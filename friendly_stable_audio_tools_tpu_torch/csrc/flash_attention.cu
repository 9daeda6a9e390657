// K7 and K8: head-split attention on [B*H, T, D] tensors, forward with the
// base-2 log-sum-exp and its single-pass backward, in fp32. The JAX
// package's `_flash_backward` (flash_attention.py:576-579) takes the single
// pass (K8) wherever its VMEM plan fits and the two passes (K9, on the tensor
// cores in flash_attention_bwd_f32.cu) elsewhere; ops/kernels/
// flash_attention.py:backward_kernel makes the same choice. The training
// path of the DiT's self-attention beyond 1168 tokens (Stable Audio 2.0:
// 6145 tokens padded to 6272, kv_len 6145: K7 and K9) runs them at D 64, as
// the JAX package's unpack branch does (flash_attention.py:1351-1389). The ADP
// U-Net's self-attention at T >= 1024 (Stable Audio 1.0: T 4096 and 2048 at
// D 64, T 1024 at D 80) runs the forward without the log-sum-exp when it
// serves, and the forward with it and K8 when it trains, as the JAX
// package's ops/attention.py sends it to `flash_attention`. The audio LM's
// causal self-attention (MusicGen small: 16 heads of 64, 1501 tokens at 30
// s) trains through the causal K7 with the log-sum-exp and the causal K9:
// the JAX package takes the two passes for every causal backward (:576).
//
// K7 replaces `_flash_forward` (friendly_stable_audio_tools_tpu/ops/pallas/
//   flash_attention.py:230, call :317) in its non-causal, no-rope case, with
//   or without `save_stats`: `_single_dot_kernel` (:121) with
//   `_single_dot_core` (:93). Per head, with q' = q * log2(e)/sqrt(D) (fp32, :127):
//     s = q' k^T, keys >= kv_len masked, m = rowmax(s), p = exp2(s - m),
//     l = rowsum(p), out = (p v) / max(l, 1e-30), lse = m + log2(max(l, 1e-30)).
//   The TPU kernel holds the whole K of a head in VMEM and takes one
//   whole-row score dot; here one block owns a 64-row q tile and streams
//   64-key tiles of K and V through an online base-2 softmax, which gives the
//   whole-row softmax up to rounding.
// K8 replaces `_flash_backward_fused` (:426, call :451; `_bwd_fused_kernel`
//   :367). Per head, with delta = rowsum(dO * O) computed beside the kernel:
//     qs = q * log2(e)/sqrt(D), s = qs k^T, keys >= kv_len masked,
//     p = exp2(s - lse), dp = dO v^T, ds = p * (dp - delta) (no scale),
//     dq = (ds k) / sqrt(D), dk = (ds^T qs) / log2(e), dv = p^T dO:
//   five products, where the TPU's K9 takes seven. The TPU kernel keeps the
//   whole K and V of a head in VMEM and carries dk/dv in a resident block
//   across its sequential q grid. Hopper has neither (K and V of a head at T 4096 are
//   2 MB in fp32; blocks run in no order), so this is FlashAttention-2's
//   single pass: one block owns a 64-key tile, keeps its dk/dv in registers,
//   loops over every q tile (recomputing s and p, then dp and ds), and adds
//   its part of dq into an fp32 dq buffer with atomics (`atomicAdd`, which
//   compiles to a reduction without return). The order in which the key
//   tiles' parts reach dq changes from run to run, so dq is not bit-equal
//   between runs (dk and dv are); the kernel-vs-plain tolerance is the
//   summation order's, which covers it. Each key tile starts its q loop at
//   a different tile, so the key tiles of one head rarely add into the same
//   dq rows at the same time.
// Causal K7 replaces `_flash_forward` with `causal` set: `_online_kernel`
//   (:146; the mask k_pos <= q_pos at :167-169, the skipped key blocks at
//   :185-188). The TPU kernel skips whole 256/512 blocks and masks every
//   score of a block it keeps; here the q and key tiles are both 64 wide, so
//   a q tile reads key tiles up to the diagonal tile only and only the
//   diagonal tile is masked: at T 1501 the forward computes 300 of the 576
//   tiles of a head, the triangle plus half the diagonal. The work of a q
//   tile grows with its index, so the forward starts the heaviest tiles
//   first (block x runs q tile n - 1 - x).
//
// Numerics: every product is fp32 on the CUDA cores (FFMA), so the result is
// the JAX package's fp32 math up to summation order. Rows at or beyond T are
// zero tiles that are never written back; rows in [kv_len, T) are real rows
// (their dO is zero on the transformer's path, so they add nothing).
//
// What bounds them on the H100: compute. At B8 T6272 kv_len 6145 H24 the
// forward is 2 products of 192 x 6145^2 x 64 multiply-adds (1.86 TFLOP)
// over ~1.2 GB of inputs and outputs. At Stable Audio 1.0's training shapes
// (B 8 x 16 heads) K8's five products are 1.37 TFLOP at T 4096 D 64 over
// ~0.7 GB. Register tiling
// keeps the shared-memory traffic under the FFMA rate: each thread owns an
// 8 x 4 tile of every product and reads its operands as 16-byte vectors (3
// shared loads per 32 FFMA), and the softmax row reductions run over the 16
// lanes that share a row. K8's dq atomics are 64 x D per (key tile, q
// tile), one per 320 of its FMAs.
//
// Head dim 80 (K7 and K8): the [64][D] tiles' row stride becomes 84 floats
// (16-byte rows; 84 = 20 mod 32, so the eight lanes of a quarter-warp still
// read distinct banks), the score products run 20 four-wide steps instead of
// 16, and each thread's output tiles gain one column (dims 64 + tx) beside
// its four (4 tx ..), read as a scalar. Shared memory: K7 4 tiles of 64 x 84
// fp32, 86 KB per block; K8 4 such tiles and 2 of 64 x 68 (p^T, ds^T), 119
// KB at D 80 and 103 KB at D 64.
#include "common.cuh"

namespace {

constexpr int kD = 64;        // the default head dim of the tile helpers
constexpr int kT = 64;        // q rows of a q tile, keys of a key tile
constexpr int kF = kD + 4;    // fp32 shared-memory row stride: 16-byte rows, no bank conflicts
constexpr int kThreads = 128; // tx = tid % 16 (columns), ty = tid / 16 (8-row groups)

template <int D>
constexpr size_t tile_bytes() { return (size_t)kT * (D + 4) * sizeof(float); }

__device__ __forceinline__ int tid_x() { return threadIdx.x & 15; }
__device__ __forceinline__ int tid_y() { return threadIdx.x >> 4; }

// dst[r][0:D] = scale * src[row0 + r][0:D] for rows below `rows`, else 0
// (dst row stride D + 4).
template <int D = kD>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int row0, int rows,
                                          float* __restrict__ dst, float scale) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kT * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
      v.x *= scale; v.y *= scale; v.z *= scale; v.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = v;
  }
}

// acc[i][j] = sum_d A[8 ty + i][d] * B[tx + 16 j][d]  (A, B: [64][D + 4] tiles)
template <int D = kD>
__device__ __forceinline__ void mm_abt(float (&acc)[8][4], const float* __restrict__ A,
                                       const float* __restrict__ B) {
  constexpr int F = D + 4;
  const float* a = A + tid_y() * 8 * F;
  const float* b = B + tid_x() * F;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + 16 * j * F + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(a + i * F + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][u] += sum_c P[8 ty + i][c] * V[c][4 tx + u]  (P: [64][FP] tile, V: [64][FV])
template <int FP = kF, int FV = FP>
__device__ __forceinline__ void mm_ab_acc(float (&acc)[8][4], const float* __restrict__ P,
                                          const float* __restrict__ V) {
  const float* p = P + tid_y() * 8 * FP;
  const float* v = V + tid_x() * 4;
#pragma unroll 2
  for (int c = 0; c < kT; c += 4) {
    float4 vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) vv[u] = *reinterpret_cast<const float4*>(v + (c + u) * FV);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 pv = *reinterpret_cast<const float4*>(p + i * FP + c);
      const float w[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[i][0] = fmaf(w[u], vv[u].x, acc[i][0]);
        acc[i][1] = fmaf(w[u], vv[u].y, acc[i][1]);
        acc[i][2] = fmaf(w[u], vv[u].z, acc[i][2]);
        acc[i][3] = fmaf(w[u], vv[u].w, acc[i][3]);
      }
    }
  }
}

// acc[i] += sum_c P[8 ty + i][c] * V[c][64 + tx]: head dim 80's fifth
// output column of each thread (P: [64][FP] tile, V: [64][FV]).
template <int FP, int FV = FP>
__device__ __forceinline__ void mm_ab_acc_tail(float (&acc)[8], const float* __restrict__ P,
                                               const float* __restrict__ V) {
  const float* p = P + tid_y() * 8 * FP;
  const float* v = V + 64 + tid_x();
#pragma unroll 2
  for (int c = 0; c < kT; c += 4) {
    float vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) vv[u] = v[(c + u) * FV];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 pv = *reinterpret_cast<const float4*>(p + i * FP + c);
      acc[i] = fmaf(pv.x, vv[0], acc[i]);
      acc[i] = fmaf(pv.y, vv[1], acc[i]);
      acc[i] = fmaf(pv.z, vv[2], acc[i]);
      acc[i] = fmaf(pv.w, vv[3], acc[i]);
    }
  }
}

// acc[i][u] = sum_c A[c][8 ty + i] * B[c][4 tx + u], and with D 80 also
// tail[i] = sum_c A[c][8 ty + i] * B[c][64 + tx]  (A: [64][FA] tile read
// down its columns, B: [64][FB]). Per c: two float4 reads of A (broadcast
// to the 16 lanes of a row group), one of B, 32 FMAs.
template <int FA, int FB, bool kTail>
__device__ __forceinline__ void mm_atb(float (&acc)[8][4], float (&tail)[8],
                                       const float* __restrict__ A, const float* __restrict__ B) {
  const float* a = A + tid_y() * 8;
  const float* b = B + tid_x() * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    tail[i] = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
  }
#pragma unroll 4
  for (int c = 0; c < kT; ++c) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + c * FA);
    const float4 a1 = *reinterpret_cast<const float4*>(a + c * FA + 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + c * FB);
    const float w[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] = fmaf(w[i], bv.x, acc[i][0]);
      acc[i][1] = fmaf(w[i], bv.y, acc[i][1]);
      acc[i][2] = fmaf(w[i], bv.z, acc[i][2]);
      acc[i][3] = fmaf(w[i], bv.w, acc[i][3]);
    }
    if constexpr (kTail) {
      const float bt = B[c * FB + 64 + tid_x()];
#pragma unroll
      for (int i = 0; i < 8; ++i) tail[i] = fmaf(w[i], bt, tail[i]);
    }
  }
}

// Reductions over the 16 lanes that hold one row (tx = lane % 16).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Causal: the q tile and the key tile are both 64 wide, so q tile i reads
// key tiles 0..i only and masks keys past each row's own position on tile i
// alone. Its work grows with i, so the grid runs the heaviest tiles first.
__device__ __forceinline__ int causal_q_tile(bool causal) {
  return causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

// K7: one block per (64-row q tile, head); D is 64 or 80.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int T, int kv_len, float prescale) {
  static_assert(D == 64 || D == 80, "K7 takes head dim 64 or 80");
  constexpr int F = D + 4;
  constexpr bool kTail = D == 80;  // dims 64..79: one more output column per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [64][F] q' of this block's rows
  float* Ks = Qs + kT * F;     // [64][F] the current key tile
  float* Vs = Ks + kT * F;     // [64][F]
  float* Ps = Vs + kT * F;     // [64][F] p of the current key tile (64 columns used)
  const int tx = tid_x(), ty = tid_y();
  const int qt = causal_q_tile(kCausal);
  const int q0 = qt * kT;
  const size_t head = (size_t)blockIdx.y * T * D;

  load_tile<D>(q + head, q0, T, Qs, prescale);
  float m[8], l[8], o[8][4], o_tail[8], s[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;  // this thread's share of the row sum, reduced at the end
    o_tail[i] = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) o[i][u] = 0.f;
  }

  int n_k = (kv_len + kT - 1) / kT;
  if (kCausal) n_k = min(n_k, qt + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kT;
    const bool diag = kCausal && kt == qt;  // keys past the row's position are masked
    __syncthreads();  // Qs written; the previous tile's readers of Ks, Vs, Ps are done
    load_tile<D>(k + head, k0, T, Ks, 1.f);
    load_tile<D>(v + head, k0, T, Vs, 1.f);
    __syncthreads();
    mm_abt<D>(s, Qs, Ks);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        if (k0 + c >= kv_len || (diag && c > ty * 8 + i)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // tile 0 holds key 0, which every row may see (causal: key 0 <= the
      // row's position), so m is finite from the first tile on
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        Ps[(ty * 8 + i) * F + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int u = 0; u < 4; ++u) o[i][u] *= alpha;
      if (kTail) o_tail[i] *= alpha;
    }
    __syncthreads();
    mm_ab_acc<F>(o, Ps, Vs);
    if (kTail) mm_ab_acc_tail<F>(o_tail, Ps, Vs);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float li = fmaxf(row_sum(l[i]), 1e-30f);
    const int r = q0 + ty * 8 + i;
    if (r < T) {
      float* row = out + head + (size_t)r * D;
      *reinterpret_cast<float4*>(row + tx * 4) =
          make_float4(o[i][0] / li, o[i][1] / li, o[i][2] / li, o[i][3] / li);
      if (kTail) row[64 + tx] = o_tail[i] / li;
      if (lse != nullptr && tx == 0) lse[(size_t)blockIdx.y * T + r] = m[i] + log2f(li);
    }
  }
}

template <int D, bool kCausal>
int launch_flash_forward(const float* q, const float* k, const float* v, float* out, float* lse,
                         int BH, int T, int kv_len, float prescale, cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes<D>();
  cudaError_t err = allow_smem(flash_forward_kernel<D, kCausal>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kT - 1) / kT, BH);
  flash_forward_kernel<D, kCausal><<<grid, kThreads, smem, stream>>>(q, k, v, out, lse, T,
                                                                      kv_len, prescale);
  return (int)cudaGetLastError();
}

// K8: one block per (64-key tile, head), looping over every q tile of the
// head. The thread's 8 x 4 tiles are (keys 8 ty + i) x (q rows tx + 16 j)
// for the transposed scores, (keys 8 ty + i) x (dims 4 tx ..) for dk and
// dv, and (q rows 8 ty + i) x (dims 4 tx ..) for the block's part of dq,
// which is added into the fp32 dq (zeroed by the caller) with atomics.
// Head dim 80 adds one column (dim 64 + tx) to each of the three.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_fused_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                       int T, int kv_len, float prescale, float scale) {
  static_assert(D == 64 || D == 80, "K8 takes head dim 64 or 80");
  constexpr int F = D + 4;    // row stride of the [64][D] tiles
  constexpr int FP = kT + 4;  // row stride of the [64 keys][64 q] tiles
  constexpr bool kTail = D == 80;
  constexpr float kInvLog2e = 0.6931471805599453f;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // [64][F] this block's keys
  float* Vs = Ks + kT * F;        // [64][F]
  float* Qs = Vs + kT * F;        // [64][F] qs = q * log2(e)/sqrt(D) of the current q tile
  float* DOs = Qs + kT * F;       // [64][F]
  float* PTs = DOs + kT * F;      // [64][FP] p^T of the current q tile
  float* DSTs = PTs + kT * FP;    // [64][FP] ds^T (no scale)
  float* lse_s = DSTs + kT * FP;  // [64]
  float* delta_s = lse_s + kT;    // [64]
  const int tx = tid_x(), ty = tid_y();
  const int k0 = blockIdx.x * kT;
  const size_t head = (size_t)blockIdx.y * T * D;
  const size_t stats = (size_t)blockIdx.y * T;

  float acc_k[8][4], acc_v[8][4], tail_k[8], tail_v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    tail_k[i] = tail_v[i] = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) acc_k[i][u] = acc_v[i][u] = 0.f;
  }
  if (k0 < kv_len) {  // a tile of masked keys only has zero gradients
    load_tile<D>(k + head, k0, T, Ks, 1.f);
    load_tile<D>(v + head, k0, T, Vs, 1.f);
    const int n_q = (T + kT - 1) / kT;
    for (int it = 0; it < n_q; ++it) {
      // the key tiles of a head start at different q tiles, so their dq
      // atomics rarely meet on one address at one time
      const int q0 = ((it + blockIdx.x) % n_q) * kT;
      __syncthreads();  // Ks/Vs written; the previous tile's readers of Qs, DOs, PTs, DSTs are done
      load_tile<D>(q + head, q0, T, Qs, prescale);
      load_tile<D>(dout + head, q0, T, DOs, 1.f);
      for (int i = threadIdx.x; i < kT; i += kThreads) {
        lse_s[i] = q0 + i < T ? lse[stats + q0 + i] : 0.f;
        delta_s[i] = q0 + i < T ? delta[stats + q0 + i] : 0.f;
      }
      __syncthreads();
      {
        float s[8][4], dp[8][4];
        mm_abt<D>(dp, Vs, DOs);  // dp^T = v dO^T
        mm_abt<D>(s, Ks, Qs);    // s^T = k qs^T
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool key_ok = k0 + ty * 8 + i < kv_len;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            const float p = key_ok && q0 + c < T ? exp2f(s[i][j] - lse_s[c]) : 0.f;
            PTs[(ty * 8 + i) * FP + c] = p;
            DSTs[(ty * 8 + i) * FP + c] = p * (dp[i][j] - delta_s[c]);
          }
        }
      }
      __syncthreads();
      mm_ab_acc<FP, F>(acc_v, PTs, DOs);  // dv += p^T dO
      mm_ab_acc<FP, F>(acc_k, DSTs, Qs);  // dk += ds^T qs
      if constexpr (kTail) {
        mm_ab_acc_tail<FP, F>(tail_v, PTs, DOs);
        mm_ab_acc_tail<FP, F>(tail_k, DSTs, Qs);
      }
      float part[8][4], part_tail[8];
      mm_atb<FP, F, kTail>(part, part_tail, DSTs, Ks);  // this key tile's ds k
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = q0 + ty * 8 + i;
        if (r < T) {
          float* row = dq + head + (size_t)r * D;
#pragma unroll
          for (int u = 0; u < 4; ++u) atomicAdd(row + tx * 4 + u, part[i][u] * scale);
          if constexpr (kTail) atomicAdd(row + 64 + tx, part_tail[i] * scale);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = k0 + ty * 8 + i;
    if (r < T) {
      float* row_k = dk + head + (size_t)r * D;
      float* row_v = dv + head + (size_t)r * D;
      *reinterpret_cast<float4*>(row_k + tx * 4) =
          make_float4(acc_k[i][0] * kInvLog2e, acc_k[i][1] * kInvLog2e, acc_k[i][2] * kInvLog2e,
                      acc_k[i][3] * kInvLog2e);
      *reinterpret_cast<float4*>(row_v + tx * 4) =
          make_float4(acc_v[i][0], acc_v[i][1], acc_v[i][2], acc_v[i][3]);
      if constexpr (kTail) {
        row_k[64 + tx] = tail_k[i] * kInvLog2e;
        row_v[64 + tx] = tail_v[i];
      }
    }
  }
}

template <int D>
int launch_flash_backward_fused(const float* q, const float* k, const float* v, const float* dout,
                                const float* lse, const float* delta, float* dq, float* dk,
                                float* dv, int BH, int T, int kv_len, float prescale, float scale,
                                cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes<D>() + 2 * (size_t)kT * (kT + 4) * sizeof(float) +
                      2 * kT * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_fused_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kT - 1) / kT, BH);
  flash_bwd_fused_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dq, dk,
                                                               dv, T, kv_len, prescale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K7: q, k, v [BH, T, D] fp32 contiguous, D 64 or 80 -> out [BH, T, D] fp32
// and, when lse is not null, lse [BH, T] fp32 (base 2). prescale =
// log2(e)/sqrt(D); causal != 0 masks key j > query i. Returns
// cudaErrorInvalidValue for another D.
extern "C" int fsat_flash_forward(const float* q, const float* k, const float* v, float* out,
                                  float* lse, int BH, int T, int kv_len, int D, int causal,
                                  float prescale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64 && causal)
    return launch_flash_forward<64, true>(q, k, v, out, lse, BH, T, kv_len, prescale, st);
  if (D == 64) return launch_flash_forward<64, false>(q, k, v, out, lse, BH, T, kv_len, prescale, st);
  if (D == 80 && causal)
    return launch_flash_forward<80, true>(q, k, v, out, lse, BH, T, kv_len, prescale, st);
  if (D == 80) return launch_flash_forward<80, false>(q, k, v, out, lse, BH, T, kv_len, prescale, st);
  return (int)cudaErrorInvalidValue;
}

// K8: q, k, v, out's dO [BH, T, D] fp32 (D 64 or 80), lse/delta [BH, T] fp32
// -> dk, dv [BH, T, D] fp32, and dq [BH, T, D] fp32 added into (the caller
// zeroes it). prescale = log2(e)/sqrt(D), scale = 1/sqrt(D). One launch.
// Returns cudaErrorInvalidValue for another D.
extern "C" int fsat_flash_backward_fused(const float* q, const float* k, const float* v,
                                         const float* dout, const float* lse, const float* delta,
                                         float* dq, float* dk, float* dv, int BH, int T,
                                         int kv_len, int D, float prescale, float scale,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch_flash_backward_fused<64>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T, kv_len,
                                           prescale, scale, st);
  if (D == 80)
    return launch_flash_backward_fused<80>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T, kv_len,
                                           prescale, scale, st);
  return (int)cudaErrorInvalidValue;
}
