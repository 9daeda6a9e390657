// K7 in bf16, serving (no log-sum-exp): head-split non-causal attention on
// [B*H, T, D] bf16 tensors, D 64 or 80, keys at or past kv_len masked.
//
// Replaces `_flash_forward` (friendly_stable_audio_tools_tpu/ops/pallas/
// flash_attention.py:230, call :317) on bf16 inputs without `save_stats`,
// in both of its forms: `_single_dot_kernel` (:121, with `_single_dot_core`
// :93) for t_k <= 8192 and `_online_kernel` (:146) beyond. Per head:
//     q' = bf16(fp32(q) * log2(e)/sqrt(D)),  s = q' k^T (fp32, keys >= kv_len masked),
//     p = exp2(s - rowmax(s)), rounded to bf16 before p v,
//     out = bf16((p v) / max(l, 1e-30)),  l = rowsum(p) in fp32.
// Stable Audio 1.0's ADP U-Net in bench.py's bf16 recipe runs it at its
// gated self-attention (B 2 x 16 heads under CFG: T 4096 and 2048 at D 64, T
// 1024 at D 80; 14 calls per U-Net forward), and Stable Audio 2.0's DiT past
// 8192 tokens (8449 padded to 8576 at 392 s) at D 64 with kv_len.
//
// Design: one block owns a 64-row q tile of one head (four warps of 16 rows)
// and streams 64-key tiles of K and V through an online base-2 softmax with
// the running max and sum in fp32 registers. The TPU kernel takes one
// whole-row score dot with all of K in VMEM (single dot) or loops over 512-key
// blocks (online); a Hopper block cannot hold K, and the streaming loop gives
// the single dot's softmax up to the bf16 rounding of p against a running
// rather than a final max, so one kernel serves both forms. Both products run
// on the tensor cores as mma.sync m16n8k16 bf16 -> fp32 (FlashAttention-2's
// register layout): q' stays in registers as A fragments for the whole key
// loop, the score accumulators become P's A fragments in registers after the
// softmax (no shared-memory round trip for S or P), and the output
// accumulators are rescaled in registers, where each lane knows its rows.
// K and V tiles are double-buffered in shared memory by cp.async (the next
// tile loads while the current one computes; rows at or past kv_len are
// zero-filled); V's B fragments come from ldmatrix.trans. Row strides of D + 8
// bf16 keep the fragment loads free of bank conflicts at D 64 and 80.
//
// What bounds it on the H100: the tensor cores. The two products are 4 T^2 D
// operations per head against 8 T D bytes in and out; at the U-Net's shapes
// (BH 32) the bound at 989 TFLOP/s is 0.139 ms at T 4096 D 64, 0.0347 ms at
// T 2048 D 64 and 0.0109 ms at T 1024 D 80 (the bytes take 0.020, 0.010 and
// 0.006 ms at 3.35 TB/s). mma.sync reaches only part of that rate; wgmma with
// TMA, FlashAttention-3's shape, is later work.
#include "common.cuh"

namespace {

constexpr int kTile = 64;   // q rows of a block; keys of a key tile
constexpr int kWarps = 4;   // 16 q rows each
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half: the lower column
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b, m16n8k16, a row-major bf16 (4 registers), b column-major bf16 (2), c fp32 (4)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 matrices from shared memory: lane i gives the
// address of row i % 8 of matrix i / 8; register j receives, for lane l,
// matrix j's elements (row 2 (l % 4) and 2 (l % 4) + 1, column l / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group complete
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts the copy of rows [k0, k0 + 64) of one head's [T, D] tensor into
// dst [64][D + 8]; rows at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ src, int k0, int limit,
                                           bf16* dst) {
  constexpr int kSeg = D / 8;
  for (int i = threadIdx.x; i < kTile * kSeg; i += kThreads) {
    const int r = i / kSeg, seg = i % kSeg;
    const bool valid = k0 + r < limit;
    cp_async16(dst + r * (D + 8) + seg * 8, src + (size_t)(valid ? k0 + r : 0) * D + seg * 8,
               valid);
  }
}

// Two bf16 of row `row` at columns (c, c + 1), prescaled in fp32 and rounded
// to bf16 (the kernel's q'), packed; zero past T.
__device__ __forceinline__ uint32_t q_pair(const bf16* __restrict__ qh, int row, int T, int D,
                                           int c, float prescale) {
  if (row >= T) return 0u;
  const float2 x =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qh + (size_t)row * D + c));
  return pack_bf16(x.x * prescale, x.y * prescale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_forward_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out, int T, int kv_len,
                          float prescale) {
  constexpr int LD = D + 8;   // shared row stride (bf16)
  constexpr int KS = D / 16;  // k-steps of the score product
  constexpr int NT = D / 8;   // 8-wide column tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [2][64][LD]
  bf16* Vs = Ks + 2 * kTile * LD;            // [2][64][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // fragment row group, column pair
  const size_t head = (size_t)blockIdx.y * T * D;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const int n_tiles = (kv_len + kTile - 1) / kTile;

  stage_tile<D>(kh, 0, kv_len, Ks);
  stage_tile<D>(vh, 0, kv_len, Vs);
  cp_async_commit();

  // this lane's rows of the q tile, and q' as A fragments
  const int r0 = blockIdx.x * kTile + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * tig;
    qa[ks][0] = q_pair(q + head, r0, T, D, c, prescale);
    qa[ks][1] = q_pair(q + head, r1, T, D, c, prescale);
    qa[ks][2] = q_pair(q + head, r0, T, D, c + 8, prescale);
    qa[ks][3] = q_pair(q + head, r1, T, D, c + 8, prescale);
  }

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows r0, r1

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      stage_tile<D>(kh, (kt + 1) * kTile, kv_len, Ks + (buf ^ 1) * kTile * LD);
      stage_tile<D>(vh, (kt + 1) * kTile, kv_len, Vs + (buf ^ 1) * kTile * LD);
    }
    cp_async_commit();  // possibly empty: the wait below then always leaves one group
    cp_async_wait_prev();
    __syncthreads();
    const bf16* Kt = Ks + buf * kTile * LD;
    const bf16* Vt = Vs + buf * kTile * LD;

    // S = q' K^T: the warp's 16 rows x 64 keys, 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kp = Kt + (j * 8 + g) * LD + ks * 16 + 2 * tig;
        mma_bf16(s[j], qa[ks], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    const int k0 = kt * kTile;
    if (k0 + kTile > kv_len) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * tig + (e & 1) >= kv_len) s[j][e] = -INFINITY;
    }

    // online base-2 softmax: elements 0, 1 are row r0, 2, 3 row r1; the four
    // lanes of a quad share a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = (m_new == -INFINITY) ? 1.f : exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    uint32_t pa[4][4];  // P as A fragments: k-step kk covers keys 16 kk .. 16 kk + 15
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = (s[j][e] == -INFINITY) ? 0.f : exp2f(s[j][e] - m[e >> 1]);
        ls[e >> 1] += p[e];
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
      ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
      l[h] = l[h] * alpha[h] + ls[h];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += P V: V's B fragments for two column tiles per ldmatrix
    const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vt + (kk * 16 + (mat & 1) * 8 + mrow) * LD + (nt + (mat >> 1)) * 8);
        mma_bf16(o[nt], pa[kk], b[0], b[1]);
        mma_bf16(o[nt + 1], pa[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
  bf16* oh = out + head;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + 2 * tig;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r0 * D + c) =
          pack_bf16(o[nt][0] / den0, o[nt][1] / den0);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r1 * D + c) =
          pack_bf16(o[nt][2] / den1, o[nt][3] / den1);
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH, int T, int kv_len,
           float prescale, cudaStream_t st) {
  const size_t smem = (size_t)4 * kTile * (D + 8) * sizeof(bf16);
  cudaError_t err = allow_smem(flash_forward_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kTile - 1) / kTile, BH);
  flash_forward_bf16_kernel<D><<<grid, kThreads, smem, st>>>(q, k, v, out, T, kv_len, prescale);
  return (int)cudaGetLastError();
}

}  // namespace

// K7 in bf16 without the LSE: q, k, v [BH, T, D] bf16 contiguous (16-byte
// aligned), D 64 or 80, 1 <= kv_len <= T -> out [BH, T, D] bf16. prescale =
// log2(e)/sqrt(D). Returns cudaErrorInvalidValue for another D.
extern "C" int fsat_flash_forward_bf16(const void* q, const void* k, const void* v, void* out,
                                       int BH, int T, int kv_len, int D, float prescale,
                                       void* stream) {
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return launch<64>(qb, kb, vb, ob, BH, T, kv_len, prescale, st);
  if (D == 80) return launch<80>(qb, kb, vb, ob, BH, T, kv_len, prescale, st);
  return (int)cudaErrorInvalidValue;
}
