// The head-pair attention forward: one kernel for three launches.
//
// K1  replaces `_fused_pair_forward` / `_fused_pair_kernel`
//     (friendly_stable_audio_tools_tpu/ops/pallas/flash_attention.py:828, :796):
//     inference, lse == nullptr. Bound at B2 T1025 H24 (SAO generation):
//     13.1 GFLOP of score and P.V products, 0.0131 ms at 989 TFLOP/s.
// K5  replaces `_fused_pair_forward_stats` / `_fused_pair_stats_kernel`
//     (:980, :931): the same with lse [B, H, T] fp32 = m + log2(l), the
//     base-2 log-sum-exp of the prescaled scores (:957) that K6 reads. Bound
//     at B8 T1040 kv_len 1025 H24 (SAO training): 0.0522 ms.
// K10 replaces `_pair_long_kernel` (:1233, call :1297): the long-sequence
//     inference path (2048 < T <= 8192). Bound at B2 T6272 kv_len 6145 H24
//     (SA 2.0 generation): ~464 GFLOP, 0.469 ms.
//
// All three read k already roped once per call and rounded to bf16 (K10a,
// attention_rope.cu: khat [B, T, H*64]) and q and v from the fused qkv
// tensor [B, T, 3*H*64] bf16. Per head, with q^ = bf16(rope(q) log2(e)/8),
// k^ = khat: s = q^ k^T (keys at or past kv_len masked), an online base-2
// softmax with an fp32 running max m and sum l, P rounded to bf16 before
// P.V, out = bf16(O / max(l, 1e-30)) [B, T, H*64].
//
// What bounded the WMMA kernel this replaces (2.5% of the bf16 peak at K1's
// shape): every score tile and every P.V partial went through fp32 shared
// memory, tiles loaded synchronously with 3-4 __syncthreads per key tile,
// and K1/K5 roped the whole of K again in every 64-row q tile. Here:
// - K is roped once per call (K10a), so the key loop does no rope at all;
//   the q tile is roped and prescaled in fp32 once, in the prologue, and
//   written as bf16 into 128B-swizzled shared memory, wgmma's A operand for
//   the whole key loop.
// - A producer warpgroup (one thread at work) streams K and V tiles of kN
//   keys by TMA (3-D
//   tensor maps over [B, T, C]: rows at or past T arrive as zeros and no
//   tile crosses a batch) into a ring of kStages stages, each guarded by a
//   "full" mbarrier (TMA bytes) and an "empty" one (the consumers' release).
// - Two consumer warpgroups each own 64 q rows: S = q^ k^T by wgmma into
//   registers, the online softmax on the accumulators there, P rounded to
//   bf16 in registers and fed back as wgmma's register A operand for P.V,
//   O rescaled in registers. Nothing but K, V and q^ touches shared memory.
//   Tile j's score product is started together with tile j-1's P.V and
//   softmaxed while P.V still runs (FlashAttention-3's intra-warpgroup
//   overlap), so the exponentials share time with the tensor cores.
// Tile shape, by measurement on the H100 (pair_attention_variants.py; the
// times are in PERF.md §6): 128 q rows per block (two warpgroups sharing
// each K/V tile; 432 blocks at K1's shape, 3.3 waves on 132 SMs) and kN =
// 128 keys per stage, 3 stages; one block per SM, a plain grid rather than
// a persistent one. 64-key stages measured slower, and so did three
// consumer warpgroups: ptxas holds 512 threads to 65536 / 512 = 128
// registers each (setmaxnreg does not raise what it allocates), spills and
// serializes the wgmmas; two fit the 168 registers of 384 threads.
#include "attention_tiles.cuh"

using namespace fsat_attn;

namespace {

constexpr int kConsumers = 2;                      // warpgroups of 64 q rows
constexpr int kM = 64 * kConsumers;                // q rows per block
constexpr int kThreads = (kConsumers + 1) * 128;   // + one producer warpgroup
constexpr int kN = 128;                            // keys per pipeline stage
constexpr int kStages = 3;
constexpr size_t kSmemBytes = 1024 + (size_t)kM * kRowBytes + 2 * (size_t)kStages * kN * kRowBytes +
                              2 * kStages * sizeof(uint64_t);

// Rows [r0, r0 + 64) of q, roped in fp32 with C/S = prescale * cos/sin over
// the first `rot` dims and prescale beyond them (the tables of
// flash_attention.py:_rope_tables, rotate-half sign convention :730-734),
// rounded to bf16 into the swizzled tile qs; rows at or past T are zero.
// Each of the warpgroup's 128 threads ropes four 8-dim segments, all loads
// started before any is used.
__device__ __forceinline__ void rope_q_tile(const bf16* __restrict__ qkv, const float* __restrict__ cos_t,
                                            const float* __restrict__ sin_t, unsigned char* qs,
                                            int b, int h, int r0, int T, int H, int rot,
                                            float prescale, int tid) {
  const size_t row_stride = (size_t)3 * H * kD;
  const int half = rot >> 1;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = tid + it * 128;
    const int r = i >> 3, seg = i & 7, t = r0 + r;
    Pack8 res;
    res.u = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) {
      const bf16* src = qkv + ((size_t)b * T + t) * row_stride + h * kD;
      Pack8 in;
      in.u = *reinterpret_cast<const uint4*>(src + seg * 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = seg * 8 + j;
        const float x = __bfloat162float(in.h[j]);
        float y;
        if (d < rot) {
          const float c = cos_t[(size_t)t * rot + d] * prescale;
          const float s = sin_t[(size_t)t * rot + d] * prescale;
          const float partner = d < half ? -__bfloat162float(src[d + half])
                                         : __bfloat162float(src[d - half]);
          y = x * c + partner * s;
        } else {
          y = x * prescale;
        }
        res.h[j] = __float2bfloat16_rn(y);
      }
    }
    *reinterpret_cast<uint4*>(qs + swizzled(r, seg)) = res.u;
  }
}

// S = q^ k^T for the warpgroup's 64 rows and the kN keys of one stage.
__device__ __forceinline__ void start_scores(float (&sc)[kN / 64][32], uint32_t q_addr,
                                             uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < kN / 64; ++c)
      wgmma_ss<0, 0>(sc[c], kmajor_desc(q_addr + kk * 32),
                     kmajor_desc(k_tile + c * 64 * kRowBytes + kk * 32), kk > 0);
}

// O += bf16(P) V: P from registers, V's tile MN-major (keys along K).
__device__ __forceinline__ void start_pv(float (&o)[32], const uint32_t (&pa)[kN / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
    wgmma_rs<1>(o, pa[kk], mnmajor_desc(v_tile + kk * 16 * kRowBytes));
}

// The online base-2 softmax on one score tile in registers (rows g and g + 8
// of the lane's warp; keys at or past kv_len set to -inf first): updates the
// running max m and the lane's part of the running sum l, leaves p in sc and
// returns the rescale factors of the rows' earlier output in a0, a1. Every
// tile holds a key below kv_len, so the new max is finite and 2^(-inf) = 0
// takes care of masked keys and of the first tile's m = -inf.
__device__ __forceinline__ void online_softmax(float (&sc)[kN / 64][32], int k0, int kv_len, int tq,
                                               float& m0, float& m1, float& l0, float& l1,
                                               float& a0, float& a1) {
  constexpr int kChunks = kN / 64;
  if (k0 + kN > kv_len) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + c * 64 + 8 * (i >> 2) + 2 * tq + (i & 1) >= kv_len) sc[c][i] = -INFINITY;
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[c][4 * j], sc[c][4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[c][4 * j + 2], sc[c][4 * j + 3]));
    }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  a0 = ex2(m0 - mx0);
  a1 = ex2(m1 - mx1);
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[c][4 * j] = ex2(sc[c][4 * j] - mx0);
      sc[c][4 * j + 1] = ex2(sc[c][4 * j + 1] - mx0);
      sc[c][4 * j + 2] = ex2(sc[c][4 * j + 2] - mx1);
      sc[c][4 * j + 3] = ex2(sc[c][4 * j + 3] - mx1);
      ls0 += sc[c][4 * j] + sc[c][4 * j + 1];
      ls1 += sc[c][4 * j + 2] + sc[c][4 * j + 3];
    }
  l0 = l0 * a0 + ls0;
  l1 = l1 * a1 + ls1;
  m0 = mx0;
  m1 = mx1;
}

__device__ __forceinline__ void scores_to_a(const float (&sc)[kN / 64][32],
                                            uint32_t (&pa)[kN / 16][4]) {
#pragma unroll
  for (int c = 0; c < kN / 64; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_to_a(sc[c], j, pa[c * 4 + j]);
}

__global__ void __launch_bounds__(kThreads, 1)
pair_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ qkv,
                      const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                      bf16* __restrict__ out, float* __restrict__ lse, int T, int H, int rot,
                      int kv_len, float prescale) {
  constexpr int kTileBytes = kN * kRowBytes;
  constexpr int kChunks = kN / 64;  // 64-key column blocks of a score tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;                           // [kM][128 B]
  unsigned char* Ks = Qs + kM * kRowBytes;            // [kStages][kN][128 B]
  unsigned char* Vs = Ks + kStages * kTileBytes;      // [kStages][kN][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * kTileBytes);
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * kM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (kv_len + kN - 1) / kN;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warpgroup: one thread starts the loads
    if (threadIdx.x == kConsumers * 128) {
      const int v_col = 2 * H * kD + h * kD;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_3d(Ks + s * kTileBytes, &kmap, &full[s], h * kD, kt * kN, b);
        tma_load_3d(Vs + s * kTileBytes, &vmap, &full[s], v_col, kt * kN, b);
      }
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 64
    const int tid = threadIdx.x & 127, warp = tid >> 5;
    const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
    unsigned char* Qw = Qs + wg * 64 * kRowBytes;
    rope_q_tile(qkv, cos_t, sin_t, Qw, b, h, q0 + wg * 64, T, H, rot, prescale, tid);
    fence_proxy_async();
    bar_sync(1 + wg, 128);

    const uint32_t q_addr = smem_u32(Qw);
    const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g + 8 (lane's part of l)
    float a0, a1;
    float sc[kChunks][32];
    uint32_t pa[kN / 16][4];

    // Tile kt's scores are computed while tile kt - 1's P.V runs: both
    // products are started, the scores waited for and softmaxed while P.V
    // still runs on the tensor cores, then P.V waited for and O rescaled.
    mbar_wait(&full[0], 0);
    wgmma_fence();
    start_scores(sc, q_addr, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) reg_fence(sc[c]);
    online_softmax(sc, 0, kv_len, tq, m0, m1, l0, l1, a0, a1);
    scores_to_a(sc, pa);
    for (int kt = 1; kt < n_tiles; ++kt) {
      const int s = kt % kStages, sp = (kt - 1) % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      reg_fence(o);
      wgmma_fence();
      start_scores(sc, q_addr, k_addr + s * kTileBytes);
      wgmma_commit();
      start_pv(o, pa, v_addr + sp * kTileBytes);
      wgmma_commit();
      wgmma_wait<1>();  // the scores
#pragma unroll
      for (int c = 0; c < kChunks; ++c) reg_fence(sc[c]);
      online_softmax(sc, kt * kN, kv_len, tq, m0, m1, l0, l1, a0, a1);
      wgmma_wait<0>();  // the previous tile's P.V
      reg_fence(o);
      mbar_arrive(&empty[sp]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      scores_to_a(sc, pa);
    }
    reg_fence(o);
    wgmma_fence();
    start_pv(o, pa, v_addr + ((n_tiles - 1) % kStages) * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    mbar_arrive(&empty[(n_tiles - 1) % kStages]);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int HD = H * kD;
    const int t0 = q0 + wg * 64 + warp * 16 + g, t1 = t0 + 8;
    if (t0 < T) {
      bf16* dst = out + ((size_t)b * T + t0) * HD + h * kD + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
      if (lse != nullptr && tq == 0) lse[((size_t)b * H + h) * T + t0] = m0 + log2f(d0);
    }
    if (t1 < T) {
      bf16* dst = out + ((size_t)b * T + t1) * HD + h * kD + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
      if (lse != nullptr && tq == 0) lse[((size_t)b * H + h) * T + t1] = m1 + log2f(d1);
    }
  }
}

}  // namespace

// qkv [B, T, 3*H*64] bf16 (q and v read), khat [B, T, H*64] bf16 (K10a's
// roped k), cos/sin [T, rot] fp32 -> out [B, T, H*64] bf16, and lse [B, H, T]
// fp32 unless lse == nullptr.
extern "C" int fsat_pair_attention(const void* qkv, const void* khat, const float* cos_t,
                                   const float* sin_t, void* out, float* lse, int B, int T, int H,
                                   int rot, int kv_len, float prescale, void* stream) {
  CUtensorMap kmap, vmap;
  cudaError_t err = head_rows_map(&kmap, khat, H * kD, T, B, kN);
  if (err == cudaSuccess) err = head_rows_map(&vmap, qkv, 3 * H * kD, T, B, kN);
  if (err == cudaSuccess) err = allow_smem(pair_attention_kernel, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kM - 1) / kM, H, B);
  pair_attention_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      kmap, vmap, static_cast<const bf16*>(qkv), cos_t, sin_t, static_cast<bf16*>(out), lse, T, H,
      rot, kv_len, prescale);
  return (int)cudaGetLastError();
}
