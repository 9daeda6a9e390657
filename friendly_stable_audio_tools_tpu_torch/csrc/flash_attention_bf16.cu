// K7 in bf16, serving (no log-sum-exp): head-split non-causal attention on
// [B*H, T, D] bf16 tensors, D 64, 80 or 128, keys at or past kv_len masked.
//
// Replaces `_flash_forward` (friendly_stable_audio_tools_tpu/ops/pallas/
// flash_attention.py:230, call :317) on bf16 inputs without `save_stats`,
// in both of its forms: `_single_dot_kernel` (:121, with `_single_dot_core`
// :93) for t_k <= 8192 and `_online_kernel` (:146) beyond. Per head:
//     q' = bf16(fp32(q) * log2(e)/sqrt(D)),  s = q' k^T (fp32, keys >= kv_len masked),
//     p = exp2(s - m), rounded to bf16 before p v,  l = rowsum(p) in fp32,
//     out = bf16((p v) / max(l, 1e-30)).
// Stable Audio 1.0's ADP U-Net in bench.py's bf16 recipe runs it at its
// gated self-attention (B 2 x 16 heads under CFG: T 4096 and 2048 at D 64, T
// 1024 at D 80; 14 calls per U-Net forward), and Stable Audio 2.0's DiT past
// 8192 tokens (8449 padded to 8576 at 392 s) at D 64 with kv_len. The TPU
// kernel takes one whole-row score dot with all of K in VMEM (single dot) or
// loops over 512-key blocks (online); a Hopper block cannot hold K, and the
// streaming loop gives the single dot's softmax up to the bf16 rounding of p
// against a running rather than a final max, so one kernel serves both forms.
//
// What bounds it on the H100: the tensor cores. The two products are 4 T
// kv_len D operations per head against 8 T D bytes in and out; at the
// U-Net's shapes (BH 32) the bound at 989 TFLOP/s is 0.139 ms at T 4096 D 64,
// 0.0347 ms at T 2048 D 64 and 0.0109 ms at T 1024 D 80 (the bytes take
// 0.020, 0.010 and 0.006 ms at 3.35 TB/s). The mma.sync kernel this replaces
// reached a fifth of that rate (0.7587 ms at T 4096, 2.1x SDPA); the design
// here is the head-pair forward's (attention.cu), FlashAttention-3's shape:
// - A producer warpgroup (one thread at work) streams K and V tiles of kN
//   keys by TMA (3-D tensor maps over [BH, T, D]: rows at or past T arrive as
//   zeros and no tile crosses a head) into a ring of kStages stages, each
//   guarded by a "full" mbarrier (TMA bytes) and an "empty" one (the
//   consumers' release).
// - Two consumer warpgroups each own 64 q rows (128 per block). The q tile
//   is read once, prescaled in fp32, rounded to bf16 and written into
//   swizzled shared memory: wgmma's A operand for the whole key loop.
//   S = q' K^T by wgmma into registers (one m64n128 product per k-slice),
//   the online base-2 softmax on the accumulators there (keys at or past
//   kv_len masked only in the tile that holds kv_len), P rounded to bf16 in
//   registers and fed back as wgmma's register A operand for P.V, O
//   rescaled in registers. Tile j's score product is started together with
//   tile j-1's P.V and softmaxed while P.V still runs, and the two
//   warpgroups start their products in turns (two named barriers), so one
//   warpgroup's exponentials run while the other's products hold the
//   tensor cores (FlashAttention-3's intra- and inter-warpgroup overlap).
// - Head dim 80: a 160-byte row is not one row of the 128-byte swizzle, so
//   every tile (q', K, V) is two panels: dims 0-63 under the 128B swizzle and
//   dims 64-79 as 32-byte rows under the 32B swizzle, each with its own
//   tensor map. S takes 4 + 1 k-slices, P.V one n64 and one n16 wgmma per
//   k-slice; nothing is padded, so D 80 does 80/64 of D 64's products.
// - Head dim 128 (the rope-fused K7 of flash_attention_rope.cu runs this
//   kernel on its roped q and k for bf16 inputs: SAO 1.0's config with 12
//   heads of 128): every tile is two panels of 64 dims under the 128B
//   swizzle, S takes 4 + 4 k-slices, P.V two m64n64 products per k-slice. A
//   stage holds 64 keys (`Layout<D>::kKeys`): the output's two halves (64
//   registers) beside a 128-key score tile (64) and its P (32) would pass
//   the 168 registers ptxas allows 384 threads (measured: 151, no spills).
// Tiles: kN 128 keys and 3 stages, the turns, and S as m64n128 products
// rather than two m64n64 (pair_attention_variants.py on the card times kN 64,
// 2 and 4 stages and the warpgroups without turns beside them; PERF.md §6);
// one block per SM (384 threads: ptxas allows 168 registers each and uses
// ~160), a plain grid of ceil(T/128) x BH blocks: at T 1024 that is 256
// blocks, 1.9 waves on 132 SMs, whose tail a persistent schedule would take.
// What bounds it now: each score takes an ex2 on the special-function units
// (16 per SM and clock: 1/16 clock, as long as its 4 D = 256 product
// operations take on the tensor cores at D 64), and the two overlap only in
// part.
#include "attention_tiles.cuh"

using namespace fsat_attn;

namespace {

constexpr int kConsumers = 2;                     // warpgroups of 64 q rows
constexpr int kM = 64 * kConsumers;               // q rows per block
constexpr int kThreads = (kConsumers + 1) * 128;  // + one producer warpgroup
constexpr int kN = 128;                           // keys per pipeline stage (D 128: 64)
constexpr int kStages = 3;
constexpr bool kTurns = true;    // the consumer warpgroups start their products in turns
constexpr int kTurnBarrier = 3;  // named barriers 3, 4: the warpgroups' turns

// A block's shared memory at head dim D: q', then the K ring, then the V
// ring, each tile as a 64-dim panel of 128-byte rows and (D 80) a 16-dim
// panel of 32-byte rows right after it; then the mbarriers.
template <int D>
struct Layout {
  static constexpr int kTail = D - kD;   // dims in the second panel: 0, 16 or 64
  static constexpr int kTailRow = 2 * kTail;  // its row bytes
  static constexpr int kTailAcc = kTail == 64 ? 32 : 8;  // its accumulator registers
  static constexpr int kKeys = D == 128 ? 64 : kN;  // keys per stage
  static constexpr int kChunks = kKeys / 64;        // 64-key column blocks of a score tile
  static constexpr int kQBytes = kM * (kRowBytes + kTailRow);
  static constexpr int kTileBytes = kKeys * (kRowBytes + kTailRow);  // one K or V stage
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * (size_t)kStages * kTileBytes + 2 * kStages * sizeof(uint64_t);
  static_assert(kTail == 0 || kTail == 16 || kTail == 64, "head dim 64, 80 or 128");
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "panels on the swizzle atom");
};

// Rows [r0, r0 + 64) of one head's q, prescaled in fp32 and rounded to bf16
// into the warpgroup's swizzled panels (qa: dims 0-63, qt: dims 64-79 or 64-127);
// rows at or past T are zero. All loads are started before any is used.
template <int D>
__device__ __forceinline__ void prescale_q_tile(const bf16* __restrict__ qh, unsigned char* qa,
                                                unsigned char* qt, int r0, int T, float prescale,
                                                int tid) {
  constexpr int kSeg = D / 8;  // 16-byte chunks per row
  constexpr int kIters = 64 * kSeg / 128;
  Pack8 in[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * 128, r = i / kSeg, seg = i % kSeg;
    in[it].u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T)
      in[it].u = *reinterpret_cast<const uint4*>(qh + (size_t)(r0 + r) * D + seg * 8);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * 128, r = i / kSeg, seg = i % kSeg;
    Pack8 res;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      res.h[j] = __float2bfloat16_rn(__bfloat162float(in[it].h[j]) * prescale);
    unsigned char* dst = seg < 8                    ? qa + sw128_offset(r, seg)
                         : Layout<D>::kTail == 64 ? qt + sw128_offset(r, seg - 8)
                                                  : qt + sw32_offset(r, seg - 8);
    *reinterpret_cast<uint4*>(dst) = res.u;
  }
}

// One k-slice of the scores: an m64nK product over the stage's K keys (two
// m64n64 halves at 128 keys).
template <int kC>
__device__ __forceinline__ void score_slice(float (&sc)[kC][32], uint64_t da, uint64_t db,
                                            int accumulate) {
  if constexpr (kC == 2)
    wgmma_ss_n128(sc[0], sc[1], da, db, accumulate);
  else
    wgmma_ss<0, 0>(sc[0], da, db, accumulate);
}

// S = q' K^T for the warpgroup's 64 rows and the keys of one stage: the
// first panel's four k-slices, then the second panel's one (D 80) or four
// (D 128).
template <int D>
__device__ __forceinline__ void start_scores(float (&sc)[Layout<D>::kChunks][32], uint32_t qa,
                                             uint32_t qt, uint32_t k_tile) {
  constexpr int kTailAt = Layout<D>::kKeys * kRowBytes;  // the K tile's second panel
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    score_slice(sc, kmajor_desc(qa + kk * 32), kmajor_desc(k_tile + kk * 32), kk > 0);
  if constexpr (Layout<D>::kTail == 16)
    score_slice(sc, kmajor32_desc(qt), kmajor32_desc(k_tile + kTailAt), 1);
  if constexpr (Layout<D>::kTail == 64) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      score_slice(sc, kmajor_desc(qt + kk * 32), kmajor_desc(k_tile + kTailAt + kk * 32), 1);
  }
}

// O += bf16(P) V: P from registers, V's panels MN-major (keys along K).
template <int D>
__device__ __forceinline__ void start_pv(float (&o)[32], float (&ot)[Layout<D>::kTailAcc],
                                         const uint32_t (&pa)[Layout<D>::kKeys / 16][4],
                                         uint32_t v_tile) {
  constexpr int kTailAt = Layout<D>::kKeys * kRowBytes;  // the V tile's second panel
#pragma unroll
  for (int kk = 0; kk < Layout<D>::kKeys / 16; ++kk) {
    wgmma_rs<1>(o, pa[kk], mnmajor_desc(v_tile + kk * 16 * kRowBytes));
    if constexpr (Layout<D>::kTail == 16)
      wgmma_rs16<1>(ot, pa[kk], mnmajor32_desc(v_tile + kTailAt + kk * 16 * 32));
    if constexpr (Layout<D>::kTail == 64)
      wgmma_rs<1>(ot, pa[kk], mnmajor_desc(v_tile + kTailAt + kk * 16 * kRowBytes));
  }
}

// Keeps the output accumulators (ot only at D 80 and 128) in place across a wgmma.
template <int D>
__device__ __forceinline__ void fence_out(float (&o)[32], float (&ot)[Layout<D>::kTailAcc]) {
  reg_fence(o);
  if constexpr (Layout<D>::kTail > 0) reg_fence(ot);
}

// Rescales the output rows g (by a0) and g + 8 (by a1) of the lane's warp.
template <int D>
__device__ __forceinline__ void rescale_out(float (&o)[32], float (&ot)[Layout<D>::kTailAcc],
                                            float a0, float a1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }
  if constexpr (Layout<D>::kTail > 0) {
#pragma unroll
    for (int j = 0; j < Layout<D>::kTail / 8; ++j) {
      ot[4 * j] *= a0;
      ot[4 * j + 1] *= a0;
      ot[4 * j + 2] *= a1;
      ot[4 * j + 3] *= a1;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_forward_bf16_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap ktail,
                          const __grid_constant__ CUtensorMap vtail, const bf16* __restrict__ q,
                          bf16* __restrict__ out, int T, int kv_len, float prescale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;  // [kM][128 B], then (D 80, 128) [kM][32 or 128 B]
  unsigned char* Ks = Qs + L::kQBytes;  // [kStages] x ([kKeys][128 B], [kKeys][32 or 128 B])
  unsigned char* Vs = Ks + kStages * L::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * L::kTileBytes);
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * kM, bh = blockIdx.y;
  const int n_tiles = (kv_len + L::kKeys - 1) / L::kKeys;
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
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        unsigned char* kd = Ks + s * L::kTileBytes;
        unsigned char* vd = Vs + s * L::kTileBytes;
        tma_load_3d(kd, &kmap, &full[s], 0, kt * L::kKeys, bh);
        tma_load_3d(vd, &vmap, &full[s], 0, kt * L::kKeys, bh);
        if constexpr (L::kTail > 0) {  // D 128: ktail and vtail are kmap and vmap
          tma_load_3d(kd + L::kKeys * kRowBytes, &ktail, &full[s], kD, kt * L::kKeys, bh);
          tma_load_3d(vd + L::kKeys * kRowBytes, &vtail, &full[s], kD, kt * L::kKeys, bh);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 64
    const int tid = threadIdx.x & 127, warp = tid >> 5;
    const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
    unsigned char* Qa = Qs + wg * 64 * kRowBytes;
    unsigned char* Qt = Qs + kM * kRowBytes + wg * 64 * L::kTailRow;
    prescale_q_tile<D>(q + (size_t)bh * T * D, Qa, Qt, q0 + wg * 64, T, prescale, tid);
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    // turns: a warpgroup starts its products after the other one started its
    // own (warpgroup 0 first), so one softmaxes while the other's run
    auto my_turn = [&] {
      if constexpr (kTurns) bar_sync(kTurnBarrier + wg, 256);
    };
    auto pass_turn = [&] {
      if constexpr (kTurns) bar_arrive(kTurnBarrier + 1 - wg, 256);
    };
    if (wg == 1) pass_turn();

    const uint32_t qa = smem_u32(Qa), qt = smem_u32(Qt);
    const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
    float o[32], ot[L::kTailAcc];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < L::kTailAcc; ++i) ot[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g + 8 (lane's part of l)
    float a0, a1;
    float sc[L::kChunks][32];
    uint32_t pa[L::kKeys / 16][4];

    // Tile kt's scores are computed while tile kt - 1's P.V runs: both
    // products are started, the scores waited for and softmaxed while P.V
    // still runs on the tensor cores, then P.V waited for and O rescaled.
    mbar_wait(&full[0], 0);
    my_turn();
    wgmma_fence();
    start_scores<D>(sc, qa, qt, k_addr);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) reg_fence(sc[c]);
    online_softmax(sc, 0, kv_len, tq, m0, m1, l0, l1, a0, a1);
    scores_to_a(sc, pa);
    for (int kt = 1; kt < n_tiles; ++kt) {
      const int s = kt % kStages, sp = (kt - 1) % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      my_turn();
      fence_out<D>(o, ot);
      wgmma_fence();
      start_scores<D>(sc, qa, qt, k_addr + s * L::kTileBytes);
      wgmma_commit();
      start_pv<D>(o, ot, pa, v_addr + sp * L::kTileBytes);
      wgmma_commit();
      pass_turn();
      wgmma_wait<1>();  // the scores
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) reg_fence(sc[c]);
      online_softmax(sc, kt * L::kKeys, kv_len, tq, m0, m1, l0, l1, a0, a1);
      wgmma_wait<0>();  // the previous tile's P.V
      fence_out<D>(o, ot);
      mbar_arrive(&empty[sp]);
      rescale_out<D>(o, ot, a0, a1);
      scores_to_a(sc, pa);
    }
    my_turn();
    fence_out<D>(o, ot);
    wgmma_fence();
    start_pv<D>(o, ot, pa, v_addr + ((n_tiles - 1) % kStages) * L::kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_out<D>(o, ot);
    if (wg == 0) pass_turn();  // warpgroup 1's last turn (its own last pass has no taker)
    mbar_arrive(&empty[(n_tiles - 1) % kStages]);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int t0 = q0 + wg * 64 + warp * 16 + g, t1 = t0 + 8;
    bf16* oh = out + (size_t)bh * T * D + 2 * tq;
    if (t0 < T) {
      bf16* dst = oh + (size_t)t0 * D;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
      if constexpr (L::kTail > 0) {
#pragma unroll
        for (int j = 0; j < L::kTail / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + kD + 8 * j) =
              pack_bf16(ot[4 * j] / d0, ot[4 * j + 1] / d0);
      }
    }
    if (t1 < T) {
      bf16* dst = oh + (size_t)t1 * D;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
      if constexpr (L::kTail > 0) {
#pragma unroll
        for (int j = 0; j < L::kTail / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + kD + 8 * j) =
              pack_bf16(ot[4 * j + 2] / d1, ot[4 * j + 3] / d1);
      }
    }
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int BH, int T, int kv_len,
           float prescale, cudaStream_t st) {
  CUtensorMap kmap, vmap, ktail, vtail;
  constexpr int kKeys = Layout<D>::kKeys;
  cudaError_t err = head_rows_map(&kmap, k, D, T, BH, kKeys);
  if (err == cudaSuccess) err = head_rows_map(&vmap, v, D, T, BH, kKeys);
  if (D == 80) {
    if (err == cudaSuccess) err = head_tail_map(&ktail, k, D, T, BH, kKeys);
    if (err == cudaSuccess) err = head_tail_map(&vtail, v, D, T, BH, kKeys);
  } else {  // unread at D 64; at D 128 the second panel is a 64-dim box of the same map
    ktail = kmap;
    vtail = vmap;
  }
  if (err == cudaSuccess) err = allow_smem(flash_forward_bf16_kernel<D>, Layout<D>::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kM - 1) / kM, BH);
  flash_forward_bf16_kernel<D><<<grid, kThreads, Layout<D>::kSmemBytes, st>>>(
      kmap, vmap, ktail, vtail, q, out, T, kv_len, prescale);
  return (int)cudaGetLastError();
}

}  // namespace

// K7 in bf16 without the LSE: q, k, v [BH, T, D] bf16 contiguous (16-byte
// aligned), D 64, 80 or 128, 1 <= kv_len <= T -> out [BH, T, D] bf16.
// prescale = log2(e)/sqrt(D) (1 for the rope-fused K7's prescaled q).
// Returns cudaErrorInvalidValue for another D.
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
  if (D == 128) return launch<128>(qb, kb, vb, ob, BH, T, kv_len, prescale, st);
  return (int)cudaErrorInvalidValue;
}
