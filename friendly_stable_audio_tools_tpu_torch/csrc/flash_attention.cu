// K7 in fp32: the forward of head-split attention on [B*H, T, D] tensors, D
// 32, 64 or 80, causal or not, with its base-2 log-sum-exp or without, on the
// tensor cores (3xTF32 wgmma on TMA-fed tiles).
//
// Replaces `_flash_forward` (friendly_stable_audio_tools_tpu/ops/pallas/
// flash_attention.py:230, call :317) on fp32 inputs without rope, in all its
// forms: `_single_dot_kernel` (:121) with `_single_dot_core` (:93) for t_k <=
// 8192, and `_online_kernel` (:146) beyond 8192 keys and when causal (the
// mask k_pos <= q_pos at :167-169, the skipped key blocks at :185-188), with
// `save_stats` or without. Per head, with q' = q * log2(e)/sqrt(D) (fp32,
// :127):
//   s = q' k^T, keys >= kv_len masked (causal: keys past the row's own
//   position too), m = rowmax(s), p = exp2(s - m), l = rowsum(p),
//   out = (p v) / max(l, 1e-30), lse = m + log2(max(l, 1e-30)).
// The TPU kernel holds the whole K of a head in VMEM and takes one whole-row
// score dot (or loops over 512-key blocks); a Hopper block cannot hold K, so
// one streaming loop over 64-key tiles through an online base-2 softmax
// serves every form and gives the whole-row softmax up to rounding.
// Callers: Stable Audio 2.0's DiT training (6145 tokens padded to 6272,
// kv_len 6145, B 8 x 24 heads, with the LSE), Stable Audio 1.0's ADP U-Net
// (B 2 x 16 heads serving, B 8 x 16 training with the LSE; T 4096 and 2048
// at D 64, T 1024 at D 80), the audio LM's causal self-attention (B 8 x 16
// heads, T 1501), SA 2.0's DiT past 8192 tokens (8449 padded to 8576) and
// Dance Diffusion's U-Net (16 heads of 32 on its 512-channel levels; T 8192,
// 4096, 2048 and 1024 at generate_diffusion_uncond's default 2,097,152
// samples, serving).
//
// What bounds it on the H100: the products. 4 T kv_len D operations per head
// against 16 T D bytes in and out; at SA 2.0's training shape that is 1.86
// TFLOP, 11.25 ms at 3xTF32's 165 TFLOP/s (TF32's 495 over three passes),
// against ~0.37 ms for the bytes. The products must stay fp32-accurate:
// 1xTF32 keeps ~3 decimal digits, so each is 3xTF32, a b ~ a_lo b_hi + a_hi
// b_lo + a_hi b_hi with hi = tf32(x) and lo = tf32(x - hi) rounded to
// nearest. The FFMA kernel this replaces ran them on the CUDA cores (66.9
// TFLOP/s) at 4.6x the bound.
//
// Design: the bf16 K7's (flash_attention_bf16.cu) with PR 17's fp32 answers
// (flash_attention_bwd_f32.cu):
// - A split pre-pass (`flash_split_kernel`, one launch per call) writes K as
//   tf32 hi/lo [2][BH][T][D] and V^T as hi/lo [2][BH][D][Tp] (Tp = T rounded
//   up to 64; keys at or past T zero) into a scratch buffer the wrapper
//   allocates. tf32 wgmma reads shared-memory operands K-major only, and P.V
//   contracts over keys, so its B operand must be V^T; V^T's keys are stored
//   in the pos8 order [0,2,4,6,1,3,5,7] within each 8, so the S accumulator
//   is P.V's register-A fragment as it stands (attention_tiles.cuh:
//   acc_to_a_tf32). The pre-pass moves 6 x 4 BH T D bytes (at SA 2.0's shape
//   ~1.85 GB, ~0.55 ms) and is counted inside K7's time.
// - One producer warp streams finished B tiles by 3-D TMA into a ring of
//   kSlots slots, each guarded by a "full" mbarrier (TMA bytes) and an
//   "empty" one (256 consumer arrivals): for key tile j, the K hi/lo tiles
//   into one slot, then the V^T hi/lo tiles into the next. One slot holds
//   2 x 64 x D fp32, either kind.
// - Two consumer warpgroups of 64 q rows (128 per block). q' = q * log2(e) /
//   sqrt(D) in fp32, split once into hi/lo tiles in shared memory: S's A
//   operand for the whole key loop (K-major: [rows][dims]). Per key tile: S
//   = q' K^T (m64n64, D/8 k8 slices, three issues each), the online softmax
//   on the accumulator (kv_len masked only in the tile that holds it;
//   causal: only the diagonal tile, where key > row), P split into hi/lo
//   register fragments, O_tile = P V^T (m64nD, 8 slices), then O = O * alpha
//   + O_tile on the CUDA cores.
// - The tensor cores' fp32 accumulate truncates: summed in one accumulator
//   over SA 2.0's 98 key tiles, O would drift ~6e-5 rel-L2 from the exact
//   sums (tests/test_torch_flash_f32_schedule.py emulates it); each tile's P.V is
//   therefore a product of its own, zeroed by its first issue and added into
//   fp32 totals in registers, as K9 adds dK and dV.
// - The two warpgroups start their products in turns (named barriers 3 and
//   4), one product each turn: S of warpgroup 0, S of warpgroup 1, P.V of 0,
//   P.V of 1, ...; each warpgroup's softmax and O update run while the
//   other's product holds the tensor cores. A warpgroup does not overlap its
//   own S with its previous P.V: that needs S's 32 registers beside P's 64
//   and the 2 x D/2 of O's tile and total (176 at D 80), over the 168 ptxas
//   allows 288 threads.
// - Causal: a block's warpgroups read key tiles up to their own diagonal
//   tile (warpgroup 0's last tile is warpgroup 1's diagonal: warpgroup 0
//   takes its turns and releases the slots without products there); each
//   head's heaviest q blocks run first (blockIdx.x reversed). At T 1501 that
//   is 300 of a head's 576 tiles. The q blocks of a head are neighbours in
//   the grid (x), so the blocks in flight share a few heads' K and V in L2.
// Budget, written before the first card run:
// - shared memory: q' hi/lo of both warpgroups (4 x 64 x D x 4 bytes) and
//   kSlots slots of 2 x 64 x D x 4: D 64 4 slots, 196,608 bytes; D 80 3
//   slots, 204,800 bytes; + 2 kSlots mbarriers + 1024 bytes of alignment
//   slack. One block per SM.
// - registers (288 threads: ptxas allows 168): O total D/2 (32, 40), O tile
//   D/2, P hi/lo 64, the softmax's m and l of two rows; S (32) only before P
//   is made: ~136-160 with addresses.
// - tensor maps: K parts [2 BH][T][D], boxes of 64 keys x 32 dims under the
//   128B swizzle at dims 0 and 32 and (D 80) 64 keys x 8 dims under the 32B
//   swizzle at dims 64 and 72; V^T parts [2 BH][D][Tp], boxes of D dims x 32
//   key positions under the 128B swizzle at positions 0 and 32 of the tile.
//   hi parts at coordinate bh, lo at BH + bh.
// - D 80 tiles: a [64][80] tile is two 128B-swizzled panels of 32 dims (8 KB
//   each) and two 32B-swizzled panels of 8 dims (2 KB each: one k8 slice
//   apiece, the bf16 K7's 32B descriptors); S takes 8 + 2 slices, P.V is one
//   m64n80 product per slice. Nothing is padded.
// - D 32 tiles: a [64][32] fp32 tile is exactly one 128B-swizzled panel (K
//   takes one box, no tail map); V^T's two panels are 32 rows each. S takes
//   4 k8 slices, P.V m64n32 products. The 8-slot ring and the q' tiles take
//   163,840 bytes.
// Measured (ptxas): 153-167 registers, no spills.
// What bounds it now (measured on the H100, PERF.md §6): the tensor cores,
// at 55-73% of the bound at D 64 above 2048 keys; at T 1024 D 80 (41%) and
// causal at T 1501 (43%) a grid of short blocks, whose first tiles and tail
// a persistent schedule would hide. A ring of 2 slots ran within 1%, the
// warpgroups without turns 3-9% slower (pair_attention_variants.py).
//
// Ragged edges: rows at or past T read as zero q and are never written;
// keys at or past T arrive as zeros (TMA) and are masked as keys >= kv_len.
// Rows in [kv_len, T) are real rows, as in the plain version.
#include "attention_tiles.cuh"

using namespace fsat_attn;

namespace {

constexpr int kConsumers = 2;                    // warpgroups of 64 q rows
constexpr int kM = 64 * kConsumers;              // q rows per block
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kN = 64;                           // keys per tile
constexpr int kTurnBarrier = 3;                  // named barriers 3, 4: the warpgroups' turns

template <int D>
struct Layout {
  static_assert(D == 32 || D == 64 || D == 80, "K7 takes head dim 32, 64 or 80");
  static constexpr int kTile = 64 * D * 4;           // one [64][D] fp32 tile, either kind
  // K or V^T hi/lo tile pairs in the ring: at D 32 a tile is one 8 KB panel
  // and a product a quarter of D 64's, so the ring runs deeper ahead
  static constexpr int kSlots = D == 32 ? 8 : D == 64 ? 4 : 3;
  static constexpr int kSlotBytes = 2 * kTile;       // hi, then lo
  // q' hi, lo of warpgroup w at w 2 kTile, then the ring
  static constexpr int kRing = kConsumers * 2 * kTile;
  static constexpr int kBars = kRing + kSlots * kSlotBytes;  // full[kSlots], empty[kSlots]
  static constexpr int kBytes = kBars + 2 * kSlots * 8;
  static constexpr int kVtPanel = D * kSwizzleRow;   // D rows of 32 key positions
  static_assert(kTile % 1024 == 0 && kVtPanel % 1024 == 0, "panels on the swizzle atom");
  static_assert(kBytes + 1024 <= 232448, "one block's shared memory");
};

// The pre-pass: K -> hi/lo [2][BH][T][D], V -> V^T hi/lo [2][BH][D][Tp] with
// each 8 keys in the pos8 order (keys at or past T zero). One block per 64
// keys of a head.
template <int D>
__global__ void __launch_bounds__(256)
flash_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                   uint32_t* __restrict__ kparts, uint32_t* __restrict__ vparts, int T, int Tp) {
  __shared__ float vs[kN][D + 1];
  const int bh = blockIdx.y, k0 = blockIdx.x * kN;
  const size_t head = (size_t)bh * T * D, kpart = (size_t)gridDim.y * T * D;
  for (int i = threadIdx.x; i < kN * D; i += 256) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (k0 + r < T) {
      const size_t at = head + (size_t)(k0 + r) * D + c;
      uint32_t hi, lo;
      split_tf32(k[at], hi, lo);
      kparts[at] = hi;
      kparts[kpart + at] = lo;
      x = v[at];
    }
    vs[r][c] = x;
  }
  __syncthreads();
  const size_t vhead = (size_t)bh * D * Tp, vpart = (size_t)gridDim.y * D * Tp;
  for (int i = threadIdx.x; i < kN * D; i += 256) {
    const int d = i / kN, r = i % kN;
    const size_t at = vhead + (size_t)d * Tp + k0 + pos8(r);
    uint32_t hi, lo;
    split_tf32(vs[r][d], hi, lo);
    vparts[at] = hi;
    vparts[vpart + at] = lo;
  }
}

// Rows [r0, r0 + 64) of one head's q, times prescale in fp32, split into the
// warpgroup's hi/lo tiles; rows at or past T are zero. All loads are started
// before any is used.
template <int D>
__device__ __forceinline__ void split_q_tile(const float* __restrict__ qh, unsigned char* hi_tile,
                                             unsigned char* lo_tile, int r0, int T,
                                             float prescale, int tid) {
  constexpr int kVec = D / 4;  // 16-byte chunks per row
  constexpr int kIters = 64 * kVec / 128;
  float4 in[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * 128, r = i / kVec, c = (i % kVec) * 4;
    in[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) in[it] = *reinterpret_cast<const float4*>(qh + (size_t)(r0 + r) * D + c);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * 128, r = i / kVec, c = (i % kVec) * 4;
    uint4 hi, lo;
    split_tf32(in[it].x * prescale, hi.x, lo.x);
    split_tf32(in[it].y * prescale, hi.y, lo.y);
    split_tf32(in[it].z * prescale, hi.z, lo.z);
    split_tf32(in[it].w * prescale, hi.w, lo.w);
    *reinterpret_cast<uint4*>(hi_tile + f32_row_off(r, c)) = hi;
    *reinterpret_cast<uint4*>(lo_tile + f32_row_off(r, c)) = lo;
  }
}

// S = q' K^T over D / 8 k8 slices, 3xTF32 (d zeroed by the first issue).
template <int D>
__device__ __forceinline__ void start_scores(float (&s)[32], uint32_t q_hi, uint32_t q_lo,
                                             uint32_t k_hi, uint32_t k_lo) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    wgmma_tf32_ss(s, f32_row_desc(q_lo, kk), f32_row_desc(k_hi, kk), kk > 0);
    wgmma_tf32_ss(s, f32_row_desc(q_hi, kk), f32_row_desc(k_lo, kk), 1);
    wgmma_tf32_ss(s, f32_row_desc(q_hi, kk), f32_row_desc(k_hi, kk), 1);
  }
}

// O_tile = P V^T over the tile's 64 keys (8 k8 slices in the pos8 order),
// 3xTF32 with P from registers (d zeroed by the first issue).
template <int D>
__device__ __forceinline__ void start_pv(float (&o)[D / 2], const uint32_t (&p_hi)[8][4],
                                         const uint32_t (&p_lo)[8][4], uint32_t v_hi,
                                         uint32_t v_lo) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk >> 2) * Layout<D>::kVtPanel + (kk & 3) * 32;
    wgmma_tf32<D>(o, p_lo[kk], kmajor_desc(v_hi + off), kk > 0);
    wgmma_tf32<D>(o, p_hi[kk], kmajor_desc(v_lo + off), 1);
    wgmma_tf32<D>(o, p_hi[kk], kmajor_desc(v_hi + off), 1);
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_forward_f32_kernel(const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap ktail,
                         const __grid_constant__ CUtensorMap vmap, const float* __restrict__ q,
                         float* __restrict__ out, float* __restrict__ lse, int T, int kv_len,
                         float prescale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kSlots;
  const int bh = blockIdx.y, BH = gridDim.y;
  const int qb = kCausal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int q0 = qb * kM;
  const int kv_tiles = (kv_len + kN - 1) / kN;
  // causal: warpgroup w reads key tiles up to its diagonal tile 2 qb + w
  const int n_tiles = kCausal ? min(kv_tiles, 2 * qb + kConsumers) : kv_tiles;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warp: one thread starts the loads
    if (threadIdx.x == kConsumers * 128) {
      for (int i = 0; i < 2 * n_tiles; ++i) {  // K of tile i / 2, then its V^T
        const int s = i % L::kSlots, k0 = (i >> 1) * kN;
        if (i >= L::kSlots) mbar_wait(&empty[s], ((i / L::kSlots) + 1) & 1);
        unsigned char* dst = smem + L::kRing + s * L::kSlotBytes;
        mbar_expect_tx(&full[s], L::kSlotBytes);
#pragma unroll
        for (int part = 0; part < 2; ++part) {  // hi, lo
          unsigned char* tile = dst + part * L::kTile;
          const int c2 = part * BH + bh;
          if ((i & 1) == 0) {
            tma_load_3d(tile, &kmap, &full[s], 0, k0, c2);
            if constexpr (D > 32) tma_load_3d(tile + kF32Panel, &kmap, &full[s], 32, k0, c2);
            if constexpr (D > 64) {
              tma_load_3d(tile + 2 * kF32Panel, &ktail, &full[s], 64, k0, c2);
              tma_load_3d(tile + 2 * kF32Panel + kF32TailPanel, &ktail, &full[s], 72, k0, c2);
            }
          } else {
            tma_load_3d(tile, &vmap, &full[s], k0, 0, c2);
            tma_load_3d(tile + L::kVtPanel, &vmap, &full[s], k0 + 32, 0, c2);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows r0 .. r0 + 63
  const int tid = threadIdx.x & 127, warp = tid >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = q0 + 64 * wg;
  unsigned char* q_tile = smem + wg * 2 * L::kTile;
  split_q_tile<D>(q + (size_t)bh * T * D, q_tile, q_tile + L::kTile, r0, T, prescale, tid);
  fence_proxy_async();
  bar_sync(1 + wg, 128);
  auto my_turn = [&] { bar_sync(kTurnBarrier + wg, 256); };
  auto pass_turn = [&] { bar_arrive(kTurnBarrier + 1 - wg, 256); };
  if (wg == 1) pass_turn();  // warpgroup 0 starts

  const uint32_t q_hi = smem_u32(q_tile), q_lo = q_hi + L::kTile;
  const uint32_t ring = smem_u32(smem + L::kRing);
  const int my_tiles = kCausal ? min(kv_tiles, 2 * qb + wg + 1) : n_tiles;
  const int row0 = r0 + 16 * warp + g;  // the lane's rows: row0, row0 + 8
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: the lane's part of the row sum

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int ik = 2 * kt, iv = ik + 1;
    const int sk = ik % L::kSlots, sv = iv % L::kSlots;
    const uint32_t k_hi = ring + sk * L::kSlotBytes, v_hi = ring + sv * L::kSlotBytes;
    mbar_wait(&full[sk], (ik / L::kSlots) & 1);
    if (kt < my_tiles) {
      float s[1][32], ot[D / 2], a0, a1;
      uint32_t p_hi[8][4], p_lo[8][4];
      my_turn();
      wgmma_fence();
      start_scores<D>(s[0], q_hi, q_lo, k_hi, k_hi + L::kTile);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      reg_fence(s[0]);
      mbar_arrive(&empty[sk]);
      const int k0 = kt * kN;
      if (kCausal && kt == 2 * qb + wg) {  // the diagonal tile: key > row masked
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + 8 * (i >> 2) + 2 * tq + (i & 1) > row0 + 8 * ((i >> 1) & 1)) s[0][i] = -INFINITY;
      }
      online_softmax<1>(s, k0, kv_len, tq, m0, m1, l0, l1, a0, a1);
      acc_to_a_tf32(s[0], p_hi, p_lo);
      mbar_wait(&full[sv], (iv / L::kSlots) & 1);
      my_turn();
      wgmma_fence();
      start_pv<D>(ot, p_hi, p_lo, v_hi, v_hi + L::kTile);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      reg_fence(ot);
      mbar_arrive(&empty[sv]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] = o[4 * j] * a0 + ot[4 * j];
        o[4 * j + 1] = o[4 * j + 1] * a0 + ot[4 * j + 1];
        o[4 * j + 2] = o[4 * j + 2] * a1 + ot[4 * j + 2];
        o[4 * j + 3] = o[4 * j + 3] * a1 + ot[4 * j + 3];
      }
    } else {  // causal, warpgroup 0 past its diagonal: its turns and releases only
      my_turn();
      pass_turn();
      mbar_arrive(&empty[sk]);
      mbar_wait(&full[sv], (iv / L::kSlots) & 1);
      my_turn();
      pass_turn();
      mbar_arrive(&empty[sv]);
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float* oh = out + (size_t)bh * T * D + 2 * tq;
  if (row0 < T) {
    float* dst = oh + (size_t)row0 * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (lse != nullptr && tq == 0) lse[(size_t)bh * T + row0] = m0 + log2f(d0);
  }
  if (row0 + 8 < T) {
    float* dst = oh + (size_t)(row0 + 8) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    if (lse != nullptr && tq == 0) lse[(size_t)bh * T + row0 + 8] = m1 + log2f(d1);
  }
}

// Tp: the V^T parts' key stride, T rounded up to whole 64-key tiles.
inline int padded_keys(int T) { return (T + kN - 1) / kN * kN; }

template <int D, bool kCausal>
int launch(const float* q, const float* k, const float* v, float* out, float* lse,
           float* scratch, int BH, int T, int kv_len, float prescale, cudaStream_t st) {
  using L = Layout<D>;
  const int Tp = padded_keys(T);
  uint32_t* kparts = reinterpret_cast<uint32_t*>(scratch);
  uint32_t* vparts = kparts + 2 * (size_t)BH * T * D;
  if (BH > 65535) return (int)cudaErrorInvalidConfiguration;
  flash_split_kernel<D><<<dim3(Tp / kN, BH), 256, 0, st>>>(k, v, kparts, vparts, T, Tp);
  cudaError_t err = cudaGetLastError();
  CUtensorMap kmap, ktail, vmap;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (err == cudaSuccess) err = sw128_map_3d(&kmap, f32, 4, kparts, D, T, 2 * BH, 32, kN);
  if (err == cudaSuccess && D > 64)
    err = swizzled_map_3d(&ktail, f32, 4, kparts, D, T, 2 * BH, 8, kN,
                          CU_TENSOR_MAP_SWIZZLE_32B);
  if (D <= 64) ktail = kmap;  // unread
  if (err == cudaSuccess) err = sw128_map_3d(&vmap, f32, 4, vparts, Tp, D, 2 * BH, 32, D);
  const size_t smem = L::kBytes + 1024;
  if (err == cudaSuccess) err = allow_smem(flash_forward_f32_kernel<D, kCausal>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kM - 1) / kM, BH);
  flash_forward_f32_kernel<D, kCausal><<<grid, kThreads, smem, st>>>(kmap, ktail, vmap, q, out,
                                                                      lse, T, kv_len, prescale);
  return (int)cudaGetLastError();
}

}  // namespace

// K7 in fp32: q, k, v [BH, T, D] fp32 contiguous (16-byte aligned), D 32, 64
// or 80, 1 <= kv_len <= T -> out [BH, T, D] fp32 and, when lse is not null,
// lse [BH, T] fp32 (base 2). scratch: 2 BH T D + 2 BH D Tp floats (Tp = T
// rounded up to 64), 16-byte aligned, for the pre-pass's tf32 parts of K and
// V^T (the argument the FFMA kernel's entry did not have: a kernel
// allocates nothing, so the wrapper passes it). prescale = log2(e)/sqrt(D);
// causal != 0 masks key j > query i. Two launches (the pre-pass, then the
// kernel). Returns cudaErrorInvalidValue for another D.
extern "C" int fsat_flash_forward(const float* q, const float* k, const float* v, float* out,
                                  float* lse, float* scratch, int BH, int T, int kv_len, int D,
                                  int causal, float prescale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 32 && causal)
    return launch<32, true>(q, k, v, out, lse, scratch, BH, T, kv_len, prescale, st);
  if (D == 32) return launch<32, false>(q, k, v, out, lse, scratch, BH, T, kv_len, prescale, st);
  if (D == 64 && causal)
    return launch<64, true>(q, k, v, out, lse, scratch, BH, T, kv_len, prescale, st);
  if (D == 64) return launch<64, false>(q, k, v, out, lse, scratch, BH, T, kv_len, prescale, st);
  if (D == 80 && causal)
    return launch<80, true>(q, k, v, out, lse, scratch, BH, T, kv_len, prescale, st);
  if (D == 80) return launch<80, false>(q, k, v, out, lse, scratch, BH, T, kv_len, prescale, st);
  return (int)cudaErrorInvalidValue;
}
