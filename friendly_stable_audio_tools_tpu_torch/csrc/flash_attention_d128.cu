// The fp32 K7 and K8 at head dim 128, on the tensor cores (3xTF32 wgmma on
// TMA-fed tiles): the forward of head-split attention on [B*H, T, 128]
// tensors with its base-2 log-sum-exp or without (K7), and its single-pass
// backward (K8).
//
// K7 replaces `_flash_forward` (friendly_stable_audio_tools_tpu/ops/pallas/
// flash_attention.py:230, call :317; `_single_dot_kernel` :121 with
// `_single_dot_core` :93, and `_online_kernel` :146 beyond 8192 keys) on fp32
// inputs at head dim 128, not causal; per head, q' = q * log2(e)/sqrt(D):
//   s = q' k^T, keys >= kv_len masked, m = rowmax(s), p = exp2(s - m),
//   l = rowsum(p), out = (p v) / max(l, 1e-30), lse = m + log2(max(l, 1e-30)).
// K8 replaces `_flash_backward_fused` (flash_attention.py:426, call :451;
// `_bwd_fused_kernel` :367) at head dim 128; per head, in its order:
//   qs = q * log2(e)/sqrt(D), s = qs k^T, keys >= kv_len masked,
//   p = exp2(s - lse), ds = p * (dO v^T - delta) (no scale),
//   dq = (ds k)/sqrt(D), dk = (ds^T qs)/log2(e), dv = p^T dO.
// Caller: a DiT with heads of 128 under grad (SAO 1.0's config with 12 heads:
// B 8 x 12 heads, T 1025, through the unpack route of ops/kernels/
// attention.py: K7 with its LSE, then K8, whose plan fits at T 1025). Both
// kernels are the D 64 designs of flash_attention.cu and
// flash_attention_bwd_f32.cu (same tiles, same 3xTF32 products, the
// same pos8 order of the products that contract over keys or q rows)
// rearranged for what a D 128 tile costs in shared memory.
//
// What bounds them on the H100: the products, which must stay fp32-accurate
// (1xTF32 keeps ~3 decimal digits), so each is 3xTF32: hi = tf32(x), lo =
// tf32(x - hi) rounded to nearest, a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi,
// at TF32's 495 TFLOP/s over three passes. At B 8 x 12 heads and T 1025 the
// forward's two products are 51.6 GFLOP (0.313 ms), the backward's five
// 129.1 GFLOP (0.782 ms), against ~0.2 ms of bytes.
//
// K7's arrangement. flash_attention.cu holds q' hi/lo for two consumer
// warpgroups and a ring of K or V^T hi/lo tile pairs; at D 128 a [64][128]
// fp32 tile is 32 KB, so two warpgroups' q' take 128 KB and each ring slot
// 64 KB, which leaves one slot under the 232,448 bytes a block may use: the
// producer could then load a tile only after the consumers released the last
// one. Here a block has one consumer warpgroup of 64 q rows (64 KB of q')
// and a ring of two slots (128 KB): the next K or V^T tile arrives while the
// current one is used. With 160 threads (the consumer warpgroup and the
// producer warp) ptxas allows 255 registers a thread, which holds the O
// total and a tile's P.V (64 each), P's hi/lo fragments (64) and S (32)
// beside them. One warpgroup per SM leaves the tensor cores idle during the
// softmax and the O update, where the D 64 kernel's second warpgroup covers
// them: a simple arrangement that is right first (the pre-pass and the
// per-tile P.V totals as in flash_attention.cu).
// - Pre-pass (`split_d128_kernel`): K as tf32 hi/lo [2][BH][T][128] and V^T
//   as hi/lo [2][BH][128][Tp] (keys in the pos8 order, Tp = T rounded up to
//   64, keys at or past T zero) into the wrapper's scratch.
// - Per key tile: S = q' K^T (16 k8 slices of m64n64, three issues each),
//   the online base-2 softmax, P split into hi/lo register fragments, the
//   tile's P.V (m64n128, 8 slices) added into the fp32 O totals.
// Budget, written before the first card run: shared memory 64 KB of q' +
// 2 x 64 KB of ring + 4 mbarriers = 196,640 bytes and 1024 of slack;
// registers ~210 of 255. Measured (ptxas, nvcc 12.9): 207, no spills.
//
// K8's arrangement. The D 64 kernel keeps K, V and K^T hi/lo of 64 keys
// resident (6 x 32 KB at D 128: no room left for the q and dO tiles). Here a
// block owns 32 keys and one warpgroup takes the head's q tiles of 64 rows
// one after the other; per q tile:
//   S = qs K^T, dP = dO V^T   (M 64 q rows, N 32 keys, K 128 dims: 16 k8
//                              slices, the A fragments loaded 8 at a time)
//   P and dS in registers
//   dV^T += dO^T P, dK^T += qs^T dS   (M 128 dims as two m64 products, N 32
//                              keys, K 64 q rows: no padding)
//   dq = dS K                 (M 64 q rows, N 128 dims, K 32 keys: m64n128)
// and adds its dq rows into dq (zeroed by the wrapper) by one bulk
// reduce-add per row. dV^T and dK^T are totals per q tile added in fp32
// registers (the tensor cores' accumulate truncates), as in the D 64 kernel.
// Budget, written before the first card run, shared memory (bytes): K, V and
// K^T hi/lo 6 x 16,384; the q and dO tiles 2 x 32,768; P^T and dS^T hi/lo 4 x
// 8,192; the staged dq rows 64 x 132 x 4 = 33,792; 2 mbarriers: 230,416, and
// 1024 of slack: 231,440 of 232,448. Registers (128 threads: ptxas allows
// 255): the dK^T/dV^T totals 64, S and dS 32, one product's A fragments 64
// and dq's accumulator 64: ~180 live at most. Measured (ptxas): 235, no
// spills.
//
// dq is summed in an order that changes from run to run (the key blocks'
// reduce-adds land in L2 in whatever order they arrive); dk and dv are
// bit-equal between runs.
//
// Ragged edges: q rows at or past T arrive as zero tiles (TMA) and get p =
// 0; their rows are never written. Keys at or past kv_len get p = 0 and so
// zero dk and dv; a K8 block whose keys all lie there writes zeros and stops.
#include "attention_tiles.cuh"

using namespace fsat_attn;

namespace {

constexpr int kDim = 128;
constexpr int kRows = 64;                     // q rows of a warpgroup's tile
constexpr int kTile128 = 64 * kDim * 4;       // a [64][128] fp32 tile: four 128B panels of 32 dims
constexpr int kVtPanel = kDim * kSwizzleRow;  // V^T: 128 dims x 32 key positions

// Byte offset of element (r, c) of a K-major fp32 tile kept as 128B-swizzled
// panels of 32 columns, `panel` bytes apart (what TMA boxes of 32 columns
// write, and what wgmma reads).
__device__ __forceinline__ uint32_t panel_off(int r, int c, int panel) {
  return (c >> 5) * panel + sw128_offset(r, (c & 31) >> 2) + (c & 3) * 4;
}

// ---- K7 ---------------------------------------------------------------------

constexpr int kFwdThreads = 128 + 32;  // one consumer warpgroup and a producer warp
constexpr int kFwdKeys = 64;           // keys per tile
constexpr int kFwdSlots = 2;           // ring slots, each a K or V^T hi/lo tile pair

struct FwdLayout {  // byte offsets into the 1024-aligned dynamic shared memory
  static constexpr int q_hi = 0;  // q' [rows][dims]
  static constexpr int q_lo = q_hi + kTile128;
  static constexpr int ring = q_lo + kTile128;
  static constexpr int slot = 2 * kTile128;  // hi, then lo
  static constexpr int bars = ring + kFwdSlots * slot;  // full[kFwdSlots], empty[kFwdSlots]
  static constexpr int bytes = bars + 2 * kFwdSlots * 8;
};
static_assert(kTile128 % 1024 == 0 && kVtPanel % 1024 == 0, "panels on the swizzle atom");
static_assert(FwdLayout::bytes + 1024 <= 232448, "one block's shared memory");

// K -> hi/lo [2][BH][T][128], V -> V^T hi/lo [2][BH][128][Tp] with each 8 keys
// in the pos8 order (keys at or past T zero). One block per 64 keys of a head.
__global__ void __launch_bounds__(256)
split_d128_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  uint32_t* __restrict__ kparts, uint32_t* __restrict__ vparts, int T, int Tp) {
  __shared__ float vs[kFwdKeys][kDim + 1];
  const int bh = blockIdx.y, k0 = blockIdx.x * kFwdKeys;
  const size_t head = (size_t)bh * T * kDim, kpart = (size_t)gridDim.y * T * kDim;
  for (int i = threadIdx.x; i < kFwdKeys * kDim; i += 256) {
    const int r = i / kDim, c = i % kDim;
    float x = 0.f;
    if (k0 + r < T) {
      const size_t at = head + (size_t)(k0 + r) * kDim + c;
      uint32_t hi, lo;
      split_tf32(k[at], hi, lo);
      kparts[at] = hi;
      kparts[kpart + at] = lo;
      x = v[at];
    }
    vs[r][c] = x;
  }
  __syncthreads();
  const size_t vhead = (size_t)bh * kDim * Tp, vpart = (size_t)gridDim.y * kDim * Tp;
  for (int i = threadIdx.x; i < kFwdKeys * kDim; i += 256) {
    const int d = i / kFwdKeys, r = i % kFwdKeys;
    const size_t at = vhead + (size_t)d * Tp + k0 + pos8(r);
    uint32_t hi, lo;
    split_tf32(vs[r][d], hi, lo);
    vparts[at] = hi;
    vparts[vpart + at] = lo;
  }
}

// Rows [r0, r0 + 64) of one head's q, times prescale in fp32, split into the
// hi/lo tiles; rows at or past T are zero.
__device__ __forceinline__ void split_q(const float* __restrict__ qh, unsigned char* hi_tile,
                                       unsigned char* lo_tile, int r0, int T, float prescale,
                                       int tid) {
  constexpr int kVec = kDim / 4;  // 16-byte chunks per row
#pragma unroll 4
  for (int it = 0; it < kRows * kVec / 128; ++it) {
    const int i = tid + it * 128, r = i / kVec, c = (i % kVec) * 4;
    float4 in = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) in = *reinterpret_cast<const float4*>(qh + (size_t)(r0 + r) * kDim + c);
    uint4 hi, lo;
    split_tf32(in.x * prescale, hi.x, lo.x);
    split_tf32(in.y * prescale, hi.y, lo.y);
    split_tf32(in.z * prescale, hi.z, lo.z);
    split_tf32(in.w * prescale, hi.w, lo.w);
    const uint32_t off = panel_off(r, c, kF32Panel);
    *reinterpret_cast<uint4*>(hi_tile + off) = hi;
    *reinterpret_cast<uint4*>(lo_tile + off) = lo;
  }
}

// K-major descriptor of k8 slice kk (dims 8 kk .. 8 kk + 7) of a [64][128] tile.
__device__ __forceinline__ uint64_t slice_desc(uint32_t tile, int kk) {
  return kmajor_desc(tile + (kk >> 2) * kF32Panel + (kk & 3) * 32);
}

__global__ void __launch_bounds__(kFwdThreads, 1)
flash_forward_d128_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const float* __restrict__ q,
                          float* __restrict__ out, float* __restrict__ lse, int T, int kv_len,
                          float prescale) {
  using L = FwdLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kFwdSlots;
  const int bh = blockIdx.y, BH = gridDim.y, q0 = blockIdx.x * kRows;
  const int n_tiles = (kv_len + kFwdKeys - 1) / kFwdKeys;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp: one thread starts the loads
    if (threadIdx.x == 128) {
      for (int i = 0; i < 2 * n_tiles; ++i) {  // K of tile i / 2, then its V^T
        const int s = i % kFwdSlots, k0 = (i >> 1) * kFwdKeys;
        if (i >= kFwdSlots) mbar_wait(&empty[s], ((i / kFwdSlots) + 1) & 1);
        unsigned char* dst = smem + L::ring + s * L::slot;
        mbar_expect_tx(&full[s], L::slot);
#pragma unroll
        for (int part = 0; part < 2; ++part) {  // hi, lo
          unsigned char* tile = dst + part * kTile128;
          const int c2 = part * BH + bh;
          if ((i & 1) == 0) {
#pragma unroll
            for (int p = 0; p < kDim / 32; ++p)
              tma_load_3d(tile + p * kF32Panel, &kmap, &full[s], 32 * p, k0, c2);
          } else {
            tma_load_3d(tile, &vmap, &full[s], k0, 0, c2);
            tma_load_3d(tile + kVtPanel, &vmap, &full[s], k0 + 32, 0, c2);
          }
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  split_q(q + (size_t)bh * T * kDim, smem + L::q_hi, smem + L::q_lo, q0, T, prescale, tid);
  fence_proxy_async();
  bar_sync(1, 128);

  const uint32_t q_hi = smem_u32(smem + L::q_hi), q_lo = smem_u32(smem + L::q_lo);
  const uint32_t ring = smem_u32(smem + L::ring);
  const int row0 = q0 + 16 * warp + g;  // the lane's rows: row0, row0 + 8
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: the lane's part of the row sum

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int ik = 2 * kt, iv = ik + 1;
    const int sk = ik % kFwdSlots, sv = iv % kFwdSlots;
    const uint32_t k_hi = ring + sk * L::slot, v_hi = ring + sv * L::slot;
    float s[1][32], ot[64], a0, a1;
    uint32_t p_hi[8][4], p_lo[8][4];
    mbar_wait(&full[sk], (ik / kFwdSlots) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDim / 8; ++kk) {  // S = q' K^T, 3xTF32
      wgmma_tf32_ss(s[0], slice_desc(q_lo, kk), slice_desc(k_hi, kk), kk > 0);
      wgmma_tf32_ss(s[0], slice_desc(q_hi, kk), slice_desc(k_hi + kTile128, kk), 1);
      wgmma_tf32_ss(s[0], slice_desc(q_hi, kk), slice_desc(k_hi, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s[0]);
    mbar_arrive(&empty[sk]);
    online_softmax<1>(s, kt * kFwdKeys, kv_len, tq, m0, m1, l0, l1, a0, a1);
    acc_to_a_tf32(s[0], p_hi, p_lo);
    mbar_wait(&full[sv], (iv / kFwdSlots) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {  // the tile's P V^T over its 64 keys (pos8 order)
      const uint32_t off = (kk >> 2) * kVtPanel + (kk & 3) * 32;
      wgmma_tf32<128>(ot, p_lo[kk], kmajor_desc(v_hi + off), kk > 0);
      wgmma_tf32<128>(ot, p_hi[kk], kmajor_desc(v_hi + kTile128 + off), 1);
      wgmma_tf32<128>(ot, p_hi[kk], kmajor_desc(v_hi + off), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(ot);
    mbar_arrive(&empty[sv]);
#pragma unroll
    for (int j = 0; j < kDim / 8; ++j) {
      o[4 * j] = o[4 * j] * a0 + ot[4 * j];
      o[4 * j + 1] = o[4 * j + 1] * a0 + ot[4 * j + 1];
      o[4 * j + 2] = o[4 * j + 2] * a1 + ot[4 * j + 2];
      o[4 * j + 3] = o[4 * j + 3] * a1 + ot[4 * j + 3];
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float* oh = out + (size_t)bh * T * kDim + 2 * tq;
  if (row0 < T) {
    float* dst = oh + (size_t)row0 * kDim;
#pragma unroll
    for (int j = 0; j < kDim / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (lse != nullptr && tq == 0) lse[(size_t)bh * T + row0] = m0 + log2f(d0);
  }
  if (row0 + 8 < T) {
    float* dst = oh + (size_t)(row0 + 8) * kDim;
#pragma unroll
    for (int j = 0; j < kDim / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    if (lse != nullptr && tq == 0) lse[(size_t)bh * T + row0 + 8] = m1 + log2f(d1);
  }
}

// ---- K8 ---------------------------------------------------------------------

constexpr int kBwdKeys = 32;                      // keys per block
constexpr int kKeyPanel = kBwdKeys * kSwizzleRow;  // 32 rows of 32 fp32: 4 KB
constexpr int kKeyTile = kBwdKeys * kDim * 4;     // K or V [32 keys][128 dims]: four panels
constexpr int kKtTile = kDim * kBwdKeys * 4;      // K^T [128 dims][32 key positions]: one panel
constexpr int kXTile = kBwdKeys * kRows * 4;      // P^T or dS^T [32 keys][64 q positions]
constexpr int kStageRow = kDim + 4;               // a staged dq row: 132 floats

struct BwdLayout {  // byte offsets into the 1024-aligned dynamic shared memory
  static constexpr int k_hi = 0;                 // K [keys][dims], hi in place of the TMA tile
  static constexpr int k_lo = k_hi + kKeyTile;
  static constexpr int v_hi = k_lo + kKeyTile;   // V [keys][dims]
  static constexpr int v_lo = v_hi + kKeyTile;
  static constexpr int kt_hi = v_lo + kKeyTile;  // K^T [dims][key positions]
  static constexpr int kt_lo = kt_hi + kKtTile;
  static constexpr int q = kt_lo + kKtTile;      // the q tile [rows][dims] (TMA)
  static constexpr int dout = q + kTile128;      // the dO tile
  static constexpr int pt_hi = dout + kTile128;  // P^T [keys][q positions]
  static constexpr int pt_lo = pt_hi + kXTile;
  static constexpr int st_hi = pt_lo + kXTile;   // dS^T [keys][q positions]
  static constexpr int st_lo = st_hi + kXTile;
  static constexpr int staged = st_lo + kXTile;  // the tile's dq rows for the reduce-adds
  static constexpr int bars = staged + kRows * kStageRow * 4;  // kv_full, q_full
  static constexpr int bytes = bars + 2 * 8;
};
static_assert(kKeyTile % 1024 == 0 && kKtTile % 1024 == 0 && kXTile % 1024 == 0,
              "tiles on the swizzle atom");
static_assert(BwdLayout::bytes + 1024 <= 232448, "one block's shared memory");

// The A operand of S or dP from 8 of the 16 k8 slices (chunk c: dims 64 c ..
// 64 c + 63) of a [64][128] tile, times `scale`, split: fragment (kk, e) is
// element (16 warp + g + 8 (e & 1), 64 c + 8 kk + t + 4 (e >> 1)).
__device__ __forceinline__ void load_rows_a(const unsigned char* tile, int c, int warp, int g,
                                            int t, float scale, uint32_t (&hi)[8][4],
                                            uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = panel_off(16 * warp + g + 8 * (e & 1), 64 * c + 8 * kk + t + 4 * (e >> 1),
                                     kF32Panel);
      split_tf32(*reinterpret_cast<const float*>(tile + off) * scale, hi[kk][e], lo[kk][e]);
    }
}

// The A operand of dV^T or dK^T (M: dims 64 h .. 64 h + 63, K: the 64 q rows
// in the pos8 order) from a [64][128] tile, times `scale`, split: fragment
// (kk, e) is element (row 8 kk + 2t + (e >> 1), dim 64 h + 16 warp + g + 8 (e & 1)).
__device__ __forceinline__ void load_cols_a(const unsigned char* tile, int h, int warp, int g,
                                            int t, float scale, uint32_t (&hi)[8][4],
                                            uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = panel_off(8 * kk + 2 * t + (e >> 1), 64 * h + 16 * warp + g + 8 * (e & 1),
                                     kF32Panel);
      split_tf32(*reinterpret_cast<const float*>(tile + off) * scale, hi[kk][e], lo[kk][e]);
    }
}

// d (+)= A B over 8 k8 slices, m64nN, 3xTF32; B a K-major hi/lo tile pair
// whose 128B-swizzled panels of 32 k positions lie `panel` bytes apart,
// starting at slice `first`; d is zeroed by the first issue unless `accumulate`.
template <int N>
__device__ __forceinline__ void product(float (&d)[N / 2], const uint32_t (&hi)[8][4],
                                        const uint32_t (&lo)[8][4], uint32_t b_hi, uint32_t b_lo,
                                        int panel, int first, int accumulate) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int k = first + kk;
    const uint32_t off = (k >> 2) * panel + (k & 3) * 32;
    wgmma_tf32<N>(d, lo[kk], kmajor_desc(b_hi + off), accumulate || kk > 0);
    wgmma_tf32<N>(d, hi[kk], kmajor_desc(b_lo + off), 1);
    wgmma_tf32<N>(d, hi[kk], kmajor_desc(b_hi + off), 1);
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void finish(float (&d)[N]) {
  wgmma_wait<0>();
  reg_fence(d);
}

// A 64 x 32 accumulator (element i: row m = 16 warp + g + 8 ((i >> 1) & 1),
// column n = 8 (i >> 2) + 2t + (i & 1)) stored transposed into a hi/lo tile
// pair: row n, the m order permuted (column pos8(m)).
__device__ __forceinline__ void store_t(const float (&d)[16], unsigned char* hi_tile,
                                        unsigned char* lo_tile, int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int m = 16 * warp + g + 8 * ((i >> 1) & 1), n = 8 * (i >> 2) + 2 * t + (i & 1);
    const uint32_t off = panel_off(n, pos8(m), kKeyPanel);
    uint32_t hi, lo;
    split_tf32(d[i], hi, lo);
    *reinterpret_cast<uint32_t*>(hi_tile + off) = hi;
    *reinterpret_cast<uint32_t*>(lo_tile + off) = lo;
  }
}

// Rows r0 .. r0 + rows - 1 of one head's [T, 128] tensor through `map` into
// a tile of four panels `panel` bytes apart.
__device__ __forceinline__ void load_rows(unsigned char* tile, const CUtensorMap* map,
                                          uint64_t* bar, int r0, int bh, int panel) {
#pragma unroll
  for (int p = 0; p < kDim / 32; ++p) tma_load_3d(tile + p * panel, map, bar, 32 * p, r0, bh);
}

__global__ void __launch_bounds__(128, 1)
flash_bwd_fused_d128_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap dmap,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, float* __restrict__ dk,
                            float* __restrict__ dv, int T, int kv_len, float prescale,
                            float scale, float dk_scale) {
  using L = BwdLayout;
  const int kb = blockIdx.x, bh = blockIdx.y, k0 = kb * kBwdKeys;
  const size_t head = (size_t)bh * T * kDim;
  const int tid = threadIdx.x;
  if (k0 >= kv_len) {  // every key of the block masked: zero gradients
    for (int i = tid; i < kBwdKeys * kDim; i += 128) {
      const int r = k0 + i / kDim;
      if (r < T) dk[head + (size_t)r * kDim + i % kDim] = dv[head + (size_t)r * kDim + i % kDim] = 0.f;
    }
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* q_full = kv_full + 1;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_q = (T + kRows - 1) / kRows;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_full, 2 * kKeyTile);
    load_rows(smem + L::k_hi, &kmap, kv_full, k0, bh, kKeyPanel);
    load_rows(smem + L::v_hi, &vmap, kv_full, k0, bh, kKeyPanel);
    mbar_expect_tx(q_full, 2 * kTile128);
    load_rows(smem + L::q, &qmap, q_full, 0, bh, kF32Panel);
    load_rows(smem + L::dout, &dmap, q_full, 0, bh, kF32Panel);
  }

  // K and V split into hi (in place) and lo; K^T beside them, its keys in
  // the pos8 order
  mbar_wait(kv_full, 0);
  for (int i = tid; i < kBwdKeys * kDim; i += 128) {
    const int r = i / kDim, c = i % kDim;
    const uint32_t off = panel_off(r, c, kKeyPanel), off_t = panel_off(c, pos8(r), kKtTile);
    uint32_t hi, lo;
    split_tf32(*reinterpret_cast<const float*>(smem + L::k_hi + off), hi, lo);
    *reinterpret_cast<uint32_t*>(smem + L::k_hi + off) = hi;
    *reinterpret_cast<uint32_t*>(smem + L::k_lo + off) = lo;
    *reinterpret_cast<uint32_t*>(smem + L::kt_hi + off_t) = hi;
    *reinterpret_cast<uint32_t*>(smem + L::kt_lo + off_t) = lo;
    split_tf32(*reinterpret_cast<const float*>(smem + L::v_hi + off), hi, lo);
    *reinterpret_cast<uint32_t*>(smem + L::v_hi + off) = hi;
    *reinterpret_cast<uint32_t*>(smem + L::v_lo + off) = lo;
  }
  fence_proxy_async();
  __syncthreads();

  const uint32_t s_base = smem_u32(smem);
  float* staged = reinterpret_cast<float*>(smem + L::staged);
  const float* lse_bh = lse + (size_t)bh * T;
  const float* delta_bh = delta + (size_t)bh * T;
  float tot_k[2][16], tot_v[2][16];  // dK^T, dV^T: dims 64 h .. 64 h + 63 x 32 keys
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 16; ++i) tot_k[h][i] = tot_v[h][i] = 0.f;

  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * kRows;
    const int r0 = q0 + 16 * warp + g;  // the lane's rows: r0, r0 + 8
    float lse_r[2], del_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse_r[h] = r0 + 8 * h < T ? lse_bh[r0 + 8 * h] : 0.f;
      del_r[h] = r0 + 8 * h < T ? delta_bh[r0 + 8 * h] : 0.f;
    }
    float s[16], dp[16], part[16];  // each written first by a zeroing issue
    mbar_wait(q_full, qt & 1);
    {
      uint32_t a_hi[8][4], a_lo[8][4];
      // S = qs K^T, then dP = dO V^T, each over two halves of the head dims
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        load_rows_a(smem + L::q, c, warp, g, t, prescale, a_hi, a_lo);
        product<32>(s, a_hi, a_lo, s_base + L::k_hi, s_base + L::k_lo, kKeyPanel, 8 * c, c);
        finish(s);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int row = r0 + 8 * ((i >> 1) & 1), key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        s[i] = (key < kv_len) & (row < T) ? ex2(s[i] - lse_r[(i >> 1) & 1]) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        load_rows_a(smem + L::dout, c, warp, g, t, 1.f, a_hi, a_lo);
        product<32>(dp, a_hi, a_lo, s_base + L::v_hi, s_base + L::v_lo, kKeyPanel, 8 * c, c);
        finish(dp);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) dp[i] = s[i] * (dp[i] - del_r[(i >> 1) & 1]);

    // P^T and dS^T into their tiles (the last tile's products read them
    // before their waits, which every lane has passed)
    __syncthreads();
    store_t(s, smem + L::pt_hi, smem + L::pt_lo, warp, g, t);
    store_t(dp, smem + L::st_hi, smem + L::st_lo, warp, g, t);
    fence_proxy_async();
    __syncthreads();
    {
      uint32_t a_hi[8][4], a_lo[8][4];
      // dV^T += dO^T P, by halves of the head dims
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        load_cols_a(smem + L::dout, h, warp, g, t, 1.f, a_hi, a_lo);
        product<32>(part, a_hi, a_lo, s_base + L::pt_hi, s_base + L::pt_lo, kKeyPanel, 0, 0);
        finish(part);
#pragma unroll
        for (int i = 0; i < 16; ++i) tot_v[h][i] += part[i];
      }
      // dK^T += qs^T dS; the q and dO tiles are free once the last q^T
      // fragments are read, so the next tile's load starts there
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        load_cols_a(smem + L::q, h, warp, g, t, prescale, a_hi, a_lo);
        if (h == 1) {
          __syncthreads();  // every lane has read q and dO
          if (tid == 0 && qt + 1 < n_q) {
            mbar_expect_tx(q_full, 2 * kTile128);
            load_rows(smem + L::q, &qmap, q_full, q0 + kRows, bh, kF32Panel);
            load_rows(smem + L::dout, &dmap, q_full, q0 + kRows, bh, kF32Panel);
          }
        }
        product<32>(part, a_hi, a_lo, s_base + L::st_hi, s_base + L::st_lo, kKeyPanel, 0, 0);
        finish(part);
#pragma unroll
        for (int i = 0; i < 16; ++i) tot_k[h][i] += part[i];
      }
    }

    // dq = dS K (m64n128 over the block's 32 keys, pos8 order) with dS from
    // its accumulator, staged as 64 rows and added into dq by one bulk
    // reduce-add per row
    float part_q[64];
    {
      uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(dp[4 * kk + 2 * (e & 1) + (e >> 1)], a_hi[kk][e], a_lo[kk][e]);
      const uint32_t b_hi = s_base + L::kt_hi, b_lo = s_base + L::kt_lo;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32<128>(part_q, a_lo[kk], kmajor_desc(b_hi + kk * 32), kk > 0);
        wgmma_tf32<128>(part_q, a_hi[kk], kmajor_desc(b_lo + kk * 32), 1);
        wgmma_tf32<128>(part_q, a_hi[kk], kmajor_desc(b_hi + kk * 32), 1);
      }
      wgmma_commit();
      finish(part_q);
    }
    if (tid < kRows) bulk_wait_read<0>();  // the last tile's reduce-adds have read the rows
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kDim / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(staged + (16 * warp + g + 8 * h) * kStageRow + 8 * j + 2 * t) =
            make_float2(part_q[4 * j + 2 * h] * scale, part_q[4 * j + 2 * h + 1] * scale);
    fence_proxy_async();
    __syncthreads();
    if (tid < kRows && q0 + tid < T)
      bulk_reduce_add_f32(dq + head + (size_t)(q0 + tid) * kDim, staged + tid * kStageRow, kDim * 4);
  }
  if (tid < kRows) bulk_wait_all();

  // dK^T and dV^T totals: rows dims, columns keys
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int d = 64 * h + 16 * warp + g + 8 * ((i >> 1) & 1);
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (key < T) {
        dv[head + (size_t)key * kDim + d] = tot_v[h][i];
        dk[head + (size_t)key * kDim + d] = tot_k[h][i] * dk_scale;
      }
    }
}

// A map over a [BH, T, 128] fp32 tensor (or [2 BH, T, 128] of tf32 parts)
// whose boxes are `rows` rows of 32 dims, 128B-swizzled: coordinates (dim,
// t, bh); rows at or past T read as zeros.
inline cudaError_t rows_map(CUtensorMap* map, const void* base, int T, int n, int rows) {
  return sw128_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, kDim, T, n, 32, rows);
}

}  // namespace

// K7 in fp32 at head dim 128, not causal: q, k, v [BH, T, 128] fp32
// contiguous (16-byte aligned), 1 <= kv_len <= T -> out [BH, T, 128] fp32
// and, when lse is not null, lse [BH, T] fp32 (base 2). scratch: 2 BH T 128
// + 2 BH 128 Tp floats (Tp = T rounded up to 64), 16-byte aligned, for the
// pre-pass's tf32 parts of K and V^T. prescale = log2(e)/sqrt(128). Two
// launches (the pre-pass, then the kernel).
extern "C" int fsat_flash_forward_d128(const float* q, const float* k, const float* v, float* out,
                                       float* lse, float* scratch, int BH, int T, int kv_len,
                                       float prescale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (BH > 65535 || T < 1 || kv_len < 1 || kv_len > T) return (int)cudaErrorInvalidValue;
  const int Tp = (T + kFwdKeys - 1) / kFwdKeys * kFwdKeys;
  uint32_t* kparts = reinterpret_cast<uint32_t*>(scratch);
  uint32_t* vparts = kparts + 2 * (size_t)BH * T * kDim;
  split_d128_kernel<<<dim3(Tp / kFwdKeys, BH), 256, 0, st>>>(k, v, kparts, vparts, T, Tp);
  cudaError_t err = cudaGetLastError();
  CUtensorMap kmap, vmap;
  if (err == cudaSuccess) err = rows_map(&kmap, kparts, T, 2 * BH, kFwdKeys);
  if (err == cudaSuccess)
    err = sw128_map_3d(&vmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, vparts, Tp, kDim, 2 * BH, 32,
                       kDim);
  const size_t smem = FwdLayout::bytes + 1024;
  if (err == cudaSuccess) err = allow_smem(flash_forward_d128_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kRows - 1) / kRows, BH);
  flash_forward_d128_kernel<<<grid, kFwdThreads, smem, st>>>(kmap, vmap, q, out, lse, T, kv_len,
                                                              prescale);
  return (int)cudaGetLastError();
}

// K8 at head dim 128: q, k, v, out's dO [BH, T, 128] fp32 contiguous
// (16-byte aligned), lse/delta [BH, T] fp32, 1 <= kv_len <= T -> dk, dv [BH,
// T, 128] fp32, and dq [BH, T, 128] fp32 added into (the caller zeroes it).
// prescale = log2(e)/sqrt(128), scale = 1/sqrt(128). One launch.
extern "C" int fsat_flash_backward_fused_d128(const float* q, const float* k, const float* v,
                                              const float* dout, const float* lse,
                                              const float* delta, float* dq, float* dk, float* dv,
                                              int BH, int T, int kv_len, float prescale,
                                              float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (BH > 65535 || T < 1 || kv_len < 1 || kv_len > T) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap, dmap;
  cudaError_t err = rows_map(&qmap, q, T, BH, kRows);
  if (err == cudaSuccess) err = rows_map(&kmap, k, T, BH, kBwdKeys);
  if (err == cudaSuccess) err = rows_map(&vmap, v, T, BH, kBwdKeys);
  if (err == cudaSuccess) err = rows_map(&dmap, dout, T, BH, kRows);
  const size_t smem = BwdLayout::bytes + 1024;
  if (err == cudaSuccess) err = allow_smem(flash_bwd_fused_d128_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kBwdKeys - 1) / kBwdKeys, BH);
  flash_bwd_fused_d128_kernel<<<grid, 128, smem, st>>>(qmap, kmap, vmap, dmap, lse, delta, dq, dk,
                                                       dv, T, kv_len, prescale, scale,
                                                       1.f / kLog2e);
  return (int)cudaGetLastError();
}
