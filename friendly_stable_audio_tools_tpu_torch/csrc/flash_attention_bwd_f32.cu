// K9 and K8: the fp32 FlashAttention backward of head-split attention on
// [B*H, T, D] tensors as one pass over key blocks on the tensor cores
// (3xTF32 wgmma on TMA-fed tiles): K9 at D 64, causal or not, and at D 32;
// K8 at D 32 and 64 (the same kernel, its constants K8's) and D 80 (one
// warpgroup per block, below the two-warpgroup kernel).
//
// K8 replaces `_flash_backward_fused` (friendly_stable_audio_tools_tpu/ops/
// pallas/flash_attention.py:426, call :451; `_bwd_fused_kernel` :367), the
// non-causal single pass that the JAX package takes wherever its VMEM plan
// fits (:576-579; ops/kernels/flash_attention.py:backward_kernel). Per head,
// in K8's formula order (in fp32 K9's function up to rounding):
//   qs = q * log2(e)/sqrt(D), s = qs k^T, keys >= kv_len masked,
//   p = exp2(s - lse), ds = p * (dO v^T - delta) (no scale),
//   dq = (ds k)/sqrt(D), dk = (ds^T qs)/log2(e), dv = p^T dO.
// Stable Audio 1.0's U-Net trains its gated self-attention through it (B 8 x
// 16 heads: T 4096 and 2048 at D 64, T 1024 at D 80), and Dance Diffusion's
// U-Net (DAU1d: 16 heads of 32 on its 512-channel levels) from 262,144
// samples, where its attention's T 1024, 2048 and 4096 fit K8's plan (a
// 2,097,152-sample step's T 8192 takes K9). The TPU kernel keeps
// K and V of a head in VMEM and carries dk/dv across a sequential q grid;
// here, as for K9, one block owns 64 keys and loops over the q tiles. The
// FFMA kernel it replaces (PR 8's, on the CUDA cores) ran at 5.4-7.6x the
// 3xTF32 bound.
//
// K9 replaces `_flash_backward` (friendly_stable_audio_tools_tpu/ops/pallas/
// flash_attention.py:565) in its two-pass case, non-causal and causal:
// `_bwd_dq_kernel` (:477, call :605) and `_bwd_dkv_kernel` (:518, call :621),
// with `causal` their masks (:497-499, :537-539) and skipped blocks (:509-511,
// :554-557). Per head, with lse the base-2 log-sum-exp of K7 and delta =
// rowsum(dO * O) computed beside the kernel:
//   s = (q k^T) * log2(e)/8, keys >= kv_len masked (causal: keys past the
//   row's own position too), p = exp2(s - lse), dp = dO v^T,
//   ds = p * (dp - delta) / 8,  dq = ds k,  dk = ds^T q,  dv = p^T dO.
// Stable Audio 2.0's DiT trains its self-attention through it (6145 tokens
// padded to 6272, kv_len 6145, B 8 x 24 heads: the unpack route), and the
// audio LM its causal self-attention (MusicGen small: B 8 x 16 heads, T 1501).
//
// What bounds it on the H100: the products. The function needs five (s, dp,
// dv, dk, dq); at the DiT's shape that is 5 x 2 x 192 x 6145^2 x 64 = 4.64
// TFLOP, 28.1 ms at 3xTF32's 165 TFLOP/s (TF32's 495 over three passes),
// against ~0.6 ms for the bytes (q, k, v, dO, lse, delta in; dq, dk, dv out).
// The FFMA kernels this replaces ran seven products (two passes, each
// recomputing s and dp) on the CUDA cores at ~47% of their 66.9 TFLOP/s: 206
// ms, 1.5x SDPA's backward. The tensor cores keep fp32 accuracy only as
// 3xTF32: a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi with hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest, three wgmma issues per k8 slice
// (1xTF32 keeps ~3 decimal digits). The raw fp32 value also serves as hi
// (the tensor cores drop its low 13 bits) with lo = tf32(x - trunc(x)):
// within 3e-6 rel-L2 at the main shapes on the H100 but slower in this
// kernel (pair_attention_variants.py's `k9_raw_hi`; PERF.md §6).
//
// Design: FlashAttention-2/3's single pass over key blocks (attention_bwd.cu's
// skeleton for K6), q-major. A block owns 64 keys of one head: their K and V
// arrive by TMA and are split once into tf32 hi/lo tiles (hi in place), with
// K^T written beside them; all six stay in shared memory for the call. Two
// warpgroups take the head's q tiles of 64 rows in turn (warpgroup w: tiles
// w, w + 2, ...; causal: from the block's diagonal tile on, where alone keys
// past a row's position are masked). Each streams its own q and dO tiles by
// TMA through one stage (the next tile's load starts once the warpgroup has
// read the current one; the other warpgroup's products cover the wait) and,
// per tile:
//   S = q K^T, dP = dO V^T         (M = q rows, N = keys, K = head dim)
//   P and dS in registers          (the exponentials run while dP computes)
//   dV^T += dO^T P, dK^T += q^T dS (M = head dim, N = keys, K = q rows)
//   dq = dS K                      (M = q rows, N = head dim, K = keys)
// then adds its dq rows into dq (zeroed by the wrapper) by one bulk
// reduce-add per row (TMA, in L2). At the end the two warpgroups' dK^T and
// dV^T are summed in shared memory: warpgroup 0 writes dv, warpgroup 1 dk.
// What is hard in fp32, and what the arrangement does about it:
// 1. tf32 wgmma reads shared-memory operands K-major only (the transpose bits
//    exist for 16-bit types alone), and three of the five products contract
//    over the sequence. Every A operand therefore comes from registers: q and
//    dO for S and dP, loaded row by row from their TMA tiles and split there,
//    as the conv kernel splits its A (conv_wgmma.cu); dO^T and q^T for dV^T
//    and dK^T, loaded down the columns of the same tiles; dS for dq, straight
//    from its accumulator. No q-side tile is transposed or split in shared
//    memory.
// 2. Every B operand is a K-major tile pair the kernel writes: K and V (keys
//    x dims) for S and dP, K^T for dq, and P^T and dS^T for dV^T and dK^T,
//    stored from the S and dS accumulators (rows q) transposed into [keys][q]
//    hi/lo tiles.
// 3. A tf32 accumulator is not a tf32 register-A fragment: a thread holds
//    columns 8j + 2t and 8j + 2t + 1, where register A wants k positions t
//    and t + 4. The products that contract over q rows or keys therefore
//    take each k8 slice's rows in the order [0, 2, 4, 6, 1, 3, 5, 7]
//    (pos8): dS's accumulator is then dq's A as it stands (K^T's keys
//    written in that order), and P^T's and dS^T's columns are stored in it.
//    The same order makes the transposed loads of dO^T and q^T (rows 2t, 2t
//    + 1 of a 128B-swizzled tile) and the transposed stores hit 32 distinct
//    banks, where rows t, t + 4 hit 16.
// 4. The tensor cores' fp32 accumulate truncates. Summed in the accumulators
//    over SA 2.0's 6272 q rows, dK and dV would drift ~6e-5 rel-L2 from the
//    exact sums (tests/test_torch_flash_bwd_schedule.py emulates it); so each
//    q tile's dV^T and dK^T are products of their own, zeroed first and added
//    into fp32 totals in registers (~5e-7).
// Budget, written before the first card run:
// - shared memory 230,424 of the 232,448 bytes a block may use: K, V and K^T
//   hi/lo (6 x 16 KB); per warpgroup the q and dO tiles (2 x 16 KB) and one
//   hi/lo tile pair (32 KB) that holds P^T, then dS^T, then the tile's dq
//   rows for the reduce-adds (64 rows of 68 floats); 1024 bytes of alignment
//   slack and three mbarriers. One block per SM.
// - registers: 256 threads put two warps on each SM sub-partition, which
//   allows 255 registers a thread (a ninth, producer warp would put three on
//   one and allow 168, the limit of K6's layout). Live at most: the dK^T and
//   dV^T totals (64), S and dP or dS and a product's result (64), and one
//   product's A fragments (8 k8 slices x 4 x hi/lo: 64), ~200 with addresses.
// Head dim 32 (the template's other instance): a [64][32] tile (K, V, q, dO)
// is one 128B-swizzled panel, so each TMA load is one box; K^T is two panels
// of 32 rows; S and dP contract over 4 k8 slices and dq = dS K is m64n32.
// dV^T and dK^T keep the head dims on wgmma's M, which is 64 rows by
// construction: M is padded to 64 with zero rows (warps 2 and 3 load no
// fragments and give zeros; their totals are never written), which costs
// two full m64n64 products per q tile where the work needs two halves (84
// units of m64n64k8 per tile where the function needs 60: at most 71% of
// the bound). Swapping those products to keys along M (dV = P^T dO, m64n32,
// with P^T as a shared-memory A operand and dO^T, q^T staged transposed, as
// the D 80 kernel does for its last 16 dims) would remove the padding; kept
// for later, as the simple form is right first. Shared memory 148,504 bytes
// (below); the staged dq rows are 36 floats and one reduce-add moves 128
// bytes. Measured on the H100 (PERF.md §6): 22-27% of the bound at T
// 1024-8192, the dq reduce-adds 8-11% of the time (2% at D 64).
// What bounds it now (measured on the H100, PERF.md §6): about half the
// 3xTF32 bound at SA 2.0's shape. Each warpgroup runs its five products one
// after another, each waited for before the next (the exponentials overlap
// dP only), and two warpgroups per SM overlap those chains only in part;
// shared memory (~400 KB of wgmma B reads, fragment loads and tile stores
// per q tile) and the dq reduce-adds (~2% of the time) are not the limit.
//
// dq is summed in an order that changes from run to run (the key blocks'
// reduce-adds land in L2 in whatever order the blocks get there), as with K6,
// in K9 and K8 alike: it agrees between runs to fp32 rounding, not bit for
// bit. dk and dv are sums in a fixed order and bit-equal between runs.
//
// Ragged edges: q rows at or past T arrive as zero tiles (TMA) and get p = 0;
// their dq rows are never written. Keys at or past kv_len get p = 0 and so
// zero dk and dv; a block whose keys all lie there writes zeros and stops.
// Rows in [kv_len, T) are real rows (their dO is zero on the transformer's
// path).
#include "attention_tiles.cuh"

using namespace fsat_attn;

namespace {

constexpr int kConsumers = 2;               // warpgroups taking q tiles in turn
constexpr int kThreads = kConsumers * 128;  // and no producer warp (see above)
constexpr int kKeys = 64;                   // keys per block
constexpr int kQ = 64;                      // q rows per tile
constexpr int kPanel = 64 * kSwizzleRow;    // 64 rows of 32 fp32 (128 bytes): 8 KB
constexpr int kXTile = 2 * kPanel;          // P^T or dS^T, [64 keys][64 q rows]: 16 KB

// The kernel's shared memory at head dim D (32 or 64): a [64][D] tile (K, V,
// q, dO) is D / 32 panels of 64 rows, K^T [D][64 keys] two panels of D rows;
// the P^T/dS^T pairs do not depend on D.
template <int D>
struct Layout {  // byte offsets into the 1024-aligned dynamic shared memory
  static_assert(D == 32 || D == 64, "the two-warpgroup kernel takes head dim 32 or 64");
  static constexpr int kTile = 64 * D * 4;       // one [64][D] or [D][64] fp32 tile
  static constexpr int kKtPanel = D * kSwizzleRow;  // K^T: D dims x 32 key positions
  static constexpr int kStageRow = D + 4;        // a staged dq row: 36 or 68 floats
  static constexpr int k_hi = 0;                 // K [keys][dims], hi in place of the TMA tile
  static constexpr int k_lo = k_hi + kTile;
  static constexpr int v_hi = k_lo + kTile;      // V [keys][dims]
  static constexpr int v_lo = v_hi + kTile;
  static constexpr int kt_hi = v_lo + kTile;     // K^T [dims][keys]
  static constexpr int kt_lo = kt_hi + kTile;
  static constexpr int wg = kt_lo + kTile;       // then per warpgroup, at these offsets:
  static constexpr int q = 0;                    //   the q tile [rows][dims] (TMA)
  static constexpr int dout = q + kTile;         //   the dO tile
  static constexpr int x_hi = dout + kTile;      //   P^T, then dS^T [keys][rows]; then dq rows
  static constexpr int x_lo = x_hi + kXTile;
  static constexpr int wg_bytes = x_lo + kXTile;
  static constexpr int bars = wg + kConsumers * wg_bytes;  // kv_full, q_full[kConsumers]
  static constexpr int bytes = bars + (1 + kConsumers) * 8;
  static_assert(kTile % 1024 == 0 && kKtPanel % 1024 == 0, "panels on the swizzle atom");
  static_assert(kQ * kStageRow * 4 <= 2 * kXTile, "a tile's dq rows fit the hi/lo tile pair");
  static_assert(bytes + 1024 <= 232448, "one block's shared memory");
};

// Byte offset of element (row, col) of a K-major fp32 tile kept as
// 128B-swizzled panels of 32 columns, `panel` bytes apart: what TMA boxes of
// 32 columns write, and the layout wgmma reads (rows along M or N, columns
// along K). K^T has panels of D rows (80 at D 80, the dims 64-79 tiles 16).
__device__ __forceinline__ uint32_t t_off(int row, int col, int panel) {
  return (col >> 5) * panel + sw128_offset(row, (col & 31) >> 2) + (col & 3) * 4;
}

// The same for a tile of 64 rows (K, V, q, dO, P^T, dS^T).
__device__ __forceinline__ uint32_t tile_off(int row, int col) {
  return t_off(row, col, kPanel);
}

// The A operand of a product from an fp32 tile of 64 rows, times `scale`
// and split into tf32 hi and lo. Without kTrans (S, dP: M = q rows, K = the
// D head dims): fragment (kk, e), kk < D / 8, is element (m, k) = (16 warp +
// g + 8 (e & 1), 8 kk + t + 4 (e >> 1)) read as tile[m][k]. With kTrans
// (dV^T, dK^T: M = head dims, K = 64 q rows): the element of position k in
// the permuted order (row 8 kk + 2t + (e >> 1)) read as tile[row][m]; M is
// 64 whatever D is, so at D 32 the rows m >= 32 (warps 2 and 3) are zeros.
template <bool kTrans, int D>
__device__ __forceinline__ void load_a(const unsigned char* tile, int warp, int g, int t,
                                       float scale, uint32_t (&hi)[8][4], uint32_t (&lo)[8][4]) {
  constexpr int kSlices = kTrans ? 8 : D / 8;
  if (kTrans && 16 * warp >= D) {  // warp-uniform: the padded rows of M
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[kk][e] = lo[kk][e] = 0u;
    return;
  }
#pragma unroll
  for (int kk = 0; kk < kSlices; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 16 * warp + g + 8 * (e & 1);
      const uint32_t off = kTrans ? tile_off(8 * kk + 2 * t + (e >> 1), m)
                                  : tile_off(m, 8 * kk + t + 4 * (e >> 1));
      split_tf32(*reinterpret_cast<const float*>(tile + off) * scale, hi[kk][e], lo[kk][e]);
    }
}

// d = A B, m64nN, over kSlices k8 slices (d zeroed by the first issue),
// 3xTF32: per slice a_lo b_hi, a_hi b_lo, a_hi b_hi. B: a K-major hi/lo tile
// pair whose 128B-swizzled panels of 32 k positions lie kPanelBytes apart.
template <int N, int kSlices, int kPanelBytes>
__device__ __forceinline__ void product(float (&d)[N / 2], const uint32_t (&hi)[8][4],
                                        const uint32_t (&lo)[8][4], uint32_t b_hi, uint32_t b_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSlices; ++kk) {
    const uint32_t off = (kk >> 2) * kPanelBytes + (kk & 3) * 32;
    wgmma_tf32<N>(d, lo[kk], kmajor_desc(b_hi + off), kk > 0);
    wgmma_tf32<N>(d, hi[kk], kmajor_desc(b_lo + off), 1);
    wgmma_tf32<N>(d, hi[kk], kmajor_desc(b_hi + off), 1);
  }
  wgmma_commit();
}

// Waits for the warpgroup's products and fences their accumulator.
template <int N>
__device__ __forceinline__ void finish(float (&d)[N]) {
  wgmma_wait<0>();
  reg_fence(d);
}

// A 64 x 64 accumulator (element i: row m = 16 warp + g + 8 ((i >> 1) & 1),
// column n = 8 (i >> 2) + 2t + (i & 1)) stored transposed into a hi/lo tile
// pair: row n, the m order permuted (column pos8(m)).
__device__ __forceinline__ void store_t(const float (&d)[32], unsigned char* hi_tile,
                                        unsigned char* lo_tile, int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int m = 16 * warp + g + 8 * ((i >> 1) & 1), n = 8 * (i >> 2) + 2 * t + (i & 1);
    const uint32_t off = tile_off(n, pos8(m));
    uint32_t hi, lo;
    split_tf32(d[i], hi, lo);
    *reinterpret_cast<uint32_t*>(hi_tile + off) = hi;
    *reinterpret_cast<uint32_t*>(lo_tile + off) = lo;
  }
}

// Rows r0 .. r0 + 63 of one head's [T, D] tensor through `map` into a [64][D]
// tile: D / 32 boxes of 32 dims.
template <int D>
__device__ __forceinline__ void load_rows(unsigned char* tile, const CUtensorMap* map,
                                          uint64_t* bar, int r0, int bh) {
#pragma unroll
  for (int p = 0; p < D / 32; ++p) tma_load_3d(tile + p * kPanel, map, bar, 32 * p, r0, bh);
}

// Rows q0 .. q0 + 63 of one head's q and dO into a warpgroup's tiles.
template <int D>
__device__ __forceinline__ void load_q_tile(unsigned char* wg_smem, uint64_t* bar,
                                            const CUtensorMap* qmap, const CUtensorMap* dmap,
                                            int q0, int bh) {
  mbar_expect_tx(bar, 2 * Layout<D>::kTile);
  load_rows<D>(wg_smem + Layout<D>::q, qmap, bar, q0, bh);
  load_rows<D>(wg_smem + Layout<D>::dout, dmap, bar, q0, bh);
}

// The constants of the two formulas (1 where a formula has none: an exact
// multiply, which the kernels take as a compile-time 1). K9: q as it is, s =
// (q k^T) log2(e)/sqrt(D), ds = p (dp - delta)/sqrt(D), dq = ds k, dk = ds^T
// q. K8 (`_bwd_fused_kernel`): qs = q log2(e)/sqrt(D) (the A operand of S
// and of dK^T), s = qs k^T, ds = p (dp - delta), dq = (ds k)/sqrt(D), dk =
// (ds^T qs)/log2(e).
struct Scales {
  float q, s, ds, dq, dk;
};

template <int D, bool kCausal, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap dmap, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int T, int kv_len,
                     Scales given) {
  using L = Layout<D>;
  // the constants each formula lacks are compile-time ones (no multiply)
  const Scales sc = kFused ? Scales{given.q, 1.f, 1.f, given.dq, given.dk}
                           : Scales{1.f, given.s, given.ds, 1.f, 1.f};
  const int kb = blockIdx.x, bh = blockIdx.y, k0 = kb * kKeys;
  const size_t head = (size_t)bh * T * D;
  if (k0 >= kv_len) {  // every key of the block masked: zero gradients
    for (int i = threadIdx.x; i < kKeys * D; i += kThreads) {
      const int r = k0 + i / D;
      if (r < T) dk[head + (size_t)r * D + i % D] = dv[head + (size_t)r * D + i % D] = 0.f;
    }
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint64_t* q_full = kv_full + 1 + wg;
  unsigned char* mine = smem + L::wg + wg * L::wg_bytes;
  const int n_q = (T + kQ - 1) / kQ;
  const int q_first = (kCausal ? kb : 0) + wg;
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kConsumers; ++i) mbar_init(kv_full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 2 * L::kTile);
    load_rows<D>(smem + L::k_hi, &kmap, kv_full, k0, bh);
    load_rows<D>(smem + L::v_hi, &vmap, kv_full, k0, bh);
  }
  if (tid == 0 && q_first < n_q) load_q_tile<D>(mine, q_full, &qmap, &dmap, q_first * kQ, bh);

  // K and V split into hi (in place) and lo; K^T beside them, its keys in
  // the permuted order
  mbar_wait(kv_full, 0);
  for (int i = threadIdx.x; i < kKeys * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const uint32_t off = tile_off(r, c), off_t = t_off(c, pos8(r), L::kKtPanel);
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
  const uint32_t x_hi = smem_u32(mine + L::x_hi), x_lo = smem_u32(mine + L::x_lo);
  float* staged = reinterpret_cast<float*>(mine + L::x_hi);
  const float* lse_bh = lse + (size_t)bh * T;
  const float* delta_bh = delta + (size_t)bh * T;
  const int bar = 1 + wg;  // the warpgroup's named barrier
  float tot_k[32], tot_v[32];  // dK^T, dV^T: 64 (padded) dims x 64 keys
#pragma unroll
  for (int i = 0; i < 32; ++i) tot_k[i] = tot_v[i] = 0.f;

  int it = 0;
  for (int qt = q_first; qt < n_q; qt += kConsumers, ++it) {
    const int q0 = qt * kQ;
    const bool diag = kCausal && qt == kb;  // keys past a row's own position are masked
    const int r0 = q0 + 16 * warp + g;      // the lane's rows: r0, r0 + 8
    float lse_r[2], del_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse_r[h] = r0 + 8 * h < T ? lse_bh[r0 + 8 * h] : 0.f;
      del_r[h] = r0 + 8 * h < T ? delta_bh[r0 + 8 * h] : 0.f;
    }
    uint32_t a_hi[8][4], a_lo[8][4];
    float s[32], dp[32], part[32], part_q[D / 2];  // each written first by a zeroing issue
    mbar_wait(q_full, it & 1);

    // S = q K^T, then dP = dO V^T while p = exp2(s log2(e)/sqrt(D) - lse)
    load_a<false, D>(mine + L::q, warp, g, t, sc.q, a_hi, a_lo);
    product<64, D / 8, kPanel>(s, a_hi, a_lo, s_base + L::k_hi, s_base + L::k_lo);
    finish(s);
    load_a<false, D>(mine + L::dout, warp, g, t, 1.f, a_hi, a_lo);
    product<64, D / 8, kPanel>(dp, a_hi, a_lo, s_base + L::v_hi, s_base + L::v_lo);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r0 + 8 * ((i >> 1) & 1), key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const bool keep = (key < kv_len) & (row < T) & !(diag & (key > row));
      s[i] = keep ? ex2(s[i] * sc.s - lse_r[(i >> 1) & 1]) : 0.f;
    }
    finish(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - del_r[(i >> 1) & 1]) * sc.ds;

    // dV^T += dO^T P, with P^T in the tile pair once the last tile's dq rows
    // have been read from it
    if (tid < kQ) bulk_wait_read<0>();
    bar_sync(bar, 128);
    store_t(s, mine + L::x_hi, mine + L::x_lo, warp, g, t);
    fence_proxy_async();
    bar_sync(bar, 128);
    load_a<true, D>(mine + L::dout, warp, g, t, 1.f, a_hi, a_lo);
    product<64, 8, kPanel>(part, a_hi, a_lo, x_hi, x_lo);
    finish(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) tot_v[i] += part[i];

    // dK^T += q^T dS, with dS^T in the tile pair; the stage is free once the
    // q^T fragments are read, so the warpgroup's next tile is loaded
    bar_sync(bar, 128);  // every lane's dV^T product has read P^T
    store_t(dp, mine + L::x_hi, mine + L::x_lo, warp, g, t);
    fence_proxy_async();
    load_a<true, D>(mine + L::q, warp, g, t, sc.q, a_hi, a_lo);
    bar_sync(bar, 128);  // dS^T stored, q and dO read
    if (tid == 0 && qt + kConsumers < n_q)
      load_q_tile<D>(mine, q_full, &qmap, &dmap, (qt + kConsumers) * kQ, bh);
    product<64, 8, kPanel>(part, a_hi, a_lo, x_hi, x_lo);
    finish(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) tot_k[i] += part[i];

    // dq = dS K (m64nD) with dS from its accumulator, staged as 64 rows and
    // added into dq by one bulk reduce-add per row
    acc_to_a_tf32(dp, a_hi, a_lo);
    product<D, 8, L::kKtPanel>(part_q, a_hi, a_lo, s_base + L::kt_hi, s_base + L::kt_lo);
    finish(part_q);
    bar_sync(bar, 128);  // every lane's dK^T product has read dS^T
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(staged + (16 * warp + g + 8 * h) * L::kStageRow + 8 * j + 2 * t) =
            make_float2(part_q[4 * j + 2 * h] * sc.dq, part_q[4 * j + 2 * h + 1] * sc.dq);
    fence_proxy_async();
    bar_sync(bar, 128);
    if (tid < kQ && q0 + tid < T)
      bulk_reduce_add_f32(dq + head + (size_t)(q0 + tid) * D, staged + tid * L::kStageRow, D * 4);
  }

  // epilogue: warpgroup 0 writes dv and warpgroup 1 dk, each adding the
  // other's total (through its tile pair, in register order: conflict-free)
  if (tid < kQ) bulk_wait_all();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 32; ++i) staged[i * 128 + tid] = wg == 0 ? tot_k[i] : tot_v[i];
  __syncthreads();
  const unsigned char* other = smem + L::wg + (1 - wg) * L::wg_bytes;
  const float* theirs = reinterpret_cast<const float*>(other + L::x_hi);
  float* out = (wg == 0 ? dv : dk) + head;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int d = 16 * warp + g + 8 * ((i >> 1) & 1), key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
    const float val = wg == 0 ? tot_v[i] + theirs[i * 128 + tid]
                              : (tot_k[i] + theirs[i * 128 + tid]) * sc.dk;
    if (d < D && key < T) out[(size_t)key * D + d] = val;
  }
}

// A map over a [BH, T, D] fp32 tensor whose boxes are 64 rows of 32 dims,
// 128B-swizzled: coordinates (dim, t, bh); rows at or past T read as zeros.
inline cudaError_t rows_map(CUtensorMap* map, const float* base, int D, int T, int BH) {
  return sw128_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, D, T, BH, 32, 64);
}

template <int D, bool kCausal, bool kFused>
int launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
           const float* delta, float* dq, float* dk, float* dv, int BH, int T, int kv_len,
           Scales sc, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap, dmap;
  cudaError_t err = rows_map(&qmap, q, D, T, BH);
  if (err == cudaSuccess) err = rows_map(&kmap, k, D, T, BH);
  if (err == cudaSuccess) err = rows_map(&vmap, v, D, T, BH);
  if (err == cudaSuccess) err = rows_map(&dmap, dout, D, T, BH);
  const size_t smem = Layout<D>::bytes + 1024;
  if (err == cudaSuccess) err = allow_smem(flash_bwd_f32_kernel<D, kCausal, kFused>, smem);
  if (err != cudaSuccess) return (int)err;
  if (BH > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((T + kKeys - 1) / kKeys, BH);
  flash_bwd_f32_kernel<D, kCausal, kFused><<<grid, kThreads, smem, st>>>(
      qmap, kmap, vmap, dmap, lse, delta, dq, dk, dv, T, kv_len, sc);
  return (int)cudaGetLastError();
}

// ---- K8 at head dim 80: one warpgroup per block -------------------------------
//
// K9's arrangement at D 64 does not fit at D 80: the resident K, V and K^T
// tiles grow to 120 KB and each warpgroup's q, dO and P^T/dS^T tiles to 72
// KB, so a block holds one consumer warpgroup (128 threads: 255 registers).
// The products over head dims as M (dV^T, dK^T) take dims 0-63 as K9 does;
// dims 64-79 come from products with the keys as M instead: dV[:, 64:80] =
// P^T dO[:, 64:80] and dK[:, 64:80] = dS^T q'[:, 64:80] (m64n16), A the P^T
// and dS^T tiles the kernel already writes (K-major: [keys][q rows]) and B
// the 16 dims' dO^T and q'^T (K-major: [16][q rows], q in the pos8 order),
// written per q tile. S and dP contract over 80 dims: 8 k8 slices in the
// 128B-swizzled panels, 2 in the 32B-swizzled ones; dq = dS K (B the K^T
// tile) is one m64n80 product per slice. Nothing is padded: the work is D 80's.
// Budget: 214,032 bytes of shared memory (below); registers, live at most:
// the dK^T/dV^T totals and the dims 64-79 totals (80), S and dP (64) and
// one product's A fragments (80 for S and dP over 10 slices). Measured: 255
// registers, 408 bytes of spill stores; 26% of the 3xTF32 bound at BH128 T1024 (PERF.md §6): one
// warpgroup per SM, so the tensor cores idle through every exponential,
// store and transpose, where K9's second warpgroup covers them.
constexpr int kD80 = 80;
constexpr int kRowTile80 = 64 * kD80 * 4;     // a [64][80] fp32 tile (f32_row_off's layout)
constexpr int kKtPanel80 = kD80 * kSwizzleRow;  // K^T: 80 dims x 32 key positions
constexpr int kTailT = 16 * kSwizzleRow;      // 16 dims x 32 q positions
constexpr int kStageRow80 = kD80 + 4;         // a staged dq row: 84 floats (336 bytes)

struct Layout80 {  // byte offsets into the 1024-aligned dynamic shared memory
  static constexpr int k_hi = 0;                  // K [keys][dims], hi in place of the TMA tile
  static constexpr int k_lo = k_hi + kRowTile80;
  static constexpr int v_hi = k_lo + kRowTile80;  // V [keys][dims]
  static constexpr int v_lo = v_hi + kRowTile80;
  static constexpr int kt_hi = v_lo + kRowTile80;  // K^T [dims][key positions]
  static constexpr int kt_lo = kt_hi + 2 * kKtPanel80;
  static constexpr int q = kt_lo + 2 * kKtPanel80;  // the q tile [rows][dims] (TMA)
  static constexpr int dout = q + kRowTile80;        // the dO tile
  static constexpr int x_hi = dout + kRowTile80;     // P^T, then dS^T [keys][q]; then dq rows
  static constexpr int x_lo = x_hi + kXTile;
  static constexpr int dot_hi = x_lo + kXTile;        // dO[:, 64:80]^T [16][q positions]
  static constexpr int dot_lo = dot_hi + 2 * kTailT;
  static constexpr int qt_hi = dot_lo + 2 * kTailT;  // q'[:, 64:80]^T
  static constexpr int qt_lo = qt_hi + 2 * kTailT;
  static constexpr int bars = qt_lo + 2 * kTailT;    // kv_full, q_full
  static constexpr int bytes = bars + 2 * 8;
};
static_assert(kQ * kStageRow80 * 4 <= 2 * kXTile, "a tile's dq rows fit the hi/lo tile pair");
static_assert(Layout80::bytes + 1024 <= 232448, "one block's shared memory");

// The A operand of S or dP at D 80 from a [64][80] fp32 tile, times
// `scale`, split: fragment (kk, e) is element (16 warp + g + 8 (e & 1), 8 kk
// + t + 4 (e >> 1)).
__device__ __forceinline__ void load_a80(const unsigned char* tile, int warp, int g, int t,
                                         float scale, uint32_t (&hi)[10][4],
                                         uint32_t (&lo)[10][4]) {
#pragma unroll
  for (int kk = 0; kk < 10; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = f32_row_elem(16 * warp + g + 8 * (e & 1), 8 * kk + t + 4 * (e >> 1));
      split_tf32(*reinterpret_cast<const float*>(tile + off) * scale, hi[kk][e], lo[kk][e]);
    }
}

// d = A B over 80 dims, 3xTF32: B a [64][80] hi/lo row tile pair.
__device__ __forceinline__ void product80(float (&d)[32], const uint32_t (&hi)[10][4],
                                          const uint32_t (&lo)[10][4], uint32_t b_hi,
                                          uint32_t b_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 10; ++kk) {
    wgmma_tf32<64>(d, lo[kk], f32_row_desc(b_hi, kk), kk > 0);
    wgmma_tf32<64>(d, hi[kk], f32_row_desc(b_lo, kk), 1);
    wgmma_tf32<64>(d, hi[kk], f32_row_desc(b_hi, kk), 1);
  }
  wgmma_commit();
}

// d = A B, m64n16 over 64 q rows, A (keys x q positions) and B (16 dims x q
// positions) K-major hi/lo tile pairs in shared memory.
__device__ __forceinline__ void product_tail(float (&d)[8], uint32_t a_hi, uint32_t a_lo,
                                             uint32_t b_hi, uint32_t b_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t oa = (kk >> 2) * kPanel + (kk & 3) * 32, ob = (kk >> 2) * kTailT + (kk & 3) * 32;
    wgmma_tf32_ss16(d, kmajor_desc(a_lo + oa), kmajor_desc(b_hi + ob), kk > 0);
    wgmma_tf32_ss16(d, kmajor_desc(a_hi + oa), kmajor_desc(b_lo + ob), 1);
    wgmma_tf32_ss16(d, kmajor_desc(a_hi + oa), kmajor_desc(b_hi + ob), 1);
  }
  wgmma_commit();
}

// dq = dS K, m64n80 over the block's 64 keys (pos8 order): B the K^T pair.
__device__ __forceinline__ void product_dq80(float (&d)[40], const uint32_t (&hi)[8][4],
                                             const uint32_t (&lo)[8][4], uint32_t b_hi,
                                             uint32_t b_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk >> 2) * kKtPanel80 + (kk & 3) * 32;
    wgmma_tf32<80>(d, lo[kk], kmajor_desc(b_hi + off), kk > 0);
    wgmma_tf32<80>(d, hi[kk], kmajor_desc(b_lo + off), 1);
    wgmma_tf32<80>(d, hi[kk], kmajor_desc(b_hi + off), 1);
  }
  wgmma_commit();
}

// Dims 64-79 of a [64][80] tile, times `scale`, transposed and split into a
// [16][q positions] hi/lo pair (row r at position pos8(r)).
__device__ __forceinline__ void store_tail_t(const unsigned char* tile, unsigned char* hi_tile,
                                             unsigned char* lo_tile, float scale, int tid) {
#pragma unroll
  for (int it = 0; it < 16 * 64 / 128; ++it) {
    const int d = (tid >> 6) + 2 * it, r = tid & 63;
    const uint32_t off = t_off(d, pos8(r), kTailT);
    uint32_t hi, lo;
    split_tf32(*reinterpret_cast<const float*>(tile + f32_row_elem(r, 64 + d)) * scale, hi, lo);
    *reinterpret_cast<uint32_t*>(hi_tile + off) = hi;
    *reinterpret_cast<uint32_t*>(lo_tile + off) = lo;
  }
}

// Rows r0 .. r0 + 63 of a [BH, T, 80] tensor into a [64][80] tile: two
// 128B-swizzled boxes of 32 dims, two 32B-swizzled ones of 8.
__device__ __forceinline__ void load_rows80(unsigned char* tile, const CUtensorMap* map,
                                            const CUtensorMap* tail, uint64_t* bar, int r0,
                                            int bh) {
  tma_load_3d(tile, map, bar, 0, r0, bh);
  tma_load_3d(tile + kF32Panel, map, bar, 32, r0, bh);
  tma_load_3d(tile + 2 * kF32Panel, tail, bar, 64, r0, bh);
  tma_load_3d(tile + 2 * kF32Panel + kF32TailPanel, tail, bar, 72, r0, bh);
}

struct Maps80 {  // per tensor: the 128B-swizzled map and the 32B-swizzled one
  CUtensorMap q, q_tail, k, k_tail, v, v_tail, d, d_tail;
};

__global__ void __launch_bounds__(128, 1)
flash_bwd_fused_d80_kernel(const __grid_constant__ Maps80 maps, const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ dq,
                           float* __restrict__ dk, float* __restrict__ dv, int T, int kv_len,
                           Scales given) {
  using L = Layout80;
  const Scales sc{given.q, 1.f, 1.f, given.dq, given.dk};  // K8's: s and ds take no constant
  const int kb = blockIdx.x, bh = blockIdx.y, k0 = kb * kKeys;
  const size_t head = (size_t)bh * T * kD80;
  const int tid = threadIdx.x;
  if (k0 >= kv_len) {  // every key of the block masked: zero gradients
    for (int i = tid; i < kKeys * kD80; i += 128) {
      const int r = k0 + i / kD80;
      if (r < T) dk[head + (size_t)r * kD80 + i % kD80] = dv[head + (size_t)r * kD80 + i % kD80] = 0.f;
    }
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* q_full = kv_full + 1;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_q = (T + kQ - 1) / kQ;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_full, 2 * kRowTile80);
    load_rows80(smem + L::k_hi, &maps.k, &maps.k_tail, kv_full, k0, bh);
    load_rows80(smem + L::v_hi, &maps.v, &maps.v_tail, kv_full, k0, bh);
    mbar_expect_tx(q_full, 2 * kRowTile80);
    load_rows80(smem + L::q, &maps.q, &maps.q_tail, q_full, 0, bh);
    load_rows80(smem + L::dout, &maps.d, &maps.d_tail, q_full, 0, bh);
  }

  // K and V split into hi (in place) and lo; K^T beside them, its keys in
  // the pos8 order
  mbar_wait(kv_full, 0);
  for (int i = tid; i < kKeys * kD80; i += 128) {
    const int r = i / kD80, c = i % kD80;
    const uint32_t off = f32_row_elem(r, c), off_t = t_off(c, pos8(r), kKtPanel80);
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
  const uint32_t x_hi = s_base + L::x_hi, x_lo = s_base + L::x_lo;
  float* staged = reinterpret_cast<float*>(smem + L::x_hi);
  const float* lse_bh = lse + (size_t)bh * T;
  const float* delta_bh = delta + (size_t)bh * T;
  float tot_k[32], tot_v[32], tail_k[8], tail_v[8];  // dK^T, dV^T dims 0-63; dK, dV dims 64-79
#pragma unroll
  for (int i = 0; i < 32; ++i) tot_k[i] = tot_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) tail_k[i] = tail_v[i] = 0.f;

  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * kQ;
    const int r0 = q0 + 16 * warp + g;  // the lane's rows: r0, r0 + 8
    float lse_r[2], del_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse_r[h] = r0 + 8 * h < T ? lse_bh[r0 + 8 * h] : 0.f;
      del_r[h] = r0 + 8 * h < T ? delta_bh[r0 + 8 * h] : 0.f;
    }
    float s[32], dp[32], part[32], part_t[8];  // each written first by a zeroing issue
    mbar_wait(q_full, qt & 1);
    {
      uint32_t a_hi[10][4], a_lo[10][4];
      // S = q' K^T, then dP = dO V^T while p = exp2(s - lse)
      load_a80(smem + L::q, warp, g, t, sc.q, a_hi, a_lo);
      product80(s, a_hi, a_lo, s_base + L::k_hi, s_base + L::k_lo);
      finish(s);
      load_a80(smem + L::dout, warp, g, t, 1.f, a_hi, a_lo);
      product80(dp, a_hi, a_lo, s_base + L::v_hi, s_base + L::v_lo);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = r0 + 8 * ((i >> 1) & 1), key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool keep = (key < kv_len) & (row < T);
        s[i] = keep ? ex2(s[i] * sc.s - lse_r[(i >> 1) & 1]) : 0.f;
      }
      finish(dp);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - del_r[(i >> 1) & 1]) * sc.ds;

    // P^T and the 16 dims' dO^T and q'^T into their tiles, once the last
    // tile's dq rows have been read from the P^T pair
    if (tid < kQ) bulk_wait_read<0>();
    __syncthreads();
    store_t(s, smem + L::x_hi, smem + L::x_lo, warp, g, t);
    store_tail_t(smem + L::dout, smem + L::dot_hi, smem + L::dot_lo, 1.f, tid);
    store_tail_t(smem + L::q, smem + L::qt_hi, smem + L::qt_lo, sc.q, tid);
    fence_proxy_async();
    __syncthreads();
    {
      // dV^T (dims 0-63) += dO^T P; dV (dims 64-79) += P^T dO[:, 64:80]
      uint32_t a_hi[8][4], a_lo[8][4];
      load_a<true, 64>(smem + L::dout, warp, g, t, 1.f, a_hi, a_lo);  // dims 0-63
      product<64, 8, kPanel>(part, a_hi, a_lo, x_hi, x_lo);
      product_tail(part_t, x_hi, x_lo, s_base + L::dot_hi, s_base + L::dot_lo);
      wgmma_wait<0>();
      reg_fence(part);
      reg_fence(part_t);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) tot_v[i] += part[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) tail_v[i] += part_t[i];

    // dK^T (dims 0-63) += q'^T dS; dK (dims 64-79) += dS^T q'[:, 64:80]; the
    // q and dO tiles are free once q'^T is read, so the next tile's load starts
    __syncthreads();  // every lane's dV products have read P^T
    store_t(dp, smem + L::x_hi, smem + L::x_lo, warp, g, t);
    fence_proxy_async();
    {
      uint32_t a_hi[8][4], a_lo[8][4];
      load_a<true, 64>(smem + L::q, warp, g, t, sc.q, a_hi, a_lo);  // dims 0-63
      __syncthreads();  // dS^T stored, q and dO read
      if (tid == 0 && qt + 1 < n_q) {
        mbar_expect_tx(q_full, 2 * kRowTile80);
        load_rows80(smem + L::q, &maps.q, &maps.q_tail, q_full, q0 + kQ, bh);
        load_rows80(smem + L::dout, &maps.d, &maps.d_tail, q_full, q0 + kQ, bh);
      }
      product<64, 8, kPanel>(part, a_hi, a_lo, x_hi, x_lo);
      product_tail(part_t, x_hi, x_lo, s_base + L::qt_hi, s_base + L::qt_lo);
      wgmma_wait<0>();
      reg_fence(part);
      reg_fence(part_t);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) tot_k[i] += part[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) tail_k[i] += part_t[i];

    // dq = dS K with dS from its accumulator, staged as 64 rows and added
    // into dq by one bulk reduce-add per row
    float part_q[40];
    {
      uint32_t a_hi[8][4], a_lo[8][4];
      acc_to_a_tf32(dp, a_hi, a_lo);
      product_dq80(part_q, a_hi, a_lo, s_base + L::kt_hi, s_base + L::kt_lo);
      wgmma_wait<0>();
      reg_fence(part_q);
    }
    __syncthreads();  // every lane's dK products have read dS^T
#pragma unroll
    for (int j = 0; j < 10; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(staged + (16 * warp + g + 8 * h) * kStageRow80 + 8 * j + 2 * t) =
            make_float2(part_q[4 * j + 2 * h] * sc.dq, part_q[4 * j + 2 * h + 1] * sc.dq);
    fence_proxy_async();
    __syncthreads();
    if (tid < kQ && q0 + tid < T)
      bulk_reduce_add_f32(dq + head + (size_t)(q0 + tid) * kD80, staged + tid * kStageRow80,
                          kD80 * 4);
  }
  if (tid < kQ) bulk_wait_all();

  // dims 0-63 from the dK^T/dV^T totals (rows dims, columns keys), dims
  // 64-79 from the tails (rows keys, columns dims)
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int d = 16 * warp + g + 8 * ((i >> 1) & 1), key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (key < T) {
      dv[head + (size_t)key * kD80 + d] = tot_v[i];
      dk[head + (size_t)key * kD80 + d] = tot_k[i] * sc.dk;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + 16 * warp + g + 8 * ((i >> 1) & 1), d = 64 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (key < T) {
      dv[head + (size_t)key * kD80 + d] = tail_v[i];
      dk[head + (size_t)key * kD80 + d] = tail_k[i] * sc.dk;
    }
  }
}

// The two maps over a [BH, T, 80] fp32 tensor: boxes of 64 rows x 32 dims
// (128B swizzle) and 64 rows x 8 dims (32B swizzle); rows past T read as zeros.
inline cudaError_t rows_maps80(CUtensorMap* map, CUtensorMap* tail, const float* base, int T,
                               int BH) {
  cudaError_t err = sw128_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, kD80, T, BH, 32, 64);
  if (err != cudaSuccess) return err;
  return swizzled_map_3d(tail, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, kD80, T, BH, 8, 64,
                         CU_TENSOR_MAP_SWIZZLE_32B);
}

int launch_fused_d80(const float* q, const float* k, const float* v, const float* dout,
                     const float* lse, const float* delta, float* dq, float* dk, float* dv, int BH,
                     int T, int kv_len, Scales sc, cudaStream_t st) {
  Maps80 maps;
  cudaError_t err = rows_maps80(&maps.q, &maps.q_tail, q, T, BH);
  if (err == cudaSuccess) err = rows_maps80(&maps.k, &maps.k_tail, k, T, BH);
  if (err == cudaSuccess) err = rows_maps80(&maps.v, &maps.v_tail, v, T, BH);
  if (err == cudaSuccess) err = rows_maps80(&maps.d, &maps.d_tail, dout, T, BH);
  const size_t smem = Layout80::bytes + 1024;
  if (err == cudaSuccess) err = allow_smem(flash_bwd_fused_d80_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (BH > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((T + kKeys - 1) / kKeys, BH);
  flash_bwd_fused_d80_kernel<<<grid, 128, smem, st>>>(maps, lse, delta, dq, dk, dv, T, kv_len, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// K9: q, k, v, out's dO [BH, T, D] fp32 contiguous (16-byte aligned), D 64
// (causal or not) or 32 (not causal), lse/delta [BH, T] fp32, 1 <= kv_len <=
// T -> dk, dv [BH, T, D] fp32, and dq [BH, T, D] fp32 added into (the caller
// zeroes it). scale_log2e = log2(e)/sqrt(D), scale = 1/sqrt(D); causal != 0
// masks key j > query i. One launch. Returns cudaErrorInvalidValue for
// another D, and for a causal call at D 32.
extern "C" int fsat_flash_backward(const float* q, const float* k, const float* v,
                                   const float* dout, const float* lse, const float* delta,
                                   float* dq, float* dk, float* dv, int BH, int T, int kv_len,
                                   int D, int causal, float scale_log2e, float scale,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Scales sc{1.f, scale_log2e, scale, 1.f, 1.f};
  if (D == 64 && causal)
    return launch<64, true, false>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T, kv_len, sc, st);
  if (D == 64)
    return launch<64, false, false>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T, kv_len, sc, st);
  if (D == 32 && !causal)
    return launch<32, false, false>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T, kv_len, sc, st);
  return (int)cudaErrorInvalidValue;
}

// K8: q, k, v, out's dO [BH, T, D] fp32 contiguous (16-byte aligned), D 32,
// 64 or 80, lse/delta [BH, T] fp32, 1 <= kv_len <= T -> dk, dv [BH, T, D]
// fp32, and dq [BH, T, D] fp32 added into (the caller zeroes it). prescale =
// log2(e)/sqrt(D), scale = 1/sqrt(D). One launch. Returns
// cudaErrorInvalidValue for another D.
extern "C" int fsat_flash_backward_fused(const float* q, const float* k, const float* v,
                                         const float* dout, const float* lse, const float* delta,
                                         float* dq, float* dk, float* dv, int BH, int T,
                                         int kv_len, int D, float prescale, float scale,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Scales sc{prescale, 1.f, 1.f, scale, 1.f / kLog2e};
  if (D == 32)
    return launch<32, false, true>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T, kv_len, sc, st);
  if (D == 64)
    return launch<64, false, true>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T, kv_len, sc, st);
  if (D == 80)
    return launch_fused_d80(q, k, v, dout, lse, delta, dq, dk, dv, BH, T, kv_len, sc, st);
  return (int)cudaErrorInvalidValue;
}
