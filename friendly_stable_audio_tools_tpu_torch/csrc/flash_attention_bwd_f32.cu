// K9: the fp32 FlashAttention backward of head-split attention on [B*H, T,
// 64] tensors, causal or not, as one pass over key blocks on the tensor cores
// (3xTF32 wgmma on TMA-fed tiles).
//
// Replaces `_flash_backward` (friendly_stable_audio_tools_tpu/ops/pallas/
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
// What bounds it now (measured on the H100, PERF.md §6): about half the
// 3xTF32 bound at SA 2.0's shape. Each warpgroup runs its five products one
// after another, each waited for before the next (the exponentials overlap
// dP only), and two warpgroups per SM overlap those chains only in part;
// shared memory (~400 KB of wgmma B reads, fragment loads and tile stores
// per q tile) and the dq reduce-adds (~2% of the time) are not the limit.
//
// dq is summed in an order that changes from run to run (the key blocks'
// reduce-adds land in L2 in whatever order the blocks get there), as with K8
// and K6: it agrees between runs to fp32 rounding, not bit for bit. dk and dv
// are sums in a fixed order and bit-equal between runs.
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
constexpr int kTile = 2 * kPanel;           // 64 x 64 fp32 as two panels: 16 KB
constexpr int kStageRow = kD + 4;           // a staged dq row: 68 floats (272 bytes)

struct Layout {  // byte offsets into the 1024-aligned dynamic shared memory
  static constexpr int k_hi = 0;              // K [keys][dims], hi in place of the TMA tile
  static constexpr int k_lo = k_hi + kTile;
  static constexpr int v_hi = k_lo + kTile;   // V [keys][dims]
  static constexpr int v_lo = v_hi + kTile;
  static constexpr int kt_hi = v_lo + kTile;  // K^T [dims][keys]
  static constexpr int kt_lo = kt_hi + kTile;
  static constexpr int wg = kt_lo + kTile;    // then per warpgroup, at these offsets:
  static constexpr int q = 0;                 //   the q tile [rows][dims] (TMA)
  static constexpr int dout = q + kTile;      //   the dO tile
  static constexpr int x_hi = dout + kTile;   //   P^T, then dS^T [keys][rows]; then dq rows
  static constexpr int x_lo = x_hi + kTile;
  static constexpr int wg_bytes = x_lo + kTile;
  static constexpr int bars = wg + kConsumers * wg_bytes;  // kv_full, q_full[kConsumers]
  static constexpr int bytes = bars + (1 + kConsumers) * 8;
};
static_assert(kQ * kStageRow * 4 <= 2 * kTile, "a tile's dq rows fit the hi/lo tile pair");
static_assert(Layout::bytes + 1024 <= 232448, "one block's shared memory");

// Byte offset of element (row, col) of a 64 x 64 fp32 tile kept as two
// 128B-swizzled panels of 32 columns: what two TMA boxes of 32 x 64 write,
// and the K-major layout wgmma reads (rows along M or N, columns along K).
__device__ __forceinline__ uint32_t tile_off(int row, int col) {
  return (col >> 5) * kPanel + sw128_offset(row, (col & 31) >> 2) + (col & 3) * 4;
}

// The k order of the products that contract over q rows (dV^T, dK^T) or
// keys (dq): within each 8, k position p holds row sigma(p) = 2p (p < 4) or
// 2(p - 4) + 1, and row r sits at position pos(r). An accumulator's column
// pair (8j + 2t, 8j + 2t + 1) is then exactly a register-A fragment's
// positions (t, t + 4), and a thread's transposed loads (rows 2t, 2t + 1 of
// a 128B-swizzled tile) hit 32 distinct banks where rows t, t + 4 hit 16.
__device__ __forceinline__ int pos8(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// x = hi + lo to ~2^-22: hi = tf32(x), lo = tf32(x - hi), rounded to nearest.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The A operand of a 64 x 64 x 64 product from an fp32 tile, split into
// tf32 hi and lo: fragment (kk, e) is element (m, k) = (16 warp + g + 8 (e &
// 1), 8 kk + t + 4 (e >> 1)) read as tile[m][k]; with kTrans, the element of
// position k in the permuted order (row 8 kk + 2t + (e >> 1)) read as
// tile[row][m].
template <bool kTrans>
__device__ __forceinline__ void load_a(const unsigned char* tile, int warp, int g, int t,
                                       uint32_t (&hi)[8][4], uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 16 * warp + g + 8 * (e & 1);
      const uint32_t off = kTrans ? tile_off(8 * kk + 2 * t + (e >> 1), m)
                                  : tile_off(m, 8 * kk + t + 4 * (e >> 1));
      split_tf32(*reinterpret_cast<const float*>(tile + off), hi[kk][e], lo[kk][e]);
    }
}

// The A operand from a 64 x 64 accumulator in registers (rows m, columns
// the k rows in the permuted order): fragment (kk, e) is the accumulator's
// row 16 warp + g + 8 (e & 1), column 8 kk + 2t + (e >> 1).
__device__ __forceinline__ void acc_to_a_tf32(const float (&d)[32], uint32_t (&hi)[8][4],
                                              uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(d[4 * kk + 2 * (e & 1) + (e >> 1)], hi[kk][e], lo[kk][e]);
}

// d = A B over 64 deep (d zeroed by the first issue), 3xTF32: per k8 slice
// a_lo b_hi, a_hi b_lo, a_hi b_hi. B: a K-major hi/lo tile pair.
__device__ __forceinline__ void product(float (&d)[32], const uint32_t (&hi)[8][4],
                                        const uint32_t (&lo)[8][4], uint32_t b_hi, uint32_t b_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk >> 2) * kPanel + (kk & 3) * 32;
    wgmma_tf32<64>(d, lo[kk], kmajor_desc(b_hi + off), kk > 0);
    wgmma_tf32<64>(d, hi[kk], kmajor_desc(b_lo + off), 1);
    wgmma_tf32<64>(d, hi[kk], kmajor_desc(b_hi + off), 1);
  }
  wgmma_commit();
}

// Waits for the warpgroup's products and fences their accumulator.
__device__ __forceinline__ void finish(float (&d)[32]) {
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

// Rows q0 .. q0 + 63 of one head's q and dO into a warpgroup's tiles.
__device__ __forceinline__ void load_q_tile(unsigned char* wg_smem, uint64_t* bar,
                                            const CUtensorMap* qmap, const CUtensorMap* dmap,
                                            int q0, int bh) {
  mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    tma_load_3d(wg_smem + Layout::q + p * kPanel, qmap, bar, 32 * p, q0, bh);
    tma_load_3d(wg_smem + Layout::dout + p * kPanel, dmap, bar, 32 * p, q0, bh);
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap dmap, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int T, int kv_len,
                     float scale_log2e, float scale) {
  const int kb = blockIdx.x, bh = blockIdx.y, k0 = kb * kKeys;
  const size_t head = (size_t)bh * T * kD;
  if (k0 >= kv_len) {  // every key of the block masked: zero gradients
    for (int i = threadIdx.x; i < kKeys * kD; i += kThreads) {
      const int r = k0 + i / kD;
      if (r < T) dk[head + (size_t)r * kD + i % kD] = dv[head + (size_t)r * kD + i % kD] = 0.f;
    }
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Layout::bars);
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint64_t* q_full = kv_full + 1 + wg;
  unsigned char* mine = smem + Layout::wg + wg * Layout::wg_bytes;
  const int n_q = (T + kQ - 1) / kQ;
  const int q_first = (kCausal ? kb : 0) + wg;
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kConsumers; ++i) mbar_init(kv_full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 2 * kTile);
    for (int p = 0; p < 2; ++p) {
      tma_load_3d(smem + Layout::k_hi + p * kPanel, &kmap, kv_full, 32 * p, k0, bh);
      tma_load_3d(smem + Layout::v_hi + p * kPanel, &vmap, kv_full, 32 * p, k0, bh);
    }
  }
  if (tid == 0 && q_first < n_q) load_q_tile(mine, q_full, &qmap, &dmap, q_first * kQ, bh);

  // K and V split into hi (in place) and lo; K^T beside them, its keys in
  // the permuted order
  mbar_wait(kv_full, 0);
  for (int i = threadIdx.x; i < kKeys * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    const uint32_t off = tile_off(r, c), off_t = tile_off(c, pos8(r));
    uint32_t hi, lo;
    split_tf32(*reinterpret_cast<const float*>(smem + Layout::k_hi + off), hi, lo);
    *reinterpret_cast<uint32_t*>(smem + Layout::k_hi + off) = hi;
    *reinterpret_cast<uint32_t*>(smem + Layout::k_lo + off) = lo;
    *reinterpret_cast<uint32_t*>(smem + Layout::kt_hi + off_t) = hi;
    *reinterpret_cast<uint32_t*>(smem + Layout::kt_lo + off_t) = lo;
    split_tf32(*reinterpret_cast<const float*>(smem + Layout::v_hi + off), hi, lo);
    *reinterpret_cast<uint32_t*>(smem + Layout::v_hi + off) = hi;
    *reinterpret_cast<uint32_t*>(smem + Layout::v_lo + off) = lo;
  }
  fence_proxy_async();
  __syncthreads();

  const uint32_t s_base = smem_u32(smem);
  const uint32_t x_hi = smem_u32(mine + Layout::x_hi), x_lo = smem_u32(mine + Layout::x_lo);
  float* staged = reinterpret_cast<float*>(mine + Layout::x_hi);
  const float* lse_bh = lse + (size_t)bh * T;
  const float* delta_bh = delta + (size_t)bh * T;
  const int bar = 1 + wg;  // the warpgroup's named barrier
  float tot_k[32], tot_v[32];
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
    float s[32], dp[32], part[32];  // each written first by a product's zeroing issue
    mbar_wait(q_full, it & 1);

    // S = q K^T, then dP = dO V^T while p = exp2(s log2(e)/8 - lse)
    load_a<false>(mine + Layout::q, warp, g, t, a_hi, a_lo);
    product(s, a_hi, a_lo, s_base + Layout::k_hi, s_base + Layout::k_lo);
    finish(s);
    load_a<false>(mine + Layout::dout, warp, g, t, a_hi, a_lo);
    product(dp, a_hi, a_lo, s_base + Layout::v_hi, s_base + Layout::v_lo);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r0 + 8 * ((i >> 1) & 1), key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const bool keep = (key < kv_len) & (row < T) & !(diag & (key > row));
      s[i] = keep ? ex2(s[i] * scale_log2e - lse_r[(i >> 1) & 1]) : 0.f;
    }
    finish(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - del_r[(i >> 1) & 1]) * scale;

    // dV^T += dO^T P, with P^T in the tile pair once the last tile's dq rows
    // have been read from it
    if (tid < kQ) bulk_wait_read<0>();
    bar_sync(bar, 128);
    store_t(s, mine + Layout::x_hi, mine + Layout::x_lo, warp, g, t);
    fence_proxy_async();
    bar_sync(bar, 128);
    load_a<true>(mine + Layout::dout, warp, g, t, a_hi, a_lo);
    product(part, a_hi, a_lo, x_hi, x_lo);
    finish(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) tot_v[i] += part[i];

    // dK^T += q^T dS, with dS^T in the tile pair; the stage is free once the
    // q^T fragments are read, so the warpgroup's next tile is loaded
    bar_sync(bar, 128);  // every lane's dV^T product has read P^T
    store_t(dp, mine + Layout::x_hi, mine + Layout::x_lo, warp, g, t);
    fence_proxy_async();
    load_a<true>(mine + Layout::q, warp, g, t, a_hi, a_lo);
    bar_sync(bar, 128);  // dS^T stored, q and dO read
    if (tid == 0 && qt + kConsumers < n_q)
      load_q_tile(mine, q_full, &qmap, &dmap, (qt + kConsumers) * kQ, bh);
    product(part, a_hi, a_lo, x_hi, x_lo);
    finish(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) tot_k[i] += part[i];

    // dq = dS K with dS from its accumulator, staged as 64 rows and added
    // into dq by one bulk reduce-add per row
    acc_to_a_tf32(dp, a_hi, a_lo);
    product(part, a_hi, a_lo, s_base + Layout::kt_hi, s_base + Layout::kt_lo);
    finish(part);
    bar_sync(bar, 128);  // every lane's dK^T product has read dS^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(staged + (16 * warp + g + 8 * h) * kStageRow + 8 * j + 2 * t) =
            make_float2(part[4 * j + 2 * h], part[4 * j + 2 * h + 1]);
    fence_proxy_async();
    bar_sync(bar, 128);
    if (tid < kQ && q0 + tid < T)
      bulk_reduce_add_f32(dq + head + (size_t)(q0 + tid) * kD, staged + tid * kStageRow, kD * 4);
  }

  // epilogue: warpgroup 0 writes dv and warpgroup 1 dk, each adding the
  // other's total (through its tile pair, in register order: conflict-free)
  if (tid < kQ) bulk_wait_all();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 32; ++i) staged[i * 128 + tid] = wg == 0 ? tot_k[i] : tot_v[i];
  __syncthreads();
  const unsigned char* other = smem + Layout::wg + (1 - wg) * Layout::wg_bytes;
  const float* theirs = reinterpret_cast<const float*>(other + Layout::x_hi);
  float* out = (wg == 0 ? dv : dk) + head;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int d = 16 * warp + g + 8 * ((i >> 1) & 1), key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
    const float val = (wg == 0 ? tot_v[i] : tot_k[i]) + theirs[i * 128 + tid];
    if (key < T) out[(size_t)key * kD + d] = val;
  }
}

// A map over a [BH, T, 64] fp32 tensor whose boxes are 64 rows of 32 dims,
// 128B-swizzled: coordinates (dim, t, bh); rows at or past T read as zeros.
inline cudaError_t rows_map(CUtensorMap* map, const float* base, int T, int BH) {
  return sw128_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, kD, T, BH, 32, 64);
}

template <bool kCausal>
int launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
           const float* delta, float* dq, float* dk, float* dv, int BH, int T, int kv_len,
           float scale_log2e, float scale, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap, dmap;
  cudaError_t err = rows_map(&qmap, q, T, BH);
  if (err == cudaSuccess) err = rows_map(&kmap, k, T, BH);
  if (err == cudaSuccess) err = rows_map(&vmap, v, T, BH);
  if (err == cudaSuccess) err = rows_map(&dmap, dout, T, BH);
  const size_t smem = Layout::bytes + 1024;
  if (err == cudaSuccess) err = allow_smem(flash_bwd_f32_kernel<kCausal>, smem);
  if (err != cudaSuccess) return (int)err;
  if (BH > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((T + kKeys - 1) / kKeys, BH);
  flash_bwd_f32_kernel<kCausal><<<grid, kThreads, smem, st>>>(
      qmap, kmap, vmap, dmap, lse, delta, dq, dk, dv, T, kv_len, scale_log2e, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K9: q, k, v, out's dO [BH, T, 64] fp32 contiguous (16-byte aligned),
// lse/delta [BH, T] fp32, 1 <= kv_len <= T -> dk, dv [BH, T, 64] fp32, and
// dq [BH, T, 64] fp32 added into (the caller zeroes it). scale_log2e =
// log2(e)/8, scale = 1/8; causal != 0 masks key j > query i. One launch.
extern "C" int fsat_flash_backward(const float* q, const float* k, const float* v,
                                   const float* dout, const float* lse, const float* delta,
                                   float* dq, float* dk, float* dv, int BH, int T, int kv_len,
                                   int causal, float scale_log2e, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (causal)
    return launch<true>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T, kv_len, scale_log2e, scale,
                        st);
  return launch<false>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T, kv_len, scale_log2e, scale,
                       st);
}
