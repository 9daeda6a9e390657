// K6: backward of the head-pair attention (K5), in the fused layout.
// Replaces `_pair_backward` (friendly_stable_audio_tools_tpu/ops/pallas/
// flash_attention.py:1119) and its two Pallas kernels: `_rope_pair_k_kernel`
// (:1229, call :1139), here K10a (attention_rope.cu) run for k^ and for q^,
// and `_pair_bwd_kernel` (:1029, call :1167).
//
// Per head, with q^ = bf16(rope(q) * log2(e)/8), k^ = bf16(rope(k)), lse the
// base-2 LSE of K5 and delta = rowsum(dO * O):
//   s = q^ k^T, p = exp2(s - lse), dp = dO v^T, ds = bf16(p * (dp - delta))
//   dq = unrope(ds k^) / 8,  dk = unrope(ds^T q^) / log2(e),  dv = bf16(p)^T dO
// dqkv [B, T, 3*H*64] fp32 holds dq, dk and dv in their thirds.
//
// Bound on the H100: five 64-deep products per (q, key) pair, 0.1305 ms at
// B8 T1040 kv_len 1025 H24 (SAO training) at 989 TFLOP/s. The WMMA version
// this replaces took 51x that: it split the work as FlashAttention-2 does (a
// dk/dv pass and a dq pass, each recomputing s, p and dp), roped K tile by
// tile in both passes and staged every score and partial through fp32
// shared memory with synchronous loads. Here, three launches:
// - delta = rowsum(dO * O) in fp32 (row_dot_kernel: a pass of its own, as
//   PyTorch's chain of ops for it took ~6x its time).
// - FlashAttention-2/3's single pass over key blocks (pair_bwd_kernel), with
//   q^ and k^ precomputed by K10a, so the loop does no rope. A block owns
//   128 keys of one head (only blocks with a key below kv_len are launched):
//   two consumer warpgroups of 64 keys, each holding its keys' dK and dV in
//   wgmma accumulators for the whole call, its k^ and v tiles resident in
//   shared memory. A producer warpgroup (one thread at work) streams q^ and
//   dO tiles of 64 rows by TMA into a ring of kStages stages (full/empty
//   mbarriers); lse and delta come from L1. Per q tile each warpgroup
//   computes s^T = k^ q^T and dp^T = v dO^T by wgmma into registers, p^T and
//   ds^T there (the rounding points above), dV += bf16(p)^T dO and dK +=
//   ds^T q^ with p^T and ds^T as register A operands, and the partial ds k^
//   with ds^T written once to swizzled shared memory. The partial goes into
//   an fp32 scratch dq_acc [B, H, Tp, 64] by one bulk reduce-add of the 16 KB
//   tile (TMA, in L2), double buffered; K8 (flash_attention.cu) sums its dq
//   with atomics the same way. The block's epilogue writes
//   unrope(dK)/log2(e) and dV.
// - unrope(dq_acc)/8 into the q third (dq_unrope_kernel). The unrope is
//   linear, so summing before it is exact up to order.
// What bounds it now (measured on the H100; pair_attention_variants.py,
// PERF.md §6): the chain of each warpgroup's tile (products, exponentials,
// products, staging) with two warpgroups per SM. Leaving out the dq
// reduce-add takes only a few percent off; starting the next tile's products
// ahead of this tile's staging needs more than the 168 registers ptxas
// allows 384 threads: it spilled and serialized the wgmmas, and was slower.
// The dq sum's order changes from run to run (the reduce-adds of the key
// blocks land in L2 in whatever order the blocks finish): dq agrees between
// two runs to fp32 rounding, not bit for bit; dk and dv are deterministic.
//
// Ragged edges: keys at or beyond kv_len get p = 0, so they neither
// contribute nor receive gradient (rows past the last launched key block get
// their zeros from the dq pass); q rows at or beyond T arrive as zero tiles
// (TMA) and get p = 0. Rows in [kv_len, T) are real rows whose dO the
// transformer makes zero.
#include "attention_tiles.cuh"

using namespace fsat_attn;

namespace {

constexpr int kConsumers = 2;                    // warpgroups of 64 keys
constexpr int kKeys = 64 * kConsumers;           // keys per block
constexpr int kQ = 64;                           // q rows per streamed tile
constexpr int kThreads = (kConsumers + 1) * 128;  // + one producer warpgroup
constexpr int kStages = 3;
constexpr int kTile = 64 * kRowBytes;            // one 64-row bf16 tile: 8 KB
constexpr int kAccTile = 64 * kD * 4;            // one 64 x 64 fp32 tile: 16 KB

struct Layout {  // byte offsets into the 1024-aligned dynamic shared memory
  static constexpr int k = 0;                                  // [kKeys] rows of k^
  static constexpr int v = k + kConsumers * kTile;             // [kKeys] rows of v
  static constexpr int q = v + kConsumers * kTile;             // [kStages] q^ tiles
  static constexpr int dout = q + kStages * kTile;             // [kStages] dO tiles
  static constexpr int ds = dout + kStages * kTile;            // [kConsumers] ds^T tiles
  static constexpr int acc = ds + kConsumers * kTile;          // [kConsumers][2] fp32 tiles
  static constexpr int bars = acc + kConsumers * 2 * kAccTile;
  static constexpr int bytes = bars + (1 + 2 * kStages) * 8;
};

// Index of column c of row `row` in an fp32 [64][64] tile whose 16-byte
// chunks are XOR-swizzled by row % 8: the layout of the staging tiles and of
// dq_acc (64-row tiles, so a global row t swizzles by t % 8), which keeps
// the stores of a wgmma accumulator free of shared-memory bank conflicts.
__device__ __forceinline__ int swz64(int row, int c) {
  return row * kD + ((((c >> 2) ^ (row & 7)) << 2) | (c & 3));
}

// Writes the warpgroup's 64 x 64 fp32 accumulator d (rows 16w + g (+8),
// columns 8j + 2t (+1)) into the swizzled tile buf.
__device__ __forceinline__ void acc_to_smem(const float (&d)[32], float* buf, int w, int g, int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq, r0 = 16 * w + g;
    *reinterpret_cast<float2*>(buf + swz64(r0, c)) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(buf + swz64(r0 + 8, c)) = make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

// Transpose (vjp) of the rope at position t, scale 1, for dim d of row `row`
// of a swizzled fp32 tile: dx = dy*C + (dy*S) P^T, i.e. dy[d]*cos[d] +
// dy[d+h]*sin[d+h] for d < h = rot/2, dy[d]*cos[d] - dy[d-h]*sin[d-h] for
// h <= d < rot, and dy[d] beyond rot (flash_attention.py:1084-1099).
__device__ __forceinline__ float unrope_tile(const float* tile, int row, int d,
                                             const float* __restrict__ cos_t,
                                             const float* __restrict__ sin_t, int t, int rot) {
  const float x = tile[swz64(row, d)];
  if (d >= rot) return x;
  const int half = rot >> 1;
  const float* c = cos_t + (size_t)t * rot;
  const float* s = sin_t + (size_t)t * rot;
  const float partner = d < half ? tile[swz64(row, d + half)] * s[d + half]
                                 : -tile[swz64(row, d - half)] * s[d - half];
  return x * c[d] + partner;
}

// The consumer warpgroup wg of a block: it owns keys kw0 .. kw0 + 64 and
// holds their dK and dV in wgmma accumulators across the q tiles.
struct Consumer {
  unsigned char* ds_tile;  // bf16 ds^T [64 keys][64 q], swizzled
  float* acc_buf;          // two fp32 [64][64] staging tiles, swizzled
  const float* lse_bh;
  const float* delta_bh;
  float* dq_bh;
  uint64_t* full;
  uint64_t* empty;
  uint32_t k_addr, v_addr, q_addr, do_addr, ds_addr;
  int T, tid, w, g, tq;
  bool ok0, ok1, adds_dq;  // this lane's two key rows below kv_len; any key of the warpgroup is

  // q tile qt: s^T and dp^T, p^T and ds^T, then dV, dK and the dq partial,
  // which is staged and reduced into dq_acc. exp2 of s^T runs while dp^T is
  // computed, the barrier on ds^T while dV and dK are. Every wgmma is waited
  // for before any branch: code in a branch while one is in flight makes the
  // compiler serialize them.
  __device__ __forceinline__ void tile(int qt, float (&dk)[32], float (&dv)[32]) const {
    const int s = qt % kStages;
    const int q0 = qt * kQ;
    const uint32_t qs = q_addr + s * kTile, dos = do_addr + s * kTile;
    mbar_wait(&full[s], (qt / kStages) & 1);
    // s^T = k^ q^T and dp^T = v dO^T (all operands K-major: the head dim is
    // contiguous), one group each
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(st, kmajor_desc(k_addr + kk * 32), kmajor_desc(qs + kk * 32), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(dpt, kmajor_desc(v_addr + kk * 32), kmajor_desc(dos + kk * 32), kk > 0);
    wgmma_commit();
    // lse and delta of this lane's 16 q columns 8j + 2t (+1)
    float lse_c[16], del_c[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = q0 + 8 * (i >> 1) + 2 * tq + (i & 1);
      lse_c[i] = col < T ? lse_bh[col] : 0.f;
      del_c[i] = col < T ? delta_bh[col] : 0.f;
    }
    wgmma_wait<1>();
    reg_fence(st);
    // p^T = exp2(s^T - lse), then ds^T = p^T (dp^T - delta), in place
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = i >> 2, e = i & 3;
      const bool ok = (e < 2 ? ok0 : ok1) && q0 + 8 * j + 2 * tq + (e & 1) < T;
      st[i] = ok ? ex2(st[i] - lse_c[2 * j + (e & 1)]) : 0.f;
    }
    wgmma_wait<0>();
    reg_fence(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i) dpt[i] = st[i] * (dpt[i] - del_c[2 * (i >> 2) + (i & 1)]);
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_to_a(st, j, pa[j]);
      acc_to_a(dpt, j, dsa[j]);
    }
    // bf16(ds^T) into the swizzled tile: dq's A operand
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r0 = 16 * w + g, r1 = r0 + 8;
      *reinterpret_cast<uint32_t*>(ds_tile + sw128_offset(r0, j) + 4 * tq) = dsa[j >> 1][(j & 1) * 2];
      *reinterpret_cast<uint32_t*>(ds_tile + sw128_offset(r1, j) + 4 * tq) =
          dsa[j >> 1][(j & 1) * 2 + 1];
    }

    // dV += bf16(p)^T dO, dK += ds^T q^ (register A; dO and q^ MN-major),
    // then, once every lane's ds^T is in shared memory, dq = ds k^ (ds^T and
    // k^ from shared memory, both MN-major)
    float dq[32];
    reg_fence(dv);
    reg_fence(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dv, pa[kk], mnmajor_desc(dos + kk * 16 * kRowBytes));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dk, dsa[kk], mnmajor_desc(qs + kk * 16 * kRowBytes));
    wgmma_commit();
    fence_proxy_async();
    bar_sync(1 + (threadIdx.x >> 7), 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(dq, mnmajor_desc(ds_addr + kk * 16 * kRowBytes),
                     mnmajor_desc(k_addr + kk * 16 * kRowBytes), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(dq);
    mbar_arrive(&empty[s]);

    if (adds_dq) {  // dq_acc[q0 .. q0 + 64] += dq, by one bulk reduce-add
      float* buf = acc_buf + (qt & 1) * (kAccTile / 4);
      if (tid == 0) bulk_wait_read<1>();  // the reduce of two tiles ago has read buf
      bar_sync(1 + (threadIdx.x >> 7), 128);
      acc_to_smem(dq, buf, w, g, tq);
      fence_proxy_async();
      bar_sync(1 + (threadIdx.x >> 7), 128);
      if (tid == 0) bulk_reduce_add_f32(dq_bh + (size_t)q0 * kD, buf, kAccTile);
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
pair_bwd_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap dmap,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                float* __restrict__ dq_acc, float* __restrict__ dqkv, int T, int Tp, int H,
                int rot, int kv_len) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Layout::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  // the grid holds only blocks with a key below kv_len
  const int k0 = blockIdx.x * kKeys, h = blockIdx.y, b = blockIdx.z;
  const int n_q = (T + kQ - 1) / kQ;
  const int HD = H * kD;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warpgroup: one thread starts the loads
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(kv_full, 2 * kConsumers * kTile);
      for (int c = 0; c < kConsumers; ++c) {
        tma_load_3d(smem + Layout::k + c * kTile, &kmap, kv_full, h * kD, k0 + 64 * c, b);
        tma_load_3d(smem + Layout::v + c * kTile, &vmap, kv_full, 2 * HD + h * kD, k0 + 64 * c, b);
      }
      for (int qt = 0; qt < n_q; ++qt) {
        const int s = qt % kStages;
        if (qt >= kStages) mbar_wait(&empty[s], ((qt / kStages) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTile);
        tma_load_3d(smem + Layout::q + s * kTile, &qmap, &full[s], h * kD, qt * kQ, b);
        tma_load_3d(smem + Layout::dout + s * kTile, &dmap, &full[s], h * kD, qt * kQ, b);
      }
    }
  } else {  // consumers: warpgroup wg owns keys kw0 .. kw0 + 64
    const int tid = threadIdx.x & 127, w = tid >> 5;
    const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
    const int kw0 = k0 + 64 * wg;
    Consumer c;
    c.ds_tile = smem + Layout::ds + wg * kTile;
    c.acc_buf = reinterpret_cast<float*>(smem + Layout::acc) + wg * 2 * (kAccTile / 4);
    c.lse_bh = lse + ((size_t)b * H + h) * T;
    c.delta_bh = delta + ((size_t)b * H + h) * T;
    c.dq_bh = dq_acc + ((size_t)b * H + h) * Tp * kD;
    c.full = full;
    c.empty = empty;
    c.k_addr = smem_u32(smem + Layout::k + wg * kTile);
    c.v_addr = smem_u32(smem + Layout::v + wg * kTile);
    c.q_addr = smem_u32(smem + Layout::q);
    c.do_addr = smem_u32(smem + Layout::dout);
    c.ds_addr = smem_u32(c.ds_tile);
    c.T = T;
    c.tid = tid;
    c.w = w;
    c.g = g;
    c.tq = tq;
    c.ok0 = kw0 + 16 * w + g < kv_len;
    c.ok1 = kw0 + 16 * w + g + 8 < kv_len;
    c.adds_dq = kw0 < kv_len;

    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_full, 0);
    for (int qt = 0; qt < n_q; ++qt) c.tile(qt, dk, dv);

    // epilogue: dk = unrope(dK) / log2(e) and dv into their thirds of dqkv
    if (tid == 0) bulk_wait_all();
    bar_sync(1 + wg, 128);
    const int r = tid >> 1, half = tid & 1, key = kw0 + r;
    const size_t row = ((size_t)b * T + key) * 3 * HD;
    acc_to_smem(dk, c.acc_buf, w, g, tq);
    bar_sync(1 + wg, 128);
    if (key < T) {
      float* dst = dqkv + row + HD + h * kD + half * 32;
#pragma unroll 8
      for (int i = 0; i < 32; ++i)
        dst[i] = unrope_tile(c.acc_buf, r, half * 32 + i, cos_t, sin_t, key, rot) * (1.f / kLog2e);
    }
    bar_sync(1 + wg, 128);
    acc_to_smem(dv, c.acc_buf, w, g, tq);
    bar_sync(1 + wg, 128);
    if (key < T) {
      float* dst = dqkv + row + 2 * HD + h * kD + half * 32;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) dst[i] = c.acc_buf[swz64(r, half * 32 + i)];
    }
  }
}

// delta[b, h, t] = sum over d of dO * O at [b, t, h*64 + d], in fp32 (FA2's
// D = rowsum(dO * O), as the JAX package computes it beside its kernel,
// flash_attention.py:1153-1158): eight threads per head's row, a 16-byte
// load of each and a shuffle sum.
__global__ void __launch_bounds__(256)
row_dot_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ out,
               float* __restrict__ delta, int T, int H, size_t n_segments) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n_segments;
  const size_t row_head = i >> 3;  // (b * T + t) * H + h
  float acc = 0.f;
  if (valid) {
    Pack8 a, c;
    a.u = reinterpret_cast<const uint4*>(dout)[i];
    c.u = reinterpret_cast<const uint4*>(out)[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += __bfloat162float(a.h[j]) * __bfloat162float(c.h[j]);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (valid && (i & 7) == 0) {
    const int h = (int)(row_head % H);
    const size_t bt = row_head / H;
    const int t = (int)(bt % T), b = (int)(bt / T);
    delta[((size_t)b * H + h) * T + t] = acc;
  }
}

// dqkv[b, t, h*64 + d] = unrope(dq_acc[b, h, t, :])[d] * scale: one thread
// per 8 dims of one head's row. Rows at or past key_end, which no key block
// covers (all their keys are masked), get zero dk and dv here.
__global__ void __launch_bounds__(256)
dq_unrope_kernel(const float* __restrict__ dq_acc, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, float* __restrict__ dqkv, int T, int Tp, int H,
                 int rot, int key_end, float scale, size_t n_segments) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_segments) return;
  const int seg = (int)(i & 7);
  const size_t row_head = i >> 3;
  const int h = (int)(row_head % H);
  const size_t bt = row_head / H;
  const int t = (int)(bt % T), b = (int)(bt / T);
  const float* tile = dq_acc + (((size_t)b * H + h) * Tp + (t & ~63)) * kD;
  float y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = unrope_tile(tile, t & 63, seg * 8 + j, cos_t, sin_t, t, rot) * scale;
  float4* dst = reinterpret_cast<float4*>(dqkv + bt * 3 * H * kD + h * kD + seg * 8);
  dst[0] = make_float4(y[0], y[1], y[2], y[3]);
  dst[1] = make_float4(y[4], y[5], y[6], y[7]);
  if (t >= key_end) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t third = (size_t)H * kD / 4;  // one third of a row, in float4
    dst[third] = dst[third + 1] = dst[2 * third] = dst[2 * third + 1] = zero;
  }
}

}  // namespace

// qhat, khat [B, T, H*64] bf16 (K10a: q roped and prescaled, k roped), qkv
// [B, T, 3*H*64] bf16 (v read), dout and out [B, T, H*64] bf16, lse [B, H, T]
// fp32, cos/sin [T, rot] fp32; scratch: delta [B, H, T] fp32 and dq_acc
// [B, H, Tp, 64] fp32 zeroed (Tp = T rounded up to 64) -> dqkv [B, T,
// 3*H*64] fp32. Three launches on `stream`: delta, the key-block pass, dq.
extern "C" int fsat_pair_attention_bwd(const void* qhat, const void* khat, const void* qkv,
                                       const void* dout, const void* out, const float* lse,
                                       float* delta, const float* cos_t, const float* sin_t,
                                       float* dq_acc, float* dqkv, int B, int T, int H, int rot,
                                       int kv_len, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * kD;
  CUtensorMap kmap, vmap, qmap, dmap;
  cudaError_t err = head_rows_map(&kmap, khat, HD, T, B, 64);
  if (err == cudaSuccess) err = head_rows_map(&vmap, qkv, 3 * HD, T, B, 64);
  if (err == cudaSuccess) err = head_rows_map(&qmap, qhat, HD, T, B, kQ);
  if (err == cudaSuccess) err = head_rows_map(&dmap, dout, HD, T, B, kQ);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = Layout::bytes + 1024;
  err = allow_smem(pair_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * T * H * 8;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  row_dot_kernel<<<blocks, 256, 0, st>>>(static_cast<const bf16*>(dout),
                                         static_cast<const bf16*>(out), delta, T, H, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int Tp = (T + kQ - 1) / kQ * kQ;
  const int key_blocks = (kv_len + kKeys - 1) / kKeys;  // blocks past kv_len have nothing to add
  const dim3 grid(key_blocks, H, B);
  pair_bwd_kernel<<<grid, kThreads, smem, st>>>(kmap, vmap, qmap, dmap, lse, delta, cos_t, sin_t,
                                                 dq_acc, dqkv, T, Tp, H, rot, kv_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_unrope_kernel<<<blocks, 256, 0, st>>>(dq_acc, cos_t, sin_t, dqkv, T, Tp, H, rot,
                                           key_blocks * kKeys, scale, n);
  return (int)cudaGetLastError();
}
