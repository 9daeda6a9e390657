// Hopper building blocks of the attention kernels (attention.cu: K1/K5/K10,
// attention_bwd.cu: K6, flash_attention_bf16.cu: the bf16 K7,
// flash_attention.cu: the fp32 K7, flash_attention_bwd_f32.cu: K8 and K9) on
// top of the shared ones in hopper.cuh: the head-row tiles, the bulk
// reduce-add of an fp32 tile into device memory, the m64n64 (m64n128, m64n16)
// bf16 wgmma forms, the 3xTF32 split and k order, and the online softmax on
// score accumulators. A tile row is one head's first 64 bf16 dims: 128
// bytes, exactly one row of the 128-byte swizzle, so a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B lands a tile in the layout wgmma reads. At head
// dim 80 the last 16 dims are a panel of their own, 32-byte rows under
// CU_TENSOR_MAP_SWIZZLE_32B (fp32: two such panels of 8 dims).
#pragma once

#include "hopper.cuh"

namespace fsat_attn {

using namespace fsat_hopper;

constexpr int kD = 64;          // head dim
constexpr int kRowBytes = 128;  // one head's row of bf16: one 128B swizzle row
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx.ftz: 2 ulp; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- TMA --------------------------------------------------------------------

// dst[i] += src[i] for `bytes` / 4 floats, shared -> global, asynchronously.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N committed bulk groups still read their shared source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until every committed bulk group has completed its writes.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- wgmma ------------------------------------------------------------------

// MN-major tile (rows along K, 64 MN elements per row: one atom at MN 64,
// so `lbo` takes any value).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 1024, 1024);
}

// The 16-column panel (32-byte rows, 32B swizzle): byte offset of 16-byte
// chunk `chunk` (0 or 1) of row `row`, in a tile whose base is 256-byte
// aligned (what TMA's SWIZZLE_32B writes: address bit 4 ^= bit 7).
__device__ __forceinline__ uint32_t sw32_offset(int row, int chunk) {
  return row * 32 + ((chunk ^ ((row >> 2) & 1)) << 4);
}

// K-major panel of 32-byte rows: one k16 slice, 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t kmajor32_desc(uint32_t addr) {
  return sw32_desc(addr, 16, 256);
}

// MN-major panel (rows along K, 16 MN elements per row: one atom at MN 16;
// 8-row K groups 256 bytes apart).
__device__ __forceinline__ uint64_t mnmajor32_desc(uint32_t addr) {
  return sw32_desc(addr, 256, 256);
}

// d (+)= A B, m64n64k16, bf16 operands from shared memory, fp32 d. d's layout
// per warp w of the warpgroup and lane l (g = l / 4, t = l % 4): d[4j + e] is
// row 16w + g + 8 (e / 2), column 8j + 2t + (e % 2).
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FSAT_WGMMA_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : FSAT_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d (+)= A B, m64n128k16 from shared memory, both operands K-major; the
// accumulator as two m64n64 halves (columns 0-63 in d0, 64-127 in d1: the
// registers of one m64n128 accumulator in order).
__device__ __forceinline__ void wgmma_ss_n128(float (&d0)[32], float (&d1)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FSAT_WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FSAT_OUT16(d0, 0), FSAT_OUT16(d0, 16), FSAT_OUT16(d1, 0), FSAT_OUT16(d1, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A from registers (a[0..3]: rows g / g + 8, columns
// 2t, 2t + 1 / 2t + 8, 2t + 9, two bf16 each: the layout of d above, so a
// fp32 accumulator becomes an A operand by packing pairs), B from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FSAT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : FSAT_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTransB));
}

// d += A B, m64n16k16: wgmma_rs for a 16-column B (d[4j + e], j < 2, as above).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTransB));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half: the lower column
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k-slice j (columns 16j .. 16j + 15) of an m64n64 fp32
// accumulator, rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], int j, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * j + 0], d[8 * j + 1]);
  a[1] = pack_bf16(d[8 * j + 2], d[8 * j + 3]);
  a[2] = pack_bf16(d[8 * j + 4], d[8 * j + 5]);
  a[3] = pack_bf16(d[8 * j + 6], d[8 * j + 7]);
}

// ---- fp32 on the tensor cores: 3xTF32 ---------------------------------------------

// The k order of the fp32 products that contract over q rows or keys (K9's
// dV^T, dK^T and dq, K7's P.V): within each 8, k position p holds row
// sigma(p) = 2p (p < 4) or 2(p - 4) + 1, and row r sits at position pos8(r).
// An accumulator's column pair (8j + 2t, 8j + 2t + 1) is then exactly a
// register-A fragment's positions (t, t + 4), and a thread's transposed
// loads (rows 2t, 2t + 1 of a 128B-swizzled tile) hit 32 distinct banks
// where rows t, t + 4 hit 16.
__device__ __forceinline__ int pos8(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// x = hi + lo to ~2^-22: hi = tf32(x), lo = tf32(x - hi), rounded to nearest.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The tf32 A operand of a product over 64 k rows from a 64 x 64 fp32
// accumulator in registers (rows m, columns the k rows in the pos8 order),
// split into hi and lo: fragment (kk, e) is the accumulator's row 16 warp +
// g + 8 (e & 1), column 8 kk + 2t + (e >> 1).
__device__ __forceinline__ void acc_to_a_tf32(const float (&d)[32], uint32_t (&hi)[8][4],
                                              uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(d[4 * kk + 2 * (e & 1) + (e >> 1)], hi[kk][e], lo[kk][e]);
}

// A [64][D] fp32 tile (D 64 or 80; rows along M or N, dims along K), as the
// TMA boxes write it: dims 0-63 as two 128B-swizzled panels of 32 (8 KB
// each), dims 64-79 as two 32B-swizzled panels of 8 (2 KB each: one k8
// slice apiece); what the K-major wgmma operands read.
constexpr int kF32Panel = 64 * kSwizzleRow;  // 64 rows of 32 fp32 (128 bytes)
constexpr int kF32TailPanel = 64 * 32;       // 64 rows of 8 fp32 (32 bytes)

// Byte offset of the 16-byte chunk holding element (r, c), c % 4 == 0.
__device__ __forceinline__ uint32_t f32_row_off(int r, int c) {
  if (c < 64) return (c >> 5) * kF32Panel + sw128_offset(r, (c & 31) >> 2);
  return 2 * kF32Panel + ((c - 64) >> 3) * kF32TailPanel + sw32_offset(r, ((c - 64) & 7) >> 2);
}

// Byte offset of element (r, c).
__device__ __forceinline__ uint32_t f32_row_elem(int r, int c) {
  return f32_row_off(r, c & ~3) + (c & 3) * 4;
}

// K-major descriptor of k8 slice kk (dims 8 kk .. 8 kk + 7) of the tile.
__device__ __forceinline__ uint64_t f32_row_desc(uint32_t tile, int kk) {
  return kk < 8 ? kmajor_desc(tile + (kk >> 2) * kF32Panel + (kk & 3) * 32)
                : kmajor32_desc(tile + 2 * kF32Panel + (kk - 8) * kF32TailPanel);
}

// ---- the online softmax -------------------------------------------------------

// The online base-2 softmax on one score tile of kChunks x 64 keys in
// registers (rows g and g + 8 of the lane's warp; keys at or past kv_len set
// to -inf first): updates the running max m and the lane's part of the
// running sum l, leaves p in sc and returns the rescale factors of the rows'
// earlier output in a0, a1. Every tile holds a key below kv_len, so the new
// max is finite and 2^(-inf) = 0 takes care of masked keys and of the first
// tile's m = -inf.
template <int kChunks>
__device__ __forceinline__ void online_softmax(float (&sc)[kChunks][32], int k0, int kv_len, int tq,
                                               float& m0, float& m1, float& l0, float& l1,
                                               float& a0, float& a1) {
  if (k0 + kChunks * 64 > kv_len) {
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

// P (the softmaxed score tile) rounded to bf16 as wgmma's register A
// operand: k-slice kk covers keys 16 kk .. 16 kk + 15.
template <int kChunks>
__device__ __forceinline__ void scores_to_a(const float (&sc)[kChunks][32],
                                            uint32_t (&pa)[kChunks * 4][4]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_to_a(sc[c], j, pa[c * 4 + j]);
}

// ---- host: tensor maps --------------------------------------------------------

// A map over a [B, T, C] bf16 tensor whose boxes are `box_rows` rows of one
// head's 64 columns, 128B-swizzled: coordinates (column, t, b); rows at or
// past T read as zeros, and no box crosses into the next batch.
inline cudaError_t head_rows_map(CUtensorMap* map, const void* base, int C, int T, int B,
                                 int box_rows) {
  return sw128_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, C, T, B, kD, box_rows);
}

// The same for the 16 columns past a head's first 64 (head dim 80): boxes of
// `box_rows` rows of 16 bf16, 32B-swizzled; coordinates (column, t, b).
inline cudaError_t head_tail_map(CUtensorMap* map, const void* base, int C, int T, int B,
                                 int box_rows) {
  return swizzled_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, C, T, B, 16, box_rows,
                         CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace fsat_attn
