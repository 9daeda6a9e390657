// Hopper building blocks of the head-pair attention kernels (attention.cu:
// K1/K5/K10, attention_bwd.cu: K6) on top of the shared ones in hopper.cuh:
// the head-row tiles, the bulk reduce-add of an fp32 tile into device memory,
// and the m64n64 bf16 wgmma forms. Every tile row is one head's 64 bf16 dims:
// 128 bytes, exactly one row of the 128-byte swizzle, so a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B lands a tile in the layout wgmma reads.
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

// ---- host: tensor maps --------------------------------------------------------

// A map over a [B, T, C] bf16 tensor whose boxes are `box_rows` rows of one
// head's 64 columns, 128B-swizzled: coordinates (column, t, b); rows at or
// past T read as zeros, and no box crosses into the next batch.
inline cudaError_t head_rows_map(CUtensorMap* map, const void* base, int C, int T, int B,
                                 int box_rows) {
  return sw128_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, C, T, B, kD, box_rows);
}

}  // namespace fsat_attn
