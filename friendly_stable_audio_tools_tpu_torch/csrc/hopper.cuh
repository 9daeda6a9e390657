// Hopper building blocks shared by the wgmma/TMA kernels (attention.cu,
// attention_bwd.cu, flash_attention.cu, flash_attention_bf16.cu,
// flash_attention_bwd_f32.cu, conv_wgmma.cu, glu_mlp.cu): mbarriers, TMA
// loads into mbarrier-guarded shared memory, warpgroup matrix products
// (wgmma, bf16 and tf32) on swizzled tiles, and the host-side tensor maps. A
// tile row is 128 bytes (64 bf16 or 32 fp32), exactly one row of the 128-byte
// swizzle, so a TMA load with CU_TENSOR_MAP_SWIZZLE_128B lands a tile in the
// layout wgmma reads; the 16 columns past 64 of a head dim of 80 are a
// second panel of 32-byte rows under the 32-byte swizzle.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encode is reached through the runtime

#include "common.cuh"

namespace fsat_hopper {

constexpr int kSwizzleRow = 128;  // bytes in one row of the 128B swizzle

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk `chunk` of row `row` in a 128B-swizzled
// tile whose base is 1024-byte aligned (what TMA's SWIZZLE_128B writes).
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return row * kSwizzleRow + ((chunk ^ (row & 7)) << 4);
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait of 2^26
// polls (seconds) means a fault in the pipeline: it traps, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) asm volatile("trap;\n");
  }
}

// Makes this thread's generic-proxy shared-memory writes visible to the async
// proxy (wgmma operands, bulk copies); a barrier must follow before the reader.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar.sync on named barrier `id` (1..15; 0 is __syncthreads) over n threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// bar.arrive on named barrier `id`: counts this warp towards n without waiting.
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- TMA --------------------------------------------------------------------

// Box (c0, c1, c2) of a 3-D tensor map into dst, completion counted on bar.
// Coordinates may be negative or run past the tensor: those elements arrive
// as zeros (and count towards the transaction bytes like the others).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Starts fetching `bytes` (a multiple of 16) at p (16-byte aligned) into L2,
// asynchronously; nothing waits for it.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(reinterpret_cast<uint64_t>(p)),
               "r"(bytes)
               : "memory");
}

// Box (c0, c1) of a 2-D tensor map into dst, as tma_load_3d.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128B-swizzled tile at `addr`
// (1024-byte aligned atoms; a K-major operand may start 32*j bytes into its
// atom to take the j-th 32-byte deep slice: 16 bf16 or 8 tf32). K-major:
// 8-row groups `sbo` apart, `lbo` unused. MN-major: an atom is 8 K-rows of 64
// MN elements; K groups of 8 rows `sbo` apart, MN atoms `lbo` apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The same for a 32B-swizzled tile (32-byte rows: 16 bf16; 256-byte aligned
// atoms of 8 rows): layout type 3 in bits 62-63 where the 128B swizzle has 1.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return sw128_desc(addr, lbo, sbo) | (3ull << 62);
}

// K-major tile of 128-byte rows: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (from its start to its wait).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Operand lists of the fp32 accumulator of an m64nN wgmma (N / 2 registers
// per thread). The layout per warp w of the warpgroup and lane l (g = l / 4,
// t = l % 4): d[4j + e] is row 16w + g + 8 (e / 2), column 8j + 2t + (e % 2).
#define FSAT_IDX_0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define FSAT_IDX_16 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FSAT_IDX_32 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define FSAT_IDX_48 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define FSAT_WGMMA_D16 "{" FSAT_IDX_0 "}"
#define FSAT_WGMMA_D32 "{" FSAT_IDX_0 ", " FSAT_IDX_16 "}"
#define FSAT_WGMMA_D40 "{" FSAT_IDX_0 ", " FSAT_IDX_16 ", %32, %33, %34, %35, %36, %37, %38, %39}"
#define FSAT_WGMMA_D48 "{" FSAT_IDX_0 ", " FSAT_IDX_16 ", " FSAT_IDX_32 "}"
#define FSAT_WGMMA_D64 "{" FSAT_IDX_0 ", " FSAT_IDX_16 ", " FSAT_IDX_32 ", " FSAT_IDX_48 "}"
#define FSAT_OUT16(d, o)                                                                         \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]),    \
      "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]),           \
      "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15])
#define FSAT_WGMMA_OUT16(d) FSAT_OUT16(d, 0)
#define FSAT_WGMMA_OUT32(d) FSAT_OUT16(d, 0), FSAT_OUT16(d, 16)
#define FSAT_WGMMA_OUT40(d)                                                                      \
  FSAT_OUT16(d, 0), FSAT_OUT16(d, 16), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define FSAT_WGMMA_OUT48(d) FSAT_OUT16(d, 0), FSAT_OUT16(d, 16), FSAT_OUT16(d, 32)
#define FSAT_WGMMA_OUT64(d) FSAT_OUT16(d, 0), FSAT_OUT16(d, 16), FSAT_OUT16(d, 32), FSAT_OUT16(d, 48)

// d (+)= A B, m64nCHk8, tf32 A from registers (a[e]: row g + 8 (e & 1),
// column t + 4 (e >> 1) of the warp's 16 x 8 slice), B K-major in shared
// memory; d is first zeroed when accumulate == 0.
template <int CH>
__device__ __forceinline__ void wgmma_tf32(float (&d)[CH / 2], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  if constexpr (CH == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " FSAT_WGMMA_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : FSAT_WGMMA_OUT16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (CH == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " FSAT_WGMMA_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : FSAT_WGMMA_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (CH == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 " FSAT_WGMMA_D40
        ", {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : FSAT_WGMMA_OUT40(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else {
    static_assert(CH == 128, "tf32 wgmma widths: 32, 64, 80, 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " FSAT_WGMMA_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : FSAT_WGMMA_OUT64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
}

// d (+)= A B, m64n64k8, tf32 A and B both K-major in shared memory (tf32
// operands from shared memory are K-major only); d is first zeroed when
// accumulate == 0.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " FSAT_WGMMA_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : FSAT_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, m64n16k8, tf32 A and B both K-major in shared memory (d[4j +
// e], j < 2, as above).
__device__ __forceinline__ void wgmma_tf32_ss16(float (&d)[8], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// fp32 -> tf32, round to nearest (ties away), in an fp32 container.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// ---- host: tensor maps --------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A swizzled map over a row-major [d2, d1, d0] tensor (d0 contiguous,
// `elem` bytes each) whose boxes are [1, box1, box0]; coordinates (i0, i1,
// i2); elements outside the tensor read as zeros, and no box crosses into
// the next d2 slice. d0 * elem must be a multiple of 16 and box0 * elem the
// swizzle's row: 128 bytes (SWIZZLE_128B) or 32 (SWIZZLE_32B).
inline cudaError_t swizzled_map_3d(CUtensorMap* map, CUtensorMapDataType dtype, int elem,
                                   const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                                   uint32_t box0, uint32_t box1, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem, d1 * d0 * elem};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, dtype, 3, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// swizzled_map_3d with the 128B swizzle: box0 * elem = 128.
inline cudaError_t sw128_map_3d(CUtensorMap* map, CUtensorMapDataType dtype, int elem,
                                const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                                uint32_t box0, uint32_t box1) {
  return swizzled_map_3d(map, dtype, elem, base, d0, d1, d2, box0, box1,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// An unswizzled map over a row-major [d1, d0] tensor (d0 contiguous, `elem`
// bytes each) whose boxes are [box1, box0], landing row after row in shared
// memory; elements outside the tensor read as zeros. d0 * elem and box0 *
// elem must be multiples of 16.
inline cudaError_t plain_map_2d(CUtensorMap* map, CUtensorMapDataType dtype, int elem,
                                const void* base, uint64_t d0, uint64_t d1, uint32_t box0,
                                uint32_t box1) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {d0 * elem};
  const cuuint32_t box[2] = {box0, box1};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Rounds a dynamic shared-memory base up to 1024 bytes (the swizzle atom).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

}  // namespace fsat_hopper
