// The building blocks of the tap-list implicit-GEMM kernels on Hopper
// (wgmma fed by TMA through an mbarrier ring), shared by the convolution
// kernel of conv_wgmma.cu (K2's wide route, K4: the design notes are
// there) and the tensor-core route of the fused MLP in glu_mlp.cu (K13:
// its two GEMMs are the one-tap case, x [M, K] the A map with B = 1, T =
// M, Cin = K): the tile and stage sizes, the plan, the products, the
// convolution's epilogue (store_tile), the launch (launch_taps), and the
// GEMMs' own mainloop (gemm_mainloop) with what they add to the
// convolution's:
// - an epilogue chosen at compile time: the GLU (store_glu: a stacked
//   [value; gate] B tile, so one wgmma of width N yields v and g of the
//   same N / 2 columns in one thread's registers) or a GEMM's plain
//   rounding (store_gemm);
// - a B tile loaded in p.b_parts row blocks (the GLU's value rows and gate
//   rows of w_in, from one map over w_in as [2, inner, K]);
// - the raster order (kGemmRowsFastest: row tiles fastest, so that the
//   blocks running together share one weight tile in L2 and each weight
//   tile is read from device memory about once);
// - rows at or past T and columns at or past cout masked in the epilogues,
//   so M, inner and Kout need not be tile multiples.
// Each GEMM __global__ kernel is a thin shim over gemm_mainloop, so the
// profiler names them apart (glu_gemm_kernel, out_gemm_kernel).
#pragma once

#include "hopper.cuh"

using namespace fsat_hopper;

namespace {

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kM = 64 * kConsumers;               // output rows per block
constexpr int kThreads = kConsumers * 128 + 32;   // + one producer warp
constexpr int kATile = kM * kSwizzleRow;          // one tap's A tile: 16 KB
constexpr int kMaxStages = 4;
constexpr int kSmemBudget = 227 * 1024 - 1024 - 2 * kMaxStages * 8;
// the GEMMs' raster: row tiles fastest across the grid (the convolution
// runs its column tiles fastest); mlp_variants.py times the other order
constexpr bool kGemmRowsFastest = true;

template <typename T>
struct ConvElem;
template <>
struct ConvElem<bf16> {
  static constexpr int kKC = 64;     // channels in one 128-byte row
  static constexpr int kBTiles = 1;  // w
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct ConvElem<float> {
  static constexpr int kKC = 32;
  static constexpr int kBTiles = 2;  // w_hi, w_lo
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <typename T, int N>
struct ConvTile {
  static constexpr int kKC = ConvElem<T>::kKC;
  static constexpr int kBTiles = ConvElem<T>::kBTiles;
  static constexpr int kBTile = N * kSwizzleRow;
  static constexpr int kStage = kATile + kBTiles * kBTile;
  static constexpr int kStages = kSmemBudget / kStage < kMaxStages ? kSmemBudget / kStage : kMaxStages;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStage + 2 * kStages * sizeof(uint64_t);
};

// What one launch computes. A GEMM [M, K] x [K, Nout] is the one-tap case:
// T = M, cin = K, cout = Nout (the GLU: inner, h's columns), taps 1, dil 1.
struct ConvPlan {
  int T;         // rows of x (K4: input rows q; a GEMM: M)
  int cin, cout;
  int taps;      // taps per output row: K2 k, K4 2
  int dil, pad;  // K2
  int stride;    // K4 s (even); 0 for K2
  int n_chunks;  // column tiles: ceil(cout / (N / b_parts)) (set by launch_taps)
  int flush;     // fp32: stages per tensor-core partial sum
  int b_parts = 1;    // row blocks of a stage's B tile: 2 for the GLU (value rows, gate rows)
  int n_rows = 0;     // row tiles x phases (set by launch_taps)
};

// The weight slice and the input row offset of tap j (K4: of output phase `phase`).
__device__ __forceinline__ void tap_at(const ConvPlan& p, int phase, int j, int& w_index,
                                       int& row_off) {
  if (p.stride == 0) {
    w_index = j;
    row_off = j * p.dil - p.pad;
    return;
  }
  const int half = p.stride / 2;
  const bool left = phase < half;
  w_index = j == 0 ? phase + half : (left ? phase + half + p.stride : phase + half - p.stride);
  row_off = j == 0 ? 0 : (left ? -1 : 1);
}

// ---- the products ------------------------------------------------------------

// d += A B, m64nCHk16, bf16 A and B K-major in shared memory.
template <int CH>
__device__ __forceinline__ void wgmma_bf16(float (&d)[CH / 2], uint64_t da, uint64_t db) {
  if constexpr (CH == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " FSAT_WGMMA_D16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : FSAT_WGMMA_OUT16(d)
        : "l"(da), "l"(db), "r"(1));
  } else if constexpr (CH == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FSAT_WGMMA_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FSAT_WGMMA_OUT32(d)
        : "l"(da), "l"(db), "r"(1));
  } else if constexpr (CH == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " FSAT_WGMMA_D48
        ", %48, %49, p, 1, 1, 0, 0;\n}\n"
        : FSAT_WGMMA_OUT48(d)
        : "l"(da), "l"(db), "r"(1));
  } else {
    static_assert(CH == 128, "bf16 wgmma widths: 32, 64, 96, 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FSAT_WGMMA_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : FSAT_WGMMA_OUT64(d)
        : "l"(da), "l"(db), "r"(1));
  }
}

// ---- the snake on a landed A tile ----------------------------------------------

// The bf16 snake in place on 64 rows of a 128B-swizzled tile of 64 channels
// from c0 (physical chunk p of row r holds channels c0 + 8 (p ^ (r & 7)) ..
// + 8); channels at or past Cin (zeros) are left alone. Cin % 8 == 0.
__device__ __forceinline__ void snake_rows_bf16(unsigned char* rows, int c0, int cin,
                                                const float* __restrict__ ab, int tid) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = tid + q * 128, r = i >> 3, p = i & 7;
    const int ch = c0 + ((p ^ (r & 7)) << 3);
    if (ch < cin) {
      uint4* ptr = reinterpret_cast<uint4*>(rows + r * kSwizzleRow + p * 16);
      Pack8 v;
      v.u = *ptr;
      const float4 a0 = *reinterpret_cast<const float4*>(ab + ch);
      const float4 a1 = *reinterpret_cast<const float4*>(ab + ch + 4);
      const float4 i0 = *reinterpret_cast<const float4*>(ab + cin + ch);
      const float4 i1 = *reinterpret_cast<const float4*>(ab + cin + ch + 4);
      const float al[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float ib[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v.h[e] = __float2bfloat16_rn(snake_poly(__bfloat162float(v.h[e]), al[e], ib[e]));
      *ptr = v.u;
    }
  }
}

// ---- the kernel -------------------------------------------------------------------

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Bias, one rounding, and the store of a warpgroup's 64 x N accumulator:
// K2 rows t, K4 rows q s + phase; rows at or past T are dropped.
template <typename T, int N, int CH>
__device__ __forceinline__ void store_tile(const float (&acc)[N / CH][CH / 2], const ConvPlan& p,
                                           const float* __restrict__ bias, T* __restrict__ y, int b,
                                           int row0, int n0, int phase, int tq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row0 + 8 * h;
    if (t >= p.T) continue;
    const size_t out_row =
        p.stride ? ((size_t)b * p.T + t) * p.stride + phase : (size_t)b * p.T + t;
    T* dst = y + out_row * p.cout + n0 + 2 * tq;
    const float* bb = bias + n0 + 2 * tq;
#pragma unroll
    for (int c = 0; c < N / CH; ++c)
#pragma unroll
      for (int j = 0; j < CH / 8; ++j) {
        const int col = c * CH + 8 * j;
        store2(dst + col, acc[c][4 * j + 2 * h] + bb[col], acc[c][4 * j + 2 * h + 1] + bb[col + 1]);
      }
  }
}

// The rounding to T at each of the TPU MLP kernel's cast points.
__device__ __forceinline__ float to_t(float v, const float*) { return v; }
__device__ __forceinline__ float to_t(float v, const bf16*) { return round_bf16(v); }

// The GLU of a warpgroup's 64 x N stacked accumulator: acc[0] holds the
// value columns and acc[1] the gate columns of the same N / 2 columns of h,
// so a thread's register i of each is one (v, g) pair. h = v * (g *
// sigmoid(g)) at the TPU kernel's rounding points (mlp.py:116-137): v and g
// rounded to T, the fp32 biases rounded to T and added in T, sigmoid in
// fp32 rounded, each product rounded. Rows at or past T and columns at or
// past cout (inner) are dropped; cout is even.
template <typename T, int CH>
__device__ __forceinline__ void store_glu(const float (&acc)[2][CH / 2], const ConvPlan& p,
                                          const float* __restrict__ bias, T* __restrict__ h,
                                          int row0, int n0, int tq) {
  const T* tag = nullptr;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = row0 + 8 * hh;
    if (t >= p.T) continue;
    T* dst = h + (size_t)t * p.cout;
#pragma unroll
    for (int j = 0; j < CH / 8; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
      if (col >= p.cout) continue;
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = to_t(acc[0][4 * j + 2 * hh + e], tag), g = to_t(acc[1][4 * j + 2 * hh + e], tag);
        if (bias != nullptr) {
          v = to_t(v + to_t(bias[col + e], tag), tag);
          g = to_t(g + to_t(bias[p.cout + col + e], tag), tag);
        }
        const float sig = to_t(1.f / (1.f + expf(-g)), tag);
        out[e] = to_t(v * to_t(g * sig, tag), tag);
      }
      store2(dst + col, out[0], out[1]);
    }
  }
}

// A GEMM's 64 x N accumulator rounded once to T (y [T, cout]); rows at or
// past T and columns at or past cout (even) are dropped.
template <typename T, int N, int CH>
__device__ __forceinline__ void store_gemm(const float (&acc)[N / CH][CH / 2], const ConvPlan& p,
                                           T* __restrict__ y, int row0, int n0, int tq) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = row0 + 8 * hh;
    if (t >= p.T) continue;
#pragma unroll
    for (int c = 0; c < N / CH; ++c)
#pragma unroll
      for (int j = 0; j < CH / 8; ++j) {
        const int col = n0 + c * CH + 8 * j + 2 * tq;
        if (col >= p.cout) continue;
        store2(y + (size_t)t * p.cout + col, acc[c][4 * j + 2 * hh], acc[c][4 * j + 2 * hh + 1]);
      }
  }
}

enum : int { kEpiGlu = 1, kEpiGemm = 2 };  // gemm_mainloop's epilogues

// A GEMM [M, K] x [K, cout] on a block: the one-tap case of the
// convolution kernel (conv_wgmma.cu: conv_taps_kernel) without its snake,
// the same ring of TMA-fed stages, products and fp32 flush; in addition a
// B tile loaded in p.b_parts row blocks of N / b_parts rows (block q from
// slice q of the weight map, stacked in shared memory: the GLU's value and
// gate rows), the row tiles fastest across blockIdx.x (kGemmRowsFastest),
// and the epilogue kEpi (store_glu, store_gemm). The convolution keeps its own
// kernel: ptxas allocates the spill-prone fp32 instantiations differently
// once it shares one with these options (its fp32 paths ran 8-18% slower).
template <typename T, int N, int CH, int kEpi>
__device__ __forceinline__ void gemm_mainloop(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                              const float* __restrict__ bias, T* __restrict__ y,
                                              const ConvPlan p) {
  using Tile = ConvTile<T, N>;
  constexpr int kStages = Tile::kStages;
  constexpr int kNC = N / CH;  // wgmma column blocks of the tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * Tile::kStage);
  uint64_t* empty = full + kStages;

  const int chunk = kGemmRowsFastest ? blockIdx.x / p.n_rows : blockIdx.x % p.n_chunks;
  const int r0 = (kGemmRowsFastest ? blockIdx.x % p.n_rows : blockIdx.x / p.n_chunks) * kM;
  const int part_rows = N / p.b_parts, n0 = chunk * part_rows;
  const int n_iter = (p.cin + Tile::kKC - 1) / Tile::kKC;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warp: one thread starts the loads
    if (threadIdx.x == kConsumers * 128) {
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) + 1) & 1);
        const int c0 = it * Tile::kKC;
        unsigned char* st = smem + s * Tile::kStage;
        mbar_expect_tx(&full[s], Tile::kStage);
        tma_load_3d(st, xmap, &full[s], c0, r0, 0);
        for (int q = 0; q < p.b_parts; ++q)
#pragma unroll
          for (int h = 0; h < Tile::kBTiles; ++h)
            tma_load_3d(st + kATile + h * Tile::kBTile + q * part_rows * kSwizzleRow, wmap,
                        &full[s], c0, n0, q * Tile::kBTiles + h);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows r0 + 64 wg .. + 64
  const int tid = threadIdx.x & 127, warp = tid >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int row_a = wg * 64 + warp * 16 + g;  // the lane's first row in the A tile
  float acc[kNC][CH / 2];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) acc[c][i] = 0.f;

  if constexpr (sizeof(T) == 2) {
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      const unsigned char* st = smem + s * Tile::kStage;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t a_addr = smem_u32(st) + wg * 64 * kSwizzleRow;
      const uint32_t b_addr = smem_u32(st) + kATile;
#pragma unroll
      for (int c = 0; c < kNC; ++c) reg_fence(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < kNC; ++c)
          wgmma_bf16<CH>(acc[c], kmajor_desc(a_addr + kk * 32),
                         kmajor_desc(b_addr + c * CH * kSwizzleRow + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kNC; ++c) reg_fence(acc[c]);
      mbar_arrive(&empty[s]);
    }
  } else {
    float part[kNC][CH / 2];
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int i = 0; i < CH / 2; ++i) part[c][i] = 0.f;
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      const unsigned char* st = smem + s * Tile::kStage;
      mbar_wait(&full[s], (it / kStages) & 1);
      uint32_t a_hi[4][4], a_lo[4][4];  // the four k8 slices of the stage's 32 channels
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row_a + 8 * (e & 1), col = 8 * kk + tq + 4 * (e >> 1);
          const float v = *reinterpret_cast<const float*>(st + sw128_offset(r, col >> 2) + (col & 3) * 4);
          a_hi[kk][e] = tf32_rna(v);
          a_lo[kk][e] = tf32_rna(v - __uint_as_float(a_hi[kk][e]));
        }
      const uint32_t hi_addr = smem_u32(st) + kATile, lo_addr = hi_addr + Tile::kBTile;
#pragma unroll
      for (int c = 0; c < kNC; ++c) reg_fence(part[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const uint64_t b_hi = kmajor_desc(hi_addr + c * CH * kSwizzleRow + kk * 32);
          const uint64_t b_lo = kmajor_desc(lo_addr + c * CH * kSwizzleRow + kk * 32);
          wgmma_tf32<CH>(part[c], a_lo[kk], b_hi, 1);
          wgmma_tf32<CH>(part[c], a_hi[kk], b_lo, 1);
          wgmma_tf32<CH>(part[c], a_hi[kk], b_hi, 1);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kNC; ++c) reg_fence(part[c]);
      mbar_arrive(&empty[s]);
      if ((it + 1) % p.flush == 0 || it + 1 == n_iter) {
#pragma unroll
        for (int c = 0; c < kNC; ++c)
#pragma unroll
          for (int i = 0; i < CH / 2; ++i) {
            acc[c][i] += part[c][i];
            part[c][i] = 0.f;
          }
      }
    }
  }
  if constexpr (kEpi == kEpiGlu) {
    static_assert(N == 2 * CH, "the GLU stacks its value and gate columns as two wgmma blocks");
    store_glu<T, CH>(acc, p, bias, y, r0 + row_a, n0, tq);
  } else {
    store_gemm<T, N, CH>(acc, p, y, r0 + row_a, n0, tq);
  }
}

// Launches `kernel` (conv_taps_kernel, or a __global__ shim of
// gemm_mainloop) with p's grid: x [B, T, cin] and the weights [w_slices,
// cout, cin] through 128B-swizzled maps (B tile boxes of N / b_parts rows);
// `args` go between the maps and p.
template <typename T, int N, typename Kernel, typename... Args>
int launch_taps(Kernel kernel, ConvPlan p, const void* x, const void* w, int w_slices, int B,
                cudaStream_t stream, Args... args) {
  using Tile = ConvTile<T, N>;
  const int part_rows = N / p.b_parts;
  p.n_chunks = (p.cout + part_rows - 1) / part_rows;
  p.n_rows = (p.T + kM - 1) / kM * (p.stride ? p.stride : 1);
  CUtensorMap xmap, wmap;
  cudaError_t err = sw128_map_3d(&xmap, ConvElem<T>::kMap, sizeof(T), x, p.cin, p.T, B,
                                 Tile::kKC, kM);
  if (err == cudaSuccess)
    err = sw128_map_3d(&wmap, ConvElem<T>::kMap, sizeof(T), w, p.cin, p.cout, w_slices, Tile::kKC,
                       part_rows);
  if (err == cudaSuccess) err = allow_smem(kernel, Tile::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.n_rows * p.n_chunks;
  if (blocks >= (1ll << 31) || B > 65535) return (int)cudaErrorInvalidConfiguration;
  kernel<<<dim3((unsigned)blocks, B), kThreads, Tile::kSmem, stream>>>(xmap, wmap, args..., p);
  return (int)cudaGetLastError();
}

}  // namespace
