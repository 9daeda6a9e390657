// K13: the fused SwiGLU MLP, out = ((x Wv^T + bv) * silu(x Wg^T + bg)) Wo^T.
//
// Replaces friendly_stable_audio_tools_tpu/ops/pallas/mlp.py:_glu_mlp_impl
// (:145; `_glu_mlp_kernel` :116, pallas_call :172). Rounding points as there:
// v = x.Wv and g = x.Wg accumulate in fp32 and round to T, the biases (fp32
// in memory) round to T and add in T, sigmoid(g) runs in fp32 and rounds, and
// h = v * (g * sigmoid(g)) rounds at each product; out accumulates h.Wo in
// fp32 and rounds once. T is float (every rounding is the identity) or bf16.
//
// Weights come in the port's nn.Linear layouts, contiguous along their input
// dimension: w_in [2 * inner, K] (GLU.proj.weight: value rows first, gate
// rows after, as the JAX package's w_in[:, :inner] / w_in[:, inner:]),
// w_out [Kout, inner] (linear_out.weight). Both are already K-major, the
// layout wgmma reads B in.
//
// Two routes, chosen by shape alone (ops/kernels/mlp.py:route):
//
// The tensor-core route (large M: a DiT's [2050-2080, 1536] tokens, a
// prompt's prefill) is bound by the products: 117.8 GFLOP at SAO's DiT
// shape, 0.119 ms at the bf16 rate. It runs two GEMMs on gemm_mainloop
// (taps_wgmma.cuh): the convolution kernel's wgmma/TMA mainloop in its
// one-tap case, with its tiles, ring, products and fp32 flush:
// - glu_gemm_kernel: a block owns 128 rows x N / 2 columns of h. Its B tile
//   is stacked: per stage the producer loads the value rows [n0, n0 + N/2)
//   and the gate rows [inner + n0, ...) of w_in by TMA from one map over
//   w_in as [2, inner, K], so one wgmma of width N yields v in its first
//   column block and g in its second, and a thread holds v and g of the same
//   column in the same register index: the GLU runs in registers at the
//   rounding points above and h is stored in T, [M, inner].
// - out_gemm_kernel: y = h w_out^T, rounded once (no bias: the caller adds
//   linear_out's, JAX :121-122).
// Each GEMM has one tile width per element type (GemmTiles) and one raster
// order (taps_wgmma.cuh: kGemmRowsFastest), both measured by
// mlp_variants.py. (Splitting GEMM2 over inner into fp32 partials summed in
// a fixed order paid 1.8x at M 64-256 but 4% at the DiT's M 2080 in fp32
// and lost in bf16; no path runs M 17-256, so there is no split. PERF.md §6.)
// The TPU kernel keeps h and a [bm, Kout] fp32 accumulator in VMEM across
// its sequential inner grid axis. On Hopper a 128-row x 1536 fp32
// accumulator is 768 KB, which neither registers nor shared memory hold, and
// recomputing h per output-column tile would multiply GEMM1 by Kout / N; so
// h goes through device memory: 25.6 MB in bf16 at SAO's shape, written and
// read back, ~15 us at 3.35 TB/s (~12% of the bound). The same function,
// not the TPU kernel's blocks. The grid runs its row tiles fastest (the
// convolution runs its column tiles fastest), so the blocks in flight share
// one weight tile in L2 and each weight tile is read from device memory
// about once; x (6.4 MB) stays in L2. fp32 is 3xTF32 as in the convolution:
// A split in registers, B as tf32 hi/lo tiles that fsat_tf32_split prepares
// per call ([parts, 2, rows, K]: 113 MB of fp32 weights read, 226 MB written
// at SAO's shape), the partial sum flushed into the fp32 total every `flush`
// stages (ops/kernels/mlp.py:F32_FLUSH).
//
// The streaming route (M <= 16: the audio LM's decode at M 2 = one row and
// its CFG twin, K 1024, inner 4096, Kout 1024, fp32) is a GEMV chain bound
// by reading the 50.3 MB of weights once: 15.0 us at 3.35 TB/s. It stays on
// the CUDA cores, one cooperative launch of up to one block per SM (128 at
// the decode), each with a producer warp that keeps a ring of 32 KB stages
// filled by 2-D TMA (~190 KB in flight per SM at M 2) and eight consumer
// warps. Phase 1: block b forms h for 32 columns (value and gate rows of
// w_in, 256 K at a time; a warp 4 columns, a lane 8 K positions, partial
// dot products in registers, reduced across the warp, the GLU at the
// rounding points) and stores them in an fp32 scratch h [M, inner]. A grid
// barrier. Phase 2: block b computes its R = Kout / blocks outputs (8 at
// the decode) for every row, each output's whole inner reduction in one warp
// in a fixed order, from w_out's rows and h. The producer starts on the
// w_out rows as soon as phase 1's stages are consumed, so they arrive
// during the barrier. The TPU kernel carries an fp32 [bm, Kout] accumulator
// across its sequential inner axis; blocks here run in parallel, so the
// barrier takes the place of that order and no output is summed from
// partials of several blocks: the result does not depend on scheduling,
// and no second launch sums partials. (Summing the blocks' partials in the
// launch, by an atomic ticket per output slice, left the blocks that drew
// the last tickets summing 1-8 MB alone: 0.085-0.68 ms at M 16; PERF.md,
// §6.)
// The grid and the ring at a shape are decided here alone (stream_grid,
// from the device's SM count and shared memory); the wrapper asks
// fsat_glu_stream_plan before it picks the route.
#include <cooperative_groups.h>

#include <mutex>

#include "taps_wgmma.cuh"

namespace {

// ---- the tensor-core route ---------------------------------------------------------

// The tile widths: GEMM1's stacked N (N / 2 columns of h per block) and
// GEMM2's N, by element type. mlp_variants.py times the others (bf16 GEMM1
// 192, 128, GEMM2 192, 128; fp32 GEMM1 64, GEMM2 96, 64) by substituting
// these lines.
template <typename T>
struct GemmTiles;
template <>
struct GemmTiles<bf16> { static constexpr int kGlu = 256, kOut = 256; };
template <>
struct GemmTiles<float> { static constexpr int kGlu = 128, kOut = 128; };

// The widest wgmma column block (bf16 up to 128, tf32 up to 64) dividing n.
template <typename T>
constexpr int wgmma_width(int n) {
  return sizeof(T) == 2 ? (n % 128 == 0 ? 128 : n % 96 == 0 ? 96 : n % 64 == 0 ? 64 : 32)
                        : (n % 64 == 0 ? 64 : 32);
}

template <typename T, int N, int CH>
__global__ void __launch_bounds__(kThreads, 1)
glu_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ bias, T* __restrict__ h, const ConvPlan p) {
  gemm_mainloop<T, N, CH, kEpiGlu>(&xmap, &wmap, bias, h, p);
}

template <typename T, int N, int CH>
__global__ void __launch_bounds__(kThreads, 1)
out_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                T* __restrict__ y, const ConvPlan p) {
  gemm_mainloop<T, N, CH, kEpiGemm>(&xmap, &wmap, nullptr, y, p);
}

// w [parts * rows, K] fp32 -> out [parts, 2, rows, K]: each part's tf32 hi
// = tf32(w) and lo = tf32(w - hi), the fp32 GEMMs' B operands. K % 4 == 0.
__global__ void tf32_split_kernel(const float4* __restrict__ w, float4* __restrict__ out,
                                  long long part_vecs, int parts) {
  const long long total = part_vecs * parts;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long q = i / part_vecs, r = i % part_vecs;
    const float4 v = w[i];
    const float vv[4] = {v.x, v.y, v.z, v.w};
    float hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = __uint_as_float(tf32_rna(vv[e]));
      lo[e] = __uint_as_float(tf32_rna(vv[e] - hi[e]));
    }
    out[2 * q * part_vecs + r] = make_float4(hi[0], hi[1], hi[2], hi[3]);
    out[(2 * q + 1) * part_vecs + r] = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

template <typename T>
int glu_gemm(int M, int K, int inner, int flush, const void* x, const void* w, const float* b,
             void* h, cudaStream_t st) {
  constexpr int N = GemmTiles<T>::kGlu;
  ConvPlan p{M, K, inner, 1, 1, 0, 0, 0, flush};
  p.b_parts = 2;
  return launch_taps<T, N>(glu_gemm_kernel<T, N, N / 2>, p, x, w, 2 * ConvElem<T>::kBTiles, 1, st,
                           b, static_cast<T*>(h));
}

template <typename T>
int out_gemm(int M, int inner, int Kout, int flush, const void* h, const void* w, void* y,
             cudaStream_t st) {
  constexpr int N = GemmTiles<T>::kOut;
  ConvPlan p{M, inner, Kout, 1, 1, 0, 0, 0, flush};
  return launch_taps<T, N>(out_gemm_kernel<T, N, wgmma_width<T>(N)>, p, h, w, ConvElem<T>::kBTiles,
                           1, st, static_cast<T*>(y));
}

// ---- the streaming route -----------------------------------------------------------

constexpr int kStreamWarps = 8;                          // consumer warps
constexpr int kConsumerThreads = kStreamWarps * 32;
constexpr int kStreamThreads = kConsumerThreads + 32;    // + one producer warp
constexpr int kCols = 32;        // columns of h per phase-1 tile
constexpr int kKB = 256;         // elements per TMA box row: K (phase 1) or inner (phase 2)
constexpr int kSlot = 32 * 1024; // bytes of one ring stage
constexpr int kMaxStreamStages = 6;
constexpr int kMaxOutRows = 32;  // phase 2: w_out rows per block, at most
constexpr int kSmemLimit = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Eight elements from shared memory, widened to fp32: two 16-byte words of
// fp32 (at p and p + 128 elements) or one of bf16.
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 128);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&out)[8]) {
  Pack8 pk;
  pk.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(pk.h[e]);
}

// The fp32 at p and p + 128 (fp32 lanes) or p .. p + 7 (bf16 lanes): the
// eight positions a lane takes of a 256-wide box row, matching load8.
__device__ __forceinline__ void load8_f32(const float* p, bool f32_layout, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + (f32_layout ? 128 : 4));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Phase 2's stage: `boxes` TMA boxes of [rows, 256] of w_out side by side,
// an inner span of 256 * boxes; the most that fit a ring stage, at most 4.
__host__ __device__ inline int out_boxes(int rows, int elem) {
  const int fit = kSlot / (rows * kKB * elem);
  return fit < 1 ? 0 : (fit > 4 ? 4 : fit);
}

// Shared memory of the streaming kernel, in bytes from the 1024-aligned
// base: the ring, x as fp32 [BM][kpad] (in phase 2 a chunk of h [BM][span]
// in the same place), v of a tile [BM][kCols], the barriers.
struct StreamSmem {
  int kpad, span, x, vs, bars, total;
};

__host__ __device__ inline StreamSmem stream_smem(int bm, int K, int span, int stages) {
  StreamSmem s;
  s.kpad = (K + kKB - 1) / kKB * kKB;
  s.span = span;
  s.x = stages * kSlot;
  s.vs = s.x + bm * (s.kpad > span ? s.kpad : span) * 4;
  s.bars = s.vs + bm * kCols * 4;
  s.total = 1024 + s.bars + 2 * stages * 8;
  return s;
}

inline int stream_stages(int bm, int K, int span) {
  for (int st = kMaxStreamStages; st >= 2; --st)
    if (stream_smem(bm, K, span, st).total <= kSmemLimit) return st;
  return 0;
}

// One cooperative launch of G blocks (all resident at once), rows [0, M <=
// BM) of x. Phase 1: block b forms h for the column tiles b, b + G, ... (32
// columns each: the value rows' nk K chunks, then the gate rows', streamed
// through the ring) and stores them in `hbuf` [M, inner] fp32. A grid
// barrier (cooperative groups' grid sync, whose arrival count the driver
// keeps per launch, so launches on several streams at once do not meet
// in it; every thread of every block takes part, the producer warp too).
// Phase 2: block b computes outputs [b R, b R + R) of every row,
// each the whole inner reduction in one warp in a fixed order, from w_out's
// rows (streamed through the ring; the producer starts on them as soon as
// phase 1's stages are done, so they arrive during the barrier) and from h
// (a span of it at a time from hbuf into shared memory). No partial sums.
template <typename T, int BM>
__global__ void __launch_bounds__(kStreamThreads, 1)
glu_stream_kernel(const __grid_constant__ CUtensorMap win_map,
                  const __grid_constant__ CUtensorMap wout_map, const T* __restrict__ x,
                  const float* __restrict__ b_in, float* __restrict__ hbuf, T* __restrict__ y,
                  int M, int K, int inner, int Kout, int R, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int boxes = out_boxes(R, sizeof(T)), span = boxes * kKB;
  const StreamSmem L = stream_smem(BM, K, span, stages);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  float* hc = xs;  // phase 2: h [BM][span]
  float* vs = reinterpret_cast<float*>(smem + L.vs);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  const int nk = L.kpad / kKB, G = gridDim.x, b = blockIdx.x;
  const int n_tiles = inner / kCols, my_tiles = (n_tiles - b + G - 1) / G;
  const int n_out = (inner + span - 1) / span, n0 = b * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (warp == kStreamWarps) {  // the producer warp: one thread starts the loads
    const int n1 = 2 * nk * my_tiles, n_all = n1 + (n0 < Kout ? n_out : 0);
    auto load = [&](int i) {
      const int s = i % stages;
      if (i >= stages) mbar_wait(&empty[s], ((i / stages) + 1) & 1);
      unsigned char* dst = smem + s * kSlot;
      if (i < n1) {
        const int t = b + (i / (2 * nk)) * G, j = i % (2 * nk);
        mbar_expect_tx(&full[s], kCols * kKB * sizeof(T));
        tma_load_2d(dst, &win_map, &full[s], (j % nk) * kKB, (j / nk) * inner + t * kCols);
      } else {
        const int c = i - n1;
        mbar_expect_tx(&full[s], boxes * R * kKB * sizeof(T));
        for (int q = 0; q < boxes; ++q)
          tma_load_2d(dst + q * R * kKB * sizeof(T), &wout_map, &full[s], c * span + q * kKB, n0);
      }
    };
    // phase 1's loads and the first `stages` of phase 2's take the slots
    // that phase 1 frees; the rest wait for phase 2's, past the grid barrier
    const int before = n_all < n1 + stages ? n_all : n1 + stages;
    for (int i = 0; lane == 0 && i < before; ++i) load(i);
    __syncwarp();
    grid.sync();
    for (int i = before; lane == 0 && i < n_all; ++i) load(i);
    return;
  }

  // x rows as fp32, zeros past M and K, 16 loads in flight per thread
  constexpr int kXBatch = 16;
  for (int i0 = tid; i0 < BM * L.kpad; i0 += kConsumerThreads * kXBatch) {
    float v[kXBatch];
#pragma unroll
    for (int u = 0; u < kXBatch; ++u) {
      const int i = i0 + u * kConsumerThreads, m = i / L.kpad, k = i % L.kpad;
      v[u] = (i < BM * L.kpad && m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kXBatch; ++u)
      if (i0 + u * kConsumerThreads < BM * L.kpad) xs[i0 + u * kConsumerThreads] = v[u];
  }
  bar_sync(1, kConsumerThreads);

  // phase 1: v, then g and h, for the warp's 4 columns of each tile: lane l
  // takes K positions 4l .. 4l + 3 and 128 + 4l .. (fp32) or 8l .. 8l + 7
  // (bf16) of each chunk
  constexpr int kRows = kCols / kStreamWarps;
  const T* tag = nullptr;
  const int kx = sizeof(T) == 4 ? 4 * lane : 8 * lane;
  int it = 0;
  for (int ti = 0; ti < my_tiles; ++ti) {
    const int j0 = (b + ti * G) * kCols;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float acc[kRows][BM];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int m = 0; m < BM; ++m) acc[r][m] = 0.f;
      for (int c = 0; c < nk; ++c, ++it) {
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const T* tile = reinterpret_cast<const T*>(smem + s * kSlot);
        float w[kRows][8];
#pragma unroll
        for (int r = 0; r < kRows; ++r) load8(tile + (warp * kRows + r) * kKB + kx, w[r]);
        mbar_arrive(&empty[s]);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          float xv[8];
          load8_f32(xs + m * L.kpad + c * kKB + kx, sizeof(T) == 4, xv);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][m] = fmaf(w[r][e], xv[e], acc[r][m]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int col = warp * kRows + r;
        const float bias = b_in != nullptr ? to_t(b_in[half * inner + j0 + col], tag) : 0.f;
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float sum = warp_sum(acc[r][m]);
          if (lane == m && m < M) {  // row m's GLU on lane m
            float val = to_t(sum, tag);
            if (b_in != nullptr) val = to_t(val + bias, tag);
            if (half == 0) {
              vs[m * kCols + col] = val;
            } else {
              const float sig = to_t(1.f / (1.f + expf(-val)), tag);
              hbuf[(size_t)m * inner + j0 + col] =
                  to_t(vs[m * kCols + col] * to_t(val * sig, tag), tag);
            }
          }
        }
      }
      __syncwarp();
    }
  }
  grid.sync();
  if (n0 >= Kout) return;

  // phase 2: y[m][n0 + r] for the block's R rows, warp w rows w, w + 8, ...;
  // lanes take inner positions of each 256-wide box as phase 1's lanes take K
  constexpr int kMaxRowsPerWarp = kMaxOutRows / kStreamWarps;
  float acc[kMaxRowsPerWarp][BM];
#pragma unroll
  for (int r = 0; r < kMaxRowsPerWarp; ++r)
#pragma unroll
    for (int m = 0; m < BM; ++m) acc[r][m] = 0.f;
  // a thread's share of one span of h: at most BM * 1024 / 4 float4s over the 256 threads
  constexpr int kHLoads = BM * 4 * kKB / 4 / kConsumerThreads;
  for (int c = 0; c < n_out; ++c, ++it) {
    // h's span [c span, c span + span) into shared memory (zeros past inner),
    // every load issued before the first store
    float4 hv4[kHLoads];
#pragma unroll
    for (int u = 0; u < kHLoads; ++u) {
      const int i = tid + u * kConsumerThreads;
      const int m = i / (span / 4), p = 4 * (i % (span / 4)), j = c * span + p;
      hv4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < BM * span / 4 && m < M && j < inner)
        hv4[u] = __ldcg(reinterpret_cast<const float4*>(hbuf + (size_t)m * inner + j));
    }
#pragma unroll
    for (int u = 0; u < kHLoads; ++u) {
      const int i = tid + u * kConsumerThreads;
      if (i < BM * span / 4)
        *reinterpret_cast<float4*>(hc + (i / (span / 4)) * span + 4 * (i % (span / 4))) = hv4[u];
    }
    bar_sync(1, kConsumerThreads);
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    const T* tile = reinterpret_cast<const T*>(smem + s * kSlot);
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int r = warp + rr * kStreamWarps;
      if (r >= R) break;
      for (int q = 0; q < boxes; ++q) {
        float w[8];
        load8(tile + (q * R + r) * kKB + kx, w);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          float hv[8];
          load8_f32(hc + m * span + q * kKB + kx, sizeof(T) == 4, hv);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[rr][m] = fmaf(w[e], hv[e], acc[rr][m]);
        }
      }
    }
    mbar_arrive(&empty[s]);
    bar_sync(1, kConsumerThreads);  // hc is rewritten by the next span
  }
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    const int n = n0 + warp + rr * kStreamWarps;
    if (warp + rr * kStreamWarps >= R) break;
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const float sum = warp_sum(acc[rr][m]);
      if (lane == 0 && m < M && n < Kout) store1(y + (size_t)m * Kout + n, sum);
    }
  }
}

// The grid of a launch at this shape: G blocks, all resident at once (one
// per SM at most, and enough that each takes at most kMaxOutRows outputs),
// and R outputs per block; false where the kernel does not take the shape.
// The answer for the last device and shape is kept: the queries cost tens
// of microseconds, and the LM's decode calls one shape thousands of times.
template <typename T, int BM>
bool stream_grid(int K, int inner, int Kout, int& G, int& R, int& stages, int& smem) {
  static std::mutex lock;
  static int key[4] = {-1, -1, -1, -1}, val[4];
  static bool fits = false;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  std::lock_guard<std::mutex> guard(lock);
  if (key[0] != dev || key[1] != K || key[2] != inner || key[3] != Kout) {
    int sms = 0, per_sm = 0;
    fits = K * (int)sizeof(T) % 16 == 0 && inner % kCols == 0 && inner * (int)sizeof(T) % 16 == 0 &&
           cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess;
    if (fits) {
      val[0] = inner / kCols < sms ? inner / kCols : sms;
      val[1] = (Kout + val[0] - 1) / val[0];
      const int span = out_boxes(val[1], sizeof(T)) * kKB;
      val[2] = stream_stages(BM, K, span);
      val[3] = stream_smem(BM, K, span, val[2]).total;
      fits = val[1] <= kMaxOutRows && val[2] > 0 &&
             allow_smem(glu_stream_kernel<T, BM>, val[3]) == cudaSuccess &&
             cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, glu_stream_kernel<T, BM>,
                                                           kStreamThreads, val[3]) == cudaSuccess &&
             per_sm >= 1;
    }
    key[0] = dev, key[1] = K, key[2] = inner, key[3] = Kout;
  }
  G = val[0], R = val[1], stages = val[2], smem = val[3];
  return fits;
}

template <typename T, int BM>
int launch_stream(const void* x, const void* w_in, const float* b_in, const void* w_out,
                  float* hbuf, void* y, int M, int K, int inner, int Kout, cudaStream_t st) {
  int G, R, stages, smem;
  if (M > BM || !stream_grid<T, BM>(K, inner, Kout, G, R, stages, smem))
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType dt =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap win_map, wout_map;
  cudaError_t err = plain_map_2d(&win_map, dt, sizeof(T), w_in, K, 2 * (uint64_t)inner, kKB, kCols);
  if (err == cudaSuccess) err = plain_map_2d(&wout_map, dt, sizeof(T), w_out, inner, Kout, kKB, R);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, 1, 1);
  cfg.blockDim = dim3(kStreamThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, glu_stream_kernel<T, BM>, win_map, wout_map,
                           static_cast<const T*>(x), b_in, hbuf, static_cast<T*>(y), M, K, inner,
                           Kout, R, stages);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The M tile of a streaming launch: the least of 2 (the decode: one row and
// its CFG twin), 4, 8, 16 that holds M; 0 past 16.
inline int stream_bm(int M) { return M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : M <= 16 ? 16 : 0; }

template <typename T>
int stream_entry(const void* x, const void* w_in, const float* b_in, const void* w_out,
                 float* hbuf, void* y, int M, int K, int inner, int Kout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (stream_bm(M)) {
    case 2: return launch_stream<T, 2>(x, w_in, b_in, w_out, hbuf, y, M, K, inner, Kout, st);
    case 4: return launch_stream<T, 4>(x, w_in, b_in, w_out, hbuf, y, M, K, inner, Kout, st);
    case 8: return launch_stream<T, 8>(x, w_in, b_in, w_out, hbuf, y, M, K, inner, Kout, st);
    case 16: return launch_stream<T, 16>(x, w_in, b_in, w_out, hbuf, y, M, K, inner, Kout, st);
  }
  return (int)cudaErrorInvalidValue;
}

// plan = {M tile, blocks, outputs per block, ring stages, shared bytes} of a
// streaming launch on the current device; an error where it does not fit.
template <typename T>
int stream_plan(int M, int K, int inner, int Kout, int* plan) {
  int G = 0, R = 0, stages = 0, smem = 0;
  bool fits = false;
  switch (plan[0] = stream_bm(M)) {
    case 2: fits = stream_grid<T, 2>(K, inner, Kout, G, R, stages, smem); break;
    case 4: fits = stream_grid<T, 4>(K, inner, Kout, G, R, stages, smem); break;
    case 8: fits = stream_grid<T, 8>(K, inner, Kout, G, R, stages, smem); break;
    case 16: fits = stream_grid<T, 16>(K, inner, Kout, G, R, stages, smem); break;
  }
  plan[1] = G, plan[2] = R, plan[3] = stages, plan[4] = smem;
  return M >= 1 && fits ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// The tensor-core route's GEMM1 with the GLU epilogue: x [M, K], w = w_in
// [2 * inner, K] (bf16) or fsat_tf32_split's [2, 2, inner, K] (fp32), b_in
// [2 * inner] fp32 or null -> h [M, inner]. K * elem and inner * elem % 16
// == 0.
extern "C" int fsat_glu_gemm(const void* x, const void* w, const float* b_in, void* h, int M, int K,
                             int inner, int f32, int flush, void* stream) {
  const int elem = f32 ? 4 : 2;
  if (K * elem % 16 || inner * elem % 16 || M < 1 || flush < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return f32 ? glu_gemm<float>(M, K, inner, flush, x, w, b_in, h, st)
             : glu_gemm<bf16>(M, K, inner, flush, x, w, b_in, h, st);
}

// GEMM2: h [M, inner], w = w_out [Kout, inner] (bf16) or fsat_tf32_split's
// [1, 2, Kout, inner] (fp32) -> y [M, Kout]. Kout even.
extern "C" int fsat_out_gemm(const void* h, const void* w, void* y, int M, int inner, int Kout,
                             int f32, int flush, void* stream) {
  const int elem = f32 ? 4 : 2;
  if (inner * elem % 16 || Kout % 2 || M < 1 || flush < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return f32 ? out_gemm<float>(M, inner, Kout, flush, h, w, y, st)
             : out_gemm<bf16>(M, inner, Kout, flush, h, w, y, st);
}

// plan = {GEMM1's stacked tile width, its blocks, GEMM2's tile width, its
// blocks} of a tensor-core call (what launch_taps launches).
extern "C" int fsat_glu_tensor_plan(int M, int inner, int Kout, int f32, int* plan) {
  const int glu_n = f32 ? GemmTiles<float>::kGlu : GemmTiles<bf16>::kGlu;
  const int out_n = f32 ? GemmTiles<float>::kOut : GemmTiles<bf16>::kOut;
  const int rows = (M + kM - 1) / kM;
  plan[0] = glu_n, plan[1] = rows * ((inner + glu_n / 2 - 1) / (glu_n / 2));
  plan[2] = out_n, plan[3] = rows * ((Kout + out_n - 1) / out_n);
  return M >= 1 ? 0 : (int)cudaErrorInvalidValue;
}

// w [parts * rows, K] fp32 -> out [parts, 2, rows, K], the tf32 hi/lo parts.
extern "C" int fsat_tf32_split(const float* w, float* out, int rows, int K, int parts, void* stream) {
  if (K % 4 || rows < 1 || parts < 1) return (int)cudaErrorInvalidValue;
  const long long part_vecs = (long long)rows * K / 4;
  const long long total = part_vecs * parts;
  const int blocks = (int)((total + 255) / 256 < 8 * 132 ? (total + 255) / 256 : 8 * 132);
  tf32_split_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(w), reinterpret_cast<float4*>(out), part_vecs, parts);
  return (int)cudaGetLastError();
}

// The streaming route: x [M <= 16, K], w_in [2 * inner, K], b_in or null,
// w_out [Kout, inner] (all T) -> y [M, Kout]; hbuf: fp32 [M, inner] scratch.
extern "C" int fsat_glu_stream(const void* x, const void* w_in, const float* b_in,
                               const void* w_out, float* hbuf, void* y, int M, int K, int inner,
                               int Kout, int f32, void* stream) {
  return f32 ? stream_entry<float>(x, w_in, b_in, w_out, hbuf, y, M, K, inner, Kout, stream)
             : stream_entry<bf16>(x, w_in, b_in, w_out, hbuf, y, M, K, inner, Kout, stream);
}

// The streaming launch's plan at this shape on the current device (see
// stream_plan); an error where the kernel does not take the shape there.
extern "C" int fsat_glu_stream_plan(int M, int K, int inner, int Kout, int f32, int* plan) {
  return f32 ? stream_plan<float>(M, K, inner, Kout, plan) : stream_plan<bf16>(M, K, inner, Kout, plan);
}
