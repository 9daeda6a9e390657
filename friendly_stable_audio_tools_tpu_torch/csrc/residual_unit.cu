// K3 fused_residual_unit on Hopper: the Oobleck VAE's residual unit
//   y = x + conv1x1(snake2(conv7_dil(snake1(x)) + b1)) + b2,   C -> C,
// channels-last, bf16 or fp32, on wgmma fed by TMA.
//
// K3 fused_residual_unit  replaces conv1d.py:_ru_forward / _ru_kernel (:507, :473)
// (friendly_stable_audio_tools_tpu/ops/pallas/).
//
// Numerics, the TPU kernel's rounding points: snake1 of x in fp32 with the
// polynomial sin^2 (common.cuh), rounded to the dtype before the products;
// the k7 dilated conv accumulated in fp32; + b1 in fp32, snake2 in fp32,
// rounded to the dtype (h); h . W2 accumulated in fp32; + b2 + x (unsnaked,
// fp32), one rounding. In fp32 nothing is rounded, and the products are
// 3xTF32 as in every fp32 kernel here (each part rounded to nearest; each
// tensor-core partial sum added into an fp32 total on the CUDA cores every
// conv1d.py:F32_FLUSH stages of 32 channels: the accumulate of the tensor
// cores truncates).
//
// Bound: 16 C^2 products per row (seven taps and the 1x1) at 989 TFLOP/s in
// bf16 or 3xTF32's 165 in fp32; x read and y written once at 3.35 TB/s is
// below that at every main-path shape (bf16 C 128: 1.92 against 3.34 ms at
// 12,582,912 rows). The WMMA kernels this replaces (PR 1 bf16, PR 6 fp32)
// ran at 4.7-12.5% of it: synchronous loads of x and all seven taps'
// weights per 32-channel step (fp32: 16) behind two __syncthreads, 64-row
// blocks (fp32: 32) each streaming all 8 C^2 weights, an fp32 scratch tile
// in the epilogue, and in fp32 both operands re-split at every fragment
// load; at C 512 and 1024 the fp32 one was slower than cuDNN's FFMA chain.
//
// Two routes, picked by (C, dtype) alone (ops/kernels/conv1d.py:ru_route),
// from the times of both at SA 2.0's decode shapes (conv_variants.py,
// NVIDIA H100 80GB HBM3, 700 W, dilation 3): fused at bf16 C 128 (6.21
// against 7.13 ms at T 6,291,456), split everywhere else (bf16 C 256 4.41
// against 5.13, C 512 3.31 against 4.72; fp32 C 128 22.79 against 25.88,
// C 256 19.01 against 25.51: the fused route's fp32 form, 3xTF32 with A
// split per tap, never won and is gone). At C 128 the split route's bytes
// weigh most: h's and the snake pass's round trips move 4 x T x C x elem
// more than the fused route, ~2/3 of the bf16 bound there.
//
// Fused (ru_fused_kernel, bf16): one block per 128 rows of one batch row,
// two consumer warpgroups of 64 rows and one producer warp, h never leaves
// shared memory.
// - Stage 1, 128 columns of h at a time: per chunk of 64 channels (one
//   128-byte row) the producer loads rows [t0 - 3 dil, t0 + 128 + 3 dil) of
//   x with one TMA box (box_rows = 128 + 6 dil rounded up to 8, at most
//   184: rows outside [0, T) arrive as zeros, and snake(0) = 0) into an x
//   ring of x_slots, and the seven taps' K-major weight tiles into a ring
//   of w_stages. The 256 consumer threads snake the box once in place (not
//   once per tap: at C 128 a per-tap snake costs more than the tap's
//   products), meet at named barrier 1, and each tap j reads its A at box
//   row 64 wg + j dil. That offset is no multiple of the swizzle's 8-row
//   atom, so A comes from registers by ldmatrix (any row of a swizzled
//   tile, each lane giving its own row address). (A descriptor with the
//   base-offset field set to the start row's phase gave wrong products on
//   the card.)
// - The stage-1 epilogue writes snake2(acc + b1), rounded, into the h tile
//   in shared memory as C / 64 128B-swizzled panels of 128 rows (the layout
//   TMA lands), each warpgroup its own 64 rows.
// - Stage 2: h . W2, 128 columns at a time, A the warpgroup's rows of h by
//   a shared-memory descriptor (after fence.proxy.async and named barrier 2
//   + wg) and the K-major W2 tiles through the same weight ring; the
//   epilogue adds b2 and the residual x (its rows read again from device
//   memory, L2-hot) and rounds once.
// - Shared memory (ru_plan): h 128 x C x 2 B, x_slots x box_rows x 128 B,
//   w_stages x 16 KB, within 232,448 bytes; the plan takes two x slots
//   where they fit and the most weight stages up to 4.
// Split: three launches.
// - A pass snakes x once into y's buffer (rounded to the dtype: the values
//   the conv's A tiles take), so that the conv does not snake each tap's A
//   tile again for every column tile (at bf16 C 1024 the per-tap snake
//   took the route from 1.41 to 3.01 ms).
// - Stage 1 is the conv kernel's mainloop (taps_wgmma.cuh: conv_mainloop,
//   K2's wide route) over the snaked rows with the epilogue store_ru_h:
//   h = snake2(acc + b1), rounded, into a device scratch [B, T, C] in the
//   activation dtype that the wrapper allocates.
// - Stage 2 is the GEMMs' mainloop (gemm_mainloop, K13's) over the B T rows
//   of h with the epilogue store_residual: + b2 + x, one rounding.
// - Tile width: fp32 128 (3xTF32 with the fp32 flush, as the conv and GEMM
//   kernels); bf16 256 where it divides C, else 128.
// Weights: one K-major tensor per call (fsat_conv_weights): [8, C, C] in
// bf16, [8, 2, C, C] tf32 hi/lo in fp32; slices 0-6 w1's taps, 7 w2.
// Measured (conv_variants.py, as above): the split route 38-59% of the
// bound (bf16 C 256 the lowest, fp32 43% at C 128); fused bf16 C 128 26-27%,
// held by the snake and the epilogues, which do not overlap the products. Loading no weight
// tile past the ring's first fill gained at most 2%, so a cluster
// multicast of the weight tiles (half those reads) is not pursued; two
// blocks per SM (112 registers) ran 12% slower, and snaking the next box
// beside each tap's products ran slower too (a branch-free, predicated
// snake computes on the taps without one). ptxas: ru_fused_kernel 160
// registers, no spills; the split route's kernels as the conv and GEMM
// kernels they share.
#include "taps_wgmma.cuh"

namespace {

constexpr int kRuTaps = 7;
constexpr int kRuMaxSmem = 232448;  // a Hopper block's dynamic shared memory
// the split route snakes x once in a pass of its own (true), or its conv
// snakes each tap's A tile as K2 does (false: conv_variants.py times it)
constexpr bool kRuSplitPreSnake = true;
// the fused route (bf16): 128 columns of h (stage 1) and of y (stage 2) a
// pass, one m64n128 wgmma wide; 64 channels a 128-byte row
constexpr int kRuN = 128;
constexpr int kRuKC = 64;
constexpr int kRuWStage = kRuN * kSwizzleRow;  // one weight tile: 16 KB
constexpr int kRuPanel = kM * kSwizzleRow;     // 64 channels of h: 16 KB

// What a fused launch computes and how its shared memory is cut
// (ops/kernels/conv1d.py:ru_plan).
struct RuPlan {
  int T, C, dil, pad;  // pad = 3 dil
  int box_rows;        // rows of one chunk's x box: kM + 6 dil rounded up to 8
  int x_slots;         // x boxes in flight
  int w_stages;        // weight tiles in flight
};

size_t ru_smem(const RuPlan& p) {
  return 1024 + (size_t)kM * p.C * sizeof(bf16) + (size_t)p.x_slots * p.box_rows * kSwizzleRow +
         (size_t)p.w_stages * kRuWStage + 2 * (size_t)(p.x_slots + p.w_stages) * sizeof(uint64_t);
}

// snake1 in place on a landed x box of `rows` rows x 64 channels from c0
// (128B-swizzled: physical 16-byte chunk q of row r holds channels c0 + 8
// (q ^ (r & 7)) ..), rounded to bf16, by the 256 consumer threads.
__device__ __forceinline__ void snake_box(unsigned char* box, int rows, int c0, int C,
                                          const float* __restrict__ ab, int tid) {
  for (int i = tid; i < rows * 8; i += kConsumers * 128) {
    const int r = i >> 3, q = i & 7;
    uint4* ptr = reinterpret_cast<uint4*>(box + r * kSwizzleRow + q * 16);
    const int ch = c0 + ((q ^ (r & 7)) << 3);
    Pack8 v;
    v.u = *ptr;
    const float4 a0 = *reinterpret_cast<const float4*>(ab + ch);
    const float4 a1 = *reinterpret_cast<const float4*>(ab + ch + 4);
    const float4 i0 = *reinterpret_cast<const float4*>(ab + C + ch);
    const float4 i1 = *reinterpret_cast<const float4*>(ab + C + ch + 4);
    const float al[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float ib[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v.h[e] = __float2bfloat16_rn(snake_poly(__bfloat162float(v.h[e]), al[e], ib[e]));
    *ptr = v.u;
  }
}

// h = snake2(acc + b1), rounded to bf16, for columns n0 .. n0 + 128 of a
// warpgroup's rows (row0, row0 + 8: the lane's) of the shared h tile.
__device__ __forceinline__ void store_h_smem(const float (&acc)[kRuN / 2], unsigned char* hs,
                                             const float* __restrict__ b1,
                                             const float* __restrict__ ab2, int C, int row0,
                                             int n0, int tq) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
#pragma unroll
    for (int j = 0; j < kRuN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * tq;
      const int in_panel = (n % kRuKC) * 2;  // byte in the panel's row
      unsigned char* dst = hs + (n / kRuKC) * kRuPanel + sw128_offset(r, in_panel >> 4) +
                           (in_panel & 15);
      store2(reinterpret_cast<bf16*>(dst),
             snake_poly(acc[4 * j + 2 * hh] + b1[n], ab2[n], ab2[C + n]),
             snake_poly(acc[4 * j + 2 * hh + 1] + b1[n + 1], ab2[n + 1], ab2[C + n + 1]));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ru_fused_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ b1, const float* __restrict__ ab1,
                const float* __restrict__ b2, const float* __restrict__ ab2,
                const bf16* __restrict__ x, bf16* __restrict__ y, const RuPlan p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* hs = smem;  // h: C / 64 panels of kM rows
  unsigned char* xs = hs + (size_t)(p.C / kRuKC) * kRuPanel;
  const int x_slot = p.box_rows * kSwizzleRow;
  unsigned char* ws = xs + p.x_slots * x_slot;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(ws + p.w_stages * kRuWStage);
  uint64_t* x_empty = x_full + p.x_slots;
  uint64_t* w_full = x_empty + p.x_slots;
  uint64_t* w_empty = w_full + p.w_stages;

  const int r0 = blockIdx.x * kM, b = blockIdx.y;
  const int n_k = p.C / kRuKC, n_col = p.C / kRuN;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.x_slots; ++s) {
      mbar_init(&x_full[s], 1);
      mbar_init(&x_empty[s], kConsumers * 128);
    }
    for (int s = 0; s < p.w_stages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warp: one thread starts the loads
    if (threadIdx.x == kConsumers * 128) {
      int wi = 0;
      auto load_w = [&](int slice, int c0, int n0) {
        const int s = wi % p.w_stages;
        if (wi >= p.w_stages) mbar_wait(&w_empty[s], ((wi / p.w_stages) + 1) & 1);
        mbar_expect_tx(&w_full[s], kRuWStage);
        tma_load_3d(ws + s * kRuWStage, &wmap, &w_full[s], c0, n0, slice);
        ++wi;
      };
      for (int q = 0; q < n_col * n_k; ++q) {  // chunk q % n_k of column pass q / n_k
        const int s = q % p.x_slots;
        if (q >= p.x_slots) mbar_wait(&x_empty[s], ((q / p.x_slots) + 1) & 1);
        mbar_expect_tx(&x_full[s], x_slot);
        tma_load_3d(xs + s * x_slot, &xmap, &x_full[s], (q % n_k) * kRuKC, r0 - p.pad, b);
        for (int j = 0; j < kRuTaps; ++j) load_w(j, (q % n_k) * kRuKC, (q / n_k) * kRuN);
      }
      for (int n2 = 0; n2 < n_col; ++n2)
        for (int k = 0; k < n_k; ++k) load_w(kRuTaps, k * kRuKC, n2 * kRuN);
    }
    return;
  }

  // consumers: warpgroup wg owns rows r0 + 64 wg .. + 64
  const int tid = threadIdx.x & 127, warp = tid >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int row_w = wg * 64 + warp * 16;  // the warp's first row in the block
  float acc[kRuN / 2];
  int wi = 0;

  // stage 1: h = snake2(conv7_dil(snake1(x)) + b1), 128 columns at a time
  for (int n1 = 0; n1 < n_col; ++n1) {
#pragma unroll
    for (int i = 0; i < kRuN / 2; ++i) acc[i] = 0.f;
    for (int k = 0; k < n_k; ++k) {
      const int q = n1 * n_k + k, xsl = q % p.x_slots;
      mbar_wait(&x_full[xsl], (q / p.x_slots) & 1);
      unsigned char* box = xs + xsl * x_slot;
      snake_box(box, p.box_rows, k * kRuKC, p.C, ab1, threadIdx.x);
      bar_sync(1, kConsumers * 128);  // the box snaked by both warpgroups
      for (int j = 0; j < kRuTaps; ++j) {
        const int s = wi % p.w_stages;
        mbar_wait(&w_full[s], (wi / p.w_stages) & 1);
        const uint32_t b_addr = smem_u32(ws + s * kRuWStage);
        // the lane's ldmatrix row: row (lane % 8) of matrix lane / 8
        const int r = row_w + j * p.dil + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(a[kk], smem_u32(box) + sw128_offset(r, 2 * kk + (lane >> 4)));
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_rs<kRuN>(acc, a[kk], kmajor_desc(b_addr + kk * 32));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
        mbar_arrive(&w_empty[s]);
        ++wi;
      }
      fence_proxy_async();  // the snake's writes before the box's next TMA load
      mbar_arrive(&x_empty[xsl]);
    }
    store_h_smem(acc, hs, b1, ab2, p.C, row_w + g, n1 * kRuN, tq);
  }
  fence_proxy_async();  // stage 2 reads h through wgmma descriptors
  bar_sync(2 + wg, 128);

  // stage 2: y = (h . W2 + b2) + x, 128 columns at a time
  const bf16* xb = x + (size_t)b * p.T * p.C;
  bf16* yb = y + (size_t)b * p.T * p.C;
  for (int n2 = 0; n2 < n_col; ++n2) {
    float out[1][kRuN / 2];
#pragma unroll
    for (int i = 0; i < kRuN / 2; ++i) out[0][i] = 0.f;
    for (int k = 0; k < n_k; ++k) {
      const int s = wi % p.w_stages;
      mbar_wait(&w_full[s], (wi / p.w_stages) & 1);
      const uint32_t a_addr = smem_u32(hs + k * kRuPanel) + wg * 64 * kSwizzleRow;
      const uint32_t b_addr = smem_u32(ws + s * kRuWStage);
      reg_fence(out[0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16<kRuN>(out[0], kmajor_desc(a_addr + kk * 32), kmajor_desc(b_addr + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(out[0]);
      mbar_arrive(&w_empty[s]);
      ++wi;
    }
    store_residual<bf16, kRuN, kRuN>(out, p.T, p.C, b2, xb, yb, r0 + row_w + g, n2 * kRuN, tq);
  }
}

// The split route's two mainloop launches: stage 1 on the conv kernel's
// mainloop, h into the scratch; stage 2 on the GEMMs' mainloop with the
// residual.
template <typename T, int N, int CH>
__global__ void __launch_bounds__(kThreads, 1)
ru_conv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ b1, const float* __restrict__ ab1, T* __restrict__ h,
               const float* __restrict__ ab2, const ConvPlan p) {
  conv_mainloop<T, N, CH, kEpiRuH>(&xmap, &wmap, b1, ab1, h, p, ab2);
}

template <typename T, int N, int CH>
__global__ void __launch_bounds__(kThreads, 1)
ru_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ b2, T* __restrict__ y, const T* __restrict__ x,
               const ConvPlan p) {
  gemm_mainloop<T, N, CH, kEpiResidual>(&xmap, &wmap, b2, y, p, x);
}

int launch_fused(const RuPlan& p, const void* x, const void* wk, const float* b1,
                 const float* ab1, const float* b2, const float* ab2, void* y, int B,
                 cudaStream_t stream) {
  using E = ConvElem<bf16>;
  const size_t smem = ru_smem(p);
  if (smem > (size_t)kRuMaxSmem || p.C % kRuN) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  cudaError_t err = sw128_map_3d(&xmap, E::kMap, 2, x, p.C, p.T, B, kRuKC, p.box_rows);
  if (err == cudaSuccess)
    err = sw128_map_3d(&wmap, E::kMap, 2, wk, p.C, p.C, kRuTaps + 1, kRuKC, kRuN);
  if (err == cudaSuccess) err = allow_smem(ru_fused_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ru_fused_kernel<<<dim3((p.T + kM - 1) / kM, B), kThreads, smem, stream>>>(
      xmap, wmap, b1, ab1, b2, ab2, static_cast<const bf16*>(x), static_cast<bf16*>(y), p);
  return (int)cudaGetLastError();
}

// The split route's snake pass: xs = snake1(x) rounded to T, the values the
// conv's A tiles take, 16 bytes a thread per step; C % 8 == 0.
template <typename T>
__global__ void ru_snake_kernel(const T* __restrict__ x, const float* __restrict__ ab,
                                T* __restrict__ xs, long long n16, int C) {
  constexpr int kPer = 16 / sizeof(T);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n16;
       i += (long long)gridDim.x * blockDim.x) {
    const int c0 = (int)(i * kPer % C);
    const uint4 v = reinterpret_cast<const uint4*>(x)[i];
    uint4 out;
    if constexpr (sizeof(T) == 2) {
      Pack8 a, b;
      a.u = v;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        b.h[e] = __float2bfloat16_rn(
            snake_poly(__bfloat162float(a.h[e]), ab[c0 + e], ab[C + c0 + e]));
      out = b.u;
    } else {
      const float f[4] = {__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                          __uint_as_float(v.w)};
      float g[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) g[e] = snake_poly(f[e], ab[c0 + e], ab[C + c0 + e]);
      out = make_uint4(__float_as_uint(g[0]), __float_as_uint(g[1]), __float_as_uint(g[2]),
                       __float_as_uint(g[3]));
    }
    reinterpret_cast<uint4*>(xs)[i] = out;
  }
}

// The split route's three launches: the snake pass into y (free until stage 2
// writes it), stage 1 on the conv kernel's mainloop over the snaked rows, h
// into the scratch; stage 2 on the GEMMs' mainloop with the residual x.
template <typename T, int N, int CH>
int launch_split(int T_, int C, int dil, int flush, const void* x, const void* wk,
                 const float* b1, const float* ab1, const float* b2, const float* ab2, void* h,
                 void* y, int B, cudaStream_t stream) {
  constexpr int kBT = ConvElem<T>::kBTiles;
  if (C % N || (long long)B * T_ >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const ConvPlan p1{T_, C, C, kRuTaps, dil, 3 * dil, 0, 0, flush};
  const void* a = x;
  const float* a_snake = ab1;
  if constexpr (kRuSplitPreSnake) {
    const long long n16 = (long long)B * T_ * C * (long long)sizeof(T) / 16;
    const long long blocks = (n16 + 255) / 256 < 132 * 16 ? (n16 + 255) / 256 : 132 * 16;
    ru_snake_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
        static_cast<const T*>(x), ab1, static_cast<T*>(y), n16, C);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    a = y;
    a_snake = nullptr;
  }
  int err = launch_taps<T, N>(ru_conv_kernel<T, N, CH>, p1, a, wk, kRuTaps * kBT, B, stream, b1,
                              a_snake, static_cast<T*>(h), ab2);
  if (err != 0) return err;
  // h and x as [1, B T, C]: the 1x1 conv is a GEMM over every row
  const ConvPlan p2{B * T_, C, C, 1, 1, 0, 0, 0, flush};
  const T* w2 = static_cast<const T*>(wk) + (size_t)kRuTaps * kBT * C * C;
  return launch_taps<T, N>(ru_gemm_kernel<T, N, CH>, p2, h, w2, kBT, 1, stream, b2,
                           static_cast<T*>(y), static_cast<const T*>(x));
}

}  // namespace

// K3: x [B, T, C], wk [8, C, C] (bf16) or [8, 2, C, C] (fp32 tf32 hi/lo) from
// fsat_conv_weights (slices 0-6 w1's taps, 7 w2), b1, b2 [C] fp32, ab1, ab2
// [2, C] fp32 -> y [B, T, C]; bf16 (f32 == 0) or fp32 with `flush` stages per
// tensor-core partial sum; C % 128 == 0, k = 7. h null: the fused route
// (bf16) with ru_plan's x_slots and w_stages; h a scratch [B, T, C] of the
// activation dtype: the split route.
extern "C" int fsat_fused_residual_unit(const void* x, const void* wk, const float* b1,
                                        const float* ab1, const float* b2, const float* ab2,
                                        void* h, void* y, int B, int T, int C, int dil,
                                        int x_slots, int w_stages, int f32, int flush,
                                        void* stream) {
  if (C % 128 || dil < 1 || flush < 1 || T < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (h != nullptr)
    return f32            ? launch_split<float, 128, 64>(T, C, dil, flush, x, wk, b1, ab1, b2,
                                                          ab2, h, y, B, st)
           : C % 256 == 0 ? launch_split<bf16, 256, 128>(T, C, dil, flush, x, wk, b1, ab1, b2,
                                                         ab2, h, y, B, st)
                          : launch_split<bf16, 128, 128>(T, C, dil, flush, x, wk, b1, ab1, b2,
                                                         ab2, h, y, B, st);
  const RuPlan p{T, C, dil, 3 * dil, (kM + 6 * dil + 7) / 8 * 8, x_slots, w_stages};
  if (f32 || p.box_rows > 256 || x_slots < 1 || w_stages < 1) return (int)cudaErrorInvalidValue;
  return launch_fused(p, x, wk, b1, ab1, b2, ab2, y, B, st);
}
