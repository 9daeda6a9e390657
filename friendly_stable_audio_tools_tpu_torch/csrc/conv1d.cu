// K2's thin route and K3: fused snake -> conv kernels, channels-last.
//
// K2 snake_conv1d, thin route replaces conv1d.py:_forward / _kernel (:91, :60)
// K3 fused_residual_unit      replaces conv1d.py:_ru_forward / _ru_kernel (:507, :473)
// (both in friendly_stable_audio_tools_tpu/ops/pallas/).
//
// Common rules, as in the TPU kernels: the snake runs in fp32 with the
// polynomial sin^2 (common.cuh), its result is rounded to bf16 before the
// products, products accumulate in fp32, bias adds in fp32, and the result is
// rounded to bf16 once. K3 runs its products on the tensor cores (WMMA bf16
// 16x16x16, fp32 accumulate); K2's thin route (ops/kernels/conv1d.py:
// conv_route) serves the convolutions a tensor-core tile would mostly pad,
// Cout 2 (the decoders' conv_out) and Cin 1 or 2 (the encoders' conv_in),
// on the CUDA cores; its other shapes take the wgmma kernel of
// conv_wgmma.cu, as K4 does. K2 also runs in fp32 (templated on the element
// type); K3 in fp32 is in conv1d_f32.cu.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// K3's tile geometry: 256 threads = 8 warps laid out 2 (rows)
// x 4 (columns), each warp owning a 32 x 32 block of a 64 x 128 output tile.
constexpr int kThreads = 256;
constexpr int kRows = 64;   // output rows per block
constexpr int kNC = 128;    // output columns per chunk
constexpr int kKC = 32;     // input channels per step
constexpr int kXld = 48;    // x tile row stride: 96 bytes, so a fragment may start on any row
constexpr int kWld = 136;   // weight tile row stride
constexpr int kSld = 132;   // fp32 epilogue scratch row stride

__host__ __device__ inline size_t round_up(size_t n, size_t m) { return (n + m - 1) / m * m; }

// Loads rows [r0, r0 + nrows) x channels [c0, c0 + 32) of one batch row of
// x [T, C] into xs [nrows][kXld]: snake (when ab != nullptr), rounded to bf16;
// rows outside [0, T) are zero (snake(0) == 0, so padding after the snake is exact).
__device__ __forceinline__ void load_x_tile(const bf16* __restrict__ xb, int T, int C, int r0,
                                            int nrows, int c0, const float* __restrict__ ab,
                                            bf16* __restrict__ xs) {
  for (int i = threadIdx.x; i < nrows * (kKC / 8); i += kThreads) {
    const int r = i >> 2, seg = i & 3, t = r0 + r, c = c0 + seg * 8;
    Pack8 pk;
    pk.u = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < T) {
      pk.u = *reinterpret_cast<const uint4*>(xb + (size_t)t * C + c);
      if (ab != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          pk.h[j] = __float2bfloat16_rn(
              snake_poly(__bfloat162float(pk.h[j]), ab[c + j], ab[C + c + j]));
      }
    }
    *reinterpret_cast<uint4*>(xs + r * kXld + seg * 8) = pk.u;
  }
}

// Loads w[k0:k0+32, n0:n0+128] of a row-major [*, ncols] bf16 matrix into ws
// [32][kWld]; columns at or past ncols (ncols % 8 == 0) are zero.
__device__ __forceinline__ void load_w_tile(const bf16* __restrict__ w, int ncols, int k0, int n0,
                                            bf16* __restrict__ ws) {
  for (int i = threadIdx.x; i < kKC * (kNC / 8); i += kThreads) {
    const int r = i >> 4, seg = i & 15;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + seg * 8 < ncols)
      val = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * ncols + n0 + seg * 8);
    *reinterpret_cast<uint4*>(ws + r * kWld + seg * 8) = val;
  }
}

__device__ __forceinline__ void store_acc(float* sc, FragC (&acc)[2][2], int wm, int wn) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
      wmma::store_matrix_sync(sc + (wm * 32 + mi * 16) * kSld + wn * 32 + ni * 16, acc[mi][ni],
                              kSld, wmma::mem_row_major);
}

__device__ __forceinline__ void zero_acc(FragC (&acc)[2][2]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) wmma::fill_fragment(acc[mi][ni], 0.f);
}

// ---------------------------------------------------------------------------
// K2: y = conv_k,dil(snake(x)) + bias, stride 1, left padding `pad`.
// One block per (row tile, Cout tile of TC, batch); each thread keeps 16 rows
// of one output column in registers. T is the element type of x, w and y:
// bf16 rounds the snake to bf16 before the products, as the bf16 TPU kernel
// does; fp32 keeps every value in fp32 (the TPU kernel's fp32 callers).
// Each thread reads four input channels of a row as one 16-byte vector, so
// a shared load feeds four FMAs.
// ---------------------------------------------------------------------------

constexpr int kK2Acc = 16;
constexpr int kK2CK = 16;  // input channels per step

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store_as(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
// the cast to the model dtype before the products
__device__ __forceinline__ float round_as(float v, const bf16*) { return round_bf16(v); }
__device__ __forceinline__ float round_as(float v, const float*) { return v; }

template <int TC, typename T>
__global__ void __launch_bounds__(kThreads)
snake_conv1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ ab,
                    T* __restrict__ y, int Tn, int Cin, int Cout, int K, int dil, int pad) {
  constexpr int RG = kThreads / TC;  // row groups
  constexpr int TT = RG * kK2Acc;    // rows per block
  extern __shared__ __align__(16) float smf[];
  const int rows = TT + (K - 1) * dil;
  float* xs = smf;                 // [rows][kK2CK]
  float* ws = smf + rows * kK2CK;  // [K][kK2CK][TC]
  const int t0 = blockIdx.x * TT, c0 = blockIdx.y * TC, b = blockIdx.z;
  const int col = threadIdx.x % TC, rg = threadIdx.x / TC;
  const T* xb = x + (size_t)b * Tn * Cin;

  float acc[kK2Acc];
#pragma unroll
  for (int a = 0; a < kK2Acc; ++a) acc[a] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kK2CK) {
    for (int i = threadIdx.x; i < rows * kK2CK; i += kThreads) {
      const int r = i / kK2CK, c = i % kK2CK, t = t0 - pad + r, ci = ci0 + c;
      float v = 0.f;
      if (t >= 0 && t < Tn && ci < Cin) {
        v = to_float(xb[(size_t)t * Cin + ci]);
        if (ab != nullptr) v = round_as(snake_poly(v, ab[ci], ab[Cin + ci]), x);
      }
      xs[i] = v;
    }
    for (int i = threadIdx.x; i < K * kK2CK * TC; i += kThreads) {
      const int j = i / (kK2CK * TC), rem = i % (kK2CK * TC), c = rem / TC, o = rem % TC;
      const int ci = ci0 + c, co = c0 + o;
      ws[i] = (ci < Cin && co < Cout) ? to_float(w[((size_t)j * Cin + ci) * Cout + co]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < K; ++j) {
      const float* xr = xs + (rg + j * dil) * kK2CK;
      const float* wr = ws + j * kK2CK * TC + col;
#pragma unroll
      for (int c = 0; c < kK2CK; c += 4) {
        const float w0 = wr[c * TC], w1 = wr[(c + 1) * TC], w2 = wr[(c + 2) * TC],
                    w3 = wr[(c + 3) * TC];
#pragma unroll
        for (int a = 0; a < kK2Acc; ++a) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + a * RG * kK2CK + c);
          acc[a] = fmaf(xv.x, w0, acc[a]);
          acc[a] = fmaf(xv.y, w1, acc[a]);
          acc[a] = fmaf(xv.z, w2, acc[a]);
          acc[a] = fmaf(xv.w, w3, acc[a]);
        }
      }
    }
    __syncthreads();
  }
  const int co = c0 + col;
  if (co < Cout) {
    const float bv = bias[co];
#pragma unroll
    for (int a = 0; a < kK2Acc; ++a) {
      const int t = t0 + rg + a * RG;
      if (t < Tn) store_as(y + ((size_t)b * Tn + t) * Cout + co, acc[a] + bv);
    }
  }
}

template <int TC, typename T>
int launch_snake_conv1d(const void* x, const void* w, const float* bias, const float* ab, void* y,
                        int B, int Tn, int Cin, int Cout, int K, int dil, int pad,
                        cudaStream_t stream) {
  constexpr int TT = (kThreads / TC) * kK2Acc;
  const size_t smem =
      ((size_t)(TT + (K - 1) * dil) * kK2CK + (size_t)K * kK2CK * TC) * sizeof(float);
  cudaError_t err = allow_smem(snake_conv1d_kernel<TC, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tn + TT - 1) / TT, (Cout + TC - 1) / TC, B);
  snake_conv1d_kernel<TC, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, ab, static_cast<T*>(y), Tn, Cin,
      Cout, K, dil, pad);
  return (int)cudaGetLastError();
}

template <typename T>
int snake_conv1d_entry(const void* x, const void* w, const float* bias, const float* ab, void* y,
                       int B, int Tn, int Cin, int Cout, int K, int dil, int pad, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Cout <= 16) return launch_snake_conv1d<16, T>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, st);
  return launch_snake_conv1d<64, T>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, st);
}

// ---------------------------------------------------------------------------
// K3: y = x + conv1x1(snake2(conv7_dil(snake1(x)) + b1)) + b2, C -> C.
// One block per (64-row tile, batch). Stage 1 builds h [64, C] in shared
// memory 128 columns at a time (x tile with its 6*dil halo loaded once per
// 32-channel step, all 7 taps' weights beside it); stage 2 multiplies h by
// w2 from shared memory and adds the residual. h never reaches device memory.
// ---------------------------------------------------------------------------

constexpr int kTaps = 7;

size_t ru_smem_bytes(int C, int dil) {
  const size_t hs = (size_t)kRows * (C + 16) * sizeof(bf16);
  const size_t xs = round_up((size_t)(kRows + (kTaps - 1) * dil) * kXld * sizeof(bf16), 128);
  const size_t ws = (size_t)kTaps * kKC * kWld * sizeof(bf16);  // also holds the fp32 scratch
  return hs + xs + ws;
}

__global__ void __launch_bounds__(kThreads)
fused_residual_unit_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                           const float* __restrict__ b1, const float* __restrict__ ab1,
                           const bf16* __restrict__ w2, const float* __restrict__ b2,
                           const float* __restrict__ ab2, bf16* __restrict__ y, int T, int C,
                           int dil) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hld = C + 16;
  const int pad = (kTaps - 1) * dil / 2;
  const int xrows = kRows + (kTaps - 1) * dil;
  bf16* hs = reinterpret_cast<bf16*>(smem);  // [kRows][hld]
  size_t off = (size_t)kRows * hld * sizeof(bf16);
  bf16* xs = reinterpret_cast<bf16*>(smem + off);  // [xrows][kXld]
  off += round_up((size_t)xrows * kXld * sizeof(bf16), 128);
  bf16* ws = reinterpret_cast<bf16*>(smem + off);   // [kTaps][kKC][kWld]
  float* sc = reinterpret_cast<float*>(smem + off);  // [kRows][kSld], aliases ws

  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int t0 = blockIdx.x * kRows, b = blockIdx.y;
  const bf16* xb = x + (size_t)b * T * C;
  FragC acc[2][2];

  // stage 1
  for (int n0 = 0; n0 < C; n0 += kNC) {
    zero_acc(acc);
    for (int k0 = 0; k0 < C; k0 += kKC) {
      __syncthreads();
      load_x_tile(xb, T, C, t0 - pad, xrows, k0, ab1, xs);
      for (int j = 0; j < kTaps; ++j) load_w_tile(w1 + (size_t)j * C * C, C, k0, n0, ws + j * kKC * kWld);
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < kTaps; ++j) {
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
          FragA a[2];
          FragB bb[2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            wmma::load_matrix_sync(a[mi], xs + (wm * 32 + mi * 16 + j * dil) * kXld + kk, kXld);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            wmma::load_matrix_sync(bb[ni], ws + (j * kKC + kk) * kWld + wn * 32 + ni * 16, kWld);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni) wmma::mma_sync(acc[mi][ni], a[mi], bb[ni], acc[mi][ni]);
        }
      }
    }
    __syncthreads();  // every warp is done with ws before sc overwrites it
    store_acc(sc, acc, wm, wn);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kNC; i += kThreads) {
      const int r = i / kNC, n = n0 + i % kNC;
      const float hv = sc[r * kSld + i % kNC] + b1[n];
      hs[r * hld + n] = __float2bfloat16_rn(snake_poly(hv, ab2[n], ab2[C + n]));
    }
  }

  // stage 2
  for (int n0 = 0; n0 < C; n0 += kNC) {
    zero_acc(acc);
    for (int k0 = 0; k0 < C; k0 += kKC) {
      __syncthreads();
      load_w_tile(w2, C, k0, n0, ws);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        FragA a[2];
        FragB bb[2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          wmma::load_matrix_sync(a[mi], hs + (wm * 32 + mi * 16) * hld + k0 + kk, hld);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          wmma::load_matrix_sync(bb[ni], ws + kk * kWld + wn * 32 + ni * 16, kWld);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) wmma::mma_sync(acc[mi][ni], a[mi], bb[ni], acc[mi][ni]);
      }
    }
    __syncthreads();
    store_acc(sc, acc, wm, wn);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kNC; i += kThreads) {
      const int r = i / kNC, t = t0 + r, n = n0 + i % kNC;
      if (t < T) {
        const size_t idx = ((size_t)b * T + t) * C + n;
        y[idx] = __float2bfloat16_rn(sc[r * kSld + i % kNC] + b2[n] + __bfloat162float(x[idx]));
      }
    }
  }
}

}  // namespace

extern "C" int fsat_snake_conv1d(const void* x, const void* w, const float* bias, const float* ab,
                                 void* y, int B, int T, int Cin, int Cout, int K, int dil, int pad,
                                 void* stream) {
  return snake_conv1d_entry<bf16>(x, w, bias, ab, y, B, T, Cin, Cout, K, dil, pad, stream);
}

// K2 on fp32 x, w and y.
extern "C" int fsat_snake_conv1d_f32(const void* x, const void* w, const float* bias,
                                     const float* ab, void* y, int B, int T, int Cin, int Cout,
                                     int K, int dil, int pad, void* stream) {
  return snake_conv1d_entry<float>(x, w, bias, ab, y, B, T, Cin, Cout, K, dil, pad, stream);
}

extern "C" int fsat_fused_residual_unit(const void* x, const void* w1, const float* b1,
                                        const float* ab1, const void* w2, const float* b2,
                                        const float* ab2, void* y, int B, int T, int C, int dil,
                                        void* stream) {
  const size_t smem = ru_smem_bytes(C, dil);
  cudaError_t err = allow_smem(fused_residual_unit_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kRows - 1) / kRows, B);
  fused_residual_unit_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1, ab1,
      static_cast<const bf16*>(w2), b2, ab2, static_cast<bf16*>(y), T, C, dil);
  return (int)cudaGetLastError();
}
