// K2's thin route: the fused snake -> conv kernel on the CUDA cores,
// channels-last, bf16 or fp32.
//
// K2 snake_conv1d, thin route replaces conv1d.py:_forward / _kernel (:91, :60)
// (friendly_stable_audio_tools_tpu/ops/pallas/).
//
// Common rules, as in the TPU kernel: the snake runs in fp32 with the
// polynomial sin^2 (common.cuh), its result is rounded to bf16 before the
// products in bf16 (fp32 rounds nothing), products accumulate in fp32, bias
// adds in fp32, and the result is rounded once. The thin route
// (ops/kernels/conv1d.py:conv_route) serves the convolutions a tensor-core
// tile would mostly pad, Cout 2 (the decoders' conv_out) and Cin 1 or 2 (the
// encoders' conv_in); K2's other shapes and K4 take the wgmma kernel of
// conv_wgmma.cu, K3 the kernels of residual_unit.cu.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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
