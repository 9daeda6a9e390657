// K3 in fp32: the fused Oobleck residual unit for fp32 callers, channels-last.
//
// K3 fused_residual_unit_f32 replaces conv1d.py:_ru_forward / _ru_kernel (:507, :473)
// (friendly_stable_audio_tools_tpu/ops/pallas/), whose kernel computes in the
// caller's dtype: for an fp32 model the snake stays fp32 and is not rounded,
// the products and their sums are fp32, the bias adds in fp32.
//
// What bounds it: the products (16 x C^2 operations per row, at C = 1024). They must stay fp32-accurate, so they run as 3xTF32 on the tensor
// cores (WMMA m16n16k8): each operand a is split into a_big = tf32(a) and
// a_small = tf32(a - a_big), and a.b is taken as a_big.b_small +
// a_small.b_big + a_big.b_big with fp32 accumulation. The dropped
// a_small.b_small term is ~2^-22 of the product, at fp32's own rounding;
// 1xTF32 would keep ~3 decimal digits. Up to 165 TFLOP/s on the H100 against
// the CUDA cores' 67. The tensor cores' fp32 accumulate does not round to
// nearest: carried over a whole reduction (7 x 1024 channels) its error grew
// with the length to ~1e-4 relative (measured on the H100). So each fragment
// takes at most six products from zero and is then added into the fp32 total
// on the CUDA cores, which round to nearest.
//
// Shared memory is the constraint in K3: the bf16 kernel holds a 64-row h
// tile for all C columns (133 KB at C = 1024), which in fp32 would be 266 KB,
// over a Hopper block's 227 KB. So the fp32 block owns 32 rows and steps the
// input channels 16 at a time: h 132 KB, the seven taps' weights 61 KB, the x
// tile 8 KB at dilation 9, 201 KB in all at C = 1024. (K4 in fp32 is the
// wgmma kernel of conv_wgmma.cu.)
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

typedef wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 8, float> FragC;

constexpr int kThreads = 256;  // 8 warps

// Splits a loaded fragment into its tf32 high part (in place) and the tf32
// rounding of the remainder. The split is per element, so it holds for any
// fragment layout.
template <typename Frag>
__device__ __forceinline__ void split_tf32(Frag& big, Frag& small) {
#pragma unroll
  for (int i = 0; i < big.num_elements; ++i) {
    const float v = big.x[i];
    const float hi = wmma::__float_to_tf32(v);
    big.x[i] = hi;
    small.x[i] = wmma::__float_to_tf32(v - hi);
  }
}

// total += part elementwise (fp32, round to nearest), both fragments of one layout.
__device__ __forceinline__ void add_part(FragC& total, const FragC& part) {
#pragma unroll
  for (int i = 0; i < total.num_elements; ++i) total.x[i] += part.x[i];
}

// acc += a . b in 3xTF32 (small terms first).
__device__ __forceinline__ void mma3(FragC& acc, const FragA& a, const FragA& a_s, const FragB& b,
                                     const FragB& b_s) {
  wmma::mma_sync(acc, a, b_s, acc);
  wmma::mma_sync(acc, a_s, b, acc);
  wmma::mma_sync(acc, a, b, acc);
}

// Loads rows [r0, r0 + nrows) x channels [c0, c0 + KC) of one batch row of
// x [T, C] fp32 into xs [nrows][LD], snaked in fp32 when ab != nullptr; rows
// outside [0, T) are zero (snake(0) == 0, so padding after the snake is exact).
template <int KC, int LD>
__device__ __forceinline__ void load_x_f32(const float* __restrict__ xb, int T, int C, int r0,
                                           int nrows, int c0, const float* __restrict__ ab,
                                           float* __restrict__ xs) {
  constexpr int kVec = KC / 4;
  for (int i = threadIdx.x; i < nrows * kVec; i += kThreads) {
    const int r = i / kVec, c = c0 + (i % kVec) * 4, t = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) {
      v = *reinterpret_cast<const float4*>(xb + (size_t)t * C + c);
      if (ab != nullptr) {
        v.x = snake_poly(v.x, ab[c], ab[C + c]);
        v.y = snake_poly(v.y, ab[c + 1], ab[C + c + 1]);
        v.z = snake_poly(v.z, ab[c + 2], ab[C + c + 2]);
        v.w = snake_poly(v.w, ab[c + 3], ab[C + c + 3]);
      }
    }
    *reinterpret_cast<float4*>(xs + r * LD + (i % kVec) * 4) = v;
  }
}

// Loads w[k0:k0+KR, n0:n0+NC] of a row-major [*, ncols] fp32 matrix into ws [KR][LD].
template <int KR, int NC, int LD>
__device__ __forceinline__ void load_w_f32(const float* __restrict__ w, int ncols, int k0, int n0,
                                           float* __restrict__ ws) {
  constexpr int kVec = NC / 4;
  for (int i = threadIdx.x; i < KR * kVec; i += kThreads) {
    const int r = i / kVec, seg = i % kVec;
    *reinterpret_cast<float4*>(ws + r * LD + seg * 4) =
        *reinterpret_cast<const float4*>(w + (size_t)(k0 + r) * ncols + n0 + seg * 4);
  }
}

// ---------------------------------------------------------------------------
// K3 fp32: y = x + conv1x1(snake2(conv7_dil(snake1(x)) + b1)) + b2, C -> C.
// One block per (32-row tile, batch); warps 2 (16 rows) x 4 (32 columns) over
// a 32 x 128 chunk. Stage 1 builds h [32, C] in shared memory 128 columns at
// a time; stage 2 multiplies h by w2 and adds the residual.
// WMMA needs 32-byte aligned fragment pointers: every row stride below is a
// multiple of 8 floats.
// ---------------------------------------------------------------------------

constexpr int kRuRows = 32;
constexpr int kRuNC = 128;
constexpr int kRuKC = 16;
constexpr int kRuXld = 24;   // x tile row stride (floats)
constexpr int kRuWld = 136;  // weight tile row stride
constexpr int kRuSld = 136;  // epilogue scratch row stride
constexpr int kTaps = 7;

__host__ __device__ inline size_t round_up128(size_t n) { return (n + 127) / 128 * 128; }

size_t ru_f32_smem_bytes(int C, int dil) {
  const size_t hs = (size_t)kRuRows * (C + 8) * sizeof(float);
  const size_t xs = round_up128((size_t)(kRuRows + (kTaps - 1) * dil) * kRuXld * sizeof(float));
  const size_t ws = (size_t)kTaps * kRuKC * kRuWld * sizeof(float);  // also the fp32 scratch
  return hs + xs + ws;
}

__global__ void __launch_bounds__(kThreads)
fused_residual_unit_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                               const float* __restrict__ b1, const float* __restrict__ ab1,
                               const float* __restrict__ w2, const float* __restrict__ b2,
                               const float* __restrict__ ab2, float* __restrict__ y, int T, int C,
                               int dil) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hld = C + 8;
  const int pad = (kTaps - 1) * dil / 2;
  const int xrows = kRuRows + (kTaps - 1) * dil;
  float* hs = reinterpret_cast<float*>(smem);  // [kRuRows][hld]
  size_t off = (size_t)kRuRows * hld * sizeof(float);
  float* xs = reinterpret_cast<float*>(smem + off);  // [xrows][kRuXld]
  off += round_up128((size_t)xrows * kRuXld * sizeof(float));
  float* ws = reinterpret_cast<float*>(smem + off);  // [kTaps][kRuKC][kRuWld]
  float* sc = ws;                                    // [kRuRows][kRuSld], aliases ws

  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int t0 = blockIdx.x * kRuRows, b = blockIdx.y;
  const float* xb = x + (size_t)b * T * C;
  FragC acc[2];

  // stage 1
  for (int n0 = 0; n0 < C; n0 += kRuNC) {
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int k0 = 0; k0 < C; k0 += kRuKC) {
      __syncthreads();
      load_x_f32<kRuKC, kRuXld>(xb, T, C, t0 - pad, xrows, k0, ab1, xs);
      for (int j = 0; j < kTaps; ++j)
        load_w_f32<kRuKC, kRuNC, kRuWld>(w1 + (size_t)j * C * C, C, k0, n0, ws + j * kRuKC * kRuWld);
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < kTaps; ++j) {
        FragC part[2];
        wmma::fill_fragment(part[0], 0.f);
        wmma::fill_fragment(part[1], 0.f);
#pragma unroll
        for (int kk = 0; kk < kRuKC; kk += 8) {
          FragA a, a_s;
          wmma::load_matrix_sync(a, xs + (wm * 16 + j * dil) * kRuXld + kk, kRuXld);
          split_tf32(a, a_s);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            FragB bb, bb_s;
            wmma::load_matrix_sync(bb, ws + (j * kRuKC + kk) * kRuWld + wn * 32 + ni * 16, kRuWld);
            split_tf32(bb, bb_s);
            mma3(part[ni], a, a_s, bb, bb_s);
          }
        }
        add_part(acc[0], part[0]);
        add_part(acc[1], part[1]);
      }
    }
    __syncthreads();  // every warp is done with ws before sc overwrites it
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
      wmma::store_matrix_sync(sc + wm * 16 * kRuSld + wn * 32 + ni * 16, acc[ni], kRuSld,
                              wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < kRuRows * kRuNC; i += kThreads) {
      const int r = i / kRuNC, n = n0 + i % kRuNC;
      hs[r * hld + n] = snake_poly(sc[r * kRuSld + i % kRuNC] + b1[n], ab2[n], ab2[C + n]);
    }
  }

  // stage 2
  for (int n0 = 0; n0 < C; n0 += kRuNC) {
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int k0 = 0; k0 < C; k0 += kRuKC) {
      __syncthreads();
      load_w_f32<kRuKC, kRuNC, kRuWld>(w2, C, k0, n0, ws);
      __syncthreads();
      FragC part[2];
      wmma::fill_fragment(part[0], 0.f);
      wmma::fill_fragment(part[1], 0.f);
#pragma unroll
      for (int kk = 0; kk < kRuKC; kk += 8) {
        FragA a, a_s;
        wmma::load_matrix_sync(a, hs + wm * 16 * hld + k0 + kk, hld);
        split_tf32(a, a_s);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          FragB bb, bb_s;
          wmma::load_matrix_sync(bb, ws + kk * kRuWld + wn * 32 + ni * 16, kRuWld);
          split_tf32(bb, bb_s);
          mma3(part[ni], a, a_s, bb, bb_s);
        }
      }
      add_part(acc[0], part[0]);
      add_part(acc[1], part[1]);
    }
    __syncthreads();
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
      wmma::store_matrix_sync(sc + wm * 16 * kRuSld + wn * 32 + ni * 16, acc[ni], kRuSld,
                              wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < kRuRows * kRuNC; i += kThreads) {
      const int r = i / kRuNC, t = t0 + r, n = n0 + i % kRuNC;
      if (t < T) {
        const size_t idx = ((size_t)b * T + t) * C + n;
        y[idx] = sc[r * kRuSld + i % kRuNC] + b2[n] + x[idx];
      }
    }
  }
}

}  // namespace

// K3 fp32: x, y [B, T, C] fp32; w1 [7, C, C], w2 [C, C] fp32; b1, b2 [C];
// ab1, ab2 [2, C] (alpha, inv_beta). C % 128 == 0.
extern "C" int fsat_fused_residual_unit_f32(const float* x, const float* w1, const float* b1,
                                            const float* ab1, const float* w2, const float* b2,
                                            const float* ab2, float* y, int B, int T, int C,
                                            int dil, void* stream) {
  const size_t smem = ru_f32_smem_bytes(C, dil);
  cudaError_t err = allow_smem(fused_residual_unit_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kRuRows - 1) / kRuRows, B);
  fused_residual_unit_f32_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w1, b1, ab1, w2, b2, ab2, y, T, C, dil);
  return (int)cudaGetLastError();
}
