// K11 and K12: the adaLN DiT block's two fused elementwise sites.
//
// K11, ln_modulate, replaces friendly_stable_audio_tools_tpu/ops/pallas/
// elementwise.py:_lnmod_forward (:98; `_lnmod_kernel` :88, pallas_call :102):
//   y = round(LayerNorm(x) * gamma), out = round(round(y * round(1 + scale)) + shift)
// with the mean and the centred variance of each row in fp32, eps 1e-5 and
// rsqrt, gamma applied in fp32, and the modulate in bf16 arithmetic: each of
// 1 + scale, the product and the sum rounds to bf16, as the Pallas kernel's
// bf16 operations do. A product of two bf16 values is exact in fp32, so
// rounding it once gives the bf16 product.
//
// K12, gated_residual, replaces elementwise.py:_gres_forward (:167;
// `_gres_kernel` :161, pallas_call :171):
//   out = round(round(y * sigmoid(1 - gate)) + residual)
// with the sigmoid and the product in fp32.
//
// x, y, residual and out are bf16 [B, T, D], contiguous; scale, shift and
// gate are bf16 [B, 1, D] rows with a batch stride of their own (the
// DiT's six adaLN vectors are chunks of one [B, 1, 6D] projection, read in
// place); gamma is fp32, bf16 or absent (the fix_scale LayerNorm: ones).
// The wrapper (ops/kernels/elementwise.py) guarantees D % 128 == 0 and
// D <= 4096, the JAX package's gate, and 16-byte aligned rows.
//
// What bounds them on the H100: one read and one write of each [B, T, D]
// tensor and nothing else (the vectors are 6 KB a batch row, from L2):
// at the adaLN DiT's [2, 1024, 1536] bf16, K11 moves 12.6 MB (3.76 us at
// 3.35 TB/s) and K12 18.9 MB (5.63 us). The TPU kernels keep a block of
// up to 1024 rows in VMEM; here K11 gives each row a block of D / 8 threads
// (192 at D 1536), each holding 8 values from one 16-byte load in
// registers through both reductions (warp shuffles, then the warps'
// partial sums added in order through shared memory), so x is read once;
// K12 is a grid-stride pass of 16-byte loads. At the DiT's shapes each
// call lasts microseconds, so the launch itself is a large part of it.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 4096 / 8 / 32;  // D <= 4096: at most 16 warps a row
constexpr int kGresThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of v over the block, the same in every thread: each warp reduces
// by shuffles, then every thread adds the warps' sums in warp order.
__device__ __forceinline__ float block_sum(float v, float* partial) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) total += partial[w];
  __syncthreads();  // partial is written again by the next reduction
  return total;
}

__device__ __forceinline__ void load8(const bf16* p, float (&out)[8]) {
  Pack8 pk;
  pk.u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(pk.h[e]);
}

__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// gamma_kind: 0 none (ones), 1 fp32, 2 bf16.
__global__ void ln_modulate_kernel(const bf16* __restrict__ x, const void* __restrict__ gamma,
                                   int gamma_kind, const bf16* __restrict__ scale,
                                   const bf16* __restrict__ shift, int scale_stride,
                                   int shift_stride, bf16* __restrict__ out, int T, int D) {
  __shared__ float partial[kMaxWarps];
  const long long row = blockIdx.x;
  const int b = (int)(row / T);
  const int c = threadIdx.x * 8;  // this thread's 8 columns
  const bool active = c < D;
  float v[8];
  float sum = 0.f;
  if (active) {
    load8(x + row * D + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e];
  }
  const float mean = block_sum(sum, partial) / D;
  float sq = 0.f;
  if (active) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] -= mean;
      sq += v[e] * v[e];
    }
  }
  const float rstd = rsqrtf(block_sum(sq, partial) / D + 1e-5f);
  if (!active) return;
  float g[8], s[8], h[8];
  if (gamma_kind == 1) {
    load8(static_cast<const float*>(gamma) + c, g);
  } else if (gamma_kind == 2) {
    load8(static_cast<const bf16*>(gamma) + c, g);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) g[e] = 1.f;
  }
  load8(scale + (long long)b * scale_stride + c, s);
  load8(shift + (long long)b * shift_stride + c, h);
  Pack8 o;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float y = round_bf16(v[e] * rstd * g[e]);
    const float m = round_bf16(y * round_bf16(1.f + s[e]));
    o.h[e] = __float2bfloat16_rn(m + h[e]);
  }
  *reinterpret_cast<uint4*>(out + row * D + c) = o.u;
}

__global__ void __launch_bounds__(kGresThreads)
gated_residual_kernel(const bf16* __restrict__ y, const bf16* __restrict__ gate, int gate_stride,
                      const bf16* __restrict__ residual, bf16* __restrict__ out,
                      long long n_vec, int vec_per_row, int T) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / vec_per_row;
    const int c = (int)(i - row * vec_per_row) * 8;
    const int b = (int)(row / T);
    float fy[8], fg[8], fr[8];
    load8(y + i * 8, fy);
    load8(gate + (long long)b * gate_stride + c, fg);
    load8(residual + i * 8, fr);
    Pack8 o;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float sig = 1.f / (1.f + expf(-(1.f - fg[e])));
      o.h[e] = __float2bfloat16_rn(round_bf16(fy[e] * sig) + fr[e]);
    }
    reinterpret_cast<uint4*>(out)[i] = o.u;
  }
}

bool shape_ok(int rows, int T, int D) {
  return rows > 0 && T > 0 && rows % T == 0 && D > 0 && D % 128 == 0 && D <= 4096;
}

}  // namespace

// K11 on bf16 x [rows = B * T, D] and bf16 scale/shift rows (batch strides
// in elements); gamma fp32 (gamma_kind 1), bf16 (2) or null (0).
extern "C" int fsat_ln_modulate(const void* x, const void* gamma, int gamma_kind,
                                const void* scale, const void* shift, int scale_stride,
                                int shift_stride, void* out, int rows, int T, int D,
                                void* stream) {
  if (!shape_ok(rows, T, D) || gamma_kind < 0 || gamma_kind > 2 ||
      (gamma_kind != 0 && gamma == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = (D / 8 + 31) / 32 * 32;
  ln_modulate_kernel<<<rows, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), gamma, gamma_kind, static_cast<const bf16*>(scale),
      static_cast<const bf16*>(shift), scale_stride, shift_stride, static_cast<bf16*>(out), T, D);
  return (int)cudaGetLastError();
}

// K12 on bf16 y and residual [rows = B * T, D] and a bf16 gate row per batch
// element (batch stride in elements).
extern "C" int fsat_gated_residual(const void* y, const void* gate, int gate_stride,
                                   const void* residual, void* out, int rows, int T, int D,
                                   void* stream) {
  if (!shape_ok(rows, T, D)) return (int)cudaErrorInvalidValue;
  const long long n_vec = (long long)rows * D / 8;
  const long long want = (n_vec + kGresThreads - 1) / kGresThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  gated_residual_kernel<<<blocks, kGresThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(gate), gate_stride,
      static_cast<const bf16*>(residual), static_cast<bf16*>(out), n_vec, D / 8, T);
  return (int)cudaGetLastError();
}
