// Shared device helpers of the Hopper kernels (sm_90a).
//
// Every kernel here takes bf16 activations and weights, accumulates in fp32
// and returns bf16, like the Pallas kernels it replaces
// (friendly_stable_audio_tools_tpu/ops/pallas/). Each C entry point returns
// cudaGetLastError() after its launch; the Python wrapper raises if it is not 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// snake(x) = x + inv_beta * sin^2(alpha * x), with sin^2 evaluated by range
// reduction and a degree-5 polynomial in s^2 (s = frac-centred alpha*x/pi):
// the same coefficients and operation order as `_snake` in
// friendly_stable_audio_tools_tpu/ops/pallas/conv1d.py:49 and the plain
// version `snake` in ops/kernels/conv1d.py. Max abs error of sin^2 2.3e-7.
__device__ __forceinline__ float snake_poly(float x, float alpha, float inv_beta) {
  const float v = x * (alpha * 0.3183098861837907f);
  const float s = v - rintf(v);  // round half to even, as jnp.round / torch.round
  const float w = s * s;
  float p = -3.2946440864775366f;
  p = p * w + 13.005597445194748f;
  p = p * w + -30.089709323462305f;
  p = p * w + 42.72581061829601f;
  p = p * w + -32.469601846083854f;
  p = p * w + 9.869603239633658f;
  return x + inv_beta * (w * p);
}

// Rounds to bf16 and back: the cast to the model dtype that the TPU kernels
// apply before every matrix product.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Eight bf16 values moved as one 16-byte word.
union Pack8 {
  uint4 u;
  bf16 h[8];
};

// Sets the block's dynamic shared memory limit when it exceeds the default 48 KB.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
