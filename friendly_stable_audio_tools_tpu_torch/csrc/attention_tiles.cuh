// Tile helpers shared by the attention kernels (attention.cu: K1/K5,
// attention_bwd.cu: K6). Tiles are 64 rows x 64 head dims of bf16 in shared
// memory with a padded row stride, read from the fused qkv tensor (or a
// [B, T, H*64] tensor) in place with the tensor's row stride.
#pragma once

#include "common.cuh"

namespace fsat_attn {

constexpr int kD = 64;     // head dim
constexpr int kTile = 64;  // rows per tile (q rows or keys)
constexpr int kWarps = 4;  // 16 tile rows each
constexpr int kThreads = kWarps * 32;
constexpr int kLd = 72;    // bf16 tile row stride: keeps 16-row fragments 32-byte aligned
constexpr int kSld = 68;   // fp32 scratch row stride
constexpr float kLog2e = 1.4426950408889634f;

// Copies rows [r0, r0 + 64) of the 64-wide column block starting at `col`
// into dst [64][kLd]; rows at or beyond `limit` are zero.
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ base, size_t row_stride,
                                           int col, int r0, int limit, bf16* dst) {
  for (int i = threadIdx.x; i < kTile * 8; i += kThreads) {
    const int r = i >> 3, seg = i & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      v = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) * row_stride + col + seg * 8);
    *reinterpret_cast<uint4*>(dst + r * kLd + seg * 8) = v;
  }
}

// dst = bf16(x*C + rotate_half(x)*S) in fp32, C/S = scale * cos/sin over the
// first `rot` dims and (scale, 0) beyond them (the tables of
// flash_attention.py:_rope_tables, rotate-half sign convention :730-734).
__device__ __forceinline__ void rope_tile(const bf16* __restrict__ src, bf16* __restrict__ dst,
                                          const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t, int r0, int T,
                                          int rot, float scale) {
  const int half = rot >> 1;
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i >> 6, d = i & (kD - 1), t = r0 + r;
    const float x = __bfloat162float(src[r * kLd + d]);
    float y;
    if (t < T && d < rot) {
      const float c = cos_t[(size_t)t * rot + d] * scale;
      const float s = sin_t[(size_t)t * rot + d] * scale;
      const float partner = d < half ? -__bfloat162float(src[r * kLd + d + half])
                                     : __bfloat162float(src[r * kLd + d - half]);
      y = x * c + partner * s;
    } else {
      y = x * scale;
    }
    dst[r * kLd + d] = __float2bfloat16_rn(y);
  }
}

// Transpose (vjp) of the rope above at position t, scale 1, for dim d of an
// fp32 row dy: dx = dy*C + (dy*S) P^T, i.e. dy[d]*cos[d] + dy[d+h]*sin[d+h]
// for d < h = rot/2, dy[d]*cos[d] - dy[d-h]*sin[d-h] for h <= d < rot, and
// dy[d] beyond rot (flash_attention.py:1084-1099).
__device__ __forceinline__ float unrope_at(const float* __restrict__ dy, int d,
                                           const float* __restrict__ cos_t,
                                           const float* __restrict__ sin_t, int t, int rot) {
  if (d >= rot) return dy[d];
  const int half = rot >> 1;
  const float* c = cos_t + (size_t)t * rot;
  const float* s = sin_t + (size_t)t * rot;
  const float partner = d < half ? dy[d + half] * s[d + half] : -dy[d - half] * s[d - half];
  return dy[d] * c[d] + partner;
}

}  // namespace fsat_attn
