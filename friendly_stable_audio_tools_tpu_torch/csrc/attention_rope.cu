// K10a: q or k of the fused qkv tensor roped once per call. Replaces
// `_rope_pair_k_kernel` (friendly_stable_audio_tools_tpu/ops/pallas/
// flash_attention.py:1229, calls :1139 and :1281): k roped in fp32 with the
// partial rotary tables of `_rope_tables` (:720) and rounded to bf16 into
// khat [B, T, H*64]. Every head-pair attention kernel reads khat: K1 and K5
// (attention.cu) as K10 does, and K6 (attention_bwd.cu), which also reads q^
// = bf16(rope(q) * log2(e)/8) from the same kernel with part 0 and that
// prescale, so neither loop ropes anything.
//
// With scale s: y = x*(s cos) + rotate_half(x)*(s sin) over the first `rot`
// dims, x*s beyond them: at s = 1 exactly the old in-kernel K rope, at s =
// log2(e)/8 exactly the forward kernel's q rope (attention.cu:rope_q_tile),
// so the scores are bit-identical wherever q^ and k^ come from.
//
// Memory bound: it reads and writes B*T*H*64 bf16 (2 x 38.5 MB at B2 T6272
// H24, ~23 us at 3.35 TB/s; 2 x 6.3 MB at B2 T1025, ~4 us). One thread per
// 8 dims of one head's row: a 16-byte load and store, the rotate-half
// partners read from the same 128-byte row (L1).
#include "attention_tiles.cuh"

using namespace fsat_attn;

namespace {

// dst[b, t, h*64 + d] = bf16(rope(x)[d] * scale), x = third `part` of qkv
// (0: q, 1: k) at head h (flash_attention.py:_rope_arr).
__global__ void __launch_bounds__(256)
rope_pair_kernel(const bf16* __restrict__ qkv, int part, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, bf16* __restrict__ dst, int T, int H, int rot,
                 float scale, size_t n_segments) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_segments) return;
  const int seg = (int)(i & 7);  // 8 dims of a 64-dim head
  const size_t row_head = i >> 3;
  const int h = (int)(row_head % H);
  const size_t bt = row_head / H;  // b * T + t
  const int t = (int)(bt % T);
  const int HD = H * kD;
  const bf16* src = qkv + bt * 3 * HD + part * HD + h * kD;
  Pack8 in, res;
  in.u = *reinterpret_cast<const uint4*>(src + seg * 8);
  const int half = rot >> 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = seg * 8 + j;
    const float x = __bfloat162float(in.h[j]);
    float y;
    if (d < rot) {
      const float c = cos_t[(size_t)t * rot + d] * scale;
      const float s = sin_t[(size_t)t * rot + d] * scale;
      const float partner = d < half ? -__bfloat162float(src[d + half])
                                     : __bfloat162float(src[d - half]);
      y = x * c + partner * s;
    } else {
      y = x * scale;
    }
    res.h[j] = __float2bfloat16_rn(y);
  }
  *reinterpret_cast<uint4*>(dst + bt * HD + h * kD + seg * 8) = res.u;
}

}  // namespace

// K10a: qkv [B, T, 3*H*64] bf16, cos/sin [T, rot] fp32 -> dst [B, T, H*64]
// bf16, the roped third `part` (0: q, 1: k) times `scale`.
extern "C" int fsat_rope_pair(const void* qkv, int part, const float* cos_t, const float* sin_t,
                              void* dst, int B, int T, int H, int rot, float scale, void* stream) {
  const size_t n = (size_t)B * T * H * 8;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  rope_pair_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), part, cos_t, sin_t, static_cast<bf16*>(dst), T, H, rot,
      scale, n);
  return (int)cudaGetLastError();
}
