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
// H24, ~23 us at 3.35 TB/s; 2 x 6.3 MB at B2 T1025, ~4 us). One block takes a
// range of rows (b, t) and all H heads of them: the rows' cos and sin are
// read once, pre-scaled once into shared memory, and serve every head. A
// thread holds 8 dims of one head's row (a 16-byte load and store); the 8
// threads of a head are 8 neighbouring lanes, and the rotate-half partners
// come from them by warp shuffles, so each element is read from device
// memory once.
#include "attention_tiles.cuh"

using namespace fsat_attn;

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerBlock = 1536;  // 16-byte items a block takes, about (6 per thread)

// The lane `off` segments on within the lane's head (width-8 shuffles wrap).
__device__ __forceinline__ uint4 from_segment(const uint4& v, int seg, int off) {
  const int src = (seg + off) & 7;
  uint4 r;
  r.x = __shfl_sync(0xffffffffu, v.x, src, 8);
  r.y = __shfl_sync(0xffffffffu, v.y, src, 8);
  r.z = __shfl_sync(0xffffffffu, v.z, src, 8);
  r.w = __shfl_sync(0xffffffffu, v.w, src, 8);
  return r;
}

__device__ __forceinline__ float elem8(const uint4& v, int j) {
  Pack8 p;
  p.u = v;
  return __bfloat162float(p.h[j]);
}

// dst[b, t, h*64 + d] = bf16(rope(x)[d] * scale), x = third `part` of qkv
// (0: q, 1: k) at head h (flash_attention.py:_rope_arr). R = (rot / 2) % 8:
// the rotate-half partner of dim d sits `rot / 2` dims away, that is rot / 16
// segments and R elements on.
template <int R>
__global__ void __launch_bounds__(kThreads)
rope_pair_kernel(const bf16* __restrict__ qkv, int part, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, bf16* __restrict__ dst, int rows_total, int T,
                 int H, int rot, float scale, int rows_per_block) {
  extern __shared__ __align__(16) float tab[];  // [rows_per_block][2][rot]: s cos, s sin
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, rows_total - row0);
  for (int i = threadIdx.x; i < rows * rot; i += kThreads) {
    const int r = i / rot, d = i % rot;
    const size_t at = (size_t)((row0 + r) % T) * rot + d;
    tab[r * 2 * rot + d] = cos_t[at] * scale;
    tab[r * 2 * rot + rot + d] = sin_t[at] * scale;
  }
  __syncthreads();
  const int HD = H * kD, segs = H * 8, half = rot >> 1, so = half >> 3;
  const int items = rows * segs;
  const int seg = threadIdx.x & 7;
  for (int base = 0; base < items; base += kThreads) {  // the same trip count in every lane
    const int i = base + threadIdx.x;
    const bool valid = i < items;
    const int r = i / segs, h = (i % segs) >> 3;
    const size_t bt = (size_t)row0 + r;  // b * T + t
    uint4 in = make_uint4(0, 0, 0, 0);
    if (valid)
      in = *reinterpret_cast<const uint4*>(qkv + bt * 3 * HD + part * HD + h * kD + seg * 8);
    // the partners: dims d + half (from segments seg + so and, where R > 0,
    // seg + so + 1) and d - half (seg - so and seg - so - 1)
    const uint4 up0 = from_segment(in, seg, so);
    const uint4 dn0 = from_segment(in, seg, 8 - so);
    uint4 up1 = up0, dn1 = dn0;
    if constexpr (R > 0) {
      up1 = from_segment(in, seg, so + 1);
      dn1 = from_segment(in, seg, 7 - so);
    }
    if (!valid) continue;
    const float* c_row = tab + r * 2 * rot;
    const float* s_row = c_row + rot;
    Pack8 res;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = seg * 8 + j;
      const float x = elem8(in, j);
      float y;
      if (d < rot) {
        const float c = c_row[d];
        const float s = s_row[d];
        const float partner = d < half ? -(j + R < 8 ? elem8(up0, (j + R) & 7)
                                                     : elem8(up1, (j + R) & 7))
                                       : (j >= R ? elem8(dn0, (j - R) & 7)
                                                 : elem8(dn1, (j - R) & 7));
        // nvcc's contraction of x * c + partner * s, written out: the
        // kernel's first version computed these bits
        y = __fmaf_rn(x, c, __fmul_rn(partner, s));
      } else {
        y = x * scale;
      }
      res.h[j] = __float2bfloat16_rn(y);
    }
    *reinterpret_cast<uint4*>(dst + bt * HD + h * kD + seg * 8) = res.u;
  }
}

template <int R>
int launch_rope(const void* qkv, int part, const float* cos_t, const float* sin_t, void* dst,
                int B, int T, int H, int rot, float scale, cudaStream_t st) {
  const int rows_total = B * T;
  const int rows_per_block = (kItemsPerBlock + H * 8 - 1) / (H * 8);
  const unsigned blocks = (unsigned)((rows_total + rows_per_block - 1) / rows_per_block);
  const size_t smem = (size_t)rows_per_block * 2 * rot * sizeof(float);
  cudaError_t err = allow_smem(rope_pair_kernel<R>, smem);
  if (err != cudaSuccess) return (int)err;
  rope_pair_kernel<R><<<blocks, kThreads, smem, st>>>(
      static_cast<const bf16*>(qkv), part, cos_t, sin_t, static_cast<bf16*>(dst), rows_total, T,
      H, rot, scale, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// K10a: qkv [B, T, 3*H*64] bf16, cos/sin [T, rot] fp32 -> dst [B, T, H*64]
// bf16, the roped third `part` (0: q, 1: k) times `scale`.
extern "C" int fsat_rope_pair(const void* qkv, int part, const float* cos_t, const float* sin_t,
                              void* dst, int B, int T, int H, int rot, float scale, void* stream) {
  if ((size_t)B * T == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((rot >> 1) & 7) {
    case 0: return launch_rope<0>(qkv, part, cos_t, sin_t, dst, B, T, H, rot, scale, st);
    case 1: return launch_rope<1>(qkv, part, cos_t, sin_t, dst, B, T, H, rot, scale, st);
    case 2: return launch_rope<2>(qkv, part, cos_t, sin_t, dst, B, T, H, rot, scale, st);
    case 3: return launch_rope<3>(qkv, part, cos_t, sin_t, dst, B, T, H, rot, scale, st);
    case 4: return launch_rope<4>(qkv, part, cos_t, sin_t, dst, B, T, H, rot, scale, st);
    case 5: return launch_rope<5>(qkv, part, cos_t, sin_t, dst, B, T, H, rot, scale, st);
    case 6: return launch_rope<6>(qkv, part, cos_t, sin_t, dst, B, T, H, rot, scale, st);
    default: return launch_rope<7>(qkv, part, cos_t, sin_t, dst, B, T, H, rot, scale, st);
  }
}
