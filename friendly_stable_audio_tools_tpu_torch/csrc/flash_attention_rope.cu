// The rope-fused K7's rope pass: q and k of a fused [B, T, 3*H*D] qkv
// tensor roped with the reference's fp32 partial rotary, q prescaled, both
// rounded to bf16, and the three split into heads [B*H, T, D]; the
// attention over them is the bf16 K7 (flash_attention_bf16.cu) for bf16
// inputs and the fp32 K7 (flash_attention.cu at D 64, flash_attention_d128.cu
// at D 128) for fp32 inputs, each with a prescale of 1.
//
// Replaces `_single_dot_rope_kernel` (friendly_stable_audio_tools_tpu/ops/
// pallas/flash_attention.py:132, called from `_flash_forward` :230 with
// `freqs`, :266-285, launched at :317): the single-dot attention that
// `flash_attention(q, k, v, freqs=...)` runs up to 2048 tokens (`_flash_rope`
// :747) for a DiT self-attention that the head-pair kernels do not take
// (head dim other than 64, or an odd head count: flash_attention.py:1413-1452).
// Per head, with cos/sin the last T rows of the rotary tables padded to D
// with 1 and 0 (`_rope_tables` :720) and q's tables times
// scale * log2(e) in fp32 (:274-278), what `_apply_rope_tile` (:66) computes:
//   rope(t) = bf16(t * C + rot_half(bf16(t)) * S), in fp32 before the rounding
// (the rotate-half product reads the bf16-rounded t even for fp32 inputs);
// then, in the attention kernel, s = q^ k^T in fp32 (keys past T masked),
// p = exp2(s - m) (base 2: the prescale holds log2(e)), l = rowsum(p), P
// rounded to v's dtype, out = (P v) / max(l, 1e-30) in the input dtype.
// Caller: SAO 1.0's config with 12 heads of 128 (rotary dim 64, T 1025 at
// CFG batch 2, no grad: 24 calls per DiT forward, 2400 per 100-step
// generation); at head dim 64, a DiT with an odd head count.
//
// What bounds it on the H100: the attention's products, 4 T^2 D operations
// per head (at B 2 x 12 heads, T 1025, D 128: 12.91 GFLOP, 0.0131 ms at the
// bf16 rate); this pass moves 3 B T H D elements in and out once (at that
// shape 18.9 MB each way in bf16, 0.0113 ms at 3.35 TB/s) and is memory
// bound (measured 0.039 ms, PERF.md §6: a first version). The TPU kernel
// ropes its q tile and the whole transposed K per program in VMEM; here the
// pass ropes each q and k row once, writes the operands the attention kernel
// reads by TMA in its [B*H, T, D] layout (the head split the JAX package does
// in XLA before the kernel), and the attention kernel needs no rope of its
// own. For fp32 inputs the roped q and k are bf16 values held in fp32, and
// the fp32 K7's 3xTF32 score product takes them exactly (their lo parts are
// zero: a product that a bf16 score product would do in a third of the
// issues, kept because the fp32 K7 already holds P.V in 3xTF32 with fp32 v).
//
// Design: one block per token of one batch row; thread i takes element i of
// the row's 3 H D (q, then k, then v), reads its rotate-half partner in the
// same head from the same (cached) row, and writes the head-split element.
// The arithmetic is written out as __fmul_rn / __fadd_rn, so that the
// compiler does not contract it into an fma, which the plain version
// (torch, one rounding per operation) does not do.
#include "common.cuh"

namespace {

template <typename Tin>
__device__ __forceinline__ float load_f32(const Tin* p);

template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}

template <>
__device__ __forceinline__ float load_f32<bf16>(const bf16* p) {
  return __bfloat162float(*p);
}

template <typename Tin>
__device__ __forceinline__ void store_from_f32(Tin* p, float x);

template <>
__device__ __forceinline__ void store_from_f32<float>(float* p, float x) {
  *p = x;
}

template <>
__device__ __forceinline__ void store_from_f32<bf16>(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// qkv [B, T, 3 H D] -> q^, k^, v [B H, T, D]. cos_q/sin_q and cos_k/sin_k:
// [T, rot] fp32 tables (the q pair already times prescale); dims >= rot take
// C = prescale (q) or 1 (k) and S = 0.
template <typename Tin>
__global__ void __launch_bounds__(256)
rope_heads_kernel(const Tin* __restrict__ qkv, Tin* __restrict__ qh, Tin* __restrict__ kh,
                  Tin* __restrict__ vh, const float* __restrict__ cos_q,
                  const float* __restrict__ sin_q, const float* __restrict__ cos_k,
                  const float* __restrict__ sin_k, int T, int H, int D, int rot, float prescale) {
  const int t = blockIdx.x, b = blockIdx.y, hd = H * D, half = rot / 2;
  const Tin* row = qkv + ((size_t)b * T + t) * 3 * hd;
  for (int i = threadIdx.x; i < 3 * hd; i += blockDim.x) {
    const int part = i / hd, j = i % hd, h = j / D, c = j % D;
    const size_t at = (((size_t)b * H + h) * T + t) * D + c;
    const float x = load_f32(row + i);
    if (part == 2) {
      vh[at] = row[i];
      continue;
    }
    float res;
    if (c < rot) {
      const float* ct = part == 0 ? cos_q : cos_k;
      const float* st = part == 0 ? sin_q : sin_k;
      const float partner = c < half ? -round_bf16(load_f32(row + i + half))
                                     : round_bf16(load_f32(row + i - half));
      res = __fadd_rn(__fmul_rn(x, ct[(size_t)t * rot + c]),
                      __fmul_rn(partner, st[(size_t)t * rot + c]));
    } else {
      res = part == 0 ? __fmul_rn(x, prescale) : x;
    }
    store_from_f32((part == 0 ? qh : kh) + at, round_bf16(res));
  }
}

}  // namespace

// The rope pass: qkv [B, T, 3 H D] (bf16 when is_bf16, else fp32),
// contiguous -> q^, k^, v [B H, T, D] in qkv's dtype (q^ and k^ bf16 values;
// v copied). cos_q, sin_q, cos_k, sin_k: [T, rot] fp32 (the q tables times
// prescale), rot even and <= D. One launch.
extern "C" int fsat_rope_heads(const void* qkv, void* q, void* k, void* v, const float* cos_q,
                               const float* sin_q, const float* cos_k, const float* sin_k, int B,
                               int T, int H, int D, int rot, float prescale, int is_bf16,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || T < 1 || B > 65535 || rot % 2 || rot > D) return (int)cudaErrorInvalidValue;
  const dim3 grid(T, B);
  if (is_bf16)
    rope_heads_kernel<bf16><<<grid, 256, 0, st>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(q), static_cast<bf16*>(k),
        static_cast<bf16*>(v), cos_q, sin_q, cos_k, sin_k, T, H, D, rot, prescale);
  else
    rope_heads_kernel<float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(qkv), static_cast<float*>(q), static_cast<float*>(k),
        static_cast<float*>(v), cos_q, sin_q, cos_k, sin_k, T, H, D, rot, prescale);
  return (int)cudaGetLastError();
}
