// The long-sequence pair path of the DiT's self-attention (2048 < T <= 8192,
// Stable Audio 2.0's 6144 latent frames + 1 prepended token, padded to 6272).
// Replaces `_pair_long_forward`
// (friendly_stable_audio_tools_tpu/ops/pallas/flash_attention.py:1255) and
// its two Pallas calls:
//
// K10a `_rope_pair_k_kernel` (:1229, call :1281): k of the fused qkv tensor
//   roped once, in fp32 with the partial rotary tables of `_rope_tables`
//   (:720), rounded to bf16 into khat [B, T, H*64]. Memory bound: it reads
//   and writes B*T*H*64 bf16 (2 x 38.5 MB at B2 T6272 H24, ~23 us at
//   3.35 TB/s). One thread per 8 dims of one head's row: a 16-byte load and
//   store, the rotate-half partners read from the same 128-byte row (L1).
//
// K10 `_pair_long_kernel` (:1233, call :1297): attention of the roped,
//   prescaled q over khat and v, keys at or beyond kv_len masked, output
//   [B, T, H*64] bf16. Tensor-core bound: 4*B*H*kv_len^2*64 FLOP over the
//   valid rows (~464 GFLOP at B2 T6272 kv_len 6145 H24, ~0.47 ms). The TPU
//   kernel keeps a head pair's whole roped K (6272 x 128 bf16, 1.6 MB) in
//   VMEM and takes one whole-K score dot per head; a Hopper block's 227 KB
//   cannot hold that, so K10 streams
//   64-key tiles of khat and v through K1's online base-2 softmax
//   (attention_fwd.cuh with kPreRopedK = true). What K10a buys over K1 at
//   this length: K1 ropes every key tile once per q tile, 98 times per head
//   at T = 6272; here each key is roped once.
#include "attention_fwd.cuh"

using namespace fsat_attn;

namespace {

// khat[b, t, h*64 + d] = bf16(k*cos + rotate_half(k)*sin) over the first
// `rot` dims of each head, k unchanged beyond them (flash_attention.py:_rope_arr).
__global__ void __launch_bounds__(256)
rope_pair_k_kernel(const bf16* __restrict__ qkv, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, bf16* __restrict__ khat, int T, int H,
                   int rot, size_t n_segments) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_segments) return;
  const int seg = (int)(i & 7);  // 8 dims of a 64-dim head
  const size_t row_head = i >> 3;
  const int h = (int)(row_head % H);
  const size_t bt = row_head / H;  // b * T + t
  const int t = (int)(bt % T);
  const int HD = H * kD;
  const bf16* src = qkv + bt * 3 * HD + HD + h * kD;
  Pack8 in, res;
  in.u = *reinterpret_cast<const uint4*>(src + seg * 8);
  const int half = rot >> 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = seg * 8 + j;
    const float x = __bfloat162float(in.h[j]);
    float y = x;
    if (d < rot) {
      const float partner = d < half ? -__bfloat162float(src[d + half])
                                     : __bfloat162float(src[d - half]);
      y = x * cos_t[(size_t)t * rot + d] + partner * sin_t[(size_t)t * rot + d];
    }
    res.h[j] = __float2bfloat16_rn(y);
  }
  *reinterpret_cast<uint4*>(khat + bt * HD + h * kD + seg * 8) = res.u;
}

}  // namespace

// K10a: qkv [B, T, 3*H*64] bf16, cos/sin [T, rot] fp32 -> khat [B, T, H*64] bf16.
extern "C" int fsat_rope_pair_k(const void* qkv, const float* cos_t, const float* sin_t,
                                void* khat, int B, int T, int H, int rot, void* stream) {
  const size_t n = (size_t)B * T * H * 8;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  rope_pair_k_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), cos_t, sin_t, static_cast<bf16*>(khat), T, H, rot, n);
  return (int)cudaGetLastError();
}

// K10: qkv [B, T, 3*H*64] bf16 (q and v read in place), khat [B, T, H*64]
// bf16 from K10a, cos/sin [T, rot] fp32 -> out [B, T, H*64] bf16.
extern "C" int fsat_pair_long_attention(const void* qkv, const void* khat, const float* cos_t,
                                        const float* sin_t, void* out, int B, int T, int H,
                                        int rot, int kv_len, float prescale, void* stream) {
  const size_t smem = pair_attention_smem();
  cudaError_t err = allow_smem(pair_attention_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  pair_attention_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(khat), cos_t, sin_t,
      static_cast<bf16*>(out), nullptr, T, H, rot, kv_len, prescale);
  return (int)cudaGetLastError();
}
