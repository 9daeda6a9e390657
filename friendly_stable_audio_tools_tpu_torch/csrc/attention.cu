// K1: non-causal self-attention over a fused qkv tensor, with partial rotary
// embedding applied in-kernel. Replaces the head-pair Pallas kernel
// `_fused_pair_forward` / `_fused_pair_kernel`
// (friendly_stable_audio_tools_tpu/ops/pallas/flash_attention.py:828, :796).
// K5 is the same kernel with its LSE output on: it replaces the training
// forward `_fused_pair_forward_stats` / `_fused_pair_stats_kernel` (:980, :931)
// and writes the per-head base-2 log-sum-exp m + log2(l) of the prescaled
// scores (:957) as lse [B, H, T] fp32, the residual K6 (attention_bwd.cu) reads.
//
// qkv [B, T, 3*H*64] bf16 (q | k | v, heads of 64 in each third), read in
// place with its row stride; cos/sin [T, rot] fp32 rotary tables; out
// [B, T, H*64] bf16. The kernel (attention_fwd.cuh, kPreRopedK = false)
// ropes each 64-key tile as it is loaded.
#include "attention_fwd.cuh"

using namespace fsat_attn;

// lse == nullptr: K1 (inference); otherwise K5, which also writes lse [B, H, T].
extern "C" int fsat_fused_qkv_rope_attention(const void* qkv, const float* cos_t,
                                             const float* sin_t, void* out, float* lse, int B,
                                             int T, int H, int rot, int kv_len, float prescale,
                                             void* stream) {
  const size_t smem = pair_attention_smem();
  cudaError_t err = allow_smem(pair_attention_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  pair_attention_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(qkv), nullptr, cos_t, sin_t, static_cast<bf16*>(out), lse, T, H,
      rot, kv_len, prescale);
  return (int)cudaGetLastError();
}
