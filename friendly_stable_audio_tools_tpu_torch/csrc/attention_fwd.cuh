// The forward attention kernel shared by K1/K5 (attention.cu) and K10
// (attention_long.cu): one block per (64-row q tile, head, batch), four
// warps of 16 q rows. The q tile is roped in fp32, prescaled by
// log2(e)/sqrt(64) and rounded to bf16; each 64-key tile is masked at
// kv_len and folded in with an online base-2 softmax (fp32 running max and
// sum). Scores and P.V run on the tensor cores (WMMA bf16, fp32 accumulate).
//
// kPreRopedK = false (K1, K5): each key tile is read from the qkv tensor and
//   roped as it is staged, so every q tile ropes the whole K again.
// kPreRopedK = true (K10): keys come already roped and rounded from khat
//   [B, T, H*64] (K10a's output, written once per call), and are staged as
//   they are.
#pragma once

#include <mma.h>

#include "attention_tiles.cuh"

namespace fsat_attn {

// attention.cu instantiates kPreRopedK = false, attention_long.cu true
template <bool kPreRopedK>
__global__ void __launch_bounds__(kThreads)
pair_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ khat,
                      const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                      bf16* __restrict__ out, float* __restrict__ lse, int T, int H, int rot,
                      int kv_len, float prescale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                      // [64][kLd]
  bf16* Ks = Qs + kTile * kLd;                                     // [64][kLd]
  bf16* Vs = Ks + kTile * kLd;                                     // [64][kLd]
  bf16* Ps = Vs + kTile * kLd;                                     // [warp][16][kLd]
  float* Ss = reinterpret_cast<float*>(Ps + kWarps * 16 * kLd);  // [warp][16][kSld]
  bf16* raw = reinterpret_cast<bf16*>(Ss);                       // [64][kLd] staging, aliases Ss

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * kD;
  const size_t row_stride = (size_t)3 * HD;
  const bf16* base = qkv + (size_t)b * T * row_stride;

  stage_tile(base, row_stride, h * kD, q0, T, raw);
  __syncthreads();
  rope_tile(raw, Qs, cos_t, sin_t, q0, T, rot, prescale);

  // lane -> (row rr of the warp's 16, column half hc); o holds 32 output dims
  const int rr = lane >> 1, hc = lane & 1;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  bf16* Pw = Ps + warp * 16 * kLd;
  float* Sw = Ss + warp * 16 * kSld;

  using namespace nvcuda;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  const int n_tiles = (kv_len + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // Qs written; previous tile's readers of Ks/Vs/Ss done
    if constexpr (kPreRopedK) {
      stage_tile(khat + (size_t)b * T * HD, HD, h * kD, k0, kv_len, Ks);
      stage_tile(base, row_stride, 2 * HD + h * kD, k0, kv_len, Vs);
      __syncthreads();
    } else {
      stage_tile(base, row_stride, HD + h * kD, k0, kv_len, raw);
      stage_tile(base, row_stride, 2 * HD + h * kD, k0, kv_len, Vs);
      __syncthreads();
      rope_tile(raw, Ks, cos_t, sin_t, k0, T, rot, 1.f);
      __syncthreads();
    }

    // S = Q K^T for the warp's 16 rows x 64 keys
    FragC sacc[4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) wmma::fill_fragment(sacc[nj], 0.f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * kLd + kk * 16, kLd);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, Ks + nj * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(sacc[nj], a, bk, sacc[nj]);
      }
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      wmma::store_matrix_sync(Sw + nj * 16, sacc[nj], kSld, wmma::mem_row_major);
    __syncwarp();

    // online base-2 softmax over this tile (two lanes per row)
    float s[32];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = hc * 32 + i;
      s[i] = (k0 + c < kv_len) ? Sw[rr * kSld + c] : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = (m_new == -INFINITY) ? 1.f : exp2f(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = (s[i] == -INFINITY) ? 0.f : exp2f(s[i] - m_new);
      ls += p;
      Pw[rr * kLd + hc * 32 + i] = __float2bfloat16_rn(p);
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha;
    __syncwarp();

    // O += P V
    FragC oacc[4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) wmma::fill_fragment(oacc[nj], 0.f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, Pw + kk * 16, kLd);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, Vs + kk * 16 * kLd + nj * 16, kLd);
        wmma::mma_sync(oacc[nj], pa, bv, oacc[nj]);
      }
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      wmma::store_matrix_sync(Sw + nj * 16, oacc[nj], kSld, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] += Sw[rr * kSld + hc * 32 + i];
  }

  const int t = q0 + warp * 16 + rr;
  if (t < T) {
    const float denom = fmaxf(l, 1e-30f);
    uint4* dst = reinterpret_cast<uint4*>(out + ((size_t)b * T + t) * HD + h * kD + hc * 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Pack8 pk;
#pragma unroll
      for (int j = 0; j < 8; ++j) pk.h[j] = __float2bfloat16_rn(o[i * 8 + j] / denom);
      dst[i] = pk.u;
    }
    if (lse != nullptr && hc == 0) lse[((size_t)b * H + h) * T + t] = m + log2f(denom);
  }
}

// Dynamic shared memory of pair_attention_kernel: Q, K, V and P tiles in
// bf16 and each warp's fp32 score scratch.
inline size_t pair_attention_smem() {
  return (size_t)4 * kTile * kLd * sizeof(bf16) + (size_t)kWarps * 16 * kSld * sizeof(float);
}

}  // namespace fsat_attn
