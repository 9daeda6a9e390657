// K6: backward of the fused qkv + rope attention (K5), in the fused layout.
// Replaces `_pair_backward` (friendly_stable_audio_tools_tpu/ops/pallas/
// flash_attention.py:1119) and its two Pallas kernels: `_rope_pair_k_kernel`
// (:1229, call :1139), whose K rope is fused here into the tile loads of both
// passes, and `_pair_bwd_kernel` (:1029, call :1167).
//
// Per head, with q^ = bf16(rope(q) * log2(e)/8), k^ = bf16(rope(k)), lse the
// base-2 LSE of K5 and delta = rowsum(dO * O) (computed beside the kernel):
//   s = q^ k^T, p = exp2(s - lse), dp = dO v^T, ds = bf16(p * (dp - delta))
//   dq = unrope(ds k^) / 8,  dk = unrope(ds^T q^) / log2(e),  dv = bf16(p)^T dO
// Products run on the tensor cores (WMMA bf16, fp32 accumulate); dq, dk and dv
// are written as fp32 into their thirds of dqkv [B, T, 3*H*64].
//
// Who owns dk/dv: the TPU kernel keeps a head pair's fp32 dk/dv resident across
// all q blocks; at T = 1040 that is over 1 MB, far beyond the 227 KB of shared
// memory a Hopper block has. So the work is split as in FlashAttention-2:
// pass 1 (one block per 64-key tile) streams every q tile and holds its keys'
// dk/dv in registers; pass 2 (one block per 64-row q tile) streams every key
// tile and holds dq. Both recompute s and p; nothing is accumulated across
// blocks, so no atomics and the result is deterministic.
//
// Ragged edges: keys at or beyond kv_len get p = 0, so they neither contribute
// nor receive gradient; q rows at or beyond T are zero tiles with p = 0. Rows
// in [kv_len, T) are real rows whose dO the transformer makes zero.
//
// Bound on the H100: both passes are tensor-core work (five 64x64x64 products
// per tile pair plus the recomputed scores); this first version uses WMMA and
// leaves wgmma/TMA to a later change.
#include <mma.h>

#include "attention_tiles.cuh"

using namespace nvcuda;
using namespace fsat_attn;

namespace {

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// acc[nj] (+)= A[16 x 64] . B^T where B is a [64][kLd] tile read transposed.
__device__ __forceinline__ void mm_abt(FragC (&acc)[4], const bf16* a, const bf16* b) {
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) wmma::fill_fragment(acc[nj], 0.f);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, kLd);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, b + nj * 16 * kLd + kk * 16, kLd);
      wmma::mma_sync(acc[nj], fa, fb, acc[nj]);
    }
  }
}

// acc[nj] += A[16 x 64] . B where B is a [64][kLd] tile.
__device__ __forceinline__ void mm_ab_acc(FragC (&acc)[4], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, kLd);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * kLd + nj * 16, kLd);
      wmma::mma_sync(acc[nj], fa, fb, acc[nj]);
    }
  }
}

__device__ __forceinline__ void store4(float* dst, FragC (&acc)[4]) {
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) wmma::store_matrix_sync(dst + nj * 16, acc[nj], kSld, wmma::mem_row_major);
}

// Writes the warp's 16 fp32 rows (row rr = lane / 2, dims hc*32 .. +32 with
// hc = lane % 2) of `w`, un-roped at row position t when `unrope` and scaled,
// to dqkv at column `col`.
__device__ __forceinline__ void write_rows(const float* w, float* __restrict__ dqkv, size_t row_off,
                                           int col, int t, bool unrope,
                                           const float* __restrict__ cos_t,
                                           const float* __restrict__ sin_t, int rot, float scale) {
  const int lane = threadIdx.x & 31, rr = lane >> 1, hc = lane & 1;
  const float* row = w + rr * kSld;
  float* dst = dqkv + row_off + col + hc * 32;
#pragma unroll 4
  for (int i = 0; i < 32; ++i) {
    const int d = hc * 32 + i;
    const float v = unrope ? unrope_at(row, d, cos_t, sin_t, t, rot) : row[d];
    dst[i] = v * scale;
  }
}

// Pass 1: dk, dv. One block per (64-key tile, head, batch); warp w owns keys
// k0 + 16w .. +16 and keeps their dk/dv fragments across the q tiles.
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                          float* __restrict__ dqkv, int T, int H, int rot, int kv_len,
                          float prescale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);        // [64][kLd] k^ of this block's keys
  bf16* Vs = Ks + kTile * kLd;                      // [64][kLd]
  bf16* Qs = Vs + kTile * kLd;                      // [64][kLd] q^ of the current q tile
  bf16* Ds = Qs + kTile * kLd;                      // [64][kLd] dO of the current q tile
  bf16* raw = Ds + kTile * kLd;                     // [64][kLd] staging before the rope
  bf16* Pw_all = raw + kTile * kLd;                 // [warp][16][kLd] bf16(p^T)
  bf16* DSw_all = Pw_all + kWarps * 16 * kLd;       // [warp][16][kLd] bf16(ds^T)
  float* Sw_all = reinterpret_cast<float*>(DSw_all + kWarps * 16 * kLd);  // [warp][16][kSld]
  float* DPw_all = Sw_all + kWarps * 16 * kSld;     // [warp][16][kSld]
  float* lse_s = DPw_all + kWarps * 16 * kSld;      // [64]
  float* delta_s = lse_s + kTile;                   // [64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rr = lane >> 1, hc = lane & 1;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * kD;
  const size_t row_stride = (size_t)3 * HD;
  const bf16* base = qkv + (size_t)b * T * row_stride;
  const bf16* dbase = dout + (size_t)b * T * HD;
  const float* lse_bh = lse + ((size_t)b * H + h) * T;
  const float* delta_bh = delta + ((size_t)b * H + h) * T;
  bf16* Pw = Pw_all + warp * 16 * kLd;
  bf16* DSw = DSw_all + warp * 16 * kLd;
  float* Sw = Sw_all + warp * 16 * kSld;
  float* DPw = DPw_all + warp * 16 * kSld;
  const int key = k0 + warp * 16 + rr;  // this lane's key row
  const size_t out_row = ((size_t)b * T + key) * row_stride;

  if (k0 >= kv_len) {  // every key masked: zero gradient
    if (key < T)
      for (int i = 0; i < 32; ++i) {
        dqkv[out_row + HD + h * kD + hc * 32 + i] = 0.f;
        dqkv[out_row + 2 * HD + h * kD + hc * 32 + i] = 0.f;
      }
    return;
  }

  stage_tile(base, row_stride, HD + h * kD, k0, kv_len, raw);
  stage_tile(base, row_stride, 2 * HD + h * kD, k0, kv_len, Vs);
  __syncthreads();
  rope_tile(raw, Ks, cos_t, sin_t, k0, T, rot, 1.f);

  FragC dk[4], dv[4], acc[4];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    wmma::fill_fragment(dk[nj], 0.f);
    wmma::fill_fragment(dv[nj], 0.f);
  }
  const bool key_ok = key < kv_len;

  const int n_q = (T + kTile - 1) / kTile;
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // previous tile's readers of Qs/Ds/raw are done
    stage_tile(base, row_stride, h * kD, q0, T, raw);
    stage_tile(dbase, HD, h * kD, q0, T, Ds);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < T;
      lse_s[i] = ok ? lse_bh[q0 + i] : 0.f;
      delta_s[i] = ok ? delta_bh[q0 + i] : 0.f;
    }
    __syncthreads();
    rope_tile(raw, Qs, cos_t, sin_t, q0, T, rot, prescale);
    __syncthreads();

    // s^T = k^ q^T and dp^T = v dO^T for the warp's 16 keys x 64 q rows
    mm_abt(acc, Ks + warp * 16 * kLd, Qs);
    store4(Sw, acc);
    mm_abt(acc, Vs + warp * 16 * kLd, Ds);
    store4(DPw, acc);
    __syncwarp();
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const int c = hc * 32 + i;
      float p = 0.f;
      if (key_ok && q0 + c < T) p = exp2f(Sw[rr * kSld + c] - lse_s[c]);
      const float ds = p * (DPw[rr * kSld + c] - delta_s[c]);
      Pw[rr * kLd + c] = __float2bfloat16_rn(p);
      DSw[rr * kLd + c] = __float2bfloat16_rn(ds);
    }
    __syncwarp();
    mm_ab_acc(dv, Pw, Ds);   // dv += p^T dO
    mm_ab_acc(dk, DSw, Qs);  // dk += ds^T q^
  }

  store4(Sw, dk);
  store4(DPw, dv);
  __syncwarp();
  if (key < T) {
    write_rows(Sw, dqkv, out_row, HD + h * kD, key, true, cos_t, sin_t, rot, 1.f / kLog2e);
    write_rows(DPw, dqkv, out_row, 2 * HD + h * kD, key, false, cos_t, sin_t, rot, 1.f);
  }
}

// Pass 2: dq. One block per (64-row q tile, head, batch); warp w owns q rows
// q0 + 16w .. +16 and keeps their dq fragments across the key tiles.
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                        float* __restrict__ dqkv, int T, int H, int rot, int kv_len,
                        float prescale, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);        // [64][kLd] q^ of this block's rows
  bf16* Ds = Qs + kTile * kLd;                      // [64][kLd] dO of this block's rows
  bf16* Ks = Ds + kTile * kLd;                      // [64][kLd] k^ of the current key tile
  bf16* Vs = Ks + kTile * kLd;                      // [64][kLd]
  bf16* raw = Vs + kTile * kLd;                     // [64][kLd] staging before the rope
  bf16* DSw_all = raw + kTile * kLd;                // [warp][16][kLd] bf16(ds)
  float* Sw_all = reinterpret_cast<float*>(DSw_all + kWarps * 16 * kLd);  // [warp][16][kSld]
  float* DPw_all = Sw_all + kWarps * 16 * kSld;     // [warp][16][kSld]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rr = lane >> 1, hc = lane & 1;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * kD;
  const size_t row_stride = (size_t)3 * HD;
  const bf16* base = qkv + (size_t)b * T * row_stride;
  bf16* DSw = DSw_all + warp * 16 * kLd;
  float* Sw = Sw_all + warp * 16 * kSld;
  float* DPw = DPw_all + warp * 16 * kSld;
  const int t = q0 + warp * 16 + rr;  // this lane's q row
  const bool row_ok = t < T;
  const float row_lse = row_ok ? lse[((size_t)b * H + h) * T + t] : 0.f;
  const float row_delta = row_ok ? delta[((size_t)b * H + h) * T + t] : 0.f;

  stage_tile(base, row_stride, h * kD, q0, T, raw);
  stage_tile(dout + (size_t)b * T * HD, HD, h * kD, q0, T, Ds);
  __syncthreads();
  rope_tile(raw, Qs, cos_t, sin_t, q0, T, rot, prescale);

  FragC dq[4], acc[4];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) wmma::fill_fragment(dq[nj], 0.f);

  const int n_k = (kv_len + kTile - 1) / kTile;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // Qs written; previous tile's readers of Ks/Vs/raw are done
    stage_tile(base, row_stride, HD + h * kD, k0, kv_len, raw);
    stage_tile(base, row_stride, 2 * HD + h * kD, k0, kv_len, Vs);
    __syncthreads();
    rope_tile(raw, Ks, cos_t, sin_t, k0, T, rot, 1.f);
    __syncthreads();

    // s = q^ k^T and dp = dO v^T for the warp's 16 q rows x 64 keys
    mm_abt(acc, Qs + warp * 16 * kLd, Ks);
    store4(Sw, acc);
    mm_abt(acc, Ds + warp * 16 * kLd, Vs);
    store4(DPw, acc);
    __syncwarp();
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const int c = hc * 32 + i;
      float p = 0.f;
      if (row_ok && k0 + c < kv_len) p = exp2f(Sw[rr * kSld + c] - row_lse);
      DSw[rr * kLd + c] = __float2bfloat16_rn(p * (DPw[rr * kSld + c] - row_delta));
    }
    __syncwarp();
    mm_ab_acc(dq, DSw, Ks);  // dq += ds k^
  }

  store4(Sw, dq);
  __syncwarp();
  if (row_ok)
    write_rows(Sw, dqkv, ((size_t)b * T + t) * row_stride, h * kD, t, true, cos_t, sin_t, rot,
               scale);
}

size_t dkdv_smem_bytes() {
  return (size_t)(5 * kTile * kLd + 2 * kWarps * 16 * kLd) * sizeof(bf16) +
         (size_t)(2 * kWarps * 16 * kSld + 2 * kTile) * sizeof(float);
}

size_t dq_smem_bytes() {
  return (size_t)(5 * kTile * kLd + kWarps * 16 * kLd) * sizeof(bf16) +
         (size_t)(2 * kWarps * 16 * kSld) * sizeof(float);
}

}  // namespace

// qkv [B, T, 3*H*64] bf16, dout [B, T, H*64] bf16, lse/delta [B, H, T] fp32,
// cos/sin [T, rot] fp32 -> dqkv [B, T, 3*H*64] fp32. Two launches on `stream`.
extern "C" int fsat_fused_qkv_rope_attention_bwd(const void* qkv, const void* dout,
                                                 const float* lse, const float* delta,
                                                 const float* cos_t, const float* sin_t,
                                                 float* dqkv, int B, int T, int H, int rot,
                                                 int kv_len, float prescale, float scale,
                                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = allow_smem(attention_bwd_dkdv_kernel, dkdv_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(attention_bwd_dq_kernel, dq_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  attention_bwd_dkdv_kernel<<<grid, kThreads, dkdv_smem_bytes(), st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), lse, delta, cos_t, sin_t,
      dqkv, T, H, rot, kv_len, prescale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<<<grid, kThreads, dq_smem_bytes(), st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), lse, delta, cos_t, sin_t,
      dqkv, T, H, rot, kv_len, prescale, scale);
  return (int)cudaGetLastError();
}
