// K13: the fused SwiGLU MLP, out = ((x Wv^T + bv) * silu(x Wg^T + bg)) Wo^T.
//
// Replaces friendly_stable_audio_tools_tpu/ops/pallas/mlp.py:_glu_mlp_impl
// (:145; `_glu_mlp_kernel` :116, pallas_call :172). Rounding points as there:
// v = x.Wv and g = x.Wg accumulate in fp32 and round to T, the biases (fp32
// in memory) round to T and add in T, sigmoid(g) runs in fp32 and rounds, and
// h = v * (g * sigmoid(g)) rounds at each product; out accumulates h.Wo in
// fp32 and rounds once. T is float (every rounding is the identity) or bf16.
//
// Weights are read in the port's nn.Linear layouts, contiguous along their
// input dimension: w_in [2 * inner, K] (GLU.proj.weight: value rows first,
// gate rows after, as the JAX package's w_in[:, :inner] / w_in[:, inner:]),
// w_out [Kout, inner] (linear_out.weight).
//
// What bounds it on the H100: at the audio LM's decode (M 2 = one row and its
// CFG twin, K 1024, inner 4096, Kout 1024, fp32) the 50.3 MB of weights, read
// once, against ~50 MFLOP: a GEMV chain bound by device memory (15.0 us at
// 3.35 TB/s). The TPU kernel keeps one M block in VMEM and walks the inner
// dimension in order, carrying its fp32 accumulator across grid steps; here
// blocks run in parallel in no order, so the inner dimension is cut into
// 32-column tiles, spread over `n_split` blocks (128 blocks at the decode
// shape: about one wave on the 132 SMs). A block stages its x rows in shared
// memory, forms v, g and h for its 32 columns there (one warp per column,
// lanes along K with 16-byte loads; h never reaches device memory), then adds
// h times its 32-column slice of every w_out row into an fp32 [BM, Kout]
// accumulator in shared memory (a group of lanes per w_out row, each lane 16
// bytes of it). Each block writes its accumulator to an fp32 partial
// [n_split, M, Kout]; a second small kernel sums the partials in a fixed
// order and rounds, so the result does not depend on scheduling. Large M
// (a prompt's prefill, a DiT's [2080, 1536] tokens) tiles M by BM = 8 rows
// per block; each block then reads every weight it needs once per M tile,
// from L2 where it can. Products run on the CUDA cores in fp32; a large-M
// call is bound by operations and is slow here (a tensor-core version is
// later work).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBJ = 32;  // GLU columns per tile

// Eight bf16 or four fp32 values: one 16-byte load, widened to fp32.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const bf16* p, float (&out)[8]) {
  Pack8 pk;
  pk.u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(pk.h[e]);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_t(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_t(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
// the rounding to T at each of the TPU kernel's cast points
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const bf16*) { return round_bf16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per (split s, M tile); shared memory: xs [BM][K], hs [BM][kBJ],
// acc [BM][Kout], all fp32. Split s takes inner tiles [s * per, (s+1) * per).
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
glu_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w_in,
               const float* __restrict__ b_in, const T* __restrict__ w_out,
               float* __restrict__ partial, int M, int K, int inner, int Kout, int per) {
  constexpr int V = Vec16<T>::N;
  constexpr int LPR = kBJ / V;   // lanes per w_out row slice (fp32 8, bf16 4)
  constexpr int RPW = 32 / LPR;  // w_out rows per warp and step
  extern __shared__ __align__(16) float smf[];
  float* xs = smf;
  float* hs = xs + BM * K;
  float* acc = hs + BM * kBJ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM;
  const int n_tiles = inner / kBJ;
  const int jt0 = blockIdx.x * per, jt1 = min(jt0 + per, n_tiles);

  for (int i = threadIdx.x; i < BM * K; i += kThreads) {
    const int m = i / K, k = i % K;
    xs[i] = (m0 + m < M) ? to_f(x[(size_t)(m0 + m) * K + k]) : 0.f;
  }
  for (int i = threadIdx.x; i < BM * Kout; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  for (int jt = jt0; jt < jt1; ++jt) {
    const int j0 = jt * kBJ;
    // v, g and h for the tile's 32 columns: warp w takes columns w, w + 8, ...
    for (int jj = warp; jj < kBJ; jj += kWarps) {
      const T* wv = w_in + (size_t)(j0 + jj) * K;
      const T* wg = w_in + (size_t)(inner + j0 + jj) * K;
      float av[BM], ag[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) av[m] = ag[m] = 0.f;
#pragma unroll 4
      for (int k = lane * V; k < K; k += 32 * V) {
        float fv[V], fg[V];
        load16(wv + k, fv);
        load16(wg + k, fg);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          // K % V == 0, so each lane's V values of x are 16-byte aligned
          const float4* xr = reinterpret_cast<const float4*>(xs + m * K + k);
#pragma unroll
          for (int q = 0; q < V / 4; ++q) {
            const float4 xv = xr[q];
            av[m] = fmaf(xv.x, fv[4 * q], av[m]);
            av[m] = fmaf(xv.y, fv[4 * q + 1], av[m]);
            av[m] = fmaf(xv.z, fv[4 * q + 2], av[m]);
            av[m] = fmaf(xv.w, fv[4 * q + 3], av[m]);
            ag[m] = fmaf(xv.x, fg[4 * q], ag[m]);
            ag[m] = fmaf(xv.y, fg[4 * q + 1], ag[m]);
            ag[m] = fmaf(xv.z, fg[4 * q + 2], ag[m]);
            ag[m] = fmaf(xv.w, fg[4 * q + 3], ag[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float sv = warp_sum(av[m]), sg = warp_sum(ag[m]);
        if (lane == m) {
          float v = rnd(sv, x), g = rnd(sg, x);
          if (b_in != nullptr) {
            v = rnd(v + rnd(b_in[j0 + jj], x), x);
            g = rnd(g + rnd(b_in[inner + j0 + jj], x), x);
          }
          const float sig = rnd(1.f / (1.f + expf(-g)), x);
          hs[m * kBJ + jj] = rnd(v * rnd(g * sig, x), x);
        }
      }
    }
    __syncthreads();
    // acc[m][n] += h[m][:] . w_out[n, j0:j0+32]: LPR lanes per row, V columns each
    const int sub = lane % LPR, rw = lane / LPR;
    float hr[BM][V];
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int e = 0; e < V; ++e) hr[m][e] = hs[m * kBJ + sub * V + e];
#pragma unroll 4
    for (int n0 = warp * RPW; n0 < Kout; n0 += kWarps * RPW) {
      const int n = n0 + rw;
      float p[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) p[m] = 0.f;
      if (n < Kout) {
        float fw[V];
        load16(w_out + (size_t)n * inner + j0 + sub * V, fw);
#pragma unroll
        for (int m = 0; m < BM; ++m)
#pragma unroll
          for (int e = 0; e < V; ++e) p[m] = fmaf(hr[m][e], fw[e], p[m]);
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) p[m] += __shfl_xor_sync(0xffffffffu, p[m], o);
      }
      if (sub == 0 && n < Kout) {
#pragma unroll
        for (int m = 0; m < BM; ++m) acc[m * Kout + n] += p[m];
      }
    }
    __syncthreads();  // hs is rewritten by the next tile
  }

  float* out = partial + (size_t)blockIdx.x * M * Kout;
  for (int i = threadIdx.x; i < BM * Kout; i += kThreads) {
    const int m = i / Kout, n = i % Kout;
    if (m0 + m < M) out[(size_t)(m0 + m) * Kout + n] = acc[i];
  }
}

// y[i] = round_T(sum over s of partial[s][i]), s in a fixed order: warp w
// sums the splits s = w, w + 8, ... of 32 consecutive outputs, then the eight
// warp sums add in warp order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
glu_mlp_reduce_kernel(const float* __restrict__ partial, T* __restrict__ y, int total,
                      int n_split) {
  __shared__ float part[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < total)
    for (int sp = warp; sp < n_split; sp += kWarps) s += partial[(size_t)sp * total + i];
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < total) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += part[w][lane];
    store_t(y + i, t);
  }
}

size_t glu_mlp_smem_bytes(int bm, int K, int Kout) {
  return (size_t)bm * (K + kBJ + Kout) * sizeof(float);
}

template <typename T, int BM>
int launch_glu_mlp(const void* x, const void* w_in, const float* b_in, const void* w_out,
                   float* partial, void* y, int M, int K, int inner, int Kout, int n_split,
                   cudaStream_t stream) {
  const int n_tiles = inner / kBJ;
  const int per = (n_tiles + n_split - 1) / n_split;
  const size_t smem = glu_mlp_smem_bytes(BM, K, Kout);
  cudaError_t err = allow_smem(glu_mlp_kernel<T, BM>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_split, (M + BM - 1) / BM);
  glu_mlp_kernel<T, BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in), b_in, static_cast<const T*>(w_out),
      partial, M, K, inner, Kout, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = M * Kout;
  glu_mlp_reduce_kernel<T><<<(total + 31) / 32, kThreads, 0, stream>>>(
      partial, static_cast<T*>(y), total, n_split);
  return (int)cudaGetLastError();
}

// bm is the wrapper's M tile (ops/kernels/mlp.py:plan): 2 or 8 rows.
template <typename T>
int glu_mlp_entry(const void* x, const void* w_in, const float* b_in, const void* w_out,
                  float* partial, void* y, int M, int K, int inner, int Kout, int n_split, int bm,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K % Vec16<T>::N || inner % kBJ || n_split < 1) return (int)cudaErrorInvalidValue;
  if (bm == 2)
    return launch_glu_mlp<T, 2>(x, w_in, b_in, w_out, partial, y, M, K, inner, Kout, n_split, st);
  if (bm == 8)
    return launch_glu_mlp<T, 8>(x, w_in, b_in, w_out, partial, y, M, K, inner, Kout, n_split, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K13 on bf16 x, w_in, w_out and y (fp32 biases and partials).
extern "C" int fsat_glu_mlp(const void* x, const void* w_in, const float* b_in, const void* w_out,
                            float* partial, void* y, int M, int K, int inner, int Kout,
                            int n_split, int bm, void* stream) {
  return glu_mlp_entry<bf16>(x, w_in, b_in, w_out, partial, y, M, K, inner, Kout, n_split, bm,
                             stream);
}

// K13 on fp32 x, w_in, w_out and y.
extern "C" int fsat_glu_mlp_f32(const void* x, const void* w_in, const float* b_in,
                                const void* w_out, float* partial, void* y, int M, int K,
                                int inner, int Kout, int n_split, int bm, void* stream) {
  return glu_mlp_entry<float>(x, w_in, b_in, w_out, partial, y, M, K, inner, Kout, n_split, bm,
                              stream);
}
