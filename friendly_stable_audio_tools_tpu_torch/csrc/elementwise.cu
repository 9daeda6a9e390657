// K11 and K12: the adaLN DiT block's two fused elementwise sites.
//
// K11, ln_modulate, replaces friendly_stable_audio_tools_tpu/ops/pallas/
// elementwise.py:_lnmod_forward (:98; `_lnmod_kernel` :88, pallas_call :102):
//   y = round(LayerNorm(x) * gamma), out = round(round(y * round(1 + scale)) + shift)
// with the mean and the centred variance of each row in fp32, eps 1e-5 and
// rsqrt, gamma applied in fp32, and the modulate in bf16 arithmetic: each of
// 1 + scale, the product and the sum rounds to bf16, as the Pallas kernel's
// bf16 operations do. A product of two bf16 values is exact in fp32, so
// rounding it once gives the bf16 product.
//
// K12, gated_residual, replaces elementwise.py:_gres_forward (:167;
// `_gres_kernel` :161, pallas_call :171):
//   out = round(round(y * sigmoid(1 - gate)) + residual)
// with the sigmoid and the product in fp32.
//
// x, y, residual and out are bf16 [B, T, D], contiguous; scale, shift and
// gate are bf16 [B, 1, D] rows with a batch stride of their own (the
// DiT's six adaLN vectors are chunks of one [B, 1, 6D] projection, read in
// place); gamma is fp32, bf16 or absent (the fix_scale LayerNorm: ones).
// The wrapper (ops/kernels/elementwise.py) guarantees D % 128 == 0 and
// D <= 4096, the JAX package's gate, and 16-byte aligned rows.
//
// What bounds them on the H100: one read and one write of each [B, T, D]
// tensor (the vectors are 6 KB a batch row, from L2): at the adaLN DiT's
// [2, 1024, 1536] bf16, K11 moves 12.6 MB (3.76 us at 3.35 TB/s) and K12
// 18.9 MB (5.63 us). The TPU kernel keeps a block of up to 1024 rows in
// VMEM with its vectors resident. Here K11 is planned on the host
// (`lnmod_plan` in ops/kernels/elementwise.py, passed in as grid, warps and
// slots) so that every row of a call is requested in one wave: the grid is
// what the card holds at once, the B * T rows are split evenly over its
// blocks and each block's over its lane groups, in contiguous runs, so that
// each SM takes the same number of rows. A lane group is a warp (a
// half-warp at D 128) and owns one row at a time: each lane loads its
// D / 256 16-byte vectors of the row at once (evict-first: x is read once)
// and keeps them in registers, and both sums are shuffles within the group.
// Each block stages gamma (in fp32) and round(1 + scale) and shift for the
// batch indices its rows span (`slots` of them, at most) in shared memory,
// loaded after its first rows' x, and waits for them once, after those
// rows' sums. A row whose batch index lies beyond the staged ones reads
// its vectors from global memory.
//
// Measured (elementwise_variants.py, x read from device memory, NVIDIA H100
// 80GB HBM3, 700.00 W): at [2, 1024, 1536] K11 takes 0.0071 ms, a `copy_`
// of the same bytes 0.0061 and an empty kernel 0.0010. Every row of a call
// arrives at about the same time, so the instructions an SM issues between
// a row's last load and its store run after the reads, not beside them:
// the modulate runs on bf16 pairs (one conversion, one product and one sum
// for two elements, in the `_rn` forms that round each step) and each
// lane's sums in four chains. K12 is a grid-stride pass of 16-byte loads.
#include "common.cuh"

namespace {

constexpr int kGresThreads = 256;
constexpr int kMaxLnThreads = 256;  // at most 8 warps a block
// shared memory a block may use (227 KB)
constexpr int kMaxSmem = 232448;

// The sum of v over a group of L lanes (L = 16 or 32, aligned in the warp),
// the same in each of them: all 32 lanes take part.
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&out)[8]) {
  Pack8 pk;
  pk.u = u;
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(pk.h[e]);
}

__device__ __forceinline__ void load8(const bf16* p, float (&out)[8]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), out);
}

// The two bf16 values of a 32-bit word as fp32: the element at the lower
// address is the low half.
__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

__device__ __forceinline__ uint32_t as_word(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// round(1 + v) of eight bf16 values, in bf16 arithmetic (one rounding each).
// The bf16 operations here are the `_rn` forms, which the compiler does not
// contract into an fma (a contracted product and sum rounds once, not twice).
__device__ __forceinline__ uint4 one_plus(uint4 u) {
  const __nv_bfloat162 one = __floats2bfloat162_rn(1.f, 1.f);
  u.x = as_word(__hadd2_rn(one, as_bf162(u.x)));
  u.y = as_word(__hadd2_rn(one, as_bf162(u.y)));
  u.z = as_word(__hadd2_rn(one, as_bf162(u.z)));
  u.w = as_word(__hadd2_rn(one, as_bf162(u.w)));
  return u;
}

// gamma_kind: 0 none (ones), 1 fp32, 2 bf16. L lanes take a row (32, or 16
// at D 128: two rows a warp); each holds NV 16-byte vectors of it. The
// kernel keeps to 64 registers a thread up to 4 vectors (32 warps an SM),
// 80 up to 6 (24 warps), 128 up to 11 (16 warps) and 255 above (8 warps):
// `lnmod_warps_per_sm` in the wrapper plans with these. Shared memory holds
// gamma in fp32 (ones without one), then per staged slot round(1 + scale)
// and shift in bf16.
template <int L, int NV>
__global__ void __launch_bounds__(kMaxLnThreads, NV <= 4 ? 4 : NV <= 6 ? 3 : NV <= 11 ? 2 : 1)
ln_modulate_kernel(const bf16* __restrict__ x, const void* __restrict__ gamma, int gamma_kind,
                   const bf16* __restrict__ scale, const bf16* __restrict__ shift,
                   int scale_stride, int shift_stride, bf16* __restrict__ out, int per, int rem,
                   int T, int D, int slots) {
  constexpr int R = 32 / L;  // lane groups (rows at a time) a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int gl = lane % L;
  const int groups = (blockDim.x >> 5) * R;
  // block b takes per rows, and one more where b < rem, from b * per + min(b, rem);
  // its lane groups split them alike, in contiguous runs
  const int b_rows = per + ((int)blockIdx.x < rem ? 1 : 0);
  const int first = blockIdx.x * per + min((int)blockIdx.x, rem);
  const int j = (threadIdx.x >> 5) * R + lane / L;
  const int r0 = first + j * (b_rows / groups) + min(j, b_rows % groups);
  const int n = b_rows / groups + (j < b_rows % groups ? 1 : 0);

  uint4 xv[NV];  // this row's vectors
  float mean = 0.f, rstd = 0.f;
  auto load = [&](int row, bool on) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (v * L + gl) * 8;
      xv[v] = on && c < D ? __ldcs(reinterpret_cast<const uint4*>(x + (long long)row * D + c))
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load(r0, n > 0);  // the first row's loads go out before anything else
  if (b_rows == 0) return;  // the whole block has no row

  // gamma in fp32 and the staged rows' round(1 + scale) and shift
  const int b_first = first / T;
  const int staged = min((first + b_rows - 1) / T - b_first + 1, slots);
  float* s_gamma = reinterpret_cast<float*>(smem);
  bf16* s_scale1 = reinterpret_cast<bf16*>(smem + 4 * D);
  bf16* s_shift = s_scale1 + (size_t)slots * D;
  const int v_chunks = D / 8;
  for (int i = threadIdx.x; i < v_chunks; i += blockDim.x) {
    float g[8];
    if (gamma_kind == 1) {
      const float4* gp = static_cast<const float4*>(gamma) + 2 * i;
      const float4 a = __ldg(gp), b = __ldg(gp + 1);
      g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
      g[4] = b.x; g[5] = b.y; g[6] = b.z; g[7] = b.w;
    } else if (gamma_kind == 2) {
      load8(static_cast<const bf16*>(gamma) + 8 * i, g);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) g[e] = 1.f;
    }
    float4* dst = reinterpret_cast<float4*>(s_gamma) + 2 * i;
    dst[0] = make_float4(g[0], g[1], g[2], g[3]);
    dst[1] = make_float4(g[4], g[5], g[6], g[7]);
  }
  for (int i = threadIdx.x; i < staged * v_chunks; i += blockDim.x) {
    const int slot = i / v_chunks, c = (i - slot * v_chunks) * 8;
    const long long b = b_first + slot;
    const uint4 sc = __ldg(reinterpret_cast<const uint4*>(scale + b * scale_stride + c));
    const uint4 sh = __ldg(reinterpret_cast<const uint4*>(shift + b * shift_stride + c));
    *reinterpret_cast<uint4*>(s_scale1 + (size_t)slot * D + c) = one_plus(sc);
    *reinterpret_cast<uint4*>(s_shift + (size_t)slot * D + c) = sh;
  }

  // the warp's two groups may differ by one row: it loops over the larger
  // count, so that every lane takes part in every shuffle
  const int n_warp = R == 2 ? max(n, __shfl_xor_sync(0xffffffffu, n, 16)) : n;
  // each lane's sums run in four chains (one per word of its vectors), so
  // that its adds do not wait on each other
  auto stats = [&]() {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t w = word(xv[v], k);
        sum[k] += lo_bf16(w);
        sum[k] += hi_bf16(w);
      }
    }
    mean = group_sum<L>((sum[0] + sum[1]) + (sum[2] + sum[3])) / D;
    float sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if ((v * L + gl) * 8 >= D) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t w = word(xv[v], k);
        const float d0 = lo_bf16(w) - mean, d1 = hi_bf16(w) - mean;
        sq[k] += d0 * d0;
        sq[k] += d1 * d1;
      }
    }
    rstd = rsqrtf(group_sum<L>((sq[0] + sq[1]) + (sq[2] + sq[3])) / D + 1e-5f);
  };

  stats();
  __syncthreads();
  for (int i = 0; i < n_warp; ++i) {
    const int row = r0 + i;
    const bool on = i < n;
    if (i > 0) {
      load(row, on);
      stats();
    }
    if (!on) continue;
    const int b = row / T;
    const int slot = b - b_first;
    const bool in_smem = slot < staged;
    const bf16* sc =
        in_smem ? s_scale1 + (size_t)slot * D : scale + (long long)b * scale_stride;
    const bf16* sh =
        in_smem ? s_shift + (size_t)slot * D : shift + (long long)b * shift_stride;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (v * L + gl) * 8;
      if (c >= D) continue;
      const float4 ga = reinterpret_cast<const float4*>(s_gamma)[c / 4];
      const float4 gb = reinterpret_cast<const float4*>(s_gamma)[c / 4 + 1];
      const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      uint4 s1 = *reinterpret_cast<const uint4*>(sc + c);
      if (!in_smem) s1 = one_plus(s1);
      const uint4 hw = *reinterpret_cast<const uint4*>(sh + c);
      uint4 o;
      uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // y = round(LN(x) * gamma) as a bf16 pair, then round(y * round(1 + s))
        // and round(. + shift) in bf16 arithmetic
        const uint32_t w = word(xv[v], k);
        const float d0 = lo_bf16(w) - mean, d1 = hi_bf16(w) - mean;
        const __nv_bfloat162 y =
            __floats2bfloat162_rn(d0 * rstd * g[2 * k], d1 * rstd * g[2 * k + 1]);
        ow[k] = as_word(
            __hadd2_rn(__hmul2_rn(y, as_bf162(word(s1, k))), as_bf162(word(hw, k))));
      }
      __stcs(reinterpret_cast<uint4*>(out + (long long)row * D + c), o);
    }
  }
}

__global__ void __launch_bounds__(kGresThreads)
gated_residual_kernel(const bf16* __restrict__ y, const bf16* __restrict__ gate, int gate_stride,
                      const bf16* __restrict__ residual, bf16* __restrict__ out,
                      long long n_vec, int vec_per_row, int T) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / vec_per_row;
    const int c = (int)(i - row * vec_per_row) * 8;
    const int b = (int)(row / T);
    float fy[8], fg[8], fr[8];
    load8(y + i * 8, fy);
    load8(gate + (long long)b * gate_stride + c, fg);
    load8(residual + i * 8, fr);
    Pack8 o;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float sig = 1.f / (1.f + expf(-(1.f - fg[e])));
      o.h[e] = __float2bfloat16_rn(round_bf16(fy[e] * sig) + fr[e]);
    }
    reinterpret_cast<uint4*>(out)[i] = o.u;
  }
}

bool shape_ok(int rows, int T, int D) {
  return rows > 0 && T > 0 && rows % T == 0 && D > 0 && D % 128 == 0 && D <= 4096;
}

template <int L, int NV>
cudaError_t launch_ln_modulate(const void* x, const void* gamma, int gamma_kind,
                               const void* scale, const void* shift, int scale_stride,
                               int shift_stride, void* out, int rows, int T, int D, int grid,
                               int warps, int slots, int smem, cudaStream_t stream) {
  auto kernel = ln_modulate_kernel<L, NV>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), gamma, gamma_kind, static_cast<const bf16*>(scale),
      static_cast<const bf16*>(shift), scale_stride, shift_stride, static_cast<bf16*>(out),
      rows / grid, rows % grid, T, D, slots);
  return cudaGetLastError();
}

}  // namespace

// K11 on bf16 x [rows = B * T, D] and bf16 scale/shift rows (batch strides
// in elements); gamma fp32 (gamma_kind 1), bf16 (2) or null (0). The plan
// (grid blocks of `warps` warps, `slots` staged batch rows a block) is the
// wrapper's `lnmod_plan`; any grid and warps in 1..8 give the same result.
extern "C" int fsat_ln_modulate(const void* x, const void* gamma, int gamma_kind,
                                const void* scale, const void* shift, int scale_stride,
                                int shift_stride, void* out, int rows, int T, int D, int grid,
                                int warps, int slots, void* stream) {
  if (!shape_ok(rows, T, D) || gamma_kind < 0 || gamma_kind > 2 ||
      (gamma_kind != 0 && gamma == nullptr) || grid < 1 || warps < 1 ||
      warps * 32 > kMaxLnThreads || slots < 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = 4LL * D * (1 + slots);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FSAT_LNMOD(L, NV)                                                                     \
  return (int)launch_ln_modulate<L, NV>(x, gamma, gamma_kind, scale, shift, scale_stride,     \
                                        shift_stride, out, rows, T, D, grid, warps, slots,    \
                                        (int)smem, st)
  if (D == 128) FSAT_LNMOD(16, 1);
  switch ((D + 255) / 256) {
    case 1: FSAT_LNMOD(32, 1);
    case 2: FSAT_LNMOD(32, 2);
    case 3: FSAT_LNMOD(32, 3);
    case 4: FSAT_LNMOD(32, 4);
    case 5: FSAT_LNMOD(32, 5);
    case 6: FSAT_LNMOD(32, 6);
    case 7: FSAT_LNMOD(32, 7);
    case 8: FSAT_LNMOD(32, 8);
    case 9: FSAT_LNMOD(32, 9);
    case 10: FSAT_LNMOD(32, 10);
    case 11: FSAT_LNMOD(32, 11);
    case 12: FSAT_LNMOD(32, 12);
    case 13: FSAT_LNMOD(32, 13);
    case 14: FSAT_LNMOD(32, 14);
    case 15: FSAT_LNMOD(32, 15);
    default: FSAT_LNMOD(32, 16);
  }
#undef FSAT_LNMOD
}

// K12 on bf16 y and residual [rows = B * T, D] and a bf16 gate row per batch
// element (batch stride in elements).
extern "C" int fsat_gated_residual(const void* y, const void* gate, int gate_stride,
                                   const void* residual, void* out, int rows, int T, int D,
                                   void* stream) {
  if (!shape_ok(rows, T, D)) return (int)cudaErrorInvalidValue;
  const long long n_vec = (long long)rows * D / 8;
  const long long want = (n_vec + kGresThreads - 1) / kGresThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  gated_residual_kernel<<<blocks, kGresThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(gate), gate_stride,
      static_cast<const bf16*>(residual), static_cast<bf16*>(out), n_vec, D / 8, T);
  return cudaGetLastError();
}
