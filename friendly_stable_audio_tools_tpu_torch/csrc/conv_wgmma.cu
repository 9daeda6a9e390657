// K2 (its wide route) and K4 on Hopper: one tap-list implicit-GEMM kernel,
// templated on the element type (bf16, fp32), channels-last.
//
// K2 snake_conv1d, wide route  replaces conv1d.py:_forward / _kernel (:91, :60)
// K4 snake_conv_transpose1d    replaces conv1d.py:_upk_forward / _upk_kernel (:262, :228)
// (friendly_stable_audio_tools_tpu/ops/pallas/).
//
// Both are sums over taps: a tap is an input row offset paired with a
// [Cin, Cout] weight slice. K2's tap j reads x[t + j dil - pad] against
// w[j], j < k; K4's output phase r of row q (y row q s + r) reads x[q]
// against w[r + s/2], then x[q - 1] against w[r + s/2 + s] when r < s/2 or
// x[q + 1] against w[r + s/2 - s] otherwise (conv1d.py:217-220). The
// numerics are the TPU kernels': the snake in fp32 with the polynomial sin^2
// (common.cuh), rounded to bf16 before the products in bf16 and not rounded
// in fp32; fp32 accumulation; the bias in fp32; one rounding at the end.
//
// Bound (the products at 989 TFLOP/s in bf16 or 3xTF32's 165 in fp32, or
// each input read and each output written once at 3.35 TB/s, the larger):
// bf16 K2 8.64 ms per SA 1.0 DAC decode (its 768 -> 768 k7 conv 0.2736 ms),
// fp32 K2 580.7 ms per SA 1.0 training step's DAC encode, bf16 K4 1.14 ms per
// DAC decode, fp32 K4 22.49 ms per SA 2.0 decode; all set by the products.
//
// What bounded the kernels this replaces: K2 ran every conv on the CUDA
// cores (FFMA, 16 input channels staged per step with scalar loads and two
// __syncthreads), ~2% of the bf16 peak at the DAC's 768 -> 768 k7 conv (12.76
// ms against a bound of 0.2736 ms, NVIDIA H100 80GB HBM3 at 700 W; cuDNN
// 0.578); the WMMA K4 loaded its tiles synchronously, went through fp32
// shared memory in its epilogue and wasted a quarter of its last 128-column
// chunk at Cout 96 and 192; the fp32 K4 ran WMMA 3xTF32 on 32-column blocks
// (~9% of the fp32-accurate rate). Here:
// - A block owns 128 output rows x N columns (N | Cout, at most 256: 96, 192,
//   768 = 3 x 256, 1536 and 2048 tile with no padding). Two consumer
//   warpgroups of 64 rows each run wgmma; one producer warp keeps a ring of
//   kStages stages filled by TMA, each stage guarded by a "full" mbarrier
//   (TMA bytes) and an "empty" one (the consumers' release).
// - A stage is one tap's A tile (128 rows x one 128-byte row of channels: 64
//   bf16 or 32 fp32) and its B tile(s), each loaded by TMA from a 3-D tensor
//   map: x [B, T, Cin] at row t0 + the tap's offset, and the weights, which
//   the wrapper lays out K-major as [taps, Cout, Cin] (fsat_conv_weights,
//   below). TMA fills rows < 0 and >= T, and channels >= Cin, with zeros, so
//   K2's 'same' padding and K4's zero edges cost no code, and no tile crosses
//   a batch. Each tap is its own load; the halo rows come from L2. The loop
//   runs the taps inside the channel chunks, so consecutive loads read
//   neighbouring rows of one channel slice.
// - The snake, when given, is applied by each consumer warpgroup to its 64
//   rows of the landed A tile, once per tap: bf16 in place through the
//   swizzle, rounded to bf16, then fence.proxy.async; fp32 in registers.
// - bf16: wgmma m64nNk16 with both operands from shared memory, fp32
//   accumulators in registers.
// - fp32 stays fp32-accurate as 3xTF32 (a.b = a_lo.b_hi + a_hi.b_lo +
//   a_hi.b_hi, each part rounded to tf32 to nearest; the dropped a_lo.b_lo is
//   ~2^-22 of the product): A is read from shared memory into registers,
//   snaked, split, and fed as wgmma's register operand (m64nNk8 .tf32); B
//   comes as two tf32-rounded K-major tiles, w_hi and w_lo, which the wrapper
//   prepares per call ([taps, 2, Cout, Cin]: one transposing pass over the
//   weights). The tensor cores' fp32 accumulate does not round to nearest:
//   carried over a whole reduction its error grows with the length. So each
//   stage's products (32 channels x 3) go into a register partial sum, which
//   is added into the fp32 total on the CUDA cores (round to nearest) and
//   zeroed every `flush` stages: conv1d.py:F32_FLUSH = 2 (64 channels). At
//   the DAC encode's 7 x 1024 reduction the kernel's rel-L2 against fp64 is
//   3.6e-7, 4.9e-7, 9.0e-7, 1.8e-6 and 4.9e-5 at 1, 2, 4, 8 stages and the
//   whole reduction (the plain fp32 version's own 1.5e-6); 2 is the longest
//   interval whose emulation with a truncating accumulate stays within 1e-6
//   (tests/test_torch_conv_schedule.py); it costs ~5% against 4 stages.
//   Zeroing the partial on the CUDA cores, rather than starting it with a
//   scale-d = 0 wgmma, took 12-23% off at flush 2 (two runs).
// - The epilogue adds the fp32 bias, rounds once and stores from registers:
//   K2 rows t, K4 rows q s + r (a block keeps one phase).
// Tile width and stages, measured on an H100 80GB HBM3 at 700 W
// (conv_variants.py): N is the widest of the instantiated widths that
// divides Cout (conv1d.py:conv_tile_n): at the DAC's 768 -> 768 k7 conv in
// bf16 0.398 ms at N 256 against 0.420, 0.475, 0.553, 0.740 and 0.876 ms at
// 192, 128, 96, 64 and 32, and the widest was the fastest at every DAC
// shape but the 64-channel conv_in. At most 4 stages fill the ring (bf16 N
// 256 and fp32 N 128: 4 x 48 KB): at the DAC decode's shapes 3 and 6 stages
// were up to 16% and 5% slower, and at most 1% faster. ptxas gives the
// 288 threads 168 registers (as for 384: three warpgroups), and bf16 N 256
// and fp32 N 128 spill 24 and 80 bytes. The Cout chunk varies fastest across
// the grid, so the blocks of one row tile run together and share their A
// tiles in L2. The body is taps_wgmma.cuh's conv_mainloop, which K3's split
// route (residual_unit.cu) runs with an epilogue of its own;
// conv_taps_kernel is its shim.
#include "taps_wgmma.cuh"

namespace {

template <typename T, int N, int CH>
__global__ void __launch_bounds__(kThreads, 1)
conv_taps_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ bias, const float* __restrict__ ab, T* __restrict__ y,
                 const ConvPlan p) {
  conv_mainloop<T, N, CH, kEpiConv>(&xmap, &wmap, bias, ab, y, p, nullptr);
}

template <typename T, int N, int CH>
int launch_conv_taps(const ConvPlan& p, const void* x, const void* wk, int w_taps,
                     const float* bias, const float* ab, void* y, int B, cudaStream_t stream) {
  return launch_taps<T, N>(conv_taps_kernel<T, N, CH>, p, x, wk, w_taps * ConvElem<T>::kBTiles, B,
                           stream, bias, ab, static_cast<T*>(y));
}

// Picks the instantiation of tile width n (conv1d.py:TILE_N): bf16 composes
// 256 and 192 from two wgmmas of 128 and 96 columns, fp32 128 and 96 from
// two of 64 and three of 32.
template <typename T>
int dispatch(ConvPlan p, int n, const void* x, const void* wk, int w_taps, const float* bias,
             const float* ab, void* y, int B, void* stream) {
  if (n <= 0 || p.cout % n || p.cin * (int)sizeof(T) % 16 || p.flush < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 2) {
    switch (n) {
      case 256: return launch_conv_taps<T, 256, 128>(p, x, wk, w_taps, bias, ab, y, B, st);
      case 192: return launch_conv_taps<T, 192, 96>(p, x, wk, w_taps, bias, ab, y, B, st);
      case 128: return launch_conv_taps<T, 128, 128>(p, x, wk, w_taps, bias, ab, y, B, st);
      case 96: return launch_conv_taps<T, 96, 96>(p, x, wk, w_taps, bias, ab, y, B, st);
      case 64: return launch_conv_taps<T, 64, 64>(p, x, wk, w_taps, bias, ab, y, B, st);
      case 32: return launch_conv_taps<T, 32, 32>(p, x, wk, w_taps, bias, ab, y, B, st);
    }
  } else {
    switch (n) {
      case 128: return launch_conv_taps<T, 128, 64>(p, x, wk, w_taps, bias, ab, y, B, st);
      case 96: return launch_conv_taps<T, 96, 32>(p, x, wk, w_taps, bias, ab, y, B, st);
      case 64: return launch_conv_taps<T, 64, 64>(p, x, wk, w_taps, bias, ab, y, B, st);
      case 32: return launch_conv_taps<T, 32, 32>(p, x, wk, w_taps, bias, ab, y, B, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the weights, K-major ---------------------------------------------------------

// w [taps, Cin, Cout] -> [taps, Cout, Cin] (bf16), or [taps, 2, Cout, Cin]
// fp32 with w_hi = tf32(w) and w_lo = tf32(w - w_hi) (kSplit), through a
// 32 x 32 shared-memory transpose.
template <typename T, bool kSplit>
__global__ void conv_weights_kernel(const T* __restrict__ w, T* __restrict__ out, int cin,
                                    int cout) {
  __shared__ float tile[32][33];
  const int j = blockIdx.z, c0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, n = n0 + tx;
    float v = 0.f;
    if (c < cin && n < cout) {
      if constexpr (sizeof(T) == 2) v = __bfloat162float(w[((size_t)j * cin + c) * cout + n]);
      else v = w[((size_t)j * cin + c) * cout + n];
    }
    tile[i][tx] = v;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, c = c0 + tx;
    if (n >= cout || c >= cin) continue;
    const float v = tile[tx][i];
    if constexpr (kSplit) {
      const uint32_t hi = tf32_rna(v);
      out[((size_t)(2 * j) * cout + n) * cin + c] = __uint_as_float(hi);
      out[((size_t)(2 * j + 1) * cout + n) * cin + c] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
    } else {
      out[((size_t)j * cout + n) * cin + c] = __float2bfloat16_rn(v);  // exact: v is a bf16
    }
  }
}

}  // namespace

// w [taps, Cin, Cout] -> out: [taps, Cout, Cin] bf16 (f32 == 0) or [taps, 2,
// Cout, Cin] fp32 tf32 hi/lo parts (f32 != 0), the wide kernel's weights.
extern "C" int fsat_conv_weights(const void* w, void* out, int taps, int cin, int cout, int f32,
                                 void* stream) {
  const dim3 grid((cout + 31) / 32, (cin + 31) / 32, taps), block(32, 8);
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    conv_weights_kernel<float, true><<<grid, block, 0, st>>>(static_cast<const float*>(w),
                                                             static_cast<float*>(out), cin, cout);
  else
    conv_weights_kernel<bf16, false><<<grid, block, 0, st>>>(static_cast<const bf16*>(w),
                                                             static_cast<bf16*>(out), cin, cout);
  return (int)cudaGetLastError();
}

// K2, wide route: x [B, T, Cin], wk from fsat_conv_weights (k taps), bias
// [Cout] fp32, ab [2, Cin] fp32 or null -> y [B, T, Cout]; bf16 (f32 == 0)
// or fp32 with `flush` stages per tensor-core partial sum. n: the tile
// width, n | Cout; Cin * elem % 16 == 0.
extern "C" int fsat_conv_taps_k2(const void* x, const void* wk, const float* bias, const float* ab,
                                 void* y, int B, int T, int Cin, int Cout, int K, int dil, int pad,
                                 int n, int f32, int flush, void* stream) {
  const ConvPlan p{T, Cin, Cout, K, dil, pad, 0, 0, flush};
  return f32 ? dispatch<float>(p, n, x, wk, K, bias, ab, y, B, stream)
             : dispatch<bf16>(p, n, x, wk, K, bias, ab, y, B, stream);
}

// K4: x [B, T, Cin], wk from fsat_conv_weights (2 s taps), bias, ab as K2
// -> y [B, T s, Cout]; s even.
extern "C" int fsat_conv_taps_k4(const void* x, const void* wk, const float* bias, const float* ab,
                                 void* y, int B, int T, int Cin, int Cout, int stride, int n,
                                 int f32, int flush, void* stream) {
  if (stride < 2 || stride % 2) return (int)cudaErrorInvalidValue;
  const ConvPlan p{T, Cin, Cout, 2, 1, 0, stride, 0, flush};
  return f32 ? dispatch<float>(p, n, x, wk, 2 * stride, bias, ab, y, B, stream)
             : dispatch<bf16>(p, n, x, wk, 2 * stride, bias, ab, y, B, stream);
}
