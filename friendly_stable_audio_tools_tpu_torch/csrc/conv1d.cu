// K2's thin route: the fused snake -> conv kernels for the convolutions a
// tensor-core tile over (rows x Cout) would mostly pad, channels-last, bf16 or
// fp32.
//
// K2 snake_conv1d, thin route replaces conv1d.py:_forward / _kernel (:91, :60)
// (friendly_stable_audio_tools_tpu/ops/pallas/).
//
// Common rules, as in the TPU kernel: the snake runs in fp32 with the
// polynomial sin^2 (common.cuh), its result is rounded to bf16 before the
// products in bf16 (fp32 rounds nothing), products accumulate in fp32, bias
// adds in fp32, and the result is rounded once. The thin route
// (ops/kernels/conv1d.py:conv_route) takes the shapes the wgmma kernel of
// conv_wgmma.cu does not: Cin * elem % 16 != 0 (the encoders' conv_in, Cin 1
// or 2) or a Cout no wgmma tile width divides (the decoders' conv_out, Cout 1
// or 2). Three kernels, chosen by shape and dtype (conv1d.py:thin_design):
//
// * thin-out (design 1; K * Cout <= 32, Cin * elem % 16 == 0): bound by
//   reading x once (SA 2.0's bf16 conv_out 128 -> 2 reads 3.2 GB, ~0.96 ms at
//   3.35 TB/s). Every output is a sum over K * Cin products, but the products
//   of one x row do not depend on the output row: Z[t, (j, o)] = sum_c
//   snake(x)[t, c] w[j, c, o] is one [rows, Cin] x [Cin, K * Cout] product
//   with no tap shift, run on the tensor cores (mma.sync m16n8k16 in bf16,
//   3xTF32 m16n8k8 in fp32; N = K * Cout padded to 8 or 16 columns, not
//   Cout to a 32-wide tile), then y[t, o] = bias[o] + sum_j Z[t - pad + j
//   dil, (j, o)] from shared memory. x streams by cp.async into a per-warp
//   ring of 16-byte slots, 4 steps deep; each lane snakes exactly the 16
//   bytes it copied, once. A block's Z rows overlap its neighbours' by the
//   (K - 1) * dil halo (1.2% more x reads at k 7).
// * thin-in (design 2; bf16, Cin 1 or 2, K * Cin <= 16, Cout % 8 == 0):
//   bound by writing y (SA 2.0's bf16 conv_in 2 -> 128 writes 3.2 GB). Each
//   output row is one 16-deep product of its K * Cin taps on the tensor
//   cores (mma.sync m16n8k16, two zero taps at k 7, Cin 2), the block's x
//   rows staged once as bf16 pairs that are the fragments' words, each
//   warp's 16 x Cout tile packed in shared memory and written with 16-byte
//   stores. On the CUDA cores the same output takes 14 FMAs and the card's
//   FMA rate, not its memory, bounds it (the CUDA-core kernel below reached
//   42% of the bytes' bound there on an H100 SXM at 700 W).
// * the CUDA-core kernel (design 0; the fp32 conv_in and every other thin
//   shape): the x rows of a block tile and their halo are staged once in
//   shared memory, snaked; the weights of all Cout sit in shared memory;
//   each thread computes 16 (fp32) or 8 (bf16) rows of one 16-byte vector of
//   output channels (only the real K * Cin products per output) and writes
//   each row with one 16-byte store, so a warp writes whole rows. Wider Cin
//   or Cout loop over channel chunks and column passes, so it takes any
//   shape. At the fp32 conv_in (bound by writing 6.4 GB at SA 2.0) it
//   reached ~74% of the bytes' bound on an H100 SXM at 700 W.
#include "hopper.cuh"

using fsat_hopper::smem_u32;
using fsat_hopper::tf32_rna;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
// the cast to the model dtype before the products
__device__ __forceinline__ float round_as(float v, const bf16*) { return round_bf16(v); }
__device__ __forceinline__ float round_as(float v, const float*) { return v; }

// ---------------------------------------------------------------------------
// Design 0, the CUDA-core kernel: a block takes tiles of TT rows and all
// Cout in turn (column passes of CG * V channels where Cout is wider), CG
// threads across the columns (V = 16 bytes of outputs each), 256 / CG row
// groups; row group rg computes rows rg, rg + RG, ... so a warp's lanes read
// neighbouring rows of the staged x (no bank conflicts) and write
// neighbouring rows of y.
// ---------------------------------------------------------------------------

template <typename T>
struct CoreShape {
  static constexpr int V = 16 / sizeof(T);             // output channels per thread
  static constexpr int RPT = sizeof(T) == 4 ? 16 : 8;  // rows per thread
};

constexpr size_t kCoreSmem = 96 * 1024;  // staged x and weights per block

struct CorePlan {
  int cg, tt, rs, ck, chunks, passes;
  size_t smem;
};

template <typename T>
CorePlan core_plan(int Cin, int Cout, int K, int dil) {
  constexpr int V = CoreShape<T>::V, RPT = CoreShape<T>::RPT;
  const int groups = (Cout + V - 1) / V;
  CorePlan p;
  p.cg = 1;
  while (p.cg < groups && p.cg < 32) p.cg *= 2;
  p.tt = kThreads / p.cg * RPT;
  p.rs = (p.tt + (K - 1) * dil + 3) / 4 * 4;  // keeps the weights 16-byte aligned
  p.passes = (groups + p.cg - 1) / p.cg;
  const size_t per_channel = ((size_t)K * p.cg * V + p.rs) * sizeof(float);
  const size_t fit = kCoreSmem / per_channel;
  p.ck = (int)(fit < (size_t)Cin ? fit : (size_t)Cin);
  p.chunks = p.ck ? (Cin + p.ck - 1) / p.ck : 0;
  p.smem = per_channel * p.ck;
  return p;
}

template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
thin_cores_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ ab, T* __restrict__ y,
                  int B, int Tn, int Cin, int Cout, int K, int dil, int pad, CorePlan p,
                  int tiles_per_b) {
  constexpr int V = CoreShape<T>::V, RPT = CoreShape<T>::RPT, RG = kThreads / CG;
  constexpr int TT = RG * RPT, CGV = CG * V;
  extern __shared__ __align__(16) float smf[];
  float* xs = smf;                // [ck][rs]: x channel-major, snaked
  float* ws = smf + p.ck * p.rs;  // [K][ck][CGV]
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;

  auto stage_w = [&](int pass, int ci0, int nc) {
    for (int i = threadIdx.x; i < K * nc * CGV; i += kThreads) {
      const int j = i / (nc * CGV), rem = i % (nc * CGV), c = rem / CGV, o = rem % CGV;
      const int co = pass * CGV + o;
      ws[(j * p.ck + c) * CGV + o] =
          co < Cout ? to_float(w[((size_t)j * Cin + ci0 + c) * Cout + co]) : 0.f;
    }
  };
  const bool keep_w = p.passes == 1 && p.chunks == 1;
  if (keep_w) stage_w(0, 0, Cin);

  for (int tile = blockIdx.x; tile < B * tiles_per_b; tile += gridDim.x) {
    const int b = tile / tiles_per_b, t0 = (tile % tiles_per_b) * TT;
    const T* xb = x + (size_t)b * Tn * Cin;
    for (int pass = 0; pass < p.passes; ++pass) {
      float acc[RPT][V];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
      for (int chunk = 0; chunk < p.chunks; ++chunk) {
        const int ci0 = chunk * p.ck, nc = min(p.ck, Cin - ci0);
        __syncthreads();  // the previous chunk's readers are done
        if (!keep_w) stage_w(pass, ci0, nc);
        for (int i = threadIdx.x; i < p.rs * nc; i += kThreads) {
          const int r = i / nc, c = i % nc, t = t0 - pad + r, ci = ci0 + c;
          float v = 0.f;
          if (t >= 0 && t < Tn) {
            v = to_float(xb[(size_t)t * Cin + ci]);
            if (ab != nullptr) v = round_as(snake_poly(v, ab[ci], ab[Cin + ci]), x);
          }
          xs[c * p.rs + r] = v;
        }
        __syncthreads();
        for (int c = 0; c < nc; ++c) {
          for (int j = 0; j < K; ++j) {
            const float* xr = xs + c * p.rs + rg + j * dil;
            const float4* wr = reinterpret_cast<const float4*>(ws + (j * p.ck + c) * CGV + cg * V);
            float wv[V];
#pragma unroll
            for (int v4 = 0; v4 < V / 4; ++v4) {
              const float4 q = wr[v4];
              wv[4 * v4] = q.x;
              wv[4 * v4 + 1] = q.y;
              wv[4 * v4 + 2] = q.z;
              wv[4 * v4 + 3] = q.w;
            }
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              const float xv = xr[r * RG];
#pragma unroll
              for (int v = 0; v < V; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
            }
          }
        }
      }
      const int co0 = pass * CGV + cg * V;
      if (co0 < Cout) {
        float bv[V];
#pragma unroll
        for (int v = 0; v < V; ++v) bv[v] = co0 + v < Cout ? bias[co0 + v] : 0.f;
        const bool vec = Cout % V == 0;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int t = t0 + rg + r * RG;
          if (t >= Tn) continue;
          T* yr = y + ((size_t)b * Tn + t) * Cout + co0;
          if (vec) {
            if constexpr (sizeof(T) == 2) {
              Pack8 o;
#pragma unroll
              for (int v = 0; v < 8; ++v) o.h[v] = __float2bfloat16_rn(acc[r][v] + bv[v]);
              *reinterpret_cast<uint4*>(yr) = o.u;
            } else {
              *reinterpret_cast<float4*>(yr) = make_float4(acc[r][0] + bv[0], acc[r][1] + bv[1],
                                                           acc[r][2] + bv[2], acc[r][3] + bv[3]);
            }
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              if (co0 + v < Cout) {
                if constexpr (sizeof(T) == 2) {
                  yr[v] = __float2bfloat16_rn(acc[r][v] + bv[v]);
                } else {
                  yr[v] = acc[r][v] + bv[v];
                }
              }
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Design 1, thin-out: Z = snake(x) W on the tensor cores, then the tap sum.
// A block tile is ZR = 16 * m rows of Z (x rows t0 - pad ...) giving TT =
// ZR - (K - 1) dil output rows; warp w computes Z's 16-row tiles w, w + 8,
// ... over chunks of KC input channels. In a chunk lane (g, q) = (lane / 4,
// lane % 4) holds rows g and g + 8 of the tile, V channels each (one 16-byte
// load per row), and those channels are the logical k indices the mma
// fragments give the lane (A's a0/a2 and B's b0/b1 both at k 2q.. in bf16, q
// and q + 4 in tf32), so B^T is stored in the same channel order and each
// lane loads its B fragments as one 16-byte word per n8 tile.
// ---------------------------------------------------------------------------

template <typename T>
struct OutShape;
template <>
struct OutShape<bf16> {
  static constexpr int KC = 32;  // input channels per chunk: 4 lanes x 8
  static constexpr int V = 8;
};
template <>
struct OutShape<float> {
  static constexpr int KC = 16;  // 4 lanes x 4
  static constexpr int V = 4;
};

constexpr int kOutStages = 4;  // cp.async steps per warp: 3 in flight
constexpr int kOutMinRows = 384;  // output rows per block tile, at least
constexpr int kOutSlot = 2 * 32 * 16;  // one step: rows g and g + 8 of 32 lanes

struct OutPlan {
  int zr, tt, chunks, cinp, nz;
  size_t bt_off, ab_off, zs_off, smem;
};

template <typename T, int NT>
OutPlan out_plan(int Cin, int K, int dil) {
  constexpr int KC = OutShape<T>::KC, V = OutShape<T>::V;
  OutPlan p;
  const int halo = (K - 1) * dil;
  p.zr = (halo + kOutMinRows + 127) / 128 * 128;
  p.tt = p.zr - halo;
  p.chunks = (Cin + KC - 1) / KC;
  p.cinp = p.chunks * KC + V;  // + one 16-byte word: row g of B^T shifts 4 banks
  p.nz = NT * 8 + 1;           // odd: the tap sum's rows fall in different banks
  const size_t bt_elems = (size_t)NT * 8 * p.cinp * (sizeof(T) == 4 ? 2 : 1);
  p.bt_off = (size_t)kWarps * kOutStages * kOutSlot;
  p.ab_off = p.bt_off + (bt_elems * sizeof(T) + 15) / 16 * 16;
  p.zs_off = p.ab_off + (size_t)2 * p.chunks * KC * sizeof(float);
  p.smem = p.zs_off + (size_t)p.zr * p.nz * sizeof(float);
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += A B, m16n8k16, bf16 A (row-major fragment a0..a3) and B (b0, b1), fp32 d
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// d += A B, m16n8k8, tf32 A and B, fp32 d
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One chunk's products for the lane: rows g (r0) and g + 8 (r1), raw 16-byte
// words as copied, snaked with the chunk's (alpha, inv_beta) of the lane's V
// channels (al, ib) where snake, into acc[NT] (bf16).
template <int NT>
__device__ __forceinline__ void out_products(float (&acc)[NT][4], uint4 r0, uint4 r1, bool snake,
                                             const float* al, const float* ib, const bf16* bt,
                                             int cinp) {
  if (snake) {
    // word e holds channels 2e (low half) and 2e + 1 of the lane's 8
    auto sn = [&](uint32_t u, int e) {
      return pack_bf16(snake_poly(bf_lo(u), al[2 * e], ib[2 * e]),
                       snake_poly(bf_hi(u), al[2 * e + 1], ib[2 * e + 1]));
    };
    r0 = make_uint4(sn(r0.x, 0), sn(r0.y, 1), sn(r0.z, 2), sn(r0.w, 3));
    r1 = make_uint4(sn(r1.x, 0), sn(r1.y, 1), sn(r1.z, 2), sn(r1.w, 3));
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint4 b = *reinterpret_cast<const uint4*>(bt + nt * 8 * cinp);
    mma_bf16(acc[nt], r0.x, r1.x, r0.y, r1.y, b.x, b.y);
    mma_bf16(acc[nt], r0.z, r1.z, r0.w, r1.w, b.z, b.w);
  }
}

// fp32: 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi) per 8-deep step
template <int NT>
__device__ __forceinline__ void out_products(float (&acc)[NT][4], uint4 r0, uint4 r1, bool snake,
                                             const float* al, const float* ib, const float* bt,
                                             int cinp) {
  float v0[4] = {__uint_as_float(r0.x), __uint_as_float(r0.y), __uint_as_float(r0.z),
                 __uint_as_float(r0.w)};
  float v1[4] = {__uint_as_float(r1.x), __uint_as_float(r1.y), __uint_as_float(r1.z),
                 __uint_as_float(r1.w)};
  if (snake) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v0[e] = snake_poly(v0[e], al[e], ib[e]);
      v1[e] = snake_poly(v1[e], al[e], ib[e]);
    }
  }
  uint32_t h0[4], l0[4], h1[4], l1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h0[e] = tf32_rna(v0[e]);
    l0[e] = tf32_rna(v0[e] - __uint_as_float(h0[e]));
    h1[e] = tf32_rna(v1[e]);
    l1[e] = tf32_rna(v1[e] - __uint_as_float(h1[e]));
  }
  const float* bt_lo = bt + NT * 8 * cinp;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint4 bh = *reinterpret_cast<const uint4*>(bt + nt * 8 * cinp);
    const uint4 bl = *reinterpret_cast<const uint4*>(bt_lo + nt * 8 * cinp);
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // channels (2s, 2s + 1) of the lane's 4: k q and q + 4
      const uint32_t bh0 = s ? bh.z : bh.x, bh1 = s ? bh.w : bh.y;
      const uint32_t bl0 = s ? bl.z : bl.x, bl1 = s ? bl.w : bl.y;
      mma_tf32(acc[nt], l0[2 * s], l1[2 * s], l0[2 * s + 1], l1[2 * s + 1], bh0, bh1);
      mma_tf32(acc[nt], h0[2 * s], h1[2 * s], h0[2 * s + 1], h1[2 * s + 1], bl0, bl1);
      mma_tf32(acc[nt], h0[2 * s], h1[2 * s], h0[2 * s + 1], h1[2 * s + 1], bh0, bh1);
    }
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
thin_out_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                const float* __restrict__ ab, T* __restrict__ y, int B, int Tn, int Cin, int Cout,
                int K, int dil, int pad, OutPlan p, int tiles_per_b) {
  constexpr int KC = OutShape<T>::KC, V = OutShape<T>::V;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                             // [warps][stages][2][32][16 B]
  T* bt = reinterpret_cast<T*>(smem + p.bt_off);          // B^T [NT * 8][cinp] (fp32: hi, lo)
  float* abs_ = reinterpret_cast<float*>(smem + p.ab_off);  // alpha, inv_beta [2][chunks * KC]
  float* zs = reinterpret_cast<float*>(smem + p.zs_off);    // Z [zr][nz]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int n_cols = K * Cout, cpad = p.chunks * KC;

  // B^T: column n = j * Cout + o holds w[j, :, o]; columns past K * Cout and
  // channels past Cin are zeros
  for (int i = threadIdx.x; i < NT * 8 * cpad; i += kThreads) {
    const int n = i / cpad, c = i % cpad;
    float v = 0.f;
    if (n < n_cols && c < Cin) v = to_float(w[((size_t)(n / Cout) * Cin + c) * Cout + n % Cout]);
    if constexpr (kF32) {
      const float hi = __uint_as_float(tf32_rna(v));
      bt[n * p.cinp + c] = hi;
      bt[(NT * 8 + n) * p.cinp + c] = __uint_as_float(tf32_rna(v - hi));
    } else {
      bt[n * p.cinp + c] = __float2bfloat16_rn(v);
    }
  }
  for (int i = threadIdx.x; i < cpad; i += kThreads) {
    abs_[i] = ab != nullptr && i < Cin ? ab[i] : 0.f;
    abs_[cpad + i] = ab != nullptr && i < Cin ? ab[Cin + i] : 0.f;
  }
  const bool snake = ab != nullptr;
  const int m_tiles = p.zr / 16;
  const int my_tiles = (m_tiles - warp + kWarps - 1) / kWarps;
  const int steps = my_tiles * p.chunks;
  unsigned char* my_ring = ring + warp * kOutStages * kOutSlot;

  for (int tile = blockIdx.x; tile < B * tiles_per_b; tile += gridDim.x) {
    const int b = tile / tiles_per_b, t0 = (tile % tiles_per_b) * p.tt;
    const T* xb = x + (size_t)b * Tn * Cin;
    __syncthreads();  // B^T staged; the previous tile's tap sums have read Z

    auto issue = [&](int s) {
      const int mt = warp + kWarps * (s / p.chunks), c = (s % p.chunks) * KC + q * V;
      unsigned char* slot = my_ring + (s % kOutStages) * kOutSlot;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 - pad + mt * 16 + g + 8 * h;
        const bool ok = t >= 0 && t < Tn && c < Cin;
        cp_async16(slot + h * 512 + lane * 16, ok ? xb + (size_t)t * Cin + c : xb, ok);
      }
    };
#pragma unroll
    for (int s = 0; s < kOutStages - 1; ++s) {
      if (s < steps) issue(s);
      cp_async_commit();
    }
    float acc[NT][4];
    for (int s = 0; s < steps; ++s) {
      if (s + kOutStages - 1 < steps) issue(s + kOutStages - 1);
      cp_async_commit();
      cp_async_wait<kOutStages - 1>();
      const int chunk = s % p.chunks;
      if (chunk == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      }
      const unsigned char* slot = my_ring + (s % kOutStages) * kOutSlot;
      const uint4 r0 = *reinterpret_cast<const uint4*>(slot + lane * 16);
      const uint4 r1 = *reinterpret_cast<const uint4*>(slot + 512 + lane * 16);
      const int c = chunk * KC + q * V;
      float al[V], ib[V];
      if (snake) {
#pragma unroll
        for (int v4 = 0; v4 < V / 4; ++v4) {
          const float4 a = *reinterpret_cast<const float4*>(abs_ + c + 4 * v4);
          const float4 i4 = *reinterpret_cast<const float4*>(abs_ + cpad + c + 4 * v4);
          al[4 * v4] = a.x, al[4 * v4 + 1] = a.y, al[4 * v4 + 2] = a.z, al[4 * v4 + 3] = a.w;
          ib[4 * v4] = i4.x, ib[4 * v4 + 1] = i4.y, ib[4 * v4 + 2] = i4.z, ib[4 * v4 + 3] = i4.w;
        }
      }
      out_products<NT>(acc, r0, r1, snake, al, ib, bt + g * p.cinp + c, p.cinp);
      if (chunk == p.chunks - 1) {
        const int row = (warp + kWarps * (s / p.chunks)) * 16 + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* z0 = zs + row * p.nz + nt * 8 + 2 * q;
          z0[0] = acc[nt][0];
          z0[1] = acc[nt][1];
          z0[8 * p.nz] = acc[nt][2];
          z0[8 * p.nz + 1] = acc[nt][3];
        }
      }
    }
    __syncthreads();
    // the tap sum: y[t0 + r, o] = bias[o] + sum_j Z[r + j dil, j Cout + o]
    const int rows = min(p.tt, Tn - t0);
    T* yb = y + ((size_t)b * Tn + t0) * Cout;
    for (int i = threadIdx.x; i < rows * Cout; i += kThreads) {
      const int r = i / Cout, o = i % Cout;
      float v = bias[o];
      for (int j = 0; j < K; ++j) v += zs[(r + j * dil) * p.nz + j * Cout + o];
      if constexpr (kF32) {
        yb[i] = v;
      } else {
        yb[i] = __float2bfloat16_rn(v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Design 2, thin-in on the tensor cores (bf16; Cin 1 or 2, K * Cin <= 16,
// Cout % 8 == 0 up to 128): each output row is one 16-deep product of its
// K * Cin taps (k = j * Cin + c, zero past K * Cin) with W [K * Cin, Cout],
// one mma.sync m16n8k16 per 8 output channels of 16 rows. The block stages
// its x rows once as bf16 pairs P[r] = (x[r, 0], x[r, 1]) (Cin 2) or (x[r],
// x[r + dil]) (Cin 1), so the fragment words of lane (g, q), k 2q, 2q + 1
// and 2q + 8, 2q + 9, are P[row + off(q)] and P[row + off(q + 4)] (off(p) =
// p dil, or 2p dil for Cin 1). The accumulators start at the bias; each
// warp packs its 16 x Cout tile to bf16 in shared memory and writes it with
// 16-byte stores, whole rows per warp instruction. The products are free;
// writing y is the work.
// ---------------------------------------------------------------------------

constexpr int kInTiles = 4;                    // 16-row tiles per warp and block tile
constexpr int kInRows = kWarps * kInTiles * 16;  // 512 output rows per block tile

struct InPlan {
  int prows, cstride;  // staged pairs; bytes per row of a warp's C tile
  size_t c_off, bias_off, smem;
};

InPlan in_plan(int Cout, int K, int dil) {
  InPlan p;
  p.prows = kInRows + (K - 1) * dil;
  p.cstride = Cout * 2 + 16;  // + 16 bytes: rows g fall in different banks
  p.bias_off = ((size_t)p.prows * 4 + 15) / 16 * 16;
  p.c_off = p.bias_off + ((size_t)Cout * 4 + 15) / 16 * 16;
  p.smem = p.c_off + (size_t)kWarps * 16 * p.cstride;
  return p;
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
thin_in_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ ab, bf16* __restrict__ y,
               int B, int Tn, int Cin, int K, int dil, int pad, InPlan p, int tiles_per_b) {
  constexpr int Cout = NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* pairs = reinterpret_cast<uint32_t*>(smem);
  float* bs = reinterpret_cast<float*>(smem + p.bias_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  unsigned char* ctile = smem + p.c_off + (size_t)warp * 16 * p.cstride;
  const int kk = K * Cin;  // real taps x channels

  // B fragments: k 2q, 2q + 1 (b0) and 2q + 8, 2q + 9 (b1) of column n = 8 nt + g
  uint32_t b0[NT], b1[NT];
  auto wk = [&](int k, int n) {
    return k < kk ? w[(size_t)k * Cout + n] : __float2bfloat16_rn(0.f);
  };
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nt * 8 + g;
    __nv_bfloat162 v0, v1;
    v0.x = wk(2 * q, n), v0.y = wk(2 * q + 1, n);
    v1.x = wk(2 * q + 8, n), v1.y = wk(2 * q + 9, n);
    b0[nt] = *reinterpret_cast<uint32_t*>(&v0);
    b1[nt] = *reinterpret_cast<uint32_t*>(&v1);
  }
  for (int i = threadIdx.x; i < Cout; i += kThreads) bs[i] = bias[i];
  // the lane's pair offsets (word p of the fragment row), zero where the
  // pair lies past the real taps (its weights are zero, but the word must be
  // finite)
  const int step = Cin == 2 ? dil : 2 * dil;
  const int off_lo = q * step, off_hi = (q + 4) * step;
  const bool lo_ok = 2 * q < kk, hi_ok = 2 * (q + 4) < kk;

  for (int tile = blockIdx.x; tile < B * tiles_per_b; tile += gridDim.x) {
    const int b = tile / tiles_per_b, t0 = (tile % tiles_per_b) * kInRows;
    const bf16* xb = x + (size_t)b * Tn * Cin;
    __syncthreads();  // the previous tile's fragments are read
    for (int r = threadIdx.x; r < p.prows; r += kThreads) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // element e of the pair: channel e of row r (Cin 2) or row r + e dil
        const int t = t0 - pad + r + (Cin == 2 ? 0 : e * dil), c = Cin == 2 ? e : 0;
        float xv = 0.f;
        if (t >= 0 && t < Tn) {
          xv = __bfloat162float(xb[(size_t)t * Cin + c]);
          if (ab != nullptr) xv = round_bf16(snake_poly(xv, ab[c], ab[Cin + c]));
        }
        v[e] = xv;
      }
      pairs[r] = pack_bf16(v[0], v[1]);
    }
    __syncthreads();
#pragma unroll 1
    for (int mt = 0; mt < kInTiles; ++mt) {
      const int r0 = (warp * kInTiles + mt) * 16;
      const uint32_t a0 = lo_ok ? pairs[r0 + g + off_lo] : 0u;
      const uint32_t a1 = lo_ok ? pairs[r0 + g + 8 + off_lo] : 0u;
      const uint32_t a2 = hi_ok ? pairs[r0 + g + off_hi] : 0u;
      const uint32_t a3 = hi_ok ? pairs[r0 + g + 8 + off_hi] : 0u;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(bs + nt * 8 + 2 * q);
        float acc[4] = {bv.x, bv.y, bv.x, bv.y};
        mma_bf16(acc, a0, a1, a2, a3, b0[nt], b1[nt]);
        *reinterpret_cast<uint32_t*>(ctile + g * p.cstride + (nt * 8 + 2 * q) * 2) =
            pack_bf16(acc[0], acc[1]);
        *reinterpret_cast<uint32_t*>(ctile + (g + 8) * p.cstride + (nt * 8 + 2 * q) * 2) =
            pack_bf16(acc[2], acc[3]);
      }
      __syncwarp();
      // 16 rows of NT 16-byte chunks, whole rows per store instruction
#pragma unroll
      for (int i = lane; i < 16 * NT; i += 32) {
        const int r = i / NT, ch = i % NT, t = t0 + r0 + r;
        if (t < Tn)
          *reinterpret_cast<uint4*>(y + ((size_t)b * Tn + t) * Cout + ch * 8) =
              *reinterpret_cast<const uint4*>(ctile + r * p.cstride + ch * 16);
      }
      __syncwarp();
    }
  }
}

int grid_for(const void* kernel, size_t smem, int tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  const int grid = sms * (per_sm > 0 ? per_sm : 1);
  return tiles < grid ? tiles : grid;
}

template <typename T, int CG>
int launch_cores(const T* x, const T* w, const float* bias, const float* ab, T* y, int B,
                 int Tn, int Cin, int Cout, int K, int dil, int pad, const CorePlan& p,
                 cudaStream_t st) {
  auto kernel = thin_cores_kernel<T, CG>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_b = (Tn + p.tt - 1) / p.tt;
  const int grid = grid_for((const void*)kernel, p.smem, B * tiles_per_b);
  kernel<<<grid, kThreads, p.smem, st>>>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, p,
                                         tiles_per_b);
  return (int)cudaGetLastError();
}

template <typename T, int NT>
int launch_out(const T* x, const T* w, const float* bias, const float* ab, T* y, int B, int Tn,
               int Cin, int Cout, int K, int dil, int pad, cudaStream_t st) {
  const OutPlan p = out_plan<T, NT>(Cin, K, dil);
  auto kernel = thin_out_kernel<T, NT>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_b = (Tn + p.tt - 1) / p.tt;
  const int grid = grid_for((const void*)kernel, p.smem, B * tiles_per_b);
  kernel<<<grid, kThreads, p.smem, st>>>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, p,
                                         tiles_per_b);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_in(const bf16* x, const bf16* w, const float* bias, const float* ab, bf16* y, int B,
              int Tn, int Cin, int K, int dil, int pad, cudaStream_t st) {
  const InPlan p = in_plan(NT * 8, K, dil);
  auto kernel = thin_in_kernel<NT>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_b = (Tn + kInRows - 1) / kInRows;
  const int grid = grid_for((const void*)kernel, p.smem, B * tiles_per_b);
  kernel<<<grid, kThreads, p.smem, st>>>(x, w, bias, ab, y, B, Tn, Cin, K, dil, pad, p,
                                         tiles_per_b);
  return (int)cudaGetLastError();
}

int thin_in(const bf16* x, const bf16* w, const float* bias, const float* ab, bf16* y, int B,
            int Tn, int Cin, int Cout, int K, int dil, int pad, cudaStream_t st) {
  if (Cin < 1 || Cin > 2 || K * Cin > 16 || Cout % 8 || Cout > 128)
    return (int)cudaErrorInvalidValue;
  switch (Cout / 8) {
#define FSAT_IN_CASE(n) \
  case n: return launch_in<n>(x, w, bias, ab, y, B, Tn, Cin, K, dil, pad, st);
    FSAT_IN_CASE(1) FSAT_IN_CASE(2) FSAT_IN_CASE(3) FSAT_IN_CASE(4) FSAT_IN_CASE(5)
    FSAT_IN_CASE(6) FSAT_IN_CASE(7) FSAT_IN_CASE(8) FSAT_IN_CASE(9) FSAT_IN_CASE(10)
    FSAT_IN_CASE(11) FSAT_IN_CASE(12) FSAT_IN_CASE(13) FSAT_IN_CASE(14) FSAT_IN_CASE(15)
    FSAT_IN_CASE(16)
#undef FSAT_IN_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int thin_entry(const void* xv, const void* wv, const float* bias, const float* ab, void* yv,
               int B, int Tn, int Cin, int Cout, int K, int dil, int pad, int design,
               void* stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* y = static_cast<T*>(yv);
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || Tn <= 0) return (int)cudaSuccess;
  if (design == 2) {  // thin-in on the tensor cores: bf16 only
    if constexpr (sizeof(T) == 2) {
      return thin_in(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (design == 1) {  // thin-out: K * Cout <= 32, rows of whole 16-byte words
    if (Cin % OutShape<T>::V) return (int)cudaErrorInvalidValue;
    switch ((K * Cout + 7) / 8) {
      case 1: return launch_out<T, 1>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, st);
      case 2: return launch_out<T, 2>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, st);
      case 3: return launch_out<T, 3>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, st);
      case 4: return launch_out<T, 4>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const CorePlan p = core_plan<T>(Cin, Cout, K, dil);
  if (p.ck == 0) return (int)cudaErrorInvalidValue;  // one channel's rows exceed kCoreSmem
  switch (p.cg) {
    case 1: return launch_cores<T, 1>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, p, st);
    case 2: return launch_cores<T, 2>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, p, st);
    case 4: return launch_cores<T, 4>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, p, st);
    case 8: return launch_cores<T, 8>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, p, st);
    case 16: return launch_cores<T, 16>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, p, st);
    default: return launch_cores<T, 32>(x, w, bias, ab, y, B, Tn, Cin, Cout, K, dil, pad, p, st);
  }
}

}  // namespace

// K2's thin route on bf16 x, w and y: `design` 0 the CUDA-core kernel, 1
// thin-out, 2 thin-in on the tensor cores (conv1d.py:thin_design).
extern "C" int fsat_snake_conv1d(const void* x, const void* w, const float* bias, const float* ab,
                                 void* y, int B, int T, int Cin, int Cout, int K, int dil, int pad,
                                 int design, void* stream) {
  return thin_entry<bf16>(x, w, bias, ab, y, B, T, Cin, Cout, K, dil, pad, design, stream);
}

// K2's thin route on fp32 x, w and y.
extern "C" int fsat_snake_conv1d_f32(const void* x, const void* w, const float* bias,
                                     const float* ab, void* y, int B, int T, int Cin, int Cout,
                                     int K, int dil, int pad, int design, void* stream) {
  return thin_entry<float>(x, w, bias, ab, y, B, T, Cin, Cout, K, dil, pad, design, stream);
}
