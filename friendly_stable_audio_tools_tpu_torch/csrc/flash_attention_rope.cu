// The rope-fused K7: non-causal self-attention of a fused qkv [B, T, 3 H D]
// tensor (q | k | v, bf16 or fp32) with the reference's fp32 partial rotary,
// in two launches: a rope pass, then the attention, whose output is written
// merged into [B, T, H D].
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
// then s = q^ k^T in fp32, p = exp2(s - m) (base 2: the prescale holds
// log2(e)), l = rowsum(p), P rounded to v's dtype, out = (P v) / max(l,
// 1e-30) in the input dtype. Caller: SAO 1.0's config with 12 heads of 128
// (rotary dim 64, T 1025 at CFG batch 2, no grad: 24 calls per DiT forward,
// 2400 per 100-step generation); at head dim 64, a DiT with an odd head count.
//
// What bounds it on the H100: the attention's products, 4 T^2 D operations
// per head (at B 2 x 12 heads, T 1025, D 128: 12.91 GFLOP, 0.0131 ms at the
// bf16 rate; in fp32 P.V at 3xTF32's 165 TFLOP/s: 0.0456 ms). The TPU kernel
// ropes its q tile and the whole transposed K in VMEM per program; here:
// - The rope pass (`rope_k_kernel`, one launch) ropes k once per call, not
//   once per q tile, into k^ [B, T, H D] bf16 (both dtypes: the roped
//   values are bf16 either way), in K10a's design (attention_rope.cu): a
//   block takes rows (b, t) with all their heads, a thread 8 dims of one
//   head's row (16- or 32-byte loads), the rotate-half partners come from the
//   neighbouring lanes by shuffles. It makes the tables itself from freqs
//   (cosf / sinf: the bits of torch.cos / torch.sin on the card): k's into
//   shared memory, q's (times the prescale) into a [2][T][rot] scratch that
//   the attention reads. For fp32 inputs the same launch writes V^T as tf32
//   hi/lo parts [2][B H][D][Tp] (Tp = T rounded up to 64, keys in the pos8
//   order, keys at or past T zero) for the 3xTF32 P.V, from blocks of its
//   own (64 keys of one head each). Memory bound: at the SAO shape it reads
//   k (6.3 MB bf16) and writes k^ (6.3 MB), 0.0038 ms at 3.35 TB/s; in fp32
//   it reads k and v (25.2 MB) and writes k^ and V^T's parts (31.5 MB). A
//   block first prefetches its rows' q and k into L2 (one bulk prefetch a
//   row): k for itself, q for the attention's prologue. Measured on the
//   H100 (PERF.md §6): 0.0060 ms bf16, 0.0177 fp32.
// - The attention ropes each q tile in its prologue straight from qkv
//   (attention_tiles.cuh: rope_q_rows, the same arithmetic) into swizzled
//   shared memory as wgmma's A operand, reads K^ by TMA from the pass's
//   output and V (bf16) by TMA straight from qkv's v third, and stores the
//   output merged: nothing is split into heads or merged back in device
//   memory. bf16: the bf16 K7's kernel (flash_attention_bf16.cu, its `kRope`
//   instance). fp32: `rope_attention_f32_kernel` below.
//
// The fp32 attention. q^ and k^ are bf16 values, so S = q^ k^T is exact as
// bf16 wgmma products accumulated in fp32: one m64n64k16 per 16 dims, where
// the fp32 K7 (flash_attention_d128.cu) spends three m64n64k8 tf32 issues per
// 8 dims on the same values (6x the tensor-core time). P stays fp32 (the JAX
// kernel rounds P to v's dtype), so P.V stays 3xTF32 against V^T's hi/lo
// parts from the pass. Measured on the card, in this order:
// - One consumer warpgroup per block (64 q rows, O and each tile's P.V as
//   separate fp32 totals, P's hi/lo fragments in registers: 244 registers)
//   pulled the V^T pairs, 64 KB a 64-key tile at D 128, from L2 at ~5 TB/s,
//   its bound: 0.145 ms at B 2 x 12 heads, T 1025.
// - Two warpgroups sharing each tile (128 q rows) with the per-tile P.V
//   total kept: the 168 registers ptxas allows 288 threads hold O, the
//   tile's P.V and S but not P, which went through shared memory as a tf32
//   A tile; its stores and the A reads beside the V^T reads left shared
//   memory the bound: 0.130 ms.
// - Here: two warpgroups, P's hi/lo fragments in registers (wgmma's A from
//   registers), and each tile's P.V accumulated into O by the tensor cores
//   after O is rescaled in registers (the bf16 K7's form). Their fp32
//   accumulate truncates: over a row's at most 32 key tiles (2048 tokens)
//   it stays far inside the 1e-4 rel-L2 the plain version is held to (the
//   fp32 K7 keeps separate totals for SA 2.0's 98 tiles, ~6e-5 without).
// The warpgroups start their products in turns (S of one, S of the other,
// P.V of one, ...), so one's softmax runs while the other's product holds
// the tensor cores. Budget, written before the card run: registers O (D/2)
// and P's fragments (64), or O and S (32): ~140 at D 128; shared memory q^
// 2 x 16 KB + K^ 2 x 16 KB + V^T 2 x 64 KB = 196,608 bytes at D 128.
#include "attention_tiles.cuh"

using namespace fsat_attn;

// The bf16 attention (flash_attention_bf16.cu).
int fsat_flash_rope_forward_bf16(const void* qkv, const void* khat, const float* cos_q,
                                 const float* sin_q, void* out, int B, int T, int H, int D,
                                 int rot, float prescale, cudaStream_t st);

namespace {

// ---- the rope pass ------------------------------------------------------------

constexpr int kPassThreads = 256;
constexpr int kPassItems = 512;   // 8-dim items a rope block takes, about (2 a thread)
constexpr int kTileKeys = 64;     // keys of a V^T block: one key tile of the attention

// Chunk (seg + off) mod W of the lane's head row: its W = D / 8 chunks sit
// in W neighbouring lanes.
template <int W>
__device__ __forceinline__ uint4 from_chunk(const uint4& v, int seg, int off) {
  const int src = (seg + off) & (W - 1);
  uint4 r;
  r.x = __shfl_sync(0xffffffffu, v.x, src, W);
  r.y = __shfl_sync(0xffffffffu, v.y, src, W);
  r.z = __shfl_sync(0xffffffffu, v.z, src, W);
  r.w = __shfl_sync(0xffffffffu, v.w, src, W);
  return r;
}

__device__ __forceinline__ float elem8(const uint4& v, int j) {
  Pack8 p;
  p.u = v;
  return __bfloat162float(p.h[j]);
}

// V^T block `blk` (fp32): 64 keys of one head's v, from qkv, as tf32 hi/lo
// into vt [2][B H][D][Tp] with each 8 keys in the pos8 order (keys at or
// past T zero), staged in vs [64][D + 1].
template <int D>
__device__ __forceinline__ void split_vt(const float* __restrict__ qkv, uint32_t* __restrict__ vt,
                                         float* vs, int B, int T, int H, int blk) {
  const int n_kt = (T + kTileKeys - 1) / kTileKeys, Tp = n_kt * kTileKeys;
  const int kt = blk % n_kt, bh = blk / n_kt, b = bh / H, h = bh % H, k0 = kt * kTileKeys;
  const size_t hd = (size_t)H * D;
  for (int i = threadIdx.x; i < kTileKeys * D / 4; i += kPassThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + r < T)
      x = *reinterpret_cast<const float4*>(qkv + ((size_t)b * T + k0 + r) * 3 * hd + 2 * hd +
                                           (size_t)h * D + c);
    float* dst = vs + r * (D + 1) + c;
    dst[0] = x.x, dst[1] = x.y, dst[2] = x.z, dst[3] = x.w;
  }
  __syncthreads();
  const size_t head = (size_t)bh * D * Tp, part = (size_t)B * H * D * Tp;
  for (int i = threadIdx.x; i < kTileKeys * D; i += kPassThreads) {
    const int d = i / kTileKeys, r = i % kTileKeys;
    const size_t at = head + (size_t)d * Tp + k0 + pos8(r);
    uint32_t hi, lo;
    split_tf32(vs[r * (D + 1) + d], hi, lo);
    vt[at] = hi;
    vt[part + at] = lo;
  }
}

// Blocks [0, rope_blocks): rows [row0, row0 + rows_per_block) of the B T
// rows (b, t), all heads: k^ = bf16(rope(k)) into khat [B, T, H D], with
// k's tables cos/sin(freqs[t]) in shared memory, and (rows of batch row 0)
// q's tables times `prescale` into cos_q, sin_q [T, rot]. Blocks past them
// (fp32 only): split_vt. R = (rot / 2) % 8: the partner of dim d sits rot / 2
// dims away, rot / 16 chunks and R elements on.
template <typename Tin, int D, int R>
__global__ void __launch_bounds__(kPassThreads)
rope_k_kernel(const Tin* __restrict__ qkv, const float* __restrict__ freqs,
              bf16* __restrict__ khat, float* __restrict__ cos_q, float* __restrict__ sin_q,
              uint32_t* __restrict__ vt, int B, int T, int H, int rot, float prescale,
              int rows_per_block, int rope_blocks) {
  constexpr int W = D / 8;  // chunks of a head's row
  extern __shared__ __align__(16) float pass_smem[];
  if ((int)blockIdx.x >= rope_blocks) {
    if constexpr (sizeof(Tin) == 4)
      split_vt<D>(reinterpret_cast<const float*>(qkv), vt, pass_smem, B, T, H,
                  blockIdx.x - rope_blocks);
    return;
  }
  float* tab = pass_smem;  // [rows_per_block][2][rot]: cos, sin of k
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, B * T - row0);
  const int hd = H * D;
  // the rows' q and k into L2 while the tables are made: k is read below, q
  // by the attention, launched next, in its prologue
  if ((int)threadIdx.x < rows)
    prefetch_l2(qkv + (size_t)(row0 + threadIdx.x) * 3 * hd, 2 * hd * (uint32_t)sizeof(Tin));
  for (int i = threadIdx.x; i < rows * rot; i += kPassThreads) {
    const int r = i / rot, d = i % rot, bt = row0 + r, t = bt % T;
    const float f = freqs[(size_t)t * rot + d];
    const float c = cosf(f), s = sinf(f);
    tab[r * 2 * rot + d] = c;
    tab[r * 2 * rot + rot + d] = s;
    if (bt < T) {  // batch row 0: each q table row written once
      cos_q[(size_t)t * rot + d] = __fmul_rn(c, prescale);
      sin_q[(size_t)t * rot + d] = __fmul_rn(s, prescale);
    }
  }
  __syncthreads();
  const int segs = H * W, half = rot >> 1, so = half >> 3;
  const int items = rows * segs;
  for (int base = 0; base < items; base += kPassThreads) {  // the same trip count in every lane
    const int i = base + threadIdx.x;
    const bool valid = i < items;
    const int r = i / segs, h = (i % segs) / W, seg = i % W;
    const size_t bt = (size_t)row0 + r;
    Raw8<Tin> xr;
    if (valid) xr.load(qkv + bt * 3 * hd + hd + (size_t)h * D + 8 * seg);
    float x[8];
    Pack8 xb;  // the partners' values: rounded to bf16
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = valid ? xr[j] : 0.f;
      xb.h[j] = __float2bfloat16_rn(x[j]);
    }
    // dims d + half (chunks seg + so and, where R > 0, seg + so + 1) and
    // d - half (seg - so and seg - so - 1)
    const uint4 up0 = from_chunk<W>(xb.u, seg, so);
    const uint4 dn0 = from_chunk<W>(xb.u, seg, W - so);
    uint4 up1 = up0, dn1 = dn0;
    if constexpr (R > 0) {
      up1 = from_chunk<W>(xb.u, seg, so + 1);
      dn1 = from_chunk<W>(xb.u, seg, W - so - 1);
    }
    if (!valid) continue;
    const float* c_row = tab + r * 2 * rot;
    const float* s_row = c_row + rot;
    Pack8 res;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * seg + j;
      float y = x[j];
      if (d < rot) {
        const float p = d < half ? -(j + R < 8 ? elem8(up0, (j + R) & 7) : elem8(up1, (j + R) & 7))
                                 : (j >= R ? elem8(dn0, (j - R) & 7) : elem8(dn1, (j - R) & 7));
        y = __fadd_rn(__fmul_rn(x[j], c_row[d]), __fmul_rn(p, s_row[d]));
      }
      res.h[j] = __float2bfloat16_rn(y);
    }
    *reinterpret_cast<uint4*>(khat + bt * hd + (size_t)h * D + 8 * seg) = res.u;
  }
}

template <typename Tin, int D, int R>
cudaError_t launch_pass(const void* qkv, const float* freqs, bf16* khat, float* cos_q,
                        float* sin_q, uint32_t* vt, int B, int T, int H, int rot, float prescale,
                        cudaStream_t st) {
  const int rows_per_block = (kPassItems + H * D / 8 - 1) / (H * D / 8);
  const int rope_blocks = (B * T + rows_per_block - 1) / rows_per_block;
  const int vt_blocks = sizeof(Tin) == 4 ? (T + kTileKeys - 1) / kTileKeys * B * H : 0;
  const size_t tab_bytes = (size_t)rows_per_block * 2 * rot * sizeof(float);
  const size_t vt_bytes = sizeof(Tin) == 4 ? (size_t)kTileKeys * (D + 1) * sizeof(float) : 0;
  const size_t smem = tab_bytes > vt_bytes ? tab_bytes : vt_bytes;
  const cudaError_t err = allow_smem(rope_k_kernel<Tin, D, R>, smem);
  if (err != cudaSuccess) return err;
  rope_k_kernel<Tin, D, R><<<rope_blocks + vt_blocks, kPassThreads, smem, st>>>(
      static_cast<const Tin*>(qkv), freqs, khat, cos_q, sin_q, vt, B, T, H, rot, prescale,
      rows_per_block, rope_blocks);
  return cudaGetLastError();
}

template <typename Tin, int D>
cudaError_t launch_pass(int r, const void* qkv, const float* freqs, bf16* khat, float* cos_q,
                        float* sin_q, uint32_t* vt, int B, int T, int H, int rot, float prescale,
                        cudaStream_t st) {
#define FSAT_PASS(R) \
  launch_pass<Tin, D, R>(qkv, freqs, khat, cos_q, sin_q, vt, B, T, H, rot, prescale, st)
  switch (r) {
    case 0: return FSAT_PASS(0);
    case 1: return FSAT_PASS(1);
    case 2: return FSAT_PASS(2);
    case 3: return FSAT_PASS(3);
    case 4: return FSAT_PASS(4);
    case 5: return FSAT_PASS(5);
    case 6: return FSAT_PASS(6);
    default: return FSAT_PASS(7);
  }
#undef FSAT_PASS
}

// ---- the fp32 attention ---------------------------------------------------------

constexpr int kConsumers = 2;                    // warpgroups of 64 q rows
constexpr int kM = 64 * kConsumers;              // q rows per block
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kKeys = 64;                        // keys per tile
constexpr int kKSlots = 2;                       // K^ tiles in flight
constexpr int kVSlots = 2;                       // V^T hi/lo tile pairs in flight
constexpr int kTurnBarrier = 3;                  // named barriers 3, 4: the warpgroups' turns
constexpr int kPanel = 64 * kRowBytes;           // 64 rows of 64 bf16 dims: a q^ or K^ panel

template <int D>
struct F32Layout {  // byte offsets into the 1024-aligned dynamic shared memory
  static constexpr int kQ = 64 * 2 * D;             // a warpgroup's q^ [64][D] bf16
  static constexpr int kKTile = kKeys * 2 * D;      // K^ [64 keys][D] bf16: D / 64 panels
  static constexpr int kVtPanel = D * kSwizzleRow;  // V^T: D dims x 32 key positions
  static constexpr int kVSlot = 4 * kVtPanel;       // a tile's hi (2 panels), then lo
  static constexpr int q = 0;                       // q^ of warpgroup w at w kQ
  static constexpr int k_ring = q + kConsumers * kQ;
  static constexpr int v_ring = k_ring + kKSlots * kKTile;
  static constexpr int bars = v_ring + kVSlots * kVSlot;  // k_full, k_empty, v_full, v_empty
  static constexpr int bytes = bars + 2 * (kKSlots + kVSlots) * 8;
  static_assert(kKTile % 1024 == 0 && kVtPanel % 1024 == 0, "tiles on the swizzle atom");
  static_assert(bytes + 1024 <= 232448, "one block's shared memory");
};

// S = q^ K^T over the tile's 64 keys: one bf16 m64n64k16 per 16 dims.
template <int D>
__device__ __forceinline__ void f32_scores(float (&s)[1][32], uint32_t q, uint32_t k_tile) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(s[0], kmajor_desc(q + p * kPanel + kk * 32),
                     kmajor_desc(k_tile + p * kPanel + kk * 32), p + kk > 0);
}

// O += P V^T over the tile's 64 keys (pos8 order) in 3xTF32: P's hi/lo
// register fragments, V^T's parts K-major from the slot.
template <int D>
__device__ __forceinline__ void f32_pv(float (&o)[D / 2], const uint32_t (&hi)[8][4],
                                       const uint32_t (&lo)[8][4], uint32_t v_slot) {
  using L = F32Layout<D>;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t v_hi = v_slot + (kk >> 2) * L::kVtPanel + (kk & 3) * 32;
    const uint32_t v_lo = v_hi + 2 * L::kVtPanel;
    wgmma_tf32<D>(o, lo[kk], kmajor_desc(v_hi), 1);
    wgmma_tf32<D>(o, hi[kk], kmajor_desc(v_lo), 1);
    wgmma_tf32<D>(o, hi[kk], kmajor_desc(v_hi), 1);
  }
}

// Block (q tile of 128 rows, head h, batch row b): qkv [B, T, 3 H D] fp32,
// K^ by kmap (over khat [B, T, H D] bf16: boxes of 64 keys x 64 dims), V^T
// by vmap (over vt [2 B H][D][Tp] fp32: boxes of D dims x 32 key positions)
// -> out [B, T, H D]. The two warpgroups start their products in turns (S
// of warpgroup 0, S of 1, P.V of 0, P.V of 1, ...), so one's softmax runs
// while the other's product holds the tensor cores.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
rope_attention_f32_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const float* __restrict__ qkv,
                          const float* __restrict__ cos_q, const float* __restrict__ sin_q,
                          float* __restrict__ out, int T, int H, int rot, float prescale) {
  using L = F32Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* k_empty = k_full + kKSlots;
  uint64_t* v_full = k_empty + kKSlots;
  uint64_t* v_empty = v_full + kVSlots;
  const int q0 = blockIdx.x * kM, h = blockIdx.y, b = blockIdx.z;
  const int BH = gridDim.y * gridDim.z, bh = b * H + h;
  const int n_tiles = (T + kKeys - 1) / kKeys;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kKSlots; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], kConsumers * 128);
    }
    for (int s = 0; s < kVSlots; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warp: one thread starts the loads
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < n_tiles; ++kt) {  // K^ of tile kt, then its V^T pair
        const int sk = kt % kKSlots, sv = kt % kVSlots, k0 = kt * kKeys;
        if (kt >= kKSlots) mbar_wait(&k_empty[sk], ((kt / kKSlots) + 1) & 1);
        unsigned char* kd = smem + L::k_ring + sk * L::kKTile;
        mbar_expect_tx(&k_full[sk], L::kKTile);
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
          tma_load_3d(kd + p * kPanel, &kmap, &k_full[sk], h * D + 64 * p, k0, b);
        if (kt >= kVSlots) mbar_wait(&v_empty[sv], ((kt / kVSlots) + 1) & 1);
        unsigned char* vd = smem + L::v_ring + sv * L::kVSlot;
        mbar_expect_tx(&v_full[sv], L::kVSlot);
#pragma unroll
        for (int part = 0; part < 2; ++part)  // hi, lo
#pragma unroll
          for (int half = 0; half < 2; ++half)
            tma_load_3d(vd + (2 * part + half) * L::kVtPanel, &vmap, &v_full[sv],
                        k0 + 32 * half, 0, part * BH + bh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows r0 .. r0 + 63
  const int tid = threadIdx.x & 127, warp = tid >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = q0 + 64 * wg;
  unsigned char* qs = smem + L::q + wg * L::kQ;
  rope_q_rows<float, D>(qkv, cos_q, sin_q, qs, qs + kPanel, b, h, r0, T, H, rot, prescale, tid);
  fence_proxy_async();
  bar_sync(1 + wg, 128);
  auto my_turn = [&] { bar_sync(kTurnBarrier + wg, 256); };
  auto pass_turn = [&] { bar_arrive(kTurnBarrier + 1 - wg, 256); };
  if (wg == 1) pass_turn();  // warpgroup 0 starts

  const uint32_t q_addr = smem_u32(qs);
  const uint32_t k_ring = smem_u32(smem + L::k_ring), v_ring = smem_u32(smem + L::v_ring);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: the lane's part of the row sum

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int sk = kt % kKSlots, sv = kt % kVSlots;
    float s[1][32], a0, a1;
    uint32_t p_hi[8][4], p_lo[8][4];
    mbar_wait(&k_full[sk], (kt / kKSlots) & 1);
    my_turn();
    wgmma_fence();
    f32_scores<D>(s, q_addr, k_ring + sk * L::kKTile);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    reg_fence(s[0]);
    mbar_arrive(&k_empty[sk]);
    online_softmax<1>(s, kt * kKeys, T, tq, m0, m1, l0, l1, a0, a1);
    acc_to_a_tf32(s[0], p_hi, p_lo);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {  // O in the new max's scale, before this tile's P.V
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    mbar_wait(&v_full[sv], (kt / kVSlots) & 1);
    my_turn();
    reg_fence(o);
    wgmma_fence();
    f32_pv<D>(o, p_hi, p_lo, v_ring + sv * L::kVSlot);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    reg_fence(o);
    mbar_arrive(&v_empty[sv]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const size_t stride = (size_t)H * D;  // merged rows [B, T, H D]
  float* oh = out + (size_t)b * T * stride + (size_t)h * D + 2 * tq;
  const int row0 = r0 + 16 * warp + g;  // the lane's rows: row0, row0 + 8
  if (row0 < T) {
    float* dst = oh + (size_t)row0 * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j] / d0, o[4 * j + 1] / d0);
  }
  if (row0 + 8 < T) {
    float* dst = oh + (size_t)(row0 + 8) * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

template <int D>
cudaError_t launch_f32(const float* qkv, const bf16* khat, const float* cos_q, const float* sin_q,
                       const uint32_t* vt, float* out, int B, int T, int H, int rot,
                       float prescale, cudaStream_t st) {
  const int Tp = (T + kKeys - 1) / kKeys * kKeys;
  CUtensorMap kmap, vmap;
  cudaError_t err = head_rows_map(&kmap, khat, H * D, T, B, kKeys);
  if (err == cudaSuccess)
    err = sw128_map_3d(&vmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, vt, Tp, D, 2 * (size_t)B * H,
                       32, D);
  const size_t smem = F32Layout<D>::bytes + 1024;
  if (err == cudaSuccess) err = allow_smem(rope_attention_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kM - 1) / kM, H, B);
  rope_attention_f32_kernel<D><<<grid, kThreads, smem, st>>>(kmap, vmap, qkv, cos_q, sin_q, out, T,
                                                             H, rot, prescale);
  return cudaGetLastError();
}

}  // namespace

// The rope-fused K7: qkv [B, T, 3 H D] (bf16 when is_bf16, else fp32)
// contiguous, 16-byte aligned; freqs [T, rot] fp32 contiguous (the rows of
// the last T positions), rot even and <= D; D 64 or 128 -> out [B, T, H D]
// in qkv's dtype. Scratch the caller allocates (16-byte aligned): khat [B,
// T, H D] bf16, tables [2][T][rot] fp32 (q's cos and sin times `prescale`,
// which the call writes), vt [2][B H][D][Tp] tf32 parts (fp32 only; Tp = T
// rounded up to 64). prescale = log2(e)/sqrt(D). Two launches: the rope
// pass, then the attention.
extern "C" int fsat_flash_rope_attention(const void* qkv, const float* freqs, void* khat,
                                         float* tables, void* vt, void* out, int B, int T, int H,
                                         int D, int rot, float prescale, int is_bf16,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || T < 1 || H < 1 || B > 65535 || H > 65535 || (D != 64 && D != 128) || rot < 0 ||
      rot % 2 || rot > D || (!is_bf16 && vt == nullptr))
    return (int)cudaErrorInvalidValue;
  bf16* kh = static_cast<bf16*>(khat);
  float* cos_q = tables;
  float* sin_q = tables + (size_t)T * rot;
  uint32_t* vparts = static_cast<uint32_t*>(vt);
  const int r = (rot >> 1) & 7;
  cudaError_t err;
  if (is_bf16)
    err = D == 64 ? launch_pass<bf16, 64>(r, qkv, freqs, kh, cos_q, sin_q, vparts, B, T, H, rot,
                                          prescale, st)
                  : launch_pass<bf16, 128>(r, qkv, freqs, kh, cos_q, sin_q, vparts, B, T, H, rot,
                                           prescale, st);
  else
    err = D == 64 ? launch_pass<float, 64>(r, qkv, freqs, kh, cos_q, sin_q, vparts, B, T, H, rot,
                                           prescale, st)
                  : launch_pass<float, 128>(r, qkv, freqs, kh, cos_q, sin_q, vparts, B, T, H, rot,
                                            prescale, st);
  if (err != cudaSuccess) return (int)err;
  if (is_bf16)
    return fsat_flash_rope_forward_bf16(qkv, kh, cos_q, sin_q, out, B, T, H, D, rot, prescale, st);
  const float* x = static_cast<const float*>(qkv);
  float* o = static_cast<float*>(out);
  return (int)(D == 64 ? launch_f32<64>(x, kh, cos_q, sin_q, vparts, o, B, T, H, rot, prescale, st)
                       : launch_f32<128>(x, kh, cos_q, sin_q, vparts, o, B, T, H, rot, prescale,
                                         st));
}
