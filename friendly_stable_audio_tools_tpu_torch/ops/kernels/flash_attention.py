"""Head-split attention on ``[B*H, T, D]`` tensors: the forward with or
without its base-2 log-sum-exp (K7), the single-pass backward (K8), the
backward the JAX package runs in two passes (K9), their plain versions and
their autograd binding.

Replaces, from friendly_stable_audio_tools_tpu/ops/pallas/flash_attention.py:

* K7 ``_flash_forward`` (:230, call :317) in its non-causal, no-rope case,
  with ``save_stats`` (training) or without (serving):
  ``_single_dot_kernel`` (:121) + ``_single_dot_core`` (:93), what it runs
  for t_k <= 8192;
* K8 ``_flash_backward_fused`` (:426, call :451; ``_bwd_fused_kernel``
  :367), the non-causal single pass that ``_flash_backward`` takes wherever
  its VMEM plan (:406-423, :func:`bwd_fused_plan`) fits;
* K9 ``_flash_backward`` (:565) in its non-causal two-pass case:
  ``_bwd_dq_kernel`` (:477, call :605) and ``_bwd_dkv_kernel`` (:518, call
  :621), with FA2's delta = rowsum(dO * O) computed beside them (:597-603),
  as it is beside K8;
* K7 and K9 with ``causal`` set (`_online_kernel` :146, masked at
  :167-169; `_bwd_dq_kernel` and `_bwd_dkv_kernel` masked at :497-499,
  :537-539), which the audio LM's causal self-attention runs when it
  trains (MusicGen small: B 8 x 16 heads, T 1501, D 64);
* the ``_flash`` custom_vjp (:646-663) becomes :class:`FlashAttention`, whose
  backward :func:`flash_attention_backward` chooses K8 or K9 as the JAX
  package does (:576-579): K9 for every causal call;
* the rope-fused K7, ``_single_dot_rope_kernel`` (:132, from
  ``_flash_forward`` with ``freqs`` :266-285, launched at :317), which
  ``flash_attention(q, k, v, freqs=...)`` runs up to 2048 tokens
  (``_flash_rope`` :747) for a DiT self-attention that the head-pair
  kernels do not take (head dim other than 64, or an odd head count):
  :func:`flash_rope_attention`, a rope pass (csrc/flash_attention_rope.cu)
  and then K7 with a prescale of 1 on the roped operands.

The DiT's self-attention takes this path under grad beyond 1168 tokens
(Stable Audio 2.0: 6145 tokens padded to 6272, kv_len 6145: K9), through
the unpack route of ops/kernels/attention.py. The ADP U-Net's
self-attention (Stable Audio 1.0), wherever the gate of ops/attention.py
sends it (T 4096 and 2048 at D 64, T 1024 at D 80), takes K7 without the
LSE when it serves and :class:`FlashAttention` (K7 with the LSE, then K8:
its plan fits at all three lengths) when it trains. Without grad, the
DiT's self-attention beyond 8192 tokens takes K7 without the LSE too (the
split route of ops/kernels/attention.py). What they compute, per head, in
the input dtype (fp32 on the training paths and through the CLIs, whose
models are fp32; bf16 in bench.py's recipe), with causal calls also masking
key j > query i::

    forward:  q' = q * log2(e)/sqrt(D), s = q' k^T (keys >= kv_len masked),
              p = exp2(s - rowmax(s)), out = (p v) / max(l, 1e-30),
              lse = rowmax(s) + log2(max(l, 1e-30)), l = rowsum(p)
    K8:       qs = q * log2(e)/sqrt(D), s = qs k^T, p = exp2(s - lse),
              ds = p * (dO v^T - delta), dq = (ds k) / sqrt(D),
              dk = (ds^T qs) / log2(e), dv = p^T dO
    K9:       s = (q k^T) * log2(e)/sqrt(D), p = exp2(s - lse), dp = dO v^T,
              ds = p * (dp - delta) / sqrt(D),
              dq = ds k, dk = ds^T q, dv = p^T dO

What bounds them on the H100: compute. At B8 T6272 kv_len 6145 H24 the
forward's two products are 1.86 TFLOP over ~1.2 GB; the function's
backward is five products (4.64 TFLOP), which K8 and K9 do as five where
the TPU's two passes take seven. The products must stay fp32-accurate
(1xTF32 keeps ~3 digits), so every kernel runs them on the tensor cores as
3xTF32 wgmma on TMA-fed tiles (hi = tf32(x), lo = tf32(x - hi); a_lo b_hi +
a_hi b_lo + a_hi b_hi). K7 (csrc/flash_attention.cu) splits K and V^T into
tf32 hi/lo parts in a pre-pass (scratch from :func:`forward_scratch_floats`),
then a producer warp streams their 64-key tiles into a ring and two
consumer warpgroups of 64 q rows run S = q' K^T, an online base-2 softmax
and P.V in turns, each tile's P.V added into fp32 totals; this gives the
TPU kernel's whole-row softmax up to rounding. The TPU's K8 carries dk/dv
across a sequential q grid with K and V resident in VMEM; K8 and K9
(csrc/flash_attention_bwd_f32.cu) are FlashAttention-2's single pass
instead: a block per 64 keys holds their K, V and K^T as tf32 hi/lo tiles,
its warpgroups take the q tiles in turn, and each q tile's dq rows go into
the zeroed dq by bulk reduce-adds, so dq is summed in an order that changes
from run to run (dk and dv are bit-equal between runs). K8 at D 64 is K9's
kernel with K8's constants (q prescaled, ds unscaled, the scale on dq and
dk); at D 80 a kernel of its own with one warpgroup per block. At D 32
(Dance Diffusion's U-Net under grad from 262,144 samples: K8 at T 1024-4096,
K9 at T 8192) K8 and K9 are the D 64 kernel's other template instance, its
dV^T and dK^T products padded to 64 head dims.

The causal kernels skip the key tiles past a q tile's diagonal (and the q
tiles before a key tile's) and mask only the diagonal tile: at T 1501 the
forward computes 300 of a head's 576 tiles.

At head dim 128 (SAO 1.0's config with 12 heads of 128; its DiT under grad
at B 8 x 12 heads, T 1025: K7 with its LSE, then K8) the fp32 K7 and K8 are
csrc/flash_attention_d128.cu: the D 64 designs with one consumer warpgroup
per block, K7 over a ring of two K or V^T tile pairs, K8 over 32 keys per
block, its dV^T and dK^T as two m64 products over the head dims.

The rope-fused K7 (:func:`flash_rope_attention`) computes, per head, what
``_single_dot_rope_kernel`` computes: q and k roped with the fp32 partial
rotary of ``_rope_tables`` (:720; q's tables times log2(e)/sqrt(D) in fp32),
``rope(t) = bf16(t * C + rot_half(bf16(t)) * S)`` (``_apply_rope_tile``
:66; the rounding to bf16 happens for fp32 inputs too), s = q^ k^T in fp32,
p = exp2(s - m), P rounded to v's dtype, out = (P v) / max(l, 1e-30) in the
input dtype. Its rope pass writes q^, k^ and v split into heads; the bf16 K7
(bf16 inputs) or the fp32 K7 (fp32 inputs, whose 3xTF32 score product takes
the bf16 values exactly) runs on them with a prescale of 1.

K7 in bf16 (csrc/flash_attention_bf16.cu) serves bf16 callers without the
LSE: the ADP U-Net in bench.py's bf16 recipe (the same three shapes) and
the DiT's self-attention beyond 8192 tokens in bf16 (Stable Audio 2.0 at 392
s: 8449 tokens padded to 8576, kv_len 8449, through the split route of
ops/kernels/attention.py). It computes what ``_single_dot_kernel`` computes
on bf16 inputs (q prescaled in fp32 and rounded to bf16, scores and the
softmax in fp32, P rounded to bf16 before P.V, the output rounded once) and
what ``_online_kernel`` computes beyond 8192 keys: both are one streaming
loop here, the fp32 K7 likewise. Its products run on the tensor cores as
wgmma on K/V tiles that a producer warpgroup streams in by TMA (the head-pair
forward's design; at head dim 80 each tile is a 64-dim and a 16-dim panel;
the fp32 K7 takes the same design with 3xTF32 products).

The plain versions run for CPU tensors (the CPU tests); CUDA tensors launch
the kernels or raise. The CUDA kernels take q, k and v of one length; K7
fp32 or bf16 (bf16 only without the LSE and not causal), K8 and K9 fp32;
the fp32 K7 and K8 head dim 32, 64, 80 or 128 (32: Dance Diffusion's U-Net
at generate_diffusion_uncond's default length, and under grad from 262,144
samples; 128 not causal), the bf16 K7 64, 80 or 128, K9 32 or 64 (causal:
64), the rope-fused K7 64 or 128. Under grad a head dim that the chosen
backward does not take raises before K7 launches. The other variants of the
TPU kernels (bf16 K7 with its LSE or at D 32 and 96, K9 at D 80-128, other
head dims, rectangular calls, the causal K9 at D 32) are still to be ported
(ROADMAP queue B).
"""

from __future__ import annotations

import math
import typing as tp

import torch

from . import build

# launch counts: each wrapper adds one where it launches its kernel
forward_launches = 0   # K7 with its LSE (training)
serving_launches = 0   # K7 without it (serving)
serving_bf16_launches = 0  # K7 in bf16, without its LSE
backward_launches = 0  # K9
fused_backward_launches = 0  # K8
# the causal kernels, counted apart from the non-causal ones
causal_forward_launches = 0   # causal K7 with its LSE
causal_serving_launches = 0   # causal K7 without it
causal_backward_launches = 0  # causal K9
# the fp32 K7 at head dim 32 (Dance Diffusion's U-Net), counted apart from
# D 64 and 80, with or without its LSE; K8 and K9 at head dim 32 likewise
d32_launches = 0
d32_fused_backward_launches = 0  # K8 at D 32
d32_backward_launches = 0  # K9 at D 32
# the fp32 K7 and K8 at head dim 128 (a DiT with heads of 128 under grad),
# counted apart; the rope-fused K7 (its rope pass and its K7 per call, bf16
# or fp32), whose K7 launches count only here
d128_launches = 0
d128_fused_backward_launches = 0
rope_launches = 0

LOG2E = 1.4426950408889634
# fp32 score bytes one chunk of heads of a plain version may hold (one
# [B*H, T, T] fp32 tensor at B8 H24 T6272 would be 30 GB)
PLAIN_SCORE_BYTES = 1 << 30


def _valid_len(t: int, kv_len: tp.Optional[int]) -> int:
    valid = t if kv_len is None else int(kv_len)
    if not 1 <= valid <= t:
        raise ValueError(f"kv_len {kv_len} outside [1, {t}]")
    return valid


def _head_chunks(bh: int, t_q: int, t_k: int):
    """(h0, h1) ranges of heads whose fp32 scores stay under PLAIN_SCORE_BYTES."""
    step = max(1, PLAIN_SCORE_BYTES // (4 * t_q * t_k))
    return [(h0, min(bh, h0 + step)) for h0 in range(0, bh, step)]


def _masked(s: torch.Tensor, valid: int, causal: bool = False) -> torch.Tensor:
    if valid < s.shape[-1]:
        s[..., valid:] = -math.inf
    if causal:  # key j > query i
        s.masked_fill_(torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu_(1),
                       -math.inf)
    return s


def _check_causal(q: torch.Tensor, k: torch.Tensor, causal: bool) -> None:
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal attention takes as many queries as keys (the JAX package's "
                         f"flash_attention asserts it), got {q.shape[1]} and {k.shape[1]}")


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: tp.Optional[int] = None, save_stats: bool = True,
                        causal: bool = False):
    """K7's plain version: q, k, v [BH, T, D] -> (out [BH, T, D] in q's dtype,
    lse [BH, T] fp32 in base 2, or None without save_stats). q is prescaled
    and rounded to its dtype and P rounded before P.V, as the kernel does."""
    dt = q.dtype
    bh, t, d = q.shape
    valid = _valid_len(k.shape[1], kv_len)
    _check_causal(q, k, causal)
    out = torch.empty_like(q)
    lse = torch.empty(bh, t, device=q.device, dtype=torch.float32) if save_stats else None
    for h0, h1 in _head_chunks(bh, t, k.shape[1]):
        qs = (q[h0:h1].float() * (LOG2E / math.sqrt(d))).to(dt).float()
        s = _masked(qs @ k[h0:h1].float().transpose(-1, -2), valid, causal)
        m = s.amax(-1, keepdim=True)
        p = s.sub_(m).exp2_()
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        out[h0:h1] = ((p.to(dt).float() @ v[h0:h1].float()) / l).to(dt)
        if save_stats:
            lse[h0:h1] = (m + torch.log2(l)).squeeze(-1)
        del s, p
    return out, lse


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                         lse: torch.Tensor, do: torch.Tensor, kv_len: tp.Optional[int] = None,
                         causal: bool = False):
    """K9's formula written out (not a call to autograd, so the tests can hold
    it against autograd): (dq, dk, dv) [BH, T, D] in q's dtype from the
    forward's out and base-2 lse and dL/d(out)."""
    dt = q.dtype
    bh, t, d = q.shape
    valid = _valid_len(k.shape[1], kv_len)
    _check_causal(q, k, causal)
    scale = 1.0 / math.sqrt(d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for h0, h1 in _head_chunks(bh, t, k.shape[1]):
        qf, kf, vf, dof = (x[h0:h1].float() for x in (q, k, v, do))
        delta = (dof * out[h0:h1].float()).sum(-1, keepdim=True)
        s = _masked((qf @ kf.transpose(-1, -2)) * (scale * LOG2E), valid, causal)
        p = s.sub_(lse[h0:h1].float()[..., None]).exp2_()
        ds = (p * (dof @ vf.transpose(-1, -2) - delta) * scale).to(dt).float()
        dq[h0:h1] = (ds @ kf).to(dt)
        dk[h0:h1] = (ds.transpose(-1, -2) @ qf).to(dt)
        dv[h0:h1] = (p.to(dt).float().transpose(-1, -2) @ dof).to(dt)
        del s, p, ds
    return dq, dk, dv


def flash_backward_fused_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                               kv_len: tp.Optional[int] = None):
    """K8's formula in its own order (``_bwd_fused_kernel``): q prescaled by
    log2(e)/sqrt(D) and rounded to its dtype, ds without the scale, the scale
    on dq and dk through qs / log2(e). (dq, dk, dv) [BH, T, D] in q's dtype."""
    dt = q.dtype
    bh, t, d = q.shape
    valid = _valid_len(k.shape[1], kv_len)
    scale = 1.0 / math.sqrt(d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for h0, h1 in _head_chunks(bh, t, k.shape[1]):
        kf, vf, dof = (x[h0:h1].float() for x in (k, v, do))
        qs = (q[h0:h1].float() * (scale * LOG2E)).to(dt).float()
        delta = (dof * out[h0:h1].float()).sum(-1, keepdim=True)
        s = _masked(qs @ kf.transpose(-1, -2), valid)
        p = s.sub_(lse[h0:h1].float()[..., None]).exp2_()
        ds = (p * (dof @ vf.transpose(-1, -2) - delta)).to(dt).float()
        dq[h0:h1] = ((ds @ kf) * scale).to(dt)
        dk[h0:h1] = ((ds.transpose(-1, -2) @ qs) * (1.0 / LOG2E)).to(dt)
        dv[h0:h1] = (p.to(dt).float().transpose(-1, -2) @ dof).to(dt)
        del s, p, ds
    return dq, dk, dv


def bwd_fused_fits(bq: int, t_kp: int, d: int) -> bool:
    """K8's VMEM budget (flash_attention.py:406): score, dp, p and ds tiles
    plus resident K/V, fp32 dk/dv accumulators and the q-side tiles."""
    tiles = bq * t_kp * 12
    resid = 3 * t_kp * d * 2 + 2 * t_kp * d * 4 + 3 * bq * d * 4
    return tiles + resid <= 12 * 2**20


def bwd_fused_plan(t_q: int, t_kp: int, d: int):
    """K8's plan (flash_attention.py:414): (16-aligned t_q, q block) or None."""
    t_qp = (t_q + 15) // 16 * 16
    for n_q in range(1, 65):
        blk, rem = divmod(t_qp, n_q)
        if rem == 0 and blk % 8 == 0 and bwd_fused_fits(blk, t_kp, d):
            return t_qp, blk
    return None


def backward_kernel(t_q: int, t_k: int, d: int, causal: bool = False) -> str:
    """The backward the JAX package runs (flash_attention.py:576-579): for a
    non-causal call "K8" where its plan fits, else "K9"; "K9" for every
    causal call."""
    if causal:
        return "K9"
    return "K8" if bwd_fused_plan(t_q, (t_k + 15) // 16 * 16, d) is not None else "K9"


FLASH_HEAD_DIMS = (32, 64, 80, 128)  # the fp32 K7's CUDA kernels
BF16_HEAD_DIMS = (64, 80, 128)  # the bf16 K7's
FUSED_BACKWARD_HEAD_DIMS = (32, 64, 80, 128)  # K8's
ROPE_HEAD_DIMS = (64, 128)  # the rope-fused K7's
BACKWARD_HEAD_DIMS = (32, 64)  # K9's
CAUSAL_BACKWARD_HEAD_DIMS = (64,)  # the causal K9's


def _cuda_args(name: str, *tensors: torch.Tensor, head_dims=BACKWARD_HEAD_DIMS,
               dtype=torch.float32):
    """Checks what the kernels take; returns the tensors made contiguous."""
    q = tensors[0]
    bh, t, d = q.shape if q.dim() == 3 else (0, 0, 0)
    if d not in head_dims:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes head dim {' or '.join(map(str, head_dims))}, got {d}; "
            f"the others are still to be ported (ROADMAP queue B)")
    for x in tensors:
        if x.dtype != dtype or x.device != q.device:
            raise ValueError(f"{name}: the CUDA kernel takes {dtype} tensors on one device, got "
                             f"{x.dtype} on {x.device}")
        if tuple(x.shape) != (bh, t, d):
            raise ValueError(f"{name}: the CUDA kernel takes [B*H, T, D] tensors of one shape, got "
                             f"{tuple(x.shape)} and {tuple(q.shape)}")
    if not 1 <= bh <= 65535:
        raise ValueError(f"{name}: B*H = {bh} outside the kernel's grid [1, 65535]")
    out = [x.contiguous() for x in tensors]
    if any(x.data_ptr() % 16 for x in out):
        raise ValueError(f"{name}: the CUDA kernel reads 16-byte aligned tensors")
    return out


def _lse_delta(name: str, lse: torch.Tensor, out: torch.Tensor, do: torch.Tensor):
    """Checks the LSE; returns it contiguous and FA2's delta = rowsum(dO * O),
    computed once beside the backward kernels (as the JAX package computes it
    in XLA, flash_attention.py:597-603)."""
    bh, t, _ = out.shape
    if lse.shape != (bh, t) or lse.dtype != torch.float32 or lse.device != out.device:
        raise ValueError(f"{name}: lse must be [B*H, T] fp32 on {out.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    return lse.contiguous(), (do * out).sum(-1)


def forward_scratch_floats(bh: int, t: int, d: int) -> int:
    """fp32 K7's scratch (csrc/flash_attention.cu, flash_attention_d128.cu):
    the pre-pass's tf32 hi/lo parts of K [2, BH, T, D] and of V^T [2, BH, D,
    Tp], Tp = T rounded up to the 64-key tile."""
    tp = (t + 63) // 64 * 64
    return 2 * bh * t * d + 2 * bh * d * tp


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse, valid: int,
                    causal: bool, prescale: float) -> torch.Tensor:
    """The fp32 K7 on checked contiguous inputs: out [BH, T, D], the LSE into
    `lse` where it is not None."""
    bh, t, d = q.shape
    out = torch.empty_like(q)
    scratch = torch.empty(forward_scratch_floats(bh, t, d), device=q.device, dtype=torch.float32)
    lse_ptr = None if lse is None else lse.data_ptr()
    if d == 128:
        err = build.library().fsat_flash_forward_d128(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, scratch.data_ptr(),
            bh, t, valid, prescale, _stream(q.device))
    else:
        err = build.library().fsat_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, scratch.data_ptr(),
            bh, t, valid, d, int(causal), prescale, _stream(q.device))
    build.check(err, "flash_forward")
    return out


def _launch_forward_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: int,
                         prescale: float) -> torch.Tensor:
    """The bf16 K7 on checked contiguous inputs: out [BH, T, D]."""
    bh, t, d = q.shape
    out = torch.empty_like(q)
    err = build.library().fsat_flash_forward_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, t, valid, d, prescale,
        _stream(q.device))
    build.check(err, "flash_forward")
    return out


def _flash_forward_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: int,
                        save_stats: bool, causal: bool) -> torch.Tensor:
    """K7 in bf16 on CUDA tensors: the output alone (serving)."""
    global serving_bf16_launches
    if save_stats or causal:
        raise NotImplementedError(
            "flash_forward: the bf16 CUDA kernel serves non-causal calls without the LSE; bf16 "
            "K7 with its LSE (a bf16 training step) and causal bf16 K7 are still to be ported "
            "(ROADMAP queue B)")
    q, k, v = _cuda_args("flash_forward", q, k, v, head_dims=BF16_HEAD_DIMS,
                         dtype=torch.bfloat16)
    out = _launch_forward_bf16(q, k, v, valid, LOG2E / math.sqrt(q.shape[2]))
    serving_bf16_launches += 1
    return out


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: tp.Optional[int] = None, save_stats: bool = True,
                  causal: bool = False):
    """K7: q, k, v [BH, T, D] -> (out [BH, T, D], lse [BH, T] fp32 or None);
    without save_stats (serving) no LSE is written; causal masks key j >
    query i. On CUDA, fp32 runs the fp32 kernel and bf16 the bf16 one
    (serving only); another dtype raises."""
    global forward_launches, serving_launches, causal_forward_launches, causal_serving_launches
    global d32_launches, d128_launches
    valid = _valid_len(k.shape[1], kv_len)
    _check_causal(q, k, causal)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, kv_len, save_stats, causal)
    if q.dtype == torch.bfloat16:
        return _flash_forward_bf16(q, k, v, valid, save_stats, causal), None
    q, k, v = _cuda_args("flash_forward", q, k, v, head_dims=FLASH_HEAD_DIMS)
    bh, t, d = q.shape
    if d == 128 and causal:
        raise NotImplementedError("flash_forward: the causal fp32 K7 at head dim 128 is still to "
                                  "be ported (ROADMAP queue B)")
    lse = torch.empty(bh, t, device=q.device, dtype=torch.float32) if save_stats else None
    out = _launch_forward(q, k, v, lse, valid, causal, LOG2E / math.sqrt(d))
    if d == 32:
        d32_launches += 1
    elif d == 128:
        d128_launches += 1
    elif causal and save_stats:
        causal_forward_launches += 1
    elif causal:
        causal_serving_launches += 1
    elif save_stats:
        forward_launches += 1
    else:
        serving_launches += 1
    return out, lse


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor, kv_len: tp.Optional[int] = None,
                   causal: bool = False):
    """K9: (dq, dk, dv) [BH, T, D] (D 32 or 64; causal: 64) from q, k, v,
    K7's out and lse, and dL/d(out), in one launch; causal for the backward
    of a causal K7."""
    global backward_launches, causal_backward_launches, d32_backward_launches
    valid = _valid_len(k.shape[1], kv_len)
    _check_causal(q, k, causal)
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, out, lse, do, kv_len, causal)
    q, k, v, out, do = _cuda_args("flash_backward", q, k, v, out, do, head_dims=(
        CAUSAL_BACKWARD_HEAD_DIMS if causal else BACKWARD_HEAD_DIMS))
    bh, t, d = q.shape
    lse, delta = _lse_delta("flash_backward", lse, out, do)
    dq = torch.zeros_like(q)  # the key blocks add their parts into it
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = build.library().fsat_flash_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, t, valid, d,
        int(causal), LOG2E / math.sqrt(d), 1.0 / math.sqrt(d), _stream(q.device))
    build.check(err, "flash_backward")
    if causal:
        causal_backward_launches += 1
    elif d == 32:
        d32_backward_launches += 1
    else:
        backward_launches += 1
    return dq, dk, dv


def flash_backward_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                         lse: torch.Tensor, do: torch.Tensor, kv_len: tp.Optional[int] = None):
    """K8: (dq, dk, dv) [BH, T, D] (D 32, 64, 80 or 128) from q, k, v, K7's
    out and lse, and dL/d(out), in one launch."""
    global fused_backward_launches, d32_fused_backward_launches, d128_fused_backward_launches
    valid = _valid_len(k.shape[1], kv_len)
    if q.device.type == "cpu":
        return flash_backward_fused_plain(q, k, v, out, lse, do, kv_len)
    q, k, v, out, do = _cuda_args("flash_backward_fused", q, k, v, out, do,
                                  head_dims=FUSED_BACKWARD_HEAD_DIMS)
    bh, t, d = q.shape
    lse, delta = _lse_delta("flash_backward_fused", lse, out, do)
    dq = torch.zeros_like(q)  # the key tiles add their parts into it
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, t, valid)
    if d == 128:
        err = build.library().fsat_flash_backward_fused_d128(
            *ptrs, LOG2E / math.sqrt(d), 1.0 / math.sqrt(d), _stream(q.device))
    else:
        err = build.library().fsat_flash_backward_fused(
            *ptrs, d, LOG2E / math.sqrt(d), 1.0 / math.sqrt(d), _stream(q.device))
    build.check(err, "flash_backward_fused")
    if d == 32:
        d32_fused_backward_launches += 1
    elif d == 128:
        d128_fused_backward_launches += 1
    else:
        fused_backward_launches += 1
    return dq, dk, dv


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             kv_len: tp.Optional[int] = None, causal: bool = False):
    """The backward of the training path as the JAX package chooses it
    (``_flash_backward``, flash_attention.py:576-579): K8 where its plan
    fits, else K9, and the causal K9 for a causal call (each its plain
    version for CPU tensors)."""
    if causal:
        return flash_backward(q, k, v, out, lse, do, kv_len, causal=True)
    if backward_kernel(q.shape[1], k.shape[1], q.shape[2]) == "K8":
        return flash_backward_fused(q, k, v, out, lse, do, kv_len)
    return flash_backward(q, k, v, out, lse, do, kv_len)


def check_backward_head_dim(t_q: int, t_k: int, d: int, causal: bool = False) -> None:
    """Raises, naming ROADMAP queue B, where the backward that
    :func:`flash_attention_backward` would choose on CUDA tensors has no
    kernel at head dim d (K8 takes 32, 64, 80 and 128, K9 32 and 64, the
    causal K9 64): a training call at another head dim stops here, before
    its forward launches anything."""
    kernel = backward_kernel(t_q, t_k, d, causal)
    dims = (FUSED_BACKWARD_HEAD_DIMS if kernel == "K8" else
            CAUSAL_BACKWARD_HEAD_DIMS if causal else BACKWARD_HEAD_DIMS)
    if d not in dims:
        raise NotImplementedError(
            f"flash attention under grad: the {'causal ' if causal else ''}backward {kernel} "
            f"takes head dim {' or '.join(map(str, dims))} on the card, got {d}; {kernel} at "
            f"head dim {d} is still to be ported (ROADMAP queue B)")


class FlashAttention(torch.autograd.Function):
    """K7 with its LSE forward, K8 or K9 backward (the ``_flash`` custom_vjp)
    on q, k, v [BH, T, D]; kv_len and causal take no gradient. On CUDA
    tensors a head dim that the backward's kernel does not take raises before
    the forward launches (:func:`check_backward_head_dim`)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len=None, causal=False):
        if q.device.type != "cpu":
            check_backward_head_dim(q.shape[1], k.shape[1], q.shape[2], causal)
        if causal:
            out, lse = flash_forward(q, k, v, kv_len, save_stats=True, causal=True)
        else:
            out, lse = flash_forward(q, k, v, kv_len, save_stats=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kv_len, ctx.causal = kv_len, causal
        return out

    @staticmethod
    def backward(ctx, grad_out):
        grads = flash_attention_backward(*ctx.saved_tensors, grad_out, ctx.kv_len, ctx.causal)
        return (*grads, None, None)


def rope_tables(freqs: torch.Tensor, t: int, prescale: float):
    """The rope-fused K7's tables (``_rope_tables``, flash_attention.py:720, and
    the q prescale of :274-278): cos and sin of the last t rows of freqs [T',
    rot] in fp32, and the pair for q times `prescale` in fp32 -> (cos_q,
    sin_q, cos_k, sin_k), each [t, rot] contiguous. The dims past rot (cos 1,
    sin 0 in the TPU's padded tables) are the kernel's and the plain version's
    own: q times prescale, k as it is."""
    f = freqs[-t:].float()
    cos_k, sin_k = torch.cos(f).contiguous(), torch.sin(f).contiguous()
    return (cos_k * prescale).contiguous(), (sin_k * prescale).contiguous(), cos_k, sin_k


def rope_heads_plain(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int):
    """The rope pass's plain version: qkv [B, T, 3*H*D] -> (q^, k^, v) [B*H, T,
    D] in qkv's dtype, q^ and k^ as ``_apply_rope_tile`` (flash_attention.py:66)
    forms them: rope(t) = bf16(t * C + rot_half(bf16(t)) * S) in fp32, q's
    tables times log2(e)/sqrt(D); v split into heads."""
    dt = qkv.dtype
    b, t, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    rot = freqs.shape[-1]
    half = rot // 2
    prescale = LOG2E / math.sqrt(d)
    cos_q, sin_q, cos_k, sin_k = rope_tables(freqs, t, prescale)
    q, k, v = qkv.reshape(b, t, 3, num_heads, d).permute(2, 0, 3, 1, 4)

    def rope(x, c, s, rest):
        xf = x.float()
        xb = xf[..., :rot].to(torch.bfloat16).float()
        partner = torch.cat([-xb[..., half:], xb[..., :half]], dim=-1)
        head = xf[..., :rot] * c + partner * s
        tail = xf[..., rot:] * prescale if rest else xf[..., rot:]
        return torch.cat([head, tail], dim=-1).to(torch.bfloat16).to(dt)

    q = rope(q, cos_q, sin_q, True)
    k = rope(k, cos_k, sin_k, False)
    return tuple(x.reshape(b * num_heads, t, d) for x in (q, k, v))


def merge_heads(x: torch.Tensor, b: int, num_heads: int) -> torch.Tensor:
    """[B*H, T, D] -> [B, T, H*D]."""
    _, t, d = x.shape
    return x.view(b, num_heads, t, d).transpose(1, 2).reshape(b, t, num_heads * d)


def flash_rope_attention_plain(qkv: torch.Tensor, freqs: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """The rope-fused K7's plain version: the rope pass's plain version, then
    a whole-row base-2 softmax of q^ k^T in fp32, P rounded to v's dtype,
    (P v) / max(l, 1e-30) in qkv's dtype -> [B, T, H*D]."""
    dt = qkv.dtype
    q, k, v = rope_heads_plain(qkv, freqs, num_heads)
    bh, t, _ = q.shape
    out = torch.empty_like(q)
    for h0, h1 in _head_chunks(bh, t, t):
        s = q[h0:h1].float() @ k[h0:h1].float().transpose(-1, -2)
        p = s.sub_(s.amax(-1, keepdim=True)).exp2_()
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        out[h0:h1] = ((p.to(dt).float() @ v[h0:h1].float()) / l).to(dt)
        del s, p
    return merge_heads(out, qkv.shape[0], num_heads)


def flash_rope_attention(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The rope-fused K7: non-causal self-attention of qkv [B, T, 3*H*D] (q | k
    | v, bf16 or fp32) with the partial rotary of freqs [T' >= T, rot] (last T
    rows) -> [B, T, H*D] in qkv's dtype. On CUDA: the rope pass
    (csrc/flash_attention_rope.cu), then the bf16 or fp32 K7 with a prescale
    of 1 on its [B*H, T, D] operands (head dim 64 or 128; another raises)."""
    global rope_launches
    if qkv.device.type == "cpu":
        return flash_rope_attention_plain(qkv, freqs, num_heads)
    b, t, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    rot = freqs.shape[-1]
    if d not in ROPE_HEAD_DIMS or three_hd != 3 * num_heads * d:
        raise NotImplementedError(
            f"flash_rope_attention: the CUDA kernels take head dim "
            f"{' or '.join(map(str, ROPE_HEAD_DIMS))}, got qkv {tuple(qkv.shape)} with "
            f"{num_heads} heads; the others are still to be ported (ROADMAP queue B)")
    if qkv.dtype not in (torch.float32, torch.bfloat16) or rot % 2 or rot > d:
        raise ValueError(f"flash_rope_attention: the CUDA kernels take fp32 or bf16 and an even "
                         f"rot <= D, got {qkv.dtype} and rot {rot}")
    if freqs.device != qkv.device or freqs.shape[0] < t:
        raise ValueError(f"flash_rope_attention: freqs must be [>= T, rot] on {qkv.device}, got "
                         f"{tuple(freqs.shape)} on {freqs.device}")
    bh = b * num_heads
    if not 1 <= bh <= 65535:
        raise ValueError(f"flash_rope_attention: B*H = {bh} outside the kernel's grid [1, 65535]")
    x = qkv.contiguous()
    tables = rope_tables(freqs, t, LOG2E / math.sqrt(d))
    q, k, v = (torch.empty(bh, t, d, device=x.device, dtype=x.dtype) for _ in range(3))
    err = build.library().fsat_rope_heads(
        x.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), *(c.data_ptr() for c in tables),
        b, t, num_heads, d, rot, LOG2E / math.sqrt(d), int(x.dtype == torch.bfloat16),
        _stream(x.device))
    build.check(err, "flash_rope_attention")
    if x.dtype == torch.bfloat16:
        out = _launch_forward_bf16(q, k, v, t, 1.0)
    else:
        out = _launch_forward(q, k, v, None, t, False, 1.0)
    rope_launches += 1
    return merge_heads(out, b, num_heads)
