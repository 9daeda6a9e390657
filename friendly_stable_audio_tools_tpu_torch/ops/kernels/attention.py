"""Fused qkv + rotary + self-attention: inference forward (K1), its
long-sequence form (K10a + K10), training forward with LSE (K5) and
backward (K6), and their autograd binding.

Replaces the head-pair Pallas kernels of the DiT's self-attention
(friendly_stable_audio_tools_tpu/ops/pallas/flash_attention.py):

* K1 ``_fused_pair_forward`` / ``_fused_pair_kernel`` (:828, :796);
* K10a ``_rope_pair_k_kernel`` (:1229, called at :1281) and K10
  ``_pair_long_kernel`` (:1233, called at :1297), the two calls of
  ``_pair_long_forward`` (:1255);
* K5 ``_fused_pair_forward_stats`` / ``_fused_pair_stats_kernel`` (:980, :931);
* K6 ``_pair_backward`` (:1119) with ``_rope_pair_k_kernel`` (:1229) and
  ``_pair_bwd_kernel`` (:1029);
* the ``_fused_pair`` custom_vjp (:1336-1392) becomes
  :class:`FusedQKVRopeAttention` (its pair path) and
  :class:`FusedQKVFlashAttention` (its unpack path).

Routing without grad follows flash_attention.py:1413-1452
(:func:`attention_route`), by the head dim and count as well as the length:
heads of 64 in an even count take the head-pair kernels, up to 2048 tokens
K1; up to 8192 (Stable Audio 2.0's 6145 tokens, padded to 6272) K10a then
K10; any other heads take the rope-fused K7 up to 2048 tokens
(:func:`flash_attention.flash_rope_attention`: SAO 1.0's config with 12
heads of 128), and run at their true length where kv_len is below T, the
output padded back (:1423-1428). Beyond that (Stable Audio
2.0 past ~380 s: 8449 tokens at 392 s, padded to 8576) the split route of
:func:`fused_qkv_rope_attention_split`: heads split, q and k roped outside
any kernel in the input dtype, K7 without its LSE on ``[B*H, T, D]`` with
kv_len (fp32 or bf16 by the input dtype; ops/kernels/flash_attention.py),
heads merged. That is the JAX package's path there: its transformer sends a
padded T > 8192 to the split path (rope outside, then
``scaled_dot_product_attention(..., kv_len)``; JAX models/transformer.py:
199-201, 234-236) and an unpadded one to ``flash_attention(freqs=...)``,
which ropes outside beyond 2048 tokens (flash_attention.py:693-698); both
reach ``_flash_forward`` with t_k > 8192, whose ``_online_kernel`` K7's
streaming loop computes. Under
grad the route is the reference's (:func:`training_route`, after
``_pair_bwd_eligible`` :1204): lengths whose pair backward plan fits
(T <= 1168 at head dim 64) take K5/K6 (:class:`FusedQKVRopeAttention`);
longer ones the unpack branch of ``_fused_pair_fwd``/``_fused_pair_bwd``
(:1351-1389, :class:`FusedQKVFlashAttention`): heads split, q and k roped
outside any kernel in the input dtype, K7 with its LSE and K9 (or K8 where
its plan fits) from ops/kernels/flash_attention.py, in the input dtype: fp32
on the training path, where the pair route casts to bf16. Every other head
dim or count takes the unpack branch at every length (``_flash_rope_fwd``
:751 and ``_flash_rope_bwd`` :760 up to 2048 tokens: the same functions):
SAO 1.0's config with 12 heads of 128 runs K7 with its LSE and K8 at head
dim 128.

What it computes: non-causal attention of a fused ``[B, T, 3*H*D]`` qkv
tensor with the fp32 partial rotary embedding of
``flash_attention.py:_rope_tables`` (:720) applied to q and k, q prescaled by
``log2(e)/sqrt(D)`` so the softmax runs in base 2, keys at or beyond
``kv_len`` masked, output ``[B, T, H*D]``. q and k are rounded to the input
dtype after the rope and before the score product, P to the input dtype
before P.V; scores, softmax and accumulation are fp32. K5 also returns the
base-2 log-sum-exp ``lse [B, H, T]`` of the prescaled scores. K6 computes,
per head, with ``q^``/``k^`` the rounded roped operands and
``delta = rowsum(dO * O)``::

    s = q^ k^T, p = exp2(s - lse), dp = dO v^T, ds = round(p * (dp - delta))
    dq = unrope(ds k^) / sqrt(D), dk = unrope(ds^T q^) / log2(e), dv = round(p)^T dO

What bounds them on the H100: at the SAO shapes each call is tens of GFLOP
of score and P.V products over a few MB of input, so they are bound by
tensor-core work and by how much of it the softmax's serial dependence
leaves idle; K10 at B2 T6272 kv_len 6145 H24 is ~464 GFLOP (~0.47 ms at
989 TFLOP/s). K1, K5 and K10 are one kernel (csrc/attention.cu): K10a
(csrc/attention_rope.cu, memory bound) ropes K once per call into a bf16
``khat [B, T, H*D]``; the kernel ropes its q tile once, streams K/V tiles
by TMA into an mbarrier-guarded ring, and runs both products on wgmma with
S, P and O in registers, so the T x T score matrix never exists in device
memory and ragged tiles are masked in-kernel. K6 (csrc/attention_bwd.cu)
reads q^ and k^ from K10a and, after a small pass for delta = rowsum(dO*O),
makes one pass per 128-key block, dK and dV in wgmma accumulators, q^/dO
tiles streamed by TMA, dq summed in an fp32 scratch by bulk reduce-adds and
unroped once by a last small pass (its order of summation, and so its last
bits, change from run to run). The TPU
kernels hold a head pair's whole K or dk/dv in VMEM; a Hopper block's 227 KB
cannot, hence the streaming loops.

The plain versions below run for CPU tensors (the CPU tests); CUDA tensors
launch the kernels or raise. The pair kernels take bf16. Without grad, the
inference entry points (:func:`fused_qkv_rope_attention`,
:func:`fused_qkv_rope_attention_long`) cast an fp32 qkv to bf16 on the way
into K1 or K10a/K10 and the output back to fp32 (:func:`kernel_input`), as
the JAX functions do (flash_attention.py:851-853, :1262-1264, :1314); on
the CPU they compute in the input dtype, as the JAX package's CPU path
(XLA, :784) does. Under grad, the pair kernels' autograd binding casts an
fp32 qkv to bf16 and its gradient back, where the JAX pair training path
casts (flash_attention.py:990-992, 1128); the unpack route keeps the input
dtype, as the JAX one does.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from .. import attention as gate
from ..embeddings import apply_rotary_pos_emb, apply_rotary_pos_emb_transpose
from . import build
from . import flash_attention as flash

# launch counts: each wrapper adds one where it launches its kernel
launches = 0  # K1
rope_k_launches = 0  # K10a
long_launches = 0  # K10
stats_launches = 0  # K5
backward_launches = 0  # K6 (its delta, key-block and dq passes per count)

LOG2E = 1.4426950408889634
PAIR_MAX_T = 2048  # K1's limit (flash_attention.py:1413)
LONG_MAX_T = 8192  # K10's limit (SINGLE_DOT_MAX_TK, flash_attention.py:55)
# fp32 score bytes one chunk of heads of the long plain version may hold
LONG_PLAIN_SCORE_BYTES = 1 << 30


def kernel_input(qkv: torch.Tensor) -> torch.Tensor:
    """What K1 and K10a/K10 read: qkv in bf16 (the JAX kernels cast an fp32
    qkv to bf16 inside and return the input dtype)."""
    return qkv.to(torch.bfloat16)


def pair_heads(head_dim: int, num_heads: int) -> bool:
    """Whether the head-pair kernels take these heads (flash_attention.py:1413,
    :1418): head dim 64 in an even count."""
    return head_dim == 64 and num_heads % 2 == 0


def attention_route(t: int, head_dim: int = 64, num_heads: int = 2) -> str:
    """The inference kernel for a self-attention of t tokens, as the JAX
    package routes it (flash_attention.py:1413-1452): heads of 64 in an even
    count "pair" (K1) for t <= 2048, "pair_long" (K10a + K10) for t <= 8192;
    other heads "rope_flash" (the rope-fused K7) for t <= 2048; else "flash"
    (heads split, rope outside, K7 without its LSE:
    :func:`fused_qkv_rope_attention_split`)."""
    if pair_heads(head_dim, num_heads):
        if t <= PAIR_MAX_T:
            return "pair"
        if t <= LONG_MAX_T:
            return "pair_long"
        return "flash"
    return "rope_flash" if t <= PAIR_MAX_T else "flash"


def pair_whole_tile(t: int) -> tp.Optional[int]:
    """The pair kernels' 16-aligned length when its score tile fits the
    TPU's VMEM, else None (flash_attention.py:971)."""
    t16 = (t + 15) // 16 * 16
    return t16 if t16 * t16 * 6 <= 8 * 2**20 else None


def pair_bwd_plan(t_p: int, d: int) -> tp.Optional[int]:
    """The pair backward's q block, or None (flash_attention.py:1102)."""
    for n_q in range(1, 65):
        blk, rem = divmod(t_p, n_q)
        if rem == 0 and blk % 8 == 0:
            tiles = blk * t_p * 12
            resid = 3 * t_p * 2 * d * 2 + 2 * t_p * 2 * d * 4 + 4 * blk * 2 * d * 4
            if tiles + resid <= 12 * 2**20:
                return blk
    return None


def training_route(t: int, head_dim: int, num_heads: int) -> str:
    """The route under grad for a sequence of t tokens, as the JAX package
    chooses it (``_pair_bwd_eligible``, flash_attention.py:1204): "pair"
    (K5/K6) where the pair backward fits, else "flash" (the unpack branch,
    K7 + K9)."""
    if not pair_heads(head_dim, num_heads):
        return "flash"
    t_p = pair_whole_tile(t)
    return "pair" if t_p is not None and pair_bwd_plan(t_p, head_dim) is not None else "flash"


def _valid_len(t: int, kv_len: tp.Optional[int]) -> int:
    valid = t if kv_len is None else int(kv_len)
    if not 1 <= valid <= t:
        raise ValueError(f"kv_len {kv_len} outside [1, {t}]")
    return valid


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*D] -> [B, H, T, D] in fp32."""
    b, t, hd = x.shape
    return x.float().view(b, t, num_heads, hd // num_heads).transpose(1, 2)


def _roped_operands(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int):
    """(q^, k^, v) [B, H, T, D] in fp32: roped q prescaled by log2(e)/sqrt(D)
    and roped k, both rounded to the input dtype, as the kernels form them."""
    dt = qkv.dtype
    b, t, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    q, k, v = qkv.float().view(b, t, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q = (apply_rotary_pos_emb(q, freqs) * (LOG2E / math.sqrt(d))).to(dt).float()
    k = apply_rotary_pos_emb(k, freqs).to(dt).float()
    return q, k, v


def _masked_scores(q: torch.Tensor, k: torch.Tensor, valid: int) -> torch.Tensor:
    s = q @ k.transpose(-1, -2)
    if valid < s.shape[-1]:
        s[..., valid:] = -math.inf
    return s


def fused_qkv_rope_attention_stats_plain(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int,
                                         kv_len: tp.Optional[int] = None):
    """-> (out [B, T, H*D] in qkv's dtype, lse [B, H, T] fp32, base 2)."""
    dt = qkv.dtype
    b, t, _ = qkv.shape
    q, k, v = _roped_operands(qkv, freqs, num_heads)
    s = _masked_scores(q, k, _valid_len(t, kv_len))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(dt).float() @ v) / l
    out = o.transpose(1, 2).reshape(b, t, -1).to(dt)
    return out, (m + torch.log2(l)).squeeze(-1)


def fused_qkv_rope_attention_plain(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int,
                                   kv_len: tp.Optional[int] = None) -> torch.Tensor:
    return fused_qkv_rope_attention_stats_plain(qkv, freqs, num_heads, kv_len)[0]


def fused_qkv_rope_attention_backward_plain(qkv: torch.Tensor, out: torch.Tensor,
                                            lse: torch.Tensor, grad_out: torch.Tensor,
                                            freqs: torch.Tensor, num_heads: int,
                                            kv_len: tp.Optional[int] = None,
                                            dtype: tp.Optional[torch.dtype] = None) -> torch.Tensor:
    """The K6 formula written out (not a call to autograd, so the tests can
    hold it against autograd): dqkv [B, T, 3*H*D] in `dtype` (default qkv's)."""
    dt = qkv.dtype
    b, t, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    q, k, v = _roped_operands(qkv, freqs, num_heads)
    p = torch.exp2(_masked_scores(q, k, _valid_len(t, kv_len)) - lse.float()[..., None])
    do = _heads(grad_out.to(dt), num_heads)
    delta = (do * _heads(out.to(dt), num_heads)).sum(-1, keepdim=True)
    ds = (p * (do @ v.transpose(-1, -2) - delta)).to(dt).float()
    dq = apply_rotary_pos_emb_transpose(ds @ k, freqs) / math.sqrt(d)
    dk = apply_rotary_pos_emb_transpose(ds.transpose(-1, -2) @ q, freqs) / LOG2E
    dv = p.to(dt).float().transpose(-1, -2) @ do

    def merge(x):
        return x.transpose(1, 2).reshape(b, t, num_heads * d)

    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(dtype or dt)


def rope_pair_k_plain(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K10a's plain version: k of qkv [B, T, 3*H*D] roped in fp32 (last T rows
    of freqs) and rounded to qkv's dtype -> [B, T, H*D]."""
    b, t, three_hd = qkv.shape
    hd = three_hd // 3
    k = _heads(qkv[..., hd:2 * hd], num_heads)
    return apply_rotary_pos_emb(k, freqs).transpose(1, 2).reshape(b, t, hd).to(qkv.dtype)


def rope_pair_q_plain(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K10a's plain version for q (what K6 reads): q of qkv roped in fp32,
    prescaled by log2(e)/sqrt(D) and rounded to qkv's dtype -> [B, T, H*D]."""
    b, t, three_hd = qkv.shape
    hd = three_hd // 3
    q = _heads(qkv[..., :hd], num_heads)
    q = apply_rotary_pos_emb(q, freqs) * (LOG2E / math.sqrt(hd // num_heads))
    return q.transpose(1, 2).reshape(b, t, hd).to(qkv.dtype)


def pair_long_attention_plain(qkv: torch.Tensor, khat: torch.Tensor, freqs: torch.Tensor,
                              num_heads: int, kv_len: tp.Optional[int] = None) -> torch.Tensor:
    """K10's plain version: q of qkv roped and prescaled by log2(e)/sqrt(D),
    rounded to qkv's dtype, a whole-sequence base-2 softmax over the pre-roped
    khat [B, T, H*D] (keys at or beyond kv_len masked), P rounded before P.V
    -> [B, T, H*D] in qkv's dtype. Heads go in chunks whose fp32 scores stay
    under LONG_PLAIN_SCORE_BYTES (one layer's at B2 T6272 H24 would be 7.6 GB)."""
    dt = qkv.dtype
    b, t, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // num_heads
    valid = _valid_len(t, kv_len)
    chunk = max(1, LONG_PLAIN_SCORE_BYTES // (4 * b * t * t))
    out = torch.empty(b, num_heads, t, d, device=qkv.device, dtype=dt)
    for h0 in range(0, num_heads, chunk):
        h1 = min(num_heads, h0 + chunk)
        q = _heads(qkv[..., h0 * d:h1 * d], h1 - h0)
        q = (apply_rotary_pos_emb(q, freqs) * (LOG2E / math.sqrt(d))).to(dt).float()
        k = _heads(khat[..., h0 * d:h1 * d].to(dt), h1 - h0)
        v = _heads(qkv[..., 2 * hd + h0 * d:2 * hd + h1 * d], h1 - h0)
        s = _masked_scores(q, k, valid)
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        del s
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        out[:, h0:h1] = ((p.to(dt).float() @ v) / l).to(dt)
        del p
    return out.transpose(1, 2).reshape(b, t, hd)


def fused_qkv_rope_attention_long_plain(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int,
                                        kv_len: tp.Optional[int] = None) -> torch.Tensor:
    """The long path in plain PyTorch: K10a's then K10's plain version."""
    return pair_long_attention_plain(qkv, rope_pair_k_plain(qkv, freqs, num_heads), freqs,
                                     num_heads, kv_len)


def _cuda_inputs(name: str, qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int):
    """Checks what the kernels take; returns (d, rot, cos, sin)."""
    d = qkv.shape[-1] // (3 * num_heads)
    rot = freqs.shape[-1]
    if qkv.dtype != torch.bfloat16 or d != 64 or rot % 2 or rot > d:
        raise ValueError(f"{name}: the CUDA kernel takes bf16, head dim 64 and an even rot <= 64, "
                         f"got {qkv.dtype}, D = {d}, rot = {rot}")
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * num_heads * d or freqs.shape[0] < qkv.shape[1]:
        raise ValueError(f"{name}: qkv must be [B, T, 3*H*64] and freqs [>= T, rot], got "
                         f"{tuple(qkv.shape)} with H = {num_heads} and {tuple(freqs.shape)}")
    if freqs.device != qkv.device:
        raise ValueError(f"{name}: freqs must be on the qkv device")
    f = freqs[-qkv.shape[1]:].float()
    return d, rot, torch.cos(f).contiguous(), torch.sin(f).contiguous()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _rope_launch(qkv, cos, sin, num_heads, part: int, scale: float) -> torch.Tensor:
    """K10a on a checked contiguous bf16 qkv: the roped third `part` (0 q, 1 k)
    times `scale` -> [B, T, H*64]."""
    global rope_k_launches
    b, t, three_hd = qkv.shape
    dst = torch.empty(b, t, three_hd // 3, device=qkv.device, dtype=qkv.dtype)
    err = build.library().fsat_rope_pair(qkv.data_ptr(), part, cos.data_ptr(), sin.data_ptr(),
                                         dst.data_ptr(), b, t, num_heads, cos.shape[-1], scale,
                                         _stream(qkv.device))
    build.check(err, "rope_pair")
    rope_k_launches += 1
    return dst


def _attention_launch(name, qkv, khat, cos, sin, num_heads, valid, with_lse: bool):
    """The forward kernel of K1, K5 and K10 on checked contiguous inputs ->
    (out [B, T, H*64] bf16, lse [B, H, T] fp32 or None)."""
    b, t, three_hd = qkv.shape
    hd = three_hd // 3
    out = torch.empty(b, t, hd, device=qkv.device, dtype=qkv.dtype)
    lse = (torch.empty(b, num_heads, t, device=qkv.device, dtype=torch.float32)
           if with_lse else None)
    err = build.library().fsat_pair_attention(
        qkv.data_ptr(), khat.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, t, num_heads, cos.shape[-1], valid,
        LOG2E / math.sqrt(hd // num_heads), _stream(qkv.device))
    build.check(err, name)
    return out, lse


def _launch_forward(qkv, freqs, num_heads, valid, with_lse: bool):
    """K1 (with_lse False) or K5: K10a ropes k once, then the forward kernel."""
    name = "fused_qkv_rope_attention" + ("_stats" if with_lse else "")
    _, _, cos, sin = _cuda_inputs(name, qkv, freqs, num_heads)
    qkv = qkv.contiguous()
    khat = _rope_launch(qkv, cos, sin, num_heads, 1, 1.0)
    return _attention_launch(name, qkv, khat, cos, sin, num_heads, valid, with_lse)


def fused_qkv_rope_attention_stats(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int,
                                   kv_len: tp.Optional[int] = None):
    """K5: the attention and its base-2 LSE -> (out [B, T, H*D], lse [B, H, T] fp32)."""
    global stats_launches
    valid = _valid_len(qkv.shape[1], kv_len)
    if qkv.device.type == "cpu":
        return fused_qkv_rope_attention_stats_plain(qkv, freqs, num_heads, kv_len)
    out, lse = _launch_forward(qkv, freqs, num_heads, valid, with_lse=True)
    stats_launches += 1
    return out, lse


def fused_qkv_rope_attention_backward(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                                      grad_out: torch.Tensor, freqs: torch.Tensor, num_heads: int,
                                      kv_len: tp.Optional[int] = None,
                                      dtype: tp.Optional[torch.dtype] = None) -> torch.Tensor:
    """K6: dqkv [B, T, 3*H*D] from qkv, K5's out and lse, and dL/d(out), in
    `dtype` (default qkv's). The CUDA kernels write fp32."""
    global backward_launches
    b, t, _ = qkv.shape
    valid = _valid_len(t, kv_len)
    if qkv.device.type == "cpu":
        return fused_qkv_rope_attention_backward_plain(qkv, out, lse, grad_out, freqs, num_heads,
                                                       kv_len, dtype)
    d, rot, cos, sin = _cuda_inputs("fused_qkv_rope_attention_backward", qkv, freqs, num_heads)
    for name, x in (("out", out), ("grad_out", grad_out), ("lse", lse)):
        if x.device != qkv.device:
            raise ValueError(f"fused_qkv_rope_attention_backward: {name} must be on {qkv.device}")
    qkv = qkv.contiguous()
    qhat = _rope_launch(qkv, cos, sin, num_heads, 0, LOG2E / math.sqrt(d))
    khat = _rope_launch(qkv, cos, sin, num_heads, 1, 1.0)
    do = grad_out.to(torch.bfloat16).contiguous()
    o = out.to(torch.bfloat16).contiguous()
    lse = lse.float().contiguous()
    # scratch: FA2's D = rowsum(dO * O) per head (fp32, the kernel's first
    # pass), and dq's fp32 sum over the key blocks [B, H, T rounded up to 64, 64]
    delta = torch.empty(b, num_heads, t, device=qkv.device, dtype=torch.float32)
    dq_acc = torch.zeros(b, num_heads, (t + 63) // 64 * 64, d, device=qkv.device,
                         dtype=torch.float32)
    dqkv = torch.empty(qkv.shape, device=qkv.device, dtype=torch.float32)
    err = build.library().fsat_pair_attention_bwd(
        qhat.data_ptr(), khat.data_ptr(), qkv.data_ptr(), do.data_ptr(), o.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), cos.data_ptr(), sin.data_ptr(), dq_acc.data_ptr(),
        dqkv.data_ptr(), b, t, num_heads, rot, valid, 1.0 / math.sqrt(d), _stream(qkv.device))
    backward_launches += 1
    build.check(err, "fused_qkv_rope_attention_backward")
    return dqkv.to(dtype or qkv.dtype)


def rope_pair_k(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K10a: k of qkv [B, T, 3*H*D] roped once -> khat [B, T, H*D] in qkv's dtype."""
    if qkv.device.type == "cpu":
        return rope_pair_k_plain(qkv, freqs, num_heads)
    _, _, cos, sin = _cuda_inputs("rope_pair_k", qkv, freqs, num_heads)
    return _rope_launch(qkv.contiguous(), cos, sin, num_heads, 1, 1.0)


def pair_long_attention(qkv: torch.Tensor, khat: torch.Tensor, freqs: torch.Tensor,
                        num_heads: int, kv_len: tp.Optional[int] = None) -> torch.Tensor:
    """K10: attention of qkv's roped q over K10a's khat and qkv's v -> [B, T, H*D]."""
    global long_launches
    b, t, three_hd = qkv.shape
    valid = _valid_len(t, kv_len)
    if tuple(khat.shape) != (b, t, three_hd // 3):
        raise ValueError(f"pair_long_attention: khat {tuple(khat.shape)} does not match qkv "
                         f"{tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return pair_long_attention_plain(qkv, khat, freqs, num_heads, kv_len)
    _, _, cos, sin = _cuda_inputs("pair_long_attention", qkv, freqs, num_heads)
    if khat.device != qkv.device or khat.dtype != qkv.dtype:
        raise ValueError("pair_long_attention: khat must be bf16 on the qkv device")
    out, _ = _attention_launch("pair_long_attention", qkv.contiguous(), khat.contiguous(), cos,
                               sin, num_heads, valid, with_lse=False)
    long_launches += 1
    return out


def fused_qkv_rope_attention_long(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int,
                                  kv_len: tp.Optional[int] = None) -> torch.Tensor:
    """The long-sequence inference path (``_pair_long_forward``): K10a, then
    K10, on :func:`kernel_input` of qkv for a CUDA tensor; out in qkv's dtype."""
    x = qkv if qkv.device.type == "cpu" else kernel_input(qkv)
    out = pair_long_attention(x, rope_pair_k(x, freqs, num_heads), freqs, num_heads, kv_len)
    return out.to(qkv.dtype)


class FusedQKVRopeAttention(torch.autograd.Function):
    """K5 forward, K6 backward (the ``_fused_pair`` custom_vjp's pair path),
    for the lengths :func:`training_route` sends to "pair" (T <= 1168 at head
    dim 64). On CUDA the kernels run in bf16: an fp32 qkv is cast on the way
    in and its gradient cast back. freqs are position tables and get no
    gradient."""

    @staticmethod
    def forward(ctx, qkv, freqs, num_heads, kv_len):
        x = qkv.to(torch.bfloat16) if qkv.is_cuda else qkv
        out, lse = fused_qkv_rope_attention_stats(x, freqs, num_heads, kv_len)
        ctx.save_for_backward(x, out, lse, freqs)
        ctx.num_heads, ctx.kv_len, ctx.dtype = num_heads, kv_len, qkv.dtype
        return out.to(qkv.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        x, out, lse, freqs = ctx.saved_tensors
        dqkv = fused_qkv_rope_attention_backward(x, out, lse, grad_out.to(x.dtype), freqs,
                                                 ctx.num_heads, ctx.kv_len, dtype=ctx.dtype)
        return dqkv, None, None, None


def _split_roped(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int):
    """qkv [B, T, 3*H*D] -> q, k, v [B*H, T, D] in qkv's dtype, q and k roped
    outside any kernel (the JAX package's ``_rope_outside``)."""
    b, t, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    q, k, v = qkv.view(b, t, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q, k = apply_rotary_pos_emb(q, freqs), apply_rotary_pos_emb(k, freqs)
    return (x.reshape(b * num_heads, t, d) for x in (q, k, v))


def fused_qkv_rope_attention_split(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int,
                                   kv_len: tp.Optional[int] = None) -> torch.Tensor:
    """The inference route beyond 8192 tokens ("flash"): heads split, q and
    k roped in qkv's dtype, K7 without its LSE (fp32 or bf16 by qkv's dtype;
    its plain version for CPU tensors), heads merged; out in qkv's dtype."""
    q, k, v = _split_roped(qkv, freqs, num_heads)
    out, _ = flash.flash_forward(q, k, v, kv_len, save_stats=False)
    return flash.merge_heads(out, qkv.shape[0], num_heads)


class FusedQKVFlashAttention(torch.autograd.Function):
    """The unpack branch of the ``_fused_pair`` custom_vjp (``_fused_pair_fwd``
    :1351-1358, ``_fused_pair_bwd`` :1367-1389), for the lengths
    :func:`training_route` sends to "flash": qkv split into heads, q and k
    roped in the input dtype, K7 with its LSE on [B*H, T, D], heads merged;
    the backward runs K9 (K8 where its plan fits), un-ropes dq and dk (the
    rope is linear) and merges dqkv. Everything stays in qkv's dtype. freqs
    are position tables and get no gradient."""

    @staticmethod
    def forward(ctx, qkv, freqs, num_heads, kv_len):
        q, k, v = _split_roped(qkv, freqs, num_heads)
        out, lse = flash.flash_forward(q, k, v, kv_len, save_stats=True)
        ctx.save_for_backward(q, k, v, out, lse, freqs)
        ctx.num_heads, ctx.kv_len = num_heads, kv_len
        return flash.merge_heads(out, qkv.shape[0], num_heads)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse, freqs = ctx.saved_tensors
        b, t, hd = grad_out.shape
        h = ctx.num_heads
        d = hd // h
        go = grad_out.to(q.dtype).view(b, t, h, d).transpose(1, 2).reshape(b * h, t, d)
        dq, dk, dv = flash.flash_attention_backward(q, k, v, out, lse, go, ctx.kv_len)

        def merge(x):
            return x.view(b, h, t, d).transpose(1, 2).reshape(b, t, hd)

        dq = apply_rotary_pos_emb_transpose(dq.view(b, h, t, d), freqs).to(q.dtype)
        dk = apply_rotary_pos_emb_transpose(dk.view(b, h, t, d), freqs).to(q.dtype)
        return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1), None, None, None


def fused_qkv_rope_attention(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int,
                             kv_len: tp.Optional[int] = None) -> torch.Tensor:
    """qkv [B, T, 3*H*D] (q | k | v), freqs [T', rot] rotary angles (last T
    rows used) -> [B, T, H*D]. kv_len: true length of a pre-padded sequence;
    keys at or beyond it are masked (the padded rows' outputs are garbage for
    the caller to slice off).

    Heads that the head-pair kernels do not take run at their true length
    where kv_len is below T, the output padded back with zeros (as the JAX
    package's fallback, flash_attention.py:1423-1428). With grad enabled and
    qkv requiring grad, runs the autograd binding that :func:`training_route`
    names for T: :class:`FusedQKVRopeAttention` (K5 then K6 on CUDA) or
    :class:`FusedQKVFlashAttention` (K7 then K8 or K9); otherwise the
    inference kernel that :func:`attention_route` names. The rope-fused K7's
    function rounds the roped q and k to bf16 whatever the input dtype: a
    CPU tensor takes it only where ops/attention.py's ``uses_kernels`` says
    so (the tests force it), else the JAX package's CPU path (rope outside,
    the attention in the input dtype: flash_attention.py:1430-1439)."""
    global launches
    _, t, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    valid = _valid_len(t, kv_len)
    if valid < t and not pair_heads(d, num_heads):
        out = fused_qkv_rope_attention(qkv[:, :valid], freqs[:valid], num_heads)
        return torch.nn.functional.pad(out, (0, 0, 0, t - valid))
    if torch.is_grad_enabled() and qkv.requires_grad:
        if training_route(t, d, num_heads) == "pair":
            return FusedQKVRopeAttention.apply(qkv, freqs, num_heads, kv_len)
        return FusedQKVFlashAttention.apply(qkv, freqs, num_heads, kv_len)
    route = attention_route(t, d, num_heads)
    if route == "pair_long":
        return fused_qkv_rope_attention_long(qkv, freqs, num_heads, kv_len)
    if route == "flash":
        return fused_qkv_rope_attention_split(qkv, freqs, num_heads, kv_len)
    if route == "rope_flash":
        if gate.uses_kernels(qkv):
            return flash.flash_rope_attention(qkv, freqs, num_heads)
        return fused_qkv_rope_attention_plain(qkv, freqs, num_heads)
    if qkv.device.type == "cpu":
        return fused_qkv_rope_attention_plain(qkv, freqs, num_heads, kv_len)
    out, _ = _launch_forward(kernel_input(qkv), freqs, num_heads, valid, with_lse=False)
    launches += 1
    return out.to(qkv.dtype)
