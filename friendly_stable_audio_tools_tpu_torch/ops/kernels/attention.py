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

Routing without grad follows flash_attention.py:1413-1421
(:func:`attention_route`): up to 2048 tokens K1; up to 8192 (Stable Audio
2.0's 6145 tokens, padded to 6272) K10a then K10; beyond that (Stable Audio
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
its plan fits, not ported) from ops/kernels/flash_attention.py, in the
input dtype: fp32 on the training path, where the pair route casts to bf16.

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
leaves idle. The kernels (csrc/attention.cu, csrc/attention_bwd.cu) give one
block a 64-row tile of one head and stream 64-row tiles of the other operand
(roped as they are loaded) through WMMA bf16 products, so the T x T score
matrix never exists in device memory; q, k and v are read with the qkv row
stride rather than copied out, and ragged tiles are masked in-kernel. K6
splits as FlashAttention-2 does (a key-tile pass for dk/dv, a q-tile pass
for dq) because the TPU kernel's resident whole-sequence dk/dv accumulators
do not fit a Hopper block's shared memory.

K10 (csrc/attention_long.cu) at B2 T6272 kv_len 6145 H24 is ~464 GFLOP of
score and P.V products (6145 valid rows x 6145 keys) over ~190 MB in and
out: tensor-core bound, ~0.47 ms at 989 TFLOP/s. The TPU kernel holds a head pair's whole roped K in VMEM
(1.6 MB) for one whole-K score dot per head; a Hopper block cannot, so K10 is
K1's streaming kernel reading keys already roped, and K10a (memory bound, 2 x
38.5 MB, ~23 us at 3.35 TB/s) ropes K once per call into a bf16 [B, T, H*D]
buffer, where K1 would rope each key tile again for each of the 98 q tiles.

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

from ..embeddings import apply_rotary_pos_emb, apply_rotary_pos_emb_transpose
from . import build
from . import flash_attention as flash

# launch counts: each wrapper adds one where it launches its kernel
launches = 0  # K1
rope_k_launches = 0  # K10a
long_launches = 0  # K10
stats_launches = 0  # K5
backward_launches = 0  # K6 (one dk/dv pass and one dq pass per count)

LOG2E = 1.4426950408889634
PAIR_MAX_T = 2048  # K1's limit (flash_attention.py:1413)
LONG_MAX_T = 8192  # K10's limit (SINGLE_DOT_MAX_TK, flash_attention.py:55)
# fp32 score bytes one chunk of heads of the long plain version may hold
LONG_PLAIN_SCORE_BYTES = 1 << 30


def kernel_input(qkv: torch.Tensor) -> torch.Tensor:
    """What K1 and K10a/K10 read: qkv in bf16 (the JAX kernels cast an fp32
    qkv to bf16 inside and return the input dtype)."""
    return qkv.to(torch.bfloat16)


def attention_route(t: int) -> str:
    """The inference kernel for a sequence of t tokens, as the JAX package
    routes it (flash_attention.py:1413-1421): "pair" (K1) for t <= 2048,
    "pair_long" (K10a + K10) for t <= 8192, else "flash" (heads split, rope
    outside, K7 without its LSE: :func:`fused_qkv_rope_attention_split`)."""
    if t <= PAIR_MAX_T:
        return "pair"
    if t <= LONG_MAX_T:
        return "pair_long"
    return "flash"


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
    if head_dim != 64 or num_heads % 2:
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


def _launch_forward(qkv, freqs, num_heads, valid, with_lse: bool):
    name = "fused_qkv_rope_attention" + ("_stats" if with_lse else "")
    b, t, _ = qkv.shape
    d, rot, cos, sin = _cuda_inputs(name, qkv, freqs, num_heads)
    qkv = qkv.contiguous()
    out = torch.empty(b, t, num_heads * d, device=qkv.device, dtype=qkv.dtype)
    lse = (torch.empty(b, num_heads, t, device=qkv.device, dtype=torch.float32)
           if with_lse else None)
    err = build.library().fsat_fused_qkv_rope_attention(
        qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, t, num_heads, rot, valid,
        LOG2E / math.sqrt(d), _stream(qkv.device))
    build.check(err, name)
    return out, lse


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
    do = grad_out.to(torch.bfloat16).contiguous()
    # FA2's D = rowsum(dO * O) per head, in fp32 beside the kernel (as the
    # JAX package computes it in XLA, flash_attention.py:1153-1158)
    delta = (_heads(do, num_heads) * _heads(out.to(torch.bfloat16), num_heads)).sum(-1)
    delta = delta.contiguous()
    lse = lse.float().contiguous()
    dqkv = torch.empty(qkv.shape, device=qkv.device, dtype=torch.float32)
    err = build.library().fsat_fused_qkv_rope_attention_bwd(
        qkv.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), dqkv.data_ptr(), b, t, num_heads, rot, valid, LOG2E / math.sqrt(d),
        1.0 / math.sqrt(d), _stream(qkv.device))
    backward_launches += 1
    build.check(err, "fused_qkv_rope_attention_backward")
    return dqkv.to(dtype or qkv.dtype)


def rope_pair_k(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K10a: k of qkv [B, T, 3*H*D] roped once -> khat [B, T, H*D] in qkv's dtype."""
    global rope_k_launches
    if qkv.device.type == "cpu":
        return rope_pair_k_plain(qkv, freqs, num_heads)
    b, t, _ = qkv.shape
    d, rot, cos, sin = _cuda_inputs("rope_pair_k", qkv, freqs, num_heads)
    qkv = qkv.contiguous()
    khat = torch.empty(b, t, num_heads * d, device=qkv.device, dtype=qkv.dtype)
    err = build.library().fsat_rope_pair_k(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                                           khat.data_ptr(), b, t, num_heads, rot,
                                           _stream(qkv.device))
    build.check(err, "rope_pair_k")
    rope_k_launches += 1
    return khat


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
    d, rot, cos, sin = _cuda_inputs("pair_long_attention", qkv, freqs, num_heads)
    if khat.device != qkv.device or khat.dtype != qkv.dtype:
        raise ValueError("pair_long_attention: khat must be bf16 on the qkv device")
    qkv, khat = qkv.contiguous(), khat.contiguous()
    out = torch.empty(b, t, num_heads * d, device=qkv.device, dtype=qkv.dtype)
    err = build.library().fsat_pair_long_attention(
        qkv.data_ptr(), khat.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), b, t,
        num_heads, rot, valid, LOG2E / math.sqrt(d), _stream(qkv.device))
    build.check(err, "pair_long_attention")
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


def _merge_heads(x: torch.Tensor, b: int, num_heads: int) -> torch.Tensor:
    """[B*H, T, D] -> [B, T, H*D]."""
    _, t, d = x.shape
    return x.view(b, num_heads, t, d).transpose(1, 2).reshape(b, t, num_heads * d)


def fused_qkv_rope_attention_split(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int,
                                   kv_len: tp.Optional[int] = None) -> torch.Tensor:
    """The inference route beyond 8192 tokens ("flash"): heads split, q and
    k roped in qkv's dtype, K7 without its LSE (fp32 or bf16 by qkv's dtype;
    its plain version for CPU tensors), heads merged; out in qkv's dtype."""
    q, k, v = _split_roped(qkv, freqs, num_heads)
    out, _ = flash.flash_forward(q, k, v, kv_len, save_stats=False)
    return _merge_heads(out, qkv.shape[0], num_heads)


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
        return _merge_heads(out, qkv.shape[0], num_heads)

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

    With grad enabled and qkv requiring grad, runs the autograd binding that
    :func:`training_route` names for T: :class:`FusedQKVRopeAttention` (K5
    then K6 on CUDA) or :class:`FusedQKVFlashAttention` (K7 then K9);
    otherwise the inference kernel that :func:`attention_route` names."""
    global launches
    _, t, three_hd = qkv.shape
    valid = _valid_len(t, kv_len)
    if torch.is_grad_enabled() and qkv.requires_grad:
        if training_route(t, three_hd // (3 * num_heads), num_heads) == "pair":
            return FusedQKVRopeAttention.apply(qkv, freqs, num_heads, kv_len)
        return FusedQKVFlashAttention.apply(qkv, freqs, num_heads, kv_len)
    route = attention_route(t)
    if route == "pair_long":
        return fused_qkv_rope_attention_long(qkv, freqs, num_heads, kv_len)
    if route == "flash":
        return fused_qkv_rope_attention_split(qkv, freqs, num_heads, kv_len)
    if qkv.device.type == "cpu":
        return fused_qkv_rope_attention_plain(qkv, freqs, num_heads, kv_len)
    out, _ = _launch_forward(kernel_input(qkv), freqs, num_heads, valid, with_lse=False)
    launches += 1
    return out.to(qkv.dtype)
