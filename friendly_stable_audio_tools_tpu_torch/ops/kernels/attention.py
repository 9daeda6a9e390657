"""Fused qkv + rotary + self-attention (K1).

Replaces the head-pair Pallas kernel ``_fused_pair_forward`` /
``_fused_pair_kernel`` (friendly_stable_audio_tools_tpu/ops/pallas/
flash_attention.py:828, :796) that carries the DiT's self-attention.

What it computes: non-causal attention of a fused ``[B, T, 3*H*D]`` qkv
tensor with the fp32 partial rotary embedding of
``flash_attention.py:_rope_tables`` (:720) applied to q and k, q prescaled by
``log2(e)/sqrt(D)`` so the softmax runs in base 2, keys at or beyond
``kv_len`` masked, output ``[B, T, H*D]``. q and k are rounded to the input
dtype after the rope and before the score product, P to the input dtype
before P.V; scores, softmax and accumulation are fp32.

What bounds it on the H100: at the SAO shape (B = 2 under CFG, 24 heads,
T = 1025) each call is ~13 GFLOP of score and P.V products over a 3 MB
input, so it is bound by tensor-core work and by how much of it the
softmax's serial dependence leaves idle. The kernel (csrc/attention.cu)
gives one block a 64-row q tile of one head, ropes and prescales it once,
then streams 64-key tiles (roped as they are loaded) through an online
base-2 softmax with WMMA bf16 products, so the T x T score matrix never
exists in device memory; q, k and v are read with the qkv row stride
rather than copied out, and the ragged last tile is masked in-kernel.

The plain version below runs for CPU tensors (the CPU tests); CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from ..embeddings import apply_rotary_pos_emb
from . import build

launches = 0

LOG2E = 1.4426950408889634


def fused_qkv_rope_attention_plain(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int,
                                   kv_len: tp.Optional[int] = None) -> torch.Tensor:
    dt = qkv.dtype
    b, t, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    valid = t if kv_len is None else kv_len
    q, k, v = qkv.float().view(b, t, 3, num_heads, d).permute(2, 0, 3, 1, 4)  # [B, H, T, D]
    q = (apply_rotary_pos_emb(q, freqs) * (LOG2E / math.sqrt(d))).to(dt).float()
    k = apply_rotary_pos_emb(k, freqs).to(dt).float()
    s = q @ k.transpose(-1, -2)
    if valid < t:
        s[..., valid:] = -math.inf
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = (p.to(dt).float() @ v) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.transpose(1, 2).reshape(b, t, num_heads * d).to(dt)


def fused_qkv_rope_attention(qkv: torch.Tensor, freqs: torch.Tensor, num_heads: int,
                             kv_len: tp.Optional[int] = None) -> torch.Tensor:
    """qkv [B, T, 3*H*D] (q | k | v), freqs [T', rot] rotary angles (last T
    rows used) -> [B, T, H*D]. kv_len: true length of a pre-padded sequence;
    keys at or beyond it are masked (the padded rows' outputs are garbage for
    the caller to slice off)."""
    global launches
    b, t, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)
    valid = t if kv_len is None else int(kv_len)
    if not 1 <= valid <= t:
        raise ValueError(f"kv_len {kv_len} outside [1, {t}]")
    if qkv.device.type == "cpu":
        return fused_qkv_rope_attention_plain(qkv, freqs, num_heads, kv_len)
    rot = freqs.shape[-1]
    if qkv.dtype != torch.bfloat16 or d != 64 or rot % 2 or rot > d:
        raise ValueError(f"fused_qkv_rope_attention: the CUDA kernel takes bf16, head dim 64 and "
                         f"an even rot <= 64, got {qkv.dtype}, D = {d}, rot = {rot}")
    if freqs.device != qkv.device:
        raise ValueError("fused_qkv_rope_attention: freqs must be on the qkv device")
    qkv = qkv.contiguous()
    f = freqs[-t:].float()
    cos, sin = torch.cos(f).contiguous(), torch.sin(f).contiguous()
    out = torch.empty(b, t, num_heads * d, device=qkv.device, dtype=qkv.dtype)
    err = build.library().fsat_fused_qkv_rope_attention(
        qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), b, t, num_heads, rot,
        valid, LOG2E / math.sqrt(d), torch.cuda.current_stream(qkv.device).cuda_stream)
    launches += 1
    build.check(err, "fused_qkv_rope_attention")
    return out
