"""Scaled-dot-product attention (counterpart of
friendly_stable_audio_tools_tpu/ops/attention.py).

:func:`attention` is the plain path (`_xla_attention` :86): two matrix
products and a softmax in fp32, with the probabilities rounded to the value
dtype before the second product. The DiT's cross-attention reads 130
conditioning tokens, which the JAX package sends there rather than to a
kernel, and so does this port.

:func:`scaled_dot_product_attention` is the JAX function (:35) with its gate
(:58-69, :func:`flash_gate`, without its FSAT_* switches): long unmasked
self-attention on the card goes to the flash kernel K7 without its
log-sum-exp (ops/kernels/flash_attention.py); everything else, and every
CPU tensor, takes the plain path. The ADP U-Net's self-attention uses it.
"""

from __future__ import annotations

import typing as tp

import torch

from .kernels import flash_attention as flash


def flash_gate(t_q: int, t_k: int, head_dim: int, masked: bool, causal: bool = False) -> bool:
    """Whether the JAX package sends an attention call to its flash kernel
    on the accelerator (ops/attention.py:58-69): at least 1024 queries and
    512 keys (short-K cross-attention stays plain), head dim at most 128, no
    mask, and causal only when square."""
    return (t_q >= 1024 and (t_q == t_k or not causal) and not masked and head_dim <= 128
            and t_k >= 512)


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, Tq, D], k/v [B, Hkv, Tk, D], mask [B, Tk] (True = attend) ->
    [B, H, Tq, D]. Non-causal. On a CUDA tensor that :func:`flash_gate`
    admits, K7 computes it (fp32, D 64 or 80; other cases raise there)."""
    b, h, t_q, d = q.shape
    if q.device.type == "cpu" or not flash_gate(t_q, k.shape[-2], d, mask is not None):
        return attention(q, k, v, mask)
    if k.shape[1] != h:
        k = k.repeat_interleave(h // k.shape[1], dim=1)
        v = v.repeat_interleave(h // v.shape[1], dim=1)
    t_k = k.shape[-2]
    out, _ = flash.flash_forward(q.reshape(b * h, t_q, d), k.reshape(b * h, t_k, d),
                                 v.reshape(b * h, t_k, d), save_stats=False)
    return out.view(b, h, t_q, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, Tq, D], k/v [B, Hkv, Tk, D] (Hkv divides H: each kv head
    serves H/Hkv consecutive q heads); mask [B, Tk], True = attend."""
    heads = q.shape[1]
    if k.shape[1] != heads:
        k = k.repeat_interleave(heads // k.shape[1], dim=1)
        v = v.repeat_interleave(heads // v.shape[1], dim=1)
    scale = q.shape[-1] ** -0.5
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return (probs.to(v.dtype).float() @ v.float()).to(q.dtype)
