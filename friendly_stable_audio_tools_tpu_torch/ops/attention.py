"""Plain attention for short key sequences (counterpart of
friendly_stable_audio_tools_tpu/ops/attention.py:_xla_attention :86).

The DiT's cross-attention reads 130 conditioning tokens; the JAX package
sends it to XLA's fused einsum-softmax-einsum rather than a kernel
(ops/attention.py:58-70), and so does this port: two matrix products and a
softmax in fp32, with the probabilities rounded to the value dtype before
the second product."""

from __future__ import annotations

import typing as tp

import torch


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
