"""Timestep Fourier features and rotary position tables (counterpart of
friendly_stable_audio_tools_tpu/ops/embeddings.py)."""

from __future__ import annotations

import math

import torch
from torch import nn


class FourierFeatures(nn.Module):
    """f = 2*pi * x @ W^T -> [cos f, sin f], computed in fp32; W ~ N(0, std)."""

    def __init__(self, in_features: int, out_features: int, std: float = 1.0):
        super().__init__()
        self.std = std
        self.weight = nn.Parameter(torch.empty(out_features // 2, in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = 2 * math.pi * x.float() @ self.weight.float().T
        return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


def rotary_freqs(seq_len: int, dim: int, base: float = 10000.0, device=None) -> torch.Tensor:
    """[seq_len, dim] rotation angles, each frequency used for both halves."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim))
    f = torch.arange(seq_len, device=device, dtype=torch.float32)[:, None] * inv_freq[None, :]
    return torch.cat([f, f], dim=-1)


def apply_rotary_pos_emb(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Partial rotary in fp32 over the first freqs.shape[-1] dims of
    t [..., seq, head_dim], using the last `seq` rows of freqs; returns t's dtype."""
    rot = freqs.shape[-1]
    seq = t.shape[-2]
    f = freqs[-seq:].float()
    t32 = t.float()
    x, rest = t32[..., :rot], t32[..., rot:]
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    out = x * torch.cos(f) + rotated * torch.sin(f)
    return torch.cat([out, rest], dim=-1).to(t.dtype)


def apply_rotary_pos_emb_transpose(dy: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """The vjp of :func:`apply_rotary_pos_emb` (the rope is linear):
    dx = dy*cos + rotate_half^T(dy*sin), where rotate_half^T(y) = [y2, -y1]
    over the first freqs.shape[-1] dims (flash_attention.py:1084-1099 of the
    JAX package); dims beyond pass through. fp32 in and out."""
    rot = freqs.shape[-1]
    f = freqs[-dy.shape[-2]:].float()
    y, rest = dy[..., :rot], dy[..., rot:]
    ys1, ys2 = (y * torch.sin(f)).chunk(2, dim=-1)
    return torch.cat([y * torch.cos(f) + torch.cat([ys2, -ys1], dim=-1), rest], dim=-1)
