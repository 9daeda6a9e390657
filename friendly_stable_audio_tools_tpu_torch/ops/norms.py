"""Normalisation layers (counterparts of the biasless LayerNorm in
friendly_stable_audio_tools_tpu/models/transformer.py:32 and the RMS norm
of models/t5.py:55)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    """Biasless LayerNorm with a learned gain; fp32 statistics, eps 1e-5,
    output in the input dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.gamma.float(), None, 1e-5)
        return y.to(x.dtype)


class RMSNorm(nn.Module):
    """T5's norm: x * rsqrt(mean(x^2) + eps) * weight in fp32, no centring."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (self.weight.float() * y).to(x.dtype)
