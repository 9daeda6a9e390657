"""The VAEs' periodic activations (counterpart of
friendly_stable_audio_tools_tpu/ops/activations.py).

SnakeBeta (the Oobleck VAE's) is never applied on its own: every snake
feeds a convolution and is fused into that convolution's kernel, so the
module only holds the parameters and hands out their effective values
(`effective`). Snake (the DAC VAE's single-parameter form) is applied on its
own, in the input's dtype, as the JAX package applies it before an unfused
convolution."""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

_EPS = 1e-9


class SnakeBeta(nn.Module):
    """x + 1/beta * sin^2(alpha x), per channel; log-scale parameters
    initialised to zero (alpha = beta = 1)."""

    def __init__(self, features: int, alpha_logscale: bool = True):
        super().__init__()
        self.alpha_logscale = alpha_logscale
        self.alpha = nn.Parameter(torch.empty(features))
        self.beta = nn.Parameter(torch.empty(features))

    def effective(self) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """(alpha, 1 / (beta + eps)) in fp32, as the fused kernels take them."""
        alpha, beta = self.alpha.float(), self.beta.float()
        if self.alpha_logscale:
            alpha, beta = torch.exp(alpha), torch.exp(beta)
        return alpha, 1.0 / (beta + _EPS)


class Snake(nn.Module):
    """x + 0.5 / (alpha + eps) * (1 - cos(2 alpha x)) per channel, in x's
    dtype (JAX activations.py:59-69); alpha initialised to one."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.to(x.dtype)
        return x + (0.5 / (alpha + _EPS)) * (1.0 - torch.cos(2.0 * alpha * x))
