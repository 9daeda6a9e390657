"""SnakeBeta, the Oobleck VAE's periodic activation (counterpart of
friendly_stable_audio_tools_tpu/ops/activations.py).

The decoder never applies it on its own: every snake feeds a convolution
and is fused into that convolution's kernel, so the module only holds the
parameters and hands out their effective values (`effective`)."""

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
