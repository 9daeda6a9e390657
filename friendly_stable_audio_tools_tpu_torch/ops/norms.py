"""Normalisation layers (counterparts of the biasless LayerNorm in
friendly_stable_audio_tools_tpu/models/transformer.py:32 and the RMS norm
of models/t5.py:55)."""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from .kernels import elementwise


class LayerNorm(nn.Module):
    """Biasless LayerNorm with a learned gain; fp32 statistics, eps 1e-5,
    output in the input dtype.

    With `scale_shift=(scale, shift)` (the adaLN block's modulation, JAX
    models/transformer.py:42-47) it returns LayerNorm(x) * (1 + scale) +
    shift through ops/kernels/elementwise.ln_modulate, which takes the fused
    kernel K11 where `fused_ew` is set (the JAX package's FSAT_FUSED_EW
    switch, set by `create_model_from_config(..., fused_ew=True)`) and the
    inputs are inside its gate, and the plain chain otherwise."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))
        self.fused_ew = False

    def forward(self, x: torch.Tensor,
                scale_shift: tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        if scale_shift is not None:
            return elementwise.ln_modulate(x, self.gamma, *scale_shift, enabled=self.fused_ew)
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
