"""1-D convolutions, channels-last (counterpart of
friendly_stable_audio_tools_tpu/ops/convs.py).

Layout: weights keep the JAX package's `[k, Cin, Cout]` layout, which is
what the CUDA kernels read, so converted checkpoints need no transpose
(torch's own Conv1d keeps `[Cout, Cin, k]`). Weight norm follows torch's
`weight_norm(dim=0)`: the magnitude `g` is per OUTPUT channel for a conv and
per INPUT channel for a transposed conv (whose dim 0 is in_channels).

The weight-normed convs run only in the forms the Oobleck decoder uses, each
through its fused snake -> conv kernel (ops/kernels/conv1d.py): stride-1
'same' convs (K2) and ConvTranspose1d(k = 2s, stride s, padding s/2) (K4).
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .kernels import conv1d as conv_kernels


class Conv1d(nn.Module):
    """Pointwise (k = 1) conv without bias, weight [1, Cin, Cout]: the DiT's
    residual pre/post projections."""

    def __init__(self, in_channels: int, out_channels: int, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(1, in_channels, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight[0].to(x.dtype)


class WNConv1d(nn.Module):
    """Weight-normalised stride-1 conv: w = g * v / ||v||_(k, in) per output channel."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, use_bias: bool = True):
        super().__init__()
        self.dilation = dilation
        self.v = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels))
        self.g = nn.Parameter(torch.empty(out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def weight(self) -> torch.Tensor:
        v = self.v.float()
        return v * (self.g.float() / (v.square().sum(dim=(0, 1)).sqrt() + 1e-12))

    def forward(self, x: torch.Tensor, snake: tp.Optional[tp.Tuple] = None) -> torch.Tensor:
        alpha, inv_beta = snake if snake is not None else (None, None)
        return conv_kernels.snake_conv1d(x, self.weight(), self.bias, alpha, inv_beta,
                                         dilation=self.dilation)


class WNConvTranspose1d(nn.Module):
    """Weight-normalised ConvTranspose1d(k = 2s, stride s, padding s/2);
    norm per input channel."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, use_bias: bool = True):
        super().__init__()
        self.stride = stride
        self.v = nn.Parameter(torch.empty(2 * stride, in_channels, out_channels))
        self.g = nn.Parameter(torch.empty(in_channels))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def weight(self) -> torch.Tensor:
        v = self.v.float()
        return v * (self.g.float() / (v.square().sum(dim=(0, 2)).sqrt() + 1e-12))[None, :, None]

    def forward(self, x: torch.Tensor, snake: tp.Optional[tp.Tuple] = None) -> torch.Tensor:
        alpha, inv_beta = snake if snake is not None else (None, None)
        return conv_kernels.snake_conv_transpose1d(x, self.weight(), self.bias, alpha, inv_beta,
                                                   stride=self.stride)
