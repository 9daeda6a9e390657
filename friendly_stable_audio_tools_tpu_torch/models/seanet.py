"""SEANet encoder and decoder of the EnCodec-style tokenizer (counterpart of
friendly_stable_audio_tools_tpu/models/seanet.py), channels-last [B, T, C].

Weight-normed convs with ELU activations, dilated residual blocks
(`compress` 2), strided down- and upsampling and a residual two-layer LSTM
over the frames. The stride-1 convs run through the fp32 K2 on the card
(ops/convs.py:WNConv1d -> snake_conv1d without a snake), where the JAX
package sends them to its Pallas `snake_conv1d` (ops/convs.py:241-248); the
downsamples with an even stride take the reshape-GEMM form and the others
a plain strided conv, as there. The LSTM is `torch.nn.LSTM` (cuDNN on the
card; TF32 off through `torch.backends.cudnn.allow_tf32`): flax's
`OptimizedLSTMCell` has the same gate order i, f, g, o and biases on its
hidden-side Denses only, which utils/convert.py carries into `bias_hh` with
`bias_ih` zero. The decoder's upsamples take K4 at an even stride and a
plain transposed conv at an odd one (JAX ops/convs.py:347-371); the LM's
training never runs the decoder.

Module names follow the JAX package's (`conv_in`, `block{i}_res{j}`,
`down{i}`, `up{i}`, `lstm`, `conv_out`), so parameters carry over by name.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.convs import WNConv1d, WNConvTranspose1d


class SEANetResnetBlock(nn.Module):
    """x + conv_k1(elu(conv_k0,dil(elu(x)))), hidden width dim / compress."""

    def __init__(self, dim: int, kernel_sizes: tp.Sequence[int] = (3, 1),
                 dilations: tp.Sequence[int] = (1, 1), compress: int = 2):
        super().__init__()
        dims = [dim, dim // compress, dim]
        for i, (k, d) in enumerate(zip(kernel_sizes, dilations)):
            self.add_module(f"conv{i}", WNConv1d(dims[i], dims[i + 1], k, dilation=d))
        self.n_convs = len(kernel_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_convs):
            h = getattr(self, f"conv{i}")(F.elu(h))
        return x + h


class SLSTM(nn.Module):
    """x + LSTM(x) over time, `num_layers` stacked (JAX `_LSTM`)."""

    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.lstm(x)[0]


class SEANetEncoder(nn.Module):
    """Audio [B, T, channels] -> [B, T / prod(ratios), dimension]. `ratios`
    in the order the encoder applies them (the factory reverses the
    config's, as the JAX factory does)."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 ratios: tp.Sequence[int] = (8, 5, 4, 2), n_residual_layers: int = 1,
                 dilation_base: int = 2, kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, lstm: int = 2, norm: str = "weight_norm",
                 causal: bool = False):
        super().__init__()
        if norm != "weight_norm" or causal:
            raise NotImplementedError("the torch port's SEANet is the non-causal weight-norm form")
        self.ratios = list(ratios)
        self.n_residual_layers = n_residual_layers
        mult = 1
        self.conv_in = WNConv1d(channels, n_filters, kernel_size)
        for bi, ratio in enumerate(self.ratios):
            for j in range(n_residual_layers):
                self.add_module(f"block{bi}_res{j}", SEANetResnetBlock(
                    mult * n_filters, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base ** j, 1)))
            self.add_module(f"down{bi}", WNConv1d(mult * n_filters, mult * n_filters * 2,
                                                  ratio * 2, stride=ratio,
                                                  padding=math.ceil(ratio / 2)))
            mult *= 2
        self.lstm = SLSTM(mult * n_filters, lstm) if lstm else None
        self.conv_out = WNConv1d(mult * n_filters, dimension, last_kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for bi in range(len(self.ratios)):
            for j in range(self.n_residual_layers):
                x = getattr(self, f"block{bi}_res{j}")(x)
            x = getattr(self, f"down{bi}")(F.elu(x))
        if self.lstm is not None:
            x = self.lstm(x)
        return self.conv_out(F.elu(x))


class SEANetDecoder(nn.Module):
    """Latents [B, L, dimension] -> audio [B, ~L * prod(ratios), channels]."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 ratios: tp.Sequence[int] = (8, 5, 4, 2), n_residual_layers: int = 1,
                 dilation_base: int = 2, kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, lstm: int = 2, norm: str = "weight_norm",
                 causal: bool = False, final_activation: tp.Optional[str] = None):
        super().__init__()
        if norm != "weight_norm" or causal:
            raise NotImplementedError("the torch port's SEANet is the non-causal weight-norm form")
        self.ratios = list(ratios)
        self.n_residual_layers = n_residual_layers
        self.final_activation = final_activation
        mult = int(2 ** len(self.ratios))
        self.conv_in = WNConv1d(dimension, mult * n_filters, kernel_size)
        self.lstm = SLSTM(mult * n_filters, lstm) if lstm else None
        for bi, ratio in enumerate(self.ratios):
            self.add_module(f"up{bi}", WNConvTranspose1d(
                mult * n_filters, mult * n_filters // 2, ratio, kernel_size=ratio * 2,
                padding=math.ceil(ratio / 2)))
            for j in range(n_residual_layers):
                self.add_module(f"block{bi}_res{j}", SEANetResnetBlock(
                    mult * n_filters // 2, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base ** j, 1)))
            mult //= 2
        self.conv_out = WNConv1d(n_filters, channels, last_kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        if self.lstm is not None:
            x = self.lstm(x)
        for bi in range(len(self.ratios)):
            x = getattr(self, f"up{bi}")(F.elu(x))
            for j in range(self.n_residual_layers):
                x = getattr(self, f"block{bi}_res{j}")(x)
        x = self.conv_out(F.elu(x))
        return torch.tanh(x) if self.final_activation == "tanh" else x
