"""The DAC-type VAE encoder and decoder (counterpart of
friendly_stable_audio_tools_tpu/models/dac_codec.py:25-139), as Stable Audio
1.0's `dac` encoder and decoder configs build them.

Each layer keeps the JAX structure: a single-parameter Snake applied on its
own (ops/activations.py), then a weight-normed conv. Every stride-1 'same'
conv runs the fused snake -> conv kernel K2 with no snake, each decoder
upsample the polyphase transposed-conv kernel K4 with no snake
(ops/kernels/conv1d.py), as the JAX package sends them to its Pallas K2 and
K4; the encoder's strided downsample is the plain reshape-GEMM form
(ops/convs.py:snake_downsample_conv1d), as the JAX package leaves it to XLA.
Under grad (AE-GAN training) the kernels run forward and their plain
versions are differentiated (ops/kernels/conv1d.py). Channels-last [B, T, C]. The residual-VQ codec (`DACCodecModule`,
`DACCodec`) is not in the port.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops.activations import Snake
from ..ops.convs import WNConv1d, WNConvTranspose1d


class DACResidualUnit(nn.Module):
    """x + conv1x1(snake2(conv7_dil(snake1(x)))) (JAX :25)."""

    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.snake1 = Snake(dim)
        self.conv1 = WNConv1d(dim, dim, 7, dilation=dilation)
        self.snake2 = Snake(dim)
        self.conv2 = WNConv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.snake2(self.conv1(self.snake1(x))))


class DACEncoderBlock(nn.Module):
    """Three residual units at dim / 2 (dilations 1, 3, 9), snake, strided
    downsample to dim (JAX :38)."""

    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.res = nn.ModuleList([DACResidualUnit(dim // 2, d) for d in (1, 3, 9)])
        self.snake = Snake(dim // 2)
        self.down = WNConv1d(dim // 2, dim, 2 * stride, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in self.res:
            x = unit(x)
        return self.down(self.snake(x))


class DACEncoder(nn.Module):
    """dac.model.dac.Encoder: d_model doubles per stride (JAX :52)."""

    def __init__(self, d_model: int = 64, strides: tp.Sequence[int] = (2, 4, 8, 8),
                 d_latent: int = 64, in_channels: int = 1):
        super().__init__()
        self.conv_in = WNConv1d(in_channels, d_model, 7)
        dims = [d_model * 2 ** (i + 1) for i in range(len(strides))]
        self.blocks = nn.ModuleList([DACEncoderBlock(d, s) for d, s in zip(dims, strides)])
        self.snake_out = Snake(dims[-1])
        self.conv_out = WNConv1d(dims[-1], d_latent, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.blocks:
            x = block(x)
        return self.conv_out(self.snake_out(x))


class DACDecoderBlock(nn.Module):
    """snake, transposed-conv upsample by `rate` (one K4 launch), three
    residual units (JAX :73)."""

    def __init__(self, in_dim: int, out_dim: int, rate: int):
        super().__init__()
        self.snake = Snake(in_dim)
        self.up = WNConvTranspose1d(in_dim, out_dim, rate)
        self.res = nn.ModuleList([DACResidualUnit(out_dim, d) for d in (1, 3, 9)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.up(self.snake(x))
        for unit in self.res:
            x = unit(x)
        return x


class DACDecoder(nn.Module):
    """dac.model.dac.Decoder: channels halve per rate, tanh out (JAX :88)."""

    def __init__(self, input_channel: int = 64, channels: int = 1536,
                 rates: tp.Sequence[int] = (8, 8, 4, 2), d_out: int = 1):
        super().__init__()
        self.conv_in = WNConv1d(input_channel, channels, 7)
        self.blocks = nn.ModuleList([DACDecoderBlock(channels // 2 ** i, channels // 2 ** (i + 1), r)
                                     for i, r in enumerate(rates)])
        ch = channels // 2 ** len(rates)
        self.snake_out = Snake(ch)
        self.conv_out = WNConv1d(ch, d_out, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.blocks:
            x = block(x)
        return torch.tanh(self.conv_out(self.snake_out(x)))


class DACEncoderWrapper(nn.Module):
    """DACEncoder to d_model * 2^len(strides) channels, then a linear
    projection to latent_dim when given (JAX :108)."""

    def __init__(self, in_channels: int = 1, latent_dim: tp.Optional[int] = None,
                 d_model: int = 64, strides: tp.Sequence[int] = (2, 4, 8, 8)):
        super().__init__()
        out_dim = d_model * 2 ** len(strides)
        self.encoder = DACEncoder(d_model=d_model, strides=strides, d_latent=out_dim,
                                  in_channels=in_channels)
        self.proj_out = nn.Linear(out_dim, latent_dim) if latent_dim is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encoder(x)
        if self.proj_out is None:
            return x
        # flax's Dense computes in the promoted dtype of input and fp32 kernel
        return self.proj_out(x.to(self.proj_out.weight.dtype))


class DACDecoderWrapper(nn.Module):
    """reference autoencoders.py:222-231 (JAX :128)."""

    def __init__(self, latent_dim: int, out_channels: int = 1, channels: int = 1536,
                 rates: tp.Sequence[int] = (8, 8, 4, 2)):
        super().__init__()
        self.decoder = DACDecoder(input_channel=latent_dim, channels=channels, rates=rates,
                                  d_out=out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(x)
