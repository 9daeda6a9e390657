"""1-D convolutions, channels-last (counterpart of
friendly_stable_audio_tools_tpu/ops/convs.py).

Layout: weights keep the JAX package's `[k, Cin, Cout]` layout, which is
what the CUDA kernels read, so converted checkpoints need no transpose
(torch's own Conv1d keeps `[Cout, Cin, k]`). Weight norm follows torch's
`weight_norm(dim=0)`: the magnitude `g` is per OUTPUT channel for a conv and
per INPUT channel for a transposed conv (whose dim 0 is in_channels).
`fold_weight_norm_` replaces `v` and `g` by the plain weight they give
(`kernel`, the same [k, Cin, Cout] layout; JAX models/utils.py:59-80, eps
1e-12), which the kernels then read as before.

The weight-normed convs run in the forms the Oobleck and SEANet codecs use:
stride-1 'same' convs through the fused snake -> conv kernel K2,
ConvTranspose1d(k = 2s, stride s, padding s/2) at an even s through K4
(ops/kernels/conv1d.py), and the encoder's strided downsample Conv1d(k =
2s, stride s, padding s/2) at an even s dividing T in the plain
reshape-GEMM form of `snake_downsample_conv1d`. Other strided forms (the
SEANet's stride 5, JAX ops/convs.py:249-277, :347-371) take a plain
convolution, as the JAX package leaves them to XLA; they take no snake.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from .kernels import conv1d as conv_kernels


def snake_downsample_conv1d(x: torch.Tensor, w: torch.Tensor, bias: tp.Optional[torch.Tensor],
                            alpha: tp.Optional[torch.Tensor], inv_beta: tp.Optional[torch.Tensor],
                            stride: int) -> torch.Tensor:
    """snake(x) -> Conv1d(k = 2s, stride s, padding s/2), x [B, T, Cin] with
    s | T, w [2s, Cin, Cout] -> [B, T/s, Cout] (JAX ops/pallas/conv1d.py:315,
    plain XLA there, so no kernel). The padded input viewed as rows of s
    samples [T/s + 1, s*Cin] puts each output's window in two consecutive
    rows, so the conv is two GEMMs over a free reshape. The snake runs in
    fp32 (snake(0) == 0, so padding after it is exact) and is rounded to x's
    dtype before the products; products accumulate in fp32 (per GEMM in x's
    dtype on the card). One batch element at a time: the fp32 snake
    temporaries of a whole batch at 2M samples would take tens of GB."""
    b, t, cin = x.shape
    k, _, cout = w.shape
    s = stride
    if k != 2 * s or s % 2 or t % s:
        raise ValueError(f"snake_downsample_conv1d takes k = 2s, an even s dividing T; "
                         f"got k = {k}, s = {s}, T = {t}")
    dt = x.dtype
    wf = w.to(dt).reshape(k * cin, cout)
    out = []
    for xb in x.split(1):
        if alpha is not None:
            xb = conv_kernels.snake(xb.float(), alpha.float(), inv_beta.float()).to(dt)
        xr = F.pad(xb[0], (0, 0, s // 2, s // 2)).reshape(t // s + 1, s * cin)
        y = (xr[:-1] @ wf[:s * cin]).float() + (xr[1:] @ wf[s * cin:]).float()
        if bias is not None:
            y = y + bias.float()
        out.append(y.to(dt))
    return torch.stack(out)


class Conv1d(nn.Module):
    """Pointwise (k = 1) conv without bias, weight [1, Cin, Cout]: the DiT's
    residual pre/post projections."""

    def __init__(self, in_channels: int, out_channels: int, zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(1, in_channels, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight[0].to(x.dtype)


class WeightNormed(nn.Module):
    """The weight-norm parameters `v`, `g` and their fold into `kernel`."""

    def _init_weight_norm(self, kernel_size: int, in_channels: int, out_channels: int,
                          gains: int) -> None:
        self.kernel_size = kernel_size
        self.v = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels))
        self.g = nn.Parameter(torch.empty(gains))
        self.register_parameter("kernel", None)

    def _normed(self) -> torch.Tensor:
        raise NotImplementedError

    def weight(self) -> torch.Tensor:
        """The fp32 conv weight [k, Cin, Cout]."""
        return self.kernel.float() if self.kernel is not None else self._normed()

    @torch.no_grad()
    def fold_weight_norm_(self) -> None:
        """Replaces `v` and `g` by `kernel` = the weight they give, in v's dtype."""
        if self.kernel is None:
            self.kernel = nn.Parameter(self._normed().to(self.v.dtype),
                                       requires_grad=self.v.requires_grad)
            self.v = None
            self.g = None


class WNConv1d(WeightNormed):
    """Weight-normalised conv: w = g * v / ||v||_(k, in) per output channel.
    Stride 1 with 'same' padding (K2), or a strided conv with `padding`
    (default stride // 2): the encoders' downsample with kernel_size = 2 *
    stride in the reshape-GEMM form where the JAX package takes it, else a
    plain convolution."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, use_bias: bool = True, stride: int = 1,
                 padding: tp.Optional[int] = None):
        super().__init__()
        self.dilation = dilation
        self.stride = stride
        self.padding = stride // 2 if padding is None else padding
        self._init_weight_norm(kernel_size, in_channels, out_channels, out_channels)
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def _normed(self) -> torch.Tensor:
        v = self.v.float()
        return v * (self.g.float() / (v.square().sum(dim=(0, 1)).sqrt() + 1e-12))

    def forward(self, x: torch.Tensor, snake: tp.Optional[tp.Tuple] = None) -> torch.Tensor:
        alpha, inv_beta = snake if snake is not None else (None, None)
        s, k = self.stride, self.kernel_size
        if s > 1 and s % 2 == 0 and k == 2 * s and self.padding == s // 2 and x.shape[1] % s == 0:
            return snake_downsample_conv1d(x, self.weight(), self.bias, alpha, inv_beta, s)
        if s > 1:
            if snake is not None:
                raise NotImplementedError("a strided conv outside the downsample form takes no snake")
            y = F.conv1d(x.transpose(1, 2), self.weight().to(x.dtype).permute(2, 1, 0),
                         stride=s, padding=self.padding)
            y = y.transpose(1, 2)
            return y if self.bias is None else y + self.bias.to(y.dtype)
        return conv_kernels.snake_conv1d(x, self.weight(), self.bias, alpha, inv_beta,
                                         dilation=self.dilation)


class WNConvTranspose1d(WeightNormed):
    """Weight-normalised ConvTranspose1d, norm per input channel: k = 2s,
    stride s, padding s/2 at an even s through K4; any other kernel size,
    padding or odd stride (the SEANet decoder's stride 5) as a plain
    transposed convolution of torch's output length (T - 1) s - 2p + k."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, use_bias: bool = True,
                 kernel_size: tp.Optional[int] = None, padding: tp.Optional[int] = None):
        super().__init__()
        self.stride = stride
        self.padding = stride // 2 if padding is None else padding
        kernel_size = 2 * stride if kernel_size is None else kernel_size
        self._init_weight_norm(kernel_size, in_channels, out_channels, in_channels)
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def _normed(self) -> torch.Tensor:
        v = self.v.float()
        return v * (self.g.float() / (v.square().sum(dim=(0, 2)).sqrt() + 1e-12))[None, :, None]

    def forward(self, x: torch.Tensor, snake: tp.Optional[tp.Tuple] = None) -> torch.Tensor:
        alpha, inv_beta = snake if snake is not None else (None, None)
        s, k = self.stride, self.kernel_size
        if s % 2 == 0 and k == 2 * s and self.padding == s // 2:
            return conv_kernels.snake_conv_transpose1d(x, self.weight(), self.bias, alpha,
                                                       inv_beta, stride=s)
        if snake is not None:
            raise NotImplementedError("a transposed conv outside the K4 form takes no snake")
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight().to(x.dtype).permute(1, 2, 0),
                               stride=s, padding=self.padding)
        y = y.transpose(1, 2)
        return y if self.bias is None else y + self.bias.to(y.dtype)
