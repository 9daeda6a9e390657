"""The Dance Diffusion U-Net, DiffusionAttnUnet1D (`DAU1d`), and its blocks
(counterpart of friendly_stable_audio_tools_tpu/models/dance_diffusion.py).

Layout: channels-last [B, T, C]. Module and parameter names are the JAX
package's (`level{i}_in0`, `level{i}_attn3`, `timestep_embed`, `conv1`,
`gn1`, `qkv_proj`, ...), conv kernels keep its [k, Cin, Cout] layout and
GroupNorms its `scale` and `bias`, so utils/convert.py carries a JAX tree
over by its generic rules.

Numerics as the JAX modules: GELU is the tanh approximation
(jax.nn.gelu's default), every GroupNorm is flax's with one group (the
statistics over time and all channels, :class:`GroupNorm1`) at eps 1e-6, the fixed cubic
resamplers pad by reflection (:class:`AADownsample1d`,
:class:`AAUpsample1d`), and a condition of another length is interpolated
by the JAX formula (`linspace(0, L - 1, T)` with floor and ceil weights),
not `F.interpolate`. Convolutions and norms are plain PyTorch, as the JAX
package leaves them to XLA.

The self-attention (`SelfAttention1d`, c // 32 heads of 32 channels) goes
through ops/attention.py:scaled_dot_product_attention with the JAX gate: on
the card, where a level runs at least 1024 tokens (from 262,144 samples at
the shipped configs' depth 14 and 5 attention levels; 8192, 4096, 2048 and
1024 tokens at generate_diffusion_uncond's default 2,097,152), the fp32
flash kernel K7 at head dim 32 serves it; under grad there ``FlashAttention``
runs K7 with its LSE, then K8 at 1024-4096 tokens and K9 at 8192 (head dim
32, as the JAX package picks them by K8's plan). At the configs' own
sample sizes (65,536 and 131,072) the largest attention is 256 and 512
tokens, which stays plain.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import Snake
from ..ops.attention import scaled_dot_product_attention
from ..ops.embeddings import FourierFeatures
from .adp import GroupNorm, gelu

_KERNELS = {
    "linear": [1 / 8, 3 / 8, 3 / 8, 1 / 8],
    "cubic": [-0.01171875, -0.03515625, 0.11328125, 0.43359375,
              0.43359375, 0.11328125, -0.03515625, -0.01171875],
    "lanczos3": [0.003689131001010537, 0.015056144446134567, -0.03399861603975296,
                 -0.066637322306633, 0.13550527393817902, 0.44638532400131226,
                 0.44638532400131226, 0.13550527393817902, -0.066637322306633,
                 -0.03399861603975296, 0.015056144446134567, 0.003689131001010537],
}


class Conv1d(nn.Module):
    """Conv with explicit padding and stride (JAX ops/convs.py:Conv1d);
    weight [k, Cin, Cout], optional bias; fan-in uniform initialisation
    (utils/common.init_weights_)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if w.shape[0] == 1 and self.stride == 1 and self.padding == 0:
            y = x @ w[0]
        else:
            y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=self.stride,
                         padding=self.padding).transpose(1, 2)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ConvTranspose1d(nn.Module):
    """Transposed conv of torch's output length (T - 1) s - 2p + k (JAX
    ops/convs.py:ConvTranspose1d); weight [k, Cin, Cout], bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight.to(x.dtype).permute(1, 2, 0),
                               stride=self.stride, padding=self.padding).transpose(1, 2)
        return y + self.bias.to(y.dtype)


class AADownsample1d(nn.Module):
    """Fixed antialiasing kernel, stride 2, depthwise (JAX :36-49): reflect
    pad of len(k) // 2 - 1, then the kernel's correlation at stride 2."""

    scale = 1.0

    def __init__(self, kernel: str = "cubic"):
        super().__init__()
        self.taps = [v * self.scale for v in _KERNELS[kernel]]
        self._kernels: tp.Dict[tp.Tuple, torch.Tensor] = {}  # by device and dtype

    def kernel(self, x: torch.Tensor) -> torch.Tensor:
        """The taps [C, 1, k] for x [B, C, T] (made once per device and dtype;
        no buffer, so a model built on the meta device needs no re-init)."""
        key = (x.device, x.dtype)
        if key not in self._kernels:
            self._kernels[key] = torch.tensor(self.taps, dtype=x.dtype, device=x.device)
        return self._kernels[key].expand(x.shape[1], 1, len(self.taps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = len(self.taps) // 2 - 1
        x = F.pad(x.transpose(1, 2), (pad, pad), mode="reflect")
        return F.conv1d(x, self.kernel(x), stride=2, groups=x.shape[1]).transpose(1, 2)


class AAUpsample1d(AADownsample1d):
    """Fixed antialiasing transposed conv, stride 2 (JAX :52-77): reflect
    pad of (pad + 1) // 2 each side (pad = len(k) // 2 - 1), the depthwise
    transposed conv with the kernel times 2 (the JAX package's input-dilated
    correlation with the flipped kernel), trimmed by 2 pad + 1 each side:
    exactly 2T samples."""

    scale = 2.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = len(self.taps) // 2 - 1
        x = F.pad(x.transpose(1, 2), ((pad + 1) // 2,) * 2, mode="reflect")
        return F.conv_transpose1d(x, self.kernel(x), stride=2, padding=2 * pad + 1,
                                  groups=x.shape[1]).transpose(1, 2)


class GroupNorm1(GroupNorm):
    """flax's GroupNorm with one group over [B, T, C]: the statistics over
    time and all channels, eps 1e-6, gain `scale` and `bias` per channel.
    The statistics come from one whole-tensor reduction per element
    (`var_mean`) and the normalisation from one pass: torch's group_norm
    reduces each (batch, group) row in a single block, which at one group
    is one block per clip (220 ms for [1, 2,097,152, 128] fp32 on the H100,
    90% of a U-Net forward)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(1, channels, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=(1, 2), unbiased=False, keepdim=True)
        a = self.scale.float() * torch.rsqrt(var + self.eps)
        return torch.addcmul(self.bias.float(), x32 - mean, a).to(x.dtype)


class ResConvBlock(nn.Module):
    """conv -> GroupNorm -> GELU (or Snake), twice, with a 1x1 `skip` conv
    where the width changes (JAX :80-111); the last block of the U-Net ends
    on its second conv."""

    def __init__(self, c_in: int, c_mid: int, c_out: int, is_last: bool = False,
                 kernel_size: int = 5, conv_bias: bool = True, use_snake: bool = False):
        super().__init__()
        self.is_last = is_last
        self.skip = Conv1d(c_in, c_out, 1, use_bias=False) if c_in != c_out else None
        pad = kernel_size // 2
        self.conv1 = Conv1d(c_in, c_mid, kernel_size, padding=pad, use_bias=conv_bias)
        self.gn1 = GroupNorm1(c_mid)
        self.act1 = Snake(c_mid) if use_snake else None
        self.conv2 = Conv1d(c_mid, c_out, kernel_size, padding=pad, use_bias=conv_bias)
        if not is_last:
            self.gn2 = GroupNorm1(c_out)
            self.act2 = Snake(c_out) if use_snake else None

    @staticmethod
    def _act(act: tp.Optional[nn.Module], x: torch.Tensor) -> torch.Tensor:
        return gelu(x) if act is None else act(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.skip is None else self.skip(x)
        h = self._act(self.act1, self.gn1(self.conv1(x)))
        h = self.conv2(h)
        if not self.is_last:
            h = self._act(self.act2, self.gn2(h))
        return h + res


class SelfAttention1d(nn.Module):
    """GroupNorm -> 1x1 qkv conv -> attention over `n_head` heads -> 1x1 out
    conv, residual (JAX :114-131)."""

    def __init__(self, c_in: int, n_head: int = 1):
        super().__init__()
        self.n_head = n_head
        self.norm = GroupNorm1(c_in)
        self.qkv_proj = Conv1d(c_in, c_in * 3, 1)
        self.out_proj = Conv1d(c_in, c_in, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        qkv = self.qkv_proj(self.norm(x)).view(b, t, 3, self.n_head, c // self.n_head)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        y = scaled_dot_product_attention(q, k, v)
        return x + self.out_proj(y.transpose(1, 2).reshape(b, t, c))


class DiffusionAttnUnet1D(nn.Module):
    """The recursive U-Net (JAX :134-255): level 1 at the input rate, level
    i (2 .. depth) after i - 1 halvings, each with three ResConvBlocks down
    and three up around the inner levels, self-attention after each from
    level depth - n_attn_layers on; timestep Fourier features (16) and an
    optional condition (`cond_dim` channels, with `cond_noise_aug` its aug
    level's features too) concatenated to the input."""

    def __init__(self, io_channels: int = 2, depth: int = 14, n_attn_layers: int = 6,
                 channels: tp.Sequence[int] = (128, 128, 256, 256) + (512,) * 10,
                 cond_dim: int = 0, cond_noise_aug: bool = False, kernel_size: int = 5,
                 learned_resample: bool = False, strides: tp.Sequence[int] = (2,) * 13,
                 conv_bias: bool = True, use_snake: bool = False):
        super().__init__()
        self.io_channels, self.depth, self.cond_dim = io_channels, depth, cond_dim
        self.cond_noise_aug = cond_noise_aug
        self.learned_resample = learned_resample
        self.channels, self.strides = list(channels), [1] + list(strides)
        self.timestep_embed = FourierFeatures(1, 16)

        def block(c_in, c_mid, c_out, is_last=False):
            return ResConvBlock(c_in, c_mid, c_out, is_last=is_last, kernel_size=kernel_size,
                                conv_bias=conv_bias, use_snake=use_snake)

        c = self.channels[0]
        in_c = io_channels + cond_dim + (32 if cond_noise_aug else 16)
        self.level1_in0, self.level1_in1, self.level1_in2 = block(in_c, c, c), block(c, c, c), \
            block(c, c, c)
        self.level1_out0, self.level1_out1 = block(2 * c, c, c), block(c, c, c)
        self.level1_out2 = block(c, c, io_channels, is_last=True)
        attn_layer = depth - n_attn_layers
        for i in range(2, depth + 1):
            c, c_prev, stride = self.channels[i - 1], self.channels[i - 2], self.strides[i - 1]
            if learned_resample or stride == 1:
                k = stride * 2 + 1 if stride > 1 else 3
                down = Conv1d(c_prev, c_prev, k, stride=stride, padding=k // 2)
            else:
                down = AADownsample1d("cubic")
            setattr(self, f"level{i}_down", down)
            for name, (ci, co) in {"in0": (c_prev, c), "in1": (c, c), "in2": (c, c),
                                   "out0": (2 * c, c), "out1": (c, c), "out2": (c, c_prev)}.items():
                setattr(self, f"level{i}_{name}", block(ci, co if name != "out2" else c, co))
            if i >= attn_layer and n_attn_layers > 0:
                for j in range(5):
                    setattr(self, f"level{i}_attn{j}", SelfAttention1d(c, c // 32))
                setattr(self, f"level{i}_attn5", SelfAttention1d(c_prev, c_prev // 32))
            if learned_resample:
                up = ConvTranspose1d(c_prev, c_prev, stride * 2, stride=stride,
                                     padding=stride // 2 + stride % 2)
            else:
                up = AAUpsample1d("cubic")
            setattr(self, f"level{i}_up", up)

    def _level(self, h: torch.Tensor, i: int) -> torch.Tensor:
        if i > self.depth:
            return h

        def attn(j, h):
            m = getattr(self, f"level{i}_attn{j}", None)
            return h if m is None else m(h)

        h = getattr(self, f"level{i}_down")(h)
        for j, name in enumerate(("in0", "in1", "in2")):
            h = attn(j, getattr(self, f"level{i}_{name}")(h))
        h = torch.cat([self._level(h, i + 1), h], dim=-1)
        for j, name in enumerate(("out0", "out1", "out2")):
            h = attn(3 + j, getattr(self, f"level{i}_{name}")(h))
        return getattr(self, f"level{i}_up")(h)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: tp.Optional[torch.Tensor] = None,
                cond_aug_scale: tp.Optional[float] = None,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, io_channels], t [B], cond [B, L, cond_dim] (interpolated
        to T where L differs) -> [B, T, io_channels]. With `cond_noise_aug`
        the aug level is `cond_aug_scale` (a draw in [0, 1) per element
        when None) and the condition's noise comes from `generator`."""
        b, length = x.shape[:2]
        te = self.timestep_embed(t[:, None]).to(x.dtype)
        inputs = [x, te[:, None, :].expand(b, length, te.shape[-1])]
        if cond is not None:
            if cond.shape[1] != length:  # the JAX formula, not F.interpolate (JAX :156-163)
                src = torch.linspace(0, cond.shape[1] - 1, length, device=cond.device)
                lo = torch.floor(src).long()
                hi = (lo + 1).clamp_max(cond.shape[1] - 1)
                w = (src - lo)[None, :, None]
                cond = cond[:, lo, :] * (1 - w) + cond[:, hi, :] * w
            if self.cond_noise_aug:
                if cond_aug_scale is None:
                    aug = torch.rand(cond.shape[0], generator=generator, device=cond.device)
                else:
                    aug = torch.full((cond.shape[0],), float(cond_aug_scale), device=cond.device)
                noise = torch.randn(cond.shape, generator=generator, device=cond.device)
                cond = cond + noise * aug[:, None, None]
                # the aug level's features reuse timestep_embed's weights (JAX :164-173)
                ae = self.timestep_embed(aug[:, None]).to(x.dtype)
                inputs.append(ae[:, None, :].expand(b, length, ae.shape[-1]))
            inputs.append(cond.to(x.dtype))
        h = torch.cat(inputs, dim=-1)
        h = self.level1_in2(self.level1_in1(self.level1_in0(h)))
        inner = self._level(h, 2) if self.depth > 1 else h
        h = torch.cat([inner, h], dim=-1)
        return self.level1_out2(self.level1_out1(self.level1_out0(h)))


class DAU1DCondWrapper(DiffusionAttnUnet1D):
    """The `DAU1d` backbone behind the conditioned wrapper's argument names
    (JAX models/diffusion.py:235-237, the reference's DAU1DCondWrapper): the
    input-concat condition becomes `cond`; the CFG and dropout arguments
    that the samplers and the trainer pass are accepted and unused, as the
    JAX adapter swallows them; `generator` draws the condition's noise
    augmentation."""

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                input_concat_cond: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None,
                cond_aug_scale: tp.Optional[float] = None, **unused) -> torch.Tensor:
        return super().forward(x, t, cond=input_concat_cond, cond_aug_scale=cond_aug_scale,
                               generator=generator)
