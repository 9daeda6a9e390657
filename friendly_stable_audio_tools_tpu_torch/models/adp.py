"""The ADP diffusion U-Net, UNet1d and UNetCFG1d (counterpart of
friendly_stable_audio_tools_tpu/models/adp.py), as Stable Audio 1.0's
`adp_cfg_1d` backbone runs it.

Layout: channels-last [B, T, C]; the conditioning embedding [B, M, E]; the
FiLM mapping vector [B, F]. Parameters keep the JAX package's names and
layouts (conv kernels [k, Cin, Cout]), so utils/convert.py carries a JAX
parameter tree over unchanged; `block1`/`block2` of a ResnetBlock1d become
the `blocks` entries "1" and "2".

The convolutions, norms and projections are plain PyTorch, as the JAX
package leaves them to XLA (ops/convs.py:conv1d). The self-attention goes
through ops/attention.py:scaled_dot_product_attention with the JAX gate: on
the card, T >= 1024 (at Stable Audio 1.0's widths T 4096 and 2048 at head
dim 64, T 1024 at head dim 80) runs the flash kernel K7 without its
log-sum-exp when it serves, and in training K7 with it and the single-pass
backward K8; the T 256 levels and every cross-attention (79 keys) stay
plain.

Numerics as the JAX modules: GELU is the tanh approximation (jax.nn.gelu's
default); LayerNorm eps 1e-6 (flax's default); ConvBlock1d's GroupNorm eps
1e-5, Transformer1d's input GroupNorm 32 groups at eps 1e-6; the attention
multiplies k and v by the context mask rather than masking logits.

Dtype: the U-Net computes in the dtype of its weights. An fp32 model (the
CLIs, the trainer) computes in fp32 throughout. With bf16 weights (bench.py's
recipe, which casts the model's input to bf16 at the call) the input, the
conditioning tokens, the global features and the context channels are cast
to bf16 at entry, and the timestep's Fourier features (computed in fp32, as
the JAX module does) before their first projection, so the whole U-Net and
its gated self-attention run in bf16 (on the card: K7 in bf16). Norm
statistics stay fp32 inside F.group_norm / F.layer_norm, as flax computes
them, and the CFG combination and rescale run in fp32 on the two halves.
The JAX module differs here on purpose: its mapping vector stays fp32 at
bf16 weights (the time features are fp32 and flax promotes an fp32 input
over bf16 weights), so its first FiLM promotes the residual stream to fp32
and its attention runs in fp32 (ROADMAP queue C).

Not in the port (they raise): STFT wrapping, Snake in the resnet blocks,
UNetNCCA1d and XUNet1d.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import scaled_dot_product_attention
from .clap import BiasLayerNorm


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _auto_pad(x: torch.Tensor, k: int, stride: int, dilation: int) -> torch.Tensor:
    """encodec-style auto padding of [B, T, C] (JAX adp.py:33, non-causal):
    pad so every input frame is covered, the larger half on the left."""
    length = x.shape[1]
    keff = (k - 1) * dilation + 1
    padding_total = keff - stride
    n_frames = (length - keff + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (keff - padding_total)
    extra = max(ideal - length, 0)
    hi = padding_total // 2
    lo = padding_total - hi
    return F.pad(x, (0, 0, lo, hi + extra))


class Conv1d(nn.Module):
    """Auto-padded conv (JAX adp.py:51); weight [k, Cin, Cout], bias [Cout]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[0]
        w = self.weight.to(x.dtype)
        if k == 1 and self.stride == 1:
            y = x @ w[0]
        else:
            x = _auto_pad(x, k, self.stride, self.dilation)
            y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=self.stride,
                         dilation=self.dilation).transpose(1, 2)
        return y + self.bias.to(y.dtype)


class ConvTranspose1d(nn.Module):
    """Transposed conv trimmed to T * stride (JAX adp.py:73); weight [k, Cin, Cout]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(kernel_size, in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[0]
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight.to(x.dtype).permute(1, 2, 0),
                               stride=self.stride).transpose(1, 2)
        y = y + self.bias.to(y.dtype)
        padding_total = k - self.stride
        hi = padding_total // 2
        lo = padding_total - hi
        return y[:, lo:y.shape[1] - hi]


def Downsample1d(in_channels: int, out_channels: int, factor: int,
                 kernel_multiplier: int = 2) -> Conv1d:
    if kernel_multiplier % 2:
        raise ValueError("kernel_multiplier must be even")
    return Conv1d(in_channels, out_channels, factor * kernel_multiplier + 1, stride=factor)


class NearestUpsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, factor: int):
        super().__init__()
        self.factor = factor
        self.conv = Conv1d(in_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(self.factor, dim=1))


def Upsample1d(in_channels: int, out_channels: int, factor: int,
               use_nearest: bool = False) -> nn.Module:
    if factor == 1:
        return Conv1d(in_channels, out_channels, 3)
    if use_nearest:
        return NearestUpsample(in_channels, out_channels, factor)
    return ConvTranspose1d(in_channels, out_channels, factor * 2, stride=factor)


class GroupNorm(nn.Module):
    """flax GroupNorm over channels-last [B, T, C]: `num_groups` groups of
    channels, statistics over time and the group, gain `scale`, `bias`."""

    def __init__(self, num_groups: int, channels: int, eps: float):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.transpose(1, 2), self.num_groups, self.scale.to(x.dtype),
                         self.bias.to(x.dtype), self.eps)
        return y.transpose(1, 2)


class ConvBlock1d(nn.Module):
    """GroupNorm -> (FiLM) -> SiLU -> conv (JAX adp.py:126)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, num_groups: int = 8, use_norm: bool = True,
                 use_snake: bool = False):
        super().__init__()
        if use_snake:
            raise NotImplementedError("the ADP blocks' Snake activation is not in the torch port")
        self.groupnorm = GroupNorm(num_groups, in_channels, 1e-5) if use_norm else None
        self.project = Conv1d(in_channels, out_channels, kernel_size, stride=stride,
                              dilation=dilation)

    def forward(self, x: torch.Tensor, scale_shift=None) -> torch.Tensor:
        if self.groupnorm is not None:
            x = self.groupnorm(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return self.project(F.silu(x))


class ResnetBlock1d(nn.Module):
    """Two conv blocks, the second FiLM-modulated from the mapping (its
    `to_scale_shift`: SiLU -> Linear, JAX MappingToScaleShift :155), and a
    1x1 conv on the residual when the width changes (JAX adp.py:169)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, use_norm: bool = True, use_snake: bool = False,
                 num_groups: int = 8, context_mapping_features: tp.Optional[int] = None):
        super().__init__()
        self.blocks = nn.ModuleDict({
            "1": ConvBlock1d(in_channels, out_channels, kernel_size, stride, dilation, num_groups,
                             use_norm, use_snake),
            "2": ConvBlock1d(out_channels, out_channels, num_groups=num_groups, use_norm=use_norm,
                             use_snake=use_snake)})
        self.to_scale_shift = (nn.Sequential(nn.SiLU(), nn.Linear(context_mapping_features,
                                                                  out_channels * 2))
                               if context_mapping_features is not None else None)
        self.to_out = Conv1d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, mapping: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if (self.to_scale_shift is None) != (mapping is None):
            raise ValueError("ResnetBlock1d takes a mapping exactly when it has context_mapping_features")
        h = self.blocks["1"](x)
        scale_shift = None
        if self.to_scale_shift is not None:
            scale_shift = self.to_scale_shift(mapping)[:, None, :].chunk(2, dim=-1)
        h = self.blocks["2"](h, scale_shift=scale_shift)
        return h + (x if self.to_out is None else self.to_out(x))


class Patcher(nn.Module):
    """JAX adp.py:201: a resnet block, then time-major patch packing."""

    def __init__(self, in_channels: int, out_channels: int, patch_size: int,
                 context_mapping_features: tp.Optional[int] = None, use_snake: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.block = ResnetBlock1d(in_channels, out_channels // patch_size, num_groups=1,
                                   context_mapping_features=context_mapping_features,
                                   use_snake=use_snake)

    def forward(self, x: torch.Tensor, mapping: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.block(x, mapping)
        b, t, c = x.shape
        p = self.patch_size
        return x.reshape(b, t // p, p, c).transpose(2, 3).reshape(b, t // p, c * p)


class Unpatcher(nn.Module):
    """JAX adp.py:222: patch unpacking, then a resnet block."""

    def __init__(self, in_channels: int, out_channels: int, patch_size: int,
                 context_mapping_features: tp.Optional[int] = None, use_snake: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.block = ResnetBlock1d(in_channels // patch_size, out_channels, num_groups=1,
                                   context_mapping_features=context_mapping_features,
                                   use_snake=use_snake)

    def forward(self, x: torch.Tensor, mapping: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, cp = x.shape
        p = self.patch_size
        x = x.reshape(b, t, cp // p, p).transpose(2, 3).reshape(b, t * p, cp // p)
        return self.block(x, mapping)


class ADPAttention(nn.Module):
    """Pre-norm attention (JAX adp.py:242): x and the context (x itself for
    self-attention) each LayerNorm-ed, k and v multiplied by the context mask."""

    def __init__(self, features: int, head_features: int, num_heads: int,
                 context_features: tp.Optional[int] = None):
        super().__init__()
        self.num_heads, self.head_features = num_heads, head_features
        mid = head_features * num_heads
        ctx = context_features or features
        self.norm = BiasLayerNorm(features, 1e-6)
        self.norm_context = BiasLayerNorm(ctx, 1e-6)
        self.to_q = nn.Linear(features, mid, bias=False)
        self.to_kv = nn.Linear(ctx, mid * 2, bias=False)
        self.to_out = nn.Linear(mid, features)

    def forward(self, x: torch.Tensor, context: tp.Optional[torch.Tensor] = None,
                context_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        q = self.to_q(self.norm(x))
        k, v = self.to_kv(self.norm_context(context)).chunk(2, dim=-1)
        if context_mask is not None:
            m = context_mask[..., None].to(k.dtype)
            k, v = k * m, v * m

        def heads(a):
            b, n, _ = a.shape
            return a.view(b, n, self.num_heads, self.head_features).transpose(1, 2)

        out = scaled_dot_product_attention(heads(q), heads(k), heads(v))
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class ADPTransformerBlock(nn.Module):
    """Self-attention, cross-attention (with context features), GELU MLP,
    each residual (JAX adp.py:274)."""

    def __init__(self, features: int, num_heads: int, head_features: int, multiplier: int,
                 context_features: tp.Optional[int] = None):
        super().__init__()
        self.attention = ADPAttention(features, head_features, num_heads)
        self.cross_attention = (ADPAttention(features, head_features, num_heads,
                                             context_features=context_features)
                                if context_features else None)
        self.ff0 = nn.Linear(features, features * multiplier)
        self.ff2 = nn.Linear(features * multiplier, features)

    def forward(self, x: torch.Tensor, context=None, context_mask=None) -> torch.Tensor:
        x = self.attention(x) + x
        if self.cross_attention is not None:
            x = self.cross_attention(x, context=context, context_mask=context_mask) + x
        return self.ff2(gelu(self.ff0(x))) + x


class Transformer1d(nn.Module):
    """GroupNorm(32, eps 1e-6) -> 1x1 conv -> blocks -> 1x1 conv, residual
    (JAX adp.py:297)."""

    def __init__(self, num_layers: int, channels: int, num_heads: int, head_features: int,
                 multiplier: int, context_features: tp.Optional[int] = None):
        super().__init__()
        self.norm_in = GroupNorm(32, channels, 1e-6)
        self.conv_in = Conv1d(channels, channels, 1)
        self.blocks = nn.ModuleList([
            ADPTransformerBlock(channels, num_heads, head_features, multiplier, context_features)
            for _ in range(num_layers)])
        self.conv_out = Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context=None, context_mask=None) -> torch.Tensor:
        h = self.conv_in(self.norm_in(x))
        for block in self.blocks:
            h = block(h, context=context, context_mask=context_mask)
        return self.conv_out(h) + x


def _make_transformer(channels, num_transformer_blocks, attention_heads, attention_features,
                      attention_multiplier, context_embedding_features) -> Transformer1d:
    if attention_features is None and attention_heads is not None:
        attention_features = channels // attention_heads
    if attention_heads is None and attention_features is not None:
        attention_heads = channels // attention_features
    return Transformer1d(num_transformer_blocks, channels, attention_heads, attention_features,
                         attention_multiplier, context_embedding_features)


class DownsampleBlock1d(nn.Module):
    """JAX adp.py:332: downsample, resnet blocks, transformer; returns the
    skips of each when use_skip."""

    def __init__(self, in_channels: int, out_channels: int, factor: int, num_groups: int,
                 num_layers: int, kernel_multiplier: int = 2, use_pre_downsample: bool = True,
                 use_skip: bool = False, use_snake: bool = False, context_channels: int = 0,
                 num_transformer_blocks: int = 0, attention_heads=None, attention_features=None,
                 attention_multiplier=None, context_mapping_features=None,
                 context_embedding_features=None):
        super().__init__()
        self.use_pre_downsample, self.use_skip = use_pre_downsample, use_skip
        self.context_channels = context_channels
        ch = out_channels if use_pre_downsample else in_channels
        self.downsample = Downsample1d(in_channels, out_channels, factor, kernel_multiplier)
        self.blocks = nn.ModuleList([
            ResnetBlock1d(ch + context_channels if i == 0 else ch, ch, num_groups=num_groups,
                          context_mapping_features=context_mapping_features, use_snake=use_snake)
            for i in range(num_layers)])
        self.transformer = (_make_transformer(ch, num_transformer_blocks, attention_heads,
                                              attention_features, attention_multiplier,
                                              context_embedding_features)
                            if num_transformer_blocks > 0 else None)

    def forward(self, x, mapping=None, channels=None, embedding=None, embedding_mask=None):
        if self.use_pre_downsample:
            x = self.downsample(x)
        if self.context_channels > 0 and channels is not None:
            x = torch.cat([x, channels.to(x.dtype)], dim=-1)
        skips = []
        for block in self.blocks:
            x = block(x, mapping)
            skips.append(x)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding, context_mask=embedding_mask)
            skips.append(x)
        if not self.use_pre_downsample:
            x = self.downsample(x)
        return (x, skips) if self.use_skip else x


class UpsampleBlock1d(nn.Module):
    """JAX adp.py:383: resnet blocks over the skips (each scaled by 2^-0.5
    with use_skip_scale), transformer, upsample."""

    def __init__(self, in_channels: int, out_channels: int, factor: int, num_layers: int,
                 num_groups: int, use_nearest: bool = False, use_pre_upsample: bool = False,
                 use_skip: bool = False, use_snake: bool = False, skip_channels: int = 0,
                 use_skip_scale: bool = False, num_transformer_blocks: int = 0,
                 attention_heads=None, attention_features=None, attention_multiplier=None,
                 context_mapping_features=None, context_embedding_features=None):
        super().__init__()
        self.use_pre_upsample = use_pre_upsample
        self.skip_scale = 2 ** -0.5 if use_skip_scale else 1.0
        ch = out_channels if use_pre_upsample else in_channels
        self.blocks = nn.ModuleList([
            ResnetBlock1d(ch + skip_channels, ch, num_groups=num_groups,
                          context_mapping_features=context_mapping_features, use_snake=use_snake)
            for _ in range(num_layers)])
        self.transformer = (_make_transformer(ch, num_transformer_blocks, attention_heads,
                                              attention_features, attention_multiplier,
                                              context_embedding_features)
                            if num_transformer_blocks > 0 else None)
        self.upsample = Upsample1d(in_channels, out_channels, factor, use_nearest)

    def forward(self, x, skips=None, mapping=None, embedding=None, embedding_mask=None):
        if self.use_pre_upsample:
            x = self.upsample(x)
        skips = list(skips) if skips is not None else None
        for block in self.blocks:
            if skips is not None:
                x = torch.cat([x, skips.pop() * self.skip_scale], dim=-1)
            x = block(x, mapping)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding, context_mask=embedding_mask)
        if not self.use_pre_upsample:
            x = self.upsample(x)
        return x


class BottleneckBlock1d(nn.Module):
    """JAX adp.py:430: resnet block, transformer, resnet block."""

    def __init__(self, channels: int, num_groups: int, num_transformer_blocks: int = 0,
                 attention_heads=None, attention_features=None, attention_multiplier=None,
                 context_mapping_features=None, context_embedding_features=None,
                 use_snake: bool = False):
        super().__init__()
        self.pre_block = ResnetBlock1d(channels, channels, num_groups=num_groups,
                                       context_mapping_features=context_mapping_features,
                                       use_snake=use_snake)
        self.transformer = (_make_transformer(channels, num_transformer_blocks, attention_heads,
                                              attention_features, attention_multiplier,
                                              context_embedding_features)
                            if num_transformer_blocks > 0 else None)
        self.post_block = ResnetBlock1d(channels, channels, num_groups=num_groups,
                                        context_mapping_features=context_mapping_features,
                                        use_snake=use_snake)

    def forward(self, x, mapping=None, embedding=None, embedding_mask=None):
        x = self.pre_block(x, mapping)
        if self.transformer is not None:
            x = self.transformer(x, context=embedding, context_mask=embedding_mask)
        return self.post_block(x, mapping)


class LearnedPositionalEmbedding(nn.Module):
    """[B] -> [B, dim + 1]: x, sin(2 pi x w), cos(2 pi x w) (JAX conditioners.py:42)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.empty(dim // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None].float()
        freqs = x * self.weights.float()[None, :] * 2 * math.pi
        return torch.cat([x, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class FixedEmbedding(nn.Module):
    """The learned null embedding over token positions (JAX adp.py:459)."""

    def __init__(self, max_length: int, features: int):
        super().__init__()
        self.max_length = max_length
        self.embedding = nn.Embedding(max_length, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, N, F] -> [B, N, features]
        b, n = x.shape[0], x.shape[1]
        if n > self.max_length:
            raise ValueError(f"{n} conditioning tokens, over max_length {self.max_length}")
        return self.embedding.weight[:n][None].expand(b, n, -1)


class UNet1d(nn.Module):
    """JAX adp.py:473, without STFT wrapping."""

    def __init__(self, in_channels: int, channels: int, multipliers: tp.Sequence[int],
                 factors: tp.Sequence[int], num_blocks: tp.Sequence[int],
                 attentions: tp.Sequence[int], patch_size: int = 1, resnet_groups: int = 8,
                 use_context_time: bool = True, kernel_multiplier_downsample: int = 2,
                 use_nearest_upsample: bool = False, use_skip_scale: bool = True,
                 use_snake: bool = False, out_channels: tp.Optional[int] = None,
                 context_features: tp.Optional[int] = None, context_features_multiplier: int = 4,
                 context_channels: tp.Optional[tp.Sequence[int]] = None,
                 context_embedding_features: tp.Optional[int] = None,
                 attention_heads: tp.Optional[int] = None,
                 attention_features: tp.Optional[int] = None,
                 attention_multiplier: tp.Optional[int] = None, use_stft: bool = False,
                 **stft_kwargs):
        super().__init__()
        if use_stft:
            raise NotImplementedError("STFT-wrapped ADP U-Nets are not in the torch port")
        self.num_layers = num_layers = len(multipliers) - 1
        cc = list(context_channels or [])
        self.context_channels = cc + [0] * (num_layers + 1 - len(cc))
        self.use_context_time = use_context_time
        self.use_context_features = context_features is not None
        mapping_features = None
        if use_context_time or self.use_context_features:
            mapping_features = channels * context_features_multiplier
        if use_context_time:
            self.to_time_pos = LearnedPositionalEmbedding(channels)
            self.to_time_lin = nn.Linear(channels + 1, mapping_features)
        if self.use_context_features:
            self.to_features = nn.Linear(context_features, mapping_features)
        if mapping_features is not None:
            self.to_mapping_0 = nn.Linear(mapping_features, mapping_features)
            self.to_mapping_2 = nn.Linear(mapping_features, mapping_features)
        self.to_in = Patcher(in_channels + self.context_channels[0], channels * multipliers[0],
                             patch_size, mapping_features, use_snake)
        attn = dict(attention_heads=attention_heads, attention_features=attention_features,
                    attention_multiplier=attention_multiplier,
                    context_mapping_features=mapping_features,
                    context_embedding_features=context_embedding_features)
        for i in range(num_layers):
            self.add_module(f"down{i}", DownsampleBlock1d(
                in_channels=channels * multipliers[i], out_channels=channels * multipliers[i + 1],
                factor=factors[i], kernel_multiplier=kernel_multiplier_downsample,
                num_groups=resnet_groups, num_layers=num_blocks[i],
                context_channels=self.context_channels[i + 1], use_pre_downsample=True,
                use_skip=True, use_snake=use_snake, num_transformer_blocks=attentions[i], **attn))
        self.bottleneck = BottleneckBlock1d(
            channels=channels * multipliers[-1], num_groups=resnet_groups,
            num_transformer_blocks=attentions[-1], use_snake=use_snake, **attn)
        for j, i in enumerate(reversed(range(num_layers))):
            self.add_module(f"up{j}", UpsampleBlock1d(
                in_channels=channels * multipliers[i + 1], out_channels=channels * multipliers[i],
                factor=factors[i], use_nearest=use_nearest_upsample, num_groups=resnet_groups,
                num_layers=num_blocks[i] + (1 if attentions[i] else 0),
                use_skip_scale=use_skip_scale, use_pre_upsample=False, use_skip=True,
                use_snake=use_snake, skip_channels=channels * multipliers[i + 1],
                num_transformer_blocks=attentions[i], **attn))
        self.to_out = Unpatcher(channels * multipliers[0], out_channels or in_channels,
                                patch_size, mapping_features, use_snake)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the U-Net computes in: its weights'."""
        return self.to_in.block.blocks["1"].project.weight.dtype

    def forward(self, x: torch.Tensor, time: tp.Optional[torch.Tensor] = None,
                features: tp.Optional[torch.Tensor] = None, channels_list=None,
                embedding: tp.Optional[torch.Tensor] = None,
                embedding_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """Returns [B, T, out_channels] in the weights' dtype; the inputs are
        cast to it (time stays fp32 through its Fourier features)."""
        dt = self.dtype
        x = x.to(dt)
        embedding = None if embedding is None else embedding.to(dt)
        items = []
        if self.use_context_time:
            items.append(gelu(self.to_time_lin(self.to_time_pos(time).to(dt))))
        if self.use_context_features:
            items.append(gelu(self.to_features(features.to(dt))))
        mapping = None
        if items:
            mapping = sum(items)
            mapping = gelu(self.to_mapping_2(gelu(self.to_mapping_0(mapping))))

        has_context = [c > 0 for c in self.context_channels]
        channels_ids = [sum(has_context[:i]) for i in range(len(has_context))]

        def get_channels(layer):
            if not has_context[layer]:
                return None
            if channels_list is None:
                raise ValueError("this U-Net takes context channels: channels_list is missing")
            return channels_list[channels_ids[layer]]

        ctx0 = get_channels(0)
        if ctx0 is not None:
            x = torch.cat([x, ctx0.to(x.dtype)], dim=-1)
        x = self.to_in(x, mapping)
        skips_list = [x]
        for i in range(self.num_layers):
            x, skips = getattr(self, f"down{i}")(x, mapping=mapping, channels=get_channels(i + 1),
                                                 embedding=embedding, embedding_mask=embedding_mask)
            skips_list.append(skips)
        x = self.bottleneck(x, mapping=mapping, embedding=embedding, embedding_mask=embedding_mask)
        for j in range(self.num_layers):
            x = getattr(self, f"up{j}")(x, skips=skips_list.pop(), mapping=mapping,
                                        embedding=embedding, embedding_mask=embedding_mask)
        x = x + skips_list.pop()
        return self.to_out(x, mapping)


class UNetCFG1d(nn.Module):
    """UNet1d with classifier-free guidance against a learned null
    embedding (JAX adp.py:658): with embedding_scale != 1, the batch is
    doubled (conditioned | null or negative embedding) or run twice, the
    halves combined, and, with rescale_cfg, the result's std over the
    channel axis pulled towards the conditioned output's by scale_phi.
    In training with embedding_mask_proba > 0 (CFG dropout, JAX :749-752),
    each batch row's embedding becomes the null one where a Bernoulli draw
    of that probability from `generator` is set, or where
    `cfg_dropout_mask` [B] is True when given; the embedding mask stays."""

    def __init__(self, context_embedding_max_length: int, context_embedding_features: int,
                 in_channels: int, channels: int, multipliers: tp.Sequence[int],
                 factors: tp.Sequence[int], num_blocks: tp.Sequence[int],
                 attentions: tp.Sequence[int], use_xattn_time: bool = False, **kwargs):
        super().__init__()
        self.use_xattn_time = use_xattn_time
        self.context_embedding_features = context_embedding_features
        self.fixed_embedding = FixedEmbedding(
            context_embedding_max_length + (1 if use_xattn_time else 0), context_embedding_features)
        if use_xattn_time:
            self.to_time_embedding_pos = LearnedPositionalEmbedding(channels)
            self.to_time_embedding_lin = nn.Linear(channels + 1, context_embedding_features)
        self.unet = UNet1d(in_channels=in_channels, channels=channels, multipliers=multipliers,
                           factors=factors, num_blocks=num_blocks, attentions=attentions,
                           context_embedding_features=context_embedding_features, **kwargs)

    def forward(self, x: torch.Tensor, time: torch.Tensor, embedding: torch.Tensor,
                embedding_mask: tp.Optional[torch.Tensor] = None, embedding_scale: float = 1.0,
                embedding_mask_proba: float = 0.0, batch_cfg: bool = True,
                rescale_cfg: bool = False, scale_phi: float = 0.4,
                negative_embedding: tp.Optional[torch.Tensor] = None,
                negative_embedding_mask: tp.Optional[torch.Tensor] = None,
                features: tp.Optional[torch.Tensor] = None, channels_list=None,
                cfg_dropout_mask: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        b = embedding.shape[0]
        dt = self.unet.dtype
        embedding = embedding.to(dt)
        if self.use_xattn_time:
            t_emb = gelu(self.to_time_embedding_lin(self.to_time_embedding_pos(time).to(dt)))
            embedding = torch.cat([embedding, t_emb[:, None, :]], dim=1)
            if embedding_mask is not None:
                embedding_mask = torch.cat([embedding_mask, embedding_mask.new_ones(b, 1)], dim=1)
        fixed = self.fixed_embedding(embedding)
        if embedding_mask_proba > 0.0 and self.training:
            if cfg_dropout_mask is None:
                cfg_dropout_mask = torch.rand(b, generator=generator,
                                              device=embedding.device) < embedding_mask_proba
            drop = cfg_dropout_mask.to(device=embedding.device, dtype=torch.bool)[:, None, None]
            embedding = torch.where(drop, fixed, embedding)
        kw = dict(features=features, channels_list=channels_list)
        if embedding_scale == 1.0:
            return self.unet(x, time, embedding=embedding, embedding_mask=embedding_mask, **kw)
        if batch_cfg:
            if negative_embedding is not None:
                if negative_embedding_mask is not None:
                    keep = negative_embedding_mask.bool()[:, :, None]
                    negative_embedding = torch.where(keep, negative_embedding.to(dt), fixed)
                null = negative_embedding.to(dt)
            else:
                null = fixed

            def two(a):
                return None if a is None else torch.cat([a, a], dim=0)

            out = self.unet(
                two(x), two(time), features=two(features),
                channels_list=None if channels_list is None else [two(c) for c in channels_list],
                embedding=torch.cat([embedding, null], dim=0), embedding_mask=two(embedding_mask))
            out, out_masked = out.chunk(2, dim=0)
        else:
            out = self.unet(x, time, embedding=embedding, embedding_mask=embedding_mask, **kw)
            out_masked = self.unet(x, time, embedding=fixed, embedding_mask=embedding_mask, **kw)
        out, out_masked = out.float(), out_masked.float()  # the combination in fp32
        out_cfg = out_masked + (out - out_masked) * embedding_scale
        if not rescale_cfg:
            return out_cfg
        out_std = out.std(dim=-1, keepdim=True, correction=0)
        out_cfg_std = out_cfg.std(dim=-1, keepdim=True, correction=0)
        return scale_phi * (out_cfg * (out_std / out_cfg_std)) + (1 - scale_phi) * out_cfg
