"""Diffusion Transformer denoiser (counterpart of
friendly_stable_audio_tools_tpu/models/dit.py).

Ported for Stable Audio Open 1.0's configuration: Fourier timestep features
-> MLP, conditioning-token and global-condition MLPs, the global embedding
(the timestep's plus the global condition's) prepended as one token
(`global_cond_type="prepend"`) or fed to every block's adaLN modulation
(`"adaLN"`, JAX dit.py:152-171: nothing is prepended), zero-initialised 1x1
residual convs around the ContinuousTransformer, and CFG by batch-doubling
with optional rescale. In training mode, CFG dropout swaps each batch
element's conditioning tokens for the null embedding with probability
`cfg_dropout_prob` (JAX dit.py:238-247), and so does the prepend
conditioning with a draw of its own.

The JAX module's other inputs (dit.py:135-203): `input_concat_cond` [B,
T', input_concat_dim] joins x over channels (nearest-resampled in time
when T' != T; the inpaint model's mask and masked latents), before the
widened `preprocess_conv`; `prepend_cond` [B, P, prepend_cond_dim] goes
through `to_prepend_embed` and is prepended with its mask
`prepend_cond_mask` [B, P] (ahead of the global token in "prepend" mode);
`patch_size` p folds p frames into one token of p * channels (channel
major, as JAX reshapes) and unfolds the output; `mask` [B, T] (True =
valid frame) masks the self-attention, a patch token being valid if any
of its frames is. Any mask sends the self-attention to the plain route
(models/transformer.py), as in the JAX package.

Layout: x is channels-last [B, T, io_channels]. The module runs in the
dtype of its parameters: inputs are cast to it on entry.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops.convs import Conv1d
from ..ops.embeddings import FourierFeatures
from .transformer import ContinuousTransformer


def _mlp(dim_in: int, dim_out: int, bias: bool = False) -> nn.Sequential:
    return nn.Sequential(nn.Linear(dim_in, dim_out, bias=bias), nn.SiLU(),
                         nn.Linear(dim_out, dim_out, bias=bias))


class DiffusionTransformer(nn.Module):
    def __init__(self, io_channels: int = 32, patch_size: int = 1, embed_dim: int = 768,
                 cond_token_dim: int = 0, project_cond_tokens: bool = True,
                 global_cond_dim: int = 0, project_global_cond: bool = True,
                 input_concat_dim: int = 0, prepend_cond_dim: int = 0, depth: int = 12,
                 num_heads: int = 8, transformer_type: str = "continuous_transformer",
                 global_cond_type: str = "prepend", grad_checkpointing: bool = False,
                 ff_mult: int = 4, **unsupported):
        super().__init__()
        if global_cond_type not in ("prepend", "adaLN"):
            raise ValueError(f"Unknown global_cond_type: {global_cond_type}")
        if transformer_type not in ("continuous_transformer", "x-transformers"):
            raise ValueError(f"Unknown transformer type: {transformer_type}")
        if any(unsupported.values()):
            raise NotImplementedError(f"DiT options not in the torch port: {sorted(unsupported)}")
        self.io_channels = io_channels
        self.patch_size = patch_size
        self.global_cond_type = global_cond_type
        dim_in = io_channels + input_concat_dim
        self.timestep_features = FourierFeatures(1, 256)
        self.to_timestep_embed = _mlp(256, embed_dim, bias=True)
        cond_embed_dim = 0
        if cond_token_dim > 0:
            cond_embed_dim = embed_dim if project_cond_tokens else cond_token_dim
            self.to_cond_embed = _mlp(cond_token_dim, cond_embed_dim)
        if global_cond_dim > 0:
            self.to_global_embed = _mlp(global_cond_dim,
                                        embed_dim if project_global_cond else global_cond_dim)
        if prepend_cond_dim > 0:
            self.to_prepend_embed = _mlp(prepend_cond_dim, embed_dim)
        self.transformer = ContinuousTransformer(
            dim=embed_dim, depth=depth, dim_in=dim_in * patch_size,
            dim_out=io_channels * patch_size,
            dim_heads=embed_dim // num_heads, cross_attend=cond_token_dim > 0,
            cond_token_dim=cond_embed_dim, ff_mult=ff_mult, grad_checkpointing=grad_checkpointing,
            global_cond_dim=embed_dim if global_cond_type == "adaLN" else None)
        self.preprocess_conv = Conv1d(dim_in, dim_in, zero_init=True)
        self.postprocess_conv = Conv1d(io_channels, io_channels, zero_init=True)

    @property
    def dtype(self) -> torch.dtype:
        return self.transformer.project_in.weight.dtype

    def _forward(self, x, t, cross_attn_cond=None, global_embed=None,
                 cross_cfg_skip: bool = False, mask=None, input_concat_cond=None,
                 prepend_cond=None, prepend_cond_mask=None):
        dt = self.dtype
        x = x.to(dt)
        if cross_attn_cond is not None:
            cross_attn_cond = self.to_cond_embed(cross_attn_cond.to(dt))
        prepend, prepend_mask = None, prepend_cond_mask
        if prepend_cond is not None:
            prepend = self.to_prepend_embed(prepend_cond.to(dt))
        if input_concat_cond is not None:
            if input_concat_cond.shape[1] != x.shape[1]:  # nearest in time (JAX dit.py:142-147)
                idx = (torch.arange(x.shape[1], device=x.device) * input_concat_cond.shape[1]
                       ) // x.shape[1]
                input_concat_cond = input_concat_cond[:, idx]
            x = torch.cat([x, input_concat_cond.to(dt)], dim=-1)
        timestep_embed = self.to_timestep_embed(self.timestep_features(t[:, None]).to(dt))
        if global_embed is not None:
            timestep_embed = self.to_global_embed(global_embed.to(dt)) + timestep_embed
        if self.global_cond_type == "prepend":
            token = timestep_embed[:, None, :]
            if prepend is None:
                prepend = token
            else:
                prepend = torch.cat([prepend, token], dim=1)
                if prepend_mask is not None:
                    prepend_mask = torch.cat([prepend_mask.bool(), torch.ones_like(
                        prepend_mask[:, :1], dtype=torch.bool)], dim=1)
        x = self.preprocess_conv(x) + x
        b, t_len, c = x.shape
        p = self.patch_size
        if p > 1:
            x = x.reshape(b, t_len // p, p, c).transpose(2, 3).reshape(b, t_len // p, c * p)
            if mask is not None:  # a patch token is valid if any of its frames is
                mask = mask.bool().reshape(b, t_len // p, p).any(dim=-1)
        out = self.transformer(
            x, prepend_embeds=prepend, prepend_mask=prepend_mask, context=cross_attn_cond,
            cross_cfg_skip=cross_cfg_skip, mask=mask,
            global_cond=timestep_embed if self.global_cond_type == "adaLN" else None)
        if prepend is not None:
            out = out[:, prepend.shape[1]:, :]
        if p > 1:
            tt, cp = out.shape[1], out.shape[2]
            out = out.reshape(b, tt, cp // p, p).transpose(2, 3).reshape(b, tt * p, cp // p)
        return self.postprocess_conv(out) + out

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cross_attn_cond: tp.Optional[torch.Tensor] = None,
                negative_cross_attn_cond: tp.Optional[torch.Tensor] = None,
                negative_cross_attn_mask: tp.Optional[torch.Tensor] = None,
                global_embed: tp.Optional[torch.Tensor] = None, cfg_scale: float = 1.0,
                scale_phi: float = 0.0, cfg_dropout_prob: float = 0.0,
                cfg_dropout_mask: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None,
                input_concat_cond: tp.Optional[torch.Tensor] = None,
                prepend_cond: tp.Optional[torch.Tensor] = None,
                prepend_cond_mask: tp.Optional[torch.Tensor] = None,
                mask: tp.Optional[torch.Tensor] = None,
                prepend_cfg_dropout_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, C], t [B] -> [B, T, C]. With cfg_scale != 1 and
        conditioning tokens or a prepend condition, the batch is doubled
        (cond | null or negative tokens, the prepend condition zeroed) and
        the two halves combined (JAX dit.py:299-363).

        Training mode with cfg_dropout_prob > 0: each element's tokens become
        the null embedding where `cfg_dropout_mask` [B] is True, drawn as
        uniform < cfg_dropout_prob from `generator` when not given; the
        prepend condition likewise by `prepend_cfg_dropout_mask`, a draw of
        its own (JAX dit.py:238-247)."""
        def drop(cond, given):
            if cond is None:
                return None
            if given is None:
                given = torch.rand(cond.shape[0], generator=generator, device=cond.device) \
                    < cfg_dropout_prob
            return torch.where(given.to(cond.device)[:, None, None], torch.zeros_like(cond), cond)

        if self.training and cfg_dropout_prob > 0.0:
            cross_attn_cond = drop(cross_attn_cond, cfg_dropout_mask)
            prepend_cond = drop(prepend_cond, prepend_cfg_dropout_mask)
        extra = dict(mask=mask, input_concat_cond=input_concat_cond,
                     prepend_cond_mask=prepend_cond_mask)
        if cfg_scale == 1.0 or (cross_attn_cond is None and prepend_cond is None):
            return self._forward(x, t, cross_attn_cond, global_embed, prepend_cond=prepend_cond,
                                 **extra)

        batch_cond = None
        if cross_attn_cond is not None:
            null_embed = torch.zeros_like(cross_attn_cond)
            if negative_cross_attn_cond is not None:
                if negative_cross_attn_mask is not None:
                    keep = negative_cross_attn_mask.bool()[:, :, None]
                    negative_cross_attn_cond = torch.where(keep, negative_cross_attn_cond,
                                                           null_embed)
                batch_cond = torch.cat([cross_attn_cond, negative_cross_attn_cond], dim=0)
            else:
                batch_cond = torch.cat([cross_attn_cond, null_embed], dim=0)

        def dup(a):
            return None if a is None else torch.cat([a, a], dim=0)

        batch_prepend = (None if prepend_cond is None else
                         torch.cat([prepend_cond, torch.zeros_like(prepend_cond)], dim=0))
        out = self._forward(dup(x), dup(t), batch_cond, dup(global_embed),
                            cross_cfg_skip=batch_cond is not None and negative_cross_attn_cond is None,
                            prepend_cond=batch_prepend,
                            **{k: dup(v) for k, v in extra.items()})
        cond_output, uncond_output = out.chunk(2, dim=0)
        cfg_output = uncond_output + (cond_output - uncond_output) * cfg_scale
        if scale_phi != 0.0:
            cond_std = cond_output.float().std(dim=-1, keepdim=True, unbiased=False)
            cfg_std = cfg_output.float().std(dim=-1, keepdim=True, unbiased=False)
            rescaled = cfg_output * (cond_std / cfg_std)
            cfg_output = (scale_phi * rescaled + (1.0 - scale_phi) * cfg_output).to(cfg_output.dtype)
        return cfg_output
