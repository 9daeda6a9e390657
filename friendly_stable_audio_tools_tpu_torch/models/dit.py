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
`cfg_dropout_prob` (JAX dit.py:238-247). Other options of the JAX module
(patching, input-concat and prepend conditioning) raise
NotImplementedError.

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
        if patch_size != 1 or input_concat_dim or prepend_cond_dim:
            raise NotImplementedError("the torch port's DiT runs without patching, input-concat "
                                      "or prepend conditioning")
        if global_cond_type not in ("prepend", "adaLN"):
            raise ValueError(f"Unknown global_cond_type: {global_cond_type}")
        if transformer_type not in ("continuous_transformer", "x-transformers"):
            raise ValueError(f"Unknown transformer type: {transformer_type}")
        if any(unsupported.values()):
            raise NotImplementedError(f"DiT options not in the torch port: {sorted(unsupported)}")
        self.io_channels = io_channels
        self.global_cond_type = global_cond_type
        self.timestep_features = FourierFeatures(1, 256)
        self.to_timestep_embed = _mlp(256, embed_dim, bias=True)
        cond_embed_dim = 0
        if cond_token_dim > 0:
            cond_embed_dim = embed_dim if project_cond_tokens else cond_token_dim
            self.to_cond_embed = _mlp(cond_token_dim, cond_embed_dim)
        if global_cond_dim > 0:
            self.to_global_embed = _mlp(global_cond_dim,
                                        embed_dim if project_global_cond else global_cond_dim)
        self.transformer = ContinuousTransformer(
            dim=embed_dim, depth=depth, dim_in=io_channels, dim_out=io_channels,
            dim_heads=embed_dim // num_heads, cross_attend=cond_token_dim > 0,
            cond_token_dim=cond_embed_dim, ff_mult=ff_mult, grad_checkpointing=grad_checkpointing,
            global_cond_dim=embed_dim if global_cond_type == "adaLN" else None)
        self.preprocess_conv = Conv1d(io_channels, io_channels, zero_init=True)
        self.postprocess_conv = Conv1d(io_channels, io_channels, zero_init=True)

    @property
    def dtype(self) -> torch.dtype:
        return self.transformer.project_in.weight.dtype

    def _forward(self, x, t, cross_attn_cond=None, global_embed=None,
                 cross_cfg_skip: bool = False):
        dt = self.dtype
        x = x.to(dt)
        if cross_attn_cond is not None:
            cross_attn_cond = self.to_cond_embed(cross_attn_cond.to(dt))
        timestep_embed = self.to_timestep_embed(self.timestep_features(t[:, None]).to(dt))
        if global_embed is not None:
            timestep_embed = self.to_global_embed(global_embed.to(dt)) + timestep_embed
        x = self.preprocess_conv(x) + x
        if self.global_cond_type == "adaLN":
            out = self.transformer(x, global_cond=timestep_embed, context=cross_attn_cond,
                                   cross_cfg_skip=cross_cfg_skip)
        else:
            out = self.transformer(x, prepend_embeds=timestep_embed[:, None, :],
                                   context=cross_attn_cond, cross_cfg_skip=cross_cfg_skip)
            out = out[:, 1:, :]
        return self.postprocess_conv(out) + out

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cross_attn_cond: tp.Optional[torch.Tensor] = None,
                negative_cross_attn_cond: tp.Optional[torch.Tensor] = None,
                negative_cross_attn_mask: tp.Optional[torch.Tensor] = None,
                global_embed: tp.Optional[torch.Tensor] = None, cfg_scale: float = 1.0,
                scale_phi: float = 0.0, cfg_dropout_prob: float = 0.0,
                cfg_dropout_mask: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, C], t [B] -> [B, T, C]. With cfg_scale != 1 and
        conditioning tokens, the batch is doubled (cond | null or negative
        tokens) and the two halves combined (JAX dit.py:299-363).

        Training mode with cfg_dropout_prob > 0: each element's tokens become
        the null embedding where `cfg_dropout_mask` [B] is True, drawn as
        uniform < cfg_dropout_prob from `generator` when not given."""
        if self.training and cfg_dropout_prob > 0.0 and cross_attn_cond is not None:
            if cfg_dropout_mask is None:
                u = torch.rand(cross_attn_cond.shape[0], generator=generator,
                               device=cross_attn_cond.device)
                cfg_dropout_mask = u < cfg_dropout_prob
            cross_attn_cond = torch.where(cfg_dropout_mask.to(cross_attn_cond.device)[:, None, None],
                                          torch.zeros_like(cross_attn_cond), cross_attn_cond)
        if cfg_scale == 1.0 or cross_attn_cond is None:
            return self._forward(x, t, cross_attn_cond, global_embed)

        null_embed = torch.zeros_like(cross_attn_cond)
        if negative_cross_attn_cond is not None:
            if negative_cross_attn_mask is not None:
                keep = negative_cross_attn_mask.bool()[:, :, None]
                negative_cross_attn_cond = torch.where(keep, negative_cross_attn_cond, null_embed)
            batch_cond = torch.cat([cross_attn_cond, negative_cross_attn_cond], dim=0)
        else:
            batch_cond = torch.cat([cross_attn_cond, null_embed], dim=0)

        def dup(a):
            return None if a is None else torch.cat([a, a], dim=0)

        out = self._forward(dup(x), dup(t), batch_cond, dup(global_embed),
                            cross_cfg_skip=negative_cross_attn_cond is None)
        cond_output, uncond_output = out.chunk(2, dim=0)
        cfg_output = uncond_output + (cond_output - uncond_output) * cfg_scale
        if scale_phi != 0.0:
            cond_std = cond_output.float().std(dim=-1, keepdim=True, unbiased=False)
            cfg_std = cfg_output.float().std(dim=-1, keepdim=True, unbiased=False)
            rescaled = cfg_output * (cond_std / cfg_std)
            cfg_output = (scale_phi * rescaled + (1.0 - scale_phi) * cfg_output).to(cfg_output.dtype)
        return cfg_output
