"""Audio LM backbone (counterpart of
friendly_stable_audio_tools_tpu/models/lm_backbone.py:31-90, the forward).

A causal ContinuousTransformer with input and output projections at the
embedding width and cross-attention to the conditioning tokens (projected
to the embedding width by a two-layer SiLU MLP when
`project_cross_attn_cond` is set). Prepended conditioning tokens (which the
JAX backbone masks in self-attention) and the static-KV-cache decode of
generation are not ported yet.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .transformer import ContinuousTransformer


def mlp_embed(dim_in: int, dim_out: int) -> nn.Sequential:
    """Linear -> SiLU -> Linear, no biases (JAX `_MLPEmbed`, children "0" and "2")."""
    return nn.Sequential(nn.Linear(dim_in, dim_out, bias=False), nn.SiLU(),
                         nn.Linear(dim_out, dim_out, bias=False))


class ContinuousTransformerAudioLMBackbone(nn.Module):
    def __init__(self, embed_dim: int, cross_attn_cond_dim: int = 0, prepend_cond_dim: int = 0,
                 project_cross_attn_cond: bool = False, depth: int = 12, num_heads: int = 8,
                 ff_mult: int = 4, qk_norm: bool = False):
        super().__init__()
        if qk_norm or prepend_cond_dim:
            raise NotImplementedError("qk_norm and prepended conditioning are not in the torch port")
        self.embed_dim = embed_dim
        self.cross_attn_cond_dim = cross_attn_cond_dim
        self.project_cross_attn_cond = project_cross_attn_cond
        self.model = ContinuousTransformer(
            dim=embed_dim, depth=depth, dim_heads=embed_dim // num_heads, dim_in=embed_dim,
            dim_out=embed_dim, cross_attend=cross_attn_cond_dim > 0,
            cond_token_dim=embed_dim if project_cross_attn_cond else cross_attn_cond_dim,
            ff_mult=ff_mult, causal=True)
        if cross_attn_cond_dim > 0 and project_cross_attn_cond:
            self.to_cross_attn_embed = mlp_embed(cross_attn_cond_dim, embed_dim)

    def forward(self, x: torch.Tensor, prepend_cond: tp.Optional[torch.Tensor] = None,
                prepend_cond_mask: tp.Optional[torch.Tensor] = None,
                cross_attn_cond: tp.Optional[torch.Tensor] = None,
                global_cond: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, S, embed_dim] -> [B, S, embed_dim]; global_cond (which the
        backbone takes no width for) is ignored, as in the JAX package."""
        if prepend_cond is not None:
            raise NotImplementedError("prepended conditioning is not in the torch port")
        if cross_attn_cond is not None and self.cross_attn_cond_dim > 0 \
                and self.project_cross_attn_cond:
            cross_attn_cond = self.to_cross_attn_embed(cross_attn_cond)
        return self.model(x, context=cross_attn_cond)
