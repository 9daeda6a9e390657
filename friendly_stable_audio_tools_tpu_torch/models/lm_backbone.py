"""Audio LM backbone (counterpart of
friendly_stable_audio_tools_tpu/models/lm_backbone.py:31-121).

A causal ContinuousTransformer with input and output projections at the
embedding width and cross-attention to the conditioning tokens (projected
to the embedding width by a two-layer SiLU MLP when
`project_cross_attn_cond` is set), and the static-KV-cache decode of
generation (`init_cache`, `decode_step`). Prepended conditioning tokens
(which the JAX backbone masks in self-attention and writes into the
caches' key mask) are not ported yet.
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

    def _context(self, prepend_cond, cross_attn_cond):
        if prepend_cond is not None:
            raise NotImplementedError("prepended conditioning is not in the torch port")
        if cross_attn_cond is not None and self.cross_attn_cond_dim > 0 \
                and self.project_cross_attn_cond:
            cross_attn_cond = self.to_cross_attn_embed(cross_attn_cond)
        return cross_attn_cond

    def forward(self, x: torch.Tensor, prepend_cond: tp.Optional[torch.Tensor] = None,
                prepend_cond_mask: tp.Optional[torch.Tensor] = None,
                cross_attn_cond: tp.Optional[torch.Tensor] = None,
                global_cond: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, S, embed_dim] -> [B, S, embed_dim]; global_cond (which the
        backbone takes no width for) is ignored, as in the JAX package."""
        return self.model(x, context=self._context(prepend_cond, cross_attn_cond))

    def init_cache(self, batch: int, max_len: int, prepend_len: int = 0,
                   dtype: torch.dtype = torch.float32) -> tp.List[tp.Dict[str, tp.Any]]:
        """One static cache per layer, on the backbone's device: zeroed k and v
        [batch, heads, prepend_len + max_len, head_dim], the per-key mask
        `kmask` [batch, prepend_len + max_len] (all True) and the write index
        0 (a Python int: the host loop knows it, so slicing needs no sync)."""
        if prepend_len:
            raise NotImplementedError("prepended conditioning is not in the torch port")
        m = self.model
        shape = (batch, m.dim // m.dim_heads, max_len + prepend_len, m.dim_heads)
        device = m.layers[0].ff_norm.gamma.device
        return [{"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device),
                 "kmask": torch.ones(batch, shape[2], dtype=torch.bool, device=device),
                 "index": 0} for _ in m.layers]

    def decode_step(self, x: torch.Tensor, caches: tp.List[tp.Dict[str, tp.Any]],
                    cross_attn_cond: tp.Optional[torch.Tensor] = None,
                    prepend_cond: tp.Optional[torch.Tensor] = None,
                    prepend_cond_mask: tp.Optional[torch.Tensor] = None,
                    global_cond: tp.Optional[torch.Tensor] = None):
        """x [B, n, embed_dim] continuing the cached sequence -> ([B, n,
        embed_dim], caches), the caches updated in place. The conditioning
        is projected anew at every step, as the JAX decode_step does."""
        return self.model(x, context=self._context(prepend_cond, cross_attn_cond),
                          kv_caches=caches)
