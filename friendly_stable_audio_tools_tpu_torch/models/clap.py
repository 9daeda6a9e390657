"""CLAP text encoder: the RoBERTa text branch and the laion-clap text
projection (counterpart of friendly_stable_audio_tools_tpu/models/clap.py).

Stable Audio 2.0 conditions its DiT on the per-token hidden states of the
second-to-last RoBERTa layer (`text_features(layer_ix=-2)`, 768 wide); the
pooled, projected and L2-normalised 512-d joint embedding is the other
output. Post-LN encoder layers with exact-erf GELU, LayerNorm eps 1e-5,
key-padding mask filled with -1e9 before an fp32 softmax. Plain PyTorch:
RoBERTa's attention at 77 tokens is an XLA einsum in the JAX package, not a
Pallas kernel. Module and parameter names follow the JAX tree, so
utils/convert.py carries its weights over unchanged; `clap_text_state_dict`
there reads a laion-clap checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1


class BiasLayerNorm(nn.Module):
    """LayerNorm with gain `scale` and `bias` (flax `nn.LayerNorm`), fp32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, self.eps)


class RobertaSelfAttention(nn.Module):
    """JAX clap.py:42."""

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape

        def heads(a):
            return a.view(b, t, self.num_heads, d // self.num_heads).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(d // self.num_heads)
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        probs = logits.softmax(-1).to(v.dtype)
        return (probs @ v).transpose(1, 2).reshape(b, t, d)


class RobertaLayer(nn.Module):
    """Post-LN encoder layer (JAX clap.py:68)."""

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        d = cfg.hidden_size
        self.attention = RobertaSelfAttention(cfg)
        self.attention_output = nn.Linear(d, d)
        self.attention_layernorm = BiasLayerNorm(d, cfg.layer_norm_eps)
        self.intermediate = nn.Linear(d, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, d)
        self.output_layernorm = BiasLayerNorm(d, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.attention_layernorm(x + self.attention_output(self.attention(x, mask)))
        h = self.output(F.gelu(self.intermediate(x), approximate="none"))
        return self.output_layernorm(x + h)


class RobertaModel(nn.Module):
    """Embeddings + encoder (JAX clap.py:86). Returns the last hidden state,
    or (last, [embeddings, layer 1, ..., layer N]) with `return_hidden_states`."""

    def __init__(self, cfg: RobertaConfig = RobertaConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d)
        self.embeddings_layernorm = BiasLayerNorm(d, cfg.layer_norm_eps)
        self.layers = nn.ModuleList([RobertaLayer(cfg) for _ in range(cfg.num_layers)])

    def forward(self, input_ids: torch.Tensor, attention_mask: tp.Optional[torch.Tensor] = None,
                return_hidden_states: bool = False):
        mask = (torch.ones_like(input_ids, dtype=torch.bool) if attention_mask is None
                else attention_mask.bool())
        # RoBERTa positions: pad_id + 1 + running count over non-pad tokens
        positions = torch.cumsum(mask.long(), dim=1) * mask + self.cfg.pad_token_id
        x = (self.word_embeddings(input_ids) + self.position_embeddings(positions)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        x = self.embeddings_layernorm(x)
        hidden_states = [x]
        for layer in self.layers:
            x = layer(x, mask)
            hidden_states.append(x)
        return (x, hidden_states) if return_hidden_states else x


class CLAPTextBranch(nn.Module):
    """RoBERTa + the laion-clap text projection, Linear-ReLU-Linear to
    `joint_embed_dim` (JAX clap.py:116). `joint_embed_dim=None` leaves the
    projection out, as the JAX module has no projection weights when only
    `text_features` is called."""

    def __init__(self, cfg: RobertaConfig = RobertaConfig(),
                 joint_embed_dim: tp.Optional[int] = 512):
        super().__init__()
        self.text_branch = RobertaModel(cfg)
        if joint_embed_dim is not None:
            self.projection_0 = nn.Linear(cfg.hidden_size, joint_embed_dim)
            self.projection_2 = nn.Linear(joint_embed_dim, joint_embed_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> the L2-normalised joint text embedding [B, joint_embed_dim],
        pooled from the first (<s>) token."""
        pooled = self.text_branch(input_ids, attention_mask)[:, 0]
        h = self.projection_2(F.relu(self.projection_0(pooled)))
        return h / h.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    def text_features(self, input_ids: torch.Tensor,
                      attention_mask: tp.Optional[torch.Tensor] = None,
                      layer_ix: int = -1) -> torch.Tensor:
        """Per-token hidden states [B, N, hidden] of `hidden_states[layer_ix]`
        (JAX clap.py:138)."""
        _, hs = self.text_branch(input_ids, attention_mask, return_hidden_states=True)
        return hs[layer_ix]
