"""T5 text encoder (counterpart of friendly_stable_audio_tools_tpu/models/t5.py).

RMS norms, a relative position bias computed by layer 0 and shared by every
layer, unscaled attention, ReLU feed-forward (the t5-* checkpoints; the
JAX package's flan-t5 gated-GELU variants are not ported). Runs once per
prompt, in the dtype of its parameters (fp32 in the slice).
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import RMSNorm


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


T5_CONFIGS: tp.Dict[str, T5Config] = {
    "t5-small": T5Config(d_model=512, d_ff=2048, num_layers=6, num_heads=8),
    "t5-base": T5Config(),
    "t5-large": T5Config(d_model=1024, d_ff=4096, num_layers=24, num_heads=16),
    "t5-3b": T5Config(d_model=1024, d_kv=128, d_ff=16384, num_layers=24, num_heads=32),
    "t5-11b": T5Config(d_model=1024, d_kv=128, d_ff=65536, num_layers=24, num_heads=128),
}


def relative_position_bucket(rel: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 bucketing of relative positions (key - query)."""
    num_buckets //= 2
    ret = (rel > 0).long() * num_buckets
    n = rel.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact + 1e-6)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = large.clamp_max(num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.relative_attention_bias = (
            nn.Parameter(torch.empty(cfg.relative_attention_num_buckets, cfg.num_heads))
            if has_relative_bias else None)

    def forward(self, x, mask=None, position_bias=None):
        cfg = self.cfg
        b, t, _ = x.shape

        def heads(a):
            return a.view(b, t, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        if self.relative_attention_bias is not None:
            pos = torch.arange(t, device=x.device)
            buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                               cfg.relative_attention_num_buckets,
                                               cfg.relative_attention_max_distance)
            position_bias = self.relative_attention_bias[buckets].permute(2, 0, 1)[None].float()
        logits = q.float() @ k.float().transpose(-1, -2)  # T5 attention is unscaled
        if position_bias is not None:
            logits = logits + position_bias
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, t, -1)
        return self.o(out), position_bias


class T5FF(nn.Module):
    """ReLU feed-forward of the original T5 checkpoints."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.relu(self.wi(x)))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.attn = T5Attention(cfg, has_relative_bias)
        self.ln2 = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.ff = T5FF(cfg)

    def forward(self, x, mask=None, position_bias=None):
        attn, position_bias = self.attn(self.ln1(x), mask=mask, position_bias=position_bias)
        x = x + attn
        return x + self.ff(self.ln2(x)), position_bias


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.blocks = nn.ModuleList([T5Block(cfg, has_relative_bias=(i == 0))
                                     for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor, attention_mask: tp.Optional[torch.Tensor] = None):
        x = self.shared(input_ids)
        position_bias = None
        for block in self.blocks:
            x, position_bias = block(x, mask=attention_mask, position_bias=position_bias)
        return self.final_layer_norm(x)
