"""Continuous transformer backbone of the DiT (counterpart of
friendly_stable_audio_tools_tpu/models/transformer.py).

Ported for the configurations Stable Audio Open 1.0 and the audio LM run:
pre-norm blocks with fused-qkv self-attention under partial rotary embedding
(through the K1 kernel, or K5/K6 when training, ops/kernels/attention.py),
cross-attention over conditioning tokens (plain, ops/attention.py), a SwiGLU
feed-forward and zero-initialised branch outputs. The causal stack of the
audio LM (`causal=True`, JAX transformer.py:199-236) ropes q and k outside
the kernel and sends its square causal self-attention through
ops/attention.py's gate (the causal K7 and K9 on the card); its
cross-attention is causal too, as the JAX block builds it, and stays plain.
A stack built with `global_cond_dim` (the DiT's `global_cond_type="adaLN"`)
modulates each block's norms and gates its residual branches from a global
condition (TransformerBlock; the fused K11/K12 of ops/kernels/elementwise.py
with `fused_ew`). In training mode with `grad_checkpointing` each block is
recomputed in the backward pass (JAX transformer.py:619-627). A key mask
[B, T] (the DiT's padding or prepend masks) sends the self-attention to
the plain masked route, whose masked rows are zeroed (JAX :199-212,
:298-301); mask-free calls keep the kernel routes above. Everything is
channels-last [B, T, C].
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention, scaled_dot_product_attention
from ..ops.embeddings import apply_rotary_pos_emb, rotary_freqs
from ..ops.kernels import attention as attn_kernels
from ..ops.kernels import elementwise
from ..ops.kernels import mlp as mlp_kernels
from ..ops.norms import LayerNorm


def zero_init(module: nn.Module) -> nn.Module:
    """Marks a projection as zero-initialised (see utils/common.init_weights_)."""
    module.zero_init = True
    return module


class GLU(nn.Module):
    """x * silu(gate) after a doubled projection."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.silu(gate)


class FeedForward(nn.Module):
    """SwiGLU MLP with a zero-initialised output projection.

    With `fused_mlp` set (the JAX package's FSAT_FUSED_MLP switch, which
    `create_model_from_config(..., fused_mlp=True)` sets on every
    FeedForward) the chain runs as one call of the fused kernel K13
    (ops/kernels/mlp.py) where the JAX package runs its Pallas `glu_mlp`
    (models/transformer.py:103-123): when inner % 128 == 0 (`pick_block_j`'s
    rule) and no input needs a gradient (under grad the JAX custom_vjp
    differentiates the plain chain, so the kernel never trains); the output
    bias is added after it."""

    def __init__(self, dim: int, mult: int = 4, zero_init_output: bool = True):
        super().__init__()
        inner = int(dim * mult)
        self.inner = inner
        self.fused_mlp = False
        self.linear_in = GLU(dim, inner)
        self.linear_out = nn.Linear(inner, dim)
        if zero_init_output:
            zero_init(self.linear_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj, out = self.linear_in.proj, self.linear_out
        if self.fused_mlp and self.inner % 128 == 0 and not (torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, proj.weight, proj.bias, out.weight))):
            y = mlp_kernels.glu_mlp(x, proj.weight, proj.bias, out.weight)
            return y + out.bias.to(y.dtype)
        return out(self.linear_in(x))


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache: tp.Dict[str, tp.Any]) -> torch.Tensor:
    """Causal self-attention of n new tokens through a layer's static KV
    cache (JAX Attention :239-264): their roped k and v are written at
    `index` into fixed [B, H, L, D] buffers, which this port updates in
    place (JAX returns new buffers); the query at absolute position index + i
    sees the keys at positions <= index + i that the persisted per-key mask
    `kmask` [B, L] keeps (the new tokens' entries are written True: the port
    has no prepended conditioning, whose padding the JAX prefill writes
    there). The masked attention over the whole buffer stays plain, as the
    JAX gate sends any masked call to `_xla_attention`."""
    idx, n, length = cache["index"], q.shape[-2], cache["k"].shape[-2]
    cache["k"][:, :, idx:idx + n] = k
    cache["v"][:, :, idx:idx + n] = v
    cache["kmask"][:, idx:idx + n] = True
    cache["index"] = idx + n
    visible = torch.ones(n, length, dtype=torch.bool, device=q.device).tril_(idx)
    mask = visible & cache["kmask"][:, None, None, :]
    return scaled_dot_product_attention(q, cache["k"], cache["v"], mask=mask)


class Attention(nn.Module):
    """Self-attention (fused to_qkv, rotary, K1 kernel) or, with
    `dim_context`, cross-attention (to_q + packed to_kv; a context narrower
    than `dim` has fewer kv heads, each shared by consecutive q heads).
    `causal` (the audio LM): the self-attention ropes q and k in fp32 and
    goes through ops/attention.py's gate with causal set, or with `kv_cache`
    through :func:`cached_attention`; the cross-attention masks as
    `_xla_attention` does (JAX :319-322): with no cache, so a single decode
    query (Tq 1) sees the whole context, where the training forward's
    queries see a triangle of it (JAX :278-283). Its `to_kv(context)` runs
    at every call, in decode too, as the JAX block's does."""

    def __init__(self, dim: int, dim_heads: int = 64, dim_context: tp.Optional[int] = None,
                 zero_init_output: bool = True, causal: bool = False):
        super().__init__()
        self.dim = dim
        self.causal = causal
        self.dim_heads = dim_heads
        self.heads = dim // dim_heads
        self.dim_context = dim_context
        if dim_context:
            self.to_q = nn.Linear(dim, dim, bias=False)
            self.to_kv = nn.Linear(dim_context, dim_context * 2, bias=False)
        else:
            self.to_qkv = nn.Linear(dim, dim * 3, bias=False)
        self.to_out = nn.Linear(dim, dim, bias=False)
        if zero_init_output:
            zero_init(self.to_out)

    def forward(self, x: torch.Tensor, context: tp.Optional[torch.Tensor] = None,
                rotary_pos_emb: tp.Optional[torch.Tensor] = None,
                kv_len: tp.Optional[int] = None,
                kv_cache: tp.Optional[tp.Dict[str, tp.Any]] = None,
                mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        if context is None and mask is not None:
            return self._masked_self_attention(x, rotary_pos_emb, mask)
        if context is None and self.causal:
            q, k, v = (t.view(b, n, self.heads, self.dim_heads).transpose(1, 2)
                       for t in self.to_qkv(x).chunk(3, dim=-1))
            if rotary_pos_emb is not None:
                q = apply_rotary_pos_emb(q, rotary_pos_emb)
                k = apply_rotary_pos_emb(k, rotary_pos_emb)
            if kv_cache is not None:
                out = cached_attention(q, k, v, kv_cache)
            else:
                out = scaled_dot_product_attention(q, k, v, causal=True)
            return self.to_out(out.transpose(1, 2).reshape(b, n, self.dim))
        if context is None:
            qkv = self.to_qkv(x)
            out = attn_kernels.fused_qkv_rope_attention(qkv, rotary_pos_emb, self.heads,
                                                        kv_len=kv_len)
            return self.to_out(out)
        q = self.to_q(x).view(b, n, self.heads, self.dim_heads).transpose(1, 2)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        kv_heads = self.dim_context // self.dim_heads
        k = k.reshape(b, -1, kv_heads, self.dim_heads).transpose(1, 2)
        v = v.reshape(b, -1, kv_heads, self.dim_heads).transpose(1, 2)
        if self.causal:
            out = scaled_dot_product_attention(q, k, v, causal=True)
        else:
            out = attention(q, k, v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, self.dim))

    def _masked_self_attention(self, x: torch.Tensor, rotary_pos_emb: tp.Optional[torch.Tensor],
                               mask: torch.Tensor) -> torch.Tensor:
        """Self-attention under a key mask [B, T] (True = valid; JAX :199-212,
        :290-301): q and k roped in fp32 outside any kernel, the attention
        through ops/attention.py's gate, which sends every masked call to the
        plain path as the JAX gate sends it to `_xla_attention`, and the
        masked positions' outputs zeroed after the projection."""
        b, n, _ = x.shape
        q, k, v = (t.view(b, n, self.heads, self.dim_heads).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        if rotary_pos_emb is not None:
            q = apply_rotary_pos_emb(q, rotary_pos_emb)
            k = apply_rotary_pos_emb(k, rotary_pos_emb)
        mask = mask.bool()
        out = scaled_dot_product_attention(q, k, v, mask=mask, causal=self.causal)
        out = self.to_out(out.transpose(1, 2).reshape(b, n, self.dim))
        return torch.where(mask[:, :, None], out, torch.zeros_like(out))


class TransformerBlock(nn.Module):
    """Pre-norm block: self-attention, optional cross-attention, SwiGLU FF.

    With `global_cond_dim` and a `global_cond` [B, global_cond_dim] (the
    DiT's adaLN conditioning, JAX models/transformer.py:395-425), a
    zero-initialised `to_scale_shift_gate` maps silu(global_cond) to six
    [B, 1, dim] vectors (scale, shift and gate of the self-attention site,
    then of the feed-forward site): each pre-norm modulates its LayerNorm
    (K11, `ln_modulate`) and each branch joins the residual through
    ``y * sigmoid(1 - gate) + residual`` (K12, `gated_residual`), the
    kernels taken where `fused_ew` is set (ops/kernels/elementwise.py); the
    cross-attention adds plainly."""

    def __init__(self, dim: int, dim_heads: int = 64, cross_attend: bool = False,
                 dim_context: tp.Optional[int] = None, zero_init_branch_outputs: bool = True,
                 ff_mult: int = 4, causal: bool = False,
                 global_cond_dim: tp.Optional[int] = None):
        super().__init__()
        self.fused_ew = False
        self.global_cond_dim = global_cond_dim
        self.pre_norm = LayerNorm(dim)
        self.self_attn = Attention(dim, dim_heads, zero_init_output=zero_init_branch_outputs,
                                   causal=causal)
        if cross_attend:
            self.cross_attend_norm = LayerNorm(dim)
            self.cross_attn = Attention(dim, dim_heads, dim_context=dim_context,
                                        zero_init_output=zero_init_branch_outputs, causal=causal)
        self.ff_norm = LayerNorm(dim)
        self.ff = FeedForward(dim, mult=ff_mult, zero_init_output=zero_init_branch_outputs)
        if global_cond_dim:
            self.to_scale_shift_gate = zero_init(nn.Linear(global_cond_dim, dim * 6, bias=False))

    def _cross(self, x: torch.Tensor, context: torch.Tensor, cross_cfg_skip: bool) -> torch.Tensor:
        if cross_cfg_skip:
            # CFG batch-doubling: the second half's context is the all-zero
            # null embedding and every projection on the K/V path is
            # biasless, so its cross-attention output is exactly zero
            # (models/transformer.py:370-381 of the JAX package)
            half = x.shape[0] // 2
            out = self.cross_attn(self.cross_attend_norm(x[:half]), context=context[:half])
            return torch.cat([out, torch.zeros_like(out)], dim=0)
        return self.cross_attn(self.cross_attend_norm(x), context=context)

    def forward(self, x: torch.Tensor, context: tp.Optional[torch.Tensor] = None,
                rotary_pos_emb: tp.Optional[torch.Tensor] = None, kv_len: tp.Optional[int] = None,
                cross_cfg_skip: bool = False,
                kv_cache: tp.Optional[tp.Dict[str, tp.Any]] = None,
                global_cond: tp.Optional[torch.Tensor] = None,
                mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.global_cond_dim and global_cond is not None:
            ssg = self.to_scale_shift_gate(F.silu(global_cond))[:, None, :]
            scale_self, shift_self, gate_self, scale_ff, shift_ff, gate_ff = ssg.chunk(6, dim=-1)
            attn = self.self_attn(self.pre_norm(x, scale_shift=(scale_self, shift_self)),
                                  rotary_pos_emb=rotary_pos_emb, kv_len=kv_len, kv_cache=kv_cache,
                                  mask=mask)
            x = elementwise.gated_residual(attn, gate_self, x, enabled=self.fused_ew)
            if context is not None:
                x = x + self._cross(x, context, cross_cfg_skip)
            ff = self.ff(self.ff_norm(x, scale_shift=(scale_ff, shift_ff)))
            return elementwise.gated_residual(ff, gate_ff, x, enabled=self.fused_ew)
        x = x + self.self_attn(self.pre_norm(x), rotary_pos_emb=rotary_pos_emb, kv_len=kv_len,
                               kv_cache=kv_cache, mask=mask)
        if context is not None:
            x = x + self._cross(x, context, cross_cfg_skip)
        return x + self.ff(self.ff_norm(x))


def seq_pad_length(valid_len: int, batch: int, dim_heads: int, heads: int) -> tp.Optional[int]:
    """Padded length of the padded-sequence rule, or None to run unpadded
    (models/transformer.py:543-582 of the JAX package).

    The residual stream is padded once to a 16-multiple (head-pair-eligible
    stacks at batch >= 4) or a 128-multiple, K/V masked at the true length
    inside the attention kernel, and the padding sliced off after the stack;
    it engages only when the padding is at most 4% of the sequence and the
    sequence is at least 1024 long."""
    pair_16 = (dim_heads == 64 and heads % 2 == 0 and (valid_len + 15) // 16 * 16 <= 2048
               and batch >= 4)
    align = 16 if pair_16 else 128
    padded = (valid_len + align - 1) // align * align
    if valid_len < 1024 or dim_heads > 128 or padded == valid_len:
        return None
    return padded if (padded - valid_len) / valid_len <= 0.04 else None


class ContinuousTransformer(nn.Module):
    """Stack of TransformerBlocks with input/output projections, rotary
    positions (rot dim max(dim_heads/2, 32), clamped to dim_heads) and
    prepended tokens. A causal stack (the audio LM's backbone) never pads
    its sequence, as the JAX package's padded-sequence rule excludes it."""

    def __init__(self, dim: int, depth: int, dim_in: tp.Optional[int] = None,
                 dim_out: tp.Optional[int] = None, dim_heads: int = 64,
                 cross_attend: bool = False, cond_token_dim: tp.Optional[int] = None,
                 zero_init_branch_outputs: bool = True, ff_mult: int = 4,
                 grad_checkpointing: bool = False, causal: bool = False,
                 global_cond_dim: tp.Optional[int] = None):
        super().__init__()
        self.dim = dim
        self.dim_heads = dim_heads
        self.causal = causal
        self.grad_checkpointing = grad_checkpointing
        self.project_in = nn.Linear(dim_in, dim, bias=False) if dim_in else None
        self.project_out = nn.Linear(dim, dim_out, bias=False) if dim_out else None
        self.layers = nn.ModuleList([
            TransformerBlock(dim, dim_heads, cross_attend=cross_attend,
                             dim_context=cond_token_dim if cross_attend else None,
                             zero_init_branch_outputs=zero_init_branch_outputs, ff_mult=ff_mult,
                             causal=causal, global_cond_dim=global_cond_dim)
            for _ in range(depth)])

    def forward(self, x: torch.Tensor, prepend_embeds: tp.Optional[torch.Tensor] = None,
                context: tp.Optional[torch.Tensor] = None,
                cross_cfg_skip: bool = False,
                kv_caches: tp.Optional[tp.List[tp.Dict[str, tp.Any]]] = None,
                global_cond: tp.Optional[torch.Tensor] = None,
                mask: tp.Optional[torch.Tensor] = None,
                prepend_mask: tp.Optional[torch.Tensor] = None):
        """x [B, T, dim_in] -> [B, T, dim_out]; `global_cond` [B, dim] feeds
        every block's adaLN modulation (stacks built with `global_cond_dim`).
        `mask` [B, T] and `prepend_mask` [B, P] (True = valid) mask the
        self-attention's keys and zero its outputs at the masked positions;
        with prepended tokens either one missing counts as all valid (JAX
        :526-529). A masked stack never pads its sequence (JAX :571) and its
        self-attention takes the plain route, as in the JAX package.
        With `kv_caches` (one static cache per layer, causal stacks only:
        models/lm_backbone.py:init_cache) the T tokens continue the cached
        sequence at the caches' index, their rotary angles sliced from a table
        of the cache's length there (JAX :589-593), and the result is (out,
        kv_caches), the caches updated in place."""
        if self.project_in is not None:
            x = self.project_in(x)
        if prepend_embeds is not None:
            b, seq, n_pre = x.shape[0], x.shape[1], prepend_embeds.shape[1]
            x = torch.cat([prepend_embeds.to(x.dtype), x], dim=1)
            if mask is not None or prepend_mask is not None:
                def valid(m, n):
                    return (torch.ones((b, n), dtype=torch.bool, device=x.device) if m is None
                            else m.bool())
                mask = torch.cat([valid(prepend_mask, n_pre), valid(mask, seq)], dim=1)
        rot_dim = min(max(self.dim_heads // 2, 32), self.dim_heads)
        if kv_caches is not None:
            if not self.causal:
                raise ValueError("the static KV cache decodes causal stacks only")
            index, length = kv_caches[0]["index"], kv_caches[0]["k"].shape[-2]
            if index + x.shape[1] > length:
                raise ValueError(f"the KV caches hold {length} positions; {index} + "
                                 f"{x.shape[1]} do not fit")
            rot = rotary_freqs(length, rot_dim, device=x.device)[index:index + x.shape[1]]
            for layer, cache in zip(self.layers, kv_caches):
                x = layer(x, context=context, rotary_pos_emb=rot, kv_cache=cache,
                          global_cond=global_cond)
            return (x if self.project_out is None else self.project_out(x)), kv_caches

        # the JAX package applies the rule off the CPU only; here the kernel
        # and its plain version both take kv_len, so it applies everywhere
        valid_len = x.shape[1]
        padded = (None if self.causal or mask is not None else
                  seq_pad_length(valid_len, x.shape[0], self.dim_heads, self.dim // self.dim_heads))
        kv_len = None
        if padded is not None:
            x = F.pad(x, (0, 0, 0, padded - valid_len))
            kv_len = valid_len

        rot = rotary_freqs(x.shape[1], rot_dim, device=x.device)
        # per-layer recompute only under training, like the JAX package
        remat = self.grad_checkpointing and self.training and torch.is_grad_enabled()
        for layer in self.layers:
            kw = dict(context=context, rotary_pos_emb=rot, kv_len=kv_len,
                      cross_cfg_skip=cross_cfg_skip, global_cond=global_cond, mask=mask)
            x = checkpoint(layer, x, use_reentrant=False, **kw) if remat else layer(x, **kw)
        x = x[:, :valid_len]
        if self.project_out is not None:
            x = self.project_out(x)
        return x
