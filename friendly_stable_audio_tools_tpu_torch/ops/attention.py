"""Scaled-dot-product attention (counterpart of
friendly_stable_audio_tools_tpu/ops/attention.py).

:func:`attention` is the plain path (`_xla_attention` :86): two matrix
products and a softmax in fp32, with the probabilities rounded to the value
dtype before the second product. The DiT's cross-attention reads 130
conditioning tokens, which the JAX package sends there rather than to a
kernel, and so does this port.

:func:`scaled_dot_product_attention` is the JAX function (:35) with its
gate (:58-69, :func:`flash_gate`, without its FSAT_* switches): long
unmasked self-attention on the card goes to the flash kernels of
ops/kernels/flash_attention.py, as the JAX package sends it to
`flash_attention` (the ``_flash`` custom_vjp). Under grad that is
``FlashAttention`` (K7 with its log-sum-exp, then K8 or K9 on the way back;
fp32 only: no path trains in bf16, and a bf16 call under grad raises);
otherwise K7 without the log-sum-exp, in fp32 or, for bf16 q, k and v (the
ADP U-Net in bench.py's bf16 recipe), in bf16. Everything else, and every
CPU tensor, takes the plain path, as the JAX package on the CPU takes
`_xla_attention`. The ADP U-Net's self-attention uses it, and so does the
causal transformer of the audio LM (models/transformer.py): its square
causal self-attention goes, under grad, through ``FlashAttention`` with
causal set (the causal K7 with its LSE, then the causal K9; never K8, as in
the JAX package, flash_attention.py:576), otherwise through the causal K7
alone; its causal cross-attention (queries and conditioning tokens of
different lengths) stays plain, with `_xla_attention`'s mask (:92-96).
A key-masked self-attention (the DiT under `mask_padding` or a prepend
mask, models/transformer.py) is plain too, wherever it runs: the JAX gate
sends every masked call to `_xla_attention` (:57-64, :73-77), and no
attention kernel (K1, K5, K6, K7) takes a mask.
"""

from __future__ import annotations

import typing as tp

import torch

from .kernels import flash_attention as flash


def flash_gate(t_q: int, t_k: int, head_dim: int, masked: bool, causal: bool = False) -> bool:
    """Whether the JAX package sends an attention call to its flash kernel
    on the accelerator (ops/attention.py:58-69): at least 1024 queries and
    512 keys (short-K cross-attention stays plain), head dim at most 128, no
    mask, and causal only when square."""
    return (t_q >= 1024 and (t_q == t_k or not causal) and not masked and head_dim <= 128
            and t_k >= 512)


def uses_kernels(x: torch.Tensor) -> bool:
    """Whether a tensor goes to the kernels (a CUDA tensor) or stays on the
    plain path (a CPU tensor), as the JAX gate reads the backend. A function
    of its own so that tests can force the kernel route on CPU tensors, where
    the kernels' wrappers run their plain versions."""
    return x.device.type != "cpu"


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 mask: tp.Optional[torch.Tensor] = None,
                                 causal: bool = False) -> torch.Tensor:
    """q [B, H, Tq, D], k/v [B, Hkv, Tk, D], mask [B, Tk] or [B, 1, Tq, Tk]
    (True = attend) -> [B, H, Tq, D]; causal masks key j > query i + Tk -
    Tq. On a CUDA tensor that :func:`flash_gate` admits (no mask), the flash
    kernels compute it (D 32, 64 or 80 in fp32, D 64 or 80 in bf16; fp32, or
    bf16 without grad and not causal; causal at D 64 under grad; other cases
    raise there, under grad before any launch): under grad,
    when q, k or v needs a gradient, ``FlashAttention`` (K7 with its LSE,
    then K8 or K9; causal: the causal K7, then the causal K9), else K7
    alone (the bf16 K7 for bf16 tensors)."""
    b, h, t_q, d = q.shape
    if not (uses_kernels(q) and flash_gate(t_q, k.shape[-2], d, mask is not None, causal)):
        return attention(q, k, v, mask, causal)
    if k.shape[1] != h:
        k = k.repeat_interleave(h // k.shape[1], dim=1)
        v = v.repeat_interleave(h // v.shape[1], dim=1)
    t_k = k.shape[-2]
    q, k, v = q.reshape(b * h, t_q, d), k.reshape(b * h, t_k, d), v.reshape(b * h, t_k, d)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if causal:
        out = (flash.FlashAttention.apply(q, k, v, None, True) if grad
               else flash.flash_forward(q, k, v, save_stats=False, causal=True)[0])
    elif grad:
        out = flash.FlashAttention.apply(q, k, v)
    else:
        out, _ = flash.flash_forward(q, k, v, save_stats=False)
    return out.view(b, h, t_q, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: tp.Optional[torch.Tensor] = None, causal: bool = False) -> torch.Tensor:
    """q [B, H, Tq, D], k/v [B, Hkv, Tk, D] (Hkv divides H: each kv head
    serves H/Hkv consecutive q heads); mask [B, Tk] (per key) or [B, 1, Tq,
    Tk] (per query and key, the KV cache's), True = attend; causal
    keeps key j for query i where j <= i + Tk - Tq (`tril(k=Tk-Tq)`, as
    `_xla_attention` :92-96). A query that may see no key (causal with Tk <
    Tq) attends evenly to every key, as the JAX package's finite fill gives."""
    heads = q.shape[1]
    if k.shape[1] != heads:
        k = k.repeat_interleave(heads // k.shape[1], dim=1)
        v = v.repeat_interleave(heads // v.shape[1], dim=1)
    scale = q.shape[-1] ** -0.5
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    fill = torch.finfo(torch.float32).min
    if causal:
        t_q, t_k = q.shape[-2], k.shape[-2]
        hidden = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).triu_(t_k - t_q + 1)
        logits = logits.masked_fill(hidden, fill)
    if mask is not None:
        logits = logits.masked_fill(~(mask[:, None, None, :] if mask.dim() == 2 else mask), fill)
    probs = torch.softmax(logits, dim=-1)
    return (probs.to(v.dtype).float() @ v.float()).to(q.dtype)
