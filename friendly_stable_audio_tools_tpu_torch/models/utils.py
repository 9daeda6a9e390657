"""Token sampling of the audio LM (counterpart of
friendly_stable_audio_tools_tpu/models/utils.py:87-113), and the weight-norm
fold of a model's convs (:func:`remove_weight_norm_`, JAX :59-80).

`jax.random.categorical` draws argmax(logits + Gumbel noise); so does
:func:`multinomial`, with the noise from an explicit `torch.Generator`. The
two frameworks draw different numbers from one seed, so each sampler also
takes the noise ready-drawn (`gumbel`, shaped probs.shape[:-1] +
(num_samples, vocabulary)): given the JAX package's draws, it returns the
JAX package's tokens.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn


def gumbel(shape: tp.Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform on [tiny, 1) in fp32, on
    the generator's device (jax.random.gumbel's default mode)."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def multinomial(probs: torch.Tensor, num_samples: int = 1,
                generator: tp.Optional[torch.Generator] = None,
                gumbel_noise: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Categorical draws over the last axis: probs [..., V] -> [..., num_samples]."""
    logits = torch.log(probs.clamp_min(1e-30))
    if gumbel_noise is None:
        gumbel_noise = gumbel((*probs.shape[:-1], num_samples, probs.shape[-1]), generator)
    return (logits[..., None, :] + gumbel_noise).argmax(-1)


def sample_top_k(probs: torch.Tensor, k: int, generator: tp.Optional[torch.Generator] = None,
                 gumbel_noise: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keeps the k largest probabilities (and any tied with the k-th),
    renormalises, draws one: probs [..., V] -> [..., 1]."""
    min_v = torch.topk(probs, k, dim=-1).values[..., -1:]
    probs = torch.where(probs < min_v, torch.zeros_like(probs), probs)
    probs = probs / probs.sum(-1, keepdim=True)
    return multinomial(probs, 1, generator, gumbel_noise)


def sample_top_p(probs: torch.Tensor, p: float, generator: tp.Optional[torch.Generator] = None,
                 gumbel_noise: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nucleus sampling: the smallest set of most probable entries whose mass
    reaches p, renormalised; the draw is over the sorted probabilities (the
    noise indexes them in that order), then mapped back: [..., V] -> [..., 1]."""
    probs_sort, sort_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = probs_sort.cumsum(-1)
    probs_sort = torch.where(cum - probs_sort > p, torch.zeros_like(probs_sort), probs_sort)
    probs_sort = probs_sort / probs_sort.sum(-1, keepdim=True)
    draw = multinomial(probs_sort, 1, generator, gumbel_noise)
    return sort_idx.gather(-1, draw)


def remove_weight_norm_(model: nn.Module) -> nn.Module:
    """Folds every weight-normed conv of `model` in place (ops/convs.py:
    `fold_weight_norm_`): per output channel for a conv, per input channel
    for a transposed conv, eps 1e-12, as the JAX package's
    `remove_weight_norm_from_model` rewrites {v, g} into a kernel. The
    convs' kernels then read the folded weight. Returns `model`."""
    from ..ops.convs import WeightNormed

    for m in model.modules():
        if isinstance(m, WeightNormed):
            m.fold_weight_norm_()
    return model
