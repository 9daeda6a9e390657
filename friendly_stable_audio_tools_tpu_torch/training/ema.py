"""Exponential moving average of parameters with the ema-pytorch power
warm-up (counterpart of friendly_stable_audio_tools_tpu/training/ema.py:18-29).

decay(step) = 0 for the first `update_after_step + 1` steps, then
clamp(1 - (1 + epoch / inv_gamma)^-power, min_value, beta) with
epoch = step - update_after_step - 1. `step` is the number of optimizer
updates before the one just applied, as the JAX trainer passes it
(training/diffusion.py:303)."""

from __future__ import annotations

import typing as tp

import torch


def ema_decay(step: int, beta: float = 0.9999, power: float = 0.75, inv_gamma: float = 1.0,
              update_after_step: int = 1, min_value: float = 0.0) -> float:
    epoch = max(step - update_after_step - 1, 0)
    if epoch <= 0:
        return 0.0
    return min(max(1 - (1 + epoch / inv_gamma) ** -power, min_value), beta)


@torch.no_grad()
def ema_update_(ema: tp.Sequence[torch.Tensor], params: tp.Sequence[torch.Tensor], step: int,
                beta: float = 0.9999, power: float = 0.75) -> None:
    """ema <- ema * d + params * (1 - d), in place."""
    d = ema_decay(step, beta=beta, power=power)
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, params, alpha=1.0 - d)
