"""Named, weighted losses (counterpart of
friendly_stable_audio_tools_tpu/training/losses/losses.py: `MSELoss` :56,
`MultiLoss` :93). Loss modules are callables over an `info` dict of tensors;
`MultiLoss` sums the weighted values and returns each one by name."""

from __future__ import annotations

import typing as tp

import torch


class MSELoss:
    """Weighted mean squared error in fp32 (the JAX module's padding mask is
    not ported: training with `mask_padding` raises in the factory)."""

    def __init__(self, key_a: str, key_b: str, weight: float = 1.0, name: str = "mse_loss"):
        self.key_a, self.key_b = key_a, key_b
        self.weight, self.name = float(weight), name

    def __call__(self, info: tp.Dict[str, tp.Any]) -> torch.Tensor:
        return self.weight * (info[self.key_a].float() - info[self.key_b].float()).square().mean()


class MultiLoss:
    def __init__(self, losses: tp.Sequence[tp.Callable]):
        self.losses = list(losses)

    def __call__(self, info: tp.Dict[str, tp.Any]):
        """-> (weighted sum, {name: weighted value})."""
        individual = {m.name: m(info) for m in self.losses}
        return sum(individual.values()), individual
