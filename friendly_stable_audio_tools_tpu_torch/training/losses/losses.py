"""Named, weighted losses (counterpart of
friendly_stable_audio_tools_tpu/training/losses/losses.py: `ValueLoss` :26,
`L1Loss` :37, `MSELoss` :56, `AuralossLoss` :83, `MultiLoss` :98). Loss
modules are callables over an `info` dict of tensors; `MultiLoss` sums the
weighted values and returns each one by name."""

from __future__ import annotations

import typing as tp

import torch


class ValueLoss:
    """A scalar already in the info dict, weighted (JAX :26)."""

    def __init__(self, key: str, name: str, weight: float = 1.0):
        self.key, self.name, self.weight = key, name, float(weight)

    def __call__(self, info: tp.Dict[str, tp.Any]) -> torch.Tensor:
        return self.weight * info[self.key]


class L1Loss:
    """Weighted mean absolute error in fp32 (JAX :37; its mask is unused by
    every caller and not ported)."""

    def __init__(self, key_a: str, key_b: str, weight: float = 1.0, name: str = "l1_loss"):
        self.key_a, self.key_b = key_a, key_b
        self.weight, self.name = float(weight), name

    def __call__(self, info: tp.Dict[str, tp.Any]) -> torch.Tensor:
        return self.weight * (info[self.key_a].float() - info[self.key_b].float()).abs().mean()


class MSELoss:
    """Weighted mean squared error in fp32 (JAX :56-75). With `mask_key`
    naming a mask in the info dict ([B, T] over channels-last [B, T, C],
    True = counted), the loss is the sum over the kept elements divided by
    their count (at least 1); a missing or None mask gives the plain mean."""

    def __init__(self, key_a: str, key_b: str, weight: float = 1.0, name: str = "mse_loss",
                 mask_key: tp.Optional[str] = None):
        self.key_a, self.key_b, self.mask_key = key_a, key_b, mask_key
        self.weight, self.name = float(weight), name

    def __call__(self, info: tp.Dict[str, tp.Any]) -> torch.Tensor:
        sq = (info[self.key_a].float() - info[self.key_b].float()).square()
        mask = info.get(self.mask_key) if self.mask_key is not None else None
        if mask is None:
            return self.weight * sq.mean()
        mask = mask.bool()
        if mask.dim() == 2 and sq.dim() == 3:
            mask = mask[:, :, None]
        mask = mask.expand_as(sq)
        return self.weight * (torch.where(mask, sq, torch.zeros_like(sq)).sum()
                              / mask.sum().clamp_min(1))


class AuralossLoss:
    """A spectral loss of auraloss.py between two info entries, weighted (JAX :83)."""

    def __init__(self, auraloss_module, input_key: str, target_key: str, name: str,
                 weight: float = 1.0):
        self.auraloss_module = auraloss_module
        self.input_key, self.target_key = input_key, target_key
        self.name, self.weight = name, float(weight)

    def __call__(self, info: tp.Dict[str, tp.Any]) -> torch.Tensor:
        return self.weight * self.auraloss_module(info[self.input_key], info[self.target_key])


class MultiLoss:
    def __init__(self, losses: tp.Sequence[tp.Callable]):
        self.losses = list(losses)

    def __call__(self, info: tp.Dict[str, tp.Any]):
        """-> (weighted sum of every loss, {name: weighted value}); two
        losses of one name both count in the sum, and the later one's value
        is the one named, as in the JAX package (:98-106)."""
        total, individual = 0.0, {}
        for m in self.losses:
            v = m(info)
            total = total + v
            individual[m.name] = v
        return total, individual
