"""Bottlenecks (counterpart of friendly_stable_audio_tools_tpu/models/bottleneck.py).

Only the decode side of the VAE bottleneck, which Stable Audio Open's
pretransform uses: sampling happens on the encode side, so decoding is the
identity."""

from __future__ import annotations

import typing as tp

import torch
from torch import nn


class VAEBottleneck(nn.Module):
    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return x


def create_bottleneck_from_config(config: tp.Dict[str, tp.Any]) -> nn.Module:
    if config.get("type") != "vae":
        raise NotImplementedError(f"bottleneck type {config.get('type')!r} is not in the torch port")
    return VAEBottleneck()
