"""Bottlenecks (counterpart of friendly_stable_audio_tools_tpu/models/bottleneck.py).

The VAE bottleneck of Stable Audio Open's pretransform. Encoding returns
the posterior mean, as the JAX package's training path does: it encodes
with no sampling rng (autoencoders.py:347-355, `vae_sample` with rng=None),
where the upstream reference draws a sample. Decoding is the identity."""

from __future__ import annotations

import typing as tp

import torch
from torch import nn


class VAEBottleneck(nn.Module):
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[..., 2 * latent_dim] (mean | scale) -> the mean (bottleneck.py:63-84)."""
        return x.chunk(2, dim=-1)[0]

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return x


def create_bottleneck_from_config(config: tp.Dict[str, tp.Any]) -> nn.Module:
    if config.get("type") != "vae":
        raise NotImplementedError(f"bottleneck type {config.get('type')!r} is not in the torch port")
    return VAEBottleneck()
