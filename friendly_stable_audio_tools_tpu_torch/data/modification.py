"""Crop, pad and channel operations of the data pipeline, host-side numpy on
(C, T) float32 arrays (counterpart of
friendly_stable_audio_tools_tpu/data/modification.py)."""

from __future__ import annotations

import math
import random

import numpy as np


class PadCrop_Normalized_T:
    """Random crop with normalized timing metadata and a padding mask.
    Returns (chunk, t_start, t_end, seconds_start, seconds_total, padding_mask)."""

    def __init__(self, n_samples: int, sample_rate: int, randomize: bool = True):
        self.n_samples = n_samples
        self.sample_rate = sample_rate
        self.randomize = randomize

    def __call__(self, source: np.ndarray):
        n_channels, n_samples = source.shape
        max_ofs = max(0, n_samples - self.n_samples)
        full_length = max_ofs + self.n_samples
        offset = random.randint(0, max_ofs) if (self.randomize and max_ofs) else 0
        chunk = np.zeros((n_channels, self.n_samples), source.dtype)
        chunk[:, : min(n_samples, self.n_samples)] = source[:, offset: offset + self.n_samples]
        padding_mask = np.zeros((self.n_samples,), np.float32)
        padding_mask[: min(n_samples, self.n_samples)] = 1
        return (chunk, offset / full_length, (offset + self.n_samples) / full_length,
                math.floor(offset / self.sample_rate), math.ceil(n_samples / self.sample_rate),
                padding_mask)


class Mono:
    def __call__(self, x: np.ndarray) -> np.ndarray:
        return x.mean(axis=0, keepdims=True) if x.ndim > 1 else x


class Stereo:
    def __call__(self, x: np.ndarray) -> np.ndarray:
        if x.ndim == 1:
            return np.stack([x, x])
        if x.shape[0] == 1:
            return np.repeat(x, 2, axis=0)
        return x[:2]


class PhaseFlipper:
    """Random sign flip with probability p."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return -x if random.random() < self.p else x
