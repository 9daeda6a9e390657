"""Audio preparation for init-audio generation (counterpart of
friendly_stable_audio_tools_tpu/inference/utils.py, which works on numpy
arrays on the host; here the audio becomes a float32 tensor on the caller's
device as soon as it has its sample rate).

Layout [B, C, T]."""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch


def set_audio_channels(audio: torch.Tensor, target_channels: int) -> torch.Tensor:
    """[B, C, T] to `target_channels`: 1 takes the mean over the channels, 2
    duplicates a mono channel, fewer keep the first channels."""
    if target_channels == 1:
        return audio.mean(1, keepdim=True)
    if target_channels == 2 and audio.shape[1] == 1:
        return audio.repeat(1, 2, 1)
    if audio.shape[1] > target_channels:
        return audio[:, :target_channels, :]
    return audio


def pad_crop(audio: torch.Tensor, target_length: int) -> torch.Tensor:
    """Pads with zeros or crops the trailing time axis to `target_length`."""
    t = audio.shape[-1]
    if t >= target_length:
        return audio[..., :target_length]
    return torch.nn.functional.pad(audio, (0, target_length - t))


def resample(audio: np.ndarray, in_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling over the last axis (scipy's `resample_poly`, on
    the host), in the input's dtype."""
    if in_sr == target_sr:
        return audio
    from scipy.signal import resample_poly

    g = math.gcd(int(in_sr), int(target_sr))
    return resample_poly(audio, target_sr // g, in_sr // g, axis=-1).astype(audio.dtype)


def prepare_audio(audio: tp.Union[np.ndarray, torch.Tensor], in_sr: int, target_sr: int,
                  target_length: int, target_channels: int,
                  device: tp.Optional[tp.Union[str, torch.device]] = None) -> torch.Tensor:
    """(T,) | (C, T) | (B, C, T) audio at `in_sr` -> float32 [B,
    target_channels, target_length] at `target_sr` on `device` (the audio's
    own device, or the CPU for an array, by default). Resampling runs on the
    host; audio already at `target_sr` stays where it is until it moves to
    `device`."""
    if isinstance(audio, torch.Tensor):
        device = audio.device if device is None else device
        if in_sr != target_sr:
            audio = torch.from_numpy(resample(audio.detach().float().cpu().numpy(), in_sr,
                                              target_sr))
    else:
        audio = torch.from_numpy(resample(np.asarray(audio, dtype=np.float32), in_sr, target_sr))
    audio = audio.to(device=device, dtype=torch.float32)
    if audio.ndim == 1:
        audio = audio[None, None, :]
    elif audio.ndim == 2:
        audio = audio[None, :, :]
    return set_audio_channels(pad_crop(audio, target_length), target_channels)
