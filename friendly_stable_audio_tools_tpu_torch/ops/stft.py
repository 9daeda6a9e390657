"""The framed real DFT of the spectral losses and the STFT discriminator
(counterpart of friendly_stable_audio_tools_tpu/ops/stft.py:20-33, 70-146
and training/losses/auraloss.py:28-63).

torch.stft semantics as the reference's auraloss and EnCodec discriminator
call it: center=True (the signal reflect-padded by n_fft // 2 on each
side), a periodic Hann window of `win_length` zero-padded to `n_fft` in
the middle, one-sided. No Pallas kernel computes this: the JAX package
frames the signal into MXU GEMMs on the TPU and calls `jnp.fft.rfft` on the
CPU; here `torch.stft` runs cuFFT on the card and pocketfft on the CPU.
"""

from __future__ import annotations

import typing as tp

import torch


def hann_window(n: int, device=None) -> torch.Tensor:
    """torch.hann_window(n, periodic=True), fp32."""
    return torch.hann_window(n, periodic=True, dtype=torch.float32, device=device)


def stft_reim(x: torch.Tensor, n_fft: int, hop: int, win_length: int,
              window: tp.Optional[torch.Tensor] = None) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """x [N, T] -> (re, im), each [N, frames, n_fft // 2 + 1] fp32, frames =
    1 + T // hop; `window` of `win_length` (the periodic Hann by default)."""
    if window is None:
        window = hann_window(win_length, device=x.device)
    spec = torch.stft(x.float(), n_fft, hop_length=hop, win_length=win_length, window=window,
                      center=True, pad_mode="reflect", normalized=False, onesided=True,
                      return_complex=True)
    spec = spec.transpose(1, 2)
    return spec.real, spec.imag


def stft_mag(x: torch.Tensor, n_fft: int, hop: int, win_length: int,
             window: tp.Optional[torch.Tensor] = None, eps: float = 1e-8) -> torch.Tensor:
    """x [N, T] -> sqrt(max(re^2 + im^2, eps)) [N, n_fft // 2 + 1, frames]
    (JAX auraloss.py:55-63)."""
    re, im = stft_reim(x, n_fft, hop, win_length, window)
    return (re * re + im * im).clamp_min(eps).sqrt().transpose(1, 2)
