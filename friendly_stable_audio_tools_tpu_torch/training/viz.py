"""Pictures for the training demos (counterpart of
friendly_stable_audio_tools_tpu/training/viz.py): a mel spectrogram image of
an audio clip, a heat map of latents and the 3-D PCA point cloud of latent
vectors. They run in numpy on the host. matplotlib is optional: the image
functions return None without it, as in the JAX package."""

from __future__ import annotations

import numpy as np

from .losses.auraloss import mel_filterbank


def _get_plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def mel_spectrogram_db(audio: np.ndarray, sample_rate: int = 44100, n_fft: int = 1024,
                       hop: int = 256, n_mels: int = 80) -> np.ndarray:
    """(C, T) or (T,) audio -> [n_mels, frames] power in dB of the mono mix:
    a reflect-padded periodic-Hann STFT, the Slaney mel filterbank, floor
    1e-10 (JAX viz.py:29-45)."""
    audio = np.asarray(audio)
    mono = audio.mean(0) if audio.ndim == 2 else audio
    window = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
    pad = n_fft // 2
    x = np.pad(mono, (pad, pad), mode="reflect")
    frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(frames)[:, None]
    spec = np.abs(np.fft.rfft(x[idx] * window, axis=-1)) ** 2
    mel = mel_filterbank(sample_rate, n_fft, n_mels) @ spec.T
    return 10 * np.log10(np.maximum(mel, 1e-10))


def audio_spectrogram_image(audio: np.ndarray, sample_rate: int = 44100, n_fft: int = 1024,
                            hop: int = 256, n_mels: int = 80):
    """A matplotlib figure of :func:`mel_spectrogram_db`, or None."""
    plt = _get_plt()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.imshow(mel_spectrogram_db(audio, sample_rate, n_fft, hop, n_mels), aspect="auto",
              origin="lower", cmap="magma")
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bin")
    fig.tight_layout()
    return fig


def tokens_spectrogram_image(latents: np.ndarray, title: str = "Latents"):
    """A heat map of latents [B, C, T] (the first) or [C, T], or None."""
    plt = _get_plt()
    if plt is None:
        return None
    z = np.asarray(latents)
    if z.ndim == 3:
        z = z[0]
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.imshow(z, aspect="auto", origin="lower", cmap="coolwarm")
    ax.set_title(title)
    ax.set_xlabel("time")
    ax.set_ylabel("channel")
    fig.tight_layout()
    return fig


def pca_point_cloud(latents: np.ndarray) -> np.ndarray:
    """Latents [B, C, T] (or [N, C] vectors) -> an (N, 6) array of points:
    the top three principal components of the centred vectors, then an RGB
    colour running with the vectors' order (JAX viz.py:88-101)."""
    z = np.asarray(latents)
    if z.ndim == 3:
        z = z.transpose(0, 2, 1).reshape(-1, z.shape[1])
    z = z - z.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(z, full_matrices=False)
    pts = z @ vt[:3].T
    t = np.linspace(0, 1, len(pts))
    colors = np.stack([t * 255, 255 - t * 255, np.full_like(t, 128)], axis=1)
    return np.concatenate([pts, colors], axis=1)
