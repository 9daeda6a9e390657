"""Spectral losses (counterpart of
friendly_stable_audio_tools_tpu/training/losses/auraloss.py:66-362, the
auraloss subset the reference vendors).

`STFTLoss` (spectral convergence, log and linear magnitude distances,
the phase term, `scale_invariance`, the mel and chroma scales, the
A-weighting prefilter), `MultiResolutionSTFTLoss` and the mid/side
`SumAndDifferenceSTFTLoss`. The STFT is torch.stft's (ops/stft.py); the
A-weighting FIR, the mel and the chroma filterbanks are designed on the
host in numpy and scipy, as the JAX package designs them (its functions
copied here, not imported). Audio is [B, C, T]; every loss is fp32.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.stft import hann_window, stft_mag, stft_reim


class _OnDevice:
    """A host array, copied once to each device it is used on."""

    def __init__(self, array: np.ndarray):
        self.host = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
        self._copies: tp.Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self._copies:
            self._copies[device] = self.host.to(device)
        return self._copies[device]


def design_a_weighting_fir(fs: int, ntaps: int = 101) -> np.ndarray:
    """IEC 1672 analog A-weighting -> bilinear -> an `ntaps` FIR by
    least squares (JAX :66-82)."""
    import scipy.signal

    f1, f2, f3, f4 = 20.598997, 107.65265, 737.86223, 12194.217
    a1000 = 1.9997
    nums = [(2 * np.pi * f4) ** 2 * (10 ** (a1000 / 20)), 0, 0, 0, 0]
    dens = np.polymul([1, 4 * np.pi * f4, (2 * np.pi * f4) ** 2],
                      [1, 4 * np.pi * f1, (2 * np.pi * f1) ** 2])
    dens = np.polymul(np.polymul(dens, [1, 2 * np.pi * f3]), [1, 2 * np.pi * f2])
    b, a = scipy.signal.bilinear(nums, dens, fs=fs)
    w_iir, h_iir = scipy.signal.freqz(b, a, worN=512, fs=fs)
    return scipy.signal.firls(ntaps, w_iir, abs(h_iir), fs=fs).astype(np.float32)


class FIRFilter:
    """FIR pre-emphasis ("hp", "fd", "aw"), a cross-correlation with 'same'
    zero padding (JAX :85-119)."""

    def __init__(self, filter_type: str = "hp", coef: float = 0.85, fs: int = 44100,
                 ntaps: int = 101):
        self.filter_type = filter_type
        if filter_type == "hp":
            taps, self.pad = np.array([1, -coef, 0], np.float32), 1
        elif filter_type == "fd":
            taps, self.pad = np.array([1, 0, -coef], np.float32), 1
        elif filter_type == "aw":
            if ntaps % 2 == 0:
                raise ValueError(f"ntaps must be odd (ntaps={ntaps}).")
            taps, self.pad = design_a_weighting_fir(fs, ntaps), ntaps // 2
        else:
            raise ValueError(filter_type)
        self.taps = _OnDevice(taps)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, T] -> filtered [N, T]."""
        return F.conv1d(x[:, None], self.taps.on(x.device)[None, None], padding=self.pad)[:, 0]

    def same_as(self, other: "FIRFilter") -> bool:
        return (self.filter_type == other.filter_type and self.pad == other.pad
                and torch.equal(self.taps.host, other.taps.host))


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: tp.Optional[float] = None) -> np.ndarray:
    """Slaney-style mel filterbank [n_mels, n_fft // 2 + 1] (librosa's; JAX :122-152)."""
    fmax = fmax or sr / 2

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= 1000.0,
                        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
                        f / (200.0 / 3))

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                        m * (200.0 / 3))

    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, len(fftfreqs)))
    for i in range(n_mels):
        weights[i] = np.maximum(0, np.minimum(-ramps[i] / fdiff[i], ramps[i + 2] / fdiff[i + 1]))
    weights *= (2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def chroma_filterbank(sr: int, n_fft: int, n_chroma: int = 12, tuning: float = 0.0,
                      ctroct: float = 5.0, octwidth: float = 2.0,
                      base_c: bool = True) -> np.ndarray:
    """librosa's chroma filterbank [n_chroma, n_fft // 2 + 1] (JAX :155-178)."""
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    a440 = 440.0 * 2.0 ** (tuning / n_chroma)
    frqbins = n_chroma * np.log2(frequencies / (a440 / 16))
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))
    d = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    half = np.round(float(n_chroma) / 2)
    d = np.remainder(d + half + 10 * n_chroma, n_chroma) - half
    wts = np.exp(-0.5 * (2 * d / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    norm = np.sqrt(np.sum(wts ** 2, axis=0, keepdims=True))
    wts = wts / np.maximum(norm, np.finfo(np.float64).tiny)
    if octwidth is not None:
        wts *= np.tile(np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
                       (n_chroma, 1))
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, :int(1 + n_fft / 2)], dtype=np.float32)


def spectral_convergence(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """||y - x||_F / ||y||_F per signal, averaged (JAX :181)."""
    num = (y_mag - x_mag).square().sum((-2, -1)).sqrt()
    den = y_mag.square().sum((-2, -1)).sqrt()
    return (num / den.clamp_min(1e-12)).mean()


def stft_magnitude_loss(x_mag, y_mag, log: bool = True, distance: str = "L1",
                        log_eps: float = 0.0, log_fac: float = 1.0) -> torch.Tensor:
    """(JAX :188)."""
    if log:
        x_mag = torch.log(log_fac * x_mag + log_eps) if log_eps else torch.log(log_fac * x_mag)
        y_mag = torch.log(log_fac * y_mag + log_eps) if log_eps else torch.log(log_fac * y_mag)
    if distance == "L1":
        return (x_mag - y_mag).abs().mean()
    if distance == "L2":
        return (x_mag - y_mag).square().mean()
    raise ValueError(f"Invalid distance: '{distance}'.")


class STFTLoss:
    """(JAX :200-292)."""

    def __init__(self, fft_size: int = 1024, hop_size: int = 256, win_length: int = 1024,
                 window: str = "hann_window", w_sc: float = 1.0, w_log_mag: float = 1.0,
                 w_lin_mag: float = 0.0, w_phs: float = 0.0,
                 sample_rate: tp.Optional[int] = None, scale: tp.Optional[str] = None,
                 n_bins: tp.Optional[int] = None, perceptual_weighting: bool = False,
                 scale_invariance: bool = False, eps: float = 1e-8, output: str = "loss",
                 reduction: str = "mean", mag_distance: str = "L1", device=None, **kwargs):
        if window != "hann_window":
            raise NotImplementedError(f"STFTLoss window {window!r}: only hann_window is ported")
        if reduction != "mean":
            raise NotImplementedError(f"STFTLoss reduction={reduction!r}: only 'mean' is ported")
        self.log_eps = float(kwargs.pop("log_eps", 0.0))
        self.log_fac = float(kwargs.pop("log_fac", 1.0))
        self.fft_size, self.hop_size, self.win_length = fft_size, hop_size, win_length
        self.w_sc, self.w_log_mag, self.w_lin_mag, self.w_phs = w_sc, w_log_mag, w_lin_mag, w_phs
        self.scale_invariance = scale_invariance
        self.eps = eps
        self.output = output
        self.mag_distance = mag_distance
        self.fb = None
        if scale is not None:
            if sample_rate is None or n_bins is None:
                raise ValueError("a mel or chroma scale needs `sample_rate` and `n_bins`")
            if scale == "mel":
                self.fb = _OnDevice(mel_filterbank(sample_rate, fft_size, n_bins))
            elif scale == "chroma":
                if n_bins > fft_size:
                    raise ValueError("Must be more FFT bins than chroma bins")
                self.fb = _OnDevice(chroma_filterbank(sample_rate, fft_size, n_chroma=n_bins))
            else:
                raise ValueError(f"Invalid scale: {scale}. Must be 'mel' or 'chroma'.")
        self.prefilter = None
        if perceptual_weighting:
            if sample_rate is None:
                raise ValueError("`sample_rate` must be supplied when "
                                 "`perceptual_weighting = True`.")
            self.prefilter = FIRFilter("aw", fs=sample_rate)

    def __call__(self, input: torch.Tensor, target: torch.Tensor, skip_prefilter: bool = False):
        """input, target [B, C, T]. `skip_prefilter`: the caller applied this
        loss's prefilter already (the multi-resolution loss applies it once
        for every scale)."""
        bs, chs, t = input.shape
        x = input.reshape(bs * chs, t).float()
        y = target.reshape(bs * chs, t).float()
        if self.prefilter is not None and not skip_prefilter:
            x, y = self.prefilter(x), self.prefilter(y)
        window = hann_window(self.win_length, device=x.device)
        args = (self.fft_size, self.hop_size, self.win_length, window)
        x_mag, y_mag = stft_mag(x, *args, eps=self.eps), stft_mag(y, *args, eps=self.eps)
        if self.fb is not None:
            fb = self.fb.on(x.device)
            x_mag = torch.einsum("mf,nft->nmt", fb, x_mag)
            y_mag = torch.einsum("mf,nft->nmt", fb, y_mag)
        if self.scale_invariance:
            alpha = (x_mag * y_mag).sum((-2, -1)) / y_mag.square().sum((-2, -1)).clamp_min(1e-12)
            y_mag = y_mag * alpha[:, None, None]
        sc = spectral_convergence(x_mag, y_mag) if self.w_sc else 0.0
        logm = (stft_magnitude_loss(x_mag, y_mag, log=True, distance=self.mag_distance,
                                    log_eps=self.log_eps, log_fac=self.log_fac)
                if self.w_log_mag else 0.0)
        linm = (stft_magnitude_loss(x_mag, y_mag, log=False, distance=self.mag_distance)
                if self.w_lin_mag else 0.0)
        phs = 0.0
        if self.w_phs:
            xr, xi = stft_reim(x, *args)
            yr, yi = stft_reim(y, *args)
            phs = (torch.atan2(xi, xr) - torch.atan2(yi, yr)).square().mean()
        loss = self.w_sc * sc + self.w_log_mag * logm + self.w_lin_mag * linm + self.w_phs * phs
        if self.output == "full":
            return loss, sc, logm, linm, phs
        return loss


class MultiResolutionSTFTLoss:
    """The mean of one STFTLoss per (fft size, hop, window length) (JAX :295-325).
    A perceptual prefilter, the same at every scale, is applied once."""

    def __init__(self, fft_sizes: tp.Sequence[int] = (1024, 2048, 512),
                 hop_sizes: tp.Sequence[int] = (120, 240, 50),
                 win_lengths: tp.Sequence[int] = (600, 1200, 240), window: str = "hann_window",
                 **kwargs):
        if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
            raise ValueError("fft_sizes, hop_sizes and win_lengths differ in length")
        self.stft_losses = [STFTLoss(fs, hs, wl, window, **kwargs)
                            for fs, hs, wl in zip(fft_sizes, hop_sizes, win_lengths)]
        self.prefilter = self.stft_losses[0].prefilter if self.stft_losses else None
        if self.prefilter is not None:
            assert all(f.prefilter is not None and f.prefilter.same_as(self.prefilter)
                       for f in self.stft_losses), "the scales' prefilters differ"

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        skip = self.prefilter is not None
        if skip:
            bs, chs, t = input.shape
            input = self.prefilter(input.reshape(bs * chs, t).float()).reshape(bs, chs, t)
            target = self.prefilter(target.reshape(bs * chs, t).float()).reshape(bs, chs, t)
        loss = 0.0
        for f in self.stft_losses:
            loss = loss + f(input, target, skip_prefilter=skip)
        return loss / len(self.stft_losses)


class SumAndDifferenceSTFTLoss:
    """The multi-resolution loss of the mid (L + R) and side (L - R) signals
    of stereo audio, (w_sum * sum_loss + w_diff * diff_loss) / 2 (JAX :328-362)."""

    def __init__(self, fft_sizes, hop_sizes, win_lengths, window: str = "hann_window",
                 w_sum: float = 1.0, w_diff: float = 1.0, output: str = "loss", **kwargs):
        self.w_sum, self.w_diff = w_sum, w_diff
        self.output = output
        self.mrstft = MultiResolutionSTFTLoss(fft_sizes, hop_sizes, win_lengths, window, **kwargs)

    @staticmethod
    def sum_and_difference(x: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """[B, 2, T] -> ([B, 1, T] mid, [B, 1, T] side)."""
        if x.shape[1] != 2:
            raise ValueError(f"Input must be stereo: {x.shape[1]} channel(s).")
        return (x[:, 0] + x[:, 1])[:, None], (x[:, 0] - x[:, 1])[:, None]

    def __call__(self, input: torch.Tensor, target: torch.Tensor):
        input_sum, input_diff = self.sum_and_difference(input)
        target_sum, target_diff = self.sum_and_difference(target)
        sum_loss = self.mrstft(input_sum, target_sum)
        diff_loss = self.mrstft(input_diff, target_diff)
        loss = (self.w_sum * sum_loss + self.w_diff * diff_loss) / 2
        if self.output == "full":
            return loss, sum_loss, diff_loss
        return loss
