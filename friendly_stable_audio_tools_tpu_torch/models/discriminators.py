"""The GAN discriminator of AE-GAN training (counterpart of
friendly_stable_audio_tools_tpu/models/discriminators.py:27-190): hinge
losses and EnCodec's multi-scale STFT discriminator.

Each scale frames the audio with torch.stft (cuFFT on the card), normalised
as torchaudio's Spectrogram(normalized=True) divides it (by the window's
L2 norm), stacks the real and imaginary parts of each channel as 2 * C
input planes [B, 2C, frames, bins], and runs a stack of weight-normed 2-D
convs, (3, 9) then three (3, 9) strided by 2 over frequency and dilated
1, 2, 4 over time, a (3, 3) and the (3, 3) logits, each but the last
followed by LeakyReLU(0.3) and kept as a feature map. Every conv has
`min(filters_scale ** (i + 1) * filters, max_filters)` outputs (constant
at the default `filters_scale` 1). The convs are plain `F.conv2d`
(cuDNN), as the JAX package leaves them to XLA. Layout NCHW; the JAX
package's is NHWC, its weights HWIO (utils/convert.py carries them over).

The `oobleck` and `dac` discriminator types are not ported (ROADMAP queue
A 4): no shipped autoencoder config uses them.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import hann_window, stft_reim


def get_hinge_losses(score_real: torch.Tensor, score_fake: torch.Tensor):
    """-> (discriminator loss, generator loss) (JAX :27)."""
    gen_loss = -score_fake.mean()
    dis_loss = F.relu(1 - score_real).mean() + F.relu(1 + score_fake).mean()
    return dis_loss, gen_loss


class WNConv2d(nn.Module):
    """Weight-normalised 2-D conv: w = g * v / ||v||_(in, kh, kw) per output
    channel (torch's weight_norm(dim=0); eps 1e-12 as JAX :34-81); v is
    [out, in, kh, kw]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tp.Tuple[int, int],
                 stride: tp.Tuple[int, int] = (1, 1), padding: tp.Tuple[int, int] = (0, 0),
                 dilation: tp.Tuple[int, int] = (1, 1)):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.v = nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size))
        self.g = nn.Parameter(torch.empty(out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def weight(self) -> torch.Tensor:
        norm = self.v.square().sum(dim=(1, 2, 3)).sqrt()
        return self.v * (self.g / (norm + 1e-12))[:, None, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight(), self.bias, stride=self.stride, padding=self.padding,
                        dilation=self.dilation)


class DiscriminatorSTFT(nn.Module):
    """One STFT scale (JAX :104-146)."""

    def __init__(self, filters: int, in_channels: int = 1, out_channels: int = 1,
                 n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024,
                 dilations: tp.Sequence[int] = (1, 2, 4), filters_scale: int = 1,
                 max_filters: int = 1024):
        super().__init__()
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.conv_in = WNConv2d(2 * in_channels, filters, (3, 9), padding=(1, 4))
        ch = filters
        self.dilations = list(dilations)
        for i, d in enumerate(self.dilations):
            out_ch = min(filters_scale ** (i + 1) * filters, max_filters)
            self.add_module(f"conv{i}", WNConv2d(ch, out_ch, (3, 9), stride=(1, 2),
                                                 dilation=(d, 1), padding=(d, 4)))
            ch = out_ch
        out_mid = min(filters_scale ** (len(self.dilations) + 1) * filters, max_filters)
        self.conv_mid = WNConv2d(ch, out_mid, (3, 3), padding=(1, 1))
        self.conv_post = WNConv2d(out_mid, out_channels, (3, 3), padding=(1, 1))

    def spectrogram(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, C] -> [B, 2C, frames, bins] (channel c's real part at
        2c, its imaginary part at 2c + 1), divided by the window's norm."""
        b, t, c = x.shape
        window = hann_window(self.win_length, device=x.device)
        re, im = stft_reim(x.transpose(1, 2).reshape(b * c, t), self.n_fft, self.hop_length,
                           self.win_length, window)
        z = torch.stack([re, im], dim=1) / window.square().sum().sqrt()  # [BC, 2, fr, bins]
        return z.reshape(b, 2 * c, *z.shape[2:])

    def forward(self, x: torch.Tensor):
        """x [B, T, C] -> (logits [B, 1, frames, bins'], feature maps)."""
        fmap = []
        h = self.spectrogram(x)
        for name in ["conv_in"] + [f"conv{i}" for i in range(len(self.dilations))] + ["conv_mid"]:
            h = F.leaky_relu(getattr(self, name)(h), 0.3)
            fmap.append(h)
        return self.conv_post(h), fmap


class EncodecDiscriminator(nn.Module):
    """One DiscriminatorSTFT per (n_fft, hop, window length) (JAX :149-190)."""

    def __init__(self, in_channels: int = 1, filters: int = 32,
                 n_ffts: tp.Sequence[int] = (1024, 2048, 512),
                 hop_lengths: tp.Sequence[int] = (256, 512, 128),
                 win_lengths: tp.Sequence[int] = (1024, 2048, 512)):
        super().__init__()
        self.discs = nn.ModuleList([
            DiscriminatorSTFT(filters, in_channels=in_channels, n_fft=n_fft, hop_length=hop,
                              win_length=win)
            for n_fft, hop, win in zip(n_ffts, hop_lengths, win_lengths)])

    def forward(self, x: torch.Tensor):
        """x [B, T, C] -> (logits per scale, feature maps per scale)."""
        logits, features = [], []
        for disc in self.discs:
            lg, fm = disc(x)
            logits.append(lg)
            features.append(fm)
        return logits, features

    def loss(self, reals: torch.Tensor, fakes: torch.Tensor):
        """reals, fakes [B, T, C] -> (discriminator hinge loss, adversarial
        loss, feature-matching distance), each summed over the scales; the
        feature matching is each scale's mean |real - fake| over its
        feature maps, averaged over them."""
        logits_true, feature_true = self(reals)
        logits_fake, feature_fake = self(fakes)
        dis_loss = adv_loss = fm = 0.0
        for lt, lf, ft, ff in zip(logits_true, logits_fake, feature_true, feature_fake):
            fm = fm + sum((a.float() - b.float()).abs().mean() for a, b in zip(ft, ff)) / len(ft)
            d, a = get_hinge_losses(lt.float(), lf.float())
            dis_loss = dis_loss + d
            adv_loss = adv_loss + a
        return dis_loss, adv_loss, fm


def create_discriminator_from_config(config: tp.Dict[str, tp.Any], channels: int) -> nn.Module:
    """The `discriminator` block of an autoencoder's loss config (JAX
    training/autoencoders.py:110-119): the `encodec` type."""
    kind = config["type"]
    if kind == "encodec":
        return EncodecDiscriminator(in_channels=channels, **config.get("config", {}))
    if kind in ("oobleck", "dac"):
        raise NotImplementedError(f"the {kind!r} discriminator is not in the torch port yet "
                                  f"(ROADMAP queue A 4): no shipped autoencoder config uses it")
    raise ValueError(f"Unknown discriminator type {kind}")
