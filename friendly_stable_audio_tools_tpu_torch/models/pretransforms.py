"""Pretransforms (counterpart of friendly_stable_audio_tools_tpu/models/pretransforms.py).

The frozen autoencoder between the diffusion latents and audio, unchunked as
Stable Audio Open runs it; with a discrete bottleneck (the audio LM's
EnCodec-style tokenizer) it also tokenizes audio to codes."""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .autoencoders import AudioAutoencoder, autoencoder_from_model_config


class AutoencoderPretransform(nn.Module):
    """Latent scale + frozen VAE (JAX pretransforms.py:56, encode_nwc :83, decode_nwc :94).

    The VAE runs in fp32, or in bf16 when `model_half` is set: its input is
    cast (JAX `_dtype`, :80-81) and every layer computes in its input's
    dtype, the parameters staying fp32. None of the txt2audio configs sets
    `model_half`, so the reference encodes and decodes in fp32.

    `iterate_batch` micro-batches the encode and the decode to bound their
    memory, as the JAX autoencoder's `encode`/`decode` do
    (autoencoders.py:309-318, :357-362): True runs one sample at a time, an
    int that many; False the whole batch. Every layer of the VAE is
    per-sample, so the result does not depend on it."""

    def __init__(self, model: AudioAutoencoder, scale: float = 1.0, model_half: bool = False,
                 iterate_batch: tp.Union[bool, int] = False):
        super().__init__()
        self.model = model
        self.scale = scale
        self.model_half = model_half
        self.iterate_batch = iterate_batch
        self.downsampling_ratio = model.downsampling_ratio
        self.io_channels = model.io_channels
        self.is_discrete = model.is_discrete
        self.num_quantizers = model.num_quantizers
        self.codebook_size = model.codebook_size

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the VAE computes in."""
        return torch.bfloat16 if self.model_half else torch.float32

    def _batched(self, fn, x: torch.Tensor) -> torch.Tensor:
        n = int(self.iterate_batch)
        if not self.iterate_batch or n >= x.shape[0]:
            return fn(x)
        return torch.cat([fn(xb) for xb in x.split(n)])

    @torch.no_grad()
    def encode_nwc(self, x: torch.Tensor) -> torch.Tensor:
        """audio [B, T, C] -> latents [B, T / ratio, latent_dim] / scale, fp32;
        the encoder runs in `dtype`."""
        return self._batched(lambda xb: self.model.encode_nwc(xb.to(self.dtype)).float(),
                             x) / self.scale

    @torch.no_grad()
    def tokenize(self, x: torch.Tensor) -> torch.Tensor:
        """audio [B, C, T] -> codes [B, K, T / ratio] (int64), in fp32 (JAX
        `tokenize` :99, which casts nothing)."""
        if not self.is_discrete:
            raise ValueError("cannot tokenize with a continuous model")
        return self.model.tokenize_nwc(x.transpose(1, 2).float()).transpose(1, 2)

    @torch.no_grad()
    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T / ratio] -> audio [B, C, T], fp32 (JAX `decode_tokens`
        :112-115, which neither scales nor casts)."""
        if not self.is_discrete:
            raise ValueError("cannot decode tokens with a continuous model")
        return self.model.decode_tokens_nwc(tokens.transpose(1, 2)).float().transpose(1, 2)

    @torch.no_grad()
    def decode_nwc(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, L, C] latents -> audio [B, T, io_channels], fp32; the
        decoder runs in `dtype`."""
        return self._batched(lambda zb: self.model.decode_nwc(zb.to(self.dtype)).float(),
                             z * self.scale)


def create_pretransform_from_config(config: tp.Dict[str, tp.Any]) -> AutoencoderPretransform:
    if config.get("type") != "autoencoder":
        raise NotImplementedError(f"pretransform type {config.get('type')!r} is not in the torch port")
    if config.get("chunked", False):
        raise NotImplementedError("chunked decoding is not in the torch port")
    autoencoder = autoencoder_from_model_config(config["config"])
    return AutoencoderPretransform(autoencoder, scale=config.get("scale", 1.0),
                                   model_half=config.get("model_half", False),
                                   iterate_batch=config.get("iterate_batch", False))
