"""Bottlenecks (counterpart of friendly_stable_audio_tools_tpu/models/bottleneck.py).

The VAE bottleneck of Stable Audio Open's pretransform. Encoding returns
the posterior mean, as the JAX package's training path does: it encodes
with no sampling rng (autoencoders.py:347-355, `vae_sample` with rng=None),
where the upstream reference draws a sample. Decoding is the identity.

The residual vector quantizer (`rvq`) of the audio LM's tokenizer
(bottleneck.py:146-278): each of `num_quantizers` codebooks quantizes the
residual the previous ones leave, by the nearest code in L2 (one matmul
over the codebook, argmin), in fp32. Encoding returns the quantized latents
and the codes; the straight-through form ze + (zq - ze) is kept, as it
rounds in fp32 as the JAX package's does, and the next residual depends on
it."""

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


class VectorQuantizer(nn.Module):
    """One codebook [codebook_size, codebook_dim], with linear projections
    in and out when codebook_dim differs from input_dim (JAX :146)."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.needs_proj = input_dim != codebook_dim
        if self.needs_proj:
            self.proj_in = nn.Linear(input_dim, codebook_dim)
            self.proj_out = nn.Linear(codebook_dim, input_dim)
        self.codebook = nn.Parameter(torch.empty(codebook_size, codebook_dim))

    def forward(self, x: torch.Tensor):
        """x [B, T, C_in] -> (quantized [B, T, C_in] in x's dtype, codes [B, T])."""
        z_e = (self.proj_in(x) if self.needs_proj else x).float()
        cb = self.codebook.float()
        d = z_e.square().sum(-1, keepdim=True) - 2 * (z_e @ cb.T) + cb.square().sum(-1)
        codes = d.argmin(-1)
        z_q = (z_e + (cb[codes] - z_e)).to(x.dtype)  # the straight-through form
        return (self.proj_out(z_q) if self.needs_proj else z_q), codes

    def lookup(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T] -> their codebook rows [B, T, C_in], fp32 (JAX :197)."""
        z_q = self.codebook.float()[codes]
        return self.proj_out(z_q) if self.needs_proj else z_q


class ResidualVQ(nn.Module):
    """`num_quantizers` codebooks, each quantizing the previous residual."""

    def __init__(self, input_dim: int, num_quantizers: int, codebook_size: int,
                 codebook_dim: tp.Optional[int] = None):
        super().__init__()
        self.num_quantizers = num_quantizers
        for i in range(num_quantizers):
            self.add_module(f"quantizer_{i}", VectorQuantizer(input_dim, codebook_size,
                                                              codebook_dim or input_dim))

    def forward(self, x: torch.Tensor):
        """x [B, T, C] -> (z_q [B, T, C], codes [B, T, Q])."""
        residual, z_q, codes = x, torch.zeros_like(x), []
        for i in range(self.num_quantizers):
            out, c = getattr(self, f"quantizer_{i}")(residual)
            z_q = z_q + out
            residual = residual - out
            codes.append(c)
        return z_q, torch.stack(codes, dim=-1)

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, Q] -> latents [B, T, C]: the codebooks' rows summed (JAX :238)."""
        return sum(getattr(self, f"quantizer_{i}").lookup(codes[..., i])
                   for i in range(self.num_quantizers))


class RVQBottleneck(nn.Module):
    """The `rvq` bottleneck (JAX :233): encode to (latents, codes), decode the
    identity. The lucidrains EMA options
    of the config (`decay`, `threshold_ema_dead_code`, `kmeans_*`) act only
    when the codec trains, which the port does not."""

    is_discrete = True

    def __init__(self, num_quantizers: int = 8, codebook_size: int = 1024,
                 codebook_dim: tp.Optional[int] = None, dim: tp.Optional[int] = None, **_ema):
        super().__init__()
        self.num_quantizers = num_quantizers
        self.codebook_size = codebook_size
        self.quantizer = ResidualVQ(dim, num_quantizers, codebook_size, codebook_dim)

    def encode(self, x: torch.Tensor, return_info: bool = False):
        z, codes = self.quantizer(x)
        return (z, {"quantizer_indices": codes}) if return_info else z

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def decode_tokens(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, Q] -> latents [B, T, dim] (JAX :276-277)."""
        return self.decode(self.quantizer.from_codes(codes))


def create_bottleneck_from_config(config: tp.Dict[str, tp.Any]) -> nn.Module:
    """The `vae` and `rvq` bottleneck types of the JAX factory."""
    kind = config.get("type")
    if kind == "vae":
        return VAEBottleneck()
    if kind == "rvq":
        return RVQBottleneck(**config.get("config", {}))
    raise NotImplementedError(f"bottleneck type {kind!r} is not in the torch port")
