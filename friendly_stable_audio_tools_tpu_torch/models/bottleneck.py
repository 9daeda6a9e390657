"""Bottlenecks (counterpart of friendly_stable_audio_tools_tpu/models/bottleneck.py).

The VAE bottleneck (`vae_sample`, :46-87): the encoder's [mean | scale]
channels give stdev = softplus(scale) + 1e-4; encoding returns the
posterior mean, as the JAX package's frozen encodes do (no sampling rng),
or with `sample` a draw mean + stdev * noise, as its AE-GAN trainer does,
and with `return_info` the KL to a standard normal, summed over channels
and averaged over batch and time, in fp32. Decoding is the identity.

The residual vector quantizer (`rvq`) of the audio LM's tokenizer
(bottleneck.py:146-278): each of `num_quantizers` codebooks quantizes the
residual the previous ones leave, by the nearest code in L2 (one matmul
over the codebook, argmin), in fp32. Encoding returns the quantized latents
and the codes, and the JAX package's stateless training form: the
straight-through estimator ze + sg(zq - ze) (rounded in fp32 as there; the
next residual depends on it) and the commitment plus codebook loss as
`quantizer_loss`, the codebooks learning from the loss instead of the
upstream EMA updates."""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn


class VAEBottleneck(nn.Module):
    def encode(self, x: torch.Tensor, return_info: bool = False, sample: bool = False,
               generator: tp.Optional[torch.Generator] = None,
               noise: tp.Optional[torch.Tensor] = None):
        """[..., 2 * latent_dim] (mean | scale) -> latents in x's dtype: the
        mean, or with `sample` mean + stdev * noise (`noise` where given,
        else a standard normal draw from `generator`); with `return_info`
        also {"kl": the fp32 KL}."""
        mean, scale = x.chunk(2, dim=-1)
        if not (return_info or sample):
            return mean
        mean32 = mean.float()
        stdev = F.softplus(scale.float()) + 1e-4
        var = stdev * stdev
        latents = mean32
        if sample:
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator, device=mean.device)
            latents = mean32 + stdev * noise.float()
        latents = latents.to(mean.dtype)
        if not return_info:
            return latents
        kl = (mean32 * mean32 + var - torch.log(var) - 1).sum(-1).mean()
        return latents, {"kl": kl}

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
        """x [B, T, C_in] -> (quantized [B, T, C_in] in x's dtype, codes
        [B, T], commitment loss, codebook loss)."""
        z_e = (self.proj_in(x) if self.needs_proj else x).float()
        cb = self.codebook.float()
        d = z_e.square().sum(-1, keepdim=True) - 2 * (z_e @ cb.T) + cb.square().sum(-1)
        codes = d.argmin(-1)
        cq = cb[codes]
        commitment = (z_e - cq.detach()).square().mean()
        codebook_loss = (z_e.detach() - cq).square().mean()
        z_q = (z_e + (cq - z_e).detach()).to(x.dtype)  # the straight-through form
        return (self.proj_out(z_q) if self.needs_proj else z_q), codes, commitment, codebook_loss

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
        """x [B, T, C] -> (z_q [B, T, C], codes [B, T, Q], the commitment and
        codebook losses summed over the codebooks)."""
        residual, z_q, codes, commit, cbl = x, torch.zeros_like(x), [], 0.0, 0.0
        for i in range(self.num_quantizers):
            out, c, c_loss, cb_loss = getattr(self, f"quantizer_{i}")(residual)
            z_q = z_q + out
            residual = residual - out
            codes.append(c)
            commit = commit + c_loss
            cbl = cbl + cb_loss
        return z_q, torch.stack(codes, dim=-1), commit, cbl

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, Q] -> latents [B, T, C]: the codebooks' rows summed (JAX :238)."""
        return sum(getattr(self, f"quantizer_{i}").lookup(codes[..., i])
                   for i in range(self.num_quantizers))


class RVQBottleneck(nn.Module):
    """The `rvq` bottleneck (JAX :233): encode to (latents, codes), decode the
    identity. The lucidrains EMA options of the config (`decay`,
    `threshold_ema_dead_code`, `kmeans_*`) are taken and unused, as in the
    JAX package: the codebooks train through `quantizer_loss`."""

    is_discrete = True

    def __init__(self, num_quantizers: int = 8, codebook_size: int = 1024,
                 codebook_dim: tp.Optional[int] = None, dim: tp.Optional[int] = None, **_ema):
        super().__init__()
        self.num_quantizers = num_quantizers
        self.codebook_size = codebook_size
        self.quantizer = ResidualVQ(dim, num_quantizers, codebook_size, codebook_dim)

    def encode(self, x: torch.Tensor, return_info: bool = False, **_sampling):
        """x [B, T, dim] -> z (and {"quantizer_indices", "quantizer_loss"});
        the VAE's sampling arguments are taken and unused (JAX :265)."""
        z, codes, commit, cbl = self.quantizer(x)
        if not return_info:
            return z
        return z, {"quantizer_indices": codes, "quantizer_loss": commit + cbl}

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
