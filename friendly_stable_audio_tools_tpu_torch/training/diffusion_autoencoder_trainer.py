"""Diffusion autoencoder training (counterpart of
friendly_stable_audio_tools_tpu/training/diffusion_autoencoder_trainer.py).

One step: the trainable encoder and bottleneck on the raw audio (on the
card the Oobleck encoder's K2 and K3 under grad, their autograd Functions
of ops/kernels/conv1d.py; a VAE bottleneck samples its latents), the
latents nearest-upsampled to the diffusion length, the diffusion input (the
audio, or its frozen pretransform encode) noised at a quasi-random uniform
timestep, the diffusion backbone with the upsampled latents as its
input-concat condition, MSE on the v target, Adam over the encoder, the
decoder and bottleneck where they have weights, and the backbone, and the
EMA of all of them. The metrics add `latent_std`. Draws are injectable as
"t", "noise" and "latent_noise" (the bottleneck's)."""

from __future__ import annotations

import typing as tp

import torch

from .diffusion import DiffusionCondTrainingWrapper, draw_timesteps, get_alphas_sigmas
from .scheduler import build_optimizer


class DiffusionAutoencoderTrainingWrapper(DiffusionCondTrainingWrapper):
    """The conditioned trainer's step, update, state and counters
    (training/diffusion.py) over the whole model but its frozen pretransform,
    with the loss and the export of its own."""

    def __init__(self, model, lr: float = 1e-4, use_reconstruction_loss: bool = False,
                 use_ema: bool = True, timestep_sampler: str = "uniform"):
        self.model = model
        self.use_reconstruction_loss = use_reconstruction_loss  # unused, as in JAX
        self.timestep_sampler = timestep_sampler
        self.gradient_clip_val = 0.0
        model.requires_grad_(True)
        if model.pretransform is not None:
            model.pretransform.requires_grad_(False)
        self.trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.dit_params = list(self.trainable.values())  # the EMA's: both trees
        self.optimizer, self.scheduler = build_optimizer(
            {"optimizer": {"type": "Adam", "config": {"lr": lr}}}, self.dit_params)
        self.ema = [p.detach().clone() for p in self.dit_params] if use_ema else None
        self.step = 0
        self.qmc_counter = 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    @property
    def device(self) -> torch.device:
        return next(self.model.diffusion.parameters()).device

    def loss(self, reals: torch.Tensor, metadata=None, qmc_counter: int = 0,
             draws: tp.Optional[dict] = None):
        """reals [B, T, C] -> (loss, metrics)."""
        draws, model, dev = draws or {}, self.model, self.device
        reals = reals.to(dev).float()
        x = reals if model.pretransform is None else model.pretransform.encode_nwc(reals)
        latents = model.encode_nwc(reals, sample=True, generator=self.generator,
                                   noise=draws.get("latent_noise"))
        up = x.shape[1]
        if latents.shape[1] != up:
            latents_up = latents[:, (torch.arange(up, device=dev) * latents.shape[1]) // up]
        else:
            latents_up = latents
        t = draws.get("t")
        if t is None:
            t = draw_timesteps(self.timestep_sampler, reals.shape[0], qmc_counter,
                               self.generator, dev)
        t = t.to(dev).float()
        alphas, sigmas = get_alphas_sigmas(t)
        alphas, sigmas = alphas[:, None, None], sigmas[:, None, None]
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(x.shape, generator=self.generator, device=dev)
        noise = noise.to(dev).float()
        x = x.float()
        output = model.diffusion.model(x * alphas + noise * sigmas, t,
                                       input_concat_cond=latents_up)
        loss = (output - (noise * alphas - x * sigmas)).square().mean()
        return loss, {"mse_loss": loss.detach(),
                      "latent_std": latents.detach().float().std(unbiased=False)}

    def export_model(self, path: str) -> None:
        """The EMA of both trees where kept, else the live weights, as a
        state_dict of the model (the frozen pretransform left out)."""
        values = self.ema if self.ema is not None else [p.detach() for p in self.dit_params]
        torch.save(dict(zip(self.trainable, values)), path)
