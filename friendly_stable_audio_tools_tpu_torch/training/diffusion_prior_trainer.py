"""Mono-to-stereo diffusion prior training (counterpart of
friendly_stable_audio_tools_tpu/training/diffusion_prior_trainer.py).

The conditioned trainer's step (training/diffusion.py) with no CFG dropout,
its `source` condition the dual-mono version of the stereo batch (its
channel mean on both channels), encoded through the frozen pretransform
where there is one, as is the target. With `use_reconstruction_loss` the
predicted clean signal, decoded through the pretransform with its gradient,
adds 0.1 x the sum-and-difference multi-resolution STFT loss against the
batch (perceptually weighted, FFT sizes 2048 down to 32)."""

from __future__ import annotations

import typing as tp

import torch

from .diffusion import DiffusionCondTrainingWrapper


class DiffusionPriorTrainingWrapper(DiffusionCondTrainingWrapper):
    def __init__(self, model, lr: tp.Optional[float] = None, prior_type: str = "mono_stereo",
                 log_loss_info: bool = False, use_reconstruction_loss: bool = False,
                 optimizer_configs: tp.Optional[dict] = None, use_ema: bool = True, **kwargs):
        super().__init__(model, lr=lr, use_ema=use_ema, log_loss_info=log_loss_info,
                         optimizer_configs=optimizer_configs, cfg_dropout_prob=0.0, **kwargs)
        if prior_type != "mono_stereo":
            raise ValueError(f"Unknown prior type {prior_type}")
        self.prior_type = prior_type
        self.use_reconstruction_loss = use_reconstruction_loss
        self._reals = None
        if use_reconstruction_loss:
            from .losses.auraloss import SumAndDifferenceSTFTLoss

            fft_sizes = [2048, 1024, 512, 256, 128, 64, 32]
            hops = [512, 256, 128, 64, 32, 16, 8]
            self.sdstft = SumAndDifferenceSTFTLoss(fft_sizes, hops, fft_sizes,
                                                   sample_rate=model.sample_rate,
                                                   perceptual_weighting=True)

    def loss(self, reals: torch.Tensor, metadata: tp.Sequence[dict], qmc_counter: int = 0,
             draws: tp.Optional[dict] = None, extra_cond=None, encoded: bool = False):
        """reals [B, T, 2] the stereo target; the draws as the conditioned
        trainer's ("t", "noise")."""
        reals = reals.to(self.device).float()
        source = reals.mean(-1, keepdim=True).repeat(1, 1, reals.shape[-1])
        x, src = reals, source
        pt = self.model.pretransform
        if pt is not None and not self.pre_encoded:
            x, src = pt.encode_nwc(reals), pt.encode_nwc(source)
        valid = torch.ones(src.shape[:2], dtype=torch.bool, device=src.device)
        self._reals = reals
        try:
            return super().loss(x, metadata, qmc_counter, draws,
                                extra_cond={"source": (src, valid)}, encoded=True)
        finally:
            self._reals = None

    def extra_losses(self, loss, losses, output, noised, alphas, sigmas):
        if not self.use_reconstruction_loss:
            return loss, losses
        pred = noised * alphas - output * sigmas
        pt = self.model.pretransform
        if pt is not None:  # with the gradient, unlike the frozen encode
            pred = pt.model.decode_nwc((pred * pt.scale).to(pt.dtype)).float()
        recon = self.sdstft(pred.transpose(1, 2), self._reals.transpose(1, 2))
        return loss + 0.1 * recon, {**losses, "recon_loss": recon}
