"""AE-GAN training of an `autoencoder` model (counterpart of
friendly_stable_audio_tools_tpu/training/autoencoders.py:69-355).

Steps alternate once `warmup_steps` have passed: the discriminator trains on
odd steps, the autoencoder (the generator) on even ones; before warmup
every step is a generator step, which runs no discriminator at all
(:323-331). A generator step encodes the reals (a VAE samples its
posterior), optionally zeroes a random share of the latents, decodes, and
sums the weighted losses (:84-133): hinge adversarial and feature matching
from the discriminator (its weights frozen for the step), the mid/side
multi-resolution STFT loss twice and the left/right ones at half weight for
stereo, L1 where its weight is positive, and the bottleneck's KL or
quantizer loss; then AdamW (or Adam) with its schedule and the EMA of the
autoencoder's weights, which counts generator steps only (:186-193). A
discriminator step runs the autoencoder under torch.no_grad() and trains
the discriminator on its hinge loss (:304-318). With
`encoder_freeze_on_warmup` the encoder runs under torch.no_grad() once
warmed up, so its parameters get no gradient and AdamW leaves them alone
(the JAX package zeroes their updates instead, :287-294: the weights are
the same, its AdamW moments decay). Every random draw (the posterior
sample, the latent mask) comes from the wrapper's `torch.Generator`; the
tests pass the draws in instead (`draws=`). The discriminator's and the
loss's spectra run in fp32 on torch.stft (cuFFT on the card).
"""

from __future__ import annotations

import contextlib
import typing as tp

import torch

from ..models.bottleneck import RVQBottleneck, VAEBottleneck
from ..models.discriminators import create_discriminator_from_config
from ..utils.common import init_weights_
from .diffusion import clip_by_global_norm_
from .ema import ema_update_
from .losses import AuralossLoss, L1Loss, MultiLoss, ValueLoss
from .losses.auraloss import MultiResolutionSTFTLoss, SumAndDifferenceSTFTLoss
from .scheduler import build_optimizer


def create_loss_modules_from_bottleneck(bottleneck, loss_config: dict) -> tp.List[ValueLoss]:
    """The bottleneck's loss terms (JAX :42-56): KL for `vae`, the
    quantizer loss for `rvq`."""
    if isinstance(bottleneck, VAEBottleneck):
        kl_weight = loss_config.get("bottleneck", {}).get("weights", {}).get("kl", 1e-6)
        return [ValueLoss(key="kl", weight=kl_weight, name="kl_loss")]
    if isinstance(bottleneck, RVQBottleneck):
        return [ValueLoss(key="quantizer_loss", weight=1.0, name="quantizer_loss")]
    return []


class AutoencoderTrainingWrapper:
    """Owns the discriminator, the two optimizers and schedules, the EMA of
    the autoencoder's weights and the step counter."""

    def __init__(self, autoencoder, loss_config: dict, optimizer_configs: tp.Optional[dict] = None,
                 lr: float = 1e-4, warmup_steps: int = 0, encoder_freeze_on_warmup: bool = False,
                 sample_rate: int = 48000, use_ema: bool = True, force_input_mono: bool = False,
                 latent_mask_ratio: float = 0.0, teacher_model=None, seed: int = 0):
        self.autoencoder = autoencoder
        self.teacher_model = teacher_model
        self.warmup_steps = warmup_steps
        self.encoder_freeze_on_warmup = encoder_freeze_on_warmup
        self.force_input_mono = force_input_mono
        self.latent_mask_ratio = latent_mask_ratio
        self.gradient_clip_val = 0.0
        dev = self.device
        if optimizer_configs is None:  # JAX :96-102
            optimizer_configs = {
                side: {"optimizer": {"type": "AdamW", "config": {"lr": lr, "betas": [0.8, 0.99]}}}
                for side in ("autoencoder", "discriminator")}

        stft_args = loss_config["spectral"]["config"]
        out_ch = autoencoder.out_channels
        if out_ch == 2:
            self.sdstft = SumAndDifferenceSTFTLoss(sample_rate=sample_rate, **stft_args)
            self.lrstft = MultiResolutionSTFTLoss(sample_rate=sample_rate, **stft_args)
        else:
            self.sdstft = MultiResolutionSTFTLoss(sample_rate=sample_rate, **stft_args)

        disc_cfg = loss_config["discriminator"]
        with torch.device("meta"):
            disc = create_discriminator_from_config(disc_cfg, out_ch)
        self.discriminator = init_weights_(disc.to_empty(device=dev),
                                           torch.Generator(device=dev).manual_seed(seed))

        gen_losses = [
            ValueLoss(key="loss_adv", weight=disc_cfg["weights"]["adversarial"], name="loss_adv"),
            ValueLoss(key="feature_matching_distance",
                      weight=disc_cfg["weights"]["feature_matching"], name="feature_matching")]
        mrstft_weight = loss_config["spectral"]["weights"]["mrstft"]
        if teacher_model is not None:
            w = mrstft_weight * 0.25
            gen_losses += [
                AuralossLoss(self.sdstft, "reals", "decoded", name="mrstft_loss", weight=w),
                AuralossLoss(self.sdstft, "decoded", "teacher_decoded",
                             name="mrstft_loss_distill", weight=w),
                AuralossLoss(self.sdstft, "reals", "own_latents_teacher_decoded",
                             name="mrstft_loss_own_latents_teacher", weight=w),
                AuralossLoss(self.sdstft, "reals", "teacher_latents_own_decoded",
                             name="mrstft_loss_teacher_latents_own", weight=w)]
        else:
            gen_losses.append(AuralossLoss(self.sdstft, "reals", "decoded", name="mrstft_loss",
                                           weight=mrstft_weight))
            if out_ch == 2:
                gen_losses += [
                    AuralossLoss(self.lrstft, "reals_left", "decoded_left", name="stft_loss_left",
                                 weight=mrstft_weight / 2),
                    AuralossLoss(self.lrstft, "reals_right", "decoded_right",
                                 name="stft_loss_right", weight=mrstft_weight / 2)]
            # the mid/side term twice, as the reference and the JAX package
            # add it (JAX :147-148)
            gen_losses.append(AuralossLoss(self.sdstft, "reals", "decoded", name="mrstft_loss",
                                           weight=mrstft_weight))
        l1_weight = loss_config.get("time", {}).get("weights", {}).get("l1", 0.0)
        if l1_weight > 0.0:
            gen_losses.append(L1Loss("reals", "decoded", weight=l1_weight, name="l1_time_loss"))
        if autoencoder.bottleneck is not None:
            gen_losses += create_loss_modules_from_bottleneck(autoencoder.bottleneck, loss_config)
        self.losses_gen = MultiLoss(gen_losses)
        self.losses_disc = MultiLoss([ValueLoss(key="loss_dis", weight=1.0,
                                                name="discriminator_loss")])

        autoencoder.requires_grad_(True)
        # flax's LSTM cell has no input-side bias: the SEANet's nn.LSTM keeps
        # its bias_ih at zero (utils/convert.py), untrained
        self.gen_named = []
        for n, p in autoencoder.named_parameters():
            if ".bias_ih_l" in n:
                p.requires_grad_(False)
            else:
                self.gen_named.append((n, p))
        if teacher_model is not None:
            teacher_model.requires_grad_(False)
        self.gen_params = [p for _, p in self.gen_named]
        self.disc_params = list(self.discriminator.parameters())
        self.gen_optimizer, self.gen_scheduler = build_optimizer(
            optimizer_configs["autoencoder"], self.gen_params)
        self.disc_optimizer, self.disc_scheduler = build_optimizer(
            optimizer_configs["discriminator"], self.disc_params)
        self.ema = [p.detach().clone() for p in self.gen_params] if use_ema else None
        self.step = 0
        self.generator = torch.Generator(device=dev).manual_seed(0)

    @property
    def device(self) -> torch.device:
        return next(self.autoencoder.parameters()).device

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

    def ema_updates(self, step: int) -> int:
        """Generator steps before `step` (JAX `_ema_updates` :186-193): every
        step during warmup, every other one after."""
        w = self.warmup_steps
        return step if step <= w else w + (step - w + 1) // 2

    # ---- the step ---------------------------------------------------------

    def forward_info(self, reals: torch.Tensor, freeze_encoder: bool,
                     draws: tp.Optional[dict] = None):
        """reals [B, T, C] -> (the losses' info dict, decoded [B, T, C]) (JAX
        `_forward_info` :195-258). `draws` may hold "noise" (the VAE's
        standard normal draw, the latents' shape) and "latent_mask" (bool,
        the latents' shape) in place of the generator's draws."""
        draws = draws or {}
        ae = self.autoencoder
        encoder_input = reals.mean(dim=-1, keepdim=True) if self.force_input_mono else reals
        with torch.no_grad() if freeze_encoder else contextlib.nullcontext():
            latents, info = ae.encode_nwc(encoder_input, return_info=True, sample=True,
                                          generator=self.generator, noise=draws.get("noise"))
        info = {k: v for k, v in info.items() if k != "quantizer_indices"}
        loss_info = {"reals_nwc": reals, "encoder_input": encoder_input, **info}
        if self.latent_mask_ratio > 0.0:
            mask = draws.get("latent_mask")
            if mask is None:
                mask = torch.rand(latents.shape, generator=self.generator,
                                  device=latents.device) < self.latent_mask_ratio
            latents = torch.where(mask.to(latents.device), torch.zeros_like(latents), latents)
        loss_info["latents"] = latents
        decoded = ae.decode_nwc(latents)
        if decoded.shape[1] != reals.shape[1]:
            # the SEANet decoder's stride-5 upsample gives 5T - 1 samples in
            # both packages; the JAX trainer's losses fail on it the same way
            raise ValueError(f"the decoder returns {decoded.shape[1]} samples for "
                             f"{reals.shape[1]}: the AE-GAN losses compare equal lengths")
        reals_bct, decoded_bct = reals.transpose(1, 2), decoded.transpose(1, 2)
        loss_info.update(reals=reals_bct, decoded=decoded_bct)
        if ae.out_channels == 2:
            loss_info.update(decoded_left=decoded_bct[:, 0:1], decoded_right=decoded_bct[:, 1:2],
                             reals_left=reals_bct[:, 0:1], reals_right=reals_bct[:, 1:2])
        if self.teacher_model is not None:
            teacher = self.teacher_model
            with torch.no_grad():  # every distillation decode (JAX :230-258)
                t_latents = teacher.encode_nwc(encoder_input)
                loss_info.update(
                    teacher_latents=t_latents,
                    teacher_decoded=teacher.decode_nwc(t_latents).transpose(1, 2),
                    own_latents_teacher_decoded=teacher.decode_nwc(latents).transpose(1, 2),
                    teacher_latents_own_decoded=ae.decode_nwc(t_latents).transpose(1, 2))
        return loss_info, decoded

    def _frozen_encoder(self) -> bool:
        return self.step >= self.warmup_steps and self.encoder_freeze_on_warmup

    def generator_step(self, reals: torch.Tensor, draws: tp.Optional[dict] = None):
        """The autoencoder's forward, losses and backward (gradients into
        the autoencoder's `.grad`) -> (loss, {name: value})."""
        warmed_up = self.step >= self.warmup_steps
        self.discriminator.requires_grad_(False)
        loss_info, decoded = self.forward_info(reals, self._frozen_encoder(), draws)
        if warmed_up:
            loss_dis, loss_adv, fm = self.discriminator.loss(reals, decoded)
        else:
            loss_dis = loss_adv = fm = torch.zeros((), device=reals.device)
        loss_info.update(loss_dis=loss_dis, loss_adv=loss_adv, feature_matching_distance=fm)
        loss, losses = self.losses_gen(loss_info)
        metrics = dict(losses)
        metrics["latent_std"] = loss_info["latents"].float().std(correction=0)
        metrics["data_std"] = loss_info["encoder_input"].float().std(correction=0)
        loss.backward()
        return loss, metrics

    def discriminator_step(self, reals: torch.Tensor, draws: tp.Optional[dict] = None):
        """The autoencoder under torch.no_grad(), the discriminator's hinge
        loss and backward -> (loss, {name: value})."""
        self.discriminator.requires_grad_(True)
        with torch.no_grad():
            _, decoded = self.forward_info(reals, self._frozen_encoder(), draws)
        loss_dis, _, _ = self.discriminator.loss(reals, decoded)
        loss, losses = self.losses_disc({"loss_dis": loss_dis})
        loss.backward()
        return loss, losses

    def train_step(self, reals: torch.Tensor, metadata: tp.Sequence[dict] = (), accum: int = 1,
                   draws: tp.Optional[dict] = None) -> tp.Dict[str, float]:
        """One generator or discriminator update by the step's parity (JAX
        `train_step` :323-331) on reals [B, T, C] (the trainer's `accum`
        loader batches concatenated, as the JAX trainer joins them for a
        wrapper without accumulation). Returns host metrics."""
        self.autoencoder.train()
        reals = reals.to(self.device)
        training_disc = self.step % 2 == 1 and self.step >= self.warmup_steps
        self.gen_optimizer.zero_grad(set_to_none=True)
        self.disc_optimizer.zero_grad(set_to_none=True)
        if training_disc:
            loss, metrics = self.discriminator_step(reals, draws)
            self._update(self.disc_optimizer, self.disc_scheduler, self.disc_params)
        else:
            loss, metrics = self.generator_step(reals, draws)
            self._update(self.gen_optimizer, self.gen_scheduler, self.gen_params)
            if self.ema is not None:
                ema_update_(self.ema, [p.detach() for p in self.gen_params],
                            self.ema_updates(self.step))
        self.step += 1
        return {k: float(v.detach()) for k, v in {"loss": loss, **metrics}.items()}

    def _update(self, optimizer, scheduler, params) -> None:
        if self.gradient_clip_val > 0:  # the JAX trainer chains the clip (trainer.py:83-91)
            clip_by_global_norm_([p.grad for p in params if p.grad is not None],
                                 self.gradient_clip_val)
        optimizer.step()
        scheduler.step()

    # ---- state -------------------------------------------------------------

    def state_dict(self) -> dict:
        """What a checkpoint holds (the JAX GANTrainState)."""
        return {"autoencoder": self.autoencoder.state_dict(),
                "discriminator": self.discriminator.state_dict(),
                "gen_optimizer": self.gen_optimizer.state_dict(),
                "disc_optimizer": self.disc_optimizer.state_dict(),
                "gen_scheduler": self.gen_scheduler.state_dict(),
                "disc_scheduler": self.disc_scheduler.state_dict(),
                "ema": self.ema, "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.autoencoder.load_state_dict(state["autoencoder"])
        self.discriminator.load_state_dict(state["discriminator"])
        for name in ("gen_optimizer", "disc_optimizer", "gen_scheduler", "disc_scheduler"):
            getattr(self, name).load_state_dict(state[name])
        if self.ema is not None:
            for e, v in zip(self.ema, state["ema"]):
                e.copy_(v)
        self.step = int(state["step"])

    def export_model(self, path: str) -> None:
        """The autoencoder's state_dict, its EMA weights where kept (JAX
        `export_model` :336-355)."""
        sd = self.autoencoder.state_dict()
        if self.ema is not None:
            sd.update((n, e.detach().clone()) for (n, _), e in zip(self.gen_named, self.ema))
        torch.save(sd, path)
