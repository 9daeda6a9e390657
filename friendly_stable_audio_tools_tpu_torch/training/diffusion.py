"""Conditioned diffusion training (counterpart of
friendly_stable_audio_tools_tpu/training/diffusion.py:DiffusionCondTrainingWrapper
:84-390 and DiffusionCondInpaintTrainingWrapper :491-567).

One step: conditioner embeddings (trainable number or int conditioners,
frozen T5 or CLAP), frozen VAE encode of the raw audio (posterior mean,
under torch.no_grad(); skipped with `pre_encoded`, whose batches hold
latents, divided by the pretransform's scale), noising at quasi-random
uniform or logit-normal timesteps under the v or the rectified-flow
objective, the backbone's forward with CFG dropout and backward (the DiT,
or Stable Audio 1.0's ADP U-Net), then the optimizer (AdamW + InverseLR,
or the Adam of a config that sets only `learning_rate`) and the EMA of the
backbone's parameters. With `mask_padding` the metadata's padding masks
(resampled to the latent rate) mask the DiT's self-attention and the loss,
unless the padding-mask dropout drops them for the step; `log_loss_info`
adds the loss per eighth of the sigma range. Gradient accumulation splits
the batch into micro-batches whose gradients average into one update.
Every random draw comes from the wrapper's `torch.Generator`; the tests
pass the draws in instead (`draws=`), since the two frameworks' random
streams differ.

The unconditional wrapper (`diffusion_uncond`: Dance Diffusion) is the
same step without a conditioner or CFG dropout; the mono-to-stereo prior's
and the diffusion autoencoder's trainers are in
training/diffusion_prior_trainer.py and
training/diffusion_autoencoder_trainer.py.

The inpaint wrapper encodes once, draws a keep mask per element (random
segments, everything, or a suffix to regenerate) and feeds the mask and
the masked latents to the DiT as the `inpaint_mask` and
`inpaint_masked_input` input-concat conditions.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from .ema import ema_update_
from .losses import MSELoss, MultiLoss
from .scheduler import build_optimizer

_MASK32 = 0xFFFFFFFF


def get_alphas_sigmas(t: torch.Tensor):
    """(cos(t pi/2), sin(t pi/2)) (JAX inference/sampling.py:42)."""
    return torch.cos(t * math.pi / 2), torch.sin(t * math.pi / 2)


def _bit_reverse32(x: torch.Tensor) -> torch.Tensor:
    """Bit reversal of 32-bit words held in int64."""
    x = x & _MASK32
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        x = ((x >> shift) & mask) | ((x & mask) << shift)
    return ((x >> 16) | (x << 16)) & _MASK32


def quasirandom_uniform(counter: int, n: int, shift: torch.Tensor) -> torch.Tensor:
    """Low-discrepancy draws in [0, 1): the base-2 radical inverse of
    counter, counter + 1, ... (top 24 bits, exact in fp32) rotated by `shift`
    (JAX training/diffusion.py:61, bit for bit)."""
    idx = (counter + torch.arange(n, dtype=torch.int64, device=shift.device)) & _MASK32
    vdc = (_bit_reverse32(idx) >> 8).to(torch.float32) / float(2 ** 24)
    return torch.remainder(vdc + shift.float(), 1.0)


def draw_timesteps(sampler: str, batch: int, qmc_counter: int, generator: torch.Generator,
                   device: torch.device) -> torch.Tensor:
    """[batch] timesteps in [0, 1) (JAX :68-74): "uniform" the rotated
    quasi-random sequence, "logit_normal" sigmoid of standard normals."""
    if sampler == "uniform":
        shift = torch.rand((), generator=generator, device=device)
        return quasirandom_uniform(qmc_counter, batch, shift)
    if sampler == "logit_normal":
        return torch.sigmoid(torch.randn(batch, generator=generator, device=device))
    raise ValueError(f"Unknown timestep sampler {sampler}")


def nearest_interp_mask(mask: torch.Tensor, length: int) -> torch.Tensor:
    """[B, T] -> [B, length] by nearest interpolation (JAX :77-81)."""
    idx = (torch.arange(length, device=mask.device) * mask.shape[1]) // length
    return mask[:, idx]


def padding_mask_from_metadata(metadata: tp.Sequence[dict]) -> tp.Optional[torch.Tensor]:
    """The loader's per-sample padding masks stacked into [B, T] bool, or
    None where the metadata carries none (JAX prepare_batch :365-367)."""
    if not metadata or "padding_mask" not in metadata[0]:
        return None
    return torch.stack([torch.as_tensor(md["padding_mask"]).reshape(-1) for md in metadata]).bool()


class DiffusionCondTrainingWrapper:
    """Owns the trainable/frozen split, the optimizer, the schedule, the EMA
    and the step and quasi-random counters of one `diffusion_cond` model,
    with the JAX wrapper's options (`mask_padding`, `mask_padding_dropout`,
    `log_loss_info`, `pre_encoded`, `timestep_sampler`) and the model's
    objective (`v` or `rectified_flow`).

    Trainable: the backbone and every conditioner whose `trainable` is not
    False (the JAX package's `Conditioner.trainable`: T5 is frozen, CLAP
    unless `finetune`); frozen: those and the pretransform."""

    def __init__(self, model, lr: tp.Optional[float] = None, use_ema: bool = True,
                 optimizer_configs: tp.Optional[dict] = None, cfg_dropout_prob: float = 0.1,
                 mask_padding: bool = False, mask_padding_dropout: float = 0.0,
                 log_loss_info: bool = False, pre_encoded: bool = False,
                 timestep_sampler: str = "uniform"):
        if lr is None and optimizer_configs is None:
            raise ValueError("Must specify either lr or optimizer_configs in training config")
        if model.diffusion_objective not in ("v", "rectified_flow"):
            raise ValueError(model.diffusion_objective)
        if timestep_sampler not in ("uniform", "logit_normal"):
            raise ValueError(f"Unknown timestep sampler {timestep_sampler}")
        self.model = model
        self.cfg_dropout_prob = cfg_dropout_prob
        self.mask_padding = mask_padding
        self.mask_padding_dropout = mask_padding_dropout
        self.log_loss_info = log_loss_info
        self.pre_encoded = pre_encoded
        self.timestep_sampler = timestep_sampler
        self.gradient_clip_val = 0.0

        model.requires_grad_(False)
        model.model.requires_grad_(True)
        if model.conditioner is not None:
            for c in model.conditioner.conditioners.values():
                if getattr(c, "trainable", True):
                    c.requires_grad_(True)
        self.trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.dit_params = list(model.model.parameters())

        if optimizer_configs is None:
            optimizer_configs = {"diffusion": {"optimizer": {"type": "Adam", "config": {"lr": lr}}}}
        self.optimizer, self.scheduler = build_optimizer(optimizer_configs["diffusion"],
                                                         list(self.trainable.values()))
        self.ema = [p.detach().clone() for p in self.dit_params] if use_ema else None
        self.losses = MultiLoss([MSELoss("output", "targets", name="mse_loss",
                                         mask_key="padding_mask" if mask_padding else None)])
        self.step = 0
        self.qmc_counter = 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    @property
    def device(self) -> torch.device:
        return next(self.model.model.parameters()).device

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

    # ---- the step ---------------------------------------------------------

    def latents(self, reals: torch.Tensor) -> torch.Tensor:
        """The diffusion input of a batch: the frozen encode of raw audio, or
        with `pre_encoded` the batch's latents over the pretransform's scale
        (JAX :231-242); a model without a pretransform diffuses `reals`."""
        pt = self.model.pretransform
        if pt is None:
            return reals
        if not self.pre_encoded:
            return pt.encode_nwc(reals)
        return reals / pt.scale if pt.scale != 1.0 else reals

    def loss(self, reals: torch.Tensor, metadata: tp.Sequence[dict], qmc_counter: int = 0,
             draws: tp.Optional[dict] = None, extra_cond: tp.Optional[dict] = None,
             encoded: bool = False):
        """reals [B, T, C] audio (latents with `pre_encoded`, or the
        diffusion input itself with `encoded`) -> (loss, metrics). `draws`
        may hold "t" [B], "noise" (the latents' shape), "cfg_dropout_mask"
        [B], "prepend_cfg_dropout_mask" [B] and "padding_dropout" (a bool:
        whether this step drops the padding mask) in place of the
        generator's draws. `extra_cond` adds conditioning tensors by id
        (the inpaint wrapper's)."""
        draws = draws or {}
        model, dev = self.model, self.device
        cond = model.conditioner(metadata, device=dev) if model.conditioner is not None else {}
        cond.update(extra_cond or {})
        reals = reals.to(dev)
        x = reals if encoded else self.latents(reals)
        mask = padding_mask_from_metadata(metadata) if self.mask_padding else None
        if mask is not None:
            mask = mask.to(dev)
            if model.pretransform is not None and not (encoded or self.pre_encoded):
                mask = nearest_interp_mask(mask, x.shape[1])
        t = draws.get("t")
        if t is None:
            t = draw_timesteps(self.timestep_sampler, x.shape[0], qmc_counter, self.generator, dev)
        t = t.to(dev).float()
        if model.diffusion_objective == "v":
            alphas, sigmas = get_alphas_sigmas(t)
        else:
            alphas, sigmas = 1 - t, t
        alphas, sigmas = alphas[:, None, None], sigmas[:, None, None]
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(x.shape, generator=self.generator, device=dev)
        noise = noise.to(dev).float()
        if mask is not None and self.mask_padding_dropout > 0:
            drop = draws.get("padding_dropout")
            if drop is None:
                drop = torch.rand((), generator=self.generator, device=dev) < self.mask_padding_dropout
            mask = mask | torch.as_tensor(drop, device=dev)
        x = x.float()
        inputs = model.get_conditioning_inputs(cond) if cond else {}
        output = model.model(x * alphas + noise * sigmas, t,
                             cfg_dropout_prob=self.cfg_dropout_prob,
                             cfg_dropout_mask=draws.get("cfg_dropout_mask"),
                             generator=self.generator,
                             **({"prepend_cfg_dropout_mask": draws.get("prepend_cfg_dropout_mask")}
                                if "prepend_cond" in inputs else {}),
                             **({"mask": mask} if mask is not None else {}),
                             **inputs)
        targets = noise * alphas - x * sigmas if model.diffusion_objective == "v" else noise - x
        loss, losses = self.losses({"output": output, "targets": targets, "padding_mask": mask})
        loss, losses = self.extra_losses(loss, losses, output, x * alphas + noise * sigmas,
                                         alphas, sigmas)
        metrics = {**{k: v.detach() for k, v in losses.items()},
                   "std_data": x.std(unbiased=False)}
        if self.log_loss_info:
            metrics.update(sigma_bucket_losses(output.detach(), targets, sigmas.flatten()))
        return loss, metrics

    def extra_losses(self, loss, losses, output, noised, alphas, sigmas):
        """Further loss terms of a derived trainer (the prior's reconstruction
        loss): (loss, losses) as they stand here."""
        return loss, losses

    def train_step(self, reals: torch.Tensor, metadata: tp.Sequence[dict], accum: int = 1,
                   draws: tp.Optional[tp.Sequence[dict]] = None) -> tp.Dict[str, float]:
        """One optimizer update from `accum` micro-batches of the batch, their
        gradients averaged (JAX training/diffusion.py:314-356); `draws[i]`
        (optional) are micro-batch i's draws. Returns host metrics."""
        self.model.train()
        b = reals.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum_batches {accum}")
        mb = b // accum
        self.optimizer.zero_grad(set_to_none=True)
        totals: tp.Dict[str, torch.Tensor] = {}
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            loss, metrics = self.loss(reals[rows], metadata[rows], self.qmc_counter + i * mb,
                                      draws[i] if draws else None)
            (loss / accum).backward()
            for k, v in {"loss": loss.detach(), **metrics}.items():
                totals[k] = totals.get(k, 0.0) + v / accum
        self.apply_update(b)
        return {k: float(v) for k, v in totals.items()}

    def apply_update(self, n_samples: int) -> None:
        """Clip (when set), AdamW + schedule, EMA, counters."""
        params = list(self.trainable.values())
        if self.gradient_clip_val > 0:
            clip_by_global_norm_([p.grad for p in params if p.grad is not None],
                                 self.gradient_clip_val)
        self.optimizer.step()
        self.scheduler.step()
        if self.ema is not None:
            ema_update_(self.ema, [p.detach() for p in self.dit_params], self.step)
        self.step += 1
        self.qmc_counter = (self.qmc_counter + n_samples) & _MASK32

    # ---- state -------------------------------------------------------------

    def state_dict(self) -> dict:
        """What a checkpoint holds (the JAX TrainState): trainable parameters,
        optimizer and schedule, EMA, step and quasi-random counter."""
        return {"params": {n: p.detach() for n, p in self.trainable.items()},
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "ema": self.ema, "step": self.step, "qmc_counter": self.qmc_counter}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for n, p in self.trainable.items():
            p.copy_(state["params"][n])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        if self.ema is not None:
            for e, v in zip(self.ema, state["ema"]):
                e.copy_(v)
        self.step, self.qmc_counter = int(state["step"]), int(state["qmc_counter"])

    def export_model(self, path: str) -> None:
        """EMA-preferring export (JAX :372): the backbone's weights (the EMA
        when kept) plus the trained conditioners, as a state_dict of the wrapper."""
        names = [n for n, _ in self.model.model.named_parameters()]
        dit = self.ema if self.ema is not None else [p.detach() for p in self.model.model.parameters()]
        sd = {f"model.{n}": v for n, v in zip(names, dit)}
        sd.update({n: p.detach() for n, p in self.trainable.items() if not n.startswith("model.")})
        torch.save(sd, path)


class DiffusionUncondTrainingWrapper(DiffusionCondTrainingWrapper):
    """The `diffusion_uncond` trainer (JAX training/diffusion.py:392-470):
    Adam at `lr` (or `optimizer_configs`), the EMA of the backbone, MSE on
    the v target (or the rectified-flow target noise - x) at quasi-random
    uniform timesteps, the frozen pretransform's encode unless
    `pre_encoded` (whose batches are the diffusion input itself, as in the
    JAX step), and the EMA-preferring export. The step, state, update and
    export are the conditioned trainer's, with no conditioner and no CFG
    dropout; the draws "t" and "noise" are injectable as there."""

    def __init__(self, model, lr: tp.Optional[float] = None, use_ema: bool = True,
                 optimizer_configs: tp.Optional[dict] = None, pre_encoded: bool = False,
                 timestep_sampler: str = "uniform"):
        super().__init__(model, lr=lr, use_ema=use_ema, optimizer_configs=optimizer_configs,
                         cfg_dropout_prob=0.0, pre_encoded=pre_encoded,
                         timestep_sampler=timestep_sampler)

    def latents(self, reals: torch.Tensor) -> torch.Tensor:
        pt = self.model.pretransform
        return reals if pt is None or self.pre_encoded else pt.encode_nwc(reals)

    def loss(self, reals: torch.Tensor, metadata: tp.Sequence[dict], qmc_counter: int = 0,
             draws: tp.Optional[dict] = None):
        draws, model, dev = draws or {}, self.model, self.device
        x = self.latents(reals.to(dev)).float()
        t = draws.get("t")
        if t is None:
            t = draw_timesteps(self.timestep_sampler, x.shape[0], qmc_counter, self.generator, dev)
        t = t.to(dev).float()
        if model.diffusion_objective == "v":
            alphas, sigmas = get_alphas_sigmas(t)
        else:
            alphas, sigmas = 1 - t, t
        alphas, sigmas = alphas[:, None, None], sigmas[:, None, None]
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(x.shape, generator=self.generator, device=dev)
        noise = noise.to(dev).float()
        output = model.model(x * alphas + noise * sigmas, t)
        targets = noise * alphas - x * sigmas if model.diffusion_objective == "v" else noise - x
        loss, losses = self.losses({"output": output, "targets": targets})
        return loss, {k: v.detach() for k, v in losses.items()}


N_SIGMA_BUCKETS = 8


@torch.no_grad()
def sigma_bucket_losses(output: torch.Tensor, targets: torch.Tensor,
                        sigmas: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
    """`log_loss_info`'s diagnostics (JAX :281-294): each element's MSE,
    averaged within each of eight equal sigma buckets (0 where a bucket is
    empty), keyed by the bucket's lower edge."""
    mse = (output.float() - targets.float()).square().mean(dim=(1, 2))
    bucket = (sigmas.float() * N_SIGMA_BUCKETS).to(torch.int64).clamp(0, N_SIGMA_BUCKETS - 1)
    out = {}
    for i in range(N_SIGMA_BUCKETS):
        hit = bucket == i
        out[f"loss_sigma_{i / N_SIGMA_BUCKETS:.3f}"] = (
            torch.where(hit, mse, torch.zeros_like(mse)).sum() / hit.sum().clamp_min(1))
    return out


class DiffusionCondInpaintTrainingWrapper(DiffusionCondTrainingWrapper):
    """The `diffusion_cond_inpaint` trainer (JAX :491-567): the diffusion
    input is encoded once (or read pre-encoded), a keep mask [B, L] drawn
    per element by :meth:`random_mask` (1 = keep, 0 = regenerate), and the
    mask [B, L, 1] and the masked latents [B, L, C] join the conditioning
    as `inpaint_mask` and `inpaint_masked_input`, which the model's
    `input_concat_ids` feed to the DiT. The keep mask is injectable as the
    draw "keep_mask"."""

    def __init__(self, model, max_mask_segments: int = 10, **kwargs):
        super().__init__(model, **kwargs)
        self.max_mask_segments = max_mask_segments

    def random_mask(self, batch: int, length: int) -> torch.Tensor:
        """[B, L] bool keep masks, one kind per element drawn uniformly
        (JAX :500-532): 0, 1 to `max_mask_segments` segments regenerated,
        each of a length uniform in 1 .. L // segments at a uniform start
        (drawn with replacement); 1, everything regenerated; 2, a suffix of
        a length uniform in 1 .. L regenerated."""
        g, dev, n_max = self.generator, self.device, self.max_mask_segments
        kind = torch.randint(0, 3, (batch,), generator=g, device=dev)
        n_seg = torch.randint(1, n_max + 1, (batch, 1), generator=g, device=dev)
        max_len = (length // n_seg).clamp_min(1)
        lens = 1 + torch.floor(torch.rand((batch, n_max), generator=g, device=dev) * max_len).long()
        starts = torch.floor(torch.rand((batch, n_max), generator=g, device=dev)
                             * (length - lens + 1)).long()
        active = torch.arange(n_max, device=dev)[None, :] < n_seg
        pos = torch.arange(length, device=dev)[None, None, :]
        regen = ((pos >= starts[..., None]) & (pos < (starts + lens)[..., None])
                 & active[..., None]).any(dim=1)
        suffix = torch.randint(1, length + 1, (batch, 1), generator=g, device=dev)
        causal_keep = torch.arange(length, device=dev)[None, :] < (length - suffix)
        kind = kind[:, None]
        return torch.where(kind == 0, ~regen,
                           torch.where(kind == 1, torch.zeros_like(regen), causal_keep))

    def loss(self, reals: torch.Tensor, metadata: tp.Sequence[dict], qmc_counter: int = 0,
             draws: tp.Optional[dict] = None, extra_cond=None, encoded: bool = False):
        draws = draws or {}
        x = self.latents(reals.to(self.device)).float()
        keep = draws.get("keep_mask")
        keep = (self.random_mask(x.shape[0], x.shape[1]) if keep is None
                else keep.to(self.device).bool())
        valid = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        inpaint = {"inpaint_mask": (keep[:, :, None].float(), valid),
                   "inpaint_masked_input": (x * keep[:, :, None], valid)}
        return super().loss(x, metadata, qmc_counter, draws, extra_cond=inpaint, encoded=True)


@torch.no_grad()
def clip_by_global_norm_(grads: tp.Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm: scale by max_norm / norm when norm >= max_norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(list(grads), scale)
    return norm
