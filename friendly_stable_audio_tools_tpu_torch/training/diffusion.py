"""Conditioned diffusion training (counterpart of
friendly_stable_audio_tools_tpu/training/diffusion.py:DiffusionCondTrainingWrapper :84-390).

One step: conditioner embeddings (trainable number or int conditioners,
frozen T5 or CLAP), frozen VAE encode of the raw audio (posterior mean,
under torch.no_grad()), v-objective noising at quasi-random timesteps, the
backbone's forward with CFG dropout and backward (the DiT, or Stable Audio
1.0's ADP U-Net), then the optimizer (AdamW + InverseLR, or the Adam of a
config that sets only `learning_rate`) and the EMA of the backbone's
parameters. Gradient accumulation splits the batch into micro-batches whose
gradients average into one update. Every random draw comes from the
wrapper's `torch.Generator`; the tests pass the draws in instead
(`draws=`), since the two frameworks' random streams differ.
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


class DiffusionCondTrainingWrapper:
    """Owns the trainable/frozen split, the optimizer, the schedule, the EMA
    and the step and quasi-random counters of one `diffusion_cond` model
    trained from raw audio with the v objective and quasi-random uniform
    timesteps (the settings of the Stable Audio configs).

    Trainable: the backbone and every conditioner whose `trainable` is not
    False (the JAX package's `Conditioner.trainable`: T5 is frozen, CLAP
    unless `finetune`); frozen: those and the pretransform."""

    def __init__(self, model, lr: tp.Optional[float] = None, use_ema: bool = True,
                 optimizer_configs: tp.Optional[dict] = None, cfg_dropout_prob: float = 0.1):
        if lr is None and optimizer_configs is None:
            raise ValueError("Must specify either lr or optimizer_configs in training config")
        if model.diffusion_objective != "v" or model.pretransform is None:
            raise NotImplementedError("the torch port trains the v objective through a pretransform")
        self.model = model
        self.cfg_dropout_prob = cfg_dropout_prob
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
        self.losses = MultiLoss([MSELoss("output", "targets", name="mse_loss")])
        self.step = 0
        self.qmc_counter = 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    @property
    def device(self) -> torch.device:
        return next(self.model.model.parameters()).device

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

    # ---- the step ---------------------------------------------------------

    def loss(self, reals: torch.Tensor, metadata: tp.Sequence[dict], qmc_counter: int = 0,
             draws: tp.Optional[dict] = None):
        """reals [B, T, C] audio -> (loss, metrics). `draws` may hold "t" [B],
        "noise" (the latents' shape) and "cfg_dropout_mask" [B] in place of
        the generator's draws."""
        draws = draws or {}
        model, dev = self.model, self.device
        cond = model.conditioner(metadata, device=dev) if model.conditioner is not None else {}
        x = model.pretransform.encode_nwc(reals.to(dev))
        t = draws.get("t")
        if t is None:
            shift = torch.rand((), generator=self.generator, device=dev)
            t = quasirandom_uniform(qmc_counter, x.shape[0], shift)
        t = t.to(dev).float()
        alphas, sigmas = (v[:, None, None] for v in get_alphas_sigmas(t))
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(x.shape, generator=self.generator, device=dev)
        noise = noise.to(dev).float()
        output = model.model(x * alphas + noise * sigmas, t,
                             cfg_dropout_prob=self.cfg_dropout_prob,
                             cfg_dropout_mask=draws.get("cfg_dropout_mask"),
                             generator=self.generator,
                             **(model.get_conditioning_inputs(cond) if cond else {}))
        loss, losses = self.losses({"output": output, "targets": noise * alphas - x * sigmas})
        return loss, {**{k: v.detach() for k, v in losses.items()}, "std_data": x.std()}

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


@torch.no_grad()
def clip_by_global_norm_(grads: tp.Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm: scale by max_norm / norm when norm >= max_norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(list(grads), scale)
    return norm
