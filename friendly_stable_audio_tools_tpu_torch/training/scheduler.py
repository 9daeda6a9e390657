"""Optimizer and learning-rate schedule from the JSON config (counterpart of
friendly_stable_audio_tools_tpu/training/scheduler.py: `inverse_lr_schedule`
:14, ExponentialLR :67, `build_optimizer` :76).

Adam and AdamW map to `torch.optim.Adam` / `torch.optim.AdamW` (Adam with a
weight decay becomes AdamW, as optax.adamw in the JAX package); the schedule
is a `LambdaLR` multiplier on the base rate. torch evaluates the multiplier
at the number of updates already taken, which is where optax evaluates its
schedule (the count before the increment). Other optimizer and scheduler
types raise NotImplementedError."""

from __future__ import annotations

import typing as tp

import torch


def inverse_lr_schedule(base_lr: float, inv_gamma: float = 1.0, power: float = 1.0,
                        warmup: float = 0.0, final_lr: float = 0.0) -> tp.Callable[[int], float]:
    """step -> lr multiplier: warmup(step) * max((1 + step/inv_gamma)^-power, final/base)."""

    def multiplier(step: int) -> float:
        mult = max((1 + step / inv_gamma) ** -power, final_lr / base_lr if base_lr else 0.0)
        return (1 - warmup ** (step + 1) if warmup > 0 else 1.0) * mult

    return multiplier


def build_optimizer(config: tp.Dict[str, tp.Any], params: tp.Iterable[torch.nn.Parameter]):
    """An `optimizer` (+ optional `scheduler`) config block -> (optimizer, LambdaLR)."""
    opt_cfg = config["optimizer"]
    opt_type = opt_cfg["type"]
    cfg = dict(opt_cfg.get("config", {}))
    lr = cfg.pop("lr", 1e-4)
    kwargs = dict(lr=lr, betas=tuple(cfg.pop("betas", (0.9, 0.999))), eps=cfg.pop("eps", 1e-8))
    weight_decay = cfg.pop("weight_decay", 0.0)
    if opt_type in ("Adam", "FusedAdam") and not weight_decay:
        optimizer = torch.optim.Adam(params, **kwargs)
    elif opt_type in ("Adam", "FusedAdam", "AdamW"):
        optimizer = torch.optim.AdamW(params, weight_decay=weight_decay, **kwargs)
    else:
        raise NotImplementedError(f"optimizer type {opt_type!r} is not in the torch port")

    multiplier = lambda step: 1.0  # noqa: E731
    if "scheduler" in config:
        sched = config["scheduler"]
        if sched["type"] == "InverseLR":
            multiplier = inverse_lr_schedule(lr, **sched.get("config", {}))
        elif sched["type"] == "ExponentialLR":  # JAX :67-69
            gamma = sched.get("config", {}).get("gamma", 0.999996)
            multiplier = lambda step: gamma ** step  # noqa: E731
        else:
            raise NotImplementedError(f"scheduler type {sched['type']!r} is not in the torch port")
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, multiplier)
