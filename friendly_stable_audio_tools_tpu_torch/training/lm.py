"""Audio language model training (counterpart of
friendly_stable_audio_tools_tpu/training/lm.py:AudioLanguageModelTrainingWrapper :25-157).

One step: tokenize the raw audio through the frozen discrete pretransform
(under torch.no_grad()), the token mask from the clips' padding masks
(nearest interpolation to the token rate), the conditioner embeddings
(frozen T5), the LM's pattern-aligned logits with CFG dropout of the
conditioning, per-codebook masked cross-entropy over the valid steps (NaN
logits, where the pattern has no step, zeroed first), per-codebook
perplexity, backward, then AdamW (betas 0.9, 0.95, weight decay 0.1 and a
learning rate of 1e-4 unless the config says otherwise) and, with
`use_ema`, the EMA of the LM's parameters. Every random draw comes from the
wrapper's `torch.Generator`; the tests pass the CFG-dropout masks in instead
(`draws=`), since the two frameworks' random streams differ.
"""

from __future__ import annotations

import typing as tp

import torch

from .diffusion import clip_by_global_norm_, nearest_interp_mask, padding_mask_from_metadata
from .ema import ema_update_
from .scheduler import build_optimizer


class AudioLanguageModelTrainingWrapper:
    """Owns the trainable/frozen split (trainable: the LM and every
    conditioner whose `trainable` is not False; frozen: T5 and the
    pretransform), the optimizer, the EMA and the step counter."""

    def __init__(self, model, lr: tp.Optional[float] = None, use_ema: bool = False,
                 optimizer_configs: tp.Optional[dict] = None, cfg_dropout_prob: float = 0.1):
        self.lm = model
        self.cfg_dropout_prob = cfg_dropout_prob
        self.gradient_clip_val = 0.0
        model.requires_grad_(False)
        model.model.requires_grad_(True)
        if model.conditioner is not None:
            for c in model.conditioner.conditioners.values():
                if getattr(c, "trainable", True):
                    c.requires_grad_(True)
        self.trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.lm_params = list(model.model.parameters())
        if optimizer_configs is None:
            optimizer_configs = {"lm": {"optimizer": {"type": "AdamW", "config": {
                "lr": lr or 1e-4, "betas": (0.9, 0.95), "weight_decay": 0.1}}}}
        self.optimizer, self.scheduler = build_optimizer(optimizer_configs["lm"],
                                                         list(self.trainable.values()))
        self.ema = [p.detach().clone() for p in self.lm_params] if use_ema else None
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    @property
    def device(self) -> torch.device:
        return next(self.lm.model.parameters()).device

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

    # ---- the step ---------------------------------------------------------

    def tokenize(self, reals: torch.Tensor) -> torch.Tensor:
        """reals [B, T, C] -> codes [B, K, T / ratio], outside grad."""
        return self.lm.pretransform.tokenize(reals.to(self.device).transpose(1, 2))

    def loss(self, reals: torch.Tensor, metadata: tp.Sequence[dict],
             draws: tp.Optional[dict] = None, codes: tp.Optional[torch.Tensor] = None):
        """reals [B, T, C] audio -> (loss, metrics). `draws` may hold the CFG
        dropout masks ({"cross_attn_cond": [B] bool, ...}) in place of the
        generator's draws; `codes` [B, K, T'] the tokens in place of the
        tokenizer's."""
        lm, dev = self.lm, self.device
        if codes is None:
            codes = self.tokenize(reals)
        codes = codes.to(dev)
        b, k, t = codes.shape
        padding_mask = padding_mask_from_metadata(metadata)
        if padding_mask is not None:
            token_mask = nearest_interp_mask(padding_mask.to(dev), t)
        else:
            token_mask = torch.ones(b, t, dtype=torch.bool, device=dev)
        cond = lm.conditioner(metadata, device=dev) if lm.conditioner is not None else {}
        out = lm.compute_logits(codes, cond, cfg_dropout_prob=self.cfg_dropout_prob,
                                generator=self.generator, cfg_dropout_masks=draws)
        valid = out.mask & token_mask[:, None, :]  # [B, K, T]
        logits = out.logits.float()
        logits = torch.where(torch.isnan(logits), torch.zeros_like(logits), logits)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, codes[..., None]).squeeze(-1)
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        loss = nll.sum() / valid.sum().clamp_min(1)
        metrics = {"ce_loss": loss.detach()}
        for q in range(k):  # per-codebook perplexity
            vq = valid[:, q]
            metrics[f"perplexity_q{q}"] = torch.exp(
                nll[:, q].detach().sum() / vq.sum().clamp_min(1))
        return loss, metrics

    def train_step(self, reals: torch.Tensor, metadata: tp.Sequence[dict], accum: int = 1,
                   draws: tp.Optional[tp.Sequence[dict]] = None) -> tp.Dict[str, float]:
        """One optimizer update from `accum` micro-batches of the batch, their
        gradients averaged; `draws[i]` (optional) are micro-batch i's CFG
        dropout masks. Returns host metrics."""
        self.lm.train()
        b = reals.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum_batches {accum}")
        mb = b // accum
        self.optimizer.zero_grad(set_to_none=True)
        totals: tp.Dict[str, torch.Tensor] = {}
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            loss, metrics = self.loss(reals[rows], metadata[rows], draws[i] if draws else None)
            (loss / accum).backward()
            for key, v in {"loss": loss.detach(), **metrics}.items():
                totals[key] = totals.get(key, 0.0) + v / accum
        self.apply_update()
        return {key: float(v) for key, v in totals.items()}

    def apply_update(self) -> None:
        """Clip (when set), AdamW, EMA, the step counter."""
        params = list(self.trainable.values())
        if self.gradient_clip_val > 0:
            clip_by_global_norm_([p.grad for p in params if p.grad is not None],
                                 self.gradient_clip_val)
        self.optimizer.step()
        self.scheduler.step()
        if self.ema is not None:
            ema_update_(self.ema, [p.detach() for p in self.lm_params], self.step)
        self.step += 1

    # ---- state -------------------------------------------------------------

    def state_dict(self) -> dict:
        return {"params": {n: p.detach() for n, p in self.trainable.items()},
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "ema": self.ema, "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for n, p in self.trainable.items():
            p.copy_(state["params"][n])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        if self.ema is not None:
            for e, v in zip(self.ema, state["ema"]):
                e.copy_(v)
        self.step = int(state["step"])
