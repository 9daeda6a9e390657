"""Metrics buffering and experiment logging (counterpart of
friendly_stable_audio_tools_tpu/training/logging.py): `MetricsLogger` averages
metrics between flushes; `ExperimentLogger` logs to the console, or to wandb
when asked to (`use_wandb`) and wandb is installed and initialises. wandb is
never imported otherwise: an installed wandb that fails to initialise
reports the failure over the network."""

from __future__ import annotations

import math
import typing as tp


class MetricsLogger:
    def __init__(self):
        self._sums: tp.Dict[str, float] = {}
        self._counts: tp.Dict[str, int] = {}

    def add(self, metrics: tp.Dict[str, tp.Any]) -> None:
        for k, v in metrics.items():
            try:
                val = float(v)
            except (TypeError, ValueError):
                continue
            if math.isfinite(val):
                self._sums[k] = self._sums.get(k, 0.0) + val
                self._counts[k] = self._counts.get(k, 0) + 1

    def pop(self) -> tp.Dict[str, float]:
        out = {k: self._sums[k] / self._counts[k] for k in self._sums}
        self._sums.clear()
        self._counts.clear()
        return out


class ExperimentLogger:
    def __init__(self, project: tp.Optional[str] = None, name: tp.Optional[str] = None,
                 config: tp.Optional[dict] = None, save_dir: str = ".", use_wandb: bool = False):
        self.run = None
        self.run_id = name or "local"
        if not use_wandb:
            return
        try:
            import wandb  # type: ignore

            self.run = wandb.init(project=project, name=name, config=config, dir=save_dir)
            self.run_id = self.run.id
        except Exception:
            self.run = None

    def log(self, metrics: tp.Dict[str, float], step: tp.Optional[int] = None) -> None:
        if self.run is not None:
            self.run.log(metrics, step=step)
        else:
            items = " ".join(f"{k}={v:.5g}" for k, v in metrics.items())
            print(f"[step {step}] {items}", flush=True)

    def finish(self) -> None:
        if self.run is not None:
            self.run.finish()
