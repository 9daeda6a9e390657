"""Metrics buffering and experiment logging (counterpart of
friendly_stable_audio_tools_tpu/training/logging.py): `MetricsLogger` averages
metrics between flushes; `ExperimentLogger` logs to the console, or to wandb
when asked to (`use_wandb`) and wandb is installed and initialises. wandb is
never imported otherwise: an installed wandb that fails to initialise
reports the failure over the network. The demos' audio, images and point
clouds (`log_audio`, `log_image`, `log_object3d`, JAX :65-80) go to wandb
only where the logger already writes there, and are dropped otherwise (the
demos write their files themselves)."""

from __future__ import annotations

import math
import typing as tp

import numpy as np


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
        self.wandb = None
        self.run_id = name or "local"
        if not use_wandb:
            return
        try:
            import wandb  # type: ignore

            self.run = wandb.init(project=project, name=name, config=config, dir=save_dir)
            self.run_id = self.run.id
            self.wandb = wandb
        except Exception:
            self.run = None

    def log(self, metrics: tp.Dict[str, float], step: tp.Optional[int] = None) -> None:
        if self.run is not None:
            self.run.log(metrics, step=step)
        else:
            items = " ".join(f"{k}={v:.5g}" for k, v in metrics.items())
            print(f"[step {step}] {items}", flush=True)

    def log_audio(self, key: str, audio, sample_rate: int, step: tp.Optional[int] = None,
                  caption: tp.Optional[str] = None) -> None:
        """audio (C, T)."""
        if self.run is not None:
            self.run.log({key: self.wandb.Audio(np.asarray(audio).T, sample_rate=sample_rate,
                                                caption=caption)}, step=step)

    def log_image(self, key: str, image, step: tp.Optional[int] = None) -> None:
        if self.run is not None:
            self.run.log({key: self.wandb.Image(image)}, step=step)

    def log_object3d(self, key: str, points, step: tp.Optional[int] = None) -> None:
        """An (N, 6) xyz + rgb point cloud."""
        if self.run is not None:
            self.run.log({key: self.wandb.Object3D(np.asarray(points, np.float32))}, step=step)

    def finish(self) -> None:
        if self.run is not None:
            self.run.finish()
