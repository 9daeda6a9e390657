"""Training loop (counterpart of friendly_stable_audio_tools_tpu/training/trainer.py).

Steps the wrapper over the data loader with gradient accumulation
(`accum_batches` loader batches form one update), global-norm clipping
ahead of the optimizer, metrics logging every `log_every` steps, a
checkpoint every `checkpoint_every` steps (directory `step_<n>/` holding
`state.pt` from `torch.save` and `model_config.json`, plus a `last` link),
resume from `ckpt_path`, an optional demo callback after every update
(training/demos.py; a demo that raises prints its traceback and training
goes on, JAX :203-209), and an optional profile window: with `profile_dir`,
`torch.profiler` records steps [profile_start_step, profile_start_step +
profile_steps) of this run (CPU, and CUDA where the model is on the card)
and writes a Chrome trace there (JAX :61-66, :176-190, :217-220, which
write a jax.profiler trace). Single process, one device.
"""

from __future__ import annotations

import json
import os
import time
import traceback
import typing as tp

import torch

from .logging import ExperimentLogger, MetricsLogger

PROGRESS_EVERY = 50  # steps between it/s lines


class Trainer:
    def __init__(self, training_wrapper, dataloader, model_config: dict, save_dir: str = ".",
                 checkpoint_every: int = 10000, demo_callback=None,
                 logger: tp.Optional[ExperimentLogger] = None, max_steps: tp.Optional[int] = None,
                 accum_batches: int = 1, log_every: int = 1, gradient_clip_val: float = 0.0,
                 profile_dir: tp.Optional[str] = None, profile_start_step: int = 10,
                 profile_steps: int = 5):
        self.wrapper = training_wrapper
        self.save_dir = save_dir
        self.profile_dir = profile_dir
        self.profile_start_step = profile_start_step
        self.profile_steps = profile_steps
        self._profiler = None
        self.dataloader = dataloader
        self.model_config = model_config
        self.checkpoint_every = checkpoint_every
        self.demo_callback = demo_callback
        self.logger = logger or ExperimentLogger()
        self.max_steps = max_steps
        self.accum_batches = accum_batches
        self.metrics_logger = MetricsLogger()
        self.log_every = log_every
        training_wrapper.gradient_clip_val = gradient_clip_val or 0.0
        self.ckpt_dir = os.path.join(save_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)

    # ---- checkpointing -------------------------------------------------------

    def save_checkpoint(self, step: int) -> str:
        path = os.path.abspath(os.path.join(self.ckpt_dir, f"step_{step}"))
        os.makedirs(path, exist_ok=True)
        torch.save({**self.wrapper.state_dict(), "model_config": self.model_config},
                   os.path.join(path, "state.pt"))
        with open(os.path.join(path, "model_config.json"), "w") as f:
            json.dump(self.model_config, f)
        last = os.path.join(self.ckpt_dir, "last")
        if os.path.islink(last):
            os.unlink(last)
        os.symlink(path, last)
        return path

    def load_checkpoint(self, path: str) -> None:
        if os.path.isdir(path):
            path = os.path.join(path, "state.pt")
        state = torch.load(path, map_location=self.wrapper.device, weights_only=True)
        self.wrapper.load_state_dict(state)

    # ---- the profile window ------------------------------------------------------

    def _start_profile(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.wrapper.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.__enter__()

    def _stop_profile(self) -> str:
        if self.wrapper.device.type == "cuda":
            torch.cuda.synchronize(self.wrapper.device)
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_steps_{self.profile_start_step}"
                                              f"_{self.profile_start_step + self.profile_steps}.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}", flush=True)
        return path

    # ---- the loop --------------------------------------------------------------

    def fit(self, ckpt_path: tp.Optional[str] = None, seed: int = 42) -> None:
        wrapper = self.wrapper
        if ckpt_path:
            self.load_checkpoint(ckpt_path)
        wrapper.seed(seed)
        step = wrapper.step
        t_last = time.time()
        pending: tp.List[tuple] = []
        try:
            while self.max_steps is None or step < self.max_steps:
                for reals, metadata in self.dataloader:
                    if self.max_steps is not None and step >= self.max_steps:
                        break
                    pending.append((reals, metadata))
                    if len(pending) < self.accum_batches:
                        continue
                    reals = torch.cat([r for r, _ in pending]).transpose(1, 2)
                    metadata = [m for _, ms in pending for m in ms]
                    pending = []
                    if self.profile_dir and self._profiler is None and step == self.profile_start_step:
                        self._start_profile()
                    metrics = wrapper.train_step(reals, metadata, accum=self.accum_batches)
                    step = wrapper.step
                    if (self._profiler is not None
                            and step >= self.profile_start_step + self.profile_steps):
                        self._stop_profile()

                    self.metrics_logger.add({f"train/{k}": v for k, v in metrics.items()})
                    if (step - 1) % self.log_every == 0:
                        self.logger.log(self.metrics_logger.pop(), step=step)
                    if step % PROGRESS_EVERY == 0:
                        dt = time.time() - t_last
                        print(f"step {step}  ({PROGRESS_EVERY / dt:.2f} it/s)", flush=True)
                        t_last = time.time()
                    if self.checkpoint_every and step % self.checkpoint_every == 0:
                        self.save_checkpoint(step)
                    if self.demo_callback is not None:
                        try:
                            self.demo_callback.on_step(self, step, (reals, metadata))
                        except Exception:  # demos never stop training
                            traceback.print_exc()
        except KeyboardInterrupt:
            print("interrupted; saving checkpoint")
            self.save_checkpoint(step)
        finally:
            if self._profiler is not None:  # the run ended inside the window
                self._stop_profile()
