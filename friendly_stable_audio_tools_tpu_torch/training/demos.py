"""Demo callbacks: generation and reconstruction at intervals during
training (counterpart of friendly_stable_audio_tools_tpu/training/demos.py).

The trainer calls `on_step(trainer, step, (reals, metadata))` after every
update, reals [B, T, C] as the step took them; every `demo_every` steps (not
at step 0, once per step) the callback runs on the model's own device, with
its kernels, under torch.no_grad(), writes its wavs (16-bit PCM) to
`<save_dir>/samples/<step>/` and logs them through the trainer's logger.
The trainer prints the traceback of a demo that fails and trains on; a
failed demo is not retried on the CPU or through the plain versions.

- :class:`DiffusionCondDemoCallback` (`diffusion_cond` and
  `diffusion_cond_inpaint`): the backbone's EMA weights swapped in for the
  demo and the live ones restored after it (the trained conditioners are
  the live model's own, so they need no swap in this port); the
  pretransform's round trip of the batch's first clip
  (`pretransform_recon.wav`), then one generation per cfg scale with
  dpmpp-3m-sde between sigma 0.3 and 500, seeded with the step
  (`demo_cfg<scale>_<i>.wav`). An inpaint model's demo regenerates
  everything: its `inpaint_mask` and `inpaint_masked_input` are zeros
  (the JAX package's demo has no inpaint conditioning to give it).
  A mono-to-stereo prior's demo takes its `source` from the batch: the
  dual-mono version of its first clips, one generation per clip.
- :class:`DiffusionDemoCallback` (`diffusion_uncond`): the EMA weights
  swapped in as above, `num_demos` unconditional generations with
  dpmpp-3m-sde between sigma 0.3 and 500, seeded with the step
  (`demo_<i>.wav`).
- :class:`DiffusionAutoencoderDemoCallback` (`diffusion_autoencoder`): the
  EMA weights of both trees swapped in, the batch's first clips encoded and
  decoded by DDIM at `demo_steps` (`recon_<i>.wav`, `real_<i>.wav`), the
  mel spectrogram of the first and the latents' PCA point cloud.
- :class:`AutoencoderDemoCallback`: the batch's round trip through the live
  autoencoder (`recon_<i>.wav`, `real_<i>.wav`), the mel spectrogram of
  the first reconstruction and the latents' PCA point cloud
  (`latent_pca.npy`).
- :class:`AudioLanguageModelDemoCallback`: up to two generations of the
  live LM, conditioned on `demo_conditioning` (`lm_demo_<i>.wav`).
"""

from __future__ import annotations

import os
import typing as tp

import numpy as np
import torch

from .viz import audio_spectrogram_image, pca_point_cloud


def _write(trainer, out: str, name: str, key: str, audio: torch.Tensor, sample_rate: int,
           step: int) -> None:
    """audio [C, T] -> out/name (16-bit PCM) and the logger's `key`."""
    from ..generate import write_wav

    clip = np.ascontiguousarray(audio.detach().float().cpu().numpy())
    write_wav(os.path.join(out, name), sample_rate, clip)
    trainer.logger.log_audio(key, clip, sample_rate, step=step)


class DemoCallback:
    def __init__(self, demo_every: int = 2000):
        self.demo_every = demo_every
        self.last_demo_step = -1

    def on_step(self, trainer, step: int, batch) -> None:
        if step == 0 or step % self.demo_every != 0 or step == self.last_demo_step:
            return
        self.last_demo_step = step
        with torch.no_grad():
            self.run_demo(trainer, step, batch)

    def run_demo(self, trainer, step: int, batch) -> None:
        raise NotImplementedError

    @staticmethod
    def out_dir(trainer, step: int) -> str:
        path = os.path.join(trainer.save_dir, "samples", str(step))
        os.makedirs(path, exist_ok=True)
        return path


class _EMAWeights:
    """The trainer's EMA weights in its trained parameters for the block
    (where it keeps an EMA), the live ones restored after; the model in eval
    mode meanwhile."""

    def __init__(self, wrapper, model):
        self.wrapper, self.model = wrapper, model

    def __enter__(self):
        w = self.wrapper
        self.live = None
        if w.ema is not None:
            self.live = [p.detach().clone() for p in w.dit_params]
            for p, e in zip(w.dit_params, w.ema):
                p.copy_(e)
        self.was_training = self.model.training
        self.model.eval()
        return self

    def __exit__(self, *exc):
        if self.live is not None:
            for p, v in zip(self.wrapper.dit_params, self.live):
                p.copy_(v)
        self.model.train(self.was_training)


class DiffusionDemoCallback(DemoCallback):
    """Unconditional sampling demos (JAX demos.py:106-135)."""

    def __init__(self, demo_every: int = 2000, num_demos: int = 4, demo_steps: int = 250,
                 sample_rate: int = 48000, sample_size: int = 65536, **kwargs):
        super().__init__(demo_every)
        self.num_demos = num_demos
        self.demo_steps = demo_steps
        self.sample_rate = sample_rate
        self.sample_size = sample_size

    def run_demo(self, trainer, step: int, batch) -> None:
        from ..inference.generation import generate_diffusion_uncond

        model = trainer.wrapper.model
        with _EMAWeights(trainer.wrapper, model):
            audio = generate_diffusion_uncond(
                model, steps=self.demo_steps, batch_size=self.num_demos,
                sample_size=self.sample_size, seed=step, sampler_type="dpmpp-3m-sde",
                sigma_min=0.3, sigma_max=500)
        out = self.out_dir(trainer, step)
        for i, clip in enumerate(audio):
            _write(trainer, out, f"demo_{i}.wav", f"demo/audio_{i}", clip, self.sample_rate, step)


class DiffusionAutoencoderDemoCallback(DemoCallback):
    """Encode -> DDIM decode reconstructions (JAX demos.py:193-240)."""

    def __init__(self, demo_every: int = 2000, max_num_sample: int = 4, demo_steps: int = 100,
                 sample_size: int = 65536, sample_rate: int = 48000, **kwargs):
        super().__init__(demo_every)
        self.max_num_sample = max_num_sample
        self.demo_steps = demo_steps
        self.sample_rate = sample_rate

    def run_demo(self, trainer, step: int, batch) -> None:
        model = trainer.wrapper.model
        dev = trainer.wrapper.device
        reals = batch[0][:self.max_num_sample].to(dev)  # [B, T, C]
        with _EMAWeights(trainer.wrapper, model):
            latents = model.encode(reals.transpose(1, 2))
            recon = model.decode(latents, steps=self.demo_steps,
                                 generator=torch.Generator(device=dev).manual_seed(step))
        out = self.out_dir(trainer, step)
        for i in range(recon.shape[0]):
            _write(trainer, out, f"recon_{i}.wav", f"demo/diffae_recon_{i}", recon[i],
                   self.sample_rate, step)
            _write(trainer, out, f"real_{i}.wav", f"demo/diffae_real_{i}", reals[i].T,
                   self.sample_rate, step)
        fig = audio_spectrogram_image(recon[0].float().cpu().numpy(), self.sample_rate)
        if fig is not None:
            trainer.logger.log_image("demo/diffae_recon_melspec", fig, step=step)
        pc = pca_point_cloud(latents.float().cpu().numpy())
        np.save(os.path.join(out, "latent_pca.npy"), pc)
        trainer.logger.log_object3d("demo/diffae_latent_pca", pc, step=step)


class DiffusionCondDemoCallback(DemoCallback):
    def __init__(self, demo_every: int = 2000, num_demos: int = 8, demo_steps: int = 250,
                 sample_size: int = 2097152, sample_rate: int = 44100,
                 demo_conditioning: tp.Optional[list] = None,
                 demo_cfg_scales: tp.Sequence[float] = (3, 5, 7), **kwargs):
        super().__init__(demo_every)
        self.num_demos = num_demos
        self.demo_steps = demo_steps
        self.sample_size = sample_size
        self.sample_rate = sample_rate
        self.demo_conditioning = (demo_conditioning or [{}])[:num_demos]
        self.demo_cfg_scales = list(demo_cfg_scales)

    def conditioning_tensors(self, model, batch=None) -> dict:
        """The conditioner's tensors for `demo_conditioning`, zeros for an
        inpaint model's `inpaint_mask` [B, L, 1] and `inpaint_masked_input`
        [B, L, C] (everything regenerated), and a prior's `source`: the
        dual-mono version of the batch's first clips (as many as
        `demo_conditioning`), encoded where the model has a pretransform."""
        dev = next(model.parameters()).device
        cond = (model.conditioner(self.demo_conditioning, device=dev)
                if model.conditioner is not None else {})
        b = len(self.demo_conditioning)
        if "source" in model.input_concat_ids and "source" not in cond and batch is not None:
            reals = batch[0][:b].to(dev).float()
            source = reals.mean(-1, keepdim=True).repeat(1, 1, reals.shape[-1])
            if model.pretransform is not None:
                source = model.pretransform.encode_nwc(source)
            cond["source"] = (source, torch.ones(source.shape[:2], dtype=torch.bool, device=dev))
        length = self.sample_size // (model.pretransform.downsampling_ratio
                                      if model.pretransform is not None else 1)
        for key, channels in (("inpaint_mask", 1), ("inpaint_masked_input", model.io_channels)):
            if key in model.input_concat_ids and key not in cond:
                cond[key] = (torch.zeros((b, length, channels), device=dev),
                             torch.ones((b, length), dtype=torch.bool, device=dev))
        return cond

    def run_demo(self, trainer, step: int, batch) -> None:
        from ..inference.generation import generate_diffusion_cond

        wrapper = trainer.wrapper
        model = wrapper.model
        with _EMAWeights(wrapper, model):
            out = self.out_dir(trainer, step)
            if batch is not None and model.pretransform is not None:
                latents = wrapper.latents(batch[0][:1].to(wrapper.device))
                recon = model.pretransform.decode_nwc(latents).transpose(1, 2)
                _write(trainer, out, "pretransform_recon.wav", "demo/pretransform_recon",
                       recon[0], self.sample_rate, step)
            cond = self.conditioning_tensors(model, batch)
            for cfg_scale in self.demo_cfg_scales:
                audio = generate_diffusion_cond(
                    model, steps=self.demo_steps, cfg_scale=cfg_scale, conditioning_tensors=cond,
                    sample_size=self.sample_size, seed=step, sampler_type="dpmpp-3m-sde",
                    sigma_min=0.3, sigma_max=500)
                for i, clip in enumerate(audio):
                    _write(trainer, out, f"demo_cfg{cfg_scale}_{i}.wav",
                           f"demo/audio_cfg{cfg_scale}_{i}", clip, self.sample_rate, step)


class AutoencoderDemoCallback(DemoCallback):
    def __init__(self, demo_every: int = 2000, max_num_sample: int = 4,
                 sample_size: int = 65536, sample_rate: int = 48000, **kwargs):
        super().__init__(demo_every)
        self.max_num_sample = max_num_sample
        self.sample_rate = sample_rate

    def run_demo(self, trainer, step: int, batch) -> None:
        ae = trainer.wrapper.autoencoder
        reals = batch[0][:self.max_num_sample].to(next(ae.parameters()).device)
        was_training = ae.training
        ae.eval()
        try:
            latents = ae.encode_nwc(reals)
            recon = ae.decode_nwc(latents)
        finally:
            ae.train(was_training)
        out = self.out_dir(trainer, step)
        for i in range(recon.shape[0]):
            _write(trainer, out, f"recon_{i}.wav", f"demo/recon_{i}", recon[i].T,
                   self.sample_rate, step)
            _write(trainer, out, f"real_{i}.wav", f"demo/real_{i}", reals[i].T,
                   self.sample_rate, step)
        fig = audio_spectrogram_image(recon[0].T.float().cpu().numpy(), self.sample_rate)
        if fig is not None:
            trainer.logger.log_image("demo/recon_melspec", fig, step=step)
        pc = pca_point_cloud(latents.float().transpose(1, 2).cpu().numpy())
        np.save(os.path.join(out, "latent_pca.npy"), pc)
        trainer.logger.log_object3d("demo/latent_pca", pc, step=step)


class AudioLanguageModelDemoCallback(DemoCallback):
    def __init__(self, demo_every: int = 2000, num_demos: int = 8, sample_size: int = 65536,
                 sample_rate: int = 48000, demo_conditioning: tp.Optional[list] = None,
                 **kwargs):
        super().__init__(demo_every)
        self.num_demos = num_demos
        self.sample_size = sample_size
        self.sample_rate = sample_rate
        self.demo_conditioning = demo_conditioning

    def run_demo(self, trainer, step: int, batch) -> None:
        model = trainer.wrapper.lm
        dev = next(model.parameters()).device
        n = min(self.num_demos, 2)
        was_training = model.training
        model.eval()
        try:
            audio = model.generate_audio(
                max_gen_len=self.sample_size // model.pretransform.downsampling_ratio,
                batch_size=n,
                conditioning=self.demo_conditioning[:n] if self.demo_conditioning else None,
                generator=torch.Generator(device=dev).manual_seed(step))
        finally:
            model.train(was_training)
        out = self.out_dir(trainer, step)
        for i, clip in enumerate(audio):
            _write(trainer, out, f"lm_demo_{i}.wav", f"demo/lm_audio_{i}", clip,
                   self.sample_rate, step)
