"""The mono-to-stereo diffusion prior (counterpart of
friendly_stable_audio_tools_tpu/models/diffusion_prior.py).

A conditioned diffusion wrapper (the `diffusion_prior` model type, prior
type `mono_stereo`) whose backbone takes the dual-mono version of a clip
as the input-concat condition `source` and generates the stereo clip."""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .diffusion import ConditionedDiffusionModelWrapper


class MonoToStereoDiffusionPrior(ConditionedDiffusionModelWrapper):
    prior_type = "mono_stereo"

    @torch.no_grad()
    def stereoize(self, audio: tp.Union[np.ndarray, torch.Tensor], in_sr: int, steps: int,
                  sampler_kwargs: tp.Optional[dict] = None, **generate_kwargs) -> torch.Tensor:
        """Mono (or any) audio [B, C, T] -> stereo [B, 2, T'] (JAX :32-60):
        resampled to the model's rate, zero-padded to a multiple of
        `min_input_length` (T' is that length), its channel mean duplicated
        into a dual-mono source, encoded through the pretransform where
        there is one, and given to `generate_diffusion_cond` as the `source`
        condition. `sampler_kwargs` go to the sampler; `generate_kwargs`
        (seed, noise, step_noise, ...) to the generator."""
        from ..inference.generation import generate_diffusion_cond
        from ..inference.utils import resample

        device = next(self.parameters()).device
        if isinstance(audio, torch.Tensor):
            audio = audio.detach().float().cpu().numpy()
        audio = np.asarray(audio, np.float32)
        if in_sr != self.sample_rate:
            audio = resample(audio, in_sr, self.sample_rate)
        length = audio.shape[-1]
        padded = length + (self.min_input_length - length % self.min_input_length) \
            % self.min_input_length
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(device)
        if padded > length:
            x = torch.nn.functional.pad(x, (0, padded - length))
        source = x.mean(1, keepdim=True).repeat(1, 2, 1).transpose(1, 2)  # [B, T, 2]
        if self.pretransform is not None:
            source = self.pretransform.encode_nwc(source)
        valid = torch.ones(source.shape[:2], dtype=torch.bool, device=device)
        return generate_diffusion_cond(self, conditioning_tensors={"source": (source, valid)},
                                       steps=steps, sample_size=padded,
                                       **(sampler_kwargs or {}), **generate_kwargs)
