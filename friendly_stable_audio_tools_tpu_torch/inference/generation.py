"""Text-to-audio generation driver (counterpart of
friendly_stable_audio_tools_tpu/inference/generation.py:generate_diffusion_cond :168).

The text path: conditioners on the prompt metadata, seeded noise, the
k-diffusion sampler over the DiT with CFG, then the pretransform decode.
Init-audio (variation, inpainting) needs the VAE encoder, which is not
ported yet. Public layout [B, C, T].

The sampler state stays fp32 whatever the model's dtype (JAX
sampling.py:38, 52): a bf16 backbone (bench.py's recipe) casts its input at
its own entry, as the JAX recipe casts it at the call, and the pretransform
casts the fp32 latents to the VAE's dtype before the decode.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .sampling import sample_k


@torch.no_grad()
def generate_diffusion_cond(
    model,
    steps: int = 250,
    cfg_scale: float = 6.0,
    conditioning: tp.Optional[tp.List[tp.Dict[str, tp.Any]]] = None,
    negative_conditioning: tp.Optional[tp.List[tp.Dict[str, tp.Any]]] = None,
    sample_size: int = 2097152,
    seed: int = -1,
    device: tp.Optional[tp.Union[str, torch.device]] = None,
    scale_phi: float = 0.0,
    noise: tp.Optional[torch.Tensor] = None,
    step_noise: tp.Optional[tp.Sequence[torch.Tensor]] = None,
    verbose: bool = False,
    **sampler_kwargs,
) -> torch.Tensor:
    """Returns audio [B, io_channels, sample_size]: one sample per
    conditioning dict (prompt, seconds_start, seconds_total). The initial
    noise and each sampler step's noise come from a generator seeded with
    `seed` (-1: a random seed), unless `noise` ([B, L, C] unit noise) and
    `step_noise` (one [B, L, C] tensor per step) are given."""
    if device is None:
        device = next(model.parameters()).device
    if model.pretransform is not None:
        sample_size //= model.pretransform.downsampling_ratio
    if conditioning is None:
        raise ValueError("generate_diffusion_cond needs `conditioning`")
    inputs = model.get_conditioning_inputs(model.conditioner(conditioning, device=device))
    if negative_conditioning is not None:
        negative = model.conditioner(negative_conditioning, device=device)
        inputs.update(model.get_conditioning_inputs(negative, negative=True))
    num_sample = len(conditioning)

    seed = int(seed) if seed != -1 else int(np.random.randint(0, 2**31 - 1))
    generator = torch.Generator(device=device).manual_seed(seed)
    if noise is None:
        noise = torch.randn((num_sample, sample_size, model.io_channels), generator=generator,
                            device=device)
    if model.diffusion_objective != "v":
        raise NotImplementedError(f"objective {model.diffusion_objective!r} is not in the torch port")

    latents = sample_k(model.model, noise.to(device), steps, generator=generator,
                       step_noise=step_noise, verbose=verbose, cfg_scale=cfg_scale,
                       scale_phi=scale_phi, **sampler_kwargs, **inputs)
    if model.pretransform is not None:
        return model.pretransform.decode_nwc(latents).transpose(1, 2)
    return latents.transpose(1, 2)
