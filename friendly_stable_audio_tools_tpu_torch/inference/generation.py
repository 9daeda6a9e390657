"""Generation (counterpart of
friendly_stable_audio_tools_tpu/inference/generation.py:generate_diffusion_uncond
:75, generate_diffusion_cond :168 and build_mask :336).

Unconditional generation: seeded noise, optional init audio, the sampler
over the backbone, then the pretransform decode. Conditioned generation:
the conditioners on the prompt metadata (or given conditioning tensors),
seeded noise, optional init audio (prepared to the VAE's channels and the
clip's length, encoded once through the pretransform to the posterior mean,
repeated per sample; cut and pasted for outpainting), the sampler over the
backbone with CFG (`sample_k` for the v objective, `sample_rf` for
rectified flow), then the pretransform decode. Public layout [B, C, T].

The sampler state stays fp32 whatever the model's dtype (JAX
sampling.py:38, 52): a bf16 backbone (bench.py's recipe) casts its input at
its own entry, as the JAX recipe casts it at the call, and the pretransform
casts its input to the VAE's dtype before the encode and the decode, whose
kernels it runs on a CUDA model.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from ..utils.common import resolve_device
from .sampling import Noise, sample_k, sample_rf
from .utils import prepare_audio


def _generator_and_noise(seed: int, noise: tp.Optional[torch.Tensor], shape: tp.Tuple[int, ...],
                         device: torch.device):
    """The sampler's generator seeded with `seed` (-1: a random seed) and
    the initial unit noise: `noise` where given, else its first draw."""
    seed = int(seed) if seed != -1 else int(np.random.randint(0, 2**31 - 1))
    generator = torch.Generator(device=device).manual_seed(seed)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    return generator, noise.to(device)


def _init_latents(model, init_audio: tp.Tuple[int, tp.Any], audio_sample_size: int, n: int,
                  device: torch.device) -> torch.Tensor:
    """`init_audio` prepared to the model's rate, length and channels,
    encoded through its pretransform where it has one, repeated n times:
    [n, L, C]."""
    in_sr, audio = init_audio
    io_channels = (model.pretransform.io_channels if model.pretransform is not None
                   else model.io_channels)
    prepared = prepare_audio(audio, in_sr=in_sr, target_sr=model.sample_rate,
                             target_length=audio_sample_size, target_channels=io_channels,
                             device=device).transpose(1, 2)
    if model.pretransform is not None:
        prepared = model.pretransform.encode_nwc(prepared)
    return prepared.repeat_interleave(n, dim=0)


def _sample_and_decode(model, noise: torch.Tensor, init_latent: tp.Optional[torch.Tensor],
                       mask: tp.Optional[torch.Tensor], steps: int, generator: torch.Generator,
                       return_latents: bool, sampler_kwargs: dict, **extra) -> torch.Tensor:
    """The model's sampler (`sample_k` for the v objective, `sample_rf` for
    rectified flow, which takes sigma_max alone: the k-sampler keyword
    arguments are dropped, JAX generation.py:118-122), then the
    pretransform's decode unless `return_latents`: [B, C, T]. `extra` goes
    to the sampler (the step hook, injected draws, the backbone's inputs)."""
    if model.diffusion_objective == "v":
        latents = sample_k(model.model, noise, init_latent, mask, steps, generator=generator,
                           **sampler_kwargs, **extra)
    elif model.diffusion_objective == "rectified_flow":
        for key in ("sigma_min", "sampler_type", "rho"):
            sampler_kwargs.pop(key, None)
        extra.pop("step_noise", None)
        extra.pop("merge_noise", None)
        latents = sample_rf(model.model, noise, init_data=init_latent, steps=steps,
                            **sampler_kwargs, **extra)
    else:
        raise ValueError(f"No such sampling mode: '{model.diffusion_objective}'")
    if model.pretransform is not None and not return_latents:
        return model.pretransform.decode_nwc(latents).transpose(1, 2)
    return latents.transpose(1, 2)


@torch.no_grad()
def generate_diffusion_uncond(
    model,
    steps: int = 250,
    batch_size: int = 1,
    sample_size: int = 2097152,
    seed: int = -1,
    device: tp.Optional[tp.Union[str, torch.device]] = None,
    init_audio: tp.Optional[tp.Tuple[int, tp.Any]] = None,
    init_noise_level: float = 1.0,
    return_latents: bool = False,
    disable_tqdm: bool = False,
    callback: tp.Optional[tp.Callable] = None,
    verbose: bool = False,
    noise: tp.Optional[torch.Tensor] = None,
    step_noise: Noise = None,
    **sampler_kwargs,
) -> torch.Tensor:
    """Unconditional generation (JAX generation.py:75-167): returns audio
    [B, io_channels, sample_size] (latents [B, C, L] with `return_latents`)
    of a `diffusion_uncond` model (models/diffusion.py:DiffusionModelWrapper).
    The default length, 2,097,152 samples, is the JAX package's: at Dance
    Diffusion's depth it runs attention levels of 8192 to 1024 tokens, which
    the fp32 flash kernel K7 at head dim 32 serves on the card.

    `init_audio` (sample rate, array or tensor) is prepared to the model's
    rate, length and channels, encoded through the pretransform where there
    is one, and repeated per sample: a variation at sigma_max =
    `init_noise_level`. The v objective samples with `sample_k` (default
    dpmpp-2m-sde), rectified flow with `sample_rf` (the k-sampler kwargs
    dropped, as JAX :118-122). The initial noise ([B, L, C]) and the
    sampler's draws come from a generator seeded with `seed` unless `noise`
    and `step_noise` inject them; `callback` and `verbose` are the
    per-evaluation hook. `device` defaults to the model's."""
    device = resolve_device(next(model.parameters()).device if device is None else device,
                            'device="cpu"')
    audio_sample_size = sample_size
    if model.pretransform is not None:
        sample_size //= model.pretransform.downsampling_ratio
    generator, noise = _generator_and_noise(seed, noise,
                                            (batch_size, sample_size, model.io_channels), device)
    init_latent = None
    if init_audio is not None:
        init_latent = _init_latents(model, init_audio, audio_sample_size, batch_size, device)
        sampler_kwargs["sigma_max"] = init_noise_level
    return _sample_and_decode(model, noise, init_latent, None, steps, generator, return_latents,
                              sampler_kwargs, callback=callback, verbose=verbose,
                              step_noise=step_noise)


@torch.no_grad()
def generate_diffusion_cond(
    model,
    steps: int = 250,
    cfg_scale: float = 6.0,
    conditioning: tp.Optional[tp.List[tp.Dict[str, tp.Any]]] = None,
    conditioning_tensors: tp.Optional[tp.Dict[str, tp.Any]] = None,
    negative_conditioning: tp.Optional[tp.List[tp.Dict[str, tp.Any]]] = None,
    negative_conditioning_tensors: tp.Optional[tp.Dict[str, tp.Any]] = None,
    sample_size: int = 2097152,
    seed: int = -1,
    device: tp.Optional[tp.Union[str, torch.device]] = None,
    init_audio: tp.Optional[tp.Tuple[int, tp.Any]] = None,
    init_noise_level: float = 1.0,
    mask_args: tp.Optional[tp.Dict[str, float]] = None,
    return_latents: bool = False,
    disable_tqdm: bool = False,
    scale_phi: float = 0.0,
    callback: tp.Optional[tp.Callable] = None,
    verbose: bool = False,
    noise: tp.Optional[torch.Tensor] = None,
    step_noise: Noise = None,
    merge_noise: Noise = None,
    **sampler_kwargs,
) -> torch.Tensor:
    """Returns audio [B, io_channels, sample_size] (latents [B, C, L] with
    `return_latents`): one sample per conditioning dict (prompt,
    seconds_start, seconds_total) or per row of `conditioning_tensors`.

    `init_audio` is (sample rate, array or tensor of (T,), (C, T) or (B, C,
    T)). Without `mask_args` it is a variation: sampling starts from its
    latents plus noise at sigma_max = `init_noise_level`. With `mask_args`
    (cropfrom, pastefrom, pasteto, maskstart, maskend, softnessL,
    softnessR, marination, in percent of the clip) it is inpainting or
    outpainting: the latents' [cropfrom, cropfrom + len) span is pasted at
    [pastefrom, pasteto) over zeros, and `build_mask` keeps it where the
    mask is 1. `callback` gets {'x', 'i', 'sigma', 'denoised'} (latents)
    once per model evaluation; `verbose` prints the evaluation rate.

    The initial noise and the sampler's draws come from a generator on the
    model's device seeded with `seed` (-1: a random seed), unless `noise`
    ([B, L, C] unit noise), `step_noise` and `merge_noise` (one [B, L, C]
    tensor per step, sampling.py's module docstring) are given.
    `device` defaults to the model's; a CUDA device raises where there is
    none. `disable_tqdm` is accepted for the JAX package's signature."""
    device = resolve_device(next(model.parameters()).device if device is None else device,
                            'device="cpu"')
    audio_sample_size = sample_size
    if model.pretransform is not None:
        sample_size //= model.pretransform.downsampling_ratio
    if conditioning is None and conditioning_tensors is None:
        raise ValueError("generate_diffusion_cond needs `conditioning` or `conditioning_tensors`")
    if conditioning_tensors is None:
        conditioning_tensors = model.conditioner(conditioning, device=device)
    inputs = model.get_conditioning_inputs(conditioning_tensors)
    if negative_conditioning is not None or negative_conditioning_tensors is not None:
        if negative_conditioning_tensors is None:
            negative_conditioning_tensors = model.conditioner(negative_conditioning, device=device)
        inputs.update(model.get_conditioning_inputs(negative_conditioning_tensors, negative=True))
    num_sample = next(iter(conditioning_tensors.values()))[0].shape[0]

    generator, noise = _generator_and_noise(seed, noise,
                                            (num_sample, sample_size, model.io_channels), device)
    init_latent, mask = None, None
    if init_audio is not None:
        init_latent = _init_latents(model, init_audio, audio_sample_size, num_sample, device)
        if mask_args is not None:
            # outpainting's cut and paste (JAX generation.py:244-258)
            cropfrom = math.floor(mask_args["cropfrom"] / 100.0 * sample_size)
            pastefrom = math.floor(mask_args["pastefrom"] / 100.0 * sample_size)
            pasteto = math.ceil(mask_args["pasteto"] / 100.0 * sample_size)
            if pastefrom >= pasteto:
                raise ValueError("Paste From should be less than Paste To")
            croplen = min(pasteto - pastefrom, sample_size - cropfrom)
            cutpaste = torch.zeros_like(init_latent)
            cutpaste[:, pastefrom:pastefrom + croplen] = init_latent[:, cropfrom:cropfrom + croplen]
            init_latent = cutpaste
            mask = build_mask(sample_size, mask_args, device=device)[None, :, None]
        else:
            sampler_kwargs["sigma_max"] = init_noise_level
    inputs.update(cfg_scale=cfg_scale, scale_phi=scale_phi)
    return _sample_and_decode(model, noise, init_latent, mask, steps, generator, return_latents,
                              sampler_kwargs, callback=callback, verbose=verbose,
                              step_noise=step_noise, merge_noise=merge_noise, **inputs)


def build_mask(sample_size: int, mask_args: tp.Dict[str, float],
               device: tp.Optional[tp.Union[str, torch.device]] = None) -> torch.Tensor:
    """The inpainting mask [sample_size]: 1 (keep the init) over [maskstart,
    maskend) percent, its edges softened by Hann half-windows of softnessL
    and softnessR percent (clamped to the span), scaled by 1 - marination;
    0 elsewhere (fresh generation)."""
    maskstart = math.floor(mask_args["maskstart"] / 100.0 * sample_size)
    maskend = math.ceil(mask_args["maskend"] / 100.0 * sample_size)
    softness_l = round(mask_args["softnessL"] / 100.0 * sample_size)
    softness_r = round(mask_args["softnessR"] / 100.0 * sample_size)
    # soft edges wider than the span are clamped to it (the JAX package's repair)
    span = max(maskend - maskstart, 0)
    softness_l = min(softness_l, span)
    softness_r = min(softness_r, span - softness_l if softness_l else span)
    marination = mask_args["marination"]

    def hann(n):  # the symmetric window of 2n points
        i = np.arange(2 * n)
        return 0.5 * (1 - np.cos(2 * np.pi * i / (2 * n - 1)))

    mask = np.zeros((sample_size,), np.float32)
    mask[maskstart:maskend] = 1
    if softness_l > 0:
        mask[maskstart:maskstart + softness_l] = hann(softness_l)[:softness_l]
    if softness_r > 0:
        mask[maskend - softness_r:maskend] = hann(softness_r)[softness_r:]
    if marination > 0:
        mask = mask * (1 - marination)
    return torch.from_numpy(mask).to(device)
