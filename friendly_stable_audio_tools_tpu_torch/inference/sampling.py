"""k-diffusion sampling for v-objective models (counterpart of
friendly_stable_audio_tools_tpu/inference/sampling.py).

Ported for the sampler Stable Audio Open generates with: the
polyexponential sigma schedule, the v-denoiser wrapper and
dpmpp-3m-sde, as a Python loop over steps. The SDE noise of each step comes
from a `torch.Generator`, or from a list of tensors the caller injects (the
tests inject the JAX sampler's own noise values, since the two frameworks'
random streams differ). The sampler state stays fp32.
"""

from __future__ import annotations

import math
import time
import typing as tp

import numpy as np
import torch


def get_sigmas_polyexponential(n: int, sigma_min: float, sigma_max: float,
                               rho: float = 1.0) -> np.ndarray:
    """k-diffusion polyexponential schedule plus a terminal zero (host side)."""
    ramp = np.linspace(1, 0, n) ** rho
    sigmas = np.exp(ramp * (math.log(sigma_max) - math.log(sigma_min)) + math.log(sigma_min))
    return np.append(sigmas, 0.0).astype(np.float64)


def make_v_denoiser(model_fn: tp.Callable, extra_args: tp.Dict[str, tp.Any]) -> tp.Callable:
    """D(x, sigma) = c_out * model(c_in * x, t(sigma)) + c_skip * x, in fp32."""

    def denoiser(x: torch.Tensor, sigma: float) -> torch.Tensor:
        c_skip = 1.0 / (sigma ** 2 + 1.0)
        c_out = -sigma / math.sqrt(sigma ** 2 + 1.0)
        c_in = 1.0 / math.sqrt(sigma ** 2 + 1.0)
        t = torch.full((x.shape[0],), math.atan(sigma) / math.pi * 2, device=x.device)
        v = model_fn(x * c_in, t, **extra_args).float()
        return v * c_out + x * c_skip

    return denoiser


def sample_dpmpp_3m_sde(denoiser: tp.Callable, x: torch.Tensor, sigmas: np.ndarray,
                        generator: tp.Optional[torch.Generator] = None,
                        noise: tp.Optional[tp.Sequence[torch.Tensor]] = None,
                        eta: float = 1.0, s_noise: float = 1.0,
                        callback: tp.Optional[tp.Callable] = None) -> torch.Tensor:
    """k-diffusion sample_dpmpp_3m_sde (JAX sampling.py:551). `noise[i]` is
    the standard-normal draw of step i; without it, draws come from
    `generator`."""
    x = x.float()
    d1 = d2 = None  # the two previous denoised estimates
    h1 = h2 = None  # the two previous step sizes
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoiser(x, sigma)
        if callback is not None:
            callback({"x": x, "i": i, "sigma": sigma, "denoised": denoised})
        if sigma_next == 0:
            x = denoised
        else:
            h = math.log(sigma) - math.log(sigma_next)
            h_eta = h * (eta + 1.0)
            x = math.exp(-h_eta) * x + (-math.expm1(-h_eta)) * denoised
            phi_2 = math.expm1(-h_eta) / h_eta + 1.0
            if h2 is not None:
                r0, r1 = h1 / h, h2 / h
                d1_0 = (denoised - d1) / r0
                d1_1 = (d1 - d2) / r1
                dd1 = d1_0 + (d1_0 - d1_1) * r0 / (r0 + r1)
                dd2 = (d1_0 - d1_1) / (r0 + r1)
                phi_3 = phi_2 / h_eta - 0.5
                x = x + phi_2 * dd1 - phi_3 * dd2
            elif h1 is not None:
                x = x + phi_2 * (denoised - d1) / (h1 / h)
            if eta > 0:
                z = noise[i] if noise is not None else torch.randn(
                    x.shape, generator=generator, device=x.device)
                x = x + z.to(x) * (sigma_next * math.sqrt(-math.expm1(-2 * h * eta)) * s_noise)
            h1, h2 = h, h1
        d1, d2 = denoised, d1
    return x


_SAMPLERS = {"dpmpp-3m-sde": sample_dpmpp_3m_sde}


def sample_k(model_fn: tp.Callable, noise: torch.Tensor, steps: int = 100,
             sampler_type: str = "dpmpp-3m-sde", sigma_min: float = 0.5, sigma_max: float = 50.0,
             rho: float = 1.0, generator: tp.Optional[torch.Generator] = None,
             step_noise: tp.Optional[tp.Sequence[torch.Tensor]] = None, verbose: bool = False,
             **extra_args) -> torch.Tensor:
    """k-diffusion sampling of a v-objective model from unit noise (JAX
    sampling.py:789); `extra_args` go to `model_fn`."""
    if sampler_type not in _SAMPLERS:
        raise NotImplementedError(f"sampler {sampler_type!r} is not in the torch port "
                                  f"(ported: {sorted(_SAMPLERS)})")
    sigmas = get_sigmas_polyexponential(steps, sigma_min, sigma_max, rho)
    denoiser = make_v_denoiser(model_fn, extra_args)
    callback = None
    if verbose:
        start = time.perf_counter()

        def callback(info):
            if info["i"] % 10 == 9:
                print(f"step {info['i'] + 1}/{steps}: "
                      f"{(info['i'] + 1) / (time.perf_counter() - start):.2f} it/s", flush=True)
    x = noise.float() * float(sigmas[0])
    return _SAMPLERS[sampler_type](denoiser, x, sigmas, generator=generator, noise=step_noise,
                                   callback=callback)
