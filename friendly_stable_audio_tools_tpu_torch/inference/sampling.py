"""k-diffusion, DDIM and rectified-flow sampling (counterpart of
friendly_stable_audio_tools_tpu/inference/sampling.py).

Every sampler of the JAX package's `sample_k` (the seven of `_K_SAMPLERS`,
`k-dpm-fast` and `k-dpm-adaptive`) with its three starts (from noise,
variation, inpainting with the per-step merge), the v-denoiser wrapper, the
`cond_fn` guidance hook and the per-evaluation step hook; DDIM `sample`
for v-objective models (the diffusion autoencoder's decode); and
`sample_rf` for rectified-flow models. Each runs as a Python loop over steps; the state
stays fp32 on the model's device whatever the model's dtype.

Noise. The samplers' standard-normal draws come from the caller's
`torch.Generator`, or from tensors the caller injects (the tests inject the
JAX sampler's own draws, since the two frameworks' random streams differ):
`step_noise[i]` is the sampler's own draw at step i (the ancestral and SDE
samplers), `merge_noise[i]` the inpaint merge's draw at step i (for
`k-dpm-fast` its order segment i, for `k-dpm-adaptive` its iteration i).
Any object indexable by the step works, a list or a lazy sequence.

Branches. Where the JAX scan computes both branches of a step and keeps one
with `jnp.where` (k-heun, k-dpm-2 and k-dpmpp-2s-ancestral at the final
step, whose sigma_next is 0), only the branch taken runs here. The outputs
are the same; the model is evaluated once less per run, so the step hook
sees one evaluation fewer than the JAX package's.
"""

from __future__ import annotations

import math
import time
import typing as tp

import numpy as np
import torch

Noise = tp.Optional[tp.Any]  # indexable by the step: one tensor per step


def get_sigmas_polyexponential(n: int, sigma_min: float, sigma_max: float,
                               rho: float = 1.0) -> np.ndarray:
    """k-diffusion polyexponential schedule plus a terminal zero (host side)."""
    ramp = np.linspace(1, 0, n) ** rho
    sigmas = np.exp(ramp * (math.log(sigma_max) - math.log(sigma_min)) + math.log(sigma_min))
    return np.append(sigmas, 0.0).astype(np.float64)


def _draw(noise: Noise, i: int, like: torch.Tensor,
          generator: tp.Optional[torch.Generator]) -> torch.Tensor:
    """Step i's standard-normal draw of `like`'s shape: injected, or from
    `generator` on `like`'s device."""
    if noise is not None:
        return noise[i].to(device=like.device, dtype=torch.float32)
    return torch.randn(like.shape, generator=generator, device=like.device)


# --------------------------------------------------------------------------
# denoiser wrappers
# --------------------------------------------------------------------------


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


def make_cond_model_fn(denoiser: tp.Callable, cond_fn: tp.Callable) -> tp.Callable:
    """Gradient guidance (JAX sampling.py:309): cond_fn(x, sigma,
    denoised=...) returns a correction added as denoised + grad * sigma^2."""

    def guided(x: torch.Tensor, sigma: float) -> torch.Tensor:
        denoised = denoiser(x, sigma)
        return denoised + cond_fn(x, sigma, denoised=denoised) * sigma ** 2

    return guided


def make_step_emitter(verbose: bool = False, callback: tp.Optional[tp.Callable] = None,
                      total_steps: tp.Optional[int] = None) -> tp.Optional[tp.Callable]:
    """The per-evaluation hook (JAX sampling.py:240): `emit(x, sigma,
    denoised)` calls `callback({'x', 'i', 'sigma', 'denoised'})` with i
    counting model evaluations, and with `verbose` prints the evaluation
    rate every 10 evaluations; None when neither is asked for."""
    if not verbose and callback is None:
        return None
    state = {"i": 0, "t0": None}

    def emit(x: torch.Tensor, sigma: float, denoised: torch.Tensor) -> None:
        i = state["i"]
        state["i"] += 1
        if callback is not None:
            callback({"x": x, "i": i, "sigma": float(sigma), "denoised": denoised})
        if verbose and i % 10 == 0:
            now = time.perf_counter()
            if state["t0"] is not None:
                total = f" (target {total_steps} steps)" if total_steps else ""
                print(f"sampling eval {i}{total}: {10.0 / max(now - state['t0'], 1e-9):.2f} "
                      f"iters/sec", flush=True)
            state["t0"] = now

    return emit


def make_step_hooked_denoiser(denoiser: tp.Callable, verbose: bool = False,
                              callback: tp.Optional[tp.Callable] = None,
                              total_steps: tp.Optional[int] = None) -> tp.Callable:
    """`denoiser` emitting the step hook on each call; itself when no hook
    is asked for."""
    emit = make_step_emitter(verbose=verbose, callback=callback, total_steps=total_steps)
    if emit is None:
        return denoiser

    def hooked(x: torch.Tensor, sigma: float) -> torch.Tensor:
        denoised = denoiser(x, sigma)
        emit(x, sigma, denoised)
        return denoised

    return hooked


# --------------------------------------------------------------------------
# inpainting (JAX sampling.py:327-344)
# --------------------------------------------------------------------------


def get_bmask(i: int, steps: int, mask: torch.Tensor) -> torch.Tensor:
    """1 where the mask is at most step i's strength (i + 1) / steps, which
    is compared in fp32 as the JAX scan computes it."""
    return (mask <= float(np.float32((i + 1) / steps))).float()


def make_inpaint_merge(init_data: tp.Optional[torch.Tensor], mask: tp.Optional[torch.Tensor],
                       steps: int, generator: tp.Optional[torch.Generator] = None,
                       noise: Noise = None) -> tp.Optional[tp.Callable]:
    """merge(x, i, sigma): x <- (init + noise * sigma) * bmask + x * (1 -
    bmask), applied after each denoise and before the integrator update;
    `noise[i]` is step i's draw. None without init data and a mask."""
    if init_data is None or mask is None:
        return None

    def merge(x: torch.Tensor, i: int, sigma: float) -> torch.Tensor:
        bmask = get_bmask(i, steps, mask)
        input_noised = init_data + _draw(noise, i, init_data, generator) * sigma
        return input_noised * bmask + x * (1.0 - bmask)

    return merge


# --------------------------------------------------------------------------
# k-diffusion samplers over a sigma grid
# --------------------------------------------------------------------------


def _to_d(x: torch.Tensor, sigma: float, denoised: torch.Tensor) -> torch.Tensor:
    return (x - denoised) / sigma


def sample_euler(denoiser, x, sigmas, generator=None, merge=None, noise=None):
    """k-diffusion sample_euler (JAX sampling.py:356). As in k-diffusion, d
    comes from the x before the merge and the update goes from the merged x."""
    x = x.float()
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoiser(x, sigma)
        d = _to_d(x, sigma, denoised)
        if merge is not None:
            x = merge(x, i, sigma)
        x = x + d * (sigma_next - sigma)
    return x


def sample_heun(denoiser, x, sigmas, generator=None, merge=None, noise=None):
    """k-diffusion sample_heun with s_churn 0 (JAX sampling.py:376); the
    final step (sigma_next 0) is Euler's and runs no second evaluation."""
    x = x.float()
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoiser(x, sigma)
        d = _to_d(x, sigma, denoised)
        if merge is not None:
            x = merge(x, i, sigma)
        dt = sigma_next - sigma
        x_euler = x + d * dt
        if sigma_next == 0:
            x = x_euler
        else:
            d_2 = _to_d(x_euler, sigma_next, denoiser(x_euler, sigma_next))
            x = x + (d + d_2) / 2 * dt
    return x


def sample_dpm_2(denoiser, x, sigmas, generator=None, merge=None, noise=None):
    """k-diffusion sample_dpm_2, the midpoint in log sigma, s_churn 0 (JAX
    sampling.py:404); the final step is Euler's, with no midpoint evaluation."""
    x = x.float()
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoiser(x, sigma)
        d = _to_d(x, sigma, denoised)
        if merge is not None:
            x = merge(x, i, sigma)
        if sigma_next == 0:
            x = x + d * (sigma_next - sigma)
        else:
            sigma_mid = math.exp(math.log(sigma) * 0.5 + math.log(sigma_next) * 0.5)
            x_2 = x + d * (sigma_mid - sigma)
            d_2 = _to_d(x_2, sigma_mid, denoiser(x_2, sigma_mid))
            x = x + d_2 * (sigma_next - sigma)
    return x


def sample_dpmpp_2s_ancestral(denoiser, x, sigmas, generator=None, merge=None, noise=None,
                              eta: float = 1.0, s_noise: float = 1.0):
    """k-diffusion sample_dpmpp_2s_ancestral (JAX sampling.py:432): a
    DPM-Solver++(2S) step down to sigma_down, then the ancestral draw
    `noise[i]` times sigma_up; Euler's step where sigma_down is 0 (the final
    step), with no second evaluation."""
    x = x.float()
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoiser(x, sigma)
        if merge is not None:
            x = merge(x, i, sigma)
        sigma_up = min(sigma_next, eta * math.sqrt(max(
            sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / max(sigma ** 2, 1e-20), 0.0)))
        sigma_down = math.sqrt(max(sigma_next ** 2 - sigma_up ** 2, 0.0))
        if sigma_down == 0:
            x = x + _to_d(x, sigma, denoised) * (sigma_down - sigma)
        else:
            t, t_next = -math.log(sigma), -math.log(sigma_down)
            h = t_next - t
            s = t + 0.5 * h
            x_2 = (math.exp(-s) / math.exp(-t)) * x - math.expm1(-0.5 * h) * denoised
            denoised_2 = denoiser(x_2, math.exp(-s))
            x = (sigma_down / sigma) * x - math.expm1(-h) * denoised_2
        if sigma_up > 0:
            x = x + _draw(noise, i, x, generator) * (s_noise * sigma_up)
    return x


def _lms_coefficients(sigmas: np.ndarray, order: int) -> tp.List[tp.List[float]]:
    """The Adams-Bashforth coefficients of each step, integrated on the host
    with scipy's quad over the static sigma grid (JAX sampling.py:480-495)."""
    from scipy import integrate

    def coeff(cur_order, t, i, j):
        def fn(tau):
            prod = 1.0
            for k in range(cur_order):
                if j != k:
                    prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
            return prod

        return integrate.quad(fn, t[i], t[i + 1], epsrel=1e-4)[0]

    return [[float(np.float32(coeff(min(i + 1, order), sigmas, i, j)))
             for j in range(min(i + 1, order))] for i in range(len(sigmas) - 1)]


def sample_lms(denoiser, x, sigmas, generator=None, merge=None, noise=None, order: int = 4):
    """k-diffusion sample_lms (JAX sampling.py:472): linear multistep over the
    last `order` derivatives, newest first."""
    coeffs = _lms_coefficients(np.asarray(sigmas, np.float64), order)
    x = x.float()
    ds: tp.List[torch.Tensor] = []
    for i in range(len(sigmas) - 1):
        sigma = float(sigmas[i])
        denoised = denoiser(x, sigma)
        d = _to_d(x, sigma, denoised)
        if merge is not None:
            x = merge(x, i, sigma)
        ds = [d] + ds[:order - 1]
        x = x + sum(c * dj for c, dj in zip(coeffs[i], ds))
    return x


def sample_dpmpp_2m_sde(denoiser, x, sigmas, generator=None, merge=None, noise=None,
                        eta: float = 1.0, s_noise: float = 1.0):
    """k-diffusion sample_dpmpp_2m_sde, solver_type 'midpoint' (JAX
    sampling.py:517). `noise[i]` is step i's SDE draw."""
    x = x.float()
    old_denoised, h_last = None, None
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoiser(x, sigma)
        if merge is not None:
            x = merge(x, i, sigma)
        if sigma_next == 0:
            x = denoised
        else:
            h = math.log(sigma) - math.log(sigma_next)
            eta_h = eta * h
            x = (sigma_next / sigma) * math.exp(-eta_h) * x + (-math.expm1(-h - eta_h)) * denoised
            if old_denoised is not None:
                r = h_last / h
                x = x + (0.5 * -math.expm1(-h - eta_h) / r) * (denoised - old_denoised)
            if eta > 0:
                x = x + _draw(noise, i, x, generator) * (
                    sigma_next * math.sqrt(max(-math.expm1(-2 * eta_h), 0.0)) * s_noise)
            h_last = h
        old_denoised = denoised
    return x


def sample_dpmpp_3m_sde(denoiser, x, sigmas, generator=None, merge=None, noise=None,
                        eta: float = 1.0, s_noise: float = 1.0):
    """k-diffusion sample_dpmpp_3m_sde (JAX sampling.py:551), the reference's
    sampler for SAO generation. `noise[i]` is step i's SDE draw."""
    x = x.float()
    d1 = d2 = None  # the two previous denoised estimates
    h1 = h2 = None  # the two previous step sizes
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoiser(x, sigma)
        if merge is not None:
            x = merge(x, i, sigma)
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
                x = x + _draw(noise, i, x, generator) * (
                    sigma_next * math.sqrt(-math.expm1(-2 * h * eta)) * s_noise)
            h1, h2 = h, h1
        d1, d2 = denoised, d1
    return x


# --------------------------------------------------------------------------
# DPM-Solver, fast and adaptive (JAX sampling.py:613-775)
# --------------------------------------------------------------------------


class _DPMSolver:
    """DPM-Solver's steps in t = -log(sigma) (k-diffusion's DPMSolver)."""

    def __init__(self, denoiser: tp.Callable):
        self.denoiser = denoiser

    def eps(self, x: torch.Tensor, t: float) -> torch.Tensor:
        sigma = math.exp(-t)
        return (x - self.denoiser(x, sigma)) / sigma

    @staticmethod
    def step1(x, t, t_next, eps):
        return x - math.exp(-t_next) * math.expm1(t_next - t) * eps

    def step2(self, x, t, t_next, eps, r1=0.5, eps_r1=None):
        h = t_next - t
        if eps_r1 is None:
            s1 = t + r1 * h
            eps_r1 = self.eps(x - math.exp(-s1) * math.expm1(r1 * h) * eps, s1)
        sn = math.exp(-t_next)
        return x - sn * math.expm1(h) * eps - sn / (2 * r1) * math.expm1(h) * (eps_r1 - eps)

    def step3(self, x, t, t_next, eps, r1=1 / 3, r2=2 / 3, eps_r1=None):
        h = t_next - t
        s1, s2 = t + r1 * h, t + r2 * h
        if eps_r1 is None:
            eps_r1 = self.eps(x - math.exp(-s1) * math.expm1(r1 * h) * eps, s1)
        sig2 = math.exp(-s2)
        u2 = (x - sig2 * math.expm1(r2 * h) * eps
              - sig2 * (r2 / r1) * (math.expm1(r2 * h) / (r2 * h) - 1) * (eps_r1 - eps))
        eps_r2 = self.eps(u2, s2)
        sn = math.exp(-t_next)
        return x - sn * math.expm1(h) * eps - sn / r2 * (math.expm1(h) / h - 1) * (eps_r2 - eps)


def sample_dpm_fast(denoiser, x, sigma_min: float, sigma_max: float, n: int, merge=None):
    """k-diffusion sample_dpm_fast with eta 0 (JAX sampling.py:653): n model
    evaluations as order-3 segments on a uniform t = -log(sigma) grid, the
    last one or two of lower order. The merge runs after each segment's
    first evaluation, keyed by the segment."""
    solver = _DPMSolver(denoiser)
    t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
    m = math.floor(n / 3) + 1
    ts = np.linspace(t_start, t_end, m + 1)
    orders = [3] * (m - 2) + [2, 1] if n % 3 == 0 else [3] * (m - 1) + [n % 3]
    x = x.float()
    for i in range(m):
        t, t_next = float(ts[i]), float(ts[i + 1])
        eps = solver.eps(x, t)
        if merge is not None:
            x = merge(x, i, math.exp(-t))
        if orders[i] == 1:
            x = solver.step1(x, t, t_next, eps)
        elif orders[i] == 2:
            x = solver.step2(x, t, t_next, eps)
        else:
            x = solver.step3(x, t, t_next, eps)
    return x


def sample_dpm_adaptive(denoiser, x, sigma_min: float, sigma_max: float, merge=None,
                        rtol: float = 0.01, atol: float = 0.01, h_init: float = 0.05,
                        pcoeff: float = 0.0, icoeff: float = 1.0, dcoeff: float = 0.0,
                        accept_safety: float = 0.81, max_steps: int = 200,
                        info: tp.Optional[tp.Dict[str, tp.Any]] = None):
    """k-diffusion sample_dpm_adaptive (JAX sampling.py:701): the embedded
    DPM-Solver (2, 3) pair, whose low-order solution shares the order-3
    solution's r1 = 1/3 evaluation (3 evaluations an iteration), under a PID
    step-size controller with its arctan limiter. A step is accepted where
    the controller's factor is at least `accept_safety`; the merge runs
    after each accepted step, keyed by the iteration. Integration stops at
    t_end or after `max_steps` iterations, accepted or not. Each iteration
    reads the error norm on the host. `info`, when given, receives the
    iterations (`steps`), `n_accept`, `n_reject`, `nfe` and each iteration's
    `factors`."""
    solver = _DPMSolver(denoiser)
    t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
    order = 3
    b1 = (pcoeff + icoeff + dcoeff) / order
    b2 = -(pcoeff + 2 * dcoeff) / order
    b3 = dcoeff / order
    x = x.float()
    x_prev = x
    s, h = t_start, h_init
    e1 = e2 = 1.0  # the controller's error history, rotated on accept
    steps, factors, n_accept = 0, [], 0
    while s < t_end - 1e-5 and steps < max_steps:
        t = min(t_end, s + h)
        eps = solver.eps(x, s)
        h_cur = t - s
        s1 = s + h_cur / 3.0
        eps_r1 = solver.eps(x - math.exp(-s1) * math.expm1(h_cur / 3.0) * eps, s1)
        x_low = solver.step2(x, s, t, eps, r1=1.0 / 3.0, eps_r1=eps_r1)
        x_high = solver.step3(x, s, t, eps, eps_r1=eps_r1)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()), min=atol)
        error = ((x_low - x_high) / delta).square().mean().sqrt().item()
        inv_err = 1.0 / (1e-8 + error)
        # the first iteration seeds the history with its own error
        h1, h2 = (inv_err, inv_err) if steps == 0 else (e1, e2)
        factor = 1 + math.atan(inv_err ** b1 * h1 ** b2 * h2 ** b3 - 1)
        factors.append(factor)
        if factor >= accept_safety:
            x = merge(x_high, steps, math.exp(-t)) if merge is not None else x_high
            x_prev, s = x_low, t
            e1, e2 = inv_err, h1
            n_accept += 1
        h = min(max(h * factor, 1e-4), abs(t_end - t_start))
        steps += 1
    if info is not None:
        info.update(steps=steps, n_accept=n_accept, n_reject=steps - n_accept, nfe=3 * steps,
                    factors=factors)
    return x


_K_SAMPLERS = {
    "k-euler": sample_euler,
    "k-heun": sample_heun,
    "k-lms": sample_lms,
    "k-dpmpp-2s-ancestral": sample_dpmpp_2s_ancestral,
    "k-dpm-2": sample_dpm_2,
    "dpmpp-2m-sde": sample_dpmpp_2m_sde,
    "dpmpp-3m-sde": sample_dpmpp_3m_sde,
}
SAMPLER_TYPES = tuple(_K_SAMPLERS) + ("k-dpm-fast", "k-dpm-adaptive")


def sample_k(model_fn: tp.Callable, noise: torch.Tensor,
             init_data: tp.Optional[torch.Tensor] = None, mask: tp.Optional[torch.Tensor] = None,
             steps: int = 100, sampler_type: str = "dpmpp-2m-sde", sigma_min: float = 0.5,
             sigma_max: float = 50.0, rho: float = 1.0,
             generator: tp.Optional[torch.Generator] = None,
             cond_fn: tp.Optional[tp.Callable] = None, callback: tp.Optional[tp.Callable] = None,
             verbose: bool = False, disable_tqdm: bool = False, device=None,
             step_noise: Noise = None, merge_noise: Noise = None, **extra_args) -> torch.Tensor:
    """k-diffusion sampling of a v-objective model (JAX sampling.py:789).

    `noise` is unit noise [B, L, C]. With `init_data` (latents of the same
    shape) and no `mask` the start is init + noise * sigma_max (variation);
    with both, inpainting: the start keeps init + noise where step 0's
    binary mask is 1, and every step merges the noised init back in where
    `mask` ([1, L, 1], 1 keeps the init) is at most the step's strength.
    `generator` gives the draws that `step_noise` and `merge_noise` (module
    docstring) do not inject; `callback` and `verbose` are the
    per-evaluation hook (`make_step_emitter`); `extra_args` go to
    `model_fn`. `disable_tqdm` and `device` are accepted for the JAX
    package's signature."""
    if sampler_type not in SAMPLER_TYPES:
        raise ValueError(f"Unknown sampler type {sampler_type}")
    sigmas = get_sigmas_polyexponential(steps, sigma_min, sigma_max, rho)
    denoiser = make_v_denoiser(model_fn, extra_args)
    if cond_fn is not None:
        denoiser = make_cond_model_fn(denoiser, cond_fn)
    denoiser = make_step_hooked_denoiser(denoiser, verbose=verbose, callback=callback,
                                         total_steps=steps)
    noise = noise.float() * float(sigmas[0])
    merge = None
    if init_data is not None and mask is None:
        x = init_data.float() + noise
    elif init_data is not None:
        bmask = get_bmask(0, steps, mask)
        x = (init_data.float() + noise) * bmask + noise * (1.0 - bmask)
        merge = make_inpaint_merge(init_data.float(), mask, steps, generator, merge_noise)
    else:
        x = noise

    if sampler_type == "k-dpm-fast":
        return sample_dpm_fast(denoiser, x, sigma_min, sigma_max, steps, merge=merge)
    if sampler_type == "k-dpm-adaptive":
        return sample_dpm_adaptive(denoiser, x, sigma_min, sigma_max, merge=merge, rtol=0.01,
                                   atol=0.01)
    return _K_SAMPLERS[sampler_type](denoiser, x, sigmas, generator=generator, merge=merge,
                                     noise=step_noise)


# --------------------------------------------------------------------------
# v-diffusion DDIM (JAX sampling.py:855-898)
# --------------------------------------------------------------------------


def sample(model_fn: tp.Callable, x: torch.Tensor, steps: int, eta: float = 0.0,
           generator: tp.Optional[torch.Generator] = None, noise: Noise = None,
           verbose: bool = False, callback: tp.Optional[tp.Callable] = None,
           **extra_args) -> torch.Tensor:
    """DDIM for v-objective models: t from 1 down to 0 in `steps` equal
    steps (the schedule in fp32, as the JAX scan has it); each step predicts
    x0 = x alpha - v sigma and eps = x sigma + v alpha and recombines them at
    the next step's (alpha, sigma), with `eta` > 0 adding fresh noise of
    the DDIM sigma (step i's draw `noise[i]`, else from `generator`). The
    final step keeps x (the JAX `jnp.where(i < steps - 1, ...)`) and the
    last prediction is returned. The step hook sees (x, sigma, pred)."""
    emit = make_step_emitter(verbose=verbose, callback=callback, total_steps=steps)
    t = torch.from_numpy(np.linspace(1, 0, steps + 1, dtype=np.float32)[:-1]).to(x.device)
    alphas, sigmas = torch.cos(t * (math.pi / 2)), torch.sin(t * (math.pi / 2))
    x = x.float()
    pred = torch.zeros_like(x)
    for i in range(steps):
        v = model_fn(x, t[i].expand(x.shape[0]), **extra_args).float()
        pred = x * alphas[i] - v * sigmas[i]
        if emit is not None:
            emit(x, float(sigmas[i]), pred)
        if i == steps - 1:
            break
        eps = x * sigmas[i] + v * alphas[i]
        a_next, s_next = alphas[i + 1], sigmas[i + 1]
        ddim_sigma = eta * torch.sqrt(s_next ** 2 / sigmas[i].square().clamp_min(1e-20)) \
            * torch.sqrt((1 - alphas[i] ** 2 / a_next.square().clamp_min(1e-20)).clamp_min(0.0))
        adjusted_sigma = torch.sqrt((s_next ** 2 - ddim_sigma ** 2).clamp_min(0.0))
        x = pred * a_next + eps * adjusted_sigma
        if eta:
            x = x + _draw(noise, i, x, generator) * ddim_sigma
    return pred


# --------------------------------------------------------------------------
# rectified flow (JAX sampling.py:906-951)
# --------------------------------------------------------------------------


def sample_discrete_euler(model_fn: tp.Callable, x: torch.Tensor, steps: int,
                          sigma_max: float = 1.0, verbose: bool = False,
                          callback: tp.Optional[tp.Callable] = None, **extra_args) -> torch.Tensor:
    """Euler for rectified flow: t from sigma_max down to 0 in `steps`
    equal steps, x += dt * model(x, t). The step hook's 'denoised' is the
    clean prediction x - t * v."""
    emit = make_step_emitter(verbose=verbose, callback=callback, total_steps=steps)
    ts = np.linspace(sigma_max, 0, steps + 1)
    x = x.float()
    for i in range(steps):
        t_curr, t_next = float(ts[i]), float(ts[i + 1])
        v = model_fn(x, torch.full((x.shape[0],), t_curr, device=x.device), **extra_args).float()
        if emit is not None:
            emit(x, t_curr, x - t_curr * v)
        x = x + (t_next - t_curr) * v
    return x


def sample_rf(model_fn: tp.Callable, noise: torch.Tensor,
              init_data: tp.Optional[torch.Tensor] = None, steps: int = 100,
              sigma_max: float = 1.0, generator: tp.Optional[torch.Generator] = None,
              cond_fn: tp.Optional[tp.Callable] = None, callback: tp.Optional[tp.Callable] = None,
              verbose: bool = False, disable_tqdm: bool = False, device=None,
              **extra_args) -> torch.Tensor:
    """Rectified-flow sampling (JAX sampling.py:940): sigma_max clamped to
    1; from noise, or from init * (1 - sigma_max) + noise * sigma_max
    (variation). It draws nothing; `generator`, `cond_fn`, `disable_tqdm`
    and `device` are accepted and unused, as in the JAX package."""
    sigma_max = min(sigma_max, 1)
    x = noise.float()
    if init_data is not None:
        x = init_data.float() * (1 - sigma_max) + x * sigma_max
    return sample_discrete_euler(model_fn, x, steps, sigma_max, verbose=verbose,
                                 callback=callback, **extra_args)
