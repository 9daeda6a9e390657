"""Every sampler of the torch port against the JAX package's.

The nine `sampler_type`s of `sample_k` (the seven of `_K_SAMPLERS`,
`k-dpm-fast` and `k-dpm-adaptive`) and `sample_rf` run in both packages on
the same inputs, the port fed the JAX samplers' own standard-normal draws
(derived from the same key splits as the JAX scans make them, `jax_draws`):

- on a closed-form toy model both frameworks compute (v = 0.6 x + 0.3
  sin(3x) t, and the same with a `cond_fn`), from noise, in variation and in
  inpainting: rel-L2 1e-5 (fp32 both sides; the host's fp64 step scalars
  against the scan's fp32 ones);
- on the tiny SAO model of test_torch_port_pipeline.py through
  `generate_diffusion_cond` at 6 steps: 1e-3 of the output's peak, as that
  file states.

The port evaluates only the branch a step takes where the JAX scan computes
both and keeps one with `jnp.where` (k-heun, k-dpm-2 and
k-dpmpp-2s-ancestral at the final step), so its step hook sees one
evaluation fewer there; every other sampler evaluates the model as often as
JAX does. `k-dpm-adaptive` takes as many iterations as JAX: the toy's
controller factors stay more than ADAPTIVE_MARGIN from the accept
threshold, far past fp32 rounding (~1e-6 here), so no decision can flip
between the frameworks; a start with a large first step (h_init 2) has the
controller reject steps too.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.inference import sampling as jsampling
from friendly_stable_audio_tools_tpu.inference.generation import generate_diffusion_cond as jax_generate
from friendly_stable_audio_tools_tpu_torch.inference import sampling as tsampling
from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond

SHAPE = (2, 16, 4)
STEPS = 6
SIGMA_MIN, SIGMA_MAX = 0.3, 20.0
TOY_RTOL = 1e-5
MODEL_ATOL = 1e-3  # of the output's peak
ADAPTIVE_MARGIN = 1e-3
# samplers whose final step the JAX scan evaluates twice and the port once
BRANCHED = ("k-heun", "k-dpm-2", "k-dpmpp-2s-ancestral")


class LazyDraws:
    """draws[i] computed on first use (the adaptive solver's iterations)."""

    def __init__(self, fn):
        self.fn, self.cache = fn, {}

    def __getitem__(self, i):
        if i not in self.cache:
            self.cache[i] = self.fn(i)
        return self.cache[i]


def jax_draws(sampler, rng, steps, shape):
    """(step_noise, merge_noise) of JAX `sample_k`'s draws for `rng`
    (sampling.py:356-775): the scans split `rng` into one key per step; the
    ancestral and SDE samplers split that into (merge, own draw) keys, the
    others merge with it whole; k-dpm-fast keys its segments, k-dpm-adaptive
    folds its iteration into `rng`."""

    def normal(key):
        return torch.tensor(np.asarray(jax.random.normal(key, shape, jnp.float32)))

    if sampler == "k-dpm-fast":
        return None, [normal(k) for k in jax.random.split(rng, steps // 3 + 1)]
    if sampler == "k-dpm-adaptive":
        return None, LazyDraws(lambda i: normal(jax.random.fold_in(rng, i)))
    keys = jax.random.split(rng, steps)
    if sampler in ("k-euler", "k-heun", "k-dpm-2", "k-lms"):
        return None, [normal(k) for k in keys]
    pairs = [jax.random.split(k) for k in keys]
    return [normal(p[1]) for p in pairs], [normal(p[0]) for p in pairs]


def toy_jax(x, t, **kw):
    return 0.6 * x + 0.3 * jnp.sin(3 * x) * t[:, None, None]


def toy_torch(x, t, **kw):
    return 0.6 * x + 0.3 * torch.sin(3 * x) * t[:, None, None]


def cond_jax(x, sigma, denoised):
    return -0.1 * (denoised - 0.2 * jnp.tanh(x))


def cond_torch(x, sigma, denoised):
    return -0.1 * (denoised - 0.2 * torch.tanh(x))


def _toy_inputs(seed=0):
    rs = np.random.RandomState(seed)
    noise = rs.randn(*SHAPE).astype(np.float32)
    init = (0.5 * rs.randn(*SHAPE)).astype(np.float32)
    mask = np.linspace(0.0, 1.0, SHAPE[1], dtype=np.float32)[None, :, None]
    return noise, init, mask


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _run_both(sampler, mode, cond, sigma_max=SIGMA_MAX):
    """JAX and the port's sample_k on the toy; returns (jax out, port out,
    jax evaluations, port evaluations, the port's adaptive info)."""
    noise, init, mask = _toy_inputs()
    init_j = init_t = mask_j = mask_t = None
    if mode in ("variation", "inpaint"):
        init_j, init_t = jnp.asarray(init), torch.tensor(init)
    if mode == "inpaint":
        mask_j, mask_t = jnp.asarray(mask), torch.tensor(mask)
    rng = jax.random.PRNGKey(11)
    counts = {"jax": 0, "torch": 0}

    def counter(name):
        def cb(info):
            assert set(info) == {"x", "i", "sigma", "denoised"}
            counts[name] += 1
        return cb

    kw = dict(steps=STEPS, sampler_type=sampler, sigma_min=SIGMA_MIN, sigma_max=sigma_max)
    want = jsampling.sample_k(toy_jax, jnp.asarray(noise), init_j, mask_j, rng=rng,
                              cond_fn=cond_jax if cond else None, callback=counter("jax"), **kw)
    step_noise, merge_noise = jax_draws(sampler, rng, STEPS, SHAPE)
    info = {}
    run = tsampling.sample_dpm_adaptive

    def adaptive_with_info(*a, **k):
        return run(*a, info=info, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsampling, "sample_dpm_adaptive", adaptive_with_info)
        got = tsampling.sample_k(toy_torch, torch.tensor(noise), init_t, mask_t,
                                 cond_fn=cond_torch if cond else None, callback=counter("torch"),
                                 step_noise=step_noise, merge_noise=merge_noise, **kw)
    return np.asarray(want), got.numpy(), counts["jax"], counts["torch"], info


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "cond_fn"])
@pytest.mark.parametrize("mode", ["noise", "variation", "inpaint"])
@pytest.mark.parametrize("sampler", tsampling.SAMPLER_TYPES)
def test_sampler_matches_jax_on_a_toy_model(sampler, mode, cond):
    want, got, n_jax, n_torch, info = _run_both(sampler, mode, cond,
                                                sigma_max=5.0 if mode == "variation" else SIGMA_MAX)
    assert got.shape == want.shape == SHAPE and np.isfinite(got).all()
    assert _rel(got, want) <= TOY_RTOL, _rel(got, want)
    # the port skips the discarded branch of the final step (module docstring)
    assert n_torch == n_jax - (sampler in BRANCHED), (n_torch, n_jax)
    if sampler == "k-dpm-adaptive":
        assert info["nfe"] == n_torch and info["steps"] < 200
        margin = min(abs(f - 0.81) for f in info["factors"])
        assert margin > ADAPTIVE_MARGIN, margin
    if sampler == "k-dpm-fast":
        assert n_torch == STEPS


def test_adaptive_rejections_match_jax():
    """sample_dpm_adaptive from a first step of 2 in t (h_init): the
    controller rejects steps and shrinks h; the same iterations, accepts and
    output as JAX."""
    noise, _, _ = _toy_inputs(3)
    x = noise * SIGMA_MAX
    counts = {"jax": 0}

    def cb(info):
        counts["jax"] += 1

    jden = jsampling.make_step_hooked_denoiser(jsampling.make_v_denoiser(toy_jax, {}), callback=cb)
    want = jsampling.sample_dpm_adaptive(jden, jnp.asarray(x), jax.random.PRNGKey(0), SIGMA_MIN,
                                         SIGMA_MAX, h_init=2.0)
    info = {}
    got = tsampling.sample_dpm_adaptive(tsampling.make_v_denoiser(toy_torch, {}), torch.tensor(x),
                                        SIGMA_MIN, SIGMA_MAX, h_init=2.0, info=info)
    assert info["n_reject"] > 0 and info["n_accept"] > 0
    assert counts["jax"] == info["nfe"] == 3 * info["steps"]
    assert min(abs(f - 0.81) for f in info["factors"]) > ADAPTIVE_MARGIN
    assert _rel(got.numpy(), want) <= TOY_RTOL


@pytest.mark.parametrize("mode", ["noise", "variation"])
def test_rectified_flow_matches_jax_on_a_toy_model(mode):
    noise, init, _ = _toy_inputs(1)
    counts = {"jax": 0, "torch": 0}

    def counter(name):
        def cb(info):
            counts[name] += 1
        return cb

    init_j, init_t = (jnp.asarray(init), torch.tensor(init)) if mode == "variation" else (None, None)
    # sigma_max above 1 is clamped to 1 in both
    sigma_max = 0.7 if mode == "variation" else 3.0
    want = jsampling.sample_rf(toy_jax, jnp.asarray(noise), init_j, steps=STEPS,
                               sigma_max=sigma_max, callback=counter("jax"))
    got = tsampling.sample_rf(toy_torch, torch.tensor(noise), init_t, steps=STEPS,
                              sigma_max=sigma_max, callback=counter("torch"))
    assert _rel(got.numpy(), np.asarray(want)) <= TOY_RTOL
    assert counts["jax"] == counts["torch"] == STEPS


def test_step_hook_reports_each_evaluation(capsys):
    """callback once per model evaluation with i counting them, the latents
    and the denoised estimate; verbose prints the rate every 10 evaluations."""
    noise, _, _ = _toy_inputs()
    seen = []
    tsampling.sample_k(toy_torch, torch.tensor(noise), steps=12, sampler_type="k-heun",
                       sigma_min=SIGMA_MIN, sigma_max=SIGMA_MAX, verbose=True,
                       callback=lambda info: seen.append(info))
    assert [s["i"] for s in seen] == list(range(23))  # 2 per step, 1 at the last
    assert all(s["x"].shape == s["denoised"].shape == SHAPE for s in seen)
    assert seen[0]["sigma"] == pytest.approx(SIGMA_MAX)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("sampling eval")]
    assert [ln.split()[2] for ln in lines] == ["10", "20"]


def test_unknown_sampler_raises():
    with pytest.raises(ValueError, match="Unknown sampler type"):
        tsampling.sample_k(toy_torch, torch.zeros(SHAPE), steps=2, sampler_type="k-nope")


# --------------------------------------------------------------------------
# the tiny SAO model through generate_diffusion_cond
# --------------------------------------------------------------------------


def build_pair(config):
    """The JAX package's model for `config` (seed 0, de-zeroed) and the
    port's with its weights converted."""
    from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
    from friendly_stable_audio_tools_tpu.utils.common import dezero_params
    from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
    from friendly_stable_audio_tools_tpu_torch.utils.convert import convert_conditioned_diffusion

    jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.params = dezero_params(jmodel.params)
    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(convert_conditioned_diffusion(
        jmodel.params, jmodel.conditioner.params, jmodel.pretransform.model.params), strict=True)
    return jmodel, tmodel


@pytest.fixture(scope="module")
def models():
    from tests.test_torch_port_pipeline import tiny_sao_config

    return build_pair(tiny_sao_config())


def generate_both(jmodel, tmodel, steps, shape, sampler=None, **kw):
    """JAX's generate_diffusion_cond and the port's on the same weights, the
    port given JAX's initial noise and `sampler`'s draws (seed SEED), for
    `shape`'s latents. With `sampler` None neither side names one."""
    from tests.test_torch_port_pipeline import CONDITIONING, SEED

    kw = dict(steps=steps, seed=SEED, **{"conditioning": CONDITIONING, **kw})
    if sampler is not None:
        kw["sampler_type"] = sampler
    want = np.asarray(jax_generate(jmodel, **kw))
    k_noise, k_sampler = jax.random.split(jax.random.PRNGKey(SEED))
    noise = torch.tensor(np.asarray(jax.random.normal(k_noise, shape)))
    step_noise, merge_noise = jax_draws(sampler or "dpmpp-2m-sde", k_sampler, steps, shape)
    got = generate_diffusion_cond(tmodel, noise=noise, step_noise=step_noise,
                                  merge_noise=merge_noise, **kw).numpy()
    return got, want


def _close_to_peak(got, want):
    peak = np.abs(want).max()
    assert peak > 1e-3 and np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL * peak)


# dpmpp-2m-sde runs as the default: neither side names it
TINY_SAO_SAMPLERS = [None] + [s for s in tsampling.SAMPLER_TYPES if s != "dpmpp-2m-sde"]


@pytest.mark.parametrize("sampler", TINY_SAO_SAMPLERS,
                         ids=[s or "default-dpmpp-2m-sde" for s in TINY_SAO_SAMPLERS])
def test_tiny_sao_generation_matches_jax_for_every_sampler(models, sampler):
    """Each sampler on the tiny SAO model at 6 steps; with no `sampler_type`
    both packages run their default, dpmpp-2m-sde (the port's was
    dpmpp-3m-sde), and the draws given the port are dpmpp-2m-sde's."""
    from tests.test_torch_port_pipeline import LATENTS, RATIO

    jmodel, tmodel = models
    got, want = generate_both(jmodel, tmodel, 6, (2, LATENTS, 16), sampler, cfg_scale=5.0,
                              sample_size=LATENTS * RATIO, sigma_min=0.3, sigma_max=50.0)
    assert want.shape == (2, 2, LATENTS * RATIO)
    _close_to_peak(got, want)
    if sampler is None:
        assert inspect.signature(tsampling.sample_k).parameters["sampler_type"].default == \
            inspect.signature(jsampling.sample_k).parameters["sampler_type"].default == \
            "dpmpp-2m-sde"


def test_generate_cli_runs_other_samplers(tmp_path):
    """The port's generate CLI takes the JAX package's sampler names."""
    import json
    import wave

    from friendly_stable_audio_tools_tpu_torch.generate import main
    from tests.test_torch_port_pipeline import LATENTS, RATIO, tiny_sao_config

    (tmp_path / "tiny.json").write_text(json.dumps(tiny_sao_config()))
    (tmp_path / "p.yaml").write_text('a:\n  b: {prompt: "x", seconds_start: 0, seconds_total: 3}\n')
    main(["--model-config", str(tmp_path / "tiny.json"), "--cond-yaml-path", str(tmp_path / "p.yaml"),
          "--output-dir", str(tmp_path / "out"), "--sample-steps", "3", "--sampler-type", "k-dpm-fast",
          "--seed", "2", "--device", "cpu"])
    with wave.open(str(tmp_path / "out" / "a" / "b_item-1.wav")) as f:
        assert (f.getnchannels(), f.getnframes()) == (2, LATENTS * RATIO)
