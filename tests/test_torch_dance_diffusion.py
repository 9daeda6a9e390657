"""The torch port's Dance Diffusion (models/dance_diffusion.py, the
`diffusion_uncond` model type), its generation (inference/generation.py:
generate_diffusion_uncond), DDIM (inference/sampling.py:sample) and its
trainer against the JAX package.

A tiny `DAU1d` (depth 4, channels [32, 32, 64, 64], attention from level 2
on, so every head has dim 32) is built by the JAX package and converted into
the port; inputs come from numpy with fixed seeds, and the JAX sampler's and
trainer's draws are recovered from their keys and injected into the port.
Everything is fp32 on the CPU. Tolerances: modules rel-L2 1e-5 (the fp32
rounding of XLA against PyTorch); generation and DDIM 1e-4 (the same
through 2-8 model evaluations); a train step's loss 1e-5 relative and every
gradient 1e-4 of its largest entry. The attention's kernel route is forced
on CPU tensors (the plain K7) and held against the JAX package's Pallas
`_flash_forward` in interpret mode at head dim 32.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu.inference import sampling as jsampling
from friendly_stable_audio_tools_tpu.inference.generation import (
    generate_diffusion_uncond as jax_generate,
)
from friendly_stable_audio_tools_tpu.models import dance_diffusion as jdd
from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.training import diffusion as jdiff
from friendly_stable_audio_tools_tpu.training.factory import (
    create_training_wrapper_from_config as jax_wrapper,
)
from friendly_stable_audio_tools_tpu_torch.inference import sampling as tsampling
from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_uncond
from friendly_stable_audio_tools_tpu_torch.models import dance_diffusion as tdd
from friendly_stable_audio_tools_tpu_torch.models.diffusion import (
    create_diffusion_uncond_from_config,
)
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.ops import attention as tattention
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash
from friendly_stable_audio_tools_tpu_torch.training.factory import (
    create_training_wrapper_from_config,
)
from friendly_stable_audio_tools_tpu_torch.utils.convert import (
    convert_diffusion_uncond,
    state_dict_from_jax,
)
from tests.test_torch_samplers import jax_draws

DD = {"io_channels": 2, "depth": 4, "n_attn_layers": 2, "channels": [32, 32, 64, 64],
      "strides": [2, 2, 2]}
SAMPLE_SIZE = 256


def tiny_dd_config(**extra):
    return {"model_type": "diffusion_uncond", "sample_size": SAMPLE_SIZE, "sample_rate": 16000,
            "model": {"type": "DAU1d", "config": {**DD, **extra}},
            "training": {"learning_rate": 1e-4, "demo": {"demo_every": 2, "demo_steps": 2}}}


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want)


def _port_module(module, params):
    """The port's `module` with the JAX `params` loaded (strictly)."""
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module.eval()


def _init(jmodule, *args, **kwargs):
    return jmodule.init(jax.random.PRNGKey(0), *[jnp.asarray(a) for a in args], **kwargs)["params"]


@pytest.fixture(scope="module")
def models():
    """The tiny `diffusion_uncond` model built by the JAX package, and the
    port's with its weights."""
    config = tiny_dd_config()
    jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    model = create_model_from_config(config, device="cpu")
    model.load_state_dict(convert_diffusion_uncond(jmodel.params), strict=True)
    return config, jmodel, model


# ---- modules -------------------------------------------------------------------


@pytest.mark.parametrize("t", [16, 37])
def test_resamplers_match_jax_to_their_edges(t):
    """AADownsample1d and AAUpsample1d (reflect padding, the stride-2
    depthwise cubic kernel): the whole output within 1e-6 of JAX's, the four
    samples at each edge included."""
    x = np.random.RandomState(t).randn(2, t, 3).astype(np.float32)
    for jm, tm, length in ((jdd.AADownsample1d(), tdd.AADownsample1d(), (t - 2) // 2 + 1),
                           (jdd.AAUpsample1d(), tdd.AAUpsample1d(), 2 * t)):
        want = np.asarray(jm.apply({}, jnp.asarray(x)))
        got = tm(_t(x)).numpy()
        assert got.shape == want.shape == (2, length, 3)
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[:, -4:], want[:, -4:], rtol=0, atol=1e-6)
        assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("c_in,c_out,is_last,use_snake", [(8, 16, False, False),
                                                          (16, 16, False, True),
                                                          (16, 2, True, False)])
def test_res_conv_block_matches_jax(c_in, c_out, is_last, use_snake):
    """ResConvBlock: tanh GELU (or Snake), flax's one-group GroupNorm at eps
    1e-6 (an input far from zero mean, where eps and the statistics show),
    the skip conv where the width changes."""
    x = (np.random.RandomState(1).randn(2, 40, c_in) * 3 + 1.5).astype(np.float32)
    kw = dict(c_in=c_in, c_mid=16, c_out=c_out, is_last=is_last, use_snake=use_snake)
    jm = jdd.ResConvBlock(**kw)
    params = _init(jm, x)
    tm = _port_module(tdd.ResConvBlock(**kw), params)
    want = jm.apply({"params": params}, jnp.asarray(x))
    assert _rel(tm(_t(x)), want) <= 1e-5


def test_flash_plain_matches_pallas_at_head_dim_32(monkeypatch):
    """The plain K7 (serving, and with its LSE) against the JAX package's
    `_flash_forward` in interpret mode at [2, 1024, 32]: rel-L2 <= 1e-5."""
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    q, k, v = (np.random.RandomState(s).randn(2, 1024, 32).astype(np.float32) for s in range(3))
    want, want_lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False,
                                        jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                        save_stats=True)
    before = tflash.serving_launches, tflash.forward_launches
    out, _ = tflash.flash_forward(_t(q), _t(k), _t(v), save_stats=False)
    out_lse, lse = tflash.flash_forward(_t(q), _t(k), _t(v))
    assert (tflash.serving_launches, tflash.forward_launches) == before  # CPU: no launch
    assert _rel(out, want) <= 1e-5 and _rel(out_lse, want) <= 1e-5
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :1024, 0], rtol=0, atol=1e-5)


def test_self_attention_takes_the_kernel_route_at_1024_tokens(monkeypatch):
    """SelfAttention1d at 64 channels (2 heads of 32) over 1024 tokens with
    the gate forced on both sides: the port's flash route (the plain K7 on
    CPU tensors) against JAX's Pallas `_flash_forward` in interpret mode."""
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("FSAT_DISABLE_PALLAS_ATTN", raising=False)
    routes = []
    monkeypatch.setattr(tattention, "uses_kernels", lambda x: True)
    real = tflash.flash_forward
    monkeypatch.setattr(tflash, "flash_forward",
                        lambda *a, **k: routes.append(a[0].shape) or real(*a, **k))
    x = np.random.RandomState(2).randn(1, 1024, 64).astype(np.float32)
    jm = jdd.SelfAttention1d(64, 2)
    params = _init(jm, x)
    tm = _port_module(tdd.SelfAttention1d(64, 2), params)
    with torch.no_grad():
        got = tm(_t(x))
    assert routes == [(2, 1024, 32)]
    assert _rel(got, jm.apply({"params": params}, jnp.asarray(x))) <= 1e-5


def test_flash_route_under_grad_trains_at_head_dim_32_and_raises_at_unported_ones():
    """On CUDA tensors (here meta tensors, which reach the same checks) a
    training call at a head dim that no backward kernel takes (48 for K8 at
    T 1024, 96 for K9 at T 8192, 32 for the causal K9) raises, naming queue
    B, before K7 runs; head dim 32 passes the check for K8 (T 1024) and K9
    (T 8192), as 64 does."""
    before = (tflash.forward_launches, tflash.d32_launches, tflash.causal_forward_launches)
    for (t, d, causal), kernel in (((1024, 48, False), "K8"), ((8192, 96, False), "K9"),
                                   ((1024, 32, True), "K9")):
        assert tflash.backward_kernel(t, t, d, causal) == kernel
        q = torch.empty(4, t, d, device="meta", requires_grad=True)
        with pytest.raises(NotImplementedError, match=f"{kernel} at head dim {d} .*queue B"):
            tflash.FlashAttention.apply(q, q, q, None, causal)
    assert (tflash.forward_launches, tflash.d32_launches,
            tflash.causal_forward_launches) == before
    for t, kernel in ((1024, "K8"), (8192, "K9")):
        assert tflash.backward_kernel(t, t, 32) == kernel
        tflash.check_backward_head_dim(t, t, 32)
        tflash.check_backward_head_dim(t, t, 64)


@pytest.mark.parametrize("extra,t", [({}, 64), ({"cond_dim": 3}, 64),
                                     ({"cond_dim": 3, "learned_resample": True, "use_snake": True},
                                      64)])
def test_unet_matches_jax(extra, t):
    """The whole DAU1d: plain, with a condition of another length (the JAX
    interpolation), and with learned resampling and Snake."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, t, 2).astype(np.float32)
    ts = np.array([0.3, 0.8], np.float32)
    jm = jdd.DiffusionAttnUnet1D(**DD, **extra)
    cond = rs.randn(2, t // 4, 3).astype(np.float32) if extra else None
    kw = {} if cond is None else {"cond": jnp.asarray(cond)}
    params = _init(jm, x, ts, **kw)
    tm = _port_module(tdd.DiffusionAttnUnet1D(**DD, **extra), params)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), **kw)
    with torch.no_grad():
        got = tm(_t(x), _t(ts), cond=None if cond is None else _t(cond))
    assert got.shape == (2, t, 2)
    assert _rel(got, want) <= 1e-5


def test_unet_cond_noise_aug_at_a_given_scale_matches_jax():
    """`cond_noise_aug` at an injected aug scale of 0: the aug level's
    Fourier features reuse `timestep_embed`'s weights."""
    rs = np.random.RandomState(4)
    x, cond = rs.randn(1, 32, 2).astype(np.float32), rs.randn(1, 32, 3).astype(np.float32)
    ts = np.array([0.5], np.float32)
    kw = dict(DD, cond_dim=3, cond_noise_aug=True)
    jm = jdd.DiffusionAttnUnet1D(**kw)
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     jnp.asarray(x), jnp.asarray(ts), cond=jnp.asarray(cond))["params"]
    tm = _port_module(tdd.DiffusionAttnUnet1D(**kw), params)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), cond=jnp.asarray(cond),
                    cond_aug_scale=0.0, rngs={"sample": jax.random.PRNGKey(2)})
    with torch.no_grad():
        got = tm(_t(x), _t(ts), cond=_t(cond), cond_aug_scale=0.0)
    assert _rel(got, want) <= 1e-5


def test_every_shipped_config_builds():
    """The four dance_diffusion/*.json on meta tensors: 223.2 M parameters
    at the base widths, every one initialised."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / (
        "friendly_stable_audio_tools_tpu/configs/model_configs/dance_diffusion")
    paths = sorted(root.glob("*.json"))
    assert len(paths) == 4
    for path in paths:
        with torch.device("meta"):
            model = create_diffusion_uncond_from_config(json.loads(path.read_text()))
        n = sum(p.numel() for p in model.parameters())
        assert n == 223_224_330, (path.name, n)
        assert model.io_channels == 2 and model.pretransform is None


# ---- generation and DDIM -------------------------------------------------------


def _jax_noise(seed, shape):
    k_noise, k_sampler = jax.random.split(jax.random.PRNGKey(seed))
    return _t(jax.random.normal(k_noise, shape, jnp.float32)), k_sampler


@pytest.mark.parametrize("sampler", ["k-euler", "dpmpp-3m-sde"])
def test_generation_matches_jax(models, sampler):
    config, jmodel, model = models
    steps, shape = 4, (2, SAMPLE_SIZE, 2)
    kw = dict(sampler_type=sampler, sigma_min=0.3, sigma_max=50)
    want = jax_generate(jmodel, steps=steps, batch_size=2, sample_size=SAMPLE_SIZE, seed=5, **kw)
    noise, k_sampler = _jax_noise(5, shape)
    step_noise, _ = jax_draws(sampler, k_sampler, steps, shape)
    got = generate_diffusion_uncond(model, steps=steps, batch_size=2, sample_size=SAMPLE_SIZE,
                                    noise=noise, step_noise=step_noise, **kw)
    assert got.shape == (2, 2, SAMPLE_SIZE) and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


def test_generation_from_init_audio_matches_jax(models):
    """A variation of 1.5 s of 22.05 kHz mono audio (resampled to 16 kHz,
    duplicated to stereo, cropped) at init_noise_level 3."""
    config, jmodel, model = models
    audio = (0.3 * np.sin(np.arange(33075) / 7.0)).astype(np.float32)
    kw = dict(sampler_type="k-euler", sigma_min=0.3, init_noise_level=3.0)
    want = jax_generate(jmodel, steps=3, batch_size=1, sample_size=SAMPLE_SIZE, seed=2,
                        init_audio=(22050, audio), **kw)
    noise, _ = _jax_noise(2, (1, SAMPLE_SIZE, 2))
    got = generate_diffusion_uncond(model, steps=3, batch_size=1, sample_size=SAMPLE_SIZE,
                                    noise=noise, init_audio=(22050, audio), **kw)
    assert _rel(got, want) <= 1e-4


def test_rectified_flow_generation_matches_jax(models):
    """A rectified-flow objective samples with `sample_rf`, the k-sampler
    keyword arguments dropped (JAX :118-122)."""
    config, jmodel, model = models
    jm, tm = copy.copy(jmodel), copy.copy(model)
    jm.diffusion_objective = tm.diffusion_objective = "rectified_flow"
    kw = dict(sampler_type="dpmpp-3m-sde", sigma_min=0.3, sigma_max=1.0)
    want = jax_generate(jm, steps=4, batch_size=1, sample_size=SAMPLE_SIZE, seed=7, **kw)
    noise, _ = _jax_noise(7, (1, SAMPLE_SIZE, 2))
    got = generate_diffusion_uncond(tm, steps=4, batch_size=1, sample_size=SAMPLE_SIZE,
                                    noise=noise, **kw)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_ddim_matches_jax(models, eta):
    """DDIM over the tiny U-Net, 5 steps, eta 0 and 0.7 with JAX's per-step
    draws injected; the step hook once per step."""
    config, jmodel, model = models
    rs = np.random.RandomState(9)
    x = rs.randn(2, 64, 2).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    want = jsampling.sample(lambda a, t: jmodel.forward(jmodel.params, a, t), jnp.asarray(x), 5,
                            eta, rng=rng)
    noise = [_t(jax.random.normal(k, x.shape, jnp.float32)) for k in jax.random.split(rng, 5)]
    seen = []
    with torch.no_grad():
        got = tsampling.sample(model.model, _t(x), 5, eta, noise=noise,
                               callback=lambda info: seen.append(info["i"]))
    assert seen == list(range(5))
    assert _rel(got, want) <= 1e-4


# ---- training --------------------------------------------------------------------


def _jax_grads(wrapper, batch, key):
    """(loss, gradient tree) of the JAX wrapper's own train_step: its
    optimizer replaced by a scale of 1e4, so the update is 1e4 x the
    gradient and the gradient (new - old) / 1e4."""
    wrapper.tx = optax.scale(1e4)
    state = wrapper.init_state()
    new, metrics = jax.jit(wrapper.train_step)(state, batch, key)
    grads = jax.tree_util.tree_map(lambda a, b: (np.asarray(a) - np.asarray(b)) / 1e4,
                                   new.params, state.params)
    return float(metrics["loss"]), grads


def _check_grads(named, grad_sd, tol=1e-4):
    """Every port gradient within `tol` of its largest entry of the JAX one."""
    for name, p in named:
        want = grad_sd[name].numpy()
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= tol * max(np.abs(want).max(), 1e-12), (name, err, np.abs(want).max())


def test_train_step_matches_jax(models):
    """One `diffusion_uncond` step at batch 2: the loss to 1e-5, every
    gradient to 1e-4 of its largest entry, with JAX's timesteps and noise."""
    config, jmodel, model = models
    model = copy.deepcopy(model)
    reals = (0.1 * np.random.RandomState(0).randn(2, 2, SAMPLE_SIZE)).astype(np.float32)
    jw = jax_wrapper(config, jmodel)
    batch = jw.prepare_batch(reals)
    key = jax.random.PRNGKey(11)
    loss_j, grads = _jax_grads(jw, batch, key)
    k_t, k_noise = jax.random.split(key)
    t = _t(jdiff.draw_timesteps("uniform", 2, jnp.zeros((), jnp.uint32), k_t))
    noise = _t(jax.random.normal(k_noise, (2, SAMPLE_SIZE, 2), jnp.float32))
    w = create_training_wrapper_from_config(config, model)
    loss, metrics = w.loss(_t(reals).transpose(1, 2), [{}, {}], 0, {"t": t, "noise": noise})
    loss.backward()
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    _check_grads(model.model.named_parameters(), state_dict_from_jax(grads["model"]))
    assert math.isfinite(w.train_step(_t(reals).transpose(1, 2), [{}, {}])["loss"])


# a DAU1d whose attention level sees 1024 tokens: depth 2, channels [32, 64]
# (level 2 runs 2 heads of 32, its last attention 1 head of 32)
DD_FLASH = {"io_channels": 2, "depth": 2, "n_attn_layers": 1, "channels": [32, 64],
            "strides": [2]}
FLASH_SAMPLE_SIZE = 2048


def test_train_step_through_flash_attention_at_head_dim_32_matches_jax(monkeypatch):
    """One `diffusion_uncond` step at batch 2 and 2048 samples with the
    kernel route forced on CPU tensors: each of level 2's six attentions
    (1024 tokens, heads of 32) goes through ``FlashAttention`` (the plain
    K7 with its LSE, then the plain K8: its plan fits at T 1024). The loss
    to 1e-5, every gradient to 1e-4 of its largest entry, against the JAX
    wrapper's train step with its timesteps and noise."""
    config = {**tiny_dd_config(**DD_FLASH), "sample_size": FLASH_SAMPLE_SIZE}
    config["model"]["config"] = dict(DD_FLASH)
    jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    model = create_model_from_config(config, device="cpu")
    model.load_state_dict(convert_diffusion_uncond(jmodel.params), strict=True)
    reals = (0.1 * np.random.RandomState(5).randn(2, 2, FLASH_SAMPLE_SIZE)).astype(np.float32)
    jw = jax_wrapper(config, jmodel)
    key = jax.random.PRNGKey(13)
    loss_j, grads = _jax_grads(jw, jw.prepare_batch(reals), key)
    k_t, k_noise = jax.random.split(key)
    t = _t(jdiff.draw_timesteps("uniform", 2, jnp.zeros((), jnp.uint32), k_t))
    noise = _t(jax.random.normal(k_noise, (2, FLASH_SAMPLE_SIZE, 2), jnp.float32))

    monkeypatch.setattr(tattention, "uses_kernels", lambda x: True)
    calls = []
    for name in ("flash_forward", "flash_backward_fused", "flash_backward"):
        real = getattr(tflash, name)
        monkeypatch.setattr(tflash, name, lambda *a, _n=name, _f=real, **k: (
            calls.append((_n, tuple(a[0].shape))) or _f(*a, **k)))
    w = create_training_wrapper_from_config(config, model)
    loss, _ = w.loss(_t(reals).transpose(1, 2), [{}, {}], 0, {"t": t, "noise": noise})
    loss.backward()
    shapes = [(4, 1024, 32)] * 5 + [(2, 1024, 32)]
    assert calls == ([("flash_forward", s) for s in shapes]
                     + [("flash_backward_fused", s) for s in reversed(shapes)])
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    _check_grads(model.model.named_parameters(), state_dict_from_jax(grads["model"]))
