"""The torch port's Stable Audio 1.0 slice (text-to-audio through the ADP
U-Net and the DAC VAE) against the JAX package.

Inputs and weights come from numpy with fixed seeds, or from the JAX
package's initialisers carried over by utils/convert.py; everything is fp32.

* K7 for serving (no LSE) at head dims 64 and 80: its plain version against
  `_flash_forward(save_stats=False)` in Pallas interpret mode
  (FSAT_PALLAS_INTERPRET=1): rel-L2 <= 1e-5 (fp32 both sides, summation
  order only).
* The fp32 K2/K3/K4: their plain versions on fp32 inputs against the JAX
  functions on the same fp32 inputs, in interpret mode where the JAX gate
  admits its kernel (Cout 96 sends its K4 to XLA): rel-L2 <= 1e-5.
* The attention gate against the JAX condition, over a grid of lengths,
  head dims and masks, read off which path the JAX function takes.
* `IntConditioner` (exact), `Snake` (1e-6), the DAC decoder and encoder at
  small widths (rel-L2 <= 1e-5), and a small `UNetCFG1d` with a level at T
  1024 (head dim 64) and one at T 256 (head dim 80), CFG on, with a context
  mask (rel-L2 <= 1e-5).
* The whole slice: Stable Audio 1.0's config at narrow widths (the CLAP text
  conditioner at full size, two `int` conditioners, the ADP U-Net, the DAC
  VAE), 2 dpmpp-3m-sde steps with the JAX sampler's noise injected, against
  the JAX `generate_diffusion_cond`: rel-L2 <= 1e-4.
"""

import copy
import functools
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friendly_stable_audio_tools_tpu.ops.attention as jattention
import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu.inference.generation import generate_diffusion_cond as jax_generate
from friendly_stable_audio_tools_tpu.models import adp as jadp
from friendly_stable_audio_tools_tpu.models import dac_codec as jdac
from friendly_stable_audio_tools_tpu.models.conditioners import IntConditioner as JIntConditioner
from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.ops import activations as jact
from friendly_stable_audio_tools_tpu.ops.pallas import conv1d as jconv
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
from friendly_stable_audio_tools_tpu_torch.models import adp as tadp
from friendly_stable_audio_tools_tpu_torch.models import dac_codec as tdac
from friendly_stable_audio_tools_tpu_torch.models.conditioners import IntConditioner
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.ops import attention as tattention
from friendly_stable_audio_tools_tpu_torch.ops.activations import Snake
from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d as tconv
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash
from friendly_stable_audio_tools_tpu_torch.utils.convert import (
    convert_conditioned_diffusion,
    state_dict_from_jax,
)

REPO = Path(__file__).resolve().parents[1]
SA1_CONFIG = REPO / "friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio/stable_audio_1_0.json"


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _conv_launches():
    return (tconv.snake_conv1d_launches, tconv.fused_residual_unit_launches,
            tconv.snake_conv_transpose1d_launches, tconv.snake_conv1d_f32_launches,
            tconv.fused_residual_unit_f32_launches, tconv.snake_conv_transpose1d_f32_launches,
            tflash.forward_launches, tflash.serving_launches)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------------------
# K7 for serving, and the gate that sends attention to it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bh,t,d", [(3, 300, 80), (2, 256, 64), (2, 1024, 80)])
def test_flash_forward_serving_plain_matches_pallas(interpret, bh, t, d):
    rng = np.random.RandomState(t + d)
    q, k, v = (rng.randn(bh, t, d).astype(np.float32) for _ in range(3))
    want = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False,
                              jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K, save_stats=False)
    before = _conv_launches()
    out, lse = tflash.flash_forward(_t(q), _t(k), _t(v), save_stats=False)
    assert _conv_launches() == before  # CPU tensors launch nothing
    assert lse is None and out.shape == (bh, t, d) and out.dtype == torch.float32
    assert _rel(out, want) <= 1e-5


GATE_GRID = [(tq, tk, d, masked) for tq in (512, 1023, 1024, 4096) for tk in (79, 511, 512, 1024)
             for d in (64, 80, 128, 160) for masked in (False, True)]


def test_flash_gate_matches_the_jax_condition(monkeypatch):
    """The JAX `scaled_dot_product_attention` on an accelerator backend, its
    two paths replaced by recorders, against `flash_gate` over the grid."""
    taken = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("FSAT_DISABLE_PALLAS_ATTN", raising=False)
    monkeypatch.delenv("FSAT_PALLAS_CROSS", raising=False)
    monkeypatch.setattr(jfa, "flash_attention", lambda q, *a, **kw: taken.append("flash") or q)
    monkeypatch.setattr(jattention, "_xla_attention", lambda q, *a, **kw: taken.append("xla") or q)
    for tq, tk, d, masked in GATE_GRID:
        q = jnp.zeros((1, 1, tq, d))
        kv = jnp.zeros((1, 1, tk, d))
        mask = jnp.ones((1, 1, tq, tk), bool) if masked else None
        jattention.scaled_dot_product_attention(q, kv, kv, mask=mask)
        assert (taken.pop() == "flash") == tattention.flash_gate(tq, tk, d, masked), (tq, tk, d, masked)


def test_sdpa_on_cpu_is_the_plain_attention():
    rng = np.random.RandomState(3)
    q, k, v = (_t(rng.randn(1, 2, 1024, 80)) for _ in range(3))
    assert tattention.flash_gate(1024, 1024, 80, False)
    before = tflash.serving_launches
    got = tattention.scaled_dot_product_attention(q, k, v)
    assert tflash.serving_launches == before
    want = jattention._xla_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    assert _rel(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# K2, K3, K4 in fp32
# ---------------------------------------------------------------------------


def _snake_params(rng, c):
    return ((np.abs(rng.randn(c)) + 0.5).astype(np.float32),
            (np.abs(rng.randn(c)) + 0.5).astype(np.float32))


@pytest.mark.parametrize("t,cin,cout,k,d,use_snake", [(300, 64, 96, 7, 3, True),
                                                      (256, 96, 96, 1, 1, False),
                                                      (260, 96, 2, 7, 1, False)])
def test_snake_conv1d_fp32_plain_matches_jax(interpret, t, cin, cout, k, d, use_snake):
    rng = np.random.RandomState(t + cout)
    x = rng.randn(2, t, cin).astype(np.float32) * 0.5
    w = rng.randn(k, cin, cout).astype(np.float32) / math.sqrt(k * cin)
    b = rng.randn(cout).astype(np.float32) * 0.1
    a, ib = _snake_params(rng, cin) if use_snake else (None, None)
    j = [None if v is None else jnp.asarray(v) for v in (a, ib)]
    want = jconv.snake_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), *j, dilation=d,
                              block_t=128)
    got = tconv.snake_conv1d(_t(x), _t(w), _t(b), *(None if v is None else _t(v) for v in (a, ib)),
                             dilation=d)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("t,c,d", [(300, 96, 9), (256, 128, 1)])
def test_fused_residual_unit_fp32_plain_matches_jax(interpret, t, c, d):
    rng = np.random.RandomState(t + c + d)
    x = rng.randn(1, t, c).astype(np.float32) * 0.5
    w1 = rng.randn(7, c, c).astype(np.float32) / math.sqrt(7 * c)
    b1 = rng.randn(c).astype(np.float32) * 0.1
    w2 = rng.randn(c, c).astype(np.float32) / math.sqrt(c)
    b2 = rng.randn(c).astype(np.float32) * 0.1
    a1, ib1 = _snake_params(rng, c)
    a2, ib2 = _snake_params(rng, c)
    args = (x, w1, b1, a1, ib1, w2, b2, a2, ib2)
    want = jconv.fused_residual_unit(*(jnp.asarray(v) for v in args), dilation=d, block_t=128)
    got = tconv.fused_residual_unit(*(_t(v) for v in args), dilation=d)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("stride,cin,cout,t", [(4, 192, 96, 130), (8, 128, 128, 130)])
def test_snake_conv_transpose1d_fp32_plain_matches_jax(interpret, stride, cin, cout, t):
    rng = np.random.RandomState(stride + cout)
    x = rng.randn(2, t, cin).astype(np.float32) * 0.5
    w = rng.randn(2 * stride, cin, cout).astype(np.float32) / math.sqrt(2 * cin)
    b = rng.randn(cout).astype(np.float32) * 0.1
    for a, ib in (_snake_params(rng, cin), (None, None)):
        j = [None if v is None else jnp.asarray(v) for v in (a, ib)]
        want = jconv.snake_conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), *j,
                                            stride=stride, block_t=128)
        got = tconv.snake_conv_transpose1d(_t(x), _t(w), _t(b),
                                           *(None if v is None else _t(v) for v in (a, ib)),
                                           stride=stride)
        assert got.shape == (2, t * stride, cout)
        assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_int_conditioner_matches_jax_exactly():
    jc = JIntConditioner(16, min_val=3, max_val=40)
    jc.init(jax.random.PRNGKey(0))
    tc = IntConditioner(16, min_val=3, max_val=40)
    tc.load_state_dict(state_dict_from_jax(jc.params), strict=True)
    ints = [0, 3, 17, 40, 99]
    want_e, want_m = jc(ints)
    got_e, got_m = tc(ints)
    assert got_e.shape == (5, 1, 16) and got_m.dtype == torch.bool
    np.testing.assert_array_equal(got_e.detach().numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_snake_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 50, 12).astype(np.float32) * 3
    alpha = (np.abs(rng.randn(12)) + 0.2).astype(np.float32)
    want = jact.Snake(12).apply({"params": {"alpha": jnp.asarray(alpha)}}, jnp.asarray(x))
    m = Snake(12)
    m.load_state_dict({"alpha": _t(alpha)})
    np.testing.assert_allclose(m(_t(x)).detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _carried(module_j, inputs, seed):
    """Initialises a flax module, de-zeroes its parameters, and returns them
    with its output on `inputs`."""
    params = jax.jit(module_j.init)(jax.random.PRNGKey(seed), *inputs)["params"]
    params = dezero_params(params, seed=seed)
    return params, jax.jit(module_j.apply)({"params": params}, *inputs)


def test_dac_decoder_matches_jax():
    z = np.random.RandomState(6).randn(2, 24, 8).astype(np.float32)
    jm = jdac.DACDecoderWrapper(latent_dim=8, out_channels=2, channels=64, rates=(4, 2))
    params, want = _carried(jm, (jnp.asarray(z),), 1)
    tm = tdac.DACDecoderWrapper(latent_dim=8, out_channels=2, channels=64, rates=(4, 2))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm(_t(z))
    assert got.shape == (2, 24 * 8, 2)
    assert _rel(got, want) <= 1e-5


def test_dac_encoder_matches_jax():
    x = np.random.RandomState(7).randn(2, 192, 2).astype(np.float32) * 0.3
    jm = jdac.DACEncoderWrapper(in_channels=2, latent_dim=16, d_model=8, strides=(2, 4))
    params, want = _carried(jm, (jnp.asarray(x),), 2)
    tm = tdac.DACEncoderWrapper(in_channels=2, latent_dim=16, d_model=8, strides=(2, 4))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm(_t(x))
    assert got.shape == (2, 24, 16)
    assert _rel(got, want) <= 1e-5


UNET = dict(context_embedding_max_length=6, context_embedding_features=24, in_channels=8,
            channels=32, multipliers=[2, 4, 5], factors=[1, 4], num_blocks=[1, 1],
            attentions=[1, 1, 1], resnet_groups=16, attention_heads=2, attention_multiplier=2,
            use_skip_scale=True, use_context_time=True, kernel_multiplier_downsample=2)


def test_unet_cfg_matches_jax():
    """A small UNetCFG1d: level 0 at T 1024 with 128 channels in 2 heads of
    64 (the JAX gate's flash length), level 1 at T 256 with 160 channels in
    heads of 80; batch-doubled CFG with rescale and a context mask."""
    rng = np.random.RandomState(8)
    x = rng.randn(1, 1024, 8).astype(np.float32)
    t = np.array([0.37], np.float32)
    emb = rng.randn(1, 5, 24).astype(np.float32)
    mask = np.array([[True, True, True, False, True]])
    jm = jadp.UNetCFG1d(**UNET)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(emb))["params"]
    params = dezero_params(params, seed=3)
    kw = dict(embedding_scale=7.0, batch_cfg=True, rescale_cfg=True)
    want = jax.jit(functools.partial(jm.apply, **kw))(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb),
        embedding_mask=jnp.asarray(mask))
    tm = tadp.UNetCFG1d(**UNET)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm(_t(x), _t(t), _t(emb), embedding_mask=torch.tensor(mask), **kw)
        two_pass = tm(_t(x), _t(t), _t(emb), embedding_mask=torch.tensor(mask),
                      **dict(kw, batch_cfg=False))
    assert got.shape == (1, 1024, 8)
    assert _rel(got, want) <= 1e-5
    assert _rel(two_pass, want) <= 1e-5


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

LATENTS, RATIO, STEPS, SEED = 1024, 8, 2, 11
CONDITIONING = [{"prompt": "A grand orchestral arrangement with thunderous percussion",
                 "seconds_start": 12, "seconds_total": 95}]


def tiny_sa1_config():
    """Stable Audio 1.0's config at narrow widths: the CLAP text conditioner
    stays full size (its 768-d features projected to the 64-d conditioning),
    the `int` conditioners as configured, a three-level ADP U-Net (T 1024
    and 256), a two-block DAC VAE with a downsampling ratio of 8."""
    c = copy.deepcopy(json.loads(SA1_CONFIG.read_text()))
    c["sample_size"] = LATENTS * RATIO
    model = c["model"]
    model["io_channels"] = 8
    model["conditioning"]["cond_dim"] = 64
    model["diffusion"]["config"].update(
        in_channels=8, context_embedding_features=64, channels=32, resnet_groups=16,
        multipliers=[2, 4, 5], factors=[1, 4], num_blocks=[1, 1], attentions=[1, 1, 1],
        attention_heads=2, attention_multiplier=2)
    pt = model["pretransform"]["config"]
    pt.update(latent_dim=8, downsampling_ratio=RATIO)
    pt["encoder"]["config"].update(latent_dim=16, d_model=8, strides=[2, 4])
    pt["decoder"]["config"].update(latent_dim=8, channels=32, rates=[4, 2])
    return c


@pytest.fixture(scope="module")
def jax_sa1():
    """The JAX package's tiny SA 1.0 model (random, de-zeroed) and the port's
    model with its weights."""
    config = tiny_sa1_config()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HF_HUB_OFFLINE", "1")  # the JAX tokenizer ladder would try the network
        jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.params = dezero_params(jmodel.params)
    jmodel.pretransform.model.params = dezero_params(jmodel.pretransform.model.params, seed=1)
    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(convert_conditioned_diffusion(
        jmodel.params, jmodel.conditioner.params, jmodel.pretransform.model.params), strict=True)
    return config, jmodel, tmodel


def _jax_sampler_noise(shape):
    """The noise of the JAX `generate_diffusion_cond` for SEED: the initial
    draw and the scan's per-step draws (generation.py:215-217,
    sampling.py:557-590)."""
    k_noise, k_sampler = jax.random.split(jax.random.PRNGKey(SEED))
    noise = np.asarray(jax.random.normal(k_noise, shape))
    steps_noise = [np.asarray(jax.random.normal(jax.random.split(k)[1], shape))
                   for k in jax.random.split(k_sampler, STEPS)]
    return torch.tensor(noise), [torch.tensor(n) for n in steps_noise]


def test_sa1_encoder_matches_jax(jax_sa1):
    """The DAC encoder and VAE bottleneck of the slice's pretransform."""
    _, jmodel, tmodel = jax_sa1
    audio = np.random.RandomState(9).randn(1, 64 * RATIO, 2).astype(np.float32) * 0.3
    want = jmodel.pretransform.encode_nwc(jnp.asarray(audio))
    got = tmodel.pretransform.encode_nwc(_t(audio))
    assert got.shape == (1, 64, 8)
    assert _rel(got, want) <= 1e-5


def test_sa1_generation_matches_jax(jax_sa1, monkeypatch):
    config, jmodel, tmodel = jax_sa1
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    kw = dict(steps=STEPS, cfg_scale=7.0, conditioning=CONDITIONING, sample_size=LATENTS * RATIO,
              sampler_type="dpmpp-3m-sde", sigma_min=0.3, sigma_max=500.0, seed=SEED)
    want = np.asarray(jax_generate(jmodel, **kw))
    noise, step_noise = _jax_sampler_noise((1, LATENTS, 8))
    before = _conv_launches()
    got = generate_diffusion_cond(tmodel, noise=noise, step_noise=step_noise, **kw)
    assert _conv_launches() == before
    assert got.shape == want.shape == (1, 2, LATENTS * RATIO)
    assert np.abs(want).max() > 1e-3 and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
