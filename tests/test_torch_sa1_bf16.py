"""The torch port's Stable Audio 1.0 slice in bench.py's bf16 recipe, and
K7's online form past 8192 keys, against the JAX package.

Inputs and weights come from numpy with fixed seeds, or from the JAX
package's initialisers carried over by utils/convert.py; bf16 values are
rounded once and handed to both sides. On the CPU the port's wrappers run
their plain versions; the JAX side runs its Pallas kernels in interpret mode
(FSAT_PALLAS_INTERPRET=1) where a test says so.

* bf16 K7 (serving): its plain version against `_flash_forward(save_stats=
  False)` in bf16, D 64 and 80, T 300 with kv_len 290 and T 1024. Both take
  one whole-row softmax with q prescaled in fp32 and rounded to bf16, and P
  rounded to bf16 before P.V; the scores' fp32 sums run in another order, so
  a probability or an output may land one bf16 step apart: rel-L2 <= 4e-3
  (2^-8) and max abs <= 2^-6 of max|out|.
* K7's online form: the JAX package's `SINGLE_DOT_MAX_TK` and the port's
  `LONG_MAX_T` monkeypatched to 1024, so that T 2304 takes the JAX
  `_online_kernel` (interpret mode, 512-key blocks) and the port's split
  route (rope outside, K7 with kv_len); with and without a kv_len, in fp32
  (rel-L2 <= 1e-5: summation order and the online rescaling only) and bf16
  (rel-L2 <= 1e-2, max abs <= 2^-5 of max|out|: P rounded to bf16 against
  each block's running max on the JAX side, once against the row max here).
* GroupNorm in bf16: the port's module on bf16 weights and input against
  flax's GroupNorm on the same (both normalise in fp32 and round once):
  rel-L2 <= 4e-3, max abs <= one bf16 step (2^-7) of max|out|.
* A small `UNetCFG1d` (levels at T 1024 with heads of 64 and 80, so the
  gate admits both; the port forced onto the kernel route by monkeypatching
  `uses_kernels`, the JAX side on its XLA attention) with bf16 weights and a
  bf16 input, with a context mask, without CFG and with CFG 7 and rescale,
  against the JAX U-Net on the same bf16 weights and input. The port runs in
  bf16 throughout (5 gated self-attentions in bf16), while the JAX module
  promotes its stream to fp32 at the first FiLM (ROADMAP queue C), so the
  two differ by the port's activation roundings: ~40 bf16 rounding sites of
  2^-9 RMS each, sqrt(40) x 2^-9 ~ 1.2e-2, hence rel-L2 <= 1.5e-2 without
  CFG; CFG 7 scales the difference of the two halves, whose rounding errors
  are independent, by 7 (~9x the error in quadrature with the null half's),
  hence rel-L2 <= 8e-2 with it. Both stay fp32 against fp32 at 1e-5
  (tests/test_torch_sa1.py).
* The DAC decoder with bf16 weights on a bf16 input against the JAX one
  (interpret mode: the Pallas K2/K4 in bf16, the same rounding points as
  the plain versions): rel-L2 <= 2e-2, the fp32 tolerance of the Oobleck
  decode ([4] of chip_smoke: bf16 through every layer).
* The whole slice in the recipe: Stable Audio 1.0's config at narrow widths,
  U-Net and VAE in bf16 (`model_half`), 2 dpmpp-3m-sde steps at CFG 7 with
  the JAX sampler's noise injected, against the JAX side built as bench.py
  builds it (bf16 parameters, the U-Net's input cast to bf16 at the call,
  the VAE decoding in bf16): rel-L2 <= 8e-2, the U-Net's bound at CFG 7
  (each step's denoised estimate is the U-Net's output; the decode adds the
  DAC's 2e-2 in quadrature).
* A bf16 CPU tensor launches nothing: the wrappers run their plain versions.
"""

import copy
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu.inference.sampling import sample_k as jax_sample_k
from friendly_stable_audio_tools_tpu.models import adp as jadp
from friendly_stable_audio_tools_tpu.models import dac_codec as jdac
from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.ops import embeddings as jemb
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
from friendly_stable_audio_tools_tpu_torch.models import adp as tadp
from friendly_stable_audio_tools_tpu_torch.models import dac_codec as tdac
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.ops import attention as tattention
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d as tconv
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash
from friendly_stable_audio_tools_tpu_torch.utils.convert import (
    convert_conditioned_diffusion,
    state_dict_from_jax,
)
from tests.test_torch_sa1 import CONDITIONING, LATENTS, RATIO, SEED, UNET, tiny_sa1_config

BF16 = torch.bfloat16


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")


def _bf16(a):
    """numpy fp32 -> the same bf16 values as (numpy fp32, torch bf16)."""
    t = torch.tensor(np.asarray(a, np.float32)).to(BF16)
    return t.float().numpy(), t


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.astype(jnp.float32) if isinstance(want, jax.Array) else want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _max_frac(got, want):
    """max |got - want| as a fraction of max |want|."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.astype(jnp.float32) if isinstance(want, jax.Array) else want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _launches():
    return (tflash.serving_bf16_launches, tflash.serving_launches, tflash.forward_launches,
            tattn.launches, tattn.long_launches, tconv.snake_conv1d_launches,
            tconv.snake_conv_transpose1d_launches)


def _to_bf16(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)


# ---------------------------------------------------------------------------
# bf16 K7 and its online form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bh,t,d,kv", [(3, 300, 80, 290), (2, 300, 64, 290), (2, 1024, 64, None),
                                       (2, 1024, 80, None)])
def test_flash_forward_bf16_plain_matches_pallas(interpret, bh, t, d, kv):
    rng = np.random.RandomState(t + d)
    (q, tq), (k, tk), (v, tv) = (_bf16(rng.randn(bh, t, d)) for _ in range(3))
    want = jfa._flash_forward(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), False,
                              jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K, save_stats=False,
                              kv_len=kv)
    before = _launches()
    out, lse = tflash.flash_forward(tq, tk, tv, kv, save_stats=False)
    assert _launches() == before  # CPU tensors launch nothing
    assert lse is None and out.dtype == BF16 and out.shape == (bh, t, d)
    assert _rel(out, want) <= 4e-3
    assert _max_frac(out, want) <= 2.0 ** -6


@pytest.mark.parametrize("dtype,kv", [("float32", None), ("float32", 2250), ("bfloat16", None),
                                      ("bfloat16", 2250)])
def test_online_k7_beyond_the_single_dot_matches_jax(interpret, monkeypatch, dtype, kv):
    """The DiT's self-attention past the long route without grad: the port's
    split route against the JAX `fused_qkv_rope_attention` (unpadded: rope
    outside in `flash_attention(freqs=...)`) or the JAX transformer's split
    path (padded, kv_len: rope outside, then `flash_attention(kv_len=...)`),
    both reaching `_online_kernel`."""
    monkeypatch.setattr(jfa, "SINGLE_DOT_MAX_TK", 1024)
    monkeypatch.setattr(tattn, "LONG_MAX_T", 1024)
    online = []
    real_online = jfa._online_kernel
    monkeypatch.setattr(jfa, "_online_kernel",
                        lambda *a, **kw: online.append(kw) or real_online(*a, **kw))
    b, h, t, d = 1, 2, 2304, 64
    assert tattn.attention_route(t) == "flash"
    rng = np.random.RandomState(23 + (kv or 0))
    qkv = rng.randn(b, t, 3 * h * d).astype(np.float32) * 0.5
    if dtype == "bfloat16":
        qkv, tqkv = _bf16(qkv)
    else:
        tqkv = torch.tensor(qkv)
    jdt = jnp.dtype(dtype)
    freqs = np.asarray(jemb.rotary_freqs(t, 32))
    jqkv = jnp.asarray(qkv, jdt)
    if kv is None:
        want = jfa.fused_qkv_rope_attention(jqkv, jnp.asarray(freqs), h)
    else:
        q, k, v = (x.reshape(b, t, h, d).transpose(0, 2, 1, 3) for x in jnp.split(jqkv, 3, -1))
        q, k = (jemb.apply_rotary_pos_emb(x, jnp.asarray(freqs)) for x in (q, k))
        want = jfa.flash_attention(q, k, v, kv_len=kv).transpose(0, 2, 1, 3).reshape(b, t, h * d)
    assert online and online[0]["kv_len"] == (kv or t)
    before = _launches()
    with torch.no_grad():
        got = tattn.fused_qkv_rope_attention(tqkv, torch.tensor(freqs), h, kv_len=kv)
    assert _launches() == before
    assert got.dtype == tqkv.dtype and got.shape == (b, t, h * d)
    if dtype == "float32":
        assert _rel(got, want) <= 1e-5
    else:
        assert _rel(got, want) <= 1e-2
        assert _max_frac(got, want) <= 2.0 ** -5


# ---------------------------------------------------------------------------
# the U-Net and the DAC decoder in bf16
# ---------------------------------------------------------------------------


def test_group_norm_bf16_matches_flax():
    rng = np.random.RandomState(4)
    x, tx = _bf16(rng.randn(2, 300, 64) * 3 + 1)
    (scale, tscale), (bias, tbias) = _bf16(rng.randn(64)), _bf16(rng.randn(64) * 0.1)
    params = {"scale": jnp.asarray(scale, jnp.bfloat16), "bias": jnp.asarray(bias, jnp.bfloat16)}
    want = fnn.GroupNorm(num_groups=16, epsilon=1e-5).apply({"params": params},
                                                            jnp.asarray(x, jnp.bfloat16))
    gn = tadp.GroupNorm(16, 64, 1e-5)
    gn.load_state_dict({"scale": tscale, "bias": tbias})
    gn.to(BF16)
    with torch.no_grad():
        got = gn(tx)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert _rel(got, want) <= 4e-3
    assert _max_frac(got, want) <= 2.0 ** -7


UNET_BF16 = dict(UNET, factors=[1, 1])  # level 1 and the bottleneck at T 1024 in heads of 80


@pytest.mark.parametrize("scale,tol", [(1.0, 1.5e-2), (7.0, 8e-2)])
def test_unet_cfg_bf16_matches_jax(monkeypatch, scale, tol):
    rng = np.random.RandomState(8)
    x = rng.randn(1, 1024, 8).astype(np.float32)
    t = np.array([0.37], np.float32)
    emb = rng.randn(1, 5, 24).astype(np.float32)
    mask = np.array([[True, True, True, False, True]])
    jm = jadp.UNetCFG1d(**UNET_BF16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(emb))["params"]
    params = dezero_params(params, seed=3)
    kw = dict(embedding_scale=scale, batch_cfg=True, rescale_cfg=True)
    apply = jax.jit(functools.partial(jm.apply, **kw))
    want16 = apply({"params": _to_bf16(params)}, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t),
                   jnp.asarray(emb), embedding_mask=jnp.asarray(mask))
    tm = tadp.UNetCFG1d(**UNET_BF16)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    tm.to(BF16)
    gated = []
    real_forward = tflash.flash_forward

    def spy(q, *a, **k):
        gated.append((q.dtype, q.shape[1], q.shape[2]))
        return real_forward(q, *a, **k)

    monkeypatch.setattr(tattention, "uses_kernels", lambda x: True)
    monkeypatch.setattr(tflash, "flash_forward", spy)
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(t), torch.tensor(emb),
                 embedding_mask=torch.tensor(mask), **kw)
    # the CFG combination runs in fp32; without it the U-Net's own bf16 comes out
    assert got.dtype == (BF16 if scale == 1.0 else torch.float32) and got.shape == (1, 1024, 8)
    assert sorted(gated) == [(BF16, 1024, 64)] * 2 + [(BF16, 1024, 80)] * 3
    assert torch.isfinite(got).all() and _rel(got, want16) <= tol


def test_dac_decoder_bf16_matches_jax(interpret):
    z = np.random.RandomState(6).randn(2, 24, 8).astype(np.float32)
    z16, tz = _bf16(z)
    jm = jdac.DACDecoderWrapper(latent_dim=8, out_channels=2, channels=128, rates=(4, 2))
    params = dezero_params(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(z))["params"], seed=1)
    want = jax.jit(jm.apply)({"params": _to_bf16(params)}, jnp.asarray(z16, jnp.bfloat16))
    tm = tdac.DACDecoderWrapper(latent_dim=8, out_channels=2, channels=128, rates=(4, 2))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    tm.to(BF16)
    before = _launches()
    with torch.no_grad():
        got = tm(tz)
    assert _launches() == before
    assert got.dtype == BF16 and got.shape == (2, 24 * 8, 2)
    assert _rel(got, want) <= 2e-2


# ---------------------------------------------------------------------------
# the whole slice in bench.py's recipe
# ---------------------------------------------------------------------------

STEPS = 2


def bench_recipe(model):
    """bench.py's bf16 recipe as chip_smoke.bench_recipe applies it: the
    backbone's and the VAE's weights in bf16, the VAE decoding in bf16."""
    model.model.to(BF16)
    model.pretransform.to(BF16)
    model.pretransform.model_half = True


@pytest.fixture(scope="module")
def jax_sa1_bf16():
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


def test_sa1_bf16_generation_matches_jax(jax_sa1_bf16, monkeypatch):
    config, jmodel, tmodel = jax_sa1_bf16
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    sampler = dict(sampler_type="dpmpp-3m-sde", sigma_min=0.3, sigma_max=500.0)
    # the JAX side as bench.py builds it (bench.py:157-173)
    common = jmodel.get_conditioning_inputs(jmodel.conditioner(CONDITIONING))
    k_noise, k_sampler = jax.random.split(jax.random.PRNGKey(SEED))
    noise = jax.random.normal(k_noise, (1, LATENTS, 8), jnp.float32)
    params16 = _to_bf16(jmodel.params)

    def model_fn(x, t, **kw):
        return jmodel.model_fn(params16, x.astype(jnp.bfloat16), t, **kw)

    latents = jax_sample_k(model_fn, noise, None, None, STEPS, rng=k_sampler, cfg_scale=7.0,
                           batch_cfg=True, rescale_cfg=True, scale_phi=0.0, **sampler, **common)
    monkeypatch.setattr(jmodel.pretransform, "model_half", True)
    want = jmodel.pretransform.decode_nwc(
        latents, params=_to_bf16(jmodel.pretransform.model.params)).transpose(0, 2, 1)
    # the JAX sampler's noise: the initial draw and the scan's per-step draws
    steps_noise = [np.asarray(jax.random.normal(jax.random.split(k)[1], noise.shape))
                   for k in jax.random.split(k_sampler, STEPS)]
    model = copy.deepcopy(tmodel)
    bench_recipe(model)
    before = _launches()
    got = generate_diffusion_cond(model, steps=STEPS, cfg_scale=7.0, conditioning=CONDITIONING,
                                  sample_size=LATENTS * RATIO, seed=SEED,
                                  noise=torch.tensor(np.asarray(noise)),
                                  step_noise=[torch.tensor(n) for n in steps_noise], **sampler)
    assert _launches() == before
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, 2, LATENTS * RATIO)
    assert np.abs(np.asarray(want)).max() > 1e-3 and torch.isfinite(got).all()
    assert _rel(got, want) <= 8e-2


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_bf16_cpu_tensors_launch_nothing(monkeypatch):
    """bf16 CPU tensors run the plain versions: K7 with and without its LSE,
    the gated attention, and the split route past the long one."""
    rng = np.random.RandomState(2)
    q, k, v = (_bf16(rng.randn(2, 1024, 80))[1] for _ in range(3))
    before = _launches()
    out, lse = tflash.flash_forward(q, k, v, save_stats=False)
    out_s, lse_s = tflash.flash_forward(q, k, v, save_stats=True)
    monkeypatch.setattr(tattention, "uses_kernels", lambda x: True)
    gated = tattention.scaled_dot_product_attention(q[None], k[None], v[None])
    monkeypatch.setattr(tattn, "PAIR_MAX_T", 256)
    monkeypatch.setattr(tattn, "LONG_MAX_T", 512)
    qkv = _bf16(rng.randn(1, 600, 3 * 64))[1]
    split = tattn.fused_qkv_rope_attention(qkv, torch.tensor(np.asarray(jemb.rotary_freqs(600, 32))),
                                           1)
    assert _launches() == before
    assert lse is None and lse_s.dtype == torch.float32
    assert out.dtype == out_s.dtype == gated.dtype == split.dtype == BF16
    assert torch.equal(out, out_s) and torch.equal(gated[0], out)
    assert math.isfinite(split.float().sum().item())
