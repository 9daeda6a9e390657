"""The torch port's long-form slice (Stable Audio 2.0 text-to-audio) against
the JAX package.

* K10a/K10, the long-sequence pair attention (2048 < T <= 8192): their
  plain versions against `_pair_long` run in Pallas interpret mode
  (FSAT_PALLAS_INTERPRET=1, as tests/test_pallas_kernels.py runs it) and
  against the JAX rope, on inputs made with numpy. fp32 inputs agree to
  2e-3 (the JAX kernel rounds q, k, v and P to bf16 inside; the bound of the
  JAX package's own test); bf16 inputs to 2^-7 of the output's peak (one
  bf16 rounding of the output; both sides round q, k and P alike).
* The route by sequence length, and the padded-sequence rule at SA 2.0's
  6144 latent frames.
* The CLAP text conditioner at SA 2.0's full size, fed the same prompts,
  with the JAX package's weights carried over: 2e-4 absolute (fp32 sums in
  another order through 11 RoBERTa layers).
* Micro-batched VAE decode (`iterate_batch`) against the whole batch.
* The whole slice: SA 2.0's config at narrow widths (CLAP text conditioner
  at full size, a 2-layer DiT 128 wide with 2 heads of 64, a two-block
  Oobleck VAE), 2100 latent frames so that 2101 tokens pad to 2176 and take
  the long path, 2 dpmpp-3m-sde steps with the JAX sampler's noise
  injected, against the JAX package's fp32 XLA path and against its kernel
  path in interpret mode (FSAT_FUSED_ATTN=1, FSAT_FORCE_SEQ_PAD=1), which
  rounds the attention's operands to bf16: 1e-3 of the output's peak, as
  for SAO 1.0 (tests/test_torch_port_pipeline.py). Measured: 1e-6 and
  3e-5 of the peak.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.inference.generation import generate_diffusion_cond as jax_generate
from friendly_stable_audio_tools_tpu.models.conditioners import CLAPTextConditioner as JCLAPTextConditioner
from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.ops.embeddings import rotary_freqs as jax_rotary_freqs
from friendly_stable_audio_tools_tpu.ops.pallas import flash_attention as jfa
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
from friendly_stable_audio_tools_tpu_torch.models.conditioners import CLAPTextConditioner
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.models.pretransforms import create_pretransform_from_config
from friendly_stable_audio_tools_tpu_torch.models.transformer import seq_pad_length
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
from friendly_stable_audio_tools_tpu_torch.utils.common import init_weights_
from friendly_stable_audio_tools_tpu_torch.utils.convert import (
    convert_conditioned_diffusion,
    state_dict_from_jax,
)

REPO = Path(__file__).resolve().parents[1]
SA2_CONFIG = REPO / "friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio/stable_audio_2_0.json"
LATENTS = 2100  # + 1 prepended token = 2101, padded to 2176 (> 2048: the long path)
RATIO = 8
STEPS = 2
SEED = 77
CONDITIONING = [{"prompt": "A cool 80s glam rock song with driving drums", "seconds_start": 0,
                 "seconds_total": 285}]
KERNEL_ENV = {"FSAT_PALLAS_INTERPRET": "1", "FSAT_FUSED_ATTN": "1", "FSAT_FORCE_SEQ_PAD": "1"}


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _bf16_values(a):
    return _t(a, torch.bfloat16).float().numpy()


def _counts():
    return tattn.launches, tattn.rope_k_launches, tattn.long_launches


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")


# ---------------------------------------------------------------------------
# K10a + K10
# ---------------------------------------------------------------------------


def test_long_attention_plain_matches_pallas_pair_long(interpret):
    """b1 t2176 h2 (17 q blocks of 128), unpadded and with kv_len 2050 pre-padded."""
    rng = np.random.RandomState(19)
    b, t, h = 1, 2176, 2
    qkv = rng.randn(b, t, 3 * h * 64).astype(np.float32) * 0.3
    freqs = np.asarray(jax_rotary_freqs(t, 32))
    before = _counts()
    got = tattn.fused_qkv_rope_attention(_t(qkv), _t(freqs), h)
    want = np.asarray(jfa._pair_long(jnp.asarray(qkv), jnp.asarray(freqs), h))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)

    valid = 2050
    qkvp = np.pad(qkv[:, :valid], ((0, 0), (0, t - valid), (0, 0)))
    got = tattn.fused_qkv_rope_attention(_t(qkvp), _t(freqs), h, kv_len=valid)
    want = np.asarray(jfa._pair_long(jnp.asarray(qkvp), jnp.asarray(freqs), h, valid))
    np.testing.assert_allclose(got.numpy()[:, :valid], want[:, :valid], atol=2e-3)
    unpadded = tattn.fused_qkv_rope_attention_plain(_t(qkv[:, :valid]), _t(freqs[:valid]), h)
    np.testing.assert_allclose(got.numpy()[:, :valid], unpadded.numpy(), atol=1e-5)
    assert _counts() == before  # CPU tensors launch nothing


def test_long_attention_plain_bf16_matches_pallas_to_one_rounding(interpret):
    rng = np.random.RandomState(20)
    b, t, h, valid = 2, 2176, 2, 2101
    qkv = _bf16_values(rng.randn(b, t, 3 * h * 64))
    freqs = np.asarray(jax_rotary_freqs(t, 32))
    got = tattn.fused_qkv_rope_attention(_t(qkv, torch.bfloat16), _t(freqs), h, kv_len=valid)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jfa._pair_long(jnp.asarray(qkv), jnp.asarray(freqs), h, valid))
    peak = np.abs(want[:, :valid]).max()
    np.testing.assert_allclose(got.float().numpy()[:, :valid], want[:, :valid],
                               atol=2.0 ** -7 * peak)


def test_rope_pair_k_plain_matches_jax_rope():
    """K10a's plain version is the JAX rope of k (`_rope_outside`), in fp32
    and rounded to bf16 (at most one bf16 ulp apart, from fp32 rounding
    before the cast)."""
    rng = np.random.RandomState(21)
    b, t, h = 2, 300, 3
    qkv = rng.randn(b, t, 3 * h * 64).astype(np.float32)
    freqs = np.asarray(jax_rotary_freqs(t, 32))
    k = qkv[..., h * 64:2 * h * 64].reshape(b, t, h, 64).transpose(0, 2, 1, 3)
    want = np.asarray(jfa._rope_outside(jnp.asarray(k), jnp.asarray(freqs)))
    want = want.transpose(0, 2, 1, 3).reshape(b, t, h * 64)
    got = tattn.rope_pair_k(_t(qkv), _t(freqs), h)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    got_b = tattn.rope_pair_k(_t(qkv, torch.bfloat16), _t(freqs), h).float().numpy()
    want_b = _bf16_values(np.asarray(jfa._rope_outside(jnp.asarray(_bf16_values(k)),
                                                       jnp.asarray(freqs)))
                          .transpose(0, 2, 1, 3).reshape(b, t, h * 64))
    np.testing.assert_allclose(got_b, want_b, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("t,route", [(1025, "pair"), (2048, "pair"), (2049, "pair_long"),
                                     (6272, "pair_long"), (8192, "pair_long"), (8193, "flash")])
def test_attention_route_thresholds(t, route):
    """flash_attention.py:1413-1421: K1 to 2048 tokens, K10a + K10 to 8192."""
    assert tattn.attention_route(t) == route


def test_inference_forward_takes_the_route(monkeypatch):
    """Without grad, T = 2049 goes through the long path; T = 2048 and
    T = 8193 (K7's inference route, not wired) take the plain whole-sequence
    version on the CPU. Under grad, T = 2049 takes the unpack route's binding
    (K7 + K9, training_route), not the long path."""
    taken = []
    real_long = tattn.fused_qkv_rope_attention_long
    monkeypatch.setattr(tattn, "fused_qkv_rope_attention_long",
                        lambda *a, **kw: taken.append(a[0].shape[1]) or real_long(*a, **kw))
    rng = np.random.RandomState(22)
    for t in (2048, 2049, 8193):  # two heads of 64: the pair kernels' (an even count)
        qkv = _t(rng.randn(1, t, 3 * 2 * 64) * 0.3)
        f = _t(np.asarray(jax_rotary_freqs(t, 32)))
        got = tattn.fused_qkv_rope_attention(qkv, f, 2)
        torch.testing.assert_close(got, tattn.fused_qkv_rope_attention_plain(qkv, f, 2),
                                   rtol=0, atol=1e-6)
    assert taken == [2049]
    qkv = _t(rng.randn(1, 2049, 3 * 2 * 64)).requires_grad_(True)
    out = tattn.fused_qkv_rope_attention(qkv, _t(np.asarray(jax_rotary_freqs(2049, 32))), 2)
    assert "FusedQKVFlashAttention" in type(out.grad_fn).__name__ and taken == [2049]


def test_seq_pad_rule_at_sa2_length():
    """6144 latent frames + 1 prepended global token = 6145 tokens (DiT
    dit.py:152-161 of the JAX package); at CFG batch 2 the rule pads them to
    the 128-multiple 6272 with kv_len 6145 (2.07% of padding, under 4%)."""
    assert seq_pad_length(6145, 2, 64, 24) == 6272
    assert tattn.attention_route(6272) == "pair_long"
    assert seq_pad_length(LATENTS + 1, 2, 64, 2) == 2176


# ---------------------------------------------------------------------------
# iterate_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iterate_batch", [True, 2])
def test_iterate_batch_decode_and_encode_equal_the_whole_batch(iterate_batch):
    pt = copy.deepcopy(json.loads(SA2_CONFIG.read_text())["model"]["pretransform"])
    cfg = pt["config"]
    cfg.update(latent_dim=4, downsampling_ratio=RATIO)
    cfg["encoder"]["config"].update(channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=8)
    cfg["decoder"]["config"].update(channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=4)
    models = []
    for ib in (False, iterate_batch):
        pt["iterate_batch"] = ib
        m = init_weights_(create_pretransform_from_config(pt), torch.Generator().manual_seed(0))
        models.append(m)
    whole, micro = models
    assert micro.iterate_batch == iterate_batch
    z = torch.randn(3, 20, 4, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(micro.decode_nwc(z), whole.decode_nwc(z), rtol=0, atol=1e-6)
    x = torch.randn(3, 20 * RATIO, 2, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(micro.encode_nwc(x), whole.encode_nwc(x), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# CLAP conditioner at full size, and the whole slice
# ---------------------------------------------------------------------------


def tiny_longform_config():
    """SA 2.0's config at narrow widths; the CLAP conditioner stays full size
    (its features are projected 768 -> 128 here, where SA 2.0's 768-wide
    conditioning needs no projection)."""
    c = copy.deepcopy(json.loads(SA2_CONFIG.read_text()))
    c["sample_size"] = LATENTS * RATIO
    model = c["model"]
    model["io_channels"] = 16
    model["conditioning"]["cond_dim"] = 128
    model["diffusion"]["config"].update(io_channels=16, embed_dim=128, depth=2, num_heads=2,
                                        cond_token_dim=128, global_cond_dim=256)
    pt = model["pretransform"]["config"]
    pt.update(latent_dim=16, downsampling_ratio=RATIO)
    pt["encoder"]["config"].update(channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=32)
    pt["decoder"]["config"].update(channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=16)
    return c


@pytest.fixture(scope="module")
def jax_longform():
    """The JAX package's tiny long-form model (random, de-zeroed) and the
    port's model with its weights."""
    config = tiny_longform_config()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HF_HUB_OFFLINE", "1")  # the JAX tokenizer ladder would try the network
        jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.params = dezero_params(jmodel.params)
    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(convert_conditioned_diffusion(
        jmodel.params, jmodel.conditioner.params, jmodel.pretransform.model.params), strict=True)
    return config, jmodel, tmodel


def test_clap_conditioner_at_sa2_size_matches_jax(jax_longform, monkeypatch):
    """SA 2.0's prompt conditioner as configured (768-d features of RoBERTa
    layer -2, no projection), on the tiny model's CLAP weights."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    _, jmodel, _ = jax_longform
    kw = json.loads(SA2_CONFIG.read_text())["model"]["conditioning"]["configs"][0]["config"]
    jc = JCLAPTextConditioner(768, **kw)
    jc.params = {"clap": jmodel.conditioner.conditioners["prompt"].params["clap"]}
    tc = CLAPTextConditioner(768, **kw)
    tc.load_state_dict(state_dict_from_jax(jc.params), strict=True)
    assert tc.proj_out is None and not jc.has_proj_out
    prompts = [c["prompt"] for c in json.loads(SA2_CONFIG.read_text())["training"]["demo"]["demo_cond"]]
    want_e, want_m = jc(prompts)
    got_e, got_m = tc.eval()(prompts)
    assert got_e.shape == (3, 77, 768)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=2e-4)


def _jax_sampler_noise(shape):
    """The noise of the JAX `generate_diffusion_cond` for SEED: the initial
    draw and the scan's per-step draws (generation.py:215-217,
    sampling.py:557-590)."""
    k_noise, k_sampler = jax.random.split(jax.random.PRNGKey(SEED))
    noise = np.asarray(jax.random.normal(k_noise, shape))
    steps_noise = [np.asarray(jax.random.normal(jax.random.split(k)[1], shape))
                   for k in jax.random.split(k_sampler, STEPS)]
    return torch.tensor(noise), [torch.tensor(n) for n in steps_noise]


@pytest.mark.parametrize("jax_path", ["xla", "kernels"])
def test_longform_generation_matches_jax(jax_longform, monkeypatch, jax_path):
    config, jmodel, tmodel = jax_longform
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    if jax_path == "kernels":
        for k, v in KERNEL_ENV.items():
            monkeypatch.setenv(k, v)
    kw = dict(steps=STEPS, cfg_scale=7.0, conditioning=CONDITIONING,
              sample_size=LATENTS * RATIO, sampler_type="dpmpp-3m-sde", sigma_min=0.3,
              sigma_max=500.0, seed=SEED)
    want = np.asarray(jax_generate(jmodel, **kw))

    noise, step_noise = _jax_sampler_noise((1, LATENTS, 16))
    before = _counts()
    got = generate_diffusion_cond(tmodel, noise=noise, step_noise=step_noise, **kw).numpy()
    assert _counts() == before
    assert got.shape == want.shape == (1, 2, LATENTS * RATIO)
    peak = np.abs(want).max()
    assert peak > 1e-3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3 * peak)
