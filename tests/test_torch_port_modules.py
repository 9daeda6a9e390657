"""The torch port's modules against the JAX package's, at small widths.

Each JAX module is initialised, de-zeroed (its zero-init output projections
would otherwise make the comparison vacuous, CLAUDE.md), converted with
friendly_stable_audio_tools_tpu_torch/utils/convert.py and loaded strictly
into the port's module; both then run on the same numpy inputs. Everything
is fp32 on the CPU. Tolerance 1e-4 absolute at unit output scale: fp32
rounding differs between XLA (at the fast tier's opt-level 0 or the full
suite's default pipeline) and PyTorch by ~1e-6 per op, and the deepest
stack here is a few dozen ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.inference.sampling import sample_k as jax_sample_k
from friendly_stable_audio_tools_tpu.models.autoencoders import OobleckDecoder as JOobleckDecoder
from friendly_stable_audio_tools_tpu.models.conditioners import NumberConditioner as JNumberConditioner
from friendly_stable_audio_tools_tpu.models.dit import DiffusionTransformer as JDiT
from friendly_stable_audio_tools_tpu.models.t5 import T5Config as JT5Config
from friendly_stable_audio_tools_tpu.models.t5 import T5Encoder as JT5Encoder
from friendly_stable_audio_tools_tpu.models.transformer import LayerNorm as JLayerNorm
from friendly_stable_audio_tools_tpu.ops import embeddings as jemb
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.inference.sampling import (
    get_sigmas_polyexponential,
    sample_k,
)
from friendly_stable_audio_tools_tpu_torch.models.autoencoders import OobleckDecoder
from friendly_stable_audio_tools_tpu_torch.models.conditioners import NumberConditioner
from friendly_stable_audio_tools_tpu_torch.models.dit import DiffusionTransformer
from friendly_stable_audio_tools_tpu_torch.models.t5 import T5Config, T5Encoder
from friendly_stable_audio_tools_tpu_torch.models.transformer import (
    ContinuousTransformer,
    seq_pad_length,
)
from friendly_stable_audio_tools_tpu_torch.ops import embeddings as temb
from friendly_stable_audio_tools_tpu_torch.ops.norms import LayerNorm
from friendly_stable_audio_tools_tpu_torch.utils.common import dezero_, init_weights_
from friendly_stable_audio_tools_tpu_torch.utils.convert import state_dict_from_jax

ATOL = 1e-4


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _load(module, jax_params, prefix=""):
    module.load_state_dict(state_dict_from_jax(jax_params, prefix), strict=True)
    return module.eval()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), atol=atol)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_rotary_tables_and_apply_match_jax():
    freqs = jemb.rotary_freqs(40, 32)
    np.testing.assert_allclose(temb.rotary_freqs(40, 32).numpy(), np.asarray(freqs), atol=1e-4)
    x = np.random.RandomState(0).randn(2, 3, 40, 64).astype(np.float32)
    _close(temb.apply_rotary_pos_emb(_t(x), _t(freqs)), jemb.apply_rotary_pos_emb(jnp.asarray(x), freqs))


def test_fourier_features_and_layernorm_match_jax():
    rng = np.random.RandomState(1)
    t = rng.rand(5, 1).astype(np.float32)
    jf = jemb.FourierFeatures(1, 256)
    p = jf.init(jax.random.PRNGKey(0), jnp.asarray(t))["params"]
    tf = _load(temb.FourierFeatures(1, 256), p)
    _close(tf(_t(t)), jf.apply({"params": p}, jnp.asarray(t)), atol=2e-4)

    x = rng.randn(3, 7, 32).astype(np.float32) * 3 + 1
    jl = JLayerNorm(32)
    p = dezero_params(jl.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], scale=0.3)
    _close(_load(LayerNorm(32), p)(_t(x)), jl.apply({"params": p}, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------

DIT_KW = dict(io_channels=16, embed_dim=256, depth=2, num_heads=4, cond_token_dim=128,
              global_cond_dim=256, transformer_type="continuous_transformer",
              global_cond_type="prepend")


@pytest.fixture(scope="module")
def dit_pair():
    jdit = JDiT(**DIT_KW)
    rng = np.random.RandomState(0)
    x = rng.randn(1, 24, 16).astype(np.float32)
    t = np.asarray([0.4], np.float32)
    cond = rng.randn(1, 10, 128).astype(np.float32)
    g = rng.randn(1, 256).astype(np.float32)
    params = jdit.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                       cross_attn_cond=jnp.asarray(cond), global_embed=jnp.asarray(g))["params"]
    params = dezero_params(params)
    tdit = _load(DiffusionTransformer(**DIT_KW), params)
    return jdit, params, tdit, (x, t, cond, g)


@pytest.mark.parametrize("cfg_scale,scale_phi", [(1.0, 0.0), (7.0, 0.0), (4.0, 0.75)])
def test_dit_forward_with_cfg_matches_jax(dit_pair, cfg_scale, scale_phi):
    jdit, params, tdit, (x, t, cond, g) = dit_pair
    want = jdit.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                      cross_attn_cond=jnp.asarray(cond), global_embed=jnp.asarray(g),
                      cfg_scale=cfg_scale, scale_phi=scale_phi)
    with torch.no_grad():
        got = tdit(_t(x), _t(t), cross_attn_cond=_t(cond), global_embed=_t(g),
                   cfg_scale=cfg_scale, scale_phi=scale_phi)
    assert np.abs(np.asarray(want)).max() > 0.1  # de-zeroed: the body is visible
    _close(got, want, atol=2e-4)


def test_dit_negative_conditioning_matches_jax(dit_pair):
    jdit, params, tdit, (x, t, cond, g) = dit_pair
    neg = np.random.RandomState(9).randn(*cond.shape).astype(np.float32)
    mask = np.ones(cond.shape[:2], bool)
    mask[:, 7:] = False
    want = jdit.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                      cross_attn_cond=jnp.asarray(cond), global_embed=jnp.asarray(g),
                      negative_cross_attn_cond=jnp.asarray(neg),
                      negative_cross_attn_mask=jnp.asarray(mask), cfg_scale=5.0)
    with torch.no_grad():
        got = tdit(_t(x), _t(t), cross_attn_cond=_t(cond), global_embed=_t(g),
                   negative_cross_attn_cond=_t(neg), negative_cross_attn_mask=torch.tensor(mask),
                   cfg_scale=5.0)
    _close(got, want, atol=2e-4)


def test_fresh_dit_init_is_input_independent_until_dezeroed():
    """The port's initialiser reproduces the zero-init branch outputs and
    residual convs: a fresh DiT's output ignores the transformer body."""
    tdit = init_weights_(DiffusionTransformer(**DIT_KW), torch.Generator().manual_seed(0))
    x = torch.randn(1, 24, 16)
    t = torch.full((1,), 0.3)
    cond_a, cond_b = torch.randn(1, 10, 128), torch.randn(1, 10, 128)
    with torch.no_grad():
        ya = tdit(x, t, cross_attn_cond=cond_a)
        yb = tdit(x, t, cross_attn_cond=cond_b)
        assert torch.equal(ya, yb)
        dezero_(tdit, torch.Generator().manual_seed(1))
        assert not torch.allclose(tdit(x, t, cross_attn_cond=cond_a),
                                  tdit(x, t, cross_attn_cond=cond_b))


def test_seq_pad_rule_matches_jax_rule():
    # SAO under CFG at batch 1 (B = 2): 1025 tokens, no padding; batch >= 4
    # pads to the 16-multiple 1040 (JAX transformer.py:554-579)
    assert seq_pad_length(1025, 2, 64, 24) is None
    assert seq_pad_length(1025, 4, 64, 24) == 1040
    assert seq_pad_length(6146, 2, 64, 24) == 6272
    assert seq_pad_length(1024, 4, 64, 24) is None
    assert seq_pad_length(500, 4, 64, 24) is None


def test_padded_sequence_path_matches_jax_unpadded():
    """kv_len path: at batch 4 the port pads 1025 tokens to 1040 and masks
    K/V at 1025; the JAX package on the CPU runs the same stack unpadded."""
    from friendly_stable_audio_tools_tpu.models.transformer import ContinuousTransformer as JCT

    rng = np.random.RandomState(6)
    x = rng.randn(4, 1024, 128).astype(np.float32) * 0.3
    prep = rng.randn(4, 1, 128).astype(np.float32) * 0.3
    jct = JCT(dim=128, depth=1, dim_heads=64)
    p = dezero_params(jct.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               prepend_embeds=jnp.asarray(prep))["params"])
    want = jct.apply({"params": p}, jnp.asarray(x), prepend_embeds=jnp.asarray(prep))
    tct = _load(ContinuousTransformer(dim=128, depth=1, dim_heads=64), p)
    assert seq_pad_length(1025, 4, 64, 2) == 1040
    with torch.no_grad():
        got = tct(_t(x), prepend_embeds=_t(prep))
    assert got.shape == (4, 1025, 128)
    _close(got, want)


# ---------------------------------------------------------------------------
# conditioners
# ---------------------------------------------------------------------------


def test_t5_encoder_matches_jax():
    kw = dict(vocab_size=100, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4)
    jt5 = JT5Encoder(JT5Config(**kw))
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 100, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, 5:] = False
    p = jt5.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"]
    want = jt5.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask))
    tt5 = _load(T5Encoder(T5Config(**kw)), p)
    with torch.no_grad():
        got = tt5(torch.tensor(ids, dtype=torch.long), torch.tensor(mask))
    _close(got, want, atol=2e-4)


def test_number_conditioner_matches_jax():
    jc = JNumberConditioner(64, min_val=0, max_val=512)
    jc.init(jax.random.PRNGKey(3))
    floats = [0.0, 47.0, 600.0]
    want_e, want_m = jc(floats)
    tc = _load(NumberConditioner(64, min_val=0, max_val=512), jc.params)
    with torch.no_grad():
        got_e, got_m = tc(floats)
    _close(got_e, want_e)
    assert got_m.numpy().tolist() == np.asarray(want_m).tolist()


# ---------------------------------------------------------------------------
# Oobleck decoder
# ---------------------------------------------------------------------------


def test_oobleck_decoder_matches_jax():
    kw = dict(out_channels=2, channels=8, latent_dim=16, c_mults=(1, 2), strides=(2, 4),
              use_snake=True, final_tanh=False)
    jdec = JOobleckDecoder(**kw)
    z = np.random.RandomState(4).randn(2, 12, 16).astype(np.float32)
    p = dezero_params(jdec.init(jax.random.PRNGKey(0), jnp.asarray(z))["params"], scale=0.2, damp=1.0)
    want = jdec.apply({"params": p}, jnp.asarray(z))
    tdec = _load(OobleckDecoder(**kw), p)
    with torch.no_grad():
        got = tdec(_t(z))
    assert got.shape == (2, 12 * 8, 2)
    _close(got, want, atol=2e-4)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def _jax_step_noise(key, steps, shape):
    """The per-step noise values of the JAX scan: split(key, steps), then
    (k_merge, k_noise) = split(step_key) (inference/sampling.py:557-590)."""
    keys = jax.random.split(key, steps)
    return [torch.tensor(np.asarray(jax.random.normal(jax.random.split(k)[1], shape, jnp.float32)))
            for k in keys]


@pytest.mark.parametrize("steps", [1, 2, 12])
def test_dpmpp_3m_sde_with_injected_noise_matches_jax(steps):
    shape = (2, 16, 4)

    def jmodel(x, t, **kw):
        return 0.3 * jnp.sin(x) + 0.2 * t[:, None, None]

    def tmodel(x, t, **kw):
        return 0.3 * torch.sin(x) + 0.2 * t[:, None, None]

    noise = jax.random.normal(jax.random.PRNGKey(7), shape, jnp.float32)
    key = jax.random.PRNGKey(11)
    want = jax_sample_k(jmodel, noise, steps=steps, sampler_type="dpmpp-3m-sde",
                        sigma_min=0.3, sigma_max=50.0, rng=key)
    got = sample_k(tmodel, _t(noise), steps=steps, sampler_type="dpmpp-3m-sde",
                   sigma_min=0.3, sigma_max=50.0, step_noise=_jax_step_noise(key, steps, shape))
    _close(got, want, atol=1e-4 * float(get_sigmas_polyexponential(steps, 0.3, 50.0)[0]))


def test_sampler_generator_draws_are_reproducible():
    def model(x, t, **kw):
        return 0.1 * x

    noise = torch.randn(1, 8, 4, generator=torch.Generator().manual_seed(0))
    a = sample_k(model, noise, steps=5, sigma_min=0.3, sigma_max=5.0,
                 generator=torch.Generator().manual_seed(3))
    b = sample_k(model, noise, steps=5, sigma_min=0.3, sigma_max=5.0,
                 generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    # every sampler of the JAX package runs; an unknown name raises as there
    heun = sample_k(model, noise, steps=5, sampler_type="k-heun", sigma_min=0.3, sigma_max=5.0)
    assert torch.isfinite(heun).all()
    with pytest.raises(ValueError, match="Unknown sampler type"):
        sample_k(model, noise, steps=5, sampler_type="k-nope")
