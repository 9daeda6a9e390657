"""The torch port's diffusion autoencoder (models/autoencoders.py:
DiffusionAutoencoder, training/diffusion_autoencoder_trainer.py) and
mono-to-stereo prior (models/diffusion_prior.py,
training/diffusion_prior_trainer.py) against the JAX package.

Tiny models, built by the JAX package and converted into the port: a
diffusion autoencoder with a two-block Oobleck encoder (8 latent channels,
ratio 8) and a 2-layer DiT decoder taking the latents by input-concat (JAX
tests/test_training_other.py's layout, de-zeroed), and the prior on Dance
Diffusion's U-Net (depth 4, channels [32, 32, 64, 64], heads of 32) taking
the dual-mono source by input-concat. The JAX trainer's and sampler's draws
are recovered from their keys and injected. Everything is fp32 on the CPU;
tolerances as tests/test_torch_dance_diffusion.py's: a train step's loss to
1e-5 relative and every gradient to 1e-4 of its largest entry; the decode
and `stereoize` to 1e-4 rel-L2.

A diffusion autoencoder with a `DAU1d` decoder is held against JAX's DDIM
over the JAX U-Net with the latents as its `cond`: the JAX wrapper passes
`input_concat_cond`, which its DAU1d module does not take (ROADMAP queue
C), while the port maps it to `cond` as the reference's DAU1DCondWrapper
does.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.inference import sampling as jsampling
from friendly_stable_audio_tools_tpu.models import dance_diffusion as jdd
from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.training import diffusion as jdiff
from friendly_stable_audio_tools_tpu.training.factory import (
    create_training_wrapper_from_config as jax_wrapper,
)
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.training.factory import (
    create_training_wrapper_from_config,
)
from friendly_stable_audio_tools_tpu_torch.utils.convert import (
    convert_autoencoder,
    convert_conditioned_diffusion,
    convert_diffusion_autoencoder,
    state_dict_from_jax,
)
from tests.test_torch_dance_diffusion import DD, _check_grads, _jax_grads, _rel, _t

SAMPLE_SIZE = 256
ENCODER = {"type": "oobleck", "config": {"in_channels": 2, "channels": 8, "c_mults": [1, 2],
                                         "strides": [2, 4], "latent_dim": 8,
                                         "use_snake": True}}


def tiny_diffae_config(diffusion=None):
    return {
        "model_type": "diffusion_autoencoder", "sample_size": SAMPLE_SIZE, "sample_rate": 16000,
        "audio_channels": 2,
        "model": {
            "encoder": ENCODER,
            "diffusion": diffusion or {"type": "dit", "config": {
                "io_channels": 2, "embed_dim": 32, "depth": 2, "num_heads": 4,
                "input_concat_dim": 8, "transformer_type": "continuous_transformer",
                "global_cond_type": "prepend"}},
            "latent_dim": 8, "downsampling_ratio": 8, "io_channels": 2,
        },
        "training": {"learning_rate": 1e-4, "demo": {"demo_every": 2, "demo_steps": 2}},
    }


def tiny_prior_config():
    return {
        "model_type": "diffusion_prior", "sample_size": SAMPLE_SIZE, "sample_rate": 16000,
        "audio_channels": 2,
        "model": {
            "prior_type": "mono_stereo", "conditioning": None, "io_channels": 2,
            "diffusion": {"type": "DAU1d", "input_concat_ids": ["source"],
                          "config": {**DD, "cond_dim": 2}},
        },
        "training": {"learning_rate": 1e-4, "prior_type": "mono_stereo",
                     "demo": {"demo_every": 2, "demo_steps": 2, "num_demos": 1,
                              "demo_cfg_scales": [1]}},
    }


@pytest.fixture(scope="module")
def diffae():
    config = tiny_diffae_config()
    jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.diffusion.params = dezero_params(jmodel.diffusion.params)
    model = create_model_from_config(config, device="cpu")
    model.load_state_dict(convert_diffusion_autoencoder(jmodel.params, jmodel.diffusion.params),
                          strict=True)
    return config, jmodel, model


@pytest.fixture(scope="module")
def prior():
    config = tiny_prior_config()
    jmodel = jax_create(config, init_rng=jax.random.PRNGKey(1))
    model = create_model_from_config(config, device="cpu")
    model.load_state_dict(convert_conditioned_diffusion(jmodel.params), strict=True)
    return config, jmodel, model


def _reals(seed, b=2):
    return (0.1 * np.random.RandomState(seed).randn(b, 2, SAMPLE_SIZE)).astype(np.float32)


# ---- the diffusion autoencoder -------------------------------------------------------


def test_diffae_fresh_weights_are_halved_where_jax_halves_them():
    """A fresh model: the encoder and the diffusion backbone halved (JAX
    autoencoders.py:725-735, diffusion.py:59) against the same draws
    unhalved."""
    from friendly_stable_audio_tools_tpu_torch.models.autoencoders import create_diffAE_from_config
    from friendly_stable_audio_tools_tpu_torch.utils.common import init_weights_

    config = tiny_diffae_config()
    model = create_model_from_config(config, device="cpu", seed=4)
    raw = init_weights_(create_diffAE_from_config(config), torch.Generator().manual_seed(4))
    want = dict(raw.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    assert any(n.startswith("encoder.") for n in names)
    assert any(n.startswith("diffusion.model.") for n in names)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p, 0.5 * want[name], rtol=0, atol=0)


def test_diffae_encode_and_decode_match_jax(diffae):
    config, jmodel, model = diffae
    reals = _reals(0)
    want_z = jmodel.encode(jnp.asarray(reals))
    z = model.encode(_t(reals))
    assert z.shape == (2, 8, 32)
    assert _rel(z, want_z) <= 1e-5
    key = jax.random.PRNGKey(4)
    want = jmodel.decode(want_z, steps=3, rng=key)
    k_noise, _ = jax.random.split(key)
    noise = _t(jax.random.normal(k_noise, (2, SAMPLE_SIZE, 2), jnp.float32))
    got = model.decode(_t(want_z), steps=3, noise=noise)
    assert got.shape == (2, 2, SAMPLE_SIZE) and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


def test_diffae_train_step_matches_jax(diffae):
    """One step at batch 2: the encoder (trainable) and the DiT both get
    their gradients."""
    config, jmodel, model = diffae
    model = copy.deepcopy(model)
    reals = _reals(1)
    jw = jax_wrapper(config, jmodel)
    key = jax.random.PRNGKey(12)
    loss_j, grads = _jax_grads(jw, jw.prepare_batch(reals), key)
    k_t, k_noise, _ = jax.random.split(key, 3)
    t = _t(jdiff.draw_timesteps("uniform", 2, jnp.zeros((), jnp.uint32), k_t))
    noise = _t(jax.random.normal(k_noise, (2, SAMPLE_SIZE, 2), jnp.float32))
    w = create_training_wrapper_from_config(config, model)
    loss, metrics = w.loss(_t(reals).transpose(1, 2), None, 0, {"t": t, "noise": noise})
    loss.backward()
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    assert metrics["latent_std"] > 0
    want = convert_autoencoder(grads["ae"], "")
    want.update(state_dict_from_jax(grads["diffusion"], "diffusion.model."))
    _check_grads(((n, p) for n, p in model.named_parameters() if p.grad is not None), want)
    assert {n for n, p in model.named_parameters() if p.grad is not None} == set(want)
    assert math.isfinite(w.train_step(_t(reals).transpose(1, 2), [{}, {}])["loss"])


def test_diffae_with_a_dance_decoder_decodes_by_ddim():
    """A DAU1d decoder (`cond_dim` = latent dim, learned resampling, Snake):
    the port's decode against JAX's DDIM over the same U-Net with the
    nearest-upsampled latents as its `cond`."""
    unet = {**DD, "cond_dim": 8, "learned_resample": True, "use_snake": True}
    config = tiny_diffae_config({"type": "DAU1d", "config": unet})
    model = create_model_from_config(config, device="cpu", seed=2)
    assert model.diffusion_downsampling_ratio == 8 and model.min_length == 64
    jm = jdd.DiffusionAttnUnet1D(**unet)
    rs = np.random.RandomState(5)
    z = rs.randn(1, 8, 8).astype(np.float32)
    up = np.asarray(z).transpose(0, 2, 1)[:, (np.arange(64) * 8) // 64]
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 2)), jnp.zeros((1,)),
                     cond=jnp.asarray(up))["params"]
    model.diffusion.load_state_dict(state_dict_from_jax(params, "model."), strict=True)
    noise = rs.randn(1, 64, 2).astype(np.float32)
    want = jsampling.sample(lambda x, t: jm.apply({"params": params}, x, t, cond=jnp.asarray(up)),
                            jnp.asarray(noise), 3, 0)
    got = model.decode(_t(z), steps=3, noise=_t(noise))
    assert _rel(got.transpose(1, 2), want) <= 1e-4


# ---- the mono-to-stereo prior -------------------------------------------------------


def test_prior_train_step_matches_jax(prior):
    """One step at batch 2 from stereo reals: the dual-mono source built from
    the batch, the U-Net's gradients."""
    config, jmodel, model = prior
    model = copy.deepcopy(model)
    reals = _reals(2)
    jw = jax_wrapper(config, jmodel)
    key = jax.random.PRNGKey(13)
    loss_j, grads = _jax_grads(jw, jw.prepare_batch(reals, [{}, {}]), key)
    k_t, k_noise, _ = jax.random.split(key, 3)
    t = _t(jdiff.draw_timesteps("uniform", 2, jnp.zeros((), jnp.uint32), k_t))
    noise = _t(jax.random.normal(k_noise, (2, SAMPLE_SIZE, 2), jnp.float32))
    w = create_training_wrapper_from_config(config, model)
    assert w.cfg_dropout_prob == 0.0
    loss, _ = w.loss(_t(reals).transpose(1, 2), [{}, {}], 0, {"t": t, "noise": noise})
    loss.backward()
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    _check_grads(model.model.named_parameters(), state_dict_from_jax(grads["model"]))
    assert math.isfinite(w.train_step(_t(reals).transpose(1, 2), [{}, {}])["loss"])


def test_stereoize_matches_jax(prior):
    """200 samples of mono audio at 22.05 kHz: resampled to 16 kHz (146
    samples), padded to the U-Net's multiple (8 -> 152), the dual-mono
    source, k-euler over 3 steps from JAX's noise."""
    config, jmodel, model = prior
    mono = (0.1 * np.random.RandomState(3).randn(1, 1, 200)).astype(np.float32)
    kw = {"sampler_type": "k-euler", "sigma_min": 0.3, "sigma_max": 50}
    want = jmodel.stereoize(mono, in_sr=22050, steps=3, sampler_kwargs={**kw, "seed": 6})
    length = np.asarray(want).shape[-1]
    assert length % model.min_input_length == 0 and model.min_input_length == 8
    k_noise, _ = jax.random.split(jax.random.PRNGKey(6))
    noise = _t(jax.random.normal(k_noise, (1, length, 2), jnp.float32))
    got = model.stereoize(mono, in_sr=22050, steps=3, sampler_kwargs=kw, noise=noise)
    assert got.shape == (1, 2, length)
    assert _rel(got, want) <= 1e-4
