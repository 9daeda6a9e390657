"""A narrow SAO 1.0 model whose DiT the head-pair kernels do not take, in
the torch port against the JAX package: generation with the JAX sampler's
noise injected, and one train step (the loss and every gradient).

Two DiTs, each SAO 1.0's config at narrow widths (tests/
test_torch_train_slice.py:tiny_train_config, 2 layers) with nothing else
changed: 256 wide in 2 heads of 128 (SAO's head dim with 12 heads, rotary
dim 64), and 192 wide in 3 heads of 64 (an odd head count; its conditioning
tokens 192 wide too, so that the cross-attention's keys come in whole heads,
as SAO's 768 do, and its global condition the two timing conditioners' 384). The JAX side
runs its fused attention path with its Pallas kernels in interpret mode
(FSAT_FUSED_ATTN=1, FSAT_PALLAS_INTERPRET=1: the rope-fused K7 without grad;
rope outside, K7 with its LSE and K8 under grad); the port takes the
rope-fused K7's route on CPU tensors (ops/attention.py's `uses_kernels` forced: its
plain version) and, under grad, its unpack route (the plain K7 and K8).
Tolerances: generation 1e-3 of the output's peak (fp32 rounding of XLA
against PyTorch over 3 sampler steps and the decoder; the roped q and k are
rounded to bf16 on both sides, and an fp32 difference before that rounding
moves a score by a bf16 step at most); the loss 1e-5 relative and every
trainable gradient 1e-4 of its own largest entry (as the train slice test:
fp32 on both sides through the VAE encode, T5 and two DiT layers).
"""

import jax
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.inference.generation import generate_diffusion_cond as jax_generate
from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.training.diffusion import DiffusionCondTrainingWrapper as JWrapper
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.ops import attention as tattention
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash
from friendly_stable_audio_tools_tpu_torch.training.diffusion import DiffusionCondTrainingWrapper
from friendly_stable_audio_tools_tpu_torch.utils.convert import (
    convert_conditioned_diffusion,
    state_dict_from_jax,
)
from tests.test_torch_port_pipeline import SEED, _jax_sampler_noise
from tests.test_torch_train_slice import LATENTS, METADATA, RATIO, _close_rel, _jax_draws
from tests.test_torch_train_slice import tiny_train_config

KERNEL_ENV = {"FSAT_PALLAS_INTERPRET": "1", "FSAT_FUSED_ATTN": "1"}
STEPS = 3


@pytest.fixture(scope="module", params=[(256, 2), (192, 3)], ids=["2x128", "3x64"])
def models(request):
    """The tiny config with the DiT's width and head count set, built by the
    JAX package (its DiT de-zeroed) and converted into the port."""
    width, heads = request.param
    config = tiny_train_config()
    config["model"]["diffusion"]["config"].update(embed_dim=width, num_heads=heads)
    if heads == 3:  # the cross-attention's keys in whole heads of 64, as SAO's 768 are
        config["model"]["conditioning"]["cond_dim"] = width
        config["model"]["diffusion"]["config"].update(cond_token_dim=width,
                                                      global_cond_dim=2 * width)
    jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.params = dezero_params(jmodel.params)
    sd = convert_conditioned_diffusion(jmodel.params, jmodel.conditioner.params,
                                       jmodel.pretransform.model.params)
    return config, jmodel, sd, heads


@pytest.fixture
def kernels(monkeypatch):
    for k, v in KERNEL_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("FSAT_FUSED_BWD", raising=False)
    monkeypatch.setattr(tattention, "uses_kernels", lambda x: True)
    return monkeypatch


def test_generation_matches_jax(models, kernels):
    config, jmodel, sd, heads = models
    routes = []
    real = tflash.flash_rope_attention
    kernels.setattr(tflash, "flash_rope_attention",
                    lambda qkv, f, h: routes.append((qkv.shape[1], h)) or real(qkv, f, h))
    kw = dict(steps=STEPS, cfg_scale=7.0, conditioning=METADATA[:1],
              sample_size=LATENTS * RATIO, sampler_type="dpmpp-3m-sde", sigma_min=0.3,
              sigma_max=50.0, seed=SEED)
    want = np.asarray(jax_generate(jmodel, **kw))
    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    noise, step_noise = _jax_sampler_noise(STEPS, (1, LATENTS, 4))
    got = generate_diffusion_cond(tmodel, noise=noise, step_noise=step_noise, **kw).numpy()
    assert got.shape == want.shape == (1, 2, LATENTS * RATIO)
    # one call per layer and model evaluation (dpmpp-3m-sde: one per step),
    # the CFG batch of 2 over the latents and the prepended tokens
    assert len(routes) == 2 * STEPS and set(routes) == {(LATENTS + 1, heads)}
    peak = np.abs(want).max()
    assert peak > 1e-3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3 * peak)


def test_one_train_step_matches_jax(models, kernels):
    config, jmodel, sd, _ = models
    opt = config["training"]["optimizer_configs"]
    reals = np.random.RandomState(2).randn(2, 2, LATENTS * RATIO).astype(np.float32) * 0.3
    jw = JWrapper(jmodel, optimizer_configs=opt, cfg_dropout_prob=0.0)
    state = jw.init_state()
    batch = jw.prepare_batch(reals, METADATA)
    rng = jax.random.PRNGKey(12)
    (jloss, _), jgrads = jax.jit(jw._loss_and_grads)(state.params, batch, rng, state.qmc_counter,
                                                     jw.frozen_arrays())

    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    tw = DiffusionCondTrainingWrapper(tmodel, optimizer_configs=opt, cfg_dropout_prob=0.0)
    flash_calls = []
    real = tattn.FusedQKVFlashAttention.apply
    kernels.setattr(tattn.FusedQKVFlashAttention, "apply",
                    lambda *a: flash_calls.append(a[0].shape) or real(*a))
    metrics = tw.train_step(torch.tensor(reals).transpose(1, 2), METADATA,
                            draws=[_jax_draws(rng, 2)])
    # the unpack route (K7 with its LSE, K8) in each layer, and again where
    # the checkpointed layers are recomputed for the backward
    assert len(flash_calls) == 4

    assert abs(metrics["loss"] - float(jloss)) <= 1e-5 * float(jloss)
    flat_grads = state_dict_from_jax(jgrads["model"], "model.")
    for cid, tree in jgrads["conditioner"].items():
        flat_grads.update(state_dict_from_jax(tree, f"conditioner.conditioners.{cid}."))
    assert sorted(flat_grads) == sorted(tw.trainable)
    for name, p in tw.trainable.items():
        want = flat_grads[name].numpy()
        if np.abs(want).max() > 0:
            _close_rel(p.grad, want, 1e-4)
        else:
            assert p.grad is None or not p.grad.any(), name
