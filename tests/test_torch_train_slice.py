"""The torch port's training slice against the JAX package: one train step of
a Stable-Audio-Open-shaped model from raw audio, then the train CLI; and one
train step of a Stable-Audio-2.0-shaped (long-form) model whose sequence is
long enough for the unpack attention route (K7 + K9).

The model is the SAO 1.0 config at narrow widths (a DiT 128 wide with 2
heads of 64, depth 2, prepend global cond and per-layer checkpointing;
t5-small; two number conditioners; a two-block snake Oobleck VAE with 4
latent channels), built by the JAX package's factory, its DiT de-zeroed,
and converted into the port. Both packages take one step of the SAO
optimizer (AdamW + InverseLR) and EMA on the same audio, with the JAX
step's own timestep and noise draws passed into the port, at CFG dropout
0 and 1 (deterministic on both sides), and once more at CFG dropout 0 with
the DiT's global condition through adaLN instead of a prepended token.
Everything is fp32 on the CPU.
Tolerances: the loss to 1e-5 relative and every trainable gradient to
1e-4 of its own largest entry (fp32 rounding of XLA against PyTorch through
the VAE encode, T5 and two DiT layers, forward and backward); parameters and
EMA after the update to 1e-6 (the first update moves each weight by at
most the step-0 learning rate, 5e-7).
"""

import copy
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.training.diffusion import DiffusionCondTrainingWrapper as JWrapper
from friendly_stable_audio_tools_tpu.training.diffusion import quasirandom_uniform as jax_qmc
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.train import main as train_main
from friendly_stable_audio_tools_tpu_torch.training.diffusion import DiffusionCondTrainingWrapper
from friendly_stable_audio_tools_tpu_torch.utils.convert import (
    convert_conditioned_diffusion,
    state_dict_from_jax,
)
from tests.test_torch_port_pipeline import SAO_CONFIG

LATENTS = 24
RATIO = 8
METADATA = [{"prompt": "amen break 174 bpm", "seconds_start": 0, "seconds_total": 47},
            {"prompt": "a calm piano melody", "seconds_start": 3, "seconds_total": 12}]


def tiny_train_config():
    c = copy.deepcopy(json.loads(SAO_CONFIG.read_text()))
    c["sample_size"] = LATENTS * RATIO
    model = c["model"]
    model["io_channels"] = 4
    model["conditioning"]["cond_dim"] = 128
    model["conditioning"]["configs"][0]["config"]["t5_model_name"] = "t5-small"
    model["diffusion"]["config"].update(io_channels=4, embed_dim=128, depth=2, num_heads=2,
                                        cond_token_dim=128, global_cond_dim=256)
    pt = model["pretransform"]["config"]
    pt.update(latent_dim=4, downsampling_ratio=RATIO)
    pt["encoder"]["config"].update(channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=8)
    pt["decoder"]["config"].update(channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=4)
    return c


@pytest.fixture(scope="module")
def models(request):
    """The tiny config built by the JAX package, de-zeroed, and its
    converted weights; with the indirect parameter "adaLN" its DiT takes
    the global condition through adaLN (to_scale_shift_gate in every
    block) instead of a prepended token."""
    config = tiny_train_config()
    config["model"]["diffusion"]["config"]["global_cond_type"] = getattr(request, "param",
                                                                         "prepend")
    jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.params = dezero_params(jmodel.params)
    sd = convert_conditioned_diffusion(jmodel.params, jmodel.conditioner.params,
                                       jmodel.pretransform.model.params)
    return config, jmodel, sd


def _jax_draws(rng, b):
    """t and noise of the JAX step (training/diffusion.py:209, 254-263)."""
    k_t, k_noise, _, _, _ = jax.random.split(rng, 5)
    t = jax_qmc(jnp.uint32(0), b, jax.random.uniform(k_t, (), jnp.float32))
    noise = jax.random.normal(k_noise, (b, LATENTS, 4), jnp.float32)
    return {"t": torch.tensor(np.asarray(t)), "noise": torch.tensor(np.asarray(noise))}


def _close_rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=rel * np.abs(want).max() + 1e-12)


@pytest.mark.parametrize("models,cfg_dropout_prob",
                         [("prepend", 0.0), ("prepend", 1.0), ("adaLN", 0.0)],
                         indirect=["models"], ids=["0.0", "1.0", "adaLN-0.0"])
def test_one_train_step_matches_jax(models, cfg_dropout_prob):
    config, jmodel, sd = models
    opt = config["training"]["optimizer_configs"]
    reals = np.random.RandomState(1).randn(2, 2, LATENTS * RATIO).astype(np.float32) * 0.3

    jw = JWrapper(jmodel, optimizer_configs=opt, cfg_dropout_prob=cfg_dropout_prob)
    state = jw.init_state()
    batch = jw.prepare_batch(reals, METADATA)
    rng = jax.random.PRNGKey(11)
    (jloss, _), jgrads = jax.jit(jw._loss_and_grads)(state.params, batch, rng, state.qmc_counter,
                                                     jw.frozen_arrays())
    new_state, _ = jw._apply_update(state, 2, jloss, {}, jgrads)

    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    tw = DiffusionCondTrainingWrapper(tmodel, optimizer_configs=opt,
                                      cfg_dropout_prob=cfg_dropout_prob)
    draws = _jax_draws(rng, 2)
    if cfg_dropout_prob == 1.0:  # a drawn mask would be all True too; pass it explicitly
        draws["cfg_dropout_mask"] = torch.ones(2, dtype=torch.bool)
    metrics = tw.train_step(torch.tensor(reals).transpose(1, 2), METADATA, draws=[draws])

    assert abs(metrics["loss"] - float(jloss)) <= 1e-5 * float(jloss)
    flat_grads = state_dict_from_jax(jgrads["model"], "model.")
    for cid, tree in jgrads["conditioner"].items():
        flat_grads.update(state_dict_from_jax(tree, f"conditioner.conditioners.{cid}."))
    assert sorted(flat_grads) == sorted(tw.trainable)  # the same trainable/frozen split
    for name, p in tw.trainable.items():
        want = flat_grads[name].numpy()
        if np.abs(want).max() > 0:
            _close_rel(p.grad, want, 1e-4)
        else:
            assert p.grad is None or not p.grad.any(), name
    new_params = state_dict_from_jax(new_state.params["model"], "model.")
    new_ema = state_dict_from_jax(new_state.ema_params, "model.")
    names = [f"model.{n}" for n, _ in tmodel.model.named_parameters()]
    for name, e in zip(names, tw.ema):
        np.testing.assert_allclose(tw.trainable[name].detach().numpy(), new_params[name].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(e.numpy(), new_ema[name].numpy(), atol=1e-6)
    assert tw.step == 1 and tw.qmc_counter == 2


LONG_LATENTS = 1423  # + 1 prepended token = 1424 > 1168: the unpack route, K7 then K9


@pytest.fixture(scope="module")
def longform_models():
    """SA 2.0's config at narrow widths (tests/test_torch_longform.py: the
    CLAP text conditioner at full size, a 2-layer DiT 128 wide with 2 heads
    of 64 and per-layer checkpointing, a two-block Oobleck VAE with 16 latent
    channels) at 1423 latent frames, built by the JAX package, de-zeroed."""
    from tests.test_torch_longform import tiny_longform_config

    config = tiny_longform_config()
    config["sample_size"] = LONG_LATENTS * RATIO
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HF_HUB_OFFLINE", "1")  # the JAX tokenizer ladder would try the network
        jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.params = dezero_params(jmodel.params)
    sd = convert_conditioned_diffusion(jmodel.params, jmodel.conditioner.params,
                                       jmodel.pretransform.model.params)
    return config, jmodel, sd


def test_one_longform_train_step_matches_jax(longform_models, monkeypatch):
    """One step at batch 2, CFG dropout 0, against the JAX package's fp32
    step on the same audio and draws. 1424 tokens take the unpack route in
    the port (per layer K7 twice, the checkpointed block being recomputed,
    and K9 once; their plain versions on the CPU). Tolerances as for SAO:
    the loss to 1e-5 relative, every trainable gradient to 1e-4 of its own
    largest entry."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    config, jmodel, sd = longform_models
    opt = config["training"]["optimizer_configs"]
    metadata = [{"prompt": "A grand orchestral arrangement", "seconds_start": 0,
                 "seconds_total": 285},
                {"prompt": "A cool 80s glam rock song", "seconds_start": 7, "seconds_total": 120}]
    reals = np.random.RandomState(5).randn(2, 2, LONG_LATENTS * RATIO).astype(np.float32) * 0.3

    jw = JWrapper(jmodel, optimizer_configs=opt, cfg_dropout_prob=0.0)
    state = jw.init_state()
    rng = jax.random.PRNGKey(12)
    (jloss, _), jgrads = jax.jit(jw._loss_and_grads)(
        state.params, jw.prepare_batch(reals, metadata), rng, state.qmc_counter,
        jw.frozen_arrays())

    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    tw = DiffusionCondTrainingWrapper(tmodel, optimizer_configs=opt, cfg_dropout_prob=0.0)
    k_t, k_noise, _, _, _ = jax.random.split(rng, 5)
    draws = {"t": torch.tensor(np.asarray(jax_qmc(jnp.uint32(0), 2,
                                                   jax.random.uniform(k_t, (), jnp.float32)))),
             "noise": torch.tensor(np.asarray(jax.random.normal(k_noise, (2, LONG_LATENTS, 16))))}
    calls = []
    for name in ("flash_forward", "flash_attention_backward"):
        fn = getattr(tflash, name)
        monkeypatch.setattr(tflash, name, lambda *a, _fn=fn, _n=name, **kw: calls.append(
            (_n, a[0].shape[1])) or _fn(*a, **kw))
    assert tattn.training_route(LONG_LATENTS + 1, 64, 2) == "flash"
    assert tflash.backward_kernel(LONG_LATENTS + 1, LONG_LATENTS + 1, 64) == "K9"
    metrics = tw.train_step(torch.tensor(reals).transpose(1, 2), metadata, draws=[draws])

    assert sorted(calls) == [("flash_attention_backward", 1424)] * 2 + [("flash_forward", 1424)] * 4
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


def test_train_cli_two_steps_checkpoint_and_resume(tmp_path):
    """`train.main` for 2 steps on 2 synthetic WAVs (checkpoint at step 2),
    then a resume from `checkpoints/last` for one more step."""
    config = tiny_train_config()
    config["training"]["checkpoint"]["every_n_train_steps"] = 2
    (tmp_path / "model.json").write_text(json.dumps(config))
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.RandomState(2)
    for i in range(2):
        wavfile.write(str(wavs / f"clip{i}.wav"), 44100, (rng.randn(300, 2) * 3000).astype(np.int16))
    (wavs / "clip0.json").write_text(json.dumps({"prompt": "noise"}))
    (tmp_path / "data.json").write_text(json.dumps(
        {"dataset_type": "audio_dir", "datasets": [{"id": "wavs", "path": str(wavs)}]}))
    args = ["--model-config", str(tmp_path / "model.json"), "--dataset-config",
            str(tmp_path / "data.json"), "--batch-size", "2", "--num-workers", "0",
            "--save-dir", str(tmp_path / "run"), "--name", "tiny", "--seed", "3",
            "--device", "cpu"]

    trainer = train_main(args + ["--max-steps", "2"])
    first = {n: p.detach().clone() for n, p in trainer.wrapper.trainable.items()}
    ckpt = tmp_path / "run" / "tiny" / "local" / "checkpoints"
    assert (ckpt / "step_2" / "state.pt").exists() and (ckpt / "last").is_symlink()
    assert json.loads((ckpt / "step_2" / "model_config.json").read_text()) == config
    assert trainer.wrapper.step == 2 and trainer.wrapper.qmc_counter == 4

    resumed = train_main(args + ["--max-steps", "3", "--ckpt-path", str(ckpt / "last")])
    w = resumed.wrapper
    assert w.step == 3 and w.qmc_counter == 6
    moved = [not torch.equal(p.detach(), first[n]) for n, p in w.trainable.items()]
    assert any(moved)
    assert all(torch.isfinite(p).all() for p in w.trainable.values())
    # the EMA decay is 0 for the first three updates: the EMA equals the weights
    assert all(torch.equal(e, p.detach()) for e, p in zip(w.ema, w.dit_params))


def test_train_cli_refuses_multi_device(tmp_path):
    with pytest.raises(NotImplementedError):
        train_main(["--model-config", "x.json", "--dataset-config", "y.json", "--num-chips", "2"])
    with pytest.raises(NotImplementedError):
        train_main(["--model-config", "x.json", "--dataset-config", "y.json", "--strategy", "fsdp"])


def test_experiment_logger_touches_wandb_only_when_asked(monkeypatch, capsys):
    """An installed wandb that fails to initialise reports over the network,
    so the logger imports it only with use_wandb=True (the train CLI sets it
    when WANDB_API_KEY is set); otherwise metrics go to the console."""
    import types

    from friendly_stable_audio_tools_tpu_torch.training.logging import ExperimentLogger

    calls = []
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: calls.append(kw) or types.SimpleNamespace(id="run1", log=None)
    monkeypatch.setitem(sys.modules, "wandb", stub)
    logger = ExperimentLogger(project="p", name=None)
    assert calls == [] and logger.run is None and logger.run_id == "local"
    logger.log({"train/loss": 0.5}, step=3)
    assert "[step 3] train/loss=0.5" in capsys.readouterr().out
    assert ExperimentLogger(project="p", use_wandb=True).run_id == "run1" and len(calls) == 1


def test_grad_accumulation_averages_micro_batches_and_export_prefers_ema(models, tmp_path):
    """accum_batches 2 on a batch of 2 gives the mean of the two micro-batch
    gradients (each at its own quasi-random counter) and one update (the
    JAX package's `_train_step_accum`): 1e-6 of the largest gradient, fp32.
    Then `export_model` writes the EMA weights as the DiT's."""
    config, _, sd = models
    opt = config["training"]["optimizer_configs"]
    reals = torch.tensor(np.random.RandomState(4).randn(2, LATENTS * RATIO, 2).astype(np.float32))
    draws = [_jax_draws(jax.random.PRNGKey(20 + i), 1) for i in range(2)]

    def wrapper():
        tmodel = create_model_from_config(config, device="cpu")
        tmodel.load_state_dict(sd, strict=True)
        return DiffusionCondTrainingWrapper(tmodel, optimizer_configs=opt, cfg_dropout_prob=0.0)

    acc = wrapper()
    acc.train_step(reals, METADATA, accum=2, draws=draws)
    assert acc.step == 1 and acc.qmc_counter == 2
    want = {}
    for i in range(2):
        single = wrapper()
        single.qmc_counter = i
        single.train_step(reals[i:i + 1], METADATA[i:i + 1], draws=[draws[i]])
        for n, p in single.trainable.items():
            if p.grad is not None:
                want[n] = want.get(n, 0) + p.grad / 2
    for n, p in acc.trainable.items():
        if n in want:
            _close_rel(p.grad, want[n].numpy(), 1e-6)

    acc.ema[0].add_(1.0)  # make the EMA tell apart from the weights
    acc.export_model(str(tmp_path / "export.pt"))
    exported = torch.load(tmp_path / "export.pt", weights_only=True)
    first = next(iter(n for n, _ in acc.model.model.named_parameters()))
    assert torch.equal(exported[f"model.{first}"], acc.ema[0])
    assert set(exported) == {f"model.{n}" for n, _ in acc.model.model.named_parameters()} | {
        n for n in acc.trainable if not n.startswith("model.")}


@pytest.mark.parametrize("key,value", [("mask_padding", True), ("pre_encoded", True),
                                       ("timestep_sampler", "logit_normal")])
def test_unported_training_options_raise(models, key, value):
    """The three options that raised before they were ported: the factory
    now builds the wrapper with each set, and one step runs (on audio with
    padding masks, or on latents for `pre_encoded`; tests/
    test_torch_train_options.py holds each against the JAX package)."""
    from friendly_stable_audio_tools_tpu_torch.training.factory import (
        create_training_wrapper_from_config,
    )

    config = copy.deepcopy(models[0])
    config["training"][key] = value
    w = create_training_wrapper_from_config(config, create_model_from_config(config, device="cpu"))
    assert getattr(w, key) == value
    rng = np.random.RandomState(9)
    metadata = [dict(md, padding_mask=np.ones(LATENTS * RATIO, np.float32)) for md in METADATA]
    metadata[1]["padding_mask"][LATENTS * RATIO // 2:] = 0
    shape = (2, LATENTS, 4) if key == "pre_encoded" else (2, LATENTS * RATIO, 2)
    metrics = w.train_step(torch.tensor(rng.randn(*shape).astype(np.float32) * 0.3), metadata)
    assert w.step == 1 and np.isfinite(metrics["loss"]) and metrics["loss"] > 0
