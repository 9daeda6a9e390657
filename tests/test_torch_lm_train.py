"""The torch port's audio-LM training slice (tests/test_torch_lm.py's tiny LM
with a t5-small prompt, trained from raw audio through its SEANet
tokenizer) against the JAX package, its train CLI, and the MusicGen-small
configuration.

* The slice: one train step at batch 2 (1100 frames, T 1101 with the delay
  pattern) against the JAX `AudioLanguageModelTrainingWrapper.train_step`,
  with the same CFG-dropout draw in both (row 0's conditioning zeroed) and
  a padding mask that leaves the last 100 frames of row 1 out of the loss;
  once as on the CPU (plain attention on both sides) and once with the
  flash gate forced on both sides (JAX: the causal Pallas K7 with stats
  and the causal two-pass K9 in interpret mode; port: `FlashAttention` with
  causal set on the plain versions). The tokens of both sides are equal
  first. Tolerances: the loss and the per-codebook perplexities to 1e-5
  relative; every gradient to 1e-4 of its own largest entry (fp32 rounding
  of XLA against PyTorch through T5, the LM forward and backward); the
  parameters after AdamW to 1e-6, the JAX update taken on the port's
  gradients so that the two optimizer steps see the same input. Then the
  whole chains, the JAX update on its own gradients against the port's step:
  per entry within 1e-6 plus what Adam's first step makes of the two
  gradients' difference there (at most twice the learning rate; AdamW's
  decay term is the same on both sides), which is wider than 2e-6 on at most
  1e-4 of the entries.
* The train CLI trains the tiny LM 2 steps on the CPU from WAVs with a
  checkpoint, and resumes for a third.
* musicgen_small_32khz.json builds in both factories at a depth cut to 1,
  with the same parameter names and shapes after conversion, and at full
  depth holds 0.524 B LM weights.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

import friendly_stable_audio_tools_tpu.ops.attention as jattention
import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.training.lm import AudioLanguageModelTrainingWrapper as JWrapper
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.models.lm import create_audio_lm_from_config
from friendly_stable_audio_tools_tpu_torch.ops import attention as tattention
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash
from friendly_stable_audio_tools_tpu_torch.train import main as train_main
from friendly_stable_audio_tools_tpu_torch.training.lm import AudioLanguageModelTrainingWrapper
from friendly_stable_audio_tools_tpu_torch.utils import convert
from friendly_stable_audio_tools_tpu_torch.utils.convert import convert_audio_lm
from tests.test_torch_lm import FRAMES, RATIO, tiny_lm_config

MUSICGEN = "friendly_stable_audio_tools_tpu_torch/configs/lm/musicgen_small_32khz.json"
LR = 1e-4


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def lm_models():
    """The JAX package's tiny LM with its t5-small prompt (random, the LM
    de-zeroed) and the same weights in the port's names."""
    config = tiny_lm_config()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HF_HUB_OFFLINE", "1")  # the JAX tokenizer ladder would try the network
        jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.params = dezero_params(jmodel.params)
    sd = convert_audio_lm(jmodel.params, jmodel.conditioner.params,
                          jmodel.pretransform.model.params)
    return config, jmodel, sd


def _accelerator_gate():
    """`jax` as the JAX attention module sees it on an accelerator: its gate
    then sends long self-attention to the Pallas flash kernels."""
    proxy = types.SimpleNamespace(**{n: getattr(jax, n) for n in dir(jax) if not n.startswith("__")})
    proxy.default_backend = lambda: "tpu"
    return proxy


def _port_grads_as_jax(jgrads, port):
    """The JAX gradient tree with each leaf replaced by the port's gradient
    of the same parameter (utils/convert.py's naming, 2-D kernels transposed
    back)."""

    def leaf(path, x):
        keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        nested = x
        for k in reversed(keys):
            nested = {k: nested}
        (name,) = convert_audio_lm(nested)
        g = port[name]
        return jnp.asarray(g.T if keys[-1] == "kernel" and g.ndim == 2 else g)

    return jax.tree_util.tree_map_with_path(leaf, jgrads)


METADATA = [{"prompt": "A grand orchestral arrangement with thunderous percussion"},
            {"prompt": "A cool 80s glam rock song"}]


@pytest.mark.parametrize("forced", [False, True])
def test_one_lm_train_step_matches_jax(lm_models, monkeypatch, forced):
    config, jmodel, sd = lm_models
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    n = FRAMES * RATIO
    reals = (np.random.RandomState(41).randn(2, 1, n) * 0.3).astype(np.float32)
    metadata = [dict(md, padding_mask=np.ones(n, np.float32)) for md in METADATA]
    metadata[1]["padding_mask"][-100 * RATIO:] = 0
    drop = [True, False]
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(drop).reshape(shape))
    if forced:
        monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("FSAT_DISABLE_PALLAS_CONV", "1")  # the SEANet's convs: XLA, as on the CPU
        monkeypatch.delenv("FSAT_DISABLE_PALLAS_ATTN", raising=False)
        monkeypatch.setattr(jattention, "jax", _accelerator_gate())
        jax_calls, backward = [], jfa._flash_backward
        monkeypatch.setattr(jfa, "_flash_backward", lambda *a, **kw: jax_calls.append(
            (a[0].shape, a[6])) or backward(*a, **kw))

    jw = JWrapper(jmodel, lr=LR)
    tx = jw.tx
    # the optimizer state carries the step's gradients out of the jitted step
    jw.tx = optax.GradientTransformation(
        lambda p: (tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
        lambda g, s, p=None: (lambda out: (out[0], (out[1], g)))(tx.update(g, s[0], p)))
    state = jw.init_state()
    batch = jw.prepare_batch(reals, metadata)
    new_state, jmetrics = jax.jit(jw.train_step)(state, batch, jax.random.PRNGKey(17),
                                                 jw.frozen_arrays())
    jgrads = new_state.opt_state[1]
    state = state.replace(opt_state=state.opt_state[0])

    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    tw = AudioLanguageModelTrainingWrapper(tmodel, lr=LR)
    codes = tw.tokenize(torch.tensor(reals).transpose(1, 2))
    np.testing.assert_array_equal(  # the same tokens on both sides
        codes.numpy(), np.asarray(jax.jit(jmodel.pretransform.tokenize)(jnp.asarray(reals))))
    routed = []
    if forced:
        monkeypatch.setattr(tattention, "uses_kernels", lambda x: True)
        for name in ("flash_forward", "flash_backward", "flash_backward_fused"):
            fn = getattr(tflash, name)
            monkeypatch.setattr(tflash, name, lambda *a, _fn=fn, _n=name, **kw: routed.append(
                (_n, tuple(a[0].shape), kw.get("causal"))) or _fn(*a, **kw))
    metrics = tw.train_step(torch.tensor(reals).transpose(1, 2), metadata,
                            draws=[{"cross_attn_cond": torch.tensor(drop)}])

    if forced:  # the 2 causal self-attentions (B 2 x 2 heads at T 1101), both sides
        assert jax_calls == [((4, FRAMES + 1, 64), True)] * 2
        assert sorted(routed) == [("flash_backward", (4, FRAMES + 1, 64), True)] * 2 + \
            [("flash_forward", (4, FRAMES + 1, 64), True)] * 2
    for key in ["loss", "ce_loss"] + [f"perplexity_q{q}" for q in range(4)]:
        assert abs(metrics[key] - float(jmetrics[key])) <= 1e-5 * abs(float(jmetrics[key])), key
    flat = convert_audio_lm(jgrads["model"])
    assert sorted(flat) == sorted(tw.trainable)  # the LM trains; T5 and the tokenizer are frozen
    for name, p in tw.trainable.items():
        want = flat[name].numpy()
        np.testing.assert_allclose(_np(p.grad), want, atol=1e-4 * np.abs(want).max() + 1e-12,
                                   err_msg=name)

    # the JAX update on the port's gradients: the same optimizer input on both sides
    port = {name: _np(p.grad) for name, p in tw.trainable.items()}
    updates, _ = tx.update({"model": _port_grads_as_jax(jgrads["model"], port)}, state.opt_state,
                           state.params)
    on_port = convert_audio_lm(optax.apply_updates(state.params, updates)["model"])
    for name, p in tw.trainable.items():
        np.testing.assert_allclose(_np(p), on_port[name].numpy(), atol=1e-6, err_msg=name)
    assert tw.step == 1

    # the whole chains: Adam's first step moves a weight by lr * g / (|g| + eps)
    # (plus the same decay term on both sides), whose slope in g, eps / (|g| +
    # eps)^2, is largest at the smallest |g| between the two gradients (at g = 0
    # where their signs differ): at most lr * dg * that slope apart, and 2 lr
    jax_params = convert_audio_lm(new_state.params["model"])
    eps, loose = 1e-8, 0
    for name, p in tw.trainable.items():
        gj, gp = flat[name].numpy().astype(np.float64), port[name].astype(np.float64)
        low = np.where(gj * gp > 0, np.minimum(np.abs(gj), np.abs(gp)), 0.0)
        tol = 1e-6 + np.minimum(2 * LR, LR * np.abs(gj - gp) * eps / (low + eps) ** 2)
        loose += int((tol > 2e-6).sum())
        err = np.abs(_np(p) - jax_params[name].numpy())
        assert (err <= tol).all(), (name, float(err.max()))
    assert loose <= 1e-4 * sum(p.numel() for p in tw.trainable.values()), loose


def test_train_cli_trains_the_tiny_lm_and_resumes(tmp_path):
    """`train.main` for 2 steps on 2 synthetic mono WAVs (checkpoint at step
    2), then a resume from `checkpoints/last` for one more step; finite,
    moved weights; T5 and the tokenizer stay frozen."""
    config = tiny_lm_config()
    (tmp_path / "model.json").write_text(json.dumps(config))
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.RandomState(2)
    for i in range(2):
        wavfile.write(str(wavs / f"clip{i}.wav"), 32000, (rng.randn(7000) * 3000).astype(np.int16))
    (wavs / "clip0.json").write_text(json.dumps({"prompt": "noise"}))
    (tmp_path / "data.json").write_text(json.dumps(
        {"dataset_type": "audio_dir", "datasets": [{"id": "wavs", "path": str(wavs)}]}))
    args = ["--model-config", str(tmp_path / "model.json"), "--dataset-config",
            str(tmp_path / "data.json"), "--batch-size", "2", "--num-workers", "0",
            "--save-dir", str(tmp_path / "run"), "--name", "tiny", "--seed", "3",
            "--device", "cpu"]
    trainer = train_main(args + ["--max-steps", "2"])
    w = trainer.wrapper
    first = {n: p.detach().clone() for n, p in w.trainable.items()}
    frozen = {n: p.detach().clone() for n, p in w.lm.named_parameters() if n not in w.trainable}
    ckpt = tmp_path / "run" / "tiny" / "local" / "checkpoints"
    assert (ckpt / "step_2" / "state.pt").exists() and (ckpt / "last").is_symlink()
    assert isinstance(w, AudioLanguageModelTrainingWrapper) and w.step == 2
    assert all(n.startswith("model.") for n in w.trainable)
    assert any(n.startswith("conditioner.") for n in frozen)
    assert any(n.startswith("pretransform.") for n in frozen)

    resumed = train_main(args + ["--max-steps", "3", "--ckpt-path", str(ckpt / "last")])
    r = resumed.wrapper
    assert r.step == 3
    assert all(torch.isfinite(p).all() for p in r.trainable.values())
    assert any(not torch.equal(p.detach(), first[n]) for n, p in r.trainable.items())
    assert all(torch.equal(p.detach(), frozen[n]) for n, p in r.lm.named_parameters()
               if n in frozen)


def test_musicgen_small_config_builds_in_both_factories(monkeypatch):
    """At a depth cut to 1 the two factories' LM and tokenizer trees match by
    name and shape after conversion (the SEANet with its LSTMs and RVQ, the
    LM with its projected cross-attention); at full depth the LM holds 0.524
    B weights (MusicGen small's widths, GLU feed-forward). Without a card the
    port's factory raises unless asked for the CPU."""
    config = json.loads(open(MUSICGEN).read())
    assert (config["sample_size"], config["sample_rate"], config["audio_channels"]) == \
        (960000, 32000, 1)
    lm = config["model"]["lm"]["config"]
    assert (lm["embed_dim"], lm["depth"], lm["num_heads"], lm["ff_mult"]) == (1024, 24, 16, 4)
    with torch.device("meta"):
        full = create_audio_lm_from_config(config)
    assert sum(p.numel() for p in full.model.parameters()) == 524_333_056
    assert full.pretransform.downsampling_ratio == 640 and full.num_quantizers == 4
    assert full.codebook_size == 2048
    config["model"]["lm"]["config"]["depth"] = 1
    del config["model"]["conditioning"]  # T5-base's names are held by the SAO tests
    jmodel = jax_create(config)
    rng = jax.random.PRNGKey(0)
    ae = jmodel.pretransform.model
    lm_shapes = jax.eval_shape(lambda r: jmodel.module.init(
        r, jnp.zeros((1, 4, 8), jnp.int32), cross_attn_cond=jnp.zeros((1, 2, 768)))["params"], rng)
    ae_shapes = jax.eval_shape(lambda r: ae.module.init(
        {"params": r, "sample": r}, jnp.zeros((1, 640 * 4, 1)))["params"], rng)
    # the conversion on zero-stride arrays, its tensors made on the meta device:
    # names and shapes without 2 GB of zeros
    zeros = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda x: np.broadcast_to(np.float32(0), x.shape), tree)
    monkeypatch.setattr(convert, "torch", types.SimpleNamespace(
        tensor=lambda a: torch.empty(np.shape(a), device="meta"), zeros_like=torch.zeros_like))
    got = convert_audio_lm(zeros(lm_shapes), None, zeros(ae_shapes))
    monkeypatch.undo()
    with torch.device("meta"):
        tmodel = create_audio_lm_from_config(config)
    want = {n: tuple(p.shape) for n, p in tmodel.state_dict().items()}
    assert {n: tuple(v.shape) for n, v in got.items()} == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model_from_config(config)
