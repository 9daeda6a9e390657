"""The torch port's diffusion-training options against the JAX package, on
tests/test_torch_train_slice.py's tiny Stable-Audio-Open model (a DiT 128
wide, 2 layers of 2 heads of 64, t5-small, two number conditioners, a
two-block Oobleck VAE with 4 latent channels), built once per module by the
JAX package, de-zeroed and converted into the port.

Train steps: pre-encoded latents (with the pretransform's scale 1 and 2),
logit-normal timesteps with `log_loss_info`'s eight sigma buckets, the
rectified-flow objective with `mask_padding` (the padding-mask dropout
forced on and off by choosing the JAX step's key), and the
`diffusion_cond_inpaint` trainer (its keep mask injected). Each runs the
JAX wrapper's own step, three jitted programs each compiled once per
module (`_program`), its draws recovered from the step key and passed
into the port, which is held on the loss, every trained gradient and the
weights after the update. Then the smaller pieces: the DiT forward with
input-concat, prepend + mask and patching, the masked self-attention and
its routing, the masked MSE, the padding-mask resample, the timestep
draws, `random_mask`'s three kinds and the weight-norm fold.

Everything is fp32 on the CPU. Tolerances as in the train-slice test: the
loss to 1e-5 relative, every trainable gradient to 1e-4 of its own largest
entry (fp32 rounding of XLA against PyTorch through T5, two DiT layers and,
where it runs, the VAE encode), the weights after the update to 1e-6 (the
first update moves a weight by at most the step-0 learning rate, 5e-7);
module outputs to 2e-5 of their largest entry, the attention to 1e-6.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.ops.attention import _xla_attention
from friendly_stable_audio_tools_tpu.training import diffusion as jdiff
from friendly_stable_audio_tools_tpu.training.losses.losses import MSELoss as JMSELoss
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.ops import attention as tattention
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as attn_kernels
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash
from friendly_stable_audio_tools_tpu_torch.training import diffusion as tdiff
from friendly_stable_audio_tools_tpu_torch.training.factory import (
    create_training_wrapper_from_config,
)
from friendly_stable_audio_tools_tpu_torch.training.losses import MSELoss
from friendly_stable_audio_tools_tpu_torch.utils.convert import (
    convert_conditioned_diffusion,
    state_dict_from_jax,
)
from tests.test_torch_train_slice import LATENTS, METADATA, RATIO, tiny_train_config

INPAINT_IDS = ["inpaint_mask", "inpaint_masked_input"]


def inpaint_config(config):
    """The tiny config as a `diffusion_cond_inpaint` model: the DiT takes
    the keep mask and the masked latents (1 + 4 channels) by input-concat."""
    c = copy.deepcopy(config)
    c["model_type"] = "diffusion_cond_inpaint"
    c["model"]["diffusion"]["input_concat_ids"] = list(INPAINT_IDS)
    c["model"]["diffusion"]["config"]["input_concat_dim"] = 1 + c["model"]["io_channels"]
    return c


@pytest.fixture(scope="module")
def models():
    """The tiny model and its inpaint variant built by the JAX package and
    de-zeroed, with their converted weights. The inpaint variant is built
    without conditioning and pretransform and then shares the plain
    model's, which it would build the same from the same config."""
    config = tiny_train_config()
    jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.params = dezero_params(jmodel.params)
    icfg = inpaint_config(config)
    bare = copy.deepcopy(icfg)
    for part in ("conditioning", "pretransform"):
        del bare["model"][part]
    jinp = jax_create(bare, init_rng=jax.random.PRNGKey(1))
    jinp.conditioner, jinp.pretransform = jmodel.conditioner, jmodel.pretransform
    jinp.params = dezero_params(jinp.params)

    def convert(jm):
        return convert_conditioned_diffusion(jm.params, jmodel.conditioner.params,
                                             jmodel.pretransform.model.params)

    return {"plain": (config, jmodel, convert(jmodel)), "inpaint": (icfg, jinp, convert(jinp))}


def _t(a):
    return torch.tensor(np.asarray(a))


def _close_rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=rel * np.abs(want).max() + 1e-12)


def _port(config, sd, **options):
    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    return tdiff.DiffusionCondTrainingWrapper(
        tmodel, optimizer_configs=config["training"]["optimizer_configs"], cfg_dropout_prob=0.0,
        **options)


def _reals(seed):
    return np.random.RandomState(seed).randn(2, 2, LATENTS * RATIO).astype(np.float32) * 0.3


def _jax_draws(rng, sampler, shape):
    """t and noise of the JAX step for key `rng` (JAX training/diffusion.py:209, 247, 256)."""
    k_t, k_noise, _, _, _ = jax.random.split(rng, 5)
    t = jdiff.draw_timesteps(sampler, shape[0], jnp.uint32(0), k_t)
    return {"t": _t(t), "noise": _t(jax.random.normal(k_noise, shape, jnp.float32))}


def _check_step(tw, jw, state, jloss, jgrads, metrics, check_params=True):
    """Loss, every trained gradient and (when the JAX update is given as
    `state`) the weights after the update."""
    assert abs(metrics["loss"] - float(jloss)) <= 1e-5 * float(jloss)
    flat = state_dict_from_jax(jgrads["model"], "model.")
    for cid, tree in jgrads.get("conditioner", {}).items():
        flat.update(state_dict_from_jax(tree, f"conditioner.conditioners.{cid}."))
    assert sorted(flat) == sorted(tw.trainable)
    for name, p in tw.trainable.items():
        want = flat[name].numpy()
        if np.abs(want).max() > 0:
            _close_rel(p.grad, want, 1e-4)
        else:
            assert p.grad is None or not p.grad.any(), name
    if check_params:
        new_state, _ = jw._apply_update(state, 2, jloss, {}, jgrads)
        new_params = state_dict_from_jax(new_state.params["model"], "model.")
        for name in new_params:
            np.testing.assert_allclose(tw.trainable[name].detach().numpy(),
                                       new_params[name].numpy(), atol=1e-6)


_PROGRAMS = {}


def _program(models, name):
    """One JAX train-step program per option set, jitted once per module
    and shared by the cases that differ only in their inputs or step key:
    (JAX wrapper, its initial state, the jitted step). "pre_encoded":
    pre-encoded latents, logit-normal timesteps, `log_loss_info`;
    "rf_mask": the rectified-flow objective with `mask_padding` (dropout
    0.5); "inpaint": the inpaint wrapper's whole `train_step`, its
    gradients carried out beside its metrics."""
    if name in _PROGRAMS:
        return _PROGRAMS[name]
    if name == "inpaint":
        config, jmodel, _ = models["inpaint"]
        jw = jdiff.DiffusionCondInpaintTrainingWrapper(
            jmodel, optimizer_configs=config["training"]["optimizer_configs"],
            cfg_dropout_prob=0.0)
        apply = jw._apply_update
        jw._apply_update = lambda st, n, loss, aux, grads: (
            lambda out: (out[0], {**out[1], "grads": grads}))(apply(st, n, loss, aux, grads))
        step = jax.jit(jw.train_step)
    else:
        config, jmodel, _ = models["plain"]
        opts = ({"pre_encoded": True, "timestep_sampler": "logit_normal", "log_loss_info": True}
                if name == "pre_encoded" else {"mask_padding": True, "mask_padding_dropout": 0.5})
        objective = jmodel.diffusion_objective
        if name == "rf_mask":
            jmodel.diffusion_objective = "rectified_flow"  # read once, by the wrapper
        jw = jdiff.DiffusionCondTrainingWrapper(
            jmodel, optimizer_configs=config["training"]["optimizer_configs"],
            cfg_dropout_prob=0.0, **opts)
        jmodel.diffusion_objective = objective
        step = jax.jit(jw._loss_and_grads)
    _PROGRAMS[name] = (jw, jw.init_state(), step)
    return _PROGRAMS[name]


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_pre_encoded_logit_normal_step_matches_jax(models, monkeypatch, scale):
    """`pre_encoded` (the batch holds latents, divided by the pretransform's
    scale; the port runs no encode, checked by making its encode raise),
    with logit-normal timesteps and `log_loss_info`: the loss per eighth of
    the sigma range against JAX's `loss_sigma_*` metrics. One JAX program
    at scale 1 serves both cases: at scale 2 it takes the latents halved,
    which is what the JAX step's division (:239-241) gives it."""
    config, _, sd = models["plain"]
    jw, state, step = _program(models, "pre_encoded")
    latents = np.random.RandomState(3).randn(2, LATENTS, 4).astype(np.float32)
    batch = jw.prepare_batch((latents / scale).transpose(0, 2, 1), METADATA)
    rng = jax.random.PRNGKey(31)
    (jloss, jaux), jgrads = step(state.params, batch, rng, state.qmc_counter, jw.frozen_arrays())

    tw = _port(config, sd, pre_encoded=True, timestep_sampler="logit_normal", log_loss_info=True)
    tw.model.pretransform.scale = scale
    monkeypatch.setattr(tw.model.pretransform, "encode_nwc", None)
    metrics = tw.train_step(_t(latents), METADATA,
                            draws=[_jax_draws(rng, "logit_normal", latents.shape)])
    _check_step(tw, jw, state, jloss, jgrads, metrics)
    buckets = sorted(k for k in jaux if k.startswith("loss_sigma_"))
    assert len(buckets) == 8 and sorted(k for k in metrics if k.startswith("loss_sigma_")) == buckets
    for k in buckets:
        assert abs(metrics[k] - float(jaux[k])) <= 1e-5 * max(float(jaux[k]), 1e-3), k
    assert sum(float(jaux[k]) > 0 for k in buckets) >= 1


def _padding_metadata(valid):
    """METADATA with the loader's padding masks: element i valid over its
    first valid[i] samples."""
    out = []
    for md, n in zip(METADATA, valid):
        pm = np.zeros(LATENTS * RATIO, np.float32)
        pm[:n] = 1
        out.append({**md, "padding_mask": pm})
    return out


def _key_with_dropout(drop, p):
    """A step key whose padding-dropout draw (JAX :243-245) is `drop` at p."""
    for seed in range(100):
        rng = jax.random.PRNGKey(seed)
        k_pdrop = jax.random.split(rng, 5)[4]
        if bool(jax.random.uniform(k_pdrop, ()) < p) == drop:
            return rng
    raise AssertionError("no key")


@pytest.mark.parametrize("drop", [False, True], ids=["mask-kept", "mask-dropped"])
def test_rectified_flow_mask_padding_step_matches_jax(models, monkeypatch, drop):
    """The rectified-flow objective with `mask_padding` (dropout 0.5, the
    JAX key chosen so that its draw keeps or drops the mask): the padding
    masks resampled to the latents, the DiT's self-attention masked (the
    plain route; the head-pair kernel's wrapper must not be called), the
    loss over the kept frames only, in both packages."""
    config, _, sd = models["plain"]
    jw, state, step = _program(models, "rf_mask")
    reals = _reals(6)
    metadata = _padding_metadata([LATENTS * RATIO, 13 * RATIO + 3])
    rng = _key_with_dropout(drop, 0.5)
    (jloss, _), jgrads = step(state.params, jw.prepare_batch(reals, metadata), rng,
                              state.qmc_counter, jw.frozen_arrays())

    tw = _port(config, sd, mask_padding=True, mask_padding_dropout=0.5)
    tw.model.diffusion_objective = "rectified_flow"
    draws = _jax_draws(rng, "uniform", (2, LATENTS, 4))
    draws["padding_dropout"] = drop  # a dropped mask is all True, and still a mask
    monkeypatch.setattr(attn_kernels, "fused_qkv_rope_attention",
                        lambda *a, **k: pytest.fail("a masked call reached the kernel"))
    metrics = tw.train_step(_t(reals).transpose(1, 2), metadata, draws=[draws])
    _check_step(tw, jw, state, jloss, jgrads, metrics)


def test_inpaint_step_matches_jax(models):
    """The `diffusion_cond_inpaint` trainer through the port's factory
    against JAX's own train step (its keep mask drawn by `random_mask` from
    the step key's first split, its gradients carried out of the jitted
    step), the port given that keep mask and the second key's draws."""
    config, _, sd = models["inpaint"]
    jw, state, step = _program(models, "inpaint")
    reals = _reals(8)
    rng = jax.random.PRNGKey(40)
    new_state, jmetrics = step(state, jw.prepare_batch(reals, METADATA), rng,
                               frozen=jw.frozen_arrays())
    rest, k_mask = jax.random.split(rng)
    keep = jw.random_mask(k_mask, (2, LATENTS))
    assert 0 < int(keep.sum()) < keep.size  # the key draws a mask that keeps some frames

    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    tw = create_training_wrapper_from_config({**config, "training": {
        **config["training"], "cfg_dropout_prob": 0.0}}, tmodel)
    assert isinstance(tw, tdiff.DiffusionCondInpaintTrainingWrapper)
    draws = {**_jax_draws(rest, "uniform", (2, LATENTS, 4)), "keep_mask": _t(keep)}
    metrics = tw.train_step(_t(reals).transpose(1, 2), METADATA, draws=[draws])
    _check_step(tw, jw, state, jmetrics["loss"], jmetrics["grads"], metrics, check_params=False)
    new_params = state_dict_from_jax(new_state.params["model"], "model.")
    for name in new_params:
        np.testing.assert_allclose(tw.trainable[name].detach().numpy(), new_params[name].numpy(),
                                   atol=1e-6)


def test_random_mask_kinds_hold_their_semantics():
    """`random_mask`'s rows (1 = keep): a segment mask regenerates at most
    `max_mask_segments` runs, each no longer than L // 1 and at least one
    frame; a full mask regenerates everything; a causal mask a non-empty
    suffix. All three kinds occur over 200 rows, as in the JAX package
    (held by its own draws of the same size)."""
    tw = tdiff.DiffusionCondInpaintTrainingWrapper.__new__(tdiff.DiffusionCondInpaintTrainingWrapper)
    tw.max_mask_segments = 4
    tw.generator = torch.Generator().manual_seed(0)
    tw.model = torch.nn.Module()
    tw.model.model = torch.nn.Linear(1, 1)
    length = 40

    def kinds(keep):
        out = []
        for row in keep:
            regen = ~row
            runs = int((regen[1:] & ~regen[:-1]).sum() + regen[0])
            if not row.any():
                out.append("full")
            elif regen.any() and bool(regen[int(row.sum()):].all()) and runs == 1 and row[0]:
                out.append("suffix")  # a kept prefix, then a regenerated suffix
            else:
                assert 1 <= runs <= tw.max_mask_segments, row
                out.append("segments")
        return out

    got = kinds(tw.random_mask(200, length).numpy())
    assert {"full", "suffix", "segments"} <= set(got)
    want = kinds(np.asarray(jdiff.DiffusionCondInpaintTrainingWrapper.random_mask(
        tw, jax.random.PRNGKey(0), (200, length))))
    assert {"full", "suffix", "segments"} <= set(want)
    for name in ("full", "suffix", "segments"):
        assert abs(got.count(name) - want.count(name)) <= 40, name  # ~67 each, uniform kinds


def test_timestep_draws_and_padding_resample_match_jax():
    """`draw_timesteps` from a generator: "uniform" is JAX's rotated
    quasi-random sequence for the generator's shift, "logit_normal" the
    sigmoid of its normals, any other name raises; `nearest_interp_mask`
    bit for bit against JAX's."""
    g = torch.Generator().manual_seed(5)
    got = tdiff.draw_timesteps("uniform", 6, 3, g, torch.device("cpu"))
    shift = torch.rand((), generator=torch.Generator().manual_seed(5))
    want = jdiff.quasirandom_uniform(jnp.uint32(3), 6, jnp.float32(shift.item()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tdiff.draw_timesteps("logit_normal", 6, 0, torch.Generator().manual_seed(5), "cpu")
    normals = torch.randn(6, generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.sigmoid(jnp.asarray(normals))),
                               atol=1e-7)
    with pytest.raises(ValueError):
        tdiff.draw_timesteps("cosine", 2, 0, g, "cpu")
    mask = np.random.RandomState(0).rand(3, 37) > 0.4
    for length in (5, 37, 64):
        np.testing.assert_array_equal(tdiff.nearest_interp_mask(_t(mask), length).numpy(),
                                      np.asarray(jdiff._nearest_interp_mask(jnp.asarray(mask),
                                                                            length)))


def test_masked_mse_matches_jax():
    rng = np.random.RandomState(1)
    a, b = rng.randn(2, 9, 3).astype(np.float32), rng.randn(2, 9, 3).astype(np.float32)
    mask = rng.rand(2, 9) > 0.5
    for m in (mask, np.zeros_like(mask), None):
        info = {"a": a, "b": b, "m": m}
        want = JMSELoss("a", "b", weight=2.0, mask_key="m")(
            {k: (None if v is None else jnp.asarray(v)) for k, v in info.items()})
        got = MSELoss("a", "b", weight=2.0, mask_key="m")(
            {k: (None if v is None else _t(v)) for k, v in info.items()})
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_masked_self_attention_matches_jax_and_stays_off_the_kernels(monkeypatch):
    """A key-masked attention call is JAX's `_xla_attention` (fp32 softmax,
    probabilities in v's dtype), and the gate sends it to the plain path
    even where the kernels are in use (no flash call), as JAX's gate does;
    an unmasked call of the same shape takes the flash route."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 2, 1040, 64).astype(np.float32) for _ in range(3))
    mask = rng.rand(2, 1040) > 0.3
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask=jnp.asarray(mask)[:, None, None, :])
    calls = []
    monkeypatch.setattr(tattention, "uses_kernels", lambda x: True)
    monkeypatch.setattr(tflash, "flash_forward", lambda *a, **kw: calls.append(1) or (a[0], None))
    got = tattention.scaled_dot_product_attention(_t(q), _t(k), _t(v), mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert calls == []
    tattention.scaled_dot_product_attention(_t(q), _t(k), _t(v))
    assert calls == [1]


DIT_BASE = dict(io_channels=4, embed_dim=128, depth=2, num_heads=2, cond_token_dim=16,
                global_cond_dim=8)


@pytest.mark.parametrize("case", ["input_concat", "prepend_mask", "patch2"])
def test_dit_conditioning_options_match_jax(case):
    """The DiT with input-concat (a shorter cond, nearest-resampled), prepend
    conditioning with its mask ahead of the global token, and patch size 2,
    each at CFG 1 without a frame mask and at CFG 3 with one, against JAX
    `DiffusionTransformer` on the same converted weights (the widened
    preprocess conv, `to_prepend_embed` and the patched projections carry
    over by utils/convert.py's rules)."""
    from friendly_stable_audio_tools_tpu.models.dit import DiffusionTransformer as JDiT
    from friendly_stable_audio_tools_tpu_torch.models.dit import DiffusionTransformer

    kw = {**DIT_BASE, **{"input_concat": {"input_concat_dim": 5},
                         "prepend_mask": {"prepend_cond_dim": 12},
                         "patch2": {"patch_size": 2}}[case]}
    rng = np.random.RandomState(0)
    b, t_len = 2, 24
    inputs = {"cross_attn_cond": rng.randn(b, 5, 16).astype(np.float32),
              "global_embed": rng.randn(b, 8).astype(np.float32)}
    if case == "input_concat":
        inputs["input_concat_cond"] = rng.randn(b, 12, 5).astype(np.float32)
    if case == "prepend_mask":
        inputs["prepend_cond"] = rng.randn(b, 3, 12).astype(np.float32)
        inputs["prepend_cond_mask"] = np.array([[True] * 3, [True, True, False]])
    x = rng.randn(b, t_len, 4).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)
    frames = np.ones((b, t_len), bool)
    frames[0, 19:] = False
    jdit = JDiT(**kw)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = dezero_params(jax.jit(jdit.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                              jnp.asarray(t), **jin)["params"])
    tdit = DiffusionTransformer(**kw)
    tdit.load_state_dict(state_dict_from_jax(params), strict=True)
    tdit.eval()
    for mask, cfg in ((None, 1.0), (frames, 3.0)):
        extra = {} if mask is None else {"mask": jnp.asarray(mask)}
        want = np.asarray(jax.jit(functools.partial(jdit.apply, cfg_scale=cfg))(
            {"params": params}, jnp.asarray(x), jnp.asarray(t), **extra, **jin))
        with torch.no_grad():
            got = tdit(_t(x), _t(t), mask=None if mask is None else _t(mask), cfg_scale=cfg,
                       **{k: _t(v) for k, v in inputs.items()})
        assert np.abs(want).max() > 0.1
        _close_rel(got, want, 2e-5)


def test_weight_norm_fold_matches_jax():
    """`remove_weight_norm_` on the tiny model's Oobleck VAE against the JAX
    package's `remove_weight_norm_from_model` on the same weights: every
    folded kernel to 1e-6 of its largest entry, the VAE's encode unchanged
    to 1e-5 relative, and the encode still going through the conv
    wrappers (now on `kernel`). The JAX fold tells a transposed conv from
    a conv by the gain's length, which cannot tell them apart where Cin ==
    Cout (this decoder's second upsample, 8 -> 8): there it folds per
    output channel. The port knows the layer and folds per input channel,
    the transposed conv's own weight norm, which holds the decode
    unchanged; that kernel is held to v * g / ||v|| over (k, Cout)."""
    from friendly_stable_audio_tools_tpu.models.utils import remove_weight_norm_from_model
    from friendly_stable_audio_tools_tpu_torch.models.autoencoders import (
        create_autoencoder_from_config,
    )
    from friendly_stable_audio_tools_tpu_torch.models.utils import remove_weight_norm_
    from friendly_stable_audio_tools_tpu_torch.ops.convs import WNConvTranspose1d
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d as tconv
    from friendly_stable_audio_tools_tpu_torch.utils.common import init_weights_

    config = tiny_train_config()
    pt = config["model"]["pretransform"]["config"]
    vae = init_weights_(create_autoencoder_from_config(
        {"model": pt, "sample_rate": config["sample_rate"]}),
        torch.Generator().manual_seed(0)).eval()
    x = torch.tensor(np.random.RandomState(0).randn(1, 64, 2).astype(np.float32))
    with torch.no_grad():
        before = vae.encode_nwc(x)
    jtree = {}
    for name, p in vae.state_dict().items():
        node = jtree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.numpy()
    folded = remove_weight_norm_from_model(jtree)
    transposed = {n for n, m in vae.named_modules() if isinstance(m, WNConvTranspose1d)}
    raw = vae.state_dict()
    remove_weight_norm_(vae)
    sd = vae.state_dict()
    assert not any(n.endswith((".v", ".g")) for n in sd)
    kernels = [n for n in sd if n.endswith(".kernel")]
    assert kernels
    ambiguous = 0
    for name in kernels:
        layer = name[:-len(".kernel")]
        v, g = raw[layer + ".v"], raw[layer + ".g"]
        if layer in transposed and v.shape[1] == v.shape[2]:
            ambiguous += 1
            want = v * (g / (v.square().sum(dim=(0, 2)).sqrt() + 1e-12))[None, :, None]
            _close_rel(sd[name], want.numpy(), 1e-6)
            continue
        node = folded
        for part in name.split("."):
            node = node[part]
        _close_rel(sd[name], node, 1e-6)
    assert ambiguous == 1
    calls = []
    real = tconv.snake_conv1d
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconv, "snake_conv1d", lambda *a, **k: calls.append(1) or real(*a, **k))
        with torch.no_grad():
            after = vae.encode_nwc(x)
    assert calls
    _close_rel(after, before.numpy(), 1e-5)


@pytest.mark.parametrize("model_type", ["diffusion_uncond", "diffusion_prior",
                                        "diffusion_autoencoder"])
def test_unported_trainers_name_their_queue_item(model_type, tmp_path):
    """The three trainers that were still to be ported (ROADMAP queue A 7)
    now train through the train CLI from a tiny config: 2 steps with a
    checkpoint each step and the demo at step 2 (its wavs), then a resume
    from the step-1 checkpoint that runs step 2 again."""
    import json

    from scipy.io import wavfile

    from friendly_stable_audio_tools_tpu_torch.train import main as train_main
    from tests.test_torch_dance_diffusion import tiny_dd_config
    from tests.test_torch_diffae_prior import tiny_diffae_config, tiny_prior_config

    config = {"diffusion_uncond": tiny_dd_config, "diffusion_prior": tiny_prior_config,
              "diffusion_autoencoder": tiny_diffae_config}[model_type]()
    config["training"]["checkpoint"] = {"every_n_train_steps": 1}
    (tmp_path / "model.json").write_text(json.dumps(config))
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.RandomState(3)
    for i in range(2):
        wavfile.write(str(wavs / f"clip{i}.wav"), config["sample_rate"],
                      (rng.randn(300, 2) * 3000).astype(np.int16))
    (tmp_path / "data.json").write_text(json.dumps(
        {"dataset_type": "audio_dir", "datasets": [{"id": "wavs", "path": str(wavs)}]}))
    args = ["--model-config", str(tmp_path / "model.json"), "--dataset-config",
            str(tmp_path / "data.json"), "--batch-size", "2", "--num-workers", "0",
            "--save-dir", str(tmp_path / "run"), "--name", "tiny", "--device", "cpu",
            "--max-steps", "2"]
    trainer = train_main(args)
    assert trainer.wrapper.step == 2
    want = {"diffusion_uncond": [f"demo_{i}.wav" for i in range(4)],
            "diffusion_prior": ["demo_cfg1_0.wav"],
            "diffusion_autoencoder": ["real_0.wav", "real_1.wav", "recon_0.wav",
                                      "recon_1.wav"]}[model_type]
    samples = os.path.join(trainer.save_dir, "samples", "2")
    assert sorted(n for n in os.listdir(samples) if n.endswith(".wav")) == want
    ckpt = os.path.join(trainer.ckpt_dir, "step_1")
    resumed = train_main(args + ["--ckpt-path", ckpt])
    assert resumed.wrapper.step == 2 and resumed.wrapper.qmc_counter == 4
