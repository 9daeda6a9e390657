"""The torch port's Stable Audio 1.0 training slice (the ADP U-Net trained
from raw audio through the frozen DAC encoder) against the JAX package.

Inputs and weights come from numpy with fixed seeds, or from the JAX
package's initialisers carried over by utils/convert.py; everything is fp32
on the CPU.

* K8, the single-pass attention backward: its plain version against
  `_flash_backward_fused` in Pallas interpret mode (FSAT_PALLAS_INTERPRET=1)
  at head dim 64 with kv_len < T and at head dim 80 at a length whose VMEM
  plan fits: rel-L2 <= 5e-5 (fp32 both sides, summation order only). The
  backward chooser takes K8's plain version exactly where `_bwd_fused_plan`
  fits.
* The attention route under grad: with the gate forced and the kernel
  launches replaced by the plain versions run without an autograd graph (as
  a CUDA kernel's output has none), `scaled_dot_product_attention` goes
  through `FlashAttention` (K7 with its LSE, then K8) under grad and through
  the serving K7 otherwise; its gradients match autograd of the plain
  attention to rel-L2 1e-6.
* `UNetCFG1d`'s CFG dropout against the JAX module (`rngs={"cfg": ...}`) at
  masks all-on, all-off and one mixed mask injected into both: rel-L2 <= 1e-5.
* The slice: one train step of `tiny_sa1_config()` (tests/test_torch_sa1.py)
  against the JAX `_loss_and_grads` and `_apply_update`, with the JAX step's
  timestep and noise draws passed into the port, at CFG dropout 0 and 1, and
  once with the attention gate forced on both sides at the U-Net's two T 1024
  self-attentions (JAX through its Pallas K7 and K8 in interpret mode, the
  port through `FlashAttention` on the plain versions). Tolerances: the loss
  to 1e-5 relative, every trainable gradient to 1e-4 of its own largest
  entry (fp32 rounding of XLA against PyTorch through the DAC encode, CLAP
  and the U-Net, forward and backward); parameters and EMA after the update
  to 1e-6, the JAX update taken on the port's gradients so that the two
  optimizer steps see the same input: the first Adam step moves each weight
  by about the learning rate (5e-4) times g / (|g| + eps), which magnifies
  the error of a near-zero gradient entry (on the JAX gradients one weight
  of this model lands 1.45e-06 apart). Then the whole chains, the JAX update
  on its own gradients against the port's step, per entry to 1e-6 plus what
  Adam's first step makes of the two gradients' difference there (its slope
  eps / (|g| + eps)^2 times the difference times the learning rate, at most
  twice the learning rate), which is wider than 2e-6 on at most 1e-4 of the
  entries.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friendly_stable_audio_tools_tpu.ops.attention as jattention
import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu.models import adp as jadp
from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.training.diffusion import DiffusionCondTrainingWrapper as JWrapper
from friendly_stable_audio_tools_tpu.training.diffusion import quasirandom_uniform as jax_qmc
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.models import adp as tadp
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.ops import attention as tattention
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash
from friendly_stable_audio_tools_tpu_torch.training.diffusion import DiffusionCondTrainingWrapper
from friendly_stable_audio_tools_tpu_torch.utils.convert import (
    convert_conditioned_diffusion,
    state_dict_from_jax,
)
from tests.test_torch_sa1 import LATENTS, RATIO, UNET, tiny_sa1_config


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _np(t):
    return t.detach().float().numpy()


def _rel(got, want):
    got = np.asarray(_np(got) if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(_np(want) if isinstance(want, torch.Tensor) else want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _launches():
    return (tflash.forward_launches, tflash.serving_launches, tflash.backward_launches,
            tflash.fused_backward_launches)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("FSAT_FUSED_BWD", raising=False)
    return monkeypatch


def _pad16(t):
    return (t + 15) // 16 * 16


# ---------------------------------------------------------------------------
# K8 and the backward chooser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bh,t,d,kv_len", [(3, 272, 64, 260), (2, 1024, 80, None)])
def test_flash_backward_fused_plain_matches_pallas(interpret, bh, t, d, kv_len):
    """dq, dk, dv against `_flash_backward_fused` (K8) from the same forward
    residuals, each rel-L2 <= 5e-5; with kv_len, the cotangent of the padded
    rows is zero (the transformer slices them off) and so are their dq, dk
    and dv."""
    assert jfa._bwd_fused_plan(t, _pad16(t), d) is not None
    rng = np.random.RandomState(t + d)
    q, k, v, g = (rng.randn(bh, t, d).astype(np.float32) for _ in range(4))
    if kv_len is not None:
        g[:, kv_len:] = 0
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, lse = jfa._flash_forward(jq, jk, jv, False, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                  save_stats=True, kv_len=kv_len)
    want = jfa._flash_backward_fused(jq, jk, jv, out, lse, jnp.asarray(g), kv_len or t)
    before = _launches()
    got = tflash.flash_backward_fused(_t(q), _t(k), _t(v), _t(out), _t(np.asarray(lse)[:, :t, 0]),
                                      _t(g), kv_len)
    assert _launches() == before  # CPU tensors launch nothing
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (bh, t, d) and a.dtype == torch.float32
        assert _rel(a, b) <= 5e-5, name
        if kv_len is not None:
            assert not _np(a)[:, kv_len:].any() and not np.asarray(b)[:, kv_len:].any(), name


@pytest.mark.parametrize("d", [64, 80])
def test_backward_takes_k8_plain_exactly_where_the_plan_fits(monkeypatch, d):
    """`flash_attention_backward` on CPU tensors over t = 16 .. 8192 in steps
    of 16 and a few ragged lengths: K8's plain version where the JAX
    `_bwd_fused_plan` fits, K9's elsewhere."""
    taken = []
    monkeypatch.setattr(tflash, "flash_backward_fused", lambda *a, **kw: taken.append("K8"))
    monkeypatch.setattr(tflash, "flash_backward", lambda *a, **kw: taken.append("K9"))
    seen = set()
    for t in list(range(16, 8193, 16)) + [1000, 1025, 1177, 4097, 6145]:
        x = torch.empty(1, t, d)
        tflash.flash_attention_backward(x, x, x, x, x[..., 0], x)
        want = "K8" if jfa._bwd_fused_plan(t, _pad16(t), d) is not None else "K9"
        assert taken.pop() == want, t
        seen.add(want)
    assert seen == {"K8", "K9"}
    for t in (1024, 2048, 4096):  # the U-Net's gated lengths at Stable Audio 1.0's widths
        assert tflash.backward_kernel(t, t, d) == "K8"


# ---------------------------------------------------------------------------
# the attention route under grad
# ---------------------------------------------------------------------------


def test_gated_attention_under_grad_goes_through_flash_attention(monkeypatch):
    """The U-Net's gated self-attention on the card: the kernel launches
    replaced by the plain versions run without an autograd graph, as a CUDA
    kernel writes its output through a raw pointer. Under grad the call must
    go through FlashAttention (K7 with its LSE, then K8 on the way back) and
    give autograd's gradients of the plain attention; without grad, or on
    tensors that need none, it takes the serving K7.

    First on meta tensors, which pass the device check as CUDA tensors do
    (not a CPU tensor): the route and the autograd graph, without values.
    Then on CPU tensors with `uses_kernels` forced (the function exists so
    that tests can force the kernel route there): the values."""
    calls = []

    def k7(q, k, v, kv_len=None, save_stats=True):
        calls.append(("K7", save_stats))
        with torch.no_grad():
            return tflash.flash_forward_plain(q, k, v, kv_len, save_stats)

    def k8(*args):
        calls.append(("K8",))
        return tflash.flash_backward_fused_plain(*args)

    monkeypatch.setattr(tflash, "flash_forward", k7)
    monkeypatch.setattr(tflash, "flash_backward_fused", k8, raising=False)  # new with K8
    q, k, v = (torch.empty(2, 2, 1024, 80, device="meta", requires_grad=True) for _ in range(3))
    out = tattention.scaled_dot_product_attention(q, k, v)
    assert out.grad_fn is not None, "the gated attention under grad has no autograd graph"
    grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert calls == [("K7", True), ("K8",)]
    assert all(gr.shape == (2, 2, 1024, 80) for gr in grads)
    calls.clear()

    monkeypatch.setattr(tattention, "uses_kernels", lambda x: True)
    rng = np.random.RandomState(21)
    q, k, v = (_t(rng.randn(2, 2, 1024, 80) * 0.5).requires_grad_(True) for _ in range(3))
    g = _t(rng.randn(2, 2, 1024, 80))
    assert tattention.flash_gate(1024, 1024, 80, False)

    out = tattention.scaled_dot_product_attention(q, k, v)
    assert calls == [("K7", True)]
    assert out.grad_fn is not None
    assert any("FlashAttention" in type(f).__name__ for f, _ in out.grad_fn.next_functions)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert calls == [("K7", True), ("K8",)]
    ref = tattention.attention(q, k, v)
    want = torch.autograd.grad(ref, (q, k, v), g)
    assert _rel(out, ref) <= 1e-6
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-6

    calls.clear()
    with torch.no_grad():
        served = tattention.scaled_dot_product_attention(q, k, v)
    detached = tattention.scaled_dot_product_attention(q.detach(), k.detach(), v.detach())
    assert calls == [("K7", False), ("K7", False)]
    assert _rel(served, ref) <= 1e-6 and _rel(detached, ref) <= 1e-6


# ---------------------------------------------------------------------------
# CFG dropout in UNetCFG1d
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proba,mask", [(1.0, None), (1e-12, None), (0.5, [True, False])])
def test_unet_cfg_dropout_matches_jax(monkeypatch, proba, mask):
    """Training forward with embedding_mask_proba > 0: all rows dropped
    (p = 1), none (p = 1e-12), and a mixed mask injected into both sides
    (the JAX draw replaced, the port's `cfg_dropout_mask`); the context mask
    stays as given. Rel-L2 <= 1e-5."""
    rng = np.random.RandomState(31)
    x = rng.randn(2, 256, 8).astype(np.float32)
    t = np.array([0.37, 0.81], np.float32)
    emb = rng.randn(2, 5, 24).astype(np.float32)
    emask = np.array([[True, True, True, False, True], [True, True, False, False, True]])
    jm = jadp.UNetCFG1d(**UNET)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(emb))["params"]
    params = dezero_params(params, seed=3)
    if mask is not None:
        drawn = jnp.asarray(mask)[:, None, None]
        monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: drawn)
    want = jax.jit(functools.partial(jm.apply, embedding_mask_proba=proba, train=True))(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb),
        embedding_mask=jnp.asarray(emask), rngs={"cfg": jax.random.PRNGKey(7)})
    tm = tadp.UNetCFG1d(**UNET)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    tm.train()
    with torch.no_grad():
        got = tm(_t(x), _t(t), _t(emb), embedding_mask=torch.tensor(emask),
                 embedding_mask_proba=proba,
                 cfg_dropout_mask=None if mask is None else torch.tensor(mask),
                 generator=torch.Generator().manual_seed(0))
        plain = tm.eval()(_t(x), _t(t), _t(emb), embedding_mask=torch.tensor(emask))
    assert got.shape == (2, 256, 8)
    assert _rel(got, want) <= 1e-5
    dropped = [proba == 1.0] * 2 if mask is None else mask
    for row, drop in enumerate(dropped):  # rows kept equal the forward without dropout
        assert (_rel(got[row], plain[row]) > 1e-3) == drop, row


# ---------------------------------------------------------------------------
# the slice: one train step against the JAX package
# ---------------------------------------------------------------------------

METADATA = [{"prompt": "A grand orchestral arrangement with thunderous percussion",
             "seconds_start": 12, "seconds_total": 95},
            {"prompt": "A cool 80s glam rock song", "seconds_start": 0, "seconds_total": 60}]


@pytest.fixture(scope="module")
def sa1_models():
    """The JAX package's tiny SA 1.0 model (random, de-zeroed) and its
    weights in the port's names."""
    config = tiny_sa1_config()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HF_HUB_OFFLINE", "1")  # the JAX tokenizer ladder would try the network
        jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.params = dezero_params(jmodel.params)
    jmodel.pretransform.model.params = dezero_params(jmodel.pretransform.model.params, seed=1)
    sd = convert_conditioned_diffusion(jmodel.params, jmodel.conditioner.params,
                                       jmodel.pretransform.model.params)
    return config, jmodel, sd


def _accelerator_gate():
    """`jax` as the JAX attention module sees it, on an accelerator backend:
    its gate then sends long self-attention to the Pallas flash kernels."""
    proxy = types.SimpleNamespace(**{n: getattr(jax, n) for n in dir(jax) if not n.startswith("__")})
    proxy.default_backend = lambda: "tpu"
    return proxy


def _flat(grads):
    """A JAX tree of the wrapper's trainable parameters (or their gradients)
    -> a dict in the port's names."""
    flat = state_dict_from_jax(grads["model"], "model.")
    for cid, tree in grads.get("conditioner", {}).items():
        flat.update(state_dict_from_jax(tree, f"conditioner.conditioners.{cid}."))
    return flat


@pytest.mark.parametrize("cfg_dropout_prob,forced", [(0.0, False), (1.0, False), (0.0, True)])
def test_one_sa1_train_step_matches_jax(sa1_models, monkeypatch, cfg_dropout_prob, forced):
    """One step at batch 2 from raw audio with SA 1.0's optimizer (Adam at
    the config's learning rate) and EMA. `forced`: the gate on both sides
    at the T 1024 levels (JAX: Pallas K7 with stats and K8 in interpret
    mode; port: FlashAttention on the plain versions, K8's on the way back)."""
    config, jmodel, sd = sa1_models
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    lr = config["training"]["learning_rate"]
    reals = np.random.RandomState(41).randn(2, 2, LATENTS * RATIO).astype(np.float32) * 0.3
    if forced:
        monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
        monkeypatch.delenv("FSAT_FUSED_BWD", raising=False)
        monkeypatch.delenv("FSAT_DISABLE_PALLAS_ATTN", raising=False)
        monkeypatch.setattr(jattention, "jax", _accelerator_gate())
        flash_calls, fused = [], jfa._flash_backward_fused
        monkeypatch.setattr(jfa, "_flash_backward_fused",
                            lambda *a, **kw: flash_calls.append(a[0].shape) or fused(*a, **kw))

    jw = JWrapper(jmodel, lr=lr, cfg_dropout_prob=cfg_dropout_prob)
    state = jw.init_state()
    rng = jax.random.PRNGKey(17)
    (jloss, _), jgrads = jax.jit(jw._loss_and_grads)(
        state.params, jw.prepare_batch(reals, METADATA), rng, state.qmc_counter,
        jw.frozen_arrays())

    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(sd, strict=True)
    tw = DiffusionCondTrainingWrapper(tmodel, lr=lr, cfg_dropout_prob=cfg_dropout_prob)
    k_t, k_noise, _, _, _ = jax.random.split(rng, 5)
    draws = {"t": _t(jax_qmc(jnp.uint32(0), 2, jax.random.uniform(k_t, (), jnp.float32))),
             "noise": _t(jax.random.normal(k_noise, (2, LATENTS, 8), jnp.float32))}
    if cfg_dropout_prob == 1.0:  # a drawn mask would be all True too; pass it explicitly
        draws["cfg_dropout_mask"] = torch.ones(2, dtype=torch.bool)
    routed = []
    if forced:
        monkeypatch.setattr(tattention, "uses_kernels", lambda x: True)
        for name in ("flash_forward", "flash_backward_fused", "flash_backward"):
            fn = getattr(tflash, name)
            monkeypatch.setattr(tflash, name, lambda *a, _fn=fn, _n=name, **kw: routed.append(
                (_n, tuple(a[0].shape))) or _fn(*a, **kw))
    metrics = tw.train_step(_t(reals).transpose(1, 2), METADATA, draws=[draws])

    if forced:  # the two T 1024 self-attentions (B 2 x 2 heads of 64), both sides
        assert flash_calls == [(4, 1024, 64)] * 2
        assert sorted(routed) == [("flash_backward_fused", (4, 1024, 64))] * 2 + \
            [("flash_forward", (4, 1024, 64))] * 2
    assert abs(metrics["loss"] - float(jloss)) <= 1e-5 * float(jloss)
    flat_grads = _flat(jgrads)
    assert sorted(flat_grads) == sorted(tw.trainable)  # the same trainable/frozen split
    assert not any(n.startswith("conditioner.conditioners.prompt.") for n in tw.trainable)
    assert any(n.startswith("conditioner.conditioners.seconds_total.") for n in tw.trainable)
    for name, p in tw.trainable.items():
        want = flat_grads[name].numpy()
        if np.abs(want).max() > 0:
            np.testing.assert_allclose(_np(p.grad), want, atol=1e-4 * np.abs(want).max() + 1e-12,
                                       err_msg=name)
        else:
            assert p.grad is None or not p.grad.any(), name

    # the JAX update on the port's gradients: the same optimizer input on both sides
    port = {n: np.zeros(p.shape, np.float32) if p.grad is None else _np(p.grad)
            for n, p in tw.trainable.items()}
    new_state, _ = jw._apply_update(state, 2, jloss, {}, _port_grads_as_jax(jgrads, port))
    new_params = _flat(new_state.params)
    new_ema = state_dict_from_jax(new_state.ema_params, "model.")
    for name, p in tw.trainable.items():
        np.testing.assert_allclose(_np(p), new_params[name].numpy(), atol=1e-6, err_msg=name)
    names = [f"model.{n}" for n, _ in tmodel.model.named_parameters()]
    for name, e in zip(names, tw.ema):
        np.testing.assert_allclose(e.numpy(), new_ema[name].numpy(), atol=1e-6, err_msg=name)
    assert tw.step == 1 and tw.qmc_counter == 2

    # the whole chains: the JAX update on its own gradients against the port's
    # step. Adam's first step moves a weight by lr * g / (|g| + eps), whose
    # slope in g is eps / (|g| + eps)^2, largest at the smallest |g| between
    # the two gradients (at g = 0 where their signs differ): two gradients dg
    # apart move the weight at most lr * dg * that slope apart, and at most
    # 2 lr. The EMA mixes the new weights with equal old ones, so the same
    # bound holds for it.
    jax_state, _ = jw._apply_update(state, 2, jloss, {}, jgrads)
    jax_params, jax_ema = _flat(jax_state.params), state_dict_from_jax(jax_state.ema_params, "model.")
    eps, tol, loose = 1e-8, {}, 0
    for name, p in tw.trainable.items():
        gj, gp = flat_grads[name].numpy().astype(np.float64), port[name].astype(np.float64)
        low = np.where(gj * gp > 0, np.minimum(np.abs(gj), np.abs(gp)), 0.0)
        tol[name] = 1e-6 + np.minimum(2 * lr, lr * np.abs(gj - gp) * eps / (low + eps) ** 2)
        loose += int((tol[name] > 2e-6).sum())
        err = np.abs(_np(p) - jax_params[name].numpy())
        assert (err <= tol[name]).all(), (name, float(err.max()))
    for name, e in zip(names, tw.ema):
        assert (np.abs(e.numpy() - jax_ema[name].numpy()) <= tol[name]).all(), name
    # the bound is 1e-6 nearly everywhere: it widens only at near-zero gradients
    assert loose <= 1e-4 * sum(p.numel() for p in tw.trainable.values()), loose


def _port_grads_as_jax(jgrads, port):
    """The JAX gradient tree with each leaf replaced by the port's gradient
    of the same parameter (utils/convert.py's naming; 2-D kernels transposed
    back)."""

    def leaf(path, x):
        keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        if keys[0] == "model":
            prefix, rest = "model.", keys[1:]
        else:
            prefix, rest = f"conditioner.conditioners.{keys[1]}.", keys[2:]
        nested = x
        for k in reversed(rest):
            nested = {k: nested}
        (name,) = state_dict_from_jax(nested, prefix)
        g = port[name]
        return jnp.asarray(g.T if rest[-1] == "kernel" and g.ndim == 2 else g)

    return jax.tree_util.tree_map_with_path(leaf, jgrads)
