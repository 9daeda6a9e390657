"""The torch port's head-split training attention (K7 forward with LSE, K9
two-pass backward, ops/kernels/flash_attention.py) and the route under grad
(ops/kernels/attention.py:training_route) against the JAX package.

Inputs come from numpy with fixed seeds, fp32 on both sides. The JAX side
runs its Pallas kernels in interpret mode (FSAT_PALLAS_INTERPRET=1, as
tests/test_pallas_kernels.py runs them), with its own test switches
FSAT_PAIR_BWD=0 (the unpack branch at a small T) and FSAT_FUSED_BWD=0 (K9
rather than K8) set where a case needs them. Both sides compute in fp32 and
differ only in summation order: the plain versions agree with the kernels'
functions to 1e-5 (forward, rel-L2) and 5e-5 (gradients, rel-L2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu.ops.embeddings import rotary_freqs as jax_rotary_freqs
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _np(t):
    return t.detach().float().numpy()


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want)


def _launches():
    return (tflash.forward_launches, tflash.backward_launches, tattn.stats_launches,
            tattn.backward_launches)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("FSAT_PAIR_BWD", raising=False)
    monkeypatch.delenv("FSAT_FUSED_BWD", raising=False)
    return monkeypatch


def _heads(rng, bh, t):
    return [rng.randn(bh, t, 64).astype(np.float32) * s for s in (1.0, 1.0, 1.0)]


SHAPES = [(3, 272, 260), (2, 1424, None)]


@pytest.mark.parametrize("bh,t,kv_len", SHAPES)
def test_flash_forward_plain_matches_pallas(interpret, bh, t, kv_len):
    """out rel-L2 <= 1e-5; the LSE (the JAX kernel's lane 0, unpadded rows)
    max abs <= 1e-5."""
    q, k, v = _heads(np.random.RandomState(t), bh, t)
    want_out, want_lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False,
                                            jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                            save_stats=True, kv_len=kv_len)
    before = _launches()
    out, lse = tflash.flash_forward(_t(q), _t(k), _t(v), kv_len)
    assert _launches() == before  # CPU tensors launch nothing
    assert out.shape == (bh, t, 64) and out.dtype == torch.float32 and lse.shape == (bh, t)
    assert _rel(_np(out), want_out) <= 1e-5
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse)[:, :t, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("bh,t,kv_len", SHAPES)
def test_flash_backward_plain_matches_pallas_two_pass(interpret, bh, t, kv_len):
    """dq, dk, dv against K9 (FSAT_FUSED_BWD=0), each rel-L2 <= 5e-5, from the
    same forward residuals; with kv_len, the cotangent of the padded rows is
    zero (the transformer slices them off) and so are their dq, dk and dv."""
    interpret.setenv("FSAT_FUSED_BWD", "0")
    rng = np.random.RandomState(t + 1)
    q, k, v = _heads(rng, bh, t)
    g = rng.randn(bh, t, 64).astype(np.float32)
    if kv_len is not None:
        g[:, kv_len:] = 0
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, lse = jfa._flash_forward(jq, jk, jv, False, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                  save_stats=True, kv_len=kv_len)
    want = jfa._flash_backward(jq, jk, jv, out, lse, jnp.asarray(g), False, jfa.DEFAULT_BLOCK_Q,
                               jfa.DEFAULT_BLOCK_K, kv_len=kv_len)
    got = tflash.flash_backward(_t(q), _t(k), _t(v), _t(out), _t(np.asarray(lse)[:, :t, 0]), _t(g),
                                kv_len)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (bh, t, 64) and a.dtype == torch.float32
        assert _rel(_np(a), b) <= 5e-5, name
        if kv_len is not None:
            assert not _np(a)[:, kv_len:].any() and not np.asarray(b)[:, kv_len:].any(), name


@pytest.mark.parametrize("kv_len", [None, 90])
def test_flash_attention_function_matches_autograd_of_plain_attention(kv_len):
    """FlashAttention (K7 forward, K9 backward; their plain versions on the
    CPU) against torch autograd of softmax(q k^T / 8 + mask) v in fp32:
    output and gradients to rel-L2 1e-6."""
    rng = np.random.RandomState(5)
    q, k, v = (_t(x).requires_grad_(True) for x in _heads(rng, 3, 100))
    g = _t(rng.randn(3, 100, 64))
    out = tflash.FlashAttention.apply(q, k, v, kv_len)
    got = torch.autograd.grad(out, (q, k, v), g)
    s = q @ k.transpose(-1, -2) / 8.0
    if kv_len is not None:
        s = s.masked_fill(torch.arange(100) >= kv_len, -float("inf"))
    ref = torch.softmax(s, dim=-1) @ v
    want = torch.autograd.grad(ref, (q, k, v), g)
    assert _rel(_np(out), _np(ref)) <= 1e-6
    for a, b in zip(got, want):
        assert _rel(_np(a), _np(b)) <= 1e-6


def test_training_route_and_backward_choice_match_the_reference(monkeypatch):
    """Over t = 16 .. 8192 in steps of 16 and 1168, 1169, 6145, 6272 at head
    dim 64 and 24 heads: "pair" exactly where `_pair_bwd_eligible` holds, and
    K8's plan (so the K8/K9 choice) exactly as `_bwd_fused_plan` gives it."""
    monkeypatch.delenv("FSAT_PAIR_BWD", raising=False)
    lengths = list(range(16, 8193, 16)) + [1168, 1169, 6145, 6272]
    routes = {}
    for t in lengths:
        want = "pair" if jfa._pair_bwd_eligible(t, 64, 24) else "flash"
        assert tattn.training_route(t, 64, 24) == want, t
        t_kp = (t + 15) // 16 * 16
        assert tflash.bwd_fused_plan(t, t_kp, 64) == jfa._bwd_fused_plan(t, t_kp, 64), t
        routes[t] = (want, tflash.backward_kernel(t, t, 64))
    assert routes[1168] == ("pair", "K8") and routes[1169][0] == "flash"
    assert routes[6272] == ("flash", "K9") and routes[1424] == ("flash", "K9")
    assert routes[1184] == ("flash", "K8")
    assert tattn.training_route(1040, 32, 24) == tattn.training_route(1040, 64, 3) == "flash"


@pytest.mark.parametrize("b,t,h,kv_len,forced", [(2, 272, 4, 260, True), (1, 1184, 2, None, False),
                                                 (1, 1424, 2, None, False)])
def test_fused_attention_under_grad_matches_jax_unpack_branch(interpret, b, t, h, kv_len, forced):
    """The port's `fused_qkv_rope_attention` under grad against jax.grad
    through `_fused_pair` (the unpack branch: rope outside, K7 with stats, K9
    or K8, unrope) on fp32 qkv: dqkv rel-L2 <= 5e-5. At T = 272 both sides
    are switched to that branch (FSAT_PAIR_BWD=0 / FSAT_FUSED_BWD=0 for JAX,
    the route for the port), mirroring
    test_pair_layout_backward_matches_unpack_path; T = 1184 (K8 on the JAX
    side) and 1424 (K9) take it by length."""
    if forced:
        interpret.setenv("FSAT_PAIR_BWD", "0")
        interpret.setenv("FSAT_FUSED_BWD", "0")
        interpret.setattr(tattn, "training_route", lambda *a: "flash")
    rng = np.random.RandomState(t + 2)
    qkv = rng.randn(b, t, 3 * h * 64).astype(np.float32) * 0.5
    freqs = np.asarray(jax_rotary_freqs(t, 32))
    g = rng.randn(b, t, h * 64).astype(np.float32)
    if kv_len is not None:
        g[:, kv_len:] = 0

    def loss(x):
        return jnp.sum(jfa._fused_pair(x, jnp.asarray(freqs), h, kv_len) * jnp.asarray(g))

    want = np.asarray(jax.grad(loss)(jnp.asarray(qkv)))
    x = _t(qkv).requires_grad_(True)
    before = _launches()
    out = tattn.fused_qkv_rope_attention(x, _t(freqs), h, kv_len)
    assert "FusedQKVFlashAttention" in type(out.grad_fn).__name__
    out.backward(_t(g))
    assert _launches() == before
    assert x.grad.dtype == torch.float32 and _rel(_np(x.grad), want) <= 5e-5
    if kv_len is not None:
        assert not _np(x.grad)[:, kv_len:].any()
