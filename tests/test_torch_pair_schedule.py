"""The schedules of the head-pair attention kernels (csrc/attention.cu: K1,
K5, K10; csrc/attention_bwd.cu: K6), written out in plain torch at small
sizes and held against the plain versions, and through them against the
JAX package.

The forward kernel streams key tiles through an online base-2 softmax; the
backward takes q^ and k^ precomputed (K10a), loops over key blocks outside
and q tiles inside, sums dq over the key blocks in fp32 before one unrope
and unropes dk once per key block. In fp32 nothing is rounded, so each
emulation equals the plain formula up to summation order: rel-L2 1e-5. At
bf16 inputs the backward emulation is held against jax.grad through the
Pallas `_pair_backward` in interpret mode (FSAT_PALLAS_INTERPRET=1) as
tests/test_torch_train_kernels.py holds the plain version: 1e-2 of the
largest gradient. K10a's plain versions give `_roped_operands`' q^ and k^
bit for bit. Inputs come from numpy with fixed seeds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu.ops.embeddings import rotary_freqs as jax_rotary_freqs
from friendly_stable_audio_tools_tpu_torch.ops.embeddings import (
    apply_rotary_pos_emb_transpose,
    rotary_freqs,
)
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn

# the kernels' tiles: keys per forward stage, keys per backward block, q rows
# per backward tile (csrc/attention.cu kN, csrc/attention_bwd.cu kKeys, kQ)
KEY_TILE, KEY_BLOCK, Q_TILE = 128, 128, 64
# (B, T, H, kv_len): T not a multiple of 64 or 128, masked tails, one q tile
RAGGED = [(2, 77, 2, None), (2, 200, 4, 190), (1, 130, 2, 129), (2, 272, 4, 260)]


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _heads(x, h):
    b, t, hd = x.shape
    return x.float().view(b, t, h, hd // h).transpose(1, 2)


def _merge(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def forward_schedule(qkv, freqs, h, kv_len=None):
    """The forward kernel's schedule: k^ from K10a, q^ roped once, key tiles
    of KEY_TILE through an online base-2 softmax (running max and sum in
    fp32, P rounded per tile against the running max) -> (out, lse)."""
    dt = qkv.dtype
    b, t, three_hd = qkv.shape
    hd = three_hd // 3
    valid = kv_len or t
    q = _heads(tattn.rope_pair_q_plain(qkv, freqs, h), h)
    k = _heads(tattn.rope_pair_k_plain(qkv, freqs, h), h)
    v = _heads(qkv[..., 2 * hd:], h)
    m = torch.full((b, h, t, 1), -math.inf)
    l = torch.zeros(b, h, t, 1)
    o = torch.zeros(b, h, t, hd // h)
    for k0 in range(0, valid, KEY_TILE):
        k1 = min(k0 + KEY_TILE, valid)
        s = q @ k[..., k0:k1, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(dt).float() @ v[..., k0:k1, :]
        m = m_new
    l = l.clamp_min(1e-30)
    return _merge(o / l).to(dt), (m + torch.log2(l)).squeeze(-1)


def backward_schedule(qkv, out, lse, grad_out, freqs, h, kv_len=None):
    """K6's schedule: q^ and k^ precomputed (K10a's plain versions), key
    blocks outer and q tiles inner, dK/dV held per key block and unroped
    there, dq's partials summed in fp32 over the key blocks, unroped once."""
    dt = qkv.dtype
    b, t, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // h
    valid = kv_len or t
    f = freqs[-t:]
    q = _heads(tattn.rope_pair_q_plain(qkv, freqs, h), h)
    k = _heads(tattn.rope_pair_k_plain(qkv, freqs, h), h)
    v = _heads(qkv[..., 2 * hd:], h)
    do = _heads(grad_out.to(dt), h)
    delta = (do * _heads(out.to(dt), h)).sum(-1)
    lse = lse.float()
    dq_acc = torch.zeros(b, h, t, d)
    dk, dv = torch.zeros(b, h, t, d), torch.zeros(b, h, t, d)
    for k0 in range(0, t, KEY_BLOCK):
        k1 = min(k0 + KEY_BLOCK, t)
        kb, vb = k[..., k0:k1, :], v[..., k0:k1, :]
        live = (torch.arange(k0, k1) < valid)[:, None]
        dk_b, dv_b = torch.zeros(b, h, k1 - k0, d), torch.zeros(b, h, k1 - k0, d)
        for q0 in range(0, t, Q_TILE):
            q1 = min(q0 + Q_TILE, t)
            st = kb @ q[..., q0:q1, :].transpose(-1, -2)
            pt = torch.where(live, torch.exp2(st - lse[..., None, q0:q1]), 0.0)
            dpt = vb @ do[..., q0:q1, :].transpose(-1, -2)
            dst = (pt * (dpt - delta[..., None, q0:q1])).to(dt).float()
            dv_b += pt.to(dt).float() @ do[..., q0:q1, :]
            dk_b += dst @ q[..., q0:q1, :]
            dq_acc[..., q0:q1, :] += dst.transpose(-1, -2) @ kb
        dk[..., k0:k1, :] = apply_rotary_pos_emb_transpose(dk_b, f[k0:k1]) / tattn.LOG2E
        dv[..., k0:k1, :] = dv_b
    dq = apply_rotary_pos_emb_transpose(dq_acc, f) / math.sqrt(d)
    return torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)


@pytest.mark.parametrize("b,t,h,kv_len", RAGGED)
def test_forward_schedule_matches_plain_in_fp32(b, t, h, kv_len):
    qkv = _t(np.random.RandomState(t).randn(b, t, 3 * h * 64) * 0.5)
    freqs = rotary_freqs(t, 32)
    out, lse = forward_schedule(qkv, freqs, h, kv_len)
    want_out, want_lse = tattn.fused_qkv_rope_attention_stats_plain(qkv, freqs, h, kv_len)
    assert _rel(out, want_out) < 1e-5
    np.testing.assert_allclose(_np(lse), _np(want_lse), atol=1e-5)


@pytest.mark.parametrize("b,t,h,kv_len", RAGGED)
def test_backward_schedule_matches_plain_in_fp32(b, t, h, kv_len):
    rng = np.random.RandomState(100 + t)
    qkv = _t(rng.randn(b, t, 3 * h * 64) * 0.5)
    freqs = rotary_freqs(t, 32)
    g = _t(rng.randn(b, t, h * 64))
    if kv_len is not None:
        g[:, kv_len:] = 0  # the transformer slices padded rows off
    out, lse = tattn.fused_qkv_rope_attention_stats_plain(qkv, freqs, h, kv_len)
    got = backward_schedule(qkv, out, lse, g, freqs, h, kv_len)
    want = tattn.fused_qkv_rope_attention_backward_plain(qkv, out, lse, g, freqs, h, kv_len)
    assert _rel(got, want) < 1e-5
    for i in range(3):  # each third on its own: dq, dk, dv
        sl = slice(i * h * 64, (i + 1) * h * 64)
        assert _rel(got[..., sl], want[..., sl]) < 1e-5


def test_backward_schedule_matches_jax_grad_through_pallas(monkeypatch):
    """At bf16 inputs (B 2, T 272 padded, kv_len 260, more than one q block
    on the JAX side) against jax.grad through `_fused_pair` (stats forward +
    `_pair_backward` in interpret mode): 1e-2 of the largest gradient, the
    tolerance of the plain version there; padded rows get exactly zero."""
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    b, t, h, kv_len = 2, 272, 4, 260
    rng = np.random.RandomState(9)
    qkv = _t(rng.randn(b, t, 3 * h * 64) * 0.5, torch.bfloat16)
    freqs = np.asarray(jax_rotary_freqs(t, 32))
    g = _t(rng.randn(b, t, h * 64), torch.bfloat16)
    g[:, kv_len:] = 0

    def loss(x):
        out = jfa._fused_pair(x, jnp.asarray(freqs), h, kv_len)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(_np(g)))

    want = np.asarray(jax.grad(loss)(jnp.asarray(_np(qkv))))
    out, lse = tattn.fused_qkv_rope_attention_stats_plain(qkv, _t(freqs), h, kv_len)
    got = _np(backward_schedule(qkv, out, lse, g, _t(freqs), h, kv_len))
    np.testing.assert_allclose(got, want, atol=1e-2 * np.abs(want).max())
    assert np.abs(got[:, kv_len:]).max() == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,h", [(2, 77, 2), (1, 130, 4)])
def test_precomputed_operands_are_the_kernels_operands_bit_for_bit(dtype, b, t, h):
    """K10a's plain versions for k (scale 1) and for q (prescale
    log2(e)/sqrt(64), K6's q^) give exactly `_roped_operands`' k^ and q^,
    the operands of the plain forward and backward; on CPU tensors the K10a
    wrapper takes its plain version and counts no launch."""
    qkv = _t(np.random.RandomState(t).randn(b, t, 3 * h * 64), dtype)
    freqs = rotary_freqs(t + 3, 32)  # the last t rows are used
    want_q, want_k, _ = tattn._roped_operands(qkv, freqs, h)
    before = tattn.rope_k_launches
    q = tattn.rope_pair_q_plain(qkv, freqs, h)
    k = tattn.rope_pair_k(qkv, freqs, h)
    assert tattn.rope_k_launches == before
    assert q.dtype == dtype and k.dtype == dtype and q.shape == (b, t, h * 64)
    assert torch.equal(_heads(q, h), want_q)
    assert torch.equal(_heads(k, h), want_k)
