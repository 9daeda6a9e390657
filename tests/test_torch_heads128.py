"""The DiT self-attention at heads the head-pair kernels do not take (head
dim 128, or an odd head count) in the torch port, against the JAX package:
the route (ops/kernels/attention.py:attention_route and the entry point's
dispatch) against the JAX gate (flash_attention.py:1413-1452), the rope-fused
K7's plain version (ops/kernels/flash_attention.py:flash_rope_attention)
against `flash_attention(q, k, v, freqs=...)` (`_single_dot_rope_kernel`), and
the fp32 K7 with its LSE and K8 at head dim 128 against `_flash_forward` and
`_flash_backward_fused`.

Inputs come from numpy with fixed seeds. The JAX side runs its Pallas kernels
in interpret mode (FSAT_PALLAS_INTERPRET=1). Tolerances, with their reasons:
- the rope-fused K7 in fp32: rel-L2 1e-4. Both sides round the roped q and
  k to bf16; an fp32 rounding difference before that rounding may move one
  roped element by a bf16 step (2^-8 relative), which shows at ~3e-5; with
  none moved the two agree to ~3e-7 (summation order).
- the rope-fused K7 in bf16: one bf16 rounding of the output, max abs
  2^-7 of the output's peak and rel-L2 4e-3 (the plain version and the
  interpret-mode kernel accumulate in fp32 in different orders and round
  P and the output to bf16).
- the fp32 K7 and K8 at head dim 128: rel-L2 1e-5 (out; the LSE max abs
  1e-5) and 5e-5 (dq, dk, dv): fp32 on both sides, summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu.ops.embeddings import rotary_freqs as jax_rotary_freqs
from friendly_stable_audio_tools_tpu_torch.ops import attention as tattention
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want)


def _launches():
    return (tflash.rope_launches, tflash.d128_launches, tflash.d128_fused_backward_launches,
            tflash.serving_launches, tflash.serving_bf16_launches, tattn.launches)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("FSAT_FUSED_BWD", raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


def _jax_route(monkeypatch, b, t, h, d, kv_len):
    """(route, T) that the JAX package's `fused_qkv_rope_attention` reaches on
    the accelerator (its XLA fallback off), traced abstractly: "pair" (K1's
    `_fused_pair`), "pair_long", "rope_flash" (`_flash_rope`: the rope-fused
    K7) or "flash" (rope outside, then `_flash`), with the length it ran at."""
    seen = []

    def recorder(name):
        def fn(x, *a, **k):
            seen.append((name, x.shape[1]))
            return jnp.zeros(x.shape[:2] + ((h * d,) if name.startswith("pair") else x.shape[2:]),
                             x.dtype)
        return fn

    monkeypatch.setattr(jfa, "_use_xla_fallback", lambda: False)
    for attr, name in (("_fused_pair", "pair"), ("_pair_long", "pair_long"),
                       ("_flash_rope", "rope_flash"), ("_flash", "flash")):
        monkeypatch.setattr(jfa, attr, recorder(name))
    qkv = jax.ShapeDtypeStruct((b, t, 3 * h * d), jnp.float32)
    freqs = jax.ShapeDtypeStruct((t, max(d // 2, 32)), jnp.float32)
    jax.eval_shape(lambda x, f: jfa.fused_qkv_rope_attention(x, f, h, kv_len=kv_len), qkv, freqs)
    assert len(seen) == 1, seen
    return seen[0]


def _port_route(monkeypatch, b, t, h, d, kv_len):
    """(route, T) that the port's `fused_qkv_rope_attention` reaches on CPU
    tensors with the kernels' route forced (ops/attention.py's `uses_kernels`), its leaves
    replaced by recorders; checks that the padded rows come back as zeros."""
    seen = []

    def recorder(name):
        def fn(qkv, *a, **k):
            seen.append((name, qkv.shape[1]))
            return torch.ones(qkv.shape[0], qkv.shape[1], h * d)
        return fn

    monkeypatch.setattr(tattention, "uses_kernels", lambda x: True)
    for mod, attr, name in ((tattn, "fused_qkv_rope_attention_plain", "pair"),
                            (tattn, "fused_qkv_rope_attention_long", "pair_long"),
                            (tflash, "flash_rope_attention", "rope_flash"),
                            (tattn, "fused_qkv_rope_attention_split", "flash")):
        monkeypatch.setattr(mod, attr, recorder(name))
    out = tattn.fused_qkv_rope_attention(torch.zeros(b, t, 3 * h * d),
                                         torch.zeros(t, max(d // 2, 32)), h, kv_len)
    assert len(seen) == 1 and out.shape == (b, t, h * d), seen
    assert bool(out[:, :seen[0][1]].all()) and not out[:, seen[0][1]:].any()
    assert tattn.attention_route(seen[0][1], d, h) == seen[0][0]
    return seen[0]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h", [2, 3])
def test_route_matches_the_jax_gate(monkeypatch, d, h):
    """At T 16, 1026, 2048 and 2049, unpadded and with kv_len 5 below T: the
    port reaches the kernel the JAX gate reaches, at the same length (heads
    other than an even count of 64 run at their true length); only heads of
    64 in an even count take the head-pair kernels, so a DiT at head dim 64
    with an odd head count no longer reaches K1."""
    for t in (16, 1026, 2048, 2049):
        for kv_len in (None, t - 5):
            want = _jax_route(monkeypatch, 1, t, h, d, kv_len)
            assert _port_route(monkeypatch, 1, t, h, d, kv_len) == want, (t, kv_len)
            if d == 64 and h == 2 and t <= 2048:
                assert want[0] == "pair"
            if d == 128 or h == 3:
                assert want == (("rope_flash" if (kv_len or t) <= 2048 else "flash"), kv_len or t)


def test_cpu_route_keeps_the_jax_cpu_path_unless_forced():
    """On CPU tensors, without the kernels' route forced, heads of 128 take the
    JAX package's CPU path (rope outside, the attention in fp32: K1's plain
    version), whose q and k are not rounded to bf16; forced, the rope-fused
    K7's plain version, which rounds them. No launches either way."""
    rng = np.random.RandomState(3)
    qkv, freqs = _t(rng.randn(2, 40, 3 * 2 * 128)), _t(jax_rotary_freqs(40, 64))
    before = _launches()
    got = tattn.fused_qkv_rope_attention(qkv, freqs, 2)
    assert torch.equal(got, tattn.fused_qkv_rope_attention_plain(qkv, freqs, 2))
    forced = tflash.flash_rope_attention(qkv, freqs, 2)
    assert 1e-6 < _rel(_np(forced), _np(got)) < 1e-2
    assert _launches() == before


# ---------------------------------------------------------------------------
# the rope-fused K7
# ---------------------------------------------------------------------------


# (head dim, heads, rotary dim, T, dtype): SAO's 12 heads of 128 at rot 64 as
# two heads; a DiT at head dim 64 with 3 heads (rot 32); rot 32 at head dim
# 128; T 256 (two 128-row q tiles of the JAX kernel) and ragged T
ROPE_CASES = [(128, 2, 64, 256, "fp32"), (128, 2, 64, 150, "bf16"), (128, 2, 64, 150, "fp32"),
              (128, 2, 32, 150, "fp32"), (64, 3, 32, 150, "fp32"), (64, 3, 32, 256, "bf16"),
              (64, 3, 32, 256, "fp32")]


@pytest.mark.parametrize("d,h,rot,t,dt", ROPE_CASES)
def test_rope_fused_k7_plain_matches_pallas(interpret, d, h, rot, t, dt):
    rng = np.random.RandomState(d + t + rot)
    qkv = rng.randn(2, t, 3 * h * d).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dt == "bf16" else (jnp.float32, torch.float32)
    x = jnp.asarray(qkv).astype(jdt)
    freqs = np.asarray(jax_rotary_freqs(t, rot))

    def heads(a):
        return a.reshape(2, t, h, d).transpose(0, 2, 1, 3)

    q, k, v = jnp.split(x, 3, axis=-1)
    want = jfa.flash_attention(heads(q), heads(k), heads(v), freqs=jnp.asarray(freqs))
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3).reshape(2, t, h * d)
    before = _launches()
    got = tflash.flash_rope_attention(_t(np.asarray(x.astype(jnp.float32)), tdt), _t(freqs), h)
    assert _launches() == before  # CPU tensors launch nothing
    assert got.dtype == tdt and got.shape == (2, t, h * d)
    if dt == "bf16":
        assert np.abs(_np(got) - want).max() <= 2.0 ** -7 * np.abs(want).max()
        assert _rel(_np(got), want) <= 4e-3
    else:
        assert _rel(_np(got), want) <= 1e-4


def test_rope_pass_plain_rounds_the_roped_operands_to_bf16():
    """The rope pass's plain version: v split into heads as it is; q^ and k^
    bf16 values (also for fp32 input); dims past the rotary dim are k itself
    and q times log2(e)/sqrt(D)."""
    rng = np.random.RandomState(4)
    b, t, h, d, rot = 2, 9, 3, 64, 32
    qkv = _t(rng.randn(b, t, 3 * h * d))
    q, k, v = tflash.rope_heads_plain(qkv, _t(jax_rotary_freqs(t, rot)), h)
    split = qkv.view(b, t, 3, h, d).permute(2, 0, 3, 1, 4).reshape(3, b * h, t, d)
    assert torch.equal(v, split[2])
    for x in (q, k):
        assert x.dtype == torch.float32 and torch.equal(x, x.to(torch.bfloat16).float())
    assert torch.equal(k[..., rot:], split[1][..., rot:].to(torch.bfloat16).float())
    scaled = (split[0][..., rot:] * (tflash.LOG2E / 8.0)).to(torch.bfloat16).float()
    assert torch.equal(q[..., rot:], scaled)


# ---------------------------------------------------------------------------
# the fp32 K7 and K8 at head dim 128
# ---------------------------------------------------------------------------


# (BH, T, kv_len): SAO's T 1025 is [3n]'s on the card; here a ragged T past
# two 64-row tiles with kv_len one key into the last 32-key block, and T
# below one tile
D128_CASES = [(2, 150, 129), (3, 50, None)]


@pytest.mark.parametrize("bh,t,kv_len", D128_CASES)
def test_flash_forward_at_head_dim_128_matches_pallas(interpret, bh, t, kv_len):
    rng = np.random.RandomState(t + 128)
    q, k, v = (rng.randn(bh, t, 128).astype(np.float32) for _ in range(3))
    want_out, want_lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False,
                                            jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                            save_stats=True, kv_len=kv_len)
    before = _launches()
    out, lse = tflash.flash_forward(_t(q), _t(k), _t(v), kv_len)
    assert _launches() == before
    assert out.shape == (bh, t, 128) and lse.shape == (bh, t)
    assert _rel(_np(out), want_out) <= 1e-5
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse)[:, :t, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("bh,t,kv_len", D128_CASES)
def test_flash_backward_fused_at_head_dim_128_matches_pallas(interpret, bh, t, kv_len):
    """K8's plain version against `_flash_backward_fused` from the JAX
    forward's out and lse; dO zero on the padded rows, as on the
    transformer's path; K8's plan fits, so the backward the port chooses is
    K8."""
    rng = np.random.RandomState(t + 129)
    q, k, v, g = (rng.randn(bh, t, 128).astype(np.float32) for _ in range(4))
    if kv_len is not None:
        g[:, kv_len:] = 0
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, lse = jfa._flash_forward(jq, jk, jv, False, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                  save_stats=True, kv_len=kv_len)
    want = jfa._flash_backward_fused(jq, jk, jv, out, lse, jnp.asarray(g), kv_len or t)
    assert tflash.backward_kernel(t, t, 128) == "K8"
    inputs = (_t(q), _t(k), _t(v), _t(out), _t(np.asarray(lse)[:, :t, 0]), _t(g))
    before = _launches()
    got = tflash.flash_attention_backward(*inputs, kv_len)
    assert _launches() == before
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (bh, t, 128)
        assert _rel(_np(a), np.asarray(b)[:, :t]) <= 5e-5, name


def test_sao_heads_128_takes_k8_and_the_rope_fused_k7():
    """SAO 1.0's DiT with 12 heads of 128 at T 1025 (1024 latent frames and
    the prepended global token: the padding rule would pad 12%, above its 4%,
    so the sequence runs unpadded): the rope-fused K7 without grad, the
    unpack route under grad, and K8 there (its plan fits: 1040 q rows in 2
    blocks of 520); the kernels take head dim 128 on the card."""
    from friendly_stable_audio_tools_tpu_torch.models.transformer import seq_pad_length

    assert seq_pad_length(1025, 2, 128, 12) is None and seq_pad_length(1025, 8, 128, 12) is None
    assert tattn.attention_route(1025, 128, 12) == "rope_flash"
    assert tattn.training_route(1025, 128, 12) == "flash"
    assert tflash.bwd_fused_plan(1025, 1040, 128) == jfa._bwd_fused_plan(1025, 1040, 128) == (
        1040, 520)
    assert tflash.backward_kernel(1025, 1025, 128) == "K8"
    tflash.check_backward_head_dim(1025, 1025, 128)
    for dims in (tflash.FLASH_HEAD_DIMS, tflash.BF16_HEAD_DIMS, tflash.FUSED_BACKWARD_HEAD_DIMS,
                 tflash.ROPE_HEAD_DIMS):
        assert 128 in dims
    meta = torch.empty(96, 1026, 128, device="meta")
    assert tflash._cuda_args("flash_backward_fused", meta, meta,
                             head_dims=tflash.FUSED_BACKWARD_HEAD_DIMS)
    with pytest.raises(NotImplementedError, match="queue B"):  # K9 at D 128 stays to port
        tflash._cuda_args("flash_backward", meta)
