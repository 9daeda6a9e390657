"""The torch port's kernels (friendly_stable_audio_tools_tpu_torch/ops/kernels/)
against the JAX package's Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold that version against the JAX function run in Pallas interpret mode
(FSAT_PALLAS_INTERPRET=1, as tests/test_pallas_kernels.py runs it) and
against the JAX package's XLA reference, on the same inputs made with numpy.
Tolerances: fp32 inputs agree with the XLA reference to 1e-4 (2e-3 where the
Pallas kernel itself rounds to bf16, the bound of the JAX package's own
kernel tests); bf16 inputs agree with interpret mode to one bf16 rounding of
the output, 1e-2 at the |y| ~ 1 scale used here.

tests/test_torch_port_cuda.py holds the CUDA kernels against the plain
versions on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.ops.embeddings import rotary_freqs as jax_rotary_freqs
from friendly_stable_audio_tools_tpu.ops.pallas import conv1d as jconv
from friendly_stable_audio_tools_tpu.ops.pallas import flash_attention as jfa
from friendly_stable_audio_tools_tpu_torch.ops.embeddings import apply_rotary_pos_emb
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
from friendly_stable_audio_tools_tpu_torch.ops.kernels import build as tbuild
from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d as tconv


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy()


def _bf16_values(a):
    """numpy fp32 array holding bf16-representable values."""
    return _np(_t(a, torch.bfloat16))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")


def _snake_params(rng, c):
    return (np.abs(rng.randn(c)) + 0.5).astype(np.float32), (np.abs(rng.randn(c)) + 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# snake (shared by K2-K4)
# ---------------------------------------------------------------------------


def test_snake_polynomial_matches_jax_and_exact_form():
    rng = np.random.RandomState(0)
    x = rng.randn(4096).astype(np.float32) * 4
    a, ib = _snake_params(rng, 4096)
    got = _np(tconv.snake(_t(x), _t(a), _t(ib)))
    want = np.asarray(jconv._snake(jnp.asarray(x), jnp.asarray(a), jnp.asarray(ib)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    exact = x + ib * np.sin(a * x.astype(np.float64)) ** 2
    np.testing.assert_allclose(got, exact, atol=2e-6 * ib.max() + 1e-6)


# ---------------------------------------------------------------------------
# K1: fused qkv + rope attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,t,h", [(2, 130, 4), (1, 77, 2)])
def test_attention_plain_matches_jax_xla_reference(b, t, h):
    rng = np.random.RandomState(t)
    qkv = rng.randn(b, t, 3 * h * 64).astype(np.float32) * 0.5
    freqs = np.asarray(jax_rotary_freqs(t, 32))
    got = tattn.fused_qkv_rope_attention(_t(qkv), _t(freqs), h)
    want = jfa._fused_reference(jnp.asarray(qkv), jnp.asarray(freqs), h)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("b,t,h", [(2, 130, 4), (1, 77, 2)])
def test_attention_plain_matches_pallas_interpret(interpret, b, t, h):
    """Ragged T (not a multiple of 16): the pair kernel pads to 16 and masks."""
    rng = np.random.RandomState(t + 1)
    qkv = _bf16_values(rng.randn(b, t, 3 * h * 64) * 0.5)
    freqs = np.asarray(jax_rotary_freqs(t, 32))
    want = np.asarray(jfa.fused_qkv_rope_attention(jnp.asarray(qkv), jnp.asarray(freqs), h))
    got_bf16 = tattn.fused_qkv_rope_attention(_t(qkv, torch.bfloat16), _t(freqs), h)
    np.testing.assert_allclose(_np(got_bf16), want, atol=1e-2)
    got_f32 = tattn.fused_qkv_rope_attention(_t(qkv), _t(freqs), h)
    np.testing.assert_allclose(_np(got_f32), want, atol=2e-3)


def test_attention_kv_len_prepadded_matches_pallas_and_unpadded(interpret):
    rng = np.random.RandomState(13)
    b, t, h, tp_ = 2, 130, 2, 144
    qkv = _bf16_values(rng.randn(b, t, 3 * h * 64) * 0.5)
    qkvp = np.pad(qkv, ((0, 0), (0, tp_ - t), (0, 0)))
    freqsp = np.asarray(jax_rotary_freqs(tp_, 32))
    freqs = freqsp[:t]
    got = tattn.fused_qkv_rope_attention(_t(qkvp, torch.bfloat16), _t(freqsp), h, kv_len=t)
    assert got.shape == (b, tp_, h * 64)
    want = np.asarray(jfa.fused_qkv_rope_attention(jnp.asarray(qkvp), jnp.asarray(freqsp), h,
                                                   kv_len=t))
    np.testing.assert_allclose(_np(got)[:, :t], want[:, :t], atol=1e-2)
    unpadded = tattn.fused_qkv_rope_attention(_t(qkv), _t(freqs), h)
    padded_f32 = tattn.fused_qkv_rope_attention(_t(qkvp), _t(freqsp), h, kv_len=t)
    np.testing.assert_allclose(_np(padded_f32)[:, :t], _np(unpadded), atol=1e-5)


def test_partial_rotary_matches_pallas_rope_tables():
    """The plain version's rope (ops/embeddings.apply_rotary_pos_emb) is the
    Pallas kernel's x*C + (x@P)*S with the tables of
    flash_attention.py:_rope_tables: rotate-half sign convention over the
    first 32 dims, identity beyond."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 64).astype(np.float32)
    freqs = np.asarray(jax_rotary_freqs(7, 32))
    got = _np(apply_rotary_pos_emb(_t(x), _t(freqs)))
    c, s, p = jfa._rope_tables(jnp.asarray(freqs), 64, 7)
    want = x * np.asarray(c) + (x @ np.asarray(p)) * np.asarray(s)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[..., 32:], x[..., 32:])


# ---------------------------------------------------------------------------
# K2: snake -> conv1d
# ---------------------------------------------------------------------------

K2_CASES = [(300, 128, 128, 7, 3, True), (256, 64, 256, 7, 1, False), (200, 128, 16, 7, 1, True)]


@pytest.mark.parametrize("t,cin,cout,k,d,use_snake", K2_CASES)
def test_snake_conv1d_plain_matches_jax(interpret, t, cin, cout, k, d, use_snake):
    rng = np.random.RandomState(t)
    x = _bf16_values(rng.randn(2, t, cin) * 0.5)
    w = rng.randn(k, cin, cout).astype(np.float32) / math.sqrt(k * cin)
    b = rng.randn(cout).astype(np.float32) * 0.1
    a, ib = _snake_params(rng, cin) if use_snake else (None, None)
    ja = None if a is None else jnp.asarray(a)
    jib = None if ib is None else jnp.asarray(ib)
    pad = d * (k - 1) // 2
    want_xla = np.asarray(jconv._xla_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), ja, jib, d, pad))
    got = tconv.snake_conv1d(_t(x), _t(w), _t(b), None if a is None else _t(a),
                             None if ib is None else _t(ib), dilation=d)
    np.testing.assert_allclose(_np(got), want_xla, atol=1e-4)
    # interpret mode in bf16 (the kernel path needs T >= block_t)
    xb = jnp.asarray(x, jnp.bfloat16)
    want_k = np.asarray(jconv.snake_conv1d(xb, jnp.asarray(w), jnp.asarray(b), ja, jib,
                                           dilation=d, block_t=128).astype(jnp.float32))
    got_b = tconv.snake_conv1d(_t(x, torch.bfloat16), _t(w), _t(b), None if a is None else _t(a),
                               None if ib is None else _t(ib), dilation=d)
    np.testing.assert_allclose(_np(got_b), want_k, atol=1e-2)


# ---------------------------------------------------------------------------
# K3: fused residual unit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,c,d", [(384, 128, 3), (333, 128, 9), (130, 128, 1)])
def test_fused_residual_unit_plain_matches_jax(interpret, t, c, d):
    rng = np.random.RandomState(t + d)
    x = _bf16_values(rng.randn(1, t, c) * 0.5)
    w1 = rng.randn(7, c, c).astype(np.float32) / math.sqrt(7 * c)
    b1 = rng.randn(c).astype(np.float32) * 0.1
    w2 = rng.randn(c, c).astype(np.float32) / math.sqrt(c)
    b2 = rng.randn(c).astype(np.float32) * 0.1
    a1, ib1 = _snake_params(rng, c)
    a2, ib2 = _snake_params(rng, c)
    j = [jnp.asarray(v) for v in (x, w1, b1, a1, ib1, w2, b2, a2, ib2)]
    want_xla = np.asarray(jconv._ru_xla(j[0], j[1], j[2], jnp.stack([j[3], j[4]]), j[5], j[6],
                                        jnp.stack([j[7], j[8]]), d))
    tt = [_t(v) for v in (x, w1, b1, a1, ib1, w2, b2, a2, ib2)]
    got = tconv.fused_residual_unit(*tt, dilation=d)
    np.testing.assert_allclose(_np(got), want_xla, atol=1e-4)
    want_k = np.asarray(jconv.fused_residual_unit(j[0].astype(jnp.bfloat16), *j[1:], dilation=d,
                                                  block_t=128).astype(jnp.float32))
    got_b = tconv.fused_residual_unit(tt[0].to(torch.bfloat16), *tt[1:], dilation=d)
    np.testing.assert_allclose(_np(got_b), want_k, atol=3e-2)
    assert np.abs(_np(got_b) - want_k).mean() < 1e-3


# ---------------------------------------------------------------------------
# K4: snake -> polyphase transposed conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride,cin,cout,t", [(2, 128, 128, 200), (4, 256, 128, 150), (8, 128, 128, 130)])
def test_snake_conv_transpose1d_plain_matches_jax(interpret, stride, cin, cout, t):
    rng = np.random.RandomState(stride)
    x = _bf16_values(rng.randn(2, t, cin) * 0.5)
    w = rng.randn(2 * stride, cin, cout).astype(np.float32) / math.sqrt(2 * cin)
    b = rng.randn(cout).astype(np.float32) * 0.1
    a, ib = _snake_params(rng, cin)
    j = [jnp.asarray(v) for v in (x, w, b, a, ib)]
    want_xla = np.asarray(jconv._upk_xla(*j, stride))
    want_gemm = np.asarray(jconv._upk_gemm(*j, stride))
    tt = [_t(v) for v in (x, w, b, a, ib)]
    got = tconv.snake_conv_transpose1d(*tt, stride=stride)
    assert got.shape == (2, t * stride, cout)
    np.testing.assert_allclose(_np(got), want_xla, atol=1e-4)
    np.testing.assert_allclose(_np(got), want_gemm, atol=1e-4)
    want_k = np.asarray(jconv.snake_conv_transpose1d(j[0].astype(jnp.bfloat16), *j[1:],
                                                     stride=stride, block_t=128).astype(jnp.float32))
    got_b = tconv.snake_conv_transpose1d(tt[0].to(torch.bfloat16), *tt[1:], stride=stride)
    np.testing.assert_allclose(_np(got_b), want_k, atol=1e-2)


# ---------------------------------------------------------------------------
# dispatch and build
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (tattn.launches, tconv.snake_conv1d_launches, tconv.fused_residual_unit_launches,
              tconv.snake_conv_transpose1d_launches)
    x = torch.randn(1, 20, 128)
    a = torch.rand(128) + 0.5
    tattn.fused_qkv_rope_attention(torch.randn(1, 20, 3 * 128), torch.zeros(20, 32), 2)
    tconv.snake_conv1d(x, torch.randn(7, 128, 4), None, a, a)
    tconv.fused_residual_unit(x, torch.randn(7, 128, 128), torch.zeros(128), a, a,
                              torch.randn(128, 128), torch.zeros(128), a, a, dilation=3)
    tconv.snake_conv_transpose1d(x, torch.randn(4, 128, 128), None, a, a, stride=2)
    after = (tattn.launches, tconv.snake_conv1d_launches, tconv.fused_residual_unit_launches,
             tconv.snake_conv_transpose1d_launches)
    assert before == after


def test_shape_rules_raise():
    x = torch.randn(1, 20, 8)
    with pytest.raises(ValueError):
        tconv.snake_conv1d(x, torch.randn(7, 8, 4), None, padding=0)
    with pytest.raises(ValueError):
        tconv.snake_conv_transpose1d(x, torch.randn(6, 8, 4), None, stride=3)
    with pytest.raises(ValueError):
        tattn.fused_qkv_rope_attention(torch.randn(1, 20, 3 * 128), torch.zeros(20, 32), 2, kv_len=21)


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such architecture' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("NVCC", str(fake))
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tbuild.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_digest_covers_every_source():
    names = {p.name for p in tbuild.sources()}
    assert {"attention.cu", "attention_bwd.cu", "conv1d.cu", "common.cuh",
            "attention_tiles.cuh"} <= names
    assert names == {p.name for p in tbuild.CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh")}
    assert len(tbuild.source_digest()) == 16
