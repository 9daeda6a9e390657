"""The torch port's training pieces against the JAX package, at small sizes:
the attention training kernels' plain versions (K5 forward with LSE, K6
backward) against the Pallas kernels in interpret mode, their autograd
binding, the rope transpose, the Oobleck encoder and pretransform encode,
the optimizer, schedule and EMA, and the quasi-random timesteps.

Inputs come from numpy with fixed seeds. JAX runs on the CPU; the Pallas
kernels in interpret mode (FSAT_PALLAS_INTERPRET=1), as the JAX package's
own kernel tests run them. Each tolerance is stated where it is used.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu.models.autoencoders import OobleckEncoder as JOobleckEncoder
from friendly_stable_audio_tools_tpu.models.autoencoders import create_autoencoder_from_config as jax_ae
from friendly_stable_audio_tools_tpu.models.pretransforms import AutoencoderPretransform as JPretransform
from friendly_stable_audio_tools_tpu.ops.embeddings import rotary_freqs as jax_rotary_freqs
from friendly_stable_audio_tools_tpu.ops.pallas.conv1d import snake_downsample_conv1d as jax_down
from friendly_stable_audio_tools_tpu.training.diffusion import quasirandom_uniform as jax_qmc
from friendly_stable_audio_tools_tpu.training.ema import ema_update as jax_ema_update
from friendly_stable_audio_tools_tpu.training.scheduler import build_optimizer as jax_build_optimizer
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.models.autoencoders import OobleckEncoder
from friendly_stable_audio_tools_tpu_torch.models.pretransforms import create_pretransform_from_config
from friendly_stable_audio_tools_tpu_torch.ops.convs import snake_downsample_conv1d
from friendly_stable_audio_tools_tpu_torch.ops.embeddings import (
    apply_rotary_pos_emb,
    apply_rotary_pos_emb_transpose,
    rotary_freqs,
)
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
from friendly_stable_audio_tools_tpu_torch.training.diffusion import quasirandom_uniform
from friendly_stable_audio_tools_tpu_torch.training.ema import ema_update_
from friendly_stable_audio_tools_tpu_torch.training.scheduler import build_optimizer
from friendly_stable_audio_tools_tpu_torch.utils.convert import state_dict_from_jax


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")


def _jax_lse(stats, b, h, t):
    """The JAX stats [B, H/2, T_pad, lanes] (lanes 0/1 = the pair's heads) -> [B, H, T]."""
    return np.asarray(stats)[:, :, :t, :2].transpose(0, 1, 3, 2).reshape(b, h, t)


def _bf16_qkv(rng, b, t, h):
    return _t(rng.randn(b, t, 3 * h * 64) * 0.5, torch.bfloat16)


# ---------------------------------------------------------------------------
# K5: forward with LSE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,t,h,kv_len", [(2, 272, 4, 260), (1, 77, 2, None)])
def test_stats_plain_matches_pallas_interpret(interpret, b, t, h, kv_len):
    """out within one bf16 rounding (1e-2 at |out| < 1); lse within 1e-4:
    both sides take the same bf16 operands and differ only in fp32 sum order."""
    qkv = _bf16_qkv(np.random.RandomState(t), b, t, h)
    freqs = np.asarray(jax_rotary_freqs(t, 32))
    want_out, stats = jfa._fused_pair_forward_stats(jnp.asarray(_np(qkv)), jnp.asarray(freqs), h,
                                                    kv_len)
    out, lse = tattn.fused_qkv_rope_attention_stats(qkv, _t(freqs), h, kv_len)
    assert out.dtype == torch.bfloat16 and lse.shape == (b, h, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(want_out), atol=1e-2)
    np.testing.assert_allclose(_np(lse), _jax_lse(stats, b, h, t), atol=1e-4)
    # the inference path (K1's plain version) gives the same output
    np.testing.assert_array_equal(_np(out), _np(tattn.fused_qkv_rope_attention_plain(
        qkv, _t(freqs), h, kv_len)))


# ---------------------------------------------------------------------------
# K6: backward
# ---------------------------------------------------------------------------


def test_rope_transpose_is_the_vjp_of_the_rope():
    """dx = dy*C + (dy*S) P^T: held against autograd (fp32, 1e-6)."""
    rng = np.random.RandomState(0)
    freqs = rotary_freqs(40, 32)
    x = _t(rng.randn(2, 3, 40, 64)).requires_grad_(True)
    dy = _t(rng.randn(2, 3, 40, 64))
    want, = torch.autograd.grad(apply_rotary_pos_emb(x, freqs), x, dy)
    np.testing.assert_allclose(_np(apply_rotary_pos_emb_transpose(dy, freqs)), _np(want), atol=1e-6)


def test_backward_plain_matches_jax_grad_through_pallas(interpret):
    """dqkv of the plain K6 formula against jax.grad through `_fused_pair`
    (stats forward + `_pair_backward` in interpret mode), B 2, T 272 padded,
    kv_len 260, with more than one q block on the JAX side. Tolerance 1e-2
    of the largest gradient: one bf16 rounding of the plain version's output
    (JAX returns fp32 for an fp32 input); padded rows get exactly zero."""
    b, t, h, kv_len = 2, 272, 4, 260
    rng = np.random.RandomState(9)
    qkv = _bf16_qkv(rng, b, t, h)
    freqs = np.asarray(jax_rotary_freqs(t, 32))
    g = _t(rng.randn(b, t, h * 64), torch.bfloat16)
    g[:, kv_len:] = 0  # the transformer slices padded rows off: no cotangent

    def loss(x):
        out = jfa._fused_pair(x, jnp.asarray(freqs), h, kv_len)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(_np(g)))

    want = np.asarray(jax.grad(loss)(jnp.asarray(_np(qkv))))
    out, lse = tattn.fused_qkv_rope_attention_stats(qkv, _t(freqs), h, kv_len)
    got = tattn.fused_qkv_rope_attention_backward(qkv, out, lse, g, _t(freqs), h, kv_len)
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    np.testing.assert_allclose(_np(got), want, atol=1e-2 * np.abs(want).max())
    assert np.abs(want[:, kv_len:]).max() == 0 and np.abs(_np(got)[:, kv_len:]).max() == 0


@pytest.mark.parametrize("kv_len", [None, 45])
def test_backward_plain_matches_autograd_of_plain_forward(kv_len):
    """The explicit formula against torch autograd of the plain forward, in
    fp32 (no rounding on either side): 1e-5 of the largest gradient."""
    rng = np.random.RandomState(3)
    b, t, h = 2, 50, 2
    qkv = _t(rng.randn(b, t, 3 * h * 64) * 0.5).requires_grad_(True)
    freqs = rotary_freqs(t, 32)
    g = _t(rng.randn(b, t, h * 64))
    want, = torch.autograd.grad(tattn.fused_qkv_rope_attention_plain(qkv, freqs, h, kv_len), qkv, g)
    out, lse = tattn.fused_qkv_rope_attention_stats_plain(qkv.detach(), freqs, h, kv_len)
    got = tattn.fused_qkv_rope_attention_backward_plain(qkv.detach(), out, lse, g, freqs, h, kv_len)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5 * _np(want).__abs__().max())


# ---------------------------------------------------------------------------
# the autograd binding
# ---------------------------------------------------------------------------


def test_autograd_function_on_cpu_matches_autograd_and_counts_no_launch():
    """With grad, `fused_qkv_rope_attention` runs the Function (plain forward,
    explicit plain backward on the CPU): same output and, to 1e-5 relative,
    the same gradient as autograd of the plain forward; no kernel launch is
    counted. Without grad it returns the plain forward unchanged."""
    rng = np.random.RandomState(4)
    b, t, h, kv_len = 2, 40, 2, 37
    x = _t(rng.randn(b, t, 3 * h * 64) * 0.5)
    freqs = rotary_freqs(t, 32)
    g = _t(rng.randn(b, t, h * 64))
    before = (tattn.launches, tattn.stats_launches, tattn.backward_launches)

    qkv = x.clone().requires_grad_(True)
    y = tattn.fused_qkv_rope_attention(qkv, freqs, h, kv_len)
    assert y.requires_grad and y.grad_fn is not None
    assert "FusedQKVRopeAttention" in type(y.grad_fn).__name__
    y.backward(g)
    ref_x = x.clone().requires_grad_(True)
    ref_y = tattn.fused_qkv_rope_attention_plain(ref_x, freqs, h, kv_len)
    ref_y.backward(g)
    np.testing.assert_array_equal(_np(y), _np(ref_y))
    np.testing.assert_allclose(_np(qkv.grad), _np(ref_x.grad), atol=1e-5 * _np(ref_x.grad).max())
    with torch.no_grad():
        np.testing.assert_array_equal(_np(tattn.fused_qkv_rope_attention(x, freqs, h, kv_len)),
                                      _np(ref_y))
    assert (tattn.launches, tattn.stats_launches, tattn.backward_launches) == before


def test_autograd_function_under_checkpoint():
    """Non-reentrant checkpointing recomputes the forward in the backward
    pass; the gradient equals the one without checkpointing (1e-6)."""
    rng = np.random.RandomState(5)
    b, t, h = 1, 33, 2
    w = _t(rng.randn(64, 3 * h * 64) * 0.1)
    x0 = _t(rng.randn(b, t, 64))
    freqs = rotary_freqs(t, 32)

    def block(x):
        return tattn.fused_qkv_rope_attention(x @ w, freqs, h).square().sum()

    xa = x0.clone().requires_grad_(True)
    block(xa).backward()
    xb = x0.clone().requires_grad_(True)
    torch.utils.checkpoint.checkpoint(block, xb, use_reentrant=False).backward()
    np.testing.assert_allclose(_np(xb.grad), _np(xa.grad), atol=1e-6)


def test_conv_plain_versions_keep_their_autograd_on_cpu():
    """The CUDA wrappers of K2-K4 refuse inputs that need grad; CPU tensors
    still take the plain versions, which autograd differentiates as before."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d as tconv

    rng = np.random.RandomState(10)
    x = _t(rng.randn(1, 40, 8)).requires_grad_(True)
    w = _t(rng.randn(7, 8, 8) * 0.1).requires_grad_(True)
    a = _t(np.abs(rng.randn(8)) + 0.5)
    y = tconv.snake_conv1d(x, w, None, a, 1 / a)
    assert y.requires_grad
    y.square().sum().backward()
    assert x.grad.abs().max() > 0 and w.grad.abs().max() > 0
    np.testing.assert_array_equal(_np(y), _np(tconv.snake_conv1d_plain(x, w, None, a, 1 / a)))


# ---------------------------------------------------------------------------
# encoder and encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride,cin,cout", [(2, 16, 32), (4, 32, 16), (8, 8, 8)])
def test_downsample_gemm_form_matches_jax(stride, cin, cout):
    """The strided downsample against `snake_downsample_conv1d` (fp32, 1e-5:
    the same two GEMMs, summed in another order)."""
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 16 * stride, cin).astype(np.float32) * 0.3
    w = rng.randn(2 * stride, cin, cout).astype(np.float32) * 0.05
    bias = rng.randn(cout).astype(np.float32) * 0.1
    a = (np.abs(rng.randn(cin)) + 0.5).astype(np.float32)
    ib = (np.abs(rng.randn(cin)) + 0.5).astype(np.float32)
    for al, ibv in ((None, None), (a, ib)):
        want = jax_down(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                        None if al is None else jnp.asarray(al),
                        None if ibv is None else jnp.asarray(ibv), stride)
        got = snake_downsample_conv1d(_t(x), _t(w), _t(bias), None if al is None else _t(al),
                                      None if ibv is None else _t(ibv), stride)
        assert got.shape == (2, 16, cout)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


ENC_KW = dict(in_channels=2, channels=8, latent_dim=8, c_mults=(1, 2), strides=(2, 4),
              use_snake=True)


def test_oobleck_encoder_matches_jax():
    """The tiny snake encoder (2 blocks, strides (2, 4), 8 latent channels)
    in fp32, random weights de-zeroed: 2e-4 absolute at unit output scale
    (a dozen conv layers of fp32 rounding, XLA vs PyTorch)."""
    jenc = JOobleckEncoder(**ENC_KW)
    x = np.random.RandomState(6).randn(2, 64, 2).astype(np.float32) * 0.5
    p = dezero_params(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], scale=0.2, damp=1.0)
    want = np.asarray(jenc.apply({"params": p}, jnp.asarray(x)))
    tenc = OobleckEncoder(**ENC_KW)
    tenc.load_state_dict(state_dict_from_jax(p), strict=True)
    with torch.no_grad():
        got = tenc(_t(x))
    assert got.shape == want.shape == (2, 8, 8) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(_np(got), want, atol=2e-4)


def test_pretransform_encode_is_the_scaled_posterior_mean():
    """AutoencoderPretransform.encode_nwc against the JAX training path's
    encode (no sampling rng: the VAE mean), latents divided by the scale."""
    ae_cfg = {"encoder": {"type": "oobleck", "config": ENC_KW},
              "decoder": {"type": "oobleck", "config": dict(out_channels=2, channels=8, latent_dim=4,
                                                            c_mults=[1, 2], strides=[2, 4],
                                                            use_snake=True, final_tanh=False)},
              "bottleneck": {"type": "vae"}, "latent_dim": 4, "downsampling_ratio": 8,
              "io_channels": 2}
    jmodel = jax_ae({"model": ae_cfg, "sample_rate": 44100})
    jmodel.init(jax.random.PRNGKey(1))
    jmodel.params = dezero_params(jmodel.params, scale=0.2, damp=1.0)
    jpt = JPretransform(jmodel, scale=1.5)
    x = np.random.RandomState(7).randn(2, 64, 2).astype(np.float32) * 0.5
    want = np.asarray(jpt.encode_nwc(jnp.asarray(x)))
    tpt = create_pretransform_from_config({"type": "autoencoder", "config": ae_cfg, "scale": 1.5})
    tpt.model.load_state_dict(state_dict_from_jax(jmodel.params), strict=True)
    got = tpt.encode_nwc(_t(x))
    assert got.shape == want.shape == (2, 8, 4) and not got.requires_grad
    np.testing.assert_allclose(_np(got), want, atol=2e-4)


# ---------------------------------------------------------------------------
# optimizer, schedule, EMA; timesteps
# ---------------------------------------------------------------------------

SAO_OPT = {"optimizer": {"type": "AdamW", "config": {"lr": 5e-5, "betas": [0.9, 0.999],
                                                     "weight_decay": 1e-3}},
           "scheduler": {"type": "InverseLR", "config": {"inv_gamma": 1000000, "power": 0.5,
                                                         "warmup": 0.99}}}


def test_adamw_inverse_lr_and_ema_match_optax():
    """4 steps of AdamW + InverseLR (SAO's settings) + EMA on a small tree,
    fed the same gradients. The learning rate at step 0 (5e-7 after the
    0.99 warm-up) and the parameters and EMA after each step agree to 1e-7
    absolute (fp32 updates of ~1e-6 from unit-scale parameters)."""
    rng = np.random.RandomState(8)
    shapes = {"w": (4, 3), "b": (3,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(4)]

    tx = jax_build_optimizer(SAO_OPT)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate, jema = tx.init(jp), dict(jp)
    tp_ = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt, sched = build_optimizer(SAO_OPT, list(tp_.values()))
    tema = [p.detach().clone() for p in tp_.values()]
    assert math.isclose(opt.param_groups[0]["lr"], 5e-5 * (1 - 0.99), rel_tol=1e-9)

    for step, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        jema = jax_ema_update(jema, jp, jnp.asarray(step))
        for k, p in tp_.items():
            p.grad = _t(g[k])
        opt.step()
        sched.step()
        ema_update_(tema, [p.detach() for p in tp_.values()], step)
        for i, k in enumerate(tp_):
            np.testing.assert_allclose(_np(tp_[k]), np.asarray(jp[k]), atol=1e-7)
            np.testing.assert_allclose(_np(tema[i]), np.asarray(jema[k]), atol=1e-7)
    assert (tema[0] != tp_["w"].detach()).any()  # the EMA decay is > 0 from the fourth step


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_global_norm_clipping_matches_optax(max_norm):
    """The trainer's clip (ahead of the optimizer) against
    optax.clip_by_global_norm, which the JAX trainer chains first: 1e-7."""
    from friendly_stable_audio_tools_tpu_torch.training.diffusion import clip_by_global_norm_

    rng = np.random.RandomState(11)
    grads = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [_t(g) for g in grads]
    clip_by_global_norm_(got, max_norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-7)


def test_quasirandom_uniform_matches_jax_bit_for_bit():
    """Over counters that wrap past 2^32 - 1, with a rotation."""
    for counter in (0, 1000, 2**31 - 3, 2**32 - 5):
        for shift in (0.0, 0.37):
            want = np.asarray(jax_qmc(jnp.uint32(counter), 16, jnp.float32(shift)))
            got = quasirandom_uniform(counter, 16, torch.tensor(shift))
            np.testing.assert_array_equal(_np(got), want)
