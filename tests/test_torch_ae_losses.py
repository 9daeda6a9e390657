"""The torch port's STFT, spectral losses and EnCodec discriminator against
the JAX package's, on the CPU in fp32 (the JAX side on its CPU path,
gather + jnp.fft.rfft, not the TPU's GEMM form).

Inputs are numpy draws from fixed seeds; the discriminator's weights are the
JAX module's, carried over by utils/convert.py. Tolerances: the STFT to
1e-5 of its largest magnitude (two FFT libraries' fp32 rounding); every loss
to 1e-5 relative (not the phase term, which no config uses: its atan2
flips by 2 pi between the two FFTs' roundings at bins on the branch cut);
the discriminator's logits and feature maps to 1e-5 of
their largest entry, its three losses to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.models.discriminators import (
    EncodecDiscriminator as JEncodecDiscriminator,
)
from friendly_stable_audio_tools_tpu.training.losses import auraloss as jaura
from friendly_stable_audio_tools_tpu_torch.models.discriminators import (
    EncodecDiscriminator,
    get_hinge_losses,
)
from friendly_stable_audio_tools_tpu_torch.ops.stft import stft_reim
from friendly_stable_audio_tools_tpu_torch.training.losses import auraloss as taura
from friendly_stable_audio_tools_tpu_torch.utils.convert import convert_encodec_discriminator

SR = 16000


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _signals(seed, shape=(2, 2, 2048)):
    """Two related signals [B, C, T]: a sum of sines with noise, and a
    perturbed copy (as a reconstruction of it)."""
    rng = np.random.RandomState(seed)
    t = np.arange(shape[-1]) / SR
    x = sum(0.2 * np.sin(2 * np.pi * rng.uniform(50, 4000) * t + rng.uniform(0, 6))
            for _ in range(4))
    x = np.broadcast_to(x, shape) + 0.05 * rng.randn(*shape)
    y = 0.8 * x + 0.05 * rng.randn(*shape)
    return x.astype(np.float32), y.astype(np.float32)


def _close_rel(got, want, rel=1e-5):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (got, want)


@pytest.mark.parametrize("n_fft,hop,win", [(128, 32, 128), (256, 64, 200), (64, 16, 64)])
def test_stft_matches_jax(n_fft, hop, win):
    x = np.random.RandomState(0).randn(3, 1000).astype(np.float32)
    jre, jim = jaura._stft_reim(jnp.asarray(x), n_fft, hop, win, jnp.asarray(jaura._hann_window(win),
                                                                              jnp.float32))
    re, im = stft_reim(_t(x), n_fft, hop, win)
    scale = float(np.abs(np.asarray(jre)).max())
    assert re.shape == jre.shape
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-5 * scale)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=1e-5 * scale)


STFT_OPTIONS = {
    "log_and_sc": {},
    "linear": dict(w_log_mag=0.0, w_lin_mag=1.0),
    "l2": dict(mag_distance="L2", w_lin_mag=1.0),
    "log_eps": dict(log_eps=1e-3, log_fac=2.0),
    "scale_invariance": dict(scale_invariance=True),
    "mel": dict(scale="mel", n_bins=16, sample_rate=SR),
    "chroma": dict(scale="chroma", n_bins=12, sample_rate=SR),
    "a_weighting": dict(perceptual_weighting=True, sample_rate=SR),
}


@pytest.mark.parametrize("option", list(STFT_OPTIONS))
def test_stft_loss_matches_jax(option):
    x, y = _signals(1)
    kw = dict(fft_size=256, hop_size=64, win_length=256, **STFT_OPTIONS[option])
    want = jaura.STFTLoss(**kw)(jnp.asarray(x), jnp.asarray(y))
    got = taura.STFTLoss(**kw)(_t(x), _t(y))
    _close_rel(got, want)


@pytest.mark.parametrize("filter_type", ["hp", "fd"])
def test_fir_prefilter_matches_jax(filter_type):
    x = np.random.RandomState(2).randn(2, 500).astype(np.float32)
    want = jaura.FIRFilter(filter_type)(jnp.asarray(x))
    got = taura.FIRFilter(filter_type)(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


MRSTFT = dict(fft_sizes=[256, 128, 64], hop_sizes=[64, 32, 16], win_lengths=[256, 128, 64])


@pytest.mark.parametrize("perceptual", [False, True])
def test_multi_resolution_and_sum_and_difference_losses_match_jax(perceptual):
    x, y = _signals(3)
    kw = dict(MRSTFT, perceptual_weighting=perceptual, sample_rate=SR)
    _close_rel(taura.MultiResolutionSTFTLoss(**kw)(_t(x), _t(y)),
               jaura.MultiResolutionSTFTLoss(**kw)(jnp.asarray(x), jnp.asarray(y)))
    _close_rel(taura.SumAndDifferenceSTFTLoss(**kw)(_t(x), _t(y)),
               jaura.SumAndDifferenceSTFTLoss(**kw)(jnp.asarray(x), jnp.asarray(y)))
    loss, sum_loss, diff_loss = taura.SumAndDifferenceSTFTLoss(**kw, output="full")(_t(x), _t(y))
    _close_rel(loss, (sum_loss + diff_loss) / 2, rel=1e-6)
    mr = taura.MultiResolutionSTFTLoss(**kw)
    assert (mr.prefilter is not None) == perceptual
    assert all(f.prefilter is None or f.prefilter.same_as(mr.prefilter) for f in mr.stft_losses)


@pytest.fixture(scope="module")
def discriminators():
    cfg = dict(filters=8, n_ffts=[256, 128], hop_lengths=[64, 32], win_lengths=[256, 128])
    jd = JEncodecDiscriminator(in_channels=2, **cfg)
    example = jnp.zeros((1, 512, 2), jnp.float32)
    params = jax.jit(lambda k: jd.init(k, example, example, method="loss"))(
        jax.random.PRNGKey(0))["params"]
    td = EncodecDiscriminator(in_channels=2, **cfg)
    td.load_state_dict(convert_encodec_discriminator(params), strict=True)
    return jd, params, td


def test_encodec_discriminator_matches_jax(discriminators):
    jd, params, td = discriminators
    x, y = (a.transpose(0, 2, 1).copy() for a in _signals(4, (2, 2, 1536)))  # [B, T, C]
    jlogits, jfeats = jax.jit(lambda p, a: jd.apply({"params": p}, a))(params, jnp.asarray(x))
    with torch.no_grad():
        logits, feats = td(_t(x))
    assert len(logits) == len(jlogits) == 2
    for lg, jlg, fm, jfm in zip(logits, jlogits, feats, jfeats):
        want = np.asarray(jlg).transpose(0, 3, 1, 2)  # NHWC -> NCHW
        np.testing.assert_allclose(lg.numpy(), want, atol=1e-5 * np.abs(want).max())
        assert len(fm) == len(jfm) == 5
        for a, b in zip(fm, jfm):
            b = np.asarray(b).transpose(0, 3, 1, 2)
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max())
    want = jax.jit(lambda p, a, b: jd.apply({"params": p}, a, b, method="loss"))(
        params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = td.loss(_t(x), _t(y))
    for g, w in zip(got, want):
        _close_rel(g, w)


def test_hinge_losses():
    real, fake = torch.tensor([0.5, 2.0, -1.0]), torch.tensor([-2.0, 0.0, 1.0])
    dis, gen = get_hinge_losses(real, fake)
    assert torch.isclose(dis, torch.tensor((0.5 + 0 + 2) / 3 + (0 + 1 + 2) / 3))
    assert torch.isclose(gen, -fake.mean())
