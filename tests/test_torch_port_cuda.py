"""The torch port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. The GPU machine has
no JAX, and tests/conftest.py imports it, so run this file there with
`python -m pytest --noconftest -q tests/test_torch_port_cuda.py`. Inputs
are bf16 unless a test says otherwise; tolerance: rel-L2 1e-2 (one bf16
rounding of the output apart, with attention's online softmax rounding P
against running maxima). The fp32 kernels (K7/K9, and K2/K3/K4 on fp32
activations) are held to fp32 tolerances: rel-L2 1e-5 (K9 1e-4); K8's
dq, whose parts arrive through atomics in a varying order, to 1e-5 too.
"""

import pytest
import torch

from friendly_stable_audio_tools_tpu_torch.ops import attention as tattention
from friendly_stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d as tconv
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _close(a, b, tol=1e-2):
    rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
    assert rel < tol, rel


def test_attention_kernel_matches_plain_ragged_and_kv_len(gen):
    for t, kv in ((200, 190), (77, None)):
        qkv = _rnd(gen, 2, t, 3 * 4 * 64).to(torch.bfloat16)
        f = rotary_freqs(t, 32, device="cuda")
        before = tattn.launches
        got = tattn.fused_qkv_rope_attention(qkv, f, 4, kv_len=kv)
        assert tattn.launches == before + 1
        _close(got, tattn.fused_qkv_rope_attention_plain(qkv, f, 4, kv_len=kv))


def test_conv_kernels_match_plain(gen):
    x = _rnd(gen, 2, 333, 128, scale=0.5).to(torch.bfloat16)
    a = _rnd(gen, 128).abs() + 0.5
    ib = 1.0 / a
    bias = _rnd(gen, 128, scale=0.1)
    w = _rnd(gen, 7, 128, 128, scale=0.03)
    _close(tconv.snake_conv1d(x, w, bias, a, ib, dilation=3),
           tconv.snake_conv1d_plain(x, w, bias, a, ib, dilation=3))
    _close(tconv.fused_residual_unit(x, w, bias, a, ib, w[0], bias, a, ib, dilation=9),
           tconv.fused_residual_unit_plain(x, w, bias, a, ib, w[0], bias, a, ib, dilation=9))
    wt = _rnd(gen, 8, 128, 128, scale=0.06)
    _close(tconv.snake_conv_transpose1d(x, wt, bias, a, ib, stride=4),
           tconv.snake_conv_transpose1d_plain(x, wt, bias, a, ib, stride=4))


def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x64 = _rnd(gen, 1, 64, 128).double()
    with pytest.raises(TypeError):  # bf16 or fp32 only
        tconv.snake_conv1d(x64, _rnd(gen, 7, 128, 128), None)
    with pytest.raises(ValueError):  # C % 128 != 0
        xb = _rnd(gen, 1, 64, 96).to(torch.bfloat16)
        tconv.fused_residual_unit(xb, _rnd(gen, 7, 96, 96), None, None, None,
                                  _rnd(gen, 96, 96), None, None, None)
    with pytest.raises(ValueError):  # head dim 32
        tattn.fused_qkv_rope_attention(_rnd(gen, 1, 64, 3 * 4 * 32).to(torch.bfloat16),
                                       rotary_freqs(64, 16, device="cuda"), 4)


def test_attention_training_kernels_carry_the_gradient(gen):
    """With grad, the fp32 qkv goes through K5 and K6: the output is in the
    autograd graph and qkv.grad is finite and non-zero; it agrees with the
    plain versions' gradient (rel-L2 1e-2: bf16 operands on both sides)."""
    t, h, kv = 272, 4, 260
    f = rotary_freqs(t, 32, device="cuda")
    x = _rnd(gen, 2, t, 3 * h * 64, scale=0.5)
    g = _rnd(gen, 2, t, h * 64)
    g[:, kv:] = 0
    before = (tattn.launches, tattn.stats_launches, tattn.backward_launches)
    qkv = x.clone().requires_grad_(True)
    out = tattn.fused_qkv_rope_attention(qkv, f, h, kv)
    assert out.requires_grad and out.dtype == torch.float32
    out.backward(g)
    assert (tattn.launches, tattn.stats_launches, tattn.backward_launches) == (
        before[0], before[1] + 1, before[2] + 1)
    assert torch.isfinite(qkv.grad).all() and qkv.grad.abs().max() > 0
    xb = x.to(torch.bfloat16)
    o, lse = tattn.fused_qkv_rope_attention_stats_plain(xb, f, h, kv)
    want = tattn.fused_qkv_rope_attention_backward_plain(xb, o, lse, g, f, h, kv,
                                                         dtype=torch.float32)
    _close(qkv.grad, want)


def test_conv_kernels_refuse_inputs_that_need_grad(gen):
    """K2-K4 have no backward: on CUDA, under grad with an input that
    requires grad, each wrapper raises rather than return a detached result;
    under torch.no_grad() it runs."""
    x = _rnd(gen, 1, 256, 128, scale=0.5).to(torch.bfloat16)
    a = _rnd(gen, 128).abs() + 0.5
    w = _rnd(gen, 7, 128, 128, scale=0.03).requires_grad_(True)
    wt = _rnd(gen, 4, 128, 128, scale=0.06).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tconv.snake_conv1d(x, w, None, a, 1.0 / a)
    with pytest.raises(RuntimeError, match="no backward"):
        tconv.fused_residual_unit(x, w, None, a, 1.0 / a, w[0], None, a, 1.0 / a)
    with pytest.raises(RuntimeError, match="no backward"):
        tconv.snake_conv_transpose1d(x.requires_grad_(True), wt.detach(), None, a, 1.0 / a,
                                     stride=2)
    with torch.no_grad():
        assert tconv.snake_conv1d(x, w, None, a, 1.0 / a).shape == (1, 256, 128)


def test_long_attention_kernels_match_plain(gen):
    """K10a against its plain version (one bf16 rounding apart, rel-L2 1e-3),
    and the long path (K10a then K10) against its plain version, at ragged
    lengths over 2048; each call launches K10a and K10 once and K1 never."""
    for b, t, h, kv in ((2, 2176, 4, 2050), (1, 2049, 2, None)):
        qkv = _rnd(gen, b, t, 3 * h * 64).to(torch.bfloat16)
        f = rotary_freqs(t, 32, device="cuda")
        _close(tattn.rope_pair_k(qkv, f, h), tattn.rope_pair_k_plain(qkv, f, h), tol=1e-3)
        before = (tattn.launches, tattn.rope_k_launches, tattn.long_launches)
        got = tattn.fused_qkv_rope_attention(qkv, f, h, kv_len=kv)
        assert (tattn.launches, tattn.rope_k_launches, tattn.long_launches) == (
            before[0], before[1] + 1, before[2] + 1)
        _close(got, tattn.fused_qkv_rope_attention_long_plain(qkv, f, h, kv_len=kv))


def test_attention_beyond_the_long_path_raises_on_cuda(gen):
    qkv = _rnd(gen, 1, 8193, 3 * 64).to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="K7"):
        tattn.fused_qkv_rope_attention(qkv, rotary_freqs(8193, 32, device="cuda"), 1)


def test_flash_kernels_match_plain_in_fp32(gen):
    """K7 (out rel-L2 1e-5, LSE max abs 1e-4) and K9 (dq, dk, dv rel-L2 1e-4
    each, exactly zero on padded rows) against their plain versions in fp32,
    at ragged lengths; one launch each per call."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash

    for bh, t, kv in ((3, 200, 190), (2, 77, None), (2, 1424, None)):
        q, k, v = (_rnd(gen, bh, t, 64) for _ in range(3))
        do = _rnd(gen, bh, t, 64)
        if kv is not None:
            do[:, kv:] = 0
        before = (tflash.forward_launches, tflash.backward_launches)
        out, lse = tflash.flash_forward(q, k, v, kv)
        grads = tflash.flash_backward(q, k, v, out, lse, do, kv)
        assert (tflash.forward_launches, tflash.backward_launches) == (before[0] + 1, before[1] + 1)
        out_p, lse_p = tflash.flash_forward_plain(q, k, v, kv)
        _close(out, out_p, tol=1e-5)
        assert (lse - lse_p).abs().max().item() <= 1e-4
        for got, want in zip(grads, tflash.flash_backward_plain(q, k, v, out, lse, do, kv)):
            _close(got, want, tol=1e-4)
            if kv is not None:
                assert not got[:, kv:].any()


def test_unpack_route_trains_in_fp32_through_k7_and_k9(gen):
    """Under grad at T = 1424 (past the pair route's 1168) the fp32 qkv
    goes through K7 twice (the forward and a checkpointed recompute) and K9
    once, never K5/K6, and qkv.grad is within rel-L2 1e-4 of autograd through
    the fp32 plain attention; at T = 1184, where the JAX package's backward
    is K8, K7 once and K8 once, within the same tolerance."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash

    t, h = 1424, 2
    f = rotary_freqs(t, 32, device="cuda")
    x = _rnd(gen, 1, t, 3 * h * 64, scale=0.5)
    g = _rnd(gen, 1, t, h * 64)
    counts = lambda: (tflash.forward_launches, tflash.backward_launches,  # noqa: E731
                      tattn.stats_launches, tattn.backward_launches)
    before = counts()
    qkv = x.clone().requires_grad_(True)
    out = torch.utils.checkpoint.checkpoint(
        lambda y: tattn.fused_qkv_rope_attention(y, f, h), qkv, use_reentrant=False)
    assert out.dtype == torch.float32
    out.backward(g)
    assert counts() == (before[0] + 2, before[1] + 1, before[2], before[3])
    ref = x.clone().requires_grad_(True)
    tattn.fused_qkv_rope_attention_plain(ref, f, h).backward(g)
    _close(qkv.grad, ref.grad, tol=1e-4)

    t = 1184
    f = rotary_freqs(t, 32, device="cuda")
    x = _rnd(gen, 1, t, 3 * h * 64, scale=0.5)
    g = _rnd(gen, 1, t, h * 64)
    before = counts() + (tflash.fused_backward_launches,)
    qkv = x.clone().requires_grad_(True)
    tattn.fused_qkv_rope_attention(qkv, f, h).backward(g)
    assert counts() + (tflash.fused_backward_launches,) == (
        before[0] + 1, before[1], before[2], before[3], before[4] + 1)
    ref = x.clone().requires_grad_(True)
    tattn.fused_qkv_rope_attention_plain(ref, f, h).backward(g)
    _close(qkv.grad, ref.grad, tol=1e-4)


@pytest.mark.parametrize("bh,t,d,kv", [(3, 200, 80, 190), (2, 1184, 64, 1177), (4, 1024, 80, None)])
def test_flash_backward_fused_matches_plain_in_fp32(gen, bh, t, d, kv):
    """K8 (one launch) against its plain version from the same residuals:
    dq, dk, dv rel-L2 1e-5 each, exactly zero on padded rows; other head
    dims raise."""
    q, k, v, do = (_rnd(gen, bh, t, d) for _ in range(4))
    if kv is not None:
        do[:, kv:] = 0
    out, lse = tflash.flash_forward_plain(q, k, v, kv)
    before = tflash.fused_backward_launches
    grads = tflash.flash_backward_fused(q, k, v, out, lse, do, kv)
    assert tflash.fused_backward_launches == before + 1
    for got, want in zip(grads, tflash.flash_backward_fused_plain(q, k, v, out, lse, do, kv)):
        _close(got, want, tol=1e-5)
        if kv is not None:
            assert not got[:, kv:].any()
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        tflash.flash_backward_fused(*(x[..., :48].contiguous() for x in (q, k, v, out)),
                                    lse, do[..., :48].contiguous(), kv)


def test_fp32_conv_kernels_match_plain(gen):
    """K2, K3 and K4 on fp32 activations run the fp32 kernels (their own
    launch counts), with and without the snake, at the DAC decoder's Cout 96."""
    x = _rnd(gen, 2, 333, 128, scale=0.5)
    a = _rnd(gen, 128).abs() + 0.5
    ib = 1.0 / a
    bias = _rnd(gen, 128, scale=0.1)
    w = _rnd(gen, 7, 128, 128, scale=0.03)
    before = (tconv.snake_conv1d_f32_launches, tconv.fused_residual_unit_f32_launches,
              tconv.snake_conv_transpose1d_f32_launches, tconv.snake_conv1d_launches)
    _close(tconv.snake_conv1d(x, w, bias, a, ib, dilation=3),
           tconv.snake_conv1d_plain(x, w, bias, a, ib, dilation=3), 1e-5)
    _close(tconv.snake_conv1d(x, w[:1, :, :96], None), tconv.snake_conv1d_plain(x, w[:1, :, :96], None),
           1e-5)
    _close(tconv.fused_residual_unit(x, w, bias, a, ib, w[0], bias, a, ib, dilation=9),
           tconv.fused_residual_unit_plain(x, w, bias, a, ib, w[0], bias, a, ib, dilation=9), 1e-5)
    wt = _rnd(gen, 8, 128, 96, scale=0.06)
    for aa, ii in ((a, ib), (None, None)):
        got = tconv.snake_conv_transpose1d(x, wt, bias[:96], aa, ii, stride=4)
        assert got.dtype == torch.float32 and got.shape == (2, 333 * 4, 96)
        _close(got, tconv.snake_conv_transpose1d_plain(x, wt, bias[:96], aa, ii, stride=4), 1e-5)
    after = (tconv.snake_conv1d_f32_launches, tconv.fused_residual_unit_f32_launches,
             tconv.snake_conv_transpose1d_f32_launches, tconv.snake_conv1d_launches)
    assert tuple(b - a_ for a_, b in zip(before, after)) == (2, 1, 2, 0)
    with pytest.raises(ValueError):  # Cout % 32 != 0
        tconv.snake_conv_transpose1d(x, wt[..., :80], None, stride=4)


@pytest.mark.parametrize("t,d", [(1024, 80), (2048, 64), (200, 80)])
def test_flash_forward_serving_matches_plain(gen, t, d):
    """K7 without the LSE (the ADP U-Net's self-attention) at head dims 64
    and 80 against its plain version; other head dims raise."""
    q, k, v = (_rnd(gen, 6, t, d) for _ in range(3))
    before = tflash.serving_launches
    out, lse = tflash.flash_forward(q, k, v, save_stats=False)
    assert lse is None and tflash.serving_launches == before + 1
    _close(out, tflash.flash_forward_plain(q, k, v, save_stats=False)[0], 1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        tflash.flash_forward(q[..., :48], k[..., :48], v[..., :48], save_stats=False)


def test_sdpa_gate_sends_long_self_attention_to_k7(gen):
    q, k, v = (_rnd(gen, 2, 16, 1024, 80) for _ in range(3))
    before = tflash.serving_launches
    got = tattention.scaled_dot_product_attention(q, k, v)
    assert tflash.serving_launches == before + 1
    _close(got, tattention.attention(q, k, v), 1e-5)
    ctx = _rnd(gen, 2, 16, 79, 80)
    tattention.scaled_dot_product_attention(q, ctx, ctx)  # 79 keys: plain
    assert tflash.serving_launches == before + 1


def test_sdpa_gate_under_grad_goes_through_k7_with_lse_and_k8(gen):
    """The ADP U-Net's gated self-attention under grad: K7 with its LSE once
    and K8 once (no serving launch), gradients within rel-L2 1e-5 of
    autograd through the plain attention."""
    x = [_rnd(gen, 2, 16, 1024, 80, scale=0.5) for _ in range(3)]
    g = _rnd(gen, 2, 16, 1024, 80)
    counts = lambda: (tflash.forward_launches, tflash.serving_launches,  # noqa: E731
                      tflash.fused_backward_launches)
    before = counts()
    q, k, v = (a.clone().requires_grad_(True) for a in x)
    got = torch.autograd.grad(tattention.scaled_dot_product_attention(q, k, v), (q, k, v), g)
    assert counts() == (before[0] + 1, before[1], before[2] + 1)
    q, k, v = (a.clone().requires_grad_(True) for a in x)
    want = torch.autograd.grad(tattention.attention(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


def test_inference_attention_casts_fp32_qkv_to_bf16(gen):
    """K1 (T 1025) and K10a/K10 (T 2176) on an fp32 qkv: the kernels read it
    in bf16 and the output comes back fp32, as the JAX functions do."""
    for t, h in ((1025, 4), (2176, 2)):
        qkv = _rnd(gen, 2, t, 3 * h * 64)
        f = rotary_freqs(t, 32, device="cuda")
        before = (tattn.launches, tattn.long_launches)
        got = tattn.fused_qkv_rope_attention(qkv, f, h)
        assert (tattn.launches, tattn.long_launches) != before
        assert got.dtype == torch.float32
        plain = (tattn.fused_qkv_rope_attention_plain if t <= tattn.PAIR_MAX_T
                 else tattn.fused_qkv_rope_attention_long_plain)
        _close(got, plain(tattn.kernel_input(qkv), f, h))
