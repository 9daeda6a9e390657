"""The torch port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. The GPU machine has
no JAX, and tests/conftest.py imports it, so run this file there with
`python -m pytest --noconftest -q tests/test_torch_port_cuda.py`. Inputs
are bf16 unless a test says otherwise; tolerance: rel-L2 1e-2 (one bf16
rounding of the output apart, with attention's online softmax rounding P
against running maxima). The fp32 kernels (K7/K9, and K2/K3/K4 on fp32
activations; the fp32 K7, K8 and K9 at head dim 32 too) are held to fp32
tolerances: rel-L2 1e-5 (K9 at head dim 64 1e-4); K8's
dq, whose parts arrive through atomics in a varying order, to 1e-5 too;
K9's dk and dv bit for bit against themselves run to run, its dq (summed
by reduce-adds in a varying order) to 1e-6. K2-K4 under grad (their
autograd Functions: the kernel forward, the plain backward) to rel-L2 1e-5
in fp32 against the plain version's autograd.
K13 (the fused SwiGLU MLP), on each route, to rel-L2 1e-5 in fp32 and 2e-3
(one bf16 rounding) in bf16, and bit for bit against itself (both routes
sum in a fixed order). K11 and K12 (the adaLN elementwise kernels) against the Pallas
kernels' arithmetic to rel-L2 1e-3 and one bf16 step of the largest value
(fp32 sums in another order may move a result across one bf16 rounding),
against the plain chains to 1e-2. The rope-fused K7 against its plain
version: rel-L2 1e-4 in fp32 (both round the roped q and k to bf16, where
an fp32 rounding difference may move one element by a bf16 step), and in
bf16 as the bf16 K7 (1e-2: P rounded against running maxima); the fp32 K7
and K8 at head dim 128 to 1e-5.
"""

import pytest
import torch

from friendly_stable_audio_tools_tpu_torch.ops import attention as tattention
from friendly_stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d as tconv
from friendly_stable_audio_tools_tpu_torch.ops.kernels import elementwise as tew
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash
from friendly_stable_audio_tools_tpu_torch.ops.kernels import mlp as tmlp

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
    """K1 at lengths that are not multiples of the kernel's 64/128-row
    tiles, with and without a masked tail: one K1 and one K10a launch each."""
    for t, kv in ((200, 190), (77, None), (130, 129), (1040, 1025)):
        qkv = _rnd(gen, 2, t, 3 * 4 * 64).to(torch.bfloat16)
        f = rotary_freqs(t, 32, device="cuda")
        before = (tattn.launches, tattn.rope_k_launches)
        got = tattn.fused_qkv_rope_attention(qkv, f, 4, kv_len=kv)
        assert (tattn.launches, tattn.rope_k_launches) == (before[0] + 1, before[1] + 1)
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


# K3 by route (conv1d.ru_route): (dtype, C, B, T, dilation); T 333 (no
# multiple of the 128-row tile) and T 77 (under one tile) at B 2, dilation 9
# reaching 27 rows past both ends; every shape but bf16 C 128 on the split
# route
RU_SHAPES = [(dt, c, 2, t, d) for dt in (torch.bfloat16, torch.float32)
             for c, t, d in ((128, 333, 9), (128, 77, 1), (256, 333, 3), (256, 77, 9),
                             (512, 333, 9), (1024, 77, 9), (1024, 333, 1))]


def _ru_forced(dt, c):
    """The routes a shape can take beside its own (None): the split one
    anywhere, the fused one in bf16 where h's tile fits (128 x C x 2 <=
    RU_H_MAX)."""
    fused_fits = dt == torch.bfloat16 and 128 * c * 2 <= tconv.RU_H_MAX
    return [None] + [r for r in ("fused", "split")
                     if (r == "split" or fused_fits) and r != tconv.ru_route(c, dt)]


RU_CASES = [(*shape, force) for shape in RU_SHAPES for force in _ru_forced(shape[0], shape[1])]


def _ru_inputs(gen, dt, c, b, t):
    x = _rnd(gen, b, t, c, scale=0.5).to(dt)
    w1, w2 = _rnd(gen, 7, c, c, scale=(7 * c) ** -0.5), _rnd(gen, c, c, scale=c ** -0.5)
    b1, b2 = _rnd(gen, c, scale=0.1), _rnd(gen, c, scale=0.1)
    a1, a2 = _rnd(gen, c).abs() + 0.5, _rnd(gen, c).abs() + 0.5
    return x, w1, b1, a1, 1.0 / a1, w2, b2, a2, 1.0 / a2


@pytest.mark.parametrize("dt,c,b,t,d,force", RU_CASES)
def test_fused_residual_unit_routes_match_plain(gen, monkeypatch, dt, c, b, t, d, force):
    """K3 on each route against its plain version: bf16 within one rounding
    (rel-L2 2e-3, max abs 2^-6 of max|plain|), fp32 rel-L2 1e-5; one launch
    of the dtype's counter per call on either route. `force` replaces
    conv1d.ru_route with the route the shape does not take by default."""
    if force is not None:
        monkeypatch.setattr(tconv, "ru_route", lambda *_: force)
    args = _ru_inputs(gen, dt, c, b, t)
    name = ("fused_residual_unit_f32_launches" if dt == torch.float32
            else "fused_residual_unit_launches")
    before = getattr(tconv, name)
    got = tconv.fused_residual_unit(*args, dilation=d)
    assert getattr(tconv, name) == before + 1
    want = tconv.fused_residual_unit_plain(*args, dilation=d)
    assert got.dtype == dt and got.shape == (b, t, c)
    if dt == torch.float32:
        _close(got, want, 1e-5)
    else:
        _close(got, want, 2e-3)
        assert (got.float() - want.float()).abs().max() <= 2.0 ** -6 * want.float().abs().max()


def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x64 = _rnd(gen, 1, 64, 128).double()
    with pytest.raises(TypeError):  # bf16 or fp32 only
        tconv.snake_conv1d(x64, _rnd(gen, 7, 128, 128), None)
    with pytest.raises(ValueError):  # C % 128 != 0
        xb = _rnd(gen, 1, 64, 96).to(torch.bfloat16)
        tconv.fused_residual_unit(xb, _rnd(gen, 7, 96, 96), None, None, None,
                                  _rnd(gen, 96, 96), None, None, None)
    with pytest.raises(NotImplementedError, match="queue B"):  # head dim 32: rope-fused K7's
        tattn.fused_qkv_rope_attention(_rnd(gen, 1, 64, 3 * 4 * 32).to(torch.bfloat16),
                                       rotary_freqs(64, 16, device="cuda"), 4)


@pytest.mark.parametrize("t,kv", [(272, 260), (200, 190), (77, None), (1040, 1025)])
def test_attention_training_kernels_carry_the_gradient(gen, t, kv):
    """With grad, the fp32 qkv goes through K5 and K6 (and K10a three
    times: k^ for K5, q^ and k^ for K6): the output is in the autograd graph
    and qkv.grad is finite and non-zero; it agrees with the plain versions'
    gradient (rel-L2 1e-2: bf16 operands on both sides)."""
    h = 4
    f = rotary_freqs(t, 32, device="cuda")
    x = _rnd(gen, 2, t, 3 * h * 64, scale=0.5)
    g = _rnd(gen, 2, t, h * 64)
    if kv is not None:
        g[:, kv:] = 0
    before = (tattn.launches, tattn.stats_launches, tattn.backward_launches, tattn.rope_k_launches)
    qkv = x.clone().requires_grad_(True)
    out = tattn.fused_qkv_rope_attention(qkv, f, h, kv)
    assert out.requires_grad and out.dtype == torch.float32
    out.backward(g)
    assert (tattn.launches, tattn.stats_launches, tattn.backward_launches,
            tattn.rope_k_launches) == (before[0], before[1] + 1, before[2] + 1, before[3] + 3)
    assert torch.isfinite(qkv.grad).all() and qkv.grad.abs().max() > 0
    xb = x.to(torch.bfloat16)
    o, lse = tattn.fused_qkv_rope_attention_stats_plain(xb, f, h, kv)
    want = tattn.fused_qkv_rope_attention_backward_plain(xb, o, lse, g, f, h, kv,
                                                         dtype=torch.float32)
    _close(qkv.grad, want)


@pytest.mark.parametrize("b,t,h,kv", [(2, 272, 4, 260), (1, 77, 2, None), (8, 1040, 24, 1025)])
def test_pair_backward_agrees_with_itself_run_to_run(gen, b, t, h, kv):
    """K6 twice on the same inputs: dq's key-block partials land in its fp32
    scratch by reduce-adds in whatever order the blocks finish, so dq agrees
    to fp32 rounding (the whole of dqkv within rel-L2 1e-6); dk and dv have
    no such sum and agree bit for bit."""
    qkv = _rnd(gen, b, t, 3 * h * 64).to(torch.bfloat16)
    f = rotary_freqs(t, 32, device="cuda")
    go = _rnd(gen, b, t, h * 64).to(torch.bfloat16)
    if kv is not None:
        go[:, kv:] = 0
    out, lse = tattn.fused_qkv_rope_attention_stats_plain(qkv, f, h, kv)
    runs = [tattn.fused_qkv_rope_attention_backward(qkv, out, lse, go, f, h, kv,
                                                     dtype=torch.float32) for _ in range(2)]
    _close(runs[1], runs[0], tol=1e-6)
    hd = h * 64
    assert torch.equal(runs[1][..., hd:], runs[0][..., hd:])
    _close(runs[0], tattn.fused_qkv_rope_attention_backward_plain(qkv, out, lse, go, f, h, kv,
                                                                  dtype=torch.float32))


def _grad_case(gen, wrapper, plain, shapes, scales, static, dtype=torch.float32):
    """The kernel's autograd Function against the plain version's autograd
    on the same inputs (all requiring grad) and upstream gradient -> the
    largest rel-L2 over the output and the inputs' gradients."""
    args = [((_rnd(gen, *sh).abs() + 0.5) if sc == "pos" else _rnd(gen, *sh, scale=sc))
            .requires_grad_(True) for sh, sc in zip(shapes, scales)]
    args[0] = args[0].detach().to(dtype).requires_grad_(True)
    y = wrapper(*args, *static)
    assert type(y.grad_fn).__name__.startswith(("SnakeConv", "FusedResidual"))
    g = _rnd(gen, *y.shape).to(dtype)
    got = torch.autograd.grad(y, args, g)
    y_ref = plain(*args, *static)
    want = torch.autograd.grad(y_ref, args, g)
    return max(((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip((y, *got), (y_ref, *want)))


def test_conv_kernels_carry_the_gradient(gen):
    """K2-K4 under grad, on each route: the kernel forward with the plain
    version's backward against the plain version's autograd, fp32 to rel-L2
    1e-5 over the output and the gradients of x, w, bias, alpha and inv_beta
    (bf16 to 1e-2); one launch per call, and under torch.no_grad() no
    autograd graph and nothing kept beyond the output."""
    c = 128
    snake = [(c,), (c,)]
    cases = [  # (wrapper, plain, shapes, scales, static, dtype)
        (tconv.snake_conv1d, tconv.snake_conv1d_plain, [(2, 999, 2), (7, 2, c), (c,)],
         [0.5, 0.1, 0.1], (None, None, 1), torch.float32),  # thin: CUDA cores
        (tconv.snake_conv1d, tconv.snake_conv1d_plain, [(2, 999, c), (7, c, 2), (2,)] + snake,
         [0.5, 0.03, 0.1, "pos", "pos"], (1,), torch.float32),  # thin-out
        (tconv.snake_conv1d, tconv.snake_conv1d_plain, [(2, 333, 256), (3, 256, c), (c,),
                                                        (256,), (256,)],
         [0.5, 0.03, 0.1, "pos", "pos"], (1,), torch.float32),  # wide
        (tconv.fused_residual_unit, tconv.fused_residual_unit_plain,
         [(2, 333, c), (7, c, c), (c,)] + snake + [(c, c), (c,)] + snake,
         [0.5, 0.03, 0.1, "pos", "pos", 0.06, 0.1, "pos", "pos"], (9,), torch.float32),  # split
        (tconv.fused_residual_unit, tconv.fused_residual_unit_plain,
         [(2, 333, c), (7, c, c), (c,)] + snake + [(c, c), (c,)] + snake,
         [0.5, 0.03, 0.1, "pos", "pos", 0.06, 0.1, "pos", "pos"], (3,), torch.bfloat16),  # fused
        (tconv.snake_conv_transpose1d, tconv.snake_conv_transpose1d_plain,
         [(2, 129, 256), (8, 256, c), (c,), (256,), (256,)],
         [0.5, 0.06, 0.1, "pos", "pos"], (4,), torch.float32),
    ]
    for wrapper, plain, shapes, scales, static, dtype in cases:
        before = sum(getattr(tconv, n) for n in dir(tconv) if n.endswith("_launches"))
        rel = _grad_case(gen, wrapper, plain, shapes, scales, static, dtype)
        after = sum(getattr(tconv, n) for n in dir(tconv) if n.endswith("_launches"))
        assert after == before + 1, (wrapper.__name__, static)
        assert rel < (1e-5 if dtype == torch.float32 else 1e-2), (wrapper.__name__, static, rel)
    x = _rnd(gen, 1, 4096, c).requires_grad_(True)
    w = _rnd(gen, 7, c, c, scale=0.03).requires_grad_(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        y = tconv.snake_conv1d(x, w, None)
    torch.cuda.synchronize()
    assert y.grad_fn is None
    assert torch.cuda.memory_allocated() == base + y.untyped_storage().nbytes()


def test_long_attention_kernels_match_plain(gen):
    """K10a against its plain version (one bf16 rounding apart, rel-L2 1e-3),
    and the long path (K10a then K10) against its plain version, at ragged
    lengths over 2048; each call launches K10a and K10 once and K1 never."""
    for b, t, h, kv in ((2, 2176, 4, 2050), (1, 2049, 2, None), (1, 2100, 2, 2090)):
        qkv = _rnd(gen, b, t, 3 * h * 64).to(torch.bfloat16)
        f = rotary_freqs(t, 32, device="cuda")
        _close(tattn.rope_pair_k(qkv, f, h), tattn.rope_pair_k_plain(qkv, f, h), tol=1e-3)
        before = (tattn.launches, tattn.rope_k_launches, tattn.long_launches)
        got = tattn.fused_qkv_rope_attention(qkv, f, h, kv_len=kv)
        assert (tattn.launches, tattn.rope_k_launches, tattn.long_launches) == (
            before[0], before[1] + 1, before[2] + 1)
        _close(got, tattn.fused_qkv_rope_attention_long_plain(qkv, f, h, kv_len=kv))


def test_attention_beyond_the_long_path_raises_on_cuda(gen):
    """Past 8192 tokens the split route runs K7 without its LSE by dtype (bf16
    here) and matches the plain route; a head dim K7 does not take raises."""
    qkv = _rnd(gen, 1, 8193, 3 * 2 * 64).to(torch.bfloat16)
    f = rotary_freqs(8193, 32, device="cuda")
    before = (tflash.serving_bf16_launches, tattn.launches, tattn.long_launches)
    got = tattn.fused_qkv_rope_attention(qkv, f, 2, kv_len=8100)
    assert (tflash.serving_bf16_launches, tattn.launches, tattn.long_launches) == (
        before[0] + 1, before[1], before[2])
    _close(got[:, :8100], tattn.fused_qkv_rope_attention_plain(qkv, f, 2, kv_len=8100)[:, :8100])
    with pytest.raises(NotImplementedError, match="head dim"):
        tattn.fused_qkv_rope_attention(_rnd(gen, 1, 8193, 3 * 32).to(torch.bfloat16),
                                       rotary_freqs(8193, 32, device="cuda"), 1)


@pytest.mark.parametrize("bh,t,d,kv", [
    (3, 300, 80, 290), (2, 1024, 64, None), (2, 77, 64, None), (1, 8576, 64, 8449),
    (2, 4096, 64, None), (2, 1024, 80, None),  # the U-Net's levels, two heads
    (2, 16, 64, None), (2, 16, 80, None),  # fewer rows than one warpgroup
    (2, 129, 64, None), (2, 129, 80, None),  # one key past a 128-key tile
    (2, 200, 64, 1), (2, 200, 80, 1),  # one valid key
    (2, 300, 64, 192), (2, 300, 80, 192),  # kv_len in the middle of a tile
    (2, 8576, 80, 8449)])
def test_flash_forward_bf16_matches_plain(gen, bh, t, d, kv):
    """K7 in bf16 (serving) against its plain version at ragged T and kv_len
    around its 128-row q tiles and 128-key tiles, at head dims 64 and 80:
    one launch of its own counter, bf16 out, rel-L2 1e-2; with its LSE, or
    causal, it raises."""
    q, k, v = (_rnd(gen, bh, t, d).to(torch.bfloat16) for _ in range(3))
    before = (tflash.serving_bf16_launches, tflash.serving_launches)
    out, lse = tflash.flash_forward(q, k, v, kv, save_stats=False)
    assert (tflash.serving_bf16_launches, tflash.serving_launches) == (before[0] + 1, before[1])
    assert lse is None and out.dtype == torch.bfloat16
    _close(out, tflash.flash_forward_plain(q, k, v, kv, save_stats=False)[0])
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        tflash.flash_forward(q, k, v, kv, save_stats=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        tflash.flash_forward(q, q, q, save_stats=False, causal=True)


def test_bf16_conv_transpose_at_the_dac_widths(gen):
    """The bf16 K4 at Cout % 128 != 0 (the DAC decoder's 384 -> 192 and
    192 -> 96 upsamples) against its plain version."""
    for cin, cout in ((384, 192), (192, 96)):
        x = _rnd(gen, 1, 333, cin, scale=0.5).to(torch.bfloat16)
        wt = _rnd(gen, 8, cin, cout, scale=1 / (2 * cin) ** 0.5)
        bias = _rnd(gen, cout, scale=0.1)
        before = tconv.snake_conv_transpose1d_launches
        got = tconv.snake_conv_transpose1d(x, wt, bias, stride=4)
        assert tconv.snake_conv_transpose1d_launches == before + 1
        assert got.shape == (1, 333 * 4, cout)
        _close(got, tconv.snake_conv_transpose1d_plain(x, wt, bias, stride=4), 2e-3)


def _k9_agrees_with_itself(first, second):
    """K9 run twice on the same inputs: dk and dv bit-equal (fixed sums), dq
    (summed by reduce-adds in whatever order the key blocks get there)
    within rel-L2 1e-6."""
    dq0, dk0, dv0 = first
    dq1, dk1, dv1 = second
    assert torch.equal(dk0, dk1) and torch.equal(dv0, dv1)
    _close(dq1, dq0, tol=1e-6)


def test_flash_kernels_match_plain_in_fp32(gen):
    """K7 (out rel-L2 1e-5, LSE max abs 1e-4) and K9 (dq, dk, dv rel-L2 1e-4
    each, exactly zero on the rows at or past kv_len) against their plain
    versions in fp32, at ragged lengths (below, at and just past one 64-row
    tile), kv_len one key, in the middle of a key block and SA 2.0's, one
    head and SA 2.0's length; one launch each per call, and K9 against
    itself run to run."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash

    for bh, t, kv in ((3, 200, 190), (2, 77, None), (2, 1424, None), (2, 64, None), (3, 65, None),
                      (2, 129, None), (2, 150, 1), (2, 300, 161), (1, 333, None),
                      (2, 6272, 6145)):
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
        for name, got, want in zip("dq dk dv".split(), grads,
                                   tflash.flash_backward_plain(q, k, v, out, lse, do, kv)):
            if kv == 1 and name != "dv":
                # one visible key: p = 1 and delta = dp, so ds, dq and dk are
                # zero but for the rounding of dp - delta on either side
                assert got.abs().max().item() <= 1e-5 and want.abs().max().item() <= 1e-5
            else:
                _close(got, want, tol=1e-4)
            if kv is not None:
                assert not got[:, kv:].any()
        _k9_agrees_with_itself(grads, tflash.flash_backward(q, k, v, out, lse, do, kv))


@pytest.mark.parametrize("bh,t,kv", [(16, 1024, None), (16, 2048, None), (2, 200, 190),
                                     (2, 77, None), (3, 129, None), (2, 300, 1),
                                     (1, 8192, None)])
def test_flash_forward_f32_at_head_dim_32_matches_plain(gen, bh, t, kv):
    """The fp32 K7 at head dim 32 (Dance Diffusion's U-Net: 16 heads, T
    1024-8192), serving and with its LSE, at ragged lengths and kv_len:
    out rel-L2 1e-5, LSE max abs 1e-4, one launch of its own counter per
    call; under grad from T 1024 FlashAttention runs it with its LSE, then
    K8 (K9 at T 8192), on counters of their own."""
    q, k, v = (_rnd(gen, bh, t, 32) for _ in range(3))
    before = (tflash.d32_launches, tflash.serving_launches, tflash.forward_launches)
    out, lse = tflash.flash_forward(q, k, v, kv, save_stats=False)
    out_lse, lse = tflash.flash_forward(q, k, v, kv)
    assert (tflash.d32_launches, tflash.serving_launches, tflash.forward_launches) == (
        before[0] + 2, before[1], before[2])
    out_p, lse_p = tflash.flash_forward_plain(q, k, v, kv)
    _close(out, out_p, tol=1e-5)
    _close(out_lse, out_p, tol=1e-5)
    assert (lse - lse_p).abs().max().item() <= 1e-4
    if t >= 1024:
        qg = q.clone().requires_grad_(True)
        bwd = (tflash.d32_fused_backward_launches, tflash.d32_backward_launches,
               tflash.fused_backward_launches, tflash.backward_launches)
        tflash.FlashAttention.apply(qg, k, v).sum().backward()
        kernel = tflash.backward_kernel(t, t, 32)
        assert tflash.d32_launches == before[0] + 3
        assert (tflash.d32_fused_backward_launches, tflash.d32_backward_launches,
                tflash.fused_backward_launches, tflash.backward_launches) == (
            bwd[0] + (kernel == "K8"), bwd[1] + (kernel == "K9"), bwd[2], bwd[3])
        assert torch.isfinite(qg.grad).all()


# (BH, T, kv_len, kernel) of K8 and K9 at head dim 32: Dance Diffusion's
# training shapes (T 1024-4096: K8; T 8192: K9), ragged lengths and kv_len
D32_BWD = [(32, 1024, None, "K8"), (16, 2048, None, "K8"), (16, 4096, None, "K8"),
           (16, 8192, None, "K9"), (2, 200, 190, "K8"), (2, 200, 190, "K9"),
           (3, 77, None, "K8"), (3, 129, None, "K9"), (2, 300, 1, "K8")]


@pytest.mark.parametrize("bh,t,kv,kernel", D32_BWD)
def test_flash_backward_at_head_dim_32_matches_plain(gen, bh, t, kv, kernel):
    """K8 and K9 at head dim 32 (the two-warpgroup kernel's D 32 instance)
    against their plain versions: dq, dk and dv to rel-L2 1e-5, rows past
    kv_len zero in dk and dv (dO zero there, as on a padded path), one
    launch of their own counter per call; the causal K9 at head dim 32
    raises before any launch."""
    q, k, v, do = (_rnd(gen, bh, t, 32) for _ in range(4))
    if kv is not None:
        do[:, kv:] = 0
    out, lse = tflash.flash_forward_plain(q, k, v, kv)
    fn, plain = ((tflash.flash_backward_fused, tflash.flash_backward_fused_plain)
                 if kernel == "K8" else (tflash.flash_backward, tflash.flash_backward_plain))
    names = ("d32_fused_backward_launches", "d32_backward_launches", "fused_backward_launches",
             "backward_launches")
    before = [getattr(tflash, n) for n in names]
    got = fn(q, k, v, out, lse, do, kv)
    torch.cuda.synchronize()
    assert [getattr(tflash, n) for n in names] == [
        before[0] + (kernel == "K8"), before[1] + (kernel == "K9"), before[2], before[3]]
    for g, w, name in zip(got, plain(q, k, v, out, lse, do, kv), ("dq", "dk", "dv")):
        if kv == 1 and name != "dv":  # one visible key: p = 1, ds zero but for rounding
            assert g.abs().max().item() <= 1e-5 and w.abs().max().item() <= 1e-5
        else:
            _close(g, w, tol=1e-5)
        if kv is not None and name != "dq":
            assert not g[:, kv:].any()
    after = [getattr(tflash, n) for n in names] + [tflash.causal_backward_launches]
    with pytest.raises(NotImplementedError, match="queue B"):
        tflash.flash_backward(q, k, v, out, lse, do, kv, causal=True)
    assert [getattr(tflash, n) for n in names] + [tflash.causal_backward_launches] == after


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


@pytest.mark.parametrize("bh,t,d,kv", [(3, 200, 80, 190), (2, 1184, 64, 1177), (4, 1024, 80, None),
                                       (2, 77, 64, None), (2, 130, 64, 65), (2, 150, 80, 129),
                                       (2, 2048, 64, None)])
def test_flash_backward_fused_matches_plain_in_fp32(gen, bh, t, d, kv):
    """K8 (one launch) against its plain version from the same residuals:
    dq, dk, dv rel-L2 1e-5 each, exactly zero on padded rows, at T below,
    past and at whole tiles, kv_len one key into a tile, head dims 64 and
    80; run twice, dk and dv bit-equal and dq within rel-L2 1e-6 (summed in
    a varying order); other head dims raise."""
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
    _k9_agrees_with_itself(grads, tflash.flash_backward_fused(q, k, v, out, lse, do, kv))
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        tflash.flash_backward_fused(*(x[..., :48].contiguous() for x in (q, k, v, out)),
                                    lse, do[..., :48].contiguous(), kv)


def test_fp32_conv_kernels_match_plain(gen):
    """K2, K3 and K4 on fp32 activations run the fp32 kernels (their own
    launch counts; both K2 shapes take the wide route), with and without the
    snake, at the DAC decoder's Cout 96."""
    x = _rnd(gen, 2, 333, 128, scale=0.5)
    a = _rnd(gen, 128).abs() + 0.5
    ib = 1.0 / a
    bias = _rnd(gen, 128, scale=0.1)
    w = _rnd(gen, 7, 128, 128, scale=0.03)
    before = (tconv.snake_conv1d_f32_launches, tconv.snake_conv1d_wide_f32_launches,
              tconv.fused_residual_unit_f32_launches, tconv.snake_conv_transpose1d_f32_launches,
              tconv.snake_conv1d_launches, tconv.snake_conv1d_wide_launches)
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
    after = (tconv.snake_conv1d_f32_launches, tconv.snake_conv1d_wide_f32_launches,
             tconv.fused_residual_unit_f32_launches, tconv.snake_conv_transpose1d_f32_launches,
             tconv.snake_conv1d_launches, tconv.snake_conv1d_wide_launches)
    assert tuple(b - a_ for a_, b in zip(before, after)) == (0, 2, 1, 2, 0, 0)
    with pytest.raises(ValueError):  # Cout % 32 != 0
        tconv.snake_conv_transpose1d(x, wt[..., :80], None, stride=4)


@pytest.mark.parametrize("t,d,kv", [(1024, 80, None), (2048, 64, None), (200, 80, None),
                                    (77, 64, None), (130, 80, 65), (8576, 64, 8449)])
def test_flash_forward_serving_matches_plain(gen, t, d, kv):
    """K7 without the LSE (the ADP U-Net's self-attention; the DiT's past
    8192 tokens) at head dims 64 and 80 against its plain version, at T
    below and past whole tiles and kv_len one key into a tile; other head
    dims raise."""
    q, k, v = (_rnd(gen, 6 if t < 8192 else 2, t, d) for _ in range(3))
    before = tflash.serving_launches
    out, lse = tflash.flash_forward(q, k, v, kv, save_stats=False)
    assert lse is None and tflash.serving_launches == before + 1
    _close(out, tflash.flash_forward_plain(q, k, v, kv, save_stats=False)[0], 1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        tflash.flash_forward(q[..., :48], k[..., :48], v[..., :48], save_stats=False)


@pytest.mark.parametrize("bh,t,d,kv,causal", [(3, 200, 80, None, True), (2, 1501, 80, None, True),
                                              (2, 130, 80, 65, False), (3, 333, 64, 257, False),
                                              (2, 1024, 80, None, False)])
def test_fp32_flash_forward_with_and_without_lse_at_d80_and_kv_len(gen, bh, t, d, kv, causal):
    """The fp32 K7 with and without its LSE, causal or with kv_len one key
    into a tile, at head dims 80 and 64, against its plain version (out
    rel-L2 1e-5, LSE max abs 1e-4), one launch each under its own counter."""
    q, k, v = (_rnd(gen, bh, t, d) for _ in range(3))
    counts = lambda: (tflash.forward_launches, tflash.serving_launches,  # noqa: E731
                      tflash.causal_forward_launches, tflash.causal_serving_launches)
    before = counts()
    out, lse = tflash.flash_forward(q, k, v, kv, causal=causal)
    served, none = tflash.flash_forward(q, k, v, kv, save_stats=False, causal=causal)
    step = (0, 0, 1, 1) if causal else (1, 1, 0, 0)
    assert none is None and counts() == tuple(a + b for a, b in zip(before, step))
    out_p, lse_p = tflash.flash_forward_plain(q, k, v, kv, causal=causal)
    _close(out, out_p, 1e-5)
    _close(served, out_p, 1e-5)
    assert (lse - lse_p).abs().max().item() <= 1e-4


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


def _causal_counts():
    return (tflash.causal_forward_launches, tflash.causal_serving_launches,
            tflash.causal_backward_launches, tflash.forward_launches, tflash.serving_launches,
            tflash.backward_launches, tflash.fused_backward_launches)


@pytest.mark.parametrize("bh,t", [(3, 200), (4, 1501), (2, 1100), (1, 64), (2, 65),
                                  (1, 129), (2, 127)])
def test_causal_flash_kernels_match_plain_in_fp32(gen, bh, t):
    """The causal K7 with and without its LSE and the causal K9 against their
    plain versions (rel-L2 1e-5, K9 1e-4), each counted apart from the
    non-causal kernels, K9 against itself run to run; causal needs as many
    queries as keys."""
    q, k, v, do = (_rnd(gen, bh, t, 64) for _ in range(4))
    before = _causal_counts()
    out, lse = tflash.flash_forward(q, k, v, causal=True)
    served, _ = tflash.flash_forward(q, k, v, save_stats=False, causal=True)
    out_p, lse_p = tflash.flash_forward_plain(q, k, v, causal=True)
    grads = tflash.flash_backward(q, k, v, out_p, lse_p, do, causal=True)
    assert _causal_counts() == (before[0] + 1, before[1] + 1, before[2] + 1, *before[3:])
    _close(out, out_p, 1e-5)
    _close(served, out_p, 1e-5)
    assert (lse - lse_p).abs().max().item() <= 1e-4
    for got, want in zip(grads, tflash.flash_backward_plain(q, k, v, out_p, lse_p, do, causal=True)):
        _close(got, want, 1e-4)
    _k9_agrees_with_itself(grads, tflash.flash_backward(q, k, v, out_p, lse_p, do, causal=True))
    with pytest.raises(ValueError, match="as many queries as keys"):
        tflash.flash_forward(q, k[:, :t - 1].contiguous(), v[:, :t - 1].contiguous(), causal=True)


def test_sdpa_gate_sends_causal_self_attention_to_causal_k7_and_k9(gen):
    """The LM's causal self-attention at T 1501: under grad FlashAttention
    with causal set (causal K7 with its LSE, then the causal K9; never K8),
    gradients within rel-L2 1e-4 of autograd of the plain attention; without
    grad the causal K7 alone."""
    q, k, v = (_rnd(gen, 2, 4, 1501, 64).requires_grad_(True) for _ in range(3))
    g = _rnd(gen, 2, 4, 1501, 64)
    before = _causal_counts()
    out = tattention.scaled_dot_product_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert _causal_counts() == (before[0] + 1, before[1], before[2] + 1, *before[3:])
    ref = tattention.attention(q, k, v, causal=True)
    _close(out, ref, 1e-5)
    for a, b in zip(got, torch.autograd.grad(ref, (q, k, v), g)):
        _close(a, b, 1e-4)
    with torch.no_grad():
        served = tattention.scaled_dot_product_attention(q, k, v, causal=True)
    assert _causal_counts()[1] == before[1] + 1
    _close(served, ref, 1e-5)


def test_tiny_lm_train_step_runs_the_causal_kernels(gen):
    """A tiny audio LM (tests/test_torch_lm.py's, without T5: the
    conditioning tokens are passed in) computes its logits and gradients on
    the card from raw audio: the SEANet's six stride-1 convs through the fp32
    K2, the causal self-attention of its 2 layers (T 1101) through the causal
    K7 and K9; a finite loss."""
    from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    seanet = {"channels": 1, "dimension": 16, "n_filters": 4, "ratios": [2, 3], "lstm": 2}
    config = {"model_type": "lm", "sample_size": 6600, "sample_rate": 32000, "audio_channels": 1,
              "model": {
                  "pretransform": {"type": "autoencoder", "config": {
                      "encoder": {"type": "seanet", "config": seanet},
                      "decoder": {"type": "seanet", "config": seanet},
                      "bottleneck": {"type": "rvq", "config": {
                          "num_quantizers": 4, "codebook_size": 32, "dim": 16}},
                      "latent_dim": 16, "downsampling_ratio": 6, "io_channels": 1}},
                  "lm": {"type": "continuous_transformer", "cross_attention_cond_ids": ["prompt"],
                         "config": {"embed_dim": 128, "depth": 2, "num_heads": 2,
                                    "cross_attn_cond_dim": 512, "project_cross_attn_cond": True}}}}
    model = create_model_from_config(config, device="cuda").train()
    reals = _rnd(gen, 2, 1, 6600, scale=0.3)
    cond = {"prompt": (_rnd(gen, 2, 8, 512), torch.ones(2, 8, dtype=torch.bool, device="cuda"))}
    before = (*_causal_counts(), tconv.snake_conv1d_f32_launches)
    codes = model.pretransform.tokenize(reals)
    out = model.compute_logits(codes, cond)
    loss = torch.nan_to_num(out.logits).square().mean()
    loss.backward()
    after = (*_causal_counts(), tconv.snake_conv1d_f32_launches)
    assert codes.shape == (2, 4, 1100)
    assert tuple(b - a for a, b in zip(before, after)) == (2, 0, 2, 0, 0, 0, 0, 6)
    assert torch.isfinite(loss)


def _glu_inputs(gen, m, k, inner, kout, dtype, bias):
    return (_rnd(gen, m, k).to(dtype), _rnd(gen, 2 * inner, k, scale=k ** -0.5).to(dtype),
            _rnd(gen, 2 * inner, scale=0.1) if bias else None,
            _rnd(gen, kout, inner, scale=inner ** -0.5).to(dtype))


def _route_counts():
    return tmlp.launches, tmlp.stream_launches, tmlp.tensor_launches


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 2, 100, 2050])
@pytest.mark.parametrize("route", ["stream", "tensor"])
def test_glu_mlp_matches_plain(gen, monkeypatch, route, m, dtype, bias):
    """Each route (forced) at ragged M, with and without the bias, against
    the plain version; twice on the same inputs with the same bits (both
    routes sum in a fixed order); one launch count per call on the route's
    counter. K 256, inner 640 (5 of bf16 GEMM1's 128-column tiles, 20 of the
    streaming tiles' 32), Kout 200 (a ragged last tile of GEMM2). The
    streaming kernel takes M <= 16 and refuses more."""
    x, w_in, b_in, w_out = _glu_inputs(gen, m, 256, 640, 200, dtype, bias)
    monkeypatch.setattr(tmlp, "route", lambda *shape: route)
    if route == "stream" and m > 16:
        with pytest.raises(ValueError):
            tmlp.glu_mlp(x, w_in, b_in, w_out)
        return
    before = _route_counts()
    with torch.no_grad():
        got = tmlp.glu_mlp(x, w_in, b_in, w_out)
        again = tmlp.glu_mlp(x, w_in, b_in, w_out)
    after = _route_counts()
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (
        2, 2 if route == "stream" else 0, 2 if route == "tensor" else 0)
    assert got.shape == (m, 200) and got.dtype == dtype and torch.equal(got, again)
    _close(got, tmlp.glu_mlp_plain(x, w_in, b_in, w_out), 1e-5 if dtype == torch.float32 else 2e-3)


@pytest.mark.parametrize("m,k,inner,kout,dtype,bias", [
    (2, 1024, 4096, 1024, torch.float32, True), (100, 136, 256, 96, torch.float32, False),
    (16, 256, 512, 128, torch.bfloat16, True), (2052, 128, 384, 200, torch.bfloat16, True),
    (2050, 1536, 6144, 1536, torch.bfloat16, True), (2080, 1536, 6144, 1536, torch.float32, False)])
def test_glu_mlp_routes_by_shape(gen, m, k, inner, kout, dtype, bias):
    """Through the route `mlp.route` names (the LM's decode streams, the
    DiT's tokens take the tensor cores), batched x [3, M / 3.., K]."""
    x, w_in, b_in, w_out = _glu_inputs(gen, 3 * m, k, inner, kout, dtype, bias)
    x = x.view(3, m, k)
    route = tmlp.route(3 * m, k, inner, kout, dtype)
    before = _route_counts()
    with torch.no_grad():
        got = tmlp.glu_mlp(x, w_in, b_in, w_out)
    after = _route_counts()
    assert after[1] - before[1] == (route == "stream") and after[2] - before[2] == (route == "tensor")
    assert got.shape == (3, m, kout) and got.dtype == dtype
    _close(got, tmlp.glu_mlp_plain(x, w_in, b_in, w_out), 1e-5 if dtype == torch.float32 else 2e-3)


def test_glu_mlp_raises_on_what_the_kernel_does_not_take(gen, monkeypatch):
    x = _rnd(gen, 2, 128)
    w_in, w_out = _rnd(gen, 512, 128), _rnd(gen, 128, 256)
    with pytest.raises(TypeError):
        tmlp.glu_mlp(x, w_in.double(), None, w_out)
    with monkeypatch.context() as mp, pytest.raises(ValueError):
        mp.setattr(tmlp, "route", lambda *shape: "stream")  # inner 240: no multiple of 32 columns
        tmlp.glu_mlp(x, _rnd(gen, 480, 128), None, _rnd(gen, 128, 240))
    with pytest.raises(ValueError):  # an odd Kout at M 64: no tensor route, and M > 16
        tmlp.glu_mlp(_rnd(gen, 64, 128), w_in, None, _rnd(gen, 127, 256))
    with pytest.raises(ValueError):  # bf16 K 100: no 16-byte row for TMA, on either route
        tmlp.glu_mlp(_rnd(gen, 2050, 100).to(torch.bfloat16),
                     _rnd(gen, 512, 100).to(torch.bfloat16), None,
                     _rnd(gen, 128, 256).to(torch.bfloat16))
    for m in (2, 2050):  # no backward on either route: a weight that needs a gradient
        with pytest.raises(RuntimeError):
            tmlp.glu_mlp(_rnd(gen, m, 128), w_in.clone().requires_grad_(True), None, w_out)


def test_glu_mlp_streams_on_two_streams_at_once(gen):
    """Streaming launches on two streams at once (each grid 20 blocks, so
    both are resident together) give the bits each gives alone: each launch
    meets its own grid barrier."""
    calls = [_glu_inputs(gen, 2, 256, 640, 200, dtype, True)
             for dtype in (torch.float32, torch.float32, torch.bfloat16)]
    assert {tmlp.route(2, 256, 640, 200, c[0].dtype) for c in calls} == {"stream"}
    with torch.no_grad():
        alone = [tmlp.glu_mlp(*c) for c in calls]
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        outs = [[], []]
        for _ in range(20):
            for i, s in enumerate(streams):
                with torch.cuda.stream(s):
                    outs[i].append([tmlp.glu_mlp(*c) for c in calls[i:i + 2]])
        torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            assert all(torch.equal(g, a) for g, a in zip(got, alone[i:i + 2]))


def test_glu_mlp_takes_the_tensor_cores_where_the_streaming_plan_does_not_fit(gen):
    """The streaming kernel plans its grid from the card: at the LM's decode
    128 blocks of 8 outputs; Kout 300 over inner 256's 8 blocks would be 38
    outputs per block, past its 32, so the plan refuses and the call takes
    the tensor cores, though `route` names the streaming route by shape."""
    plan = tmlp.stream_plan(torch.device("cuda", torch.cuda.current_device()), 2, 1024, 4096, 1024,
                            torch.float32)
    assert plan is not None and (plan["m_tile"], plan["blocks"], plan["outputs"]) == (2, 128, 8)
    x, w_in, b_in, w_out = _glu_inputs(gen, 2, 128, 256, 300, torch.bfloat16, True)
    assert tmlp.route(2, 128, 256, 300, torch.bfloat16) == "stream"
    assert tmlp.stream_plan(x.device, 2, 128, 256, 300, torch.bfloat16) is None
    before = _route_counts()
    with torch.no_grad():
        got = tmlp.glu_mlp(x, w_in, b_in, w_out)
    after = _route_counts()
    assert (after[1] - before[1], after[2] - before[2]) == (0, 1)
    _close(got, tmlp.glu_mlp_plain(x, w_in, b_in, w_out), 2e-3)


def test_tiny_lm_generates_through_k13(gen):
    """A tiny audio LM with the fused MLP switched on generates on the card:
    K13 once per layer and decode_step call (a prefill and one call per
    generated step), the same codes as with the switch off (greedy), and
    audio through the fp32 K2 and K4 (16 filters: the fp32 K4 takes 32-multiples
    of channels)."""
    from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    seanet = {"channels": 1, "dimension": 16, "n_filters": 16, "ratios": [2, 3], "lstm": 2}
    config = {"model_type": "lm", "sample_size": 6600, "sample_rate": 32000, "audio_channels": 1,
              "model": {
                  "pretransform": {"type": "autoencoder", "config": {
                      "encoder": {"type": "seanet", "config": seanet},
                      "decoder": {"type": "seanet", "config": seanet},
                      "bottleneck": {"type": "rvq", "config": {
                          "num_quantizers": 4, "codebook_size": 32, "dim": 16}},
                      "latent_dim": 16, "downsampling_ratio": 6, "io_channels": 1}},
                  "lm": {"type": "continuous_transformer", "cross_attention_cond_ids": ["prompt"],
                         "config": {"embed_dim": 128, "depth": 2, "num_heads": 2,
                                    "cross_attn_cond_dim": 512, "project_cross_attn_cond": True}}}}
    cond = {"prompt": (_rnd(gen, 1, 8, 512), torch.ones(1, 8, dtype=torch.bool, device="cuda"))}
    codes = {}
    for fused in (False, True):
        model = create_model_from_config(config, device="cuda", fused_mlp=fused)
        before = (tmlp.launches, tconv.snake_conv1d_f32_launches,
                  tconv.snake_conv1d_wide_f32_launches, tconv.snake_conv_transpose1d_f32_launches)
        codes[fused] = model.generate(max_gen_len=20, conditioning_tensors=cond, cfg_scale=3.0,
                                      temp=0.0)
        audio = model.pretransform.decode_tokens(codes[fused])
        after = (tmlp.launches, tconv.snake_conv1d_f32_launches,
                 tconv.snake_conv1d_wide_f32_launches, tconv.snake_conv_transpose1d_f32_launches)
        # 24 steps of the delay pattern: a prefill and 23 decode steps, 2 layers;
        # K2 on the wide route at 16 -> 64 and 16 -> 32, on the thin one at
        # Cout 16, 8 and 1 (no tile width divides them)
        assert tuple(b - a for a, b in zip(before, after)) == (48 if fused else 0, 4, 2, 1)
        assert audio.shape == (1, 1, 119) and torch.isfinite(audio).all()
    assert torch.equal(codes[False], codes[True])


def _adaln_vectors(gen, b, d):
    """scale, shift and gate as the DiT makes them: chunks of one [B, 1, 6D]
    bf16 projection, read in place by the kernels."""
    return _rnd(gen, b, 1, 6 * d, scale=0.3).to(torch.bfloat16).chunk(6, dim=-1)[:3]


def _one_rounding(got, want):
    _close(got, want, 1e-3)
    assert (got.float() - want.float()).abs().max() <= 2.0 ** -7 * want.float().abs().max()


# K11 at the gate's edges: the DiT's width with each gamma; D 128 (two rows
# a warp) at T 1, 77 and 1025; D 4096 at T 300; B * T not a multiple of a
# block's 8 warps (231, 2331, 26 rows) and batch rows split across two
# blocks (T 77, 777, 13, 1025); T 1 (a block's rows in eight batch
# indices); a lane's last vector past the row (D 384); more rows than the
# card holds at once (each warp then takes several: D 1536 B8 T1024, D 128
# B8 T8448, D 4096 B2 T2000)
LNMOD_CASES = [(2, 1024, 1536, "bf16"), (2, 1024, 1536, None), (2, 1024, 1536, "fp32"),
               (3, 777, 1536, "bf16"), (3, 77, 128, "fp32"), (2, 1, 128, None),
               (2, 1025, 128, "bf16"), (1, 300, 4096, "bf16"), (2, 300, 4096, "fp32"),
               (2, 13, 1536, None), (8, 1, 256, "bf16"), (3, 50, 384, "fp32"),
               (8, 1024, 1536, "bf16"), (8, 8448, 128, None), (2, 2000, 4096, "bf16")]


def _lnmod_inputs(gen, b, t, d, gamma):
    x = _rnd(gen, b, t, d).to(torch.bfloat16)
    g = None if gamma is None else (1 + _rnd(gen, d, scale=0.1)).to(
        torch.bfloat16 if gamma == "bf16" else torch.float32)
    scale, shift, _ = _adaln_vectors(gen, b, d)
    return x, g, scale, shift


@pytest.mark.parametrize("b,t,d,gamma", LNMOD_CASES)
def test_ln_modulate_kernel_matches_plain(gen, b, t, d, gamma):
    x, g, scale, shift = _lnmod_inputs(gen, b, t, d, gamma)
    before = tew.lnmod_launches
    got = tew.ln_modulate(x, g, scale, shift)
    assert tew.lnmod_launches == before + 1 and got.dtype == torch.bfloat16
    _one_rounding(got, tew.ln_modulate_kernel_math(x, g, scale, shift))
    _close(got, tew.ln_modulate_plain(x, g, scale, shift))


@pytest.mark.parametrize("b,t,d,gamma", [(2, 1024, 1536, "bf16"), (3, 77, 128, "fp32"),
                                         (8, 1, 4096, None)])
def test_ln_modulate_kernel_is_the_same_under_any_plan(gen, monkeypatch, b, t, d, gamma):
    """K11 computes each row alike whatever its plan: 4 or 1 warps a block,
    one block, a grid of one block an SM, nothing staged, one slot staged
    (the other rows' vectors read from global memory): bit for bit."""
    x, g, scale, shift = _lnmod_inputs(gen, b, t, d, gamma)
    want = tew.ln_modulate(x, g, scale, shift)
    plan = tew.lnmod_plan(b * t, t, d, tew.sm_count(x.device))
    for other in (plan._replace(warps=4), plan._replace(warps=1), plan._replace(grid=1),
                  plan._replace(grid=132), plan._replace(slots=0),
                  plan._replace(grid=3, slots=1)):
        monkeypatch.setattr(tew, "lnmod_plan", lambda *a, other=other: other)
        assert torch.equal(tew.ln_modulate(x, g, scale, shift), want), other


@pytest.mark.parametrize("b,t,d", [(2, 1024, 1536), (3, 77, 128), (1, 300, 4096)])
def test_gated_residual_kernel_matches_plain(gen, b, t, d):
    y, res = (_rnd(gen, b, t, d).to(torch.bfloat16) for _ in range(2))
    _, _, gate = _adaln_vectors(gen, b, d)
    before = tew.gres_launches
    got = tew.gated_residual(y, gate, res)
    assert tew.gres_launches == before + 1 and got.dtype == torch.bfloat16
    _one_rounding(got, tew.gated_residual_kernel_math(y, gate, res))
    _close(got, tew.gated_residual_plain(y, gate, res))


def test_elementwise_kernels_carry_the_gradient(gen):
    """Under grad each kernel's autograd binding launches it forward and
    differentiates the plain chain: every input's gradient equals the plain
    chain's autograd on the same inputs and cotangent (the same operations
    in the same order)."""
    b, t, d = 2, 256, 1536
    x = _rnd(gen, b, t, d).to(torch.bfloat16)
    g = (1 + _rnd(gen, d, scale=0.1)).to(torch.bfloat16)
    vecs = _adaln_vectors(gen, b, d)
    cot = _rnd(gen, b, t, d).to(torch.bfloat16)
    for fn, plain, args in ((tew.ln_modulate, tew.ln_modulate_plain, (x, g) + vecs[:2]),
                            (tew.gated_residual, tew.gated_residual_plain, (x, vecs[2], cot))):
        grads = []
        for f in (fn, plain):
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            out = f(*leaves)
            assert out.requires_grad
            out.backward(cot)
            grads.append([leaf.grad for leaf in leaves])
        for got, want in zip(*grads):
            assert got is not None and torch.isfinite(got).all() and got.abs().max() > 0
            assert torch.equal(got, want)


def test_tiny_adaln_dit_runs_k11_and_k12(gen):
    """A bf16 adaLN DiT (2 layers 256 wide) with the switch on: K11 and K12
    twice per layer and forward (CFG batch 2), none with it off; against an
    fp32 copy (the plain chains), the output with the kernels errs at most
    1.5x as much as with the plain bf16 chains (CFG 5 amplifies each
    site's rounding, so the two bf16 outputs are compared through it)."""
    import copy

    from friendly_stable_audio_tools_tpu_torch.models.dit import DiffusionTransformer
    from friendly_stable_audio_tools_tpu_torch.ops.norms import LayerNorm
    from friendly_stable_audio_tools_tpu_torch.utils.common import dezero_, init_weights_

    dit = DiffusionTransformer(io_channels=16, embed_dim=256, depth=2, num_heads=4,
                               cond_token_dim=64, global_cond_dim=32, global_cond_type="adaLN")
    dit = dit.to("cuda")
    init_weights_(dit, gen)
    dezero_(dit, gen)
    dit = dit.to(torch.bfloat16).eval()
    x, cond, g = _rnd(gen, 1, 300, 16), _rnd(gen, 1, 10, 64), _rnd(gen, 1, 32)
    t = torch.full((1,), 0.3, device="cuda")
    kw = dict(cross_attn_cond=cond, global_embed=g, cfg_scale=5.0)
    with torch.no_grad():
        ref = copy.deepcopy(dit).float()(x, t, **kw)
    errs = {}
    for fused in (True, False):
        for m in dit.modules():
            if isinstance(m, LayerNorm) or hasattr(m, "to_scale_shift_gate"):
                m.fused_ew = fused
        before = (tew.lnmod_launches, tew.gres_launches)
        with torch.no_grad():
            out = dit(x, t, **kw)
        assert (tew.lnmod_launches - before[0], tew.gres_launches - before[1]) == (
            (4, 4) if fused else (0, 0))
        assert out.shape == (1, 300, 16) and torch.isfinite(out).all()
        errs[fused] = ((out.float() - ref).norm() / ref.norm()).item()
    assert errs[True] <= 1.5 * errs[False], errs


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-3), (torch.float32, 1e-5)])
def test_wide_conv_kernel_at_the_dac_widths_and_ragged_lengths(gen, dtype, tol):
    """K2's wide route (the wgmma kernel) at the DAC's 768, 384, 192 and 96
    channels and K4 at its four upsamples, at lengths that are no multiple of
    the 128-row tile, batch 2, with and without the snake, against the plain
    versions (one rounding apart in bf16; summation order in fp32, where the
    products are 3xTF32): one launch of the route's own count each; a Cout 2
    conv takes the thin route."""
    for c, t, d in ((768, 301, 9), (384, 333, 3), (192, 130, 1), (96, 77, 9)):
        x = _rnd(gen, 2, t, c, scale=0.5).to(dtype)
        w = _rnd(gen, 7, c, c, scale=1 / (7 * c) ** 0.5)
        bias = _rnd(gen, c, scale=0.1)
        a = _rnd(gen, c).abs() + 0.5
        for aa, ib in ((a, 1.0 / a), (None, None)):
            before = (tconv.snake_conv1d_wide_launches, tconv.snake_conv1d_wide_f32_launches)
            got = tconv.snake_conv1d(x, w, bias, aa, ib, dilation=d)
            wide = dtype == torch.float32
            assert (tconv.snake_conv1d_wide_launches, tconv.snake_conv1d_wide_f32_launches) == (
                before[0] + (not wide), before[1] + wide)
            _close(got, tconv.snake_conv1d_plain(x, w, bias, aa, ib, dilation=d), tol)
        if c > 96:
            s = 8 if c == 768 else 4
            wt = _rnd(gen, 2 * s, c, c // 2, scale=1 / (2 * c) ** 0.5)
            got = tconv.snake_conv_transpose1d(x, wt, bias[:c // 2], a, 1.0 / a, stride=s)
            assert got.shape == (2, t * s, c // 2)
            _close(got, tconv.snake_conv_transpose1d_plain(x, wt, bias[:c // 2], a, 1.0 / a,
                                                           stride=s), tol)
    x = _rnd(gen, 2, 300, 96, scale=0.5).to(dtype)
    before = (tconv.snake_conv1d_launches, tconv.snake_conv1d_f32_launches)
    w2 = _rnd(gen, 7, 96, 2, scale=0.05)
    _close(tconv.snake_conv1d(x, w2, None), tconv.snake_conv1d_plain(x, w2, None), tol)
    f32 = dtype == torch.float32
    assert (tconv.snake_conv1d_launches, tconv.snake_conv1d_f32_launches) == (
        before[0] + (not f32), before[1] + f32)



# K2's thin route (csrc/conv1d.cu) at every main-path thin shape: (Cin,
# Cout, k, snake, bias) of the Oobleck conv_in and conv_out, the DAC's and
# the SEANet's, at batch 2 and lengths past one block tile (3000) and ragged
# ones (333, under one thin-out tile; 77)
THIN_MAIN = [(2, 128, 7, False, True), (128, 2, 7, True, False), (96, 2, 7, False, True),
             (1, 64, 7, False, True), (64, 1, 7, False, True)]
# odd thin shapes of both designs: (T, Cin, Cout, k, dilation)
THIN_ODD = [(333, 3, 48, 7, 3), (130, 64, 48, 7, 1), (300, 4, 4, 7, 9), (211, 16, 3, 7, 1),
            (211, 40, 2, 3, 2), (400, 2, 600, 7, 1), (129, 2048, 2, 3, 1), (500, 300, 1, 5, 1),
            (333, 1, 40, 5, 3), (77, 2, 8, 7, 2), (600, 1, 120, 15, 1)]


def _thin_close(got, want, dtype):
    """K2's tolerance: bf16 within one rounding (rel-L2 2e-3, max abs 2^-6
    of max|plain|), fp32 rel-L2 1e-5."""
    if dtype == torch.float32:
        _close(got, want, 1e-5)
    else:
        _close(got, want, 2e-3)
        assert (got.float() - want.float()).abs().max() <= 2.0 ** -6 * want.float().abs().max()


def _thin_case(gen, dtype, b, t, cin, cout, k, d, snake, bias):
    x = _rnd(gen, b, t, cin, scale=0.5).to(dtype)
    w = _rnd(gen, k, cin, cout, scale=1 / (k * cin) ** 0.5)
    bb = _rnd(gen, cout, scale=0.1) if bias else None
    a = _rnd(gen, cin).abs() + 0.5 if snake else None
    ib = 1.0 / (_rnd(gen, cin).abs() + 0.5) if snake else None
    name = "snake_conv1d_f32_launches" if dtype == torch.float32 else "snake_conv1d_launches"
    before = getattr(tconv, name)
    got = tconv.snake_conv1d(x, w, bb, a, ib, dilation=d)
    assert getattr(tconv, name) == before + 1
    assert got.dtype == dtype and got.shape == (b, t, cout)
    _thin_close(got, tconv.snake_conv1d_plain(x, w, bb, a, ib, dilation=d), dtype)


@pytest.mark.parametrize("t", [3000, 333, 77])
@pytest.mark.parametrize("cin,cout,k,snake,bias", THIN_MAIN)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_thin_conv_kernels_at_the_main_path_thin_shapes(gen, dtype, cin, cout, k, snake, bias, t):
    """Each main-path thin shape on its kernel (conv_out thin-out; conv_in
    thin-in in bf16, the CUDA-core kernel in fp32), with and without the
    snake where the path has none, one launch of the thin route's count per
    call."""
    assert tconv.conv_route(cin, cout, k, dtype) == "thin"
    for sn in {snake, False}:
        _thin_case(gen, dtype, 2, t, cin, cout, k, 1, sn, bias)


@pytest.mark.parametrize("t,cin,cout,k,d", THIN_ODD)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_thin_conv_kernels_at_odd_shapes(gen, dtype, t, cin, cout, k, d):
    """The thin route's other shapes, each on the kernel thin_design gives
    it: channel chunks and column passes of the CUDA-core kernel, three and
    four n8 tiles and a ragged last chunk of thin-out, thin-in's Cin 1 pairs
    at a dilation, one n8 tile and all 16 fragment k, with the snake."""
    assert tconv.conv_route(cin, cout, k, dtype) == "thin"
    _thin_case(gen, dtype, 2, t, cin, cout, k, d, True, True)


def _rope_formula(qkv, freqs, num_heads, part, scale):
    """K10a's arithmetic in plain torch on the card: c = fp32(cos s), s' =
    fp32(sin s), partner = -x[d + rot/2] or x[d - rot/2], y = fma(x, c,
    fp32(partner s')) over the rotated dims (nvcc's contraction of x * c +
    partner * s' in the kernel before its redesign, which the kernel now
    writes out; x c is exact in fp64, the sum rounded once), x s beyond,
    rounded to bf16."""
    b, t, three_hd = qkv.shape
    hd = three_hd // 3
    rot = freqs.shape[-1]
    f = freqs[-t:].float()
    c = (torch.cos(f) * scale).double()[:, None]
    s = (torch.sin(f) * scale).double()[:, None]
    x = qkv[..., part * hd:(part + 1) * hd].float().view(b, t, num_heads, 64)
    xr = x[..., :rot].double()
    partner = torch.cat([-xr[..., rot // 2:], xr[..., :rot // 2]], dim=-1)
    y = x * scale
    y[..., :rot] = (xr * c + (partner * s).float().double()).float()
    return y.reshape(b, t, hd).to(torch.bfloat16)


@pytest.mark.parametrize("t", [77, 1025, 6145])
@pytest.mark.parametrize("h", [2, 24])
@pytest.mark.parametrize("part", [1, 0])
def test_rope_pair_matches_its_formula_bit_for_bit(gen, part, h, t):
    """K10a, k (scale 1) and q (K6's prescale log2(e)/8), bit for bit
    against its formula (the parent kernel's arithmetic) and within
    rope_pair_k's tolerance of the plain version; one launch per call."""
    qkv = _rnd(gen, 2, t, 3 * h * 64).to(torch.bfloat16)
    f = rotary_freqs(t, 32, device="cuda")
    _, _, cos, sin = tattn._cuda_inputs("rope_pair", qkv, f, h)
    scale = 1.0 if part else tattn.LOG2E / 8
    before = tattn.rope_k_launches
    got = tattn._rope_launch(qkv, cos, sin, h, part, scale)
    assert tattn.rope_k_launches == before + 1
    assert torch.equal(got, _rope_formula(qkv, f, h, part, scale))
    plain = (tattn.rope_pair_k_plain if part else tattn.rope_pair_q_plain)(qkv, f, h)
    _close(got, plain, tol=1e-3)


def test_tiny_init_audio_generation_runs_the_encoder_kernels(gen, monkeypatch):
    """A tiny SAO-shaped model (DiT 256 wide, 2 layers; its Oobleck VAE 128
    channels wide, the K3 kernels' width) in fp32 on the card: a variation
    and an inpainting of init audio encode it through the fp32 K2 (conv_in
    and conv_out) and K3 (6 residual units) once, on top of a generation
    from noise's decode, and give finite audio. Without a CUDA device the
    entry points raise rather than run on the CPU."""
    import json
    from pathlib import Path

    from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config

    repo = Path(__file__).resolve().parents[1]
    config = json.loads((repo / "friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio/"
                                "stable_audio_open_1_0.json").read_text())
    config["sample_size"] = 24 * 8
    m = config["model"]
    m["io_channels"] = 16
    m["conditioning"]["cond_dim"] = 128
    m["conditioning"]["configs"][0]["config"]["t5_model_name"] = "t5-small"
    m["diffusion"]["config"].update(io_channels=16, embed_dim=256, depth=2, num_heads=4,
                                    cond_token_dim=128, global_cond_dim=256)
    pt = m["pretransform"]["config"]
    pt.update(latent_dim=16, downsampling_ratio=8)
    pt["encoder"]["config"].update(channels=128, c_mults=[1, 2], strides=[2, 4], latent_dim=32)
    pt["decoder"]["config"].update(channels=128, c_mults=[1, 2], strides=[2, 4], latent_dim=16)
    model = create_model_from_config(config, device="cuda")
    init = (44100, _rnd(gen, 2, 200, scale=0.3).cpu())
    cond = [{"prompt": "amen break", "seconds_start": 0, "seconds_total": 47}]

    def counts():
        return (tconv.snake_conv1d_f32_launches + tconv.snake_conv1d_wide_f32_launches,
                tconv.fused_residual_unit_f32_launches, tattn.launches)

    runs = {}
    for mode, kw in (("noise", {}), ("variation", dict(init_audio=init, init_noise_level=3.0)),
                     ("inpaint", dict(init_audio=init, mask_args=dict(
                         cropfrom=0, pastefrom=25, pasteto=75, maskstart=25, maskend=75,
                         softnessL=5, softnessR=5, marination=0)))):
        before = counts()
        audio = generate_diffusion_cond(model, steps=3, cfg_scale=7.0, conditioning=cond,
                                        sample_size=24 * 8, sampler_type="dpmpp-3m-sde",
                                        sigma_min=0.3, sigma_max=50, seed=1, **kw)
        runs[mode] = tuple(b - a for a, b in zip(before, counts()))
        assert audio.shape == (1, 2, 24 * 8) and audio.is_cuda and torch.isfinite(audio).all()
    k2, k3, k1 = runs["noise"]
    assert k2 > 0 and k3 == 6 and k1 == 2 * 3  # the decode; K1 per layer and step
    for mode in ("variation", "inpaint"):
        assert runs[mode] == (k2 + 2, k3 + 6, k1), runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model_from_config(config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_diffusion_cond(model, steps=1, conditioning=cond, sample_size=24 * 8,
                                init_audio=init, device="cuda")


def _d128_counts():
    return (tflash.rope_launches, tflash.d128_launches, tflash.d128_fused_backward_launches,
            tflash.serving_launches, tflash.serving_bf16_launches, tflash.forward_launches,
            tflash.fused_backward_launches, tattn.launches, tattn.rope_k_launches)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,t,h,d", [(2, 1025, 12, 128), (1, 2048, 2, 128), (2, 333, 3, 64),
                                     (1, 77, 2, 128), (2, 16, 3, 64)])
def test_rope_fused_k7_matches_plain(gen, b, t, h, d, dtype, tol):
    """The rope-fused K7 (its rope pass, then the bf16 or fp32 K7 with a
    prescale of 1) against its plain version at SAO's 12 heads of 128 (T
    1025), at T 2048, at 3 heads of 64 and at T below one tile: one launch
    of its own count and no other; the entry point routes such heads there
    without grad, at their true length where kv_len is below T."""
    qkv = _rnd(gen, b, t, 3 * h * d).to(dtype)
    f = rotary_freqs(t, max(d // 2, 32), device="cuda")
    before = _d128_counts()
    got = tflash.flash_rope_attention(qkv, f, h)
    after = _d128_counts()
    assert after == (before[0] + 1,) + before[1:]
    assert got.dtype == dtype and got.shape == (b, t, h * d)
    _close(got, tflash.flash_rope_attention_plain(qkv, f, h), tol)
    routed = tattn.fused_qkv_rope_attention(qkv, f, h)
    assert _d128_counts()[0] == after[0] + 1 and torch.equal(routed, got)
    if t > 16:
        kv = t - 5
        padded = tattn.fused_qkv_rope_attention(qkv, f, h, kv_len=kv)
        assert not padded[:, kv:].any()
        _close(padded[:, :kv], tflash.flash_rope_attention_plain(qkv[:, :kv], f[:kv], h), tol)


def test_rope_pass_matches_its_plain_version_bit_for_bit(gen):
    """The rope pass alone: q^ and k^ bit for bit against the plain version's
    (fp32 products and sum rounded once each, then to bf16), v copied."""
    for dtype in (torch.float32, torch.bfloat16):
        b, t, h, d = 2, 1025, 12, 128
        qkv = _rnd(gen, b, t, 3 * h * d).to(dtype)
        f = rotary_freqs(t, 64, device="cuda")
        tables = tflash.rope_tables(f, t, tflash.LOG2E / d ** 0.5)
        q, k, v = (torch.empty(b * h, t, d, device="cuda", dtype=dtype) for _ in range(3))
        from friendly_stable_audio_tools_tpu_torch.ops.kernels import build

        err = build.library().fsat_rope_heads(
            qkv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(c.data_ptr() for c in tables), b, t, h, d, 64, tflash.LOG2E / d ** 0.5,
            int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        assert err == 0
        for got, want in zip((q, k, v), tflash.rope_heads_plain(qkv, f, h)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("bh,t,kv", [(96, 1025, None), (3, 333, 257), (2, 77, None),
                                     (2, 150, 129), (1, 64, 33)])
def test_fp32_k7_and_k8_at_head_dim_128_match_plain(gen, bh, t, kv):
    """The fp32 K7 with and without its LSE and K8 at head dim 128 against
    their plain versions (rel-L2 1e-5; the LSE max abs 1e-4), at SAO's
    training shape with 12 heads (B 8), ragged T and kv_len one key into a
    32-key block; the padded rows' dk and dv exactly zero; K8 twice gives
    bit-equal dk and dv; one launch of their own counts each."""
    q, k, v, do = (_rnd(gen, bh, t, 128) for _ in range(4))
    if kv is not None:
        do[:, kv:] = 0
    before = _d128_counts()
    out, lse = tflash.flash_forward(q, k, v, kv)
    serving, none = tflash.flash_forward(q, k, v, kv, save_stats=False)
    assert none is None and _d128_counts() == (before[0], before[1] + 2) + before[2:]
    out_p, lse_p = tflash.flash_forward_plain(q, k, v, kv)
    _close(out, out_p, 1e-5)
    _close(serving, out_p, 1e-5)
    assert (lse - lse_p).abs().max().item() <= 1e-4
    before = _d128_counts()
    grads = tflash.flash_attention_backward(q, k, v, out_p, lse_p, do, kv)
    assert _d128_counts() == before[:2] + (before[2] + 1,) + before[3:]
    for got, want in zip(grads, tflash.flash_backward_fused_plain(q, k, v, out_p, lse_p, do, kv)):
        _close(got, want, 1e-5)
    if kv is not None:
        assert not grads[1][:, kv:].any() and not grads[2][:, kv:].any()
    again = tflash.flash_backward_fused(q, k, v, out_p, lse_p, do, kv)
    assert torch.equal(again[1], grads[1]) and torch.equal(again[2], grads[2])


def test_bf16_k7_at_head_dim_128_matches_plain(gen):
    """The bf16 K7 (serving) at head dim 128, which the rope-fused K7 runs
    for bf16 inputs: ragged T and kv_len, rel-L2 1e-2."""
    for bh, t, kv in ((24, 1025, None), (3, 300, 257), (2, 16, None)):
        q, k, v = (_rnd(gen, bh, t, 128).to(torch.bfloat16) for _ in range(3))
        before = tflash.serving_bf16_launches
        out, lse = tflash.flash_forward(q, k, v, kv, save_stats=False)
        assert lse is None and tflash.serving_bf16_launches == before + 1
        _close(out, tflash.flash_forward_plain(q, k, v, kv, save_stats=False)[0])


def test_heads_128_train_through_k7_and_k8_and_raise_where_no_kernel_is(gen):
    """Under grad, 12 heads of 128 at T 1025 take the unpack route: K7 with
    its LSE and K8 at head dim 128 once each, qkv.grad within rel-L2 1e-4
    of autograd through the fp32 plain attention. What no kernel takes
    raises on the card: the rope-fused K7 at head dim 96, the causal fp32 K7
    at 128, K9 at 128."""
    t, h = 1025, 12
    f = rotary_freqs(t, 64, device="cuda")
    x = _rnd(gen, 1, t, 3 * h * 128, scale=0.5)
    g = _rnd(gen, 1, t, h * 128)
    before = _d128_counts()
    qkv = x.clone().requires_grad_(True)
    tattn.fused_qkv_rope_attention(qkv, f, h).backward(g)
    assert _d128_counts() == (before[0], before[1] + 1, before[2] + 1) + before[3:]
    ref = x.clone().requires_grad_(True)
    tattn.fused_qkv_rope_attention_plain(ref, f, h).backward(g)
    _close(qkv.grad, ref.grad, tol=1e-4)
    with pytest.raises(NotImplementedError, match="queue B"):
        tflash.flash_rope_attention(_rnd(gen, 1, 64, 3 * 2 * 96), rotary_freqs(64, 48,
                                                                               device="cuda"), 2)
    q = _rnd(gen, 2, 64, 128)
    with pytest.raises(NotImplementedError, match="queue B"):
        tflash.flash_forward(q, q, q, causal=True)
    with pytest.raises(NotImplementedError, match="queue B"):
        tflash.flash_backward(q, q, q, q, q[..., 0], q)
