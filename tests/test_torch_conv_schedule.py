"""The schedule of the wgmma convolution kernel (csrc/conv_wgmma.cu: K2's
wide route and K4), written out in plain torch at small sizes and held
against the plain versions, and through the same inputs against the JAX
package's Pallas kernels in interpret mode (FSAT_PALLAS_INTERPRET=1).

The kernel computes 128-row output tiles, N columns at a time (N from
conv1d.conv_tile_n), as a sum over taps: for each chunk of input channels
(64 in bf16, 32 in fp32), each tap loads its own rows of x, rows outside
[0, T) reading as zero, snakes them (rounded to bf16 in bf16) and
multiplies them by the tap's weight slice; K4's output phase r of row q
reads x[q] and x[q -+ 1] with its two taps (conv1d.py:217-220 of the JAX
package), and its rows land at q s + r. In fp32 nothing is rounded, so
the schedule equals the plain formula up to summation order (rel-L2
1e-5); in bf16 both round the snake and the output once (the JAX kernels'
interpret mode within 1e-2, as tests/test_torch_port_kernels.py holds the
plain versions).

The fp32 kernel's products are 3xTF32 (each operand split into a tf32
part rounded to nearest and a tf32 remainder; a_lo b_hi + a_hi b_lo + a_hi
b_hi) on tensor cores whose fp32 accumulate truncates: the emulation below
adds each 8-deep product into the partial sum rounding toward zero and adds
the partial into a round-to-nearest fp32 total every conv1d.F32_FLUSH
stages of 32 channels. On the H100 this model overstates the kernel's error
by ~1.3x (PERF.md, PR 14). At the DAC encode's 7 x 1024 reduction it stays
within rel-L2 1e-6 of fp64; 1xTF32, and 3xTF32 without the flush, do not.

Inputs come from numpy with fixed seeds.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.ops.pallas import conv1d as jconv
from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d as tconv

M_TILE = 128  # output rows per block (csrc/conv_wgmma.cu kM)
KC = {torch.bfloat16: 64, torch.float32: 32}  # input channels per 128-byte row
STAGE = 32  # fp32 channels per pipeline stage: one flush unit


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _load(x, b, r0, c0, kc, alpha, inv_beta, dtype):
    """One tap's A tile: rows r0 .. r0 + M_TILE of batch b, channels c0 ..
    c0 + kc; rows outside [0, T) and channels past Cin are zeros; snaked in
    fp32 and rounded to `dtype` (fp32: not rounded)."""
    t, cin = x.shape[1], x.shape[2]
    tile = torch.zeros(M_TILE, kc)
    lo, hi = max(r0, 0), min(r0 + M_TILE, t)
    c1 = min(c0 + kc, cin)
    if lo < hi:
        rows = x[b, lo:hi, c0:c1].float()
        if alpha is not None:
            rows = tconv.snake(rows, alpha[c0:c1].float(), inv_beta[c0:c1].float())
        tile[lo - r0:hi - r0, :c1 - c0] = rows.to(dtype).float()
    return tile


def _weights(w, c0, kc, n0, n, dtype):
    """The tap's weight slice [kc, n], channels past Cin zero."""
    out = torch.zeros(kc, n)
    part = w[c0:c0 + kc, n0:n0 + n].to(dtype).float()
    out[:part.shape[0]] = part
    return out


def k2_schedule(x, w, bias, alpha=None, inv_beta=None, dilation=1):
    """K2's wide route as the kernel schedules it: per (128-row tile, Cout
    chunk, batch), channel chunks outside and taps inside, one load per tap."""
    dt = x.dtype
    b, t, cin = x.shape
    k, _, cout = w.shape
    n, kc = tconv.conv_tile_n(cout, dt), KC[dt]
    pad = dilation * (k - 1) // 2
    y = torch.empty(b, t, cout)
    for bb in range(b):
        for r0 in range(0, t, M_TILE):
            for n0 in range(0, cout, n):
                acc = torch.zeros(M_TILE, n)
                for c0 in range(0, cin, kc):
                    for j in range(k):
                        a = _load(x, bb, r0 + j * dilation - pad, c0, kc, alpha, inv_beta, dt)
                        acc += a @ _weights(w[j], c0, kc, n0, n, dt)
                rows = min(M_TILE, t - r0)
                y[bb, r0:r0 + rows, n0:n0 + n] = acc[:rows] + (0 if bias is None else bias[n0:n0 + n])
    return y.to(dt)


def k4_schedule(x, w, bias, alpha=None, inv_beta=None, stride=2):
    """K4 as the kernel schedules it: per (128-row q tile, phase, Cout chunk,
    batch), the phase's two taps, each its own load of x[q] or x[q -+ 1];
    the rows land at q s + r of the interleaved output."""
    dt = x.dtype
    b, t, cin = x.shape
    _, _, cout = w.shape
    n, kc = tconv.conv_tile_n(cout, dt), KC[dt]
    half = stride // 2
    y = torch.empty(b, t * stride, cout)
    for bb in range(b):
        for q0 in range(0, t, M_TILE):
            rows = min(M_TILE, t - q0)
            for r in range(stride):
                left = r < half
                taps = [(r + half, 0), (r + half + stride if left else r + half - stride,
                                        -1 if left else 1)]
                for n0 in range(0, cout, n):
                    acc = torch.zeros(M_TILE, n)
                    for c0 in range(0, cin, kc):
                        for wi, off in taps:
                            a = _load(x, bb, q0 + off, c0, kc, alpha, inv_beta, dt)
                            acc += a @ _weights(w[wi], c0, kc, n0, n, dt)
                    out = acc[:rows] + (0 if bias is None else bias[n0:n0 + n])
                    y[bb, (q0 + torch.arange(rows)) * stride + r, n0:n0 + n] = out
    return y.to(dt)


def _inputs(seed, b, t, cin, cout, k, snake):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, cin).astype(np.float32) * 0.5
    w = rng.randn(k, cin, cout).astype(np.float32) / math.sqrt(k * cin)
    bias = rng.randn(cout).astype(np.float32) * 0.1
    if not snake:
        return x, w, bias, None, None
    return (x, w, bias, (np.abs(rng.randn(cin)) + 0.5).astype(np.float32),
            (np.abs(rng.randn(cin)) + 0.5).astype(np.float32))


def _torch(*arrays):
    return [None if a is None else _t(a) for a in arrays]


# (B, T, Cin, Cout, dilation): ragged T (no multiple of the 128-row tile),
# batch 2, the DAC's last width 96, Cin past one channel chunk
K2_CASES = [(2, 300, 96, 96, 9), (2, 333, 96, 96, 3), (1, 130, 160, 96, 1)]
# (B, T, Cin, Cout, stride)
K4_CASES = [(2, 77, 192, 96, 8), (2, 150, 96, 96, 4), (1, 130, 64, 96, 2)]


@pytest.mark.parametrize("snake", [True, False])
@pytest.mark.parametrize("b,t,cin,cout,d", K2_CASES)
def test_k2_schedule_matches_plain_in_fp32(b, t, cin, cout, d, snake):
    x, w, bias, a, ib = _torch(*_inputs(t + d, b, t, cin, cout, 7, snake))
    got = k2_schedule(x, w, bias, a, ib, dilation=d)
    assert _rel(got, tconv.snake_conv1d_plain(x, w, bias, a, ib, dilation=d)) < 1e-5


@pytest.mark.parametrize("snake", [True, False])
@pytest.mark.parametrize("b,t,cin,cout,s", K4_CASES)
def test_k4_schedule_matches_plain_in_fp32(b, t, cin, cout, s, snake):
    x, _, bias, a, ib = _torch(*_inputs(t + s, b, t, cin, cout, 1, snake))
    w = _t(np.random.RandomState(s).randn(2 * s, cin, cout) / math.sqrt(2 * cin))
    got = k4_schedule(x, w, bias, a, ib, stride=s)
    assert got.shape == (b, t * s, cout)
    assert _rel(got, tconv.snake_conv_transpose1d_plain(x, w, bias, a, ib, stride=s)) < 1e-5


@pytest.mark.parametrize("b,t,cin,cout,d", K2_CASES[:2])
def test_k2_schedule_in_bf16_matches_jax_forward_in_interpret_mode(monkeypatch, b, t, cin, cout, d):
    """bf16 in and out: the schedule against the Pallas `_forward` (:91) in
    interpret mode on the same bf16 values, with the snake."""
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    x, w, bias, a, ib = _inputs(t * d, b, t, cin, cout, 7, True)
    xb = _t(x, torch.bfloat16)
    want = np.asarray(jconv._forward(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(w),
                                     jnp.asarray(bias), jnp.asarray(a), jnp.asarray(ib), d,
                                     d * 3, 128).astype(jnp.float32))
    got = k2_schedule(xb, *_torch(w, bias, a, ib), dilation=d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)
    plain = tconv.snake_conv1d_plain(xb, *_torch(w, bias, a, ib), dilation=d)
    assert _rel(got, plain) < 5e-3  # one bf16 rounding of the output apart


@pytest.mark.parametrize("b,t,cin,cout,s", K4_CASES[:2])
def test_k4_schedule_in_bf16_matches_jax_upk_forward_in_interpret_mode(monkeypatch, b, t, cin, cout,
                                                                       s):
    """bf16 in and out: the schedule against the Pallas `_upk_forward`
    (:262, through `_upk`) in interpret mode, with the snake, at Cout 96."""
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    x, _, bias, a, ib = _inputs(t * s, b, t, cin, cout, 1, True)
    w = (np.random.RandomState(s + 1).randn(2 * s, cin, cout) / math.sqrt(2 * cin)).astype(np.float32)
    xb = _t(x, torch.bfloat16)
    want = np.asarray(jconv._upk(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(w),
                                 jnp.asarray(bias), jnp.asarray(a), jnp.asarray(ib), s,
                                 128).astype(jnp.float32))
    got = k4_schedule(xb, *_torch(w, bias, a, ib), stride=s)
    np.testing.assert_allclose(got.float().numpy(), want[:, :t * s], atol=1e-2)
    plain = tconv.snake_conv_transpose1d_plain(xb, *_torch(w, bias, a, ib), stride=s)
    assert _rel(got, plain) < 5e-3


# ---------------------------------------------------------------------------
# 3xTF32 with a truncating tensor-core accumulate
# ---------------------------------------------------------------------------


def tf32(v):
    """fp32 -> the nearest tf32 (10 mantissa bits), in fp32."""
    bits = v.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _round_toward_zero(v):
    """fp64 -> fp32, rounding toward zero (the tensor cores' accumulate)."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def tensor_core_product(a, b, flush, passes=3):
    """a [M, K] @ b [K, N] as the fp32 kernel computes it: 3xTF32 (passes=3:
    a_lo b_hi, a_hi b_lo, a_hi b_hi) or 1xTF32 (passes=1), each 8-deep
    product added into the partial sum rounding toward zero, the partial
    added into the fp32 total every `flush` stages of STAGE channels (and
    at the end)."""
    a_hi, b_hi = tf32(a), tf32(b)
    terms = [(a_hi, b_hi)] if passes == 1 else [(tf32(a - a_hi), b_hi), (a_hi, tf32(b - b_hi)),
                                                (a_hi, b_hi)]
    k = a.shape[1]
    total = torch.zeros(a.shape[0], b.shape[1])
    part = torch.zeros_like(total)
    for s0 in range(0, k, STAGE):
        for k0 in range(s0, s0 + STAGE, 8):
            for x, y in terms:
                part = _round_toward_zero(part.double() + x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double())
        if (s0 // STAGE + 1) % flush == 0 or s0 + STAGE >= k:
            total, part = total + part, torch.zeros_like(part)
    return total


def _long_reduction(cin=1024, k=7, rows=64, cout=32):
    """The DAC encode's 1024 -> 1024 k7 conv, cut to 64 rows and 32 outputs,
    as the kernel's [rows, k * cin] x [k * cin, cout] product: channel
    chunks outside, taps inside (the kernel's stage order)."""
    x, w, _, _, _ = _inputs(7, 1, rows + k - 1, cin, cout, k, False)
    win = np.stack([x[0, j:j + rows] for j in range(k)], 1)  # [rows, k, cin]
    a = win.reshape(rows, k, cin // STAGE, STAGE).transpose(0, 2, 1, 3).reshape(rows, -1)
    b = w.reshape(k, cin // STAGE, STAGE, cout).transpose(1, 0, 2, 3).reshape(-1, cout)
    return torch.tensor(a), torch.tensor(b)


@pytest.mark.parametrize("passes,flush,within", [
    (3, tconv.F32_FLUSH, True),   # the shipped 3xTF32 schedule
    (3, 1, True),
    (1, tconv.F32_FLUSH, False),  # 1xTF32 keeps ~3 digits
    (3, 7 * 1024 // STAGE, False),  # 3xTF32 accumulated over the whole reduction
])
def test_3xtf32_at_the_longest_reduction(passes, flush, within):
    a, b = _long_reduction()
    ref = a.double() @ b.double()
    err = _rel(tensor_core_product(a, b, flush, passes), ref)
    assert (err <= 1e-6) == within, err


def test_tf32_split_is_exact_and_rounds_to_nearest():
    v = torch.tensor(np.random.RandomState(3).randn(4096).astype(np.float32))
    hi = tf32(v)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((v - hi).abs() <= hi.abs() * 2.0 ** -11 + 1e-30)
    lo = tf32(v - hi)
    assert ((hi.double() + lo.double() - v.double()).abs() <= v.double().abs() * 2.0 ** -21).all()


# ---------------------------------------------------------------------------
# K2's route and the tile width
# ---------------------------------------------------------------------------

DAC_WIDTHS = [(64, 1536), (1536, 1536), (768, 768), (384, 384), (192, 192), (96, 96), (128, 128),
              (256, 256), (512, 512), (1024, 1024), (2048, 2048)]
OOBLECK_AND_SEANET = [(64, 2048), (2048, 128), (64, 32), (32, 64), (128, 64), (1024, 128),
                      (128, 1024), (512, 256)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_route_sends_thin_shapes_to_the_cuda_core_kernel(dtype):
    for cin, cout in [(1, 32), (1, 64), (2, 128), (2, 64), (96, 2), (128, 2), (64, 1), (32, 1)]:
        for k in (1, 3, 7):
            assert tconv.conv_route(cin, cout, k, dtype) == "thin", (cin, cout, k)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_route_sends_the_dac_oobleck_and_seanet_widths_to_the_wide_kernel(dtype):
    for cin, cout in DAC_WIDTHS + OOBLECK_AND_SEANET:
        for k in (1, 3, 7):
            assert tconv.conv_route(cin, cout, k, dtype) == "wide", (cin, cout, k)


def test_conv_route_depends_on_the_shape_only():
    """The route is a function of (Cin, Cout, k, dtype) alone: no length,
    batch, dilation or data enters it, and the same shape always takes the
    same kernel."""
    assert list(inspect.signature(tconv.conv_route).parameters) == ["cin", "cout", "k", "dtype"]
    for dtype in (torch.bfloat16, torch.float32):
        for cin, cout in DAC_WIDTHS + OOBLECK_AND_SEANET + [(2, 128), (96, 2)]:
            routes = {tconv.conv_route(cin, cout, k, dtype) for k in (1, 3, 7) for _ in range(2)}
            assert len(routes) == 1


@pytest.mark.parametrize("cout,bf16,f32", [(96, 96, 96), (192, 192, 96), (384, 192, 128),
                                           (768, 256, 128), (1536, 256, 128), (2048, 256, 128),
                                           (32, 32, 32), (2, None, None)])
def test_tile_width_divides_cout_without_padding(cout, bf16, f32):
    assert tconv.conv_tile_n(cout, torch.bfloat16) == bf16
    assert tconv.conv_tile_n(cout, torch.float32) == f32
