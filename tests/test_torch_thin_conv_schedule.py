"""The schedules of K2's thin route (csrc/conv1d.cu) and of K10a
(csrc/attention_rope.cu), written out in plain torch at small sizes and held
against the plain versions, and through the same inputs against the JAX
package's Pallas kernels in interpret mode (FSAT_PALLAS_INTERPRET=1).

K2's thin route has three kernels (conv1d.thin_design). The CUDA-core one
(the fp32 conv_in, and every thin shape the others do not take): a block
stages TT rows of x and their (k - 1) * dilation halo, snaked (rounded to
bf16 in bf16), chunks of input channels at a time, and each thread sums,
for V = 16 bytes of output channels and RPT rows, chunk by chunk, channel
by channel and tap by tap, in fp32; Cout wider than 32 vectors takes
column passes. Thin-in (the bf16 conv_in): per 512-row block tile the x
rows staged once as bf16 pairs, (x[r, 0], x[r, 1]) for Cin 2 or (x[r],
x[r + dilation]) for Cin 1, which are the mma fragments' words: k index j
Cin + c, pair p at row offset p dilation (Cin 2) or 2p dilation (Cin 1),
zero past k * Cin; each row one 16-deep product, the sum starting at the
bias. Thin-out (the decoders' conv_out): Z = snake(x) W over the
k * Cout (tap, output) columns, N padded to 8-column tiles, summed chunk by
chunk of KC input channels (the mma fragments give each lane V channels of
a row, and the same channels of B^T), in bf16 products or 3xTF32 in fp32;
each output is then bias + sum over taps j of Z[t - pad + j dilation, j
Cout + o] over a block tile of ZR Z rows (TT = ZR - halo outputs). In fp32
both equal the plain formula up to summation order (rel-L2 1e-5); in bf16
both round the snake and the output once, as the plain version and the
JAX kernel do.

K10a: a block takes a range of rows (b, t) with all heads; the rows' cos
and sin are pre-scaled once (c = cos * s, s = sin * s); a thread holds 8
dims (a segment) of one head's row, and the rotate-half partner of dim d
(d + rot/2 or d - rot/2) comes from the segment rot/16 segments away (and
the next one where rot/2 is no multiple of 8), as the warp shuffles fetch
it; y = x c + partner s over the rotated dims, x * scale beyond.

Inputs come from numpy with fixed seeds.
"""

import math

import jax
import jax.numpy as jnp
import jax.scipy.linalg
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu.ops.pallas import conv1d as jconv
from friendly_stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d as tconv

THREADS = 256
CORE_SMEM = 96 * 1024  # csrc/conv1d.cu kCoreSmem
OUT_MIN_ROWS = 384  # csrc/conv1d.cu kOutMinRows
OUT_KC = {torch.bfloat16: 32, torch.float32: 16}  # input channels per thin-out chunk


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _staged(x, b, r0, rows, c0, nc, alpha, inv_beta, dtype):
    """x rows r0 .. r0 + rows of batch b, channels c0 .. c0 + nc, in fp32:
    zeros outside [0, T) and past Cin, snaked in fp32 and rounded to
    `dtype` (fp32: not rounded)."""
    t, cin = x.shape[1], x.shape[2]
    out = torch.zeros(rows, nc)
    lo, hi = max(r0, 0), min(r0 + rows, t)
    c1 = min(c0 + nc, cin)
    if lo < hi and c0 < c1:
        v = x[b, lo:hi, c0:c1].float()
        if alpha is not None:
            v = tconv.snake(v, alpha[c0:c1].float(), inv_beta[c0:c1].float())
        out[lo - r0:hi - r0, :c1 - c0] = v.to(dtype).float()
    return out


def core_plan(cin, cout, k, dilation, dtype):
    """csrc/conv1d.cu:core_plan: (column threads CG, rows per tile TT, staged
    rows RS, channels per chunk, column passes, V)."""
    v = 16 // (2 if dtype == torch.bfloat16 else 4)
    rpt = 8 if dtype == torch.bfloat16 else 16
    groups = -(-cout // v)
    cg = 1
    while cg < groups and cg < 32:
        cg *= 2
    tt = THREADS // cg * rpt
    rs = (tt + (k - 1) * dilation + 3) // 4 * 4
    ck = min(cin, CORE_SMEM // ((k * cg * v + rs) * 4))
    return cg, tt, rs, ck, -(-groups // cg), v


def cuda_cores_schedule(x, w, bias, alpha=None, inv_beta=None, dilation=1):
    """Design 0 as the kernel schedules it: per (row tile, column pass),
    channel chunks staged once, then channel by channel and tap by tap."""
    dt = x.dtype
    b, t, cin = x.shape
    k, _, cout = w.shape
    cg, tt, rs, ck, passes, v = core_plan(cin, cout, k, dilation, dt)
    pad = (k - 1) * dilation // 2
    cgv = cg * v
    wd = torch.zeros(k, cin, passes * cgv)
    wd[..., :cout] = w.to(dt).float()
    y = torch.zeros(b, t, cout)
    for bb in range(b):
        for t0 in range(0, t, tt):
            for p in range(passes):
                acc = torch.zeros(tt, cgv)
                for ci0 in range(0, cin, ck):
                    nc = min(ck, cin - ci0)
                    xs = _staged(x, bb, t0 - pad, rs, ci0, nc, alpha, inv_beta, dt)
                    for c in range(nc):
                        for j in range(k):
                            acc += (xs[j * dilation:j * dilation + tt, c, None]
                                    * wd[j, ci0 + c, None, p * cgv:(p + 1) * cgv])
                n = min(tt, t - t0)
                c1 = min(cgv, cout - p * cgv)
                y[bb, t0:t0 + n, p * cgv:p * cgv + c1] = (acc[:n, :c1]
                                                           + bias[p * cgv:p * cgv + c1])
    return y.to(dt)


def fragment_channels(dtype):
    """For each mma step of one thin-out chunk, the input channel behind
    each logical k index, from the fragment layouts: bf16 m16n8k16, lane q
    holds channels 8q .. 8q + 7 as four words, step m's a0/b0 (k 2q, 2q + 1)
    its word 2m and a2/b1 (k 2q + 8, 2q + 9) word 2m + 1; tf32 m16n8k8, lane
    q holds channels 4q .. 4q + 3, step s's a0/b0 (k q) channel 4q + 2s and
    a2/b1 (k q + 4) 4q + 2s + 1. A and B read the same map."""
    steps = []
    if dtype == torch.bfloat16:
        for m in range(2):
            ch = [0] * 16
            for q in range(4):
                for e in range(2):
                    ch[2 * q + e] = 8 * q + 4 * m + e
                    ch[2 * q + 8 + e] = 8 * q + 4 * m + 2 + e
            steps.append(ch)
    else:
        for s in range(2):
            ch = [0] * 8
            for q in range(4):
                ch[q] = 4 * q + 2 * s
                ch[q + 4] = 4 * q + 2 * s + 1
            steps.append(ch)
    return steps


def tf32(v):
    """fp32 -> the nearest tf32 (10 mantissa bits, ties away from zero as
    cvt.rna), in fp32."""
    bits = v.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def thin_out_schedule(x, w, bias, alpha=None, inv_beta=None, dilation=1):
    """Design 1 as the kernel schedules it: per block tile of ZR Z rows
    (the halo plus at least OUT_MIN_ROWS, rounded to 128: TT = ZR - halo
    outputs), Z over chunks of KC channels in the fragments' channel order
    (3xTF32 in fp32: a_lo b_hi + a_hi b_lo + a_hi b_hi), then the tap sum."""
    dt = x.dtype
    b, t, cin = x.shape
    k, _, cout = w.shape
    kc = OUT_KC[dt]
    n = k * cout
    ncol = -(-n // 8) * 8
    halo = (k - 1) * dilation
    pad = halo // 2
    zr = (halo + OUT_MIN_ROWS + 127) // 128 * 128
    tt = zr - halo
    chunks = -(-cin // kc)
    bt = torch.zeros(chunks * kc, ncol)  # B: channel c, column j * Cout + o
    bt[:cin, :n] = w.to(dt).float().permute(1, 0, 2).reshape(cin, n)
    steps = fragment_channels(dt)
    y = torch.zeros(b, t, cout)
    for bb in range(b):
        for t0 in range(0, t, tt):
            z = torch.zeros(zr, ncol)
            for ch in range(chunks):
                xs = _staged(x, bb, t0 - pad, zr, ch * kc, kc, alpha, inv_beta, dt)
                bc = bt[ch * kc:(ch + 1) * kc]
                for perm in steps:
                    a, bw = xs[:, perm], bc[perm]
                    if dt == torch.float32:
                        a_hi, b_hi = tf32(a), tf32(bw)
                        a_lo, b_lo = tf32(a - a_hi), tf32(bw - b_hi)
                        z += a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
                    else:
                        z += a @ bw
            rows = min(tt, t - t0)
            out = bias.clone().expand(rows, cout).clone()
            for j in range(k):
                out += z[j * dilation:j * dilation + rows, j * cout:(j + 1) * cout]
            y[bb, t0:t0 + rows] = out
    return y.to(dt)


IN_ROWS = 512  # csrc/conv1d.cu kInRows


def in_pairs(xs, cin, dilation):
    """The thin-in kernel's staged pairs of x rows xs [rows, Cin]: (x[r, 0],
    x[r, 1]) for Cin 2, (x[r], x[r + dilation]) for Cin 1 -> [rows, 2]."""
    if cin == 2:
        return xs
    shifted = torch.zeros_like(xs[:, 0])
    shifted[:-dilation] = xs[dilation:, 0]
    return torch.stack([xs[:, 0], shifted], 1)


def fragment_a(pairs, rows, k, cin, dilation):
    """A [rows, 16] as the lanes read it: pair p of row r (k 2p, 2p + 1) is
    pairs[r + p dilation] (Cin 2) or pairs[r + 2p dilation] (Cin 1), zero
    where the pair lies past the k * Cin real taps."""
    step = dilation if cin == 2 else 2 * dilation
    a = torch.zeros(rows, 16)
    for p in range(8):
        if 2 * p < k * cin:
            a[:, 2 * p:2 * p + 2] = pairs[p * step:p * step + rows]
    return a


def thin_in_tc_schedule(x, w, bias, alpha=None, inv_beta=None, dilation=1):
    """Design 2 (bf16) as the kernel schedules it: per block tile, the
    pairs staged once (snaked, rounded to bf16), each row's 16-deep product
    with W [16, Cout] (rows k * Cin.. zero), the sum starting at the bias."""
    dt = x.dtype
    b, t, cin = x.shape
    k, _, cout = w.shape
    halo = (k - 1) * dilation
    pad = halo // 2
    wk = torch.zeros(16, cout)
    wk[:k * cin] = w.to(dt).float().reshape(k * cin, cout)
    y = torch.zeros(b, t, cout)
    for bb in range(b):
        for t0 in range(0, t, IN_ROWS):
            xs = _staged(x, bb, t0 - pad, IN_ROWS + halo + dilation, 0, cin, alpha, inv_beta, dt)
            a = fragment_a(in_pairs(xs, cin, dilation), IN_ROWS, k, cin, dilation)
            n = min(IN_ROWS, t - t0)
            y[bb, t0:t0 + n] = (bias + a @ wk)[:n]
    return y.to(dt)


SCHEDULES = {"cuda_cores": cuda_cores_schedule, "out": thin_out_schedule,
             "in": thin_in_tc_schedule}


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


# (T, Cin, Cout, k): the thin-in shapes (Cin 1 and 2 to 32, 64, 128) and the
# thin-out ones (Cin 64, 96, 128 to 1 and 2), at T 333 (no multiple of a
# tile) and 77 (under one), k 7 and 3
THIN_IN = [(t, cin, cout, k) for t in (333, 77) for cin, cout in ((1, 32), (2, 64), (2, 128))
           for k in (7, 3)]
THIN_OUT = [(t, cin, cout, k) for t in (333, 77) for cin, cout in ((64, 1), (96, 2), (128, 2))
            for k in (7, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,cin,cout,k", THIN_IN + THIN_OUT)
def test_thin_design_takes_the_main_path_shapes(t, cin, cout, k, dtype):
    """The decoders' conv_out take the thin-out kernel in both dtypes, the
    encoders' conv_in the thin-in one in bf16 and the CUDA-core one in
    fp32; all are K2's thin route."""
    assert tconv.conv_route(cin, cout, k, dtype) == "thin"
    want = "out" if cin > 2 else "in" if dtype == torch.bfloat16 else "cuda_cores"
    assert tconv.thin_design(cin, cout, k, 1, dtype) == want


@pytest.mark.parametrize("snake", [True, False])
@pytest.mark.parametrize("t,cin,cout,k", THIN_IN + THIN_OUT)
def test_thin_schedule_matches_plain_in_fp32(t, cin, cout, k, snake):
    x, w, bias, a, ib = _torch(*_inputs(t + cin + k, 2, t, cin, cout, k, snake))
    got = SCHEDULES[tconv.thin_design(cin, cout, k, 1, torch.float32)](x, w, bias, a, ib)
    assert got.shape == (2, t, cout)
    assert _rel(got, tconv.snake_conv1d_plain(x, w, bias, a, ib)) < 1e-5


@pytest.mark.parametrize("snake", [True, False])
@pytest.mark.parametrize("t,cin,cout,k", THIN_IN + THIN_OUT)
def test_thin_schedule_in_bf16_within_one_rounding_of_plain(t, cin, cout, k, snake):
    """bf16 in and out: the schedule and the plain version round the snake
    and the output once each; they differ by at most one bf16 rounding of
    the output."""
    x, w, bias, a, ib = _torch(*_inputs(2 * t + cout, 2, t, cin, cout, k, snake))
    xb = x.to(torch.bfloat16)
    got = SCHEDULES[tconv.thin_design(cin, cout, k, 1, torch.bfloat16)](xb, w, bias, a, ib)
    want = tconv.snake_conv1d_plain(xb, w, bias, a, ib).float()
    assert got.dtype == torch.bfloat16
    assert ((got.float() - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6).all()


@pytest.mark.parametrize("t,cin,cout,k", [(333, 2, 128, 7), (77, 1, 64, 3), (333, 128, 2, 7),
                                          (77, 96, 2, 3), (333, 64, 1, 7)])
def test_thin_schedule_in_bf16_matches_jax_forward_in_interpret_mode(monkeypatch, t, cin, cout, k):
    """bf16 in and out: each design's schedule against the Pallas
    `_forward` (:91) in interpret mode on the same bf16 values, with the
    snake."""
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    x, w, bias, a, ib = _inputs(t * k + cin, 2, t, cin, cout, k, True)
    xb = _t(x, torch.bfloat16)
    want = np.asarray(jconv._forward(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(w),
                                     jnp.asarray(bias), jnp.asarray(a), jnp.asarray(ib), 1,
                                     (k - 1) // 2, 128).astype(jnp.float32))
    design = tconv.thin_design(cin, cout, k, 1, torch.bfloat16)
    got = SCHEDULES[design](xb, *_torch(w, bias, a, ib))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)
    assert _rel(got, torch.tensor(want)) < 5e-3  # one bf16 rounding of the output apart


# odd thin shapes: (T, Cin, Cout, k, dilation, design in bf16, in fp32)
CC = "cuda_cores"
ODD = [(130, 64, 48, 7, 1, CC, CC),         # Cout no tile divides, wide Cin: chunks
       (333, 3, 48, 7, 3, CC, CC),          # Cin 3: rows no whole 16-byte words
       (300, 4, 4, 7, 9, CC, "out"),        # k * Cout 28: four n8 tiles in fp32
       (211, 16, 3, 7, 1, "out", "out"),    # k * Cout 21: three n8 tiles
       (211, 40, 2, 3, 2, "out", "out"),    # Cin 40: a ragged last chunk
       (400, 2, 600, 7, 1, CC, CC),         # Cout 600: column passes
       (129, 2048, 2, 3, 1, CC, CC),        # Cin past THIN_OUT_MAX_CIN
       (333, 1, 40, 5, 3, "in", CC),        # Cin 1 pairs at dilation 3, five n8 tiles
       (77, 2, 8, 7, 2, "in", CC),          # one n8 tile, dilation 2
       (600, 1, 120, 15, 1, "in", CC)]      # all 16 fragment k, two block tiles


@pytest.mark.parametrize("snake", [True, False])
@pytest.mark.parametrize("t,cin,cout,k,d,bf16,f32", ODD)
def test_thin_schedule_at_odd_shapes_matches_plain(t, cin, cout, k, d, bf16, f32, snake):
    for dt, design, tol in ((torch.float32, f32, 1e-5), (torch.bfloat16, bf16, 5e-3)):
        assert tconv.conv_route(cin, cout, k, dt) == "thin"
        assert tconv.thin_design(cin, cout, k, d, dt) == design
        x, w, bias, a, ib = _torch(*_inputs(t + d, 1, t, cin, cout, k, snake))
        x = x.to(dt)
        got = SCHEDULES[design](x, w, bias, a, ib, dilation=d)
        assert _rel(got, tconv.snake_conv1d_plain(x, w, bias, a, ib, dilation=d)) < tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_thin_out_fragments_cover_each_chunk_channel_once(dtype):
    """The fragments' channel maps of one chunk: each step's logical k
    indices name distinct channels, and the steps together name every
    channel of the chunk once (A's and B's words are loaded in this order,
    so the product is the chunk's whole sum)."""
    steps = fragment_channels(dtype)
    seen = [c for ch in steps for c in ch]
    assert sorted(seen) == list(range(OUT_KC[dtype]))


def test_thin_design_limits():
    """Thin-out takes k * Cout up to 32 columns, rows of whole 16-byte
    words, Cin up to THIN_OUT_MAX_CIN and halos up to THIN_OUT_MAX_HALO;
    thin-in bf16 Cin 1 or 2 with k * Cin up to 16 and Cout a multiple of 8
    up to THIN_IN_MAX_COUT; everything else the CUDA-core kernel, which
    takes any shape."""
    bf, f32 = torch.bfloat16, torch.float32
    for cin, cout, k, d, dt, want in [
            (128, 4, 7, 1, bf, "out"), (128, 4, 9, 1, bf, CC), (128, 5, 7, 1, bf, CC),
            (12, 2, 7, 1, bf, CC), (12, 2, 7, 1, f32, "out"), (1024, 2, 7, 1, bf, "out"),
            (1032, 2, 7, 1, bf, CC), (256, 2, 7, 1, f32, "out"), (264, 2, 7, 1, f32, CC),
            (128, 2, 7, 42, bf, "out"), (128, 2, 7, 43, bf, CC),
            (2, 128, 7, 1, bf, "in"), (2, 128, 7, 1, f32, CC), (2, 136, 7, 1, bf, CC),
            (2, 100, 7, 1, bf, CC), (2, 128, 9, 1, bf, CC), (1, 64, 15, 1, bf, "in"),
            (1, 64, 17, 1, bf, CC), (3, 64, 5, 1, bf, CC), (2, 64, 7, 9, bf, "in")]:
        assert tconv.thin_design(cin, cout, k, d, dt) == want, (cin, cout, k, d, dt)


@pytest.mark.parametrize("cin,k,d", [(2, 7, 1), (1, 7, 1), (2, 3, 3), (1, 15, 1), (1, 5, 3)])
def test_thin_in_pairs_are_the_fragment_words(cin, k, d):
    """The staged pairs, read at the lanes' offsets, give each row's k *
    Cin taps in k order (k = j Cin + c: x[r + j d, c]) and zeros past them:
    the im2col row the 16-deep product needs."""
    rows = 32
    xs = torch.arange(1.0, 1.0 + (rows + 16 * d) * cin).reshape(-1, cin)
    a = fragment_a(in_pairs(xs, cin, d), rows, k, cin, d)
    want = torch.zeros(rows, 16)
    for kk in range(k * cin):
        j, c = divmod(kk, cin)
        want[:, kk] = xs[j * d:j * d + rows, c]
    assert torch.equal(a[:, :k * cin], want[:, :k * cin])
    odd_tail = a[:, k * cin:]  # past the real taps: zero, or (Cin 1, odd k) the finite next tap
    assert torch.isfinite(odd_tail).all() and (k * cin % 2 or not odd_tail.any())


# ---------------------------------------------------------------------------
# K10a
# ---------------------------------------------------------------------------


def rope_schedule(qkv, freqs, num_heads, part, scale):
    """K10a as the kernel schedules it, in fp32: the rows' tables pre-scaled
    once, each head's 64 dims as 8 segments of 8, each dim's partner taken
    from the segment rot/16 away (and the next) at element (j +- rot/2) % 8,
    y = x c + partner s over the rotated dims, x * scale beyond; rounded to
    qkv's dtype."""
    b, t, three_hd = qkv.shape
    hd = three_hd // 3
    rot = freqs.shape[-1]
    half, so, r = rot // 2, rot // 16, (rot // 2) % 8
    f = freqs[-t:].float()
    c_tab, s_tab = torch.cos(f) * scale, torch.sin(f) * scale  # [T, rot], once per row
    seg = qkv[..., part * hd:(part + 1) * hd].float().reshape(b, t, num_heads, 8, 8)

    def lanes(off):  # the segments `off` on within the head (the width-8 shuffles wrap)
        return seg[:, :, :, [(s + off) % 8 for s in range(8)]]

    up0, up1, dn0, dn1 = lanes(so), lanes(so + 1), lanes(8 - so), lanes(7 - so)
    y = seg * scale
    for s in range(8):
        for j in range(8):
            d = 8 * s + j
            if d >= rot:
                continue
            if d < half:
                p = -(up0[..., s, j + r] if j + r < 8 else up1[..., s, (j + r) % 8])
            else:
                p = dn0[..., s, j - r] if j >= r else dn1[..., s, (j - r) % 8]
            y[..., s, j] = seg[..., s, j] * c_tab[:, d, None] + p * s_tab[:, d, None]
    return y.reshape(b, t, hd).to(qkv.dtype)


def _qkv(seed, b, t, h, dtype=torch.bfloat16):
    return _t(np.random.RandomState(seed).randn(b, t, 3 * h * 64), dtype)


@pytest.mark.parametrize("rot", [32, 16, 24, 64, 10])
@pytest.mark.parametrize("b,t,h", [(2, 77, 2), (1, 130, 4), (2, 65, 24)])
def test_rope_schedule_matches_the_plain_k_bit_for_bit(b, t, h, rot):
    """At scale 1 (k) the schedule computes the plain version's formula in
    the same fp32 operations: the same bits, at the shipped rot 32 and at
    rot values whose half is no multiple of 8 (partners across two
    segments)."""
    qkv = _qkv(t + rot, b, t, h)
    freqs = rotary_freqs(t + 5, rot)
    assert torch.equal(rope_schedule(qkv, freqs, h, 1, 1.0), tattn.rope_pair_k_plain(qkv, freqs, h))


@pytest.mark.parametrize("b,t,h", [(2, 77, 2), (1, 130, 4), (2, 65, 24)])
def test_rope_schedule_q_within_one_rounding_of_the_plain_q(b, t, h):
    """At K6's prescale log2(e)/8 the kernel scales the tables (x (c s) + p
    (s s)) where the plain version scales the sum ((x c + p s) s): the same
    value up to fp32 rounding, so within one bf16 rounding of the output."""
    qkv = _qkv(t + 1, b, t, h)
    freqs = rotary_freqs(t, 32)
    got = rope_schedule(qkv, freqs, h, 0, tattn.LOG2E / 8).float()
    want = tattn.rope_pair_q_plain(qkv, freqs, h).float()
    assert ((got - want).abs() <= 2.0 ** -7 * want.abs()).all()
    assert (got != want).float().mean() < 0.01


def jax_rope_pair(qkv, freqs, num_heads, part, scale):
    """JAX `_rope_pair_k_kernel` (:1229) in interpret mode over head pairs
    of the third `part` of qkv, with `_rope_tables`' cos and sin scaled by
    `scale` (as `_pair_tables` prescales q's for K6)."""
    b, t, _ = qkv.shape
    g = num_heads // 2
    cos, sin, p = jfa._rope_tables(jnp.asarray(freqs.numpy()), 64, t)
    c2 = jnp.concatenate([cos * scale] * 2, axis=1)
    s2 = jnp.concatenate([sin * scale] * 2, axis=1)
    p2 = jax.scipy.linalg.block_diag(p, p)
    tab = lambda b_, g_: (0, 0)  # noqa: E731
    out = pl.pallas_call(
        jfa._rope_pair_k_kernel, grid=(b, g), interpret=True,
        in_specs=[pl.BlockSpec((None, t, 128), lambda b_, g_: (b_, 0, part * g + g_)),
                  pl.BlockSpec((t, 128), tab), pl.BlockSpec((t, 128), tab),
                  pl.BlockSpec((128, 128), tab)],
        out_specs=pl.BlockSpec((None, t, 128), lambda b_, g_: (b_, 0, g_)),
        out_shape=jax.ShapeDtypeStruct((b, t, num_heads * 64), jnp.bfloat16),
    )(jnp.asarray(qkv.float().numpy(), jnp.bfloat16), c2, s2, p2)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("part", [1, 0])
@pytest.mark.parametrize("b,t,h", [(2, 77, 2), (1, 136, 4)])
def test_rope_schedule_matches_jax_rope_pair_kernel_in_interpret_mode(b, t, h, part):
    """Both parts against the Pallas kernel in interpret mode (k at scale
    1, q at log2(e)/8): the same formula on the same pre-scaled tables,
    within one bf16 rounding."""
    qkv = _qkv(3 * t + part, b, t, h)
    freqs = rotary_freqs(t, 32)
    scale = 1.0 if part else tattn.LOG2E / 8
    want = jax_rope_pair(qkv, freqs, h, part, scale)
    got = rope_schedule(qkv, freqs, h, part, scale).float().numpy()
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)).all()
