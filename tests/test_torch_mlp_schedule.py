"""The schedules of K13's two routes (csrc/glu_mlp.cu), written out in plain
torch at small sizes and held against the plain version
(`glu_mlp_plain`) and, through the same inputs, against the JAX package's
Pallas `glu_mlp` in interpret mode (FSAT_PALLAS_INTERPRET=1).

Tensor-core route (ops/kernels/mlp.py:_glu_tensor): 128-row tiles of x, the
last one ragged (TMA fills the missing rows with zeros; their results are
dropped); GEMM1 per tile of N / 2 columns of h, its B tile stacked from N / 2
value rows and N / 2 gate rows of w_in (zeros past inner), so one product of
width N holds v in its first column block and g in its second; wgmma's
accumulator layout gives a thread column c of both blocks in the same
register index, and the GLU runs on those register pairs at the input
dtype's rounding points; h is stored in that dtype; GEMM2 multiplies h into
w_out per 128-row x N tile. In fp32 each product is 3xTF32 with the tensor
cores' truncating accumulate and a flush into a round-to-nearest total every
mlp.F32_FLUSH stages of 32 channels, emulated as
tests/test_torch_conv_schedule.py emulates the convolution's.

Streaming route (M <= 16): one block per SM at most; phase 1 gives each
block 32-column tiles of h (v and g as one warp adds them: each lane its
positions of each 256-wide chunk, then the warp's butterfly), stored in an
fp32 scratch; a grid barrier; phase 2 gives each block R outputs, each one
warp's sum over all of h in the same order. No output is summed from parts
of several blocks, so whatever order phase 1's blocks finish in, the bits
are the same.

Tolerances: rel-L2 1e-5 in fp32 and 2e-3 in bf16 (one bf16 rounding of the
output, with v, g and h a bf16 step apart where fp32 sums in another order
cross a rounding boundary) against the plain version, and in fp32 against
JAX. In bf16 the JAX kernel in interpret mode is not within 2e-3 of the
plain version itself where a bias is added (2.3e-3 to 2.7e-3 at these
shapes; the JAX package's Pallas kernel and its own unfused chain are 4e-3
apart), so against JAX in bf16 the schedules are held to the bound
tests/test_torch_lm_generate.py holds the plain version to (rel-L2 2^-8,
max 2^-7 of max|JAX|) and to no more than the plain version's own distance
from JAX plus 1e-4. Inputs come from numpy with fixed seeds.
"""

import inspect
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.ops.pallas import mlp as jmlp
from friendly_stable_audio_tools_tpu_torch.ops.kernels import mlp as tmlp
from tests.test_torch_conv_schedule import tensor_core_product

ROW_TILE = 128  # rows per block of the tensor-core route (csrc/taps_wgmma.cuh kM)
# the shipped tile widths (GEMM1's stacked N, GEMM2's N; csrc/glu_mlp.cu:GemmTiles)
# and the others mlp_variants.py times
TILES = {torch.bfloat16: (256, 256), torch.float32: (128, 128)}
OTHER_TILES = [(torch.bfloat16, (192, 192)), (torch.bfloat16, (128, 128)),
               (torch.float32, (64, 96)), (torch.float32, (64, 64))]
BOX = 256  # elements per TMA box row of the streaming route (csrc/glu_mlp.cu kKB)
STREAM_COLS = tmlp.STREAM_COLS
SMS = 132  # an H100's SMs: the streaming grid's most blocks (csrc/glu_mlp.cu:stream_grid)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
# (K, inner, Kout): within the sizes the kernels' tiles see at small scale,
# the last with a ragged column tile in both GEMMs
SHAPES = [(128, 384, 96), (64, 256, 128), (96, 320, 72)]


def _rel(a, b):
    a = torch.as_tensor(np.asarray(a, np.float64)) if not torch.is_tensor(a) else a.double()
    b = torch.as_tensor(np.asarray(b, np.float64)) if not torch.is_tensor(b) else b.double()
    return ((a - b).norm() / b.norm()).item()


def _inputs(seed, m, k, inner, kout, bias=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32) * 0.5
    w_in = rng.randn(2 * inner, k).astype(np.float32) / math.sqrt(k)
    b_in = (rng.randn(2 * inner).astype(np.float32) * 0.1) if bias else None
    w_out = rng.randn(kout, inner).astype(np.float32) / math.sqrt(inner)
    return x, w_in, b_in, w_out


def _torch(x, w_in, b_in, w_out, dt):
    return (torch.tensor(x).to(dt), torch.tensor(w_in).to(dt),
            None if b_in is None else torch.tensor(b_in), torch.tensor(w_out).to(dt))


def _glu(v, g, bv, bg, dt):
    """h = v * (g * sigmoid(g)) at the kernels' rounding points: v, g and the
    biases rounded to dt and added in dt, sigmoid in fp32 rounded, each
    product rounded (fp32: nothing rounds)."""
    v, g = v.to(dt), g.to(dt)
    if bv is not None:
        v, g = v + bv.to(dt), g + bg.to(dt)
    return v * (g * torch.sigmoid(g.float()).to(dt))


# ---------------------------------------------------------------------------
# the tensor-core route
# ---------------------------------------------------------------------------


def wgmma_layout(ch):
    """(row, column) of register i of lane l of warp w of an m64nCH fp32
    accumulator (csrc/hopper.cuh): d[4j + e] is row 16w + l / 4 + 8 (e / 2),
    column 8j + 2 (l % 4) + e % 2. Returns [4, 32, ch / 2, 2] indices."""
    out = np.zeros((4, 32, ch // 2, 2), np.int64)
    for w, lane, i in itertools.product(range(4), range(32), range(ch // 2)):
        j, e = divmod(i, 4)
        out[w, lane, i] = (16 * w + lane // 4 + 8 * (e // 2), 8 * j + 2 * (lane % 4) + e % 2)
    return out


def glu_in_registers(acc, bias_v, bias_g, dt):
    """The GLU epilogue (csrc/taps_wgmma.cuh:store_glu) on one block's
    stacked [128, N] accumulator, register by register: each thread of each
    consumer warpgroup pairs register i of column block 0 (v) with register
    i of column block 1 (g); both name the same row and the same column c of
    their blocks, column c of h. Returns h [128, N / 2] in fp32."""
    ch = acc.shape[1] // 2
    layout = wgmma_layout(ch)
    h = torch.full((ROW_TILE, ch), float("nan"))
    for wg in range(2):  # two consumer warpgroups of 64 rows
        rows = torch.from_numpy(64 * wg + layout[..., 0].reshape(-1))
        cols = torch.from_numpy(layout[..., 1].reshape(-1))
        v, g = acc[rows, cols], acc[rows, ch + cols]  # the same register of each block
        bv = None if bias_v is None else bias_v[cols]
        bg = None if bias_g is None else bias_g[cols]
        h[rows, cols] = _glu(v, g, bv, bg, dt).float()
    return h


def _product(a, b, dt):
    """a [rows, K] @ b [K, N] as the tile's products: bf16 operands into an
    fp32 sum; fp32 as 3xTF32 with the truncating accumulate and the flush."""
    if dt == torch.bfloat16:
        return (a.double() @ b.double()).float()
    return tensor_core_product(a, b, tmlp.F32_FLUSH)


def tensor_schedule(x, w_in, b_in, w_out, tiles=None):
    """K13's tensor-core route as csrc/glu_mlp.cu schedules it, at the
    tile widths `tiles` (GEMM1's stacked N, GEMM2's N; the shipped ones by
    default)."""
    dt = x.dtype
    m, k = x.shape
    inner, kout = w_in.shape[0] // 2, w_out.shape[0]
    glu_n, out_n = tiles or TILES[dt]
    cols = glu_n // 2
    xf, wi, wo = x.float(), w_in.float(), w_out.float()
    h = torch.zeros(m, inner)
    for r0 in range(0, m, ROW_TILE):
        rows = min(ROW_TILE, m - r0)
        a = torch.zeros(ROW_TILE, k)
        a[:rows] = xf[r0:r0 + rows]
        for n0 in range(0, inner, cols):
            cv = min(cols, inner - n0)
            b = torch.zeros(2 * cols, k)  # stacked: value rows, then gate rows
            b[:cv] = wi[n0:n0 + cv]
            b[cols:cols + cv] = wi[inner + n0:inner + n0 + cv]
            acc = _product(a, b.T.contiguous(), dt)
            bias_v = bias_g = None
            if b_in is not None:
                bias_v, bias_g = torch.zeros(cols), torch.zeros(cols)
                bias_v[:cv], bias_g[:cv] = b_in[n0:n0 + cv], b_in[inner + n0:inner + n0 + cv]
            h[r0:r0 + rows, n0:n0 + cv] = glu_in_registers(acc, bias_v, bias_g, dt)[:rows, :cv]
    y = torch.zeros(m, kout)
    for r0 in range(0, m, ROW_TILE):
        rows = min(ROW_TILE, m - r0)
        a = torch.zeros(ROW_TILE, inner)
        a[:rows] = h[r0:r0 + rows]
        for n0 in range(0, kout, out_n):
            nv = min(out_n, kout - n0)
            b = torch.zeros(out_n, inner)
            b[:nv] = wo[n0:n0 + nv]
            y[r0:r0 + rows, n0:n0 + nv] = _product(a, b.T.contiguous(), dt)[:rows, :nv]
    return y.to(dt)


@pytest.mark.parametrize("ch", [32, 64, 96, 128])
def test_wgmma_layout_pairs_value_and_gate_columns(ch):
    """Every (row, column) of a 64 x ch block is one register of one thread,
    and the register index alone fixes the column: a stacked tile's value
    and gate blocks hold column c of h in the same thread's same register."""
    layout = wgmma_layout(ch)
    cells = {tuple(rc) for rc in layout.reshape(-1, 2)}
    assert len(cells) == layout.size // 2
    assert cells == {(r, c) for r in range(64) for c in range(ch)}
    # a register's column does not depend on the warp: the four warps of the
    # warpgroup own rows, and every thread spans the block's columns
    assert (layout[..., 1] == layout[:1, :, :, 1]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,bias", [(1, True), (2, False), (16, True), (130, False)])
@pytest.mark.parametrize("shape", SHAPES, ids=["k128", "k64", "ragged"])
def test_tensor_schedule_matches_plain(shape, m, bias, dtype):
    x, w_in, b_in, w_out = _torch(*_inputs(m + shape[0], m, *shape, bias=bias), dtype)
    got = tensor_schedule(x, w_in, b_in, w_out)
    assert got.dtype == dtype and got.shape == (m, shape[2])
    assert _rel(got, tmlp.glu_mlp_plain(x, w_in, b_in, w_out)) <= TOL[dtype]


@pytest.mark.parametrize("dtype,tiles", OTHER_TILES, ids=["bf16-192", "bf16-128", "fp32-64-96",
                                                          "fp32-64"])
@pytest.mark.parametrize("shape", SHAPES, ids=["k128", "k64", "ragged"])
def test_tensor_schedule_at_other_tile_widths(shape, dtype, tiles):
    """The widths mlp_variants.py substitutes compute the same function: a
    ragged row tile (M 130) and ragged column tiles in both GEMMs."""
    x, w_in, b_in, w_out = _torch(*_inputs(7 + shape[0], 130, *shape), dtype)
    got = tensor_schedule(x, w_in, b_in, w_out, tiles)
    assert _rel(got, tmlp.glu_mlp_plain(x, w_in, b_in, w_out)) <= TOL[dtype]


# ---------------------------------------------------------------------------
# the streaming route
# ---------------------------------------------------------------------------


def lane_positions(dtype):
    """The 8 positions lane l takes of each 256-wide box row, in the order
    it adds them: fp32 4l .. 4l + 3 and 128 + 4l .. (two 16-byte words), bf16
    8l .. 8l + 7 (one). Returns [32, 8]."""
    lane = torch.arange(32)[:, None]
    e = torch.arange(8)[None, :]
    if dtype == torch.float32:
        return 4 * lane + e % 4 + 128 * (e // 4)
    return 8 * lane + e


def warp_dot(a, b, dtype):
    """sum over the last axis of a * b as one warp adds it: each lane its
    positions of each 256-wide chunk, chunk after chunk, in fp32, then the
    lanes' sums by the butterfly of csrc/glu_mlp.cu:warp_sum (xor 16, 8, 4,
    2, 1). a, b [..., P]; P padded with zeros to a multiple of 256."""
    p = a.shape[-1]
    pad = math.ceil(p / BOX) * BOX - p
    a = torch.nn.functional.pad(a.float(), (0, pad))
    b = torch.nn.functional.pad(b.float(), (0, pad))
    pos = lane_positions(dtype)
    acc = torch.zeros(*a.shape[:-1], 32)
    for c in range(a.shape[-1] // BOX):
        idx = c * BOX + pos  # [32, 8]
        prod = a[..., idx] * b[..., idx]  # [..., 32, 8]
        for e in range(8):
            acc = acc + prod[..., e]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def stream_grid(inner, kout, blocks=None):
    """(G, R): the streaming kernel's blocks (one per 32-column tile of h,
    one per SM at most) and outputs per block, as csrc/glu_mlp.cu:stream_grid
    plans them on an H100; `blocks` sets G."""
    blocks = blocks or min(inner // STREAM_COLS, SMS)
    return blocks, math.ceil(kout / blocks)


def stream_schedule(x, w_in, b_in, w_out, finish_order=None, barrier=True, blocks=None):
    """The streaming route as csrc/glu_mlp.cu schedules it: G blocks (one
    per SM at most; `blocks` sets G), phase 1 in `finish_order` (block b forms h for the
    32-column tiles b, b + G, ... and stores them in the fp32 scratch), the
    grid barrier (every block has arrived: no column of h is missing), then
    phase 2 (block b's R outputs, each one warp's sum over all of inner).
    With barrier=False phase 2 reads the scratch after the first block."""
    dt = x.dtype
    m, k = x.shape
    inner, kout = w_in.shape[0] // 2, w_out.shape[0]
    assert m <= 16
    blocks, rows = stream_grid(inner, kout, blocks)
    hbuf = torch.full((m, inner), float("nan"))
    xf = x.float()
    arrived = 0
    for b in (finish_order if finish_order is not None else range(blocks)):
        for j0 in range(b * STREAM_COLS, inner, blocks * STREAM_COLS):
            cols = slice(j0, j0 + STREAM_COLS)
            v = warp_dot(xf[:, None, :], w_in[cols].float()[None], dt)
            g = warp_dot(xf[:, None, :], w_in[inner + j0:inner + j0 + STREAM_COLS].float()[None], dt)
            bv = None if b_in is None else b_in[cols]
            bg = None if b_in is None else b_in[inner + j0:inner + j0 + STREAM_COLS]
            hbuf[:, cols] = _glu(v, g, bv, bg, dt).float()
        arrived += 1
        if not barrier:
            break
    if barrier:
        assert arrived == blocks and not torch.isnan(hbuf).any()
    y = torch.empty(m, kout)
    for b in range(blocks):
        n = slice(b * rows, min(kout, (b + 1) * rows))
        y[:, n] = warp_dot(hbuf[:, None, :], w_out[n].float()[None], dt)
    return y.to(dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,bias", [(1, True), (2, False), (16, True)])
@pytest.mark.parametrize("shape", SHAPES, ids=["k128", "k64", "ragged"])
def test_stream_schedule_matches_plain(shape, m, bias, dtype):
    x, w_in, b_in, w_out = _torch(*_inputs(m + shape[1], m, *shape, bias=bias), dtype)
    got = stream_schedule(x, w_in, b_in, w_out)
    assert got.dtype == dtype and got.shape == (m, shape[2])
    assert _rel(got, tmlp.glu_mlp_plain(x, w_in, b_in, w_out)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_result_does_not_depend_on_finish_order(dtype):
    """Phase 1's blocks store h in any order; behind the grid barrier every
    order gives the same bits, since each output is one warp's sum in a
    fixed order over all of h. Without the barrier phase 2 would read
    columns of h that are not stored yet."""
    m, k, inner, kout = 2, 64, 512, 128
    x, w_in, b_in, w_out = _torch(*_inputs(5, m, k, inner, kout), dtype)
    blocks = stream_grid(inner, kout)[0]
    want = stream_schedule(x, w_in, b_in, w_out)
    rng = np.random.RandomState(0)
    for _ in range(4):
        got = stream_schedule(x, w_in, b_in, w_out, finish_order=list(rng.permutation(blocks)))
        assert torch.equal(got, want)
    early = stream_schedule(x, w_in, b_in, w_out, finish_order=[3], barrier=False)
    assert torch.isnan(early.float()).any()


def test_warp_dot_is_the_kernel_order_not_any_order():
    """The emulated warp sum follows the lanes' and the butterfly's order:
    at fp32 it differs in the last bits from a plain sum in position order,
    and both are within rounding of fp64."""
    rng = np.random.RandomState(1)
    a = torch.tensor(rng.randn(64, 1024).astype(np.float32))
    b = torch.tensor(rng.randn(64, 1024).astype(np.float32))
    got, plain = warp_dot(a, b, torch.float32), (a * b).sum(-1)
    ref = (a.double() * b.double()).sum(-1)
    assert not torch.equal(got, plain)
    assert _rel(got, ref) < 1e-6 and _rel(plain, ref) < 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", [1, 3, 5, 7])
def test_stream_schedule_at_any_grid(blocks, dtype):
    """The grid is the kernel's to plan from the card's SMs (fewer blocks
    than tiles of h, a last block with fewer outputs): every G gives the
    same bits, since each output is one warp's sum over all of h."""
    k, inner, kout = SHAPES[2]
    x, w_in, b_in, w_out = _torch(*_inputs(blocks, 3, k, inner, kout), dtype)
    got = stream_schedule(x, w_in, b_in, w_out, blocks=blocks)
    assert torch.equal(got, stream_schedule(x, w_in, b_in, w_out))
    assert _rel(got, tmlp.glu_mlp_plain(x, w_in, b_in, w_out)) <= TOL[dtype]


# ---------------------------------------------------------------------------
# against the JAX package's Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


def _jax_glu_mlp(x, w_in, b_in, w_out, dtype):
    inner = w_in.shape[0] // 2
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xt, wi, _, wo = _torch(x, w_in, b_in, w_out, dtype)  # the values the port sees
    out = jmlp.glu_mlp(jnp.asarray(xt.float().numpy(), jdt),
                       jnp.asarray(wi.float().numpy()[:inner].T, jdt),
                       jnp.asarray(wi.float().numpy()[inner:].T, jdt),
                       jnp.asarray(wo.float().numpy().T, jdt),
                       None if b_in is None else jnp.asarray(b_in[:inner]),
                       None if b_in is None else jnp.asarray(b_in[inner:]))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 2, 16, 130])
def test_both_routes_match_jax_in_interpret_mode(monkeypatch, m, dtype):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    k, inner, kout = SHAPES[0]
    arrays = _inputs(3 * m, m, k, inner, kout, bias=m % 2 == 0)
    want = _jax_glu_mlp(*arrays, dtype)
    x, w_in, b_in, w_out = _torch(*arrays, dtype)
    plain_err = _rel(tmlp.glu_mlp_plain(x, w_in, b_in, w_out).float(), want)
    schedules = [tensor_schedule] + ([stream_schedule] if m <= 16 else [])
    for got in (schedule(x, w_in, b_in, w_out) for schedule in schedules):
        err = _rel(got.float(), want)
        if dtype == torch.float32:
            assert err <= TOL[dtype]
        else:
            assert err <= min(2.0 ** -8, plain_err + 1e-4), (err, plain_err)
            assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * np.abs(want).max()


# ---------------------------------------------------------------------------
# 3xTF32 at GEMM2's reduction, the route and the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flush,within", [(tmlp.F32_FLUSH, True), (6144 // 32, False)])
def test_3xtf32_flush_at_gemm2s_6144_long_reduction(flush, within):
    """GEMM2 of the DiT reduces over inner 6144 (192 stages): with the
    shipped flush the truncating tensor-core accumulate stays within 1e-6
    of fp64; accumulated over the whole reduction it does not."""
    rng = np.random.RandomState(11)
    h = torch.tensor(rng.randn(16, 6144).astype(np.float32))
    w = torch.tensor((rng.randn(6144, 16) / math.sqrt(6144)).astype(np.float32))
    err = _rel(tensor_core_product(h, w, flush), h.double() @ w.double())
    assert (err <= 1e-6) == within, err


def test_route_depends_on_the_shape_only():
    assert list(inspect.signature(tmlp.route).parameters) == ["m", "k", "inner", "kout", "dtype"]
    for dtype in (torch.float32, torch.bfloat16):
        for m in (1, 2, 16, 130, 2050, 2080):
            assert len({tmlp.route(m, 1024, 4096, 1024, dtype) for _ in range(2)}) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_by_m_at_the_main_path_shapes(dtype):
    """The LM's decode (M 2) streams; the DiT's tokens (M 2050 in generation,
    2080 at the training pad) take the tensor cores; the boundary is the
    measured crossover, STREAM_MAX_M."""
    cut = tmlp.STREAM_MAX_M[dtype]
    assert tmlp.route(2, 1024, 4096, 1024, dtype) == "stream"
    assert tmlp.route(cut, 1024, 4096, 1024, dtype) == "stream"
    assert tmlp.route(cut + 1, 1024, 4096, 1024, dtype) == "tensor"
    for m in (2050, 2080):
        assert tmlp.route(m, 1536, 6144, 1536, dtype) == "tensor"
    for m in (1, 2, 16, 130):  # the small shapes of this file
        assert tmlp.route(m, 128, 384, 96, dtype) == ("stream" if m <= cut else "tensor")


def test_route_falls_to_the_other_route_or_none():
    # inner 240 is no multiple of the streaming tiles' 32 columns
    assert tmlp.route(2, 128, 240, 128, torch.float32) == "tensor"
    # Kout 300 over inner 256's 8 blocks (38 outputs per block, past the
    # kernel's 32) meets the shape's preconditions: on the card the kernel's
    # plan refuses it and the wrapper takes the tensor cores
    assert tmlp.route(2, 128, 256, 300, torch.bfloat16) == "stream"
    # M 17 and more never stream
    assert not tmlp.stream_fits(17, 1024, 4096, torch.float32)
    # an odd Kout does not fit the tensor route; K 100 in bf16 is no 16-byte row for TMA
    assert tmlp.route(2, 128, 256, 97, torch.float32) == "stream"
    assert tmlp.route(64, 128, 256, 97, torch.float32) is None
    assert tmlp.route(4096, 100, 256, 128, torch.bfloat16) is None
