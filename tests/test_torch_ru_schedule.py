"""The schedule of K3's Hopper kernels (csrc/residual_unit.cu: the Oobleck
residual unit y = x + conv1x1(snake2(conv7_dil(snake1(x)) + b1)) + b2),
written out in plain torch at small sizes and held against the plain
version and, through the same inputs, against the JAX package's
`fused_residual_unit` in interpret mode (FSAT_PALLAS_INTERPRET=1).

Two routes, by (C, dtype) alone (conv1d.ru_route):
- fused (bf16 C 128): per 128-row tile, stage 1 builds h 128 columns at a
  time; per chunk of 64 channels one box of x rows [t0 - 3 dil, t0 + 128 +
  3 dil) (rows outside [0, T) read as zero) is snaked once, rounded to
  bf16, and the seven taps read it at row offsets j dil; h = snake2(acc +
  b1) rounded to bf16 stays with the block; stage 2 multiplies it by w2
  chunk by chunk and adds b2 and x (one rounding);
- split (every other shape, bf16 and fp32): a pass snakes x once (rounded
  to the dtype); stage 1 is the conv kernel's schedule over the snaked
  rows (each tap its own load of 128 rows, channel chunks of 64 in bf16 or
  32 in fp32), h rounded into a scratch [B, T, C]; stage 2 a GEMM over the
  B T rows of h in 128-row tiles with the same residual epilogue.

fp32 products are 3xTF32 with a truncating tensor-core accumulate and the
partial sum flushed into a round-to-nearest total every conv1d.F32_FLUSH
stages of 32 channels (tests/test_torch_conv_schedule.py's emulation);
stage 1's stages run the taps inside the channel chunks. The schedules
hold against the plain version to rel-L2 1e-5 in fp32 and to one bf16
rounding in bf16 (rel-L2 2e-3, max abs 2^-6 of the largest value: the
tolerance chip_smoke.py holds the kernels to), and against the JAX
function at tests/test_torch_port_kernels.py's tolerance for K3 (fp32 atol
1e-4; bf16 atol 3e-2 and mean abs 1e-3).

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
from tests.test_torch_conv_schedule import STAGE, tensor_core_product

M_TILE = 128  # output rows per block (csrc/taps_wgmma.cuh kM)
KC = {torch.bfloat16: 64, torch.float32: 32}  # channels per 128-byte row
TAPS = 7
SMEM_MAX = 232448  # a Hopper block's dynamic shared memory
BOX_MAX = 256  # a TMA box's rows


def _rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _rows(x, b, r0, rows, c0, kc):
    """Rows r0 .. r0 + rows of batch b, channels c0 .. c0 + kc, fp32; rows
    outside [0, T) are zeros (what TMA fills)."""
    t = x.shape[1]
    out = torch.zeros(rows, kc)
    lo, hi = max(r0, 0), min(r0 + rows, t)
    if lo < hi:
        out[lo - r0:hi - r0] = x[b, lo:hi, c0:c0 + kc].float()
    return out


def _snake1(rows, a, ib, c0, kc, dt):
    """snake1 in fp32, rounded to the activation dtype (fp32: not rounded)."""
    return tconv.snake(rows, a[c0:c0 + kc].float(), ib[c0:c0 + kc].float()).to(dt).float()


def _h(acc, b1, a2, i2, n0, dt):
    """h = snake2(acc + b1) for columns n0 .., rounded to the dtype."""
    n = acc.shape[1]
    v = acc + b1[n0:n0 + n].float()
    return tconv.snake(v, a2[n0:n0 + n].float(), i2[n0:n0 + n].float()).to(dt).float()


def _product(pairs, dt):
    """sum of a @ b over the stages' (a [M, kc], b [kc, N]) pairs: fp32 as
    3xTF32 with the truncating partial sum and the F32_FLUSH flush (the
    stages in order, each STAGE channels), bf16 exactly (fp32 sums)."""
    if dt == torch.float32:
        a = torch.cat([p[0] for p in pairs], 1)
        b = torch.cat([p[1] for p in pairs], 0)
        assert a.shape[1] % STAGE == 0
        return tensor_core_product(a, b, tconv.F32_FLUSH)
    return sum(a @ b for a, b in pairs)


def _stage2(h, w2, b2, xrows, n, kc, dt):
    """y rows = (h . w2 + b2) + x, N columns at a time, chunk by chunk."""
    c = h.shape[1]
    y = torch.empty(h.shape[0], c)
    for n0 in range(0, c, n):
        acc = _product([(h[:, c0:c0 + kc], w2[c0:c0 + kc, n0:n0 + n].to(dt).float())
                        for c0 in range(0, c, kc)], dt)
        y[:, n0:n0 + n] = (acc + b2[n0:n0 + n].float()) + xrows[:, n0:n0 + n]
    return y


def ru_fused_schedule(x, w1, b1, a1, i1, w2, b2, a2, i2, dilation):
    """The fused route as ru_fused_kernel schedules it."""
    dt = x.dtype
    assert dt == torch.bfloat16, "the fused route is bf16's"
    bsz, t, c = x.shape
    plan = tconv.ru_plan(c, dilation)
    n, kc, pad = 128, KC[dt], 3 * dilation
    y = torch.empty(bsz, t, c)
    for b in range(bsz):
        for r0 in range(0, t, M_TILE):
            h = torch.zeros(M_TILE, c)
            for n1 in range(0, c, n):
                pairs = []
                for c0 in range(0, c, kc):
                    box = _snake1(_rows(x, b, r0 - pad, plan["box_rows"], c0, kc), a1, i1, c0, kc,
                                  dt)  # snaked once per chunk
                    for j in range(TAPS):  # tap j's A: box rows j dil .. + 128
                        pairs.append((box[j * dilation:j * dilation + M_TILE],
                                      w1[j, c0:c0 + kc, n1:n1 + n].to(dt).float()))
                h[:, n1:n1 + n] = _h(_product(pairs, dt), b1, a2, i2, n1, dt)
            rows = min(M_TILE, t - r0)
            out = _stage2(h, w2, b2, _rows(x, b, r0, M_TILE, 0, c), n, kc, dt)
            y[b, r0:r0 + rows] = out[:rows]
    return y.to(dt)


def ru_split_schedule(x, w1, b1, a1, i1, w2, b2, a2, i2, dilation):
    """The split route: the snake pass, the conv kernel's schedule over the
    snaked rows into a rounded h scratch, then the GEMM over the B T rows of
    h with the residual."""
    dt = x.dtype
    bsz, t, c = x.shape
    n, kc, pad = tconv.split_tile_n(c, dt), KC[dt], 3 * dilation
    xs = torch.stack([_snake1(x[b].float(), a1, i1, 0, c, dt) for b in range(bsz)])  # the pass
    h = torch.empty(bsz, t, c)
    for b in range(bsz):
        for r0 in range(0, t, M_TILE):
            rows = min(M_TILE, t - r0)
            for n0 in range(0, c, n):
                pairs = [(_rows(xs, b, r0 + j * dilation - pad, M_TILE, c0, kc),
                          w1[j, c0:c0 + kc, n0:n0 + n].to(dt).float())
                         for c0 in range(0, c, kc) for j in range(TAPS)]  # each tap its own load
                h[b, r0:r0 + rows, n0:n0 + n] = _h(_product(pairs, dt), b1, a2, i2, n0, dt)[:rows]
    hf, xf = h.reshape(bsz * t, c), x.reshape(bsz * t, c).float()
    y = torch.empty(bsz * t, c)
    for r0 in range(0, bsz * t, M_TILE):
        y[r0:r0 + M_TILE] = _stage2(hf[r0:r0 + M_TILE], w2, b2, xf[r0:r0 + M_TILE], n, kc, dt)
    return y.reshape(bsz, t, c).to(dt)


SCHEDULES = {"fused": ru_fused_schedule, "split": ru_split_schedule}


def _inputs(seed, b, t, c):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, c).astype(np.float32) * 0.5
    w1 = rng.randn(TAPS, c, c).astype(np.float32) / math.sqrt(TAPS * c)
    b1 = rng.randn(c).astype(np.float32) * 0.1
    w2 = rng.randn(c, c).astype(np.float32) / math.sqrt(c)
    b2 = rng.randn(c).astype(np.float32) * 0.1
    a1, i1, a2, i2 = ((np.abs(rng.randn(c)) + 0.5).astype(np.float32) for _ in range(4))
    return x, w1, b1, a1, i1, w2, b2, a2, i2


def _torch(arrays, dt):
    x, *rest = (torch.tensor(a) for a in arrays)
    return [x.to(dt), *rest]


def _one_rounding(got, want):
    """Within one bf16 rounding of the output: rel-L2 2e-3, max abs 2^-6 of max|want|."""
    diff = (got.float() - want.float()).abs()
    assert _rel(got, want) < 2e-3
    assert diff.max().item() <= 2.0 ** -6 * want.float().abs().max().item()


# (B, T, C, dilation): B 2, T 333 (no multiple of the 128-row tile) and T 77
# (under one tile); dilation 9 reaches 27 rows past both ends
CASES = [(2, 333, 128, 9), (2, 77, 256, 9), (2, 333, 256, 1), (2, 77, 128, 3)]
DTYPES = [torch.float32, torch.bfloat16]


# the fused route is bf16's; the split route runs in both dtypes
ROUTE_CASES = [(case, dt, route) for case in CASES for dt in DTYPES for route in ("fused", "split")
               if route == "split" or dt == torch.bfloat16]


@pytest.mark.parametrize("case,dt,route", ROUTE_CASES,
                         ids=[f"{c}-{'fp32' if d == torch.float32 else 'bf16'}-{r}"
                              for c, d, r in ROUTE_CASES])
def test_schedule_matches_plain(case, dt, route):
    """Both routes' schedules against fused_residual_unit_plain, each also
    where ru_route gives the other one (the split route at bf16 C 128, the
    fused one at bf16 C 256)."""
    b, t, c, d = case
    args = _torch(_inputs(t + c + d, b, t, c), dt)
    got = SCHEDULES[route](*args, dilation=d)
    want = tconv.fused_residual_unit_plain(*args, dilation=d)
    assert got.shape == (b, t, c) and got.dtype == dt
    if dt == torch.float32:
        assert _rel(got, want) < 1e-5
    else:
        _one_rounding(got, want)


@pytest.mark.parametrize("dt", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,c,d", [(2, 333, 128, 9), (2, 333, 256, 9)])
def test_schedule_matches_jax_fused_residual_unit_in_interpret_mode(monkeypatch, b, t, c, d, dt):
    """The shipped route's schedule against the JAX `fused_residual_unit`
    on the same values, through its Pallas kernel (`_ru_forward`, block_t
    128) in interpret mode. (Under one block, T 77, the JAX function takes
    its XLA form, which rounds the 1x1 conv and the residual add apart.)"""
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    arrays = _inputs(t * d + c, b, t, c)
    args = _torch(arrays, dt)
    x_np = args[0].float().numpy()
    jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
    want = np.asarray(jconv.fused_residual_unit(jnp.asarray(x_np, jdt),
                                                *(jnp.asarray(a) for a in arrays[1:]),
                                                dilation=d, block_t=128).astype(jnp.float32))
    got = SCHEDULES[tconv.ru_route(c, dt)](*args, dilation=d).float().numpy()
    if dt == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=3e-2)
        assert np.abs(got - want).mean() < 1e-3


def test_split_route_at_c1024_matches_plain_in_bf16():
    """bf16 C 1024 takes the split route; its schedule at T 77, dilation 9."""
    assert tconv.ru_route(1024, torch.bfloat16) == "split"
    args = _torch(_inputs(5, 1, 77, 1024), torch.bfloat16)
    _one_rounding(ru_split_schedule(*args, dilation=9),
                  tconv.fused_residual_unit_plain(*args, dilation=9))


# ---------------------------------------------------------------------------
# the route and the launch plan
# ---------------------------------------------------------------------------

ROUTES = {(torch.bfloat16, 128): "fused", (torch.bfloat16, 256): "split",
          (torch.bfloat16, 512): "split", (torch.bfloat16, 1024): "split",
          (torch.float32, 128): "split", (torch.float32, 256): "split",
          (torch.float32, 512): "split", (torch.float32, 1024): "split"}


@pytest.mark.parametrize("dt,c", list(ROUTES), ids=[f"{d}-{c}" for d, c in ROUTES])
def test_ru_route(dt, c):
    assert tconv.ru_route(c, dt) == ROUTES[(dt, c)]


def test_ru_route_depends_on_channels_and_dtype_only():
    assert list(inspect.signature(tconv.ru_route).parameters) == ["c", "dtype"]


def _conv_tile_smem(dt, n):
    """The split route's conv and GEMM launches: ConvTile<T, N>::kSmem
    (csrc/taps_wgmma.cuh: stages of one 128-row A tile and kBTiles N-row B
    tiles, at most 4, within the budget)."""
    a_tile, b_tile = M_TILE * 128, n * 128 * (2 if dt == torch.float32 else 1)
    budget = 227 * 1024 - 1024 - 2 * 4 * 8
    stages = min(budget // (a_tile + b_tile), 4)
    return stages, 1024 + stages * (a_tile + b_tile) + 2 * stages * 8


@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("dt,c", list(ROUTES), ids=[f"{d}-{c}" for d, c in ROUTES])
def test_launch_plan_fits_a_block(dt, c, d):
    """On the split route the conv and GEMM tiles within 232,448 bytes; the
    fused plan wherever bf16 h's 128-row tile fits RU_H_MAX (C 128, and C
    256 and 512, which the split route runs faster): shared memory within
    232,448 bytes (h + the x ring + the weight ring of 128-row tiles +
    mbarriers + 1024 of alignment), each x slot 1024-aligned and holding
    one TMA box of the 128 rows and the 6 dil halo (at most 256 rows)."""
    if tconv.ru_route(c, dt) == "split":
        n = tconv.split_tile_n(c, dt)
        stages, smem = _conv_tile_smem(dt, n)
        assert c % n == 0 and stages >= 2 and smem <= SMEM_MAX
    if dt == torch.float32 or M_TILE * c * 2 > tconv.RU_H_MAX:
        assert tconv.ru_route(c, dt) == "split"
        return
    plan = tconv.ru_plan(c, d)
    rows = plan["box_rows"]
    assert M_TILE + 6 * d <= rows < M_TILE + 6 * d + 8 and rows % 8 == 0 and rows <= BOX_MAX
    assert (rows * 128) % 1024 == 0
    want = (1024 + M_TILE * c * 2 + plan["x_slots"] * rows * 128 + plan["w_stages"] * 128 * 128
            + 16 * (plan["x_slots"] + plan["w_stages"]))
    assert plan["smem"] == want <= SMEM_MAX
    assert plan["x_slots"] >= 1 and plan["w_stages"] >= 2
