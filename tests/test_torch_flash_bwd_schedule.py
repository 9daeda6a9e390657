"""The schedule of K9 on the tensor cores (csrc/flash_attention_bwd_f32.cu:
the fp32 FlashAttention backward, causal or not), written out in plain
torch at small sizes and held against the plain version and the JAX
package.

The kernel gives each block 64 keys of one head (blocks whose keys all lie
at or past kv_len write zero dk and dv) and two warpgroups that take the
head's q tiles of 64 rows in turn (causal: from the block's diagonal tile
on, where alone keys past a row's position are masked). Per q tile, five
products of 64 x 64 x 64, each zeroed first: S = q K^T and dP = dO V^T (q
rows by keys), P = exp2(S log2(e)/8 - lse) and dS = P (dP - delta) / 8 in
fp32, dV^T = dO^T P and dK^T = q^T dS (head dims by keys), each added into
the warpgroup's fp32 totals, and dq = dS K (q rows by head dims), added into
dq row by row. Every product is 3xTF32 on tensor cores whose fp32
accumulate truncates: per k8 slice a_lo b_hi, a_hi b_lo, a_hi b_hi, each
added into the accumulator rounding toward zero, with hi = tf32(x) and lo =
tf32(x - hi) rounded to nearest. The products over q rows (dV^T, dK^T) and
over keys (dq) take their k8 slices' rows in a permuted order, which leaves
the slices, and so this emulation, unchanged. At the end dk and dv are the
two warpgroups' totals summed.

Against `flash_backward_plain` (the function in fp32): rel-L2 <= 1e-5 for
dq, dk and dv. Against the JAX `_flash_backward` in interpret mode
(FSAT_PALLAS_INTERPRET=1, FSAT_FUSED_BWD=0 for its two-pass K9, as
tests/test_torch_flash.py forces it): rel-L2 <= 1e-4. The emulation also
shows why the kernel adds each q tile's dV^T and dK^T into fp32 totals
rather than summing them in the accumulators: over SA 2.0's 6272 q rows the
truncating accumulate alone drifts past 1e-5. The launch plan (the kernel's
shared-memory layout and its TMA boxes) is checked against the card's
limits. Inputs come from numpy with fixed seeds.

K8 (`flash_backward_fused`, non-causal) runs the same kernel at head dim 64
with its own formula order: q' = q log2(e)/sqrt(D) as the A operand of S
and of dK^T, P = exp2(S - lse), dS = P (dP - delta) unscaled, dq = (dS K) /
sqrt(D), dk = (dS^T q') / log2(e). At head dim 80 one warpgroup takes every
q tile (the tiles do not fit two), S and dP sum ten k8 slices, dq is an
m64n80 product, and dK and dV take dims 0-63 as above and dims 64-79 from
products with the keys as rows: dV[:, 64:] = P^T dO[:, 64:] and dK[:, 64:] =
dS^T q'[:, 64:]. Against `flash_backward_fused_plain`: rel-L2 <= 1e-5;
against the JAX `_flash_backward_fused` in interpret mode: rel-L2 <= 1e-4.
"""

import functools
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu_torch.ops.kernels import build
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash

SOURCE = build.CSRC_DIR / "flash_attention_bwd_f32.cu"
TILE = 64        # keys per block, q rows per tile, head dim
WARPGROUPS = 2   # take the q tiles in turn
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use
# (BH, T, kv_len, causal): T below one tile; a masked tail; kv_len one key
# into a key block; causal at a ragged T and at one past 1024
CASES = [(2, 77, None, False), (2, 200, 190, False), (1, 130, 65, False), (2, 200, None, True),
         (1, 1100, None, True)]


def tf32(v):
    """fp32 -> the nearest tf32 (10 mantissa bits, ties away), in fp32."""
    bits = v.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def split(v):
    """The kernel's 3xTF32 parts: hi and lo, each rounded to nearest."""
    hi = tf32(v)
    return hi, tf32(v - hi)


def _round_toward_zero(v):
    """fp64 -> fp32, rounding toward zero (the tensor cores' accumulate)."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def product(a, b, acc=None):
    """a [..., M, K] @ b [..., K, N] as one 3xTF32 wgmma chain: per k8 slice
    a_lo b_hi, a_hi b_lo, a_hi b_hi, each added into the accumulator (zero,
    or `acc`) rounding toward zero."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    d = torch.zeros(*a.shape[:-1], b.shape[-1]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            d = _round_toward_zero(d.double() + x[..., ks].double() @ y[..., ks, :].double())
    return d


def _tiles(x, n):
    """x [BH, T, 64] as n zero-padded 64-row tiles [BH, n, 64, 64]."""
    bh, t, d = x.shape
    pad = torch.zeros(bh, n * TILE, d)
    pad[:, :t] = x
    return pad.view(bh, n, TILE, d)


def backward_schedule(q, k, v, out, lse, do, kv_len=None, causal=False, fused=False):
    """K9 (or with `fused`, K8) as the kernel schedules it: (dq, dk, dv)
    [BH, T, D] fp32, D 64 or 80."""
    bh, t, d = q.shape
    valid = kv_len or t
    n = (t + TILE - 1) // TILE
    scale = 1.0 / math.sqrt(d)
    # (q's factor, s's, ds's, dq's, dk's): K8's order or K9's
    c_q, c_s, c_ds, c_dq, c_dk = ((scale * tflash.LOG2E, 1.0, 1.0, scale, 1.0 / tflash.LOG2E)
                                  if fused else (1.0, scale * tflash.LOG2E, scale, 1.0, 1.0))
    warpgroups = WARPGROUPS if d == 64 else 1
    delta = (do * out).sum(-1)  # beside the kernel, as the wrapper computes it
    qt, dot, kt, vt = (_tiles(x, n) for x in (q * c_q, do, k, v))
    lse_t, delta_t = (_tiles(x[..., None], n)[..., 0] for x in (lse, delta))
    dq = torch.zeros(bh, n * TILE, d)
    dk = torch.zeros(bh, n * TILE, d)
    dv = torch.zeros(bh, n * TILE, d)
    rows = torch.arange(TILE)
    for kb in range((valid + TILE - 1) // TILE):
        k0 = kb * TILE
        keys = k0 + rows
        tot_k = [torch.zeros(bh, d, TILE) for _ in range(warpgroups)]
        tot_v = [torch.zeros(bh, d, TILE) for _ in range(warpgroups)]
        for w in range(warpgroups):
            tiles = list(range((kb if causal else 0) + w, n, warpgroups))
            if not tiles:
                continue
            # the warpgroup's tiles are independent until their sums: batched
            qs, dos = qt[:, tiles], dot[:, tiles]
            q_rows = torch.tensor(tiles)[:, None] * TILE + rows  # [tiles, 64]
            keep = (keys < valid)[None, None, :] & (q_rows < t)[:, :, None]
            if causal:
                keep &= keys[None, None, :] <= q_rows[:, :, None]
            s = product(qs, kt[:, kb, None].transpose(-1, -2))
            p = torch.where(keep, torch.exp2(s * c_s - lse_t[:, tiles, :, None]), torch.zeros(()))
            dp = product(dos, vt[:, kb, None].transpose(-1, -2))
            ds = p * (dp - delta_t[:, tiles, :, None]) * c_ds
            part_v = product(dos[..., :64].transpose(-1, -2), p)   # dV^T, dims 0-63
            part_k = product(qs[..., :64].transpose(-1, -2), ds)   # dK^T
            if d > 64:  # dims 64-79: the keys as rows
                part_v = torch.cat([part_v, product(p.transpose(-1, -2), dos[..., 64:])
                                    .transpose(-1, -2)], dim=-2)
                part_k = torch.cat([part_k, product(ds.transpose(-1, -2), qs[..., 64:])
                                    .transpose(-1, -2)], dim=-2)
            part_q = product(ds, kt[:, kb, None])        # dq
            for i, tile in enumerate(tiles):
                tot_v[w] = tot_v[w] + part_v[:, i]
                tot_k[w] = tot_k[w] + part_k[:, i]
                dq[:, tile * TILE:(tile + 1) * TILE] += part_q[:, i] * c_dq
        dv[:, k0:k0 + TILE] = sum(tot_v).transpose(-1, -2)
        dk[:, k0:k0 + TILE] = (sum(tot_k) * c_dk).transpose(-1, -2)
    return dq[:, :t], dk[:, :t], dv[:, :t]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(t):
    return t.float().numpy()


@functools.lru_cache(maxsize=None)
def _case(bh, t, kv_len, causal):
    """Inputs from numpy (the JAX forward's out and lse) and the schedule's
    gradients, shared by the tests of one case."""
    rng = np.random.RandomState(t + 7 * bh + (kv_len or 0) + int(causal))
    q, k, v, g = (rng.randn(bh, t, 64).astype(np.float32) for _ in range(4))
    if kv_len is not None:
        g[:, kv_len:] = 0  # as on the transformer's path
    out, lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                  jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K, save_stats=True,
                                  kv_len=kv_len)
    inputs = [torch.tensor(np.asarray(x, np.float32)) for x in (q, k, v, out)]
    inputs += [torch.tensor(np.asarray(lse)[:, :t, 0]), torch.tensor(g)]
    return (q, k, v, out, lse, g), inputs, backward_schedule(*inputs, kv_len, causal)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("FSAT_FUSED_BWD", "0")


@pytest.mark.parametrize("bh,t,kv_len,causal", CASES)
def test_schedule_matches_plain(interpret, bh, t, kv_len, causal):
    _, inputs, got = _case(bh, t, kv_len, causal)
    want = tflash.flash_backward_plain(*inputs, kv_len, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (bh, t, 64)
        assert _rel(_np(a), _np(b)) <= 1e-5, name
        if kv_len is not None:
            assert not _np(a)[:, kv_len:].any(), name


@pytest.mark.parametrize("bh,t,kv_len,causal", CASES)
def test_schedule_matches_pallas(interpret, bh, t, kv_len, causal):
    (q, k, v, out, lse, g), _, got = _case(bh, t, kv_len, causal)
    want = jfa._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
                               jnp.asarray(g), causal, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                               kv_len=kv_len)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(_np(a), b) <= 1e-4, name


@pytest.mark.parametrize("per_tile,within", [(True, True), (False, False)])
def test_dk_dv_need_fp32_totals_over_long_sequences(per_tile, within):
    """dV^T of one 64-key block over SA 2.0's 6272 q rows with softmax-sized
    P: each q tile's product added into an fp32 total (the kernel) stays
    within rel-L2 1e-6 of fp64; summed in the truncating accumulator across
    all 98 tiles it drifts past 1e-5."""
    rng = np.random.RandomState(3)
    t = 6272
    do = torch.tensor(rng.randn(t, 64).astype(np.float32))
    s = torch.tensor(rng.randn(t, 64).astype(np.float32))
    p = torch.exp(s) / 6145  # the size of a softmax's probabilities over 6145 keys
    ref = do.double().T @ p.double()
    a, b = do.T.reshape(64, t // TILE, TILE).transpose(0, 1), p.view(t // TILE, TILE, 64)
    if per_tile:
        parts, got = product(a, b), torch.zeros(64, 64)
        for part in parts:  # fp32 adds of the tiles' products, in order
            got = got + part
    else:
        got = None
        for i in range(t // TILE):
            got = product(a[i], b[i], got)
    err = ((got.double() - ref).norm() / ref.norm()).item()
    assert (err <= 1e-6) == within, err
    assert err <= 1e-4  # K9's tolerance holds either way at this length


def test_split_rounds_to_nearest_and_is_exact_to_21_bits():
    v = torch.tensor(np.random.RandomState(4).randn(4096).astype(np.float32))
    hi, lo = split(v)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((v - hi).abs() <= hi.abs() * 2.0 ** -11 + 1e-30)
    assert ((hi.double() + lo.double() - v.double()).abs() <= v.double().abs() * 2.0 ** -21).all()


def _constant(name, text):
    found = re.findall(rf"constexpr int {name} = ([^;]+);", text)
    assert len(found) == 1, name
    return found[0]


def test_launch_plan_fits_the_card():
    """The kernel's shared memory (its Layout: K, V and K^T hi/lo tiles, two
    warpgroups' q, dO and hi/lo tiles, three mbarriers, 1024 bytes of
    alignment slack) fits one block; every tile starts on a 1024-byte
    swizzle atom; a TMA box row of 32 fp32 is one 128-byte swizzle row; a
    tile's 64 dq rows of 68 floats fit its hi/lo tile pair; the grid's
    BH (gridDim.y) stays within 65535, which the wrapper checks."""
    text = SOURCE.read_text()
    assert _constant("kConsumers", text) == "2" and _constant("kKeys", text) == "64"
    assert _constant("kQ", text) == "64" and _constant("kPanel", text) == "64 * kSwizzleRow"
    tile = 64 * 32 * 4 * 2  # two panels of 64 rows x 32 fp32
    assert tile % 1024 == 0 and 32 * 4 == 128
    smem = 6 * tile + WARPGROUPS * 4 * tile + (1 + WARPGROUPS) * 8 + 1024
    assert smem == 230_424 <= SMEM_LIMIT
    assert 64 * (64 + 4) * 4 <= 2 * tile
    meta = [torch.empty(bh, 64, 64, device="meta") for bh in (65535, 65536)]
    assert tflash._cuda_args("flash_backward", meta[0], meta[0])
    with pytest.raises(ValueError, match="65535"):
        tflash._cuda_args("flash_backward", meta[1], meta[1])
    with pytest.raises(NotImplementedError, match="queue B"):  # K9 at D 80 stays to port
        tflash._cuda_args("flash_backward", torch.empty(2, 64, 80, device="meta"))


# (BH, T, D, kv_len) of K8: T below one tile; D 80 with a masked tail; kv_len
# one key into a key block at D 80; a ragged T past two tiles at D 64
K8_CASES = [(2, 77, 64, None), (2, 200, 80, 190), (1, 130, 80, 65), (2, 150, 64, 129)]


@functools.lru_cache(maxsize=None)
def _k8_case(bh, t, d, kv_len):
    """Inputs from numpy (the JAX forward's out and lse) and K8's schedule."""
    rng = np.random.RandomState(t + 5 * d + 7 * bh + (kv_len or 0))
    q, k, v, g = (rng.randn(bh, t, d).astype(np.float32) for _ in range(4))
    if kv_len is not None:
        g[:, kv_len:] = 0  # as on the transformer's path
    out, lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False,
                                  jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K, save_stats=True,
                                  kv_len=kv_len)
    inputs = [torch.tensor(np.asarray(x, np.float32)) for x in (q, k, v, out)]
    inputs += [torch.tensor(np.asarray(lse)[:, :t, 0]), torch.tensor(g)]
    return (q, k, v, out, lse, g), inputs, backward_schedule(*inputs, kv_len, fused=True)


@pytest.mark.parametrize("bh,t,d,kv_len", K8_CASES)
def test_k8_schedule_matches_plain(interpret, bh, t, d, kv_len):
    _, inputs, got = _k8_case(bh, t, d, kv_len)
    want = tflash.flash_backward_fused_plain(*inputs, kv_len)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (bh, t, d)
        assert _rel(_np(a), _np(b)) <= 1e-5, name
        if kv_len is not None:
            assert not _np(a)[:, kv_len:].any(), name


@pytest.mark.parametrize("bh,t,d,kv_len", K8_CASES)
def test_k8_schedule_matches_pallas(interpret, bh, t, d, kv_len):
    (q, k, v, out, lse, g), _, got = _k8_case(bh, t, d, kv_len)
    want = jfa._flash_backward_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
                                     jnp.asarray(g), kv_len or t)
    assert want is not None  # the JAX package's plan fits: it runs K8 here
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(_np(a), b) <= 1e-4, name


def test_k8_d80_launch_plan_fits_the_card():
    """K8 at head dim 80 (one warpgroup per block): K and V hi/lo as [64][80]
    tiles (two 128B-swizzled panels of 32 dims, two 32B-swizzled of 8), K^T
    hi/lo as 80 dims x 64 keys, the q and dO tiles, the P^T/dS^T hi/lo pair
    (which also stages the 64 dq rows of 84 floats), the 16 dims' dO^T and
    q'^T hi/lo, two mbarriers and 1024 bytes of slack fit one block; every
    panel starts on its swizzle atom; the TMA boxes are one swizzle row."""
    text = SOURCE.read_text()
    assert _constant("kD80", text) == "80" and _constant("kStageRow80", text) == "kD80 + 4"
    row_tile = 64 * 80 * 4
    kt_pair, x_pair, tail = 2 * 80 * 128 * 2, 2 * 64 * 32 * 4 * 2, 16 * 128 * 2
    smem = 4 * row_tile + kt_pair + 2 * row_tile + x_pair + 4 * tail + 2 * 8 + 1024
    assert smem == 214_032 <= SMEM_LIMIT
    assert row_tile % 1024 == 0 and 80 * 128 % 1024 == 0 and tail % 1024 == 0
    assert 64 * 32 % 256 == 0 and 32 * 4 == 128 and 8 * 4 == 32
    assert 64 * (80 + 4) * 4 <= x_pair and (80 + 4) * 4 % 16 == 0 and 80 * 4 % 16 == 0


def test_cpu_tensors_launch_nothing(interpret):
    _, inputs, _ = _case(*CASES[0])
    before = (tflash.backward_launches, tflash.causal_backward_launches)
    for causal in (False, True):
        grads = tflash.flash_backward(*inputs, causal=causal)
        assert all(g.dtype == torch.float32 and g.device.type == "cpu" for g in grads)
    assert (tflash.backward_launches, tflash.causal_backward_launches) == before
