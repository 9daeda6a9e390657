"""The schedule of the fp32 K7 on the tensor cores (csrc/flash_attention.cu:
the forward with or without its LSE, causal or not, head dims 64 and 80),
written out in plain torch at small sizes and held against the plain
version and the JAX package.

The kernel gives each block 128 q rows, two warpgroups of 64, and streams
64-key tiles through an online base-2 softmax. Per warpgroup and key tile:
S = q' K^T (q' = q * log2(e)/sqrt(D) in fp32; keys at or past kv_len set to
-inf, and on a causal warpgroup's diagonal tile the keys past each row), the
running max m and sum l, P = exp2(S - m), a product O_tile = P V of its own,
and O = O * alpha + O_tile in fp32; causal warpgroups stop at their
diagonal tile. At the end out = O / max(l, 1e-30) and lse = m + log2(max(l,
1e-30)). Both products are 3xTF32 on tensor cores whose fp32 accumulate
truncates (tests/test_torch_flash_bwd_schedule.py: `product`); P.V takes
each k8 slice's keys in the pos8 order, which leaves the slices, and so
this emulation, unchanged.

Against `flash_forward_plain` (the function in fp32): out rel-L2 <= 1e-5,
the LSE max abs <= 1e-5. Against the JAX `_flash_forward` in interpret mode
(FSAT_PALLAS_INTERPRET=1) at tests/test_torch_flash.py's tolerance: the
same. The emulation also shows why each tile's P.V is a product of its own
added into fp32 totals: summed in the truncating accumulator over SA 2.0's
6145 keys, O drifts past 1e-5. The launch plan (shared memory, the TMA
boxes, the scratch's strides) is checked against the card's limits. Inputs
come from numpy with fixed seeds.
"""

import functools
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_bwd_schedule import product

import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu_torch import pair_attention_variants as variants
from friendly_stable_audio_tools_tpu_torch.ops.kernels import build
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash

SOURCE = build.CSRC_DIR / "flash_attention.cu"
TILE = 64          # q rows per warpgroup, keys per key tile
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use
# (BH, T, D, kv_len, causal): T below one tile; a masked tail at D 80;
# kv_len one key into a key tile; causal at a ragged T and past 1024; a
# ragged T at D 80 with kv_len one key into its last tile
CASES = [(2, 77, 64, None, False), (2, 200, 80, 190, False), (1, 130, 64, 65, False),
         (2, 200, 64, None, True), (1, 1100, 64, None, True), (1, 300, 80, 257, False)]


def _padded(x, rows):
    """x [BH, T, D] zero-padded to `rows` rows."""
    pad = torch.zeros(x.shape[0], rows, x.shape[2])
    pad[:, :x.shape[1]] = x
    return pad


def forward_schedule(q, k, v, kv_len=None, causal=False):
    """The fp32 K7 as the kernel schedules it: (out [BH, T, D], lse [BH, T])."""
    bh, t, d = q.shape
    valid = kv_len or t
    n_q, n_k = (t + TILE - 1) // TILE, (valid + TILE - 1) // TILE
    qs = _padded(q * (tflash.LOG2E / math.sqrt(d)), n_q * TILE)
    kp, vp = (_padded(x[:, :n_k * TILE], n_k * TILE) for x in (k, v))
    out, lse = torch.empty(bh, n_q * TILE, d), torch.empty(bh, n_q * TILE)
    cols = torch.arange(TILE)
    for qt in range(n_q):  # one warpgroup's 64 rows
        rows = slice(qt * TILE, (qt + 1) * TILE)
        m = torch.full((bh, TILE, 1), -math.inf)
        l, o = torch.zeros(bh, TILE, 1), torch.zeros(bh, TILE, d)
        for kt in range(min(n_k, qt + 1) if causal else n_k):
            keys = slice(kt * TILE, (kt + 1) * TILE)
            s = product(qs[:, rows], kp[:, keys].transpose(-1, -2))
            mask = (kt * TILE + cols >= valid)[None, :].expand(TILE, TILE)
            if causal and kt == qt:
                mask = mask | (cols[None, :] > cols[:, None])
            s = s.masked_fill(mask, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + product(p, vp[:, keys])
            m = m_new
        den = l.clamp_min(1e-30)
        out[:, rows] = o / den
        lse[:, rows] = (m + torch.log2(den))[..., 0]
    return out[:, :t], lse[:, :t]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@functools.lru_cache(maxsize=None)
def _case(bh, t, d, kv_len, causal):
    """Inputs from numpy and the schedule's (out, lse), shared by the tests of one case."""
    rng = np.random.RandomState(t + 3 * d + 7 * bh + (kv_len or 0) + int(causal))
    q, k, v = (rng.randn(bh, t, d).astype(np.float32) for _ in range(3))
    inputs = [torch.tensor(x) for x in (q, k, v)]
    return (q, k, v), inputs, forward_schedule(*inputs, kv_len, causal)


@pytest.mark.parametrize("bh,t,d,kv_len,causal", CASES)
def test_schedule_matches_plain(bh, t, d, kv_len, causal):
    _, inputs, (out, lse) = _case(bh, t, d, kv_len, causal)
    want_out, want_lse = tflash.flash_forward_plain(*inputs, kv_len, causal=causal)
    assert out.shape == (bh, t, d) and lse.shape == (bh, t)
    assert _rel(out.numpy(), want_out.numpy()) <= 1e-5
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=0, atol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("bh,t,d,kv_len,causal", CASES)
def test_schedule_matches_pallas(interpret, bh, t, d, kv_len, causal):
    (q, k, v), _, (out, lse) = _case(bh, t, d, kv_len, causal)
    want_out, want_lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                            save_stats=True, kv_len=kv_len)
    assert _rel(out.numpy(), want_out) <= 1e-5
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :t, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("per_tile,within", [(True, True), (False, False)])
def test_o_needs_fp32_totals_over_long_sequences(per_tile, within):
    """P.V of one 64-row q tile over SA 2.0's 6145 keys (98 tiles) with
    softmax-sized P: each key tile's product added into an fp32 total (the
    kernel) stays within rel-L2 1e-6 of fp64; summed in the truncating
    accumulator across the tiles it drifts past 1e-5, K7's tolerance."""
    rng = np.random.RandomState(5)
    n = 98
    p = torch.tensor(np.exp(rng.randn(n, TILE, TILE)).astype(np.float32)) / 6145
    v = torch.tensor(rng.randn(n, TILE, 64).astype(np.float32))
    ref = torch.einsum("nij,njd->id", p.double(), v.double())
    if per_tile:
        got = torch.zeros(TILE, 64)
        for part in product(p, v):  # fp32 adds of the tiles' products, in order
            got = got + part
    else:
        got = None
        for i in range(n):
            got = product(p[i], v[i], got)
    err = ((got.double() - ref).norm() / ref.norm()).item()
    assert (err <= 1e-6) == within, err


def _slots(d: int, text: str) -> int:
    """Layout<D>::kSlots as the source (or a variant) writes it."""
    found = re.findall(r"static constexpr int kSlots = (?:D == 64 \? (\d+) : (\d+)|(\d+));", text)
    assert len(found) == 1
    d64, d80, fixed = found[0]
    return int(fixed or (d64 if d == 64 else d80))


def _constant(name: str, text: str) -> str:
    found = re.findall(rf"constexpr int {name} = ([^;]+);", text)
    assert len(found) == 1, name
    return found[0]


def _variant_texts():
    """The shipped source and each fp32 K7 variant pair_attention_variants.py builds."""
    text = SOURCE.read_text()
    texts = {"shipped": text}
    for name, (file, edits) in variants.VARIANTS.items():
        if file == SOURCE.name:
            changed = text
            for old, new in edits:
                assert changed.count(old) == 1, (name, old)
                changed = changed.replace(old, new)
            texts[name] = changed
    return texts


@pytest.mark.parametrize("d", [64, 80])
def test_launch_plan_fits_the_card(d):
    """Shared memory (q' hi/lo of two warpgroups, kSlots slots of a K or V^T
    hi/lo tile pair, two mbarriers per slot, 1024 bytes of alignment slack)
    fits one block for the shipped source and each variant; every panel
    starts on its swizzle atom; the TMA boxes are one swizzle row wide and
    at most 256 rows; the scratch's parts and rows sit on 16 bytes."""
    texts = _variant_texts()
    assert set(texts) >= {"shipped", "k7_f32_slots2", "k7_f32_turns_off"}
    text = texts["shipped"]
    assert _constant("kConsumers", text) == "2" and _constant("kN", text) == "64"
    assert _constant("kThreads", text) == "kConsumers * 128 + 32"
    tile = TILE * d * 4
    for name, changed in texts.items():
        slots = _slots(d, changed)
        smem = 2 * 2 * tile + slots * 2 * tile + 2 * slots * 8 + 1024
        assert smem <= SMEM_LIMIT, (name, smem)
    assert _slots(d, text) == {64: 4, 80: 3}[d]
    assert {64: 196_608, 80: 204_800}[d] == 2 * 2 * tile + _slots(d, text) * 2 * tile
    # panels: [64][D] tiles as 128B-swizzled 32-dim panels (8 KB) and, at D
    # 80, 32B-swizzled 8-dim panels (2 KB); V^T tiles as D rows of 32 keys
    assert tile % 1024 == 0 and 64 * 128 % 1024 == 0 and 64 * 32 % 256 == 0
    assert (d * 128) % 1024 == 0 and d <= 256
    assert 32 * 4 == 128 and 8 * 4 == 32 and (d - 64) in (0, 16)
    # the C entry lays the scratch out as the wrapper sizes it: K's two parts,
    # then V^T's, whose key stride is T rounded up to the 64-key tile
    assert "uint32_t* vparts = kparts + 2 * (size_t)BH * T * D;" in text
    assert "inline int padded_keys(int T) { return (T + kN - 1) / kN * kN; }" in text
    for bh, t in ((1, 1), (2, 77), (192, 6272), (48, 8576), (128, 1501)):
        tp = (t + 63) // 64 * 64
        k_part = bh * t * d  # floats of one K part; V^T's start after two
        assert tflash.forward_scratch_floats(bh, t, d) == 2 * k_part + 2 * bh * d * tp
        assert (2 * k_part * 4) % 16 == 0 and (d * 4) % 16 == 0 and (t * d * 4) % 16 == 0
        assert (tp * 4) % 16 == 0 and (d * tp * 4) % 16 == 0 and tp % 64 == 0


def test_cpu_tensors_launch_nothing():
    _, inputs, _ = _case(*CASES[0])
    counts = lambda: (tflash.forward_launches, tflash.serving_launches,  # noqa: E731
                      tflash.causal_forward_launches, tflash.causal_serving_launches)
    before = counts()
    for causal in (False, True):
        for stats in (False, True):
            out, lse = tflash.flash_forward(*inputs, save_stats=stats, causal=causal)
            assert out.dtype == torch.float32 and out.device.type == "cpu"
            assert (lse is not None) == stats
    assert counts() == before
