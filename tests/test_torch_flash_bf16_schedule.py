"""The schedule of the bf16 K7 (csrc/flash_attention_bf16.cu: serving, no
LSE), written out in plain torch at small sizes and held against the plain
version and the JAX package.

The kernel takes 128-row q tiles (two warpgroups of 64 rows), prescales q in
fp32 and rounds it to bf16 once, and streams key tiles of KEY_TILE keys
through an online base-2 softmax: the running max and sum in fp32, P rounded
to bf16 per tile against the running max, O rescaled in fp32. At head dim 80
every tile is two panels, dims 0-63 and 64-79: the scores sum the first
panel's four k-slices and then the second's one, and P.V is one product per
panel. Against `flash_forward_plain` (one whole-row softmax) and against the
JAX `_flash_forward` on the same bf16 inputs in interpret mode
(FSAT_PALLAS_INTERPRET=1), P's rounding against a running rather than the
final max and the fp32 sums' order may move a probability or an output one
bf16 step: rel-L2 <= 4e-3 (2^-8) and max abs <= 2^-6 of max|out|, the
tolerance of tests/test_torch_sa1_bf16.py's plain-against-Pallas check.

The launch plan (the kernel's shared-memory layout, its tensor-map boxes and
strides) is checked against the card's limits for the tiles the source
ships and for each tile variant pair_attention_variants.py builds. Inputs
come from numpy with fixed seeds.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu_torch import pair_attention_variants as variants
from friendly_stable_audio_tools_tpu_torch.ops.kernels import build
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash

BF16 = torch.bfloat16
SOURCE = build.CSRC_DIR / "flash_attention_bf16.cu"
Q_TILE = 128  # q rows per block: csrc/flash_attention_bf16.cu kM
PANEL = 64    # dims in the first (128B-swizzled) panel
# (BH, T, D, kv_len): a T below one q tile, a masked tail, the U-Net's D-80
# level, a tail past a q tile with kv_len two keys into a key tile, and
# kv_len one key into a key tile
CASES = [(2, 77, 64, None), (3, 300, 80, 290), (1, 1024, 80, None), (1, 2176, 64, 2050),
         (2, 300, 64, 257), (2, 150, 80, 129)]
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use


def _constant(name: str, text: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, name
    return int(found[0])


KEY_TILE = _constant("kN", SOURCE.read_text())


def _inputs(bh, t, d, seed):
    rng = np.random.RandomState(seed)
    return [torch.tensor(rng.randn(bh, t, d).astype(np.float32)).to(BF16) for _ in range(3)]


def _scores(qs, kt):
    """q' k^T in fp32, at head dim 80 as the kernel sums it: the first
    panel's dims, then the second's."""
    if qs.shape[-1] == PANEL:
        return qs @ kt.transpose(-1, -2)
    return (qs[..., :PANEL] @ kt[..., :PANEL].transpose(-1, -2)
            + qs[..., PANEL:] @ kt[..., PANEL:].transpose(-1, -2))


def _pv(p, vt):
    """bf16(P) V in fp32, one product per panel."""
    pb = p.to(BF16).float()
    return torch.cat([pb @ vt[..., :PANEL], pb @ vt[..., PANEL:]], dim=-1)


def forward_schedule(q, k, v, kv_len=None):
    """The kernel's schedule: out [BH, T, D] bf16 from bf16 q, k, v."""
    bh, t, d = q.shape
    valid = kv_len or t
    qs = (q.float() * (tflash.LOG2E / math.sqrt(d))).to(BF16).float()
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    for q0 in range(0, t, Q_TILE):
        qt = qs[:, q0:q0 + Q_TILE]
        m = torch.full((bh, qt.shape[1], 1), -math.inf)
        l = torch.zeros(bh, qt.shape[1], 1)
        o = torch.zeros(bh, qt.shape[1], d)
        for k0 in range(0, valid, KEY_TILE):
            k1 = min(k0 + KEY_TILE, valid)  # keys at or past kv_len: 2^-inf = 0
            s = _scores(qt, kf[:, k0:k1])
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + _pv(p, vf[:, k0:k1])
            m = m_new
        out[:, q0:q0 + Q_TILE] = (o / l.clamp_min(1e-30)).to(BF16)
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _max_frac(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("bh,t,d,kv", CASES)
def test_schedule_matches_plain(bh, t, d, kv):
    q, k, v = _inputs(bh, t, d, t + d)
    got = forward_schedule(q, k, v, kv)
    want, lse = tflash.flash_forward_plain(q, k, v, kv, save_stats=False)
    assert lse is None and got.dtype == want.dtype == BF16
    assert _rel(_np(got), _np(want)) <= 4e-3
    assert _max_frac(_np(got), _np(want)) <= 2.0 ** -6


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("bh,t,d,kv", CASES)
def test_schedule_matches_pallas(interpret, bh, t, d, kv):
    q, k, v = _inputs(bh, t, d, 7 * t + d)
    want = jfa._flash_forward(*(jnp.asarray(_np(x), jnp.bfloat16) for x in (q, k, v)), False,
                              jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K, save_stats=False,
                              kv_len=kv)
    got = forward_schedule(q, k, v, kv)
    want = np.asarray(want.astype(jnp.float32))
    assert _rel(_np(got), want) <= 4e-3
    assert _max_frac(_np(got), want) <= 2.0 ** -6


def _smem_bytes(d, key_tile, stages):
    """csrc/flash_attention_bf16.cu's Layout<D>::kSmemBytes: 1024 bytes of
    alignment slack, q' [128 rows], K and V rings of `stages` x [key_tile
    rows], each row 128 bytes (dims 0-63) plus 32 (dims 64-79) at D 80, and
    two mbarriers per stage."""
    row = 128 + 2 * (d - PANEL)
    return 1024 + Q_TILE * row + 2 * stages * key_tile * row + 2 * stages * 8


def _variant_tiles():
    """(key tile, stages) of the shipped source and of each bf16 K7 variant
    that pair_attention_variants.py builds."""
    text = SOURCE.read_text()
    tiles = {(KEY_TILE, _constant("kStages", text))}
    for file, edits in variants.VARIANTS.values():
        if file == SOURCE.name:
            changed = text
            for old, new in edits:
                changed = changed.replace(old, new)
            tiles.add((_constant("kN", changed), _constant("kStages", changed)))
    return sorted(tiles)


@pytest.mark.parametrize("d", [64, 80])
def test_launch_plan_fits_the_card(d):
    tiles = _variant_tiles()
    assert {kn for kn, _ in tiles} >= {64, 128} and {s for _, s in tiles} >= {2, 3, 4}
    for key_tile, stages in tiles:
        assert _smem_bytes(d, key_tile, stages) <= SMEM_LIMIT, (key_tile, stages)
        # every panel starts on a 1024-byte swizzle atom
        for rows in (Q_TILE, key_tile):
            assert rows * 128 % 1024 == 0 and rows * 2 * (d - PANEL) % 1024 == 0
        assert key_tile <= 256 and key_tile % 64 == 0  # a TMA box's rows; 64-key score chunks
    # the boxes: 64 bf16 = one 128-byte swizzle row, 16 bf16 = one 32-byte row;
    # the tensor maps' global strides (a row, a head) are multiples of 16 bytes
    assert PANEL * 2 == 128 and (d - PANEL) * 2 in (0, 32)
    for t in (1, 77, 1024, 8576):
        assert d * 2 % 16 == 0 and t * d * 2 % 16 == 0
    shipped = (KEY_TILE, _constant("kStages", SOURCE.read_text()))
    assert shipped == (128, 3)
    assert _smem_bytes(d, *shipped) == {64: 115_760, 80: 144_432}[d]


def test_cpu_tensors_launch_nothing():
    q, k, v = _inputs(2, 77, 80, 1)
    before = tflash.serving_bf16_launches
    out, lse = tflash.flash_forward(q, k, v, None, save_stats=False)
    assert tflash.serving_bf16_launches == before and lse is None and out.dtype == BF16
