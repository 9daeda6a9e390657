"""K11's launch plan (`lnmod_plan` in ops/kernels/elementwise.py) and its
schedule (csrc/elementwise.cu), written out in plain torch at small sizes.

The kernel splits the B * T rows evenly over the grid's blocks and each
block's over its lane groups (a warp, or a half-warp at D 128), in
contiguous runs: block b takes rows // grid rows, one more where b < rows %
grid, and its groups split them alike. Each block stages gamma and the scale
and shift rows of the batch indices its rows span, up to the plan's
`slots`, in shared memory; a row beyond them reads its vectors from global
memory. Within a row each of the group's lanes holds `vectors` 16-byte
vectors (columns (v * lanes + lane) * 8 + e), sums its elements in four
chains (one per 32-bit word of its vectors), and the group sums the lanes'
partials by an xor butterfly of shuffles.

The plan is held to what the kernel needs over B 1-8, T 1-8448 and D
128-4096 (hypothesis) and at the adaLN DiT's shapes: every row in exactly
one group, no row at or past B * T, each block's batch span within its
staged slots, shared memory within the 227 KB a block may use, and a grid
that the card holds at once (132 SMs, by threads, registers and shared
memory). The emulated kernel, fed the arguments the wrapper passes (the
DiT's scale and shift read in place at batch stride 6D, or contiguous
copies at stride D), is held against `ln_modulate_kernel_math` within one
bf16 rounding (rel-L2 1e-3, max abs 2^-7 of max |out|: fp32 sums in
another order may move a result across one rounding), bit for bit between
strided and contiguous vectors and between plans. No JAX: the kernel's
arithmetic is held against the JAX package in tests/test_torch_adaln.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from friendly_stable_audio_tools_tpu_torch.ops.kernels import elementwise as ew

BF16 = torch.bfloat16
SM_COUNT = 132  # H100 SXM
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32


def _starts(plan, rows):
    """The first row of each lane group, and `rows` after the last: block
    b takes rows // grid rows, one more where b < rows % grid, and its
    groups split them alike."""
    groups = plan.warps * (32 // plan.lanes)
    b = np.arange(plan.grid, dtype=np.int64)
    first = b * (rows // plan.grid) + np.minimum(b, rows % plan.grid)
    b_rows = rows // plan.grid + (b < rows % plan.grid)
    j = np.arange(groups, dtype=np.int64)
    starts = (first[:, None] + j * (b_rows // groups)[:, None]
              + np.minimum(j, (b_rows % groups)[:, None]))
    return np.append(starts.reshape(-1), rows)


def _check_plan(b, t, d, covered=True):
    rows = b * t
    plan = ew.lnmod_plan(rows, t, d, SM_COUNT)
    groups = plan.warps * (32 // plan.lanes)
    # each lane's vectors cover the row, and none lies wholly past it
    assert plan.lanes * plan.vectors * 8 >= d > plan.lanes * (plan.vectors - 1) * 8
    assert 1 <= plan.warps <= 8 and plan.vectors <= 16
    starts = _starts(plan, rows)
    counts = np.diff(starts)
    # every row in exactly one group, no row at or past B * T
    assert starts[0] == 0 and starts[-1] == rows and (counts >= 0).all()
    owner = np.repeat(np.arange(len(counts)), counts)
    assert len(owner) == rows and (np.bincount(owner, minlength=len(counts)) == counts).all()
    # the rows are split evenly: blocks' and a block's groups' run lengths
    # differ by at most one
    per_block = counts.reshape(plan.grid, groups).sum(1)
    assert per_block.max() - per_block.min() <= 1
    assert (np.ptp(counts.reshape(plan.grid, groups), axis=1) <= 1).all()
    # each block's rows span the batch indices it stages
    first, end = starts[:-1:groups], starts[groups::groups]
    busy = end > first
    span = (end[busy] - 1) // t - first[busy] // t + 1
    assert span.max() <= plan.slots or not covered
    # shared memory: gamma in fp32 and the slots' scale and shift rows in
    # bf16, within a block's 227 KB
    assert plan.smem == 4 * d * (1 + plan.slots) <= ew.SMEM_PER_BLOCK
    # the grid is what 132 SMs hold at once
    per_sm = min(THREADS_PER_SM // (32 * plan.warps), BLOCKS_PER_SM,
                 ew.lnmod_warps_per_sm(plan.vectors) // plan.warps,
                 ew.SMEM_PER_SM // (plan.smem + ew.SMEM_RESERVED))
    assert 1 <= plan.grid <= SM_COUNT * per_sm
    return plan, counts


@settings(max_examples=400, deadline=None, database=None, derandomize=True)
@given(b=st.integers(1, 8), t=st.integers(1, 8448), d=st.integers(1, 32).map(lambda k: 128 * k))
def test_plan_covers_every_row_once_within_the_card(b, t, d):
    _check_plan(b, t, d)


@pytest.mark.parametrize("b,t", [(2, 1024), (3, 777)])
def test_plan_at_the_dit_shapes_requests_every_row_in_one_wave(b, t):
    """The adaLN DiT's [2, 1024, 1536] (CFG batch 2) and [3, 777, 1536]:
    one row a warp at most, all of a call's rows in one wave, the grid
    filling the card's 24 warps an SM, each block's rows in at most two
    batch indices."""
    d = 1536
    plan, counts = _check_plan(b, t, d)
    assert (plan.lanes, plan.vectors, plan.slots) == (32, 6, 2)
    assert counts.max() == 1 and plan.grid * plan.warps == SM_COUNT * 24


@pytest.mark.parametrize("b,t,d", [(4096, 2, 2048), (100_000, 1, 4096), (20_000, 1, 1024)])
def test_plan_where_shared_memory_binds(b, t, d):
    """Many batch rows of a few tokens: a block's rows span more batch
    indices than 227 KB of shared memory stages, so the plan stages what
    fits (the other rows read their vectors from global memory) and sizes
    the grid to the blocks that shared memory lets an SM hold."""
    plan, _ = _check_plan(b, t, d, covered=False)
    assert plan.smem + 4 * d > ew.SMEM_PER_BLOCK
    assert plan.grid == SM_COUNT * (ew.SMEM_PER_SM // (plan.smem + ew.SMEM_RESERVED))


def _bf16(t):
    return t.to(BF16).float()


def emulate(x, gamma, kind, scale, scale_stride, shift, shift_stride, plan):
    """K11 as csrc/elementwise.cu computes it under `plan`, from the
    arguments the wrapper passes (tensors in place of pointers): the rows
    each group takes, each block's staged vectors (read at b * stride from
    the vectors' storage), each lane's partial sums in the kernel's order,
    the butterfly, then the bf16 modulate. Asserts that every row is
    written exactly once."""
    b, t, d = x.shape
    rows, lanes, nv = b * t, plan.lanes, plan.vectors
    groups = plan.warps * (32 // lanes)
    starts = torch.from_numpy(_starts(plan, rows))
    owner = torch.repeat_interleave(torch.arange(len(starts) - 1), starts.diff())
    assert len(owner) == rows  # every row taken once
    block = owner // groups
    first, end = starts[block * groups], starts[(block + 1) * groups]
    b_first = first // t
    staged = torch.clamp((end - 1) // t - b_first + 1, max=plan.slots)
    batch = torch.arange(rows) // t
    slot = batch - b_first
    # a staged row is the copy of storage row b_first + slot, else the row read in place
    src = torch.where(slot < staged, b_first + slot, batch)
    vec = lambda v, stride: torch.as_strided(v, (b, d), (stride, 1))[src].float()  # noqa: E731
    sc, sh = vec(scale, scale_stride), vec(shift, shift_stride)
    g = torch.ones(d) if kind == 0 else gamma.float()

    width = nv * lanes * 8
    xp = torch.zeros(rows, width)
    xp[:, :d] = x.reshape(rows, d).float()
    xl = xp.view(rows, nv, lanes, 8)
    valid = (torch.arange(width) < d).view(nv, lanes, 8)
    lane_idx = torch.arange(lanes)

    def butterfly(part):
        o = lanes // 2
        while o:
            part = part + part[:, lane_idx ^ o]
            o //= 2
        return part[:, :1]

    def lane_sum(term):
        """Each lane's sum of term(v, e) over its vectors: four chains, one
        per 32-bit word k (elements 2k, 2k + 1 of each vector in turn)."""
        part = [torch.zeros(rows, lanes) for _ in range(4)]
        for v in range(nv):
            for e in range(8):
                part[e // 2] = part[e // 2] + term(v, e)
        return (part[0] + part[1]) + (part[2] + part[3])

    mean = butterfly(lane_sum(lambda v, e: xl[:, v, :, e])) / d

    def centred_sq(v, e):
        dv = xl[:, v, :, e] - mean
        return torch.where(valid[v, :, e], dv * dv, torch.zeros(()))

    rstd = torch.rsqrt(butterfly(lane_sum(centred_sq)) / d + ew.EPS)
    y = _bf16((xp[:, :d] - mean) * rstd * g)
    out = _bf16(y * _bf16(1.0 + sc)) + sh
    return out.to(BF16).view(b, t, d)


def _inputs(b, t, d, gamma_kind, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32) * 2 + 0.5).to(BF16)
    proj = torch.from_numpy(rng.randn(b, 1, 6 * d).astype(np.float32) * 0.3).to(BF16)
    scale, shift = proj.chunk(6, dim=-1)[:2]  # the DiT's chunks: batch stride 6D
    gamma = None
    if gamma_kind is not None:
        gamma = torch.from_numpy(1 + rng.randn(d).astype(np.float32) * 0.1).to(
            BF16 if gamma_kind == "bf16" else torch.float32)
    return x, gamma, scale, shift


def _one_rounding(got, want):
    got, want = got.float(), want.float()
    assert ((got - want).norm() / want.norm()).item() < 1e-3
    assert (got - want).abs().max() <= 2.0 ** -7 * want.abs().max()


# (B, T, D, gamma): two rows a warp at D 128 (T 1, 77, 1025), a lane's last
# vector past the row at D 384 and 640, the DiT's width with each gamma,
# D 4096, T 1 (a block's rows in eight batch indices), a block split across
# a batch boundary (T 13 with 8 rows a block)
CASES = [(2, 1, 128, "fp32"), (3, 77, 128, None), (1, 1025, 128, "bf16"), (3, 50, 384, "bf16"),
         (2, 33, 640, None), (2, 40, 1536, "bf16"), (2, 40, 1536, None), (3, 13, 1536, "fp32"),
         (1, 20, 4096, "bf16"), (8, 1, 256, "fp32")]


@pytest.mark.parametrize("b,t,d,gamma", CASES)
def test_wrapper_arguments_in_place_match_contiguous_copies(b, t, d, gamma):
    x, g, scale, shift = _inputs(b, t, d, gamma, seed=b * 1000 + t + d)
    args = ew._lnmod_args(x, g, scale, shift)
    xa, ga, kind, sc, sc_stride, sh, sh_stride = args
    # the DiT's chunks are read in place at their batch stride, 6D
    assert sc.data_ptr() == scale.data_ptr() and sh.data_ptr() == shift.data_ptr()
    assert sc_stride == sh_stride == (6 * d if b > 1 else d)
    assert kind == {None: 0, "fp32": 1, "bf16": 2}[gamma]
    copies = ew._lnmod_args(x, g, scale.contiguous(), shift.contiguous())
    assert copies[4] == copies[6] == d
    plan = ew.lnmod_plan(b * t, t, d, SM_COUNT)
    got = emulate(*args, plan)
    assert torch.equal(got, emulate(*copies, plan))
    _one_rounding(got, ew.ln_modulate_kernel_math(x, g, scale, shift))
    # any plan computes the same: other warps a block, one block, nothing staged
    for other in (plan._replace(warps=4), plan._replace(warps=1), plan._replace(grid=1),
                  plan._replace(slots=0), plan._replace(grid=3, slots=1)):
        assert torch.equal(emulate(*args, other), got)


def test_vectors_that_are_not_16_byte_rows_are_copied():
    """A vector the kernel cannot read in place (not unit-strided, or its
    rows off 16 bytes) is passed as a contiguous copy at stride D."""
    b, t, d = 2, 4, 256
    x, g, scale, shift = _inputs(b, t, d, "fp32", seed=7)
    odd = torch.zeros(b, 1, d + 1, dtype=BF16)[..., 1:]  # rows start 2 bytes in
    odd.copy_(scale)
    args = ew._lnmod_args(x, g, odd, shift)
    assert args[3].data_ptr() != odd.data_ptr() and args[4] == d
    assert torch.equal(emulate(*args, ew.lnmod_plan(b * t, t, d, SM_COUNT)),
                       emulate(*ew._lnmod_args(x, g, scale, shift),
                               ew.lnmod_plan(b * t, t, d, SM_COUNT)))


def test_plan_holds_the_warps_the_kernels_launch_bounds_allow():
    """`lnmod_warps_per_sm` is what csrc/elementwise.cu's launch bounds
    give each instantiation (NV <= a ? m : ...: at least m blocks of
    kMaxLnThreads threads an SM), and the plan's blocks fit those threads."""
    import re

    from friendly_stable_audio_tools_tpu_torch.ops.kernels import build

    text = (build.CSRC_DIR / "elementwise.cu").read_text()
    threads = int(re.search(r"constexpr int kMaxLnThreads = (\d+);", text).group(1))
    bounds = re.search(r"__launch_bounds__\(kMaxLnThreads, ([^)]*)\)\nln_modulate_kernel",
                       text).group(1)
    tiers = [(int(a), int(m)) for a, m in re.findall(r"NV <= (\d+) \? (\d+)", bounds)]
    last = int(bounds.rsplit(":", 1)[1])
    assert ew.LN_WARPS * 32 <= threads
    for nv in range(1, 17):
        blocks = next((m for a, m in tiers if nv <= a), last)
        assert ew.lnmod_warps_per_sm(nv) == blocks * threads // 32, nv
