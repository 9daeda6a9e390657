"""The adaLN DiT block's fused elementwise sites: LayerNorm + modulate (K11)
and the gated residual (K12).

Replaces friendly_stable_audio_tools_tpu/ops/pallas/elementwise.py:
``_lnmod_forward`` (:98; ``_lnmod_kernel`` :88, pallas_call :102) and
``_gres_forward`` (:167; ``_gres_kernel`` :161, pallas_call :171), which the
JAX package's adaLN ``TransformerBlock`` runs at each of its four sites
per layer when its fused-elementwise switch (FSAT_FUSED_EW) is on:

* :func:`ln_modulate` ``(x, gamma, scale, shift)``: LayerNorm(x; gamma) *
  (1 + scale) + shift;
* :func:`gated_residual` ``(y, gate, residual)``: y * sigmoid(1 - gate) +
  residual.

Each call takes the kernel inside the JAX gate (``_eligible`` :55-60:
3-D bf16 activations with bf16 adaLN vectors, D % 128 == 0, D <= 4096, the
shift or residual in the activation dtype) with the switch on; outside it,
or with the switch off, the plain chain runs, as in JAX. Inside the gate a
CUDA tensor launches the kernel (csrc/elementwise.cu) or the call raises,
and a CPU tensor takes the plain chain (:func:`ln_modulate_plain`,
:func:`gated_residual_plain`, transcribed from ``_lnmod_xla`` :76 and
``_gres_xla`` :157). The plain chain and the kernels round at different
points: the chain computes the sigmoid in the gate's bf16, the kernel in
fp32, as in JAX. :func:`ln_modulate_kernel_math` and
:func:`gated_residual_kernel_math` compute the Pallas kernels' own order of
fp32 math and bf16 roundings, for holding the CUDA kernels to them.

Each kernel's autograd binding launches it in the forward and
differentiates the plain chain in the backward, as the JAX custom_vjps
recompute through XLA (:119-135, :185-201); no backward kernel exists.
K11's launch (grid, warps a block, staged batch rows) is planned here by
:func:`lnmod_plan` from the card's SM count and passed to its C entry.
What bounds the kernels on the H100 and what their design does about it:
csrc/elementwise.cu.
"""

from __future__ import annotations

import functools
import typing as tp

import torch

from . import build
from .autograd import plain_grads

# launch counts: each wrapper adds one where it launches its kernel
lnmod_launches = 0  # K11
gres_launches = 0  # K12

MAX_DIM = 4096
EPS = 1e-5

# K11's launch plan (csrc/elementwise.cu): the card's per-SM limits
LN_WARPS = 8  # warps a block
H100_SMS = 132
SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block may use (227 KB)
SMEM_PER_SM = 233_472  # and an SM holds (228 KB), 1 KB of it reserved per block
SMEM_RESERVED = 1024


class LnmodPlan(tp.NamedTuple):
    """K11's launch: `grid` blocks of `warps` warps; a lane group of `lanes`
    lanes (32, or 16 at D 128) owns one row at a time, each lane `vectors`
    16-byte vectors of it; each block stages gamma (fp32) and the scale and
    shift rows (bf16) of up to `slots` batch indices in `smem` bytes of
    shared memory."""
    grid: int
    warps: int
    lanes: int
    vectors: int
    slots: int
    smem: int


def lnmod_warps_per_sm(vectors: int) -> int:
    """Warps an SM holds of K11 with `vectors` vectors a lane: its launch
    bounds keep it to 64 registers a thread up to 4 vectors, 80 up to 6,
    128 up to 11 and 255 above."""
    return 32 if vectors <= 4 else 24 if vectors <= 6 else 16 if vectors <= 11 else 8


@functools.lru_cache(maxsize=256)
def lnmod_plan(rows: int, t: int, d: int, sm_count: int) -> LnmodPlan:
    """K11's launch for `rows` = B * T rows of width `d` on a card of
    `sm_count` SMs.

    The grid is what the card holds at once (by the warps the kernel's
    registers allow an SM and by shared memory), or one block a row where
    there are fewer rows, so every row is requested in one wave. The kernel
    splits the rows evenly over the blocks in contiguous runs (block b
    takes rows // grid rows, one more where b < rows % grid) and each
    block's over its lane groups alike, so a block's n rows span at most
    (n + t - 2) // t + 1 batch indices, and `slots` covers that span
    wherever shared memory allows."""
    lanes = min(32, d // 8)
    vectors = -(-d // (8 * lanes))
    by_regs = lnmod_warps_per_sm(vectors) // LN_WARPS
    grid = min(rows, sm_count * by_regs)
    while True:
        n = -(-rows // grid)  # the most rows a block takes
        slots = min(rows // t, (n + t - 2) // t + 1)
        slots = min(slots, SMEM_PER_BLOCK // (4 * d) - 1)
        smem = 4 * d * (1 + slots)
        fits = sm_count * min(by_regs, SMEM_PER_SM // (smem + SMEM_RESERVED))
        if grid <= fits:
            return LnmodPlan(grid, LN_WARPS, lanes, vectors, slots, smem)
        grid = fits


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of `device`'s card; off a card (meta tensors) those of the
    H100 SXM the kernels are built for."""
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def eligible(x: torch.Tensor, vec: torch.Tensor, other: torch.Tensor) -> bool:
    """The JAX gate (``_eligible`` :55-60 and the callers' dtype checks):
    x [B, T, D] bf16 with D % 128 == 0 and D <= 4096, the adaLN vector
    `vec` bf16, and `other` (the shift, or the residual) in x's dtype."""
    return (x.dim() == 3 and x.shape[-1] % 128 == 0 and x.shape[-1] <= MAX_DIM
            and x.dtype == torch.bfloat16 and vec.dtype == torch.bfloat16
            and other.dtype == x.dtype)


def ln_modulate_plain(x: torch.Tensor, gamma: tp.Optional[torch.Tensor], scale: torch.Tensor,
                      shift: torch.Tensor) -> torch.Tensor:
    """The chain of JAX ``_lnmod_xla``: LayerNorm in fp32 (eps 1e-5, no
    bias), gamma in fp32, cast to x's dtype, then ``y * (1 + scale) +
    shift`` in the operands' dtypes."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + EPS)
    if gamma is not None:
        y = y * gamma
    y = y.to(x.dtype)
    return y * (1 + scale) + shift


def gated_residual_plain(y: torch.Tensor, gate: torch.Tensor,
                         residual: torch.Tensor) -> torch.Tensor:
    """The chain of JAX ``_gres_xla``: ``y * sigmoid(1 - gate) + residual``
    in the operands' dtypes (the sigmoid in the gate's)."""
    return y * torch.sigmoid(1 - gate) + residual


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def ln_modulate_kernel_math(x: torch.Tensor, gamma: tp.Optional[torch.Tensor],
                            scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """K11's arithmetic as the Pallas kernel orders it (``_lnmod_kernel``
    :88-95): the mean and the centred variance in fp32, rsqrt, gamma in
    fp32, a bf16 rounding, then 1 + scale, the product and the sum each
    rounded to bf16. bf16 in, bf16 out."""
    x32 = x.float()
    xc = x32 - x32.mean(-1, keepdim=True)
    y = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + EPS)
    if gamma is not None:
        y = y * gamma.float()
    y = _bf16(y)
    return (_bf16(y * _bf16(1 + scale.float())) + shift.float()).to(torch.bfloat16)


def gated_residual_kernel_math(y: torch.Tensor, gate: torch.Tensor,
                               residual: torch.Tensor) -> torch.Tensor:
    """K12's arithmetic as the Pallas kernel orders it (``_gres_kernel``
    :161-164): the sigmoid and the product in fp32, one bf16 rounding, then
    the bf16 sum with the residual."""
    g = torch.sigmoid(1.0 - gate.float())
    return (_bf16(y.float() * g) + residual.float()).to(torch.bfloat16)


def _vector(v: torch.Tensor, b: int, d: int, name: str) -> tp.Tuple[torch.Tensor, int]:
    """An adaLN vector [B, 1, D] as the kernels read it, with its batch
    stride in elements: read in place where its rows are unit-strided and
    16-byte aligned (the DiT's chunks of one projection), else copied."""
    if tuple(v.shape) != (b, 1, d):
        raise ValueError(f"{name}: expected [{b}, 1, {d}], got {list(v.shape)}")
    stride = v.stride(0) if b > 1 else d
    if v.stride(-1) != 1 or v.data_ptr() % 16 or stride % 8:
        v = v.contiguous()
        stride = d
    return v, stride


def _activation(t: torch.Tensor, shape: torch.Size, name: str) -> torch.Tensor:
    if t.shape != shape:
        raise ValueError(f"{name}: expected {list(shape)}, got {list(t.shape)}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte aligned rows")
    return t


def _check_cuda(name: str, x: torch.Tensor, *others: tp.Optional[torch.Tensor]) -> None:
    if x.dim() != 3 or x.dtype != torch.bfloat16 or x.shape[-1] % 128 or x.shape[-1] > MAX_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes bf16 [B, T, D] with D % 128 == 0 and "
                         f"D <= {MAX_DIM}, got {x.dtype} {list(x.shape)}")
    if any(t is not None and t.device != x.device for t in others):
        raise ValueError(f"{name}: all tensors must be on {x.device}")


def _lnmod_args(x, gamma, scale, shift):
    """K11's arguments as its C entry reads them, checked, with tensors in
    place of pointers: (x, gamma, gamma_kind, scale, scale_stride, shift,
    shift_stride). The DiT's scale and shift are read in place."""
    _check_cuda("ln_modulate", x, gamma, scale, shift)
    b, t, d = x.shape
    x = _activation(x, x.shape, "ln_modulate x")
    if scale.dtype != torch.bfloat16 or shift.dtype != torch.bfloat16:
        raise TypeError(f"ln_modulate: the CUDA kernel takes bf16 scale and shift, got "
                        f"{scale.dtype}, {shift.dtype}")
    scale, scale_stride = _vector(scale, b, d, "ln_modulate scale")
    shift, shift_stride = _vector(shift, b, d, "ln_modulate shift")
    kind = 0
    if gamma is not None:
        kinds = {torch.float32: 1, torch.bfloat16: 2}
        if gamma.dtype not in kinds or tuple(gamma.shape) != (d,):
            raise TypeError(f"ln_modulate: gamma must be fp32 or bf16 [{d}], got {gamma.dtype} "
                            f"{list(gamma.shape)}")
        gamma = gamma.contiguous()
        if gamma.data_ptr() % 16:
            gamma = gamma.clone()
        kind = kinds[gamma.dtype]
    return x, gamma, kind, scale, scale_stride, shift, shift_stride


def _launch_ln_modulate(x, gamma, scale, shift):
    global lnmod_launches
    x, gamma, kind, scale, scale_stride, shift, shift_stride = _lnmod_args(x, gamma, scale, shift)
    b, t, d = x.shape
    plan = lnmod_plan(b * t, t, d, sm_count(x.device))
    out = torch.empty_like(x)
    err = build.library().fsat_ln_modulate(
        x.data_ptr(), None if gamma is None else gamma.data_ptr(), kind, scale.data_ptr(),
        shift.data_ptr(), scale_stride, shift_stride, out.data_ptr(), b * t, t, d, plan.grid,
        plan.warps, plan.slots, torch.cuda.current_stream(x.device).cuda_stream)
    lnmod_launches += 1
    build.check(err, "ln_modulate")
    return out


def _launch_gated_residual(y, gate, residual):
    global gres_launches
    _check_cuda("gated_residual", y, gate, residual)
    b, t, d = y.shape
    y = _activation(y, y.shape, "gated_residual y")
    residual = _activation(residual, y.shape, "gated_residual residual")
    if gate.dtype != torch.bfloat16:
        raise TypeError(f"gated_residual: the CUDA kernel takes a bf16 gate, got {gate.dtype}")
    gate, gate_stride = _vector(gate, b, d, "gated_residual gate")
    out = torch.empty_like(y)
    err = build.library().fsat_gated_residual(
        y.data_ptr(), gate.data_ptr(), gate_stride, residual.data_ptr(), out.data_ptr(), b * t, t,
        d, torch.cuda.current_stream(y.device).cuda_stream)
    gres_launches += 1
    build.check(err, "gated_residual")
    return out


class LnModulate(torch.autograd.Function):
    """K11 forward; the backward differentiates :func:`ln_modulate_plain`."""

    @staticmethod
    def forward(ctx, x, gamma, scale, shift):
        ctx.save_for_backward(x, gamma, scale, shift)
        return _launch_ln_modulate(x, gamma, scale, shift)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_grads(ln_modulate_plain, ctx.saved_tensors, ctx.needs_input_grad,
                           grad_out)


class GatedResidual(torch.autograd.Function):
    """K12 forward; the backward differentiates :func:`gated_residual_plain`."""

    @staticmethod
    def forward(ctx, y, gate, residual):
        ctx.save_for_backward(y, gate, residual)
        return _launch_gated_residual(y, gate, residual)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_grads(gated_residual_plain, ctx.saved_tensors, ctx.needs_input_grad,
                           grad_out)


def ln_modulate(x: torch.Tensor, gamma: tp.Optional[torch.Tensor], scale: torch.Tensor,
                shift: torch.Tensor, enabled: bool = True) -> torch.Tensor:
    """LayerNorm(x; gamma) * (1 + scale) + shift. x [B, T, D]; gamma [D] or
    None (the fix_scale LayerNorm); scale and shift [B, 1, D]. `enabled` is
    the fused-elementwise switch; see the module docstring for the route."""
    if not (enabled and eligible(x, scale, shift)) or x.device.type == "cpu":
        return ln_modulate_plain(x, gamma, scale, shift)
    return LnModulate.apply(x, gamma, scale, shift)


def gated_residual(y: torch.Tensor, gate: torch.Tensor, residual: torch.Tensor,
                   enabled: bool = True) -> torch.Tensor:
    """y * sigmoid(1 - gate) + residual. y and residual [B, T, D]; gate
    [B, 1, D]. `enabled` is the fused-elementwise switch; see the module
    docstring for the route."""
    if not (enabled and eligible(y, gate, residual)) or y.device.type == "cpu":
        return gated_residual_plain(y, gate, residual)
    return GatedResidual.apply(y, gate, residual)
