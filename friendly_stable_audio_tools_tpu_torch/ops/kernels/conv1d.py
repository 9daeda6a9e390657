"""Fused snake -> conv kernels of the Oobleck VAE (K2, K3, K4).

Each public function takes channels-last tensors ``[B, T, C]`` and runs
either a CUDA kernel or its plain PyTorch version: the plain version for a
tensor on the CPU, a kernel for a tensor on a CUDA device, where the wrapper
raises on anything the kernel does not take. Nothing falls back from the
kernel to the plain version.

Under grad the kernels carry the gradient as the JAX package's do (its
custom_vjp launches the Pallas forward and differentiates the plain XLA
form, conv1d.py:150-163, 389-409, 548-561): where grad mode is on and an
input requires grad, each wrapper runs an autograd Function
(:class:`SnakeConv1d`, :class:`FusedResidualUnit`,
:class:`SnakeConvTranspose1d`) whose forward launches the kernel and saves
only its inputs (x, the weight-normed w, the bias, the effective snake
parameters), and whose backward re-runs the plain version on them under
autograd. Otherwise (a frozen encode, a decode) the kernel runs alone and
nothing is saved. The kernels' launch counts are the same either way.

Numerics of both paths follow the Pallas kernels they replace
(friendly_stable_audio_tools_tpu/ops/pallas/conv1d.py): snake in fp32 with
the polynomial sin^2 (:37-57), rounded to the model dtype before the
products (:67-70), fp32 accumulation, bias in fp32, one rounding at the end.
The kernels dispatch on the activation dtype as the Pallas kernels compute
in it: bf16 activations run the bf16 kernels; fp32 activations (an fp32
model, which is what the reference runs unless a config sets `model_half`)
run fp32 kernels that round nothing. The fp32 tensor-core products are
3xTF32 (each operand split into two TF32 parts, three products), which
keeps fp32 accuracy; 1xTF32 would keep ~3 digits.

What bounds them on the H100, and what the design does about it:

* K2 ``snake_conv1d`` (replaces ``_forward``/``_kernel``, conv1d.py:91, :60)
  takes one of two kernels by shape alone (:func:`conv_route`). Its wide
  convolutions (the DAC's residual k7 and 1x1 convs at 96-1536 channels,
  the Oobleck's 64 -> 2048 and 2048 -> 128, the SEANet's) are GEMMs over
  taps, bound by tensor-core work: they run the wgmma kernel of
  ``csrc/conv_wgmma.cu`` (TMA-fed 128 x N tiles, N | Cout up to 256,
  :func:`conv_tile_n`), bf16 or 3xTF32. Its thin convolutions take
  ``csrc/conv1d.cu``, one of three kernels by shape and dtype
  (:func:`thin_design`).
  Thin-out (Cout 1 or 2: the decoders' conv_out, bound by reading x once):
  Z = snake(x) W over the K * Cout (tap, output) columns, one product with
  no tap shift on the tensor cores (mma.sync, bf16 or 3xTF32, N padded to 8
  or 16, not to a 32-wide tile), x streamed by cp.async and snaked once,
  then each output the sum of its K taps' Z columns. Thin-in (Cin 1 or 2:
  the encoders' conv_in, bound by writing y), in bf16 one 16-deep product of
  each row's K * Cin taps on the tensor cores, the x rows staged once as
  bf16 pairs and each warp's output tile written with 16-byte stores; in
  fp32 (and at every other thin shape) on the CUDA cores: a block's x rows
  and halo staged once, the weights of all Cout in shared memory, each
  thread 16 rows of a 16-byte output vector (the real K * Cin products
  only).
* K3 ``fused_residual_unit`` (replaces ``_ru_forward``/``_ru_kernel``,
  conv1d.py:507, :473). Bound by tensor-core work (16 C^2 products per row:
  ~137 GFLOP per unit at C = 1024); Hopper gives a block 227 KB of shared
  memory against the TPU's multi-MB VMEM. ``csrc/residual_unit.cu`` takes
  one of two routes by (C, dtype) alone (:func:`ru_route`). Fused, bf16 C
  128: per 64-channel chunk one TMA box of x with its 6*dilation halo,
  snaked once and read by all seven taps at their row offsets (A by
  ldmatrix), the taps' K-major weights through a TMA ring, ``h`` kept in
  shared memory as stage 2's A operand (:func:`ru_plan` cuts the shared
  memory). Split, every other shape: a pass snakes x once, the wgmma conv
  kernel writes ``h`` to a scratch with its epilogue, and a GEMM adds the
  residual.
* K4 ``snake_conv_transpose1d`` (replaces ``_upk_forward``/``_upk_kernel``,
  conv1d.py:262, :228). Polyphase: each output phase is a two-tap product
  of x[q] with x[q-1] or x[q+1], so it is the same tap-list GEMM as K2's
  wide route, in the same kernel: a block computes one phase for a 128-row
  q tile and writes its rows of the interleaved output; no zero-stuffed
  input is ever formed.

The TPU package sends some decoder shapes to plain XLA for lack of VMEM
(``_upk_gemm`` for cin 2048/1024, ``_ru_xla`` for C = 1024). Hopper has no
such limit at these shapes: every decoder shape runs the kernels.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from . import build
from .autograd import plain_grads

# launch counts: each wrapper adds one where it launches its kernel (the
# bf16 kernels, then the fp32 ones); K2 counts its thin route
# (snake_conv1d_*) and its wide route (snake_conv1d_wide_*) apart
snake_conv1d_launches = 0
snake_conv1d_wide_launches = 0
fused_residual_unit_launches = 0
snake_conv_transpose1d_launches = 0
snake_conv1d_f32_launches = 0
snake_conv1d_wide_f32_launches = 0
fused_residual_unit_f32_launches = 0
snake_conv_transpose1d_f32_launches = 0

# the wgmma kernel's Cout tile widths, widest first (csrc/conv_wgmma.cu:
# dispatch); bf16 up to 256 columns, fp32 up to 128 (its tensor-core partial
# sum and fp32 total both live in registers)
TILE_N = {torch.bfloat16: (256, 192, 128, 96, 64, 32), torch.float32: (128, 96, 64, 32)}
# fp32: stages (32 input channels of one tap each) per tensor-core partial
# sum before it is added into the fp32 total (csrc/conv_wgmma.cu)
F32_FLUSH = 2

# K2's thin-out design (csrc/conv1d.cu, thin_out_kernel): at most
# THIN_OUT_MAX_N (tap, output) columns of Z (four n8 tiles), Cin up to
# THIN_OUT_MAX_CIN (B^T and Z in one block's shared memory) and a halo
# (k - 1) * dilation up to THIN_OUT_MAX_HALO
THIN_OUT_MAX_N = 32
THIN_OUT_MAX_CIN = {torch.bfloat16: 1024, torch.float32: 256}
THIN_OUT_MAX_HALO = 256
# K2's bf16 thin-in design (thin_in_kernel): up to 16 n8 tiles of outputs
THIN_IN_MAX_COUT = 128
# the C entry's design numbers (csrc/conv1d.cu: thin_entry)
THIN_DESIGNS = {"cuda_cores": 0, "out": 1, "in": 2}

# K3 (csrc/residual_unit.cu): the fused route (bf16) holds a 128-row tile of
# h in shared memory, at most RU_H_MAX bytes of a block's SMEM_MAX, beside
# an x ring of TMA boxes (64 channels: a 128-byte row, with the 6*dilation
# halo) and a weight ring. It takes bf16 C up to RU_FUSED_MAX_C: the split
# route (a snake pass, the conv, the GEMM) ran faster at every other shape
# where both run, and in fp32 (conv_variants.py, NVIDIA H100 80GB HBM3,
# 700 W)
M_TILE = 128
SMEM_MAX = 232448
RU_H_MAX = 128 * 1024
RU_FUSED_MAX_C = 128

_INV_PI = 0.3183098861837907
_SIN2_C = (9.869603239633658, -32.469601846083854, 42.72581061829601,
           -30.089709323462305, 13.005597445194748, -3.2946440864775366)


def snake(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor) -> torch.Tensor:
    """x + inv_beta * sin^2(alpha x) in fp32 with the kernels' polynomial
    sin^2 (range reduction + degree-5 polynomial in s^2; max abs error 2.3e-7).
    The CUDA kernels share it as ``snake_poly`` (csrc/common.cuh)."""
    v = x * (alpha * _INV_PI)
    s = v - torch.round(v)
    w = s * s
    p = torch.full_like(w, _SIN2_C[5])
    for c in (_SIN2_C[4], _SIN2_C[3], _SIN2_C[2], _SIN2_C[1], _SIN2_C[0]):
        p = p * w + c
    return x + inv_beta * (w * p)


def _snake_rounded(x: torch.Tensor, alpha, inv_beta, dtype) -> torch.Tensor:
    """fp32 snake of x (or x itself), rounded to `dtype`, returned in fp32."""
    xf = x.float()
    if alpha is not None:
        xf = snake(xf, alpha.float(), inv_beta.float())
    return xf.to(dtype).float()


def _conv_f32(x: torch.Tensor, w: torch.Tensor, dilation: int, padding: int) -> torch.Tensor:
    """[B, T, Cin] x [k, Cin, Cout] stride-1 conv in fp32, channels-last."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), padding=padding, dilation=dilation)
    return y.transpose(1, 2)


def _stack_snake(alpha, inv_beta) -> tp.Optional[torch.Tensor]:
    """[2, C] fp32 (alpha, inv_beta), the kernels' snake-parameter layout."""
    if alpha is None:
        return None
    return torch.stack([alpha.float(), inv_beta.float()]).contiguous()


def conv_tile_n(cout: int, dtype) -> tp.Optional[int]:
    """The wgmma kernel's Cout tile width for `cout` outputs: the widest of
    TILE_N[dtype] that divides it (768 -> 256, 384 and 192 -> 192, 96 -> 96
    in bf16), or None when none does."""
    return next((n for n in TILE_N[dtype] if cout % n == 0), None)


def conv_route(cin: int, cout: int, k: int, dtype) -> str:
    """K2's kernel for a [*, cin] -> [*, cout] conv of `k` taps on `dtype`
    activations, by the shape alone: "wide" (csrc/conv_wgmma.cu) or "thin"
    (the CUDA-core kernel of csrc/conv1d.cu).

    Thin: Cin * elem % 16 != 0 (Cin 1 and 2: the encoders' conv_in, whose
    rows TMA cannot map) or a Cout that no tile width divides (Cout 1 and 2:
    the decoders' conv_out, bound by reading its input once, where a
    tensor-core tile would be almost all padding). Every other shape
    chip_smoke.py times, from the SEANet's 32 channels to the DAC's 1536,
    takes the wide kernel (`k` plays no part: 1x1 and k7 convs take the same
    route)."""
    elem = 2 if dtype == torch.bfloat16 else 4
    if (cin * elem) % 16 or conv_tile_n(cout, dtype) is None:
        return "thin"
    return "wide"


def thin_design(cin: int, cout: int, k: int, dilation: int, dtype) -> str:
    """The thin route's kernel (csrc/conv1d.cu) for a conv conv_route sends
    to "thin": "out" (the decoders' conv_out: the tensor-core Z product,
    thin_out_kernel) where its k * Cout (tap, output) columns fit
    THIN_OUT_MAX_N, x's rows are whole 16-byte words and B^T, Z and the halo
    fit a block; "in" (the encoders' conv_in in bf16: one 16-deep tensor-core
    product per row, thin_in_kernel) for bf16 Cin 1 or 2 with k * Cin <=
    16 and Cout a multiple of 8 up to THIN_IN_MAX_COUT; "cuda_cores" (the
    CUDA-core thin_cores_kernel, which takes any shape) everywhere else: the
    conv_in in fp32, whose FFMA reached ~74% of the bytes' bound on an H100
    SXM at 700 W, and every other thin shape."""
    elem = 2 if dtype == torch.bfloat16 else 4
    if (k * cout <= THIN_OUT_MAX_N and (cin * elem) % 16 == 0 and cin <= THIN_OUT_MAX_CIN[dtype]
            and (k - 1) * dilation <= THIN_OUT_MAX_HALO):
        return "out"
    if (dtype == torch.bfloat16 and cin <= 2 and k * cin <= 16 and cout % 8 == 0
            and cout <= THIN_IN_MAX_COUT):
        return "in"
    return "cuda_cores"


def _k_major_weights(w: torch.Tensor, dtype,
                     out: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """w [taps, Cin, Cout] -> the wgmma kernel's K-major weights: [taps,
    Cout, Cin] in bf16, or [taps, 2, Cout, Cin] fp32 holding the tf32
    parts w_hi = tf32(w), w_lo = tf32(w - w_hi) (one pass over the weights,
    ``fsat_conv_weights``), into `out` where given (contiguous)."""
    taps, cin, cout = w.shape
    f32 = dtype == torch.float32
    wc = w.to(dtype).contiguous()
    if out is None:
        out = torch.empty((taps, 2, cout, cin) if f32 else (taps, cout, cin), device=w.device,
                          dtype=dtype)
    err = build.library().fsat_conv_weights(_ptr(wc), _ptr(out), taps, cin, cout, int(f32),
                                            _stream(w.device))
    build.check(err, "conv weights")
    return out


def ru_route(c: int, dtype) -> str:
    """K3's route for C channels on `dtype` activations, by (C, dtype) alone:
    "fused" (h in shared memory) in bf16 up to RU_FUSED_MAX_C (C 128), else
    "split" (a snake pass, then h through a device scratch)."""
    return "fused" if dtype == torch.bfloat16 and c <= RU_FUSED_MAX_C else "split"


def ru_plan(c: int, dilation: int) -> dict:
    """The fused route's launch plan (csrc/residual_unit.cu: RuPlan; bf16,
    128 columns a pass): the x box's rows (128 rows and the 6*dilation halo,
    rounded up to 8), x boxes and weight tiles in flight (two x slots where
    they fit, then the most weight stages, 4 to 2), and the shared memory it
    takes: 1024 (alignment) + h + the x ring + the weight ring + the
    mbarriers. Raises where nothing fits."""
    box_rows = (M_TILE + 6 * dilation + 7) // 8 * 8
    for x_slots in (2, 1):
        for w_stages in (4, 3, 2):
            smem = (1024 + M_TILE * c * 2 + x_slots * box_rows * 128 + w_stages * 128 * 128
                    + 16 * (x_slots + w_stages))
            if smem <= SMEM_MAX and box_rows <= 256 and c % 128 == 0:
                return dict(box_rows=box_rows, x_slots=x_slots, w_stages=w_stages, smem=smem)
    raise ValueError(f"fused_residual_unit: no fused plan fits C = {c}, dilation {dilation}")


def split_tile_n(c: int, dtype) -> int:
    """The split route's tile width (its conv and GEMM launches,
    csrc/residual_unit.cu: launch_split): bf16 256 where it divides C, else
    128; fp32 128."""
    return 256 if dtype == torch.bfloat16 and c % 256 == 0 else 128


def _ru_weights(w1: torch.Tensor, w2: torch.Tensor, dtype) -> torch.Tensor:
    """K3's K-major weights in one tensor: [8, C, C] bf16 or [8, 2, C, C]
    fp32 tf32 hi/lo, slices 0-6 w1's taps and 7 w2."""
    c = w2.shape[0]
    out = torch.empty((8, 2, c, c) if dtype == torch.float32 else (8, c, c), device=w1.device,
                      dtype=dtype)
    _k_major_weights(w1, dtype, out[:7])
    _k_major_weights(w2[None], dtype, out[7:])
    return out


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte aligned address, as a TMA tensor map needs."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def uses_kernels(x: torch.Tensor) -> bool:
    """Whether the wrappers launch a kernel for `x`: a tensor on a CUDA
    device. (A function, so that the tests can drive the autograd Functions
    on CPU tensors with the launches replaced by the plain versions.)"""
    return x.device.type != "cpu"


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _check_cuda(name: str, x: torch.Tensor, *tensors: torch.Tensor) -> None:
    """Raises on what the kernels do not take."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the CUDA kernels take bf16 or fp32 activations, got {x.dtype}")
    for t in (x, *tensors):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}, got {t.device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: tp.Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# K2: snake -> stride-1 dilated conv
# ---------------------------------------------------------------------------


def snake_conv1d_plain(x, w, bias, alpha=None, inv_beta=None, dilation: int = 1,
                       padding: tp.Optional[int] = None):
    dt = x.dtype
    if padding is None:
        padding = (dilation * (w.shape[0] - 1)) // 2
    y = _conv_f32(_snake_rounded(x, alpha, inv_beta, dt), w.to(dt).float(), dilation, padding)
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def snake_conv1d(x: torch.Tensor, w: torch.Tensor, bias: tp.Optional[torch.Tensor],
                 alpha: tp.Optional[torch.Tensor] = None,
                 inv_beta: tp.Optional[torch.Tensor] = None, dilation: int = 1,
                 padding: tp.Optional[int] = None) -> torch.Tensor:
    """Fused snake(x) -> conv, stride 1, same length. x [B, T, Cin];
    w [k, Cin, Cout]; alpha/inv_beta the effective per-channel snake
    parameters (None skips the snake). The plain version takes the same
    arguments."""
    k = w.shape[0]
    if padding is None:
        padding = (dilation * (k - 1)) // 2
    if 2 * padding != dilation * (k - 1):
        raise ValueError("snake_conv1d computes 'same'-length convolutions only")
    if not uses_kernels(x):
        return snake_conv1d_plain(x, w, bias, alpha, inv_beta, dilation, padding)
    _check_cuda("snake_conv1d", x, w, bias, alpha, inv_beta)
    if _needs_grad(x, w, bias, alpha, inv_beta):
        return SnakeConv1d.apply(x, w, bias, alpha, inv_beta, dilation, padding)
    return _launch_snake_conv1d(x, w, bias, alpha, inv_beta, dilation, padding)


def _launch_snake_conv1d(x, w, bias, alpha, inv_beta, dilation: int, padding: int):
    global snake_conv1d_launches, snake_conv1d_f32_launches
    global snake_conv1d_wide_launches, snake_conv1d_wide_f32_launches
    k, cin, cout = w.shape
    ab = _stack_snake(alpha, inv_beta)
    b, t, _ = x.shape
    f32 = x.dtype == torch.float32
    bias = (torch.zeros(cout, device=x.device) if bias is None else bias.float()).contiguous()
    y = torch.empty(b, t, cout, device=x.device, dtype=x.dtype)
    lib = build.library()
    if conv_route(cin, cout, k, x.dtype) == "wide":
        x = _tma_ready(x)
        err = lib.fsat_conv_taps_k2(_ptr(x), _ptr(_k_major_weights(w, x.dtype)), _ptr(bias),
                                    _ptr(ab), _ptr(y), b, t, cin, cout, k, dilation, padding,
                                    conv_tile_n(cout, x.dtype), int(f32), F32_FLUSH,
                                    _stream(x.device))
        if f32:
            snake_conv1d_wide_f32_launches += 1
        else:
            snake_conv1d_wide_launches += 1
    else:
        x = x.contiguous()
        wc = w.to(x.dtype).contiguous()
        fn = lib.fsat_snake_conv1d_f32 if f32 else lib.fsat_snake_conv1d
        design = THIN_DESIGNS[thin_design(cin, cout, k, dilation, x.dtype)]
        err = fn(_ptr(x), _ptr(wc), _ptr(bias), _ptr(ab), _ptr(y), b, t, cin, cout, k, dilation,
                 padding, design, _stream(x.device))
        if f32:
            snake_conv1d_f32_launches += 1
        else:
            snake_conv1d_launches += 1
    build.check(err, "snake_conv1d")
    return y


class SnakeConv1d(torch.autograd.Function):
    """K2 forward; the backward differentiates :func:`snake_conv1d_plain`."""

    @staticmethod
    def forward(ctx, x, w, bias, alpha, inv_beta, dilation, padding):
        ctx.save_for_backward(x, w, bias, alpha, inv_beta)
        ctx.conv = (dilation, padding)
        return _launch_snake_conv1d(x, w, bias, alpha, inv_beta, dilation, padding)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_grads(snake_conv1d_plain, (*ctx.saved_tensors, *ctx.conv),
                            ctx.needs_input_grad, grad_out)


# ---------------------------------------------------------------------------
# K3: whole Oobleck residual unit
# ---------------------------------------------------------------------------


def fused_residual_unit_plain(x, w1, b1, alpha1, inv_beta1, w2, b2, alpha2, inv_beta2,
                              dilation: int = 1):
    dt = x.dtype
    k = w1.shape[0]
    h = _conv_f32(_snake_rounded(x, alpha1, inv_beta1, dt), w1.to(dt).float(), dilation,
                  dilation * (k - 1) // 2) + b1.float()
    h = snake(h, alpha2.float(), inv_beta2.float()).to(dt).float()
    y = h @ w2.to(dt).float() + b2.float()
    return (y + x.float()).to(dt)


def fused_residual_unit(x, w1, b1, alpha1, inv_beta1, w2, b2, alpha2, inv_beta2,
                        dilation: int = 1) -> torch.Tensor:
    """y = x + conv1x1(snake2(conv_k,dil(snake1(x)) + b1)) + b2 (cin == cout).
    w1 [k, C, C], w2 [C, C]; k = 7 on CUDA."""
    k, c, c2 = w1.shape
    if not (c == c2 == w2.shape[0] == w2.shape[1]):
        raise ValueError("fused_residual_unit needs cin == cout")
    args = (x, w1, b1, alpha1, inv_beta1, w2, b2, alpha2, inv_beta2)
    if not uses_kernels(x):
        return fused_residual_unit_plain(*args, dilation)
    _check_cuda("fused_residual_unit", *args)
    if k != 7 or c % 128:
        raise ValueError(f"fused_residual_unit: the CUDA kernel takes k = 7 and C % 128 == 0, "
                         f"got k = {k}, C = {c}")
    if _needs_grad(*args):
        return FusedResidualUnit.apply(*args, dilation)
    return _launch_fused_residual_unit(*args, dilation)


def _launch_fused_residual_unit(x, w1, b1, alpha1, inv_beta1, w2, b2, alpha2, inv_beta2,
                                dilation: int):
    global fused_residual_unit_launches, fused_residual_unit_f32_launches
    c = w1.shape[1]
    ab1 = _stack_snake(alpha1, inv_beta1)
    ab2 = _stack_snake(alpha2, inv_beta2)
    route = ru_route(c, x.dtype)
    f32 = x.dtype == torch.float32
    b, t, _ = x.shape
    x = _tma_ready(x)
    wk = _ru_weights(w1, w2, x.dtype)
    y = torch.empty_like(x)
    if route == "fused":
        h, plan = None, ru_plan(c, dilation)
    else:
        h, plan = torch.empty_like(x), dict(x_slots=0, w_stages=0)
    b1c, b2c = b1.float().contiguous(), b2.float().contiguous()
    err = build.library().fsat_fused_residual_unit(
        _ptr(x), _ptr(wk), _ptr(b1c), _ptr(ab1), _ptr(b2c), _ptr(ab2), _ptr(h), _ptr(y), b, t, c,
        dilation, plan["x_slots"], plan["w_stages"], int(f32), F32_FLUSH, _stream(x.device))
    if f32:
        fused_residual_unit_f32_launches += 1
    else:
        fused_residual_unit_launches += 1
    build.check(err, "fused_residual_unit")
    return y


class FusedResidualUnit(torch.autograd.Function):
    """K3 forward; the backward differentiates :func:`fused_residual_unit_plain`."""

    @staticmethod
    def forward(ctx, x, w1, b1, alpha1, inv_beta1, w2, b2, alpha2, inv_beta2, dilation):
        ctx.save_for_backward(x, w1, b1, alpha1, inv_beta1, w2, b2, alpha2, inv_beta2)
        ctx.dilation = dilation
        return _launch_fused_residual_unit(x, w1, b1, alpha1, inv_beta1, w2, b2, alpha2,
                                           inv_beta2, dilation)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_grads(fused_residual_unit_plain, (*ctx.saved_tensors, ctx.dilation),
                            ctx.needs_input_grad, grad_out)


# ---------------------------------------------------------------------------
# K4: snake -> ConvTranspose1d(k = 2s, stride s, padding s/2), polyphase
# ---------------------------------------------------------------------------


def snake_conv_transpose1d_plain(x, w, bias, alpha=None, inv_beta=None, stride: int = 2):
    """The phase-grouped GEMM form (conv1d.py:_upk_gemm :353): group A
    (phases r < s/2) reads (x[q], x[q-1]), group B reads (x[q], x[q+1])."""
    dt = x.dtype
    b, t, cin = x.shape
    _, _, cout = w.shape
    s = stride
    p = s // 2
    xr = _snake_rounded(x, alpha, inv_beta, dt)
    wd = w.to(dt).float()
    xm1 = F.pad(xr, (0, 0, 1, 0))[:, :t]
    xp1 = F.pad(xr, (0, 0, 0, 1))[:, 1:]

    def grp(lo, hi):  # [Cin, (hi - lo) * Cout]
        return torch.cat([wd[i] for i in range(lo, hi)], dim=1)

    a = xr @ grp(p, s) + xm1 @ grp(p + s, 2 * s)
    bq = xr @ grp(s, s + p) + xp1 @ grp(0, p)
    y = torch.cat([a.view(b, t, p, cout), bq.view(b, t, p, cout)], dim=2)
    if bias is not None:
        y = y + bias.float()
    return y.reshape(b, t * s, cout).to(dt)


def snake_conv_transpose1d(x: torch.Tensor, w: torch.Tensor, bias: tp.Optional[torch.Tensor],
                           alpha: tp.Optional[torch.Tensor] = None,
                           inv_beta: tp.Optional[torch.Tensor] = None,
                           stride: int = 2) -> torch.Tensor:
    """Fused snake(x) -> ConvTranspose1d(k = 2s, stride s, padding s/2):
    x [B, T, Cin], w [2s, Cin, Cout] -> [B, T*s, Cout]."""
    k, cin, cout = w.shape
    if stride % 2 or k != 2 * stride:
        raise ValueError("snake_conv_transpose1d needs an even stride and k == 2 * stride")
    if not uses_kernels(x):
        return snake_conv_transpose1d_plain(x, w, bias, alpha, inv_beta, stride)
    _check_cuda("snake_conv_transpose1d", x, w, bias, alpha, inv_beta)
    if (cin * x.element_size()) % 16 or conv_tile_n(cout, x.dtype) is None:
        raise ValueError(f"snake_conv_transpose1d: the CUDA kernel takes Cin * elem % 16 == 0 and "
                         f"Cout % {TILE_N[x.dtype][-1]} == 0, got {cin} -> {cout} in {x.dtype}")
    if _needs_grad(x, w, bias, alpha, inv_beta):
        return SnakeConvTranspose1d.apply(x, w, bias, alpha, inv_beta, stride)
    return _launch_snake_conv_transpose1d(x, w, bias, alpha, inv_beta, stride)


def _launch_snake_conv_transpose1d(x, w, bias, alpha, inv_beta, stride: int):
    global snake_conv_transpose1d_launches, snake_conv_transpose1d_f32_launches
    _, cin, cout = w.shape
    ab = _stack_snake(alpha, inv_beta)
    f32 = x.dtype == torch.float32
    b, t, _ = x.shape
    x = _tma_ready(x)
    bias = (torch.zeros(cout, device=x.device) if bias is None else bias.float()).contiguous()
    y = torch.empty(b, t * stride, cout, device=x.device, dtype=x.dtype)
    err = build.library().fsat_conv_taps_k4(
        _ptr(x), _ptr(_k_major_weights(w, x.dtype)), _ptr(bias), _ptr(ab), _ptr(y), b, t, cin, cout,
        stride, conv_tile_n(cout, x.dtype), int(f32), F32_FLUSH, _stream(x.device))
    if f32:
        snake_conv_transpose1d_f32_launches += 1
    else:
        snake_conv_transpose1d_launches += 1
    build.check(err, "snake_conv_transpose1d")
    return y


class SnakeConvTranspose1d(torch.autograd.Function):
    """K4 forward; the backward differentiates :func:`snake_conv_transpose1d_plain`."""

    @staticmethod
    def forward(ctx, x, w, bias, alpha, inv_beta, stride):
        ctx.save_for_backward(x, w, bias, alpha, inv_beta)
        ctx.stride = stride
        return _launch_snake_conv_transpose1d(x, w, bias, alpha, inv_beta, stride)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_grads(snake_conv_transpose1d_plain, (*ctx.saved_tensors, ctx.stride),
                            ctx.needs_input_grad, grad_out)
