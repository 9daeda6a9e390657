"""The fused SwiGLU MLP (K13): ((x Wv^T + bv) * silu(x Wg^T + bg)) Wo^T.

Replaces friendly_stable_audio_tools_tpu/ops/pallas/mlp.py:_glu_mlp_impl
(:145; `_glu_mlp_kernel` :116, pallas_call :172), which the JAX package's
`FeedForward` runs when its fused-MLP switch is on (models/transformer.py:
103-123). :func:`glu_mlp` runs a CUDA kernel (csrc/glu_mlp.cu) on a CUDA
tensor and raises on what the kernels do not take; :func:`glu_mlp_plain`,
the unfused chain at the kernels' rounding points (JAX `_xla_reference`,
:198-202), serves CPU tensors. Nothing falls back from a kernel.

Two routes, chosen by the shape alone (:func:`route`):

* "stream" (M <= 16: the audio LM's decode at M 2): a GEMV chain bound by
  reading the weights once; CUDA cores, one cooperative launch whose blocks
  stream their slices of w_in, then of w_out, through a TMA-fed ring: h
  for 32 columns per block, a grid barrier, then each block's own outputs
  over all of h, so no partial sums at all.
* "tensor" (large M: a DiT's tokens, a prompt's prefill): bound by the
  products; two wgmma/TMA GEMMs on the convolution kernels' mainloop
  (csrc/taps_wgmma.cuh): GEMM1 with the GLU as its epilogue writes h [M,
  inner] in the input dtype, GEMM2 multiplies it into w_out. bf16 reads the
  weights as they are; fp32 runs 3xTF32 on tf32 hi/lo parts of the weights
  that each call prepares (:func:`tensor_weights`).

Weights come in the port's nn.Linear layouts: ``w_in`` is
``GLU.proj.weight`` [2 * inner, K] with the value rows first and the gate
rows after (JAX ``w_in[:, :inner]`` / ``w_in[:, inner:]``), ``b_in`` its
bias [2 * inner] or None, ``w_out`` is ``linear_out.weight`` [Kout, inner].
The caller adds the output bias (JAX :121-122).

The kernels have no backward, as the JAX package's has none: its custom_vjp
differentiates the plain chain (:211-219). `FeedForward` therefore takes
the plain chain under grad, and on a CUDA tensor the wrapper raises when an
input needs a gradient. What bounds each route on the H100 and what its
design does about it: csrc/glu_mlp.cu.
"""

from __future__ import annotations

import ctypes
import functools
import typing as tp

import torch

from . import build
from .conv1d import F32_FLUSH, _stream, _tma_ready

# launch counts: the wrapper adds one to `launches` and one to its route's
# count where it launches a route's kernels (fp32 or bf16); a tensor-core
# call is 2-3 kernels (the fp32 weight parts, GEMM1, GEMM2)
launches = 0
stream_launches = 0
tensor_launches = 0

# the streaming route takes M <= 16 and inner in tiles of STREAM_COLS
# columns; its grid and ring at a shape are the kernel's to decide
# (csrc/glu_mlp.cu:stream_grid, from the card's SMs and shared memory),
# which :func:`stream_plan` asks
STREAM_COLS = 32
# the largest M the streaming route is preferred for (the crossover measured
# by mlp_variants.py at the LM's widths on an H100: fp32 streams faster than
# the tensor cores up to its limit of 16, bf16 up to M 8; PERF.md §6); above
# it the tensor-core route
STREAM_MAX_M = {torch.float32: 16, torch.bfloat16: 8}
# fp32: the tensor-core partial sum is flushed every F32_FLUSH stages, as
# the convolution's (conv1d.F32_FLUSH; at GEMM2's 6144-long reduction too)


def _elem(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def stream_fits(m: int, k: int, inner: int, dtype) -> bool:
    """The streaming kernel's preconditions on the shape: 1 <= M <= 16, rows
    of x and w_in in 16-byte words (K * elem % 16), inner % STREAM_COLS."""
    return 1 <= m <= 16 and (k * _elem(dtype)) % 16 == 0 and inner % STREAM_COLS == 0


def tensor_fits(k: int, inner: int, kout: int, dtype) -> bool:
    """The tensor-core route's: rows of 16-byte words for TMA (K * elem and
    inner * elem % 16), Kout even (its epilogue stores column pairs)."""
    return (k * _elem(dtype)) % 16 == 0 and (inner * _elem(dtype)) % 16 == 0 and kout % 2 == 0


@functools.lru_cache(maxsize=256)  # the shape decides; the LM's decode asks thousands of times
def route(m: int, k: int, inner: int, kout: int, dtype) -> tp.Optional[str]:
    """K13's route for x [M, K], inner and Kout on `dtype`, by the shape
    alone: "stream" for M <= STREAM_MAX_M[dtype] (the measured crossover),
    "tensor" above it; the other route where the shape does not meet the
    preferred one's preconditions (:func:`stream_fits`, :func:`tensor_fits`);
    None where it meets neither's. Whether the streaming grid and ring fit
    the card at the shape is the kernel's to say: :func:`glu_mlp` asks
    :func:`stream_plan` and takes the tensor cores where they do not."""
    fits = {"stream": stream_fits(m, k, inner, dtype), "tensor": tensor_fits(k, inner, kout, dtype)}
    order = ("stream", "tensor") if m <= STREAM_MAX_M[dtype] else ("tensor", "stream")
    return next((r for r in order if fits[r]), None)


@functools.lru_cache(maxsize=256)
def stream_plan(device: torch.device, m: int, k: int, inner: int, kout: int,
                dtype) -> tp.Optional[tp.Dict[str, int]]:
    """The streaming launch on CUDA `device` as its kernel plans it (M tile,
    blocks, outputs per block, ring stages, shared-memory bytes;
    ``fsat_glu_stream_plan``), or None where the kernel does not take the
    shape on that card."""
    plan = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = build.library().fsat_glu_stream_plan(m, k, inner, kout, int(dtype == torch.float32),
                                                   plan)
    return None if err else dict(zip(("m_tile", "blocks", "outputs", "stages", "smem"), plan))


def tensor_plan(m: int, inner: int, kout: int, dtype) -> tp.Dict[str, int]:
    """The tensor-core route's launches as the kernels run them: GEMM1's
    stacked tile width and blocks, GEMM2's tile width and blocks
    (``fsat_glu_tensor_plan``; the widths are csrc/glu_mlp.cu:GemmTiles)."""
    plan = (ctypes.c_int * 4)()
    build.check(build.library().fsat_glu_tensor_plan(m, inner, kout, int(dtype == torch.float32),
                                                      plan), "glu_mlp plan")
    return dict(zip(("glu_n", "glu_blocks", "out_n", "out_blocks"), plan))


def glu_mlp_plain(x: torch.Tensor, w_in: torch.Tensor, b_in: tp.Optional[torch.Tensor],
                  w_out: torch.Tensor) -> torch.Tensor:
    """The chain in x's dtype at the kernels' rounding points: products
    accumulated in fp32 and rounded, bias added in x's dtype, sigmoid in fp32
    rounded, each product of the silu-mul rounded."""
    dt = x.dtype
    inner = w_in.shape[0] // 2
    w = w_in.to(dt).float()
    xf = x.float()
    v = (xf @ w[:inner].T).to(dt)
    g = (xf @ w[inner:].T).to(dt)
    if b_in is not None:
        b = b_in.to(dt)
        v = v + b[:inner]
        g = g + b[inner:]
    h = v * (g * torch.sigmoid(g.float()).to(dt))
    return (h.float() @ w_out.to(dt).float().T).to(dt)


def tensor_weights(w_in: torch.Tensor, w_out: torch.Tensor,
                   dtype) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core route's B operands: bf16 w_in and w_out as they are;
    fp32 their tf32 hi/lo parts, w_in as [2 (value, gate), 2 (hi, lo),
    inner, K] and w_out as [1, 2, Kout, inner] (one pass over the weights,
    ``fsat_tf32_split``)."""
    w_in, w_out = _tma_ready(w_in), _tma_ready(w_out)
    if dtype == torch.bfloat16:
        return w_in, w_out
    lib, st = build.library(), _stream(w_in.device)
    out = []
    for w, parts in ((w_in, 2), (w_out, 1)):
        rows, k = w.shape[0] // parts, w.shape[1]
        split = torch.empty(parts, 2, rows, k, device=w.device, dtype=torch.float32)
        build.check(lib.fsat_tf32_split(w.data_ptr(), split.data_ptr(), rows, k, parts, st),
                    "glu_mlp weights")
        out.append(split)
    return out[0], out[1]


def _glu_stream(x2, w_in, b, w_out, y, k, inner, kout):
    m = x2.shape[0]
    hbuf = torch.empty(m, inner, device=x2.device, dtype=torch.float32)
    w_in, w_out = _tma_ready(w_in), _tma_ready(w_out)
    return build.library().fsat_glu_stream(
        x2.data_ptr(), w_in.data_ptr(), None if b is None else b.data_ptr(), w_out.data_ptr(),
        hbuf.data_ptr(), y.data_ptr(), m, k, inner, kout, int(x2.dtype == torch.float32),
        _stream(x2.device))


def _glu_tensor(x2, w_in, b, w_out, y, k, inner, kout):
    m, dt = x2.shape[0], x2.dtype
    f32 = int(dt == torch.float32)
    wi, wo = tensor_weights(w_in, w_out, dt)
    h = torch.empty(m, inner, device=x2.device, dtype=dt)
    lib, st = build.library(), _stream(x2.device)
    err = lib.fsat_glu_gemm(x2.data_ptr(), wi.data_ptr(), None if b is None else b.data_ptr(),
                            h.data_ptr(), m, k, inner, f32, F32_FLUSH, st)
    return err or lib.fsat_out_gemm(h.data_ptr(), wo.data_ptr(), y.data_ptr(), m, inner, kout, f32,
                                    F32_FLUSH, st)


def glu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: tp.Optional[torch.Tensor],
            w_out: torch.Tensor) -> torch.Tensor:
    """x [..., K] -> [..., Kout] (see the module docstring for the layouts),
    through the route :func:`route` names (the card tests and
    mlp_variants.py replace `route` to run either)."""
    global launches, stream_launches, tensor_launches
    k = x.shape[-1]
    inner = w_in.shape[0] // 2
    kout = w_out.shape[0]
    if w_in.shape != (2 * inner, k) or w_out.shape != (kout, inner) or (
            b_in is not None and b_in.shape != (2 * inner,)):
        raise ValueError(f"glu_mlp: w_in {tuple(w_in.shape)}, b_in "
                         f"{None if b_in is None else tuple(b_in.shape)}, w_out "
                         f"{tuple(w_out.shape)} do not fit x [..., {k}]")
    if x.device.type == "cpu":
        return glu_mlp_plain(x, w_in, b_in, w_out)
    tensors = (x, w_in, b_in, w_out)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("glu_mlp: the CUDA kernels have no backward (the JAX package "
                           "differentiates the plain chain, ops/pallas/mlp.py:211-219); "
                           "FeedForward takes the plain chain under grad")
    if x.dtype not in (torch.float32, torch.bfloat16) or w_in.dtype != x.dtype \
            or w_out.dtype != x.dtype:
        raise TypeError(f"glu_mlp: the CUDA kernels take fp32 or bf16 x with weights of its "
                        f"dtype, got x {x.dtype}, w_in {w_in.dtype}, w_out {w_out.dtype}")
    if any(t is not None and t.device != x.device for t in tensors):
        raise ValueError(f"glu_mlp: all tensors must be on {x.device}")
    x2 = _tma_ready(x.reshape(-1, k))
    m = x2.shape[0]
    chosen = route(m, k, inner, kout, x.dtype)
    plan = None
    if chosen == "stream" and stream_fits(m, k, inner, x.dtype):
        plan = stream_plan(x.device, m, k, inner, kout, x.dtype)
        if plan is None and tensor_fits(k, inner, kout, x.dtype):
            chosen = "tensor"  # the card holds no streaming grid or ring for this shape
    fits = {"stream": plan is not None, "tensor": tensor_fits(k, inner, kout, x.dtype)}
    if m == 0 or not fits.get(chosen, False):
        raise ValueError(f"glu_mlp: no CUDA route takes M {m}, K {k}, inner {inner}, Kout {kout} "
                         f"in {x.dtype} (route {chosen}; stream: M <= 16, K * elem % 16 == 0, "
                         f"inner % {STREAM_COLS} == 0 and a grid and ring the card holds "
                         f"(csrc/glu_mlp.cu:stream_grid); tensor: K * elem and inner * elem % 16 "
                         f"== 0, Kout even)")
    b = None if b_in is None else b_in.float().contiguous()
    y = torch.empty(m, kout, device=x.device, dtype=x.dtype)
    if chosen == "stream":
        err = _glu_stream(x2, w_in, b, w_out, y, k, inner, kout)
        stream_launches += 1
    else:
        err = _glu_tensor(x2, w_in, b, w_out, y, k, inner, kout)
        tensor_launches += 1
    launches += 1
    build.check(err, f"glu_mlp ({chosen} route)")
    return y.view(*x.shape[:-1], kout)
