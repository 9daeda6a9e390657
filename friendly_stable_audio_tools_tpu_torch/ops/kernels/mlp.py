"""The fused SwiGLU MLP (K13): ((x Wv^T + bv) * silu(x Wg^T + bg)) Wo^T.

Replaces friendly_stable_audio_tools_tpu/ops/pallas/mlp.py:_glu_mlp_impl
(:145; `_glu_mlp_kernel` :116, pallas_call :172), which the JAX package's
`FeedForward` runs when its fused-MLP switch is on (models/transformer.py:
103-123). :func:`glu_mlp` runs the CUDA kernel (csrc/glu_mlp.cu) on a CUDA
tensor and raises on what the kernel does not take; :func:`glu_mlp_plain`,
the unfused chain at the kernel's rounding points (JAX `_xla_reference`,
:198-202), serves CPU tensors. Nothing falls back from the kernel.

Weights come in the port's nn.Linear layouts: ``w_in`` is
``GLU.proj.weight`` [2 * inner, K] with the value rows first and the gate
rows after (JAX ``w_in[:, :inner]`` / ``w_in[:, inner:]``), ``b_in`` its
bias [2 * inner] or None, ``w_out`` is ``linear_out.weight`` [Kout, inner].
The caller adds the output bias (JAX :121-122).

The kernel has no backward, as the JAX package's has none: its custom_vjp
differentiates the plain chain (:211-219). `FeedForward` therefore takes
the plain chain under grad, and on a CUDA tensor the wrapper raises when an
input needs a gradient. What bounds the kernel on the H100 and what its
design does about it: csrc/glu_mlp.cu.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from . import build

# launch count: the wrapper adds one where it launches the kernel (fp32 or bf16)
launches = 0

BLOCK_J = 32  # the kernel's inner tile (csrc/glu_mlp.cu: kBJ)
BLOCKS = 2 * 132  # blocks to aim for: two per SM of the H100
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on the H100


def plan(m: int, inner: int) -> tp.Tuple[int, int]:
    """(M tile, number of splits of the inner dimension) for M rows: a tile
    of 2 rows (the LM's decode: one row and its CFG twin) or 8, and enough
    splits that the grid holds about BLOCKS blocks."""
    bm = 2 if m <= 2 else 8
    n_tiles = inner // BLOCK_J
    n_split = min(n_tiles, max(1, math.ceil(BLOCKS / math.ceil(m / bm))))
    per = math.ceil(n_tiles / n_split)
    return bm, math.ceil(n_tiles / per)


def glu_mlp_plain(x: torch.Tensor, w_in: torch.Tensor, b_in: tp.Optional[torch.Tensor],
                  w_out: torch.Tensor) -> torch.Tensor:
    """The chain in x's dtype at the kernel's rounding points: products
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


def glu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: tp.Optional[torch.Tensor],
            w_out: torch.Tensor) -> torch.Tensor:
    """x [..., K] -> [..., Kout] (see the module docstring for the layouts)."""
    global launches
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
        raise RuntimeError("glu_mlp: the CUDA kernel has no backward (the JAX package "
                           "differentiates the plain chain, ops/pallas/mlp.py:211-219); "
                           "FeedForward takes the plain chain under grad")
    if x.dtype not in (torch.float32, torch.bfloat16) or w_in.dtype != x.dtype \
            or w_out.dtype != x.dtype:
        raise TypeError(f"glu_mlp: the CUDA kernel takes fp32 or bf16 x with weights of its "
                        f"dtype, got x {x.dtype}, w_in {w_in.dtype}, w_out {w_out.dtype}")
    if any(t is not None and t.device != x.device for t in tensors):
        raise ValueError(f"glu_mlp: all tensors must be on {x.device}")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    bm, n_split = plan(m, inner)
    if k % 8 or inner % BLOCK_J or bm * (k + BLOCK_J + kout) * 4 > SMEM_LIMIT or m == 0:
        raise ValueError(f"glu_mlp: the CUDA kernel takes K % 8 == 0, inner % {BLOCK_J} == 0 "
                         f"and K + Kout <= {SMEM_LIMIT // 32 - BLOCK_J}, got M {m}, K {k}, "
                         f"inner {inner}, Kout {kout}")
    w_in, w_out = w_in.contiguous(), w_out.contiguous()
    b = None if b_in is None else b_in.float().contiguous()
    partial = torch.empty(n_split, m, kout, device=x.device, dtype=torch.float32)
    y = torch.empty(m, kout, device=x.device, dtype=x.dtype)
    lib = build.library()
    fn = lib.fsat_glu_mlp_f32 if x.dtype == torch.float32 else lib.fsat_glu_mlp
    err = fn(x2.data_ptr(), w_in.data_ptr(), None if b is None else b.data_ptr(),
             w_out.data_ptr(), partial.data_ptr(), y.data_ptr(), m, k, inner, kout, n_split, bm,
             torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    build.check(err, "glu_mlp")
    return y.view(*x.shape[:-1], kout)
