"""Chunked processing with a crossfaded overlap-add, and micro-batching
(counterpart of friendly_stable_audio_tools_tpu/ops/chunking.py:21-95).

A long input runs through a network one overlapping chunk at a time, so
that memory stays at one chunk's activations; the outputs are crossfaded
with a Bartlett window where the chunks overlap. The JAX package scans
over the chunks inside one jitted program; here the loop is Python's, each
chunk one eager call of the network.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F


def bartlett_window(n: int, device=None) -> torch.Tensor:
    """torch.bartlett_window(n) (periodic), fp32."""
    return torch.bartlett_window(n, periodic=True, dtype=torch.float32, device=device)


def chunked_process(fn: tp.Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                    chunk_in: int, hop_in: int, chunk_out: int, hop_out: int, overlap_out: int,
                    out_channels: int, out_length: int, pad_mode: str = "zero",
                    out_dtype: tp.Optional[torch.dtype] = None) -> torch.Tensor:
    """Applies `fn: [B, chunk_in, Cin] -> [B, chunk_out, Cout]` over
    overlapping chunks of `x` [B, T, Cin], each `hop_in` after the last (the
    tail padded with zeros, or by reflection), and sums the outputs at
    `hop_out` apart, each chunk's first and last `overlap_out` rows scaled
    by the rising and falling halves of a Bartlett window, except the
    first chunk's head and the last one's tail (JAX :34-80). Returns the
    first `out_length` rows, in `out_dtype` (x's by default)."""
    b, t, cin = x.shape
    n_chunk = max(int(math.ceil((t - chunk_in) / hop_in)) + 1, 1)
    pad = chunk_in + hop_in * (n_chunk - 1) - t
    if pad > 0:
        x = F.pad(x.transpose(1, 2), (0, pad),
                  mode="reflect" if pad_mode == "reflect" else "constant").transpose(1, 2)
    win = bartlett_window(overlap_out * 2, device=x.device)
    out = torch.zeros(b, chunk_out + hop_out * (n_chunk - 1), out_channels, device=x.device)
    for i in range(n_chunk):
        yc = fn(x[:, i * hop_in:i * hop_in + chunk_in]).float()
        if overlap_out > 0:
            w = torch.ones(chunk_out, device=x.device)
            if i > 0:
                w[:overlap_out] = win[:overlap_out]
            if i < n_chunk - 1:
                w[chunk_out - overlap_out:] = win[overlap_out:]
            yc = yc * w[None, :, None]
        out[:, i * hop_out:i * hop_out + chunk_out] += yc
    return out[:, :out_length].to(out_dtype or x.dtype)


def microbatched(fn: tp.Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                 max_batch: int) -> torch.Tensor:
    """`fn` over the batch dim in groups of `max_batch`, the last group
    shorter (JAX :83-95 pads it with copies of the last row and trims the
    result, which gives the same rows for a per-sample `fn`)."""
    if max_batch >= x.shape[0]:
        return fn(x)
    return torch.cat([fn(xb) for xb in x.split(max_batch)])
