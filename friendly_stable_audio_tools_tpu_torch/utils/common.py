"""Random initialisation and de-zeroing of the port's parameters.

`init_weights_` follows the JAX package's initialisers module by module:
fan-in scaled normal for linear layers with zero bias, torch's fan-in
uniform for the weight-normed convs (the discriminator's 2-D ones too)
with `g = ||v||` (so the initial weight equals v) and for the ADP and
Dance Diffusion U-Nets' convs (weight and bias), unit gains, zero
log-scale snake parameters and unit single-parameter ones, unit-normal
embeddings, Fourier weights and vector-quantizer codebooks, fan-in scaled
normal LSTM weights with zero biases, unit gain and zero bias for the LayerNorms
and GroupNorms with a bias, and zeros for the projections marked
`zero_init` (the transformer's branch outputs, the adaLN blocks'
`to_scale_shift_gate`, the DiT's residual convs).
Every draw comes from the generator passed in.
"""

from __future__ import annotations

import math
import typing as tp

import torch
from torch import nn

from ..models import adp, dance_diffusion
from ..models.bottleneck import VectorQuantizer
from ..models.clap import BiasLayerNorm
from ..models.discriminators import WNConv2d
from ..models.t5 import T5Attention
from ..ops.activations import Snake, SnakeBeta
from ..ops.convs import Conv1d, WNConv1d, WNConvTranspose1d
from ..ops.embeddings import FourierFeatures
from ..ops.norms import LayerNorm, RMSNorm


def _uniform_(p: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    p.uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def init_weights_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    done = set()
    for m in model.modules():
        own = list(m.parameters(recurse=False))
        if not own:
            continue
        zero = getattr(m, "zero_init", False)
        if isinstance(m, nn.Linear):
            if zero:
                m.weight.zero_()
            else:
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Conv1d):
            if zero:
                m.weight.zero_()
            else:
                _uniform_(m.weight, 1.0 / math.sqrt(m.weight.shape[1]), gen)
        elif isinstance(m, (WNConv1d, WNConvTranspose1d)):
            k, cin, cout = m.v.shape
            transposed = isinstance(m, WNConvTranspose1d)
            bound = 1.0 / math.sqrt((cout if transposed else cin) * k)
            _uniform_(m.v, bound, gen)
            m.g.copy_(m.v.square().sum(dim=(0, 2) if transposed else (0, 1)).sqrt())
            if m.bias is not None:
                _uniform_(m.bias, bound, gen)
        elif isinstance(m, WNConv2d):
            bound = 1.0 / math.sqrt(m.v[0].numel())
            _uniform_(m.v, bound, gen)
            m.g.copy_(m.v.square().sum(dim=(1, 2, 3)).sqrt())
            _uniform_(m.bias, bound, gen)
        elif isinstance(m, (adp.Conv1d, adp.ConvTranspose1d, dance_diffusion.Conv1d,
                            dance_diffusion.ConvTranspose1d)):
            k, cin, cout = m.weight.shape
            transposed = isinstance(m, (adp.ConvTranspose1d, dance_diffusion.ConvTranspose1d))
            bound = 1.0 / math.sqrt((cout if transposed else cin) * k)
            _uniform_(m.weight, bound, gen)
            if m.bias is not None:
                _uniform_(m.bias, bound, gen)
        elif isinstance(m, Snake):
            m.alpha.fill_(1.0)
        elif isinstance(m, SnakeBeta):
            fill = 0.0 if m.alpha_logscale else 1.0
            m.alpha.fill_(fill)
            m.beta.fill_(fill)
        elif isinstance(m, (LayerNorm, RMSNorm)):
            for p in own:
                p.fill_(1.0)
        elif isinstance(m, (BiasLayerNorm, adp.GroupNorm)):
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=gen)
        elif isinstance(m, VectorQuantizer):
            m.codebook.normal_(0.0, 1.0, generator=gen)
        elif isinstance(m, nn.LSTM):
            for name, p in m.named_parameters(recurse=False):
                if name.startswith("weight"):
                    p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
                else:
                    p.zero_()
        elif isinstance(m, FourierFeatures):
            m.weight.normal_(0.0, m.std, generator=gen)
        elif isinstance(m, adp.LearnedPositionalEmbedding):
            m.weights.normal_(0.0, 1.0, generator=gen)
        elif isinstance(m, T5Attention) or type(m) is nn.Module:
            for p in own:  # T5 relative position bias, NumberEmbedder's Fourier weights
                p.normal_(0.0, 1.0, generator=gen)
        else:
            raise TypeError(f"no initialiser for {type(m).__name__}")
        done.update(id(p) for p in own)
    missing = [n for n, p in model.named_parameters() if id(p) not in done]
    if missing:
        raise TypeError(f"parameters left uninitialised: {missing[:5]}")
    return model


@torch.no_grad()
def dezero_(model: nn.Module, gen: torch.Generator, scale: float = 0.02,
            damp: float = 0.5) -> nn.Module:
    """p <- damp * p + scale * N(0, 1) for every parameter (JAX
    utils/common.dezero_params). A fresh transformer's zero-initialised
    output projections make its output independent of its input; any test of
    output sensitivity on random weights needs this first."""
    for p in model.parameters():
        noise = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
        p.copy_((p.float() * damp + scale * noise).to(p.dtype))
    return model


def resolve_device(device: tp.Union[str, torch.device], how_to_pick_cpu: str) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and there is no
    CUDA device, rather than run on the CPU unasked. `how_to_pick_cpu` names
    the argument that selects the CPU, for the message."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available: the torch port runs on the GPU by "
                           f"default; pass {how_to_pick_cpu} to run on the CPU")
    return device
