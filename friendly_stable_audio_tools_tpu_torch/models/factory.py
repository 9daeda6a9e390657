"""Config-driven model factory (counterpart of
friendly_stable_audio_tools_tpu/models/factory.py:17).

Reads the JAX package's model-config JSON schema as it stands; the
`diffusion_cond` (and `diffusion_cond_inpaint`, the same wrapper),
`diffusion_uncond`, `diffusion_prior`, `diffusion_autoencoder`, `lm` and
`autoencoder` model types are ported: every type of the JAX factory."""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops.norms import LayerNorm
from ..utils.common import init_weights_, resolve_device
from .autoencoders import create_autoencoder_from_config, create_diffAE_from_config
from .conditioners import CLAPTextConditioner
from .diffusion import create_diffusion_cond_from_config, create_diffusion_uncond_from_config
from .lm import create_audio_lm_from_config
from .transformer import FeedForward, TransformerBlock


def create_model_from_config(model_config: tp.Dict[str, tp.Any], seed: int = 0,
                             device: tp.Union[str, torch.device] = "cuda",
                             fused_mlp: bool = False, fused_ew: bool = False) -> nn.Module:
    """Builds the model on `device` (the GPU unless `device="cpu"`; raises
    when there is no GPU) with random weights drawn from a generator seeded
    with `seed` (the JAX package's initialisation scheme,
    utils/common.init_weights_; a diffusion backbone is then halved, as the
    JAX wrappers halve it, and so is a diffusion autoencoder's encoder (JAX
    autoencoders.py:725-735); an LM or an autoencoder is not). A CLAP
    conditioner then reads its `clap_ckpt_path` when that file exists. Load a converted checkpoint over
    the weights with `load_state_dict` (utils/convert.py). `fused_mlp` turns
    on the fused SwiGLU kernel K13 in every transformer FeedForward (the JAX
    package's FSAT_FUSED_MLP switch, off by default as there). `fused_ew`
    turns on the fused adaLN elementwise kernels K11 and K12 in every
    LayerNorm and TransformerBlock (the JAX package's FSAT_FUSED_EW switch,
    off by default as there; only a DiT with `global_cond_type="adaLN"`
    reaches them, and only in bf16, ops/kernels/elementwise.py)."""
    device = resolve_device(device, 'device="cpu"')
    model_type = model_config.get("model_type")
    if model_type is None:
        raise ValueError("model_type must be specified in model config")
    builders = {"diffusion_cond": create_diffusion_cond_from_config,
                "diffusion_cond_inpaint": create_diffusion_cond_from_config,
                "diffusion_prior": create_diffusion_cond_from_config,
                "diffusion_uncond": create_diffusion_uncond_from_config,
                "diffusion_autoencoder": create_diffAE_from_config,
                "lm": create_audio_lm_from_config,
                "autoencoder": create_autoencoder_from_config}
    if model_type not in builders:
        raise NotImplementedError(f"model type {model_type!r} is not in the torch port")
    with torch.device("meta"):
        model = builders[model_type](model_config)
    model = model.to_empty(device=device)
    init_weights_(model, torch.Generator(device=device).manual_seed(seed))
    if model_type == "diffusion_autoencoder":
        halved = [model.diffusion.model, model.encoder]
    else:
        halved = [model.model] if model_type.startswith("diffusion") else []
    with torch.no_grad():  # the JAX wrappers halve a fresh backbone (diffusion.py:59, :103)
        for p in (p for m in halved if m is not None for p in m.parameters()):
            p.mul_(0.5)
    for m in model.modules():
        if isinstance(m, CLAPTextConditioner):
            m.load_checkpoint()
        if isinstance(m, FeedForward):
            m.fused_mlp = fused_mlp
        if isinstance(m, (LayerNorm, TransformerBlock)):
            m.fused_ew = fused_ew
    return model.eval()

