"""Diffusion wrappers (counterpart of
friendly_stable_audio_tools_tpu/models/diffusion.py: DiffusionModelWrapper
:36 and ConditionedDiffusionModelWrapper :78).

:class:`DiffusionModelWrapper` is the unconditional model type
`diffusion_uncond` (Dance Diffusion's `DAU1d` U-Net, the ADP `UNet1d` as
`adp_uncond_1d`, or the DiT), with an optional frozen pretransform; the
diffusion autoencoder holds one as its decoder's diffusion model
(models/autoencoders.py).

:class:`ConditionedDiffusionModelWrapper` holds the diffusion backbone
(`model`: the DiT, Stable Audio 1.0's ADP U-Net `adp_cfg_1d`, or Dance
Diffusion's U-Net `DAU1d`, whose only condition is input-concat: the
mono-to-stereo prior's `source`), the conditioners (`conditioner`) and the frozen
pretransform (`pretransform`) as submodules, and maps conditioner outputs
onto the backbone's inputs by conditioning id: cross-attention tokens are
concatenated over the sequence, global conditions over channels, the DiT's
input-concat conditions over channels and its prepend conditions (with
their masks) over the sequence. The `diffusion_cond_inpaint` model type is
the same wrapper, its DiT taking the inpaint mask and the masked latents
as input-concat conditions (`input_concat_ids`)."""

from __future__ import annotations

import math
import typing as tp

import torch
from torch import nn

from .adp import UNet1d, UNetCFG1d
from .conditioners import MultiConditioner, create_multi_conditioner_from_conditioning_config
from .dance_diffusion import DAU1DCondWrapper, DiffusionAttnUnet1D
from .dit import DiffusionTransformer
from .pretransforms import AutoencoderPretransform, create_pretransform_from_config


class UNetCFG1DWrapper(UNetCFG1d):
    """The `adp_cfg_1d` backbone behind the wrapper's argument names (JAX
    diffusion.py:204-222): cross-attention tokens and their mask become the
    embedding and its mask (the mask is kept, where the DiT drops it),
    global conditions the features, cfg_scale the embedding scale. The
    sampler's `scale_phi` is not passed on, as the JAX adapter consumes it:
    the U-Net's CFG rescale keeps its own 0.4. `batch_cfg` and `rescale_cfg`
    default to the JAX generation's sampler call (inference/generation.py:303-309).
    The training step's `cfg_dropout_prob` becomes the U-Net's
    `embedding_mask_proba`, with its `cfg_dropout_mask` and `generator` for
    the draw."""

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cross_attn_cond: tp.Optional[torch.Tensor] = None,
                cross_attn_mask: tp.Optional[torch.Tensor] = None,
                global_embed: tp.Optional[torch.Tensor] = None,
                negative_cross_attn_cond: tp.Optional[torch.Tensor] = None,
                negative_cross_attn_mask: tp.Optional[torch.Tensor] = None,
                cfg_scale: float = 1.0, scale_phi: float = 0.0, batch_cfg: bool = True,
                rescale_cfg: bool = True, cfg_dropout_prob: float = 0.0,
                cfg_dropout_mask: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        return super().forward(
            x, t, embedding=cross_attn_cond, embedding_mask=cross_attn_mask, features=global_embed,
            embedding_scale=cfg_scale, embedding_mask_proba=cfg_dropout_prob, batch_cfg=batch_cfg,
            rescale_cfg=rescale_cfg, negative_embedding=negative_cross_attn_cond,
            negative_embedding_mask=negative_cross_attn_mask, cfg_dropout_mask=cfg_dropout_mask,
            generator=generator)


class ConditionedDiffusionModelWrapper(nn.Module):
    def __init__(self, model: nn.Module, conditioner: tp.Optional[MultiConditioner],
                 io_channels: int, pretransform: tp.Optional[AutoencoderPretransform] = None,
                 cross_attn_cond_ids: tp.Sequence[str] = (),
                 global_cond_ids: tp.Sequence[str] = (), diffusion_objective: str = "v",
                 sample_rate: tp.Optional[int] = None,
                 input_concat_ids: tp.Sequence[str] = (),
                 prepend_cond_ids: tp.Sequence[str] = (), min_input_length: int = 1):
        super().__init__()
        self.min_input_length = min_input_length  # a length the backbone takes is a multiple
        self.model = model
        self.conditioner = conditioner
        self.pretransform = pretransform
        self.io_channels = io_channels
        self.cross_attn_cond_ids = list(cross_attn_cond_ids)
        self.global_cond_ids = list(global_cond_ids)
        self.input_concat_ids = list(input_concat_ids)
        self.prepend_cond_ids = list(prepend_cond_ids)
        self.diffusion_objective = diffusion_objective
        self.sample_rate = sample_rate  # init audio is resampled to it

    def get_conditioning_inputs(self, conditioning_tensors: tp.Dict[str, tp.Any],
                                negative: bool = False) -> tp.Dict[str, tp.Any]:
        """Conditioner outputs -> the backbone's keyword arguments (JAX diffusion.py:136)."""
        cross, cross_mask, global_cond = None, None, None
        if self.cross_attn_cond_ids:
            ins, masks = [], []
            for key in self.cross_attn_cond_ids:
                emb, mask = conditioning_tensors[key]
                if emb.ndim == 2:
                    emb, mask = emb[:, None, :], mask[:, None]
                ins.append(emb)
                masks.append(mask)
            cross, cross_mask = torch.cat(ins, dim=1), torch.cat(masks, dim=1)
        if self.global_cond_ids:
            global_cond = torch.cat([conditioning_tensors[key][0] for key in self.global_cond_ids],
                                    dim=-1)
            if global_cond.ndim == 3:
                global_cond = global_cond.squeeze(1)
        if negative:
            return {"negative_cross_attn_cond": cross, "negative_cross_attn_mask": cross_mask}
        if isinstance(self.model, UNetCFG1DWrapper):
            return {"cross_attn_cond": cross, "cross_attn_mask": cross_mask,
                    "global_embed": global_cond}
        if isinstance(self.model, DAU1DCondWrapper):  # JAX diffusion.py:235-237
            return {"input_concat_cond": torch.cat(
                [conditioning_tensors[key][0] for key in self.input_concat_ids], dim=-1)
                if self.input_concat_ids else None}
        # the DiT ignores conditioning-token masks (reference dit.py:250-252)
        inputs = {"cross_attn_cond": cross, "global_embed": global_cond}
        if self.input_concat_ids:
            inputs["input_concat_cond"] = torch.cat(
                [conditioning_tensors[key][0] for key in self.input_concat_ids], dim=-1)
        if self.prepend_cond_ids:
            inputs["prepend_cond"] = torch.cat(
                [conditioning_tensors[key][0] for key in self.prepend_cond_ids], dim=1)
            inputs["prepend_cond_mask"] = torch.cat(
                [conditioning_tensors[key][1] for key in self.prepend_cond_ids], dim=1)
        return inputs


def create_diffusion_cond_from_config(config: tp.Dict[str, tp.Any]) -> ConditionedDiffusionModelWrapper:
    """The `dit`, `adp_cfg_1d` and `DAU1d` backbones of a `diffusion_cond`,
    `diffusion_cond_inpaint` or `diffusion_prior` config (JAX
    diffusion.py:315); a prior is a :class:`MonoToStereoDiffusionPrior`
    (models/diffusion_prior.py)."""
    model_config = config["model"]
    diffusion = model_config["diffusion"]
    backbones = {"dit": DiffusionTransformer, "adp_cfg_1d": UNetCFG1DWrapper,
                 "DAU1d": DAU1DCondWrapper}
    if diffusion["type"] not in backbones:
        raise NotImplementedError(f"diffusion type {diffusion['type']!r} is not in the torch port")
    if diffusion["type"] == "adp_cfg_1d" and (diffusion.get("input_concat_ids")
                                              or diffusion.get("prepend_cond_ids")):
        raise NotImplementedError("the torch port takes input-concat and prepend conditioning "
                                  "into the DiT and (input-concat) the DAU1d U-Net only")
    wrapper_cls = ConditionedDiffusionModelWrapper
    if config["model_type"] == "diffusion_prior":
        from .diffusion_prior import MonoToStereoDiffusionPrior

        if model_config.get("prior_type") != "mono_stereo":
            raise ValueError(f"Unknown prior type: {model_config.get('prior_type')}")
        wrapper_cls = MonoToStereoDiffusionPrior
    conditioning = model_config.get("conditioning")
    pretransform = model_config.get("pretransform")
    pretransform = create_pretransform_from_config(pretransform) if pretransform else None
    backbone = diffusion["config"]
    min_input_length = pretransform.downsampling_ratio if pretransform is not None else 1
    if diffusion["type"] == "dit":
        min_input_length *= backbone.get("patch_size", 1)
    elif diffusion["type"] == "DAU1d":
        min_input_length *= math.prod(backbone.get("strides", [2] * 13))
    else:
        min_input_length *= math.prod(backbone["factors"])
    return wrapper_cls(
        backbones[diffusion["type"]](**backbone),
        create_multi_conditioner_from_conditioning_config(conditioning) if conditioning else None,
        io_channels=model_config["io_channels"], pretransform=pretransform,
        cross_attn_cond_ids=diffusion.get("cross_attention_cond_ids", []),
        global_cond_ids=diffusion.get("global_cond_ids", []),
        diffusion_objective=diffusion.get("diffusion_objective", "v"),
        sample_rate=config.get("sample_rate"),
        input_concat_ids=diffusion.get("input_concat_ids", []),
        prepend_cond_ids=diffusion.get("prepend_cond_ids", []),
        min_input_length=min_input_length)


class DiffusionModelWrapper(nn.Module):
    """An unconditional diffusion model (JAX diffusion.py:36-74): the
    backbone `model` called as model(x [B, T, C], t [B]), an optional frozen
    pretransform, and the shape facts the generators read."""

    def __init__(self, model: nn.Module, io_channels: int, sample_size: int, sample_rate: int,
                 min_input_length: int = 1,
                 pretransform: tp.Optional[AutoencoderPretransform] = None,
                 diffusion_objective: str = "v"):
        super().__init__()
        self.model = model
        self.conditioner = None  # no conditioning: the trainers read it as absent
        self.pretransform = pretransform
        self.io_channels = io_channels
        self.sample_size = sample_size
        self.sample_rate = sample_rate
        self.min_input_length = min_input_length
        self.diffusion_objective = diffusion_objective

    def forward(self, x: torch.Tensor, t: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.model(x, t, **kwargs)

    def generate(self, *args, **kwargs) -> torch.Tensor:
        from ..inference.generation import generate_diffusion_uncond

        return generate_diffusion_uncond(self, *args, **kwargs)


class DiTUncondWrapper(DiffusionTransformer):
    """The DiT as an unconditional backbone (JAX diffusion.py:297-300: its
    `in_channels` is the io width)."""

    def __init__(self, in_channels: int, **config):
        super().__init__(io_channels=in_channels, **config)


class UNet1DCondWrapper(UNet1d):
    """The ADP `UNet1d` behind the wrapper's input-concat argument (JAX
    diffusion.py:222-234): the condition, nearest-resampled to the input's
    length where it differs, is the U-Net's one context-channel entry;
    sampler and trainer arguments it has no use for are accepted and
    unused."""

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                input_concat_cond: tp.Optional[torch.Tensor] = None, **unused) -> torch.Tensor:
        channels_list = None
        if input_concat_cond is not None:
            if input_concat_cond.shape[1] != x.shape[1]:
                idx = (torch.arange(x.shape[1], device=x.device)
                       * input_concat_cond.shape[1]) // x.shape[1]
                input_concat_cond = input_concat_cond[:, idx]
            channels_list = [input_concat_cond]
        return super().forward(x, t, channels_list=channels_list)


def create_diffusion_uncond_from_config(config: tp.Dict[str, tp.Any]) -> DiffusionModelWrapper:
    """A `diffusion_uncond` config (JAX diffusion.py:271-312): the `DAU1d`,
    `adp_uncond_1d` or `dit` backbone, its pretransform if any."""
    model_config = config["model"]
    kind = model_config["type"]
    backbone = dict(model_config.get("config", {}))
    if kind == "DAU1d":
        model, io_channels = DiffusionAttnUnet1D(**backbone), backbone.get("io_channels", 2)
    elif kind == "adp_uncond_1d":
        model, io_channels = UNet1d(**backbone), backbone.get("in_channels", 2)
    elif kind == "dit":
        model, io_channels = DiTUncondWrapper(**backbone), backbone["in_channels"]
    else:
        raise NotImplementedError(f"Unknown model type: {kind}")
    pretransform = model_config.get("pretransform")
    pretransform = create_pretransform_from_config(pretransform) if pretransform else None
    return DiffusionModelWrapper(
        model, io_channels=io_channels, sample_size=config["sample_size"],
        sample_rate=config["sample_rate"],
        min_input_length=pretransform.downsampling_ratio if pretransform is not None else 1,
        pretransform=pretransform)
