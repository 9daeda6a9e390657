"""Conditioned diffusion wrapper (counterpart of
friendly_stable_audio_tools_tpu/models/diffusion.py:ConditionedDiffusionModelWrapper :78).

Holds the diffusion backbone (`model`: the DiT, or Stable Audio 1.0's ADP
U-Net `adp_cfg_1d`), the conditioners (`conditioner`) and the frozen
pretransform (`pretransform`) as submodules, and maps conditioner outputs
onto the backbone's inputs by conditioning id: cross-attention tokens are
concatenated over the sequence, global conditions over channels, the DiT's
input-concat conditions over channels and its prepend conditions (with
their masks) over the sequence. The `diffusion_cond_inpaint` model type is
the same wrapper, its DiT taking the inpaint mask and the masked latents
as input-concat conditions (`input_concat_ids`)."""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .adp import UNetCFG1d
from .conditioners import MultiConditioner, create_multi_conditioner_from_conditioning_config
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
                 prepend_cond_ids: tp.Sequence[str] = ()):
        super().__init__()
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
    """The `dit` and `adp_cfg_1d` backbones of a `diffusion_cond` or
    `diffusion_cond_inpaint` config (JAX diffusion.py:315)."""
    model_config = config["model"]
    diffusion = model_config["diffusion"]
    backbones = {"dit": DiffusionTransformer, "adp_cfg_1d": UNetCFG1DWrapper}
    if diffusion["type"] not in backbones:
        raise NotImplementedError(f"diffusion type {diffusion['type']!r} is not in the torch port")
    if diffusion["type"] != "dit" and (diffusion.get("input_concat_ids")
                                       or diffusion.get("prepend_cond_ids")):
        raise NotImplementedError("the torch port takes input-concat and prepend conditioning "
                                  "into the DiT only")
    conditioning = model_config.get("conditioning")
    pretransform = model_config.get("pretransform")
    return ConditionedDiffusionModelWrapper(
        backbones[diffusion["type"]](**diffusion["config"]),
        create_multi_conditioner_from_conditioning_config(conditioning) if conditioning else None,
        io_channels=model_config["io_channels"],
        pretransform=(create_pretransform_from_config(pretransform)
                      if pretransform else None),
        cross_attn_cond_ids=diffusion.get("cross_attention_cond_ids", []),
        global_cond_ids=diffusion.get("global_cond_ids", []),
        diffusion_objective=diffusion.get("diffusion_objective", "v"),
        sample_rate=config.get("sample_rate"),
        input_concat_ids=diffusion.get("input_concat_ids", []),
        prepend_cond_ids=diffusion.get("prepend_cond_ids", []))
