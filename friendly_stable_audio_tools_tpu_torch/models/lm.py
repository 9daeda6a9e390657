"""MusicGen-style multi-codebook audio language model (counterpart of
friendly_stable_audio_tools_tpu/models/lm.py).

`AudioLanguageModelModule` (:48) sums one embedding per codebook (with a
slot for the special token) into the backbone and reads one logit head per
codebook. `AudioLanguageModelWrapper` owns it with the conditioner, the
frozen discrete pretransform and the codebook pattern, maps conditioner
outputs to backbone inputs (`get_conditioning_inputs`, :135) and computes
the training logits (`compute_logits`, :153-196): the codes interleaved by
the pattern, the model, the logits taken back to the codes' frames with NaN
where the pattern has none, and classifier-free-guidance dropout of the
conditioning drawn from an explicit `torch.Generator`. Generation (the
static-KV-cache decode, sampling, `generate`) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
from torch import nn

from .codebook_patterns import PATTERN_PROVIDERS, CodebooksPatternProvider
from .conditioners import MultiConditioner, create_multi_conditioner_from_conditioning_config
from .lm_backbone import ContinuousTransformerAudioLMBackbone
from .pretransforms import AutoencoderPretransform, create_pretransform_from_config

COND_KINDS = ("cross_attn_cond", "prepend_cond", "global_cond")


@dataclasses.dataclass
class LMOutput:
    logits: torch.Tensor  # [B, K, T, card], NaN where the pattern has no step
    mask: torch.Tensor  # [B, K, T]


class AudioLanguageModelModule(nn.Module):
    """Per-codebook embeddings (codebook_size + 1 rows: the special token) ->
    backbone -> per-codebook heads."""

    def __init__(self, backbone: ContinuousTransformerAudioLMBackbone, num_quantizers: int,
                 codebook_size: int):
        super().__init__()
        self.backbone = backbone
        dim = backbone.embed_dim
        self.embeds = nn.ModuleList([nn.Embedding(codebook_size + 1, dim)
                                     for _ in range(num_quantizers)])
        self.quantizer_heads = nn.ModuleList([nn.Linear(dim, codebook_size)
                                              for _ in range(num_quantizers)])

    def forward(self, sequence: torch.Tensor, prepend_cond=None, prepend_cond_mask=None,
                cross_attn_cond=None, global_cond=None) -> torch.Tensor:
        """sequence [B, K, S] -> logits [B, K, S, card]."""
        x = sum(emb(sequence[:, i]) for i, emb in enumerate(self.embeds))
        out = self.backbone(x, prepend_cond=prepend_cond, prepend_cond_mask=prepend_cond_mask,
                            cross_attn_cond=cross_attn_cond, global_cond=global_cond)
        return torch.stack([head(out) for head in self.quantizer_heads], dim=1)


class AudioLanguageModelWrapper(nn.Module):
    def __init__(self, pretransform: AutoencoderPretransform, model: AudioLanguageModelModule,
                 pattern_provider: CodebooksPatternProvider, sample_rate: int,
                 conditioner: tp.Optional[MultiConditioner] = None,
                 cross_attn_cond_ids: tp.Sequence[str] = (),
                 prepend_cond_ids: tp.Sequence[str] = (), global_cond_ids: tp.Sequence[str] = ()):
        super().__init__()
        if not pretransform.is_discrete:
            raise ValueError("the audio LM's pretransform must be discrete")
        self.pretransform = pretransform
        self.model = model
        self.conditioner = conditioner
        self.pattern_provider = pattern_provider
        self.sample_rate = sample_rate
        self.cross_attn_cond_ids = list(cross_attn_cond_ids)
        self.prepend_cond_ids = list(prepend_cond_ids)
        self.global_cond_ids = list(global_cond_ids)
        self.num_quantizers = pretransform.num_quantizers
        self.codebook_size = pretransform.codebook_size
        self.masked_token_id = self.codebook_size

    def get_conditioning_inputs(self, cond: tp.Dict[str, tp.Any]) -> tp.Dict[str, tp.Any]:
        """{id: (embeds, mask)} -> the backbone's conditioning keyword arguments."""
        out = dict.fromkeys(("cross_attn_cond", "prepend_cond", "prepend_cond_mask",
                             "global_cond"))
        if self.cross_attn_cond_ids:
            out["cross_attn_cond"] = torch.cat([cond[k][0] for k in self.cross_attn_cond_ids], 1)
        if self.prepend_cond_ids:
            out["prepend_cond"] = torch.cat([cond[k][0] for k in self.prepend_cond_ids], 1)
            out["prepend_cond_mask"] = torch.cat([cond[k][1] for k in self.prepend_cond_ids], 1)
        if self.global_cond_ids:
            g = torch.cat([cond[k][0] for k in self.global_cond_ids], -1)
            out["global_cond"] = g.squeeze(1) if g.dim() == 3 else g
        return out

    def compute_logits(self, codes: torch.Tensor,
                       condition_tensors: tp.Optional[tp.Dict[str, tp.Any]] = None,
                       cfg_dropout_prob: float = 0.0,
                       generator: tp.Optional[torch.Generator] = None,
                       cfg_dropout_masks: tp.Optional[tp.Dict[str, torch.Tensor]] = None
                       ) -> LMOutput:
        """codes [B, K, T] -> LMOutput. With `cfg_dropout_prob` > 0 each
        conditioning input (cross-attention, prepend, global) of each row is
        zeroed with that probability, the draws from `generator`;
        `cfg_dropout_masks` ({kind: [B] bool}) passes them in instead."""
        inputs = self.get_conditioning_inputs(condition_tensors or {})
        if cfg_dropout_prob > 0.0:
            masks = cfg_dropout_masks or {}
            if generator is None and any(inputs[k] is not None and k not in masks
                                         for k in COND_KINDS):
                raise ValueError("cfg_dropout_prob > 0 needs a generator (or the masks)")
            for kind in COND_KINDS:
                arr = inputs[kind]
                if arr is None:
                    continue
                drop = masks.get(kind)
                if drop is None:
                    drop = torch.rand(arr.shape[0], generator=generator,
                                      device=generator.device) < cfg_dropout_prob
                drop = drop.to(arr.device).view(-1, *([1] * (arr.dim() - 1)))
                inputs[kind] = torch.where(drop, torch.zeros_like(arr), arr)

        b, k, t = codes.shape
        pattern = self.pattern_provider.get_pattern(t)
        shifted, _, _ = pattern.build_pattern_sequence(codes, self.masked_token_id,
                                                       keep_only_valid_steps=True)
        logits = self.model(shifted, **inputs)  # [B, K, S, card]
        # back to the codes' frames: one gather over the (K, S) steps of the
        # [B, K, S, card] logits (JAX :190-193 gathers the same entries from
        # a [B, card, K, S] view), NaN where the pattern has no step
        s, card = logits.shape[2], logits.shape[3]
        idx, mask = pattern._revert_table(s, k, True, True)
        flat = torch.cat([logits.reshape(b, k * s, card),
                          logits.new_full((b, 1, card), float("nan"))], dim=1)
        out = flat.index_select(1, torch.from_numpy(idx.reshape(-1)).to(logits.device))
        mask = torch.from_numpy(mask).to(logits.device)
        return LMOutput(logits=out.view(b, k, t, card), mask=mask.expand(b, k, t))


def create_audio_lm_from_config(config: tp.Dict[str, tp.Any]) -> AudioLanguageModelWrapper:
    """JAX models/lm.py:374: the `continuous_transformer` (and
    `x-transformers`, the same architecture) backbone."""
    model_config = config["model"]
    lm_config = model_config["lm"]
    pretransform = create_pretransform_from_config(model_config["pretransform"])
    if not pretransform.is_discrete:
        raise ValueError("the audio LM's pretransform must be discrete")
    pattern_provider = PATTERN_PROVIDERS[lm_config.get("codebook_pattern", "delay")](
        n_q=pretransform.num_quantizers)
    conditioning = model_config.get("conditioning")
    conditioner = (create_multi_conditioner_from_conditioning_config(conditioning)
                   if conditioning is not None else None)
    if lm_config["type"] not in ("x-transformers", "continuous_transformer"):
        raise NotImplementedError(f"Unrecognized lm type {lm_config['type']}")
    backbone = ContinuousTransformerAudioLMBackbone(**lm_config["config"])
    module = AudioLanguageModelModule(backbone, pretransform.num_quantizers,
                                      pretransform.codebook_size)
    return AudioLanguageModelWrapper(
        pretransform=pretransform, model=module, pattern_provider=pattern_provider,
        sample_rate=config["sample_rate"], conditioner=conditioner,
        cross_attn_cond_ids=lm_config.get("cross_attention_cond_ids", []),
        prepend_cond_ids=lm_config.get("prepend_cond_ids", []),
        global_cond_ids=lm_config.get("global_cond_ids", []))
