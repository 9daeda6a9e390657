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
conditioning drawn from an explicit `torch.Generator`.

Generation (JAX :198-372): `generate` allocates one static KV cache per
layer for the S steps of the pattern, runs the prefill of the steps before
the first one to generate, then a host loop over the remaining offsets
(JAX compiles that loop into one `lax.scan`; here each step is launched
from the host and nothing waits on the device until the end). Each step
samples the next tokens from the last logits (`_sample_token`: the CFG
lerp of the batch-doubled logits, temperature, top-k or top-p, the Gumbel
draws from an explicit `torch.Generator`), keeps prompt tokens and the
special token where the pattern has no coordinate, and decodes the new
step. `generate_audio` decodes the codes through the tokenizer.
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
from .utils import multinomial, sample_top_k, sample_top_p

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

    def _embed(self, sequence: torch.Tensor) -> torch.Tensor:
        return sum(emb(sequence[:, i]) for i, emb in enumerate(self.embeds))

    def _heads(self, out: torch.Tensor) -> torch.Tensor:
        return torch.stack([head(out) for head in self.quantizer_heads], dim=1)

    def forward(self, sequence: torch.Tensor, prepend_cond=None, prepend_cond_mask=None,
                cross_attn_cond=None, global_cond=None) -> torch.Tensor:
        """sequence [B, K, S] -> logits [B, K, S, card]."""
        out = self.backbone(self._embed(sequence), prepend_cond=prepend_cond,
                            prepend_cond_mask=prepend_cond_mask,
                            cross_attn_cond=cross_attn_cond, global_cond=global_cond)
        return self._heads(out)

    def init_cache(self, batch: int, max_len: int, prepend_len: int = 0,
                   dtype: torch.dtype = torch.float32):
        return self.backbone.init_cache(batch, max_len, prepend_len, dtype)

    def decode_step(self, sequence: torch.Tensor, caches, prepend_cond=None,
                    prepend_cond_mask=None, cross_attn_cond=None, global_cond=None):
        """sequence [B, K, n] tokens continuing the cached steps -> (logits
        [B, K, n, card], caches)."""
        out, caches = self.backbone.decode_step(
            self._embed(sequence), caches, cross_attn_cond=cross_attn_cond,
            prepend_cond=prepend_cond, prepend_cond_mask=prepend_cond_mask,
            global_cond=global_cond)
        return self._heads(out), caches


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

    # ---- generation --------------------------------------------------------

    @staticmethod
    def _sample_token(logits: torch.Tensor, generator: tp.Optional[torch.Generator],
                      top_k: int = 250, top_p: float = 0.0, temp: float = 1.0,
                      cfg_scale: float = 1.0) -> torch.Tensor:
        """logits [B (2B with CFG: conditioned rows first), K, n, card] -> the
        next tokens [B, K, 1] from the last step (JAX :198-213): the CFG lerp
        uncond + (cond - uncond) * cfg_scale, then a draw from softmax(l /
        temp) through top-p, top-k or all of it, or the argmax at temp 0."""
        if cfg_scale != 1.0:
            cond, uncond = logits.chunk(2, dim=0)
            logits = uncond + (cond - uncond) * cfg_scale
        logits = logits[:, :, -1, :]
        if temp > 0:
            probs = torch.softmax(logits.float() / temp, dim=-1)
            if top_p > 0.0:
                return sample_top_p(probs, top_p, generator)
            if top_k > 0:
                return sample_top_k(probs, top_k, generator)
            return multinomial(probs, 1, generator)
        return logits.argmax(-1, keepdim=True)

    @torch.no_grad()
    def generate(self, max_gen_len: int = 256, batch_size: tp.Optional[int] = None,
                 init_data: tp.Optional[torch.Tensor] = None,
                 conditioning: tp.Optional[tp.List[dict]] = None,
                 conditioning_tensors: tp.Optional[tp.Dict[str, tp.Any]] = None,
                 callback: tp.Optional[tp.Callable[[int, int], None]] = None,
                 use_cache: bool = True, cfg_scale: float = 1.0,
                 generator: tp.Optional[torch.Generator] = None, top_k: int = 250,
                 top_p: float = 0.0, temp: float = 1.0) -> torch.Tensor:
        """Autoregressive generation of codes [B, K, max_gen_len] (JAX
        :214-365). `init_data` [B, K, T0] continues a prompt's codes;
        `conditioning` (per-sample metadata for the conditioner) or
        `conditioning_tensors` ({id: (embeds, mask)}) condition it;
        `callback(step, total)` fires before each generated step;
        `generator` (on the model's device; a freshly seeded one if None)
        draws the samples. `use_cache=False` raises, as in the JAX package."""
        if not use_cache:
            raise NotImplementedError(
                "use_cache=False (recompute full attention per token) is not implemented: "
                "the decode always uses static KV caches")
        device = self.model.quantizer_heads[0].weight.device
        if generator is None:
            generator = torch.Generator(device=device)
            generator.seed()
        if conditioning_tensors is None and conditioning is not None:
            conditioning_tensors = self.conditioner(conditioning, device=device)
        if batch_size is None:
            if init_data is not None:
                batch_size = init_data.shape[0]
            elif conditioning_tensors:
                batch_size = next(iter(conditioning_tensors.values()))[0].shape[0]
            else:
                batch_size = 1

        start_offset = 0 if init_data is None else init_data.shape[-1]
        if start_offset >= max_gen_len:
            raise ValueError("init data longer than max gen length")
        pattern = self.pattern_provider.get_pattern(max_gen_len)
        unknown_token = -1
        gen_codes = torch.full((batch_size, self.num_quantizers, max_gen_len), unknown_token,
                               dtype=torch.long, device=device)
        if start_offset > 0:
            gen_codes[..., :start_offset] = init_data
        gen_sequence, _, mask = pattern.build_pattern_sequence(gen_codes, self.masked_token_id)
        mask = mask.to(device)
        start = pattern.get_first_step_with_timesteps(start_offset)
        if start is None:
            raise ValueError(f"the pattern has no step for timestep {start_offset}")
        steps = gen_sequence.shape[-1]

        inputs = self.get_conditioning_inputs(conditioning_tensors or {})
        use_cfg = cfg_scale != 1.0
        if use_cfg:  # the unconditioned rows: zero conditioning, the same prepend mask
            for kind in COND_KINDS:
                if inputs[kind] is not None:
                    inputs[kind] = torch.cat([inputs[kind], torch.zeros_like(inputs[kind])])
            if inputs["prepend_cond_mask"] is not None:
                inputs["prepend_cond_mask"] = inputs["prepend_cond_mask"].repeat(2, 1)
        prepend_len = 0 if inputs["prepend_cond"] is None else inputs["prepend_cond"].shape[1]

        def dup(a):
            return torch.cat([a, a]) if use_cfg else a

        caches = self.model.init_cache(batch_size * (2 if use_cfg else 1), steps, prepend_len)
        logits, caches = self.model.decode_step(dup(gen_sequence[..., :start]), caches, **inputs)
        step_inputs = {"cross_attn_cond": inputs["cross_attn_cond"],
                       "global_cond": inputs["global_cond"]}
        total = steps - start
        for offset in range(start, steps):
            if callback is not None:
                callback(offset + 1 - start, total)
            next_token = self._sample_token(logits, generator, top_k=top_k, top_p=top_p,
                                            temp=temp, cfg_scale=cfg_scale)
            next_token = torch.where(mask[None, :, offset:offset + 1], next_token,
                                     self.masked_token_id)
            cur = gen_sequence[..., offset:offset + 1]
            new = torch.where(cur == unknown_token, next_token, cur)
            gen_sequence[..., offset:offset + 1] = new
            logits, caches = self.model.decode_step(dup(new), caches, **step_inputs)

        out_codes, _, _ = pattern.revert_pattern_sequence(gen_sequence, unknown_token)
        if (out_codes[..., :max_gen_len] == unknown_token).any():
            raise RuntimeError("unknown tokens in the generated sequence")
        return out_codes

    def generate_audio(self, **kwargs) -> torch.Tensor:
        """`generate`'s codes decoded by the tokenizer: audio [B, C, T]."""
        return self.pretransform.decode_tokens(self.generate(**kwargs))


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
