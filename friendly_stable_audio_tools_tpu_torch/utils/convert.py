"""JAX parameter trees -> this port's state_dict.

The port names its modules after the JAX package's flax modules, so a
parameter's path carries over with three renames:

* a flax `Dense` kernel `[in, out]` becomes a torch `Linear` weight
  `[out, in]` (transposed); the other direction is
  friendly_stable_audio_tools_tpu/utils/torch_import.py:29-41;
* a flax `Embed` table `embedding` becomes `weight`, same layout;
* numbered children become list entries: `layer{i}` -> `layers.{i}`
  (transformer), `block{i}` -> `blocks.{i}` (T5, the VAEs' encoders and
  decoders, the ADP U-Net's resnet and transformer blocks; a ResnetBlock1d's
  `block1`/`block2` land in its `blocks` dict as "1"/"2"), `res{i}` ->
  `res.{i}` (VAE residual units).

An adaLN DiT's `layer{i}/to_scale_shift_gate/kernel` [D, 6D] becomes
`layers.{i}.to_scale_shift_gate.weight` [6D, D] by the Dense rule; its six
column blocks (scale, shift and gate of the self-attention, then of the
feed-forward) become the weight's six row blocks in the same order.

The DiT's other conditioning inputs need no rule of their own:
`to_prepend_embed/{0,2}/kernel` (the prepend condition's MLP) becomes
`to_prepend_embed.{0,2}.weight` by the Dense rule, the preprocess conv
widened by `input_concat_dim` keeps its `[1, C + Ci, C + Ci]` kernel as
`weight`, and with `patch_size` p the transformer's `project_in` [p (C +
Ci), dim] and `project_out` [dim, p C] transpose by the Dense rule, their
rows in the JAX package's channel-major patch order, which the port's DiT
folds the same way (tests/test_torch_train_options.py).

The ADP U-Net (`adp_cfg_1d`), the DAC encoder and decoder and the `int`
conditioners carry over by these rules alone: the port names their modules
as the JAX package does (`down{i}`, `up{j}`, `to_scale_shift.1`,
`fixed_embedding`, `embed.int_embedder`, `snake1`, ...).

The CLAP conditioner's tree `clap/text_branch/layer{i}/...` carries over by
the same rules (its LayerNorms keep `scale` and `bias`).

The audio LM (:func:`convert_audio_lm`): its embeddings `embed{i}` and
heads `head{i}` become `embeds.{i}` and `quantizer_heads.{i}`, its backbone
carries over by the rules above, and so does its SEANet tokenizer
(`block{i}_res{j}`, `down{i}`, `up{i}` and the RVQ's `quantizer_{i}/codebook`
keep their names), except the LSTMs: flax's `OptimizedLSTMCell` keeps one
Dense per gate, `ii`, `if`, `ig`, `io` on the input (no bias) and `hi`, `hf`,
`hg`, `ho` on the hidden state (with bias), which torch's `nn.LSTM` stacks
in the same gate order into `weight_ih_l{n}` [4H, in], `weight_hh_l{n}` [4H,
H] and `bias_hh_l{n}`, with `bias_ih_l{n}` zero.
:func:`clap_text_state_dict` reads a laion-clap checkpoint's text branch
instead, by the key map of the JAX package's `models/clap.py:convert_clap_text_branch`.

Dance Diffusion's U-Net (`DAU1d`) needs no rule of its own either: its
blocks keep the JAX names (`level{i}_in0`, `level{i}_attn3`, `conv1`,
`gn1`, `qkv_proj`, `timestep_embed`, `act1` for a Snake), its conv kernels
the [k, Cin, Cout] layout and its GroupNorms `scale` and `bias`. The
unconditional wrapper carries over by :func:`convert_diffusion_uncond`, the
diffusion autoencoder by :func:`convert_diffusion_autoencoder` (its `ae`
and `diffusion` trees), the mono-to-stereo prior by
:func:`convert_conditioned_diffusion`.

A standalone autoencoder (the `autoencoder` model type) carries over by
:func:`convert_autoencoder`, and the AE-GAN trainer's EnCodec discriminator
by :func:`convert_encodec_discriminator`: its scales `disc{i}` become
`discs.{i}` and each 2-D conv's HWIO `v` torch's [out, in, kh, kw].

Conv weights keep the JAX layout `[k, Cin, Cout]`, which the CUDA kernels
read: a plain `Conv1d` kernel becomes `weight` unchanged, and the
weight-normed convs keep `v`, `g`, `bias`. The magnitude `g` is per output
channel for a conv and per input channel for a transposed conv in both
packages (torch `weight_norm(dim=0)` semantics), so it needs no reshaping.
"""

from __future__ import annotations

import re
import typing as tp

import numpy as np
import torch

_NUMBERED = re.compile(r"^(layer|block|res)(\d+)$")
_LIST_NAME = {"layer": "layers", "block": "blocks", "res": "res"}


def _flatten(tree: tp.Mapping, prefix: tp.Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, tp.Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def state_dict_from_jax(tree: tp.Mapping, prefix: str = "") -> tp.Dict[str, torch.Tensor]:
    """Converts one JAX parameter (sub)tree, keys prefixed with `prefix`."""
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        names = []
        for part in path[:-1]:
            m = _NUMBERED.match(part)
            names += [_LIST_NAME[m.group(1)], m.group(2)] if m else [part]
        leaf_name = path[-1]
        if leaf_name == "kernel":
            leaf_name = "weight"
            if arr.ndim == 2:
                arr = arr.T
        elif leaf_name == "embedding":
            leaf_name = "weight"
        out[prefix + ".".join(names + [leaf_name])] = torch.tensor(arr)
    return out


_LSTM_LAYER = re.compile(r"^lstm(\d+)$")
_GATES = ("i", "f", "g", "o")  # torch's order of the four gates, and flax's


def _lstm_state(tree: tp.Mapping, prefix: str) -> tp.Dict[str, torch.Tensor]:
    """A flax `_LSTM` tree {lstm{n}: {ii, if, ig, io, hi, hf, hg, ho}} ->
    the state of a torch `nn.LSTM` under `prefix`."""
    out = {}
    for name, cell in tree.items():
        n = _LSTM_LAYER.match(name).group(1)
        w = lambda side: torch.tensor(np.concatenate(  # noqa: E731
            [np.asarray(cell[side + g]["kernel"], np.float32).T for g in _GATES]))
        bias = torch.tensor(np.concatenate([np.asarray(cell["h" + g]["bias"], np.float32)
                                            for g in _GATES]))
        out.update({f"{prefix}weight_ih_l{n}": w("i"), f"{prefix}weight_hh_l{n}": w("h"),
                    f"{prefix}bias_ih_l{n}": torch.zeros_like(bias),
                    f"{prefix}bias_hh_l{n}": bias})
    return out


def seanet_codec_state_dict(tree: tp.Mapping, prefix: str = "") -> tp.Dict[str, torch.Tensor]:
    """A JAX autoencoder tree with SEANet encoder/decoder (and any
    bottleneck) -> the port's state dict under `prefix`."""
    sd = {}
    for part, sub in tree.items():
        sub = dict(sub)
        lstm = sub.pop("lstm", None)
        sd.update(state_dict_from_jax(sub, f"{prefix}{part}."))
        if lstm is not None:
            sd.update(_lstm_state(lstm, f"{prefix}{part}.lstm.lstm."))
    return sd


def convert_autoencoder(tree: tp.Mapping, prefix: str = "") -> tp.Dict[str, torch.Tensor]:
    """A JAX `AudioAutoencoder`'s `params` ({encoder, decoder, and any
    bottleneck}; Oobleck, DAC or SEANet) -> the state_dict of the port's
    `AudioAutoencoder` under `prefix` (`pretransform.model.` inside a
    diffusion model or an LM)."""
    return seanet_codec_state_dict(tree, prefix)


def convert_encodec_discriminator(tree: tp.Mapping) -> tp.Dict[str, torch.Tensor]:
    """A JAX `EncodecDiscriminator`'s params ({disc{i}: {conv_in, conv{j},
    conv_mid, conv_post}}, each WNConv2d's `v` HWIO [kh, kw, in, out], `g`
    and `bias` [out]) -> the state_dict of the port's (`discs.{i}.`, `v`
    as torch's [out, in, kh, kw])."""
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "v":
            arr = arr.transpose(3, 2, 0, 1)
        disc = re.match(r"^disc(\d+)$", path[0]).group(1)
        out[".".join(("discs", disc) + path[1:])] = torch.tensor(arr)
    return out


def convert_audio_lm(lm_params: tp.Mapping,
                     conditioner_params: tp.Optional[tp.Mapping] = None,
                     pretransform_params: tp.Optional[tp.Mapping] = None
                     ) -> tp.Dict[str, torch.Tensor]:
    """The three trees of a JAX `AudioLanguageModelWrapper` (its `params`,
    `conditioner.params`, `pretransform.model.params`) -> a state_dict of the
    port's wrapper."""
    sd = {}
    for name, tree in lm_params.items():
        m = re.match(r"^(embed|head)(\d+)$", name)
        if m:
            where = {"embed": "embeds", "head": "quantizer_heads"}[m.group(1)]
            sd.update(state_dict_from_jax(tree, f"model.{where}.{m.group(2)}."))
        else:
            sd.update(state_dict_from_jax(tree, f"model.{name}."))
    for key, tree in (conditioner_params or {}).items():
        sd.update(state_dict_from_jax(tree, f"conditioner.conditioners.{key}."))
    if pretransform_params is not None:
        sd.update(seanet_codec_state_dict(pretransform_params, "pretransform.model."))
    return sd


def convert_conditioned_diffusion(dit_params: tp.Mapping,
                                  conditioner_params: tp.Optional[tp.Mapping] = None,
                                  pretransform_params: tp.Optional[tp.Mapping] = None
                                  ) -> tp.Dict[str, torch.Tensor]:
    """The three trees of a JAX `ConditionedDiffusionModelWrapper` (its
    `params`, `conditioner.params`, `pretransform.model.params`, encoder and
    decoder) -> a state_dict of the port's wrapper."""
    sd = state_dict_from_jax(dit_params, "model.")
    for key, tree in (conditioner_params or {}).items():
        sd.update(state_dict_from_jax(tree, f"conditioner.conditioners.{key}."))
    if pretransform_params is not None:
        sd.update(state_dict_from_jax(pretransform_params, "pretransform.model."))
    return sd


def convert_diffusion_uncond(params: tp.Mapping,
                             pretransform_params: tp.Optional[tp.Mapping] = None
                             ) -> tp.Dict[str, torch.Tensor]:
    """A JAX `DiffusionModelWrapper`'s `params` (the backbone's tree: Dance
    Diffusion's `level{i}_*` blocks, the ADP `UNet1d` or the DiT) and its
    pretransform's -> a state_dict of the port's `DiffusionModelWrapper`."""
    sd = state_dict_from_jax(params, "model.")
    if pretransform_params is not None:
        sd.update(state_dict_from_jax(pretransform_params, "pretransform.model."))
    return sd


def convert_diffusion_autoencoder(ae_params: tp.Mapping, diffusion_params: tp.Mapping,
                                  pretransform_params: tp.Optional[tp.Mapping] = None
                                  ) -> tp.Dict[str, torch.Tensor]:
    """A JAX `DiffusionAutoencoder`'s two trees (`params`: encoder, decoder
    and bottleneck; `diffusion.params`: the diffusion backbone) and its
    pretransform's -> a state_dict of the port's `DiffusionAutoencoder`."""
    sd = convert_autoencoder(ae_params)
    sd.update(state_dict_from_jax(diffusion_params, "diffusion.model."))
    if pretransform_params is not None:
        sd.update(state_dict_from_jax(pretransform_params, "pretransform.model."))
    return sd


def clap_text_state_dict(sd: tp.Mapping[str, tp.Any]) -> tp.Dict[str, torch.Tensor]:
    """A laion-clap checkpoint's state dict (keys with or without the
    `module.` DataParallel prefix) -> the state dict of the port's
    `CLAPTextBranch` (models/clap.py). Torch Linear weights keep their layout."""

    def get(key):
        for prefix in ("module.", ""):
            if prefix + key in sd:
                return torch.as_tensor(sd[prefix + key]).float()
        raise KeyError(key)

    out = {}

    def take(dst, src, leaves=(("weight", "weight"), ("bias", "bias"))):
        for d, s_ in leaves:
            out[f"{dst}.{d}"] = get(f"{src}.{s_}")

    ln = (("scale", "weight"), ("bias", "bias"))
    emb = "text_branch.embeddings"
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        take(f"text_branch.{name}", f"{emb}.{name}", (("weight", "weight"),))
    take("text_branch.embeddings_layernorm", f"{emb}.LayerNorm", ln)
    i = 0
    while any(f"text_branch.encoder.layer.{i}." in k for k in sd):
        src, dst = f"text_branch.encoder.layer.{i}", f"text_branch.layers.{i}"
        for part in ("query", "key", "value"):
            take(f"{dst}.attention.{part}", f"{src}.attention.self.{part}")
        take(f"{dst}.attention_output", f"{src}.attention.output.dense")
        take(f"{dst}.attention_layernorm", f"{src}.attention.output.LayerNorm", ln)
        take(f"{dst}.intermediate", f"{src}.intermediate.dense")
        take(f"{dst}.output", f"{src}.output.dense")
        take(f"{dst}.output_layernorm", f"{src}.output.LayerNorm", ln)
        i += 1
    take("projection_0", "text_projection.0")
    take("projection_2", "text_projection.2")
    return out
