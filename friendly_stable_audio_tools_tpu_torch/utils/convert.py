"""JAX parameter trees -> this port's state_dict.

The port names its modules after the JAX package's flax modules, so a
parameter's path carries over with three renames:

* a flax `Dense` kernel `[in, out]` becomes a torch `Linear` weight
  `[out, in]` (transposed); the other direction is
  friendly_stable_audio_tools_tpu/utils/torch_import.py:29-41;
* a flax `Embed` table `embedding` becomes `weight`, same layout;
* numbered children become list entries: `layer{i}` -> `layers.{i}`
  (transformer), `block{i}` -> `blocks.{i}` (T5, encoder, decoder), `res{i}` ->
  `res.{i}` (VAE residual units).

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
