"""Conditioners (counterpart of friendly_stable_audio_tools_tpu/models/conditioners.py).

Ported for Stable Audio Open 1.0: the frozen T5 prompt encoder and the
number conditioners of `seconds_start` / `seconds_total`, dispatched by a
MultiConditioner. Tokenising is host work: a local sentencepiece
`spiece.model` is read by the JAX package's numpy-only tokenizer
(`friendly_stable_audio_tools_tpu.models.sentencepiece`, the one module this
package imports from there); without one, the deterministic hash tokenizer
below stands in, exactly as in the JAX package.
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
import typing as tp

import numpy as np
import torch
from torch import nn

from .t5 import T5_CONFIGS, T5Encoder


class SimpleTokenizer:
    """Deterministic hash tokenizer for environments without a vocabulary
    file (JAX conditioners.py:91). Token ids do not match pretrained
    checkpoints."""

    warned = False

    def __init__(self, vocab_size: int = 32100):
        self.vocab_size = vocab_size
        if not SimpleTokenizer.warned:
            logging.warning("Using SimpleTokenizer fallback (no local spiece.model). "
                            "Token ids will NOT match pretrained checkpoints.")
            SimpleTokenizer.warned = True

    def __call__(self, texts, truncation=True, max_length=128, padding="max_length", **kw):
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            toks = [2 + int(hashlib.md5(w.encode()).hexdigest(), 16) % (self.vocab_size - 2)
                    for w in str(text).lower().split()]
            toks = toks[: max_length - 1] + [1]  # eos
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _find_spiece_model(name: str, tokenizer_path: tp.Optional[str]) -> tp.Optional[str]:
    """`tokenizer_path` (file or directory), then `$FSAT_TOKENIZER_DIR/<name>/`,
    then `$FSAT_TOKENIZER_DIR/spiece.model` (JAX conditioners.py:138)."""
    candidates = []
    if tokenizer_path:
        candidates.append(os.path.join(tokenizer_path, "spiece.model")
                          if os.path.isdir(tokenizer_path) else tokenizer_path)
    root = os.environ.get("FSAT_TOKENIZER_DIR")
    if root:
        candidates += [os.path.join(root, name.replace("/", "--"), "spiece.model"),
                       os.path.join(root, name, "spiece.model"),
                       os.path.join(root, "spiece.model")]
    for c in candidates:
        if os.path.isfile(c):
            return c
    if tokenizer_path:
        raise FileNotFoundError(f"tokenizer_path={tokenizer_path!r}: no spiece.model found")
    return None


def get_tokenizer(name: str, fallback_vocab: int = 32100,
                  tokenizer_path: tp.Optional[str] = None):
    """A local sentencepiece model when one is found, else the hash fallback."""
    spiece = _find_spiece_model(name, tokenizer_path)
    if spiece is None:
        return SimpleTokenizer(fallback_vocab)
    from friendly_stable_audio_tools_tpu.models.sentencepiece import SentencePieceUnigramTokenizer

    # HF T5 tokenizers append 100 <extra_id_*> sentinels after the 32000 pieces
    return SentencePieceUnigramTokenizer.from_file(spiece, extra_ids=100)


class NumberEmbedder(nn.Module):
    """[B] floats -> [x, sin(2 pi x w), cos(2 pi x w)] -> Linear."""

    def __init__(self, features: int, dim: int = 256):
        super().__init__()
        self.pos = nn.Module()
        self.pos.weights = nn.Parameter(torch.empty(dim // 2))
        self.to_out = nn.Linear(dim + 1, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None].float()
        f = x * self.pos.weights.float()[None, :] * 2 * math.pi
        h = torch.cat([x, torch.sin(f), torch.cos(f)], dim=-1)
        return self.to_out(h.to(self.to_out.weight.dtype))


class NumberConditioner(nn.Module):
    """Floats -> clamp -> [0, 1] -> Fourier embedding [B, 1, dim] + all-ones mask."""

    def __init__(self, output_dim: int, min_val: float = 0.0, max_val: float = 1.0):
        super().__init__()
        self.min_val, self.max_val = float(min_val), float(max_val)
        self.embedder = NumberEmbedder(output_dim)

    def forward(self, floats: tp.Sequence[float], device=None):
        arr = np.clip(np.asarray([float(x) for x in floats], np.float32), self.min_val, self.max_val)
        arr = (arr - self.min_val) / (self.max_val - self.min_val)
        e = self.embedder(torch.as_tensor(arr, device=device))[:, None, :]
        return e, torch.ones(e.shape[:2], dtype=torch.bool, device=e.device)


class T5Conditioner(nn.Module):
    """Frozen T5 encoder -> masked token embeddings [B, max_length, dim]."""

    def __init__(self, output_dim: int, t5_model_name: str = "t5-base", max_length: int = 128,
                 project_out: bool = False, tokenizer_path: tp.Optional[str] = None):
        super().__init__()
        if t5_model_name not in T5_CONFIGS:
            raise ValueError(f"Unknown T5 model name: {t5_model_name}")
        cfg = T5_CONFIGS[t5_model_name]
        self.max_length = max_length
        self.tokenizer = get_tokenizer(t5_model_name, cfg.vocab_size, tokenizer_path)
        self.t5 = T5Encoder(cfg)
        self.proj_out = (nn.Linear(cfg.d_model, output_dim)
                         if cfg.d_model != output_dim or project_out else None)

    def forward(self, texts: tp.Sequence[str], device=None):
        enc = self.tokenizer(list(texts), truncation=True, max_length=self.max_length,
                             padding="max_length", return_tensors="np")
        ids = torch.as_tensor(np.asarray(enc["input_ids"], np.int64), device=device)
        mask = torch.as_tensor(np.asarray(enc["attention_mask"]), device=device).bool()
        with torch.no_grad():
            h = self.t5(ids, mask).float()
        if self.proj_out is not None:
            h = self.proj_out(h.to(self.proj_out.weight.dtype)).float()
        return h * mask[..., None].float(), mask


class MultiConditioner(nn.Module):
    """Keyed dispatch over conditioners with default-key aliasing."""

    def __init__(self, conditioners: tp.Dict[str, nn.Module],
                 default_keys: tp.Optional[tp.Dict[str, str]] = None):
        super().__init__()
        self.conditioners = nn.ModuleDict(conditioners)
        self.default_keys = default_keys or {}

    def forward(self, batch_metadata: tp.List[tp.Dict[str, tp.Any]], device=None):
        """Per-sample metadata dicts -> {id: (embeds [B, N, D], mask [B, N])}."""
        out = {}
        for key, conditioner in self.conditioners.items():
            inputs = []
            for x in batch_metadata:
                ckey = key if key in x else self.default_keys.get(key)
                if ckey is None or ckey not in x:
                    raise ValueError(f"Conditioner key {key} not found in batch metadata")
                val = x[ckey]
                inputs.append(val[0] if isinstance(val, (list, tuple)) and len(val) == 1 else val)
            out[key] = conditioner(inputs, device=device)
        return out


def create_multi_conditioner_from_conditioning_config(config: tp.Dict[str, tp.Any]):
    """The `t5` and `number` conditioner types of the JAX factory
    (conditioners.py:725); other types raise NotImplementedError."""
    conditioners = {}
    for info in config["configs"]:
        kwargs = {"output_dim": config["cond_dim"], **info["config"]}
        if info["type"] == "t5":
            conditioners[info["id"]] = T5Conditioner(**kwargs)
        elif info["type"] == "number":
            conditioners[info["id"]] = NumberConditioner(**kwargs)
        else:
            raise NotImplementedError(f"conditioner type {info['type']!r} is not in the torch port")
    return MultiConditioner(conditioners, default_keys=config.get("default_keys", {}))
