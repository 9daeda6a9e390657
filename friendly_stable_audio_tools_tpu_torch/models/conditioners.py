"""Conditioners (counterpart of friendly_stable_audio_tools_tpu/models/conditioners.py).

Ported for Stable Audio Open 1.0 and 2.0: the frozen T5 prompt encoder
(SAO 1.0), the frozen CLAP text encoder (SA 2.0) and the number
conditioners of `seconds_start` / `seconds_total`, dispatched by a
MultiConditioner. Tokenising is host work, resolved as the JAX package's
ladder does (conditioners.py:128-225): a local sentencepiece `spiece.model`
(read by the port's own numpy-only copy of the tokenizer,
models/sentencepiece.py), then a local Hugging Face tokenizer when
`transformers` is installed (local files only, never a download), then the
deterministic hash tokenizer below.
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
import typing as tp
import warnings

import numpy as np
import torch
from torch import nn

from .clap import CLAPTextBranch, RobertaConfig
from .t5 import T5_CONFIGS, T5Encoder


class SimpleTokenizer:
    """Deterministic hash tokenizer for environments without a vocabulary
    file (JAX conditioners.py:91). Token ids do not match pretrained
    checkpoints; `is_fallback` lets a checkpoint loader refuse it."""

    warned = False
    is_fallback = True

    def __init__(self, vocab_size: int = 32100):
        self.vocab_size = vocab_size
        if not SimpleTokenizer.warned:
            logging.warning("Using SimpleTokenizer fallback (no local tokenizer files). "
                            "Token ids will NOT match pretrained checkpoints.")
            SimpleTokenizer.warned = True

    def __len__(self):
        return self.vocab_size

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


def _is_sentencepiece_family(name: str) -> bool:
    """Only T5-family (sentencepiece-unigram) names may resolve to a bare
    spiece.model: a BPE tokenizer such as CLAP's roberta-base must not pick
    up an unrelated T5 model and give wrong ids without an error (JAX
    conditioners.py:128)."""
    n = name.lower()
    return "t5" in n or "ul2" in n or "spiece" in n


def _find_spiece_model(name: str, tokenizer_path: tp.Optional[str]) -> tp.Optional[str]:
    """`tokenizer_path` (file or directory), then `$FSAT_TOKENIZER_DIR/<name>/`,
    then, for sentencepiece-family names only, `$FSAT_TOKENIZER_DIR/spiece.model`
    (JAX conditioners.py:138). An explicit file path that is not a `.model`
    is left to the Hugging Face step."""
    candidates = []
    if tokenizer_path:
        candidates.append(os.path.join(tokenizer_path, "spiece.model")
                          if os.path.isdir(tokenizer_path) else tokenizer_path)
    root = os.environ.get("FSAT_TOKENIZER_DIR")
    if root:
        candidates += [os.path.join(root, name.replace("/", "--"), "spiece.model"),
                       os.path.join(root, name, "spiece.model")]
        if _is_sentencepiece_family(name):
            candidates.append(os.path.join(root, "spiece.model"))
    explicit_file = bool(tokenizer_path) and not os.path.isdir(tokenizer_path)
    for c in candidates:
        if os.path.isfile(c):
            return None if explicit_file and not c.endswith(".model") else c
    if explicit_file:
        raise FileNotFoundError(f"tokenizer_path={tokenizer_path!r}: no spiece.model found")
    return None


def _local_hf_tokenizer(name: str, tokenizer_path: tp.Optional[str]):
    """A Hugging Face tokenizer from local files, when `transformers` is
    installed: `tokenizer_path`'s directory first, then the cache for
    `name`. Never downloads; None when neither is there."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            from transformers import AutoTokenizer
    except ImportError:
        return None
    sources = []
    if tokenizer_path:
        sources.append(tokenizer_path if os.path.isdir(tokenizer_path)
                       else os.path.dirname(tokenizer_path))
    sources.append(name)
    previous = logging.root.manager.disable
    logging.disable(logging.ERROR)
    try:
        for source in sources:
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    return AutoTokenizer.from_pretrained(source, local_files_only=True)
            except Exception:  # noqa: BLE001 - any failure moves down the ladder
                continue
    finally:
        logging.disable(previous)
    return None


def get_tokenizer(name: str, fallback_vocab: int = 32100,
                  tokenizer_path: tp.Optional[str] = None):
    """The JAX package's ladder (conditioners.py:183-225) without its online
    step: a local sentencepiece model, then a local Hugging Face tokenizer,
    then the hash fallback."""
    spiece = _find_spiece_model(name, tokenizer_path)
    if spiece is not None:
        from .sentencepiece import SentencePieceUnigramTokenizer

        # HF T5 tokenizers append 100 <extra_id_*> sentinels after the 32000 pieces
        extra = 100 if _is_sentencepiece_family(name) else 0
        return SentencePieceUnigramTokenizer.from_file(spiece, extra_ids=extra)
    hf = _local_hf_tokenizer(name, tokenizer_path)
    return hf if hf is not None else SimpleTokenizer(fallback_vocab)


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

    trainable = False

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


class CLAPTextConditioner(nn.Module):
    """The CLAP text branch as a conditioner (JAX conditioners.py:447).

    With `use_text_features`, the masked 768-d hidden states of RoBERTa
    layer `feature_layer_ix` [B, 77, 768] and the token mask; otherwise the
    512-d joint embedding [B, 1, 512] and an all-ones mask. A `proj_out`
    Linear only when that width differs from `output_dim` or `project_out`.
    Frozen (no gradient into the CLAP weights) unless `finetune`.
    `clap_ckpt_path`: a laion-clap checkpoint, read by
    utils/convert.py:clap_text_state_dict when the file exists; a missing
    file leaves the random weights with a warning, as in the JAX package.
    `audio_model_type` and `enable_fusion` describe the checkpoint's audio
    branch, which the text conditioner does not use. `roberta` shrinks the
    encoder for tests."""

    def __init__(self, output_dim: int, clap_ckpt_path: str = "", use_text_features: bool = False,
                 feature_layer_ix: int = -1, audio_model_type: str = "HTSAT-base",
                 enable_fusion: bool = True, project_out: bool = False, finetune: bool = False,
                 roberta: RobertaConfig = RobertaConfig()):
        super().__init__()
        self.use_text_features = use_text_features
        self.feature_layer_ix = feature_layer_ix
        self.trainable = finetune
        self.max_length = 77  # laion-clap's RoBERTa token budget
        self.tokenizer = get_tokenizer("roberta-base", 50265)
        self.clap = CLAPTextBranch(roberta, joint_embed_dim=None if use_text_features else 512)
        dim = roberta.hidden_size if use_text_features else 512
        self.proj_out = nn.Linear(dim, output_dim) if dim != output_dim or project_out else None
        self.clap_ckpt_path = clap_ckpt_path

    def load_checkpoint(self) -> bool:
        """Loads `clap_ckpt_path` into the CLAP weights when the file exists
        (the JAX conditioner's `init`, :500-525); returns whether it did."""
        if not self.clap_ckpt_path:
            return False
        if not os.path.exists(self.clap_ckpt_path):
            logging.warning(f"CLAP checkpoint {self.clap_ckpt_path} not found; using random init")
            return False
        if (getattr(self.tokenizer, "is_fallback", False)
                and os.environ.get("FSAT_ALLOW_FALLBACK_TOKENIZER") != "1"):
            raise RuntimeError(
                "CLAPTextConditioner: pretrained CLAP weights requested (clap_ckpt_path) but only "
                "the hash-fallback tokenizer is available: token ids would not match the "
                "checkpoint. Provide a local roberta-base tokenizer (FSAT_TOKENIZER_DIR/"
                "roberta-base/ or the Hugging Face cache), or set "
                "FSAT_ALLOW_FALLBACK_TOKENIZER=1 for smoke tests.")
        from ..utils.convert import clap_text_state_dict

        sd = torch.load(self.clap_ckpt_path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        # the checkpoint's projection is left out when only text features are used
        missing = self.clap.load_state_dict(clap_text_state_dict(sd), strict=False).missing_keys
        if missing:
            raise KeyError(f"CLAP checkpoint {self.clap_ckpt_path} lacks {missing[:5]}")
        return True

    def forward(self, texts: tp.Sequence[str], device=None):
        enc = self.tokenizer(list(texts), truncation=True, max_length=self.max_length,
                             padding="max_length", return_tensors="np")
        ids = torch.as_tensor(np.asarray(enc["input_ids"], np.int64), device=device)
        mask = torch.as_tensor(np.asarray(enc["attention_mask"]), device=device).bool()
        with torch.set_grad_enabled(self.trainable and torch.is_grad_enabled()):
            if self.use_text_features:
                h = self.clap.text_features(ids, mask, layer_ix=self.feature_layer_ix)
            else:
                h = self.clap(ids, mask)[:, None, :]
                mask = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
        h = h.float()
        if self.proj_out is not None:
            h = self.proj_out(h.to(self.proj_out.weight.dtype)).float()
        if self.use_text_features:
            h = h * mask[..., None].float()
        return h, mask


class IntConditioner(nn.Module):
    """Ints -> clamp to [min_val, max_val] -> offset -> embedding table
    [B, 1, dim] + all-ones mask (JAX conditioners.py:263-287)."""

    def __init__(self, output_dim: int, min_val: int = 0, max_val: int = 512):
        super().__init__()
        self.min_val, self.max_val = int(min_val), int(max_val)
        self.embed = nn.Module()
        self.embed.int_embedder = nn.Embedding(self.max_val - self.min_val + 1, output_dim)

    def forward(self, ints: tp.Sequence[int], device=None):
        arr = np.clip(np.asarray([int(i) for i in ints], np.int64), self.min_val, self.max_val)
        e = self.embed.int_embedder(torch.as_tensor(arr - self.min_val, device=device))[:, None, :]
        return e, torch.ones(e.shape[:2], dtype=torch.bool, device=e.device)


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
    """The `t5`, `clap_text`, `int` and `number` conditioner types of the JAX
    factory (conditioners.py:725); other types raise NotImplementedError."""
    conditioners = {}
    for info in config["configs"]:
        kwargs = {"output_dim": config["cond_dim"], **info["config"]}
        if info["type"] == "t5":
            conditioners[info["id"]] = T5Conditioner(**kwargs)
        elif info["type"] == "clap_text":
            conditioners[info["id"]] = CLAPTextConditioner(**kwargs)
        elif info["type"] == "int":
            conditioners[info["id"]] = IntConditioner(**kwargs)
        elif info["type"] == "number":
            conditioners[info["id"]] = NumberConditioner(**kwargs)
        else:
            raise NotImplementedError(f"conditioner type {info['type']!r} is not in the torch port")
    return MultiConditioner(conditioners, default_keys=config.get("default_keys", {}))
