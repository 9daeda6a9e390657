"""What the torch port must not do: import the JAX package, fall back to the
CPU unasked, or let a BPE tokenizer name pick up a T5 sentencepiece model.
"""

import ast
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.models import conditioners as jcond
from friendly_stable_audio_tools_tpu_torch.models import conditioners as tcond
from friendly_stable_audio_tools_tpu_torch.models.sentencepiece import SentencePieceUnigramTokenizer

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "friendly_stable_audio_tools_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    files = sorted((REPO / "friendly_stable_audio_tools_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    bad = {str(f.relative_to(REPO)): root for f in files for root in _imported_roots(f)
           if root in FORBIDDEN}
    assert not bad, bad


def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
    """Without a CUDA device, the default device raises and names the switch."""
    from friendly_stable_audio_tools_tpu_torch.generate import main as generate_main
    from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
    from friendly_stable_audio_tools_tpu_torch.train import main as train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        generate_main(["--model-config", "x.json", "--cond-yaml-path", "p.yaml",
                       "--output-dir", "out"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_main(["--model-config", "x.json", "--dataset-config", "y.json"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        create_model_from_config({"model_type": "diffusion_cond"})


def _spiece_model_bytes() -> bytes:
    """A tiny sentencepiece ModelProto: <pad>, </s>, <unk> and three pieces."""
    def varint(n):
        out = b""
        while True:
            b, n = n & 0x7F, n >> 7
            if not n:
                return out + bytes([b])
            out += bytes([b | 0x80])

    def piece(text, score, ptype):
        p = text.encode()
        body = (b"\x0a" + varint(len(p)) + p + b"\x15" + struct.pack("<f", score)
                + b"\x18" + varint(ptype))
        return b"\x0a" + varint(len(body)) + body

    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2),
              ("▁a", -1.0, 1), ("b", -2.0, 1), ("▁", -3.0, 1)]
    return b"".join(piece(*p) for p in pieces)


def test_bare_spiece_model_serves_only_sentencepiece_names(tmp_path, monkeypatch):
    """A T5 spiece.model at the root of FSAT_TOKENIZER_DIR is T5's tokenizer,
    with the 100 extra ids; roberta-base does not pick it up (JAX
    conditioners.py:128-159)."""
    (tmp_path / "spiece.model").write_bytes(_spiece_model_bytes())
    monkeypatch.setenv("FSAT_TOKENIZER_DIR", str(tmp_path))
    t5 = tcond.get_tokenizer("t5-base")
    assert isinstance(t5, SentencePieceUnigramTokenizer) and len(t5) == 6 + 100
    roberta = tcond.get_tokenizer("roberta-base", 50265)
    assert getattr(roberta, "is_fallback", False) and len(roberta) == 50265
    for name in ("t5-base", "roberta-base"):
        assert tcond._find_spiece_model(name, None) == jcond._find_spiece_model(name, None)
        assert tcond._is_sentencepiece_family(name) == jcond._is_sentencepiece_family(name)
    # a name-scoped directory serves any name, without extra ids for BPE names
    (tmp_path / "roberta-base").mkdir()
    (tmp_path / "roberta-base" / "spiece.model").write_bytes(_spiece_model_bytes())
    assert len(tcond.get_tokenizer("roberta-base", 50265)) == 6


def test_hash_fallback_matches_the_jax_tokenizer():
    texts = ["A grand orchestral arrangement with thunderous percussion", "", "amen " * 90]
    got = tcond.SimpleTokenizer(50265)(texts, max_length=77)
    want = jcond.SimpleTokenizer(50265)(texts, max_length=77)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["attention_mask"].sum(1).tolist() == [8, 1, 77]
