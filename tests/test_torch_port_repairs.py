"""What the torch port must not do: import the JAX package, fall back to the
CPU unasked, let a BPE tokenizer name pick up a T5 sentencepiece model, run
another dtype than the reference's (the CLIs' bf16 casts, an ignored
`model_half`, TF32 convolutions), or refuse an fp32 qkv where the JAX
inference attention casts it.
"""

import ast
import copy
import json
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from friendly_stable_audio_tools_tpu.models import conditioners as jcond
from friendly_stable_audio_tools_tpu.ops.embeddings import rotary_freqs as jax_rotary_freqs
from friendly_stable_audio_tools_tpu.ops.pallas import flash_attention as jfa
from friendly_stable_audio_tools_tpu_torch.models import conditioners as tcond
from friendly_stable_audio_tools_tpu_torch.models.pretransforms import create_pretransform_from_config
from friendly_stable_audio_tools_tpu_torch.models.sentencepiece import SentencePieceUnigramTokenizer
from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention as tattn
from friendly_stable_audio_tools_tpu_torch.utils.common import init_weights_

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
    names = {f.name for f in files}
    assert {"adp.py", "dac_codec.py", "attention.py", "conv1d.py", "flash_attention.py"} <= names
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


CONFIGS = REPO / "friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio"


def _tiny_pretransform_config(model_half=None):
    pt = copy.deepcopy(json.loads((CONFIGS / "stable_audio_open_1_0.json").read_text())["model"]
                       ["pretransform"])
    cfg = pt["config"]
    cfg.update(latent_dim=4, downsampling_ratio=8)
    cfg["encoder"]["config"].update(channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=8)
    cfg["decoder"]["config"].update(channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=4)
    if model_half is not None:
        pt["model_half"] = model_half
    return pt


@pytest.mark.parametrize("model_half", [None, False, True])
def test_model_half_sets_the_pretransform_dtype(model_half):
    """As the JAX pretransform (models/pretransforms.py:80-81): `model_half`
    casts the VAE's input to bf16, its absence keeps fp32; the parameters
    stay fp32 either way and the latents and audio come back fp32."""
    pt = init_weights_(create_pretransform_from_config(_tiny_pretransform_config(model_half)),
                       torch.Generator().manual_seed(0))
    want = torch.bfloat16 if model_half else torch.float32
    assert pt.dtype == want
    seen = []
    for part in (pt.model.encoder, pt.model.decoder):
        part.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
    z = pt.encode_nwc(torch.randn(1, 64, 2, generator=torch.Generator().manual_seed(1)))
    audio = pt.decode_nwc(z)
    assert seen == [want, want]
    assert z.dtype == audio.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pt.parameters())


class _FakeModel(nn.Module):
    """Stands in for the built model: records the dtypes and TF32 flags the
    entry point hands on."""

    def __init__(self):
        super().__init__()
        self.model = nn.Linear(2, 2)
        self.pretransform = nn.Linear(2, 2)


def _seen(model):
    return {"model": model.model.weight.dtype, "pretransform": model.pretransform.weight.dtype,
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32}


@pytest.fixture
def tf32_on(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)


def test_generate_cli_keeps_the_model_dtype_and_turns_tf32_off(tmp_path, monkeypatch, tf32_on):
    from friendly_stable_audio_tools_tpu_torch import generate
    from friendly_stable_audio_tools_tpu_torch.inference import generation
    from friendly_stable_audio_tools_tpu_torch.models import factory

    seen = []
    monkeypatch.setattr(factory, "create_model_from_config", lambda cfg, device: _FakeModel())

    def fake_generate(model, **kw):
        seen.append(_seen(model))
        return torch.zeros(len(kw["conditioning"]), 2, 16)

    monkeypatch.setattr(generation, "generate_diffusion_cond", fake_generate)
    config = tmp_path / "model.json"
    config.write_text(json.dumps({"sample_rate": 44100, "sample_size": 16}))
    prompts = tmp_path / "p.yaml"
    prompts.write_text("a:\n  b:\n    prompt: x\n    seconds_start: 0\n    seconds_total: 1\n")
    generate.main(["--model-config", str(config), "--cond-yaml-path", str(prompts),
                   "--output-dir", str(tmp_path / "out"), "--device", "cpu"])
    assert seen == [{"model": torch.float32, "pretransform": torch.float32,
                     "matmul_tf32": False, "cudnn_tf32": False}]


def test_train_cli_keeps_the_model_dtype_and_turns_tf32_off(tmp_path, monkeypatch, tf32_on):
    from friendly_stable_audio_tools_tpu_torch import train
    from friendly_stable_audio_tools_tpu_torch.data import dataset
    from friendly_stable_audio_tools_tpu_torch.models import factory
    from friendly_stable_audio_tools_tpu_torch.training import factory as tfactory

    seen = []

    class Stop(Exception):
        pass

    def fake_wrapper(config, model):
        seen.append(_seen(model))
        raise Stop

    monkeypatch.setattr(dataset, "create_dataloader_from_config", lambda *a, **kw: [])
    monkeypatch.setattr(factory, "create_model_from_config", lambda *a, **kw: _FakeModel())
    monkeypatch.setattr(tfactory, "create_training_wrapper_from_config", fake_wrapper)
    config = tmp_path / "model.json"
    config.write_text(json.dumps({"sample_rate": 44100, "sample_size": 16, "audio_channels": 2}))
    data = tmp_path / "data.json"
    data.write_text(json.dumps({"dataset_type": "audio_dir", "datasets": []}))
    with pytest.raises(Stop):
        train.main(["--model-config", str(config), "--dataset-config", str(data),
                    "--device", "cpu", "--save-dir", str(tmp_path)])
    assert seen == [{"model": torch.float32, "pretransform": torch.float32,
                     "matmul_tf32": False, "cudnn_tf32": False}]


@pytest.mark.parametrize("t,h", [(1025, 4), (2176, 2)])
def test_inference_attention_on_fp32_qkv_matches_the_jax_kernels(monkeypatch, t, h):
    """On the card, an fp32 qkv reaches K1 (T 1025) or K10a/K10 (T 2176) as
    `kernel_input(qkv)`, bf16, and the output returns fp32. The plain
    versions on that input against the JAX functions on the fp32 input in
    interpret mode, which cast it alike (flash_attention.py:851-853,
    :1262-1264, :1314): within one bf16 rounding of the output's peak."""
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(t)
    qkv = rng.randn(1, t, 3 * h * 64).astype(np.float32)
    freqs = np.asarray(jax_rotary_freqs(t, 32))
    x = tattn.kernel_input(torch.tensor(qkv))
    ft = torch.tensor(freqs)
    if t <= tattn.PAIR_MAX_T:
        got = tattn.fused_qkv_rope_attention_plain(x, ft, h).float()
        want = np.asarray(jfa._fused_pair_forward(jnp.asarray(qkv), jnp.asarray(freqs), h))
    else:
        got = tattn.fused_qkv_rope_attention_long_plain(x, ft, h).float()
        want = np.asarray(jfa._pair_long(jnp.asarray(qkv), jnp.asarray(freqs), h))
    assert x.dtype == torch.bfloat16 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2.0 ** -7 * np.abs(want).max())
