"""The torch port's CLAP text encoder (models/clap.py), its conditioner and
the laion-clap checkpoint loader against the JAX package.

Inputs are made with numpy and fed to both packages; weights are the JAX
package's, carried over by utils/convert.py. Everything is fp32; tolerance
1e-4 absolute on values of order 1 (fp32 sums in another order through a
few layers of LayerNorm and GELU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.models.clap import CLAPTextBranch as JCLAPTextBranch
from friendly_stable_audio_tools_tpu.models.clap import RobertaConfig as JRobertaConfig
from friendly_stable_audio_tools_tpu.models.clap import convert_clap_text_branch
from friendly_stable_audio_tools_tpu_torch.models.clap import CLAPTextBranch, RobertaConfig
from friendly_stable_audio_tools_tpu_torch.models.conditioners import CLAPTextConditioner
from friendly_stable_audio_tools_tpu_torch.utils.common import init_weights_
from friendly_stable_audio_tools_tpu_torch.utils.convert import (
    clap_text_state_dict,
    state_dict_from_jax,
)

SMALL = dict(vocab_size=120, hidden_size=64, num_layers=3, num_heads=4, intermediate_size=128,
             max_position_embeddings=40)
# the conditioner's hash tokenizer draws from RoBERTa's vocabulary, 77 tokens
COND_SMALL = dict(SMALL, vocab_size=50265, max_position_embeddings=514)
ATOL = 1e-4


def _ids_and_mask():
    rng = np.random.RandomState(0)
    ids = rng.randint(2, SMALL["vocab_size"], (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 7:] = 0  # padded rows: positions stop counting, keys are masked
    mask[2, 3:] = 0
    ids[mask == 0] = 1
    return ids, mask


@pytest.fixture(scope="module")
def small_branch():
    jb = JCLAPTextBranch(JRobertaConfig(**SMALL))
    ids, mask = _ids_and_mask()
    params = jb.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"]
    # the fresh LayerNorms are identity: perturb them so the test sees their parameters
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(len(str(path))), p.shape)
        if "layernorm" in str(path) else p, params)
    tb = CLAPTextBranch(RobertaConfig(**SMALL))
    tb.load_state_dict(state_dict_from_jax(params), strict=True)
    return jb, params, tb.eval()


def test_clap_text_branch_matches_jax_hidden_states_and_pooled(small_branch):
    jb, params, tb = small_branch
    ids, mask = _ids_and_mask()
    with torch.no_grad():
        _, hs = tb.text_branch(torch.tensor(ids, dtype=torch.long), torch.tensor(mask),
                               return_hidden_states=True)
        pooled = tb(torch.tensor(ids, dtype=torch.long), torch.tensor(mask))
    assert len(hs) == SMALL["num_layers"] + 1
    for ix in range(-len(hs), 0):
        want = jb.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), layer_ix=ix,
                        method=JCLAPTextBranch.text_features)
        np.testing.assert_allclose(hs[ix].numpy(), np.asarray(want), atol=ATOL, err_msg=str(ix))
    want = jb.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(pooled.numpy(), axis=-1), 1.0, atol=1e-5)


def _laion_state_dict(tb: CLAPTextBranch, prefix: str = "module.") -> dict:
    """A laion-clap-style state dict holding `tb`'s weights (HF RoBERTa
    names under text_branch., the projection as text_projection.0/.2)."""
    rng = np.random.RandomState(3)
    sd = {}
    for name, p in tb.state_dict().items():
        value = torch.tensor(rng.randn(*p.shape).astype(np.float32))
        key = (name.replace("text_branch.layers.", "text_branch.encoder.layer.")
               .replace("attention.query", "attention.self.query")
               .replace("attention.key", "attention.self.key")
               .replace("attention.value", "attention.self.value")
               .replace("attention_output", "attention.output.dense")
               .replace("attention_layernorm", "attention.output.LayerNorm")
               .replace("intermediate", "intermediate.dense")
               .replace("output_layernorm", "output.LayerNorm")
               .replace(".output.weight", ".output.dense.weight")
               .replace(".output.bias", ".output.dense.bias")
               .replace("embeddings_layernorm", "embeddings.LayerNorm")
               .replace("projection_", "text_projection.")
               .replace(".scale", ".weight"))
        for emb in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
            key = key.replace(f"text_branch.{emb}", f"text_branch.embeddings.{emb}")
        sd[prefix + key] = value
    sd["module.logit_scale_t"] = torch.ones(())  # other laion-clap entries are ignored
    return sd


def test_laion_clap_loader_matches_the_jax_key_map():
    tb = CLAPTextBranch(RobertaConfig(**SMALL))
    sd = _laion_state_dict(tb)
    got = clap_text_state_dict(sd)
    want = state_dict_from_jax(convert_clap_text_branch({k: v.numpy() for k, v in sd.items()}))
    assert sorted(got) == sorted(want) == sorted(tb.state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_clap_conditioner_reads_a_checkpoint_only_with_a_real_tokenizer(tmp_path, monkeypatch, caplog):
    monkeypatch.delenv("FSAT_TOKENIZER_DIR", raising=False)
    tb = CLAPTextBranch(RobertaConfig(**SMALL))
    sd = _laion_state_dict(tb)
    path = tmp_path / "clap.pt"
    torch.save({"state_dict": sd, "epoch": 15}, path)

    def conditioner(ckpt):
        c = CLAPTextConditioner(SMALL["hidden_size"], clap_ckpt_path=str(ckpt),
                                use_text_features=True, feature_layer_ix=-2,
                                roberta=RobertaConfig(**SMALL))
        return init_weights_(c, torch.Generator().manual_seed(0))

    c = conditioner(path)
    assert c.tokenizer.is_fallback and c.proj_out is None
    with pytest.raises(RuntimeError, match="fallback tokenizer"):
        c.load_checkpoint()
    monkeypatch.setenv("FSAT_ALLOW_FALLBACK_TOKENIZER", "1")
    assert c.load_checkpoint()
    want = clap_text_state_dict(sd)
    for k, v in c.clap.state_dict().items():  # the projection is left out with text features
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    assert not conditioner(tmp_path / "missing.pt").load_checkpoint()
    assert "not found" in caplog.text


def test_clap_conditioner_is_frozen_unless_finetuned():
    kw = dict(use_text_features=True, feature_layer_ix=-2, roberta=RobertaConfig(**COND_SMALL))
    for finetune in (False, True):
        c = init_weights_(CLAPTextConditioner(32, finetune=finetune, **kw),
                          torch.Generator().manual_seed(0))
        assert c.trainable is finetune and c.proj_out is not None  # 64 -> 32
        h, mask = c(["a calm piano", "drums"])
        assert h.shape == (2, 77, 32) and mask.shape == (2, 77)
        h.sum().backward()
        # layer -2's features: the last layer takes no part
        last = f"text_branch.layers.{COND_SMALL['num_layers'] - 1}."
        grads = [p.grad is not None for n, p in c.clap.named_parameters()
                 if not n.startswith(last)]
        assert all(grads) if finetune else not any(grads)
        assert c.proj_out.weight.grad is not None
