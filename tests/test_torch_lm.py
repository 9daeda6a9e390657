"""The torch port's audio-LM modules against the JAX package: the causal
flash kernels' plain versions, the causal attention route, the codebook
patterns, the SEANet tokenizer and the LM's logits.

Inputs and weights come from numpy with fixed seeds, or from the JAX
package's initialisers carried over by utils/convert.py; fp32 on both sides.

* The causal K7 and K9: their plain versions against `_flash_forward` and
  `_flash_backward` with `causal=True` in Pallas interpret mode
  (FSAT_PALLAS_INTERPRET=1) at T 272 and 1100 (no multiple of the TPU's
  256/512 blocks nor of the CUDA kernels' 64): out and LSE rel-L2 <= 1e-5,
  dq/dk/dv rel-L2 <= 5e-5 (fp32 both sides, summation order only).
* The route: with the gate forced, a square causal self-attention goes
  through `FlashAttention` with causal set under grad (the causal K7 with
  its LSE, then the causal K9, never K8) and through the causal K7 without
  its LSE otherwise; gradients match autograd of the plain causal attention
  to rel-L2 1e-6. The plain causal attention matches `_xla_attention`'s
  `tril(k=Tk-Tq)` mask, rectangular (queries that see no key) and square,
  to rel-L2 1e-6.
* The five codebook pattern providers: index tables, built sequences and
  reverted logits equal to the JAX package's exactly, NaN positions
  included.
* The SEANet encoder (LSTM included) and decoder: rel-L2 <= 1e-5; the RVQ
  codes equal, except where a codebook's two nearest codes lie within 1e-5
  relative of each other (a tie that fp32 summation order may break either
  way; from there on that frame's later codebooks differ legitimately).
* `compute_logits` (CFG dropout off, and at 0.5 with one mask injected into
  both sides): rel-L2 <= 1e-5 over the valid entries, NaN positions and the
  mask identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friendly_stable_audio_tools_tpu.ops.attention as jattention
import friendly_stable_audio_tools_tpu.ops.pallas.flash_attention as jfa
from friendly_stable_audio_tools_tpu.models import codebook_patterns as jpat
from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.models import codebook_patterns as tpat
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.ops import attention as tattention
from friendly_stable_audio_tools_tpu_torch.ops.kernels import flash_attention as tflash
from friendly_stable_audio_tools_tpu_torch.utils.convert import convert_audio_lm

# the tiny LM: 2 causal layers 128 wide (2 heads of 64), 4 codebooks of 32;
# a SEANet of ratios (3, 2) (the encoder's order; one odd stride, as the
# MusicGen tokenizer's 5), so 6600 samples give 1100 frames and 1101 steps
# of the delay pattern, above the flash gate's 1024
RATIO, FRAMES = 6, 1100
SEANET = {"channels": 1, "dimension": 16, "n_filters": 4, "ratios": [2, 3],
          "n_residual_layers": 1, "dilation_base": 2, "lstm": 2, "norm": "weight_norm"}


def tiny_lm_config(conditioning: bool = True) -> dict:
    """The tiny LM in the JAX factory's schema; with `conditioning`, a
    t5-small prompt through projected cross-attention, as the MusicGen-small
    config conditions (musicgen_small_32khz.json)."""
    config = {
        "model_type": "lm", "sample_size": FRAMES * RATIO, "sample_rate": 32000,
        "audio_channels": 1,
        "model": {
            "pretransform": {"type": "autoencoder", "config": {
                "encoder": {"type": "seanet", "config": dict(SEANET)},
                "decoder": {"type": "seanet", "config": dict(SEANET)},
                "bottleneck": {"type": "rvq", "config": {
                    "num_quantizers": 4, "codebook_size": 32, "dim": 16}},
                "latent_dim": 16, "downsampling_ratio": RATIO, "io_channels": 1}},
            "lm": {"type": "continuous_transformer", "codebook_pattern": "delay",
                   "cross_attention_cond_ids": ["prompt"],
                   "config": {"embed_dim": 128, "depth": 2, "num_heads": 2, "ff_mult": 4,
                              "cross_attn_cond_dim": 512, "project_cross_attn_cond": True}}},
        "training": {"learning_rate": 1e-4, "use_ema": False,
                     "checkpoint": {"every_n_train_steps": 2}},
    }
    if conditioning:
        config["model"]["conditioning"] = {
            "configs": [{"id": "prompt", "type": "t5",
                         "config": {"t5_model_name": "t5-small", "max_length": 8}}],
            "cond_dim": 512}
    return config


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _np(t):
    return t.detach().float().numpy()


def _rel(got, want):
    got = np.asarray(_np(got) if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(_np(want) if isinstance(want, torch.Tensor) else want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _launches():
    return (tflash.forward_launches, tflash.serving_launches, tflash.backward_launches,
            tflash.fused_backward_launches, tflash.causal_forward_launches,
            tflash.causal_serving_launches, tflash.causal_backward_launches)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("FSAT_FUSED_BWD", raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# the causal K7 and K9
# ---------------------------------------------------------------------------

CAUSAL_SHAPES = [(3, 272), (2, FRAMES)]


def _causal_forward_jax(q, k, v):
    return jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                              jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K, save_stats=True)


@pytest.mark.parametrize("bh,t", CAUSAL_SHAPES)
def test_causal_flash_forward_plain_matches_pallas(interpret, bh, t):
    """out and LSE (the JAX kernel's lane 0, unpadded rows) rel-L2 <= 1e-5;
    without the LSE the same out."""
    q, k, v = (np.random.RandomState(t + i).randn(bh, t, 64).astype(np.float32)
               for i in range(3))
    want_out, want_lse = _causal_forward_jax(q, k, v)
    before = _launches()
    out, lse = tflash.flash_forward(_t(q), _t(k), _t(v), causal=True)
    served, none = tflash.flash_forward(_t(q), _t(k), _t(v), save_stats=False, causal=True)
    assert _launches() == before  # CPU tensors launch nothing
    assert out.shape == (bh, t, 64) and lse.shape == (bh, t) and none is None
    assert _rel(out, want_out) <= 1e-5
    assert _rel(lse, np.asarray(want_lse)[:, :t, 0]) <= 1e-5
    assert torch.equal(served, out)


@pytest.mark.parametrize("bh,t", CAUSAL_SHAPES)
def test_causal_flash_backward_plain_matches_pallas(interpret, bh, t):
    """dq, dk, dv against the causal two-pass `_flash_backward` from the same
    forward residuals, each rel-L2 <= 5e-5; the choice of backward is K9."""
    rng = np.random.RandomState(t + 7)
    q, k, v, g = (rng.randn(bh, t, 64).astype(np.float32) for _ in range(4))
    out, lse = _causal_forward_jax(q, k, v)
    want = jfa._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
                               jnp.asarray(g), True, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K)
    got = tflash.flash_attention_backward(_t(q), _t(k), _t(v), _t(out), _t(np.asarray(lse)[:, :t, 0]),
                                          _t(g), causal=True)
    assert tflash.backward_kernel(t, t, 64, causal=True) == "K9"
    for a, b in zip(got, want):
        assert a.shape == (bh, t, 64)
        assert _rel(a, b) <= 5e-5


# ---------------------------------------------------------------------------
# the causal route and the plain causal attention
# ---------------------------------------------------------------------------


def test_causal_attention_under_grad_goes_through_causal_k7_and_k9(monkeypatch):
    """The LM's square causal self-attention on the card, the kernel
    launches replaced by the plain versions run without an autograd graph
    (a CUDA kernel writes through a raw pointer): on meta tensors (which
    pass the device check as CUDA tensors do) the route and the graph; on
    CPU tensors with `uses_kernels` forced, the values. K8 is never taken."""
    calls = []

    def k7(q, k, v, kv_len=None, save_stats=True, causal=False):
        calls.append(("K7", save_stats, causal))
        with torch.no_grad():
            return tflash.flash_forward_plain(q, k, v, kv_len, save_stats, causal)

    def k9(*args, causal=False):
        calls.append(("K9", causal))
        return tflash.flash_backward_plain(*args, causal=causal)

    def k8(*args):
        calls.append(("K8",))
        return tflash.flash_backward_fused_plain(*args)

    monkeypatch.setattr(tflash, "flash_forward", k7)
    monkeypatch.setattr(tflash, "flash_backward", k9)
    monkeypatch.setattr(tflash, "flash_backward_fused", k8)
    t = FRAMES + 1
    q, k, v = (torch.empty(2, 2, t, 64, device="meta", requires_grad=True) for _ in range(3))
    out = tattention.scaled_dot_product_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert calls == [("K7", True, True), ("K9", True)]
    assert all(gr.shape == (2, 2, t, 64) for gr in grads)
    calls.clear()

    monkeypatch.setattr(tattention, "uses_kernels", lambda x: True)
    rng = np.random.RandomState(5)
    q, k, v = (_t(rng.randn(2, 2, t, 64) * 0.5).requires_grad_(True) for _ in range(3))
    g = _t(rng.randn(2, 2, t, 64))
    assert tattention.flash_gate(t, t, 64, False, causal=True)
    out = tattention.scaled_dot_product_attention(q, k, v, causal=True)
    assert any("FlashAttention" in type(f).__name__ for f, _ in out.grad_fn.next_functions)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert calls == [("K7", True, True), ("K9", True)]
    ref = tattention.attention(q, k, v, causal=True)
    want = torch.autograd.grad(ref, (q, k, v), g)
    assert _rel(out, ref) <= 1e-6
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-6

    calls.clear()
    with torch.no_grad():
        served = tattention.scaled_dot_product_attention(q, k, v, causal=True)
    assert calls == [("K7", False, True)]
    assert _rel(served, ref) <= 1e-6
    # the gate keeps causal cross-attention (Tq != Tk) and short sequences plain
    calls.clear()
    tattention.scaled_dot_product_attention(q, k[:, :, :600], v[:, :, :600], causal=True)
    tattention.scaled_dot_product_attention(q[:, :, :1000], k[:, :, :1000], v[:, :, :1000],
                                            causal=True)
    assert calls == []


@pytest.mark.parametrize("t_q,t_k,masked", [(40, 12, False), (40, 12, True), (33, 33, False)])
def test_plain_causal_attention_matches_xla(t_q, t_k, masked):
    """`attention(causal=True)` against `_xla_attention(causal=True)`: the
    LM's cross-attention is causal with fewer keys than queries, so its
    first Tq - Tk queries see no key and attend evenly to all of them."""
    rng = np.random.RandomState(t_q + t_k)
    q = rng.randn(2, 4, t_q, 64).astype(np.float32)
    k, v = (rng.randn(2, 2, t_k, 64).astype(np.float32) for _ in range(2))
    mask = rng.rand(2, t_k) > 0.3 if masked else None
    jk, jv = jattention._repeat_kv(jnp.asarray(k), jnp.asarray(v), 4)
    want = jattention._xla_attention(jnp.asarray(q), jk, jv, causal=True,
                                     mask=None if mask is None else jnp.asarray(mask)[:, None, None])
    got = tattention.attention(_t(q), _t(k), _t(v), None if mask is None else torch.tensor(mask),
                               causal=True)
    assert _rel(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# codebook patterns
# ---------------------------------------------------------------------------

PROVIDERS = ["parallel", "delay", "unroll", "coarse_first", "musiclm"]
JAX_PROVIDERS = {"parallel": jpat.ParallelPatternProvider, "delay": jpat.DelayedPatternProvider,
                 "unroll": jpat.UnrolledPatternProvider, "coarse_first": jpat.CoarseFirstPattern,
                 "musiclm": jpat.MusicLMPattern}


@pytest.mark.parametrize("name", PROVIDERS)
def test_codebook_patterns_match_jax(name):
    """Tables, built sequences (special token 32) and reverted logits (NaN)
    equal to the JAX package's, with and without keep_only_valid_steps."""
    t = 9
    jp, tp_ = JAX_PROVIDERS[name](4).get_pattern(t), tpat.PATTERN_PROVIDERS[name](4).get_pattern(t)
    assert tp_.layout == jp.layout
    rng = np.random.RandomState(3)
    codes = rng.randint(0, 32, (2, 4, t))
    for valid in (True, False):
        for a, b in zip(jp._build_table(t, 4, valid), tp_._build_table(t, 4, valid)):
            np.testing.assert_array_equal(a, b)
        want, _, want_mask = jp.build_pattern_sequence(jnp.asarray(codes, jnp.int32), 32, valid)
        got, _, got_mask = tp_.build_pattern_sequence(torch.tensor(codes), 32, valid)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
        s = got.shape[-1]
        for model_output in (True, False):
            for a, b in zip(jp._revert_table(s, 4, valid, model_output),
                            tp_._revert_table(s, 4, valid, model_output)):
                np.testing.assert_array_equal(a, b)
        logits = rng.randn(2, 5, 4, s).astype(np.float32)
        want, _, want_mask = jp.revert_pattern_logits(jnp.asarray(logits), float("nan"), valid)
        got, _, got_mask = tp_.revert_pattern_logits(torch.tensor(logits), float("nan"), valid)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # NaN == NaN here
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
        seq = tp_.build_pattern_sequence(torch.tensor(codes), 32, valid)[0]
        want, _, _ = jp.revert_pattern_sequence(jnp.asarray(seq.numpy()), -1, valid)
        got, _, _ = tp_.revert_pattern_sequence(seq, -1, valid)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the SEANet tokenizer and the LM's logits
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_models():
    """The JAX package's tiny LM without a conditioner (the conditioning
    tensors are passed in), de-zeroed, and the port's with its weights."""
    config = tiny_lm_config(conditioning=False)
    jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.params = dezero_params(jmodel.params)
    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(convert_audio_lm(jmodel.params, None, jmodel.pretransform.model.params),
                           strict=True)
    return jmodel, tmodel


def _audio(seed, n=2):
    return (np.random.RandomState(seed).randn(n, 1, FRAMES * RATIO) * 0.3).astype(np.float32)


def _seanet_part(jae, part):
    """The JAX codec's encoder or decoder as one jitted function of (params, x)."""
    return jax.jit(lambda params, a: jae.module.apply(
        {"params": params}, a, method=lambda m, y: getattr(m, part)(y)))


def test_seanet_encoder_and_decoder_match_jax(lm_models):
    """Encoder latents (through the residual LSTM) and the decoder's audio
    from them: rel-L2 <= 1e-5."""
    jmodel, tmodel = lm_models
    jae, tae = jmodel.pretransform.model, tmodel.pretransform.model
    x = _audio(11).transpose(0, 2, 1)
    want_z = _seanet_part(jae, "encoder")(jae.params, jnp.asarray(x))
    with torch.no_grad():
        got_z = tae.encoder(_t(x))
        got_y = tae.decoder(got_z)
    want_y = _seanet_part(jae, "decoder")(jae.params, want_z)
    assert got_z.shape == (2, FRAMES, 16) and _rel(got_z, want_z) <= 1e-5
    assert got_y.shape == want_y.shape and _rel(got_y, want_y) <= 1e-5


def test_tokenize_matches_jax(lm_models):
    """[B, K, T'] codes of `tokenize` equal to the JAX package's, up to
    near-ties of a codebook's two nearest codes (1e-5 relative)."""
    jmodel, tmodel = lm_models
    x = _audio(12)
    want = np.asarray(jax.jit(jmodel.pretransform.tokenize)(jnp.asarray(x)))
    got = tmodel.pretransform.tokenize(_t(x)).numpy()
    assert got.shape == want.shape == (2, 4, FRAMES)
    z = np.asarray(_seanet_part(jmodel.pretransform.model, "encoder")(
        jmodel.pretransform.model.params, jnp.asarray(x.transpose(0, 2, 1))), np.float64)
    books = [np.asarray(jmodel.pretransform.model.params["bottleneck"]["quantizer"]
                        [f"quantizer_{i}"]["codebook"], np.float64) for i in range(4)]
    residual, settled = z, np.zeros(z.shape[:2], bool)  # frames past a tie
    for i, cb in enumerate(books):
        d = ((residual[..., None, :] - cb) ** 2).sum(-1)
        two = np.sort(d, -1)[..., :2]
        tie = (two[..., 1] - two[..., 0]) <= 1e-5 * np.abs(two[..., 0])
        differ = got[:, i] != want[:, i]
        assert not (differ & ~settled & ~tie).any(), f"codebook {i}: codes differ off a near-tie"
        settled |= differ
        residual = residual - cb[want[:, i]]
    assert settled.mean() <= 0.01


@pytest.mark.parametrize("cfg_dropout", [None, [True, False]])
def test_compute_logits_matches_jax(lm_models, monkeypatch, cfg_dropout):
    """Pattern-shifted logits of JAX codes with random conditioning tokens:
    rel-L2 <= 1e-5 over the valid entries, NaN positions and the mask
    identical; with CFG dropout at 0.5 and the mask [True, False] in both
    (row 0's conditioning zeroed)."""
    jmodel, tmodel = lm_models
    rng = np.random.RandomState(13)
    codes = rng.randint(0, 32, (2, 4, FRAMES))
    emb = rng.randn(2, 8, 512).astype(np.float32)
    emask = np.ones((2, 8), bool)
    prob, kwargs = 0.0, {}
    if cfg_dropout is not None:
        prob = 0.5
        drawn = jnp.asarray(cfg_dropout)[:, None, None]
        monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: drawn)
        kwargs = {"cfg_dropout_masks": {"cross_attn_cond": torch.tensor(cfg_dropout)}}
    want = jmodel.compute_logits(jmodel.params, jnp.asarray(codes, jnp.int32),
                                 {"prompt": (jnp.asarray(emb), jnp.asarray(emask))},
                                 cfg_dropout_prob=prob, rng=jax.random.PRNGKey(1))
    with torch.no_grad():
        got = tmodel.compute_logits(torch.tensor(codes), {"prompt": (_t(emb), torch.tensor(emask))},
                                    cfg_dropout_prob=prob, **kwargs)
    wl, gl = np.asarray(want.logits), got.logits.numpy()
    assert gl.shape == (2, 4, FRAMES, 32)
    np.testing.assert_array_equal(np.isnan(gl), np.isnan(wl))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    valid = ~np.isnan(wl)
    assert _rel(gl[valid], wl[valid]) <= 1e-5
    if cfg_dropout is not None:  # the dropped row differs from the forward without dropout
        with torch.no_grad():
            plain = tmodel.compute_logits(torch.tensor(codes),
                                          {"prompt": (_t(emb), torch.tensor(emask))}).logits
        assert _rel(got.logits[0][valid[0]], plain[0][valid[0]]) > 1e-4
        np.testing.assert_array_equal(got.logits[1].numpy(), plain[1].numpy())  # NaN == NaN
