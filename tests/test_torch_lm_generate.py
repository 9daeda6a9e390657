"""The torch port's audio-LM generation against the JAX package: the fused
SwiGLU MLP K13's plain version and its routing, the static-KV-cache decode,
the samplers, `generate` and the token decoder.

Inputs and weights come from numpy with fixed seeds, or from the JAX
package's initialisers carried over by utils/convert.py (tests/
test_torch_lm.py's tiny LM: 2 causal layers 128 wide, 4 codebooks of 32, a
ratio-6 SEANet); fp32 unless a test says otherwise. The JAX side runs on the
CPU; where its fused-MLP path is wanted, FSAT_FUSED_MLP=1 with
FSAT_PALLAS_INTERPRET=1 runs its Pallas `glu_mlp` in interpret mode.

* K13: `glu_mlp_plain` against the JAX `glu_mlp` at M 2, 16, 100 and 2052,
  with and without biases: fp32 rel-L2 <= 1e-5 (summation order only); bf16
  within one bf16 rounding (rel-L2 <= 2^-8 and max abs <= 2^-7 of
  max|ref|: the two sides may round a v, g or h entry to neighbouring bf16
  values when their fp32 sums differ in the last bits).
* `FeedForward` with the switch on against the JAX one under
  FSAT_FUSED_MLP=1 (rel-L2 <= 1e-5), through K13's wrapper exactly when
  inner % 128 == 0 on both sides; the value rows of `GLU.proj` are the JAX
  w_in[:, :inner]. Under grad the wrapper is never entered and the
  gradients equal the unfused chain's. `create_model_from_config`'s
  `fused_mlp` reaches every FeedForward, off by default.
* The cached decode: per-step logits of a prefill and single-token steps
  at CFG batch 2 with cross-attention context, against the JAX
  `decode_step` on the same teacher-forced tokens, with the fused MLP off
  and on: rel-L2 <= 1e-5 at every step.
* The samplers given JAX's Gumbel draws return JAX's tokens.
* `generate`, greedy (temp 0) with CFG 3: the port's codes equal JAX's
  wherever JAX's top-2 logit margin exceeds 100x the logits tolerance (1e-5
  of the logits' largest magnitude): the first token that differs, if any,
  must sit on a decision within that margin, and at least 3/4 of the
  decisions must clear it; the same for a prompt continuation, whose prompt
  codes are kept; `callback` sees steps 1..total once each, as the JAX one
  does.
* `decode_tokens` (RVQ lookups through the SEANet decoder): rel-L2 <= 1e-5,
  and `generate_audio`'s shape equals the JAX decoder's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.models import utils as jutils
from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.models.transformer import FeedForward as JFeedForward
from friendly_stable_audio_tools_tpu.ops.pallas import mlp as jmlp
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.models import utils as tutils
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.models.transformer import FeedForward
from friendly_stable_audio_tools_tpu_torch.ops.kernels import mlp as tmlp
from friendly_stable_audio_tools_tpu_torch.utils.convert import convert_audio_lm, state_dict_from_jax
from tests.test_torch_lm import tiny_lm_config

CARD = 32  # the tiny LM's codebook size
GEN_LEN = 24  # frames generated: 28 steps of the delay pattern


def _rel(got, want):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.float().numpy() if isinstance(want, torch.Tensor) else want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture
def fused_jax(monkeypatch):
    """The JAX package's fused-MLP switch on, its Pallas kernel in interpret mode."""
    monkeypatch.setenv("FSAT_FUSED_MLP", "1")
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("FSAT_DISABLE_FUSED_MLP", raising=False)
    return monkeypatch


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------


def _mlp_inputs(m, k, inner, k_out, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32) * 0.3,
            rng.randn(k, inner).astype(np.float32) * 0.05,
            rng.randn(k, inner).astype(np.float32) * 0.05,
            rng.randn(inner, k_out).astype(np.float32) * 0.05,
            rng.randn(inner).astype(np.float32) * 0.1,
            rng.randn(inner).astype(np.float32) * 0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,bias", [(2, True), (16, False), (100, True), (2052, False)])
def test_glu_mlp_plain_matches_pallas(fused_jax, dtype, m, bias):
    k, inner, k_out = 128, 256, 96
    x, wv, wg, wo, bv, bg = _mlp_inputs(m, k, inner, k_out, seed=m)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jmlp.glu_mlp(jnp.asarray(x, jdt), jnp.asarray(wv, jdt), jnp.asarray(wg, jdt),
                        jnp.asarray(wo, jdt), jnp.asarray(bv) if bias else None,
                        jnp.asarray(bg) if bias else None)
    w_in = torch.tensor(np.concatenate([wv, wg], axis=1).T.copy()).to(tdt)
    b_in = torch.tensor(np.concatenate([bv, bg])) if bias else None
    got = tmlp.glu_mlp(torch.tensor(x).to(tdt), w_in, b_in, torch.tensor(wo.T.copy()).to(tdt))
    assert got.dtype == tdt and got.shape == (m, k_out)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        assert _rel(got, want) <= 1e-5
    else:
        assert _rel(got, want) <= 2.0 ** -8
        assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("mult,fused", [(4, True), (1.5, False)])
def test_feedforward_fused_mlp_matches_jax(fused_jax, mult, fused):
    dim, inner = 128, int(128 * mult)
    x = np.random.RandomState(4).randn(2, 3, dim).astype(np.float32) * 0.3
    jff = JFeedForward(dim=dim, mult=mult, zero_init_output=False)
    params = jff.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    jcalls = _count_calls(fused_jax, jmlp, "glu_mlp")
    want = jff.apply({"params": params}, jnp.asarray(x))
    ff = FeedForward(dim, mult=mult, zero_init_output=False)
    ff.load_state_dict(state_dict_from_jax(params), strict=True)
    ff.fused_mlp = True
    tcalls = _count_calls(fused_jax, tmlp, "glu_mlp")
    with torch.no_grad():
        got = ff(torch.tensor(x))
    assert len(jcalls) == len(tcalls) == int(fused)
    assert _rel(got, want) <= 1e-5
    # GLU.proj keeps the value rows first: the JAX w_in[:, :inner]
    w_in = np.asarray(params["linear_in"]["proj"]["kernel"])
    np.testing.assert_array_equal(ff.linear_in.proj.weight[:inner].detach().numpy(), w_in[:, :inner].T)


def test_fused_feedforward_under_grad_takes_the_plain_chain(monkeypatch):
    torch.manual_seed(0)
    ff = FeedForward(128, mult=4, zero_init_output=False)
    x = torch.randn(2, 5, 128)
    calls = _count_calls(monkeypatch, tmlp, "glu_mlp")

    def grads(fused):
        ff.fused_mlp = fused
        ff.zero_grad()
        xg = x.clone().requires_grad_(True)
        ff(xg).square().sum().backward()
        return [xg.grad] + [p.grad.clone() for p in ff.parameters()]

    fused, unfused = grads(True), grads(False)
    assert not calls
    for a, b in zip(fused, unfused):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():
        ff.fused_mlp = True
        got = ff(x)
        ff.fused_mlp = False
        want = ff(x)
    assert len(calls) == 1 and _rel(got, want) <= 1e-6


def test_factory_switch_reaches_every_feedforward():
    """create_model_from_config(..., fused_mlp=True) turns K13 on in each of
    the LM's FeedForwards; off by default, as FSAT_FUSED_MLP is unset."""
    config = tiny_lm_config(conditioning=False)
    for kwargs, want in (({}, False), ({"fused_mlp": True}, True)):
        model = create_model_from_config(config, device="cpu", **kwargs)
        ffs = [m for m in model.modules() if isinstance(m, FeedForward)]
        assert len(ffs) == 2 and all(m.fused_mlp is want for m in ffs)


# ---------------------------------------------------------------------------
# the LM: cached decode, sampling, generate, decode_tokens
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


def _cond(seed, batch=1):
    rng = np.random.RandomState(seed)
    emb = rng.randn(batch, 8, 512).astype(np.float32)
    return ({"prompt": (jnp.asarray(emb), jnp.ones((batch, 8), bool))},
            {"prompt": (torch.tensor(emb), torch.ones(batch, 8, dtype=torch.bool))})


@pytest.mark.parametrize("fused", [False, True])
def test_cached_decode_matches_jax(lm_models, monkeypatch, fused):
    jmodel, tmodel = lm_models
    if fused:
        monkeypatch.setenv("FSAT_FUSED_MLP", "1")
        monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    for m in tmodel.modules():
        if isinstance(m, FeedForward):
            monkeypatch.setattr(m, "fused_mlp", fused)
    calls = _count_calls(monkeypatch, tmlp, "glu_mlp")
    rng = np.random.RandomState(7)
    emb = rng.randn(1, 8, 512).astype(np.float32)
    ctx = np.concatenate([emb, np.zeros_like(emb)])  # CFG: the unconditioned twin
    tokens = rng.randint(0, CARD + 1, (1, 4, 16))  # the special token included
    tokens = np.concatenate([tokens, tokens])
    prefill, steps = 3, 16

    module, params = jmodel.module, {"params": jmodel.params}
    jstep = jax.jit(lambda p, seq, caches, c: module.apply(p, seq, caches, cross_attn_cond=c,
                                                           method="decode_step"))
    jcaches = module.apply(params, 2, steps, 0, method="init_cache")
    tcaches = tmodel.model.init_cache(2, steps)
    spans = [(0, prefill)] + [(i, i + 1) for i in range(prefill, steps)]
    with torch.no_grad():
        for lo, hi in spans:
            want, jcaches = jstep(params, jnp.asarray(tokens[..., lo:hi], jnp.int32), jcaches,
                                  jnp.asarray(ctx))
            got, tcaches = tmodel.model.decode_step(torch.tensor(tokens[..., lo:hi]), tcaches,
                                                   cross_attn_cond=torch.tensor(ctx))
            assert got.shape == (2, 4, hi - lo, CARD)
            assert _rel(got, want) <= 1e-5, (lo, hi)
    assert tcaches[0]["index"] == steps
    assert len(calls) == (2 * len(spans) if fused else 0)  # one per layer and step


def test_samplers_match_jax_given_its_gumbel_draws():
    rng = np.random.RandomState(9)
    probs = jax.nn.softmax(jnp.asarray(rng.randn(2, 4, CARD).astype(np.float32) * 2), -1)
    tprobs = torch.tensor(np.asarray(probs))
    noise_shape = probs.shape[:-1] + (1, CARD)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        noise = torch.tensor(np.asarray(jax.random.gumbel(key, noise_shape, jnp.float32)))
        cases = [(jutils.multinomial(key, probs, 1), tutils.multinomial(tprobs, 1, gumbel_noise=noise)),
                 (jutils.sample_top_k(key, probs, 5), tutils.sample_top_k(tprobs, 5, gumbel_noise=noise)),
                 (jutils.sample_top_p(key, probs, 0.6), tutils.sample_top_p(tprobs, 0.6, gumbel_noise=noise))]
        for want, got in cases:
            assert got.shape == (2, 4, 1)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the port's own draws stay inside the top-k set and the nucleus
    gen = torch.Generator().manual_seed(0)
    top5 = tprobs.topk(5, -1).indices
    for _ in range(20):
        tok = tutils.sample_top_k(tprobs, 5, gen)
        assert (tok == top5).any(-1).all()
    order = tprobs.sort(-1, descending=True)
    nucleus = (order.values.cumsum(-1) - order.values) <= 0.6
    for _ in range(20):
        tok = tutils.sample_top_p(tprobs, 0.6, gen)
        rank = (order.indices == tok).float().argmax(-1, keepdim=True)
        assert nucleus.gather(-1, rank).all()


def _assert_same_greedy_path(jmodel, want, got, jcond, cfg_scale):
    """JAX's CFG-lerped logits along its own greedy path (a forward over its
    pattern sequence) give each decision's top-2 margin; the tolerance is
    1e-5 of the logits' largest magnitude. The port's codes must equal
    JAX's up to their first difference, and every decision that differs
    there must have a margin within 100x the tolerance (a near-tie that fp32
    summation order may break either way; from there on the two paths
    legitimately part). At least 3/4 of the decisions must clear the margin."""
    pattern = jmodel.pattern_provider.get_pattern(want.shape[-1])
    seq, _, mask = pattern.build_pattern_sequence(jnp.asarray(want), jmodel.masked_token_id)
    ctx = jcond["prompt"][0]
    logits = jmodel.module.apply({"params": jmodel.params}, jnp.concatenate([seq, seq])[..., :-1],
                                 cross_attn_cond=jnp.concatenate([ctx, jnp.zeros_like(ctx)]))
    cond, uncond = np.split(np.asarray(logits, np.float64), 2)
    lerped = (uncond + (cond - uncond) * cfg_scale)[0]  # [K, S - 1, card]: step s from s - 1
    top2 = np.sort(lerped, -1)[..., -2:]
    low = (top2[..., 1] - top2[..., 0]) <= 100 * 1e-5 * np.abs(lerped).max()
    valid = np.asarray(mask)[:, 1:]
    assert (low & valid).sum() <= valid.sum() / 4, "most of JAX's decisions are near-ties"
    # codebook q's frame t is decided at step t + q + 1, from the logits at step t + q
    k, t = want.shape[1:]
    at = np.arange(t)[None, :] + np.arange(k)[:, None]
    differ = got[0] != want[0]
    if differ.any():
        first = at[differ].min()
        assert low[differ & (at == first), first].all(), "a decisive token differs from JAX's"


def test_greedy_generate_matches_jax(lm_models):
    jmodel, tmodel = lm_models
    jcond, tcond = _cond(21)
    want = np.asarray(jmodel.generate(max_gen_len=GEN_LEN, conditioning_tensors=jcond,
                                      cfg_scale=3.0, temp=0.0, rng=jax.random.PRNGKey(0)))
    got = tmodel.generate(max_gen_len=GEN_LEN, conditioning_tensors=tcond, cfg_scale=3.0,
                          temp=0.0).numpy()
    assert got.shape == want.shape == (1, 4, GEN_LEN)
    _assert_same_greedy_path(jmodel, want, got, jcond, 3.0)


def test_generate_continues_a_prompt_and_reports_steps(lm_models):
    jmodel, tmodel = lm_models
    jcond, tcond = _cond(22)
    prompt = np.random.RandomState(23).randint(0, CARD, (1, 4, 5))
    jsteps, tsteps = [], []
    want = np.asarray(jmodel.generate(max_gen_len=GEN_LEN, init_data=jnp.asarray(prompt, jnp.int32),
                                      conditioning_tensors=jcond, cfg_scale=3.0, temp=0.0,
                                      rng=jax.random.PRNGKey(0),
                                      callback=lambda s, n: jsteps.append((s, n))))
    got = tmodel.generate(max_gen_len=GEN_LEN, init_data=torch.tensor(prompt),
                          conditioning_tensors=tcond, cfg_scale=3.0, temp=0.0,
                          callback=lambda s, n: tsteps.append((s, n))).numpy()
    np.testing.assert_array_equal(got[..., :5], prompt)
    _assert_same_greedy_path(jmodel, want, got, jcond, 3.0)
    # the prompt's 5 frames start generation at step 6 of the 28 (the delay pattern)
    total = GEN_LEN + 4 - 6
    assert tsteps == [(s, total) for s in range(1, total + 1)]
    assert jsteps == tsteps
    with pytest.raises(NotImplementedError):
        tmodel.generate(max_gen_len=GEN_LEN, conditioning_tensors=tcond, use_cache=False)
    with pytest.raises(ValueError):
        tmodel.generate(max_gen_len=4, init_data=torch.tensor(prompt))


def test_decode_tokens_matches_jax(lm_models):
    jmodel, tmodel = lm_models
    codes = np.random.RandomState(31).randint(0, CARD, (2, 4, 30))
    want = np.asarray(jmodel.pretransform.decode_tokens(jnp.asarray(codes, jnp.int32)))
    got = tmodel.pretransform.decode_tokens(torch.tensor(codes))
    assert got.shape == want.shape == (2, 1, 30 * 6 - 1)  # the stride-3 upsample's length
    assert _rel(got, want) <= 1e-5
    _, tcond = _cond(24)
    audio = tmodel.generate_audio(max_gen_len=GEN_LEN, conditioning_tensors=tcond,
                                  cfg_scale=3.0, temp=1.0, top_k=8,
                                  generator=torch.Generator().manual_seed(0))
    assert audio.shape == (1, 1, GEN_LEN * 6 - 1) and torch.isfinite(audio).all()
