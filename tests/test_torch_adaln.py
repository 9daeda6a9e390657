"""The torch port's adaLN DiT (`global_cond_type="adaLN"`) and its fused
elementwise kernels K11 (`ln_modulate`) and K12 (`gated_residual`) against
the JAX package, on the CPU at small widths.

Inputs are drawn with numpy from fixed seeds and handed to both packages;
JAX weights are de-zeroed (`dezero_params`: a fresh `to_scale_shift_gate`
is zero, which would make every scale, shift and gate 0 and the comparison
vacuous) and converted with utils/convert.py. The JAX side runs its Pallas
kernels in interpret mode where the test turns its switch on
(FSAT_FUSED_EW=1 with FSAT_PALLAS_INTERPRET=1); on CPU tensors the port
runs its plain chains. Tolerances: in bf16, atol 3e-2 with rtol 3e-2 (one
bf16 rounding at the outputs' unit scale, the JAX package's own kernel
tests; the plain chain rounds the sigmoid where the kernel does not); in
fp32, 1e-5 relative (fp32 rounding of XLA against PyTorch); the bf16 DiT
within 1.5x the error of the JAX package's own bf16 DiT, both against the
JAX fp32 DiT (the bf16 gate of the port's DiT compares, PERF.md §2).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.models.dit import DiffusionTransformer as JDiT
from friendly_stable_audio_tools_tpu.models.transformer import TransformerBlock as JBlock
from friendly_stable_audio_tools_tpu.ops.embeddings import rotary_freqs as jax_rotary_freqs
from friendly_stable_audio_tools_tpu.ops.pallas import elementwise as jew
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.models.dit import DiffusionTransformer
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.models.transformer import TransformerBlock
from friendly_stable_audio_tools_tpu_torch.ops.kernels import build
from friendly_stable_audio_tools_tpu_torch.ops.kernels import elementwise as tew
from friendly_stable_audio_tools_tpu_torch.ops.norms import LayerNorm
from friendly_stable_audio_tools_tpu_torch.utils.convert import state_dict_from_jax

BF16_TOL = dict(atol=3e-2, rtol=3e-2)
FP32_RTOL = 1e-5
DIT_ERR_RATIO = 1.5


@pytest.fixture
def fused_jax(monkeypatch):
    """Turns the JAX package's fused-elementwise switch on, in interpret mode."""
    monkeypatch.setenv("FSAT_FUSED_EW", "1")
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    assert jew.fused_ew_enabled()


def _pair(a, dtype):
    """One numpy draw as a torch tensor and a JAX array holding the same
    values in `dtype` (bf16 rounding done once, by torch)."""
    t = torch.tensor(np.asarray(a, np.float32)).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return t, jnp.asarray(t.float().numpy(), jdt)


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _lnmod_inputs(seed, b, t, d, dtype):
    rng = np.random.RandomState(seed)
    x = _pair(rng.randn(b, t, d), dtype)
    gamma = (torch.tensor((1 + 0.1 * rng.randn(d)).astype(np.float32)),)
    gamma += (jnp.asarray(gamma[0].numpy()),)
    scale = _pair(0.2 * rng.randn(b, 1, d), dtype)
    shift = _pair(0.2 * rng.randn(b, 1, d), dtype)
    return x, gamma, scale, shift


# ---------------------------------------------------------------------------
# (a) the plain versions of K11 and K12
# ---------------------------------------------------------------------------

SHAPES = [(2, 130, 128), (1, 64, 256), (2, 77, 128)]  # T 130 and 77: ragged rows


@pytest.mark.parametrize("with_gamma", [True, False])
@pytest.mark.parametrize("b,t,d", SHAPES)
def test_ln_modulate_plain_matches_jax_chain_and_pallas_kernel(fused_jax, b, t, d, with_gamma):
    x, gamma, scale, shift = _lnmod_inputs(0, b, t, d, torch.bfloat16)
    g_t, g_j = gamma if with_gamma else (None, None)
    got = tew.ln_modulate(x[0], g_t, scale[0], shift[0])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tew.ln_modulate_plain(x[0], g_t, scale[0], shift[0]))
    chain = jew._lnmod_xla(x[1], g_j, scale[1], shift[1])
    kernel = jew.ln_modulate(x[1], g_j, scale[1], shift[1])  # Pallas, interpret mode
    np.testing.assert_allclose(_np(got), _np(chain), **BF16_TOL)
    np.testing.assert_allclose(_np(got), _np(kernel), **BF16_TOL)
    # the Pallas kernel's own arithmetic, as the CUDA kernel is held to it on the card
    km = tew.ln_modulate_kernel_math(x[0], g_t, scale[0], shift[0])
    np.testing.assert_allclose(_np(km), _np(kernel), **BF16_TOL)


@pytest.mark.parametrize("b,t,d", SHAPES)
def test_gated_residual_plain_matches_jax_chain_and_pallas_kernel(fused_jax, b, t, d):
    rng = np.random.RandomState(1)
    y, gate, res = (_pair(rng.randn(*s), torch.bfloat16) for s in ((b, t, d), (b, 1, d), (b, t, d)))
    got = tew.gated_residual(y[0], gate[0], res[0])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tew.gated_residual_plain(y[0], gate[0], res[0]))
    chain = jew._gres_xla(y[1], gate[1], res[1])
    kernel = jew.gated_residual(y[1], gate[1], res[1])
    np.testing.assert_allclose(_np(got), _np(chain), **BF16_TOL)
    np.testing.assert_allclose(_np(got), _np(kernel), **BF16_TOL)
    km = tew.gated_residual_kernel_math(y[0], gate[0], res[0])
    np.testing.assert_allclose(_np(km), _np(kernel), **BF16_TOL)


def test_plain_versions_match_jax_in_fp32():
    x, gamma, scale, shift = _lnmod_inputs(2, 2, 50, 128, torch.float32)
    got = tew.ln_modulate(x[0], gamma[0], scale[0], shift[0])
    want = jew._lnmod_xla(x[1], gamma[1], scale[1], shift[1])
    assert _rel(got, want) <= FP32_RTOL
    rng = np.random.RandomState(3)
    y, gate, res = (_pair(rng.randn(*s), torch.float32) for s in ((2, 50, 128), (2, 1, 128),
                                                                   (2, 50, 128)))
    assert _rel(tew.gated_residual(y[0], gate[0], res[0]), jew._gres_xla(y[1], gate[1], res[1])) \
        <= FP32_RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_functions_differentiate_the_plain_chain_as_jax_vjp(monkeypatch, dtype):
    """The kernels' autograd bindings (their launches replaced by the plain
    chains, as no kernel runs on the CPU) against jax.vjp of the XLA chains:
    every input's gradient, fp32 to 1e-5 relative, bf16 to one rounding of
    each gradient's scale."""
    monkeypatch.setattr(tew, "_launch_ln_modulate", tew.ln_modulate_plain)
    monkeypatch.setattr(tew, "_launch_gated_residual", tew.gated_residual_plain)
    b, t, d = 2, 40, 128
    x, gamma, scale, shift = _lnmod_inputs(4, b, t, d, dtype)
    rng = np.random.RandomState(5)
    cot = _pair(rng.randn(b, t, d), dtype)
    leaves = [v[0].clone().requires_grad_(True) for v in (x, gamma, scale, shift)]
    tew.LnModulate.apply(*leaves).backward(cot[0])
    _, vjp = jax.vjp(jew._lnmod_xla, x[1], gamma[1], scale[1], shift[1])
    pairs = [(leaf.grad, want) for leaf, want in zip(leaves, vjp(cot[1]))]

    y, gate, res = (_pair(rng.randn(*s), dtype) for s in ((b, t, d), (b, 1, d), (b, t, d)))
    leaves = [v[0].clone().requires_grad_(True) for v in (y, gate, res)]
    tew.GatedResidual.apply(*leaves).backward(cot[0])
    _, vjp = jax.vjp(jew._gres_xla, y[1], gate[1], res[1])
    pairs += [(leaf.grad, want) for leaf, want in zip(leaves, vjp(cot[1]))]
    for got, want in pairs:
        assert got is not None and got.shape == tuple(want.shape)
        if dtype == torch.float32:
            assert _rel(got, want) <= FP32_RTOL
        else:
            scale_of = float(np.abs(_np(want)).max())
            np.testing.assert_allclose(_np(got), _np(want), atol=3e-2 * scale_of, rtol=3e-2)


def test_gate_routes_and_kernel_launch_on_a_non_cpu_tensor(monkeypatch):
    """Outside the JAX gate (fp32, D % 128 != 0, switch off) the chain runs
    on any device; inside it a tensor off the CPU launches the kernel (here
    meta tensors and a recording stub of the library: the DiT's adaLN
    vectors, chunks of one [B, 1, 6D] projection, are read in place with
    their batch stride) and nothing falls back."""
    calls = []

    class Lib:
        def fsat_ln_modulate(self, *args):
            calls.append(("ln_modulate", args))
            return 0

        def fsat_gated_residual(self, *args):
            calls.append(("gated_residual", args))
            return 0

    monkeypatch.setattr(build, "library", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0}))
    meta = dict(device="meta", dtype=torch.bfloat16)
    x = torch.empty(2, 16, 256, **meta)
    ssg = torch.empty(2, 1, 6 * 256, **meta)
    scale, shift, gate = ssg.chunk(6, dim=-1)[:3]
    gamma = torch.empty(256, device="meta", dtype=torch.float32)
    before = (tew.lnmod_launches, tew.gres_launches)
    assert tew.ln_modulate(x, gamma, scale, shift).shape == x.shape
    assert tew.gated_residual(x, gate, x).shape == x.shape
    assert (tew.lnmod_launches, tew.gres_launches) == (before[0] + 1, before[1] + 1)
    (name1, a1), (name2, a2) = calls
    # gamma kind 1 (fp32); scale and shift strides 6D; rows B*T, T, D
    assert name1 == "ln_modulate" and a1[2] == 1 and a1[5:7] == (1536, 1536) and a1[8:11] == (
        32, 16, 256)
    assert name2 == "gated_residual" and a2[2] == 1536 and a2[5:8] == (32, 16, 256)
    calls.clear()
    tew.ln_modulate(x, None, scale, shift, enabled=False)
    tew.gated_residual(x.float(), gate.float(), x.float())
    tew.ln_modulate(x[..., :200], None, scale[..., :200], shift[..., :200])
    assert calls == []
    monkeypatch.setattr(build, "library", lambda: (_ for _ in ()).throw(RuntimeError("no nvcc")))
    with pytest.raises(RuntimeError):
        tew.gated_residual(x, gate, x)


# ---------------------------------------------------------------------------
# (b) one adaLN TransformerBlock
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block_pair():
    """A JAX adaLN TransformerBlock (dim 128, 2 heads of 64, global cond 64),
    de-zeroed, and the port's block loaded from its converted weights."""
    jblk = JBlock(dim=128, dim_heads=64, global_cond_dim=64)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 64, 128).astype(np.float32)
    g = rng.randn(2, 64).astype(np.float32)
    freqs = jax_rotary_freqs(64, 32)
    params = jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), global_cond=jnp.asarray(g),
                       rotary_pos_emb=freqs)["params"]
    params = dezero_params(params)
    tblk = TransformerBlock(128, 64, global_cond_dim=64)
    tblk.load_state_dict(state_dict_from_jax(params), strict=True)
    return jblk, params, tblk.eval(), (x, g, np.asarray(freqs))


@pytest.mark.parametrize("fused", [False, True])
def test_adaln_block_matches_jax(block_pair, monkeypatch, fused):
    """The port's block with `fused_ew` off and on (the plain chains on the
    CPU) against the JAX block: in fp32 against the XLA block, in bf16
    against the JAX block with its switch off and on (the Pallas kernels in
    interpret mode); atol 5e-2 in bf16, the JAX package's own fused-vs-
    unfused block test (test_transformer_block_fused_ew_matches_unfused)."""
    jblk, params, tblk, (x, g, freqs) = block_pair
    for m in tblk.modules():
        if isinstance(m, (LayerNorm, TransformerBlock)):
            m.fused_ew = fused
    rot = torch.tensor(freqs)
    monkeypatch.delenv("FSAT_FUSED_EW", raising=False)
    with torch.no_grad():
        got32 = tblk(torch.tensor(x), global_cond=torch.tensor(g), rotary_pos_emb=rot)
    want32 = jblk.apply({"params": params}, jnp.asarray(x), global_cond=jnp.asarray(g),
                        rotary_pos_emb=jnp.asarray(freqs))
    assert _rel(got32, want32) <= FP32_RTOL
    # de-zeroed: the gated branches move the output, and move it as in JAX
    assert _rel(got32, x) > 0.01
    assert _rel(got32 - torch.tensor(x), _np(want32) - x) <= 10 * FP32_RTOL

    p16 = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    blk16 = copy.deepcopy(tblk).to(torch.bfloat16)
    with torch.no_grad():
        got = blk16(torch.tensor(x).to(torch.bfloat16),
                    global_cond=torch.tensor(g).to(torch.bfloat16), rotary_pos_emb=rot)
    assert got.dtype == torch.bfloat16
    if fused:
        monkeypatch.setenv("FSAT_FUSED_EW", "1")
        monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    want = jblk.apply({"params": p16}, jnp.asarray(x, jnp.bfloat16),
                      global_cond=jnp.asarray(g, jnp.bfloat16), rotary_pos_emb=jnp.asarray(freqs))
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-2)


# ---------------------------------------------------------------------------
# (c) a tiny adaLN DiT with CFG batch doubling
# ---------------------------------------------------------------------------

DIT_KW = dict(io_channels=4, embed_dim=128, depth=2, num_heads=2, cond_token_dim=8,
              global_cond_dim=12, transformer_type="continuous_transformer",
              global_cond_type="adaLN")


@pytest.fixture(scope="module")
def dit_pair():
    jdit = JDiT(**DIT_KW)
    rng = np.random.RandomState(7)
    x = rng.randn(1, 24, 4).astype(np.float32)
    t = np.asarray([0.4], np.float32)
    cond = rng.randn(1, 5, 8).astype(np.float32)
    g = rng.randn(1, 12).astype(np.float32)
    params = jdit.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                       cross_attn_cond=jnp.asarray(cond), global_embed=jnp.asarray(g))["params"]
    params = dezero_params(params)
    tdit = DiffusionTransformer(**DIT_KW)
    tdit.load_state_dict(state_dict_from_jax(params), strict=True)
    return jdit, params, tdit.eval(), (x, t, cond, g)


def _jax_dit(jdit, params, inputs, dtype, **kw):
    x, t, cond, g = (jnp.asarray(a, dtype) for a in inputs)
    return jdit.apply({"params": params}, x, t, cross_attn_cond=cond, global_embed=g, **kw)


def test_tiny_adaln_dit_with_cfg_matches_jax(dit_pair, monkeypatch):
    jdit, params, tdit, inputs = dit_pair
    targs = [torch.tensor(a) for a in inputs]
    cfg = dict(cfg_scale=7.0)

    def port(dit, dtype):
        x, t, cond, g = (a.to(dtype) for a in targs)
        with torch.no_grad():
            return dit(x, t, cross_attn_cond=cond, global_embed=g, **cfg)

    assert not any(p.shape[0] == 0 for p in tdit.parameters())
    want32 = _jax_dit(jdit, params, inputs, jnp.float32, **cfg)
    got32 = port(tdit, torch.float32)
    assert got32.shape == (1, 24, 4)
    assert _rel(got32, want32) <= FP32_RTOL
    # nothing is prepended: the adaLN stack sees exactly the 24 frames
    assert float(np.abs(_np(want32)).max()) > 0.1

    p16 = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    monkeypatch.delenv("FSAT_FUSED_EW", raising=False)
    err_jax = _rel(_jax_dit(jdit, p16, inputs, jnp.bfloat16, **cfg), want32)
    monkeypatch.setenv("FSAT_FUSED_EW", "1")
    monkeypatch.setenv("FSAT_PALLAS_INTERPRET", "1")
    err_jax_fused = _rel(_jax_dit(jdit, p16, inputs, jnp.bfloat16, **cfg), want32)
    dit16 = copy.deepcopy(tdit).to(torch.bfloat16)
    for fused in (False, True):
        for m in dit16.modules():
            if isinstance(m, (LayerNorm, TransformerBlock)):
                m.fused_ew = fused
        got = port(dit16, torch.bfloat16)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        err = _rel(got, want32)
        assert err <= DIT_ERR_RATIO * min(err_jax, err_jax_fused), (fused, err, err_jax,
                                                                    err_jax_fused)


# ---------------------------------------------------------------------------
# (e) the entry points
# ---------------------------------------------------------------------------

def test_factory_builds_adaln_dit_with_fused_ew(monkeypatch):
    from tests.test_torch_train_slice import LATENTS, tiny_train_config

    config = tiny_train_config()
    config["model"]["diffusion"]["config"]["global_cond_type"] = "adaLN"
    model = create_model_from_config(config, device="cpu", fused_ew=True)
    blocks = model.model.transformer.layers
    assert all(b.fused_ew and b.pre_norm.fused_ew and b.ff_norm.fused_ew for b in blocks)
    ssg = blocks[0].to_scale_shift_gate.weight
    assert ssg.shape == (6 * 128, 128) and not ssg.any()  # zero-initialised, as in JAX
    assert not create_model_from_config(config, device="cpu").model.transformer.layers[0].fused_ew
    with torch.no_grad():
        cond = model.get_conditioning_inputs(model.conditioner(
            [{"prompt": "a", "seconds_start": 0, "seconds_total": 5}], device="cpu"))
        out = model.model(torch.randn(1, LATENTS, 4), torch.full((1,), 0.5), cfg_scale=3.0,
                          **cond)
    assert out.shape == (1, LATENTS, 4) and torch.isfinite(out).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model_from_config(config, fused_ew=True)
