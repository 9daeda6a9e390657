"""The torch port's AE-GAN training against the JAX package.

A tiny snake Oobleck VAE (tests/test_autoencoder.py:tiny_ae's widths: 8
channels, c_mults (1, 2), strides (2, 4), 16 -> 8 latent channels) with the
EnCodec discriminator and the multi-resolution STFT losses at two scales
(tests/test_training_autoencoder.py's loss config, with the A-weighting
prefilter on), built by the JAX package and carried into the port by
utils/convert.py. One generator step, then one discriminator step (from
JAX's updated weights), on the same reals [2, 1024, 2], with the JAX step's
VAE noise (recovered as (z - mean) / stdev from its own encode) passed into
the port. Everything is fp32 on the CPU. Tolerances: each named loss to
1e-5 relative; the autoencoder's gradient to rel-L2 1e-4 as a whole, and
per parameter to 1e-4 plus the fp32 rounding of this loss at that
parameter: the port's fp64 run of the same step measures the port's share
(fp32 against fp64, itself under 1e-3), and JAX's fp32 arithmetic carries
at most twice as much (so the port's fp64 gradient lies within 1e-4 plus
twice the port's rounding of JAX's fp32 one, its fp32 gradient within 1e-4
plus three times it).
The L1 log-magnitude STFT losses behind the A-weighting prefilter make that
rounding large: their bins near the 1e-4 clamp carry ~1e-3 of relative
error in fp32 and weigh each by 1 / magnitude. Measured on these inputs
against the port's fp64 gradient, per parameter: the port's fp32 gradient
up to 1.35e-4 (XLA's default pipeline) and 1.18e-4 (opt level 0, the fast
tier; the inputs carry JAX's VAE noise), alike at 1, 2 and 8 torch
threads; JAX's up to 4.2e-5 and 2.01e-4 (1.71x the port's). On equivalent
inputs (the batch swapped, negated, scaled by 1.01) either side's error is
the larger, up to 3.3e-3, so neither is at fault. The discriminator's gradient
to rel-L2 1e-4 as a whole and each of its parameters' to 1e-4 of that
whole's norm (its first 2-D conv's at the 64-point scale, of norm 1e-2,
carried 2e-4 of rounding against the port's own fp64 on these inputs, 9e-7
on others, and JAX's 3e-7: a sum over the spectrogram's positions that
cancels); the weights after the AdamW update as `check_update` says. Then the wrapper's options on the port alone (warmup, the encoder
freeze, the EMA's count, the latent mask, mono input, the export), the RVQ
bottleneck's quantizer loss against JAX's, the factory on every shipped
autoencoder config, the CLI training two steps and resuming, and the
K2/K3/K4 autograd Functions on CPU tensors with their launches replaced by
the plain versions.
"""

import copy
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from friendly_stable_audio_tools_tpu.models.autoencoders import (
    create_autoencoder_from_config as jax_ae_from_config,
)
from friendly_stable_audio_tools_tpu.models.bottleneck import RVQBottleneck as JRVQ
from friendly_stable_audio_tools_tpu.models.bottleneck import VAEBottleneck as JVAEBottleneck
from friendly_stable_audio_tools_tpu.training.autoencoders import (
    AutoencoderTrainingWrapper as JWrapper,
)
from friendly_stable_audio_tools_tpu.training.ema import ema_update as jax_ema_update
from friendly_stable_audio_tools_tpu_torch.models.autoencoders import create_autoencoder_from_config
from friendly_stable_audio_tools_tpu_torch.models.bottleneck import RVQBottleneck
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.ops.kernels import conv1d as tconv
from friendly_stable_audio_tools_tpu_torch.train import main as train_main
from friendly_stable_audio_tools_tpu_torch.training.autoencoders import AutoencoderTrainingWrapper
from friendly_stable_audio_tools_tpu_torch.training.factory import (
    create_training_wrapper_from_config,
)
from friendly_stable_audio_tools_tpu_torch.utils.convert import (
    convert_autoencoder,
    convert_encodec_discriminator,
    state_dict_from_jax,
)
from tests.test_autoencoder import tiny_ae
from tests.test_training_autoencoder import OPT_CONFIGS

AE_CONFIGS = sorted(glob.glob("friendly_stable_audio_tools_tpu/configs/model_configs/autoencoders/"
                              "*.json"))
SR = 16000
T = 1024
# the step-0 learning rates (OPT_CONFIGS: InverseLR's warmup 0.999 scales
# 1e-3 and 2e-3 by 1 - 0.999)
GEN_LR0, DISC_LR0 = 1e-3 * (1 - 0.999), 2e-3 * (1 - 0.999)


def check_update(after, want, grad, lr0):
    """The first AdamW update moves each weight by lr0 * g / (|g| + eps),
    about lr0 * sign(g): where the gradient is at least 1e-2 of its largest
    entry the updated weights agree to fp32 rounding (1e-7), elsewhere a
    rounding can flip the sign of a gradient near zero, so to 2 lr0."""
    g = np.abs(grad.numpy())
    diff = np.abs(after.numpy() - want.numpy())
    strong = g >= 1e-2 * g.max()
    assert diff[strong].max(initial=0) <= 1e-7 and diff.max() <= 2 * lr0 + 1e-7
LOSS_CONFIG = {
    "discriminator": {
        "type": "encodec",
        "config": {"filters": 8, "n_ffts": [128, 64], "hop_lengths": [32, 16],
                   "win_lengths": [128, 64]},
        "weights": {"adversarial": 0.1, "feature_matching": 5.0},
    },
    "spectral": {
        "type": "mrstft",
        "config": {"fft_sizes": [128, 64], "hop_sizes": [32, 16], "win_lengths": [128, 64],
                   "perceptual_weighting": True},
        "weights": {"mrstft": 1.0},
    },
    "time": {"type": "l1", "weights": {"l1": 0.1}},
    "bottleneck": {"type": "kl", "weights": {"kl": 1e-4}},
}


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tiny_ae_config():
    """The tiny VAE as an `autoencoder` model config (the JAX tiny_ae's widths)."""
    cfg = json.load(open(AE_CONFIGS[-1]))  # stable_audio_2_0_vae.json
    cfg.update(sample_rate=SR, sample_size=T)
    model = cfg["model"]
    for part, latent in (("encoder", 16), ("decoder", 8)):
        model[part]["config"].update(channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=latent)
    model["decoder"]["config"]["final_tanh"] = True  # the JAX OobleckDecoder's default
    model.update(latent_dim=8, downsampling_ratio=8)
    cfg["training"]["loss_configs"] = copy.deepcopy(LOSS_CONFIG)
    cfg["training"]["optimizer_configs"] = copy.deepcopy(OPT_CONFIGS)
    return cfg


def jax_noise(jae, gen_params, reals, key):
    """The standard normal draw behind JAX's VAE sample for the step key:
    (z - mean) / stdev of its own encode."""
    k_sample, _ = jax.random.split(key)
    mod = jae.module
    z, _ = mod.apply({"params": gen_params}, reals, return_info=True, method="encode",
                     rngs={"sample": k_sample})
    h = mod.apply({"params": gen_params}, reals, method=lambda m, x: m.encoder(x))
    mean, scale = jnp.split(h, 2, axis=-1)
    return (z - mean) / (jax.nn.softplus(scale) + 1e-4)


def port_generator_grads_fp64(gen_params, disc_params, reals, noise):
    """The port's generator step (forward, losses, backward) in fp64 on the
    same weights, reals and VAE noise: {name: gradient}. The loss code casts
    to fp32 and builds its windows and filters in fp32; here those keep
    fp64 (the filters' fp32 taps, widened)."""
    from friendly_stable_audio_tools_tpu_torch.ops import stft as tstft
    from friendly_stable_audio_tools_tpu_torch.training.losses import auraloss

    to_float, on, hann = torch.Tensor.float, auraloss._OnDevice.on, tstft.hann_window
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", lambda x, *a, **k: (
            x if x.dtype == torch.float64 else to_float(x, *a, **k)))
        mp.setattr(auraloss._OnDevice, "on", lambda self, dev: on(self, dev).double())
        for mod in (tstft, auraloss, __import__(
                "friendly_stable_audio_tools_tpu_torch.models.discriminators", fromlist=["x"])):
            mp.setattr(mod, "hann_window", lambda n, device=None: hann(n, device).double())
        ae = create_autoencoder_from_config(tiny_ae_config())
        ae.load_state_dict(convert_autoencoder(gen_params), strict=True)
        tw = AutoencoderTrainingWrapper(ae, loss_config=LOSS_CONFIG,
                                        optimizer_configs=OPT_CONFIGS, sample_rate=SR)
        tw.discriminator.load_state_dict(convert_encodec_discriminator(disc_params), strict=True)
        ae.double()
        tw.discriminator.double()
        tw.generator_step(_t(reals).double(), draws={"noise": _t(noise).double()})
    return {n: p.grad.clone() for n, p in ae.named_parameters()}


@pytest.fixture(scope="module")
def steps():
    """One JAX generator step and one discriminator step (losses, grads,
    updated params, the VAE noise of each), as the JAX wrapper's
    `_get_step_fn("gen" / "disc", warmed_up=True, freeze_encoder=False)`
    compute them, in one jitted program; and the port's wrapper taking the
    same two steps."""
    jae = tiny_ae(JVAEBottleneck(), latent_dim=8, enc_latent_dim=16)
    jw = JWrapper(jae, loss_config=LOSS_CONFIG, optimizer_configs=OPT_CONFIGS, warmup_steps=0,
                  sample_rate=SR, use_ema=True)
    example = jnp.zeros((1, 512, 2), jnp.float32)
    gen_params = jae.params
    disc_params = jax.jit(lambda k: jw.discriminator.init(k, example, example, method="loss"))(
        jax.random.PRNGKey(0))["params"]
    reals = np.random.RandomState(0).randn(2, T, 2).astype(np.float32) * 0.3
    jreals = jnp.asarray(reals)

    def gen_loss(gp, dp, key):
        info, decoded = jw._forward_info(gp, jreals, key, True, False)
        loss_dis, loss_adv, fm = jw._disc_loss_call(jax.lax.stop_gradient(dp), jreals, decoded)
        info.update(loss_dis=loss_dis, loss_adv=loss_adv, feature_matching_distance=fm)
        loss, losses = jw.losses_gen(info)
        return loss, dict(losses, latent_std=info["latents"].std(),
                          data_std=info["encoder_input"].std())

    def disc_loss(dp, gp, key):
        _, decoded = jw._forward_info(jax.lax.stop_gradient(gp), jreals, key, True, False)
        loss_dis, _, _ = jw._disc_loss_call(dp, jreals, jax.lax.stop_gradient(decoded))
        return jw.losses_disc({"loss_dis": loss_dis})

    @jax.jit
    def two_steps(gp, dp, key):
        keys = jax.random.split(key, 2)
        (gl, gaux), ggrads = jax.value_and_grad(gen_loss, has_aux=True)(gp, dp, keys[0])
        updates, _ = jw.gen_tx.update(ggrads, jw.gen_tx.init(gp), gp)
        new_gen = optax.apply_updates(gp, updates)
        new_ema = jax_ema_update(gp, new_gen, jw._ema_updates(jnp.asarray(0)))
        (dl, _), dgrads = jax.value_and_grad(disc_loss, has_aux=True)(dp, new_gen, keys[1])
        updates, _ = jw.disc_tx.update(dgrads, jw.disc_tx.init(dp), dp)
        return dict(gen_loss=gl, gen_aux=gaux, gen_grads=ggrads, new_gen=new_gen,
                    new_ema=new_ema, disc_loss=dl, disc_grads=dgrads,
                    new_disc=optax.apply_updates(dp, updates),
                    noise=(jax_noise(jae, gp, jreals, keys[0]),
                           jax_noise(jae, new_gen, jreals, keys[1])))

    out = two_steps(gen_params, disc_params, jax.random.PRNGKey(7))
    noise = [np.asarray(n) for n in out["noise"]]
    new_gen = out["new_gen"]

    cfg = tiny_ae_config()
    ae = create_autoencoder_from_config(cfg)
    ae.load_state_dict(convert_autoencoder(gen_params), strict=True)
    tw = AutoencoderTrainingWrapper(ae, loss_config=LOSS_CONFIG, optimizer_configs=OPT_CONFIGS,
                                    sample_rate=SR, use_ema=True)
    tw.discriminator.load_state_dict(convert_encodec_discriminator(disc_params), strict=True)
    gen_metrics = tw.train_step(_t(reals), draws={"noise": _t(noise[0])})
    gen_grads = {n: p.grad.clone() for n, p in ae.named_parameters()}
    gen_grads64 = port_generator_grads_fp64(gen_params, disc_params, reals, noise[0])
    gen_after = {n: p.detach().clone() for n, p in ae.named_parameters()}
    ema = {n: e.clone() for (n, _), e in zip(tw.gen_named, tw.ema)}
    # the discriminator step from JAX's updated weights, so that both sides
    # hold the same fakes up to the decoder's rounding
    ae.load_state_dict(convert_autoencoder(new_gen), strict=True)
    gen_loaded = {n: p.detach().clone() for n, p in ae.named_parameters()}
    disc_metrics = tw.train_step(_t(reals), draws={"noise": _t(noise[1])})
    disc_grads = {n: p.grad.clone() for n, p in tw.discriminator.named_parameters()}
    return dict(
        jax=dict(gen_loss=float(out["gen_loss"]),
                 gen_aux={k: float(v) for k, v in out["gen_aux"].items()},
                 gen_grads=convert_autoencoder(out["gen_grads"]),
                 new_gen=convert_autoencoder(new_gen), new_ema=convert_autoencoder(out["new_ema"]),
                 disc_loss=float(out["disc_loss"]),
                 disc_grads=convert_encodec_discriminator(out["disc_grads"]),
                 new_disc=convert_encodec_discriminator(out["new_disc"])),
        port=dict(gen_metrics=gen_metrics, gen_grads=gen_grads, gen_grads64=gen_grads64,
                  gen_after=gen_after, ema=ema,
                  disc_metrics=disc_metrics, disc_grads=disc_grads,
                  disc_after={n: p.detach() for n, p in tw.discriminator.named_parameters()},
                  gen_loaded=gen_loaded,
                  gen_after_disc={n: p.detach() for n, p in ae.named_parameters()},
                  step=tw.step))


def test_generator_step_losses_match_jax(steps):
    j, p = steps["jax"], steps["port"]
    names = {"loss_adv", "feature_matching", "mrstft_loss", "stft_loss_left", "stft_loss_right",
             "l1_time_loss", "kl_loss", "latent_std", "data_std"}
    assert names <= set(j["gen_aux"]) and names <= set(p["gen_metrics"])
    assert abs(p["gen_metrics"]["loss"] - j["gen_loss"]) <= 1e-5 * abs(j["gen_loss"])
    for k in names:
        assert abs(p["gen_metrics"][k] - j["gen_aux"][k]) <= 1e-5 * abs(j["gen_aux"][k]) + 1e-9, k


def test_generator_step_gradients_and_update_match_jax(steps):
    j, p = steps["jax"], steps["port"]
    assert set(j["gen_grads"]) == set(p["gen_grads"]) == set(p["gen_grads64"])
    names = list(j["gen_grads"])
    whole = [torch.cat([g[n].flatten().double() for n in names])
             for g in (p["gen_grads"], j["gen_grads"])]
    assert _rel(*whole) <= 1e-4
    for n, want in j["gen_grads"].items():
        assert np.abs(want.numpy()).max() > 0, n
        exact = p["gen_grads64"][n]
        rounding = _rel(p["gen_grads"][n], exact)  # the port's fp32 arithmetic alone
        assert rounding <= 1e-3, (n, rounding)
        # JAX's fp32 gradient carries its own rounding of the same loss, up
        # to twice the port's (see the module docstring)
        assert _rel(exact, want) <= 1e-4 + 2 * rounding, (n, _rel(exact, want), rounding)
        err = _rel(p["gen_grads"][n], want)
        assert err <= 1e-4 + 3 * rounding, (n, err, rounding)
        check_update(p["gen_after"][n], j["new_gen"][n], want, GEN_LR0)
        check_update(p["ema"][n], j["new_ema"][n], want, GEN_LR0)


def test_discriminator_step_matches_jax(steps):
    j, p = steps["jax"], steps["port"]
    assert abs(p["disc_metrics"]["loss"] - j["disc_loss"]) <= 1e-5 * abs(j["disc_loss"])
    assert p["disc_metrics"]["discriminator_loss"] == p["disc_metrics"]["loss"]
    assert set(j["disc_grads"]) == set(p["disc_grads"])
    total = torch.cat([g.flatten() for g in j["disc_grads"].values()]).norm().item()
    got = torch.cat([p["disc_grads"][n].flatten() for n in j["disc_grads"]])
    assert _rel(got, torch.cat([g.flatten() for g in j["disc_grads"].values()])) <= 1e-4
    for n, want in j["disc_grads"].items():
        err = (p["disc_grads"][n] - want).norm().item()
        assert err <= 1e-4 * total, (n, err, total)
        check_update(p["disc_after"][n], j["new_disc"][n], want, DISC_LR0)
    # the autoencoder is not touched by a discriminator step
    for n, v in p["gen_loaded"].items():
        assert torch.equal(v, p["gen_after_disc"][n])
    assert p["step"] == 2


# ---------------------------------------------------------------------------
# the wrapper's options, on the port
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_wrapper():
    def make(**kw):
        cfg = tiny_ae_config()
        ae = create_autoencoder_from_config(cfg)
        from friendly_stable_audio_tools_tpu_torch.utils.common import init_weights_

        init_weights_(ae.to_empty(device="cpu"), torch.Generator().manual_seed(0))
        return AutoencoderTrainingWrapper(ae, loss_config=LOSS_CONFIG,
                                          optimizer_configs=OPT_CONFIGS, sample_rate=SR, **kw)
    return make


def _reals(t=T, seed=0):
    return torch.randn(2, t, 2, generator=torch.Generator().manual_seed(seed)) * 0.3


def test_warmup_runs_no_discriminator_before_it_ends(tiny_wrapper, monkeypatch):
    w = tiny_wrapper(warmup_steps=2)
    calls = []
    loss = w.discriminator.loss
    monkeypatch.setattr(w.discriminator, "loss", lambda *a: calls.append(w.step) or loss(*a))
    ema_before = [e.clone() for e in w.ema]
    disc_before = [p.detach().clone() for p in w.disc_params]
    metrics = [w.train_step(_reals(512)) for _ in range(4)]
    assert calls == [2, 3]  # step 2: the generator's adversarial loss; step 3: a discriminator step
    assert metrics[0]["loss_adv"] == metrics[0]["feature_matching"] == 0.0
    assert "discriminator_loss" in metrics[3] and "mrstft_loss" in metrics[2]
    assert not any(torch.equal(a, b) for a, b in zip(ema_before, w.ema))
    assert any(not torch.equal(a, b.detach()) for a, b in zip(disc_before, w.disc_params))


def test_encoder_freeze_on_warmup_leaves_the_encoder_untouched(tiny_wrapper):
    w = tiny_wrapper(warmup_steps=1, encoder_freeze_on_warmup=True)
    w.train_step(_reals(512))  # step 0: warming up, the encoder trains
    enc = {n: p.detach().clone() for n, p in w.autoencoder.encoder.named_parameters()}
    dec = {n: p.detach().clone() for n, p in w.autoencoder.decoder.named_parameters()}
    w.train_step(_reals(512, 1))  # step 1: warmed up, a generator step (step - warmup even)
    w.train_step(_reals(512, 2))  # step 2: a discriminator step
    w.train_step(_reals(512, 3))  # step 3: a generator step
    for n, p in w.autoencoder.encoder.named_parameters():
        assert torch.equal(p.detach(), enc[n]) and p.grad is None, n
    assert any(not torch.equal(p.detach(), dec[n]) for n, p in
               w.autoencoder.decoder.named_parameters())


@pytest.mark.parametrize("warmup", [0, 3])
def test_ema_counts_generator_steps_as_jax(warmup):
    jw = JWrapper.__new__(JWrapper)
    jw.warmup_steps = warmup
    w = AutoencoderTrainingWrapper.__new__(AutoencoderTrainingWrapper)
    w.warmup_steps = warmup
    for step in range(12):
        assert w.ema_updates(step) == int(jw._ema_updates(jnp.asarray(step))), step


def test_ema_moves_on_generator_steps_only(tiny_wrapper):
    w = tiny_wrapper()
    w.train_step(_reals(512))
    ema = [e.clone() for e in w.ema]
    w.train_step(_reals(512, 1))  # a discriminator step
    assert all(torch.equal(a, b) for a, b in zip(ema, w.ema))
    w.train_step(_reals(512, 2))
    assert not all(torch.equal(a, b) for a, b in zip(ema, w.ema))


def test_latent_mask_and_mono_input(tiny_wrapper):
    w = tiny_wrapper(latent_mask_ratio=0.5)
    reals = _reals(512)
    noise = torch.randn(2, 64, 8, generator=torch.Generator().manual_seed(3))
    mask = torch.rand(2, 64, 8, generator=torch.Generator().manual_seed(4)) < 0.5
    info, decoded = w.forward_info(reals, False, {"noise": noise, "latent_mask": mask})
    z = w.autoencoder.encode_nwc(reals, sample=True, noise=noise)
    want = torch.where(mask, torch.zeros_like(z), z)
    torch.testing.assert_close(info["latents"], want, rtol=0, atol=0)
    torch.testing.assert_close(decoded, w.autoencoder.decode_nwc(want), rtol=0, atol=0)
    # drawn: a share of the latents near the ratio is zeroed
    info, _ = w.forward_info(_reals(4096), False)
    assert 0.4 < (info["latents"] == 0).float().mean().item() < 0.6

    cfg = tiny_ae_config()
    cfg["model"]["encoder"]["config"]["in_channels"] = 1
    cfg["model"]["in_channels"] = 1
    ae = create_model_from_config(cfg, device="cpu")
    wm = AutoencoderTrainingWrapper(ae, loss_config=LOSS_CONFIG, optimizer_configs=OPT_CONFIGS,
                                    sample_rate=SR, force_input_mono=True)
    info, decoded = wm.forward_info(reals, False, {"noise": noise})
    torch.testing.assert_close(info["encoder_input"], reals.mean(-1, keepdim=True))
    assert decoded.shape == reals.shape
    assert np.isfinite(wm.train_step(reals)["loss"])


def test_seanet_rvq_step_refuses_its_short_decode():
    """encodec_musicgen_rvq.json as written: the factory gives its wrapper
    (the quantizer loss among the generator's terms), and a step raises on
    the SEANet decoder's 640 T - 8 samples, where the JAX trainer's
    spectral losses fail on the same mismatch."""
    cfg = json.load(open(AE_CONFIGS[1]))
    wrapper = create_training_wrapper_from_config(cfg, create_model_from_config(cfg, device="cpu"))
    assert "quantizer_loss" in [m.name for m in wrapper.losses_gen.losses]
    with pytest.raises(ValueError, match="decoder returns 1272 samples for 1280"):
        wrapper.train_step(torch.zeros(1, 1280, 1))


def test_exponential_lr_matches_jax():
    from friendly_stable_audio_tools_tpu.training.scheduler import create_scheduler_from_config
    from friendly_stable_audio_tools_tpu_torch.training.scheduler import build_optimizer

    sched = {"type": "ExponentialLR", "config": {"gamma": 0.9}}
    want = create_scheduler_from_config(sched, 1e-3)
    opt, lr = build_optimizer({"optimizer": {"type": "AdamW", "config": {"lr": 1e-3}},
                               "scheduler": sched}, [torch.nn.Parameter(torch.zeros(1))])
    for step in range(4):
        assert abs(opt.param_groups[0]["lr"] - float(want(step))) <= 1e-12, step
        opt.step()
        lr.step()


def test_teacher_distillation_decodes_without_gradient(tiny_wrapper):
    """With a teacher, the spectral loss splits into the four distillation
    terms at a quarter weight (JAX :122-131); every teacher decode runs
    under torch.no_grad(), so the teacher gets no gradient."""
    cfg = tiny_ae_config()
    teacher = create_model_from_config(cfg, seed=1, device="cpu")
    w = tiny_wrapper(teacher_model=teacher)
    metrics = w.train_step(_reals(512))
    names = {"mrstft_loss", "mrstft_loss_distill", "mrstft_loss_own_latents_teacher",
             "mrstft_loss_teacher_latents_own"}
    assert names <= set(metrics) and "stft_loss_left" not in metrics
    assert all(p.grad is None for p in teacher.parameters())
    assert all(p.grad is not None for p in w.autoencoder.parameters())


def test_rvq_quantizer_loss_matches_jax():
    jb = JRVQ(num_quantizers=3, codebook_size=32, dim=16)
    x = np.random.RandomState(1).randn(2, 20, 16).astype(np.float32)
    params = jb.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    (jz, jinfo) = jb.apply({"params": params}, jnp.asarray(x), return_info=True, method="encode")
    tb = RVQBottleneck(num_quantizers=3, codebook_size=32, dim=16)
    tb.load_state_dict(state_dict_from_jax(params), strict=True)
    z, info = tb.encode(_t(x), return_info=True, sample=True)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_array_equal(info["quantizer_indices"].numpy(),
                                  np.asarray(jinfo["quantizer_indices"]))
    assert abs(info["quantizer_loss"].item() - float(jinfo["quantizer_loss"])) <= \
        1e-5 * float(jinfo["quantizer_loss"])
    # the straight-through estimator: dz/dx is the identity; the codebooks
    # learn from the quantizer loss alone
    xt = _t(x).requires_grad_(True)
    z, info = tb.encode(xt, return_info=True)
    (z.sum() + info["quantizer_loss"]).backward()
    assert tb.quantizer.quantizer_0.codebook.grad.abs().max() > 0


def test_export_prefers_the_ema(tiny_wrapper, tmp_path):
    w = tiny_wrapper(use_ema=True)
    w.train_step(_reals(512))
    for e in w.ema:
        e.add_(1.0)
    w.export_model(str(tmp_path / "ema.pt"))
    sd = torch.load(tmp_path / "ema.pt", weights_only=True)
    for (n, p), e in zip(w.gen_named, w.ema):
        assert torch.equal(sd[n], e) and not torch.equal(sd[n], p.detach()), n
    w = tiny_wrapper(use_ema=False)
    w.export_model(str(tmp_path / "plain.pt"))
    sd = torch.load(tmp_path / "plain.pt", weights_only=True)
    for n, p in w.autoencoder.named_parameters():
        assert torch.equal(sd[n], p.detach()), n


@pytest.mark.parametrize("path", AE_CONFIGS, ids=lambda p: os.path.basename(p)[:-5])
def test_factory_builds_every_shipped_autoencoder(path):
    """The port's model on the meta device has the JAX model's parameter
    count (chip_smoke.py builds each on the card with its AE-GAN wrapper;
    the tiny config's wrapper comes from the factory in the CLI test)."""
    cfg = json.load(open(path))
    with torch.device("meta"):
        model = create_autoencoder_from_config(cfg)
    jae = jax_ae_from_config(cfg)
    x = jax.ShapeDtypeStruct((1, 4 * jae.downsampling_ratio, jae.in_channels), jnp.float32)
    shapes = jax.eval_shape(jae.module.init, {"params": jax.random.PRNGKey(0),
                                              "sample": jax.random.PRNGKey(1)}, x)
    n_jax = sum(int(np.prod(v.shape)) for _, v in _flat(shapes["params"]))
    # flax's LSTM cell has no input-side bias: the port's nn.LSTM holds it at zero
    assert sum(p.numel() for n, p in model.named_parameters() if ".bias_ih_l" not in n) == n_jax
    assert (model.sample_rate, model.latent_dim, model.downsampling_ratio) == (
        cfg["sample_rate"], cfg["model"]["latent_dim"], cfg["model"]["downsampling_ratio"])


def test_cli_trains_two_steps_and_resumes(tmp_path):
    cfg = tiny_ae_config()
    cfg["training"]["checkpoint"]["every_n_train_steps"] = 2
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        wavfile.write(str(wavs / f"c{i}.wav"), SR, (rng.randn(2 * T, 2) * 3000).astype(np.int16))
    (tmp_path / "model.json").write_text(json.dumps(cfg))
    (tmp_path / "data.json").write_text(json.dumps(
        {"dataset_type": "audio_dir", "datasets": [{"id": "w", "path": str(wavs)}]}))
    args = ["--model-config", str(tmp_path / "model.json"), "--dataset-config",
            str(tmp_path / "data.json"), "--batch-size", "2", "--num-workers", "0",
            "--save-dir", str(tmp_path / "run"), "--name", "ae", "--device", "cpu"]
    trainer = train_main(args + ["--max-steps", "2"])
    w = trainer.wrapper
    assert isinstance(w, AutoencoderTrainingWrapper) and w.step == 2
    ckpt = os.path.join(trainer.ckpt_dir, "last")
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)
    resumed = train_main(args + ["--max-steps", "3", "--ckpt-path", ckpt]).wrapper
    assert resumed.step == 3
    # step 2 was a generator step from the checkpoint's weights
    assert any(not torch.equal(saved["autoencoder"][n], p.detach().cpu())
               for n, p in resumed.autoencoder.named_parameters())
    resumed.export_model(str(tmp_path / "vae.pt"))
    model = create_model_from_config(cfg, device="cpu")
    model.load_state_dict(torch.load(tmp_path / "vae.pt", weights_only=True), strict=True)


# ---------------------------------------------------------------------------
# K2, K3, K4 under grad: the autograd Functions on CPU tensors
# ---------------------------------------------------------------------------


def _leaf(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).requires_grad_(True)


def _conv_cases(gen):
    c = 128  # the CUDA K3 takes C % 128 == 0
    a = (_leaf(gen, c).detach().abs() + 0.5).requires_grad_(True)
    ib = (1.0 / a.detach()).requires_grad_(True)
    x = _leaf(gen, 2, 40, c, scale=0.5)
    return {
        "K2": (tconv.snake_conv1d, "_launch_snake_conv1d", tconv.snake_conv1d_plain,
               (x, _leaf(gen, 7, c, 8, scale=0.03), _leaf(gen, 8, scale=0.1), a, ib, 3, 9)),
        "K3": (tconv.fused_residual_unit, "_launch_fused_residual_unit",
               tconv.fused_residual_unit_plain,
               (x, _leaf(gen, 7, c, c, scale=0.03), _leaf(gen, c, scale=0.1), a, ib,
                _leaf(gen, c, c, scale=0.03), _leaf(gen, c, scale=0.1), a, ib, 3)),
        "K4": (tconv.snake_conv_transpose1d, "_launch_snake_conv_transpose1d",
               tconv.snake_conv_transpose1d_plain,
               (x, _leaf(gen, 4, c, 32, scale=0.06), _leaf(gen, 32, scale=0.1), a, ib, 2)),
    }


@pytest.mark.parametrize("kernel", ["K2", "K3", "K4"])
def test_conv_autograd_functions_carry_the_plain_gradient(kernel, monkeypatch):
    """Forced onto the kernel route with the launch replaced by the plain
    version (no launch on the CPU), each wrapper runs its autograd Function
    under grad: the output and every input's gradient equal the plain
    version's own autograd; under torch.no_grad() it calls the launch
    directly and builds no graph."""
    wrapper, launch, plain, args = _conv_cases(torch.Generator().manual_seed(0))[kernel]
    calls = []
    monkeypatch.setattr(tconv, "uses_kernels", lambda x: True)
    monkeypatch.setattr(tconv, launch, lambda *a: calls.append(1) or plain(*a))
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    y = wrapper(*args)
    assert type(y.grad_fn).__name__.startswith(("SnakeConv", "FusedResidual")) and calls == [1]
    g_out = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad(y, tensors, g_out)
    y_ref = plain(*args)
    want = torch.autograd.grad(y_ref, tensors, g_out)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        y = wrapper(*args)
    assert y.grad_fn is None and calls == [1, 1]
