"""Init-audio generation of the torch port against the JAX package's.

`generate_diffusion_cond` with `init_audio` on the tiny SAO model of
test_torch_port_pipeline.py (its Oobleck encoder encodes the init audio to
the posterior mean on both sides), the port fed JAX's initial noise and
its sampler's draws, the inpaint merge's included (test_torch_samplers.py:
`jax_draws`): variation, inpainting with outpainting's cut and paste, two
samples repeating one init latent, and a rectified-flow model from noise and
in variation. Tolerance: 1e-3 of the output's peak, as
test_torch_port_pipeline.py states. `build_mask` and `prepare_audio` (host
arithmetic in both) must agree exactly.
"""

import jax
import numpy as np
import pytest
import torch

from friendly_stable_audio_tools_tpu.inference.generation import build_mask as jax_build_mask
from friendly_stable_audio_tools_tpu.inference.generation import generate_diffusion_cond as jax_generate
from friendly_stable_audio_tools_tpu.inference.utils import prepare_audio as jax_prepare_audio
from friendly_stable_audio_tools_tpu_torch.inference.generation import build_mask, generate_diffusion_cond
from friendly_stable_audio_tools_tpu_torch.inference.utils import prepare_audio
from tests.test_torch_port_pipeline import CONDITIONING, LATENTS, RATIO, SEED, tiny_sao_config
from tests.test_torch_samplers import _close_to_peak, build_pair, generate_both

STEPS = 6
SAMPLE_SIZE = LATENTS * RATIO
# mono at 16 kHz: 80 samples resample to 221 at 44.1 kHz, cropped to 192
INIT = (16000, (0.3 * np.sin(np.arange(80) / 5.0)
                + 0.05 * np.random.RandomState(4).randn(80)).astype(np.float32))
# 0-100 percent of the clip: [cropfrom, cropfrom + len) pasted at [pastefrom, pasteto)
CUT_PASTE = {"cropfrom": 10.0, "pastefrom": 30.0, "pasteto": 90.0, "maskstart": 30.0,
             "maskend": 90.0, "softnessL": 10.0, "softnessR": 5.0, "marination": 0.0}
# the crop runs past the clip's end: the pasted span is shortened to it
CUT_PAST_END = {"cropfrom": 60.0, "pastefrom": 0.0, "pasteto": 70.0, "maskstart": 0.0,
                "maskend": 70.0, "softnessL": 0.0, "softnessR": 20.0, "marination": 0.2}


@pytest.fixture(scope="module")
def models():
    return build_pair(tiny_sao_config())


@pytest.fixture(scope="module")
def rf_models():
    config = tiny_sao_config()
    config["model"]["diffusion"]["diffusion_objective"] = "rectified_flow"
    return build_pair(config)


def _generate(pair, num_sample=1, sampler="dpmpp-3m-sde", **kw):
    jmodel, tmodel = pair
    return generate_both(jmodel, tmodel, STEPS, (num_sample, LATENTS, 16), sampler,
                         conditioning=CONDITIONING[:num_sample], cfg_scale=4.0,
                         sample_size=SAMPLE_SIZE, sigma_min=0.3, sigma_max=50.0, **kw)


def test_variation_matches_jax(models):
    got, want = _generate(models, init_audio=INIT, init_noise_level=5.0)
    assert want.shape == (1, 2, SAMPLE_SIZE)
    _close_to_peak(got, want)
    # the init audio moved the result: the port from noise alone differs
    plain = generate_diffusion_cond(models[1], steps=STEPS, conditioning=CONDITIONING[:1],
                                    cfg_scale=4.0, sample_size=SAMPLE_SIZE, seed=SEED,
                                    sampler_type="dpmpp-3m-sde", sigma_min=0.3,
                                    sigma_max=50.0).numpy()
    assert np.abs(plain - got).max() > 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("sampler,mask_args", [("dpmpp-3m-sde", CUT_PASTE),
                                               ("k-dpmpp-2s-ancestral", CUT_PAST_END)],
                         ids=["cut_paste", "past_end"])
def test_inpainting_with_cut_and_paste_matches_jax(models, mask_args, sampler):
    got, want = _generate(models, sampler=sampler, init_audio=INIT, mask_args=mask_args)
    _close_to_peak(got, want)


def test_two_samples_repeat_the_init_latent(models):
    """Two prompts inpainting one init audio: the latent is repeated, and
    the merge draws each sample's own noise."""
    # JAX generate_diffusion_cond's compiled-program cache is keyed without num_sample
    # (its init-latent repeat is traced in): a one-sample program compiled
    # by an earlier test would repeat the latent once, and its merge would
    # draw one sample's noise, so the cache starts empty here
    models[0]._gen_jit_cache = {}
    got, want = _generate(models, num_sample=2, init_audio=(44100, np.stack([INIT[1]] * 2)),
                          mask_args=CUT_PASTE)
    assert want.shape == (2, 2, SAMPLE_SIZE)
    _close_to_peak(got, want)


@pytest.mark.parametrize("mode", ["noise", "variation"])
def test_rectified_flow_generation_matches_jax(rf_models, mode):
    kw = dict(init_audio=INIT, init_noise_level=0.6) if mode == "variation" else {}
    got, want = _generate(rf_models, sampler=None, **kw)
    _close_to_peak(got, want)


def test_latents_and_conditioning_tensors_match_jax(models):
    """return_latents with conditioning and negative conditioning given as
    each package's own conditioner outputs; inpainting at k-dpm-fast."""
    jmodel, tmodel = models
    negative = [{"prompt": "noise", "seconds_start": 0, "seconds_total": 10}]
    kw = dict(steps=STEPS, cfg_scale=4.0, sample_size=SAMPLE_SIZE, seed=SEED, sigma_min=0.3,
              sigma_max=50.0, sampler_type="k-dpm-fast", init_audio=INIT, mask_args=CUT_PASTE,
              return_latents=True)
    want = np.asarray(jax_generate(
        jmodel, conditioning_tensors=jmodel.conditioner(CONDITIONING[:1]),
        negative_conditioning_tensors=jmodel.conditioner(negative), **kw))
    k_noise, k_sampler = jax.random.split(jax.random.PRNGKey(SEED))
    noise = torch.tensor(np.asarray(jax.random.normal(k_noise, (1, LATENTS, 16))))
    merge_noise = [torch.tensor(np.asarray(jax.random.normal(k, (1, LATENTS, 16))))
                   for k in jax.random.split(k_sampler, STEPS // 3 + 1)]
    got = generate_diffusion_cond(
        tmodel, conditioning_tensors=tmodel.conditioner(CONDITIONING[:1], device="cpu"),
        negative_conditioning_tensors=tmodel.conditioner(negative, device="cpu"), noise=noise,
        merge_noise=merge_noise, **kw).numpy()
    assert want.shape == (1, 16, LATENTS)
    _close_to_peak(got, want)


@pytest.mark.parametrize("size,args", [
    (256, {"maskstart": 25.0, "maskend": 75.0, "softnessL": 5.0, "softnessR": 5.0,
           "marination": 0.0}),
    (1024, CUT_PASTE), (24, CUT_PAST_END),
    # soft edges wider than the span are clamped to it
    (100, {"maskstart": 40.0, "maskend": 50.0, "softnessL": 30.0, "softnessR": 30.0,
           "marination": 0.5}),
    (100, {"maskstart": 40.0, "maskend": 50.0, "softnessL": 0.0, "softnessR": 30.0,
           "marination": 0.0}),
    (77, {"maskstart": 0.0, "maskend": 100.0, "softnessL": 33.0, "softnessR": 33.0,
          "marination": 0.1}),
])
def test_build_mask_matches_jax_exactly(size, args):
    got = build_mask(size, args).numpy()
    want = np.asarray(jax_build_mask(size, args))
    assert got.dtype == want.dtype == np.float32 and got.shape == (size,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,in_sr,length,channels", [
    ((100,), 16000, 192, 2),        # mono to stereo, 16 kHz -> 44.1 kHz, cropped
    ((2, 100), 16000, 400, 1),      # stereo to mono, padded
    ((1, 100), 16000, 300, 2),      # one channel to two
    ((3, 2, 500), 44100, 256, 2),   # a batch at the target rate, cropped
    ((4, 300), 48000, 300, 2),      # four channels to two, 48 kHz
])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["array", "tensor"])
def test_prepare_audio_matches_jax_exactly(shape, in_sr, length, channels, as_tensor):
    audio = np.random.RandomState(len(shape) + length).randn(*shape).astype(np.float32) * 0.3
    want = jax_prepare_audio(audio, in_sr=in_sr, target_sr=44100, target_length=length,
                             target_channels=channels)
    got = prepare_audio(torch.tensor(audio) if as_tensor else audio, in_sr=in_sr,
                        target_sr=44100, target_length=length, target_channels=channels)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.shape[1:] == (channels, length)
    np.testing.assert_array_equal(got.numpy(), want)
