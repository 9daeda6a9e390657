"""The torch port's text-to-audio slice against the JAX package, end to end.

A Stable-Audio-Open-shaped model (the SAO 1.0 config with narrow widths:
DiT 256 wide, 2 layers, 4 heads of 64; t5-small; a two-block Oobleck
decoder) is built by the JAX package's factory, its DiT de-zeroed, and its
weights converted into the port. Both packages' `generate_diffusion_cond`
then run with the same initial noise and the same per-step sampler noise
(the JAX sampler's own draws, injected into the port). Tolerance: 1e-3 of
the output's peak, covering fp32 rounding differences between XLA and
PyTorch compounded over 8 sampler steps and the decoder.

A subprocess runs the port (factory, generation from noise and from init
audio, the generate and train CLIs, and a model with the CLAP text
conditioner) behind an import hook that
refuses jax, flax and the JAX package, and checks that none of them enters
`sys.modules`.
"""

import copy
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from friendly_stable_audio_tools_tpu.inference.generation import generate_diffusion_cond as jax_generate
from friendly_stable_audio_tools_tpu.models.factory import create_model_from_config as jax_create
from friendly_stable_audio_tools_tpu.utils.common import dezero_params
from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.utils.convert import convert_conditioned_diffusion

REPO = Path(__file__).resolve().parents[1]
SAO_CONFIG = REPO / "friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio/stable_audio_open_1_0.json"
LATENTS = 24
RATIO = 8
STEPS = 8
SEED = 1234
CONDITIONING = [{"prompt": "amen break 174 bpm", "seconds_start": 0, "seconds_total": 47},
                {"prompt": "a calm piano melody", "seconds_start": 3, "seconds_total": 12}]


def tiny_sao_config():
    """SAO 1.0's config at narrow widths (same structure and conditioning)."""
    c = copy.deepcopy(json.loads(SAO_CONFIG.read_text()))
    c["sample_size"] = LATENTS * RATIO
    model = c["model"]
    model["io_channels"] = 16
    model["conditioning"]["cond_dim"] = 128
    model["conditioning"]["configs"][0]["config"]["t5_model_name"] = "t5-small"
    model["diffusion"]["config"].update(io_channels=16, embed_dim=256, depth=2, num_heads=4,
                                        cond_token_dim=128, global_cond_dim=256)
    pt = model["pretransform"]["config"]
    pt.update(latent_dim=16, downsampling_ratio=RATIO)
    pt["encoder"]["config"].update(channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=32)
    pt["decoder"]["config"].update(channels=8, c_mults=[1, 2], strides=[2, 4], latent_dim=16)
    return c


def _jax_sampler_noise(steps, shape):
    """Noise of the JAX driver for SEED: the initial draw from k_noise and
    the scan's per-step draws from k_sampler (generation.py:215-217,
    sampling.py:557-590)."""
    k_noise, k_sampler = jax.random.split(jax.random.PRNGKey(SEED))
    noise = np.asarray(jax.random.normal(k_noise, shape))
    steps_noise = [np.asarray(jax.random.normal(jax.random.split(k)[1], shape))
                   for k in jax.random.split(k_sampler, steps)]
    return torch.tensor(noise), [torch.tensor(n) for n in steps_noise]


@pytest.mark.parametrize("cfg_scale,scale_phi", [(7.0, 0.0), (4.0, 0.5)])
def test_generate_diffusion_cond_matches_jax(cfg_scale, scale_phi):
    config = tiny_sao_config()
    jmodel = jax_create(config, init_rng=jax.random.PRNGKey(0))
    jmodel.params = dezero_params(jmodel.params)
    kw = dict(steps=STEPS, cfg_scale=cfg_scale, conditioning=CONDITIONING,
              sample_size=LATENTS * RATIO, sampler_type="dpmpp-3m-sde", sigma_min=0.3,
              sigma_max=50.0, seed=SEED, scale_phi=scale_phi)
    want = np.asarray(jax_generate(jmodel, **kw))

    tmodel = create_model_from_config(config, device="cpu")
    tmodel.load_state_dict(convert_conditioned_diffusion(
        jmodel.params, jmodel.conditioner.params, jmodel.pretransform.model.params), strict=True)
    noise, step_noise = _jax_sampler_noise(STEPS, (len(CONDITIONING), LATENTS, 16))
    got = generate_diffusion_cond(tmodel, noise=noise, step_noise=step_noise, **kw).numpy()

    assert got.shape == want.shape == (2, 2, LATENTS * RATIO)
    peak = np.abs(want).max()
    assert peak > 1e-3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3 * peak)


def test_port_runs_without_jax(tmp_path):
    """Factory, generation on the CPU (from noise, a variation and an
    inpainting of init audio, and a k-dpm-adaptive pass), the generate CLI,
    one step of the train CLI and a model with a `clap_text` conditioner, in
    a process whose import hook refuses jax, flax and
    friendly_stable_audio_tools_tpu."""
    config_path = tmp_path / "tiny_sao.json"
    config_path.write_text(json.dumps(tiny_sao_config()))
    clap_config = tiny_sao_config()
    clap_config["model"]["conditioning"]["configs"][0] = {
        "id": "prompt", "type": "clap_text",
        "config": {"clap_ckpt_path": str(tmp_path / "no_such_clap.pt"),
                   "use_text_features": True, "feature_layer_ix": -2}}
    clap_path = tmp_path / "tiny_clap.json"
    clap_path.write_text(json.dumps(clap_config))
    (tmp_path / "wavs").mkdir()
    wav = np.random.RandomState(0).randn(LATENTS * RATIO + 50, 2) * 3000
    wavfile.write(str(tmp_path / "wavs" / "clip.wav"), 44100, wav.astype(np.int16))
    (tmp_path / "data.json").write_text(json.dumps(
        {"dataset_type": "audio_dir", "datasets": [{"id": "w", "path": str(tmp_path / "wavs")}]}))
    (tmp_path / "prompts.yaml").write_text(textwrap.dedent("""\
        drums:
          amen: {prompt: "amen break", seconds_start: 0, seconds_total: 47}
          calm: {prompt: "calm piano", seconds_start: 0, seconds_total: 2}
        """))
    script = textwrap.dedent(f"""\
        import importlib.abc, json, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "friendly_stable_audio_tools_tpu"):
                    raise ImportError("the torch port imported " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import torch
        from friendly_stable_audio_tools_tpu_torch import create_model_from_config
        from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
        from friendly_stable_audio_tools_tpu_torch.generate import main
        model = create_model_from_config(json.load(open({str(config_path)!r})), seed=3,
                                         device="cpu")
        audio = generate_diffusion_cond(model, steps=3, cfg_scale=7.0,
            conditioning=[{{"prompt": "x", "seconds_start": 0, "seconds_total": 47}}],
            sample_size={LATENTS * RATIO}, sampler_type="dpmpp-3m-sde", sigma_min=0.3,
            sigma_max=500, seed=5)
        assert audio.shape == (1, 2, {LATENTS * RATIO}) and torch.isfinite(audio).all()
        # init-audio generation: a variation of that audio, an inpainting with
        # a cut and paste, and one k-dpm-adaptive pass
        init = (44100, audio[0])
        cond = [{{"prompt": "x", "seconds_start": 0, "seconds_total": 47}}]
        for kw in (dict(init_audio=init, init_noise_level=2.0, sampler_type="k-heun"),
                   dict(init_audio=init, sampler_type="dpmpp-2m-sde", mask_args=dict(
                       cropfrom=0, pastefrom=25, pasteto=75, maskstart=25, maskend=75,
                       softnessL=5, softnessR=5, marination=0)),
                   dict(sampler_type="k-dpm-adaptive")):
            out = generate_diffusion_cond(model, steps=3, cfg_scale=7.0, conditioning=cond,
                                          sample_size={LATENTS * RATIO}, sigma_min=0.3,
                                          sigma_max=50, seed=6, **kw)
            assert out.shape == (1, 2, {LATENTS * RATIO}) and torch.isfinite(out).all()
        main(["--model-config", {str(config_path)!r}, "--cond-yaml-path",
              {str(tmp_path / "prompts.yaml")!r}, "--output-dir", {str(tmp_path / "out")!r},
              "--sample-steps", "2", "--batch-size", "4", "--seed", "1", "--device", "cpu"])
        from friendly_stable_audio_tools_tpu_torch.train import main as train
        trainer = train(["--model-config", {str(config_path)!r}, "--dataset-config",
                         {str(tmp_path / "data.json")!r}, "--batch-size", "2", "--max-steps", "1",
                         "--num-workers", "0", "--save-dir", {str(tmp_path / "run")!r},
                         "--device", "cpu"])
        assert trainer.wrapper.step == 1
        clap = create_model_from_config(json.load(open({str(clap_path)!r})), device="cpu")
        emb, mask = clap.conditioner.conditioners["prompt"](["a calm piano melody"])
        assert emb.shape == (1, 77, 128) and mask.sum() == 5 and torch.isfinite(emb).all()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "friendly_stable_audio_tools_tpu"))
        assert not bad, bad
        print("OK")
        """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout
    wavs = sorted(p.name for p in (tmp_path / "out" / "drums").glob("*.wav"))
    assert wavs == ["amen_item-1.wav", "calm_item-1.wav"]
