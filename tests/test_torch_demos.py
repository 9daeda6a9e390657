"""The torch port's training demos, mirroring tests/test_demos.py: each
ported type's demo callback on a tiny model writes its wavs under
`samples/<step>/`; the diffusion demo generates from the EMA weights and
puts the live ones back; the factory dispatches every type; and the train
CLI runs a demo, the weight-norm fold and the profiler window on the CPU.
Tiny sizes, fp32, all on the CPU (the plain versions of the kernels)."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from friendly_stable_audio_tools_tpu_torch.models.factory import create_model_from_config
from friendly_stable_audio_tools_tpu_torch.train import main as train_main
from friendly_stable_audio_tools_tpu_torch.training import demos
from friendly_stable_audio_tools_tpu_torch.training.factory import (
    create_demo_callback_from_config,
    create_training_wrapper_from_config,
)
from friendly_stable_audio_tools_tpu_torch.training.logging import ExperimentLogger
from tests.test_torch_ae_train import tiny_ae_config
from tests.test_torch_lm import tiny_lm_config
from tests.test_torch_train_slice import LATENTS, METADATA, RATIO, tiny_train_config


class _Trainer:
    """The attributes a demo reads from the trainer."""

    def __init__(self, wrapper, save_dir):
        self.wrapper = wrapper
        self.save_dir = str(save_dir)
        self.logger = ExperimentLogger()


def _wavs(save_dir, step):
    d = os.path.join(str(save_dir), "samples", str(step))
    return sorted(f for f in os.listdir(d) if f.endswith(".wav")) if os.path.isdir(d) else []


def test_diffusion_cond_demo_uses_the_ema_and_restores_the_weights(tmp_path, monkeypatch):
    """Two cfg scales, one demo each, 4 steps, plus the pretransform round
    trip of the batch's first clip; the DiT generates from the EMA weights
    (checked inside the sampler call) and holds its live weights after."""
    from friendly_stable_audio_tools_tpu_torch.inference import generation

    config = tiny_train_config()
    model = create_model_from_config(config, device="cpu")
    wrapper = create_training_wrapper_from_config(config, model)
    with torch.no_grad():
        for e in wrapper.ema:
            e.mul_(0.5)
    live = [p.detach().clone() for p in wrapper.dit_params]
    seen = []
    real = generation.generate_diffusion_cond

    def spy(m, **kw):
        seen.append(all(torch.equal(p, e) for p, e in zip(wrapper.dit_params, wrapper.ema)))
        return real(m, **kw)

    monkeypatch.setattr(generation, "generate_diffusion_cond", spy)
    cb = demos.DiffusionCondDemoCallback(
        demo_every=2, num_demos=1, demo_steps=4, sample_size=LATENTS * RATIO, sample_rate=16000,
        demo_conditioning=METADATA[:1], demo_cfg_scales=[1, 3])
    reals = torch.randn(2, LATENTS * RATIO, 2) * 0.1
    cb.on_step(_Trainer(wrapper, tmp_path), 1, (reals, METADATA))  # not a demo step
    assert _wavs(tmp_path, 1) == [] and seen == []
    cb.on_step(_Trainer(wrapper, tmp_path), 2, (reals, METADATA))
    assert _wavs(tmp_path, 2) == ["demo_cfg1_0.wav", "demo_cfg3_0.wav", "pretransform_recon.wav"]
    assert seen == [True, True]
    assert all(torch.equal(p, v) for p, v in zip(wrapper.dit_params, live))
    sr, audio = wavfile.read(os.path.join(tmp_path, "samples", "2", "demo_cfg3_0.wav"))
    assert sr == 16000 and audio.shape == (LATENTS * RATIO, 2)


def test_inpaint_demo_regenerates_everything(tmp_path):
    """A `diffusion_cond_inpaint` model's demo gives its DiT an all-zero
    keep mask and masked input (free generation)."""
    from tests.test_torch_train_options import inpaint_config

    config = inpaint_config(tiny_train_config())
    model = create_model_from_config(config, device="cpu")
    cb = create_demo_callback_from_config(config)
    cb.num_demos, cb.demo_steps, cb.demo_cfg_scales = 1, 2, [3]
    cb.demo_conditioning = METADATA[:1]
    cond = cb.conditioning_tensors(model)
    assert cond["inpaint_mask"][0].shape == (1, LATENTS, 1) and not cond["inpaint_mask"][0].any()
    assert cond["inpaint_masked_input"][0].shape == (1, LATENTS, 4)
    wrapper = create_training_wrapper_from_config(config, model)
    cb.on_step(_Trainer(wrapper, tmp_path), cb.demo_every, None)
    assert _wavs(tmp_path, cb.demo_every) == ["demo_cfg3_0.wav"]


def test_autoencoder_demo_writes_reconstructions_and_the_latent_pca(tmp_path):
    cfg = tiny_ae_config()
    model = create_model_from_config(cfg, device="cpu")
    wrapper = create_training_wrapper_from_config(cfg, model)
    cb = demos.AutoencoderDemoCallback(demo_every=2, max_num_sample=2, sample_rate=16000)
    reals = torch.randn(3, 512, 2) * 0.1
    cb.on_step(_Trainer(wrapper, tmp_path), 2, (reals, [{}] * 3))
    assert _wavs(tmp_path, 2) == ["real_0.wav", "real_1.wav", "recon_0.wav", "recon_1.wav"]
    pca = np.load(os.path.join(tmp_path, "samples", "2", "latent_pca.npy"))
    assert pca.shape == (2 * 512 // 8, 6) and np.isfinite(pca).all()


def test_lm_demo_writes_its_generations(tmp_path):
    config = tiny_lm_config()
    config["sample_size"] = 8 * 6  # 8 frames of the tiny SEANet's ratio 6
    # codebooks of 256 entries: generation keeps the top 250 (the LM's default top_k)
    config["model"]["pretransform"]["config"]["bottleneck"]["config"]["codebook_size"] = 256
    model = create_model_from_config(config, device="cpu")
    wrapper = create_training_wrapper_from_config(config, model)
    cb = create_demo_callback_from_config(
        {**config, "training": {"demo": {"demo_every": 2, "num_demos": 3,
                                         "demo_cond": [{"prompt": "drums"}, {"prompt": "bass"}]}}})
    assert isinstance(cb, demos.AudioLanguageModelDemoCallback)
    cb.on_step(_Trainer(wrapper, tmp_path), 2, None)
    assert _wavs(tmp_path, 2) == ["lm_demo_0.wav", "lm_demo_1.wav"]


def test_demo_factory_dispatch():
    base = {"sample_size": 256, "sample_rate": 16000, "training": {"demo": {"demo_every": 7}}}
    cases = {"autoencoder": demos.AutoencoderDemoCallback,
             "diffusion_cond": demos.DiffusionCondDemoCallback,
             "diffusion_cond_inpaint": demos.DiffusionCondDemoCallback,
             "lm": demos.AudioLanguageModelDemoCallback,
             "diffusion_uncond": demos.DiffusionDemoCallback,
             "diffusion_prior": demos.DiffusionCondDemoCallback,
             "diffusion_autoencoder": demos.DiffusionAutoencoderDemoCallback}
    for model_type, cls in cases.items():
        cb = create_demo_callback_from_config({**base, "model_type": model_type})
        assert isinstance(cb, cls) and cb.demo_every == 7, model_type
    with pytest.raises(NotImplementedError, match="Unknown model type"):
        create_demo_callback_from_config({**base, "model_type": "diffusion_unknown"})


def test_train_cli_demo_weight_norm_fold_and_profile(tmp_path):
    """Two steps of the train CLI on the tiny SAO model with a demo at step
    2 (one demo, two cfg scales), `--remove-pretransform-weight-norm
    post_load` (the VAE then holds plain kernels) and `--profile-dir` over
    step 1 (a Chrome trace with the step's ops)."""
    config = tiny_train_config()
    config["training"]["demo"].update(demo_every=2, demo_steps=2, num_demos=1,
                                      demo_cfg_scales=[1, 3])
    config["training"]["checkpoint"]["every_n_train_steps"] = 100
    (tmp_path / "model.json").write_text(json.dumps(config))
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.RandomState(2)
    for i in range(2):
        wavfile.write(str(wavs / f"clip{i}.wav"), 44100, (rng.randn(300, 2) * 3000).astype(np.int16))
    (tmp_path / "data.json").write_text(json.dumps(
        {"dataset_type": "audio_dir", "datasets": [{"id": "wavs", "path": str(wavs)}]}))
    trainer = train_main(["--model-config", str(tmp_path / "model.json"), "--dataset-config",
                          str(tmp_path / "data.json"), "--batch-size", "2", "--num-workers", "0",
                          "--save-dir", str(tmp_path / "run"), "--name", "tiny", "--device", "cpu",
                          "--max-steps", "2", "--remove-pretransform-weight-norm", "post_load",
                          "--profile-dir", str(tmp_path / "prof"), "--profile-start-step", "1",
                          "--profile-steps", "1"])
    assert trainer.wrapper.step == 2
    assert _wavs(trainer.save_dir, 2) == ["demo_cfg1_0.wav", "demo_cfg3_0.wav",
                                          "pretransform_recon.wav"]
    names = [n for n, _ in trainer.wrapper.model.pretransform.named_parameters()]
    assert any(n.endswith(".kernel") for n in names)
    assert not any(n.endswith((".v", ".g")) for n in names)
    traces = os.listdir(tmp_path / "prof")
    assert traces == ["trace_steps_1_2.json"]
    events = json.loads((tmp_path / "prof" / traces[0]).read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
