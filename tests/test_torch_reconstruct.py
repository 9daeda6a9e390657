"""The torch port's chunked processing and folder reconstruction against the
JAX package, on the CPU in fp32.

`chunked_process` against JAX's (ops/chunking.py) on a network that mixes
channels and changes the length, with zero and reflect padding, to 1e-6;
`microbatched` against one call; the tiny Oobleck VAE's chunked round
trip (`AudioAutoencoder.reconstruct_nwc`) against JAX's
`reconstruct_audio` at the same weights, to 1e-5 of the largest output
(fp32 rounding through the encoder and the decoder); then the port's
reconstruct CLI on a directory of WAVs of ragged lengths.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from friendly_stable_audio_tools_tpu.models.bottleneck import VAEBottleneck as JVAEBottleneck
from friendly_stable_audio_tools_tpu.ops.chunking import chunked_process as jax_chunked
from friendly_stable_audio_tools_tpu_torch.models.autoencoders import create_autoencoder_from_config
from friendly_stable_audio_tools_tpu_torch.ops.chunking import chunked_process, microbatched
from friendly_stable_audio_tools_tpu_torch.reconstruct_audios import main as reconstruct_main
from friendly_stable_audio_tools_tpu_torch.utils.convert import convert_autoencoder
from tests.test_autoencoder import tiny_ae
from tests.test_torch_ae_train import tiny_ae_config

MIX = np.random.RandomState(0).randn(3, 2).astype(np.float32)


def _jax_net(x):  # [B, T, 3] -> [B, 2T, 2]
    return jnp.repeat(jnp.tanh(x @ jnp.asarray(MIX)), 2, axis=1)


def _torch_net(x):
    return torch.repeat_interleave(torch.tanh(x @ torch.tensor(MIX)), 2, dim=1)


@pytest.mark.parametrize("pad_mode,t", [("zero", 1000), ("reflect", 1000), ("zero", 96),
                                        ("reflect", 1024)])
def test_chunked_process_matches_jax(pad_mode, t):
    x = np.random.RandomState(1).randn(2, t, 3).astype(np.float32)
    kw = dict(chunk_in=128, hop_in=112, chunk_out=256, hop_out=224, overlap_out=32,
              out_channels=2, out_length=2 * t, pad_mode=pad_mode)
    want = jax_chunked(_jax_net, jnp.asarray(x), **kw)
    got = chunked_process(_torch_net, torch.tensor(x), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_microbatched_is_one_call():
    x = torch.randn(5, 7, 3, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(microbatched(_torch_net, x, 2), _torch_net(x), rtol=0, atol=0)


@pytest.fixture(scope="module")
def vae_pair():
    jae = tiny_ae(JVAEBottleneck(), latent_dim=8, enc_latent_dim=16)
    cfg = tiny_ae_config()
    model = create_autoencoder_from_config(cfg)
    model.load_state_dict(convert_autoencoder(jae.params), strict=True)
    return jae, model.eval(), cfg


def test_chunked_round_trip_matches_jax(vae_pair):
    jae, model, _ = vae_pair
    audio = (0.3 * np.random.RandomState(2).randn(1, 2, 8 * 100)).astype(np.float32)
    want = np.asarray(jae.reconstruct_audio(jnp.asarray(audio), chunked=True, chunk_size=32,
                                            overlap=4))
    with torch.no_grad():
        got = model.reconstruct_nwc(torch.tensor(audio).transpose(1, 2), 32, 4)
    got = got.transpose(1, 2).numpy()
    assert got.shape == want.shape == audio.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_reconstruct_cli(vae_pair, tmp_path):
    _, model, cfg = vae_pair
    (tmp_path / "model.json").write_text(json.dumps(cfg))
    torch.save(model.state_dict(), tmp_path / "vae.pt")
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.RandomState(3)
    lengths = {"a": 3001, "b": 1600}  # 3001: not a multiple of the ratio
    wavfile.write(str(src / "a.wav"), 16000, (rng.randn(lengths["a"], 2) * 3000).astype(np.int16))
    wavfile.write(str(src / "b.wav"), 8000, (rng.randn(lengths["b"]) * 3000).astype(np.int16))
    reconstruct_main(["--model-config", str(tmp_path / "model.json"), "--ckpt-path",
                      str(tmp_path / "vae.pt"), "--audio-dir", str(src), "--output-dir",
                      str(tmp_path / "out"), "--frame-duration", "0.05", "--device", "cpu"])
    for name, n in (("a", 3001), ("b", 3200)):  # b: mono at 8 kHz, resampled and made stereo
        sr, data = wavfile.read(str(tmp_path / "out" / f"{name}.wav"))
        assert sr == 16000 and data.shape == (n, 2) and np.abs(data).max() > 0
