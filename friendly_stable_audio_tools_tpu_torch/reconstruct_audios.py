"""Folder reconstruction CLI of the torch port (counterpart of the
repository's reconstruct_audios.py): every WAV under `--audio-dir` goes
through an `autoencoder` model's encode and decode, chunk by chunk with a
crossfade, and is written under `--output-dir` with its own name.

    python -m friendly_stable_audio_tools_tpu_torch.reconstruct_audios \
        --model-config friendly_stable_audio_tools_tpu/configs/model_configs/autoencoders/stable_audio_2_0_vae.json \
        --ckpt-path vae.pt --audio-dir in/ --output-dir out/

Each file is resampled to the model's rate, its channels set to the model's
(a mean for mono, a copy of mono for stereo), padded to a multiple of the
downsampling ratio, reconstructed in chunks of `--frame-duration` seconds
overlapping by `--overlap-rate` of that (at least one latent frame;
AudioAutoencoder.reconstruct_nwc), and cut back to its length. Work is
split across processes as `[rank::world_size]` from the RANK / WORLD_SIZE
environment variables. The model runs in fp32 with TF32 off, through the
port's kernels on the card (`--device cuda`, the default; raises without a
CUDA device) or their plain versions (`--device cpu`). Without
`--ckpt-path` the weights are random, drawn from seed 0; a checkpoint is a
state_dict of the port's autoencoder (the AE-GAN trainer's `export_model`,
or utils/convert.py:convert_autoencoder of a JAX tree). `--batch-size` is
taken and unused, as the JAX CLI's chunked round trip runs one chunk at a
time.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-config", type=str, required=True, help="Model config file (json).")
    p.add_argument("--ckpt-path", type=str, default="", help="state_dict of the port's autoencoder.")
    p.add_argument("--audio-dir", type=str, required=True, help="Directory of audio files.")
    p.add_argument("--output-dir", type=str, required=True, help="Directory for the results.")
    p.add_argument("--frame-duration", type=float, default=1.0, help="Chunk duration in seconds.")
    p.add_argument("--overlap-rate", type=float, default=0.01,
                   help="Chunk overlap rate for the crossfade.")
    p.add_argument("--batch-size", type=int, default=20, help="Taken and unused.")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    import numpy as np
    import torch

    from .data.dataset import get_audio_filenames, load_audio_file, resample_audio
    from .generate import write_wav
    from .inference.utils import set_audio_channels
    from .models.factory import create_model_from_config
    from .utils.common import resolve_device

    device = resolve_device(args.device, "--device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(args.model_config) as f:
        model_config = json.load(f)
    if model_config.get("model_type") != "autoencoder":
        raise ValueError("reconstruct_audios takes an `autoencoder` model config")
    model = create_model_from_config(model_config, device=device)
    if args.ckpt_path:
        model.load_state_dict(torch.load(args.ckpt_path, map_location=device, weights_only=True))
    rank = int(os.environ.get("RANK", 0))
    world_size = int(os.environ.get("WORLD_SIZE", 1))

    sr, ratio = model.sample_rate, model.downsampling_ratio
    chunk_size = int((args.frame_duration * sr) / ratio)
    overlap = max(int((args.frame_duration * sr * args.overlap_rate) / ratio), 1)
    if rank == 0:
        n_params = sum(p.numel() for p in model.parameters())
        print(f"sample rate {sr}; in/out channels {model.in_channels} / {model.out_channels}; "
              f"ratio {ratio}; latent dim {model.latent_dim}; params {n_params / 1e6:.2f} M; "
              f"chunks of {chunk_size} latents, overlap {overlap}; device {device}")

    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for path in get_audio_filenames(args.audio_dir)[rank::world_size]:
        audio, in_sr = load_audio_file(path)
        audio = set_audio_channels(torch.from_numpy(resample_audio(audio, in_sr, sr))[None],
                                   model.in_channels)
        t = audio.shape[-1]
        audio = torch.nn.functional.pad(audio, (0, (ratio - t % ratio) % ratio))
        with torch.no_grad():
            recon = model.reconstruct_nwc(audio.transpose(1, 2).to(device), chunk_size, overlap)
        recon = recon[0, :t].T.float().cpu().numpy()
        out_path = output_dir / (Path(path).stem + ".wav")
        write_wav(str(out_path), sr, np.ascontiguousarray(recon))
        print(f"[rank {rank}] {path} -> {out_path}")
    print(f"Rank-{rank}: finished.")


if __name__ == "__main__":
    main()
