"""Batch text-to-audio generation CLI of the torch port (counterpart of the
repository's generate.py, without its int8 options).

    python -m friendly_stable_audio_tools_tpu_torch.generate \
        --model-config friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio/stable_audio_open_1_0.json \
        --cond-yaml-path prompts.yaml --output-dir out/

The YAML file nests prompts to any depth; each leaf is one condition dict
(`prompt`, `seconds_start`, `seconds_total`). Work is split across
processes as `[rank::world_size]` from the RANK / WORLD_SIZE environment
variables. The model runs in its own dtype, as the JAX CLI runs it: fp32
(the VAE in bf16 only where the config sets `model_half`), with TF32 off for
matrix products and convolutions, so plain fp32 layers compute in fp32.
`--device cuda` (the default) runs it through the port's kernels (the bf16
attention kernels K1/K10 cast an fp32 input to bf16 inside and return fp32,
as the JAX package's do) and raises when there is no CUDA device;
`--device cpu` runs it through the kernels' plain versions. Without
`--ckpt-path` the weights are random, drawn from seed 0. Long-form Stable
Audio 2.0 (285 s) is the same command with
`--model-config friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio/stable_audio_2_0.json`,
and Stable Audio 1.0 (95.1 s; ADP U-Net, DAC VAE) with
`--model-config friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio/stable_audio_1_0.json`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import wave
from pathlib import Path

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output-dir", type=str, required=True, help="Directory for generated audio.")
    p.add_argument("--cond-yaml-path", type=str, required=True, help="YAML file of sample conditions.")
    p.add_argument("--model-name", type=str, default="stabilityai/stable-audio-open-1.0",
                   help="Pretrained model name (needs a local copy; use --model-config).")
    p.add_argument("--model-config", type=str, default="", help="Model config JSON.")
    p.add_argument("--ckpt-path", type=str, default="",
                   help="state_dict of the port's model (torch.save), e.g. converted with "
                        "friendly_stable_audio_tools_tpu_torch.utils.convert.")
    p.add_argument("--sampler-type", type=str, default="dpmpp-3m-sde",
                   help="k-euler, k-heun, k-lms, k-dpmpp-2s-ancestral, k-dpm-2, dpmpp-2m-sde, "
                        "dpmpp-3m-sde, k-dpm-fast or k-dpm-adaptive (a v-objective model); a "
                        "rectified-flow model ignores it")
    p.add_argument("--sample-steps", type=int, default=100)
    p.add_argument("--cfg-scale", type=float, default=7.0)
    p.add_argument("--n-sample-per-cond", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--clip-length", action="store_true",
                   help="Clip generated audio to the specified 'seconds_total'.")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--verbose", action="store_true",
                   help="print the sampler's rate every 10 model evaluations")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu")
    return p.parse_args(argv)


def flatten_dict(d, parent_key="", separator="/", depth=0):
    """Nested prompt YAML -> {path: condition dict}."""
    items = {}
    for k, v in d.items():
        if depth == 0 and not (isinstance(v, dict) and all(isinstance(v_, dict) for v_ in v.values())):
            raise ValueError("the top level of the condition YAML must map names to dicts")
        new_key = f"{parent_key}{separator}{k}" if parent_key else k
        if isinstance(list(v.values())[0], dict):
            items.update(flatten_dict(v, new_key, separator=separator, depth=depth + 1))
        else:
            items[new_key] = dict(v)
    return items


def write_wav(path: str, sample_rate: int, audio: np.ndarray) -> None:
    """audio [C, T] float in [-1, 1] -> 16-bit PCM wav."""
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.T.tobytes())


def main(argv=None):
    args = get_args(argv)
    import torch
    import yaml

    from .inference.generation import generate_diffusion_cond
    from .models.factory import create_model_from_config
    from .utils.common import resolve_device

    device = resolve_device(args.device, "--device cpu")
    # fp32 products and convolutions in fp32, as the JAX package computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not args.model_config:
        raise SystemExit("pretrained downloads are not available to the torch port: "
                         "pass --model-config (and --ckpt-path for trained weights)")
    rank = int(os.environ.get("RANK", 0))
    world_size = int(os.environ.get("WORLD_SIZE", 1))

    with open(args.model_config) as f:
        model_config = json.load(f)
    model = create_model_from_config(model_config, device=device)
    if args.ckpt_path:
        model.load_state_dict(torch.load(args.ckpt_path, map_location=device, weights_only=True))

    sample_rate = model_config["sample_rate"]
    sample_size = model_config["sample_size"]
    # CFG batch-doubling halves the effective batch
    batch_sample = max(args.batch_size // 2 if args.cfg_scale != 1.0 else args.batch_size, 1)

    with open(args.cond_yaml_path) as f:
        conds = flatten_dict(yaml.safe_load(f))
    paths, conditions = [], []
    for p, cond in conds.items():
        for idx in range(args.n_sample_per_cond):
            paths.append(f"{p}_item-{idx + 1}")
            conditions.append(cond)
    if rank == 0:
        n_params = sum(p.numel() for p in model.model.parameters())
        print(f"Diffusion params: {n_params / 1e6:.3f} M; device {device}; "
              f"{args.sampler_type}, {args.sample_steps} steps, CFG {args.cfg_scale}; "
              f"{len(conds)} x {args.n_sample_per_cond} prompts")

    paths, conditions = paths[rank::world_size], conditions[rank::world_size]
    for i in range(int(math.ceil(len(conditions) / batch_sample))):
        path_i = paths[i * batch_sample:(i + 1) * batch_sample]
        conds_i = conditions[i * batch_sample:(i + 1) * batch_sample]
        audio = generate_diffusion_cond(
            model, steps=args.sample_steps, cfg_scale=args.cfg_scale, conditioning=conds_i,
            sample_size=sample_size, sigma_min=0.3, sigma_max=500, sampler_type=args.sampler_type,
            seed=args.seed, device=device, verbose=args.verbose).cpu().numpy()
        for n, path in enumerate(path_i):
            clip = audio[n]
            if args.clip_length:
                clip = clip[:, :int(conds_i[n]["seconds_total"] * sample_rate)]
            out = Path(args.output_dir) / f"{path}.wav"
            out.parent.mkdir(parents=True, exist_ok=True)
            write_wav(str(out), sample_rate, clip)
    print(f"Rank-{rank}: finished.")


if __name__ == "__main__":
    main()
