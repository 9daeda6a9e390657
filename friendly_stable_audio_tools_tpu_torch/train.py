"""Training CLI of the torch port (counterpart of the repository's train.py).

    python -m friendly_stable_audio_tools_tpu_torch.train \
        --model-config friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio/stable_audio_open_1_0.json \
        --dataset-config dataset.json --batch-size 8 --max-steps 1000 --save-dir runs/

Flags and their defaults come from `defaults.ini` (in the working directory,
else the repository's). Trains a `diffusion_cond` model on one device: a
CUDA card by default, raising when there is none; `--device cpu` trains on
the CPU through the kernels' plain versions. On the card the DiT trains in
fp32 with its self-attention routed as the JAX package routes it
(ops/kernels/attention.py:training_route): up to 1168 tokens through the
pair kernels K5/K6, which cast to bf16 as the JAX pair path does; longer
sequences through K7 and K8 or K9 in fp32. Stable Audio 1.0's ADP U-Net
trains in fp32 with its self-attention at T >= 1024 through K7 (with its
LSE) and K8 (ops/attention.py). The frozen VAE encodes in fp32 through the
fp32 K2/K3 (the DAC encoder: K2 only; in bf16 only where the config sets
`model_half`). TF32 is off
for matrix products and convolutions, so plain fp32 layers compute in fp32.
Without `--pretrained-ckpt-path` the weights are random, drawn from
`--seed`. Checkpoints (`torch.save`) go to
`<save-dir>/<name>/<run id>/checkpoints/step_<n>/`; `--ckpt-path` resumes
from one. Multi-device training (`--num-chips` > 1, `--num-nodes` > 1,
`--strategy fsdp`) is not ported and raises. Metrics go to the console, or
to wandb when `WANDB_API_KEY` is set.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from pathlib import Path

REPO_DEFAULTS = Path(__file__).resolve().parents[1] / "defaults.ini"


def _load_into(module, path: str, what: str) -> None:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    result = module.load_state_dict(sd, strict=False)
    if result.unexpected_keys:
        raise ValueError(f"{what} {path}: keys the model does not have: "
                         f"{result.unexpected_keys[:5]}")


def main(argv=None):
    from .utils.config_args import get_all_args

    defaults = "defaults.ini" if os.path.isfile("defaults.ini") else str(REPO_DEFAULTS)
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a CUDA device) or cpu")
    args = get_all_args(defaults, argv, parser)
    if args.num_nodes > 1 or args.num_chips > 1 or args.strategy == "fsdp":
        raise NotImplementedError("multi-device training is not in the torch port: "
                                  "run with --num-nodes 1 --num-chips 0|1 --strategy dp")
    for flag in ("remove_pretransform_weight_norm", "profile_dir"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not in the torch port")

    import numpy as np
    import torch

    from .data.dataset import create_dataloader_from_config
    from .models.factory import create_model_from_config
    from .training.factory import (
        create_demo_callback_from_config,
        create_training_wrapper_from_config,
    )
    from .training.logging import ExperimentLogger
    from .training.trainer import Trainer
    from .utils.common import resolve_device

    device = resolve_device(args.device, "--device cpu")
    # fp32 products and convolutions in fp32, as the JAX package computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seed = args.seed + int(os.environ.get("SLURM_PROCID", 0))
    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)

    with open(args.model_config) as f:
        model_config = json.load(f)
    with open(args.dataset_config) as f:
        dataset_config = json.load(f)

    train_dl = create_dataloader_from_config(
        dataset_config, batch_size=args.batch_size, num_workers=args.num_workers,
        sample_rate=model_config["sample_rate"], sample_size=model_config["sample_size"],
        audio_channels=model_config["audio_channels"], seed=seed)

    model = create_model_from_config(model_config, seed=seed, device=device)
    if args.pretrained_ckpt_path:
        print(f"->->-> Loading a pretrained checkpoint from {args.pretrained_ckpt_path}...")
        _load_into(model, args.pretrained_ckpt_path, "pretrained checkpoint")
    if args.pretransform_ckpt_path and model.pretransform is not None:
        print(f"->->-> Loading a pretransform checkpoint from {args.pretransform_ckpt_path}...")
        _load_into(model.pretransform.model, args.pretransform_ckpt_path, "pretransform checkpoint")

    training_wrapper = create_training_wrapper_from_config(model_config, model)
    logger = ExperimentLogger(project=args.name, config={"model_config": model_config,
                                                         "dataset_config": dataset_config,
                                                         **vars(args)},
                              use_wandb=bool(os.environ.get("WANDB_API_KEY")))
    save_dir = os.path.join(args.save_dir or ".", args.name, logger.run_id)
    os.makedirs(save_dir, exist_ok=True)
    ckpt_config = model_config["training"].get("checkpoint", {"every_n_train_steps": 10000})

    demo_callback = None
    try:
        demo_callback = create_demo_callback_from_config(model_config, demo_dl=train_dl)
    except NotImplementedError:
        pass

    trainer = Trainer(
        training_wrapper, train_dl, model_config=model_config, save_dir=save_dir,
        checkpoint_every=ckpt_config.get("every_n_train_steps", 10000),
        demo_callback=demo_callback, logger=logger, max_steps=args.max_steps or None,
        accum_batches=args.accum_batches,
        log_every=model_config["training"].get("logging", {}).get("log_every", 1),
        gradient_clip_val=args.gradient_clip_val)
    trainer.fit(ckpt_path=args.ckpt_path or None, seed=seed)
    return trainer


if __name__ == "__main__":
    main()
