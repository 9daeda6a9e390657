"""Where a generation step's device time goes: `torch.profiler` over a few
sampler-step backbone calls (one CFG-doubled forward each) of a model config.

    python -m friendly_stable_audio_tools_tpu_torch.profile_generation \
        --model-config friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio/stable_audio_2_0.json \
        --steps 3 [--dtype bf16|model] [--out profile.json]

The model is built from random weights (seed 0, de-zeroed) at the config's
`sample_size`, CFG 7, with the backbone in bf16 (bench.py's recipe, the
default; Stable Audio 1.0's U-Net then casts its input at entry and runs the
bf16 K7) or in the model's own fp32 as the generate CLI runs it (`--dtype
model`). TF32 is off.
Prints the wall time per step, the device kernel time per step by category
(the port's kernels by name, GEMMs, elementwise, copies and casts, ...),
the share of the wall the device is idle, and writes the same as JSON with
the ten largest kernels by name. Needs a CUDA device.
:func:`profile_backbone` does the same for a model already built (chip_smoke
[5] profiles the SAO bf16 step with it).
"""

from __future__ import annotations

import argparse
import json
import time

# (category, substrings of the kernel name); the first match wins
CATEGORIES = [
    ("K1/K5/K10 pair attention", ("pair_attention_kernel",)),
    ("K6 pair attention backward", ("pair_bwd_kernel", "dq_unrope_kernel")),
    ("K10a rope_pair", ("rope_pair_kernel",)),
    ("K7 flash_forward", ("flash_forward_kernel",)),
    ("K7 bf16 flash_forward", ("flash_forward_bf16_kernel",)),
    ("K13 glu_mlp", ("glu_gemm_kernel", "out_gemm_kernel", "glu_stream_kernel",
                     "tf32_split_kernel")),
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "winograd", "fft")),
    ("GEMMs (cuBLAS/CUTLASS)", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "splitK")),
    ("softmax", ("softmax",)),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("GroupNorm", ("group_norm", "GroupNorm")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "Copy", "cat_", "CatArray")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
]


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def profile_backbone(model, config, steps=3, cfg_scale=7.0):
    """`steps` backbone calls (one CFG-doubled sampler step each) of a built
    model at the config's `sample_size` under torch.profiler: the wall and
    device kernel time per step, the idle share, the time by category and
    the ten largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prompt = {"prompt": "A grand orchestral arrangement", "seconds_start": 0,
              "seconds_total": config["sample_size"] / config["sample_rate"]}
    frames = config["sample_size"] // model.pretransform.downsampling_ratio
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(1, frames, model.io_channels, generator=g, device="cuda")
    t = torch.full((1,), 0.6, device="cuda")
    with torch.no_grad():
        cond = model.get_conditioning_inputs(model.conditioner([prompt], device="cuda"))

        def step():
            return model.model(x, t, cfg_scale=cfg_scale, **cond)

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - start) * 1e3 / steps

    by_name = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3 / steps
    by_cat = {}
    for name, ms in by_name.items():
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms
    device = sum(by_cat.values())
    return {
        "frames": frames, "cfg_batch": 2, "card": torch.cuda.get_device_name(0),
        "wall_ms_per_step": wall, "device_ms_per_step": device,
        "idle_share": max(0.0, 1.0 - device / wall),
        "by_category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10]),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-config", required=True)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--cfg-scale", type=float, default=7.0)
    p.add_argument("--dtype", choices=("bf16", "model"), default="bf16",
                   help="the backbone in bf16 (bench.py's recipe) or in the model's own dtype")
    p.add_argument("--out", default="", help="write the breakdown as JSON here")
    args = p.parse_args(argv)

    import torch

    from .models.factory import create_model_from_config
    from .utils.common import dezero_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(args.model_config) as f:
        config = json.load(f)
    model = create_model_from_config(config, seed=0, device="cuda")
    dezero_(model, torch.Generator(device="cuda").manual_seed(1))
    if args.dtype == "bf16":
        model.model.to(torch.bfloat16)
    result = {"model_config": args.model_config, "dtype": args.dtype,
              **profile_backbone(model, config, args.steps, args.cfg_scale)}
    device = result["device_ms_per_step"]
    print(f"{args.model_config}: {result['frames']} latent frames, CFG batch 2, {args.steps} "
          f"steps on {result['card']}")
    print(f"wall {result['wall_ms_per_step']:.3f} ms/step, device kernels {device:.3f} ms/step, "
          f"idle {100 * result['idle_share']:.1f}%")
    for cat, ms in result["by_category_ms"].items():
        print(f"  {cat:32s} {ms:10.3f} ms  {100 * ms / device:5.1f}%")
    for name, ms in result["top_kernels_ms"].items():
        print(f"  top: {ms:10.3f} ms  {name[:110]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
