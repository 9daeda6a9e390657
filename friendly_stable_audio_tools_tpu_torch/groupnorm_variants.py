"""Dance Diffusion's one-group GroupNorm on the card: torch's `group_norm`
against the port's `models/dance_diffusion.py:GroupNorm1`, and what each
makes of a whole U-Net forward.

    python -m friendly_stable_audio_tools_tpu_torch.groupnorm_variants

For the U-Net's shapes ([B, T, C] fp32: B4 x 65,536 x 128, B1 x 2,097,152
x 128, B1 x 131,072 x 512) it prints each norm's time (CUDA events, 5 runs
after a warm-up) and their largest difference; then one forward of
`dance_diffusion_base_44k.json` (random weights, seed 0) at 4 x 65,536 and
1 x 2,097,152 samples with each norm (torch's patched in for the second),
its wall, its device time under torch.profiler and the part of it in
torch's group_norm kernels (or in reductions and addcmul, GroupNorm1's
statistics and output). TF32 is off.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

CONFIG = (Path(__file__).resolve().parents[1] / "friendly_stable_audio_tools_tpu/configs/"
          "model_configs/dance_diffusion/dance_diffusion_base_44k.json")
SHAPES = [(4, 65536, 128), (1, 2097152, 128), (1, 131072, 512)]


def event_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def torch_group_norm(self, x):
    """torch's group_norm with one group on [B, T, C] (the layout's transpose
    as adp.GroupNorm takes it)."""
    import torch.nn.functional as F

    return F.group_norm(x.transpose(1, 2), 1, self.scale, self.bias, self.eps).transpose(1, 2)


def forward_profile(model, batch: int, samples: int) -> str:
    import torch

    x = torch.randn(batch, samples, 2, device="cuda")
    t = torch.full((batch,), 0.5, device="cuda")
    with torch.no_grad():
        model.model(x, t)
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            model.model(x, t)
            torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = list(prof.key_averages())  # CUDA activity only: the kernels
    total = sum(e.self_device_time_total for e in events) / 1e3
    norm = sum(e.self_device_time_total for e in events
               if "Moments" in e.key or "group_norm" in e.key.lower() or "reduce" in e.key.lower()
               or "addcmul" in e.key) / 1e3
    return (f"wall {wall * 1e3:.1f} ms (under the profiler), device {total:.1f} ms, "
            f"of it group_norm's kernels or the reductions and addcmul {norm:.1f} ms")


def main() -> None:
    import subprocess

    import torch

    from . import create_model_from_config
    from .models import dance_diffusion as dd

    if not torch.cuda.is_available():
        raise SystemExit("groupnorm_variants needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for b, t, c in SHAPES:
        norm = dd.GroupNorm1(c).cuda()
        with torch.no_grad():
            norm.scale.normal_()
            norm.bias.normal_()
            x = torch.randn(b, t, c, device="cuda") * 2 + 0.5
            diff = (norm(x) - torch_group_norm(norm, x)).abs().max().item()
            print(f"B{b} T{t} C{c}: torch group_norm {event_ms(lambda: torch_group_norm(norm, x)):.3f} "
                  f"ms, GroupNorm1 {event_ms(lambda: norm(x)):.3f} ms, max |difference| "
                  f"{diff:.3g}", flush=True)
    model = create_model_from_config(json.loads(CONFIG.read_text()), seed=0, device="cuda")
    for batch, samples in ((4, 65536), (1, 2097152)):
        print(f"U-Net forward B{batch} x {samples}, GroupNorm1: "
              f"{forward_profile(model, batch, samples)}", flush=True)
        original = dd.GroupNorm1.forward
        dd.GroupNorm1.forward = torch_group_norm
        try:
            print(f"U-Net forward B{batch} x {samples}, torch group_norm: "
                  f"{forward_profile(model, batch, samples)}", flush=True)
        finally:
            dd.GroupNorm1.forward = original


if __name__ == "__main__":
    main()
