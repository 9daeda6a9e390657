#!/usr/bin/env python3
"""Chip smoke test of the torch port (friendly_stable_audio_tools_tpu_torch)
on one NVIDIA GPU: Stable Audio Open 1.0 text-to-audio at full width.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from csrc/ (timed);
3. each kernel K1-K4 against its plain PyTorch version on the card in bf16,
   at every shape the main path gives it plus small ragged shapes, with
   max-abs and rel-L2 errors against a stated tolerance and both times;
4. one DiT forward (CFG batch-doubled) and one short VAE decode with the
   kernels and with the plain versions, same weights and inputs;
5. the main path: `create_model_from_config(stable_audio_open_1_0.json)`
   with random weights (seed 0, de-zeroed), DiT and VAE in bf16, then
   `generate_diffusion_cond` for one prompt, 100 dpmpp-3m-sde steps, CFG 7,
   2,097,152 stereo samples; output shape, finiteness and RMS are checked,
   and the kernels' launch counts show that the path ran through them.

Output: progress lines, then one JSON line of per-kernel results, the
nvidia-smi line, and as the last line `{"ok": true, "device": {...}}`.
Without a CUDA device the script exits with 2 and prints no result.
"""

import contextlib
import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SAO_CONFIG = REPO / "friendly_stable_audio_tools_tpu/configs/model_configs/txt2audio/stable_audio_open_1_0.json"
STEPS = 100
CFG_SCALE = 7.0
SAMPLE_SIZE = 2_097_152
PROMPT = {"prompt": "Amen break 174 BPM", "seconds_start": 0, "seconds_total": 47}

# tolerances of the kernel-vs-plain compares (bf16 in and out; both sides
# accumulate in fp32 and round the result once, in different orders):
#   rel-L2 of the difference, and max abs difference as a fraction of max|plain|
TOL = {
    # online (per 64-key tile) vs one-shot softmax: P is rounded to bf16
    # against different running maxima, ~2^-9 relative per probability
    "fused_qkv_rope_attention": (1e-2, 2.0 ** -5),
    # one bf16 rounding of the output: at most ~1 ulp (2^-7 relative) apart
    "snake_conv1d": (2e-3, 2.0 ** -6),
    "fused_residual_unit": (2e-3, 2.0 ** -6),
    "snake_conv_transpose1d": (2e-3, 2.0 ** -6),
}
# model compares: the bf16 DiT with the kernels against an fp32 copy (plain
# versions, same weights) may err at most DIT_ERR_RATIO times as much as the
# bf16 DiT with the plain versions does; random de-zeroed weights amplify
# bf16 rounding through 24 layers, so the bf16 error itself is the yardstick
DIT_ERR_RATIO = 1.5
DECODE_REL_TOL = 2e-2  # 15 residual units, 5 upsamples, 2 convs in bf16


def log(msg):
    print(msg, flush=True)


def smi_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def timed_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, kernel_fn, plain_fn, reps=3):
    """Runs both, checks the tolerance, returns (max_abs, rel_l2, kernel ms, plain ms)."""
    import torch

    out = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_fn()
    diff = out.float() - ref.float()
    max_abs = diff.abs().max().item()
    rel_l2 = (diff.norm() / ref.float().norm()).item()
    peak = ref.float().abs().max().item()
    rel_tol, abs_frac = TOL[name]
    ok = bool(torch.isfinite(out).all()) and rel_l2 <= rel_tol and max_abs <= abs_frac * peak
    ms, plain_ms = timed_ms(kernel_fn, reps), timed_ms(plain_fn, reps)
    return ok, max_abs, rel_l2, peak, ms, plain_ms


@contextlib.contextmanager
def plain_kernels():
    """Routes the model's kernel calls to the plain versions (for the
    kernel-vs-plain model compares of phase 4 only)."""
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention, conv1d

    names = [(attention, "fused_qkv_rope_attention"), (conv1d, "snake_conv1d"),
             (conv1d, "fused_residual_unit"), (conv1d, "snake_conv_transpose1d")]
    saved = [getattr(m, n) for m, n in names]
    for m, n in names:
        setattr(m, n, getattr(m, n + "_plain"))
    try:
        yield
    finally:
        for (m, n), fn in zip(names, saved):
            setattr(m, n, fn)


def kernel_phase(results):
    import torch

    from friendly_stable_audio_tools_tpu_torch.ops.embeddings import rotary_freqs
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention, conv1d

    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def snake_params(c):
        return rnd(c).abs() + 0.5, 1.0 / (rnd(c).abs() + 0.5)

    def run(name, label, main_path, kernel_fn, plain_fn):
        ok, max_abs, rel_l2, peak, ms, plain_ms = compare(name, kernel_fn, plain_fn)
        log(f"  {name} {label}: max_abs {max_abs:.4g} (max|plain| {peak:.4g}) rel_l2 {rel_l2:.3g} "
            f"tol {TOL[name]} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"{'main-path' if main_path else 'extra'} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain version")
        r = results[name]
        if main_path:
            r["max_abs_err"] = max(r["max_abs_err"], max_abs)
            r["ms"] += ms * r["weight"].get(label, 1)
            r["plain_ms"] += plain_ms * r["weight"].get(label, 1)

    # K1: the DiT's self-attention, B = 2 (CFG), 24 heads, T = 1024 + 1 prepended token
    for b, t, h, kv, main in [(2, 1025, 24, None, True), (1, 77, 2, None, False),
                              (4, 1040, 4, 1025, False), (2, 144, 2, 130, False)]:
        qkv = rnd(b, t, 3 * h * 64).to(bf)
        f = rotary_freqs(t, 32, device=dev)
        run("fused_qkv_rope_attention", f"B{b} T{t} H{h} kv_len {kv}", main,
            lambda: attention.fused_qkv_rope_attention(qkv, f, h, kv),
            lambda: attention.fused_qkv_rope_attention_plain(qkv, f, h, kv))

    # K2: decoder conv_in (64 -> 2048 at 1024 frames) and conv_out (snake, 128 -> 2, no bias)
    for b, t, cin, cout, d, sn, bias, main in [
            (1, 1024, 64, 2048, 1, False, True, True), (1, SAMPLE_SIZE, 128, 2, 1, True, False, True),
            (2, 301, 32, 48, 3, True, True, False)]:
        x = rnd(b, t, cin, scale=0.5).to(bf)
        w = rnd(7, cin, cout, scale=1 / math.sqrt(7 * cin))
        bb = rnd(cout, scale=0.1) if bias else None
        a, ib = snake_params(cin) if sn else (None, None)
        run("snake_conv1d", f"B{b} T{t} {cin}->{cout} d{d}", main,
            lambda: conv1d.snake_conv1d(x, w, bb, a, ib, dilation=d),
            lambda: conv1d.snake_conv1d_plain(x, w, bb, a, ib, dilation=d))

    # K3: the 15 residual units of the decode, then a small ragged one
    ru_shapes = [(1, t, c, d, True) for c, t in [(1024, 8192), (512, 65536), (256, 262144),
                                                  (128, 1048576), (128, 2097152)]
                 for d in (1, 3, 9)] + [(2, 333, 128, 9, False)]
    for b, t, c, d, main in ru_shapes:
        x = rnd(b, t, c, scale=0.5).to(bf)
        w1, w2 = rnd(7, c, c, scale=1 / math.sqrt(7 * c)), rnd(c, c, scale=1 / math.sqrt(c))
        b1, b2 = rnd(c, scale=0.1), rnd(c, scale=0.1)
        (a1, i1), (a2, i2) = snake_params(c), snake_params(c)
        run("fused_residual_unit", f"B{b} T{t} C{c} d{d}", main,
            lambda: conv1d.fused_residual_unit(x, w1, b1, a1, i1, w2, b2, a2, i2, dilation=d),
            lambda: conv1d.fused_residual_unit_plain(x, w1, b1, a1, i1, w2, b2, a2, i2, dilation=d))

    # K4: the 5 upsamples of the decode, then a small ragged one
    for b, t, cin, cout, s, main in [(1, 1024, 2048, 1024, 8, True), (1, 8192, 1024, 512, 8, True),
                                     (1, 65536, 512, 256, 4, True), (1, 262144, 256, 128, 4, True),
                                     (1, 1048576, 128, 128, 2, True), (2, 77, 128, 128, 4, False)]:
        x = rnd(b, t, cin, scale=0.5).to(bf)
        w = rnd(2 * s, cin, cout, scale=1 / math.sqrt(2 * cin))
        bb = rnd(cout, scale=0.1)
        a, ib = snake_params(cin)
        run("snake_conv_transpose1d", f"B{b} T{t} {cin}->{cout} s{s}", main,
            lambda: conv1d.snake_conv_transpose1d(x, w, bb, a, ib, stride=s),
            lambda: conv1d.snake_conv_transpose1d_plain(x, w, bb, a, ib, stride=s))


def rel_err(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from friendly_stable_audio_tools_tpu_torch import create_model_from_config
    from friendly_stable_audio_tools_tpu_torch.inference.generation import generate_diffusion_cond
    from friendly_stable_audio_tools_tpu_torch.ops.kernels import attention, build, conv1d
    from friendly_stable_audio_tools_tpu_torch.utils.common import dezero_

    smi = smi_line()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.library()
    log(f"[2] built {build.build().name} in {time.perf_counter() - t0:.1f} s")

    src = "friendly_stable_audio_tools_tpu_torch/csrc/"
    tpu = "friendly_stable_audio_tools_tpu/ops/pallas/"
    results = {
        "fused_qkv_rope_attention": dict(route="cuda", source=src + "attention.cu",
                                         replaces=tpu + "flash_attention.py:828"),
        "snake_conv1d": dict(route="cuda", source=src + "conv1d.cu", replaces=tpu + "conv1d.py:91"),
        "fused_residual_unit": dict(route="cuda", source=src + "conv1d.cu",
                                    replaces=tpu + "conv1d.py:507"),
        "snake_conv_transpose1d": dict(route="cuda", source=src + "conv1d.cu",
                                       replaces=tpu + "conv1d.py:262"),
    }
    for r in results.values():
        r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, weight={})
    # ms / plain_ms: one step's 24 attention calls; the decode's calls of each conv kernel
    results["fused_qkv_rope_attention"]["weight"] = {"B2 T1025 H24 kv_len None": 24}
    log("[3] kernels vs plain versions (bf16, tolerance = (rel-L2, max-abs / max|plain|))")
    kernel_phase(results)

    log("[4] model forwards with the kernels vs the plain versions")
    config = json.loads(SAO_CONFIG.read_text())
    model = create_model_from_config(config, seed=0, device="cuda")
    dezero_(model, torch.Generator(device="cuda").manual_seed(1))
    model.model.to(torch.bfloat16)
    model.pretransform.to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(2)
    cond = model.get_conditioning_inputs(model.conditioner([PROMPT], device="cuda"))
    x = torch.randn(1, SAMPLE_SIZE // 2048, 64, generator=g, device="cuda")
    t = torch.full((1,), 0.6, device="cuda")
    with torch.no_grad():
        dit_k = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
        with plain_kernels():
            dit_p = model.model(x, t, cfg_scale=CFG_SCALE, **cond)
            dit32 = copy.deepcopy(model.model).float()
            dit_ref = dit32(x, t, cfg_scale=CFG_SCALE, **cond)
            del dit32
        z = torch.randn(1, 64, 64, generator=g, device="cuda")
        dec_k = model.pretransform.decode_nwc(z)
        with plain_kernels():
            dec_p = model.pretransform.decode_nwc(z)
    err_k, err_p = rel_err(dit_k, dit_ref), rel_err(dit_p, dit_ref)
    dec_rel = rel_err(dec_k, dec_p)
    log(f"  DiT forward [1, 1024, 64] with CFG, rel-L2 against the fp32 DiT: kernels {err_k:.3g}, "
        f"plain bf16 {err_p:.3g} (bound: kernels <= {DIT_ERR_RATIO} x plain); "
        f"kernels vs plain {rel_err(dit_k, dit_p):.3g}")
    log(f"  VAE decode [1, 64, 64] -> {list(dec_k.shape)}: rel-L2 {dec_rel:.3g} (bound {DECODE_REL_TOL})")
    if not (err_k <= DIT_ERR_RATIO * err_p and dec_rel <= DECODE_REL_TOL):
        raise AssertionError("model forward with the kernels disagrees with the plain versions")

    log("[5] main path: SAO 1.0 text-to-audio, 100 dpmpp-3m-sde steps, CFG 7")
    phase = {"t5": 0.0, "decode": 0.0}

    def timed(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phase[key] += time.perf_counter() - start
            return out
        return wrapper

    model.conditioner.forward = timed(model.conditioner.forward, "t5")
    model.pretransform.decode_nwc = timed(model.pretransform.decode_nwc, "decode")
    attention.launches = 0
    conv1d.snake_conv1d_launches = 0
    conv1d.fused_residual_unit_launches = 0
    conv1d.snake_conv_transpose1d_launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    audio = generate_diffusion_cond(model, steps=STEPS, cfg_scale=CFG_SCALE, conditioning=[PROMPT],
                                    sample_size=SAMPLE_SIZE, sampler_type="dpmpp-3m-sde",
                                    sigma_min=0.3, sigma_max=500, seed=42)
    torch.cuda.synchronize()
    total = time.perf_counter() - start
    launches = {"fused_qkv_rope_attention": attention.launches,
                "snake_conv1d": conv1d.snake_conv1d_launches,
                "fused_residual_unit": conv1d.fused_residual_unit_launches,
                "snake_conv_transpose1d": conv1d.snake_conv_transpose1d_launches}
    rms = audio.float().square().mean().sqrt().item()
    seconds = SAMPLE_SIZE / config["sample_rate"]
    denoise = total - phase["t5"] - phase["decode"]
    log(f"  audio {list(audio.shape)} finite {bool(torch.isfinite(audio).all())} rms {rms:.4g}")
    log(f"  wall: T5 {phase['t5']:.4f} s, denoise {denoise:.4f} s ({denoise / STEPS * 1e3:.3f} ms/step), "
        f"decode {phase['decode']:.4f} s, total {total:.4f} s = {seconds / total:.3f} s-audio/s")
    log(f"  launches {launches}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    expected = {"fused_qkv_rope_attention": 24 * STEPS, "fused_residual_unit": 15,
                "snake_conv_transpose1d": 5}
    if tuple(audio.shape) != (1, 2, SAMPLE_SIZE) or not torch.isfinite(audio).all() or rms <= 0:
        raise AssertionError("generation output is not finite [1, 2, 2097152] audio")
    if any(launches[k] != n for k, n in expected.items()) or launches["snake_conv1d"] < 2:
        raise AssertionError(f"launch counts {launches} do not show the main path's kernels")

    line = {"kernels": [dict(name=name, route=r["route"], source=r["source"],
                             replaces=r["replaces"], launches=launches[name],
                             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"])
                        for name, r in results.items()]}
    print(json.dumps(line))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
