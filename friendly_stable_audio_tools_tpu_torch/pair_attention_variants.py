"""Times design variants of the head-pair attention kernels against the
shipped ones on the card (the measurements behind the tile shape of
csrc/attention.cu and the notes of csrc/attention_bwd.cu).

    python -m friendly_stable_audio_tools_tpu_torch.pair_attention_variants [--out variants.json]

Each variant is the shipped sources (csrc/) with one substitution, built
apart into a library of its own:

* ``keys64``: 64 keys per forward pipeline stage instead of 128;
* ``consumers3``: three consumer warpgroups (192 q rows per block) in the
  forward instead of two;
* ``no_dq_reduce``: K6 without its dq reduce-add (its dq is then wrong:
  timing only).

K1, K5, K10 and K6 run at their main-path shapes (chip_smoke's) with each
library in turns (shipped, the variants, the variants again in reverse,
shipped): per call the CUDA-event time of the wrapper (its K10a launches
included, best of the two turns) and, from torch.profiler, the device time
of the attention kernel alone. Each output is held against the plain
version (the no_dq_reduce K6 excepted). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import tempfile
from pathlib import Path

from .ops.kernels import build

# variant -> (source file, text in it, replacement)
VARIANTS = {
    "keys64": ("attention.cu", "constexpr int kN = 128;", "constexpr int kN = 64;"),
    "consumers3": ("attention.cu", "constexpr int kConsumers = 2;", "constexpr int kConsumers = 3;"),
    "no_dq_reduce": ("attention_bwd.cu",
                     "if (tid == 0) bulk_reduce_add_f32(dq_bh + (size_t)q0 * kD, buf, kAccTile);",
                     ""),
}
SOURCES = ("attention.cu", "attention_bwd.cu", "attention_rope.cu")
ENTRY_POINTS = ("fsat_pair_attention", "fsat_pair_attention_bwd", "fsat_rope_pair")
# (B, T, H, kv_len) of each kernel's main path
SHAPES = {"K1": (2, 1025, 24, None), "K5": (8, 1040, 24, 1025), "K10": (2, 6272, 24, 6145),
          "K6": (8, 1040, 24, 1025)}
# the kernel whose device time each case reports
KERNEL_NAMES = {"K1": "pair_attention_kernel", "K5": "pair_attention_kernel",
                "K10": "pair_attention_kernel", "K6": "pair_bwd_kernel"}


def build_variant(name: str, tmp: Path) -> ctypes.CDLL:
    """The shipped sources with VARIANTS[name]'s substitution ("shipped": none),
    compiled with build.NVCC_FLAGS into tmp/name/lib.so and bound."""
    src = tmp / name
    shutil.copytree(build.CSRC_DIR, src)
    if name != "shipped":
        file, old, new = VARIANTS[name]
        text = (src / file).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {file} exactly once")
        (src / file).write_text(text.replace(old, new))
    nvcc = build.find_nvcc()
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-I", str(src), "-c", "-o",
                               str(src / (f + ".o")), str(src / f)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for f in SOURCES]
    for f, proc in zip(SOURCES, procs):
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed on {f}:\n{out}")
    lib_path = src / "lib.so"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    *(str(src / (f + ".o")) for f in SOURCES)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for entry in ENTRY_POINTS:
        fn = getattr(lib, entry)
        fn.argtypes = build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return lib


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="", help="write the results as JSON here")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .ops.embeddings import rotary_freqs
    from .ops.kernels import attention

    if not torch.cuda.is_available():
        raise RuntimeError("pair_attention_variants needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    tmp = Path(tempfile.mkdtemp())
    names = ["shipped", *VARIANTS]
    libs = {name: build_variant(name, tmp) for name in names}

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for key, (b, t, h, kv) in SHAPES.items():
        qkv = torch.randn(b, t, 3 * h * 64, generator=g, device="cuda").to(torch.bfloat16)
        f = rotary_freqs(t, 32, device="cuda")
        go = torch.randn(b, t, h * 64, generator=g, device="cuda").to(torch.bfloat16)
        if kv is not None:
            go[:, kv:] = 0
        cases[key] = (qkv, f, h, kv, go)
    qkv6, f6, h6, kv6, go6 = cases["K6"]
    out6, lse6 = attention.fused_qkv_rope_attention_stats_plain(qkv6, f6, h6, kv6)
    calls = {
        "K1": lambda c: attention.fused_qkv_rope_attention(*c[:4]),
        "K5": lambda c: attention.fused_qkv_rope_attention_stats(*c[:4])[0],
        "K10": lambda c: attention.fused_qkv_rope_attention_long(*c[:4]),
        "K6": lambda c: attention.fused_qkv_rope_attention_backward(
            c[0], out6, lse6, c[4], c[1], c[2], c[3], dtype=torch.float32),
    }
    plains = {
        "K1": attention.fused_qkv_rope_attention_plain(*cases["K1"][:4]),
        "K5": attention.fused_qkv_rope_attention_stats_plain(*cases["K5"][:4])[0],
        "K10": attention.fused_qkv_rope_attention_long_plain(*cases["K10"][:4]),
        "K6": attention.fused_qkv_rope_attention_backward_plain(
            qkv6, out6, lse6, go6, f6, h6, kv6, dtype=torch.float32),
    }

    def timed_ms(fn, reps=10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def kernel_ms(fn, kernel, reps=5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum((getattr(e, "self_device_time_total", 0) or 0) for e in prof.key_averages()
                   if kernel in e.key) / 1e3 / reps

    results = {name: {} for name in names}
    for name in names + names[::-1]:
        build._lib = libs[name]
        for key, call in calls.items():
            c = cases[key]
            out = call(c)
            torch.cuda.synchronize()
            rel = ((out.float() - plains[key]).norm() / plains[key].norm()).item()
            r = results[name].setdefault(key, {"ms": [], "kernel_ms": [], "rel_l2": rel})
            r["ms"].append(timed_ms(lambda: call(c)))
            r["kernel_ms"].append(kernel_ms(lambda: call(c), KERNEL_NAMES[key]))
    build._lib = None
    summary = {"card": smi, "shapes": {k: list(v) for k, v in SHAPES.items()}, "variants": {}}
    for name in names:
        summary["variants"][name] = {key: {"ms": min(r["ms"]), "kernel_ms": min(r["kernel_ms"]),
                                           "rel_l2": r["rel_l2"]}
                                     for key, r in results[name].items()}
        print(f"{name:13s} " + "  ".join(
            f"{key} {r['ms']:.4f} ms (kernel {r['kernel_ms']:.4f}, rel-L2 {r['rel_l2']:.2e})"
            for key, r in summary["variants"][name].items()), flush=True)
    print(f"card: {smi}")
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=1))
    shutil.rmtree(tmp, ignore_errors=True)
    return summary


if __name__ == "__main__":
    main()
