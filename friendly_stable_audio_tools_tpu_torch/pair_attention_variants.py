"""Times design variants of the attention kernels on Hopper against the
shipped ones on the card (the measurements behind the tile shapes of
csrc/attention.cu and csrc/flash_attention_bf16.cu and the notes of
csrc/attention_bwd.cu).

    python -m friendly_stable_audio_tools_tpu_torch.pair_attention_variants \
        [--out variants.json] [--parent CHECKOUT] [--check]

Each variant is the shipped sources (csrc/) with one change, built apart
into a library of its own:

* ``keys64``: 64 keys per forward pipeline stage instead of 128;
* ``consumers3``: three consumer warpgroups (192 q rows per block) in the
  forward instead of two;
* ``no_dq_reduce``: K6 without its dq reduce-add (its dq is then wrong:
  timing only);
* ``bf16_keys64``, ``bf16_stages2``, ``bf16_stages4``: the bf16 K7 with 64
  keys per stage, or 2 or 4 stages instead of 3;
* ``bf16_turns_off``: the bf16 K7's consumer warpgroups starting their
  products freely instead of in turns.

``--parent CHECKOUT`` adds the kernels built from another checkout's csrc/
(e.g. the parent commit unpacked by ``git archive`` into a directory
.gitignore lists), timed at every case in the same turns.

The shipped build prints ``-Xptxas -v`` for attention.cu and
flash_attention_bf16.cu (registers, shared memory, spills). K1, K5, K10 and
K6 run at their main-path shapes (chip_smoke's), and the bf16 K7 at the
ADP U-Net's (BH 32: T 4096 and 2048 at D 64, T 1024 at D 80) and SA 2.0's
DiT past 8192 tokens (BH 48, T 8576, kv_len 8449), each library on the
cases of the source it changes, in turns (shipped, the variants, the
variants again in reverse, shipped): per call the CUDA-event time of the
wrapper (K1/K5/K6's K10a launches included, best of the two turns) and, from
torch.profiler, the device time of the kernel alone; beside the bf16 K7,
SDPA's time on the same heads (K/V cut to kv_len). Each output is held
against the plain version (the no_dq_reduce K6 excepted); ``--check`` stops
after one such pass. Needs a CUDA device and nvcc.
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

# variant -> (source file, [(text in it, replacement), ...])
BF16_SOURCE = "flash_attention_bf16.cu"
VARIANTS = {
    "keys64": ("attention.cu", [("constexpr int kN = 128;", "constexpr int kN = 64;")]),
    "consumers3": ("attention.cu", [("constexpr int kConsumers = 2;",
                                     "constexpr int kConsumers = 3;")]),
    "no_dq_reduce": ("attention_bwd.cu", [
        ("if (tid == 0) bulk_reduce_add_f32(dq_bh + (size_t)q0 * kD, buf, kAccTile);", "")]),
    "bf16_keys64": (BF16_SOURCE, [("constexpr int kN = 128;", "constexpr int kN = 64;")]),
    "bf16_stages2": (BF16_SOURCE, [("constexpr int kStages = 3;", "constexpr int kStages = 2;")]),
    "bf16_stages4": (BF16_SOURCE, [("constexpr int kStages = 3;", "constexpr int kStages = 4;")]),
    "bf16_turns_off": (BF16_SOURCE, [("constexpr bool kTurns = true;",
                                      "constexpr bool kTurns = false;")]),
}
SOURCES = ("attention.cu", "attention_bwd.cu", "attention_rope.cu", BF16_SOURCE)
ENTRY_POINTS = {"attention.cu": "fsat_pair_attention",
                "attention_bwd.cu": "fsat_pair_attention_bwd",
                "attention_rope.cu": "fsat_rope_pair", BF16_SOURCE: "fsat_flash_forward_bf16"}
PTXAS_REPORT = ("attention.cu", BF16_SOURCE)  # printed with -Xptxas -v for the shipped build
# (B, T, H, kv_len) of each head-pair kernel's main path
PAIR_SHAPES = {"K1": (2, 1025, 24, None), "K5": (8, 1040, 24, 1025), "K10": (2, 6272, 24, 6145),
               "K6": (8, 1040, 24, 1025)}
# (BH, T, D, kv_len) of the bf16 K7's: the ADP U-Net's levels, SA 2.0's DiT past 8192 tokens
BF16_SHAPES = {"K7 BH32 T4096 D64": (32, 4096, 64, None), "K7 BH32 T2048 D64": (32, 2048, 64, None),
               "K7 BH32 T1024 D80": (32, 1024, 80, None),
               "K7 BH48 T8576 kv8449 D64": (48, 8576, 64, 8449)}
# the kernel whose device time each case reports (a substring of its name)
KERNEL_NAMES = {"K1": "pair_attention_kernel", "K5": "pair_attention_kernel",
                "K10": "pair_attention_kernel", "K6": "pair_bwd_kernel",
                **{key: "bf16_kernel" for key in BF16_SHAPES}}
# the source each case's kernel is built from
CASE_SOURCES = {"K1": "attention.cu", "K5": "attention.cu", "K10": "attention.cu",
                "K6": "attention_bwd.cu", **{key: BF16_SOURCE for key in BF16_SHAPES}}


def build_variant(name: str, tmp: Path, csrc: Path = build.CSRC_DIR,
                  sources=SOURCES) -> ctypes.CDLL:
    """`sources` of `csrc` with VARIANTS[name]'s substitutions (none for
    "shipped" or "parent"), compiled with build.NVCC_FLAGS into
    tmp/name/lib.so and bound; the shipped build prints -Xptxas -v."""
    src = tmp / name
    shutil.copytree(csrc, src)
    if name in VARIANTS:
        file, edits = VARIANTS[name]
        text = (src / file).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in {file} exactly once")
            text = text.replace(old, new)
        (src / file).write_text(text)
    nvcc = build.find_nvcc()
    report = name == "shipped"
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS,
                               *(["-Xptxas", "-v"] if report and f in PTXAS_REPORT else []),
                               "-I", str(src), "-c", "-o", str(src / (f + ".o")), str(src / f)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for f in sources]
    for f, proc in zip(sources, procs):
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed on {f}:\n{out}")
        if report and f in PTXAS_REPORT:
            print(f"ptxas, {f}:\n{out}", flush=True)
    lib_path = src / "lib.so"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    *(str(src / (f + ".o")) for f in sources)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for f in sources:
        fn = getattr(lib, ENTRY_POINTS[f])
        fn.argtypes = build.SIGNATURES[ENTRY_POINTS[f]]
        fn.restype = ctypes.c_int
    return lib


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="", help="write the results as JSON here")
    p.add_argument("--parent", default="", metavar="CHECKOUT",
                   help="also time the kernels built from this checkout's csrc/")
    p.add_argument("--check", action="store_true", help="stop after one correctness pass")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .ops.embeddings import rotary_freqs
    from .ops.kernels import attention
    from .ops.kernels import flash_attention as flash

    if not torch.cuda.is_available():
        raise RuntimeError("pair_attention_variants needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    tmp = Path(tempfile.mkdtemp())
    names = ["shipped", *([] if args.check else VARIANTS)]
    libs = {name: build_variant(name, tmp) for name in names}
    if args.parent:
        names.append("parent")
        libs["parent"] = build_variant(
            "parent", tmp, Path(args.parent) / build.CSRC_DIR.relative_to(build.PACKAGE_DIR.parent))
    # the cases each library runs: the shipped and the parent's all, a
    # variant those of the source it changes
    runs = {name: [key for key, f in CASE_SOURCES.items()
                   if name in ("shipped", "parent") or f == VARIANTS[name][0]]
            for name in names}

    g = torch.Generator(device="cuda").manual_seed(0)
    cases, calls, plains, sdpa = {}, {}, {}, {}
    for key, (b, t, h, kv) in PAIR_SHAPES.items():
        qkv = torch.randn(b, t, 3 * h * 64, generator=g, device="cuda").to(torch.bfloat16)
        f = rotary_freqs(t, 32, device="cuda")
        go = torch.randn(b, t, h * 64, generator=g, device="cuda").to(torch.bfloat16)
        if kv is not None:
            go[:, kv:] = 0
        cases[key] = (qkv, f, h, kv, go)
    qkv6, f6, h6, kv6, go6 = cases["K6"]
    out6, lse6 = attention.fused_qkv_rope_attention_stats_plain(qkv6, f6, h6, kv6)
    calls.update({
        "K1": lambda c: attention.fused_qkv_rope_attention(*c[:4]),
        "K5": lambda c: attention.fused_qkv_rope_attention_stats(*c[:4])[0],
        "K10": lambda c: attention.fused_qkv_rope_attention_long(*c[:4]),
        "K6": lambda c: attention.fused_qkv_rope_attention_backward(
            c[0], out6, lse6, c[4], c[1], c[2], c[3], dtype=torch.float32),
    })
    plains.update({
        "K1": attention.fused_qkv_rope_attention_plain(*cases["K1"][:4]),
        "K5": attention.fused_qkv_rope_attention_stats_plain(*cases["K5"][:4])[0],
        "K10": attention.fused_qkv_rope_attention_long_plain(*cases["K10"][:4]),
        "K6": attention.fused_qkv_rope_attention_backward_plain(
            qkv6, out6, lse6, go6, f6, h6, kv6, dtype=torch.float32),
    })
    for key, (bh, t, d, kv) in BF16_SHAPES.items():
        q, k, v = (torch.randn(bh, t, d, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        cases[key] = (q, k, v, kv)
        calls[key] = lambda c: flash.flash_forward(*c, save_stats=False)[0]
        plains[key] = flash.flash_forward_plain(q, k, v, kv, save_stats=False)[0].float()
        valid = kv or t
        kk, vv = k[:, :valid].contiguous(), v[:, :valid].contiguous()
        sdpa[key] = (q[None], kk[None], vv[None])

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
    for name in names if args.check else names + names[::-1]:
        build._lib = libs[name]
        for key in runs[name]:
            c, call = cases[key], calls[key]
            out = call(c)
            torch.cuda.synchronize()
            rel = ((out.float() - plains[key]).norm() / plains[key].norm()).item()
            r = results[name].setdefault(key, {"ms": [], "kernel_ms": [], "rel_l2": rel})
            if not args.check:
                r["ms"].append(timed_ms(lambda: call(c)))
                r["kernel_ms"].append(kernel_ms(lambda: call(c), KERNEL_NAMES[key]))
    build._lib = None
    shapes = {**PAIR_SHAPES, **BF16_SHAPES}
    summary = {"card": smi, "shapes": {k: list(v) for k, v in shapes.items()}, "variants": {},
               "sdpa_ms": {}}
    if not args.check:
        for key, qkv in sdpa.items():
            summary["sdpa_ms"][key] = min(
                timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*qkv))
                for _ in range(2))
    for name in names:
        summary["variants"][name] = {
            key: {"ms": min(r["ms"], default=None), "kernel_ms": min(r["kernel_ms"], default=None),
                  "rel_l2": r["rel_l2"]}
            for key, r in results[name].items()}
        timed = lambda r: "" if r["ms"] is None else (  # noqa: E731
            f" {r['ms']:.4f} ms (kernel {r['kernel_ms']:.4f})")
        print(f"{name:13s} " + "  ".join(f"{key} rel-L2 {r['rel_l2']:.2e}{timed(r)}"
                                         for key, r in summary["variants"][name].items()),
              flush=True)
    for key, ms in summary["sdpa_ms"].items():
        print(f"SDPA          {key} {ms:.4f} ms", flush=True)
    print(f"card: {smi}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    shutil.rmtree(tmp, ignore_errors=True)
    worst = max(r["rel_l2"] for name in names for key, r in summary["variants"][name].items()
                if not (name == "no_dq_reduce" and key == "K6"))
    if worst > 1e-2:
        raise AssertionError(f"a kernel disagrees with its plain version: rel-L2 {worst:.3g}")
    return summary


if __name__ == "__main__":
    main()
