"""Measurements behind the wgmma convolution kernel (csrc/conv_wgmma.cu: K2's
wide route and K4) on the card.

    python -m friendly_stable_audio_tools_tpu_torch.conv_variants [--out conv.json] [--check]
    python -m friendly_stable_audio_tools_tpu_torch.conv_variants --paths CHECKOUT [CHECKOUT ...]

1. ``ptxas``: registers, shared memory and spills of every kernel in
   conv_wgmma.cu and residual_unit.cu (K3) (nvcc -Xptxas -v with
   build.NVCC_FLAGS; the mainloops are csrc/taps_wgmma.cuh);
2. ``check``: the wide kernel in bf16 and fp32, K2 and K4, against the
   plain versions at ragged and at DAC/Oobleck widths (rel-L2 within 2e-3
   in bf16, 1e-5 in fp32); with --check the script stops here;
3. ``tile_n``: each Cout tile width that divides Cout, at the DAC decode's
   K2 and K4 shapes (the shipped width is conv1d.py:conv_tile_n's);
4. ``stages``: the shipped library (at most 4 pipeline stages,
   kMaxStages) against one built with at most 6 and one with at most 3, at
   the same shapes, in turns;
5. ``flush``: the fp32 kernel's error against an fp64 reference at the
   longest reductions (the DAC encode's 1024 -> 1024 k7 and 2048 -> 2048
   k3) for tensor-core partial sums of 1, 2, 4, 8 stages and of the whole
   reduction, beside the plain fp32 version (TF32 off) and cuDNN in TF32
   (1xTF32); each interval timed in turns (1, 2, ..., whole, whole, ..., 1),
   the best of its two turns, with the shipped library and with
   ``scale_d_zero`` (the partial sum started by a scale-d = 0 wgmma after each
   flush instead of zeroed by the CUDA cores);
6. ``k3``: K3 (csrc/residual_unit.cu) at SA 2.0's decode shapes (C 1024,
   512, 256, 128, dilation 3) in bf16 and fp32, through its C entry with
   its weights prepared once: the shipped route and plan beside, in turns,
   the other route wherever both run (bf16 C <= 512), the split route's
   conv snaking each tap's A tile (``ru_split_tap_snake``), smaller rings
   and two blocks per SM at bf16 C 128 (``ru_2cta``), each with its rel-L2
   to the shipped kernel's output, and, timing only, the fused route
   without its weight loads past the first ring (``ru_no_w_loads``: the
   most a multicast of the weight tiles could save); each with its share
   of the bound;
7. ``profile``: torch.profiler over calls of the public wrappers at
   main-path shapes: the device time of the conv kernel, of the weights'
   K-major pass and of everything else per call, and the conv kernel's
   share of its bound; the Oobleck upsamples (which fuse the snake) also
   without the snake, to show what the snake costs.

Times are CUDA-event means over repeated calls of the kernel's launch
alone (its K-major weights prepared once, outside the timing). Needs a CUDA
device and nvcc.

``--thin [CHECKOUT]`` instead runs the thin route's sections (csrc/conv1d.cu):

1. ``ptxas`` of conv1d.cu;
2. ``check``: the thin route through the public wrapper at ragged and odd
   shapes of its three kernels (conv1d.thin_design), with and without the
   snake, bf16 and fp32, against the plain versions (bf16 rel-L2 2e-3 and
   max abs 2^-6 of max|plain|, fp32 rel-L2 1e-5), one launch of the thin
   route's count each; with --check the script stops here;
3. ``thin``: every main-path thin shape (THIN_CASES: the Oobleck, DAC and
   SEANet conv_in and conv_out at chip_smoke's lengths) through the C
   entry, against the plain version, timed in turns with the kernel built
   from CHECKOUT's csrc/conv1d.cu (e.g. the parent commit unpacked by ``git
   archive``; its entry takes no design) where given: CHECKOUT, shipped,
   shipped, CHECKOUT, the best of each's two turns; beside them cuDNN's
   conv1d on the snaked input (TF32 off) and the bound (bytes: x read
   once, y written once, at 3.35 TB/s; or the products at the dtype's
   rate).

``--paths`` instead runs chip_smoke.py's convolution phases ([3], [3c],
[3f], [3h], [3i]'s SEANet decode, [3k]) in each checkout given (the root of
a checkout of this repo, e.g. the parent commit unpacked by ``git
archive``), each in its own process, in turns (A, B, ..., B, A), and prints
each run's per-path K2/K4 totals and K3's: a change to the convolution
kernels held against its parent on one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .ops.kernels import build

# variant library -> [(text in conv_wgmma.cu or taps_wgmma.cuh, replacement), ...]
VARIANTS = {
    "stages6": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 6;")],
    "stages3": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 3;")],
    # the fp32 partial sum started by a scale-d = 0 wgmma after each flush,
    # where the shipped kernel zeroes it on the CUDA cores
    "scale_d_zero": [("a_lo[kk], kmajor_desc(hi_addr + off), 1);",
                      "a_lo[kk], kmajor_desc(hi_addr + off), (it % p.flush) || kk);"),
                     ("            acc[c][i] += part[c][i];\n            part[c][i] = 0.f;\n"
                      "          }\n      }\n    }\n  }\n  if constexpr (kEpi == kEpiRuH)",
                      "            acc[c][i] += part[c][i];\n"
                      "          }\n      }\n    }\n  }\n  if constexpr (kEpi == kEpiRuH)")],
}
# K3 variant libraries (csrc/residual_unit.cu substituted), timed beside the
# shipped one in k3_phase; none ships as a knob
RU_VARIANTS = {
    # two blocks per SM on the fused route: launch bounds (288, 2), at most
    # 112 registers a thread; run with rings cut to fit two blocks' shared
    # memory (RU_2CTA_PLAN)
    "ru_2cta": [("__global__ void __launch_bounds__(kThreads, 1)\nru_fused_kernel(",
                 "__global__ void __launch_bounds__(kThreads, 2)\nru_fused_kernel(")],
    # the split route's conv snaking each tap's A tile (K2's way), not one
    # snake pass over x before it
    "ru_split_tap_snake": [("constexpr bool kRuSplitPreSnake = true;",
                            "constexpr bool kRuSplitPreSnake = false;")],
    # timing only (its results are wrong): the fused route loads no weight
    # tile past the ring's first fill, so no weight reads from L2 at all;
    # a cluster multicast of each tile to two blocks would save at most
    # half of what this saves
    "ru_no_w_loads": [("        mbar_expect_tx(&w_full[s], kRuWStage);\n",
                       "        if (wi >= p.w_stages) {\n          mbar_arrive(&w_full[s]);\n"
                       "          ++wi;\n          return;\n        }\n"
                       "        mbar_expect_tx(&w_full[s], kRuWStage);\n")],
}
RU_2CTA_PLAN = dict(x_slots=2, w_stages=2)  # 113,728 bytes at C 128: two fit an SM's 228 KB
# K3 at SA 2.0's decode shapes (C, T), dilation 3, B 1
RU_SHAPES = [(1024, 49152), (512, 393216), (256, 1572864), (128, 6291456)]
STAGE_VARIANTS = ("stages6", "stages3")
FLUSH_VARIANTS = ("scale_d_zero",)
# the DAC decode of 4096 latent frames: (T, Cin, Cout, k, dilation) of K2,
# (T, Cin, Cout, stride) of K4
DAC_K2 = [(4096, 64, 1536, 7, 1), (32768, 768, 768, 7, 1), (32768, 768, 768, 7, 9),
          (32768, 768, 768, 1, 1), (262144, 384, 384, 7, 1), (1048576, 192, 192, 7, 1),
          (4194304, 96, 96, 7, 1)]
DAC_K4 = [(4096, 1536, 768, 8), (32768, 768, 384, 8), (262144, 384, 192, 4),
          (1048576, 192, 96, 4)]
# the DAC encode's longest reductions (T, C, k)
FLUSH_CASES = [(8192, 1024, 7), (8192, 2048, 3)]
# K2's thin route at its main-path shapes (chip_smoke [3], [3c], [3f], [3h],
# [3i], [3k]): (label, dtype, B, T, Cin, Cout, k, snake, bias)
THIN_CASES = [
    ("Oobleck conv_in SA 2.0", "fp32", 1, 12582912, 2, 128, 7, False, True),
    ("Oobleck conv_in SA 2.0", "bf16", 1, 12582912, 2, 128, 7, False, True),
    ("Oobleck conv_in SAO", "fp32", 1, 2097152, 2, 128, 7, False, True),
    ("Oobleck conv_in SAO", "bf16", 1, 2097152, 2, 128, 7, False, True),
    ("Oobleck conv_out SA 2.0", "bf16", 1, 12582912, 128, 2, 7, True, False),
    ("Oobleck conv_out SA 2.0", "fp32", 1, 12582912, 128, 2, 7, True, False),
    ("Oobleck conv_out SAO", "bf16", 1, 2097152, 128, 2, 7, True, False),
    ("Oobleck conv_out SAO", "fp32", 1, 2097152, 128, 2, 7, True, False),
    ("DAC conv_in", "fp32", 1, 4194304, 2, 128, 7, False, True),
    ("DAC conv_out", "bf16", 1, 4194304, 96, 2, 7, False, True),
    ("DAC conv_out", "fp32", 1, 4194304, 96, 2, 7, False, True),
    ("SEANet conv_in", "fp32", 8, 960000, 1, 64, 7, False, True),
    ("SEANet conv_out", "fp32", 1, 959992, 64, 1, 7, False, True),
]
# ragged and odd thin shapes of the three kernels: (B, T, Cin, Cout, k, dilation)
THIN_CHECKS = [(2, 333, 2, 128, 7, 1), (2, 77, 1, 64, 3, 1), (2, 333, 128, 2, 7, 1),
               (2, 77, 96, 2, 3, 1), (1, 300, 64, 1, 7, 1), (2, 333, 3, 48, 7, 3),
               (2, 130, 64, 48, 7, 1), (2, 300, 4, 4, 7, 9), (1, 211, 16, 3, 7, 1),
               (1, 211, 32, 4, 7, 2), (2, 500, 300, 1, 5, 1), (1, 129, 2048, 2, 3, 1),
               (1, 400, 2, 600, 7, 1), (2, 333, 1, 40, 5, 3), (1, 77, 2, 8, 7, 2),
               (1, 600, 1, 120, 15, 1)]
# --paths: chip_smoke.py's convolution phases, run from a checkout's root
PATHS_CODE = '''
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from friendly_stable_audio_tools_tpu_torch.ops.kernels import build
build.library()
r = cs.new_results()
cfg, sa2, sa1, lm = (json.loads(c.read_text())
                     for c in (cs.SAO_CONFIG, cs.SA2_CONFIG, cs.SA1_CONFIG, cs.LM_CONFIG))
cs.decode_conv_phase(r, torch.bfloat16, {"sa2": "ms", "sao": "sao_decode_ms"})
cs.encoder_conv_phase(r, cfg, "encode_ms")
cs.encoder_conv_phase(r, sa2, "sa2_encode_ms")
cs.decode_conv_phase(r, torch.float32, {"sa2": "sa2_decode_ms", "sao": "sao_decode_ms", "sao_ru": "ms"})
cs.encoder_conv_phase(r, cfg, "encode_ms", torch.float32)
cs.encoder_conv_phase(r, sa2, "sa2_encode_ms", torch.float32)
cs.dac_conv_phase(r)
cs.dac_encode_conv_phase(r, sa1)
cs.seanet_conv_phase(r, lm)
cs.seanet_decode_conv_phase(r, lm)
cs.dac_conv_phase(r, torch.bfloat16, "sa1_decode_ms")
for name in ("fused_residual_unit", "fused_residual_unit_f32"):
    for field in ("ms", "sao_decode_ms", "sa2_decode_ms", "encode_ms", "sa2_encode_ms"):
        if field in r[name]:
            print(f"  {name} {field}: {r[name][field]:.4f} ms per path (plain "
                  f"{r[name]['plain_' + field]:.4f} ms, bound {r[name]['bound_' + field]:.4f} ms)")
'''


def paths(roots, out_path=None) -> None:
    """chip_smoke.py's convolution phases in each checkout of `roots`, in
    turns (roots, then reversed); prints and keeps each run's per-path
    totals (chip_smoke's ' ms per ' lines)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    runs = []
    for root in list(roots) + list(roots)[::-1]:
        proc = subprocess.run([sys.executable, "-c", PATHS_CODE], cwd=root, capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"conv_variants --paths in {root}:\n{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-4000:]}")
        totals = [line.strip() for line in proc.stdout.splitlines() if " ms per " in line]
        runs.append({"root": str(root), "totals": totals})
        print(f"{root} ({smi}):", *totals, sep="\n  ", flush=True)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps({"card": smi, "runs": runs}, indent=1))


def start_ptxas_report(nvcc: str, tmp: str, source: str = "conv_wgmma.cu") -> subprocess.Popen:
    """Starts nvcc -Xptxas -v on `source` (each kernel's registers, shared
    memory and spills on its stderr), beside the library's build."""
    return subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC_DIR),
                             "-c", "-o", str(Path(tmp) / (source + ".o")),
                             str(build.CSRC_DIR / source)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def substitute(src: Path, files, edits, name: str) -> None:
    """Applies each (old, new) of `edits` to the one file of `files` under
    src that holds `old`, which must occur exactly once in all of them."""
    texts = {f: (src / f).read_text() for f in files}
    for old, new in edits:
        hits = [f for f, t in texts.items() if old in t]
        if len(hits) != 1 or texts[hits[0]].count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not found exactly once in {files}")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    for f, t in texts.items():
        (src / f).write_text(t)


def build_variant(name: str, tmp: Path, nvcc: str) -> ctypes.CDLL:
    """conv_wgmma.cu and its mainloop (taps_wgmma.cuh) with VARIANTS[name]'s
    substitutions, compiled alone into tmp/name; for a K3 variant
    (RU_VARIANTS) residual_unit.cu with its substitutions, and conv_wgmma.cu
    beside it."""
    src = tmp / name
    shutil.copytree(build.CSRC_DIR, src)
    ru = name in RU_VARIANTS
    files = ("residual_unit.cu",) if ru else ("conv_wgmma.cu", "taps_wgmma.cuh")
    substitute(src, files, (RU_VARIANTS if ru else VARIANTS)[name], name)
    cus = [str(src / "conv_wgmma.cu")] + ([str(src / "residual_unit.cu")] if ru else [])
    lib = src / "lib.so"
    proc = subprocess.run([nvcc, *build.NVCC_FLAGS, *(["-Xptxas", "-v"] if ru else []), "-shared",
                           "-I", str(src), "-o", str(lib), *cus],
                          check=True, capture_output=True, text=True)
    if ru:  # the variant kernels' registers and spills
        print(f"ptxas, {name}:", *(line for line in proc.stderr.splitlines()
                                   if "ru_fused_kernel" in line or "registers" in line
                                   or "spill" in line), sep="\n  ", flush=True)
    handle = ctypes.CDLL(str(lib))
    for fn in ("fsat_conv_weights", "fsat_conv_taps_k2", "fsat_conv_taps_k4") + (
            ("fsat_fused_residual_unit",) if ru else ()):
        getattr(handle, fn).argtypes = build.SIGNATURES[fn]
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def build_thin_parent(checkout: str, tmp: str, nvcc: str):
    """The thin route's kernel of another checkout (its csrc/conv1d.cu),
    built alone and bound -> (library, whether its entries take the design
    argument: the kernel before the three designs took none)."""
    csrc = Path(checkout) / build.CSRC_DIR.relative_to(build.PACKAGE_DIR.parent)
    lib = Path(tmp) / "thin_parent.so"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(lib),
                    str(csrc / "conv1d.cu")], check=True, capture_output=True, text=True)
    designs = "int design" in (csrc / "conv1d.cu").read_text()
    handle = ctypes.CDLL(str(lib))
    for fn in ("fsat_snake_conv1d", "fsat_snake_conv1d_f32"):
        sig = build.SIGNATURES[fn]
        getattr(handle, fn).argtypes = sig if designs else sig[:12] + sig[13:]
        getattr(handle, fn).restype = ctypes.c_int
    return handle, designs


def thin_check(rnd, rel):
    """The thin route through snake_conv1d at THIN_CHECKS, both dtypes, with
    and without the snake: one thin launch each, within K2's tolerances."""
    import torch

    from .ops.kernels import conv1d

    checks = []
    with torch.no_grad():
        for dt, tol in ((torch.bfloat16, 2e-3), (torch.float32, 1e-5)):
            for b, t, cin, cout, k, d in THIN_CHECKS:
                for sn in (True, False):
                    x = rnd(b, t, cin, scale=0.5).to(dt)
                    w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
                    bb = rnd(cout, scale=0.1)
                    a, ib = ((rnd(cin).abs() + 0.5), 1 / (rnd(cin).abs() + 0.5)) if sn else (None,
                                                                                            None)
                    counter = "snake_conv1d_f32_launches" if dt == torch.float32 else \
                        "snake_conv1d_launches"
                    before = getattr(conv1d, counter)
                    got = conv1d.snake_conv1d(x, w, bb, a, ib, dilation=d)
                    launched = getattr(conv1d, counter) - before
                    want = conv1d.snake_conv1d_plain(x, w, bb, a, ib, dilation=d)
                    err = rel(got, want)
                    max_abs = (got.float() - want.float()).abs().max().item()
                    ok = err <= tol and launched == 1 and (
                        dt == torch.float32 or max_abs <= 2.0 ** -6 * want.float().abs().max().item())
                    checks.append(dict(kernel="K2 thin", dtype=str(dt), shape=[b, t, cin, cout, k, d],
                                       snake=sn, design=conv1d.thin_design(cin, cout, k, d, dt),
                                       rel_l2=err, max_abs=max_abs, ok=ok))
                    print(checks[-1], flush=True)
    return checks


def thin_phase(rnd, rel, timed_ms, parent=None):
    """THIN_CASES through the thin route's C entry (and, where given, the
    parent's, in turns), against the plain version, beside cuDNN and the
    bound; each time the best of its two turns."""
    import torch
    import torch.nn.functional as F

    from .ops.kernels import conv1d

    rows = []
    lib = build.library()
    with torch.no_grad():
        for label, dt_name, b, t, cin, cout, k, sn, has_bias in THIN_CASES:
            dt = torch.bfloat16 if dt_name == "bf16" else torch.float32
            f32 = dt == torch.float32
            x = rnd(b, t, cin, scale=0.5).to(dt)
            w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
            bb = rnd(cout, scale=0.1) if has_bias else None
            a, ib = ((rnd(cin).abs() + 0.5), 1 / (rnd(cin).abs() + 0.5)) if sn else (None, None)
            wc = w.to(dt).contiguous()
            bias = (torch.zeros(cout, device="cuda") if bb is None else bb).contiguous()
            ab = conv1d._stack_snake(a, ib)
            y = torch.empty(b, t, cout, device="cuda", dtype=dt)
            pad = (k - 1) // 2
            design = conv1d.thin_design(cin, cout, k, 1, dt)
            stream = torch.cuda.current_stream().cuda_stream
            args = (x.data_ptr(), wc.data_ptr(), bias.data_ptr(), None if ab is None else ab.data_ptr(),
                    y.data_ptr(), b, t, cin, cout, k, 1, pad)
            entry = "fsat_snake_conv1d_f32" if f32 else "fsat_snake_conv1d"
            calls = {"shipped": lambda: build.check(
                getattr(lib, entry)(*args, conv1d.THIN_DESIGNS[design], stream), "thin K2")}
            if parent is not None:
                handle, designs = parent
                extra = (conv1d.THIN_DESIGNS[design],) if designs else ()
                calls["parent"] = lambda: build.check(
                    getattr(handle, entry)(*args, *extra, stream), "parent thin K2")
            calls["shipped"]()
            torch.cuda.synchronize()
            want = conv1d.snake_conv1d_plain(x, w, bb, a, ib)
            err = rel(y, want)
            max_abs = (y.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            del want
            ok = err <= (1e-5 if f32 else 2e-3) and (f32 or max_abs <= 2.0 ** -6 * peak)
            if parent is not None:
                y_new = y.clone()
                calls["parent"]()
                torch.cuda.synchronize()
                parent_err = rel(y, y_new)
                del y_new
            xs = (x.float() if a is None else conv1d.snake(x.float(), a, ib)).to(dt)
            xs = xs.transpose(1, 2).contiguous()
            wt = w.permute(2, 1, 0).to(dt).contiguous()
            bt = None if bb is None else bb.to(dt)
            calls["cuDNN"] = lambda: F.conv1d(xs, wt, bt, padding="same")
            turns = (["parent"] if parent is not None else []) + ["shipped"]
            order = turns + turns[::-1] + ["cuDNN", "cuDNN"]
            times = {}
            for name in order:
                ms = timed_ms(calls[name], 5)
                times[name] = min(times.get(name, ms), ms)
            del xs
            nbytes = (x.numel() + y.numel() + w.numel()) * x.element_size() + 4 * bias.numel()
            flops = 2 * b * t * cin * cout * k
            t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / (495e12 / 3 if f32 else 989e12) * 1e3
            bound = max(t_bytes, t_ops)
            row = dict(label=label, dtype=dt_name, shape=[b, t, cin, cout, k], snake=sn,
                       design=design, rel_l2=err, max_abs=max_abs, ok=ok, ms=times,
                       bound_ms=bound, bound_by="bytes" if t_bytes >= t_ops else "operations",
                       share=bound / times["shipped"])
            if parent is not None:
                row["rel_l2_to_parent"] = parent_err
                row["speedup_over_parent"] = times["parent"] / times["shipped"]
            rows.append(row)
            print(row, flush=True)
            del x, y
    return rows


def main(argv=None):
    import torch

    from .ops.kernels import conv1d

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    ap.add_argument("--check", action="store_true", help="stop after the correctness checks")
    ap.add_argument("--paths", nargs="+", metavar="CHECKOUT", default=None,
                    help="time chip_smoke's conv phases in these checkouts, in turns")
    ap.add_argument("--thin", nargs="?", const="", default=None, metavar="CHECKOUT",
                    help="run the thin route's sections instead (against CHECKOUT's kernel)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_variants: needs a CUDA device")
    if args.paths:
        paths(args.paths, args.out)
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi}
    nvcc = build.find_nvcc()
    thin = args.thin is not None
    with tempfile.TemporaryDirectory() as tmp:
        sources = ("conv1d.cu",) if thin else ("conv_wgmma.cu", "residual_unit.cu")
        procs = [start_ptxas_report(nvcc, tmp, f) for f in sources]
        lib = build.library()
        parent = build_thin_parent(args.thin, tmp, nvcc) if thin and args.thin else None
        reports = [proc.communicate()[1] for proc in procs]
    out["ptxas"] = "\n".join(reports)
    if any(proc.returncode for proc in procs):
        raise RuntimeError(out["ptxas"])
    print(out["ptxas"], flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

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

    def k2_call(handle, x, wk, bias, y, cin, cout, k, d, n, flush=conv1d.F32_FLUSH, ab=None):
        f32 = x.dtype == torch.float32
        return lambda: build.check(handle.fsat_conv_taps_k2(
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), None if ab is None else ab.data_ptr(),
            y.data_ptr(), x.shape[0], x.shape[1], cin, cout, k, d, d * (k - 1) // 2, n, int(f32),
            flush, torch.cuda.current_stream().cuda_stream), "k2")

    def k4_call(handle, x, wk, bias, y, cin, cout, s, n):
        f32 = x.dtype == torch.float32
        return lambda: build.check(handle.fsat_conv_taps_k4(
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), None, y.data_ptr(), x.shape[0],
            x.shape[1], cin, cout, s, n, int(f32), conv1d.F32_FLUSH,
            torch.cuda.current_stream().cuda_stream), "k4")

    if thin:
        out["check"] = thin_check(rnd, rel)
        failed = not all(c["ok"] for c in out["check"])
        if not (args.check or failed):
            out["thin"] = thin_phase(rnd, rel, timed_ms, parent)
            failed = not all(r["ok"] for r in out["thin"])
        out["card"] = smi
        print(f"card: {smi}", flush=True)
        _finish(out, args.out)
        if failed:
            raise SystemExit("conv_variants: a thin-route result disagrees with its plain version")
        return

    # 2. correctness through the public wrappers
    checks = []
    with torch.no_grad():
        for dt, tol in ((torch.bfloat16, 2e-3), (torch.float32, 1e-5)):
            for b, t, cin, cout, k, d, sn in [(2, 300, 96, 96, 7, 9, True), (2, 300, 96, 96, 7, 9, False),
                                             (1, 1000, 768, 768, 7, 3, False),
                                             (1, 333, 64, 1536, 7, 1, False),
                                             (2, 130, 2048, 128, 3, 1, True),
                                             (1, 517, 128, 128, 1, 1, False),
                                             (2, 211, 16, 32, 1, 1, False),
                                             (1, 4096, 1024, 1024, 7, 9, False)]:
                x = rnd(b, t, cin, scale=0.5).to(dt)
                w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
                bb = rnd(cout, scale=0.1)
                a, ib = ((rnd(cin).abs() + 0.5), 1 / (rnd(cin).abs() + 0.5)) if sn else (None, None)
                route = conv1d.conv_route(cin, cout, k, dt)
                err = rel(conv1d.snake_conv1d(x, w, bb, a, ib, dilation=d),
                          conv1d.snake_conv1d_plain(x, w, bb, a, ib, dilation=d))
                checks.append(dict(kernel="K2", dtype=str(dt), shape=[b, t, cin, cout, k, d],
                                   snake=sn, route=route, rel_l2=err, ok=err <= tol))
                print(checks[-1], flush=True)
            for b, t, cin, cout, s, sn in [(2, 77, 192, 96, 8, True), (1, 300, 1536, 768, 8, False),
                                           (1, 1000, 384, 192, 4, False), (2, 333, 128, 128, 2, True),
                                           (1, 64, 2048, 1024, 8, True)]:
                x = rnd(b, t, cin, scale=0.5).to(dt)
                w = rnd(2 * s, cin, cout, scale=1 / math.sqrt(2 * cin))
                bb = rnd(cout, scale=0.1)
                a, ib = ((rnd(cin).abs() + 0.5), 1 / (rnd(cin).abs() + 0.5)) if sn else (None, None)
                err = rel(conv1d.snake_conv_transpose1d(x, w, bb, a, ib, stride=s),
                          conv1d.snake_conv_transpose1d_plain(x, w, bb, a, ib, stride=s))
                checks.append(dict(kernel="K4", dtype=str(dt), shape=[b, t, cin, cout, s], snake=sn,
                                   rel_l2=err, ok=err <= tol))
                print(checks[-1], flush=True)
    out["check"] = checks
    if args.check or not all(c["ok"] for c in checks):
        _finish(out, args.out)
        if not all(c["ok"] for c in checks):
            raise SystemExit("conv_variants: a wide-kernel result disagrees with its plain version")
        return

    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(len(VARIANTS) + len(RU_VARIANTS)) as pool:
        built = {name: pool.submit(build_variant, name, Path(tmp), nvcc)
                 for name in list(VARIANTS) + list(RU_VARIANTS)}
        libs = {"shipped": lib, **{name: fut.result() for name, fut in built.items()}}
        # 3. tile widths and 4. stages, bf16 and fp32, at the DAC decode's shapes
        tiles, stages = [], []
        with torch.no_grad():
            for dt in (torch.bfloat16, torch.float32):
                for kind, case in [("K2", c) for c in DAC_K2] + [("K4", c) for c in DAC_K4]:
                    if kind == "K2":
                        t, cin, cout, k, d = case
                        w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
                        y = torch.empty(1, t, cout, device="cuda", dtype=dt)
                    else:
                        t, cin, cout, s = case
                        w = rnd(2 * s, cin, cout, scale=1 / math.sqrt(2 * cin))
                        y = torch.empty(1, t * s, cout, device="cuda", dtype=dt)
                    x = rnd(1, t, cin, scale=0.5).to(dt)
                    bb = rnd(cout, scale=0.1)
                    wk = conv1d._k_major_weights(w, dt)

                    def call(handle, n):
                        if kind == "K2":
                            return k2_call(handle, x, wk, bb, y, cin, cout, k, d, n)
                        return k4_call(handle, x, wk, bb, y, cin, cout, s, n)

                    shipped_n = conv1d.conv_tile_n(cout, dt)
                    row = dict(kernel=kind, dtype=str(dt), shape=list(case), shipped_n=shipped_n,
                               ms={n: timed_ms(call(lib, n), 5) for n in conv1d.TILE_N[dt]
                                   if cout % n == 0})
                    tiles.append(row)
                    print(row, flush=True)
                    order = ["shipped", *STAGE_VARIANTS, *reversed(STAGE_VARIANTS), "shipped"]
                    times = {}
                    for name in order:  # in turns: shipped, variants, variants, shipped
                        ms = timed_ms(call(libs[name], shipped_n), 5)
                        times[name] = min(times.get(name, ms), ms)
                    stages.append(dict(kernel=kind, dtype=str(dt), shape=list(case), ms=times))
                    print(stages[-1], flush=True)
                    del x, y, wk
        out["tile_n"], out["stages"] = tiles, stages

        # 5. the fp32 flush interval at the longest reductions
        out["flush"] = flush_phase(libs, rnd, rel, timed_ms, k2_call)
        # 6. K3's routes, tiles and variants
        out["k3"] = k3_phase(libs, rnd, timed_ms)
    out["profile"] = profile_phase(rnd)
    _finish(out, args.out)


# (label, dtype, K2 (T, Cin, Cout, k, dilation) or K4 (T, Cin, Cout, stride), snake)
PROFILE_CASES = [("bf16 K2 DAC 768->768 k7", "bf16", "K2", (32768, 768, 768, 7, 1), False),
                 ("bf16 K2 DAC 96->96 k7", "bf16", "K2", (4194304, 96, 96, 7, 1), False),
                 ("fp32 K2 DAC encode 1024->1024 k7", "fp32", "K2", (32768, 1024, 1024, 7, 1), False)] + [
    (f"{dt} K4 SA 2.0 decode {c[1]}->{c[2]} s{c[3]}{'' if snake else ' without the snake'}", dt, "K4",
     c, snake)
    for dt in ("bf16", "fp32") for c in ((1572864, 256, 128, 4), (6291456, 128, 128, 2))
    for snake in (True, False)]


def profile_phase(rnd, calls=5):
    import torch

    from .ops.kernels import conv1d

    peak = {"bf16": 989e12, "fp32": 495e12 / 3}
    rows = []
    with torch.no_grad():
        for label, dt_name, kind, case, snake in PROFILE_CASES:
            dt = torch.bfloat16 if dt_name == "bf16" else torch.float32
            if kind == "K2":
                t, cin, cout, k, d = case
                w = rnd(k, cin, cout, scale=1 / math.sqrt(k * cin))
                flops = 2 * t * cin * cout * k
            else:
                t, cin, cout, s = case
                w = rnd(2 * s, cin, cout, scale=1 / math.sqrt(2 * cin))
                flops = 2 * t * s * cin * cout * 2
            x = rnd(1, t, cin, scale=0.5).to(dt)
            bb = rnd(cout, scale=0.1)
            a, ib = (rnd(cin).abs() + 0.5, 1 / (rnd(cin).abs() + 0.5)) if snake else (None, None)
            if kind == "K2":
                def fn():
                    return conv1d.snake_conv1d(x, w, bb, a, ib, dilation=d)
            else:
                def fn():
                    return conv1d.snake_conv_transpose1d(x, w, bb, a, ib, stride=s)
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            split = {"conv": 0.0, "weights": 0.0, "other": 0.0}
            for ev in prof.key_averages():
                us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
                key = ("conv" if "conv_taps_kernel" in ev.key else
                       "weights" if "conv_weights_kernel" in ev.key else "other")
                split[key] += us / calls / 1e3
            row = dict(label=label, ms_per_call=split,
                       conv_share_of_bound=flops / peak[dt_name] * 1e3 / max(split["conv"], 1e-9))
            rows.append(row)
            print(row, flush=True)
            del x
    return rows


def k3_phase(libs, rnd, timed_ms):
    """K3 at RU_SHAPES in bf16 and fp32: the shipped route and plan and the
    variants that apply to each shape, in turns (shipped, variants, variants
    reversed, shipped), the best of two turns; each with its share of the
    bound (16 C^2 T products at 989 TFLOP/s in bf16, 165 in fp32)."""
    import torch

    from .ops.kernels import conv1d

    rows = []
    with torch.no_grad():
        for dt, peak in ((torch.bfloat16, 989e12), (torch.float32, 495e12 / 3)):
            f32 = dt == torch.float32
            for c, t in RU_SHAPES:
                d = 3
                x = rnd(1, t, c, scale=0.5).to(dt)
                w1, w2 = rnd(7, c, c, scale=(7 * c) ** -0.5), rnd(c, c, scale=c ** -0.5)
                b1, b2 = rnd(c, scale=0.1), rnd(c, scale=0.1)
                ab1 = torch.stack([rnd(c).abs() + 0.5, 1 / (rnd(c).abs() + 0.5)]).contiguous()
                ab2 = torch.stack([rnd(c).abs() + 0.5, 1 / (rnd(c).abs() + 0.5)]).contiguous()
                wk = conv1d._ru_weights(w1, w2, dt)
                y, h = torch.empty_like(x), torch.empty_like(x)

                def call(handle, route, plan):
                    hp = h.data_ptr() if route == "split" else None
                    pl = plan or dict(x_slots=0, w_stages=0)
                    return lambda: build.check(handle.fsat_fused_residual_unit(
                        x.data_ptr(), wk.data_ptr(), b1.data_ptr(), ab1.data_ptr(), b2.data_ptr(),
                        ab2.data_ptr(), hp, y.data_ptr(), 1, t, c, d, pl["x_slots"],
                        pl["w_stages"], int(f32), conv1d.F32_FLUSH,
                        torch.cuda.current_stream().cuda_stream), "k3")

                route = conv1d.ru_route(c, dt)
                fused_fits = not f32 and 128 * c * 2 <= conv1d.RU_H_MAX
                plan = conv1d.ru_plan(c, d) if fused_fits else None
                cases = {"shipped": call(libs["shipped"], route, plan)}
                if fused_fits:  # both routes run here: the other one
                    other = "split" if route == "fused" else "fused"
                    cases[f"{other} route"] = call(libs["shipped"], other, plan)
                    # the fused route without its weight loads past the ring's first fill
                    cases["ru_no_w_loads (timing only)"] = call(libs["ru_no_w_loads"], "fused",
                                                                plan)
                if route == "split":
                    cases["ru_split_tap_snake"] = call(libs["ru_split_tap_snake"], "split", None)
                if route == "fused":  # the 2-block rings, one block and two per SM
                    cases["fused 2x2 ring"] = call(libs["shipped"], "fused", RU_2CTA_PLAN)
                    cases["ru_2cta"] = call(libs["ru_2cta"], "fused", RU_2CTA_PLAN)
                agree = {}  # each case's output against the shipped one's
                cases["shipped"]()
                ref = y.clone()
                for name, fn in cases.items():
                    if "timing only" not in name and name != "shipped":
                        y.zero_()
                        fn()
                        agree[name] = ((y.double() - ref.double()).norm()
                                       / ref.double().norm()).item()
                order = list(cases) + list(cases)[::-1]
                times = {}
                for name in order:
                    ms = timed_ms(cases[name], 5)
                    times[name] = min(times.get(name, ms), ms)
                bound = 16 * c * c * t / peak * 1e3
                row = dict(dtype=str(dt), C=c, T=t, dilation=d, route=route,
                           plan=plan if route == "fused" else None,
                           bound_ms=bound, ms=times, rel_l2_to_shipped=agree,
                           share={k: bound / v for k, v in times.items()})
                rows.append(row)
                print(row, flush=True)
                del x, y, h, wk, ref
    return rows


def flush_phase(libs, rnd, rel, timed_ms, k2_call):
    import torch

    from .ops.kernels import conv1d

    flush = []
    with torch.no_grad():
        for t, c, k in FLUSH_CASES:
            x = rnd(1, t, c, scale=0.5)
            w = rnd(k, c, c, scale=1 / math.sqrt(k * c))
            bb = rnd(c, scale=0.1)
            ref = conv1d._conv_f32(x.double(), w.double(), 1, (k - 1) // 2) + bb.double()
            wk = conv1d._k_major_weights(w, torch.float32)
            y = torch.empty(1, t, c, device="cuda")
            n = conv1d.conv_tile_n(c, torch.float32)
            n_stages = math.ceil(c / 32) * k
            row = dict(shape=[t, c, c, k], reduction=k * c, plain_fp32=rel(
                conv1d.snake_conv1d_plain(x, w, bb), ref))
            torch.backends.cudnn.allow_tf32 = True
            row["cudnn_1xtf32"] = rel(conv1d._conv_f32(x, w, 1, (k - 1) // 2) + bb, ref)
            torch.backends.cudnn.allow_tf32 = False
            intervals = (1, 2, 4, 8, n_stages)
            for name in ("shipped", *FLUSH_VARIANTS):
                for f in intervals:
                    k2_call(libs[name], x, wk, bb, y, c, c, k, 1, n, flush=f)()
                    row[f"{name} flush{f}"] = dict(rel_l2=rel(y, ref))
                for f in intervals + tuple(reversed(intervals)):
                    ms = timed_ms(k2_call(libs[name], x, wk, bb, y, c, c, k, 1, n, flush=f), 5)
                    row[f"{name} flush{f}"]["ms"] = min(row[f"{name} flush{f}"].get("ms", ms), ms)
            flush.append(row)
            print(row, flush=True)
            del x, y, wk, ref
    return flush


def _finish(out, path):
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
