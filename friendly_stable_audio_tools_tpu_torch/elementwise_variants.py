"""Times K11 (csrc/elementwise.cu's LayerNorm + modulate) on the card
against the parent's kernel and against variants of its launch plan, with
K12 (the gated residual) beside them.

    python -m friendly_stable_audio_tools_tpu_torch.elementwise_variants \
        [--parent CHECKOUT] [--out elementwise.json] [--check]

The shipped elementwise.cu is built with ``-Xptxas -v`` (registers, shared
memory and spills of each instantiation printed). ``--parent CHECKOUT``
adds the kernels built from another checkout's csrc/elementwise.cu (e.g.
the parent commit unpacked by ``git archive`` into a directory .gitignore
lists); where that K11 entry takes no plan (one block of D / 8 threads a
row), it is called so. Each variant changes the plan (``lnmod_plan`` in
ops/kernels/elementwise.py, with the shipped build), or the source (the
shipped elementwise.cu with one change, built apart), or both:

* ``warps4``: 4 warps a block instead of 8, the plan made anew for them;
* ``unstaged``: no scale or shift row staged in shared memory (slots 0):
  each row reads its vectors from L1/L2 after its sums;
* ``sm_grid``: one block an SM (132 at the H100), each warp taking its
  rows one after another;
* ``packed``: one row a warp in full blocks (B * T / 8 blocks), the SMs
  taking two or three blocks each at [3j]'s shapes;
* ``ldg``: x loaded with ``__ldg`` and the output stored plainly instead
  of with the evict-first hints (``__ldcs``, ``__stcs``);
* ``sync_before_sums``: the block's wait for its staged vectors placed
  before its first rows' sums instead of after them;
* ``one_chain``: each lane's sums in one chain of adds instead of four.

Each runs at chip_smoke [3j]'s three K11 shapes (the adaLN DiT's B2 T1024
D1536 with a bf16 gamma and without one, and B3 T777), its scale and shift
chunks of one [B, 1, 6D] projection as the DiT hands them over. Each call
is timed as CUDA-graph replays (5 rounds over as many input sets as make
x alone at least twice the card's L2 cache, 17 at B2 T1024 D1536 on the
H100's 50 MB, each set with an output tensor of its own, so that no call
finds its x or its output's lines still in L2), in
turns: the parent, the shipped kernel, the variants, then all again in
reverse; the best of the two turns counts. Each result stands beside its
share of the bound (x read once, the output written once, the vectors
read once, at 3.35 TB/s), its largest difference from the parent's
output in bf16 steps (units of the last place of the larger value) and the
share of its outputs that differ from the parent's. Every
output is held against ``ln_modulate_kernel_math`` within one bf16
rounding; ``--check`` stops after that pass. Beside K11, two yardsticks
in the same replays: ``copy`` (``copy_`` of x into the set's output: the same
bytes as K11 less its vectors) and ``launch`` (an empty kernel,
``torch.cuda._sleep(0)``: what a graph's kernel node costs with no work).
Needs a CUDA device and nvcc.
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

SOURCE = "elementwise.cu"
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# (B, T, D, gamma) of K11 at chip_smoke [3j]; K12 at the first and the last
K11_SHAPES = {"B2 T1024 D1536": (2, 1024, 1536, "bf16"),
              "B2 T1024 D1536 gamma None": (2, 1024, 1536, None),
              "B3 T777 D1536": (3, 777, 1536, "bf16")}
K12_SHAPES = {"B2 T1024 D1536": (2, 1024, 1536), "B3 T777 D1536": (3, 777, 1536)}
# variant -> (source variant or None, plan variant or None)
VARIANTS = {"warps4": (None, "warps4"), "unstaged": (None, "unstaged"),
            "sm_grid": (None, "sm_grid"), "packed": (None, "packed"), "ldg": ("ldg", None),
            "sync_before_sums": ("sync_before_sums", None), "one_chain": ("one_chain", None)}
# source variant -> [(text in SOURCE, replacement), ...]
SOURCE_VARIANTS = {
    "ldg": [
        ("__ldcs(reinterpret_cast<const uint4*>(x + (long long)row * D + c))",
         "__ldg(reinterpret_cast<const uint4*>(x + (long long)row * D + c))"),
        ("__stcs(reinterpret_cast<uint4*>(out + (long long)row * D + c), o);",
         "*reinterpret_cast<uint4*>(out + (long long)row * D + c) = o;")],
    "sync_before_sums": [("  stats();\n  __syncthreads();\n", "  __syncthreads();\n  stats();\n")],
    "one_chain": [
        ("sum[k] += lo_bf16(w);\n        sum[k] += hi_bf16(w);",
         "sum[0] += lo_bf16(w);\n        sum[0] += hi_bf16(w);"),
        ("sq[k] += d0 * d0;\n        sq[k] += d1 * d1;",
         "sq[0] += d0 * d0;\n        sq[0] += d1 * d1;")],
}
# the K11 entry of a kernel that takes no plan (one block of D / 8 threads a row)
OLD_K11_SIGNATURE = build.SIGNATURES["fsat_ln_modulate"][:11] + [ctypes.c_void_p]


def build_library(name: str, csrc: Path, tmp: Path) -> tuple:
    """`csrc`/elementwise.cu (with its headers and SOURCE_VARIANTS[name]'s
    changes) compiled with build.NVCC_FLAGS into tmp/name/lib.so and bound;
    the shipped build prints -Xptxas -v. Returns the library and whether
    its K11 takes a plan."""
    src = tmp / name
    shutil.copytree(csrc, src)
    text = (src / SOURCE).read_text()
    for old, new in SOURCE_VARIANTS.get(name, []):
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {SOURCE} exactly once")
        text = text.replace(old, new)
    (src / SOURCE).write_text(text)
    nvcc = build.find_nvcc()
    report = ["-Xptxas", "-v"] if name == "shipped" else []
    proc = subprocess.run([nvcc, *build.NVCC_FLAGS, *report, "-I", str(src), "-c", "-o",
                           str(src / "ew.o"), str(src / SOURCE)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    if report:
        print(f"ptxas, {SOURCE}:\n{proc.stdout}{proc.stderr}", flush=True)
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(src / "lib.so"),
                    str(src / "ew.o")], check=True)
    lib = ctypes.CDLL(str(src / "lib.so"))
    planned = "int slots" in (src / SOURCE).read_text()
    for entry in ("fsat_ln_modulate", "fsat_gated_residual"):
        fn = getattr(lib, entry)
        fn.argtypes = (build.SIGNATURES[entry] if planned or entry != "fsat_ln_modulate"
                       else OLD_K11_SIGNATURE)
        fn.restype = ctypes.c_int
    return lib, planned


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="", help="write the results as JSON here")
    p.add_argument("--parent", default="", metavar="CHECKOUT",
                   help="also time the kernels built from this checkout's csrc/elementwise.cu")
    p.add_argument("--check", action="store_true", help="stop after one correctness pass")
    args = p.parse_args(argv)

    import torch

    from .ops.kernels import elementwise as ew

    if not torch.cuda.is_available():
        raise RuntimeError("elementwise_variants needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    sms = ew.sm_count(torch.device("cuda"))
    tmp = Path(tempfile.mkdtemp())
    libs = {"shipped": build_library("shipped", build.CSRC_DIR, tmp)}
    if args.parent:
        parent_csrc = Path(args.parent) / build.CSRC_DIR.relative_to(build.PACKAGE_DIR.parent)
        libs["parent"] = build_library("parent", parent_csrc, tmp)
    if not args.check:
        libs.update({name: build_library(name, build.CSRC_DIR, tmp) for name in SOURCE_VARIANTS})
    source_of = {name: src for name, (src, _) in VARIANTS.items() if src}
    plan_variant = {name: plan for name, (_, plan) in VARIANTS.items() if plan}

    def plan_of(name, rows, t, d):
        name = plan_variant.get(name, name)
        if name == "warps4":
            warps, ew.LN_WARPS = ew.LN_WARPS, int(name[5:])
            try:
                return ew.lnmod_plan.__wrapped__(rows, t, d, sms)
            finally:
                ew.LN_WARPS = warps
        plan = ew.lnmod_plan(rows, t, d, sms)
        if name == "unstaged":
            return plan._replace(slots=0, smem=plan.smem - 4 * d * plan.slots)
        if name == "sm_grid":
            return plan._replace(grid=sms)
        if name == "packed":
            return plan._replace(grid=-(-rows // plan.warps))
        return plan

    def k11(name):
        lib, planned = libs[name if name == "parent" else source_of.get(name, "shipped")]

        def call(out, x, gamma, scale, shift):
            xa, ga, kind, sc, ss, sh, hs = ew._lnmod_args(x, gamma, scale, shift)
            b, t, d = x.shape
            head = (xa.data_ptr(), None if ga is None else ga.data_ptr(), kind, sc.data_ptr(),
                    sh.data_ptr(), ss, hs, out.data_ptr(), b * t, t, d)
            stream = torch.cuda.current_stream().cuda_stream
            if planned:
                plan = plan_of(name, b * t, t, d)
                err = lib.fsat_ln_modulate(*head, plan.grid, plan.warps, plan.slots, stream)
            else:
                err = lib.fsat_ln_modulate(*head, stream)
            build.check(err, f"ln_modulate ({name})")
            return out
        return call

    def k12(name):
        lib = libs["parent" if name == "parent" else "shipped"][0]

        def call(out, y, gate, residual):
            b, t, d = y.shape
            g, stride = ew._vector(gate, b, d, "gate")
            build.check(lib.fsat_gated_residual(
                y.data_ptr(), g.data_ptr(), stride, residual.data_ptr(), out.data_ptr(), b * t, t,
                d, torch.cuda.current_stream().cuda_stream), f"gated_residual ({name})")
            return out
        return call

    def events_ms(fn, reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, sets, rounds=5):
        """Device time per call of fn(out, *inputs) over `sets` of (out,
        inputs), as one CUDA-graph replay."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for out, s in sets:
                fn(out, *s)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(rounds):
                for out, s in sets:
                    fn(out, *s)
        ms = events_ms(graph.replay, 3) / (rounds * len(sets))
        del graph
        return ms

    def steps(a, b):
        """The largest |a - b| in units of the last place of the larger bf16 value."""
        a, b = a.float(), b.float()
        _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
        return ((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)).max().item()

    def one_rounding(got, want):
        got, want = got.float(), want.float()
        rel = ((got - want).norm() / want.norm()).item()
        return rel, rel < 1e-3 and (got - want).abs().max() <= 2.0 ** -7 * want.abs().max()

    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape, scale=1.0: torch.randn(*shape, generator=g, device="cuda") * scale  # noqa: E731
    names = (["parent"] if args.parent else []) + ["shipped"] + (
        [] if args.check else list(VARIANTS))
    turns = names if args.check else names + names[::-1]
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    summary = {"card": smi, "sm_count": sms, "l2_bytes": l2, "k11": {}, "k12": {}}
    failed = []
    cases = [("k11", key, shape) for key, shape in K11_SHAPES.items()] + [
        ("k12", key, shape) for key, shape in K12_SHAPES.items()]
    for kernel, key, shape in cases:
        b, t, d = shape[:3]
        n_sets = max(2, -(-2 * l2 // (b * t * d * 2)))  # x alone >= 2 x L2
        sets = []
        for _ in range(n_sets):
            x = rnd(b, t, d).to(torch.bfloat16)
            scale, shift, gate = rnd(b, 1, 6 * d, scale=0.3).to(torch.bfloat16).chunk(6, -1)[:3]
            if kernel == "k11":
                gamma = None if shape[3] is None else (1 + rnd(d, scale=0.1)).to(torch.bfloat16)
                sets.append((torch.empty_like(x), (x, gamma, scale, shift)))
            else:
                sets.append((torch.empty_like(x), (x, gate, rnd(b, t, d).to(torch.bfloat16))))
        inputs = sets[0][1]
        moved = sum(u.numel() * u.element_size() for u in inputs if u is not None) + \
            b * t * d * 2
        bound = moved / PEAK_BYTES * 1e3
        run_names = [n for n in names if kernel == "k11" or n in ("parent", "shipped")]
        make = k11 if kernel == "k11" else k12
        reference = (ew.ln_modulate_kernel_math if kernel == "k11"
                     else ew.gated_residual_kernel_math)
        want = reference(*inputs)
        rows = {}
        with torch.no_grad():
            outs = {n: make(n)(torch.empty_like(inputs[0]), *inputs) for n in run_names}
            for n in run_names:
                rel, ok = one_rounding(outs[n], want)
                rows[n] = {"rel_l2_kernel_math": rel, "ms": []}
                if "parent" in outs:
                    rows[n]["parent_steps"] = steps(outs[n], outs["parent"])
                    rows[n]["parent_differ"] = (outs[n] != outs["parent"]).float().mean().item()
                if not ok:
                    failed.append(f"{kernel} {key} {n}")
            del outs
            for n in (turns if not args.check else []):
                if n in rows:
                    rows[n]["ms"].append(graph_ms(make(n), sets))
            if kernel == "k11" and not args.check:
                refs = {"copy": lambda out, x, *_: out.copy_(x),
                        "launch": lambda *_: torch.cuda._sleep(0)}
                for n, fn in refs.items():
                    rows[n] = {"ms": [graph_ms(fn, sets) for _ in range(2)]}
        for n, r in rows.items():
            r["ms"] = min(r["ms"], default=None)
            r["share_of_bound"] = None if r["ms"] is None else bound / r["ms"]
            timed = "" if r["ms"] is None else f" {r['ms']:.5f} ms ({100 * r['share_of_bound']:.0f}%)"
            rel = (f" rel-L2 {r['rel_l2_kernel_math']:.2e}" if "rel_l2_kernel_math" in r else "")
            diff = (f" {r['parent_steps']:.0f} steps from the parent at most, "
                    f"{100 * r['parent_differ']:.3f}% differ" if "parent_steps" in r else "")
            print(f"{kernel} {key:28s} {n:9s}{timed}{rel}{diff}", flush=True)
        summary[kernel][key] = {"shape": list(shape), "bound_ms": bound, "sets": n_sets,
                                "runs": rows}
        print(f"{kernel} {key:28s} bound {bound:.5f} ms, {n_sets} input sets "
              f"(x {n_sets * b * t * d * 2 / l2:.2f} x L2)", flush=True)
        del sets
    print(f"card: {smi}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise AssertionError(f"not within one rounding of the kernel's arithmetic: {failed}")
    return summary


if __name__ == "__main__":
    main()
