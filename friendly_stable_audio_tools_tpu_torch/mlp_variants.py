"""Measurements behind the fused SwiGLU MLP's two routes (csrc/glu_mlp.cu:
K13's tensor-core route on the wgmma mainloop of csrc/taps_wgmma.cuh, and
its streaming route) on the card.

    python -m friendly_stable_audio_tools_tpu_torch.mlp_variants [--out mlp.json] [--check]

1. ``ptxas``: registers, shared memory and spills of every kernel in
   glu_mlp.cu (nvcc -Xptxas -v with build.NVCC_FLAGS);
2. ``check``: both routes in bf16 and fp32 through the public wrapper
   (`mlp.route` replaced, `forced`) against the plain version at ragged M, with and
   without the bias (rel-L2 within 2e-3 in bf16, 1e-5 in fp32), and the
   streaming route twice on the same inputs (equal bits: its partials add
   in a fixed order); with --check the script stops here;
3. ``tile_n``: GEMM1's stacked tile widths and GEMM2's tile widths at the
   DiT's shape (M 2080 and 2050, K 1536, inner 6144, Kout 1536), bf16 and
   fp32: the shipped library against libraries built with other widths
   (csrc/glu_mlp.cu:GemmTiles substituted; each library reports its widths
   through fsat_glu_tensor_plan);
4. ``raster``: the shipped row tiles fastest against a library with the
   column tiles fastest (taps_wgmma.cuh:kGemmRowsFastest), both GEMMs, at
   the same shapes;
5. ``stages``: the shipped library against variants with at most 3 and 6
   tensor-core stages (kMaxStages) and with 2, 3 and 4 streaming stages
   (kMaxStreamStages), in turns;
6. ``crossover``: both routes at the audio LM's widths (K 1024, inner 4096,
   Kout 1024) at M 2, 4, 8, 16 (the streaming kernel's M) and the tensor
   route at 32-256, fp32 and bf16, beside the unfused cuBLAS chain
   (F.linear, silu * mul, F.linear; TF32 off);
7. ``flush``: the fp32 tensor-core route's error against fp64 at GEMM2's
   6144-long reduction for partial sums of 1, 2, 4, 8 stages and of the
   whole reduction, beside the plain fp32 version.

Times are device times per call from torch.profiler (the sum of the call's
kernels: the fp32 weight parts, GEMM1 and GEMM2, or the streaming
kernel), weights cycling through sets that exceed the 50 MB L2
where a set is smaller, as the model reads a new layer's weights at every
call. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .conv_variants import substitute
from .ops.kernels import build

# the shipped tile widths (GEMM1's stacked N, GEMM2's N) in csrc/glu_mlp.cu
TILE_LINES = {"bf16": "struct GemmTiles<bf16> { static constexpr int kGlu = 256, kOut = 256; };",
              "fp32": "struct GemmTiles<float> { static constexpr int kGlu = 128, kOut = 128; };"}


def _tiles(bf16, fp32):
    """Substitutions setting (GEMM1, GEMM2) widths per element type."""
    return [(TILE_LINES[name], TILE_LINES[name].replace(
        TILE_LINES[name][TILE_LINES[name].index("kGlu"):TILE_LINES[name].index(";")],
        f"kGlu = {glu}, kOut = {out}")) for name, (glu, out) in (("bf16", bf16), ("fp32", fp32))]


# variant library -> [(text in glu_mlp.cu or taps_wgmma.cuh, replacement), ...]
VARIANTS = {
    "glu192": _tiles((192, 256), (64, 128)),
    "glu128": _tiles((128, 256), (64, 128)),
    "out192": _tiles((256, 192), (128, 96)),
    "out128": _tiles((256, 128), (128, 64)),
    "cols_fastest": [("constexpr bool kGemmRowsFastest = true;",
                      "constexpr bool kGemmRowsFastest = false;")],
    "tc_stages3": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 3;")],
    "tc_stages6": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 6;")],
    "stream_stages3": [("constexpr int kMaxStreamStages = 6;", "constexpr int kMaxStreamStages = 3;")],
    "stream_stages4": [("constexpr int kMaxStreamStages = 6;", "constexpr int kMaxStreamStages = 4;")],
    "stream_stages2": [("constexpr int kMaxStreamStages = 6;", "constexpr int kMaxStreamStages = 2;")],
}
TILE_VARIANTS = ("shipped", "glu192", "glu128", "out192", "out128")
ENTRY_POINTS = ("fsat_glu_gemm", "fsat_out_gemm", "fsat_glu_tensor_plan", "fsat_tf32_split",
                "fsat_glu_stream")
DIT = (1536, 6144, 1536)     # K, inner, Kout of SAO's DiT
LM = (1024, 4096, 1024)      # of the audio LM
DIT_M = (2080, 2050)         # CFG batch 2 x 1040 (training pad), x 1025 (generation)
CROSSOVER_M = (2, 4, 8, 16, 32, 64, 128, 256)
PEAK = {"bf16": 989e12, "fp32": 495e12 / 3}
PEAK_BYTES = 3.35e12


@contextlib.contextmanager
def forced(route_name):
    """mlp.glu_mlp through `route_name` ("stream" or "tensor") in the block."""
    from .ops.kernels import mlp

    real = mlp.route
    mlp.route = lambda *shape: route_name
    try:
        yield
    finally:
        mlp.route = real


def build_variant(name: str, tmp: Path, nvcc: str) -> ctypes.CDLL:
    """glu_mlp.cu with VARIANTS[name]'s substitutions, compiled alone into tmp/name."""
    src = tmp / name
    import shutil

    shutil.copytree(build.CSRC_DIR, src)
    substitute(src, ("glu_mlp.cu", "taps_wgmma.cuh"), VARIANTS[name], name)
    lib = src / "lib.so"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-I", str(src), "-o", str(lib),
                    str(src / "glu_mlp.cu")], check=True, capture_output=True)
    handle = ctypes.CDLL(str(lib))
    for fn in ENTRY_POINTS:
        getattr(handle, fn).argtypes = build.SIGNATURES[fn]
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def main(argv=None):
    import torch

    from .ops.kernels import mlp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    ap.add_argument("--check", action="store_true", help="stop after the correctness checks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mlp_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi}
    nvcc = build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                                 str(build.CSRC_DIR), "-c", "-o", str(Path(tmp) / "m.o"),
                                 str(build.CSRC_DIR / "glu_mlp.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        lib = build.library()
        _, out["ptxas"] = proc.communicate()
    if proc.returncode:
        raise RuntimeError(out["ptxas"])
    print(out["ptxas"], flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def weights(k, inner, kout, dt, bias=True):
        return (rnd(2 * inner, k, scale=k ** -0.5).to(dt),
                rnd(2 * inner, scale=0.1) if bias else None,
                rnd(kout, inner, scale=inner ** -0.5).to(dt))

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    # 2. correctness through the public wrapper
    checks = []
    with torch.no_grad():
        for dt, tol in ((torch.bfloat16, 2e-3), (torch.float32, 1e-5)):
            for m, (k, inner, kout), bias in [(1, (136, 384, 200), True), (2, LM, True),
                                              (16, LM, False), (100, (136, 384, 200), False),
                                              (130, (256, 512, 128), True), (2050, DIT, True),
                                              (2080, DIT, False)]:
                x = rnd(m, k, scale=0.5).to(dt)
                w_in, b_in, w_out = weights(k, inner, kout, dt, bias)
                want = mlp.glu_mlp_plain(x, w_in, b_in, w_out)
                for rname in ("stream", "tensor"):
                    if rname == "stream" and m > 16:
                        continue
                    with forced(rname):
                        got = mlp.glu_mlp(x, w_in, b_in, w_out)
                        again = mlp.glu_mlp(x, w_in, b_in, w_out)
                    torch.cuda.synchronize()
                    err = rel(got, want)
                    row = dict(route=rname, dtype=str(dt), m=m, k=k, inner=inner, kout=kout,
                               bias=bias, rel_l2=err, same_bits=bool(torch.equal(got, again)),
                               ok=bool(err <= tol and torch.isfinite(got).all()
                                       and (rname != "stream" or torch.equal(got, again))))
                    checks.append(row)
                    print(row, flush=True)
    out["check"] = checks
    if args.check or not all(c["ok"] for c in checks):
        _finish(out, args.out)
        if not all(c["ok"] for c in checks):
            raise SystemExit("mlp_variants: a K13 route disagrees with the plain version")
        return

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = {name: pool.submit(build_variant, name, Path(tmp), nvcc) for name in VARIANTS}
        libs = {"shipped": lib, **{name: fut.result() for name, fut in built.items()}}
        with torch.no_grad():
            out["tile_n"], out["raster"] = tile_phase(libs, rnd, weights)
            out["stages"] = stages_phase(libs, rnd, weights)
            out["crossover"] = crossover_phase(rnd, weights)
            out["flush"] = flush_phase(libs, rnd, rel)
    _finish(out, args.out)


def device_ms(fn, calls=10):
    """Device time per call of fn under torch.profiler: (total ms, {kernel: ms})."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            by[ev.key[:90]] = by.get(ev.key[:90], 0.0) + us / calls / 1e3
    return sum(by.values()), by


def tensor_fn(lib, x, w_in, b_in, w_out):
    """One tensor-core K13 call through `lib` (the wrapper's _glu_tensor)."""
    import torch

    from .ops.kernels import mlp

    m, k = x.shape
    inner, kout = w_in.shape[0] // 2, w_out.shape[0]
    dt = x.dtype
    f32 = int(dt == torch.float32)
    h = torch.empty(m, inner, device="cuda", dtype=dt)
    y = torch.empty(m, kout, device="cuda", dtype=dt)
    b = None if b_in is None else b_in.float().contiguous()
    st = torch.cuda.current_stream().cuda_stream

    def run():
        wi, wo = mlp.tensor_weights(w_in, w_out, dt)
        build.check(lib.fsat_glu_gemm(x.data_ptr(), wi.data_ptr(), None if b is None else b.data_ptr(),
                                      h.data_ptr(), m, k, inner, f32, mlp.F32_FLUSH, st), "glu gemm")
        build.check(lib.fsat_out_gemm(h.data_ptr(), wo.data_ptr(), y.data_ptr(), m, inner, kout, f32,
                                      mlp.F32_FLUSH, st), "out gemm")
        return y

    return run


def widths(lib, m, inner, kout, dt):
    """(GEMM1's stacked N, GEMM2's N) that `lib` launches."""
    import torch

    plan = (ctypes.c_int * 4)()
    build.check(lib.fsat_glu_tensor_plan(m, inner, kout, int(dt == torch.float32), plan), "plan")
    return plan[0], plan[2]


def stream_fn(lib, x, w_in, b_in, w_out):
    import torch

    m, k = x.shape
    inner, kout = w_in.shape[0] // 2, w_out.shape[0]
    f32 = int(x.dtype == torch.float32)
    hbuf = torch.empty(m, inner, device="cuda")
    y = torch.empty(m, kout, device="cuda", dtype=x.dtype)
    b = None if b_in is None else b_in.float().contiguous()
    st = torch.cuda.current_stream().cuda_stream

    def run():
        build.check(lib.fsat_glu_stream(x.data_ptr(), w_in.data_ptr(), None if b is None else b.data_ptr(),
                                        w_out.data_ptr(), hbuf.data_ptr(), y.data_ptr(), m, k, inner,
                                        kout, f32, st), "stream")
        return y

    return run


def cycled(fns):
    """Calls fns in turn, one per call (weight sets cycling through L2)."""
    state = {"i": 0}

    def run():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()

    return run


def _sets(weights, k, inner, kout, dt):
    """Enough weight sets that together they exceed the 50 MB L2 cache twice."""
    per = (3 * inner * k + kout * inner) * (2 if str(dt) == "torch.bfloat16" else 4)
    return [weights(k, inner, kout, dt) for _ in range(max(1, math.ceil(100e6 / per)))]


def tile_phase(libs, rnd, weights):
    import torch

    tiles, raster = [], []
    k, inner, kout = DIT
    for dt in (torch.bfloat16, torch.float32):
        sets = _sets(weights, k, inner, kout, dt)
        for m in DIT_M:
            x = rnd(m, k, scale=0.5).to(dt)

            def at(name):
                return device_ms(cycled([tensor_fn(libs[name], x, *ws) for ws in sets]))

            row = dict(dtype=str(dt), m=m, ms={})
            for name in TILE_VARIANTS:
                row["ms"][f"{name} {widths(libs[name], m, inner, kout, dt)}"] = at(name)
            tiles.append(row)
            print(json.dumps(row), flush=True)
            rr = dict(dtype=str(dt), m=m, ms={})  # in turns: each order's two runs
            for name in ("shipped", "cols_fastest", "cols_fastest", "shipped"):
                rr["ms"].setdefault(name, []).append(at(name))
            raster.append(rr)
            print(json.dumps(rr), flush=True)
    return tiles, raster


def stages_phase(libs, rnd, weights):
    import torch

    from .ops.kernels import mlp

    rows = []
    for dt in (torch.bfloat16, torch.float32):
        k, inner, kout = DIT
        sets = _sets(weights, k, inner, kout, dt)
        x = rnd(2050, k, scale=0.5).to(dt)
        order = ["shipped", "tc_stages3", "tc_stages6", "tc_stages6", "tc_stages3", "shipped"]
        ms = {}
        for name in order:
            t = device_ms(cycled([tensor_fn(libs[name], x, *ws) for ws in sets]))[0]
            ms[name] = min(ms.get(name, t), t)
        rows.append(dict(route="tensor", dtype=str(dt), m=2050, ms=ms))
        print(json.dumps(rows[-1]), flush=True)
        k, inner, kout = LM
        lsets = _sets(weights, k, inner, kout, dt)
        for m in (2, 16):
            x = rnd(m, k, scale=0.5).to(dt)
            names = ["shipped", "stream_stages2", "stream_stages3", "stream_stages4"]
            ms = {}
            for name in names + names[::-1]:
                t = device_ms(cycled([stream_fn(libs[name], x, *ws) for ws in lsets]), 20)[0]
                ms[name] = min(ms.get(name, t), t)
            rows.append(dict(route="stream", dtype=str(dt), m=m, ms=ms,
                             plan=mlp.stream_plan(x.device, m, k, inner, kout, dt)))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def crossover_phase(rnd, weights):
    import torch
    import torch.nn.functional as F

    from .ops.kernels import mlp

    rows = []
    k, inner, kout = LM
    for dt in (torch.float32, torch.bfloat16):
        sets = _sets(weights, k, inner, kout, dt)
        name = "fp32" if dt == torch.float32 else "bf16"
        for m in CROSSOVER_M:
            x = rnd(m, k, scale=0.5).to(dt)

            def chain(w_in, b_in, w_out):
                v, gg = F.linear(x, w_in, b_in.to(dt)).chunk(2, dim=-1)
                return F.linear(v * F.silu(gg), w_out)

            flops = 2 * m * k * 2 * inner + 2 * m * inner * kout
            nbytes = (2 * inner * k + kout * inner + m * (k + kout)) * x.element_size()
            row = dict(dtype=name, m=m, bound_ms=max(flops / PEAK[name], nbytes / PEAK_BYTES) * 1e3)
            for rname in ("stream", "tensor"):
                if rname == "stream" and m > 16:
                    row[rname] = None  # the streaming kernel takes M <= 16
                    continue
                with forced(rname):
                    row[rname] = device_ms(cycled([lambda ws=ws: mlp.glu_mlp(x, *ws) for ws in sets]),
                                           20)[0]
            row["cublas_chain"] = device_ms(cycled([lambda ws=ws: chain(*ws) for ws in sets]), 20)[0]
            row["route"] = mlp.route(m, k, inner, kout, dt)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def flush_phase(libs, rnd, rel):
    """The fp32 route's error against fp64 at GEMM2's 6144-long reduction,
    by flush interval (a GEMM1 with a short K, so GEMM2 dominates)."""
    import torch

    from .ops.kernels import mlp

    rows = []
    m, k, inner, kout = 512, 64, 6144, 256
    x = rnd(m, k, scale=0.5)
    w_in = rnd(2 * inner, k, scale=k ** -0.5)
    w_out = rnd(kout, inner, scale=inner ** -0.5)
    h = torch.empty(m, inner, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    lib = libs["shipped"]
    wi, wo = mlp.tensor_weights(w_in, w_out, torch.float32)
    build.check(lib.fsat_glu_gemm(x.data_ptr(), wi.data_ptr(), None, h.data_ptr(), m, k, inner, 1,
                                  mlp.F32_FLUSH, st), "glu gemm")
    ref = h.double() @ w_out.double().T
    row = dict(shape=[m, inner, kout], plain_fp32=rel(h @ w_out.T, ref))
    y = torch.empty(m, kout, device="cuda")
    for f in (1, 2, 4, 8, inner // 32):
        build.check(lib.fsat_out_gemm(h.data_ptr(), wo.data_ptr(), y.data_ptr(), m, inner, kout, 1, f,
                                      st), "out gemm")
        torch.cuda.synchronize()
        row[f"flush{f}"] = rel(y, ref)
    rows.append(row)
    print(json.dumps(row), flush=True)
    return rows


def _finish(out, path):
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
