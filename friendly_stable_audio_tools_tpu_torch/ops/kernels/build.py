"""Builds the hand-written Hopper kernels (``csrc/*.cu``) and binds them.

Each ``.cu`` source compiles with its own ``nvcc`` process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ``ctypes`` (seconds, where a PyTorch C++ extension
takes minutes). The build happens at the first CUDA call, never at import,
into ``build/torch_kernels/`` beside the package, under a name keyed on a
hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused. A failed build raises.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (all return an int cudaError_t)
SIGNATURES = {
    "fsat_pair_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "fsat_pair_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _F, _P],
    "fsat_rope_pair": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "fsat_flash_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "fsat_flash_forward_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "fsat_flash_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    "fsat_flash_backward_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    "fsat_flash_forward_d128": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "fsat_flash_backward_fused_d128": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                       _P],
    "fsat_rope_heads": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "fsat_snake_conv1d": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "fsat_snake_conv1d_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "fsat_fused_residual_unit": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _P],
    "fsat_conv_weights": [_P, _P, _I, _I, _I, _I, _P],
    "fsat_conv_taps_k2": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "fsat_conv_taps_k4": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "fsat_glu_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fsat_out_gemm": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fsat_glu_tensor_plan": [_I, _I, _I, _I, _P],
    "fsat_tf32_split": [_P, _P, _I, _I, _I, _P],
    "fsat_glu_stream": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fsat_glu_stream_plan": [_I, _I, _I, _I, _I, _P],
    "fsat_ln_modulate": [_P, _P, _I, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P],
    "fsat_gated_residual": [_P, _P, _I, _P, _P, _I, _I, _I, _P],
}

_lib = None
_lock = threading.Lock()


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit on PATH): "
                       "the torch port's CUDA kernels cannot be built")


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")


def build() -> Path:
    """Compiles the sources unless a library for this digest exists; returns its path."""
    target = BUILD_DIR / f"libfsat_kernels_{source_digest()}.so"
    if target.exists():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, cmds = [], []
        for cu in sorted(CSRC_DIR.glob("*.cu")):
            obj = str(Path(tmp) / (cu.stem + ".o"))
            objs.append(obj)
            cmds.append([nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", obj, str(cu)])
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            for fut in [pool.submit(_run, cmd) for cmd in cmds]:
                fut.result()
        lib = str(Path(tmp) / "lib.so")
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs])
        os.replace(lib, target)  # atomic: a concurrent loader never sees a partial file
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
