"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ files in `nerface_tpu_torch/csrc/` with a plain C
interface. `build_library` compiles one with nvcc into a shared library
under `build/nerface_tpu_torch/` at the root of the checkout, on first use;
`load_library` loads it with ctypes and declares the C function's
argument types. The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is not.

Flags: Hopper (`sm_90a`), -O3, and neither `--use_fast_math` nor
`-ftz=true`: the encoding needs `sinf` with full range reduction (sin
arguments reach hundreds of radians), and the disparity guard
max(acc, 1e-38) needs denormals.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "nerface_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_library(name: str = "fused_paper_render") -> Path:
    """Compile `csrc/<name>.cu` into `build/nerface_tpu_torch/` unless a
    library of the same source and flags is there; returns its path. The
    compiler's resource report (-Xptxas -v) is kept beside it as
    `<library>.log`."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    Path(str(lib) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the fused-render library, with argtypes
    declared: pointers and the stream as c_void_p, sizes as c_int."""
    lib = ctypes.CDLL(str(build_library("fused_paper_render")))
    fn = lib.nerface_fused_paper_render
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
