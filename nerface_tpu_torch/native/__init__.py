"""Native host library: the C++ ray-batch sampler (ctypes binding).

The port's copy of `nerface_tpu/native/__init__.py`'s functions, with the
same signatures: `importance_map`, `gumbel_topk` and `assemble_batch` over
`ray_sampler.cpp`, which is a byte-identical copy of the JAX package's
source. It is built with the JAX package's exact g++ flags, so the two
libraries compute bit for bit the same on one machine, and the port's
`RayFeed` draws the batches the JAX package's native `RayFeed` draws.

The library is built at first use into `build/nerface_tpu_torch/` at the
root of the checkout, under a file name that carries a hash of the source,
the flags and the host's CPU (`-march=native`). Several processes may build at once (test workers): the
build runs under an `fcntl` lock on the build directory, writes a
temporary file and renames it into place, so every process loads one
complete library. A failed build raises: a caller that wants the numpy
draws asks for them (`RayFeed(native=False)`), because they are other
draws.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "ray_sampler.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerface_tpu_torch"
# the JAX package's flags (nerface_tpu/native/__init__.py::_compile)
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


def _cpu_id() -> bytes:
    """This host's CPU model and feature flags: `-march=native` builds for
    them, so a library built on another CPU is not reused."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        return b""


def build_library(build_dir: Optional[Path] = None) -> Path:
    """Compile `ray_sampler.cpp` into `build_dir` (default BUILD_DIR) unless
    a library of the same source, flags and CPU is there; returns its
    path. Raises RuntimeError if g++ is missing or fails."""
    build_dir = Path(build_dir or BUILD_DIR)
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                            + _cpu_id()).hexdigest()
    lib = build_dir / f"libnerface_host_{digest[:16]}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native ray sampler cannot be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "libnerface_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # another process built it while this one waited
                return lib
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(f"g++ timed out after {BUILD_TIMEOUT_S} s: {' '.join(cmd)}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c = ctypes
    lib.nerface_importance_map.argtypes = [
        c.c_int64, c.c_int64, c.c_int64, c.c_int64, c.c_int64, c.c_int64, c.c_double, f64,
    ]
    lib.nerface_gumbel_topk.argtypes = [f64, c.c_int64, c.c_int64, c.c_uint64, i64]
    lib.nerface_assemble_batch.argtypes = [
        i64, c.c_int64, f32, f32, c.c_int64,
        c.c_void_p,  # background or NULL
        f32, f32, f32, f32,
        c.c_void_p,  # bg out or NULL
    ]
    for fn in (lib.nerface_importance_map, lib.nerface_gumbel_topk, lib.nerface_assemble_batch):
        fn.restype = None
    return lib


def library() -> ctypes.CDLL:
    """The loaded library of BUILD_DIR (built first if needed), its
    functions declared."""
    with _lock:
        if BUILD_DIR not in _libs:
            _libs[BUILD_DIR] = _declare(ctypes.CDLL(str(build_library(BUILD_DIR))))
        return _libs[BUILD_DIR]


def importance_map(H: int, W: int, bbox, p: float = 0.9) -> np.ndarray:
    """C++ variant of `sampler.build_importance_maps` for one frame."""
    out = np.empty(H * W, np.float64)
    h0, h1, w0, w1 = [int(v) for v in bbox]
    library().nerface_importance_map(H, W, h0, h1, w0, w1, float(p), out)
    return out


def gumbel_topk(probs: np.ndarray, k: int, seed: int) -> np.ndarray:
    """Draw k indices without replacement ~ probs (Gumbel top-k)."""
    probs = np.ascontiguousarray(probs, np.float64)
    out = np.empty(k, np.int64)
    library().nerface_gumbel_topk(probs, probs.shape[0], k, np.uint64(seed), out)
    return out


def assemble_batch(
    sel: np.ndarray,
    dirs_cam: np.ndarray,
    image_flat: np.ndarray,
    pose: np.ndarray,
    background_flat: Optional[np.ndarray] = None,
):
    """Gather + rotate the selected rays: returns (ro, rd, target, bg?)."""
    sel = np.ascontiguousarray(sel, np.int64)
    k = sel.shape[0]
    dirs_cam = np.ascontiguousarray(dirs_cam, np.float32)
    image_flat = np.ascontiguousarray(image_flat, np.float32)
    pose34 = np.ascontiguousarray(pose[:3, :4], np.float32)
    ro = np.empty((k, 3), np.float32)
    rd = np.empty((k, 3), np.float32)
    target = np.empty((k, 3), np.float32)
    bg = bg_ptr = src_ptr = None
    if background_flat is not None:
        background_flat = np.ascontiguousarray(background_flat[:, :3], np.float32)
        bg = np.empty((k, 3), np.float32)
        bg_ptr = bg.ctypes.data_as(ctypes.c_void_p)
        src_ptr = background_flat.ctypes.data_as(ctypes.c_void_p)
    library().nerface_assemble_batch(
        sel, k, dirs_cam, image_flat, image_flat.shape[-1], src_ptr, pose34, ro, rd, target, bg_ptr,
    )
    return ro, rd, target, bg
