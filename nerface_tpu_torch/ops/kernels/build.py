"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ files in `nerface_tpu_torch/csrc/` with a plain C
interface, one library per `.cu` file (`fused_paper_render`, K2;
`fused_train_pass`, K1; `fused_paper_mlp`, K3; `fused_flex`, K4;
`fused_resample`, K5; `probes`, the design probes P1 and P2 of
`nerface_tpu_torch/tools/perf/`), sharing the `.cuh` headers.
`build_library` compiles one with nvcc into a shared library under
`build/nerface_tpu_torch/` at the root of the checkout, on first use;
`load_library(name)` loads it with ctypes and declares its C functions'
argument types (`SIGNATURES`). The library's file name carries a hash of
the source, the headers beside it and the flags, so an edited source is
rebuilt and an unchanged one is not.

Flags: Hopper (`sm_90a`), -O3, and neither `--use_fast_math` nor
`-ftz=true`: the encoding needs `sinf` with full range reduction (sin
arguments reach hundreds of radians), and the disparity guard
max(acc, 1e-38) needs denormals. ptxas compiles a library's entry
functions in parallel threads (`--split-compile=0`: as many as the host
has cores); each kernel's SASS is the same as from one thread.

K1's, K3's and K4's libraries (`fused_train_pass`, `fused_paper_mlp`,
`fused_flex`) hold the kernels' layout classes (`csrc/mma_tile.cuh`) in
two builds, compiled side by side: the fixed classes S = 64 / 128 and the
runtime class of every other S (`layout_library`, `SAMPLE_CLASS_DEFINES`).
K4's hidden widths 768 and 1024 are a build each besides
(`flex_sliced_defines`); `library_builds` lists a library's builds.

A debug build: the environment variable NERFACE_KERNEL_DEFINES (defines,
space-separated) is added to every library's `defines`, e.g.
`NERFACE_KERNEL_DEFINES=NERFACE_WATCHDOG_REPORT`, the mbarrier watchdog's
report (`csrc/wgmma_tile.cuh`, read by `tools/perf/watchdog_loop.py`).
Unset, the libraries are the production build.
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
    "-Xptxas", "--split-compile=0",
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


def build_library(name: str = "fused_paper_render", defines: tuple = ()) -> Path:
    """Compile `csrc/<name>.cu` into `build/nerface_tpu_torch/` unless a
    library of the same source and flags is there; returns its path.
    `defines` ("NAME=value", ...) and NERFACE_KERNEL_DEFINES's go to nvcc
    as -D flags: a variant build for a comparison, or a debug build. The
    compiler's resource report (-Xptxas -v) is kept beside it as
    `<library>.log`."""
    src = CSRC / f"{name}.cu"
    defines = tuple(defines) + tuple(os.environ.get("NERFACE_KERNEL_DEFINES", "").split())
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()
    lib = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    Path(str(lib) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library -> {C function: (argtypes, restype)}: pointers and the stream as
# c_void_p, sizes and flags as c_int, scalars as c_float.
SIGNATURES = {
    "fused_paper_render": {
        "nerface_fused_paper_render": ([_P] * 13 + [_I] * 5 + [_P], ctypes.c_int),
        "nerface_fused_paper_render_shared_bytes": ([_P], None),
    },
    "fused_train_pass": {
        "nerface_fused_train_pass": ([_P] * 17 + [_I] * 5 + [_F] * 3 + [_P], ctypes.c_int),
        "nerface_fused_train_workspace_bytes": ([_I] * 3, ctypes.c_longlong),
        "nerface_fused_train_shared_bytes": ([_P], None),
    },
    "fused_paper_mlp": {
        "nerface_fused_paper_mlp_fwd": ([_P] * 7 + [_I] * 4 + [_P], ctypes.c_int),
        "nerface_fused_paper_mlp_bwd": ([_P] * 12 + [_I] * 4 + [_P], ctypes.c_int),
        "nerface_fused_paper_mlp_workspace_bytes": ([_I] * 3, ctypes.c_longlong),
        "nerface_fused_paper_mlp_shared_bytes": ([_P], None),
    },
    "fused_flex": {
        "nerface_fused_flex_fwd": ([_P] * 7 + [_I] * 5 + [_P], ctypes.c_int),
        "nerface_fused_flex_bwd": ([_P] * 12 + [_I] * 5 + [_P], ctypes.c_int),
        "nerface_fused_flex_workspace_bytes": ([_I] * 5, ctypes.c_longlong),
        "nerface_fused_flex_shared_bytes": ([_P], None),
    },
    "fused_resample": {
        "nerface_fused_resample": ([_P] * 3 + [_I, _P] + [_I] * 4 + [_P], ctypes.c_int),
    },
    "probes": {
        "nerface_probe_chain": ([_P] * 4 + [_I] * 3 + [_P], ctypes.c_int),
        "nerface_probe_encoder": ([_P] * 4 + [_I] * 3 + [_P], ctypes.c_int),
    },
}


@functools.lru_cache(maxsize=None)
def load_library(name: str = "fused_paper_render", defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load the library of `csrc/<name>.cu` (with
    `build_library`'s `defines`), with its functions' argtypes and restype
    declared from `SIGNATURES`."""
    lib = ctypes.CDLL(str(build_library(name, defines)))
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


# The two builds of K1's, K3's and K4's libraries: the fixed layout classes
# (S = 64 and 128, the passes of the bundled configs, at up to 10 xyz
# bands) and the runtime class (any other S, and every kernel's passes of
# 11..31 bands at any S: the fixed classes read a one-block xin image).
# Each builds in about half the nvcc time of one library of all of them.
FIXED_SAMPLES = (64, 128)
SAMPLE_CLASS_DEFINES = {"fixed": ("NERFACE_SAMPLE_CLASSES=2",), "any": ("NERFACE_SAMPLE_CLASSES=1",)}


def sample_class_defines(n_samples: int, num_encoding_fn_xyz: int = 10) -> tuple:
    """The defines of the build that holds a pass of n_samples samples at
    num_encoding_fn_xyz bands (the fixed classes read a K_XIN encoding)."""
    from nerface_tpu_torch.ops.kernels.fused_mlp import K_XIN, xin_extent

    fixed = n_samples in FIXED_SAMPLES and xin_extent(num_encoding_fn_xyz) == K_XIN
    return SAMPLE_CLASS_DEFINES["fixed" if fixed else "any"]


# the libraries built as the two builds of `SAMPLE_CLASS_DEFINES`
LAYOUT_LIBRARIES = ("fused_train_pass", "fused_paper_mlp", "fused_flex")


def flex_sliced_defines(h: int) -> tuple:
    """The defines of the build that holds K4 at width h, one of
    `fused_flex.SLICED_WIDTHS` (`csrc/fused_flex.cu`'s sliced kernels, the
    runtime layout class at every S): one build of `fused_flex` a width,
    with no layout class of the narrower widths, so that each compiles in
    parallel with the rest."""
    return ("NERFACE_SAMPLE_CLASSES=0", f"NERFACE_SLICED_WIDTH={h}")


def library_builds(name: str) -> tuple:
    """The define sets `name` builds with: two layout-class builds of
    LAYOUT_LIBRARIES, and fused_flex's sliced widths besides."""
    from nerface_tpu_torch.ops.kernels.fused_flex import SLICED_WIDTHS

    if name not in LAYOUT_LIBRARIES:
        return ((),)
    builds = tuple(SAMPLE_CLASS_DEFINES.values())
    return builds + tuple(map(flex_sliced_defines, SLICED_WIDTHS)) if name == "fused_flex" else builds


def layout_library(name: str, n_samples: int, num_encoding_fn_xyz: int = 10) -> ctypes.CDLL:
    """`load_library(name)` in the build that holds the layout class of a
    pass of n_samples samples at num_encoding_fn_xyz bands (one of
    LAYOUT_LIBRARIES)."""
    return load_library(name, sample_class_defines(n_samples, num_encoding_fn_xyz))
