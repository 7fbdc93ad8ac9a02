"""K5: the hierarchical resample (inverse-CDF draw + sorted merge) as one
kernel.

Port of `nerface_tpu/ops/pallas/fused_mlp.py::fused_resample` (the Pallas
TPU kernel `_resample_kernel`, `pallas_call` at fused_mlp.py:973). Like the
JAX package's, it is an entry point of its own: nothing in `render/` or
`eval/` calls it, and `render_rays` keeps `sample_pdf` + `merge_sorted_zvals`.

* `fused_resample` is the wrapper: on CUDA tensors it checks them
  (`check_kernel_operands`) and launches `csrc/fused_resample.cu`
  (`_launch_resample`) or raises; on CPU tensors it runs
  `fused_resample_reference`. It counts launches in `fused_resample.launches`.
* `fused_resample_reference` is the plain PyTorch version, exactly what
  `render_rays` runs: `sample_pdf` over the z-midpoints and the weights
  `w[:, 1:-1]` at the given draws, then `merge_sorted_zvals`.

The kernel takes every shape of the JAX kernel within the port's samples
a ray: Sc ≥ MIN_COARSE = 3 coarse samples, Sf ≥ 1 draws, Sc + Sf ≤
MAX_TOTAL = `fused_mlp.MAX_SAMPLES` (1024), the limit of every kernel of
the port. `csrc/fused_resample.cu` pads Sc to its class (32, 64, ...,
1024); up to 256 in all a warp holds a ray in registers, past it (the long
regime) a warp holds it in shared memory. The wrapper raises past that on
either device.

It agrees with `sample_pdf` to 2e-6·far where every pdf bin is ≥ 1e-3,
but not where a bin sits at the 1e-5 clamp: near the knots of such a bin
the draw jumps across it with the cdf's last ulp, which no two orders of
f32 sums share. A change that wires it into `render_rays` must handle
those bins first.

Two regimes, as in JAX: `sorted_u=True` when u is non-decreasing per ray
(the deterministic linspace draws, passed once as an (Sf,) row), where the
drawn samples come out sorted and the kernel merges without sorting them;
and general draws (R, Sf), which the kernel sorts first. Both give the
sorted union of z and the samples, so the plain version is the same for
both. The result is detached (the reference detaches the fine samples).
"""

from __future__ import annotations

import ctypes

import torch

from nerface_tpu_torch.ops.kernels.fused_mlp import MAX_SAMPLES
from nerface_tpu_torch.ops.sampling import merge_sorted_zvals, sample_pdf

MIN_COARSE = 3  # the JAX kernel's least Sc
MAX_TOTAL = MAX_SAMPLES  # Sc + Sf, the port's samples a ray
# Sc + Sf up to SHORT_TOTAL: a warp holds the ray in registers; past it the
# long regime (`csrc/fused_resample.cu`)
SHORT_TOTAL = 256


def _check_shapes(z_vals, weights, u):
    if z_vals.ndim != 2 or weights.shape != z_vals.shape:
        raise ValueError(
            f"z_vals and weights must be (R, Sc), got {tuple(z_vals.shape)} and "
            f"{tuple(weights.shape)}"
        )
    if z_vals.shape[1] < 3:
        raise ValueError(f"resampling needs at least 3 coarse samples, got {z_vals.shape[1]}")
    if u.ndim not in (1, 2) or (u.ndim == 2 and u.shape[0] != z_vals.shape[0]):
        raise ValueError(f"u must be (R, Sf) or (Sf,), got {tuple(u.shape)} for R = {z_vals.shape[0]}")


def fused_resample_reference(
    z_vals: torch.Tensor, weights: torch.Tensor, u: torch.Tensor, sorted_u: bool = False
) -> torch.Tensor:
    """(R, Sc + Sf) sorted union of the coarse depths `z_vals` (R, Sc) and
    the depths drawn at `u` ((R, Sf), or (Sf,) for every ray) from the
    coarse `weights` (R, Sc). `sorted_u` only picks the kernel's regime."""
    _check_shapes(z_vals, weights, u)
    n_rays = z_vals.shape[0]
    if u.ndim == 1:
        u = u.expand(n_rays, u.shape[0])
    z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
    samples = sample_pdf(z_mid, weights[:, 1:-1], u.shape[-1], u=u)
    return merge_sorted_zvals(z_vals, samples).detach()


def fused_resample(
    z_vals: torch.Tensor, weights: torch.Tensor, u: torch.Tensor, sorted_u: bool = False
) -> torch.Tensor:
    """The fused resample. z_vals, weights (R, Sc) f32 with z sorted per
    ray; u (R, Sf) or (Sf,) f32 draws in [0, 1], non-decreasing per ray
    when `sorted_u`. MIN_COARSE ≤ Sc, 1 ≤ Sf, Sc + Sf ≤ MAX_TOTAL; on the
    card contiguous inputs."""
    _check_shapes(z_vals, weights, u)
    check_sample_counts(z_vals.shape[1], u.shape[-1])
    dev = z_vals.device
    if dev.type == "cpu":
        return fused_resample_reference(z_vals, weights, u, sorted_u)
    if dev.type != "cuda":
        raise ValueError(f"fused_resample runs on cuda or cpu, not {dev}")
    check_kernel_operands(z_vals, weights, u)
    n_rays, n_coarse = z_vals.shape
    out = torch.empty(n_rays, n_coarse + u.shape[-1], dtype=torch.float32, device=dev)
    _launch_resample(z_vals, weights, u, out, sorted_u)
    return out


fused_resample.launches = 0


def check_sample_counts(n_coarse: int, n_fine: int) -> None:
    """Raise on sample counts outside the kernel's domain: Sc below
    MIN_COARSE, Sf below 1, Sc + Sf past MAX_TOTAL."""
    if n_coarse < MIN_COARSE:
        raise ValueError(f"the kernel takes at least {MIN_COARSE} coarse samples, got {n_coarse}")
    if n_fine < 1 or n_coarse + n_fine > MAX_TOTAL:
        raise ValueError(
            f"the kernel takes 1 or more fine samples and at most {MAX_TOTAL} in all, "
            f"got {n_coarse} + {n_fine}"
        )


def check_kernel_operands(z_vals: torch.Tensor, weights: torch.Tensor, u: torch.Tensor):
    """Raise on what the kernel does not take: sample counts outside
    `check_sample_counts`' domain, an operand that is not f32, not on
    z_vals' device or not contiguous."""
    check_sample_counts(z_vals.shape[1], u.shape[-1])
    for name, t in (("z_vals", z_vals), ("weights", weights), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != z_vals.device:
            raise ValueError(f"{name} is on {t.device}, expected {z_vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_resample(z_vals, weights, u, out, sorted_u):
    """K5's C entry point on checked CUDA operands (`check_kernel_operands`),
    into `out` (R, Sc + Sf) f32. Counts the launch in
    `fused_resample.launches`."""
    from nerface_tpu_torch.ops.kernels.build import load_library

    n_rays, n_coarse = z_vals.shape
    lib = load_library("fused_resample")
    dev = z_vals.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerface_fused_resample(
            ctypes.c_void_p(z_vals.data_ptr()), ctypes.c_void_p(weights.data_ptr()),
            ctypes.c_void_p(u.data_ptr()), int(u.ndim == 1), ctypes.c_void_p(out.data_ptr()),
            n_rays, n_coarse, u.shape[-1], int(bool(sorted_u)), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_resample kernel launch failed: cudaError {err}")
    fused_resample.launches += 1
