"""Depth sampling along rays: stratified coarse samples and hierarchical
inverse-CDF resampling.

Port of `nerface_tpu/ops/sampling.py` (reference stratified block
`train_utils.py:56-76` and `sample_pdf_2`, `nerf_helpers.py:344-387`).

Random draws. JAX's draws come from `fold_in(key, ray_index)` and cannot
be reproduced in torch, so every function here takes its draws as an
argument (`t_rand`, `u`) — tests inject the JAX package's own. Without
injected draws the port makes its own with `per_ray_uniform`: a
counter-based hash of (seed, stream, global ray index, sample index)
written in torch integer ops. A ray's draws depend on those four numbers
alone, so they are the same on the CPU and the card and for any tiling
of the ray axis. The seed may be a 0-d int64 tensor on the device
(`step_seed` of the window's step counter): the draws are then made
without reading anything back to the host, and equal the int form's bit
for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerface_tpu_torch.ops.math import linspace01

_M32 = 0xFFFFFFFF

# Stream ids: one per kind of draw, as the JAX package splits its key
# four ways (`render/pipeline.py`: strat, coarse noise, pdf, fine noise).
STREAM_STRATIFIED = 0
STREAM_NOISE_COARSE = 1
STREAM_PDF = 2
STREAM_NOISE_FINE = 3
# The device ray feed's draws (data/device_feed.py): the frame, then one
# Gumbel key a pixel.
STREAM_FEED_FRAME = 4
STREAM_FEED_PIXEL = 5


def _mul32(x, c: int):
    """(x · c) mod 2^32 for x in [0, 2^32) held in int64, without
    overflowing int64: multiply the two 16-bit halves separately."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer finalizer (lowbias32): a bijection whose output bits
    each depend on every input bit. Works on Python ints and int64
    tensors alike."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def step_seed(seed, step):
    """The draws' seed of train step `step` of a run seeded `seed`: keyed
    by the step number (as the JAX package folds the step into its key),
    so a resumed run draws what the uninterrupted run would have. Either
    argument may be a 0-d int64 tensor (the window reads the step from a
    device counter): the result is then a 0-d int64 tensor on its device,
    equal bit for bit to the int form."""
    if not isinstance(seed, torch.Tensor):
        seed = int(seed)
    if not isinstance(step, torch.Tensor):
        step = int(step)
    return _mix32((seed & _M32) ^ _mix32((step + 0x632BE5AB) & _M32))


def per_ray_bits(seed, stream: int, ray_index: torch.Tensor, num_samples: int,
                 first_sample: int = 0) -> torch.Tensor:
    """(R, num_samples) int64 hashes in [0, 2^32) on `ray_index`'s device.
    Row r depends only on (seed, stream, ray_index[r]); `seed` is an int or
    a 0-d int64 tensor (`step_seed`'s tensor form). Column c is sample
    `first_sample + c` of the row."""
    if not isinstance(seed, torch.Tensor):
        seed = int(seed)
    key = _mix32((seed & _M32) ^ _mix32((int(stream) + 0x9E3779B9) & _M32))
    ray = ray_index.to(torch.int64).reshape(-1, 1) & _M32
    h = _mix32(ray ^ key)
    col = torch.arange(first_sample, first_sample + num_samples, dtype=torch.int64,
                       device=ray_index.device)
    return _mix32(h ^ _mix32(_mul32(col, 0x9E3779B9) ^ 0x85EBCA6B))


def per_ray_uniform(seed, stream: int, ray_index: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(R, num_samples) f32 uniforms in [0, 1) on `ray_index`'s device.
    Row r depends only on (seed, stream, ray_index[r])."""
    h = per_ray_bits(seed, stream, ray_index, num_samples)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def per_ray_normal(seed, stream: int, ray_index: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(R, num_samples) f32 standard normals (Box–Muller over
    `per_ray_uniform`'s draws); row r depends only on (seed, stream,
    ray_index[r]), as the JAX package's `per_ray_normal` rows do."""
    u = per_ray_uniform(seed, stream, ray_index, 2 * num_samples)
    u1 = 1.0 - u[:, 0::2]  # (0, 1]: log stays finite
    u2 = u[:, 1::2]
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * torch.pi) * u2)


def stratified_zvals(
    near: torch.Tensor,
    far: torch.Tensor,
    num_samples: int,
    lindisp: bool = False,
    perturb: bool = True,
    t_rand: Optional[torch.Tensor] = None,
    seed=0,
    ray_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Coarse depth values per ray: (num_rays, num_samples).

    near/far: (num_rays, 1). When `perturb`, samples are jittered
    uniformly within each stratum by `t_rand` (R, num_samples), or by the
    port's own draws for (`seed`, `ray_index`) when `t_rand` is None."""
    t_vals = linspace01(num_samples, near.dtype, near.device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    z_vals = z_vals.expand(near.shape[0], num_samples).contiguous()
    if perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            if ray_index is None:
                ray_index = torch.arange(near.shape[0], device=near.device)
            t_rand = per_ray_uniform(seed, STREAM_STRATIFIED, ray_index, num_samples)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    det: bool = False,
    u: Optional[torch.Tensor] = None,
    seed=0,
    ray_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-transform sampling of `num_samples` depths from a per-ray
    piecewise-constant pdf over `bins`.

    bins: (R, B) sorted bin positions (z-midpoints); weights: (R, B - 1)
    unnormalized mass per interval. `det` uses jnp.linspace(0, 1) draws;
    otherwise `u` (R, num_samples), or the port's own draws when None.
    Returns (R, num_samples), detached (reference `train_utils.py:124`)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (R, B)

    if det:
        u = linspace01(num_samples, weights.dtype, weights.device)
        u = u.expand(cdf.shape[:-1] + (num_samples,))
    elif u is None:
        if ray_index is None:
            ray_index = torch.arange(cdf.shape[0], device=cdf.device)
        u = per_ray_uniform(seed, STREAM_PDF, ray_index, num_samples)
    u = u.contiguous()

    B = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=B - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    samples = bins_below + t * (bins_above - bins_below)
    return samples.detach()


def merge_sorted_zvals(z_vals: torch.Tensor, z_samples: torch.Tensor) -> torch.Tensor:
    """Sorted union of coarse z_vals and hierarchical z_samples per ray
    (reference `train_utils.py:126`)."""
    return torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
