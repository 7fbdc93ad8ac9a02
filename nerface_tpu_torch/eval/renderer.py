"""Full-frame rendering: the eval/serving path.

Port of `nerface_tpu/eval/renderer.py`.

The parity renderer (`_render_frame_jit`): the frame's H·W rays are padded
to whole tiles of `tile` rays (default `settings.chunksize`, the
reference's validation chunk of 65536) and rendered tile by tile (in bf16,
each pass of a paper-family tile is one fused-render kernel launch, K2,
which only this renderer enables: eval is never differentiated); each
ray's draws are keyed by its global index, so the frame does not depend on
the tile size.

The fast renderer (`_render_frame_fast_jit`), with `settings.fast_eval` and
a pixel bbox and/or an occupancy grid (`eval/occupancy.py`): only the
active rays run the radiance field. With JAX's capacity semantics, so that
the frames agree pixel for pixel: a stable argsort puts the active rays
first in raster order, wrapped cyclically to a fixed capacity of
`fast_eval_capacity`·H·W rays rounded up to whole tiles of at most 16384;
those rays render as usual (spare slots render real rays), and the results
are scattered over the background defaults. Active rays beyond the capacity
fall back to the background.

Sharding (`devices`, JAX's `mesh`: `_render_frame_sharded` and
`_render_frame_fast_sharded`, :270-345, :441-514): the ray axis (or the
fast path's capacity) is padded to whole tiles on every device, with JAX's
rules — the tile cut to ⌈n / n_dev⌉ on the parity path, the capacity
rounded to tile·n_dev on the fast path — and cut into one block a device.
Each block carries its rays' global indices, so its draws are the
one-device frame's; its tiles are launched on its device (asynchronously
on a card) through a replica of the models kept on that device, and the
blocks are gathered on the first device. With the same tiles the sharded
frame is the one-device frame bit for bit. A list may repeat a device,
which drives the split and the gather on one card or the CPU.

With `settings.no_ndc` false (the stock LLFF configs) the parity renderer
projects the frame's rays to NDC, with near / far 0 / 1, before tiling
them (`nerface_tpu/eval/renderer.py:51-60`); the fast renderer keeps the
JAX package's gate and takes no such frame.
"""

from __future__ import annotations

import copy
import dataclasses
import weakref
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nerface_tpu_torch.eval.occupancy import (
    ray_occupancy_mask,
    ray_occupancy_mask_blocked,
    ray_occupancy_mask_splat,
)
from nerface_tpu_torch.ops.rays import get_ray_bundle, ndc_rays
from nerface_tpu_torch.render.pipeline import RenderSettings, render_rays

# the fast path's largest tile: small tiles round the capacity tighter
# (a 65536-ray tile would pad a 0.35 capacity to 0.5 of a 512² frame)
FAST_TILE = 16384


def _pad_rows(x: torch.Tensor, n_pad: int, fill: float) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, n_pad - x.shape[0]), value=fill).contiguous()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _active_mask(ro, rd, height, width, bbox, occupancy, settings, pose=None, intrinsics=None):
    """(H·W,) bool: the rays that run the radiance field on the fast path,
    inside the pixel bbox [h0, h1, w0, w1] (inclusive) AND touching an
    occupied voxel, either test alone when the other is absent. A grid with
    splat boxes uses the projection-splat mask, a bare grid per-ray (or
    blocked) probing."""
    n = height * width
    dev = ro.device
    inside = torch.ones(n, dtype=torch.bool, device=dev)
    if bbox is not None:
        h0, h1, w0, w1 = (int(v) for v in np.asarray(bbox).reshape(4))
        k = torch.arange(n, device=dev)
        ii, jj = k // width, k % width
        inside = (ii >= h0) & (ii <= h1) & (jj >= w0) & (jj <= w1)
    if occupancy is not None:
        b = settings.occupancy_block
        if occupancy.boxes_lo is not None and pose is not None:
            inside = inside & ray_occupancy_mask_splat(occupancy, pose, intrinsics, height, width)
        elif b > 1 and height % b == 0 and width % b == 0:
            inside = inside & ray_occupancy_mask_blocked(
                occupancy, ro, rd, height, width, settings.near, settings.far,
                settings.occupancy_probes, b,
            )
        else:
            inside = inside & ray_occupancy_mask(
                occupancy, ro, rd, settings.near, settings.far, settings.occupancy_probes
            )
    return inside


def _render_tiles(model_coarse, model_fine, ro, rd, idx, bg, abl, tile, settings, **kw):
    """render_rays over consecutive tiles of the given rays (global ray
    indices `idx`); the per-ray maps concatenated, per-sample weights
    dropped (8.6 GB for a 512² frame at 128 samples)."""
    # eval is never differentiated: the forward-only fused render may run
    # (`nerface_tpu/eval/renderer.py:83-87`)
    settings = dataclasses.replace(settings, fused_render=True)
    tiles = []
    for t0 in range(0, ro.shape[0], tile):
        sl = slice(t0, t0 + tile)
        out = render_rays(
            model_coarse, model_fine, ro[sl], rd[sl], settings,
            background_prior=bg[sl] if bg is not None else None,
            ray_directions_ablation=abl[sl] if abl is not None else None,
            ray_index=idx[sl], **kw,
        )
        out.pop("weights")
        tiles.append({k: v for k, v in out.items() if v is not None})
    return {k: torch.cat([t[k] for t in tiles]) for k in tiles[0]}


# model → {device: (the weights' storage and versions, the replica)}
_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _replica(model, device: torch.device):
    """`model` on `device`: the model itself where it lives there, else a
    copy made once and kept while its weights are unchanged."""
    if model is None or next(model.parameters()).device == device:
        return model
    key = tuple((p.data_ptr(), p._version) for p in model.parameters())
    per = _REPLICAS.setdefault(model, {})
    hit = per.get(device)
    if hit is None or hit[0] != key:
        cache = model.__dict__.pop("_kernel_weights_cache", None)
        try:
            rep = copy.deepcopy(model)
        finally:
            if cache is not None:
                model._kernel_weights_cache = cache
        per[device] = hit = (key, rep.to(device).requires_grad_(False))
    return hit[1]


def _on(x, device):
    return x.to(device, non_blocking=True) if isinstance(x, torch.Tensor) else x


def _render_blocks(model_coarse, model_fine, ro, rd, idx, bg, abl, tile, settings, devices,
                   **kw):
    """`_render_tiles` over one equal block of the rays a device, block d
    on `devices[d]` (its launches queued there before the next block's),
    gathered on `devices[0]`."""
    if len(devices) == 1:
        return _render_tiles(model_coarse, model_fine, ro, rd, idx, bg, abl, tile, settings,
                             **kw)
    per = ro.shape[0] // len(devices)
    blocks = []
    for d, dev in enumerate(devices):
        sl = slice(d * per, (d + 1) * per)
        blocks.append(_render_tiles(
            _replica(model_coarse, dev), _replica(model_fine, dev), _on(ro[sl], dev),
            _on(rd[sl], dev), _on(idx[sl], dev), _on(bg[sl], dev) if bg is not None else None,
            _on(abl[sl], dev) if abl is not None else None, tile, settings,
            **{k: _on(v, dev) for k, v in kw.items()},
        ))
    first = devices[0]
    return {k: torch.cat([_on(b[k], first) for b in blocks]) for k in blocks[0]}


def _render_frame_fast(model_coarse, model_fine, height, width, intrinsics, pose, settings,
                       background, bbox, occupancy, tile, devices, **kw):
    n = height * width
    n_dev = len(devices)
    tile = min(tile, FAST_TILE)
    # the capacity in whole tiles on every device (`renderer.py:284-290`)
    cap = _round_up(max(1, int(n * float(settings.fast_eval_capacity))), tile * n_dev)
    cap = min(cap, _round_up(n, tile * n_dev))
    ro, rd = get_ray_bundle(height, width, intrinsics, pose)
    ro, rd = ro.reshape(n, 3), rd.reshape(n, 3)
    inside = _active_mask(ro, rd, height, width, bbox, occupancy, settings, pose=pose,
                          intrinsics=intrinsics)
    # active rays first in raster order, wrapped cyclically to `cap` (cap
    # may pass n once rounded up to whole tiles): a ray twice renders the
    # same twice, its draws keyed by its global index
    order = torch.argsort((~inside).to(torch.int32), stable=True)
    act = order.repeat(-(-cap // n))[:cap]
    maps = _render_blocks(
        model_coarse, model_fine, ro[act], rd[act], act,
        background[act] if background is not None else None, None, tile, settings, devices,
        **kw,
    )
    # the skipped rays' defaults: the background sample absorbs all the
    # transmittance (acc and bg_weight 1, depth at the far plane)
    have_bg = background is not None
    far = torch.tensor(settings.far, dtype=torch.float32, device=ro.device)
    out = {}
    for k, v in maps.items():
        if k.startswith("rgb"):
            full = (background.clone() if have_bg else
                    torch.full((n, 3), 1.0 if settings.white_background else 0.0, device=ro.device))
        elif k.startswith("disp"):
            full = (1.0 / torch.clamp(far, min=1e-10)).expand(n).clone()
        elif k.startswith("depth"):
            full = far.expand(n).clone()
        else:  # acc_* and bg_weight
            full = torch.full((n,), 1.0 if have_bg else 0.0, device=ro.device)
        full = full.to(v.dtype)
        full[act] = v
        out[k] = full.reshape(height, width, *v.shape[1:])
    return out


@torch.no_grad()
def render_full_frame(
    model_coarse,
    model_fine,
    height: int,
    width: int,
    intrinsics,
    pose,
    settings: RenderSettings,
    seed: int = 0,
    expressions: Optional[torch.Tensor] = None,
    latent_code: Optional[torch.Tensor] = None,
    background: Optional[torch.Tensor] = None,
    ray_directions_ablation: Optional[torch.Tensor] = None,
    tile: Optional[int] = None,
    dtype=None,
    device=None,
    bbox=None,
    occupancy=None,
    devices: Optional[Sequence] = None,
) -> Dict[str, torch.Tensor]:
    """Render one frame on `device` (default: the coarse model's); returns
    image-shaped maps (rgb_coarse/rgb_fine (H, W, 3); disp/acc/depth and
    bg_weight (H, W)). `pose` is the (3, 4) or (4, 4) camera-to-world
    transform; `background` is (H, W, 3) or flat.

    With `settings.fast_eval` and a pixel `bbox` [h0, h1, w0, w1] and/or an
    `occupancy` grid, only the active rays run the radiance field (the JAX
    package's gate: no direction ablation, `no_ndc`).

    With `devices` (JAX's `mesh`) the frame's rays are sharded over them,
    one block a device (the module docstring); the maps land on
    `devices[0]`, where the inputs live."""
    if devices:
        devices = [torch.device(d) for d in devices]
        device = devices[0]
    if device is None:
        device = next(model_coarse.parameters()).device
    devices = devices or [torch.device(device)]
    tile = min(int(tile or settings.chunksize), height * width)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    n = height * width
    bg = background.reshape(n, 3) if background is not None else None
    kw = dict(seed=seed, expressions=expressions, latent_code=latent_code, dtype=dtype)
    if (settings.fast_eval and (bbox is not None or occupancy is not None)
            and ray_directions_ablation is None and settings.no_ndc):
        return _render_frame_fast(model_coarse, model_fine, height, width, intrinsics, pose,
                                  settings, bg, bbox, occupancy, tile, devices, **kw)

    ro, rd = get_ray_bundle(height, width, intrinsics, pose)
    if not settings.no_ndc:
        # the LLFF path: rays projected to NDC, near / far 0 / 1
        # (`train_utils.py:198-207`)
        focal = torch.as_tensor(intrinsics, dtype=torch.float32, device=ro.device)[:2]
        ro, rd = ndc_rays(height, width, focal, 1.0, ro.reshape(n, 3), rd.reshape(n, 3))
        settings = dataclasses.replace(settings, no_ndc=True, near=0.0, far=1.0)
    # whole tiles on every device (`renderer.py:453-456`)
    n_dev = len(devices)
    tile = min(tile, _round_up(n, n_dev) // n_dev)
    n_pad = _round_up(n, tile * n_dev)
    ro = _pad_rows(ro.reshape(n, 3), n_pad, 0.0)
    rd = _pad_rows(rd.reshape(n, 3), n_pad, 1.0)
    bg = _pad_rows(bg, n_pad, 0.0) if bg is not None else None
    abl = (
        _pad_rows(ray_directions_ablation.reshape(n, 3), n_pad, 1.0)
        if ray_directions_ablation is not None else None
    )
    idx = torch.arange(n_pad, device=ro.device)
    maps = _render_blocks(model_coarse, model_fine, ro, rd, idx, bg, abl, tile, settings, devices,
                          **kw)
    return {k: v[:n].reshape(height, width, *v.shape[1:]) for k, v in maps.items()}
