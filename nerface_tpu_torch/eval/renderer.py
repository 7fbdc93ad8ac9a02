"""Full-frame rendering: the eval/serving path.

Port of the single-device parity renderer of `nerface_tpu/eval/renderer.py`
(`_render_frame_jit`): the frame's H·W rays are padded to whole tiles of
`tile` rays (default `settings.chunksize`, the reference's validation
chunk of 65536) and rendered tile by tile (in bf16, each pass of a
paper-family tile is one fused-render kernel launch, K2, which only this
renderer enables: eval is never differentiated);
each ray's draws are keyed by its global index, so the frame does not
depend on the tile size. Fast-eval (bbox / occupancy ray skipping) and
mesh sharding are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nerface_tpu_torch.ops.rays import get_ray_bundle
from nerface_tpu_torch.render.pipeline import RenderSettings, render_rays


def _pad_rows(x: torch.Tensor, n_pad: int, fill: float) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, n_pad - x.shape[0]), value=fill).contiguous()


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
) -> Dict[str, torch.Tensor]:
    """Render one frame on `device`; returns image-shaped maps
    (rgb_coarse/rgb_fine (H, W, 3); disp/acc/depth and bg_weight (H, W)).
    `pose` is the (3, 4) or (4, 4) camera-to-world transform; `background`
    is (H, W, 3) or flat."""
    tile = min(int(tile or settings.chunksize), height * width)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    ro, rd = get_ray_bundle(height, width, intrinsics, pose)
    n = height * width
    n_pad = -(-n // tile) * tile
    ro = _pad_rows(ro.reshape(n, 3), n_pad, 0.0)
    rd = _pad_rows(rd.reshape(n, 3), n_pad, 1.0)
    bg = _pad_rows(background.reshape(n, 3), n_pad, 0.0) if background is not None else None
    abl = (
        _pad_rows(ray_directions_ablation.reshape(n, 3), n_pad, 1.0)
        if ray_directions_ablation is not None else None
    )
    idx = torch.arange(n_pad, device=ro.device)
    # eval is never differentiated: the forward-only fused render may run
    # (`nerface_tpu/eval/renderer.py:83-87`)
    settings = dataclasses.replace(settings, fused_render=True)

    tiles = []
    for t0 in range(0, n_pad, tile):
        sl = slice(t0, t0 + tile)
        out = render_rays(
            model_coarse, model_fine, ro[sl], rd[sl], settings, seed=seed,
            expressions=expressions, latent_code=latent_code,
            background_prior=bg[sl] if bg is not None else None,
            ray_directions_ablation=abl[sl] if abl is not None else None,
            dtype=dtype, ray_index=idx[sl],
        )
        # per-sample weights of a whole frame are not kept (8.6 GB at 512²×128)
        out.pop("weights")
        tiles.append({k: v for k, v in out.items() if v is not None})

    return {
        k: torch.cat([t[k] for t in tiles])[:n].reshape(height, width, *tiles[0][k].shape[1:])
        for k in tiles[0]
    }
