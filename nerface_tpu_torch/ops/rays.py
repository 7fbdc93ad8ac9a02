"""Ray generation from camera intrinsics and head-pose c2w transforms.

Port of `get_ray_bundle` from `nerface_tpu/ops/rays.py` (reference
`nerf_helpers.py:68-123`). Convention: intrinsics is [fx, fy, cx, cy] with
cx, cy *relative* in [0, 1]; pixel (i=x/col, j=y/row) maps to the
camera-frame direction ((i - W·cx)/fx, -(j - H·cy)/fy, -1), rotated by the
camera-to-world rotation. A scalar focal f means [f, f, 0.5, 0.5].
"""

from __future__ import annotations

from typing import Tuple

import torch

from nerface_tpu_torch.ops.math import meshgrid_xy


def _normalize_intrinsics(intrinsics, dtype, device) -> torch.Tensor:
    intrinsics = torch.as_tensor(intrinsics, dtype=dtype, device=device)
    if intrinsics.ndim == 0:
        half = torch.tensor(0.5, dtype=dtype, device=device)
        intrinsics = torch.stack([intrinsics, intrinsics, half, half])
    return intrinsics


def pixel_directions(
    height: int, width: int, intrinsics, dtype=torch.float32, device=None
) -> torch.Tensor:
    """Camera-frame direction for every pixel: (H, W, 3)."""
    intr = _normalize_intrinsics(intrinsics, dtype, device)
    ii, jj = meshgrid_xy(
        torch.arange(width, dtype=dtype, device=device),
        torch.arange(height, dtype=dtype, device=device),
    )
    return torch.stack(
        [
            (ii - width * intr[2]) / intr[0],
            -(jj - height * intr[3]) / intr[1],
            -torch.ones_like(ii),
        ],
        dim=-1,
    )


def get_ray_bundle(
    height: int, width: int, intrinsics, tform_cam2world: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ray per pixel: origins (H, W, 3), directions (H, W, 3), on the
    pose's device. Directions are *not* normalized (reference behavior;
    the renderer scales dists by ||rd|| instead)."""
    c2w = torch.as_tensor(tform_cam2world)
    directions = pixel_directions(height, width, intrinsics, c2w.dtype, c2w.device)
    ray_directions = torch.sum(directions[..., None, :] * c2w[:3, :3], dim=-1)
    ray_origins = c2w[:3, -1].expand(ray_directions.shape)
    return ray_origins, ray_directions
