"""Normal maps from rendered depth/disparity.

Port of `nerface_tpu/eval/normals.py` (reference
`eval_transformed_rays.py:84-119`, `torch_normal_map`): backproject each
pixel with the intrinsics, take forward differences, cross them for the
surface normal, then optionally "clean" with the background weights
(mask > 0.22 -> white, then blend toward white by the mask). The reference
feeds the *disparity* map as `depthmap` (:469); so does the server.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerface_tpu_torch.ops.math import meshgrid_xy


def normal_map_from_depth(
    depthmap: torch.Tensor,
    intrinsics,
    weights: Optional[torch.Tensor] = None,
    clean: bool = True,
    central_difference: bool = False,
) -> torch.Tensor:
    """depthmap: (H, W); intrinsics: [fx, fy, cx, cy] (cx, cy relative).
    Returns (H-d, W-d, 3) normals scaled to 0..255 (float)."""
    H, W = depthmap.shape
    intr = torch.as_tensor(intrinsics, dtype=depthmap.dtype, device=depthmap.device)
    fx, fy, cx, cy = intr[0], intr[1], intr[2] * W, intr[3] * H
    ii, jj = meshgrid_xy(
        torch.arange(W, dtype=depthmap.dtype, device=depthmap.device),
        torch.arange(H, dtype=depthmap.dtype, device=depthmap.device),
    )
    points = torch.stack(
        [((ii - cx) * depthmap) / fx, -((jj - cy) * depthmap) / fy, depthmap], dim=-1
    )
    d = 2 if central_difference else 1
    dx = points[d:, :, :] - points[:-d, :, :]
    dy = points[:, d:, :] - points[:, :-d, :]
    normals = torch.linalg.cross(dy[:-d, :, :], dx[:, :-d, :], dim=-1)
    norm = torch.sqrt(torch.sum(normals * normals, dim=2, keepdim=True))
    normals = normals / torch.clamp(norm, min=1e-12)
    normals = normals * 0.5 + 0.5

    if clean and weights is not None:
        mask = weights[..., None].expand(*weights.shape, 3)[:-d, :-d]
        normals = torch.where(mask > 0.22, torch.ones_like(normals), normals)
        normals = (1.0 - mask) * normals + mask * torch.ones_like(normals)
    return normals * 255.0
