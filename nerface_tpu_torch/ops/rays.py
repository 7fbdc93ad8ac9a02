"""Ray generation from camera intrinsics and head-pose c2w transforms.

Port of `nerface_tpu/ops/rays.py` (reference `nerf_helpers.py`):
`get_ray_bundle` (:68-123), `get_ray_bundle_axis_angles` (:126-185, with
the Rodrigues formula for pytorch3d's `so3_exponential_map`), `ndc_rays`
(:252-281) and the numpy `ray_bundle_numpy`.

Convention: intrinsics is [fx, fy, cx, cy] with cx, cy *relative* in
[0, 1]; pixel (i=x/col, j=y/row) maps to the camera-frame direction
((i - W·cx)/fx, -(j - H·cy)/fy, -1), rotated by the camera-to-world
rotation. A scalar focal f means [f, f, 0.5, 0.5].
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
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


def rodrigues(axis_angle: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (3,) -> rotation matrix (3, 3) by the Rodrigues formula
    (the JAX package's stand-in for pytorch3d's `so3_exponential_map`,
    `nerf_helpers.py:177`). θ is regularised by `eps`, so the value and its
    gradient stay finite at θ = 0; below `eps` the first-order expansion is
    returned."""
    theta2 = torch.sum(axis_angle * axis_angle)
    theta = torch.sqrt(theta2 + eps)
    k = axis_angle / theta
    zero = torch.zeros_like(k[0])
    K = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta2 < eps, eye + K * theta, R)


def get_ray_bundle_axis_angles(
    height: int, width: int, intrinsics, tform_cam2world: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray bundle from a (2, 3) [axis-angle; translation] pose
    (`nerf_helpers.py:126-185`, pose-refinement scaffolding)."""
    pose = torch.as_tensor(tform_cam2world)
    directions = pixel_directions(height, width, intrinsics, pose.dtype, pose.device)
    rot = rodrigues(pose[0])
    ray_directions = torch.sum(directions[..., None, :] * rot, dim=-1)
    ray_origins = pose[1].expand(ray_directions.shape)
    return ray_origins, ray_directions


def ndc_rays(
    H: int,
    W: int,
    focal: Union[float, Sequence[float], torch.Tensor],
    near: float,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift rays to the near plane and project them to normalised device
    coordinates (`nerf_helpers.py:252-281`). `focal` is a scalar or
    [fx, fy]."""
    focal = torch.as_tensor(focal, dtype=rays_o.dtype, device=rays_o.device)
    fx, fy = (focal, focal) if focal.ndim == 0 else (focal[0], focal[1])
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * fx)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * fy)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * fx)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (H / (2.0 * fy)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def ray_bundle_numpy(height: int, width: int, intrinsics, tform_cam2world: np.ndarray):
    """Host-side (numpy) twin of `get_ray_bundle` for the data pipeline
    (copied from the JAX package's `ops/rays.py`)."""
    intr = np.asarray(intrinsics, np.float32)
    if intr.ndim == 0:
        intr = np.array([intr, intr, 0.5, 0.5], np.float32)
    ii, jj = np.meshgrid(
        np.arange(width, dtype=np.float32),
        np.arange(height, dtype=np.float32),
        indexing="xy",
    )
    directions = np.stack(
        [
            (ii - width * intr[2]) / intr[0],
            -(jj - height * intr[3]) / intr[1],
            -np.ones_like(ii),
        ],
        axis=-1,
    )
    tform = np.asarray(tform_cam2world, np.float32)
    ray_directions = directions @ tform[:3, :3].T
    ray_origins = np.broadcast_to(tform[:3, -1], ray_directions.shape)
    return ray_origins, ray_directions
