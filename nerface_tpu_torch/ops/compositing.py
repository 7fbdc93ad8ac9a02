"""Alpha compositing of a sampled radiance field along rays.

Port of `nerface_tpu/ops/compositing.py` (reference
`volume_rendering_utils.py:7-75`), with its background-prior semantics:

* with a `background_prior`, the *last* sample's RGB is the raw
  (pre-sigmoid) background pixel; every other sample's RGB is sigmoided;
* the last sample's sigma gets +1e-6 unconditionally;
* returns (rgb, disp, acc, weights, depth-or-None).

σ-noise takes its normals as an argument (`noise`), like every draw in
the port (see ops/sampling.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from nerface_tpu_torch.ops.math import cumprod_exclusive


def volume_render_radiance_field(
    radiance_field: torch.Tensor,
    depth_values: torch.Tensor,
    ray_directions: torch.Tensor,
    radiance_field_noise_std: float = 0.0,
    white_background: bool = False,
    background_prior: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    return_depth: bool = False,
):
    """Composite (R, S, 4) radiance into per-ray maps. `noise` (R, S)
    standard normals are required when `radiance_field_noise_std` > 0."""
    dists = torch.cat(
        [
            depth_values[..., 1:] - depth_values[..., :-1],
            torch.full_like(depth_values[..., :1], 1e10),
        ],
        dim=-1,
    )
    dists = dists * torch.linalg.norm(ray_directions, dim=-1)[..., None]

    if background_prior is not None:
        rgb = torch.sigmoid(radiance_field[:, :-1, :3])
        rgb = torch.cat([rgb, radiance_field[:, -1:, :3]], dim=1)
    else:
        rgb = torch.sigmoid(radiance_field[..., :3])

    sigma = radiance_field[..., 3]
    if radiance_field_noise_std > 0.0:
        if noise is None:
            raise ValueError("radiance_field_noise_std > 0 requires noise")
        sigma = sigma + noise * radiance_field_noise_std
    sigma_a = torch.relu(sigma)
    # Unconditional epsilon on the last sample (`volume_rendering_utils.py:53`).
    sigma_a = torch.cat([sigma_a[..., :-1], sigma_a[..., -1:] + 1e-6], dim=-1)

    alpha = 1.0 - torch.exp(-sigma_a * dists)
    # 1 − α + 1e-10 ≥ 1e-10: no zero
    weights = alpha * cumprod_exclusive(1.0 - alpha + 1e-10)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * depth_values, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)

    if white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    return rgb_map, disp_map, acc_map, weights, (depth_map if return_depth else None)


def inject_background(
    radiance_field: torch.Tensor, background_prior: Optional[torch.Tensor]
) -> torch.Tensor:
    """Overwrite the last sample's RGB with the background pixel
    (`train_utils.py:95-96,141-142`); returns a new tensor."""
    if background_prior is None:
        return radiance_field
    out = radiance_field.clone()
    out[:, -1, :3] = background_prior
    return out
