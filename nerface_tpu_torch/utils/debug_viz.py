"""Debug visualization: dump high-density ray samples as a .ply point
cloud. A copy of `nerface_tpu/utils/debug_viz.py` whose inputs may be
tensors on any device (read back to the host here) or arrays; the
equivalent of `nerf_helpers.py:389-433` (`dump_rays`), the
reference's geometry-inspection tool (call sites commented at
`train_utils.py:79-80,144-147`). Vectorized numpy instead of the
reference's per-point Python loop; same ASCII PLY output.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or an array, as a host array."""
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def dump_rays(
    origins,
    points,
    radiance_field,
    path: str = "rays_small.ply",
    threshold: float = 0.9999996,
    stride: int = 100,
    include_origins: bool = False,
) -> int:
    """Write samples whose sigmoid(relu(σ)) exceeds `threshold` (the
    reference keeps every 100th of the first tenth; `stride` generalizes
    that decimation). Returns the number of points written."""
    points = _host(points)
    rf = _host(radiance_field)
    density = 1.0 / (1.0 + np.exp(-np.maximum(rf[..., 3], 0.0)))
    ray_idx, depth_idx = np.where(density > threshold)
    keep = np.arange(0, len(ray_idx) // 10, stride)
    ray_idx, depth_idx = ray_idx[keep], depth_idx[keep]

    xyz = points[ray_idx, depth_idx]
    rgb = np.clip(rf[ray_idx, depth_idx, :3] * 255.0, 0, 255).astype(np.int32)

    origins = _host(origins) if include_origins else np.zeros((0, 3))
    n_extra = len(origins)
    with open(path, "w") as fid:
        fid.write("ply\n")
        fid.write("format ascii 1.0\n")
        fid.write("element vertex %d\n" % (len(xyz) + n_extra))
        fid.write("property float x\n")
        fid.write("property float y\n")
        fid.write("property float z\n")
        fid.write("property uchar red\n")
        fid.write("property uchar green\n")
        fid.write("property uchar blue\n")
        fid.write("end_header\n")
        for p, c in zip(xyz, rgb):
            fid.write("%f %f %f %d %d %d\n" % (p[0], p[1], p[2], c[0], c[1], c[2]))
        for o in origins:
            fid.write("%f %f %f 0 255 0\n" % (o[0], o[1], o[2]))
    return len(xyz) + n_extra
