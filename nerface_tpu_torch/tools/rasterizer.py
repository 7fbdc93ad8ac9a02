"""Minimal software triangle rasterizer (numpy, no GL): a copy of
`nerface_tpu/tools/rasterizer.py`, host code in both packages. The
visibility scatter-min stays numpy's on uint64 keys: torch has no CPU
uint64 min-scatter, and a float key would break depth ties differently.


Replaces the reference's pyrender EGL offscreen renders
(`real_to_nerf.py:125-197`): the rasterized mean-face mask that feeds
`find_bbox` (:204-238) and the debug camera-overlay frames (:1520-1543,
1132-1135). The camera model is pyrender's (OpenGL convention: camera
looks down -z, y up, IntrinsicsCamera fx/fy/cx/cy).

Design: no GL stack and no per-pixel Python. Triangles are projected in
bulk; each triangle rasterizes into a fixed KxK local window around its
integer bbox with vectorized edge functions (the mean face's ~106k
triangles are 1-2 px each at 512x512), and a z-buffer scatter
(np.minimum.at on flattened pixel ids) resolves visibility. The rare
triangles larger than the window fall back to a per-triangle fill.

For bbox parity the mathematical fact is stronger than the renderer:
perspective projection maps triangles to triangles, so the silhouette's
bbox equals the bbox of the projected VERTICES up to pixel discretization
and clipping. `tools/dataset_builder.mesh_bbox` exploits exactly that;
tests/test_rasterizer.py pins the delta between the two pipelines.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_off_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) f64, faces (F, 3) i64) of an OFF mesh; polygon
    faces are fan-triangulated."""
    with open(path) as f:
        tokens = []
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                tokens.extend(line.split())
    if tokens[0] != "OFF":
        raise ValueError(f"{path}: not an OFF file")
    n_verts, n_faces = int(tokens[1]), int(tokens[2])
    i = 4
    verts = np.array(tokens[i:i + 3 * n_verts], np.float64).reshape(n_verts, 3)
    i += 3 * n_verts
    faces = []
    for _ in range(n_faces):
        k = int(tokens[i])
        poly = [int(t) for t in tokens[i + 1:i + 1 + k]]
        i += 1 + k
        for j in range(1, k - 1):  # fan triangulation
            faces.append((poly[0], poly[j], poly[j + 1]))
    return verts, np.asarray(faces, np.int64)


def project_vertices(
    vertices: np.ndarray,
    pose: np.ndarray,
    intrinsics: np.ndarray,
    scale: float = 1.0,
    mesh_unit_scale: float = 1e-6,
):
    """Project world-space mesh vertices with the reference camera model.
    Returns (u, v, depth) with depth > 0 in front of the camera."""
    v = vertices * (mesh_unit_scale * scale)
    w2c = np.linalg.inv(np.asarray(pose, np.float64))
    v_cam = v @ w2c[:3, :3].T + w2c[:3, 3]
    z = -v_cam[:, 2]  # OpenGL camera looks down -z
    fx, fy, cx, cy = np.asarray(intrinsics[:4], np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fx * v_cam[:, 0] / z + cx
        vv = -fy * v_cam[:, 1] / z + cy
    return u, vv, z


def rasterize_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    pose: np.ndarray,
    intrinsics: np.ndarray,
    H: int = 512,
    W: int = 512,
    scale: float = 1.0,
    mesh_unit_scale: float = 1e-6,
    near: float = 0.01,
    window: int = 8,
    chunk: int = 16384,
) -> Tuple[np.ndarray, np.ndarray]:
    """Z-buffered rasterization. Returns (depth (H, W) f32 with +inf on
    background, mask (H, W) bool)."""
    depth, mask, _ = rasterize_mesh_ids(
        vertices, faces, pose, intrinsics, H, W, scale, mesh_unit_scale,
        near, window, chunk,
    )
    return depth, mask


def rasterize_mesh_ids(
    vertices: np.ndarray,
    faces: np.ndarray,
    pose: np.ndarray,
    intrinsics: np.ndarray,
    H: int = 512,
    W: int = 512,
    scale: float = 1.0,
    mesh_unit_scale: float = 1e-6,
    near: float = 0.01,
    window: int = 8,
    chunk: int = 16384,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Z-buffered rasterization that also resolves WHICH triangle owns
    each pixel. Returns (depth (H, W) f32 +inf on background, mask (H, W)
    bool, face_id (H, W) i64 with -1 on background).

    One scatter-min resolves depth and owner together: positive-f32
    depth bits are order-preserving as uint32, so the 64-bit key
    (depth_bits << 32) | face_index min-reduces to the nearest triangle
    (ties broken toward the lower face index, deterministically). The
    face ids feed Gouraud shading in `tools/mesh_dataset.py` — the
    pyrender_data.py offscreen-render replacement."""
    u, v, z = project_vertices(vertices, pose, intrinsics, scale, mesh_unit_scale)
    sentinel = np.uint64(0xFFFFFFFFFFFFFFFF)
    buf = np.full((H + 1) * (W + 1), sentinel, np.uint64)  # +1: clip slab

    tri_ok = (z[faces] > near).all(axis=1)
    fid_all = np.flatnonzero(tri_ok).astype(np.uint64)
    faces = faces[tri_ok]

    ux, vx, zx = u[faces], v[faces], z[faces]  # (F, 3)
    # integer bboxes (pixel centers at integer coords)
    x0 = np.maximum(np.ceil(ux.min(1) - 0.5), 0).astype(np.int64)
    x1 = np.minimum(np.floor(ux.max(1) + 0.5), W - 1).astype(np.int64)
    y0 = np.maximum(np.ceil(vx.min(1) - 0.5), 0).astype(np.int64)
    y1 = np.minimum(np.floor(vx.max(1) + 0.5), H - 1).astype(np.int64)
    wide = (x1 - x0 >= window) | (y1 - y0 >= window)
    onscreen = (x1 >= x0) & (y1 >= y0)

    def fill(ux, vx, zx, fid, px, py, inside_extra=None):
        """Edge-function coverage + barycentric depth at pixel centers
        (px, py); scatter-min of (depth_bits << 32 | face_id) keys."""
        e01 = (ux[:, 1] - ux[:, 0])[:, None] * (py - vx[:, 0][:, None]) - (
            vx[:, 1] - vx[:, 0]
        )[:, None] * (px - ux[:, 0][:, None])
        e12 = (ux[:, 2] - ux[:, 1])[:, None] * (py - vx[:, 1][:, None]) - (
            vx[:, 2] - vx[:, 1]
        )[:, None] * (px - ux[:, 1][:, None])
        e20 = (ux[:, 0] - ux[:, 2])[:, None] * (py - vx[:, 2][:, None]) - (
            vx[:, 0] - vx[:, 2]
        )[:, None] * (px - ux[:, 2][:, None])
        area = (
            (ux[:, 1] - ux[:, 0]) * (vx[:, 2] - vx[:, 0])
            - (vx[:, 1] - vx[:, 0]) * (ux[:, 2] - ux[:, 0])
        )[:, None]
        inside = ((e01 >= 0) & (e12 >= 0) & (e20 >= 0)) | (
            (e01 <= 0) & (e12 <= 0) & (e20 <= 0)
        )
        inside &= np.abs(area) > 1e-12
        if inside_extra is not None:
            inside &= inside_extra
        with np.errstate(divide="ignore", invalid="ignore"):
            w0 = e12 / area
            w1 = e20 / area
            w2 = e01 / area
        zpix = (
            w0 * zx[:, 0][:, None] + w1 * zx[:, 1][:, None]
            + w2 * zx[:, 2][:, None]
        )
        ids = (py.astype(np.int64) * (W + 1) + px.astype(np.int64))
        ids = np.where(inside, ids, H * (W + 1) + W)  # clip slab cell
        zbits = (
            np.where(inside, zpix, np.inf)
            .astype(np.float32)
            .view(np.uint32)
            .astype(np.uint64)
        )
        key = (zbits << np.uint64(32)) | fid[:, None]
        np.minimum.at(buf, ids.ravel(), key.ravel())

    # vectorized path: KxK local windows
    small = onscreen & ~wide
    k = window
    dy, dx = np.mgrid[0:k, 0:k]
    for s in range(0, int(small.sum()), chunk):
        idx = np.flatnonzero(small)[s:s + chunk]
        px = x0[idx][:, None] + dx.ravel()[None, :]
        py = y0[idx][:, None] + dy.ravel()[None, :]
        ok = (px <= x1[idx][:, None]) & (py <= y1[idx][:, None])
        fill(ux[idx], vx[idx], zx[idx], fid_all[idx],
             px.astype(np.float64), py.astype(np.float64), ok)

    # fallback: big triangles, one at a time
    for idx in np.flatnonzero(onscreen & wide):
        gx, gy = np.meshgrid(
            np.arange(x0[idx], x1[idx] + 1, dtype=np.float64),
            np.arange(y0[idx], y1[idx] + 1, dtype=np.float64),
        )
        fill(
            ux[idx:idx + 1], vx[idx:idx + 1], zx[idx:idx + 1],
            fid_all[idx:idx + 1],
            gx.ravel()[None, :], gy.ravel()[None, :],
        )

    buf = buf.reshape(H + 1, W + 1)[:H, :W]
    depth = (buf >> np.uint64(32)).astype(np.uint32).view(np.float32)
    mask = np.isfinite(depth)  # untouched cells unpack to NaN (sentinel)
    depth = np.where(mask, depth, np.float32(np.inf))  # contract: +inf bg
    face_id = np.where(mask, (buf & np.uint64(0xFFFFFFFF)).astype(np.int64), -1)
    return depth, mask, face_id


def render_mask_image(
    vertices: np.ndarray,
    faces: np.ndarray,
    pose: np.ndarray,
    intrinsics: np.ndarray,
    H: int = 512,
    W: int = 512,
    scale: float = 1.0,
    light_dir: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The reference's debug render as consumed by `find_bbox`: white
    background, the head shaded non-white (`real_to_nerf.py:125-197` —
    exact shading is irrelevant to every consumer, which thresholds
    `im[..., 0] < 255`). Depth-shaded for useful visual inspection."""
    depth, mask = rasterize_mesh(
        vertices, faces, pose, intrinsics, H, W, scale
    )
    img = np.full((H, W, 3), 255, np.uint8)
    if mask.any():
        d = depth[mask]
        lo, hi = float(d.min()), float(max(d.max(), d.min() + 1e-9))
        shade = (80 + 140 * (d - lo) / (hi - lo)).astype(np.uint8)
        img[mask] = np.stack([shade, (shade * 0.8).astype(np.uint8),
                              (shade * 0.75).astype(np.uint8)], axis=-1)
    return img


def render_debug_camera_matrix(
    pose: np.ndarray,
    intrinsics: np.ndarray,
    scale: float = 1.0,
    mesh_path: str = "average.off",
    H: int = 512,
    W: int = 512,
) -> np.ndarray:
    """Drop-in for the reference's pyrender debug view of the mean face
    under a candidate camera matrix (`real_to_nerf.py:125-197`)."""
    verts, faces = load_off_mesh(mesh_path)
    return render_mask_image(verts, faces, pose, intrinsics, H, W, scale)
