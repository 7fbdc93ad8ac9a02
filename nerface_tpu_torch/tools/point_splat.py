"""A copy of `nerface_tpu/tools/point_splat.py` on the port's tools.

Point-splatting synthetic renderer — the dataset-output contract of the
reference's `rendering/render_trimesh.py:74-353` (the last reference source
with no counterpart here), as a vectorized host tool.

What the reference does per camera pose: project the (normalized) mesh
vertices through a fixed homogeneous intrinsics matrix, round to pixels,
z-buffer them one Python loop iteration per point on the GPU
(`project_world_to_image_torch`, :197-267), and write

    <out>/depth/depth_%d.png          uint8 depth (|z| scaled to 0..255)
    <out>/<mode>/A/pose_%d.npy        (S, S, 4) = xyz coords ++ vert_ids
    <out>/<mode>/B/pose_%d.png        color render of the same pose
    <out>/poses_{train,test}.npy      the sampled camera positions

with train poses from a Fibonacci LATTICE and test poses from a SPIRAL
(`render_trimesh.py:372-390`). This module reproduces that contract with a
vectorized z-buffer (lexsort replaces the per-point loop, keeping the
reference's exact winner semantics: minimum z, earliest point on ties) and
the in-repo software rasterizer for the color "B" side (the reference uses
trimesh's GL preview; this image has no GL stack).

Kept reference conventions:
  * `lookAt` builds camToWorld row-wise then transposes
    (`render_trimesh.py:60-74`) — reproduced verbatim, including
    forward = normalize(cam - target) and tmp-up [0, 1, 0];
  * the homogeneous intrinsics `[[0, 200, S/2, 0], [-200, 0, S/2, 0],
    [0, 0, 1, 0]]` (:183-187) — note the axis swap + sign, which the splat
    path uses UNSCALED by anti_alias;
  * splat images index as [u, v] (projected x as the row — :240-260), so
    outputs are transposed relative to the color render, as released;
  * vert_ids are 1-based indices into the per-pose VISIBLE point list
    (:262 "shifting vid by one!! for DL pipeline");
  * depth: unset pixels 0, else |z| / max * 255 as uint8 (:264-267).

Deliberate divergences (cited, not silently fixed):
  * mesh scale: the reference divides by 2x the radius of trimesh's
    minimum bounding sphere (:125-127); we use Ritter's bounding sphere
    (deterministic two-pass approximation, within a few percent) — no
    trimesh in this image;
  * cam-space coords: the reference's `projected_points_cam_space
    [selection_mask_1]` lines at :244-245 are no-op expressions (results
    never assigned), so its `coords_space="cam"` output indexes the
    UNFILTERED array with filtered indices — garbage rows whenever any
    vertex was culled. We apply the masks for real.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def look_at_splat(cam_pos: np.ndarray, target: np.ndarray,
                  tmp: np.ndarray = np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """The reference's `lookAt` (`render_trimesh.py:55-74`), verbatim:
    rows [right, up, forward, cam] transposed into a c2w matrix."""
    def _n(v):
        return v / np.linalg.norm(v)

    forward = _n(np.asarray(cam_pos, float) - np.asarray(target, float))
    axis = _n(np.asarray(tmp, float))
    if np.linalg.norm(np.cross(axis, forward)) < 1e-8:
        # camera exactly along the up axis: the reference's lookAt emits a
        # NaN rotation here (0/0 in the normalize) and silently splats
        # nothing for that pose; pick a perpendicular fallback instead
        axis = np.array([1.0, 0.0, 0.0])
    right = _n(np.cross(axis, forward))
    up = _n(np.cross(forward, right))
    m = np.zeros((4, 4))
    m[0, :-1] = right
    m[1, :-1] = up
    m[2, :-1] = forward
    m[3, :-1] = cam_pos
    m[3, 3] = 1.0
    return m.T


def splat_intrinsics_hom(im_size: int) -> np.ndarray:
    """`camera_intrinsics_1_hom` (`render_trimesh.py:183-187`)."""
    return np.array([
        [0.0, 200.0, im_size / 2, 0.0],
        [-200.0, 0.0, im_size / 2, 0.0],
        [0.0, 0.0, 1.0, 0.0],
    ])


def ritter_bounding_sphere(points: np.ndarray) -> Tuple[np.ndarray, float]:
    """Deterministic enclosing sphere (Ritter 1990): pick the most distant
    pair along an axis sweep, then grow to cover stragglers."""
    p = np.asarray(points, float)
    x = p[0]
    y = p[np.argmax(np.sum((p - x) ** 2, axis=1))]
    z = p[np.argmax(np.sum((p - y) ** 2, axis=1))]
    center = 0.5 * (y + z)
    radius = 0.5 * float(np.linalg.norm(z - y))
    d = np.sqrt(np.sum((p - center) ** 2, axis=1))
    for i in np.nonzero(d > radius)[0]:
        dist = d[i]
        new_r = 0.5 * (radius + dist)
        center = center + (new_r - radius) / dist * (p[i] - center)
        radius = new_r
        d = np.sqrt(np.sum((p - center) ** 2, axis=1))
    return center, radius


def normalize_for_splat(vertices: np.ndarray) -> np.ndarray:
    """Center on the bounds centroid (trimesh `scene.centroid`) and scale
    by 1/(2·bounding-sphere radius) (`render_trimesh.py:120-127`)."""
    v = np.asarray(vertices, float)
    lo, hi = v.min(0), v.max(0)
    centered = v - 0.5 * (lo + hi)
    _, radius = ritter_bounding_sphere(centered)
    return centered / (2.0 * max(radius, 1e-12))


def project_and_splat(
    c2w: np.ndarray,
    intrinsics_hom: np.ndarray,
    verts: np.ndarray,
    im_size: int,
    coords_space: str = "world",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized `project_world_to_image_torch` (`render_trimesh.py:
    197-267`). Returns (depth_u8 (S,S), coords (S,S,3), vert_ids (S,S)).

    Winner per pixel: minimum z; ties go to the earliest point — exactly
    the reference's sequential `z < buffer` update, via a (z, index)
    lexsort instead of a Python loop over every projected point.
    """
    verts_hom = np.concatenate(
        [verts, np.ones((len(verts), 1))], axis=1
    )
    world2cam = np.linalg.inv(c2w)
    m = intrinsics_hom @ world2cam  # (3, 4)
    proj = (m @ verts_hom.T).T  # (N, 3): [u*z, v*z, z]
    cam_space = proj.copy()
    z = proj[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = np.rint(proj[:, :2] / z[:, None])
    mask = np.isfinite(uv).all(axis=1)
    mask &= (uv >= 0).all(axis=1) & (uv < im_size).all(axis=1)
    pix = uv[mask].astype(np.int64)
    zv = z[mask]
    src = (verts if coords_space == "world" else cam_space[:, :3])[mask]

    depth = np.zeros((im_size, im_size), float)
    coords = np.full((im_size, im_size, 3), -1.0)
    vert_ids = np.zeros((im_size, im_size), float)

    if len(zv):
        # reference indexes images as [u, v] (projected x = row)
        lin = pix[:, 0] * im_size + pix[:, 1]
        order = np.lexsort((np.arange(len(zv)), zv))  # z asc, index asc
        lin_sorted = lin[order]
        _, first = np.unique(lin_sorted, return_index=True)
        win = order[first]  # one winner per occupied pixel
        rows, cols = pix[win, 0], pix[win, 1]
        depth[rows, cols] = np.abs(zv[win])
        coords[rows, cols] = src[win]
        vert_ids[rows, cols] = win + 1.0  # 1-based visible-point id

    mx = depth.max()
    depth_u8 = (depth / mx * 255.0).astype(np.uint8) if mx > 0 else \
        depth.astype(np.uint8)
    return depth_u8, coords, vert_ids


def splat_dataset(
    mesh_path: str,
    outdir: str,
    n_views_train: int = 200,
    n_views_test: int = 200,
    im_size: int = 256,
    coords_space: str = "world",
    render_color: bool = False,
    focal: float = 300.0,
    log: bool = True,
) -> dict:
    """The reference `__main__` flow (`render_trimesh.py:353-391`):
    normalize the mesh, LATTICE train / SPIRAL test poses, splat every
    pose to `<mode>/A/pose_%d.npy` + `depth/depth_%d.png`, optionally
    render the color side to `<mode>/B/pose_%d.png` (software rasterizer
    in place of the reference's GL preview)."""
    from PIL import Image

    from nerface_tpu_torch.tools.mesh_dataset import (
        load_mesh,
        render_shaded,
        shade_vertices,
        vertex_normals,
    )
    from nerface_tpu_torch.tools.spherical_sampler import SphericalSampler

    verts_raw, faces = load_mesh(mesh_path)
    verts = normalize_for_splat(verts_raw)
    colors = (
        shade_vertices(verts, vertex_normals(verts, faces))
        if render_color else None
    )

    for sub in ("depth", "train/A", "train/B", "test/A", "test/B"):
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)

    intr_hom = splat_intrinsics_hom(im_size)
    counts = {}
    for mode, n, sampling in (("train", n_views_train, "LATTICE"),
                              ("test", n_views_test, "SPIRAL")):
        if n <= 0:
            counts[mode] = 0
            continue
        cams = SphericalSampler(n, sampling).points
        np.save(os.path.join(outdir, f"poses_{mode}.npy"), cams)
        for i, cam in enumerate(cams):
            c2w = look_at_splat(cam, np.zeros(3))
            depth_u8, coords, vids = project_and_splat(
                c2w, intr_hom, verts, im_size, coords_space=coords_space
            )
            # reference writes depth/ unsplit (test overwrites train ids)
            Image.fromarray(depth_u8).save(
                os.path.join(outdir, "depth", f"depth_{i}.png")
            )
            np.save(
                os.path.join(outdir, mode, "A", f"pose_{i}"),
                np.dstack((coords, vids)),
            )
            if render_color:
                img = render_shaded(
                    verts, faces, colors, c2w,
                    np.array([focal, focal, im_size / 2, im_size / 2]),
                    im_size, im_size,
                )
                Image.fromarray((img * 255).astype(np.uint8)).save(
                    os.path.join(outdir, mode, "B", f"pose_{i}.png")
                )
        counts[mode] = int(n)
        if log:
            print(f"[splat] {mode}: {n} poses -> {outdir}/{mode}/A")
    return counts
