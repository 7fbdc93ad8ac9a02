"""Synthetic blender-format dataset from a mesh file — GL-free. A copy of
`nerface_tpu/tools/mesh_dataset.py` on the port's rasterizer and sampler.


The replacement for the reference's offscreen pyrender data
generator (`rendering/pyrender_data.py:1-268`): load a mesh, normalize it
into the unit-ish box, sample camera viewpoints on the sphere, shade and
rasterize each view with the software rasterizer (tools/rasterizer.py),
and write `transforms_{train,val,test}.json` + PNGs in the blender schema
consumed by `data/blender.py` (and by the reference's own blender loader).

Deliberate deviations from pyrender_data.py, documented:
* Shading is Gouraud-interpolated Lambertian (ambient + N point lights)
  instead of pyrender's GL spot-light pipeline — the generator's purpose
  is geometry-consistent, view-independent training images for NeRF
  experiments; exact radiometry is irrelevant and no GL stack exists in
  this image.
* The reference's `lookAt` builds camToWorld rows then transposes and
  later flips the z column per view (`pyrender_data.py:41-57,110-117`);
  here the camera-to-world frame is constructed directly in the
  blender/OpenGL convention (camera looks down -z, y up) that
  `data/blender.py` and the rasterizer's `project_vertices` share.
* Splits follow the reference: RANDOM sphere points shuffled 60/20/20
  (`pyrender_data.py:166-173`), optional HELIX test sequence (:175-177).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from nerface_tpu_torch.tools.rasterizer import load_off_mesh, project_vertices, rasterize_mesh_ids
from nerface_tpu_torch.tools.spherical_sampler import SphericalSampler


# -- mesh IO ------------------------------------------------------------------

def load_ply_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) f64, faces (F, 3) i64) of a PLY mesh (ascii or
    binary_little_endian); polygon faces are fan-triangulated."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # [(name, count, [(prop_dtype, prop_name), ...])]
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            tok = line.split()
            if not tok or tok[0] == b"comment":
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                elements.append([tok[1].decode(), int(tok[2]), []])
            elif tok[0] == b"property":
                if tok[1] == b"list":
                    elements[-1][2].append(
                        (("list", tok[2].decode(), tok[3].decode()),
                         tok[-1].decode())
                    )
                else:
                    elements[-1][2].append((tok[1].decode(), tok[2].decode()))
            elif tok[0] == b"end_header":
                break
        np_t = {
            "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
            "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
            "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
        }
        verts = None
        faces = []
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    xyz = {p: i for i, (t, p) in enumerate(props)}
                    sel = [xyz["x"], xyz["y"], xyz["z"]]
                    verts = np.array(
                        [[float(r[j]) for j in sel] for r in rows], np.float64
                    )
                elif name == "face":
                    for r in rows:
                        k = int(r[0])
                        poly = [int(v) for v in r[1:1 + k]]
                        for j in range(1, k - 1):
                            faces.append((poly[0], poly[j], poly[j + 1]))
            elif fmt == "binary_little_endian":
                if name == "vertex":
                    dt = np.dtype(
                        [(p, "<" + np_t[t]) for t, p in props]
                    )
                    data = np.frombuffer(f.read(dt.itemsize * count), dt)
                    verts = np.stack(
                        [data["x"], data["y"], data["z"]], -1
                    ).astype(np.float64)
                elif name == "face":
                    _, count_t, index_t = props[0][0]  # ("list", ct, it)
                    cdt = np.dtype("<" + np_t[count_t])
                    idt = np.dtype("<" + np_t[index_t])
                    for _ in range(count):
                        k = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                        poly = np.frombuffer(f.read(idt.itemsize * k), idt)
                        for j in range(1, k - 1):
                            faces.append(
                                (int(poly[0]), int(poly[j]), int(poly[j + 1]))
                            )
                else:  # skip unknown fixed-size element
                    dt = np.dtype([(p, "<" + np_t[t]) for t, p in props])
                    f.read(dt.itemsize * count)
            else:
                raise ValueError(f"{path}: unsupported PLY format {fmt}")
    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    return verts, np.asarray(faces, np.int64)


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    if path.lower().endswith(".ply"):
        return load_ply_mesh(path)
    return load_off_mesh(path)


def normalize_mesh(vertices: np.ndarray) -> np.ndarray:
    """Center on the bounding-box centroid and scale by 1/(1.2·diag),
    mirroring pyrender_data.py:134-141 (trimesh's `scene.centroid` is the
    bounds centroid and `.scale` the bounding-box diagonal length)."""
    lo, hi = vertices.min(0), vertices.max(0)
    centered = vertices - 0.5 * (lo + hi)
    diag = float(np.linalg.norm(hi - lo))
    return centered / (1.2 * max(diag, 1e-12))


# -- camera + shading ---------------------------------------------------------

def look_at_pose(
    cam_pos: np.ndarray,
    target: np.ndarray = np.zeros(3),
    up: np.ndarray = np.array([0.0, 0.0, 1.0]),
) -> np.ndarray:
    """(4, 4) camera-to-world in blender/OpenGL convention: the camera at
    `cam_pos` looks down its -z toward `target`."""
    forward = cam_pos - target  # +z away from the scene
    forward = forward / np.linalg.norm(forward)
    right = np.cross(up, forward)
    nr = np.linalg.norm(right)
    if nr < 1e-8:  # looking along `up`: pick any perpendicular
        right = np.cross(np.array([1.0, 0.0, 0.0]), forward)
        nr = np.linalg.norm(right)
    right = right / nr
    true_up = np.cross(forward, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2] = right, true_up, forward
    pose[:3, 3] = cam_pos
    return pose


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    vn = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    n = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(n, 1e-12)


DEFAULT_LIGHTS = (  # positions match pyrender_data.py:157-162's spot rig
    (2.0, 2.0, 2.0), (2.0, 6.0, 3.0), (2.0, -1.0, -3.0),
    (-4.0, 4.0, -3.0), (-2.0, -2.0, -3.0),
)


def shade_vertices(
    vertices: np.ndarray,
    normals: np.ndarray,
    base_color: Sequence[float] = (0.75, 0.7, 0.65),
    lights: Sequence[Sequence[float]] = DEFAULT_LIGHTS,
    ambient: float = 0.5,
    diffuse: float = 0.35,
) -> np.ndarray:
    """(V, 3) Lambertian vertex colors in [0, 1]: ambient plus per-light
    max(0, n·l) with two-sided normals (meshes here aren't consistently
    wound)."""
    shade = np.full(len(vertices), ambient)
    for lp in lights:
        d = np.asarray(lp, np.float64) - vertices
        d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        shade = shade + diffuse * np.abs((normals * d).sum(-1))
    return np.clip(shade[:, None] * np.asarray(base_color)[None, :], 0.0, 1.0)


def render_shaded(
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_colors: np.ndarray,
    pose: np.ndarray,
    intrinsics: np.ndarray,
    H: int,
    W: int,
) -> np.ndarray:
    """(H, W, 4) float RGBA: Gouraud-shaded mesh over a transparent
    background (alpha from coverage), via the face-id rasterizer + a
    per-pixel barycentric interpolation of vertex colors."""
    depth, mask, fid = rasterize_mesh_ids(
        vertices, faces, pose, intrinsics, H, W, mesh_unit_scale=1.0
    )
    img = np.zeros((H, W, 4), np.float64)
    ys, xs = np.nonzero(mask)
    if len(ys):
        u, v, _ = project_vertices(
            vertices, pose, intrinsics, mesh_unit_scale=1.0
        )
        tri = faces[fid[ys, xs]]                      # (P, 3) vertex ids
        ux, vx = u[tri], v[tri]                       # (P, 3)
        px, py = xs.astype(np.float64), ys.astype(np.float64)
        e12 = (ux[:, 2] - ux[:, 1]) * (py - vx[:, 1]) - (
            vx[:, 2] - vx[:, 1]
        ) * (px - ux[:, 1])
        e20 = (ux[:, 0] - ux[:, 2]) * (py - vx[:, 2]) - (
            vx[:, 0] - vx[:, 2]
        ) * (px - ux[:, 2])
        e01 = (ux[:, 1] - ux[:, 0]) * (py - vx[:, 0]) - (
            vx[:, 1] - vx[:, 0]
        ) * (px - ux[:, 0])
        area = (ux[:, 1] - ux[:, 0]) * (vx[:, 2] - vx[:, 0]) - (
            vx[:, 1] - vx[:, 0]
        ) * (ux[:, 2] - ux[:, 0])
        area = np.where(np.abs(area) < 1e-12, 1.0, area)
        w0, w1, w2 = e12 / area, e20 / area, e01 / area
        cols = (
            vertex_colors[tri[:, 0]] * w0[:, None]
            + vertex_colors[tri[:, 1]] * w1[:, None]
            + vertex_colors[tri[:, 2]] * w2[:, None]
        )
        img[ys, xs, :3] = np.clip(cols, 0.0, 1.0)
        img[ys, xs, 3] = 1.0
    return img


# -- dataset generation -------------------------------------------------------

def generate_mesh_dataset(
    mesh_path: str,
    outdir: str,
    n_views: int = 100,
    im_size: int = 256,
    focal: float = 300.0,
    radius: float = 1.0,
    test_sequence: Optional[str] = None,
    n_views_test: int = 40,
    seed: int = 0,
    white_background: bool = True,
) -> dict:
    """Render `n_views` spherical viewpoints of the mesh into a
    blender-schema dataset under `outdir` (60/20/20 train/val/test like
    pyrender_data.py:166-173; `test_sequence='HELIX'` replaces the test
    split with the reference's smooth fly-around, :175-177). Returns
    per-split frame counts."""
    verts, faces = load_mesh(mesh_path)
    verts = normalize_mesh(verts)
    vcols = shade_vertices(verts, vertex_normals(verts, faces))

    rng = np.random.RandomState(seed)
    pts = SphericalSampler(n_views, "RANDOM", rng=rng).points
    rng.shuffle(pts)
    splits = {
        "train": pts[: int(0.6 * n_views)],
        "val": pts[int(0.6 * n_views): int(0.8 * n_views)],
        "test": pts[int(0.8 * n_views):],
    }
    if test_sequence:
        splits["test"] = SphericalSampler(
            n_views_test, test_sequence.upper()
        ).points

    H = W = int(im_size)
    intr = np.array([focal, focal, W / 2.0, H / 2.0], np.float64)
    camera_angle_x = 2.0 * np.arctan(W / (2.0 * focal))

    from PIL import Image

    counts = {}
    for split, points in splits.items():
        os.makedirs(os.path.join(outdir, split), exist_ok=True)
        frames = []
        for i, p in enumerate(np.asarray(points, np.float64)):
            pose = look_at_pose(radius * p)
            rgba = render_shaded(verts, faces, vcols, pose, intr, H, W)
            rgb = rgba[..., :3]
            if white_background:
                rgb = rgb + (1.0 - rgba[..., 3:4])
            out = np.concatenate(
                [np.clip(rgb, 0, 1), rgba[..., 3:4]], -1
            )
            name = f"r_{i}"
            Image.fromarray((out * 255).astype(np.uint8), "RGBA").save(
                os.path.join(outdir, split, name + ".png")
            )
            frames.append({
                "file_path": f"./{split}/{name}",
                "transform_matrix": pose.tolist(),
            })
        with open(
            os.path.join(outdir, f"transforms_{split}.json"), "w"
        ) as f:
            json.dump(
                {"camera_angle_x": camera_angle_x, "frames": frames}, f,
                indent=1,
            )
        counts[split] = len(frames)
    return counts
