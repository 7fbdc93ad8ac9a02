"""Synthetic FLAME-format datasets (host, numpy).

Port of `nerface_tpu/data/synthetic.py`. `make_synthetic_flame_dataset`
writes the generator's dataset directory (`transforms_{split}.json`,
`{split}/f_%04d.png`, `bg/00050.png`, `index_map.npy`), the same files as
the JAX package's (Pillow is imported where it is used).

`synthetic_flame_dataset` holds the same scene in memory: the generator's
camera poses, expression vectors, intrinsics, checkerboard background,
bboxes and index map, drawn from the same `RandomState(seed)` stream in
the same order — so `synthetic_flame_dataset(...)` holds exactly the poses
and expressions that `make_synthetic_flame_dataset` writes to disk with
the same arguments (its default, non-compact scene). With
`with_images=True` it also renders the ground-truth frames with the
generator's `render_blob_frame` (copied here) and quantises them to 8 bits
as its PNG files hold them, so a training set needs no files and no image
library.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from nerface_tpu_torch.data.flame import FlameDataset, spherical_render_poses


def _look_at(cam_pos: np.ndarray) -> np.ndarray:
    """c2w with -z looking at the origin (OpenGL-style, like the tracker
    poses: head at origin, camera at z≈0.5)."""
    forward = cam_pos / np.linalg.norm(cam_pos)  # camera -z points to origin
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    true_up = np.cross(forward, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = forward
    c2w[:3, 3] = cam_pos
    return c2w


def _checkerboard(H: int, W: int, tile: int = 8) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W]
    checker = ((yy // tile + xx // tile) % 2).astype(np.float32)
    bg = np.stack(
        [0.15 + 0.2 * checker, 0.25 + 0.15 * checker, 0.45 - 0.1 * checker], axis=-1
    )
    return bg


BLOB_ROWS = 16  # `render_blob_frame`'s rows a block


def render_blob_frame(
    H: int,
    W: int,
    intrinsics: np.ndarray,
    c2w: np.ndarray,
    expression: np.ndarray,
    background: np.ndarray,
    num_samples: int = 48,
    near: float = 0.2,
    far: float = 0.8,
    compact: bool = False,
) -> np.ndarray:
    """Analytic volume render of the expression-conditioned blob over
    `background`, (H, W, 3) in [0, 1] (the JAX package's
    `data/synthetic.py::render_blob_frame`). `compact` renders a small blob
    whose σ is exactly 0 beyond 2.5 radii. The rows render in blocks of
    BLOB_ROWS, in threads (numpy leaves the GIL in its array loops): every
    pixel's arithmetic is the whole frame's, so the frame is the same bit
    for bit."""
    fx, fy, cx, cy = intrinsics
    ii, jj = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(ii - W * cx) / fx, -(jj - H * cy) / fy, -np.ones_like(ii)], axis=-1)
    rd = dirs @ c2w[:3, :3].T
    ro = c2w[:3, 3]

    t = np.linspace(near, far, num_samples, dtype=np.float32)

    e0 = float(expression[0]) if len(expression) else 0.0
    e1 = float(expression[1]) if len(expression) > 1 else 0.0
    radius = (0.012 if compact else 0.08) * (1.0 + 0.4 * np.tanh(e0))
    color = np.clip(
        np.array([0.8 + 0.2 * np.tanh(e1), 0.4, 0.3 - 0.2 * np.tanh(e1)]), 0, 1
    ).astype(np.float32)
    background = np.broadcast_to(background, (H, W, 3))

    def rows(b):
        pts = ro[None, None, None, :] + rd[b, :, None, :] * t[None, None, :, None]
        d2 = np.sum(pts * pts, axis=-1)
        sigma = 400.0 * np.exp(-d2 / (2 * radius * radius))
        if compact:
            cut = 2.5 * radius
            sigma = np.where(d2 < cut * cut, sigma, 0.0)

        dists = np.diff(t, append=t[-1] + 1e10).astype(np.float32)
        dists = dists[None, None, :] * np.linalg.norm(rd[b], axis=-1)[..., None]
        alpha = 1.0 - np.exp(-sigma * dists)
        trans = np.cumprod(1.0 - alpha + 1e-10, axis=-1)
        trans = np.roll(trans, 1, axis=-1)
        trans[..., 0] = 1.0
        weights = alpha * trans

        rgb = np.sum(weights[..., None] * color[None, None, None, :], axis=-2)
        acc = np.sum(weights, axis=-1)
        return np.clip(rgb + (1.0 - acc[..., None]) * background[b], 0.0, 1.0)

    blocks = [slice(i, i + BLOB_ROWS) for i in range(0, H, BLOB_ROWS)]
    with ThreadPoolExecutor(min(len(blocks), os.cpu_count() or 1)) as pool:
        return np.concatenate(list(pool.map(rows, blocks)))


def synthetic_flame_dataset(
    n_train: int = 8,
    n_val: int = 2,
    n_test: int = 2,
    H: int = 64,
    W: int = 64,
    expr_dim: int = 76,
    seed: int = 0,
    with_images: bool = False,
    num_samples: int = 48,
) -> FlameDataset:
    """An in-memory `FlameDataset` of the generator's (non-compact) scene:
    its per-frame poses, expressions and bboxes for train, val and test in
    order, its intrinsics, and the background and index map that
    `load_flame_data` would read from its files. With `with_images`, the
    frames the generator writes (rendered with `num_samples` samples a
    ray) as the loader reads them back: 8-bit levels / 255 in float32;
    otherwise `images` is None. No files."""
    rng = np.random.RandomState(seed)
    camera_angle_x = 0.35
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    n = n_train + n_val + n_test
    poses, exprs = [], []
    for _ in range(n):
        # the generator's draws, in its order: camera jitter, then expression
        jitter = rng.randn(3) * np.array([0.06, 0.06, 0.02])
        cam = np.array([0.0, 0.0, 0.5]) + jitter
        poses.append(_look_at(cam.astype(np.float32)))
        expr = np.zeros(expr_dim, np.float32)
        expr[:6] = rng.randn(6).astype(np.float32) * 0.5
        exprs.append(expr)
    bboxes = np.tile(np.array([0.30, 0.70, 0.30, 0.70], np.float32), (n, 1))
    bboxes[:, 0:2] *= H
    bboxes[:, 2:4] *= W
    # the background as its 8-bit PNG holds it
    background = (_checkerboard(H, W) * 255).astype(np.uint8).astype(np.float32) / 255.0
    index_map = np.stack(
        [np.arange(n), np.concatenate([np.arange(n_train), -np.ones(n_val + n_test, int)])],
        axis=-1,
    )
    starts = np.cumsum([0, n_train, n_val, n_test])
    images = None
    if with_images:
        intr = np.array([focal, focal, 0.5, 0.5], np.float32)
        bg_float = _checkerboard(H, W)
        images = np.stack([
            (render_blob_frame(H, W, intr, c2w, e, bg_float, num_samples=num_samples) * 255)
            .astype(np.uint8)
            for c2w, e in zip(poses, exprs)
        ]).astype(np.float32) / 255.0
    return FlameDataset(
        images=images,
        poses=np.stack(poses).astype(np.float32),
        render_poses=spherical_render_poses(),
        H=int(H),
        W=int(W),
        intrinsics=np.array([focal, focal, 0.5, 0.5], np.float32),
        i_split=[np.arange(starts[i], starts[i + 1]) for i in range(3)],
        expressions=np.stack(exprs).astype(np.float32),
        frontal_images=None,
        bboxes=np.floor(bboxes).astype(np.int32),
        background=background,
        index_map=index_map,
    )


def make_synthetic_flame_dataset(
    outdir: str,
    n_train: int = 8,
    n_val: int = 2,
    n_test: int = 2,
    H: int = 64,
    W: int = 64,
    expr_dim: int = 76,
    seed: int = 0,
    num_samples: int = 48,
    compact: bool = False,
) -> str:
    """Write a loader-compatible synthetic dataset; returns `outdir`
    (`nerface_tpu/data/synthetic.py:109-207`). `compact` renders the small
    truncated blob (background pixels equal bg/00050.png exactly) with
    per-frame bboxes from its projection, at ≥ 128 samples a ray."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    if compact:
        num_samples = max(num_samples, 128)
    camera_angle_x = 0.35
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    intrinsics = np.array([focal, focal, 0.5, 0.5], np.float32)
    background = _checkerboard(H, W)

    os.makedirs(os.path.join(outdir, "bg"), exist_ok=True)
    Image.fromarray((background * 255).astype(np.uint8)).save(os.path.join(outdir, "bg", "00050.png"))

    frame_id = 0
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        os.makedirs(os.path.join(outdir, split), exist_ok=True)
        frames = []
        for _ in range(n):
            # camera near z = 0.5 with a small jitter (tracker-pose-like)
            jitter = rng.randn(3) * np.array([0.06, 0.06, 0.02])
            cam = np.array([0.0, 0.0, 0.5]) + jitter
            c2w = _look_at(cam.astype(np.float32))
            expr = np.zeros(expr_dim, np.float32)
            expr[:6] = rng.randn(6).astype(np.float32) * 0.5
            img = render_blob_frame(H, W, intrinsics, c2w, expr, background,
                                    num_samples=num_samples, compact=compact)
            name = f"f_{frame_id:04d}"
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(outdir, split, name + ".png"))
            if compact:
                # the truncated blob's projected extent plus 30 %
                r_blob = 0.012 * (1.0 + 0.4 * np.tanh(float(expr[0])))
                cut = 2.5 * r_blob
                dist = float(np.linalg.norm(cam))
                half = 1.3 * (cut / max(dist - cut, 1e-6)) / (2.0 * np.tan(0.5 * camera_angle_x))
                half = float(min(0.49, half))
                bbox = np.array([0.5 - half, 0.5 + half, 0.5 - half, 0.5 + half], np.float32)
            else:
                bbox = np.array([0.30, 0.70, 0.30, 0.70], np.float32)
            frames.append({"file_path": f"{split}/{name}", "transform_matrix": c2w.tolist(),
                           "expression": expr.tolist(), "bbox": bbox.tolist()})
            frame_id += 1
        with open(os.path.join(outdir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "intrinsics": intrinsics.tolist(),
                       "frames": frames}, f)

    n = n_train + n_val + n_test
    index_map = np.stack(
        [np.arange(n), np.concatenate([np.arange(n_train), -np.ones(n_val + n_test, int)])],
        axis=-1,
    )
    np.save(os.path.join(outdir, "index_map.npy"), index_map)
    return outdir
