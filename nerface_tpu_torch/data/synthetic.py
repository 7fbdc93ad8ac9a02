"""Synthetic FLAME-format scene parameters (host, numpy).

Port of the scene half of `nerface_tpu/data/synthetic.py`: the generator's
camera poses, expression vectors, intrinsics, checkerboard background,
bboxes and index map, drawn from the same `RandomState(seed)` stream in
the same order — so `synthetic_flame_dataset(...)` holds exactly the poses
and expressions that `make_synthetic_flame_dataset` writes to disk with
the same arguments (its default, non-compact scene). The ground-truth
frames (the analytic blob render) are not produced: serving needs none.
"""

from __future__ import annotations

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


def synthetic_flame_dataset(
    n_train: int = 8,
    n_val: int = 2,
    n_test: int = 2,
    H: int = 64,
    W: int = 64,
    expr_dim: int = 76,
    seed: int = 0,
) -> FlameDataset:
    """An in-memory `FlameDataset` of the generator's (non-compact) scene:
    its per-frame poses, expressions and bboxes for train, val and test in
    order, its intrinsics, and the background and index map that
    `load_flame_data` would read from its files. No frames (`images` is
    None) and no files."""
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
    return FlameDataset(
        images=None,
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
