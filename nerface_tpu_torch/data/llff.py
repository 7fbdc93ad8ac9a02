"""LLFF (real forward-facing) dataset loader — equivalent of
`nerf/load_llff.py` (stock nerf-pytorch loader; SURVEY.md §2 component 7).
Copied from `nerface_tpu/data/llff.py` (numpy + PIL; the PyTorch port never
imports the JAX package).

Reads `poses_bounds.npy` + `images/`, applies the LLFF axis fix, bd-factor
rescaling, pose recentering, optional spherification, and builds the spiral
render path (`load_llff.py:278-356`). The pose-path math below is a
reimplementation of the canonical LLFF recipe (Mildenhall et al.'s
original `llff/poses/pose_utils.py`, via nerf-pytorch) — the algorithms
and constants are the spec; the decomposition (batched camera-frame
construction, einsum normal equations, vectorized path generation) is this
repo's. Bit-level agreement with the reference functions is pinned by
tests/test_llff_oracle.py. Deviations: `_minify` (:12-66) shells out to
ImageMagick `mogrify`; here downsampled image sets are generated with PIL
area resize — same `images_{factor}` cache-directory contract.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def camera_frame(forward: np.ndarray, up_hint: np.ndarray) -> np.ndarray:
    """Orthonormal camera basis as a (3, 3) matrix with COLUMNS
    [right, up, forward], from a forward direction and an approximate up.

    LLFF camera convention: right = up̂ × ẑ, up = ẑ × right (both
    renormalized), matching `load_llff.py:143-149`.
    """
    fwd = _unit(forward)
    right = _unit(np.cross(up_hint, fwd))
    up = _unit(np.cross(fwd, right))
    return np.stack([right, up, fwd], axis=1)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """(3, 4) camera-to-world from forward/up-hint/position."""
    return np.concatenate([camera_frame(z, up), pos[:, None]], axis=1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """The "average" camera: mean position, summed forward/up axes, with
    the first frame's [H, W, focal] column carried along
    (`load_llff.py:157-166`)."""
    center = poses[:, :3, 3].mean(axis=0)
    mean_forward = _unit(poses[:, :3, 2].sum(axis=0))
    mean_up = poses[:, :3, 1].sum(axis=0)
    hwf = poses[0, :3, -1:]
    return np.concatenate(
        [viewmatrix(mean_forward, mean_up, center), hwf], axis=1
    )


def _to_homogeneous(p34: np.ndarray) -> np.ndarray:
    """(..., 3, 4) -> (..., 4, 4) by appending [0, 0, 0, 1] rows."""
    bottom = np.broadcast_to(
        np.array([0.0, 0.0, 0.0, 1.0]), p34.shape[:-2] + (1, 4)
    )
    return np.concatenate([p34, bottom], axis=-2)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Express all cameras relative to the average camera, so the average
    pose becomes the identity (`load_llff.py:185-197`)."""
    avg_inv = np.linalg.inv(_to_homogeneous(poses_avg(poses)[:3, :4]))
    rebased = avg_inv @ _to_homogeneous(poses[:, :3, :4])
    out = poses.copy()
    out[:, :3, :4] = rebased[:, :3, :4]
    return out


def render_path_spiral(
    c2w: np.ndarray, up: np.ndarray, rads, focal: float, zdelta: float,
    zrate: float, rots: int, N: int,
) -> List[np.ndarray]:
    """Spiral of N cameras around the average pose, all looking at a point
    `focal` units down its axis (`load_llff.py:169-182`). `zdelta` is
    accepted for signature parity but unused, as in the reference."""
    del zdelta
    rads4 = np.append(np.asarray(list(rads), np.float64), 1.0)
    hwf = c2w[:, 4:5]
    look_target = c2w[:3, :4] @ np.array([0.0, 0.0, -focal, 1.0])
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        offset = rads4 * np.array(
            [0.5 * np.cos(theta), -0.5 * np.sin(theta),
             -np.sin(theta * zrate / 2), 1.0]
        )
        cam_pos = c2w[:3, :4] @ offset
        fwd = _unit(cam_pos - look_target)
        out.append(np.concatenate([viewmatrix(fwd, up, cam_pos), hwf], 1))
    return out


def _nearest_point_to_rays(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Least-squares point closest to a bundle of lines (origin + t·dir):
    solve (mean Aᵢ) x = mean(Aᵢ oᵢ) with Aᵢ = I − dᵢdᵢᵀ. Written via the
    same normal-equation form the LLFF recipe uses (AᵢᵀAᵢ = Aᵢ for the
    projector, but the reference averages AᵢᵀAᵢ — kept for bit parity)."""
    proj = np.eye(3) - dirs * np.transpose(dirs, (0, 2, 1))  # (N, 3, 3)
    rhs = -proj @ origins                                    # (N, 3, 1)
    lhs = (np.transpose(proj, (0, 2, 1)) @ proj).mean(axis=0)
    return np.squeeze(-np.linalg.inv(lhs) @ rhs.mean(axis=0))


def spherify_poses(
    poses: np.ndarray, bds: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rebase the scene on the cameras' mutual focus point, normalize the
    mean camera distance to 1, and build a 120-view circular render path
    at the cameras' average height (`load_llff.py:200-275`)."""
    focus = _nearest_point_to_rays(poses[:, :3, 3:4], poses[:, :3, 2:3])

    # world frame anchored at the focus point; the axis order differs from
    # camera_frame deliberately (z-up world, not a camera) — the arbitrary
    # probe vector [.1, .2, .3] breaks the cross-product degeneracy exactly
    # as in the recipe.
    world_up = _unit((poses[:, :3, 3] - focus).mean(axis=0))
    axis1 = _unit(np.cross([0.1, 0.2, 0.3], world_up))
    axis2 = _unit(np.cross(world_up, axis1))
    world = np.stack([axis1, axis2, world_up, focus], axis=1)  # (3, 4)

    rebased = np.linalg.inv(_to_homogeneous(world[None])) @ _to_homogeneous(
        poses[:, :3, :4]
    )
    mean_dist = np.sqrt(np.square(rebased[:, :3, 3]).sum(axis=-1).mean())
    scale = 1.0 / mean_dist
    rebased[:, :3, 3] *= scale
    bds = bds * scale

    # circle at the cameras' mean height, radius on the unit sphere
    height = rebased[:, :3, 3].mean(axis=0)[2]
    circle_r = np.sqrt(1.0 - height**2)  # mean_dist scaled to 1
    thetas = np.linspace(0.0, 2.0 * np.pi, 120)
    ring = []
    for th in thetas:
        cam_pos = np.array(
            [circle_r * np.cos(th), circle_r * np.sin(th), height]
        )
        # path cameras look at the origin with -z as the up hint; note the
        # recipe's own basis order here (right = fwd × up, up = fwd × right)
        fwd = _unit(cam_pos)
        right = _unit(np.cross(fwd, np.array([0.0, 0.0, -1.0])))
        up = _unit(np.cross(fwd, right))
        ring.append(np.stack([right, up, fwd, cam_pos], axis=1))
    ring = np.stack(ring, axis=0)

    hwf0 = poses[0, :3, -1:]
    ring = np.concatenate(
        [ring, np.broadcast_to(hwf0, ring[:, :3, -1:].shape)], axis=-1
    )
    rebased34 = np.concatenate(
        [rebased[:, :3, :4],
         np.broadcast_to(hwf0, rebased[:, :3, -1:].shape)], axis=-1
    )
    return rebased34, ring, bds


def _minify(basedir: str, factor: int) -> str:
    """Generate `images_{factor}/` with PIL area downsampling (replaces the
    reference's ImageMagick `mogrify` subprocess, `load_llff.py:12-66`)."""
    from PIL import Image

    outdir = os.path.join(basedir, f"images_{factor}")
    srcdir = os.path.join(basedir, "images")
    names = sorted(
        f for f in os.listdir(srcdir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    if os.path.exists(outdir):
        existing = [
            f for f in os.listdir(outdir)
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        ]
        if len(existing) == len(names):
            return outdir
    os.makedirs(outdir, exist_ok=True)
    for name in names:
        with Image.open(os.path.join(srcdir, name)) as im:
            w, h = im.size
            im.resize((w // factor, h // factor), Image.LANCZOS).save(
                os.path.join(outdir, os.path.splitext(name)[0] + ".png")
            )
    return outdir


def _load_data(basedir: str, factor: Optional[int] = None):
    """poses_bounds.npy + images -> (poses (3, 5, N), bds (2, N), imgs
    (H, W, 3, N)), with the [H, W, focal] column refreshed to the actual
    (possibly downsampled) image size (`load_llff.py:69-110`)."""
    from PIL import Image

    raw = np.load(os.path.join(basedir, "poses_bounds.npy"))  # (N, 17)
    poses = raw[:, :-2].reshape(-1, 3, 5).transpose(1, 2, 0)
    bds = raw[:, -2:].transpose(1, 0)

    if factor is not None and factor != 1:
        imgdir = _minify(basedir, factor)
    else:
        factor = 1
        imgdir = os.path.join(basedir, "images")

    imgfiles = [
        os.path.join(imgdir, f)
        for f in sorted(os.listdir(imgdir))
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    ]
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}"
        )

    imgs = []
    for f in imgfiles:
        with Image.open(f) as im:
            imgs.append(np.asarray(im)[..., :3] / 255.0)
    imgs = np.stack(imgs, -1)

    poses[:2, 4, :] = np.array(imgs.shape[:2]).reshape(2, 1)
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor
    return poses, bds, imgs


@dataclasses.dataclass
class LLFFDataset:
    images: np.ndarray        # (N, H, W, 3)
    poses: np.ndarray         # (N, 3, 5) — last column is [H, W, focal]
    bds: np.ndarray           # (N, 2) near/far bounds
    render_poses: np.ndarray  # spiral or circular path
    i_test: int

    @property
    def hwf(self):
        h, w, f = self.poses[0, :3, -1]
        return [int(h), int(w), float(f)]

    def as_tuple(self):
        return self.images, self.poses, self.bds, self.render_poses, self.i_test


def load_llff_data(
    basedir: str,
    factor: int = 4,
    recenter: bool = True,
    bd_factor: Optional[float] = 0.75,
    spherify: bool = False,
    path_zflat: bool = False,
) -> LLFFDataset:
    poses, bds, imgs = _load_data(basedir, factor=factor)

    # LLFF axis fix: [down right back] -> [right up back] (:290)
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = _unit(poses[:, :3, 1].sum(0))
        # path depth bounds -> look-at focal & radii (`load_llff.py:318-334`)
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / (((1.0 - dt) / close_depth + dt / inf_depth))
        zdelta = close_depth * 0.2
        rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
        c2w_path = c2w
        N_views, N_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots = 1
            N_views //= 2
        render_poses = render_path_spiral(
            c2w_path, up, rads, focal, zdelta, zrate=0.5, rots=N_rots, N=N_views
        )

    render_poses = np.array(render_poses).astype(np.float32)
    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    return LLFFDataset(
        images=images.astype(np.float32),
        poses=poses.astype(np.float32),
        bds=bds,
        render_poses=render_poses,
        i_test=i_test,
    )
