"""FLAME/face dataset loader — host-side, numpy.

Port of `nerface_tpu/data/flame.py` (itself the behavioral equivalent of
the reference's `nerf/load_flame.py:40-211`): reads
`transforms_{train,val,test}.json` (per frame: `file_path` PNG, 4×4
`transform_matrix` head pose as c2w, 76-dim `expression`, normalized
`bbox [h0,h1,w0,w1]`), global `camera_angle_x` + `intrinsics [fx,fy,cx,cy]`,
spherical render poses, optional half-res resize with intrinsics scaling,
bbox → pixel coordinates, and `test=True` loading only the test split.

Differences from the JAX package's module, all about dependencies: the
image readers (`PIL`, `cv2`) are imported inside the functions that use
them (PNG frames through Pillow, which imageio itself reads them with),
and a `FlameDataset` may carry its background and index map
in memory, so a dataset built without files (e.g. from
`data/synthetic.py`) serves the same requests as one loaded from disk.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np


def _translate_z(t: float) -> np.ndarray:
    tform = np.eye(4, dtype=np.float32)
    tform[2, 3] = t
    return tform


def _rotate_phi_x(phi: float) -> np.ndarray:
    tform = np.eye(4, dtype=np.float32)
    tform[1, 1] = tform[2, 2] = np.cos(phi)
    tform[1, 2] = -np.sin(phi)
    tform[2, 1] = -tform[1, 2]
    return tform


def _rotate_theta_y(theta: float) -> np.ndarray:
    tform = np.eye(4, dtype=np.float32)
    tform[0, 0] = tform[2, 2] = np.cos(theta)
    tform[0, 2] = -np.sin(theta)
    tform[2, 0] = -tform[0, 2]
    return tform


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Spherical debug/render pose (`load_flame.py:32-37`)."""
    c2w = _translate_z(radius)
    c2w = _rotate_phi_x(phi / 180.0 * np.pi) @ c2w
    c2w = _rotate_theta_y(theta / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip @ c2w


def spherical_render_poses() -> np.ndarray:
    """The loader's 40 spherical render poses."""
    return np.stack(
        [
            pose_spherical(angle, -30.0, 4.0)
            for angle in np.linspace(-180, 180, 40 + 1)[:-1]
        ],
        0,
    )


def _resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        # Box-filter downsample for integer factors.
        fh, fw = img.shape[0] // h, img.shape[1] // w
        return (
            img[: h * fh, : w * fw].reshape(h, fh, w, fw, -1).mean(axis=(1, 3)).squeeze()
        )
    return cv2.resize(img, dsize=(w, h), interpolation=cv2.INTER_AREA)


@dataclasses.dataclass
class FlameDataset:
    """Loaded dataset. `images` may be None for a dataset that only serves
    (the server needs poses, expressions, intrinsics and the background)."""

    images: Optional[np.ndarray]  # (N, H, W, C) float32 in [0, 1]
    poses: np.ndarray  # (N, 4, 4)
    render_poses: np.ndarray  # (40, 4, 4)
    H: int
    W: int
    intrinsics: np.ndarray  # [fx, fy, cx, cy], cx/cy relative
    i_split: List[np.ndarray]
    expressions: np.ndarray  # (N, 76)
    frontal_images: Optional[np.ndarray]
    bboxes: np.ndarray  # (N, 4) int pixel coords [h0, h1, w0, w1]
    basedir: str = ""
    background: Optional[np.ndarray] = None  # in-memory bg/00050.png
    index_map: Optional[np.ndarray] = None  # in-memory index_map.npy

    @property
    def i_train(self):
        return self.i_split[0]

    @property
    def i_val(self):
        return self.i_split[1] if len(self.i_split) > 1 else np.array([], np.int64)

    @property
    def i_test(self):
        return self.i_split[-1]

    @property
    def hwf(self):
        return [self.H, self.W, self.intrinsics]

    def as_tuple(self):
        """The reference `load_flame_data`'s return tuple, in its order."""
        return (
            self.images,
            self.poses,
            self.render_poses,
            [self.H, self.W, self.intrinsics],
            self.i_split,
            self.expressions,
            self.frontal_images,
            self.bboxes,
        )

    def load_background(self, name: str = "00050.png") -> np.ndarray:
        """GT background `bg/00050.png` scaled to [0, 1] and thumbnailed to
        (H, W) (`train_transformed_rays.py:159-168`); the in-memory
        background when the dataset carries one."""
        if self.background is not None:
            return np.asarray(self.background, np.float32)
        from PIL import Image

        bg = Image.open(os.path.join(self.basedir, "bg", name))
        bg.thumbnail((self.H, self.W))
        return np.asarray(bg, dtype=np.float32) / 255.0

    def load_index_map(self) -> np.ndarray:
        """`index_map.npy`: dataset order -> shuffled-train order
        (read `eval_transformed_rays.py:329`); the in-memory map when the
        dataset carries one. Raises FileNotFoundError when neither exists."""
        if self.index_map is not None:
            return np.asarray(self.index_map).astype(int)
        return np.load(os.path.join(self.basedir, "index_map.npy")).astype(int)


def load_flame_data(
    basedir: str,
    half_res: bool = False,
    testskip: int = 1,
    debug: bool = False,
    expressions: bool = True,
    load_frontal_faces: bool = False,
    load_bbox: bool = True,
    test: bool = False,
    cachedir: Optional[str] = None,
) -> FlameDataset:
    """`cachedir` (the reference's `cfg.dataset.cachedir`): a directory
    holding a pre-decoded .npz of the dataset — loaded instead of
    re-decoding PNGs, written on first load. Same file names as the JAX
    package's loader, so the two share a cache."""
    if cachedir:
        tag = (
            f"flame_{'test' if test else 'full'}"
            f"_hr{int(half_res)}_ts{int(testskip)}_dbg{int(debug)}.npz"
        )
        cache_path = os.path.join(cachedir, tag)
        if os.path.exists(cache_path):
            z = np.load(cache_path, allow_pickle=False)
            n_splits = int(z["n_splits"])
            return FlameDataset(
                z["images"], z["poses"], z["render_poses"],
                int(z["H"]), int(z["W"]), z["intrinsics"],
                [z[f"i_split_{i}"] for i in range(n_splits)],
                z["expressions"],
                z["frontal"] if "frontal" in z.files else None,
                z["bboxes"], str(z["basedir"]),
            )
        ds = load_flame_data(
            basedir, half_res=half_res, testskip=testskip, debug=debug,
            expressions=expressions, load_frontal_faces=load_frontal_faces,
            load_bbox=load_bbox, test=test, cachedir=None,
        )
        os.makedirs(cachedir, exist_ok=True)
        payload = dict(
            images=ds.images, poses=ds.poses, render_poses=ds.render_poses,
            H=ds.H, W=ds.W, intrinsics=ds.intrinsics,
            n_splits=len(ds.i_split), expressions=ds.expressions,
            bboxes=ds.bboxes, basedir=ds.basedir,
        )
        for i, s in enumerate(ds.i_split):
            payload[f"i_split_{i}"] = s
        if ds.frontal_images is not None:
            payload["frontal"] = ds.frontal_images
        np.savez(cache_path, **payload)
        return ds

    from PIL import Image

    def imread(path):
        return np.asarray(Image.open(path))

    splits = ["test"] if test else ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json"), "r") as fp:
            metas[s] = json.load(fp)

    all_imgs, all_frontal, all_poses, all_expr, all_bbox = [], [], [], [], []
    counts = [0]
    meta = None
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, frontal, poses, exprs, bboxes = [], [], [], [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(imread(fname))
            if load_frontal_faces:
                frontal.append(
                    imread(
                        os.path.join(basedir, frame["file_path"] + "_frontal.png")
                    )
                )
            poses.append(np.array(frame["transform_matrix"]))
            exprs.append(np.array(frame["expression"]))
            if load_bbox:
                bboxes.append(
                    np.array(frame.get("bbox", [0.0, 1.0, 0.0, 1.0]))
                )
        all_imgs.append((np.array(imgs) / 255.0).astype(np.float32))
        if load_frontal_faces:
            all_frontal.append((np.array(frontal) / 255.0).astype(np.float32))
        all_poses.append(np.array(poses).astype(np.float32))
        all_expr.append(np.array(exprs).astype(np.float32))
        all_bbox.append(np.array(bboxes).astype(np.float32))
        counts.append(counts[-1] + len(imgs))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(len(splits))]
    imgs = np.concatenate(all_imgs, 0)
    frontal = np.concatenate(all_frontal, 0) if load_frontal_faces else None
    poses = np.concatenate(all_poses, 0)
    exprs = np.concatenate(all_expr, 0)
    bboxes = np.concatenate(all_bbox, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    if meta.get("intrinsics"):
        intrinsics = np.array(meta["intrinsics"], np.float32)
    else:
        intrinsics = np.array([focal, focal, 0.5, 0.5], np.float32)

    render_poses = spherical_render_poses()

    if debug:
        # Tiny-image debug mode (`load_flame.py:133-157`).
        H, W = H // 32, W // 32
        intrinsics = intrinsics.copy()
        intrinsics[:2] = intrinsics[:2] / 32.0
        imgs = np.stack([_resize_area(im, 25, 25) for im in imgs], 0)
        if frontal is not None:
            frontal = np.stack([_resize_area(im, 25, 25) for im in frontal], 0)
        bboxes = np.floor(
            bboxes * np.array([H, H, W, W], np.float32)
        ).astype(np.int32)
        return FlameDataset(
            imgs, poses, render_poses, H, W, intrinsics, i_split, exprs,
            frontal, bboxes, basedir,
        )

    if half_res:
        H, W = H // 2, W // 2
        intrinsics = intrinsics.copy()
        intrinsics[:2] = intrinsics[:2] * 0.5
        imgs = np.stack([_resize_area(im, H, W) for im in imgs], 0)
        if frontal is not None:
            frontal = np.stack([_resize_area(im, H, W) for im in frontal], 0)

    # bbox normalized -> pixel coords (`load_flame.py:205-208`)
    bboxes = bboxes.copy()
    bboxes[:, 0:2] *= H
    bboxes[:, 2:4] *= W
    bboxes = np.floor(bboxes).astype(np.int32)

    return FlameDataset(
        imgs, poses, render_poses, int(H), int(W), intrinsics, i_split, exprs,
        frontal, bboxes, basedir,
    )
