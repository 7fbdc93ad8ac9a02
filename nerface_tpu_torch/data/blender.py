"""Blender-synthetic dataset loader — equivalent of `nerf/load_blender.py`
(stock nerf-pytorch loader kept for compatibility; SURVEY.md §2 component 7).
Copied from `nerface_tpu/data/blender.py` (numpy + PIL; the PyTorch port
never imports the JAX package).

Reads `transforms_{train,val,test}.json` with `camera_angle_x` and per-frame
`transform_matrix`, builds the 40-view spherical render path, optional
half/debug resolution with focal scaling (`load_blender.py:40-171`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from nerface_tpu_torch.data.flame import pose_spherical, _resize_area


@dataclasses.dataclass
class BlenderDataset:
    images: np.ndarray          # (N, H, W, C) float32 in [0, 1]
    poses: np.ndarray           # (N, 4, 4)
    render_poses: np.ndarray    # (40, 4, 4) spherical path
    H: int
    W: int
    focal: float
    i_split: List[np.ndarray]
    frontal_images: Optional[np.ndarray] = None

    @property
    def i_train(self):
        return self.i_split[0]

    @property
    def i_val(self):
        return self.i_split[1]

    @property
    def i_test(self):
        return self.i_split[2]

    @property
    def intrinsics(self) -> np.ndarray:
        """Scalar-focal intrinsics in the framework's [fx, fy, cx, cy]
        convention (relative centers), matching `nerf_helpers.py:109-110`."""
        return np.array([self.focal, self.focal, 0.5, 0.5], np.float32)

    @property
    def hwf(self):
        return [self.H, self.W, self.focal]

    def as_tuple(self):
        """Reference return signature (`load_blender.py:171`)."""
        return (
            self.images, self.poses, self.render_poses, self.hwf,
            self.i_split, self.frontal_images,
        )


def load_blender_data(
    basedir: str,
    half_res: bool = False,
    testskip: int = 1,
    debug: bool = False,
    load_frontal_faces: bool = False,
) -> BlenderDataset:
    from PIL import Image

    splits = ["train", "val", "test"]
    all_imgs, all_frontal, all_poses = [], [], []
    counts = [0]
    meta = None
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            meta = json.load(fp)
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(np.asarray(Image.open(fname)))
            if load_frontal_faces:
                all_frontal.append(
                    np.asarray(
                        Image.open(
                            os.path.join(
                                basedir, frame["file_path"] + "_frontal.png"
                            )
                        )
                    )
                )
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(np.array(poses).astype(np.float32))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    images = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)
    frontal = (
        (np.array(all_frontal) / 255.0).astype(np.float32)
        if load_frontal_faces
        else None
    )

    H, W = images[0].shape[:2]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_poses = np.stack(
        [
            pose_spherical(angle, -30.0, 4.0)
            for angle in np.linspace(-180, 180, 40 + 1)[:-1]
        ],
        0,
    ).astype(np.float32)

    if debug:
        # Reference debug mode: 25×25 thumbnails, focal/32 (:104-121)
        H, W, focal = H // 32, W // 32, focal / 32.0
        images = np.stack([_resize_area(im, 25, 25) for im in images])
        if frontal is not None:
            frontal = np.stack([_resize_area(im, 25, 25) for im in frontal])
    elif half_res:
        H, W, focal = H // 2, W // 2, focal / 2.0
        images = np.stack([_resize_area(im, H, W) for im in images])
        if frontal is not None:
            frontal = np.stack([_resize_area(im, H, W) for im in frontal])

    return BlenderDataset(
        images=images,
        poses=poses,
        render_poses=render_poses,
        H=int(H),
        W=int(W),
        focal=float(focal),
        i_split=i_split,
        frontal_images=frontal,
    )
