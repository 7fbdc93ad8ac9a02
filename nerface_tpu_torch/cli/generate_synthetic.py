"""Synthetic dataset generation CLI: port of
`nerface_tpu/cli/generate_synthetic.py` (the counterpart of the
reference's `rendering/pyrender_data.py`). Frames come from the analytic
expression-conditioned blob (`data/synthetic.py::render_blob_frame`) seen
from spherical camera samples (`tools/spherical_sampler.py`), in the
loader's format: `transforms_{split}.json`, PNG frames, `bg/00050.png`
and `index_map.npy`. Pillow is imported where the frames are written.

    python -m nerface_tpu_torch.cli.generate_synthetic --target /tmp/synth512 --size 512

`--mesh` renders a mesh file with the software rasterizer instead
(`tools/mesh_dataset.py`, the `pyrender_data.py` counterpart), and
`--splat --mesh` writes the point-splatting dataset
(`tools/point_splat.py`, the `render_trimesh.py` counterpart).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--target", type=str, required=True)
    parser.add_argument("--n-train", type=int, default=40)
    parser.add_argument("--n-val", type=int, default=5)
    parser.add_argument("--n-test", type=int, default=5)
    parser.add_argument("--size", type=int, default=128, help="H = W")
    parser.add_argument("--sampling", type=str, default="LATTICE",
                        help="LATTICE | RANDOM | CURVE | SPIRAL | HELIX | ARC")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--mesh", type=str, default=None,
        help="Render THIS mesh file (.off/.ply) with the software rasterizer instead of the "
        "analytic blob (tools/mesh_dataset.py). Uses --n-train+--n-val+--n-test views split "
        "60/20/20; --sampling HELIX, SPIRAL or ARC makes the test split that smooth path.",
    )
    parser.add_argument("--focal", type=float, default=300.0,
                        help="--mesh mode: focal length in pixels (pyrender_data.py:90).")
    parser.add_argument(
        "--splat", action="store_true",
        help="Point-splatting output instead of a NeRF dataset (tools/point_splat.py: depth/ "
        "pngs, <mode>/A/pose_%%d.npy xyz+vert_id maps, poses_{train,test}.npy; LATTICE train / "
        "SPIRAL test poses). Requires --mesh; --n-train/--n-test set the view counts.",
    )
    parser.add_argument("--render-color", action="store_true",
                        help="--splat mode: also write <mode>/B color renders of each pose.")
    parser.add_argument("--coords-space", choices=["world", "cam"], default="world",
                        help="--splat mode: xyz stored per pixel (world or camera space).")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.splat:
        if not args.mesh:
            raise SystemExit("--splat requires --mesh")
        from nerface_tpu_torch.tools.point_splat import splat_dataset

        counts = splat_dataset(
            args.mesh, args.target, n_views_train=args.n_train, n_views_test=args.n_test,
            im_size=args.size, coords_space=args.coords_space,
            render_color=args.render_color, focal=args.focal,
        )
        print(f"splat dataset written to {args.target}: {counts}")
        return

    if args.mesh:
        from nerface_tpu_torch.tools.mesh_dataset import generate_mesh_dataset

        counts = generate_mesh_dataset(
            args.mesh, args.target, n_views=args.n_train + args.n_val + args.n_test,
            im_size=args.size, focal=args.focal, seed=args.seed,
            test_sequence=args.sampling if args.sampling in ("HELIX", "SPIRAL", "ARC") else None,
        )
        print(f"mesh dataset written to {args.target}: {counts}")
        return

    from PIL import Image

    from nerface_tpu_torch.data.synthetic import _checkerboard, render_blob_frame
    from nerface_tpu_torch.tools.dataset_builder import look_at
    from nerface_tpu_torch.tools.spherical_sampler import SphericalSampler

    H = W = args.size
    rng = np.random.RandomState(args.seed)
    camera_angle_x = 0.35
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    intrinsics = np.array([focal, focal, 0.5, 0.5], np.float32)
    background = _checkerboard(H, W)

    os.makedirs(os.path.join(args.target, "bg"), exist_ok=True)
    Image.fromarray((background * 255).astype(np.uint8)).save(
        os.path.join(args.target, "bg", "00050.png"))

    n_total = args.n_train + args.n_val + args.n_test
    sampler = SphericalSampler(n_total, sampling=args.sampling, rng=rng)
    # camera positions on the face scene's shell (mean z ≈ 0.5)
    cams = sampler.points * 0.5
    cams[:, 2] = np.abs(cams[:, 2]) + 0.25

    frame_id = 0
    for split, n in (("train", args.n_train), ("val", args.n_val), ("test", args.n_test)):
        os.makedirs(os.path.join(args.target, split), exist_ok=True)
        frames = []
        for k in range(n):
            c2w = look_at(cams[frame_id].astype(np.float32), np.zeros(3))
            expr = np.zeros(76, np.float32)
            expr[:6] = rng.randn(6).astype(np.float32) * 0.5
            img = render_blob_frame(H, W, intrinsics, c2w.astype(np.float32), expr, background)
            name = f"f_{k:04d}"
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(args.target, split, name + ".png"))
            frames.append({"file_path": f"./{split}/{name}", "transform_matrix": c2w.tolist(),
                           "expression": expr.tolist(), "bbox": [0.3, 0.7, 0.3, 0.7]})
            frame_id += 1
        with open(os.path.join(args.target, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "intrinsics": intrinsics.tolist(),
                       "frames": frames}, f, indent=4)

    index_map = -np.ones((n_total, 2))
    index_map[:, 0] = np.arange(n_total)
    index_map[: args.n_train, 1] = np.arange(args.n_train)
    np.save(os.path.join(args.target, "index_map.npy"), index_map)
    print(f"Wrote {n_total} frames to {args.target}")


if __name__ == "__main__":
    main()
