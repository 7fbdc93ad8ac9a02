"""Legacy static-NeRF eval of the PyTorch port — the JAX package's
`cli/eval_nerf.py` (the reference's `eval_nerf.py:39-192`): renders the
spherical (blender) or spiral (LLFF, through NDC) `render_poses` of a
dataset from a reference-schema `.ckpt`, with no expression, background
or latent conditioning, in f32. JAX's arguments plus `--device`:

    python -m nerface_tpu_torch.cli.eval_nerf --config lego.yml \\
        --checkpoint run.ckpt --savedir renders/ --save-disparity-image
    # the CPU
    python -m nerface_tpu_torch.cli.eval_nerf --config c.yml --checkpoint run.ckpt --device cpu

An orbax checkpoint directory (the JAX package's own format) is refused:
the JAX package's train CLI writes the reference `.ckpt` with
`--export-torch`.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True,
                        help="Path to (.yml) config file.")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Reference-schema torch .ckpt to evaluate.")
    parser.add_argument("--savedir", type=str, default="./renders/")
    parser.add_argument("--save-disparity-image", action="store_true")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to render on (default cuda).")
    return parser


def load_render_path(cfg):
    """(render_poses, H, W, focal) of the config's blender or LLFF dataset."""
    dataset_type = str(cfg.dataset.type).lower()
    if dataset_type == "blender":
        from nerface_tpu_torch.data.blender import load_blender_data

        ds = load_blender_data(
            cfg.dataset.basedir, half_res=bool(cfg.dataset.half_res),
            testskip=int(cfg.dataset.testskip),
        )
    elif dataset_type == "llff":
        from nerface_tpu_torch.data.llff import load_llff_data

        ds = load_llff_data(
            cfg.dataset.basedir, factor=int(getattr(cfg.dataset, "downsample_factor", 4))
        )
    else:
        raise SystemExit(f"unsupported dataset type for eval_nerf: {dataset_type}")
    H, W, focal = ds.hwf
    return ds.render_poses, H, W, focal


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if os.path.isdir(args.checkpoint):
        raise SystemExit(
            f"{args.checkpoint} is a directory (an orbax checkpoint of the JAX package); "
            "the PyTorch port reads the reference .ckpt only: write one with the JAX "
            "package's `python -m nerface_tpu.cli.train ... --export-torch`"
        )

    import numpy as np
    import torch
    from PIL import Image

    from nerface_tpu_torch.config import load_config
    from nerface_tpu_torch.config.flags import FeatureFlags
    from nerface_tpu_torch.eval.driver import cast_to_disparity_image, cast_to_image
    from nerface_tpu_torch.eval.renderer import render_full_frame
    from nerface_tpu_torch.render.pipeline import RenderSettings
    from nerface_tpu_torch.train.checkpoint import load_torch_checkpoint
    from nerface_tpu_torch.train.loop import build_models_from_cfg
    from nerface_tpu_torch.train.state import create_train_state

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not available "
                           "(pass --device cpu to render on the CPU)")
    cfg = load_config(args.config)
    render_poses, H, W, focal = load_render_path(cfg)
    intrinsics = np.array([focal, focal, 0.5, 0.5], np.float32)

    model_coarse, model_fine = build_models_from_cfg(cfg, device=device)
    # the static model: no latent table and no background, so a checkpoint's
    # are not read (`eval_nerf.py`; JAX :66-69)
    flags = FeatureFlags(train_latent_codes=False, fixed_background=False,
                         disable_latent_codes=True)
    state = create_train_state(model_coarse, model_fine, flags, n_train=1)
    ckpt = load_torch_checkpoint(args.checkpoint, device=device)
    for model, sd in ((state.model_coarse, ckpt["coarse"]), (state.model_fine, ckpt["fine"])):
        if model is not None:
            model.load_state_dict(sd, strict=True)
            model.eval().requires_grad_(False)

    settings = RenderSettings.from_cfg(cfg, mode="validation")
    os.makedirs(args.savedir, exist_ok=True)
    if args.save_disparity_image:
        os.makedirs(os.path.join(args.savedir, "disparity"), exist_ok=True)

    times = []
    n = len(render_poses) if args.max_frames is None else min(len(render_poses), args.max_frames)
    for i in range(n):
        t0 = time.perf_counter()
        out = render_full_frame(
            state.model_coarse, state.model_fine, H, W, intrinsics,
            np.asarray(render_poses[i][:3, :4]), settings, seed=i, device=device,
        )
        rgb = out["rgb_fine"] if "rgb_fine" in out else out["rgb_coarse"]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        Image.fromarray(cast_to_image(rgb.cpu().numpy())).save(
            os.path.join(args.savedir, f"{i:04d}.png"))
        if args.save_disparity_image:
            disp = out["disp_fine"] if "disp_fine" in out else out["disp_coarse"]
            Image.fromarray(cast_to_disparity_image(disp.cpu().numpy())).save(
                os.path.join(args.savedir, "disparity", f"{i:04d}.png"))
        print(f"Avg time per image: {sum(times) / (i + 1)}")
    return {"frames": n, "avg_time_per_image": sum(times) / max(n, 1), "times": times}


if __name__ == "__main__":
    main()
