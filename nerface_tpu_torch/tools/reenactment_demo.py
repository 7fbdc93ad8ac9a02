"""End-to-end cross-actor reenactment demo on two synthetic identities: the
port of the repository's `tools/reenactment_demo.py`.

The paper's headline capability (`real_to_nerf.py:497-601` +
`eval_transformed_rays.py:392-467`), through the port's components in
sequence:

1. two synthetic face-tracker outputs (identities differ by neutral
   expression offset and camera path), frames rendered by the analytic
   expression-conditioned blob (`data/synthetic.render_blob_frame`);
2. `tools/dataset_builder.build_dataset` → the TARGET identity's NeRF
   dataset (train/val splits, index_map.npy);
3. `train.loop.train` → a person-specific avatar (bf16 on the card: K1
   takes the training passes, K2 the validations);
4. `generate_original_test_sequence` → self-reenactment test split (GT
   available) → `eval.driver.evaluate` → `metrics.harness` PSNR/SSIM/L1;
5. `generate_driven_test_sequence` → the DRIVING identity's head rotations
   and neutral-relative expression deltas transferred onto the target
   (`driven_sequence`) → `eval.driver.evaluate` renders the reenactment;
6. a driving | reenacted | normals triptych AVI by `tools/video_writer.py`.

    python -m nerface_tpu_torch.tools.reenactment_demo [--iters 3000] [--size 64]
        [--frames 60] [--workdir DIR] [--device cuda|cpu] [--bf16]

The schedule is `configs/synth512_paper.yml` (the reference's
`dave_dvp_lcode_fixed_bg_512_paper_model.yml` schedule) with the JAX
demo's overrides. bf16 is on by default on a CUDA device. Below 128² the
demo trains 512 rays at 16 + 16 samples, which the hand kernels take as
they take the production 64 + 64 (K1 in training, K2 in validation and
evaluation). Results are printed and written to <workdir>/summary.json.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PAPER_CONFIG = os.path.join(REPO_ROOT, "configs", "synth512_paper.yml")
VIDEO_WRITER = os.path.join(REPO_ROOT, "tools", "video_writer.py")


def make_tracker_identity(
    path: str, n_frames: int, seed: int, neutral_e0: float,
    H: int, W: int, yaw_amp: float = 8.0,
) -> None:
    """Synthetic tracker output: images/ + intrinsics.txt + rigid.txt +
    expression.txt, in the RAW tracker conventions that
    `dataset_builder.read_*` undo (sign flips, pre-scale poses)."""
    from PIL import Image

    from nerface_tpu_torch.data.synthetic import _checkerboard, render_blob_frame
    from nerface_tpu_torch.tools.dataset_builder import look_at

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(path, "images"), exist_ok=True)

    rel = np.array([-1.5, -1.5, 0.5, 0.5])  # read_intrinsics flips fx/fy
    np.savetxt(os.path.join(path, "intrinsics.txt"), rel[None])
    # render_blob_frame's convention: pixel focals, RELATIVE centers
    intr_px = np.array([1.5 * W, 1.5 * H, 0.5, 0.5], np.float32)

    # expressions: identity-specific neutral + smooth sinusoidal play on
    # the two components the blob responds to
    t = np.linspace(0, 4 * np.pi, n_frames)
    expr = np.zeros((n_frames, 76))
    expr[:, 0] = neutral_e0 + 0.6 * np.sin(t)
    expr[:, 1] = 0.5 * np.cos(1.7 * t)
    expr[:, 2:] = 0.02 * rng.randn(n_frames, 74)
    np.savetxt(os.path.join(path, "expression.txt"), expr)

    bg = _checkerboard(H, W)
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        # camera z pinned to exactly 0.5 so the loader's mean-z rescale
        # (`read_rigid_poses`) is the identity and dataset poses match the
        # cameras the frames were rendered with bit-for-bit
        yaw = np.deg2rad(yaw_amp * np.sin(t[i] * 0.5))
        cam = np.array([0.5 * np.tan(yaw), 0.02 * np.sin(t[i]), 0.5])
        c2w = look_at(cam, np.zeros(3))
        img = render_blob_frame(H, W, intr_px, c2w.astype(np.float32), expr[i], bg)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(path, "images", f"{i:05d}.png"))
        raw = c2w.copy()
        raw[:, 0] *= -1  # read_rigid_poses re-negates columns 0 and 2
        raw[:, 2] *= -1
        poses[i] = raw
    if abs(np.mean(poses[:, 2, -1]) - 0.5) >= 1e-12:
        raise AssertionError("the cameras' mean z must be 0.5")
    np.savetxt(os.path.join(path, "rigid.txt"), poses.reshape(n_frames, -1))
    # the background the datasets will carry
    Image.fromarray((bg * 255).astype(np.uint8)).save(os.path.join(path, "background.png"))


def scaled_config(ds_dir: str, logdir: str, iters: int, size: int) -> dict:
    """`configs/synth512_paper.yml` with the JAX demo's overrides."""
    import yaml

    with open(PAPER_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"]["basedir"] = ds_dir
    cfg["dataset"]["half_res"] = False
    cfg["experiment"].update(
        logdir=logdir, id="avatar", train_iters=iters,
        # the cadences must share a large common divisor, or the execution
        # window (train/loop._effective_window) collapses toward K = 1
        print_every=max(iters // 10, 1), validate_every=max(iters // 4, 1),
        # the loop always writes a final checkpoint at train_iters - 1; a
        # round save_every keeps the cadences divisible
        save_every=iters,
    )
    if size >= 128:
        # the paper config's production shape (2048 rays, 64 + 64 samples)
        # and the device feed
        cfg["nerf"]["validation"].update(chunksize=min(size * size, 65536))
        cfg["experiment"]["device_feed"] = True
    else:
        # the small smoke regime
        cfg["nerf"]["train"].update(num_random_rays=512, num_coarse=16, num_fine=16)
        cfg["nerf"]["validation"].update(num_coarse=16, num_fine=16,
                                         chunksize=min(size * size, 16384))
    return cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--workdir", type=str,
                    default=os.path.join(tempfile.gettempdir(), "reenact_demo"))
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the card) or cpu; there is no fallback")
    ap.add_argument("--bf16", action="store_true", default=None,
                    help="bf16 training and rendering (default: on for a CUDA device)")
    return ap


def main(argv=None) -> dict:
    """Run the demo; returns the summary written to <workdir>/summary.json."""
    args = build_parser().parse_args(argv)

    import importlib.util
    import shutil

    import torch
    import yaml
    from PIL import Image

    from nerface_tpu_torch.config import EvalFlags, load_config
    from nerface_tpu_torch.eval.driver import evaluate
    from nerface_tpu_torch.metrics.harness import two_folders
    from nerface_tpu_torch.tools.dataset_builder import (
        BuilderConfig,
        build_dataset,
        generate_driven_test_sequence,
        generate_original_test_sequence,
    )
    from nerface_tpu_torch.train.checkpoint import latest_checkpoint
    from nerface_tpu_torch.train.loop import train

    device = torch.device(args.device)
    bf16 = args.bf16
    if bf16 is None:
        bf16 = device.type == "cuda"
    dtype = torch.bfloat16 if bf16 else None

    w = args.workdir
    os.makedirs(w, exist_ok=True)
    drv_dir = os.path.join(w, "tracker_driving")
    tgt_dir = os.path.join(w, "tracker_target")
    n = args.frames
    if not os.path.exists(os.path.join(tgt_dir, "rigid.txt")):
        print("[demo] building two synthetic tracker identities ...", flush=True)
        make_tracker_identity(drv_dir, n, seed=1, neutral_e0=0.4,
                              H=args.size, W=args.size, yaw_amp=14.0)
        make_tracker_identity(tgt_dir, n, seed=2, neutral_e0=-0.4,
                              H=args.size, W=args.size, yaw_amp=6.0)

    ds_dir = os.path.join(w, "target_ds")
    bcfg = BuilderConfig(
        source=tgt_dir, target=ds_dir, driving=drv_dir, reserve_test=10,
        n_val=4, n_test=0, seed=0,
        neutral_driving_idx=0, neutral_target_idx=0,
    )
    if not os.path.exists(os.path.join(ds_dir, "transforms_train.json")):
        print("[demo] building the target identity's NeRF dataset ...", flush=True)
        build_dataset(bcfg, log=False)
        # the loader reads all three splits: the original test tail up
        # front (regenerated for each evaluation below)
        generate_original_test_sequence(bcfg, log=False)
        shutil.copy(os.path.join(tgt_dir, "background.png"),
                    os.path.join(ds_dir, "bg", "00050.png"))

    cfg_path = os.path.join(w, "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.dump(scaled_config(ds_dir, os.path.join(w, "logs"), args.iters, args.size), f)
    cfg = load_config(cfg_path)

    logdir = os.path.join(w, "logs", "avatar")
    ckpt = latest_checkpoint(logdir) if os.path.isdir(logdir) else None
    if ckpt is None:
        print(f"[demo] training the avatar ({args.iters} iters, bf16={bf16}, "
              f"{device}) ...", flush=True)
        train(cfg, dtype=dtype, device=device)
        ckpt = latest_checkpoint(logdir)
    print(f"[demo] checkpoint: {ckpt}", flush=True)

    summary = {}

    # self-reenactment: the original test tail, GT available -> metrics
    print("[demo] self-reenactment (original test sequence) ...", flush=True)
    generate_original_test_sequence(bcfg, log=False)
    self_dir = os.path.join(w, "renders_self")
    r = evaluate(cfg, ckpt, self_dir, eval_flags=EvalFlags(), save_error_image=True,
                 log=False, dtype=dtype, device=device)
    m = two_folders(os.path.join(ds_dir, "test"), self_dir, log=False, device=device)
    summary["self_reenactment"] = {
        "frames": r["frames"], "s_per_frame": r["avg_time_per_image"],
        "psnr": float(m["PSNR"]), "ssim": float(m["SSIM"]), "l1": float(m["L1"]),
    }
    print(f"[demo]   {summary['self_reenactment']}", flush=True)

    # cross-actor reenactment: the driving identity's deltas + rotations
    print("[demo] cross-actor driven sequence (expression-delta transfer) ...", flush=True)
    generate_driven_test_sequence(bcfg, n_max=n, log=False)
    driven_dir = os.path.join(w, "renders_driven")
    r = evaluate(cfg, ckpt, driven_dir, eval_flags=EvalFlags(), log=False, dtype=dtype,
                 device=device)
    rendered = sorted(f for f in os.listdir(driven_dir) if f.endswith(".png"))
    # the driven renders must react to the driving expressions (the blob's
    # radius follows e0): frame-to-frame variance
    frames = np.stack([np.asarray(Image.open(os.path.join(driven_dir, f)), np.float32)
                       for f in rendered[:20]])
    temporal_std = float(frames.std(axis=0).mean())
    summary["cross_reenactment"] = {
        "frames": r["frames"], "s_per_frame": r["avg_time_per_image"],
        "temporal_std": temporal_std,
    }
    print(f"[demo]   {summary['cross_reenactment']}", flush=True)
    if not temporal_std > 1.0:
        raise AssertionError("driven renders look static — expression transfer not reaching "
                             "the avatar")

    # driving actor | reenacted render | normals (the reference's
    # videos.txt composition), without ffmpeg
    spec = importlib.util.spec_from_file_location("video_writer", VIDEO_WRITER)
    vw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vw)
    video_path = os.path.join(w, "reenactment.avi")
    vw.main([video_path, os.path.join(drv_dir, "images"), driven_dir,
             os.path.join(driven_dir, "normals"), "--fps", "25"])
    summary["video"] = video_path

    with open(os.path.join(w, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"[demo] wrote {os.path.join(w, 'summary.json')}", flush=True)
    return summary


if __name__ == "__main__":
    main()
