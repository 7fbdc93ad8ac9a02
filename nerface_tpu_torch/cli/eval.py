"""Eval / reenactment CLI of the PyTorch port: the JAX package's
`cli/eval.py` arguments (the reference's `eval_transformed_rays.py:203-222`,
its hardcoded ablation switches, :374-380,420, exposed as flags or
`cfg.eval.*` keys), plus `--device` and `--bf16`.

    # bf16 on the card: each pass of each tile of a frame is one K2 launch
    python -m nerface_tpu_torch.cli.eval --config configs/synth512_devfeed.yml \\
        --checkpoint run.ckpt --savedir renders/ --bf16 --save-disparity-image
    # the CPU (f32, the kernels' plain versions)
    python -m nerface_tpu_torch.cli.eval --config c.yml --checkpoint run.ckpt --device cpu
    # each frame's rays sharded over the host's first 2 cards
    python -m nerface_tpu_torch.cli.eval --config c.yml --checkpoint run.ckpt --bf16 \
        --num-devices 2
"""

from __future__ import annotations

import argparse
import dataclasses

# JAX's precision names onto torch.set_float32_matmul_precision's
MATMUL_PRECISION = {"default": "medium", "high": "high", "highest": "highest"}


def shard_devices(num_devices: int, device: str):
    """`--num-devices N` with `--device`: the N devices to spread over —
    cuda:0..N-1, or the CPU N times with `--device cpu` — or None below 2.
    N beyond the host's cards is refused."""
    if not num_devices or num_devices < 2:
        return None
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if num_devices > count:
            raise SystemExit(f"--num-devices {num_devices}: this host has {count} CUDA "
                             f"device(s)")
        return [torch.device("cuda", i) for i in range(num_devices)]
    return [dev] * num_devices


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True, help="Path to (.yml) config file.")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Reference-schema torch .ckpt to evaluate.")
    parser.add_argument("--savedir", type=str, default="./renders/",
                        help="Save images to this directory.")
    parser.add_argument("--save-disparity-image", action="store_true",
                        help="Save disparity images too.")
    parser.add_argument("--save-error-image", action="store_true",
                        help="Save photometric error visualization.")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--num-devices", type=int, default=0,
                        help="Shard each frame's rays over this many devices: cuda:0..N-1, "
                             "or N times the CPU with --device cpu.")
    parser.add_argument("--matmul-precision", type=str, default=None,
                        choices=sorted(MATMUL_PRECISION),
                        help="f32 matmul precision ('highest' = strict f32), through "
                             "torch.set_float32_matmul_precision.")
    parser.add_argument("--no-background", action="store_true")
    parser.add_argument("--no-expressions", action="store_true")
    parser.add_argument("--no-lcode", action="store_true")
    parser.add_argument("--nerf", action="store_true",
                        help="Static-NeRF ablation (implies the three above).")
    parser.add_argument("--frontalize", action="store_true")
    parser.add_argument("--interpolate-mouth", action="store_true")
    parser.add_argument("--ablate", type=str, default=None,
                        choices=["expression", "latent_code", "view_dir"])
    parser.add_argument("--per-frame-latent", action="store_true",
                        help="Use idx_map[i] latent codes instead of the reference's pinned "
                             "idx_map[10].")
    parser.add_argument("--fast-eval", action="store_true",
                        help="Opt-in fast eval: skip rays outside the test split's head-bbox "
                             "union (off the parity path; equals nerf.validation.fast_eval).")
    parser.add_argument("--occupancy", action="store_true",
                        help="With --fast-eval: tighten the skip region to rays touching an "
                             "occupancy grid built from the trained field (equals "
                             "nerf.validation.occupancy).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to render on (default cuda).")
    parser.add_argument("--bf16", action="store_true",
                        help="Render in bfloat16 (the fused-render kernel on the card).")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    devices = shard_devices(args.num_devices, args.device)

    import torch

    from nerface_tpu_torch.config import load_config
    from nerface_tpu_torch.config.flags import EvalFlags
    from nerface_tpu_torch.eval.driver import evaluate

    cfg = load_config(args.config)
    flags = EvalFlags.from_cfg(cfg)
    flags = dataclasses.replace(
        flags,
        no_background=args.no_background or flags.no_background,
        no_expressions=args.no_expressions or flags.no_expressions,
        no_lcode=args.no_lcode or flags.no_lcode,
        nerf=args.nerf or flags.nerf,
        frontalize=args.frontalize or flags.frontalize,
        interpolate_mouth=args.interpolate_mouth or flags.interpolate_mouth,
        ablate=args.ablate if args.ablate is not None else flags.ablate,
        fix_latent_code_index=False if args.per_frame_latent else flags.fix_latent_code_index,
    )
    if args.fast_eval:
        cfg.nerf.validation["fast_eval"] = True
    if args.occupancy:
        cfg.nerf.validation["fast_eval"] = True
        cfg.nerf.validation["occupancy"] = True
    if args.matmul_precision:
        torch.set_float32_matmul_precision(MATMUL_PRECISION[args.matmul_precision])

    summary = evaluate(
        cfg, checkpoint=args.checkpoint, savedir=args.savedir, eval_flags=flags,
        save_disparity_image=args.save_disparity_image,
        save_error_image=args.save_error_image, max_frames=args.max_frames,
        dtype=torch.bfloat16 if args.bf16 else None, device=args.device, devices=devices,
    )
    print(f"Rendered {int(summary['frames'])} frames; "
          f"avg time per image: {summary['avg_time_per_image']:.4f}s")
    return summary


if __name__ == "__main__":
    main()
