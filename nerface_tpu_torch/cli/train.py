"""Train CLI of the PyTorch port (the reference's
`train_transformed_rays.py:26-36` arguments).

    # bf16 on the card: both passes of every step through K1
    python -m nerface_tpu_torch.cli.train --config configs/synth512_paper.yml --bf16

Options of the JAX package's CLI that are not ported yet are refused:
`--num-devices` > 1, `--device-feed` and `--steps-per-execute` > 1
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True, help="Path to (.yml) config file.")
    parser.add_argument(
        "--load-checkpoint", type=str, default="",
        help="Reference-schema torch .ckpt to resume from.",
    )
    parser.add_argument(
        "--max-iters", type=int, default=None, help="Override cfg.experiment.train_iters."
    )
    parser.add_argument(
        "--bf16", action="store_true",
        help="bfloat16 compute (f32 params): the fused training kernel on the card.",
    )
    parser.add_argument(
        "--device", type=str, default="cuda", help="Torch device to train on (default cuda)."
    )
    parser.add_argument(
        "--num-devices", type=int, default=0,
        help="Data-parallel devices (not yet ported: > 1 is refused).",
    )
    parser.add_argument(
        "--device-feed", action="store_true",
        help="Sample ray batches on the device (not yet ported: refused).",
    )
    parser.add_argument(
        "--steps-per-execute", type=int, default=None, metavar="K",
        help="Train steps per execution window (not yet ported: > 1 is refused).",
    )
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.num_devices > 1:
        raise SystemExit(
            "--num-devices > 1 is not yet ported to PyTorch (ROADMAP.md Queue 1: DDP)"
        )
    if args.device_feed:
        raise SystemExit(
            "--device-feed is not yet ported to PyTorch (ROADMAP.md Queue 1: DeviceRayFeed)"
        )
    if args.steps_per_execute is not None and args.steps_per_execute > 1:
        raise SystemExit(
            "--steps-per-execute > 1 is not yet ported to PyTorch (ROADMAP.md Queue 1: the "
            "CUDA-graph execution window)"
        )

    import torch

    from nerface_tpu_torch.config import load_config
    from nerface_tpu_torch.train.loop import train

    train(
        load_config(args.config),
        load_checkpoint=args.load_checkpoint,
        max_iters=args.max_iters,
        dtype=torch.bfloat16 if args.bf16 else None,
        device=args.device,
        steps_per_execute=args.steps_per_execute,
    )


if __name__ == "__main__":
    main()
