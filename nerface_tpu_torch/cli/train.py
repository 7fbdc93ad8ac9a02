"""Train CLI of the PyTorch port (the reference's
`train_transformed_rays.py:26-36` arguments).

    # bf16 on the card: both passes of every step through K1, the rays
    # drawn on the card, 50 steps a window of CUDA-graph replays
    python -m nerface_tpu_torch.cli.train --config configs/synth512_devfeed.yml --bf16

`--num-devices` > 1 is not ported yet and is refused (ROADMAP.md Queue 1:
DDP).
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
        "--device-feed", action="store_true", default=None,
        help="Sample ray batches on the device (default: cfg.experiment.device_feed).",
    )
    parser.add_argument(
        "--steps-per-execute", type=int, default=None, metavar="K",
        help="Train steps per execution window: K replays of one captured CUDA graph on "
             "the card (default: cfg.experiment.steps_per_execute; auto = 50 at >= 2000 "
             "iterations, else 1).",
    )
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.num_devices > 1:
        raise SystemExit(
            "--num-devices > 1 is not yet ported to PyTorch (ROADMAP.md Queue 1: DDP)"
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
        device_feed=args.device_feed,
    )


if __name__ == "__main__":
    main()
