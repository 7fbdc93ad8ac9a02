"""Train CLI of the PyTorch port (the reference's
`train_transformed_rays.py:26-36` arguments).

    # bf16 on the card: both passes of every step through K1, the rays
    # drawn on the card, 50 steps a window of CUDA-graph replays
    python -m nerface_tpu_torch.cli.train --config configs/synth512_devfeed.yml --bf16

SIGTERM exits with 143 through the loop's `finally` (the feed stopped, the
last checkpoint written, TensorBoard closed), so `cli/supervise.py` can
stop it and resume it. `--num-devices` > 1 is not ported yet and is
refused (ROADMAP.md Queue 1: DDP).
"""

from __future__ import annotations

import argparse

from nerface_tpu_torch.cli.eval import MATMUL_PRECISION


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
    parser.add_argument(
        "--export-torch", action="store_true",
        help="Accepted for the JAX CLI's command lines and does nothing: the port's "
             "checkpoints are always reference-schema torch .ckpt files.",
    )
    parser.add_argument(
        "--profile", type=str, default=None, metavar="LOGDIR",
        help="Record a torch.profiler trace of the run (CPU ops and CUDA kernels) into "
             "LOGDIR/trace.json.",
    )
    parser.add_argument(
        "--debug-nans", action="store_true",
        help="Autograd anomaly detection: fail at the backward op that made a NaN. It "
             "reads every gradient back to the host, so the loop runs one step a window.",
    )
    parser.add_argument(
        "--matmul-precision", type=str, default=None, choices=sorted(MATMUL_PRECISION),
        help="f32 matmul precision, JAX's names onto torch.set_float32_matmul_precision "
             "(as cli/eval.py): 'default' -> 'medium' (bf16-based), 'high' -> 'high' "
             "(TF32), 'highest' -> 'highest' (strict f32). The bf16 kernels are not "
             "affected.",
    )
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    # A supervisor (cli/supervise.py) stops us with SIGTERM; turn it into
    # SystemExit so the loop's `finally` runs before the process dies.
    # 143 = 128 + SIGTERM, the conventional code.
    import signal
    import sys

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))

    if args.num_devices > 1:
        raise SystemExit(
            "--num-devices > 1 is not yet ported to PyTorch (ROADMAP.md Queue 1: DDP)"
        )

    import contextlib

    import torch

    from nerface_tpu_torch.config import load_config
    from nerface_tpu_torch.train.loop import train
    from nerface_tpu_torch.utils.profiling import enable_debug, profile_trace

    if args.matmul_precision:
        torch.set_float32_matmul_precision(MATMUL_PRECISION[args.matmul_precision])
    if args.debug_nans:
        enable_debug(nans=True)
    ctx = profile_trace(args.profile) if args.profile else contextlib.nullcontext()
    with ctx:
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
