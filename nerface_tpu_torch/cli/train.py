"""Train CLI of the PyTorch port (the reference's
`train_transformed_rays.py:26-36` arguments).

    # bf16 on the card: both passes of every step through K1, the rays
    # drawn on the card, 50 steps a window of CUDA-graph replays
    python -m nerface_tpu_torch.cli.train --config configs/synth512_devfeed.yml --bf16

    # data-parallel over the 4 cards of this host: 4 ranks, rank r on cuda:r
    python -m nerface_tpu_torch.cli.train --config c.yml --bf16 --num-devices 4
    # the same on the CPU over gloo, 2 ranks
    python -m nerface_tpu_torch.cli.train --config c.yml --device cpu --num-devices 2
    # one rank of a run whose ranks are started by hand (or on other hosts)
    python -m nerface_tpu_torch.cli.train --config c.yml --bf16 \
        --coordinator-address host0:29500 --num-processes 2 --process-id 1

SIGTERM exits with 143 through the loop's `finally` (the feed stopped, the
last checkpoint written, TensorBoard closed), so `cli/supervise.py` can
stop it and resume it. Under `--num-devices` the spawning process passes
SIGTERM on to its ranks and exits with 143 once they are gone.
"""

from __future__ import annotations

import argparse

import sys

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
        help="Data-parallel over this many devices of this host (0 = one device): N ranks, "
             "each a spawned process, rank r on cuda:r (NCCL), or all on the CPU with "
             "--device cpu (gloo).",
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
    parser.add_argument(
        "--coordinator-address", type=str, default=None, metavar="HOST:PORT",
        help="torch.distributed rendezvous (rank 0 listens there); with --num-processes / "
             "--process-id this process joins a data-parallel run as one rank (NCCL on a "
             "CUDA device, gloo on the CPU); --device cuda becomes cuda:<process-id modulo "
             "the card count>.",
    )
    parser.add_argument(
        "--num-processes", type=int, default=None,
        help="total process count for --coordinator-address.",
    )
    parser.add_argument(
        "--process-id", type=int, default=None,
        help="this process's id (0..num-processes-1).",
    )
    return parser


def _rank_main(argv, devices) -> None:
    """A `--num-devices` rank (a spawned process, already in the group):
    the same command line on this rank's device."""
    from nerface_tpu_torch.train import distributed

    main(list(argv) + ["--num-devices", "0", "--device", devices[distributed.rank()]])


def _spawn_ranks(args, argv) -> None:
    """`--num-devices N`: N ranks spawned on this host, rank r on cuda:r (or
    the CPU), joined over a free loopback port."""
    from nerface_tpu_torch.cli.eval import shard_devices
    from nerface_tpu_torch.train import distributed

    devices = [str(d) for d in shard_devices(args.num_devices, args.device)]
    distributed.spawn(_rank_main, len(devices), args=(argv, devices), devices=devices)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.coordinator_address and (args.num_processes is None or args.process_id is None):
        raise SystemExit("--coordinator-address needs --num-processes and --process-id")

    # A supervisor (cli/supervise.py) stops us with SIGTERM; turn it into
    # SystemExit so the loop's `finally` runs before the process dies.
    # 143 = 128 + SIGTERM, the conventional code.
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))

    if not args.coordinator_address and args.num_devices > 1:
        _spawn_ranks(args, argv)
        return

    import contextlib

    import torch

    from nerface_tpu_torch.config import load_config
    from nerface_tpu_torch.train import distributed
    from nerface_tpu_torch.train.loop import train
    from nerface_tpu_torch.utils.profiling import enable_debug, profile_trace

    device = args.device
    if args.coordinator_address:
        if torch.device(device).type == "cuda" and torch.device(device).index is None:
            device = f"cuda:{args.process_id % max(torch.cuda.device_count(), 1)}"
        distributed.initialize(args.coordinator_address, args.num_processes, args.process_id,
                               device=device)
    if args.matmul_precision:
        torch.set_float32_matmul_precision(MATMUL_PRECISION[args.matmul_precision])
    if args.debug_nans:
        enable_debug(nans=True)
    profiled = args.profile and distributed.is_primary()
    ctx = profile_trace(args.profile) if profiled else contextlib.nullcontext()
    with ctx:
        train(
            load_config(args.config),
            load_checkpoint=args.load_checkpoint,
            max_iters=args.max_iters,
            dtype=torch.bfloat16 if args.bf16 else None,
            device=device,
            steps_per_execute=args.steps_per_execute,
            device_feed=args.device_feed,
        )
    if args.coordinator_address:
        distributed.shutdown()


if __name__ == "__main__":
    main()
