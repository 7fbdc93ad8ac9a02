"""Avatar serving CLI for the PyTorch port: a resident render server over a
reference-schema `.ckpt`. Protocol: newline-delimited JSON (see
`nerface_tpu_torch/serve.py`).

    # stdio
    echo '{"frame": 0, "save": "out_"}' | \
        python -m nerface_tpu_torch.cli.serve --config c.yml --checkpoint m.ckpt --stdio

    # TCP, bf16 on the card: both passes through the fused-render kernel
    python -m nerface_tpu_torch.cli.serve --config c.yml --checkpoint m.ckpt \
        --listen 0.0.0.0:7860 --bf16 --device cuda
    # each frame sharded over the host's first 2 cards
    python -m nerface_tpu_torch.cli.serve --config c.yml --checkpoint m.ckpt --stdio \
        --bf16 --num-devices 2
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument(
        "--checkpoint", type=str, required=True,
        help="Reference-schema torch .ckpt to serve.",
    )
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument(
        "--stdio", action="store_true",
        help="Serve JSONL requests on stdin, responses on stdout.",
    )
    mode.add_argument(
        "--listen", type=str, metavar="HOST:PORT",
        help="Serve the JSONL protocol over TCP.",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Torch device to render on (default cuda).",
    )
    parser.add_argument(
        "--fast-eval", action="store_true",
        help="Head-bbox ray skipping (sets nerf.validation.fast_eval; with "
        "nerf.validation.occupancy the occupancy grid too): the production "
        "serving configuration with --bf16.",
    )
    parser.add_argument(
        "--bf16", action="store_true",
        help="Render in bfloat16 (the fused-render kernel on the card).",
    )
    parser.add_argument(
        "--num-devices", type=int, default=0,
        help="Shard each frame over this many devices: cuda:0..N-1, or N times the CPU "
        "with --device cpu.",
    )
    parser.add_argument(
        "--warmup", action="store_true",
        help="Render one frame before accepting requests.",
    )
    parser.add_argument(
        "--max-requests", type=int, default=None,
        help="Exit after this many requests (testing/draining).",
    )
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import sys

    from nerface_tpu_torch.cli.eval import shard_devices

    devices = shard_devices(args.num_devices, args.device)

    import torch

    from nerface_tpu_torch.config import load_config
    from nerface_tpu_torch.serve import AvatarServer

    cfg = load_config(args.config)
    if args.fast_eval:
        cfg.nerf.validation["fast_eval"] = True
    server = AvatarServer(
        cfg, checkpoint=args.checkpoint,
        dtype=torch.bfloat16 if args.bf16 else None,
        device=args.device,
        devices=devices,
    )
    if args.warmup:
        server.render(maps=("rgb_fine",))
        print("[serve] warmup render done", file=sys.stderr, flush=True)

    if args.stdio:
        n = server.serve_jsonl(sys.stdin, sys.stdout, max_requests=args.max_requests)
    else:
        host, _, port = args.listen.rpartition(":")
        n = server.serve_tcp(host or "127.0.0.1", int(port), max_requests=args.max_requests)
    print(f"[serve] handled {n} requests", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
