"""Dataset-builder CLI (a copy of `nerface_tpu/cli/build_dataset.py`) —
equivalent of `real_to_nerf.py:1490-1519` arg
surface, plus a --mode switch for the entry points the reference toggles by
editing source (:1505-1508).

    python -m nerface_tpu_torch.cli.build_dataset --source <tracker dir> --target <dataset dir>
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--source", type=str, required=True,
                        help="tracker output dir (images/, intrinsics.txt, "
                             "rigid.txt, expression.txt)")
    parser.add_argument("--target", type=str, required=True,
                        help="output dataset dir")
    parser.add_argument("--driving", type=str, default=None,
                        help="tracker dir of the DRIVING actor "
                             "(expressions + rotations) for --mode driven")
    parser.add_argument("--LESS_DATA", type=float, default=0.0, dest="less_data",
                        help="fraction of train frames to keep (0 = all)")
    parser.add_argument("--mode", type=str, default="train",
                        choices=["train", "original", "custom", "driven"],
                        help="train: build train/val splits; original/custom/"
                             "driven: generate a test sequence")
    parser.add_argument("--n-max", type=int, default=1000,
                        help="cap test-sequence length (reference uses 1000)")
    parser.add_argument("--reserve-test", type=int, default=1000,
                        help="reserve the last N frames for test "
                             "(the reference's DVP_PARTITION)")
    parser.add_argument("--mesh", type=str, default=None,
                        help="mean-face .off mesh for head-bbox detection "
                             "(e.g. the reference's average.off)")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--debug-vis", type=int, default=0, metavar="N",
                        help="also write N mean-face camera-overlay frames "
                             "to target/debug_vis (software rasterizer "
                             "equivalent of real_to_nerf.py:1520-1543; "
                             "requires --mesh)")
    parser.add_argument("--neutral-driving-idx", type=int, default=None)
    parser.add_argument("--neutral-target-idx", type=int, default=None)
    parser.add_argument("--sequence", type=str, default="open_mouth_xyz",
                        choices=["presentation", "xyz", "open_mouth",
                                 "open_mouth_xyz", "teaser"],
                        help="--mode custom generator; default matches the "
                             "reference's live branch "
                             "(real_to_nerf.py:1255)")
    parser.add_argument("--seq-start", type=int, default=None,
                        help="first frame of the source's test tail for "
                             "waypoint sequences (reference hardcodes "
                             "per-person values, e.g. 5506)")
    parser.add_argument("--neutral-offset", type=int, default=None,
                        help="offset of the neutral frame from --seq-start")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from nerface_tpu_torch.tools.dataset_builder import (
        BuilderConfig,
        build_dataset,
        generate_custom_test_sequence,
        generate_driven_test_sequence,
        generate_original_test_sequence,
        write_debug_overlays,
    )

    cfg = BuilderConfig(
        source=args.source,
        target=args.target,
        driving=args.driving,
        less_data=args.less_data,
        reserve_test=args.reserve_test,
        mesh_path=args.mesh,
        seed=args.seed,
        neutral_driving_idx=args.neutral_driving_idx,
        neutral_target_idx=args.neutral_target_idx,
    )
    if args.debug_vis:
        write_debug_overlays(cfg, range(args.debug_vis))
    if args.mode == "train":
        build_dataset(cfg)
    elif args.mode == "original":
        generate_original_test_sequence(cfg, args.n_max)
    elif args.mode == "custom":
        seq_kwargs = {}
        if args.sequence != "presentation" and args.sequence != "teaser":
            if args.seq_start is not None:
                seq_kwargs["seq_start"] = args.seq_start
            if args.neutral_offset is not None:
                seq_kwargs["neutral_offset"] = args.neutral_offset
        generate_custom_test_sequence(
            cfg, args.n_max, sequence=args.sequence, **seq_kwargs
        )
    elif args.mode == "driven":
        generate_driven_test_sequence(cfg, args.n_max)
    print("Done.")


if __name__ == "__main__":
    main()
