"""Metrics CLI of the PyTorch port: the JAX package's `cli/metrics.py`
arguments (the reference's `nerf/metrics.py:153-179`), plus `--device`
for LPIPS.

    python -m nerface_tpu_torch.cli.metrics --gt_path <dataset>/test --images_path renders/

writes `renders/metrics.txt` and `renders/L2/%04d.png`.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--gt_path", type=str, default="", help="directory of GT images")
    parser.add_argument("--images_path", type=str, default="",
                        help="directory of generated images")
    parser.add_argument("--mode", type=str, default="folders", help="folders | images")
    parser.add_argument("--lpips-weights", type=str, default=None,
                        help="combined LPIPS-alex state_dict (optional; LPIPS reported as nan "
                             "without it)")
    parser.add_argument("--data-range", type=float, default=1.0,
                        help="PSNR/SSIM data range (2.0 replicates legacy skimage float "
                             "behavior)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device for LPIPS (default cuda).")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.mode != "folders":
        raise SystemExit("only --mode folders is supported")
    from nerface_tpu_torch.metrics.harness import two_folders

    return two_folders(args.gt_path, args.images_path, lpips_weights=args.lpips_weights,
                       data_range=args.data_range, device=args.device)


if __name__ == "__main__":
    main()
