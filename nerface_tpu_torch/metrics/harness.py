"""Folder-against-folder metrics harness.

Port of `nerface_tpu/metrics/harness.py` (the reference's
`nerf/metrics.py:20-148`): L1, PSNR, SSIM and LPIPS per image pair with
running means (`ScalarMetric`), an L2 heat map per pair (`L2/%04d.png`),
and `metrics.txt` written into the generated images' folder in the same
text layout.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from nerface_tpu_torch.metrics.image import l1, psnr, ssim

_KEYS = ("L1", "PSNR", "SSIM", "LPIPS")


class ScalarMetric:
    """Running mean (`metrics.py:20-42`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.num_observations = 0.0
        self.aggregated_value = 0.0

    def update(self, x: float) -> None:
        self.aggregated_value += x
        self.num_observations += 1

    def peek(self) -> float:
        return self.aggregated_value / (self.num_observations if self.num_observations > 0 else 1)

    def __repr__(self):
        return str(self.peek())


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(path)) / 255.0


def _numeric_sort(names):
    return sorted(names, key=lambda f: int("".join(filter(str.isdigit, f)) or 0))


def _pngs(folder: str):
    return _numeric_sort([f for f in os.listdir(folder)
                          if os.path.isfile(os.path.join(folder, f)) and f.endswith(".png")])


def _save_l2_image(im1: np.ndarray, im2: np.ndarray, outname: str) -> None:
    from PIL import Image

    from nerface_tpu_torch.eval.driver import error_image

    Image.fromarray(error_image(im1, im2)).save(outname)


def two_folders(
    path_gt: str,
    path_generated: str,
    lpips_weights: Optional[str] = None,
    data_range: float = 1.0,
    save_l2_images: bool = True,
    log: bool = True,
    device="cuda",
) -> Dict[str, float]:
    """Compare the ground-truth folder with the generated one, pairing the
    PNGs in numeric order; writes `metrics.txt` and `L2/%04d.png` into
    `path_generated` and returns the means. LPIPS runs on `device` when
    `lpips_weights` is given, else it is nan."""
    lpips_fn = None
    if lpips_weights:
        from nerface_tpu_torch.metrics.lpips import LPIPSAlex

        lpips_fn = LPIPSAlex(lpips_weights, device=device)

    metrics = {k: ScalarMetric() for k in _KEYS}
    names_gt, names_gen = _pngs(path_gt), _pngs(path_generated)
    if len(names_gen) > len(names_gt):
        raise ValueError(f"{len(names_gen)} generated images but {len(names_gt)} ground truth")
    if save_l2_images:
        os.makedirs(os.path.join(path_generated, "L2"), exist_ok=True)

    with open(os.path.join(path_generated, "metrics.txt"), "w") as fo:
        for i, (name_gt, name_gen) in enumerate(zip(names_gt, names_gen)):
            im_real = _load_image(os.path.join(path_gt, name_gt))[..., :3]
            im_gen = _load_image(os.path.join(path_generated, name_gen))[..., :3]
            if im_real.shape != im_gen.shape:
                raise ValueError(f"{name_gt} {im_real.shape} vs {name_gen} {im_gen.shape}")
            if save_l2_images:
                _save_l2_image(im_real, im_gen, os.path.join(path_generated, "L2", "%04d.png" % i))
            vals = {
                "L1": l1(im_real, im_gen),
                "PSNR": psnr(im_real, im_gen, data_range=data_range),
                "SSIM": ssim(im_real, im_gen, data_range=data_range),
                "LPIPS": lpips_fn(im_real, im_gen) if lpips_fn else float("nan"),
            }
            for k, v in vals.items():
                if not np.isnan(v):
                    metrics[k].update(v)
                fo.write(name_gen + "   %s:  \t%5f \n" % (k, v))
            fo.write("\n")

        fo.write("=" * 80)
        fo.write("\n Summary \n folder 1: %s \n folder 2: %s \n" % (path_gt, path_generated))
        fo.write("-" * 80)
        for k in _KEYS:
            fo.write("\n mean %s:\t%5f" % (k, metrics[k].peek()))
        fo.write("\n")

    summary = {k: m.peek() for k, m in metrics.items()}
    if lpips_fn is None:
        summary["LPIPS"] = float("nan")
    if log:
        print("=" * 80)
        print(" Summary\n folder 1: %s\n folder 2: %s" % (path_gt, path_generated))
        for k, v in summary.items():
            print(" mean %s:\t%5f" % (k, v))
    return summary
