"""Image-quality metrics: host numpy, no skimage.

Port of `nerface_tpu/metrics/image.py` (the reference's `nerf/metrics.py:57-76`):

* PSNR = skimage's `compare_psnr` = 10·log10(data_range² / MSE), inf for
  identical images.
* SSIM = skimage's `compare_ssim(multichannel=True)`: a 7×7 uniform window,
  the unbiased covariance (N/(N-1)), K1 = 0.01, K2 = 0.03, each channel
  apart and the scores averaged, the (win//2)-pixel border cropped before
  the mean.
* L1 = the mean absolute difference (`metrics.py:119`).

`data_range` defaults to 1.0 for [0, 1] float images; old skimage inferred
2.0 for floats, which `data_range=2.0` reproduces.
"""

from __future__ import annotations

import numpy as np


def psnr(im1: np.ndarray, im2: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(im1, np.float64) - np.asarray(im2, np.float64)) ** 2))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def l1(im1: np.ndarray, im2: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(im1, np.float64) - np.asarray(im2, np.float64))))


def _ssim_single(x: np.ndarray, y: np.ndarray, win_size: int, data_range: float,
                 k1: float, k2: float) -> float:
    from scipy.ndimage import uniform_filter

    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    np_win = win_size**2
    cov_norm = np_win / (np_win - 1.0)  # unbiased, skimage's default

    ux = uniform_filter(x, win_size)
    uy = uniform_filter(y, win_size)
    uxx = uniform_filter(x * x, win_size)
    uyy = uniform_filter(y * y, win_size)
    uxy = uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return float(s[pad:-pad or None, pad:-pad or None].mean())


def ssim(im1: np.ndarray, im2: np.ndarray, data_range: float = 1.0, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03) -> float:
    """SSIM of two (H, W) or (H, W, C) images; channels scored apart and
    averaged (skimage's semantics)."""
    im1 = np.asarray(im1)
    im2 = np.asarray(im2)
    if im1.shape != im2.shape:
        raise ValueError(f"shape mismatch: {im1.shape} vs {im2.shape}")
    if im1.ndim == 2:
        return _ssim_single(im1, im2, win_size, data_range, k1, k2)
    return float(np.mean([
        _ssim_single(im1[..., c], im2[..., c], win_size, data_range, k1, k2)
        for c in range(im1.shape[-1])
    ]))
