"""Gaussian smoothing (a depthwise convolution).

Port of `nerface_tpu/utils/smoothing.py` (reference `train_utils.py:379-443`,
`GaussianSmoothing`): blurs the trainable background's initialisation
(`train_transformed_rays.py:147-152`). The kernel is a product of per-axis
1-D Gaussians whose std sits inside the square, exp(−((x − mean)/(2·std))²),
a quirk of the reference kept for parity, and the convolution pads by 5.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(kernel_size, sigma, dim: int = 2) -> np.ndarray:
    if isinstance(kernel_size, (int, float)):
        kernel_size = [int(kernel_size)] * dim
    if isinstance(sigma, (int, float)):
        sigma = [float(sigma)] * dim
    kernel = np.array(1.0, np.float32)
    grids = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in kernel_size], indexing="ij")
    for size, std, mgrid in zip(kernel_size, sigma, grids):
        mean = (size - 1) / 2.0
        kernel = kernel * (
            1.0 / (std * math.sqrt(2 * math.pi)) * np.exp(-(((mgrid - mean) / (2 * std)) ** 2))
        )
    return kernel / kernel.sum()


def gaussian_smooth(
    image: torch.Tensor, kernel_size: int = 11, sigma: float = 11.0, padding: int = 5
) -> torch.Tensor:
    """Blur an (H, W, C) image with a depthwise Gaussian (padding 5, as the
    reference's conv call, `train_utils.py:442`)."""
    k = torch.as_tensor(gaussian_kernel(kernel_size, sigma, dim=2), device=image.device)
    C = image.shape[-1]
    x = image.permute(2, 0, 1)[None].to(torch.float32)  # (1, C, H, W)
    w = k[None, None].repeat(C, 1, 1, 1)  # (C, 1, kh, kw) depthwise
    y = F.conv2d(x, w, padding=padding, groups=C)
    return y[0].permute(1, 2, 0)
