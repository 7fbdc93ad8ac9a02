"""Numerically safe primitives whose gradients follow torch's conventions.

Port of `nerface_tpu/ops/safe.py`.
"""

from __future__ import annotations

import torch


class _SafeNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        n = torch.sqrt(torch.sum(x * x))
        ctx.save_for_backward(x, n)
        return n

    @staticmethod
    def backward(ctx, g):
        x, n = ctx.saved_tensors
        grad = torch.where(n > 0, x / torch.where(n > 0, n, torch.ones_like(n)), torch.zeros_like(x))
        return g * grad


def safe_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm of all of `x` with subgradient 0 at the origin. The
    reference's latent-code regularizer ‖code‖·0.0005
    (`train_transformed_rays.py:372`) is applied to codes that start at
    exactly zero, where d‖x‖/dx = x/‖x‖ would be 0/0."""
    return _SafeNorm.apply(x)
