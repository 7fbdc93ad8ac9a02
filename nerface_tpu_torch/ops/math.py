"""Small numeric helpers shared across the pipeline.

Port of `nerface_tpu/ops/math.py`: `img2mse`, `meshgrid_xy`,
`cumprod_exclusive` and `mse2psnr` (the PSNR of an MSE tensor),
plus `linspace01`, which reproduces `jnp.linspace(0, 1, n)` bit for bit
(torch's and numpy's linspace round differently in the last place, and
the sample depths must match the JAX package's exactly).
"""

from __future__ import annotations

import torch


def img2mse(img_src: torch.Tensor, img_tgt: torch.Tensor) -> torch.Tensor:
    return torch.mean((img_src - img_tgt) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    """PSNR of an MSE tensor, clamped at 1e-5 as the JAX package does."""
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-5))


def meshgrid_xy(tensor1: torch.Tensor, tensor2: torch.Tensor):
    """np.meshgrid(..., indexing='xy') semantics: (ii, jj) of shape
    (len(tensor2), len(tensor1)); ii varies along columns, jj along rows."""
    ii, jj = torch.meshgrid(tensor1, tensor2, indexing="xy")
    return ii, jj


class _CumprodNonzero(torch.autograd.Function):
    """`torch.cumprod` along the last axis of a tensor with no zero. Its
    gradient is torch's own for that case (`cumprod_backward`:
    reversed_cumsum(output·grad) / input), taken without torch's test for
    zeros, which reads a flag back to the host and so cannot run inside a
    captured CUDA graph."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        if x.numel() <= 1 or x.shape[-1] == 1:
            return g
        return torch.flip(torch.flip(out * g, [-1]).cumsum(-1), [-1]).div(x)


def cumprod_exclusive(tensor: torch.Tensor) -> torch.Tensor:
    """tf.math.cumprod(..., exclusive=True) along the last axis:
    [a, b, c] -> [1, a, ab], for a `tensor` with no zero (the compositing's
    1 − α + 1e-10): its gradient reads nothing back to the host."""
    cumprod = _CumprodNonzero.apply(tensor)
    return torch.cat([torch.ones_like(cumprod[..., :1]), cumprod[..., :-1]], dim=-1)


def linspace01(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """`jnp.linspace(0.0, 1.0, n)` as the JAX package computes it on the
    CPU: i · (1 / (n - 1)) in f32 for i < n - 1 (XLA turns its division by
    the constant n - 1 into this product), then 1."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    head = torch.arange(n - 1, dtype=dtype, device=device) * (1.0 / (n - 1))
    return torch.cat([head, torch.ones(1, dtype=dtype, device=device)])
