"""Dense-layer helpers over `nn.Linear` (torch layout: weight (out, in)).

Port of `nerface_tpu/models/mlp.py`. The per-frame conditioning inputs
(expression, latent code) are constant over a batch, so for a layer
y = W @ [x; e; l] + b their columns contribute one (out,) vector, computed
once per frame and broadcast, instead of replicating (N, 76+32) inputs
like the reference (`models.py:239-242`). Same math.

`dtype=torch.bfloat16` rounds both operands to bf16 and multiplies them in
f32 — the JAX package's `preferred_element_type=f32` bf16 matmul (the
products of bf16 values are exact in f32).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def matmul_t(x: torch.Tensor, w: torch.Tensor, dtype=None) -> torch.Tensor:
    """x @ w.T in f32, with operands rounded to `dtype` first when given."""
    if dtype is not None and dtype != torch.float32:
        x = x.to(dtype).float()
        w = w.to(dtype).float()
    return x @ w.T


def linear(layer: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    return matmul_t(x, layer.weight, dtype) + layer.bias


def linear_cols(
    layer: nn.Linear,
    x: torch.Tensor,
    col_start: int,
    col_end: int,
    dtype=None,
    with_bias: bool = False,
) -> torch.Tensor:
    """Contribution of input columns [col_start, col_end) of a linear:
    x @ W[:, col_start:col_end].T (+ b)."""
    y = matmul_t(x, layer.weight[:, col_start:col_end], dtype)
    if with_bias:
        y = y + layer.bias
    return y


def cond_contribution(
    layer: nn.Linear,
    segments: Sequence[tuple],
    offset: int,
    dtype=None,
) -> Optional[torch.Tensor]:
    """Sum of column-slice contributions of per-frame constant inputs.
    segments: (vector (width,), width) pairs laid out from input column
    `offset`. Returns one (out,) vector."""
    total = None
    col = offset
    for vec, width in segments:
        contrib = linear_cols(layer, vec[None, :], col, col + width, dtype=dtype)[0]
        total = contrib if total is None else total + contrib
        col += width
    return total
