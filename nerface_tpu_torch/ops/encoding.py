"""Frequency positional encoding.

Port of `nerface_tpu/ops/encoding.py` (reference `nerf_helpers.py:195-249`):
optional input passthrough, log- or linear-spaced frequency bands, the
band-major [x, sin(f0 x), cos(f0 x), sin(f1 x), ...] layout, computed as
sin(x·f + φ) with φ = π/2 for the cos terms — the JAX package's form, so
both packages round the sin argument identically. The products x·f are
taken elementwise (one nonzero term per column of the JAX package's band
matrix C, so x @ C is exactly this product) in f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _frequency_bands(num_encoding_functions: int, log_sampling: bool) -> np.ndarray:
    if log_sampling:
        return 2.0 ** np.linspace(
            0.0, num_encoding_functions - 1, num_encoding_functions, dtype=np.float32
        )
    return np.linspace(
        2.0 ** 0.0,
        2.0 ** (num_encoding_functions - 1),
        num_encoding_functions,
        dtype=np.float32,
    )


@functools.lru_cache(maxsize=32)
def _encoding_matrix(d: int, num_encoding_functions: int, log_sampling: bool) -> tuple:
    """Static (D, 2·N·D) band-scatter matrix C and phase row φ such that
    the interleaved sin/cos encoding equals sin(x @ C + φ): column block
    2kD+d holds f_k at row d with φ=0 (sin), block (2k+1)D+d holds f_k with
    φ=π/2 (cos = sin shifted). Same values as the JAX package's."""
    bands = _frequency_bands(num_encoding_functions, log_sampling)
    n = num_encoding_functions
    C = np.zeros((d, 2 * n * d), np.float32)
    phase = np.zeros((2 * n * d,), np.float32)
    for k in range(n):
        for dd in range(d):
            C[dd, (2 * k) * d + dd] = bands[k]
            C[dd, (2 * k + 1) * d + dd] = bands[k]
            phase[(2 * k + 1) * d + dd] = np.pi / 2.0
    return C, phase


@functools.lru_cache(maxsize=32)
def _encoding_columns(d: int, num_encoding_functions: int, log_sampling: bool):
    """Per output column: (input row, frequency, phase) — the one nonzero
    of each column of C, as numpy arrays."""
    C, phase = _encoding_matrix(d, num_encoding_functions, log_sampling)
    rows = np.argmax(C != 0, axis=0)
    return rows, C[rows, np.arange(C.shape[1])], phase


@functools.lru_cache(maxsize=64)
def encoding_tables(d: int, num_encoding_functions: int, log_sampling: bool, dtype, device):
    """`_encoding_columns` as tensors on `device`: (input rows, frequencies,
    phases), copied there once. A copy from the host on every call would
    wait for the stream, and inside a captured CUDA graph it is refused."""
    rows, freqs, phase = _encoding_columns(d, num_encoding_functions, log_sampling)
    return (torch.as_tensor(rows, device=device), torch.as_tensor(freqs, dtype=dtype, device=device),
            torch.as_tensor(phase, dtype=dtype, device=device))


def positional_encoding(
    tensor: torch.Tensor,
    num_encoding_functions: int = 6,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """Encode `tensor` (..., D) -> (..., D * (include_input + 2*N))."""
    if num_encoding_functions == 0:
        return tensor if include_input else tensor[..., :0]
    d = tensor.shape[-1]
    rows, freqs, phase = encoding_tables(d, num_encoding_functions, log_sampling, tensor.dtype,
                                         tensor.device)
    enc = torch.sin(tensor[..., rows] * freqs + phase)
    if include_input:
        return torch.cat([tensor, enc], dim=-1)
    return enc



def encoding_dim(input_dim: int, num_encoding_functions: int, include_input: bool) -> int:
    """Feature size of `positional_encoding`'s output (`nerface_tpu/ops/encoding.py:94`)."""
    if num_encoding_functions == 0:
        return input_dim if include_input else 0
    return input_dim * ((1 if include_input else 0) + 2 * num_encoding_functions)


def get_embedding_function(
    num_encoding_functions: int = 6,
    include_input: bool = True,
    log_sampling: bool = True,
):
    """`positional_encoding` with its settings bound (reference `nerf_helpers.py:242-249`)."""
    return functools.partial(
        positional_encoding,
        num_encoding_functions=num_encoding_functions,
        include_input=include_input,
        log_sampling=log_sampling,
    )
