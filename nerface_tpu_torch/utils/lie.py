"""SO(3) / SE(3) exponential and logarithm maps in torch.

Port of `nerface_tpu/utils/lie.py` (the reference's `lieutils.py:41-737`,
pose-refinement scaffolding: unused by the train / eval path, part of the
public surface). The maps are plain differentiable functions. Near θ = 0
their sinc-like coefficients take a Taylor value, and the exact branch is
fed a safe θ (1) there before it is evaluated: `torch.where` passes the
untaken branch a zero gradient, and 0 · NaN is NaN, so selecting after
the fact would not keep the gradient finite.

`so3_exponential_map` is the pytorch3d name the reference imports
(`nerf_helpers.py:4,177`).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], -1),
            torch.stack([wz, zeros, -wx], -1),
            torch.stack([-wy, wx, zeros], -1),
        ],
        -2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _taylor_safe(theta_sq, exact_fn, taylor_val):
    """`exact_fn(θ)` where θ² ≥ _EPS, `taylor_val` elsewhere; the exact
    branch sees θ = 1 where it is not taken, so neither branch's value nor
    gradient is NaN."""
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    return torch.where(small, taylor_val, exact_fn(torch.sqrt(safe_sq)))


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) by Rodrigues:
    R = I + sinc(θ)·ŵ + ((1 − cos θ)/θ²)·ŵ² (`lieutils.py` SO3.Exp :499)."""
    theta_sq = torch.sum(w * w, dim=-1)
    A = _taylor_safe(theta_sq, lambda t: torch.sin(t) / t, 1.0 - theta_sq / 6.0)[..., None, None]
    B = _taylor_safe(
        theta_sq, lambda t: (1.0 - torch.cos(t)) / (t * t), 0.5 - theta_sq / 24.0
    )[..., None, None]
    W = hat(w)
    return _eye_like(W) + A * W + B * (W @ W)


so3_exponential_map = so3_exp


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3) (SO3.Log)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    theta_sq = theta * theta
    # w = θ/(2 sin θ) · vee(R − Rᵀ); Taylor: 1/2 + θ²/12
    coef = _taylor_safe(theta_sq, lambda t: t / (2.0 * torch.sin(t)), 0.5 + theta_sq / 12.0)
    return coef[..., None] * vee(R - R.transpose(-1, -2))


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) = [v, w] -> homogeneous transform (..., 4, 4)
    (SE3.Exp `lieutils.py:670`)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    R = so3_exp(w)
    B = _taylor_safe(
        theta_sq, lambda t: (1.0 - torch.cos(t)) / (t * t), 0.5 - theta_sq / 24.0
    )[..., None, None]
    C = _taylor_safe(
        theta_sq, lambda t: (t - torch.sin(t)) / (t * t * t), 1.0 / 6.0 - theta_sq / 120.0
    )[..., None, None]
    W = hat(w)
    V = _eye_like(W) + B * W + C * (W @ W)
    t = (V @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform (..., 4, 4) -> twist (..., 6) = [v, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta_sq = torch.sum(w * w, dim=-1)
    # V⁻¹ = I − ŵ/2 + (1/θ² − (1 + cos θ)/(2θ sin θ))·ŵ²
    coef = _taylor_safe(
        theta_sq,
        lambda th: 1.0 / (th * th) - (1.0 + torch.cos(th)) / (2.0 * th * torch.sin(th)),
        1.0 / 12.0 + theta_sq / 720.0,
    )[..., None, None]
    W = hat(w)
    V_inv = _eye_like(W) - 0.5 * W + coef * (W @ W)
    v = (V_inv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)
