"""Spherical camera-position samplers for synthetic data generation: a port of
`nerface_tpu/tools/spherical_sampler.py`, the
counterpart of `rendering/spherical_sampler.py:7-177` (SURVEY.md §2
component 14): Fibonacci lattice, Gaussian-random hemisphere, horizontal
curve, spiral, helix, and arc paths on/near the unit sphere.
"""

from __future__ import annotations

import numpy as np

SAMPLINGS = ("LATTICE", "RANDOM", "CURVE", "SPIRAL", "HELIX", "ARC")


def sphere_fibonacci_grid_points(ng: int) -> np.ndarray:
    """Fibonacci spiral grid on the sphere (Swinbank & Purser 2006;
    `spherical_sampler.py:31-77`)."""
    golden = (1.0 + np.sqrt(5.0)) / 2.0
    i2 = 2.0 * np.arange(ng) - (ng - 1)
    theta = 2.0 * np.pi * i2 / golden
    sphi = i2 / ng
    cphi = np.sqrt((ng + i2) * (ng - i2)) / ng
    return np.stack(
        [cphi * np.sin(theta), cphi * np.cos(theta), sphi], axis=-1
    )


def sphere_sample_gaussian(n: int, rng=None) -> np.ndarray:
    """Random points on the upper hemisphere (|z|) — normalized Gaussians
    (`spherical_sampler.py:79-89`)."""
    rng = rng or np.random
    pts = rng.normal(size=(n, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts[:, 2] = np.abs(pts[:, 2])
    return pts


def sphere_sample_curve(n: int, theta: float = np.pi / 2) -> np.ndarray:
    """Horizontal circle at polar angle theta (`spherical_sampler.py:90-104`)."""
    phi = np.linspace(0, 2 * np.pi, num=n, endpoint=False)
    return np.stack(
        [
            np.sin(theta) * np.cos(phi),
            np.full(n, np.cos(theta)),
            np.sin(theta) * np.sin(phi),
        ],
        axis=-1,
    )


def sphere_sample_spiral(n: int) -> np.ndarray:
    """Outward spiral projected to the sphere (`spherical_sampler.py:106-126`)."""
    phi = np.linspace(0, 1, num=n, endpoint=False)
    x = phi * np.cos(16 * phi)
    z = phi * np.sin(16 * phi)
    y = np.sqrt(np.maximum(1 - x**2 - z**2, 0.0))
    pts = np.stack([x, y, z], axis=-1)
    return pts / np.linalg.norm(pts, axis=-1, keepdims=True)


def sphere_sample_arc(n: int) -> np.ndarray:
    """Small planar arc in front of the subject (`spherical_sampler.py:128-145`);
    note: intentionally NOT normalized (matches the reference)."""
    pts = np.zeros((n, 3))
    pts[:, 0] = np.linspace(-0.5, 0.5, num=n, endpoint=False)
    pts[:, 1] = np.linspace(-0.2, 0.2, num=n, endpoint=False)
    pts[:, 2] = 0.7
    return pts


def sphere_sample_helix(n: int) -> np.ndarray:
    """Rising helix (`spherical_sampler.py:148-165`); not normalized."""
    t = np.linspace(0, 1, num=n, endpoint=False)
    return np.stack(
        [np.cos(3 * t * np.pi), np.sin(3 * t * np.pi), t], axis=-1
    )


class SphericalSampler:
    """Sample N camera positions on/near the unit sphere
    (`spherical_sampler.py:7-29`)."""

    def __init__(self, N: int, sampling: str = "LATTICE", rng=None):
        self.N = N
        if sampling == "LATTICE":
            self.points = sphere_fibonacci_grid_points(N)
        elif sampling == "RANDOM":
            self.points = sphere_sample_gaussian(N, rng=rng)
        elif sampling == "CURVE":
            self.points = sphere_sample_curve(N)
        elif sampling == "SPIRAL":
            self.points = sphere_sample_spiral(N)
        elif sampling == "HELIX":
            self.points = sphere_sample_helix(N)
        elif sampling == "ARC":
            self.points = sphere_sample_arc(N)
        else:
            raise NameError(
                "Sampling of type: %s not supported. Use one of %s"
                % (sampling, " | ".join(SAMPLINGS))
            )
