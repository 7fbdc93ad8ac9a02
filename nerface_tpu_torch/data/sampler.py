"""Face-bbox importance ray sampling (host, numpy).

Port of `nerface_tpu/data/sampler.py` (reference
`train_transformed_rays.py:229-239,320-322`): per train frame, probability
mass 0.9 spread uniformly inside the head bbox and 0.1 outside, normalised
over all H·W pixels; each step draws `num_rays` pixels without replacement
from it, by Gumbel top-k (distributed as successive sampling without
replacement proportional to p).
"""

from __future__ import annotations

import numpy as np


def build_importance_maps(
    bboxes: np.ndarray, H: int, W: int, indices: np.ndarray, p: float = 0.9
) -> np.ndarray:
    """(len(indices), H*W) float64 probability maps, one per train frame."""
    maps = np.empty((len(indices), H * W), np.float64)
    for row, i in enumerate(indices):
        h0, h1, w0, w1 = [int(v) for v in bboxes[i]]
        probs = np.full((H, W), 1.0 - p)
        probs[h0:h1, w0:w1] = p
        probs /= probs.sum()
        maps[row] = probs.reshape(-1)
    return maps


def sample_ray_indices(rng: np.random.RandomState, prob_map: np.ndarray, num_rays: int) -> np.ndarray:
    """Draw `num_rays` pixel indices without replacement ~ prob_map
    (Gumbel top-k)."""
    with np.errstate(divide="ignore"):
        logp = np.log(prob_map)
    gumbel = -np.log(-np.log(rng.random_sample(prob_map.shape)))
    keys = logp + gumbel
    return np.argpartition(keys, -num_rays)[-num_rays:]
