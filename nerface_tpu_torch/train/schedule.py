"""Learning-rate schedule.

Port of `nerface_tpu/train/schedule.py`. The reference sets the LR *after*
each optimizer step (`train_transformed_rays.py:393-400`): iteration 0
runs at `lr`, and iteration k ≥ 1 at
`lr · lr_decay_factor^((k − 1) / (lr_decay·1000))`. With
`torch.optim.Adam`, the train step sets `param_group["lr"]` to
`schedule(k + 1)` after `optimizer.step()` of iteration k.
"""

from __future__ import annotations

import numpy as np


def exponential_lr(lr_init: float, lr_decay: float, lr_decay_factor: float = 0.1):
    """schedule(k): the LR that iteration k runs at."""
    num_decay_steps = lr_decay * 1000.0

    def schedule(step: int) -> float:
        # in float32, as the JAX package's schedule computes it
        eff = np.float32(max(float(step) - 1.0, 0.0))
        rate = np.float32(lr_decay_factor) ** (eff / np.float32(num_decay_steps))
        return float(np.float32(lr_init) * rate)

    return schedule


def from_cfg(cfg):
    return exponential_lr(
        float(cfg.optimizer.lr),
        float(cfg.scheduler.lr_decay),
        float(cfg.scheduler.lr_decay_factor),
    )
