"""Learning-rate schedule.

Port of `nerface_tpu/train/schedule.py`. The reference sets the LR *after*
each optimizer step (`train_transformed_rays.py:393-400`): iteration 0
runs at `lr`, and iteration k ≥ 1 at
`lr · lr_decay_factor^((k − 1) / (lr_decay·1000))`.

`exponential_lr` computes it from a 0-d int64 step tensor in f32 torch ops
on the step's device: the train step writes the LR of step k + 1 into the
optimizer's LR tensor from its device step counter after
`optimizer.step()` of step k, so a captured step (train/window.py) reads
no Python int. It equals the JAX package's f32 schedule bit for bit on
the CPU (tests/test_torch_window.py); `pow` on the card may round another
way in the last bit.
"""

from __future__ import annotations

import numpy as np
import torch


def exponential_lr(lr_init: float, lr_decay: float, lr_decay_factor: float = 0.1):
    """schedule(step) for a 0-d int64 tensor `step`: a 0-d f32 tensor on
    its device, with no read back to the host."""
    num_decay_steps = float(np.float32(lr_decay * 1000.0))
    factor = float(np.float32(lr_decay_factor))
    lr0 = float(np.float32(lr_init))

    def schedule(step: torch.Tensor) -> torch.Tensor:
        eff = torch.clamp(step - 1, min=0).to(torch.float32)
        return torch.pow(factor, eff / num_decay_steps) * lr0

    return schedule


def from_cfg(cfg):
    """The config's schedule."""
    return exponential_lr(
        float(cfg.optimizer.lr),
        float(cfg.scheduler.lr_decay),
        float(cfg.scheduler.lr_decay_factor),
    )
