"""Image casts of the eval driver.

Port of the cast helpers of `nerface_tpu/eval/driver.py` (reference
`eval_transformed_rays.py:184-198`). The full test-sequence `evaluate()`
is not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch


def cast_to_image(img) -> np.ndarray:
    """[0,1] float (H,W,3) -> uint8, clamped, round-half-even."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0).round().astype(np.uint8)


def device_cast_to_image(img: torch.Tensor) -> torch.Tensor:
    """`cast_to_image` on the tensor's device (f32 clip·255 → round half
    to even → uint8), so only the uint8 frame is copied to the host."""
    x = torch.clamp(img.float(), 0.0, 1.0) * 255.0
    return torch.round(x).to(torch.uint8)


def device_uint8(x: torch.Tensor) -> torch.Tensor:
    """Float → uint8 truncation on device, for maps already scaled to
    0..255 (e.g. `normal_map_from_depth`)."""
    return x.to(torch.uint8)


def cast_to_disparity_image(disp) -> np.ndarray:
    """Per-frame min-max normalize -> uint8 (`eval_transformed_rays.py:195-198`)."""
    disp = np.asarray(disp, np.float64)
    rng = disp.max() - disp.min()
    img = (disp - disp.min()) / (rng if rng > 0 else 1.0)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)
