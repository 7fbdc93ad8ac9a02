"""TensorBoard-compatible logging.

Port of `nerface_tpu/utils/tb.py`. The same scalar / image panel names as
the reference's SummaryWriter usage
(`train_transformed_rays.py:200-206,415-424,518-541`): train/coarse_loss,
train/fine_loss, train/psnr, train/code_loss, train/bg_loss,
validation/{loss,coarse_loss,fine_loss,psnr} and image panels
validation/{rgb_coarse,rgb_fine,img_target,background,weights}. The
config snapshot is dumped to `logdir/config.yml` on construction, with or
without tensorboardX; without it the writer logs nothing. A writer with no
logdir (a data-parallel run's ranks other than 0) writes nothing at all.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np


class ScalarWriter:
    """Thread-safe: the train loop logs train scalars from its logging
    thread while validation images are written from the validation
    thread; a lock serializes the underlying writer."""

    def __init__(self, logdir: Optional[str], cfg=None):
        self.logdir = logdir
        self._lock = threading.Lock()
        self._writer = None
        if logdir is None:
            return
        os.makedirs(logdir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter

            self._writer = SummaryWriter(logdir)
        except ImportError:
            self._writer = None
        if cfg is not None:
            with open(os.path.join(logdir, "config.yml"), "w") as f:
                f.write(cfg.dump())

    @property
    def active(self) -> bool:
        """True while a tensorboardX writer takes what is logged: callers
        skip the host copies of panels that would be thrown away."""
        return self._writer is not None

    def scalar(self, tag: str, value, step: int):
        with self._lock:
            if self._writer is not None:
                self._writer.add_scalar(tag, float(value), step)

    def image(self, tag: str, img: np.ndarray, step: int, dataformats: str = "HWC"):
        with self._lock:
            if self._writer is not None:
                img = np.asarray(img)
                if img.dtype != np.uint8:
                    img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
                self._writer.add_image(tag, img, step, dataformats=dataformats)

    def close(self):
        with self._lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None
