"""Host-side ray-batch feed.

Port of `nerface_tpu/data/pipeline.py::RayFeed` (reference
`train_transformed_rays.py:289-331`): per step, a train frame and
`num_rays` importance-sampled pixels (data/sampler.py), their rays (pixel
directions in the camera frame are computed once and only the selected
ones are rotated by the frame's pose), target and background pixels, the
frame's expression and latent index. Batch b's draws come from
`RandomState(SeedSequence([seed, b]))`, so a resumed run built with
`start_batch` = its step continues the uninterrupted run's stream.

Two paths, each bit-identical to the JAX package's path of the same name:
the native path (the default, as in JAX) draws one seed from the batch's
RandomState for the C++ Gumbel top-k over the frame's map and gathers and
rotates the rays in C++ (`nerface_tpu_torch/native`); the numpy path
(`native=False`) draws with `sample_ray_indices`. They draw other batches.
A background thread keeps `prefetch` batches ready; the train loop stacks
a window's batches and uploads them once (train/window.py).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from nerface_tpu_torch.data.flame import FlameDataset
from nerface_tpu_torch.data.sampler import build_importance_maps, sample_ray_indices


class RayFeed:
    def __init__(
        self,
        dataset: FlameDataset,
        num_rays: int,
        background: Optional[np.ndarray] = None,
        seed: int = 42,
        bbox_p: float = 0.9,
        prefetch: int = 4,
        start_batch: int = 0,
        native: bool = True,
    ):
        if dataset.images is None:
            raise ValueError("RayFeed needs a dataset with images")
        self.dataset = dataset
        self.num_rays = num_rays
        self.seed = int(seed)
        self._batch_index = int(start_batch)
        H, W = dataset.H, dataset.W
        intr = np.asarray(dataset.intrinsics, np.float32)
        if intr.ndim == 0:
            intr = np.array([intr, intr, 0.5, 0.5], np.float32)
        ii, jj = np.meshgrid(
            np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
        )
        self._dirs_cam = np.stack(
            [(ii - W * intr[2]) / intr[0], -(jj - H * intr[3]) / intr[1], -np.ones_like(ii)],
            axis=-1,
        ).reshape(-1, 3)
        self._images_flat = dataset.images.reshape(dataset.images.shape[0], -1, dataset.images.shape[-1])
        self._background_flat = (
            background.reshape(-1, background.shape[-1]) if background is not None else None
        )
        self._maps = build_importance_maps(dataset.bboxes, H, W, dataset.i_train, p=bbox_p)
        self._train_pos = {int(g): i for i, g in enumerate(dataset.i_train)}
        self._native = None
        if native:
            from nerface_tpu_torch import native as _native

            _native.library()  # built (or its failure raised) here, not in the thread
            self._native = _native
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _batch_rng(self) -> np.random.RandomState:
        ss = np.random.SeedSequence([self.seed, self._batch_index])
        return np.random.RandomState(ss.generate_state(4))

    def sample_batch(self) -> Dict[str, np.ndarray]:
        ds = self.dataset
        rng = self._batch_rng()
        self._batch_index += 1
        img_idx = int(rng.choice(ds.i_train))
        probs = self._maps[self._train_pos[img_idx]]
        if self._native is not None:
            sel = self._native.gumbel_topk(probs, self.num_rays, int(rng.randint(0, 2**63 - 1)))
            ro, rd, target, bg = self._native.assemble_batch(
                sel, self._dirs_cam, self._images_flat[img_idx], ds.poses[img_idx],
                self._background_flat,
            )
        else:
            sel = sample_ray_indices(rng, probs, self.num_rays)
            pose = ds.poses[img_idx]
            rd = (self._dirs_cam[sel] @ pose[:3, :3].T.astype(np.float32)).astype(np.float32)
            ro = np.broadcast_to(pose[:3, 3].astype(np.float32), rd.shape).copy()
            target = self._images_flat[img_idx][sel, :3]
            bg = None
            if self._background_flat is not None:
                bg = self._background_flat[sel, :3].astype(np.float32)
        batch = {
            "ray_origins": ro,
            "ray_directions": rd,
            "target_rgb": target,
            "expression": ds.expressions[img_idx],
            "latent_index": np.int32(img_idx),
            "frame_index": np.int32(img_idx),
            "pixel_indices": sel.astype(np.int32),
        }
        if bg is not None:
            batch["background_rgb"] = bg
        return batch

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = self.sample_batch()
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.25)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # handed to the consumer by __next__
            self._error = e
            self._stop.set()

    def start(self) -> "RayFeed":
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._thread is None:
            return self.sample_batch()
        while True:
            if self._error is not None:
                raise RuntimeError("ray feed thread failed") from self._error
            try:
                return self._queue.get(timeout=0.25)
            except queue.Empty:
                continue

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A feed batch of numpy arrays as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}
