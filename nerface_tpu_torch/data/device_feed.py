"""Device-resident ray feed: the frame pick, the importance-sampled pixel
draw (Gumbel top-k) and the rays, all on the device, with no host work and
no host-to-device copy a step.

Port of `nerface_tpu/data/device_feed.py`: the single-device sampler
(:33-132) and, through `draw(seed, position=g)`, the mesh and process
samplers (:134-249). The batch has the schema of
`data/pipeline.py::RayFeed`'s, so it drops into the train step unchanged.
The train images live on the device as uint8 ((N·H·W·3) bytes) and are
normalised after the gather.

The importance map of frame t is never stored densely ((N, H·W) f32 is
5.24 GB at 5,000 frames of 512²): it takes two values, log(p / Σ) inside
the frame's bbox and log((1 − p) / Σ) outside, computed once a frame in
f64 on the host and cast to f32, exactly as `build_importance_maps` and
`np.log(np.maximum(maps, 1e-300)).astype(np.float32)` give them; `draw`
builds frame t's row from them and its bbox.

The draws come from the port's counter hash (ops/sampling.py), keyed by
the step's seed (`step_seed(seed, step)`, a 0-d device tensor inside the
execution window): the frame from stream `STREAM_FEED_FRAME`, one Gumbel
key a pixel from `STREAM_FEED_PIXEL` by pixel index. So the feed is
deterministic in (seed, step), and a resumed run continues the stream.
Both draws can be injected (`frame`, `gumbel`).

Under data parallelism every rank draws one block of the step's global
batch: the frame comes from the seed alone, so all ranks share it, and the
rank at global position g takes its Gumbel keys from sample g of each
pixel's hash row (position 0 is the single-device stream, bit for bit),
with `ray_index` g·num_rays + arange(num_rays), as JAX's `fold_in(k_pix,
g)` gives each mesh position its own block.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nerface_tpu_torch.data.flame import FlameDataset
from nerface_tpu_torch.ops.sampling import STREAM_FEED_FRAME, STREAM_FEED_PIXEL, per_ray_bits


def bbox_log_values(bbox, H: int, W: int, p: float = 0.9):
    """((h0, h1, w0, w1) as numpy slices them, log value inside, log value
    outside) of one frame's importance map, in f32, equal bit for bit to
    that frame's row of `np.log(np.maximum(build_importance_maps(...),
    1e-300)).astype(np.float32)`."""
    h0, h1, w0, w1 = [int(v) for v in bbox]
    probs = np.full((H, W), 1.0 - p)
    probs[h0:h1, w0:w1] = p
    total = probs.sum()
    hs = slice(h0, h1).indices(H)[:2]
    ws = slice(w0, w1).indices(W)[:2]

    def log32(v):
        return np.float32(np.log(np.maximum(v / total, 1e-300)))

    return hs + ws, log32(p), log32(1.0 - p)


class DeviceRayFeed:
    def __init__(
        self,
        dataset: FlameDataset,
        num_rays: int,
        background: Optional[np.ndarray] = None,
        bbox_p: float = 0.9,
        device="cuda",
    ):
        dev = torch.device(device)
        self.num_rays = int(num_rays)
        H, W = dataset.H, dataset.W
        self.H, self.W = H, W
        intr = np.asarray(dataset.intrinsics, np.float32)
        if intr.ndim == 0:
            intr = np.array([intr, intr, 0.5, 0.5], np.float32)
        ii, jj = np.meshgrid(
            np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
        )
        dirs = np.stack(
            [(ii - W * intr[2]) / intr[0], -(jj - H * intr[3]) / intr[1], -np.ones_like(ii)],
            axis=-1,
        ).reshape(-1, 3)
        i_train = np.asarray(dataset.i_train)
        self.n_frames = len(i_train)
        # one (bounds, log in, log out) a distinct bbox: frames often share one
        by_bbox = {}
        rows = []
        for i in i_train:
            key = tuple(int(v) for v in dataset.bboxes[i])
            if key not in by_bbox:
                by_bbox[key] = bbox_log_values(key, H, W, bbox_p)
            rows.append(by_bbox[key])

        self.dirs_cam = torch.as_tensor(dirs, device=dev)
        imgs = np.clip(dataset.images[i_train][..., :3] * 255.0, 0, 255).astype(np.uint8)
        self.images_u8 = torch.as_tensor(imgs.reshape(-1, 3), device=dev)  # (N·H·W, 3)
        self.poses = torch.as_tensor(
            dataset.poses[i_train][:, :3, :4].astype(np.float32), device=dev)
        self.expressions = torch.as_tensor(
            dataset.expressions[i_train].astype(np.float32), device=dev)
        self.i_train = torch.as_tensor(i_train.astype(np.int32), device=dev)
        self.bounds = torch.as_tensor(np.array([r[0] for r in rows], np.int64), device=dev)
        self.log_in = torch.as_tensor(np.array([r[1] for r in rows], np.float32), device=dev)
        self.log_out = torch.as_tensor(np.array([r[2] for r in rows], np.float32), device=dev)
        pix = torch.arange(H * W, dtype=torch.int64, device=dev)
        self.pixels = pix
        self.pix_row = pix // W
        self.pix_col = pix % W
        self.background = (
            torch.as_tensor(np.asarray(background, np.float32).reshape(-1, 3), device=dev)
            if background is not None else None
        )

    def log_row(self, t: torch.Tensor) -> torch.Tensor:
        """(H·W,) f32 log-importance of train frame `t` (a (1,) int64 tensor)."""
        h0, h1, w0, w1 = self.bounds.index_select(0, t)[0].unbind()
        inside = ((self.pix_row >= h0) & (self.pix_row < h1)
                  & (self.pix_col >= w0) & (self.pix_col < w1))
        return torch.where(inside, self.log_in.index_select(0, t), self.log_out.index_select(0, t))

    def frame(self, seed) -> torch.Tensor:
        """(1,) int64: the train frame (a row of `i_train`) for the step's
        seed, uniform over the frames."""
        bits = per_ray_bits(seed, STREAM_FEED_FRAME, self.pixels[:1], 1).reshape(1)
        return (bits * self.n_frames) >> 32

    def gumbel(self, seed, position: int = 0) -> torch.Tensor:
        """(H·W,) f32 standard Gumbel keys for the step's seed at global
        position `position`, one a pixel: −log(−log u), u = (23 hash bits +
        ½)·2⁻²³, in (0, 1) exactly."""
        bits = per_ray_bits(seed, STREAM_FEED_PIXEL, self.pixels, 1,
                            first_sample=int(position)).reshape(-1)
        u = ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
        return -torch.log(-torch.log(u))

    def draw(
        self,
        seed,
        frame: Optional[torch.Tensor] = None,
        gumbel: Optional[torch.Tensor] = None,
        position: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """One train frame and `num_rays` of its pixels without replacement,
        proportional to its importance map: the top `num_rays` of log-map +
        Gumbel keys, highest first (as `jax.lax.top_k`). `seed` is an int or
        `step_seed`'s 0-d tensor; `frame` (a row of `i_train`) and `gumbel`
        ((H·W,) f32) replace the hash's draws. With `position` g the batch
        is block g of a data-parallel step: the pixels of position g and
        `ray_index` g·num_rays + arange(num_rays)."""
        dev = self.dirs_cam.device
        if frame is None:
            t = self.frame(seed)
        else:
            t = torch.as_tensor(frame, dtype=torch.int64, device=dev).reshape(1)
        g = self.gumbel(seed, position or 0) if gumbel is None else gumbel
        sel = torch.topk(self.log_row(t) + g, self.num_rays).indices

        pose = self.poses.index_select(0, t)[0]
        rd = self.dirs_cam.index_select(0, sel) @ pose[:, :3].T
        ro = pose[:, 3].expand(rd.shape)
        target = self.images_u8.index_select(0, t * (self.H * self.W) + sel)
        frame_index = self.i_train.index_select(0, t).reshape(())
        batch = {
            "ray_origins": ro,
            "ray_directions": rd,
            "target_rgb": target.to(torch.float32) * (1.0 / 255.0),
            "expression": self.expressions.index_select(0, t)[0],
            "latent_index": frame_index,
            "frame_index": frame_index,
            "pixel_indices": sel.to(torch.int32),
        }
        if self.background is not None:
            batch["background_rgb"] = self.background.index_select(0, sel)
        if position is not None:
            batch["ray_index"] = torch.arange(
                position * self.num_rays, (position + 1) * self.num_rays, device=dev)
        return batch
