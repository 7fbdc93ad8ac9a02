"""The execution window: k train steps with no host work between them.

The counterpart of `nerface_tpu/train/step.py::make_train_megastep` (K
steps as one dispatched `lax.scan`). On the card one train step — the
losses, backward, the optimizer's step, the LR write and the device step
counter's increment — is captured once in a `torch.cuda.CUDAGraph`, and a
window of k steps is k replays of it. One graph serves every window
length, as JAX's stacked batches and `n_steps` do.

Every input of the step sits in a static device buffer that the graph
reads:

* the step counter `step_t` (0-d int64): the draws' seed is
  `step_seed(seed_t, step_t)` and the LR written after the step is the
  schedule's at `step_t + 1` (train/schedule.py), so no Python int enters
  the step;
* the host feed: a (K, ...) stack of the window's batches, uploaded once a
  window (from a pinned staging stack, two of them in turns) and indexed
  by the window slot `slot_t`;
* the device feed (data/device_feed.py): nothing from the host, the draw
  runs inside the graph.

The first step a window object runs is eager: it creates the optimizer's
lazy state (Adam's moments exist only after the first `step()`), builds
the kernels' libraries and fills the wrappers' caches. It is a real step;
the capture follows it and executes nothing, and the replays are the
remaining steps. No step runs twice and none is skipped. A capture that
fails raises: there is no fallback to eager steps on the card. The capture
runs in `thread_local` mode, so the feed's thread and the async validation
thread (its own stream) may work meanwhile.

Python runs once, at capture. So `state.step` advances by k after the
replays, and every parameter's autograd version is bumped, which keeps
`render/pipeline.py::_kernel_weights` (keyed on `_version`) from packing
stale weights after a window. A kernel wrapper counts its C entry's calls
(`.launches`): the eager steps' and the capture's, which puts the kernel
into the graph. The replays run the graph's kernels with no call from the
host and so count nothing; what they ran is read from the device
(torch.profiler's kernel records, `chip_smoke.py::kernel_runs`).

On the CPU, and on the card where `k_max` is 1 (`train()` at a window of
one step), there is no graph: a window runs its steps one at a time
through the same step body and the same bookkeeping. That is the
step-at-a-time path, bit for bit the window's.

Under data parallelism (train/distributed.py) the step body is JAX's DP
step (`nerface_tpu/train/step.py:172-201`): between `backward()` and the
optimizer's step one all-reduce averages the gradients and the metrics
over the ranks (`GradReducer`'s flat buffer, allocated here), and PSNR is
recomputed from the averaged loss. A group of one rank runs the collective
too, and trains bit for bit as no group does. Over NCCL the collective is
captured with the step and replayed with it; the eager first step runs it
once before the capture. gloo's collectives cannot be captured, so a gloo
run steps one at a time (train/loop.py's window rule). The device feed's
rank r draws block r of the step (`DeviceRayFeed.draw(position=r)`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from nerface_tpu_torch.config.flags import FeatureFlags
from nerface_tpu_torch.ops.math import mse2psnr
from nerface_tpu_torch.ops.sampling import step_seed
from nerface_tpu_torch.render.pipeline import RenderSettings
from nerface_tpu_torch.train import distributed
from nerface_tpu_torch.train.fused import fused_losses, fused_train_eligible
from nerface_tpu_torch.train.state import TrainState, set_lr
from nerface_tpu_torch.train.step import compute_losses

METRIC_KEYS = ("total_loss", "loss", "coarse_loss", "fine_loss", "psnr", "latent_code_loss",
               "background_loss")


def train_step(
    state: TrainState,
    optimizer: torch.optim.Optimizer,
    batch: Dict[str, torch.Tensor],
    seed,
    settings: RenderSettings,
    flags: FeatureFlags,
    dtype=None,
    fused: bool = False,
    reducer: Optional[distributed.GradReducer] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """One train step: the losses (through K1 where `fused`), backward,
    with a `reducer` the all-reduce of the gradients and metrics over the
    ranks, and the optimizer's step. Returns the `METRIC_KEYS` vector.
    `draws` may inject the render's draws (as `compute_losses`)."""
    optimizer.zero_grad(set_to_none=True)
    if fused:
        total, metrics = fused_losses(state, batch, seed, settings, flags, draws=draws)
    else:
        total, metrics = compute_losses(state, batch, seed, settings, flags, dtype=dtype,
                                        draws=draws)
    total.backward()
    metrics["total_loss"] = total.detach()
    vec = torch.stack([metrics[k].reshape(()) for k in METRIC_KEYS])
    if reducer is not None:
        vec = reducer(vec)
        # the PSNR of the averaged loss: a mean of logs is not the log of
        # the mean (`nerface_tpu/train/step.py:187-191`)
        vec[METRIC_KEYS.index("psnr")] = mse2psnr(vec[METRIC_KEYS.index("loss")])
    optimizer.step()
    return vec


class TrainWindow:
    """Runs windows of `state`'s training steps (`run`); `k_max` is the
    longest window. `device_feed` is a `DeviceRayFeed` or None (the host
    feed: `run` takes the window's batches). `before_capture` is called
    just before the capture: the loop waits there for a validation render
    in flight, so that no render runs beside the capture."""

    def __init__(
        self,
        state: TrainState,
        optimizer: torch.optim.Optimizer,
        settings: RenderSettings,
        flags: FeatureFlags,
        lr_schedule: Callable[[torch.Tensor], torch.Tensor],
        seed: int,
        k_max: int,
        dtype=None,
        device_feed=None,
        before_capture: Optional[Callable[[], None]] = None,
    ):
        self.state = state
        self.optimizer = optimizer
        self.settings = settings
        self.flags = flags
        self.lr_schedule = lr_schedule
        self.dtype = dtype
        self.k_max = int(k_max)
        self.device_feed = device_feed
        self.before_capture = before_capture
        dev = next(state.model_coarse.parameters()).device
        self.device = dev
        self.graphed = dev.type == "cuda" and self.k_max > 1
        self.rank = distributed.rank()
        self.reducer = None
        if distributed.initialized():
            self.reducer = distributed.GradReducer(
                [p for g in optimizer.param_groups for p in g["params"]], len(METRIC_KEYS))
        # whether the steps train through K1: decided at the first batch,
        # whose ray count the card's rule reads
        self.fused: Optional[bool] = None
        self.seed_t = torch.tensor(int(seed), dtype=torch.int64, device=dev)
        self.step_t = torch.tensor(int(state.step), dtype=torch.int64, device=dev)
        self.slot_t = torch.zeros((), dtype=torch.int64, device=dev)
        self.metrics_out = torch.zeros(len(METRIC_KEYS), dtype=torch.float32, device=dev)
        self.buffers: Optional[Dict[str, torch.Tensor]] = None
        self._staging: List[Dict[str, torch.Tensor]] = []
        self._staged: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        set_lr(optimizer, lr_schedule(self.step_t))

    # -- the step ------------------------------------------------------------
    def _batch(self) -> Dict[str, torch.Tensor]:
        if self.device_feed is not None:
            position = self.rank if self.reducer is not None else None
            return self.device_feed.draw(step_seed(self.seed_t, self.step_t), position=position)
        idx = self.slot_t.reshape(1)
        return {k: buf.index_select(0, idx)[0] for k, buf in self.buffers.items()}

    def _step(self) -> None:
        """One train step on the static buffers (eager, or being captured)."""
        batch = self._batch()
        if self.fused is None:
            s = self.state
            self.fused = fused_train_eligible(
                s.model_coarse, s.model_fine, self.settings, self.flags, self.dtype, self.device,
                num_rays=batch["ray_origins"].reshape(-1, 3).shape[0])
        seed = step_seed(self.seed_t, self.step_t)
        vec = train_step(self.state, self.optimizer, batch, seed, self.settings, self.flags,
                         dtype=self.dtype, fused=self.fused, reducer=self.reducer)
        self.step_t.add_(1)
        self.slot_t.add_(1)
        # the reference sets the LR after the step (train/schedule.py)
        set_lr(self.optimizer, self.lr_schedule(self.step_t))
        self.metrics_out.copy_(vec)

    def _capture(self) -> None:
        if self.before_capture is not None:
            self.before_capture()
        dev = self.device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph

    # -- the host feed's stack ------------------------------------------------
    def _upload(self, batches: Sequence[Dict[str, np.ndarray]]) -> None:
        n = len(batches)
        cuda = self.device.type == "cuda"
        if self.buffers is None:
            first = {k: torch.from_numpy(np.asarray(v)) for k, v in batches[0].items()}
            self.buffers = {k: torch.empty((self.k_max,) + v.shape, dtype=v.dtype, device=self.device)
                            for k, v in first.items()}
            # two staging stacks in turns: a window's upload may still be on
            # its way when the next window stages its batches
            self._staging = [{k: torch.empty(b.shape, dtype=b.dtype, pin_memory=cuda)
                              for k, b in self.buffers.items()} for _ in range(2)]
        if self._staged[self._turn] is not None:
            self._staged[self._turn].synchronize()
        for k, host in self._staging[self._turn].items():
            np.stack([np.asarray(b[k]) for b in batches], out=host[:n].numpy())
            self.buffers[k][:n].copy_(host[:n], non_blocking=cuda)
        if cuda:
            self._staged[self._turn] = torch.cuda.Event()
            self._staged[self._turn].record()
        self._turn ^= 1
        self.slot_t.zero_()

    # -- a window -------------------------------------------------------------
    def run(self, k_run: int, batches: Optional[Sequence[Dict[str, np.ndarray]]] = None
            ) -> torch.Tensor:
        """Train steps `state.step` .. `state.step + k_run − 1`; `batches`
        are their host batches (None with the device feed). Returns the
        last step's metrics (`METRIC_KEYS`), a device tensor that the next
        window overwrites."""
        if not 1 <= k_run <= self.k_max:
            raise ValueError(f"a window of {k_run} steps (1..{self.k_max})")
        if self.device_feed is None:
            if batches is None or len(batches) != k_run:
                raise ValueError("the host feed needs one batch a step")
            self._upload(batches)
        n = k_run
        if not self.graphed:
            for _ in range(n):
                self._step()
        else:
            if self.graph is None:
                self._step()  # a real step: lazy state, libraries and caches
                n -= 1
                if n:
                    self._capture()
            for _ in range(n):
                self.graph.replay()
            self.replays += n
            for group in self.optimizer.param_groups:
                for p in group["params"]:
                    torch.autograd.graph.increment_version(p)
        self.state.step += k_run
        return self.metrics_out
