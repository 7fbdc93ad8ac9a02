"""The training loop.

Port of the single-device path of `nerface_tpu/train/loop.py` (reference
`train_transformed_rays.py:24-575`): config and data, the models, the
background (blurred with `blur_background`) and the latent table, the ray
feed, the train step (in bf16 on the card through K1 for the paper model,
through K4f/K4b for the Flexible family), periodic validation renders (K2,
or K4f), and reference-schema `.ckpt` saves.

The steps run in execution windows (train/window.py): K steps as K
replays of one captured CUDA graph on the card, the counterpart of the
JAX package's `make_train_megastep`. K is `steps_per_execute` (argument,
else config; "auto" is 50 at ≥ 2000 iterations, else 1), cut by
`_effective_window` to divide every active cadence, so the bookkeeping at
step j (print, validate, save) always sees the state after step j, as
the step-at-a-time loop does; the metrics are the window's last step's.
K = 1 runs every step eagerly through the same step body.

The feed is the host `RayFeed` (batch b from `SeedSequence([seed, b])`,
one stack of K batches uploaded a window) or, with `device_feed`, the
device sampler (data/device_feed.py) inside the step. The draws' seed of
step i is `step_seed(seed, i)` from the device step counter, so a resumed
run draws what the uninterrupted run would have, and its feed continues
the stream.

A print boundary copies the metrics to the host behind the window and a
logging thread prints them; the loop waits for the previous boundary's
copy (`_backpressure`), which bounds how far the host runs ahead of the
card. Validation is asynchronous by default under a window
(`experiment.async_val` overrides): a side thread renders on its own CUDA
stream from a snapshot of the post-step-j models and background, cloned
on the training stream, at most one render in flight; a failing render
fails the run.

Saves go through `AsyncCheckpointWriter` (train/checkpoint.py): the state
and the Adam state cloned on the training stream after the window, written
by a worker thread to a temporary file renamed into place, at most one
write in flight; the loop's `finally` waits for the last write and
re-raises a failed one. `ScalarWriter` (utils/tb.py) writes
`logdir/config.yml` and, with tensorboardX, the JAX package's panels: the
train scalars and `host/rss_gb` from the logging thread at print
boundaries, the validation scalars and images from the validation render.
Under autograd's anomaly mode (`--debug-nans`), which reads every
gradient back to the host, the loop runs one step a window.

Not ported yet (ROADMAP.md Queue 1): several devices (DDP).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from nerface_tpu_torch.config.flags import FeatureFlags
from nerface_tpu_torch.data.flame import FlameDataset, load_flame_data
from nerface_tpu_torch.data.pipeline import RayFeed
from nerface_tpu_torch.eval.renderer import render_full_frame
from nerface_tpu_torch.models.nerf_models import build_model
from nerface_tpu_torch.ops.math import mse2psnr
from nerface_tpu_torch.render.pipeline import RenderSettings
from nerface_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    load_torch_checkpoint,
    restore_train_state,
)
from nerface_tpu_torch.train.schedule import from_cfg
from nerface_tpu_torch.train.state import TrainState, build_optimizer, create_train_state
from nerface_tpu_torch.train.window import METRIC_KEYS, TrainWindow
from nerface_tpu_torch.utils.profiling import host_rss_gb
from nerface_tpu_torch.utils.tb import ScalarWriter


def build_models_from_cfg(cfg, device=None, generator: Optional[torch.Generator] = None):
    """Coarse + (optional) fine model with the reference's constructor
    quirks: the fine model takes the *coarse* num_layers/hidden_size
    (`train_transformed_rays.py:100-124`)."""
    model_coarse = build_model(cfg.models.coarse, device=device, generator=generator)
    model_fine = None
    if "fine" in cfg.models:
        model_fine = build_model(
            cfg.models.fine, num_layers=cfg.models.coarse.num_layers,
            hidden_size=cfg.models.coarse.hidden_size, device=device, generator=generator,
        )
    return model_coarse, model_fine


def setup_background(dataset: FlameDataset, flags: FeatureFlags) -> Optional[np.ndarray]:
    """Fixed background: the GT `bg/00050.png`. Trainable background: the
    mean of the train frames, blurred with `blur_background`
    (`train_transformed_rays.py:143-170`)."""
    if flags.train_background:
        avg = dataset.images[dataset.i_train].mean(axis=0)
        if flags.blur_background:
            from nerface_tpu_torch.utils.smoothing import gaussian_smooth

            avg = gaussian_smooth(torch.from_numpy(np.asarray(avg, np.float32)), 11, 11.0).numpy()
        return avg.astype(np.float32)
    if flags.fixed_background:
        bg = dataset.load_background()
        if bg.shape != dataset.images[dataset.i_train][0].shape:
            raise ValueError(f"background {bg.shape} does not match the frames {dataset.images.shape}")
        return bg
    return None


def validate(
    cfg,
    dataset: FlameDataset,
    state: TrainState,
    flags: FeatureFlags,
    step: int,
    num_frames: int = 2,
    dtype=None,
    writer: Optional[ScalarWriter] = None,
) -> Dict[str, float]:
    """Full-frame validation renders (`train_transformed_rays.py:427-549`)
    with the reference's quirks: only the first `num_frames` val frames,
    a zero latent code (which a model that takes none ignores), the fine
    MSE counted twice, and the sum divided by len(i_val). With an active
    `writer`, the validation scalars and the last frame's images are logged
    (`nerface_tpu/train/loop.py:151-166`)."""
    settings = RenderSettings.from_cfg(cfg, mode="validation")
    dev = next(state.model_coarse.parameters()).device
    bg = None
    if (flags.train_background or flags.fixed_background) and state.background is not None:
        bg = state.background.detach()
    latent = (
        torch.zeros(32, device=dev)
        if (flags.train_latent_codes or flags.disable_latent_codes) else None
    )
    total_loss = coarse_loss = fine_loss = 0.0
    last = None
    t0 = time.time()
    for img_idx in dataset.i_val[:num_frames]:
        expr = torch.as_tensor(np.asarray(dataset.expressions[img_idx], np.float32), device=dev)
        if flags.disable_expressions:
            expr = torch.zeros_like(expr)
        out = render_full_frame(
            state.model_coarse, state.model_fine, dataset.H, dataset.W, dataset.intrinsics,
            dataset.poses[img_idx][:3, :4], settings, seed=int(step), expressions=expr,
            latent_code=latent, background=bg, dtype=dtype, device=dev,
        )
        target = torch.as_tensor(dataset.images[img_idx][..., :3], device=dev)
        coarse_loss = float(torch.mean((out["rgb_coarse"] - target) ** 2))
        if "rgb_fine" in out:
            fine_loss = float(torch.mean((out["rgb_fine"] - target) ** 2))
            # the reference's validation loss counts the fine MSE twice
            # (train_transformed_rays.py:509-514)
            total_loss += fine_loss + fine_loss
        else:
            total_loss += coarse_loss
        last = (out, target)
    loss = total_loss / max(len(dataset.i_val), 1)
    psnr = float(mse2psnr(torch.tensor(loss)))
    if writer is not None and writer.active and last is not None:
        out, target = last
        host = {k: out[k].float().cpu().numpy() for k in ("rgb_coarse", "rgb_fine", "bg_weight")
                if k in out}
        writer.scalar("validation/loss", loss, step)
        writer.scalar("validation/coarse_loss", coarse_loss, step)
        writer.scalar("validation/psnr", psnr, step)
        writer.image("validation/rgb_coarse", host["rgb_coarse"], step)
        if "rgb_fine" in host:
            writer.scalar("validation/fine_loss", fine_loss, step)
            writer.image("validation/rgb_fine", host["rgb_fine"], step)
        writer.image("validation/img_target", target.cpu().numpy(), step)
        if bg is not None:
            writer.image("validation/background", bg.float().cpu().numpy(), step)
            writer.image("validation/weights", host["bg_weight"], step, dataformats="HW")
    return {"loss": loss, "psnr": psnr,
            "coarse_loss": coarse_loss, "fine_loss": fine_loss, "time": time.time() - t0}


def _effective_window(requested, cadences, multiprocess: bool = False) -> int:
    """The largest window K ≤ `requested` that divides every active
    cadence, so print, validate and save land on window ends
    (`nerface_tpu/train/loop.py:170-186`). Several processes run K = 1."""
    if multiprocess:
        return 1
    cad = [int(c) for c in cadences if c and int(c) > 0]
    k = max(1, int(requested))
    if cad:
        k = min([k] + cad)
    while k > 1 and any(c % k for c in cad):
        k -= 1
    return k


def _requested_window(steps_per_execute, cfg, train_iters: int) -> int:
    """The argument, else the config; "auto" (or none) is 50 for
    production-length runs (≥ 2000 iterations), else 1."""
    k_req = steps_per_execute
    if k_req is None:
        k_req = cfg.experiment.get("steps_per_execute")
    if k_req is None or str(k_req) == "auto":
        return 50 if train_iters >= 2000 else 1
    return int(k_req)


def _snapshot(state: TrainState, stream=None) -> TrainState:
    """The models and the background, cloned on the current stream, for a
    validation render that runs while training goes on, on `stream` if
    given (the clones' memory is then kept until that stream is done)."""

    def clone(m):
        if m is None:
            return None
        cache = m.__dict__.pop("_kernel_weights_cache", None)
        try:
            out = copy.deepcopy(m)
        finally:
            if cache is not None:
                m._kernel_weights_cache = cache
        return out.requires_grad_(False)

    bg = None if state.background is None else state.background.detach().clone()
    snap = dataclasses.replace(state, model_coarse=clone(state.model_coarse),
                               model_fine=clone(state.model_fine), latent_codes=None,
                               background=bg)
    if stream is not None:
        models = [m for m in (snap.model_coarse, snap.model_fine) if m is not None]
        for t in [p for m in models for p in m.parameters()] + ([bg] if bg is not None else []):
            t.record_stream(stream)
    return snap


def train(
    cfg,
    load_checkpoint: str = "",
    max_iters: Optional[int] = None,
    dataset: Optional[FlameDataset] = None,
    dtype=None,
    device="cuda",
    steps_per_execute: Optional[int] = None,
    device_feed: Optional[bool] = None,
) -> TrainState:
    """Run training per the config on `device` (the card unless the
    caller asks for the CPU); returns the final `TrainState`. `dtype`
    torch.bfloat16 trains the paper model through K1 and a Flexible-family
    model through K4f/K4b. `steps_per_execute` and `device_feed` override
    the config's."""
    dev = torch.device(device)
    flags = FeatureFlags.from_cfg(cfg)
    if device_feed is None:
        device_feed = bool(cfg.experiment.get("device_feed") or False)
    if dataset is None:
        dataset = load_flame_data(
            cfg.dataset.basedir, half_res=cfg.dataset.half_res, testskip=cfg.dataset.testskip,
            cachedir=cfg.dataset.get("cachedir"),
        )
    seed = int(cfg.experiment.randomseed)
    np.random.seed(seed)
    model_coarse, model_fine = build_models_from_cfg(
        cfg, device=dev, generator=torch.Generator().manual_seed(seed)
    )
    background = setup_background(dataset, flags)
    state = create_train_state(
        model_coarse, model_fine, flags, n_train=len(dataset.i_train), background=background,
        device=dev,
    )
    optimizer = build_optimizer(cfg, state)
    if load_checkpoint:
        if not os.path.isfile(load_checkpoint):
            raise FileNotFoundError(f"--load-checkpoint path does not exist: {load_checkpoint!r}")
        restore_train_state(state, optimizer, load_torch_checkpoint(load_checkpoint, device=dev))

    settings = RenderSettings.from_cfg(cfg, mode="train")
    logdir = os.path.join(str(cfg.experiment.logdir), str(cfg.experiment.id))
    writer = ScalarWriter(logdir, cfg=cfg)
    train_iters = int(max_iters if max_iters is not None else cfg.experiment.train_iters)
    validate_every = int(cfg.experiment.validate_every)
    save_every = int(cfg.experiment.save_every)
    print_every = int(cfg.experiment.print_every)
    rays_per_step = int(cfg.nerf.train.num_random_rays)
    k_exec = _effective_window(_requested_window(steps_per_execute, cfg, train_iters),
                               [print_every, validate_every, save_every])
    if torch.is_anomaly_enabled() and k_exec > 1:
        print(f"[train] anomaly detection on (--debug-nans): one step a window instead of "
              f"{k_exec}", flush=True)
        k_exec = 1
    if k_exec > 1:
        print(f"[train] execution window: {k_exec} steps", flush=True)

    feed = dfeed = None
    if device_feed:
        from nerface_tpu_torch.data.device_feed import DeviceRayFeed

        dfeed = DeviceRayFeed(dataset, num_rays=rays_per_step,
                              background=background if flags.fixed_background else None,
                              device=dev)
    else:
        # resume continues the uninterrupted run's sample stream
        feed = RayFeed(dataset, num_rays=rays_per_step,
                       background=background if flags.fixed_background else None,
                       seed=seed, start_batch=state.step).start()
    cuda = dev.type == "cuda"
    async_val = cfg.experiment.get("async_val")
    async_val = bool(k_exec > 1 if async_val is None else async_val)
    val_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="train-val") if async_val else None
    val_stream = torch.cuda.Stream(device=dev) if async_val and cuda else None
    val_pending: collections.deque = collections.deque()

    def _drain_validation():
        while val_pending:
            val_pending.popleft().result()

    ckpt_writer = AsyncCheckpointWriter()

    def _before_capture():
        _drain_validation()
        ckpt_writer.drain()

    window = TrainWindow(state, optimizer, settings, flags, from_cfg(cfg), seed, k_exec,
                         dtype=dtype, device_feed=dfeed, before_capture=_before_capture)
    io_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="train-log")
    logged = []
    start_iter = state.step
    t_start = time.time()
    log_prev = {"t": None, "n": 0}

    def _log_train(host, ready, j, n_done):
        # the logging thread: waits for the copy, so rays/s counts work done
        if ready is not None:
            ready.synchronize()
        m = dict(zip(METRIC_KEYS, host.tolist()))
        now = time.time()
        rays_s = rays_per_step * n_done / max(now - t_start, 1e-9)
        inst = rays_s
        if log_prev["t"] is not None and n_done > log_prev["n"]:
            inst = rays_per_step * (n_done - log_prev["n"]) / max(now - log_prev["t"], 1e-9)
        log_prev["t"], log_prev["n"] = now, n_done
        print(
            f"[TRAIN] Iter: {j} Loss: {m['total_loss']:.6f} "
            f"BG Loss: {m['background_loss']:.6f} PSNR: {m['psnr']:.3f} "
            f"LatentReg: {m['latent_code_loss']:.6f} rays/s: {rays_s:,.0f}",
            flush=True,
        )
        writer.scalar("train/coarse_loss", m["coarse_loss"], j)
        writer.scalar("train/fine_loss", m["fine_loss"], j)
        writer.scalar("train/psnr", m["psnr"], j)
        writer.scalar("train/rays_per_sec", rays_s, j)
        writer.scalar("train/rays_per_sec_inst", inst, j)
        writer.scalar("host/rss_gb", host_rss_gb() or 0.0, j)
        if flags.train_latent_codes:
            writer.scalar("train/code_loss", m["latent_code_loss"], j)
        if flags.supervised_train_background:
            writer.scalar("train/bg_loss", m["background_loss"], j)

    # at each print boundary the loop waits for the previous boundary's
    # copy: the host runs at most ~2 print windows ahead of the card
    copies: collections.deque = collections.deque()

    def _backpressure(ready):
        copies.append(ready)
        if len(copies) > 1:
            prev = copies.popleft()
            if prev is not None:
                prev.synchronize()

    def _run_val(snap, vj, ready):
        if val_stream is None:
            vm = validate(cfg, dataset, snap, flags, vj, dtype=dtype, writer=writer)
        else:
            with torch.cuda.stream(val_stream):
                val_stream.wait_event(ready)
                vm = validate(cfg, dataset, snap, flags, vj, dtype=dtype, writer=writer)
        print(f"[VAL] Iter: {vj} loss: {vm['loss']:.6f} PSNR: {vm['psnr']:.3f} "
              f"time: {vm['time']:.2f}s", flush=True)
        return vm

    try:
        i = start_iter
        while i < train_iters:
            # the window [i .. j]: j is the next multiple of k_exec (where
            # every cadence lands) or the last step
            j = i if i % k_exec == 0 else (i // k_exec + 1) * k_exec
            j = min(j, train_iters - 1)
            k_run = j - i + 1
            batches = None if dfeed is not None else [next(feed) for _ in range(k_run)]
            window.run(k_run, batches)
            last = j == train_iters - 1

            if j % print_every == 0 or last:
                host = torch.empty(len(METRIC_KEYS), dtype=torch.float32, pin_memory=cuda)
                host.copy_(window.metrics_out, non_blocking=cuda)
                ready = None
                if cuda:
                    ready = torch.cuda.Event()
                    ready.record()
                _backpressure(ready)
                logged.append(io_pool.submit(_log_train, host, ready, j, j - start_iter + 1))

            if validate_every > 0 and j % validate_every == 0 and len(dataset.i_val):
                if val_pool is not None:
                    snap = _snapshot(state, val_stream)
                    ready = None
                    if val_stream is not None:
                        ready = torch.cuda.Event()
                        ready.record()
                    val_pending.append(val_pool.submit(_run_val, snap, j, ready))
                    # at most one render in flight
                    while len(val_pending) > 1:
                        val_pending.popleft().result()
                else:
                    _run_val(state, j, None)

            if save_every > 0 and (j % save_every == 0 or last):
                metrics = window.metrics_out
                ckpt_writer.submit(
                    os.path.join(logdir, f"checkpoint{state.step:05d}.ckpt"), state, optimizer,
                    loss=metrics[METRIC_KEYS.index("total_loss")],
                    psnr=metrics[METRIC_KEYS.index("psnr")],
                )
            i = j + 1
    finally:
        try:
            if feed is not None:
                feed.stop()
            _drain_validation()  # a failed render fails the run
            ckpt_writer.finish()  # and so does a failed save
        finally:
            if val_pool is not None:
                val_pool.shutdown(wait=True)
            io_pool.shutdown(wait=True)
            writer.close()
    for f in logged:
        f.result()
    return state
