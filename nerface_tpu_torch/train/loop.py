"""The training loop.

Port of the single-device, host-feed path of `nerface_tpu/train/loop.py`
(reference `train_transformed_rays.py:24-575`): config and data, the
models, the background and the latent table, the prefetching ray feed,
the train step (train/step.py: in bf16 on the card through K1 for the
paper model, through K4f/K4b for the Flexible family), periodic
validation renders (K2, or K4f), and reference-schema `.ckpt` saves.

Per step: one host batch from `RayFeed` (pinned, copied with
`non_blocking=True` on the card), and the draws' seed `step_seed(seed, i)`:
keyed by the iteration, so a resumed run draws what the uninterrupted run
would have, and a resumed feed (`start_batch` = the step) continues its
sample stream. Cadences as in the JAX package: print at `print_every` and
the last step; validate at `validate_every` (synchronously); save at
`save_every` and the last step, into `<logdir>/<id>/checkpoint<step>.ckpt`.

Not ported yet (ROADMAP.md Queue 1): the device feed, the execution
window (`steps_per_execute` > 1; "auto" runs one step at a time), async
validation, TensorBoard, several devices.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from nerface_tpu_torch.config.flags import FeatureFlags
from nerface_tpu_torch.data.flame import FlameDataset, load_flame_data
from nerface_tpu_torch.data.pipeline import RayFeed, batch_to_device
from nerface_tpu_torch.eval.renderer import render_full_frame
from nerface_tpu_torch.models.nerf_models import build_model
from nerface_tpu_torch.ops.math import mse2psnr
from nerface_tpu_torch.ops.sampling import step_seed
from nerface_tpu_torch.render.pipeline import RenderSettings
from nerface_tpu_torch.train.checkpoint import (
    load_torch_checkpoint,
    restore_train_state,
    save_torch_checkpoint,
)
from nerface_tpu_torch.train.schedule import from_cfg as schedule_from_cfg
from nerface_tpu_torch.train.state import TrainState, build_optimizer, create_train_state
from nerface_tpu_torch.train.step import train_step


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
    mean of the train frames (`train_transformed_rays.py:143-170`)."""
    if flags.train_background:
        if flags.blur_background:
            raise NotImplementedError(
                "blur_background is not ported yet (utils/smoothing.py: ROADMAP.md Queue 1)"
            )
        return dataset.images[dataset.i_train].mean(axis=0).astype(np.float32)
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
) -> Dict[str, float]:
    """Full-frame validation renders (`train_transformed_rays.py:427-549`)
    with the reference's quirks: only the first `num_frames` val frames,
    a zero latent code (which a model that takes none ignores), the fine
    MSE counted twice, and the sum divided by len(i_val)."""
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
    loss = total_loss / max(len(dataset.i_val), 1)
    return {"loss": loss, "psnr": float(mse2psnr(torch.tensor(loss))),
            "coarse_loss": coarse_loss, "fine_loss": fine_loss, "time": time.time() - t0}


def train(
    cfg,
    load_checkpoint: str = "",
    max_iters: Optional[int] = None,
    dataset: Optional[FlameDataset] = None,
    dtype=None,
    device="cuda",
    steps_per_execute: Optional[int] = None,
) -> TrainState:
    """Run training per the config on `device` (the card unless the
    caller asks for the CPU); returns the final `TrainState`. `dtype`
    torch.bfloat16 trains the paper model through K1 and a Flexible-family
    model through K4f/K4b."""
    if bool(cfg.experiment.get("device_feed") or False):
        raise NotImplementedError(
            "the device feed is not ported yet (ROADMAP.md Queue 1: DeviceRayFeed)"
        )
    k_req = steps_per_execute
    if k_req is None:
        k_req = cfg.experiment.get("steps_per_execute")
    if k_req is not None and str(k_req) != "auto" and int(k_req) > 1:
        raise NotImplementedError(
            "steps_per_execute > 1 is not ported yet (ROADMAP.md Queue 1: the CUDA-graph "
            "execution window)"
        )
    dev = torch.device(device)
    flags = FeatureFlags.from_cfg(cfg)
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
    schedule = schedule_from_cfg(cfg)
    for group in optimizer.param_groups:
        group["lr"] = schedule(state.step)

    settings = RenderSettings.from_cfg(cfg, mode="train")
    logdir = os.path.join(str(cfg.experiment.logdir), str(cfg.experiment.id))
    os.makedirs(logdir, exist_ok=True)
    train_iters = int(max_iters if max_iters is not None else cfg.experiment.train_iters)
    validate_every = int(cfg.experiment.validate_every)
    save_every = int(cfg.experiment.save_every)
    print_every = int(cfg.experiment.print_every)
    rays_per_step = int(cfg.nerf.train.num_random_rays)

    feed = RayFeed(
        dataset, num_rays=rays_per_step,
        background=background if flags.fixed_background else None,
        seed=seed, start_batch=state.step, pin_memory=dev.type == "cuda",
    ).start()
    start_iter = state.step
    t_start = time.time()
    try:
        for i in range(start_iter, train_iters):
            batch = batch_to_device(next(feed), dev)
            metrics = train_step(
                state, optimizer, batch, step_seed(seed, i), settings, flags, schedule, dtype=dtype
            )
            last = i == train_iters - 1
            if i % print_every == 0 or last:
                m = {k: float(v) for k, v in metrics.items()}
                rays_s = rays_per_step * (i - start_iter + 1) / max(time.time() - t_start, 1e-9)
                print(
                    f"[TRAIN] Iter: {i} Loss: {m['total_loss']:.6f} "
                    f"BG Loss: {m['background_loss']:.6f} PSNR: {m['psnr']:.3f} "
                    f"LatentReg: {m['latent_code_loss']:.6f} rays/s: {rays_s:,.0f}",
                    flush=True,
                )
            if validate_every > 0 and i % validate_every == 0 and len(dataset.i_val):
                vm = validate(cfg, dataset, state, flags, i, dtype=dtype)
                print(f"[VAL] Iter: {i} loss: {vm['loss']:.6f} PSNR: {vm['psnr']:.3f} "
                      f"time: {vm['time']:.2f}s", flush=True)
            if save_every > 0 and (i % save_every == 0 or last):
                save_torch_checkpoint(
                    os.path.join(logdir, f"checkpoint{state.step:05d}.ckpt"), state, optimizer,
                    loss=float(metrics["total_loss"]), psnr=float(metrics["psnr"]),
                )
    finally:
        feed.stop()
    return state
