"""Full test-sequence evaluation / reenactment.

Port of `nerface_tpu/eval/driver.py` (the reference's
`eval_transformed_rays.py:201-498`). `evaluate` renders every test frame
(pose and expression from `transforms_test.json`, which for reenactment is
a driven sequence), writes `savedir/{i:04d}.png`, `normals/`, and with the
options `disparity/` and `error/`, and reports the seconds a frame. In
bf16 on the card each pass of each tile of a paper-family frame is one
launch of the fused-render kernel (K2) through `render_full_frame`.

Ablations, as the reference has them (SURVEY.md §2.4):

* `interpolate_mouth`: pose and expression pinned to frame 241, blendshape
  68 swept over arange(-1, 1, 2/150) (:405-410).
* `frontalize`: pose pinned to frame 0 (:412-413).
* `ablate='expression'`: pose pinned to frame 100 (:422-423).
* `ablate='latent_code'`: pose and expression pinned to frame 100, the
  latent code from `idx_map[100+i, 1]` (:424-428).
* `ablate='view_dir'`: pose and expression pinned to frame 100, the
  direction branch fed the rays of pose `240+i` (:429-433). The fast
  renderer refuses direction ablation, so this mode renders the parity way.
* the latent row: `idx_map[10, 1]` pinned (the reference's "USE THIS" line,
  :444) unless `fix_latent_code_index` is off, then `idx_map[i, 1]` where
  it is ≥ 0 (:441-443); `ablate='latent_code'` overrides both.
* `no_lcode`: the latent table replaced by zeros(5000, 32) and still used
  (:386-389).
* `replace_background`: the checkpoint's background replaced by the
  dataset's `bg/00050.png` (:335-344).

Each pinned frame index is clamped to the split's length. Frame i draws
its samples with `seed=i` (JAX keys it by `PRNGKey(i)`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from nerface_tpu_torch.config.flags import EvalFlags, FeatureFlags
from nerface_tpu_torch.train.state import LATENT_DIM

# `no_lcode`'s zero table (`eval_transformed_rays.py:386-389`)
NO_LCODE_ROWS = 5000
# PNG writes a saver may have queued before `save` waits for the oldest
SAVER_BACKLOG = 16


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


# matplotlib's 'jet' control points: (position, (r, g, b))
_JET_STOPS = (
    (0.000, (0.0, 0.0, 0.5)),
    (0.110, (0.0, 0.0, 1.0)),
    (0.365, (0.0, 1.0, 1.0)),
    (0.500, (0.5, 1.0, 0.5)),
    (0.635, (1.0, 1.0, 0.0)),
    (0.890, (1.0, 0.0, 0.0)),
    (1.000, (0.5, 0.0, 0.0)),
)


def jet_colormap(x) -> np.ndarray:
    """[0,1] floats -> jet RGB uint8 (the reference's plt.imshow
    cmap='jet', `eval_transformed_rays.py:160-182`, without matplotlib)."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    pos = np.array([s[0] for s in _JET_STOPS], np.float64)
    cols = np.array([s[1] for s in _JET_STOPS], np.float64)
    out = np.empty(x.shape + (3,), np.float64)
    for c in range(3):
        out[..., c] = np.interp(x, pos, cols[:, c])
    return (out * 255).astype(np.uint8)


def error_image(gt, pred) -> np.ndarray:
    """Per-pixel L2 error, normalised to the frame's largest and
    jet-mapped (`eval_transformed_rays.py:160-182,489-497`)."""
    diff = np.linalg.norm(np.asarray(gt, np.float64) - np.asarray(pred, np.float64), axis=2)
    peak = diff.max()
    return jet_colormap(diff / (peak if peak > 0 else 1.0))


def _save_png(path: str, img, stream, fn) -> None:
    from PIL import Image

    if isinstance(img, torch.Tensor):
        # the copy to the host is queued on the stream that wrote the
        # tensor, so it follows the frame's kernels; it blocks this thread
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            img = img.cpu().numpy()
    if fn is not None:
        img = fn(img)
    Image.fromarray(np.asarray(img)).save(path)


class _AsyncSaver:
    """PNG writer on threads: at 512² a PNG encode costs about as much as
    the frame's render, so the writes, and the copies to the host before
    them, overlap the next frames (the reference saves synchronously inside
    its timed loop, `eval_transformed_rays.py:484-497`). `save` takes a
    tensor (read back on the thread) or an array, and an optional host
    function applied before the write. At most SAVER_BACKLOG writes wait
    at once, so a run whose writes lag its renders does not keep the whole
    sequence on the card. A write that fails fails `wait()`."""

    def __init__(self, workers: int = 4):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="png-saver")
        self._futures = []

    def save(self, path: str, img, fn=None) -> None:
        stream = None
        if isinstance(img, torch.Tensor) and img.is_cuda:
            stream = torch.cuda.current_stream(img.device)
        self._futures.append(self._pool.submit(_save_png, path, img, stream, fn))
        if len(self._futures) > SAVER_BACKLOG:
            self._futures.pop(0).result()

    def wait(self) -> None:
        futures, self._futures = self._futures, []
        for f in futures:
            f.result()

    def shutdown(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()


@dataclasses.dataclass
class Avatar:
    """A trained avatar ready to render: the models with the checkpoint's
    weights, the latent table, the background (H, W, 3) after the eval
    flags' rules, and the latent-row map (`index_map.npy` or the identity)."""

    model_coarse: torch.nn.Module
    model_fine: Optional[torch.nn.Module]
    latent_codes: Optional[torch.Tensor]
    background: Optional[torch.Tensor]
    idx_map: Optional[np.ndarray]


def load_avatar(cfg, checkpoint: str, dataset, flags: EvalFlags, device, log: bool = True,
                no_lcode: bool = False) -> Avatar:
    """The set-up shared by `evaluate` and the server (the JAX package's
    train-state template + `import_torch_weights`): models from cfg with
    the `.ckpt`'s weights, in eval mode on `device`; the checkpoint's latent
    table, else zeros(n_train, 32), when the flags train latent codes, and
    none otherwise (a table in the checkpoint is then ignored); with
    `no_lcode` (the eval driver's, not the server's) zeros(5000, 32) used
    in its place; the checkpoint's background, else zeros when a fixed or
    trained one is in use, then the eval flags' `replace_background` and
    `no_background`; `idx_map` when a table is used, the identity when the
    dataset has no `index_map.npy`."""
    from nerface_tpu_torch.train.checkpoint import load_torch_checkpoint
    from nerface_tpu_torch.train.loop import build_models_from_cfg

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not available "
                           "(pass device='cpu' to render on the CPU)")
    ckpt = load_torch_checkpoint(checkpoint, device=device)
    model_coarse, model_fine = build_models_from_cfg(cfg, device=device)
    model_coarse.load_state_dict(ckpt["coarse"], strict=True)
    if model_fine is not None:
        model_fine.load_state_dict(ckpt["fine"], strict=True)
    for m in (model_coarse, model_fine):
        if m is not None:
            m.eval().requires_grad_(False)

    train_flags = FeatureFlags.from_cfg(cfg)
    codes = None
    if train_flags.train_latent_codes and not train_flags.disable_latent_codes:
        codes = ckpt["latent_codes"]
        if codes is None:
            codes = torch.zeros(max(len(dataset.i_train), 1), LATENT_DIM, device=device)
    if no_lcode:
        codes = torch.zeros(NO_LCODE_ROWS, LATENT_DIM, device=device)

    background = ckpt["background"]
    if background is None and (train_flags.train_background or train_flags.fixed_background):
        background = torch.zeros(dataset.H, dataset.W, 3, device=device)
    if flags.replace_background:
        background = torch.as_tensor(dataset.load_background(), dtype=torch.float32,
                                     device=device)
    if flags.no_background:
        background = None

    idx_map = None
    if codes is not None:
        try:
            idx_map = dataset.load_index_map()
        except FileNotFoundError:
            # the reference requires index_map.npy (`eval_transformed_rays.py:329`)
            if log:
                print("WARNING: index_map.npy not found; using identity latent-code mapping")
            n = len(dataset.poses)
            idx_map = np.stack([np.arange(n), np.arange(n)], axis=-1)
    return Avatar(model_coarse, model_fine, codes, background, idx_map)


def _frame_inputs(i, flags, poses, expressions, idx_map, latent_index):
    """Frame i's pose, expression, direction-ablation pose and latent row
    under the ablations (`nerface_tpu/eval/driver.py:289-325`)."""
    last = len(poses) - 1
    pose, expression, view_pose = poses[i], expressions[i], None
    if flags.interpolate_mouth:
        pose = poses[min(241, last)]
        expression = expressions[min(241, last)].copy()
        sweep = np.arange(-1.0, 1.0, 2.0 / 150.0)
        expression[68] = sweep[min(i, len(sweep) - 1)]
    if flags.frontalize:
        pose = poses[0]
    if flags.ablate == "expression":
        pose = poses[min(100, last)]
    elif flags.ablate == "latent_code":
        pose, expression = poses[min(100, last)], expressions[min(100, last)]
        if idx_map is not None and 100 + i < len(idx_map) and idx_map[100 + i, 1] >= 0:
            latent_index = int(idx_map[100 + i, 1])
    elif flags.ablate == "view_dir":
        pose, expression = poses[min(100, last)], expressions[min(100, last)]
        view_pose = poses[min(240 + i, last)]
    if idx_map is not None and flags.ablate != "latent_code":
        if flags.fix_latent_code_index:
            latent_index = int(idx_map[min(10, len(idx_map) - 1), 1])
        elif i < len(idx_map) and idx_map[i, 1] >= 0:
            latent_index = int(idx_map[i, 1])
    return pose, expression, view_pose, latent_index


def evaluate(
    cfg,
    checkpoint: str,
    savedir: str,
    eval_flags: Optional[EvalFlags] = None,
    dataset=None,
    save_disparity_image: bool = False,
    save_error_image: bool = False,
    max_frames: Optional[int] = None,
    dtype=None,
    log: bool = True,
    device="cuda",
) -> Dict[str, float]:
    """Render the test split of `cfg`'s dataset with the `.ckpt` at
    `checkpoint` into `savedir`, on `device` (the card unless the caller
    asks for the CPU; there is no fallback); `dtype=torch.bfloat16` takes
    the kernel path. Returns `frames`, `avg_time_per_image` (seconds from a
    frame's start until its uint8 rgb is on the device, the stream
    synchronised), `setup_s` (dataset, checkpoint, fast-eval / occupancy
    set-up) and `frame_loop_s` (renders, copies and PNG writes, the saver
    joined)."""
    from nerface_tpu_torch.data.flame import load_flame_data
    from nerface_tpu_torch.eval.normals import normal_map_from_depth
    from nerface_tpu_torch.eval.renderer import render_full_frame
    from nerface_tpu_torch.ops.rays import get_ray_bundle
    from nerface_tpu_torch.render.pipeline import RenderSettings

    t_setup0 = time.perf_counter()
    device = torch.device(device)
    flags = eval_flags if eval_flags is not None else EvalFlags.from_cfg(cfg)
    if dataset is None:
        dataset = load_flame_data(
            cfg.dataset.basedir, half_res=cfg.dataset.half_res,
            testskip=cfg.dataset.testskip, test=True, cachedir=cfg.dataset.get("cachedir"),
        )
    avatar = load_avatar(cfg, checkpoint, dataset, flags, device, log=log,
                         no_lcode=flags.no_lcode)
    H, W = dataset.H, dataset.W
    intrinsics = np.asarray(dataset.intrinsics, np.float32)
    intr_t = torch.as_tensor(intrinsics, device=device)
    background = avatar.background
    codes = avatar.latent_codes

    render_poses = np.asarray(dataset.poses, np.float32)[dataset.i_test]
    render_expressions = np.asarray(dataset.expressions, np.float32)[dataset.i_test].copy()
    if flags.no_expressions:
        render_expressions = np.zeros_like(render_expressions)

    settings = RenderSettings.from_cfg(cfg, mode="validation")
    # opt-in fast eval: the union of the test split's head bboxes (the
    # ablations render frame i under other frames' poses), and with
    # `occupancy` the grid built from the trained field
    fast_bbox = occ_grid = None
    if settings.fast_eval:
        from nerface_tpu_torch.eval.occupancy import fast_eval_setup

        # the mouth sweep takes blendshape 68 to ±1, past anything in the
        # dataset: those extremes join the grid's expression sample, or
        # the sweep's density lands in voxels marked empty
        extra = None
        if flags.interpolate_mouth and len(render_expressions):
            extra = []
            for v in (-1.0, 1.0):
                e = render_expressions[min(241, len(render_expressions) - 1)].copy()
                e[68] = v
                extra.append(e)
        fast_bbox, settings, occ_grid = fast_eval_setup(
            dataset, render_poses, render_expressions, settings, avatar.model_coarse,
            latent_codes=codes, dtype=dtype, log=log, extra_expressions=extra, device=device,
        )

    os.makedirs(os.path.join(savedir, "normals"), exist_ok=True)
    if save_disparity_image:
        os.makedirs(os.path.join(savedir, "disparity"), exist_ok=True)
    if save_error_image:
        os.makedirs(os.path.join(savedir, "error"), exist_ok=True)

    n_frames = len(render_expressions)
    if max_frames is not None:
        n_frames = min(n_frames, max_frames)

    times = []
    latent_index = 0
    saver = _AsyncSaver()
    setup_s = time.perf_counter() - t_setup0
    t_loop0 = time.perf_counter()
    try:
        for i in range(n_frames):
            t0 = time.perf_counter()
            pose, expression, view_pose, latent_index = _frame_inputs(
                i, flags, render_poses, render_expressions, avatar.idx_map, latent_index)
            abl = None
            if view_pose is not None:
                _, abl = get_ray_bundle(H, W, intrinsics,
                                        torch.as_tensor(view_pose[:3, :4], device=device))
            latent_code = None
            if codes is not None:
                # a row past the table clamps, as JAX's gather does
                latent_code = codes[min(max(latent_index, 0), len(codes) - 1)]
            out = render_full_frame(
                avatar.model_coarse, avatar.model_fine, H, W, intrinsics, pose[:3, :4], settings,
                seed=i, expressions=torch.as_tensor(expression, device=device),
                latent_code=latent_code, background=background,
                ray_directions_ablation=abl, dtype=dtype, device=device,
                bbox=fast_bbox, occupancy=occ_grid,
            )
            rgb = out.get("rgb_fine", out["rgb_coarse"])
            disp = out.get("disp_fine", out["disp_coarse"])
            rgb_u8 = device_cast_to_image(rgb)
            # the frame's time ends when its uint8 rgb is on the device
            # (JAX: block_until_ready on it, `driver.py:352-355`)
            ready = None
            if device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(device))
            normals_u8 = device_uint8(normal_map_from_depth(disp, intr_t, out["bg_weight"],
                                                            clean=True))
            if ready is not None:
                ready.synchronize()
            times.append(time.perf_counter() - t0)

            saver.save(os.path.join(savedir, f"{i:04d}.png"), rgb_u8)
            saver.save(os.path.join(savedir, "normals", f"{i:04d}.png"), normals_u8)
            if save_disparity_image:
                saver.save(os.path.join(savedir, "disparity", f"{i:04d}.png"), disp,
                           cast_to_disparity_image)
            if save_error_image and len(dataset.i_test) > i:
                gt = dataset.images[dataset.i_test[i]][..., :3]
                # against the quantized render: the image the run ships
                saver.save(os.path.join(savedir, "error", f"{i:04d}.png"), rgb_u8,
                           lambda u8, gt=gt: error_image(gt, np.asarray(u8, np.float64) / 255.0))
            if log:
                print(f"Avg time per image: {sum(times) / (i + 1)}")
    finally:
        saver.shutdown()
    return {
        "frames": float(n_frames),
        "avg_time_per_image": (sum(times) / len(times)) if times else 0.0,
        "setup_s": setup_s,
        "frame_loop_s": time.perf_counter() - t_loop0,
    }
