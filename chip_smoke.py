#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`nerface_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100:
the kernel is built for sm_90a) and nvcc. It imports nothing of JAX.
Phases, one line each (plus the kernel's register report):

  1. device  — nvidia-smi's name and power limit, torch's device name;
               fails when CUDA is not available.
  2. build   — nvcc builds `nerface_tpu_torch/csrc/fused_paper_render.cu`
               into build/nerface_tpu_torch/; prints the seconds it took.
  3. kernel  — the fused-render kernel against its plain PyTorch version
               (bf16 operands), on He-scaled random weights (HE_GAIN) on
               the card, at the main path's coarse
               (S=64, with weights) and fine (S=128) shapes, for 4096 rays
               and for one whole 65536-ray tile (the plain version in
               chunks), among them rays with acc → 0, plus fully opaque
               rays: rgb/acc/bg_weight/weights atol 2e-3, depth atol
               2e-3·far, disp rtol 1e-2, everything finite. Median kernel
               and plain times at 4096 rays, and the kernel's at 65536
               (CUDA events, after warm-up).
  4. serve   — a 512² avatar of the paper model (configs/synth512_paper.yml
               as a dict, He-scaled random weights from a fixed seed with σ
               biased up so that the MLP's colour, not the background, makes
               the pixels; a 32-wide latent table; saved as a reference-schema
               .ckpt) served by `AvatarServer(dtype=torch.bfloat16,
               device="cuda")` over `serve_jsonl`: ping, three renders,
               stop. Checks every reply, that the kernel ran exactly
               2 × tiles times per frame, the maps' shapes and dtype, and the
               bf16 kernel frame against the f32 plain-PyTorch frame of the
               same request (max 1 level, mean ≤ 0.15 levels), and that the
               frame is the MLP's (≥ 10 levels off the background and a
               std of ≥ 10 levels).

    python3 chip_smoke.py --profile

adds a fifth phase: 6 timed frames per map set, then torch.profiler over 2
frames, whose table of device time per op is printed.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failure raises, exits non-zero and
prints no result.
"""

import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# configs/synth512_paper.yml as a dict (no PyYAML needed);
# tests/test_torch_serve.py pins the equality.
SYNTH512_PAPER = {
    "experiment": {
        "id": "synth512_paper", "logdir": "/tmp/nerface_runs", "randomseed": 42,
        "train_iters": 1000000, "validate_every": 1000, "save_every": 5000,
        "print_every": 100, "device": 0, "steps_per_execute": "auto",
    },
    "dataset": {
        "type": "blender", "basedir": "/tmp/synth512", "half_res": False,
        "testskip": 1, "no_ndc": True, "near": 0.2, "far": 0.8,
    },
    "models": {
        "coarse": {
            "type": "ConditionalBlendshapePaperNeRFModel", "num_layers": 4,
            "hidden_size": 256, "skip_connect_every": 3, "include_input_xyz": True,
            "log_sampling_xyz": True, "num_encoding_fn_xyz": 10, "use_viewdirs": True,
            "include_input_dir": False, "num_encoding_fn_dir": 4, "log_sampling_dir": True,
        },
        "fine": {
            "type": "ConditionalBlendshapePaperNeRFModel", "num_layers": 4,
            "hidden_size": 256, "skip_connect_every": 3, "num_encoding_fn_xyz": 10,
            "include_input_xyz": True, "log_sampling_xyz": True, "use_viewdirs": True,
            "include_input_dir": False, "num_encoding_fn_dir": 4, "log_sampling_dir": True,
        },
    },
    "optimizer": {"type": "Adam", "lr": 5.0e-4},
    "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
    "nerf": {
        "use_viewdirs": True,
        "encode_position_fn": "positional_encoding",
        "encode_direction_fn": "positional_encoding",
        "train": {
            "num_random_rays": 2048, "chunksize": 2048, "perturb": True,
            "num_coarse": 64, "num_fine": 64, "white_background": False,
            "radiance_field_noise_std": 0.1, "lindisp": False,
        },
        "validation": {
            "chunksize": 65536, "perturb": True, "num_coarse": 64, "num_fine": 64,
            "white_background": False, "radiance_field_noise_std": 0.0, "lindisp": False,
        },
    },
}

KERNEL_RAYS = 4096
TILE_RAYS = 65536  # the validation chunksize: one tile of the main path
FAR = 0.8
SEED = 0
# Random weights are PyTorch's default init times √6, He's variance 2/fan_in:
# as in a trained field, activations keep their size through the layers
# (at the default init they fade, and the output is nearly the last bias).
HE_GAIN = 6.0 ** 0.5
# added to fc_alpha's bias in the served avatar: σ ≈ 10 a unit of depth
# leaves the background ≈ e^-6 of a pixel
SIGMA_BIAS = 10.0
MLP_FLOP_PER_SAMPLE = 0.98e6  # the .cu file's count


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, text):
    print(f"[{name}] {text}", flush=True)


def _median_ms(fn, warmup=3, iters=15):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _kernel_inputs(n_rays, n_samples, gen, dev):
    """Rays through a head at the origin seen from z = 0.5; rays 0-1 with
    rd = 0 (acc = 0 exactly) and 2-3 with |rd| = 1e-9 (acc ~ 1e-5)."""
    import torch

    ro = torch.randn(n_rays, 3, generator=gen) * 0.05 + torch.tensor([0.0, 0.0, 0.5])
    rd = torch.randn(n_rays, 3, generator=gen) * torch.tensor([0.2, 0.2, 0.05])
    rd[:, 2] -= 1.0
    rd[0:2] = 0.0
    rd[2:4] = 1e-9
    z = 0.2 + torch.cumsum(torch.rand(n_rays, n_samples, generator=gen) * (1.2 / n_samples), -1)
    dc = torch.randn(n_rays, 128, generator=gen) * 0.3
    cond = torch.cat([torch.randn(76, generator=gen) * 0.5 / 3.0, torch.randn(32, generator=gen) * 0.1])
    bg = torch.rand(n_rays, 3, generator=gen)
    return [t.to(dev).contiguous() for t in (ro, rd, z, dc, cond, bg)]


def _compare(got, ref, label):
    """Kernel vs plain at the stated tolerances; returns the max abs errors."""
    import torch

    errs = {}
    for k in ref:
        check(bool(torch.isfinite(got[k]).all()), f"{label}: kernel {k} not finite")
        check(bool(torch.isfinite(ref[k]).all()), f"{label}: plain {k} not finite")
        errs[k] = float((got[k] - ref[k]).abs().max())
    for k in ("rgb", "acc", "bg_weight", "weights"):
        if k in ref:
            check(errs[k] <= 2e-3, f"{label}: {k} max abs err {errs[k]} > 2e-3")
    check(errs["depth"] <= 2e-3 * FAR, f"{label}: depth max abs err {errs['depth']}")
    rel = float(((got["disp"] - ref["disp"]).abs() / ref["disp"].abs()).max())
    check(rel <= 1e-2, f"{label}: disp max rel err {rel} > 1e-2")
    errs["disp_rel"] = rel
    return errs


def _chunked(fn, params, per_ray, cond, chunk=16384, **kw):
    """fn over chunks of the rays (the plain version's activations at
    65536 rays × 128 samples would take tens of GB)."""
    import torch

    ro, rd, z, dc, bg = per_ray
    parts = []
    for i in range(0, ro.shape[0], chunk):
        sl = slice(i, i + chunk)
        parts.append(fn(params, ro[sl], rd[sl], z[sl], dc[sl], cond, background=bg[sl], **kw))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _he_scale(model):
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".weight"):
                p.mul_(HE_GAIN)


def kernel_phase(dev):
    import torch

    from nerface_tpu_torch.models.nerf_models import ConditionalBlendshapePaperNeRFModel
    from nerface_tpu_torch.ops.kernels.fused_mlp import (
        fused_paper_render,
        fused_paper_render_reference,
        pack_paper_weights,
    )

    model = ConditionalBlendshapePaperNeRFModel(
        num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False,
        device=dev, generator=torch.Generator().manual_seed(SEED),
    )
    # the opaque rays' check below takes the default init: there one
    # sample's colour is the ray's, and a bf16 rounding flip of a He-scaled
    # activation moves it by up to 1.6e-3 of the 2e-3 limit (H100, PERF.md)
    default_init = {k: v.clone() for k, v in model.state_dict().items()}
    _he_scale(model)
    params = model.state_dict()
    packed = pack_paper_weights(params)
    gen = torch.Generator().manual_seed(SEED + 1)
    result = {"err": {}, "ms": {}, "plain_ms": {}, "tile_ms": {}}
    for label, S, with_w in (("coarse", 64, True), ("fine", 128, False)):
        ro, rd, z, dc, cond, bg = _kernel_inputs(KERNEL_RAYS, S, gen, dev)
        args = (params, ro, rd, z, dc, cond)
        kw = dict(background=bg, out_weights=with_w)
        got = fused_paper_render(*args, **kw)
        torch.cuda.synchronize()
        ref = fused_paper_render_reference(*args, **kw)
        check(float(got["acc"][:2].abs().max()) == 0.0, f"{label}: rd = 0 rays have acc != 0")
        result["err"][label] = _compare(got, ref, label)
        result["ms"][label] = _median_ms(lambda: fused_paper_render(packed, *args[1:], **kw))
        result["plain_ms"][label] = _median_ms(lambda: fused_paper_render_reference(*args, **kw))
        phase(
            "kernel",
            f"S={S} rays={KERNEL_RAYS}: max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in result["err"][label].items())
            + f"; kernel {result['ms'][label]:.3f} ms, plain {result['plain_ms'][label]:.3f} ms",
        )
        # one whole tile of the main path: 16x the grid of the check above
        ro, rd, z, dc, cond, bg = _kernel_inputs(TILE_RAYS, S, gen, dev)
        args = (packed, ro, rd, z, dc, cond)
        kw = dict(background=bg, out_weights=with_w)
        got = fused_paper_render(*args, **kw)
        torch.cuda.synchronize()
        ref = _chunked(fused_paper_render_reference, params, (ro, rd, z, dc, bg), cond,
                       out_weights=with_w)
        result["err"][label + "_tile"] = _compare(got, ref, label + " tile")
        del ref
        result["tile_ms"][label] = _median_ms(lambda: fused_paper_render(*args, **kw), iters=10)
        tflops = TILE_RAYS * S * MLP_FLOP_PER_SAMPLE / result["tile_ms"][label] / 1e9
        phase(
            "kernel",
            f"S={S} rays={TILE_RAYS}: max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in result["err"][label + "_tile"].items())
            + f"; kernel {result['tile_ms'][label]:.3f} ms, {tflops:.1f} TFLOP/s of MLP",
        )
    # fully opaque rays: σ = 1e8 puts σ·d past exp's underflow (σ·d > 104)
    # for every first spacing above 1e-6, so alpha == 1 exactly there
    hot = dict(default_init, **{"fc_alpha.bias": default_init["fc_alpha.bias"] + 1e8})
    ro, rd, z, dc, cond, bg = _kernel_inputs(256, 64, gen, dev)
    got = fused_paper_render(hot, ro, rd, z, dc, cond, background=bg, out_weights=True)
    ref = fused_paper_render_reference(hot, ro, rd, z, dc, cond, background=bg, out_weights=True)
    result["err"]["opaque"] = _compare(got, ref, "opaque")
    check(float((z[4:, 1] - z[4:, 0]).min()) > 1e-6, "opaque: a first spacing is below 1e-6")
    check(float((got["weights"][4:, 0] - 1.0).abs().max()) < 1e-6, "opaque: weight 0 != 1")
    phase("kernel", f"opaque rays: max abs err {max(result['err']['opaque'].values()):.3g}")
    return result


def serve_phase(dev, tmp):
    import numpy as np
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
    from nerface_tpu_torch.models.nerf_models import build_model
    from nerface_tpu_torch.ops.kernels.fused_mlp import fused_paper_render
    from nerface_tpu_torch.serve import AvatarServer

    cfg = CfgNode(SYNTH512_PAPER)
    ds = synthetic_flame_dataset(H=512, W=512, n_train=8, n_val=2, n_test=2, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 2)
    coarse = build_model(cfg.models.coarse, generator=gen)
    fine = build_model(
        cfg.models.fine, num_layers=cfg.models.coarse.num_layers,
        hidden_size=cfg.models.coarse.hidden_size, generator=gen,
    )
    for m in (coarse, fine):
        _he_scale(m)
        with torch.no_grad():
            m.fc_alpha.bias += SIGMA_BIAS
    ckpt = os.path.join(tmp, "synth512_paper.ckpt")
    torch.save(
        {
            "iter": 0,
            "model_coarse_state_dict": coarse.state_dict(),
            "model_fine_state_dict": fine.state_dict(),
            "optimizer_state_dict": None,
            "loss": 0.0,
            "psnr": 0.0,
            "background": torch.as_tensor(ds.load_background()),
            "latent_codes": torch.randn(len(ds.i_train), 32, generator=gen) * 0.1,
        },
        ckpt,
    )
    server = AvatarServer(cfg, ckpt, dataset=ds, dtype=torch.bfloat16, device=dev, log=False)
    n_pix = server.H * server.W
    tiles = -(-n_pix // min(server.settings.chunksize, n_pix))
    maps = ["rgb_fine", "disp", "normals"]
    requests = [
        {"cmd": "ping"},
        {"frame": 0, "seed": 0, "maps": maps},
        {"frame": 1, "seed": 1, "maps": maps},
        {"frame": 0, "seed": 2, "maps": maps},
        {"cmd": "stop"},
    ]
    n_renders = sum("cmd" not in r for r in requests)
    out = io.StringIO()
    fused_paper_render.launches = 0
    handled = server.serve_jsonl(io.StringIO("\n".join(map(json.dumps, requests)) + "\n"), out)
    launches = fused_paper_render.launches
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    check(handled == len(requests) and len(replies) == len(requests), f"replies: {replies}")
    for req, rep in zip(requests, replies):
        check(rep.get("ok") is True, f"request {req} failed: {rep}")
    check(replies[0]["H"] == 512 and replies[0]["W"] == 512, f"ping: {replies[0]}")
    check(launches == 2 * tiles * n_renders,
          f"kernel launches {launches} != 2 x {tiles} tiles x {n_renders} frames")
    frame_ms = [r["frame_ms"] for r in replies if "frame_ms" in r]
    phase("serve", f"{n_renders} renders at 512x512 via serve_jsonl, frame_ms {frame_ms}, "
                   f"kernel launches {launches} = 2 x {tiles} tiles x {n_renders}")

    # the maps of the request, and the same frame from the f32 plain path
    img = server.render(frame=1, seed=1, maps=tuple(maps))
    check(img["rgb_fine"].shape == (512, 512, 3), f"rgb shape {img['rgb_fine'].shape}")
    check(img["disp"].shape == (512, 512), f"disp shape {img['disp'].shape}")
    check(img["normals"].shape == (511, 511, 3), f"normals shape {img['normals'].shape}")
    for k, v in img.items():
        check(v.dtype == np.uint8, f"{k} dtype {v.dtype}")
    cfg32 = CfgNode(SYNTH512_PAPER)
    cfg32.nerf.validation["chunksize"] = 16384  # bounds the f32 activations
    plain = AvatarServer(cfg32, ckpt, dataset=ds, dtype=None, device=dev, log=False)
    before = fused_paper_render.launches
    ref = plain.render(frame=1, seed=1, maps=("rgb_fine",))["rgb_fine"]
    check(fused_paper_render.launches == before, "the f32 plain path launched the kernel")
    diff = np.abs(img["rgb_fine"].astype(np.int16) - ref.astype(np.int16))
    mean_diff, p99 = float(diff.mean()), float(np.percentile(diff, 99))
    # bf16 operands against f32: the limits sit just above the reading on an
    # H100 (mean 0.0999, max 1; PERF.md); the pixels are the MLP's colour
    bg = (np.clip(ds.load_background(), 0.0, 1.0) * 255.0).astype(np.int16)
    off_bg = float(np.abs(img["rgb_fine"].astype(np.int16) - bg).mean())
    spread = float(img["rgb_fine"].std())
    check(off_bg >= 10.0 and spread >= 10.0,
          f"frame {off_bg} levels off the background, std {spread}: the MLP shows little")
    check(int(diff.max()) <= 1 and mean_diff <= 0.15,
          f"bf16 frame vs f32: mean {mean_diff}, max {int(diff.max())}")
    phase("serve", f"shapes rgb {img['rgb_fine'].shape} disp {img['disp'].shape} normals "
                   f"{img['normals'].shape} uint8; mean |frame - background| {off_bg:.2f} "
                   f"levels, frame std {spread:.2f} levels; bf16 kernel frame "
                   f"vs f32 plain frame: mean |diff| {mean_diff:.4f} levels, p99 {p99:.0f}, "
                   f"max {int(diff.max())}")
    return server, {"launches": launches, "frame_ms": frame_ms, "tiles": tiles}


def profile_phase(server):
    """Frame times of the warm server, then where one frame's device time
    goes (torch.profiler over 2 frames, CUDA kernels only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    all_maps = ("rgb_fine", "disp", "normals")
    for maps in (("rgb_fine",), all_maps):
        server.render(frame=0, maps=maps)
        ts = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.render(frame=i % 2, seed=i, maps=maps)
            ts.append((time.perf_counter() - t0) * 1e3)
        phase("profile", f"frame_ms {'+'.join(maps)}: {[round(t, 2) for t in ts]}, "
                         f"median {statistics.median(ts):.2f}")
    n = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            server.render(frame=0, seed=i, maps=all_maps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "device_time_total", None)
            rows.append(((us if us is not None else e.cuda_time_total) / 1e3 / n, e.count // n,
                         e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    check(busy > 0.0, "the profiler saw no device time")
    phase("profile", f"{'+'.join(all_maps)} under the profiler: {wall:.2f} ms a frame, device "
                     f"busy {busy:.2f} ms ({100 * busy / wall:.1f} %), "
                     f"{sum(r[1] for r in rows)} kernel launches a frame")
    for ms, count, key in rows[:12]:
        phase("profile", f"  {ms:9.3f} ms {100 * ms / busy:5.1f} % x{count:<4d} {key[:90]}")
    return {"wall_ms": wall, "busy_ms": busy}


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also time warm frames and profile one frame's device time")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    phase("device", f"nvidia-smi: {card}; torch: {kind}, count {count}, "
                    f"torch {torch.__version__}, cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from nerface_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    lib = build.build_library("fused_paper_render")
    build_s = time.perf_counter() - t0
    regs = [line.strip() for line in open(str(lib) + ".log") if "registers" in line]
    phase("build", f"{build_s:.1f} s, {lib.name}; ptxas: {' | '.join(regs)}")

    k = kernel_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        server, s = serve_phase(dev, tmp)
        if args.profile:
            profile_phase(server)

    errs = [v for errs in k["err"].values() for key, v in errs.items()
            if key in ("rgb", "acc", "bg_weight", "weights")]
    kernels = {"kernels": [{
        "name": "fused_paper_render",
        "route": "cuda",
        "source": "nerface_tpu_torch/csrc/fused_paper_render.cu",
        "replaces": "nerface_tpu/ops/pallas/fused_mlp.py:652",
        "launches": s["launches"],
        "max_abs_err": max(errs),
        # one coarse (S=64, weights) + one fine (S=128) call on 4096 rays
        "ms": k["ms"]["coarse"] + k["ms"]["fine"],
        "plain_ms": k["plain_ms"]["coarse"] + k["plain_ms"]["fine"],
        "ms_by_pass": k["ms"],
        "plain_ms_by_pass": k["plain_ms"],
        "tile_ms_by_pass": k["tile_ms"],  # 65536 rays
        "frame_ms_512": s["frame_ms"],
        "card": card,
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
