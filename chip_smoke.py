#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`nerface_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100:
the kernels are built for sm_90a) and nvcc. It imports nothing of JAX.
Phases, one line each (plus the kernels' register reports):

  1. device  — nvidia-smi's name and power limit, torch's device name;
               fails when CUDA is not available.
  2. build   — nvcc builds the six kernel libraries,
               `nerface_tpu_torch/csrc/fused_paper_render.cu` (K2),
               `fused_train_pass.cu` (K1), `fused_paper_mlp.cu` (K3),
               `fused_flex.cu` (K4), `fused_resample.cu` (K5) and
               `probes.cu` (the design probes P1 / P2), in parallel into
               build/nerface_tpu_torch/; prints the seconds and each
               kernel's ptxas registers, spills and shared memory.
  3. kernel  — the fused-render kernel against its plain PyTorch version
               (bf16 operands), on He-scaled random weights (cases.HE_GAIN) on
               the card, at the main path's coarse
               (S=64, with weights) and fine (S=128) shapes, for 4096 rays
               and for one whole 65536-ray tile (the plain version in
               chunks), among them rays with acc → 0, plus fully opaque
               rays: rgb/acc/bg_weight/weights atol 2e-3, depth atol
               2e-3·far, disp rtol 1e-2, everything finite. Median kernel
               and plain times at 4096 rays, and the kernel's at 65536
               (CUDA events, after warm-up), each both through the wrapper
               and as the bare C launch with the conditioning folded
               beforehand (`launch_ms_by_pass`).
     small_kernels — the same for K2's `small` mode (the smaller paper
               model), and K1's `small` mode as in phase 6 at R = 2048,
               S = 64 and 128, at those kernels' limits.
     resample_kernel — K5 `fused_resample` on its own entry point (nothing
               renders through it, as in JAX): once per regime on a
               65536-ray tile with the counts reset, then against its plain
               version (the pipeline's sample_pdf + merge_sorted_zvals) at
               2048 rays and a 65536-ray tile, 64 + 64 samples, RESAMPLE_SEEDS
               draws a case, general and sorted_u (+ a spike case): max error
               ≤ RESAMPLE_TOL·far, rows sorted, bit-identical over 2
               launches; kernel (wrapper) ms, the bare C launch's ms, its
               device ms under torch.profiler and GB/s from that
               (`tools/perf/k3f_k5_launch_split.py`), plain and bound ms.
     probes  — the design probes of K2's layer chain
               (nerface_tpu_torch/tools/perf/, csrc/probes.cu), each variant
               driven once at the TPU probes' sizes with the counts reset
               (P2 chain_overlap: 7 variants; P1 encoder_concat: split and
               packed), then held against its plain version on every row
               (P2 within `chain_overlap_probe.tolerance`, bwd_mix's aᵀ·gy
               product of the last 64 rows within its TOL, P1 within its
               TOL) and timed: ms, TFLOP/s, the plain version's ms, and for
               P1 the ms a repetition.
  4. serve   — a 512² avatar of the paper model (configs/synth512_paper.yml
               as a dict, He-scaled random weights from a fixed seed with σ
               biased up so that the MLP's colour, not the background, makes
               the pixels; a 32-wide latent table; saved as a reference-schema
               .ckpt) served by `AvatarServer(dtype=torch.bfloat16,
               device="cuda")` over `serve_jsonl`: ping, three renders,
               stop. Checks every reply, that the kernel ran exactly
               2 × tiles times per frame, the maps' shapes and dtype, and the
               bf16 kernel frame against the f32 plain-PyTorch frame of the
               same request (max FRAME_MAX = 1 level, mean ≤ FRAME_MEAN =
               0.15 levels), and that the frame is the MLP's (≥ 10 levels
               off the background and a std of ≥ 10 levels).
     smaller_serve — the same for SYNTH512_SMALLER (both models the smaller
               paper model): K2 `small`, 24 launches.
     fast_serve — the same avatar with `nerf.validation.fast_eval: true`, the
               JAX package's production serving configuration: the bbox
               union [153, 358, 153, 358], capacity 0.17, 3 tiles of 16384
               rays, K2 launched 6 times a frame (nothing else); the fast
               frame against the same server's parity frame (active pixels
               within 1 level, the count that differ; every skipped pixel
               the background or, in a spare slot, the parity pixel); warm
               fast and parity frame ms in turns.
     noisy_frame — one 512² synth512_paper frame at validation σ-noise 0.1,
               which K2 refuses: K3f launched 2 × tiles = 8 times, K2 and
               K3b never; the frame against the f32 plain frame (the same
               noise draws) at the serve limits.
  5. train_kernel — K1 `fused_train_pass` against its plain PyTorch version
               (bf16 operands) on He-scaled random weights: R = 2048 rays at
               S = 64 and 128 with σ-noise and a background (the slice's two
               passes), R = 256 at S = 32 with a white background (σ raised
               by SIGMA_BIAS) and with a trainable background + the
               supervised background term.
               Each case on K1_SEEDS draws of weights and inputs: rgb/weights
               atol 2e-3; every gradient tensor within its max-error and
               norm-error limits (`k1_grad_limits`);
               everything finite; two launches on the same inputs give
               bit-identical gradients. Prints every tensor's worst readings.
               Median kernel and plain ms (CUDA events) and TFLOP/s at R = 2048,
               the bare C launch's ms (operands packed beforehand) and each of
               its kernels' device ms by name (torch.profiler) beside its
               bound (tools/perf/k1_launch_split.py); K3b's the same in
               paper_mlp_kernel.
     paper_mlp_kernel — K3f `fused_paper_mlp_forward` and K3b
               `fused_paper_mlp_backward` (csrc/fused_paper_mlp.cu) against
               their plain versions, both modes, K3_SEEDS draws a case: R =
               2048 at S = 64 and 128 (forward and backward) and 65536-ray
               tiles at S = 64 and 128 (forward). Raw rgb and σ within
               K3_OUT_TOL·max; every gradient tensor within
               `k1_grad_limits`; bit-identical over 2 launches; ms, TFLOP/s,
               bound ms and the plain versions' ms; K3f's bare C launch
               (`tools/perf/k3f_k5_launch_split.py`) beside its wrapper in
               every case. Then K3f against K2 on one 65536-ray tile, S =
               64: K3f's raw rows composited by ops/compositing.py against
               K2's rgb and acc within K3F_K2_TOL (the two run one chain).
  6. train_step — one train step of the flagship config (2048 rays, 64 + 64
               samples, σ-noise 0.1) on the card both ways from the same
               weights, batch and draws: bf16 through K1, f32 through the
               plain autograd path. Loss rtol 0.03, gradients atol
               0.25·max|f32| (tests/test_fused_train.py's envelope); every
               parameter with an f32 gradient has a bf16 one.
  7. train   — the main path: `train(cfg, dataset=…)` of
               nerface_tpu_torch/train/loop.py, bf16 on the card, for
               TRAIN_STEPS steps on a 512² in-memory dataset (4 train + 2 val
               frames rendered by the ported `render_blob_frame`, 8-bit as
               the PNGs hold them) with configs/synth512_paper.yml's
               settings, print_every 10, a validation at step 0 and saves at
               step 0 and the end. Checks: K1 launched 2 × steps times, K2
               2 × 4 tiles × 2 frames, K3 never; the loop printed the loss at
               steps 0, 10, 20, 30 and 39, every one finite, and the mean of
               those in the last 10 steps below that of steps 0 and 10; the
               last .ckpt reloads and holds two Adam param groups. Then the
               median of steady synchronised steps and rays/s.
     window_train — the execution window (train/window.py): `train()` of
               synth512_paper with configs/synth512_devfeed.yml's settings
               (the device feed) for WINDOW_STEPS = 40 steps, print every
               10, validation at 0 and 20, saves every 20 and at the end, at
               `steps_per_execute` WINDOW_K = 10 (CUDA-graph replays, async
               validation) and at 1 (the same step body eagerly, sync
               validation); then the same for the host feed. Checks: final
               parameters, latent table, Adam state (the last .ckpt) and
               printed [TRAIN] lines bit for bit; the [VAL] lines equal; K1
               ran 80 times and K2 32 (2 validations) in each run, read from
               torch.profiler's kernel records (replays included); the loss
               falls; the windowed run's steps are graph replays (38
               replays, K1's wrapper called from the host 6 times: 2 eager
               steps and the capture). Then the steady per-step ms windowed
               and step at a time (`train()`'s window of one step, one
               batch uploaded a step), each the median of 12 blocks of 10
               steps with validation off, and with --profile the device
               idle share of a window. The host feed is the native sampler
               (`nerface_tpu_torch/native`, RayFeed's default); its numpy
               path (`native=False`) beside it, windowed: both feeds'
               steady step, idle share (--profile) and the feed thread's ms
               a batch; and the device feed's `torch.topk` over the 512²
               frame's 262144 keys timed alone.
     eval    — the eval / reenactment entry point: a 512² synthetic
               dataset written to disk (EVAL_SPLIT: 16 train, 2 val, 5
               test frames), `cli/train.py --bf16` for EVAL_STEPS = 300
               steps of synth512_devfeed's settings at K = 50, then
               `cli/eval.py --bf16 --save-disparity-image
               --save-error-image` over the test split parity,
               `--fast-eval` and `--occupancy`: every file written, K2
               only (2 × 4 tiles a parity frame, and the parity run again
               under torch.profiler: 40 `render_kernel` runs), the bf16
               frames against the same checkpoint's f32 plain frames
               (FRAME_MAX / FRAME_MEAN), each fast frame's active pixels
               against the parity frame (`[fast_serve]`'s contract), and
               each mode's avg_time_per_image, setup_s and frame_loop_s.
     metrics — `cli/metrics.py` over each mode's renders against the test
               split: mean L1, PSNR, SSIM (LPIPS nan, no weights),
               metrics.txt and L2/ written.
     quality — the same 300 steps in f32 from the same seed; each run's
               last and first checkpoints rendered in bf16 (parity) and
               scored: each run ≥ QUALITY_GAIN_DB above its first
               checkpoint, bf16's mean test PSNR ≥ f32's −
               QUALITY_BF16_MARGIN_DB.
     supervised_train — the production run's sidecars: `cli/train.py
               --bf16` on the eval dataset with the host feed (native), K
               = 50, save_every 100, 300 steps, uninterrupted (in this
               process, K1's launches counted); then `cli/supervise.py`
               over the same run in a child process: once a checkpoint
               past step 100 is complete the phase sends the train child
               SIGTERM, the child must exit 143 and the supervisor
               relaunch it from the newest complete .ckpt and finish; the
               last .ckpt's parameters, latent table and Adam state equal
               the uninterrupted run's bit for bit. Then the training
               thread's ms inside an async save's `submit` against a
               synchronous save's.
     occupancy_serve — that run's last checkpoint served with fast_eval and
               the occupancy grid (splat, 128³, 2× supersampled): the grid
               builds' seconds, occupied and active fractions, capacity, K2
               launches (2 a tile), frame ms, and the fast_serve contract.
     smaller_train — the same for SYNTH512_SMALLER, PAPER_TRAIN_STEPS steps:
               K1 `small` 2 × steps = 60, K2 16.
     coarse_train — SYNTH512_PAPER_COARSE (no fine pass, which K1 refuses):
               one bf16 step against the f32 plain step as in phase 6 (K3f
               and K3b once each, K1 never; every parameter with a
               gradient), then PAPER_TRAIN_STEPS steps of `train()`: K3f and
               K3b 30 times each, K1 never, K2 4 tiles × 2 validation frames.
  8. flex_kernel — K4f `fused_flex_forward` and K4b `fused_flex_backward`
               (csrc/fused_flex.cu) against their plain versions on
               synth512_lcode's He-scaled weights, FLEX_SEEDS draws a case
               (FLEX_CASES): R = 2048 at S = 64 and 128 (forward and
               backward), one 65536-ray tile at each (forward), and the
               same model at 0 and 8 hidden layers at R = 2048, S = 32. Raw
               rgb and σ within FLEX_OUT_TOL of their max; every gradient
               tensor, d_v0 and d_dir within `k1_grad_limits` (at 8 hidden
               layers `flex_limit`: no less than FLEX_TC_FACTOR × the
               plain version's own error on the tensor cores, each reading
               printed per seed beside that yardstick's and what a lost
               64-row unit reads, the factor checked to lie between the
               two); bit-identical
               over 2 launches; at n = 3 the wrapper's and the bare C
               launch's ms (`tools/perf/flex_launch_split.py`, through the
               wrappers' `_launch_flex_*`), TFLOP/s, bound ms, the plain
               versions' ms, and K4b's device ms per launch (recompute, dX,
               dW, reductions) under torch.profiler, each beside its
               operations bound and, apart, its workspace byte floor.
     flex_dead_units — K4f + K4b at 8 hidden layers, DEAD_UNIT_PASSES
               passes of 2085 × 64 and 601 × 128 (their last round leaves
               warpgroup 1 past the last ray: the dead-unit walk of K4b's
               recompute and dX, `fused_flex.cu::skip_stages`), every
               pass's output and gradients equal to the first pass's bit
               for bit; passes and wall time. A fault fails the run.
  9. flex_serve — a 512² synth512_lcode avatar (SYNTH512_LCODE: the paper
               config with the Flexible family's
               ConditionalBlendshapeLearnableCodeNeRFModel) served as in
               phase 4: K4f launched 2 × tiles per frame, no K2 or K4b, the
               bf16 frame against the f32 plain frame within FLEX_FRAME_MAX
               / FLEX_FRAME_MEAN levels.
 10. flex_train — `train()` of synth512_lcode in bf16 for FLEX_TRAIN_STEPS
               steps, validation at step 0: K4f launched 2 × steps + 2 ×
               tiles × 2 frames, K4b 2 × steps, K1 and K2 never; the printed
               loss falling; the last .ckpt reloading; steady step ms and
               rays/s.

    python3 chip_smoke.py --profile

adds profile phases: 6 timed frames per map set, then torch.profiler over 2
frames, of the parity and of the fast synth512_paper server, of the σ-noise
frame's server (K3f) and of the synth512_lcode server, and torch.profiler
over 5 steady train steps of
synth512_paper, of synth512_paper_coarse and of synth512_lcode; each prints
its table of device time per kernel.

The line before the last is {"kernels": [...]} (K2, K1, K3f, K3b, K4f,
K4b, K5, P2, P1); the last line is {"ok": true, "device": {...}}. Any
failure raises, exits non-zero and prints no result.
"""

import contextlib
import copy
import ctypes
import io
import json
import math
import os
import re
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

# synth512_paper with one change: both models are the Flexible family's
# ConditionalBlendshapeLearnableCodeNeRFModel (expr·(1/3) ⊕ a 32-dim latent
# code folded into layer1, 3 hidden relu layers of 256, σ off the trunk),
# whose MLP runs through K4; tests/test_torch_flex_serve.py pins it.
SYNTH512_LCODE = copy.deepcopy(SYNTH512_PAPER)
for _node in SYNTH512_LCODE["models"].values():
    _node["type"] = "ConditionalBlendshapeLearnableCodeNeRFModel"

# synth512_paper with the reference's coarse-only setting: no models.fine
# node and num_fine 0 in training and validation, so K1 refuses the step
# and every training pass's MLP is K3 (K3f forward, K3b backward);
# tests/test_torch_paper_mlp.py pins it.
SYNTH512_PAPER_COARSE = copy.deepcopy(SYNTH512_PAPER)
del SYNTH512_PAPER_COARSE["models"]["fine"]
for _mode in ("train", "validation"):
    SYNTH512_PAPER_COARSE["nerf"][_mode]["num_fine"] = 0

# synth512_paper with both models ConditionalBlendshapePaperSmallerNeRFModel
# (5 trunk layers, the expression fed again into the direction branch) at
# the paper config's widths: K1, K2 and K3 in their `small` mode.
SYNTH512_SMALLER = copy.deepcopy(SYNTH512_PAPER)
for _node in SYNTH512_SMALLER["models"].values():
    _node["type"] = "ConditionalBlendshapePaperSmallerNeRFModel"

KERNEL_RAYS = 4096
TILE_RAYS = 65536  # the validation chunksize: one tile of the main path
FAR = 0.8
SEED = 0
# added to fc_alpha's bias in the served avatar: σ ≈ 10 a unit of depth
# leaves the background ≈ e^-6 of a pixel
SIGMA_BIAS = 10.0
# H100 SXM: dense bf16 tensor-core peak and HBM3 rate (NVIDIA data sheet),
# the denominators of each kernel's least time (`bound_ms`)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# The paper model's products per sample, (K, N) of each, at the function's
# widths (the kernels zero-pad layer 0's K = 63 and the skip layer's 319 to
# 64 and 320; the pad is not the function's work): the trunk, fc_feat, the
# σ head, the direction branch and the rgb head.
D_XYZ = 3 + 6 * 10  # xyz + 10 sin/cos bands
PAPER_FORWARD_KN = [(D_XYZ, 256), (256, 256), (256, 256), (D_XYZ + 256, 256), (256, 256),
                    (256, 256), (256, 256), (256, 1), (256, 128), (128, 128), (128, 128),
                    (128, 3)]
# dX runs every product but the two that read the encoded input, with the
# skip layer's K = 256 part only
PAPER_DX_KN = [(256, 256)] * 5 + [(256, 256), (256, 1), (256, 128), (128, 128), (128, 128),
                                  (128, 3)]
K2_FLOP_PER_SAMPLE = sum(2 * k * n for k, n in PAPER_FORWARD_KN)
# K1: forward + dX + dW (dW has the forward's products)
K1_FLOP_PER_SAMPLE = sum(2 * k * n for k, n in PAPER_FORWARD_KN + PAPER_DX_KN + PAPER_FORWARD_KN)
# the smaller model has no layers_xyz.5: one 256×256 product fewer in the
# forward, in dX and in dW
W5_FLOP = 2 * 256 * 256


def paper_flop_per_sample(small, backward):
    """The paper MLP's operations a sample: the forward (K2, K3f) or the
    forward + dX + dW (K1, K3b)."""
    if backward:
        return K1_FLOP_PER_SAMPLE - (3 * W5_FLOP if small else 0)
    return K2_FLOP_PER_SAMPLE - (W5_FLOP if small else 0)


# K1 against its plain version: each gradient tensor g against the plain
# r, on K1_SEEDS draws of weights and inputs per case, within two limits
# read on the card (PERF.md): the max error max|g − r| ≤ a·max|r| + 1e-6,
# and the norm error ‖g − r‖ ≤ b·‖r‖ + 1e-6, which bf16 rounding flips
# barely move but a systematic fault (a dropped or doubled row segment, a
# wrong partial) would. (a, b) = k1_grad_limits(n_rays, tensor).
K1_SEEDS = 3
K1_GRAD_TOL = (0.02, 0.02)  # (max, norm) at the slice's 2048 rays
# at a few hundred rays (the white and trainable-background cases), whose
# sums have fewer terms
K1_GRAD_TOL_FEW_RAYS = (0.06, 0.04)
# the direction branch's gradients have few terms: one flipped bf16
# rounding moves them further (d_dir, a ray's sum over its samples, most)
K1_DIR_BRANCH_MAX_TOL = {"dir": 0.15, "wd0": 0.04, "wd1": 0.04, "wd2": 0.04,
                         "bd0": 0.04, "bd1": 0.04, "bd2": 0.04}


def k1_grad_limits(n_rays, name):
    """(max, norm) limits of K1's gradient tensor `name` in a pass of
    `n_rays` rays, relative to the plain version's max|r| and ‖r‖."""
    max_tol, norm_tol = K1_GRAD_TOL if n_rays >= TRAIN_RAYS else K1_GRAD_TOL_FEW_RAYS
    return max(max_tol, K1_DIR_BRANCH_MAX_TOL.get(name, 0.0)), norm_tol


# The Flexible trunk of synth512_lcode (n = 3 hidden layers), forward:
# layer1 at K = 63, the hidden layers, fc_feat, the σ head off the trunk,
# layers_dir.0's feat columns and fc_rgb. Its dX products: fc_rgb,
# layers_dir.0, fc_feat, the σ head and the hidden layers (the last one's
# output cotangent feeds layer1's gradient and d_v0).
FLEX_FORWARD_KN = [(D_XYZ, 256)] + [(256, 256)] * 3 + [(256, 256), (256, 1), (256, 128), (128, 3)]
FLEX_DX_KN = [(128, 3), (256, 128), (256, 256), (256, 1)] + [(256, 256)] * 3
K4F_FLOP_PER_SAMPLE = sum(2 * k * n for k, n in FLEX_FORWARD_KN)
# K4b: recompute + dX + dW (dW has the forward's products)
K4B_FLOP_PER_SAMPLE = sum(2 * k * n for k, n in FLEX_FORWARD_KN + FLEX_DX_KN + FLEX_FORWARD_KN)
FLEX_N_HIDDEN = 3
FLEX_SEEDS = 3
# K4f against its plain version: max |kernel − plain| ≤ FLEX_OUT_TOL·max|plain|,
# raw rgb and σ each: a flipped bf16 rounding of an activation moves a raw
# output by a few units of its last bf16 place (readings on the card up to
# 5.6e-3, PERF.md). K4b's gradients take K1's limits (`k1_grad_limits`).
FLEX_OUT_TOL = 0.01
# the served bf16 K4f frame against the f32 plain frame, in 8-bit levels
# (readings on the card: max 1, mean 0.0748; PERF.md)
FLEX_FRAME_MAX = 1
FLEX_FRAME_MEAN = 0.1

TRAIN_RAYS = 2048
TRAIN_STEPS = 40
FLEX_TRAIN_STEPS = 30
# the paper family's slice: train() steps of synth512_smaller (K1 small) and
# of synth512_paper_coarse (K3)
PAPER_TRAIN_STEPS = 30
# K3f against its plain version: raw rgb and σ within K3_OUT_TOL·max|plain|
# each (K4f's limit, for the same kind of kernel); K3b's gradients take
# K1's limits (`k1_grad_limits`)
K3_OUT_TOL = 0.01
K3_SEEDS = 3
# K3f's raw rows composited by the port's plain compositing against K2's
# rgb / acc on the same inputs: the two kernels run one copy of the chain
# (csrc/paper_chain.cuh) on the same bf16 weight images, f32 rows and dir_c,
# so their raw rows are the same bits and only the compositing differs (K2's
# warp scan of log transmittance against torch's cumprod: a few f32 ulps a
# sample, ~1e-6 over 64 samples). One flipped bf16 rounding in either chain
# moves an output by ~1e-3 (each kernel against its plain version), so
# K3F_K2_TOL = 1e-4 keeps rounding noise and catches a chain that differs.
K3F_K2_TOL = 1e-4
# a served frame against the f32 plain frame, in 8-bit levels: K2 (with or
# without `small`) and the σ-noise frame through K3f
FRAME_MAX = 1
FRAME_MEAN = 0.15
LIBRARIES = ("fused_paper_render", "fused_train_pass", "fused_paper_mlp", "fused_flex",
             "fused_resample", "probes")
# PR 5's record of K2's 65536-ray tile times in its earlier design
# (ldmatrix + mma.sync, one 512-thread CTA a tile), read by chip_smoke.py on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6). Copied, not measured: the
# phase text prints them, labelled, beside this run's; the kernels line
# carries only this run's numbers
K2_PREVIOUS_TILE_MS = {"coarse": 18.985, "fine": 37.460}
# ... and its warm rgb 512² frames, parity / fast / occupancy (PERF.md §5, §6)
PREVIOUS_FRAME_MS = {"parity": 240.43, "fast": 56.14, "occupancy": 53.85}
K4F_DESIGN = ("K2's wgmma chain without the cluster (csrc/wgmma_chain.cuh): m64n256k16 with A "
              "from registers; weight chunk images through a 5-stage bulk-copy ring; persistent "
              "grid, one CTA an SM; two free-running consumer warpgroups on whole rays; three "
              "encoder warps; n = 0..8 hidden layers at run time; the heads on m64n8 wgmmas")
K4B_DESIGN = ("the recompute: K4f's kernel with a save flag, the activations to the workspace as "
              "wgmma operand images and the relu masks as bits; dX: persistent, each product one "
              "wgmma_ss m64n256k16 chain with A (the last cotangent) in a shared-memory tile, "
              "copied out by one bulk store, masks from the bits; dW: wgmma_dw.cuh's kernel in "
              "row segments filling one wave; two ordered reduce_rows, no atomics")
K3F_DESIGN = ("K2's chain (csrc/paper_chain.cuh on wgmma_chain.cuh) without the cluster: persistent "
              "grid, one CTA an SM; weight chunk images through a 5-stage bulk-copy ring; three "
              "encoder warps; two free-running consumer warpgroups on whole rays, m64n256k16 with A "
              "from registers, the heads on m64n8; each row's raw [rgb, σ] out as one float4")
K5_DESIGN = ("persistent warps, one ray each at a time, the next ray's rows loaded ahead into "
             "registers; the scan in registers (butterfly sum, warp scan); a branch-free search; the "
             "draws bitonic-sorted by shuffles; the union one bitonic merge of 32·E registers; "
             "16-byte stores")
K2_DESIGN = ("wgmma m64n256k16 with A from registers, f32 accumulators; weight chunk "
             "images through a 5-stage ring of cp.async.bulk copies from a producer warp "
             "(mbarriers), multicast to a 2-CTA cluster; persistent grid; two free-running "
             "consumer warpgroups, each on whole rays; three encoder warps; the heads on "
             "m64n8 wgmmas")
# K5 against its plain version (the pipeline's sample_pdf + merge_sorted_zvals):
# max |kernel − plain| ≤ RESAMPLE_TOL·far, the JAX kernel's own contract
# against its XLA twin (`tests/test_pallas.py`), on RESAMPLE_SEEDS draws per
# case at 64 + 64 samples; the spike case's mass on one bin is RESAMPLE_SPIKE
RESAMPLE_TOL = 1e-5
RESAMPLE_SEEDS = 3
RESAMPLE_SPIKE = 50.0
# synth512_paper served as the JAX package's production configuration:
# fast-eval (the test split's head-bbox union, capacity 0.17 of the 512²
# frame: 3 tiles of 16384 rays) and, for the trained checkpoint, the
# occupancy grid too (splat mask, 128³, 2× supersampled)
FAST_FRAMES = 6  # timed warm frames per renderer, fast and parity in turns
# the fast phases' frame side and grid resolution (a CPU rehearsal shrinks them)
FAST_SERVE_SIZE = 512
OCCUPANCY_RESOLUTION = 128


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, text):
    print(f"[{name}] {text}", flush=True)


def _median_ms(fn, warmup=3, iters=15):
    from nerface_tpu_torch.tools.perf._timing import median_ms

    return median_ms(fn, warmup, iters)


def _kernel_inputs(n_rays, n_samples, gen, dev):
    """Rays through a head at the origin seen from z = 0.5 (`cases.py`'s
    `render_inputs`); rays 0-1 with rd = 0 (acc = 0 exactly) and 2-3 with
    |rd| = 1e-9 (acc ~ 1e-5)."""
    from nerface_tpu_torch.tools.perf.cases import render_inputs

    ro, rd, z, dc, cond, bg = render_inputs(n_rays, n_samples, gen, dev)
    rd[0:2] = 0.0
    rd[2:4] = 1e-9
    return [ro, rd, z, dc, cond, bg]


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


def _paper_model(seed, dev, small=False):
    """A paper-family model (the smaller one with `small`) at the slice's
    widths, its weights drawn from `seed`."""
    import torch

    from nerface_tpu_torch.models.nerf_models import (
        ConditionalBlendshapePaperNeRFModel,
        ConditionalBlendshapePaperSmallerNeRFModel,
    )

    cls = ConditionalBlendshapePaperSmallerNeRFModel if small else ConditionalBlendshapePaperNeRFModel
    return cls(num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False,
               device=dev, generator=torch.Generator().manual_seed(seed))


def kernel_phase(dev, small=False):
    """K2 (its `small` mode with `small`) against its plain version."""
    import torch

    from nerface_tpu_torch.ops.kernels.fused_mlp import (
        fused_paper_render,
        fused_paper_render_reference,
        pack_paper_weights,
    )
    from nerface_tpu_torch.tools.perf.cases import he_scale

    name = "small_kernels" if small else "kernel"
    what = "K2 small" if small else "K2"
    model = _paper_model(SEED + (50 if small else 0), dev, small)
    # the opaque rays' check below takes the default init: there one
    # sample's colour is the ray's, and a bf16 rounding flip of a He-scaled
    # activation moves it by up to 1.6e-3 of the 2e-3 limit (H100, PERF.md)
    default_init = {k: v.clone() for k, v in model.state_dict().items()}
    he_scale(model)
    params = model.state_dict()
    packed = pack_paper_weights(params)
    gen = torch.Generator().manual_seed(SEED + 1)
    result = {"err": {}, "ms": {}, "plain_ms": {}, "tile_ms": {}, "launch_ms": {}}
    for label, S, with_w in (("coarse", 64, True), ("fine", 128, False)):
        ro, rd, z, dc, cond, bg = _kernel_inputs(KERNEL_RAYS, S, gen, dev)
        args = (params, ro, rd, z, dc, cond)
        kw = dict(background=bg, out_weights=with_w, small=small)
        got = fused_paper_render(*args, **kw)
        torch.cuda.synchronize()
        ref = fused_paper_render_reference(*args, **kw)
        check(float(got["acc"][:2].abs().max()) == 0.0, f"{label}: rd = 0 rays have acc != 0")
        result["err"][label] = _compare(got, ref, f"{what} {label}")
        result["ms"][label] = _median_ms(lambda: fused_paper_render(packed, *args[1:], **kw))
        result["launch_ms"][label] = _median_ms(_bare_launch(packed, args[1:], kw))
        result["plain_ms"][label] = _median_ms(lambda: fused_paper_render_reference(*args, **kw))
        phase(
            name,
            f"{what} S={S} rays={KERNEL_RAYS}: max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in result["err"][label].items())
            + f"; kernel {result['ms'][label]:.3f} ms (bare launch "
            f"{result['launch_ms'][label]:.3f} ms), plain {result['plain_ms'][label]:.3f} ms",
        )
        # one whole tile of the main path: 16x the grid of the check above
        ro, rd, z, dc, cond, bg = _kernel_inputs(TILE_RAYS, S, gen, dev)
        args = (packed, ro, rd, z, dc, cond)
        kw = dict(background=bg, out_weights=with_w, small=small)
        got = fused_paper_render(*args, **kw)
        torch.cuda.synchronize()
        ref = _chunked(fused_paper_render_reference, params, (ro, rd, z, dc, bg), cond,
                       out_weights=with_w, small=small)
        result["err"][label + "_tile"] = _compare(got, ref, f"{what} {label} tile")
        del ref
        result["tile_ms"][label] = _median_ms(lambda: fused_paper_render(*args, **kw), iters=10)
        result["launch_ms"][label + "_tile"] = _median_ms(_bare_launch(packed, args[1:], kw), iters=10)
        flop = TILE_RAYS * S * paper_flop_per_sample(small, False)
        tflops = flop / result["tile_ms"][label] / 1e9
        bound = _bound_ms(flop, _k2_bytes(TILE_RAYS, S, with_w))[0]
        prev = "" if small else f" (PR 5's record, earlier design: {K2_PREVIOUS_TILE_MS[label]} ms)"
        phase(
            name,
            f"{what} S={S} rays={TILE_RAYS}: max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in result["err"][label + "_tile"].items())
            + f"; kernel {result['tile_ms'][label]:.3f} ms (bare launch "
            f"{result['launch_ms'][label + '_tile']:.3f} ms), {tflops:.1f} TFLOP/s of MLP; bound "
            f"{bound:.3f} ms{prev}",
        )
    if small:
        return result
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


def _bare_launch(packed, per_call, kw):
    """K2's C entry point alone, as a function to time: the conditioning
    folded and the outputs allocated beforehand, so a call is the ctypes
    call and the kernel (the wrapper's time also holds the fold, the
    checks and the allocations). `per_call` is (ro, rd, z, dc, cond)."""
    from nerface_tpu_torch.ops.kernels.fused_mlp import (
        _fold_conditioning,
        _launch_render,
        render_outputs,
    )

    ro, rd, z, dc, cond = per_call
    fbuf = _fold_conditioning(packed, cond)
    out = render_outputs(*z.shape, kw.get("out_weights", False), ro.device)
    operands = (ro, rd, z, dc, kw.get("background"))
    return lambda: _launch_render(packed, fbuf, operands, out, kw.get("white_background", False),
                                  kw.get("small", False))


def probes_phase(dev):
    """The design probes P2 (chain_overlap, 7 variants) and P1
    (encoder_concat, split / packed) of K2's layer chain: each variant
    driven once at the TPU probes' sizes with the counts reset just before,
    then held against its plain version and timed."""
    import torch

    from nerface_tpu_torch.tools.perf import chain_overlap_probe as P2
    from nerface_tpu_torch.tools.perf import encoder_concat_probe as P1

    P2.chain_overlap.launches = 0
    P1.encoder_concat.launches = 0
    r2 = P2.run(dev, seed=SEED + 40)
    r1 = P1.run(dev, seed=SEED + 41)
    check(r2["launches"] == len(P2.VARIANTS), f"probes: P2 drove {r2['launches']} launches")
    check(r1["launches"] == len(P1.VARIANTS), f"probes: P1 drove {r1['launches']} launches")
    rows = P2.GRID * P2.TILE
    for v, r in r2["variants"].items():
        max_tol, norm_tol = P2.tolerance(v)
        check(r["finite"], f"probes: P2 {v} not finite")
        check(r["max_err"] <= max_tol and r["norm_err"] <= norm_tol,
              f"probes: P2 {v} max / norm err {r['max_err']:.3g} / {r['norm_err']:.3g} > "
              f"{max_tol} / {norm_tol}")
        dw = ""
        if v == "bwd_mix":
            check(r["dw_finite"] and r["dw_max_err"] <= P2.TOL[0]
                  and r["dw_norm_err"] <= P2.TOL[1],
                  f"probes: P2 bwd_mix aᵀ·gy max / norm err {r['dw_max_err']:.3g} / "
                  f"{r['dw_norm_err']:.3g} > {P2.TOL[0]} / {P2.TOL[1]}")
            dw = (f"; aᵀ·gy of the last 64 rows max / norm rel err {r['dw_max_err']:.2e} / "
                  f"{r['dw_norm_err']:.2e} (limits {P2.TOL[0]} / {P2.TOL[1]})")
        r["bound"] = _bound_ms(P2.flops(rows), P2.nbytes(rows))
        phase("probes", f"P2 {v:17s} {rows} rows × {P2.DEPTH} layers: {r['ms']:.3f} ms, "
                        f"{r['tflops']:.1f} TFLOP/s (bound {r['bound'][0]:.3f} ms, "
                        f"{r['bound'][1]}); plain {r['plain_ms']:.2f} ms; max / norm rel err "
                        f"{r['max_err']:.2e} / {r['norm_err']:.2e} (limits {max_tol} / {norm_tol})"
                        f"{dw}")
    for v, r in r1["variants"].items():
        check(r["finite"] and r["max_err"] <= P1.TOL,
              f"probes: P1 {v} max rel err {r['max_err']:.3g} > {P1.TOL}")
        r["bound"] = _bound_ms(P1.flops(rows), P1.nbytes(rows))
        phase("probes", f"P1 {v:6s} {rows} rows × {P1.REPS} reps: {r['ms']:.3f} ms, "
                        f"{r['tflops']:.1f} TFLOP/s (bound {r['bound'][0]:.3f} ms, "
                        f"{r['bound'][1]}); {1e3 * r['rep_ms']:.2f} µs a repetition "
                        f"({r['rep_tflops'] or 0:.1f} TFLOP/s); plain {r['plain_ms']:.2f} ms; "
                        f"max rel err {r['max_err']:.2e} (limit {P1.TOL})")
    # the probes' GB of inputs, outputs and plain versions go back to the card
    # before the serving and training phases
    torch.cuda.empty_cache()
    faster = min(P1.VARIANTS, key=lambda v: r1["variants"][v]["rep_ms"])
    phase("probes", f"P1: {faster} is faster a repetition; P2: the two free-running warpgroups "
                    f"{r2['variants']['twochain']['tflops']:.1f} TFLOP/s against ping-pong "
                    f"{r2['variants']['twochain_pingpong']['tflops']:.1f} and one warpgroup "
                    f"{r2['variants']['single']['tflops']:.1f}")
    return {"P2": r2, "P1": r1}


def _frame_against_plain(img, cfg_dict, ckpt, ds, dev, label):
    """The served bf16 frame `img` (frame 1, seed 1) against the f32
    plain-PyTorch frame of the same request: (mean |diff|, p99, max) in
    8-bit levels; fails past FRAME_MEAN / FRAME_MAX, when the f32 path
    launched a kernel, or when the frame shows little of the MLP."""
    import numpy as np

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.ops.kernels.fused_mlp import (
        fused_paper_mlp_forward,
        fused_paper_render,
    )
    from nerface_tpu_torch.serve import AvatarServer

    cfg32 = CfgNode(cfg_dict)
    cfg32.nerf.validation["chunksize"] = 16384  # bounds the f32 activations
    plain = AvatarServer(cfg32, ckpt, dataset=ds, dtype=None, device=dev, log=False)
    before = fused_paper_render.launches + fused_paper_mlp_forward.launches
    ref = plain.render(frame=1, seed=1, maps=("rgb_fine",))["rgb_fine"]
    check(fused_paper_render.launches + fused_paper_mlp_forward.launches == before,
          f"{label}: the f32 plain path launched a kernel")
    diff = np.abs(img["rgb_fine"].astype(np.int16) - ref.astype(np.int16))
    mean_diff, p99 = float(diff.mean()), float(np.percentile(diff, 99))
    # bf16 operands against f32: the limits sit just above the readings on
    # an H100 (PERF.md); the pixels are the MLP's colour
    bg = (np.clip(ds.load_background(), 0.0, 1.0) * 255.0).astype(np.int16)
    off_bg = float(np.abs(img["rgb_fine"].astype(np.int16) - bg).mean())
    spread = float(img["rgb_fine"].std())
    check(off_bg >= 10.0 and spread >= 10.0,
          f"{label}: frame {off_bg} levels off the background, std {spread}: the MLP shows little")
    check(int(diff.max()) <= FRAME_MAX and mean_diff <= FRAME_MEAN,
          f"{label}: bf16 frame vs f32: mean {mean_diff}, max {int(diff.max())}")
    return {"mean_diff": mean_diff, "p99": p99, "max_diff": int(diff.max()), "off_bg": off_bg,
            "spread": spread}


def serve_phase(dev, tmp, cfg_dict=SYNTH512_PAPER, name="serve", seed=SEED + 2):
    """A 512² avatar of `cfg_dict` (a paper-family model) served in bf16:
    every pass of every tile one K2 launch."""
    import numpy as np
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
    from nerface_tpu_torch.ops.kernels.fused_mlp import fused_paper_mlp_forward, fused_paper_render
    from nerface_tpu_torch.serve import AvatarServer

    cfg = CfgNode(cfg_dict)
    ds = synthetic_flame_dataset(H=512, W=512, n_train=8, n_val=2, n_test=2, seed=SEED)
    ckpt = _save_avatar(cfg, ds, os.path.join(tmp, f"{name}.ckpt"), seed)
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
    fused_paper_render.launches = fused_paper_mlp_forward.launches = 0
    handled = server.serve_jsonl(io.StringIO("\n".join(map(json.dumps, requests)) + "\n"), out)
    launches = fused_paper_render.launches
    check(fused_paper_mlp_forward.launches == 0, f"{name}: serving launched K3f")
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    check(handled == len(requests) and len(replies) == len(requests), f"replies: {replies}")
    for req, rep in zip(requests, replies):
        check(rep.get("ok") is True, f"request {req} failed: {rep}")
    check(replies[0]["H"] == 512 and replies[0]["W"] == 512, f"ping: {replies[0]}")
    check(launches == 2 * tiles * n_renders,
          f"{name}: K2 launches {launches} != 2 x {tiles} tiles x {n_renders} frames")
    frame_ms = [r["frame_ms"] for r in replies if "frame_ms" in r]
    phase(name, f"{n_renders} renders of {cfg.models.coarse.type} at 512x512 via serve_jsonl, "
                f"frame_ms {frame_ms}, K2 launches {launches} = 2 x {tiles} tiles x {n_renders}")

    # the maps of the request, and the same frame from the f32 plain path
    img = server.render(frame=1, seed=1, maps=tuple(maps))
    check(img["rgb_fine"].shape == (512, 512, 3), f"rgb shape {img['rgb_fine'].shape}")
    check(img["disp"].shape == (512, 512), f"disp shape {img['disp'].shape}")
    check(img["normals"].shape == (511, 511, 3), f"normals shape {img['normals'].shape}")
    for k, v in img.items():
        check(v.dtype == np.uint8, f"{k} dtype {v.dtype}")
    f = _frame_against_plain(img, cfg_dict, ckpt, ds, dev, name)
    phase(name, f"shapes rgb {img['rgb_fine'].shape} disp {img['disp'].shape} normals "
                f"{img['normals'].shape} uint8; mean |frame - background| {f['off_bg']:.2f} "
                f"levels, frame std {f['spread']:.2f} levels; bf16 kernel frame "
                f"vs f32 plain frame: mean |diff| {f['mean_diff']:.4f} levels, p99 {f['p99']:.0f}, "
                f"max {f['max_diff']} (limits {FRAME_MEAN}, {FRAME_MAX})")
    return server, dict(f, launches=launches, frame_ms=frame_ms, tiles=tiles)


def noisy_frame_phase(dev, tmp, profile=False):
    """One 512² synth512_paper frame at validation σ-noise 0.1, which K2
    refuses: both passes of every tile are K3f + torch compositing with the
    noise, as the JAX package renders it. The f32 plain frame draws the
    same noise (keyed by seed and ray index)."""
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
    from nerface_tpu_torch.ops.kernels.fused_mlp import (
        fused_paper_mlp_backward,
        fused_paper_mlp_forward,
        fused_paper_render,
    )
    from nerface_tpu_torch.serve import AvatarServer

    d = copy.deepcopy(SYNTH512_PAPER)
    d["nerf"]["validation"]["radiance_field_noise_std"] = 0.1
    cfg = CfgNode(d)
    ds = synthetic_flame_dataset(H=512, W=512, n_train=8, n_val=2, n_test=2, seed=SEED)
    ckpt = _save_avatar(cfg, ds, os.path.join(tmp, "noisy.ckpt"), SEED + 2)
    server = AvatarServer(cfg, ckpt, dataset=ds, dtype=torch.bfloat16, device=dev, log=False)
    tiles = -(-server.H * server.W // min(server.settings.chunksize, server.H * server.W))
    server.render(frame=0, seed=0, maps=("rgb_fine",))  # warm
    fused_paper_render.launches = fused_paper_mlp_forward.launches = 0
    fused_paper_mlp_backward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = server.render(frame=1, seed=1, maps=("rgb_fine",))
    frame_ms = (time.perf_counter() - t0) * 1e3
    k3f = fused_paper_mlp_forward.launches
    check(k3f == 2 * tiles and fused_paper_render.launches == 0
          and fused_paper_mlp_backward.launches == 0,
          f"noisy frame: K3f {k3f} (want 2 x {tiles} tiles), K2 {fused_paper_render.launches}, "
          f"K3b {fused_paper_mlp_backward.launches} (want 0)")
    prof = profile_phase(server, "profile_noisy") if profile else None
    f = _frame_against_plain(img, d, ckpt, ds, dev, "noisy_frame")
    phase("noisy_frame", f"one 512x512 frame at σ-noise 0.1 in {frame_ms:.1f} ms: K3f launches {k3f} "
                         f"= 2 x {tiles} tiles, K2 0; bf16 K3f frame vs f32 plain frame: mean |diff| "
                         f"{f['mean_diff']:.4f} levels, p99 {f['p99']:.0f}, max {f['max_diff']} "
                         f"(limits {FRAME_MEAN}, {FRAME_MAX})")
    return dict(f, launches=k3f, frame_ms=frame_ms, profile=prof)


def profile_phase(server, name="profile"):
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
        phase(name, f"frame_ms {'+'.join(maps)}: {[round(t, 2) for t in ts]}, "
                    f"median {statistics.median(ts):.2f}")
    n = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            server.render(frame=0, seed=i, maps=all_maps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    busy = _print_profile(name, prof, n, wall, "a frame", DeviceType, "+".join(all_maps))
    return {"wall_ms": wall, "busy_ms": busy}


def _bound_ms(flops, nbytes):
    """The least time for the work: the larger of its operations at the
    bf16 dense peak and its bytes (inputs read once, outputs written once)
    at the memory rate; and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _entry_name(text):
    """A kernel's short name, with its template arguments, from a ptxas
    line that holds its mangled name."""
    m = re.search(r"(train_pass_kernel|dw_wgmma_kernel|flex_chain_kernel|flex_dx_kernel|"
                  r"reduce_rows|render_kernel|mlp_fwd_kernel|"
                  r"resample_kernel|chain_kernel|encoder_kernel)"
                  r"(?:ILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?|ILb([01])E)?", text)
    if not m:
        return text
    flag = {"resample_kernel": "sorted_u", "flex_chain_kernel": "save"}.get(m.group(1), "small")
    ints = [m.group(2)] if m.group(2) else []
    if m.group(3):  # K5's draws a lane
        ints.append(f"FP={m.group(3)}")
    targs = ", ".join(ints + ([flag] if m.group(4) == "1" else []))
    if m.group(1) == "chain_kernel" and m.group(2):
        from nerface_tpu_torch.tools.perf.chain_overlap_probe import VARIANTS

        targs = VARIANTS[int(m.group(2))]
    if m.group(5):
        targs = "split" if m.group(5) == "1" else "packed"
    return m.group(1) + (f"<{targs}>" if targs else "")


def build_phase():
    """Every library, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from nerface_tpu_torch.ops.kernels import build

    def one(name):
        t0 = time.perf_counter()
        lib = build.build_library(name)
        return name, lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = list(pool.map(one, LIBRARIES))
    wall = time.perf_counter() - t0
    for name, lib, secs in built:
        log = open(str(lib) + ".log").read().splitlines()
        info = []
        for i, line in enumerate(log):
            if "Compiling entry function" not in line:
                continue
            usage = [x.split("info    :")[-1].strip() if "info" in x else x.strip()
                     for x in log[i + 1:i + 4] if "registers" in x or "spill" in x]
            info.append(f"{_entry_name(line)}: {'; '.join(usage)}")
        # ptxas's C75xx notes: wgmmas it serialises, and why
        serial = set()
        for x in log:
            m = re.search(r"\((C75\d\d)\)[^:]*:\s*(.*?)(?: (?:in|for) the function '([^']+)')?\.?$", x)
            if m:
                serial.add(f"{_entry_name(m.group(3) or '?')}: {m.group(1)} {m.group(2)}")
        serial = sorted(serial)
        phase("build", f"{name}: {secs:.1f} s ({lib.name}); ptxas: {' | '.join(info)}")
        phase("build", f"{name} wgmma serialisation (ptxas C75xx): "
                       f"{' | '.join(serial) if serial else 'none reported'}")
        if name in ("fused_train_pass", "fused_paper_mlp"):
            smem = (ctypes.c_longlong * 3)()
            k = "train" if name == "fused_train_pass" else "paper_mlp"
            getattr(build.load_library(name), f"nerface_fused_{k}_shared_bytes")(smem)
            sizes = ([] if k == "train" else [f"mlp_fwd_kernel {smem[0]} B"]) + [
                f"train_pass_kernel {smem[k != 'train']} B",
                f"dw_wgmma_kernel {smem[1 + (k != 'train')]} B"]
            phase("build", f"{name} shared memory a CTA (dynamic): {', '.join(sizes)}")
        if name == "fused_flex":
            smem = (ctypes.c_longlong * 3)()
            build.load_library(name).nerface_fused_flex_shared_bytes(smem)
            phase("build", f"{name} shared memory a CTA (dynamic): flex_chain_kernel {smem[0]} B, "
                           f"flex_dx_kernel {smem[1]} B, dw_wgmma_kernel {smem[2]} B")
    phase("build", f"{len(LIBRARIES)} libraries in {wall:.1f} s")


def _train_kernel_inputs(n_rays, n_samples, gen, dev):
    import torch

    ro, rd, z, _, cond, bg = _kernel_inputs(n_rays, n_samples, gen, dev)
    rd[:4] = rd[4:8]  # K1's rays all cross the head
    tgt = torch.rand(n_rays, 3, generator=gen).to(dev)
    noise = torch.randn(n_rays, n_samples, generator=gen).to(dev)
    pe_dir = torch.randn(n_rays, 24, generator=gen).to(dev)
    return ro, rd.contiguous(), z, tgt, bg, noise, pe_dir, cond


def _k2_bytes(n_rays, n_samples, with_weights):
    from nerface_tpu_torch.ops.kernels.fused_mlp import F_OFFSETS, W_OFFSETS

    per_ray_in = 4 * (3 + 3 + 3 + 128 + n_samples)  # ro rd bg dir_c z
    per_ray_out = 4 * (3 + 4 + (n_samples if with_weights else 0))  # rgb, 4 maps, weights
    return n_rays * (per_ray_in + per_ray_out) + 2 * W_OFFSETS["TOTAL"] + 4 * F_OFFSETS["TOTAL"]


def _k1_bytes(n_rays, n_samples):
    from nerface_tpu_torch.ops.kernels.fused_mlp import F_OFFSETS, W_OFFSETS
    from nerface_tpu_torch.ops.kernels.fused_mlp import WT_OFFSETS

    per_ray_in = 4 * (3 + 3 + 3 + 3 + 128 + 2 * n_samples)  # ro rd target bg dir_c z noise
    per_ray_out = 4 * (3 + n_samples + 128)  # rgb, weights, d_dir
    weights = 2 * (W_OFFSETS["TOTAL"] + WT_OFFSETS["TOTAL"]) + 4 * F_OFFSETS["TOTAL"]
    grads = 4 * (W_OFFSETS["TOTAL"] + F_OFFSETS["TOTAL"])
    return n_rays * (per_ray_in + per_ray_out) + weights + grads


def _k1_params(seed, dev, small=False):
    """He-scaled random weights of one paper-family model."""
    from nerface_tpu_torch.tools.perf.cases import he_scale

    model = _paper_model(seed, dev, small)
    he_scale(model)
    return {k: v.detach() for k, v in model.named_parameters()}


def _bundle_names(small):
    from nerface_tpu_torch.ops.kernels.fused_mlp import bundle_names

    wn, bn = bundle_names(small)
    return ["cond0", "cond3", "dir"] + list(wn) + list(bn)


def _grad_readings(label, what, R, names, grads, rgrads, worst):
    """Each gradient tensor against the plain version's within
    `k1_grad_limits`; updates `worst` (tensor -> (max, norm) relative
    readings) and returns the largest absolute error."""
    import torch

    abs_err = 0.0
    for name, g, r in zip(names, grads, rgrads):
        g, r = g.float(), r.float()
        check(bool(torch.isfinite(g).all()), f"{label}: {what} grad {name} not finite")
        d = g - r
        e, scale = float(d.abs().max()), float(r.abs().max())
        e_norm, r_norm = float(d.norm()), float(r.norm())
        tol, tol_norm = k1_grad_limits(R, name)
        check(e <= tol * scale + 1e-6,
              f"{label}: {what} grad {name} max err {e} > {tol}·{scale} + 1e-6")
        check(e_norm <= tol_norm * r_norm + 1e-6,
              f"{label}: {what} grad {name} ‖err‖ {e_norm} > {tol_norm}·{r_norm} + 1e-6")
        w = worst.get(name, (0.0, 0.0))
        worst[name] = (max(w[0], e / max(scale, 1e-30)), max(w[1], e_norm / max(r_norm, 1e-30)))
        abs_err = max(abs_err, e)
    return abs_err


def _launch_split(name, what, fn, R, S, small, k3b=False):
    """`fn`, a bare launch of K1 or K3b (operands packed beforehand), timed
    (CUDA events), then its kernels' device ms a call by name under
    torch.profiler, each beside its operations bound and its byte floor
    (tools/perf/k1_launch_split.py). Returns (bare ms, {kernel: row})."""
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS

    bare = _median_ms(fn, iters=10)
    rows = KS.split_rows(fn, KS.launch_bounds(R, S, small, k3b))
    for short, r in rows.items():
        phase(name, f"  {what} S={S} {KS.row_text(short, r)}")
    if not rows:
        phase(name, f"  {what} S={S} split not measured: the profiler saw no device time")
    return bare, rows


def train_kernel_phase(dev, small=False):
    """K1 (its `small` mode with `small`) against its plain version."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_train as T
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS

    name = "small_kernels" if small else "train_kernel"
    what = "K1 small" if small else "K1"
    names = _bundle_names(small)
    models = [_k1_params(SEED + 3 + 100 * i + (50 if small else 0), dev, small)
              for i in range(K1_SEEDS)]
    result = {"err": {}, "grad_rel": {}, "ms": {}, "plain_ms": {}, "bound": {}, "readings": {},
              "bare_ms": {}, "split": {}}
    cases = (("fine", TRAIN_RAYS, 128, "noise"), ("coarse", TRAIN_RAYS, 64, "noise"))
    if not small:
        cases += (("white", 256, 32, "white"), ("train_bg", 256, 32, "train_bg"))
    for c, (label, R, S, kind) in enumerate(cases):
        worst = {}  # tensor -> (max reading, norm reading) over the seeds
        errs = {"rgb": 0.0, "weights": 0.0}
        for i, params in enumerate(models):
            gen = torch.Generator().manual_seed(SEED + 4 + 100 * i + c)
            ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_kernel_inputs(R, S, gen, dev)
            if kind == "white":
                # σ raised as in the served avatar: with a white background
                # the last sample's colour carries what a ray did not absorb,
                # and on transparent rays one flipped bf16 rounding of a
                # He-scaled activation shows there in full (2.24e-3 against
                # the 2e-3 limit on the card; PERF.md)
                params = dict(params, **{"fc_alpha.bias": params["fc_alpha.bias"] + SIGMA_BIAS})
            bundle = [t.contiguous()
                      for t in T.prefold_paper_params(params, cond, pe_dir, 10, small=small)]
            kw = dict(loss_scale=2.0 / (3.0 * R), small=small)
            if kind == "noise":
                kw.update(background=bg, noise=noise, noise_std=0.1)
            elif kind == "white":
                kw.update(white_background=True)
            else:
                kw.update(background=bg, train_bg=True, sup_bg_scale=0.001 / R)
            args = (bundle, ro, rd, z, tgt)
            got, grads, d_bg = T.fused_train_pass(*args, **kw)
            torch.cuda.synchronize()
            _, grads2, d_bg2 = T.fused_train_pass(*args, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(grads, grads2))
            same = same and (d_bg is None or torch.equal(d_bg, d_bg2))
            check(same, f"{label} seed {i}: two launches gave different gradients")
            ref, rgrads, rd_bg = T.fused_train_pass_reference(*args, **kw)
            for k in ("rgb", "weights"):
                check(bool(torch.isfinite(got[k]).all()), f"{label}: kernel {k} not finite")
                e = float((got[k] - ref[k]).abs().max())
                check(e <= 2e-3, f"{label} seed {i}: {k} max abs err {e} > 2e-3")
                errs[k] = max(errs[k], e)
            pairs = list(zip(names, grads, rgrads))
            if d_bg is not None:
                pairs.append(("bg", d_bg, rd_bg))
            _grad_readings(f"{label} seed {i}", what, R, *zip(*pairs), worst)
            if i == 0 and R == TRAIN_RAYS:
                result["ms"][label] = _median_ms(lambda: T.fused_train_pass(*args, **kw),
                                                 iters=10)
                result["plain_ms"][label] = _median_ms(
                    lambda: T.fused_train_pass_reference(*args, **kw), warmup=1, iters=3)
                result["bound"][label] = _bound_ms(R * S * paper_flop_per_sample(small, True),
                                                   _k1_bytes(R, S))
                rays = dict(ro=ro, rd=rd, z=z, tgt=tgt, bg=bg, noise=noise)
                result["bare_ms"][label], result["split"][label] = _launch_split(
                    name, what, KS.k1_bare(bundle, rays, small), R, S, small)
        result["err"][label] = errs
        result["readings"][label] = worst
        w_max = max(worst, key=lambda n: worst[n][0])
        w_norm = max(worst, key=lambda n: worst[n][1])
        result["grad_rel"][label] = (w_max, worst[w_max][0], w_norm, worst[w_norm][1])
        line = (f"{what} R={R} S={S} {kind}, {K1_SEEDS} seeds: rgb err {errs['rgb']:.3g}, weights "
                f"err {errs['weights']:.3g}; worst grad max err {w_max} {worst[w_max][0]:.4f}·max, "
                f"worst ‖err‖ {w_norm} {worst[w_norm][1]:.4f}·‖r‖; bit-identical over 2 launches")
        if R == TRAIN_RAYS:
            fps = paper_flop_per_sample(small, True)
            line += (f"; kernel {result['ms'][label]:.3f} ms, bare launch "
                     f"{result['bare_ms'][label]:.3f} ms "
                     f"({R * S * fps / result['ms'][label] / 1e9:.1f} TFLOP/s at "
                     f"{fps / 1e6:.4f} MFLOP a sample, bound {result['bound'][label][0]:.3f}), plain "
                     f"{result['plain_ms'][label]:.3f} ms")
        phase(name, line)
    # every tensor's worst readings per case, the calibration of the limits
    for t in names + ["bg"]:
        cells = [f"{label} {result['readings'][label][t][0]:.2e}/"
                 f"{result['readings'][label][t][1]:.2e}"
                 for label, *_ in cases if t in result["readings"][label]]
        if not cells:
            continue
        limits = {R: "/".join(map(str, k1_grad_limits(R, t))) for _, R, *_ in cases}
        phase(name, f"  {what} grad {t:6s} max/norm rel err: {', '.join(cells)} (limits "
                    + ", ".join(f"{v} at R={R}" for R, v in limits.items()) + ")")
    return result


def _k3_bytes(n_rays, n_samples, backward):
    """The bytes K3f / K3b must move: each input read once (rays, depths,
    dir_c, the packed weights; g and the transposed weights for K3b), each
    output written once ((R, S, 4); the gradients and d_dir for K3b)."""
    from nerface_tpu_torch.ops.kernels.fused_mlp import F_OFFSETS, W_OFFSETS, WT_OFFSETS

    rays = n_rays * 4 * (3 + 3 + n_samples + 128)
    samples = n_rays * n_samples * 4 * 4  # (R, S, 4) f32: the output, or g
    weights = 2 * W_OFFSETS["TOTAL"] + 4 * F_OFFSETS["TOTAL"]
    if not backward:
        return rays + samples + weights
    grads = 4 * (W_OFFSETS["TOTAL"] + F_OFFSETS["TOTAL"]) + n_rays * 4 * 128
    return rays + samples + weights + 2 * WT_OFFSETS["TOTAL"] + grads


def paper_mlp_kernel_phase(dev):
    """K3f `fused_paper_mlp_forward` and K3b `fused_paper_mlp_backward`
    (csrc/fused_paper_mlp.cu) against their plain versions, both modes, on
    He-scaled weights, K3_SEEDS draws a case: R = 2048 at S = 64 and 128
    (forward and backward) and one 65536-ray tile at each (forward, the
    paper model: the σ-noise frame's tiles)."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.ops.kernels.fused_train import prefold_paper_params
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS

    from nerface_tpu_torch.tools.perf.k3f_k5_launch_split import k3f_bare

    result = {"err": {}, "readings": {}, "ms": {}, "plain_ms": {}, "bound": {}, "tile_ms": {},
              "bare_ms": {}, "tile_bare_ms": {}, "tile_bound": {},
              "bwd_ms": {}, "bwd_plain_ms": {}, "bwd_bound": {}, "grad_rel": {},
              "bwd_bare_ms": {}, "bwd_split": {},
              "abs_err": 0.0, "grad_abs_err": 0.0}
    cases = [(f"{m}_{S}", small, R, S)
             for small, m in ((False, "paper"), (True, "small"))
             for R, S in ((TRAIN_RAYS, 64), (TRAIN_RAYS, 128))]
    cases += [("paper_tile64", False, TILE_RAYS, 64), ("paper_tile128", False, TILE_RAYS, 128)]
    for c, (label, small, R, S) in enumerate(cases):
        what = "K3 small" if small else "K3"
        names = _bundle_names(small)
        worst, out_err, out_lim, calib = {}, {"rgb": 0.0, "sigma": 0.0}, {"rgb": 0.0, "sigma": 0.0}, {}
        for i in range(K3_SEEDS):
            params = _k1_params(SEED + 11 + 100 * i + (50 if small else 0), dev, small)
            gen = torch.Generator().manual_seed(SEED + 12 + 100 * i + c)
            ro, rd, z, _, _, _, pe_dir, cond = _train_kernel_inputs(R, S, gen, dev)
            bundle = [t.contiguous() for t in prefold_paper_params(
                params, cond, pe_dir, 10, small=small, dir_expr_offset=(256 + 24) if small else 0)]
            kw = dict(small=small)
            args = (bundle, ro, rd, z)
            got = K.fused_paper_mlp_forward(*args, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{label}: K3f output not finite")
            check(torch.equal(got, K.fused_paper_mlp_forward(*args, **kw)),
                  f"{label} seed {i}: two K3f launches differ")
            # the plain version's activations at 65536 rays take tens of GB:
            # chunks of 8192 rays (dir_contrib is per ray)
            ref = torch.cat([
                K.fused_paper_mlp_reference(
                    bundle[:2] + [bundle[2][j:j + 8192]] + bundle[3:], ro[j:j + 8192],
                    rd[j:j + 8192], z[j:j + 8192], **kw)
                for j in range(0, R, 8192)
            ])
            for part, sl in (("rgb", slice(0, 3)), ("sigma", slice(3, 4))):
                e = float((got[..., sl] - ref[..., sl]).abs().max())
                scale = float(ref[..., sl].abs().max())
                check(e <= K3_OUT_TOL * scale,
                      f"{label} seed {i}: K3f {part} max err {e} > {K3_OUT_TOL}·{scale}")
                out_err[part] = max(out_err[part], e / scale)
                result["abs_err"] = max(result["abs_err"], e)
            del ref
            fps = paper_flop_per_sample(small, False)
            if i == 0:
                tile = R == TILE_RAYS
                it = 10 if tile else 15
                result["tile_ms" if tile else "ms"][label] = _median_ms(
                    lambda: K.fused_paper_mlp_forward(*args, **kw), iters=it)
                result["tile_bare_ms" if tile else "bare_ms"][label] = _median_ms(
                    k3f_bare(bundle, dict(ro=ro, rd=rd, z=z), small), iters=it)
                result["tile_bound" if tile else "bound"][label] = _bound_ms(R * S * fps,
                                                                              _k3_bytes(R, S, False))
                if not tile:
                    result["plain_ms"][label] = _median_ms(
                        lambda: K.fused_paper_mlp_reference(*args, **kw), warmup=1, iters=5)
            if R != TRAIN_RAYS:
                continue
            g = torch.randn(R, S, 4, generator=gen).to(dev)
            grads = K.fused_paper_mlp_backward(*args, g, **kw)
            torch.cuda.synchronize()
            grads2 = K.fused_paper_mlp_backward(*args, g, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(grads, grads2)),
                  f"{label} seed {i}: two K3b launches gave different gradients")
            rgrads = K.fused_paper_mlp_backward_reference(*args, g, **kw)
            result["grad_abs_err"] = max(
                result["grad_abs_err"],
                _grad_readings(f"{label} seed {i}", what, R, names, grads, rgrads, worst))
            if i == 0:
                result["bwd_ms"][label] = _median_ms(
                    lambda: K.fused_paper_mlp_backward(*args, g, **kw), iters=10)
                result["bwd_plain_ms"][label] = _median_ms(
                    lambda: K.fused_paper_mlp_backward_reference(*args, g, **kw), warmup=1, iters=3)
                result["bwd_bound"][label] = _bound_ms(R * S * paper_flop_per_sample(small, True),
                                                       _k3_bytes(R, S, True))
                result["bwd_bare_ms"][label], result["bwd_split"][label] = _launch_split(
                    "paper_mlp_kernel", "K3b small" if small else "K3b",
                    KS.k3b_bare(bundle, dict(ro=ro, rd=rd, z=z, g=g), small),
                    R, S, small, k3b=True)
        result["err"][label] = out_err
        line = (f"{what} R={R} S={S}, {K3_SEEDS} seeds: K3f max err rgb {out_err['rgb']:.2e}·max, "
                f"σ {out_err['sigma']:.2e}·max (limit {K3_OUT_TOL}), bit-identical over 2 launches")
        fps, bps = paper_flop_per_sample(small, False), paper_flop_per_sample(small, True)
        if R == TILE_RAYS:
            ms, bare = result["tile_ms"][label], result["tile_bare_ms"][label]
            line += (f"; K3f {ms:.3f} ms, bare launch {bare:.3f} ms ({R * S * fps / bare / 1e9:.1f} "
                     f"TFLOP/s), bound {result['tile_bound'][label][0]:.3f} ms")
        else:
            result["readings"][label] = worst
            w_max = max(worst, key=lambda k: worst[k][0])
            w_norm = max(worst, key=lambda k: worst[k][1])
            result["grad_rel"][label] = (w_max, worst[w_max][0], w_norm, worst[w_norm][1])
            fw, bw = result["ms"][label], result["bwd_ms"][label]
            line += (f"; K3b worst grad max err {w_max} {worst[w_max][0]:.4f}·max, worst ‖err‖ "
                     f"{w_norm} {worst[w_norm][1]:.4f}·‖r‖; bit-identical over 2 launches; "
                     f"K3f {fw:.3f} ms, bare launch {result['bare_ms'][label]:.3f} ms "
                     f"({R * S * fps / result['bare_ms'][label] / 1e9:.1f} TFLOP/s at {fps / 1e6:.4f} "
                     f"MFLOP a sample, bound {result['bound'][label][0]:.3f}), plain "
                     f"{result['plain_ms'][label]:.3f} ms; K3b {bw:.3f} ms, bare launch "
                     f"{result['bwd_bare_ms'][label]:.3f} ms "
                     f"({R * S * bps / bw / 1e9:.1f} TFLOP/s at {bps / 1e6:.4f} MFLOP a sample, "
                     f"bound {result['bwd_bound'][label][0]:.3f}), plain "
                     f"{result['bwd_plain_ms'][label]:.3f} ms")
        phase("paper_mlp_kernel", line)
    for t in _bundle_names(False):
        cells = [f"{label} {result['readings'][label][t][0]:.2e}/{result['readings'][label][t][1]:.2e}"
                 for label in result["readings"] if t in result["readings"][label]]
        phase("paper_mlp_kernel", f"  K3b grad {t:5s} max/norm rel err: {', '.join(cells)} (limits "
                                  f"{'/'.join(map(str, k1_grad_limits(TRAIN_RAYS, t)))})")
    result["k2_cross"] = k3f_k2_crosscheck(dev)
    return result


def k3f_k2_crosscheck(dev):
    """K3f's raw rows at one 65536-ray tile, S = 64, composited by the
    port's plain compositing (ops/compositing.py), against K2's rgb and acc
    on the same inputs: K3f takes K2's folded rows, dir_c and weights as
    its bundle. Within K3F_K2_TOL; returns the max errors."""
    import torch

    from nerface_tpu_torch.ops import compositing as C
    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.tools.perf.cases import paper_params, render_inputs

    R, S = TILE_RAYS, 64
    params = paper_params(SEED + 13, dev)
    ro, rd, z, dc, cond, bg = render_inputs(R, S, torch.Generator().manual_seed(SEED + 14), dev)
    packed = K.pack_paper_weights(params)
    k2 = K.fused_paper_render(packed, ro, rd, z, dc, cond, background=bg)
    fbuf = K._fold_conditioning(packed, cond)
    W = K._layout_matrices(params, 63, cond.shape[-1])
    rows = [fbuf[K.F_OFFSETS[n]:K.F_OFFSETS[n] + 256][None] for n in ("COND0", "COND3")]
    wn, bn = K.bundle_names(False)
    bundle = rows + [dc] + [W[n].contiguous() for n in wn] + [W[n][None].contiguous() for n in bn]
    raw = K.fused_paper_mlp_forward(bundle, ro, rd, z)
    rgb, _, acc, _, _ = C.volume_render_radiance_field(C.inject_background(raw, bg), z, rd,
                                                       background_prior=bg)
    torch.cuda.synchronize()
    err = {"rgb": float((rgb - k2["rgb"]).abs().max()), "acc": float((acc - k2["acc"]).abs().max())}
    for k, e in err.items():
        check(e <= K3F_K2_TOL, f"K3f vs K2 at {R}x{S}: {k} max err {e} > {K3F_K2_TOL}")
    phase("paper_mlp_kernel", f"K3f vs K2 at {R} rays x {S} (one chain, csrc/paper_chain.cuh): K3f's raw "
                              f"rows through ops/compositing.py against K2's maps: rgb max err "
                              f"{err['rgb']:.3g}, acc {err['acc']:.3g} (limit {K3F_K2_TOL})")
    return err


def _train_cfg(steps, logdir, cfg_dict=SYNTH512_PAPER):
    d = copy.deepcopy(cfg_dict)
    d["experiment"].update(logdir=logdir, train_iters=steps, print_every=10,
                           validate_every=1000, save_every=1000)
    return d


def _train_dataset():
    from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset

    return synthetic_flame_dataset(H=512, W=512, n_train=4, n_val=2, n_test=1, seed=SEED,
                                   with_images=True)


def _launch_counts():
    """The wrappers' launch counters of the paper family's kernels."""
    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.ops.kernels.fused_train import fused_train_pass

    return {"K1": fused_train_pass, "K2": K.fused_paper_render, "K3f": K.fused_paper_mlp_forward,
            "K3b": K.fused_paper_mlp_backward}


def train_step_phase(dev, ds, cfg_dict=SYNTH512_PAPER, name="train_step"):
    """One step's losses and gradients both ways from the same weights,
    batch and draws (the update itself is Adam's, the same code both ways):
    bf16 on the card (through K1 where the step is eligible, else through
    K3) against the f32 plain path. Every parameter the f32 step gives a
    gradient gets one in bf16, within 0.25·max."""
    import torch

    from nerface_tpu_torch.config import CfgNode, FeatureFlags
    from nerface_tpu_torch.data.pipeline import RayFeed, batch_to_device
    from nerface_tpu_torch.render.pipeline import RenderSettings
    from nerface_tpu_torch.train.fused import fused_losses, fused_train_eligible
    from nerface_tpu_torch.train.loop import build_models_from_cfg, setup_background
    from nerface_tpu_torch.train.state import create_train_state
    from nerface_tpu_torch.train.step import compute_losses

    cfg = CfgNode(cfg_dict)
    flags = FeatureFlags.from_cfg(cfg)
    settings = RenderSettings.from_cfg(cfg, mode="train")
    bg = setup_background(ds, flags)
    batch = batch_to_device(RayFeed(ds, TRAIN_RAYS, background=bg, seed=SEED).sample_batch(), dev)
    mc, mf = build_models_from_cfg(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    fused = fused_train_eligible(mc, mf, settings, flags, torch.bfloat16, dev)
    n_pass = 2 if mf is not None else 1
    want = {"K1": n_pass, "K3f": 0, "K3b": 0} if fused else {"K1": 0, "K3f": n_pass, "K3b": n_pass}
    latent = torch.randn(len(ds.i_train), 32, generator=torch.Generator().manual_seed(1)) * 0.1
    counters = _launch_counts()
    out = {}
    for label in ("bf16", "f32"):
        state = create_train_state(copy.deepcopy(mc), copy.deepcopy(mf), flags,
                                   n_train=len(ds.i_train), background=bg, device=dev)
        with torch.no_grad():
            state.latent_codes.copy_(latent)
        before = {k: c.launches for k, c in counters.items()}
        if label == "bf16" and fused:
            total, _ = fused_losses(state, batch, 7, settings, flags)
        else:
            total, _ = compute_losses(state, batch, 7, settings, flags,
                                      dtype=torch.bfloat16 if label == "bf16" else None)
        total.backward()
        torch.cuda.synchronize()
        launched = {k: c.launches - before[k] for k, c in counters.items()}
        expect = dict(want, K2=0) if label == "bf16" else dict.fromkeys(counters, 0)
        check(all(launched[k] == v for k, v in expect.items()),
              f"{name}: the {label} step launched {launched}, expected {expect}")
        grads = {}
        for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
            if m is not None:
                grads.update({f"{which}.{n}": p.grad for n, p in m.named_parameters()})
        grads["latent_codes"] = state.latent_codes.grad
        out[label] = (float(total.detach()), grads)
    loss_b, gb = out["bf16"]
    loss_f, gf = out["f32"]
    check(abs(loss_b - loss_f) <= 0.03 * abs(loss_f), f"{name}: loss bf16 {loss_b} vs f32 {loss_f}")
    worst, worst_rel, n_grads = "", 0.0, 0
    for t, g32 in gf.items():
        if g32 is None:  # layers_dir.3: never reaches the loss
            check(gb[t] is None, f"{name}: {t}: bf16 grad where f32 has none")
            continue
        check(gb[t] is not None, f"{name}: {t} has an f32 gradient and no bf16 one")
        scale = float(g32.abs().max())
        e = float((gb[t] - g32).abs().max())
        check(bool(torch.isfinite(gb[t]).all()), f"{name}: bf16 step grad {t} not finite")
        check(e <= 0.25 * scale + 2e-6, f"{name}: step grad {t}: err {e} > 0.25·{scale}")
        n_grads += 1
        if scale > 0 and e / scale > worst_rel:
            worst, worst_rel = t, e / scale
    via = "K1" if fused else "K3"
    phase(name, f"{TRAIN_RAYS} rays, {settings.num_coarse}+{settings.num_fine} samples, σ-noise "
                f"{settings.radiance_field_noise_std}: loss bf16/{via} {loss_b:.6f} vs f32 plain "
                f"{loss_f:.6f} (rel {abs(loss_b - loss_f) / loss_f:.4f}); {n_grads} parameters with "
                f"a gradient, each in bf16 too; worst grad {worst} {worst_rel:.4f}·max (limit 0.25); "
                f"launches {want}")
    return {"loss_bf16": loss_b, "loss_f32": loss_f, "worst_grad_rel": worst_rel,
            "n_grads": n_grads}


def train_phase(dev, ds, tmp, profile, card, cfg_dict=SYNTH512_PAPER, steps=TRAIN_STEPS,
                name="train"):
    """The main path: `train()` of `cfg_dict` in bf16 on the card for
    `steps` steps with one validation at step 0 and saves at step 0 and the
    end. The paper family's launches: K1 2 a step (K3f and K3b 1 a pass a
    step where K1 refuses the step), K2 2 a tile of the 2 validation frames
    (1 without a fine pass)."""
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.render.pipeline import RenderSettings
    from nerface_tpu_torch.train.checkpoint import load_torch_checkpoint
    from nerface_tpu_torch.train.loop import train

    cfg = CfgNode(_train_cfg(steps, os.path.join(tmp, name), cfg_dict))
    n_pass = 2 if "fine" in cfg.models else 1
    tiles = -(-ds.H * ds.W // int(cfg.nerf.validation.chunksize))
    k1 = RenderSettings.from_cfg(cfg, "train").num_fine > 0
    want = {"K1": n_pass * steps if k1 else 0, "K2": n_pass * tiles * 2,
            "K3f": 0 if k1 else n_pass * steps, "K3b": 0 if k1 else n_pass * steps}
    counters = _launch_counts()
    for c in counters.values():
        c.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = train(cfg, dataset=ds, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: c.launches for k, c in counters.items()}
    print(out.getvalue(), end="", flush=True)
    check(launched == want, f"{name}: launches {launched}, expected {want}")
    # the losses the loop printed: every 10th step and the last
    printed = {int(i): float(v) for i, v in
               re.findall(r"\[TRAIN\] Iter: (\d+) Loss: (\S+)", out.getvalue())}
    steps_printed = sorted(set(range(0, steps, 10)) | {steps - 1})
    check(sorted(printed) == steps_printed, f"{name}: printed steps {sorted(printed)}")
    check(all(math.isfinite(v) for v in printed.values()), f"{name}: non-finite loss: {printed}")
    first = statistics.mean(printed[i] for i in steps_printed if i < 20)
    last = statistics.mean(printed[i] for i in steps_printed if i >= steps - 10)
    check(last < first, f"{name}: loss did not fall: steps < 20 {first}, last 10 steps {last}")
    path = os.path.join(tmp, name, str(cfg.experiment.id), f"checkpoint{steps:05d}.ckpt")
    saved = load_torch_checkpoint(path)
    groups = saved["optimizer"]["param_groups"]
    check(saved["iter"] == steps and len(groups) == 2,
          f"{name}: checkpoint iter {saved['iter']}, {len(groups)} param groups")
    check(set(saved["coarse"]) == set(state.model_coarse.state_dict())
          and (saved["fine"] is None) == (state.model_fine is None), f"{name}: checkpoint keys")
    phase(name, f"{steps} steps of {cfg.models.coarse.type}"
                f"{'' if n_pass == 2 else ' (coarse only)'} at {ds.H}x{ds.W} (bf16, {dev.type}) in "
                f"{wall:.1f} s with one validation and 2 saves; launches {launched} = {want}; "
                f"printed loss, mean of steps 0 and 10 {first:.5f} -> of the last 10 steps "
                f"{last:.5f}; {os.path.basename(path)} reloads, 2 param groups")

    # steady steps, synchronised, from the trained state
    launches_before = {k: c.launches for k, c in counters.items()}
    times, step, feed = _steady_steps(state, cfg, ds, dev)
    step_ms = statistics.median(times)
    phase(name, f"steady step {step_ms:.2f} ms (median of 15, synchronised; min "
                f"{min(times):.2f}, max {max(times):.2f}), {TRAIN_RAYS / step_ms * 1e3:,.0f} "
                f"rays/s on {card}")
    result = {"launches": launched, "step_ms": step_ms, "rays_s": TRAIN_RAYS / step_ms * 1e3,
              "loss_printed": printed, "checkpoint": path}
    if profile:
        _profile_steps(f"profile_{name}", step, f"{name} step")
    feed.stop()
    main = "K1" if k1 else "K3f"
    check(counters[main].launches > launches_before[main], f"{name}: steady steps did not launch {main}")
    return result


WINDOW_STEPS = 40
WINDOW_K = 10
WINDOW_TIMED = 12  # timed blocks of WINDOW_K steps each way: 120 steps
_TRAIN_LINE = r"\[TRAIN\] Iter: (\d+) Loss: (\S+) BG Loss: (\S+) PSNR: (\S+) LatentReg: (\S+)"
_VAL_LINE = r"\[VAL\] Iter: (\d+) loss: (\S+) PSNR: (\S+)"


def _window_cfg(logdir, k, device_feed):
    """configs/synth512_devfeed.yml's settings (synth512_paper, the device
    feed) cut to WINDOW_STEPS steps: print every 10, validate at 0 and 20,
    save every 20 and at the end, `steps_per_execute` k."""
    d = copy.deepcopy(SYNTH512_PAPER)
    d["experiment"].update(id="synth512_devfeed", logdir=logdir, train_iters=WINDOW_STEPS,
                           print_every=10, validate_every=20, save_every=20,
                           steps_per_execute=k, device_feed=device_feed)
    return d


# the hand kernels' __global__ functions (nerface_tpu_torch/csrc/): a K1 or
# K3b call runs one train_pass_kernel, a K2 call one render_kernel, a K3f
# call one mlp_fwd_kernel, a K4f call one flex_chain_kernel, a K4b call one
# flex_chain_kernel (its recompute) and one flex_dx_kernel, a K5 call one
# resample_kernel
HAND_KERNELS = ("train_pass_kernel", "dw_wgmma_kernel", "reduce_rows", "render_kernel",
                "mlp_fwd_kernel", "flex_chain_kernel", "flex_dx_kernel", "resample_kernel")


def kernel_runs(prof):
    """The hand kernels' runs that torch.profiler `prof` read from the
    card's kernel records, by __global__ name: a CUDA graph's replays run
    its kernels with no call from the host, and are counted here."""
    from torch.autograd import DeviceType

    runs = dict.fromkeys(HAND_KERNELS, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            for name in HAND_KERNELS:
                if re.search(rf"\b{name}\b", e.key):
                    runs[name] += e.count
    return runs


def _window_run(cfg, ds, dev):
    """`train()` of `cfg` in bf16 under torch.profiler, with the launch
    counters reset: the wrappers' counts (their C entries' calls from the
    host), the graph replays, and the hand kernels' runs on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from nerface_tpu_torch.train.loop import train

    counters = _launch_counts()
    for c in counters.values():
        c.launches = 0
    calls = {"replays": 0}
    replay = torch.cuda.CUDAGraph.replay

    def counted_replay(g):
        calls["replays"] += 1
        return replay(g)

    torch.cuda.CUDAGraph.replay = counted_replay
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with contextlib.redirect_stdout(out):
                state = train(cfg, dataset=ds, dtype=torch.bfloat16, device=dev)
            torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph.replay = replay
    wall = time.perf_counter() - t0
    return {"state": state, "out": out.getvalue(), "wall": wall,
            "launches": {k: c.launches for k, c in counters.items()},
            "runs": kernel_runs(prof), **calls}


def _window_steady(cfg, ds, dev, k_max, device_feed, profile=False, native=True):
    """Per-step ms of WINDOW_TIMED blocks of WINDOW_K steps (synchronised
    at block ends, validation off) from a fresh state through a
    `TrainWindow` of `k_max` steps, as `train()` runs it: windowed (k_max
    WINDOW_K, a block is one window of graph replays) or step at a time
    (k_max 1, a block is WINDOW_K windows of one eager step, the host feed
    uploading one batch a step). The host feed draws with the native
    sampler, or with numpy where `native` is False."""
    import torch

    from nerface_tpu_torch.config import FeatureFlags
    from nerface_tpu_torch.data.device_feed import DeviceRayFeed
    from nerface_tpu_torch.data.pipeline import RayFeed
    from nerface_tpu_torch.render.pipeline import RenderSettings
    from nerface_tpu_torch.train.loop import build_models_from_cfg, setup_background
    from nerface_tpu_torch.train.schedule import from_cfg
    from nerface_tpu_torch.train.state import build_optimizer, create_train_state
    from nerface_tpu_torch.train.window import TrainWindow

    flags = FeatureFlags.from_cfg(cfg)
    bg = setup_background(ds, flags)
    mc, mf = build_models_from_cfg(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(mc, mf, flags, n_train=len(ds.i_train), background=bg, device=dev)
    opt = build_optimizer(cfg, state)
    dfeed = feed = None
    if device_feed:
        dfeed = DeviceRayFeed(ds, TRAIN_RAYS, background=bg if flags.fixed_background else None,
                              device=dev)
    else:
        feed = RayFeed(ds, TRAIN_RAYS, background=bg if flags.fixed_background else None,
                       seed=SEED, native=native).start()
    window = TrainWindow(state, opt, RenderSettings.from_cfg(cfg, "train"), flags,
                         from_cfg(cfg), SEED, k_max, dtype=torch.bfloat16, device_feed=dfeed)

    def run():
        for _ in range(WINDOW_K // k_max):
            window.run(k_max, None if feed is None else [next(feed) for _ in range(k_max)])

    try:
        for _ in range(2):
            run()
        times = []
        for _ in range(WINDOW_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / WINDOW_K)
        idle = None
        if profile:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile as torch_profile

            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e3
            idle = None if busy <= 0 else 1.0 - busy / wall
    finally:
        if feed is not None:
            feed.stop()
    return times, idle


def window_train_phase(dev, ds, tmp, profile, card):
    """The execution window on the main path: `train()` of synth512_paper
    with configs/synth512_devfeed.yml's settings, WINDOW_STEPS steps at
    `steps_per_execute` WINDOW_K (CUDA-graph replays) against the same run
    one step at a time, for the device feed and the host feed: final
    parameters, Adam state and printed losses bit for bit, the async
    validation lines equal the sync ones, K1 ran 2 times a step and K2 2
    times a tile of each validation frame in each (torch.profiler's kernel
    records, graph replays included), the loss falls, and the window's
    steps are graph replays (K1's wrapper called from the host only for
    the eager steps and the capture). Then the steady per-step ms both
    ways (median of WINDOW_TIMED blocks of WINDOW_K steps, validation
    off)."""
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.train.checkpoint import load_torch_checkpoint

    result = {"launches": {}, "runs": {}, "step_ms": {}, "idle": {}}
    for feed_name, device_feed in (("device_feed", True), ("host_feed", False)):
        runs = {}
        for k in (1, WINDOW_K):
            cfg = CfgNode(_window_cfg(os.path.join(tmp, f"window_{feed_name}_{k}"), k, device_feed))
            runs[k] = r = _window_run(cfg, ds, dev)
            tag = f"{feed_name}, K={k}"
            # K1 2 passes a step; K2 2 passes a tile of 2 frames at 2 validations
            tiles = -(-ds.H * ds.W // int(cfg.nerf.validation.chunksize))
            want = {"K1": 2 * WINDOW_STEPS, "K2": 2 * tiles * 2 * 2}
            ran = {"K1": r["runs"]["train_pass_kernel"], "K2": r["runs"]["render_kernel"]}
            check(ran == want and r["runs"]["mlp_fwd_kernel"] == 0,
                  f"window_train ({tag}): kernel runs on the card {r['runs']}, expected {want}")
            printed = re.findall(_TRAIN_LINE, r["out"])
            steps_printed = sorted(set(range(0, WINDOW_STEPS, 10)) | {WINDOW_STEPS - 1})
            check([int(p[0]) for p in printed] == steps_printed,
                  f"window_train ({tag}): printed steps {[p[0] for p in printed]}")
            loss = {int(p[0]): float(p[1]) for p in printed}
            check(all(math.isfinite(v) for v in loss.values()), f"window_train ({tag}): {loss}")
            check(statistics.mean(loss[i] for i in (10, 20, 30, 39)) < loss[0],
                  f"window_train ({tag}): the loss did not fall: {loss}")
            r["printed"], r["loss"] = printed, loss
            r["val"] = re.findall(_VAL_LINE, r["out"])
            check([int(v[0]) for v in r["val"]] == [0, 20],
                  f"window_train ({tag}): validation lines {r['val']}")
            r["ckpt"] = load_torch_checkpoint(os.path.join(
                tmp, f"window_{feed_name}_{k}", "synth512_devfeed",
                f"checkpoint{WINDOW_STEPS:05d}.ckpt"))
        one, win = runs[1], runs[WINDOW_K]
        # the windowed run: 2 eager steps (the first window and the step before
        # the capture), the rest replays; K1's wrapper called from the host
        # for the eager steps' 2 passes and the capture's 2. The validations'
        # K2 calls are eager in both.
        n_replay = WINDOW_STEPS - 2
        want_win = {"K1": 2 * 2 + 2, "K2": want["K2"], "K3f": 0, "K3b": 0}
        check(win["replays"] == n_replay and win["launches"] == want_win,
              f"window_train ({feed_name}): {win['replays']} replays, wrapper counts "
              f"{win['launches']} (expected {n_replay} and {want_win})")
        want_one = {"K1": 2 * WINDOW_STEPS, "K2": want["K2"], "K3f": 0, "K3b": 0}
        check(one["replays"] == 0 and one["launches"] == want_one,
              f"window_train ({feed_name}): step at a time: {one['replays']} replays, wrapper "
              f"counts {one['launches']} (expected {want_one})")
        check(one["printed"] == win["printed"],
              f"window_train ({feed_name}): printed lines differ:\n{one['printed']}\n{win['printed']}")
        check(one["val"] == win["val"],
              f"window_train ({feed_name}): sync validation {one['val']} != async {win['val']}")
        sa, sb = one["state"], win["state"]
        n_params = 0
        for a, b in ((sa.model_coarse, sb.model_coarse), (sa.model_fine, sb.model_fine)):
            for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
                check(torch.equal(pa, pb), f"window_train ({feed_name}): {name} differs")
                n_params += 1
        check(torch.equal(sa.latent_codes, sb.latent_codes),
              f"window_train ({feed_name}): the latent table differs")
        oa, ob = one["ckpt"]["optimizer"]["state"], win["ckpt"]["optimizer"]["state"]
        check(oa.keys() == ob.keys(), f"window_train ({feed_name}): Adam state keys")
        for key in oa:
            for f in ("step", "exp_avg", "exp_avg_sq"):
                check(torch.equal(oa[key][f], ob[key][f]),
                      f"window_train ({feed_name}): Adam {f} of parameter {key} differs")
        result["launches"][feed_name] = {"step_at_a_time": one["launches"],
                                         "windowed": win["launches"]}
        result["runs"][feed_name] = {"step_at_a_time": one["runs"], "windowed": win["runs"]}
        phase("window_train", f"{feed_name}: {WINDOW_STEPS} steps of synth512_paper at "
                              f"{ds.H}x{ds.W} (bf16, under torch.profiler): K={WINDOW_K} in "
                              f"{win['wall']:.1f} s ({win['replays']} graph replays, K1 ran "
                              f"{win['runs']['train_pass_kernel']} times on the card from "
                              f"{win['launches']['K1']} wrapper calls, validation async) = K=1 in "
                              f"{one['wall']:.1f} s (K1 ran {one['runs']['train_pass_kernel']} "
                              f"times from {one['launches']['K1']} calls, validation sync) bit for "
                              f"bit: {n_params} parameters + latent "
                              f"table, Adam state of {len(oa)} tensors, printed losses "
                              f"{[round(v, 5) for v in win['loss'].values()]}, validation lines "
                              f"{[(v[0], v[1]) for v in win['val']]}")

        cfg = CfgNode(_window_cfg(tmp, WINDOW_K, device_feed))
        graph_ms, idle = _window_steady(cfg, ds, dev, WINDOW_K, device_feed, profile)
        eager_ms, _ = _window_steady(cfg, ds, dev, 1, device_feed)
        g, e = statistics.median(graph_ms), statistics.median(eager_ms)
        result["step_ms"][feed_name] = {"windowed": g, "step_at_a_time": e}
        result["idle"][feed_name] = idle
        phase("window_train", f"{feed_name}: steady step windowed {g:.3f} ms vs step at a time "
                              f"{e:.3f} ms (median of {WINDOW_TIMED} blocks of {WINDOW_K} steps "
                              f"each, validation off; windowed min "
                              f"{min(graph_ms):.3f} max {max(graph_ms):.3f}, step at a time min "
                              f"{min(eager_ms):.3f} max {max(eager_ms):.3f}) on {card}"
                              + ("" if not profile else
                                 f"; device idle in a window "
                                 f"{'not measured' if idle is None else f'{idle:.3f}'}"))

    # the host feed's numpy path beside the native one, windowed; the
    # draw alone on each path; the device feed's top-k alone
    t_rows = time.perf_counter()
    cfg = CfgNode(_window_cfg(tmp, WINDOW_K, False))
    numpy_ms, numpy_idle = _window_steady(cfg, ds, dev, WINDOW_K, False, profile, native=False)
    n = statistics.median(numpy_ms)
    result["step_ms"]["host_feed_numpy"] = {"windowed": n}
    result["idle"]["host_feed_numpy"] = numpy_idle
    result["feed_batch_ms"] = {path: _feed_batch_ms(cfg, ds, native)
                               for path, native in (("native", True), ("numpy", False))}
    result["topk_ms"] = _topk_ms(ds, dev)
    result["feed_rows_s"] = time.perf_counter() - t_rows
    idle = {k: result["idle"][k] for k in ("host_feed", "host_feed_numpy")}
    native_ms = result["step_ms"]["host_feed"]["windowed"]
    phase("window_train", f"host feed windowed: native sampler {native_ms:.3f} ms, numpy path "
                          f"{n:.3f} ms a step (medians of {WINDOW_TIMED} blocks "
                          f"of {WINDOW_K}; numpy min {min(numpy_ms):.3f} max {max(numpy_ms):.3f})"
                          + ("" if not profile else
                             "; device idle in a window: " + ", ".join(
                                 f"{k} {'not measured' if v is None else f'{v:.3f}'}"
                                 for k, v in idle.items()))
                          + f"; the feed thread's ms a batch ({TRAIN_RAYS} rays of a "
                            f"{ds.H}x{ds.W} frame, median of {FEED_BATCHES} sample_batch calls): "
                            f"native {result['feed_batch_ms']['native']:.3f}, numpy "
                            f"{result['feed_batch_ms']['numpy']:.3f}; the device feed's "
                            f"torch.topk of {TRAIN_RAYS} over {ds.H * ds.W} keys alone: "
                            f"{result['topk_ms']['single']:.4f} ms a call (median of 15, CUDA "
                            f"events), {result['topk_ms']['queued']:.4f} ms a call queued "
                            f"({TOPK_QUEUED} calls between two events); on {card}; these "
                            f"rows took {result['feed_rows_s']:.1f} s")
    return result


FEED_BATCHES = 50
TOPK_QUEUED = 100


def _feed_batch_ms(cfg, ds, native):
    """Median ms of one `RayFeed.sample_batch` (the feed thread's work for a
    batch: the frame, the draw, the rays' gather and rotation) on this
    host's CPU, native or numpy."""
    from nerface_tpu_torch.config import FeatureFlags
    from nerface_tpu_torch.data.pipeline import RayFeed
    from nerface_tpu_torch.train.loop import setup_background

    flags = FeatureFlags.from_cfg(cfg)
    bg = setup_background(ds, flags)
    feed = RayFeed(ds, TRAIN_RAYS, background=bg if flags.fixed_background else None, seed=SEED,
                   native=native)
    for _ in range(3):
        feed.sample_batch()
    times = []
    for _ in range(FEED_BATCHES):
        t0 = time.perf_counter()
        feed.sample_batch()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _topk_ms(ds, dev):
    """The device feed's draw, `torch.topk` of TRAIN_RAYS over a frame's
    H·W f32 keys (data/device_feed.py), alone: ms of one call between two
    CUDA events (median), and a call's share of TOPK_QUEUED calls queued
    between two events."""
    import torch

    keys = torch.rand(ds.H * ds.W, generator=torch.Generator().manual_seed(SEED)).to(dev)
    single = _median_ms(lambda: torch.topk(keys, TRAIN_RAYS))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(TOPK_QUEUED):
        torch.topk(keys, TRAIN_RAYS)
    b.record()
    b.synchronize()
    return {"single": single, "queued": a.elapsed_time(b) / TOPK_QUEUED}


EVAL_SIZE = 512
EVAL_SPLIT = {"n_train": 16, "n_val": 2, "n_test": 5}
EVAL_STEPS = 300
EVAL_K = 50
EVAL_MODES = {"parity": [], "fast": ["--fast-eval"], "occupancy": ["--occupancy"]}
QUALITY_GAIN_DB = 10.0  # each trained run above its first checkpoint
QUALITY_BF16_MARGIN_DB = 1.0  # bf16's mean test PSNR at least f32's minus this


def _eval_cfg(ds_dir, logdir, run_id, chunksize=None):
    """configs/synth512_devfeed.yml's settings (synth512_paper, the device
    feed) on the dataset at `ds_dir`, cut to EVAL_STEPS steps at
    `steps_per_execute` EVAL_K: print every 50, validate at 0 and 150, save
    at the first step and the last."""
    d = copy.deepcopy(SYNTH512_PAPER)
    d["experiment"].update(id=run_id, logdir=logdir, train_iters=EVAL_STEPS, print_every=50,
                           validate_every=150, save_every=EVAL_STEPS,
                           steps_per_execute=EVAL_K, device_feed=True)
    d["dataset"]["basedir"] = ds_dir
    if chunksize:
        d["nerf"]["validation"]["chunksize"] = chunksize
    return d


def _write_cfg(d, path):
    """The config as JSON, which the YAML loader reads."""
    with open(path, "w") as f:
        json.dump(d, f)
    return path


def _cli(main, argv):
    """A CLI's `main(argv)` with its standard output captured: (result, text)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


def _cli_train(cfg_path, bf16, dev):
    """`cli/train.py` for EVAL_STEPS steps; returns the printed [TRAIN] PSNRs
    by step, the wall seconds and K1's wrapper calls."""
    from nerface_tpu_torch.cli import train as cli_train

    counters = _launch_counts()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    _, text = _cli(cli_train.main, ["--config", cfg_path, "--device", str(dev)]
                   + (["--bf16"] if bf16 else []))
    wall = time.perf_counter() - t0
    psnr = {int(m[0]): float(m[3]) for m in re.findall(_TRAIN_LINE, text)}
    check(sorted(psnr) == list(range(0, EVAL_STEPS, 50)) + [EVAL_STEPS - 1],
          f"eval: training printed steps {sorted(psnr)}")
    check(all(math.isfinite(v) for v in psnr.values()), f"eval: training PSNRs {psnr}")
    check(f"execution window: {EVAL_K} steps" in text, "eval: training did not take the window")
    return {"psnr": psnr, "wall": wall, "launches": {k: c.launches for k, c in counters.items()}}


def _cli_eval(cfg_path, ckpt, savedir, dev, bf16, extra=(), profile=False):
    """`cli/eval.py` on `ckpt` into `savedir`, the paper family's launch
    counts reset just before and read just after (and under torch.profiler
    with `profile`); returns the summary, the launches, the kernel runs and
    the fast-eval set-up that evaluate made."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from nerface_tpu_torch.cli import eval as cli_eval
    from nerface_tpu_torch.eval import occupancy as O

    argv = ["--config", cfg_path, "--checkpoint", ckpt, "--savedir", savedir, "--device", str(dev),
            "--save-disparity-image", "--save-error-image", *extra] + (["--bf16"] if bf16 else [])
    counters = _launch_counts()
    for c in counters.values():
        c.launches = 0
    setups = []
    real_setup = O.fast_eval_setup

    def recorded_setup(*a, **k):
        setups.append(real_setup(*a, **k))
        return setups[-1]

    O.fast_eval_setup = recorded_setup
    runs = None
    try:
        if profile:
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                summary, text = _cli(cli_eval.main, argv)
                torch.cuda.synchronize()
            runs = kernel_runs(prof)
        else:
            summary, text = _cli(cli_eval.main, argv)
    finally:
        O.fast_eval_setup = real_setup
    launched = {k: c.launches for k, c in counters.items()}
    return {"summary": summary, "launches": launched, "runs": runs,
            "setup": setups[0] if setups else None, "text": text}


def _png(path):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(path))


def eval_phase(dev, tmp, card):
    """The eval / reenactment entry point on the main path: a 512² synthetic
    dataset written to disk, `cli/train.py` in bf16 for EVAL_STEPS steps of
    synth512_devfeed's settings, then `cli/eval.py --bf16` over the test
    split parity, `--fast-eval` and `--occupancy`, with the disparity and
    error images: every frame's K2 runs read from torch.profiler (a parity
    frame is 2 passes × 4 tiles), the bf16 parity frames against the same
    checkpoint's f32 plain frames (FRAME_MAX / FRAME_MEAN), each fast
    frame's active pixels against the parity frame as `[fast_serve]` holds
    them, and each mode's times."""
    import numpy as np
    import torch

    from nerface_tpu_torch.data.flame import load_flame_data
    from nerface_tpu_torch.data.synthetic import make_synthetic_flame_dataset
    from nerface_tpu_torch.eval.driver import device_cast_to_image
    from nerface_tpu_torch.eval.renderer import _active_mask
    from nerface_tpu_torch.ops.rays import get_ray_bundle

    t0 = time.perf_counter()
    ds_dir = make_synthetic_flame_dataset(os.path.join(tmp, "eval_ds"), H=EVAL_SIZE, W=EVAL_SIZE,
                                          seed=SEED, **EVAL_SPLIT)
    gen_s = time.perf_counter() - t0
    n_test = EVAL_SPLIT["n_test"]
    logdir = os.path.join(tmp, "eval_runs")
    cfg_path = _write_cfg(_eval_cfg(ds_dir, logdir, "eval_bf16"), os.path.join(tmp, "eval.yml"))
    tr = _cli_train(cfg_path, True, dev)
    run_dir = os.path.join(logdir, "eval_bf16")
    ckpt = os.path.join(run_dir, f"checkpoint{EVAL_STEPS:05d}.ckpt")
    check(os.path.isfile(ckpt) and os.path.isfile(os.path.join(run_dir, "checkpoint00001.ckpt")),
          f"eval: checkpoints {sorted(os.listdir(run_dir))}")
    phase("eval", f"dataset {EVAL_SIZE}x{EVAL_SIZE} written in {gen_s:.1f} s (cut: "
                  f"{EVAL_SPLIT['n_train']} train, {EVAL_SPLIT['n_val']} val, {n_test} test "
                  f"frames); cli/train.py --bf16: {EVAL_STEPS} steps at K={EVAL_K} in "
                  f"{tr['wall']:.1f} s, K1 wrapper calls {tr['launches']['K1']}, printed PSNR "
                  f"{tr['psnr']}")

    tiles = -(-EVAL_SIZE * EVAL_SIZE // int(SYNTH512_PAPER["nerf"]["validation"]["chunksize"]))
    res = {"dataset": ds_dir, "cfg": cfg_path, "ckpt": ckpt, "train": tr, "modes": {},
           "dirs": {}}
    for mode, extra in EVAL_MODES.items():
        d = os.path.join(tmp, f"eval_{mode}")
        r = _cli_eval(cfg_path, ckpt, d, dev, True, extra)
        s, launched = r["summary"], r["launches"]
        check(s["frames"] == n_test, f"eval ({mode}): {s['frames']} frames")
        check(launched["K1"] == launched["K3f"] == launched["K3b"] == 0 and launched["K2"] > 0
              and launched["K2"] % (2 * n_test) == 0,
              f"eval ({mode}): launches {launched}")
        if mode == "parity":
            check(launched["K2"] == 2 * tiles * n_test,
                  f"eval (parity): K2 launches {launched['K2']} != 2 x {tiles} x {n_test}")
        for sub in ("", "normals", "disparity", "error"):
            names = sorted(f for f in os.listdir(os.path.join(d, sub)) if f.endswith(".png"))
            check(names == [f"{i:04d}.png" for i in range(n_test)],
                  f"eval ({mode}): {sub or 'rgb'} files {names}")
        rgb = _png(os.path.join(d, "0000.png"))
        check(rgb.shape == (EVAL_SIZE, EVAL_SIZE, 3) and rgb.dtype == np.uint8,
              f"eval ({mode}): rgb {rgb.shape} {rgb.dtype}")
        check(_png(os.path.join(d, "normals", "0000.png")).shape == (EVAL_SIZE - 1,
                                                                     EVAL_SIZE - 1, 3),
              f"eval ({mode}): normals shape")
        res["modes"][mode] = {"summary": s, "launches": launched["K2"], "setup": r["setup"]}
        res["dirs"][mode] = d
        phase("eval", f"{mode}: cli/eval.py --bf16 {' '.join(extra)} over {n_test} test frames: "
                      f"avg_time_per_image {s['avg_time_per_image'] * 1e3:.2f} ms, setup_s "
                      f"{s['setup_s']:.3f}, frame_loop_s {s['frame_loop_s']:.3f}; K2 launches "
                      f"{launched['K2']} ({launched['K2'] // n_test} a frame), nothing else; on "
                      f"{card}")

    # the parity run again under torch.profiler: the kernel runs on the card
    r = _cli_eval(cfg_path, ckpt, os.path.join(tmp, "eval_profiled"), dev, True, profile=True)
    ran = r["runs"]["render_kernel"]
    check(ran == 2 * tiles * n_test == r["launches"]["K2"] and r["runs"]["mlp_fwd_kernel"] == 0
          and r["runs"]["train_pass_kernel"] == 0,
          f"eval: torch.profiler saw {r['runs']} for {n_test} parity frames "
          f"(K2 wrapper calls {r['launches']['K2']}, want 2 x {tiles} tiles a frame)")
    for i in range(n_test):
        name = f"{i:04d}.png"
        check(np.array_equal(_png(os.path.join(tmp, "eval_profiled", name)),
                             _png(os.path.join(res["dirs"]["parity"], name))),
              f"eval: profiled parity frame {i} differs from the first run's")
    res["runs"] = ran

    # the same checkpoint's f32 plain frames (16384-ray tiles bound the f32
    # activations; each ray's draws are keyed by its index, not the tile)
    cfg32 = _write_cfg(_eval_cfg(ds_dir, logdir, "eval_bf16", chunksize=16384),
                       os.path.join(tmp, "eval_f32.yml"))
    r32 = _cli_eval(cfg32, ckpt, os.path.join(tmp, "eval_f32"), dev, False)
    check(r32["launches"] == {"K1": 0, "K2": 0, "K3f": 0, "K3b": 0},
          f"eval: the f32 plain path launched {r32['launches']}")
    frames = []
    for i in range(n_test):
        name = f"{i:04d}.png"
        a = _png(os.path.join(res["dirs"]["parity"], name)).astype(np.int16)
        b = _png(os.path.join(tmp, "eval_f32", name)).astype(np.int16)
        diff = np.abs(a - b)
        frames.append((float(diff.mean()), int(diff.max())))
        check(int(diff.max()) <= FRAME_MAX and float(diff.mean()) <= FRAME_MEAN,
              f"eval: bf16 frame {i} vs f32: mean {diff.mean()}, max {diff.max()}")
    res["vs_f32"] = frames
    phase("eval", f"bf16 parity frames vs the f32 plain frames of the checkpoint, each frame: "
                  f"(mean |diff|, max) {[(round(m, 4), x) for m, x in frames]} levels (limits "
                  f"{FRAME_MEAN}, {FRAME_MAX}); f32 avg_time_per_image "
                  f"{r32['summary']['avg_time_per_image'] * 1e3:.1f} ms")

    # each fast frame against the parity frame of the same seed
    test_ds = load_flame_data(ds_dir, test=True)
    bg = device_cast_to_image(torch.as_tensor(test_ds.load_background())).numpy()
    for mode in ("fast", "occupancy"):
        bbox, settings, occ = res["modes"][mode]["setup"]
        check((occ is not None) == (mode == "occupancy"), f"eval ({mode}): grid {occ}")
        worst = {"inside_max": 0, "active": []}
        for i in range(n_test):
            pose = torch.as_tensor(test_ds.poses[test_ds.i_test[i]][:3, :4], device=dev)
            ro, rd = get_ray_bundle(EVAL_SIZE, EVAL_SIZE, test_ds.intrinsics, pose)
            active = _active_mask(ro.reshape(-1, 3), rd.reshape(-1, 3), EVAL_SIZE, EVAL_SIZE,
                                  bbox, occ, settings, pose=pose,
                                  intrinsics=test_ds.intrinsics).reshape(EVAL_SIZE, EVAL_SIZE)
            c = _contract(_png(os.path.join(res["dirs"][mode], f"{i:04d}.png")),
                          _png(os.path.join(res["dirs"]["parity"], f"{i:04d}.png")),
                          active.cpu().numpy(), bg, f"eval ({mode}) frame {i}")
            worst["inside_max"] = max(worst["inside_max"], c["inside_max"])
            worst["active"].append(c["active"])
        res["modes"][mode]["contract"] = worst
        phase("eval", f"{mode} frames vs the parity frames: active pixels {worst['active']}, "
                      f"max {worst['inside_max']} level off; every skipped pixel the background "
                      f"or the parity pixel; capacity {settings.fast_eval_capacity:.4f}"
                      + (f", grid {occ.resolution}^3 {occ.occupancy_fraction():.4f} occupied"
                         if occ is not None else ""))
    return res


def _score(ds_dir, images_dir, label):
    """`cli/metrics.py` against the test split's ground truth; checks
    metrics.txt and one L2 map a frame. Returns the means."""
    from nerface_tpu_torch.cli import metrics as cli_metrics

    summary, _ = _cli(cli_metrics.main, ["--gt_path", os.path.join(ds_dir, "test"),
                                         "--images_path", images_dir])
    l2 = sorted(os.listdir(os.path.join(images_dir, "L2")))
    n = len([f for f in os.listdir(images_dir) if f.endswith(".png")])
    check(os.path.isfile(os.path.join(images_dir, "metrics.txt")) and len(l2) == n > 0,
          f"{label}: metrics.txt or L2/ missing ({l2})")
    check(all(math.isfinite(summary[k]) for k in ("L1", "PSNR", "SSIM"))
          and math.isnan(summary["LPIPS"]), f"{label}: {summary}")
    return summary


def metrics_phase(ev):
    """`cli/metrics.py` over each `[eval]` mode's renders."""
    out = {}
    for mode, d in ev["dirs"].items():
        s = out[mode] = _score(ev["dataset"], d, f"metrics ({mode})")
        phase("metrics", f"{mode}: mean L1 {s['L1']:.5f}, PSNR {s['PSNR']:.3f} dB, SSIM "
                         f"{s['SSIM']:.4f}, LPIPS {s['LPIPS']} (no weights); metrics.txt and "
                         f"L2/ written")
    return out


def quality_phase(dev, tmp, ev, me, card):
    """bf16 training's quality against f32's on the same data and seed:
    the same EVAL_STEPS steps in f32 through `cli/train.py`, each run's last
    and first checkpoints rendered by `cli/eval.py --bf16` (parity) and
    scored by `cli/metrics.py`: each run at least QUALITY_GAIN_DB above its
    first checkpoint, bf16's mean test PSNR at least f32's minus
    QUALITY_BF16_MARGIN_DB."""
    logdir = os.path.join(tmp, "eval_runs")
    cfg_path = _write_cfg(_eval_cfg(ev["dataset"], logdir, "eval_f32"),
                          os.path.join(tmp, "quality_f32.yml"))
    tr = _cli_train(cfg_path, False, dev)
    check(tr["launches"]["K1"] == 0, f"quality: the f32 run launched K1 {tr['launches']}")
    scores = {"bf16": {"last": me["parity"]}, "f32": {}}
    for run, path in (("bf16", ev["cfg"]), ("f32", cfg_path)):
        run_dir = os.path.join(logdir, f"eval_{run}")
        for which, step in (("last", EVAL_STEPS), ("first", 1)):
            if which in scores[run]:
                continue
            d = os.path.join(tmp, f"quality_{run}_{which}")
            _cli_eval(path, os.path.join(run_dir, f"checkpoint{step:05d}.ckpt"), d, dev, True)
            scores[run][which] = _score(ev["dataset"], d, f"quality ({run}, {which})")
    for run in ("bf16", "f32"):
        gain = scores[run]["last"]["PSNR"] - scores[run]["first"]["PSNR"]
        check(gain >= QUALITY_GAIN_DB, f"quality ({run}): {gain:.2f} dB over the first checkpoint")
    gap = scores["f32"]["last"]["PSNR"] - scores["bf16"]["last"]["PSNR"]
    check(gap <= QUALITY_BF16_MARGIN_DB, f"quality: bf16 {gap:.3f} dB below f32")
    phase("quality", f"f32 training: {EVAL_STEPS} steps at K={EVAL_K} in {tr['wall']:.1f} s, "
                     f"printed PSNR {tr['psnr']}")
    phase("quality", "mean test PSNR / SSIM of the bf16 parity renders (cli/metrics.py, "
                     f"{EVAL_SPLIT['n_test']} frames at {EVAL_SIZE}x{EVAL_SIZE}): "
                     + "; ".join(f"{run} training: step {EVAL_STEPS} {s['last']['PSNR']:.3f} dB / "
                                 f"{s['last']['SSIM']:.4f}, checkpoint00001 "
                                 f"{s['first']['PSNR']:.3f} dB / {s['first']['SSIM']:.4f}"
                                 for run, s in scores.items())
                     + f"; bf16 - f32 {-gap:+.3f} dB (limit -{QUALITY_BF16_MARGIN_DB}); on {card}")
    return {"scores": scores, "train": tr, "gap_db": -gap}


SUPERVISED_SAVE = 100
SAVE_TIMINGS = 5


def _supervised_cfg(ds_dir, logdir, run_id):
    """`[eval]`'s run (synth512_paper on the 512² dataset on disk, EVAL_STEPS
    steps at K = EVAL_K, validation at 0 and 150) on the host feed, saving
    every SUPERVISED_SAVE steps."""
    d = _eval_cfg(ds_dir, logdir, run_id)
    d["experiment"].update(save_every=SUPERVISED_SAVE, device_feed=False)
    return d


def _children(pid):
    """The live child processes of `pid`: the processes /proc lists (no
    threads) whose parent is `pid`."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            # the fields after the parenthesised command: state, ppid, ...
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(entry))
    return out


def supervised_train_phase(dev, tmp, ds_dir, card):
    """The production run's sidecars on the main path: `cli/train.py --bf16`
    on the host feed (native), uninterrupted, in this process with the
    launch counts reset; then `cli/supervise.py` over the same run in a
    child process. Once a checkpoint past step SUPERVISED_SAVE is complete
    the train child gets SIGTERM: it must exit 143, and the supervisor
    relaunch it from the newest complete .ckpt and finish. The last
    .ckpt's parameters, latent table, background and Adam state equal the
    uninterrupted run's bit for bit. Then the training thread's ms inside
    an async save's `submit` against a synchronous save's, on the run's
    last state."""
    import signal

    import torch

    from nerface_tpu_torch.cli import train as cli_train
    from nerface_tpu_torch.config import CfgNode, FeatureFlags
    from nerface_tpu_torch.data.flame import load_flame_data
    from nerface_tpu_torch.train import checkpoint as C
    from nerface_tpu_torch.train.loop import build_models_from_cfg, setup_background
    from nerface_tpu_torch.train.state import build_optimizer, create_train_state

    t_phase = time.perf_counter()
    logdir = os.path.join(tmp, "supervised_runs")
    paths = {run: _write_cfg(_supervised_cfg(ds_dir, logdir, run),
                             os.path.join(tmp, f"supervised_{run}.yml"))
             for run in ("whole", "supervised")}
    counters = _launch_counts()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    _, text = _cli(cli_train.main, ["--config", paths["whole"], "--device", str(dev), "--bf16"])
    whole_s = time.perf_counter() - t0
    launched = {k: c.launches for k, c in counters.items()}
    check(f"execution window: {EVAL_K} steps" in text, "supervised_train: no window")
    check(launched["K1"] > 0 and launched["K2"] > 0 and launched["K3f"] == launched["K3b"] == 0,
          f"supervised_train: launches {launched}")
    saves = [f"checkpoint{j + 1:05d}.ckpt" for j in range(0, EVAL_STEPS - 1, SUPERVISED_SAVE)]
    saves.append(f"checkpoint{EVAL_STEPS:05d}.ckpt")
    check(all(os.path.isfile(os.path.join(logdir, "whole", n)) for n in saves),
          f"supervised_train: checkpoints {sorted(os.listdir(os.path.join(logdir, 'whole')))}")

    run_dir = os.path.join(logdir, "supervised")
    log_path = os.path.join(tmp, "supervise.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        sup = subprocess.Popen(
            [sys.executable, "-m", "nerface_tpu_torch.cli.supervise", "--poll-seconds", "0.2",
             "--max-restarts", "2", "--outage-probe-seconds", "0", "--", "--config",
             paths["supervised"], "--device", str(dev), "--bf16"],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log, stderr=subprocess.STDOUT)
        try:
            while True:
                latest = C.latest_checkpoint(run_dir)
                if latest is not None and C.checkpoint_step(latest) > SUPERVISED_SAVE:
                    break
                check(sup.poll() is None and time.perf_counter() - t0 < 600,
                      f"supervised_train: no checkpoint past step {SUPERVISED_SAVE}")
                time.sleep(0.02)
            t_ckpt = time.perf_counter() - t0
            children = _children(sup.pid)
            check(len(children) == 1, f"supervised_train: the supervisor's children {children}")
            os.kill(children[0], signal.SIGTERM)
            t_relaunch = None
            while sup.poll() is None and t_relaunch is None:
                if [c for c in _children(sup.pid) if c != children[0]]:
                    t_relaunch = time.perf_counter() - t0
                time.sleep(0.02)
            rc = sup.wait(timeout=600)
        finally:
            if sup.poll() is None:
                sup.kill()
                sup.wait()
    sup_s = time.perf_counter() - t0
    with open(log_path) as f:
        out = f.read()
    check(rc == 0 and "[SUPERVISE] training complete" in out, f"supervised_train: rc {rc}\n{out}")
    check("[SUPERVISE] child exited 143" in out,
          f"supervised_train: the train child did not exit 143 on SIGTERM\n{out}")
    relaunch = [line for line in out.splitlines() if "[SUPERVISE] launch (restart 1)" in line]
    check(len(relaunch) == 1 and "--load-checkpoint" in relaunch[0],
          f"supervised_train: relaunches {relaunch}\n{out}")
    resumed = relaunch[0].split("--load-checkpoint")[1].strip()
    check(C.checkpoint_step(resumed) > SUPERVISED_SAVE and os.path.isfile(resumed),
          f"supervised_train: resumed from {resumed}")
    check(not [n for n in os.listdir(run_dir) if n.endswith(".tmp")],
          f"supervised_train: partial files {os.listdir(run_dir)}")
    a = C.load_torch_checkpoint(os.path.join(logdir, "whole", f"checkpoint{EVAL_STEPS:05d}.ckpt"))
    b = C.load_torch_checkpoint(os.path.join(run_dir, f"checkpoint{EVAL_STEPS:05d}.ckpt"))
    n_tensors = 0
    for which in ("coarse", "fine"):
        check(a[which].keys() == b[which].keys(), f"supervised_train: {which} keys")
        for k in a[which]:
            check(torch.equal(a[which][k], b[which][k]), f"supervised_train: {which}.{k} differs")
            n_tensors += 1
    for k in ("latent_codes", "background"):
        check(torch.equal(a[k], b[k]), f"supervised_train: {k} differs")
    oa, ob = a["optimizer"], b["optimizer"]
    check(oa["param_groups"] == ob["param_groups"] and oa["state"].keys() == ob["state"].keys(),
          "supervised_train: Adam's groups or keys differ")
    for key in oa["state"]:
        for f in ("step", "exp_avg", "exp_avg_sq"):
            check(torch.equal(oa["state"][key][f], ob["state"][key][f]),
                  f"supervised_train: Adam {f} of parameter {key} differs")
    phase("supervised_train", f"cli/train.py --bf16 (host feed, native), {EVAL_STEPS} steps at "
                              f"K={EVAL_K}, saves every {SUPERVISED_SAVE}: uninterrupted in "
                              f"{whole_s:.1f} s (K1 wrapper calls {launched['K1']}, K2 "
                              f"{launched['K2']}); cli/supervise.py in {sup_s:.1f} s: the child "
                              f"got SIGTERM after {os.path.basename(latest)} (at {t_ckpt:.1f} s), "
                              f"exited 143, was relaunched (at {t_relaunch or 0.0:.1f} s) from "
                              f"{os.path.basename(resumed)} and finished; "
                              f"checkpoint{EVAL_STEPS:05d}.ckpt equals the uninterrupted run's "
                              f"bit for bit ({n_tensors} parameters, latent table, background, "
                              f"Adam state of {len(oa['state'])} tensors)")

    # a save's cost to the training thread, on the run's last state
    cfg = CfgNode(_supervised_cfg(ds_dir, logdir, "timing"))
    flags = FeatureFlags.from_cfg(cfg)
    ds = load_flame_data(ds_dir)
    mc, mf = build_models_from_cfg(cfg, device=dev)
    state = create_train_state(mc, mf, flags, n_train=len(ds.i_train),
                               background=setup_background(ds, flags), device=dev)
    opt = build_optimizer(cfg, state)
    C.restore_train_state(state, opt, C.load_torch_checkpoint(
        os.path.join(run_dir, f"checkpoint{EVAL_STEPS:05d}.ckpt"), device=dev))
    writer = C.AsyncCheckpointWriter()
    loss, psnr = torch.tensor(0.01, device=dev), torch.tensor(30.0, device=dev)
    times = {"submit": [], "sync": []}
    for i in range(SAVE_TIMINGS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        writer.submit(os.path.join(tmp, f"timing_async{i}.ckpt"), state, opt, loss=loss, psnr=psnr)
        times["submit"].append((time.perf_counter() - t0) * 1e3)
        writer.drain()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C.save_torch_checkpoint(os.path.join(tmp, f"timing_sync{i}.ckpt"), state, opt, loss=loss,
                                psnr=psnr)
        times["sync"].append((time.perf_counter() - t0) * 1e3)
    writer.finish()
    mb = os.path.getsize(os.path.join(tmp, "timing_sync0.ckpt")) / 1e6
    ms = {k: statistics.median(v) for k, v in times.items()}
    phase_s = time.perf_counter() - t_phase
    phase("supervised_train", f"a save's time on the training thread ({mb:.1f} MB .ckpt, median of "
                              f"{SAVE_TIMINGS}): async submit {ms['submit']:.3f} ms (min "
                              f"{min(times['submit']):.3f}) vs synchronous save {ms['sync']:.3f} ms "
                              f"(min {min(times['sync']):.3f}); on {card}; the phase took "
                              f"{phase_s:.1f} s")
    return {"launches": launched, "resumed_from": os.path.basename(resumed),
            "sigterm_after": os.path.basename(latest), "save_ms": ms, "ckpt_mb": mb,
            "whole_s": whole_s, "supervised_s": sup_s, "phase_s": phase_s}


def _k4_bytes(n_rays, n_samples, backward):
    """The bytes K4f / K4b must move: each input read once (rays, depths,
    dir_c, v0, weights; g and the transposed weights for K4b), each output
    written once ((R, S, 4); the gradients and d_dir for K4b)."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    n = FLEX_N_HIDDEN
    w, f, wt = F.w_offsets(n)["TOTAL"], F.f_offsets(n)["TOTAL"], F.wt_offsets(n)["TOTAL"]
    rays = n_rays * 4 * (3 + 3 + n_samples + 128)
    samples = n_rays * n_samples * 4 * 4  # (R, S, 4) f32: the output, or g
    weights = 2 * w + 4 * f
    if not backward:
        return rays + samples + weights
    return rays + samples + weights + 2 * wt + 4 * (w + f) + n_rays * 4 * 128


# At FLEX_TC_DEPTH hidden layers no evaluation on the tensor cores meets
# `k1_grad_limits` or FLEX_OUT_TOL: PyTorch's own plain version with TF32
# matmuls (the same bf16-exact operands, the tensor cores' f32
# accumulation) misses them on the same inputs by as much as K4f / K4b do
# (PERF.md). There a reading passes within its limit or within
# FLEX_TC_FACTOR of that yardstick's same reading. The factor lies between
# the largest kernel / yardstick ratio of [flex_kernel]'s n = 8 case and
# what a modelled fault reads there: one 64-row unit's cotangent lost
# (`_lost_unit`), which the dW launch's weight tensors alone must still
# catch (PERF.md §6).
FLEX_TC_DEPTH = 8
FLEX_TC_FACTOR = 1.5


def flex_limit(base, n_hidden, tc=None):
    """The limit of one reading of K4f or K4b (relative to the plain
    version's max or norm) at `n_hidden` hidden layers: `base`, and at
    n_hidden ≥ FLEX_TC_DEPTH no less than FLEX_TC_FACTOR × `tc`, the same
    reading of the plain version on the tensor cores (`tensor_core_plain`)."""
    return base if n_hidden < FLEX_TC_DEPTH else max(base, FLEX_TC_FACTOR * tc)


def flex_grad_limits(n_rays, name, n_hidden, tc_err=None):
    """(max, norm) limits of K4b's gradient tensor `name`: `k1_grad_limits`
    through `flex_limit`, `tc_err` the tensor-core yardstick's (max, norm)
    readings (needed at n_hidden ≥ FLEX_TC_DEPTH only)."""
    tol, tol_norm = k1_grad_limits(n_rays, name)
    tc = tc_err or (None, None)
    return flex_limit(tol, n_hidden, tc[0]), flex_limit(tol_norm, n_hidden, tc[1])


def _lost_unit(t):
    """`t` (R, S, 4) with the middle 64-row unit's rows zeroed: a kernel
    that loses one unit of its schedule."""
    f = t.clone().reshape(-1, 64, 4)
    f[f.shape[0] // 2] = 0
    return f.reshape(t.shape)


def tensor_core_plain(fn):
    """`fn()` (a plain version) with its f32 matmuls on the tensor cores
    (TF32: exact on bf16 operands, the tensor cores' accumulation)."""
    import torch

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def rel_err(a, r):
    """(max|a − r| / max|r|, ‖a − r‖ / ‖r‖), f32."""
    a, r = a.float(), r.float()
    d = a - r
    return float(d.abs().max()) / max(float(r.abs().max()), 1e-30), float(d.norm()) / max(float(r.norm()), 1e-30)


# [flex_kernel]'s cases: (label, rays, samples a ray, hidden layers); the
# train step's pair and the serving tiles at synth512_lcode's n = 3, and
# the kernels' other chunk sequences, n = 0 and the most they take, 8
FLEX_CASES = (("coarse", TRAIN_RAYS, 64, FLEX_N_HIDDEN), ("fine", TRAIN_RAYS, 128, FLEX_N_HIDDEN),
              ("tile64", TILE_RAYS, 64, FLEX_N_HIDDEN), ("tile128", TILE_RAYS, 128, FLEX_N_HIDDEN),
              ("n0_s32", TRAIN_RAYS, 32, 0), ("n8_s32", TRAIN_RAYS, 32, 8))


def flex_kernel_phase(dev):
    """K4f and K4b against their plain versions on synth512_lcode's
    He-scaled weights (and the same model at 0 and 8 hidden layers),
    FLEX_SEEDS draws of weights and inputs a case; at n = 3 the wrappers'
    and the bare launches' times (`tools/perf/flex_launch_split.py`, the
    wrappers' own `_launch_flex_*`) and K4b's device time per launch."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.tools.perf import flex_launch_split as FS
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS
    from nerface_tpu_torch.tools.perf.cases import flex_params

    result = {"err": {}, "readings": {}, "ms": {}, "plain_ms": {}, "bound": {}, "tile_ms": {},
              "bare_ms": {}, "bwd_ms": {}, "bwd_plain_ms": {}, "bwd_bound": {}, "grad_rel": {},
              "bwd_bare_ms": {}, "bwd_split": {}, "abs_err": 0.0, "grad_abs_err": 0.0}
    models = {}
    for c, (label, R, S, n) in enumerate(FLEX_CASES):
        if n not in models:
            models[n] = [flex_params(SEED + 7 + 100 * i + (n if n != FLEX_N_HIDDEN else 0), dev, n)
                         for i in range(FLEX_SEEDS)]
        wn, bn = F.weight_names(n)
        names = list(wn) + list(bn) + ["v0", "dir"]
        timed = n == FLEX_N_HIDDEN
        worst, out_err, out_lim, calib = {}, {"rgb": 0.0, "sigma": 0.0}, {"rgb": 0.0, "sigma": 0.0}, {}
        for i, (params, v0) in enumerate(models[n]):
            gen = torch.Generator().manual_seed(SEED + 8 + 100 * i + c)
            ro, rd, z, dc, _, _ = _kernel_inputs(R, S, gen, dev)
            weights = F.pack_flex_weights(params, n, 10)
            args = (weights, ro, rd, z, dc, v0, n)
            got = F.fused_flex_forward(*args)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{label}: K4f output not finite")
            # the plain version's activations at 65536 rays take tens of GB:
            # chunks of 8192 rays
            ref = torch.cat([
                F.fused_flex_forward_reference(weights, ro[j:j + 8192], rd[j:j + 8192],
                                               z[j:j + 8192], dc[j:j + 8192], v0, n)
                for j in range(0, R, 8192)
            ])
            tc_ref = None
            if n >= FLEX_TC_DEPTH:
                tc_ref = tensor_core_plain(lambda: F.fused_flex_forward_reference(*args))
                lost = _lost_unit(ref)
            for part, sl in (("rgb", slice(0, 3)), ("sigma", slice(3, 4))):
                e = float((got[..., sl] - ref[..., sl]).abs().max())
                scale = float(ref[..., sl].abs().max())
                tc_e = tc_ref is not None and rel_err(tc_ref[..., sl], ref[..., sl])
                tol = flex_limit(FLEX_OUT_TOL, n, tc_e and tc_e[0])
                check(e <= tol * scale, f"{label} seed {i}: K4f {part} max err {e} > {tol}·{scale}")
                out_err[part] = max(out_err[part], e / scale)
                out_lim[part] = max(out_lim[part], tol)
                result["abs_err"] = max(result["abs_err"], e)
                if tc_ref is not None:
                    calib.setdefault(part, []).append(dict(
                        kernel=rel_err(got[..., sl], ref[..., sl]), tc=tc_e, limit=(tol, None),
                        base=(FLEX_OUT_TOL, None), fault=rel_err(lost[..., sl], ref[..., sl])))
            del ref
            g = torch.randn(R, S, 4, generator=gen).to(dev)
            case = dict(weights=weights, ro=ro, rd=rd, z=z, dc=dc, v0=v0, g=g, n=n)
            if i == 0 and timed:
                flops = R * S * K4F_FLOP_PER_SAMPLE
                key = "tile_ms" if R == TILE_RAYS else "ms"
                iters = 10 if R == TILE_RAYS else 15
                result[key][label] = _median_ms(lambda: F.fused_flex_forward(*args), iters=iters)
                result["bare_ms"][label] = _median_ms(FS.bare_fwd(case), iters=iters)
                if R == TRAIN_RAYS:
                    result["plain_ms"][label] = _median_ms(
                        lambda: F.fused_flex_forward_reference(*args), warmup=1, iters=5)
                    result["bound"][label] = _bound_ms(flops, _k4_bytes(R, S, False))
            if R != TRAIN_RAYS:
                continue
            grads, d_v0, d_dir = F.fused_flex_backward(*args[:6], g, n)
            torch.cuda.synchronize()
            grads2, d_v02, d_dir2 = F.fused_flex_backward(*args[:6], g, n)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(grads + (d_v0, d_dir),
                                                          grads2 + (d_v02, d_dir2)))
            check(same, f"{label} seed {i}: two K4b launches gave different gradients")
            plain = lambda: F.fused_flex_backward_reference(*args[:6], g, n)  # noqa: E731
            rgrads, rd_v0, rd_dir = plain()
            tc = fault = [None] * len(names)
            if n >= FLEX_TC_DEPTH:
                t = tensor_core_plain(plain)
                tc = [rel_err(x, r) for x, r in zip(t[0] + t[1:], rgrads + (rd_v0, rd_dir))]
                t = F.fused_flex_backward_reference(*args[:6], _lost_unit(g), n)
                fault = [rel_err(x, r) for x, r in zip(t[0] + t[1:], rgrads + (rd_v0, rd_dir))]
            for name, a, r, tc_err, f_err in zip(names, grads + (d_v0, d_dir), rgrads + (rd_v0, rd_dir),
                                                 tc, fault):
                a, r = a.float(), r.float()
                check(bool(torch.isfinite(a).all()), f"{label}: K4b grad {name} not finite")
                d = a - r
                e, scale = float(d.abs().max()), float(r.abs().max())
                e_norm, r_norm = float(d.norm()), float(r.norm())
                tol, tol_norm = flex_grad_limits(R, name, n, tc_err)
                if tc_err is not None:
                    calib.setdefault(name, []).append(dict(
                        kernel=rel_err(a, r), tc=tc_err, limit=(tol, tol_norm),
                        base=k1_grad_limits(R, name), fault=f_err))
                check(e <= tol * scale + 1e-6,
                      f"{label} seed {i}: K4b grad {name} max err {e} > {tol}·{scale} + 1e-6")
                check(e_norm <= tol_norm * r_norm + 1e-6,
                      f"{label} seed {i}: K4b grad {name} ‖err‖ {e_norm} > {tol_norm}·{r_norm}")
                w = worst.get(name, (0.0, 0.0))
                worst[name] = (max(w[0], e / max(scale, 1e-30)), max(w[1], e_norm / max(r_norm, 1e-30)))
                result["grad_abs_err"] = max(result["grad_abs_err"], e)
            if i == 0 and timed:
                result["bwd_ms"][label] = _median_ms(
                    lambda: F.fused_flex_backward(*args[:6], g, n), iters=10)
                result["bwd_plain_ms"][label] = _median_ms(
                    lambda: F.fused_flex_backward_reference(*args[:6], g, n), warmup=1, iters=3)
                result["bwd_bound"][label] = _bound_ms(R * S * K4B_FLOP_PER_SAMPLE,
                                                       _k4_bytes(R, S, True))
                bwd = FS.bare_bwd(case)
                result["bwd_bare_ms"][label] = _median_ms(bwd, iters=10)
                rows = KS.split_rows(bwd, FS.launch_bounds(R, S, n))
                result["bwd_split"][label] = rows
                for short, row in rows.items():
                    phase("flex_kernel", f"  K4b S={S} {KS.row_text(short, row)}")
                if not rows:
                    phase("flex_kernel", f"  K4b S={S} split not measured: the profiler saw no "
                                         "device time")
        result["err"][label] = out_err
        line = (f"{label} R={R} S={S} n={n}, {FLEX_SEEDS} seeds: K4f max err rgb "
                f"{out_err['rgb']:.2e}·max, σ {out_err['sigma']:.2e}·max (limits "
                f"{out_lim['rgb']:.4g}, {out_lim['sigma']:.4g})")
        if R == TILE_RAYS:
            ms, bare = result["tile_ms"][label], result["bare_ms"][label]
            line += (f"; K4f {ms:.3f} ms, bare launch {bare:.3f} ms "
                     f"({R * S * K4F_FLOP_PER_SAMPLE / bare / 1e9:.1f} TFLOP/s at "
                     f"{K4F_FLOP_PER_SAMPLE / 1e6:.4f} MFLOP a sample, operations bound "
                     f"{R * S * K4F_FLOP_PER_SAMPLE / PEAK_BF16_FLOPS * 1e3:.3f} ms)")
        else:
            result["readings"][label] = worst
            w_max = max(worst, key=lambda k: worst[k][0])
            w_norm = max(worst, key=lambda k: worst[k][1])
            result["grad_rel"][label] = (w_max, worst[w_max][0], w_norm, worst[w_norm][1])
            line += (f"; K4b worst grad max err {w_max} {worst[w_max][0]:.4f}·max, worst ‖err‖ "
                     f"{w_norm} {worst[w_norm][1]:.4f}·‖r‖; bit-identical over 2 launches")
            if timed:
                fw, bw = result["ms"][label], result["bwd_ms"][label]
                line += (f"; K4f {fw:.3f} ms, bare launch {result['bare_ms'][label]:.3f} ms "
                         f"({R * S * K4F_FLOP_PER_SAMPLE / fw / 1e9:.1f} TFLOP/s, bound "
                         f"{result['bound'][label][0]:.3f}), plain {result['plain_ms'][label]:.3f} ms; "
                         f"K4b {bw:.3f} ms, bare launch {result['bwd_bare_ms'][label]:.3f} ms "
                         f"({R * S * K4B_FLOP_PER_SAMPLE / bw / 1e9:.1f} TFLOP/s at "
                         f"{K4B_FLOP_PER_SAMPLE / 1e6:.4f} MFLOP a sample, bound "
                         f"{result['bwd_bound'][label][0]:.3f}), plain "
                         f"{result['bwd_plain_ms'][label]:.3f} ms")
        phase("flex_kernel", line)
        if calib:
            result.setdefault("calibration", {})[label] = _flex_calibration(label, calib)
    # every tensor's worst readings per case
    for name in sorted({t for r in result["readings"].values() for t in r}, key=lambda t: (len(t), t)):
        cells = [f"{label} {r[name][0]:.2e}/{r[name][1]:.2e}"
                 for label, r in result["readings"].items() if name in r]
        phase("flex_kernel", f"  grad {name:5s} max/norm rel err: {', '.join(cells)} (limits "
                             f"{'/'.join(map(str, k1_grad_limits(TRAIN_RAYS, name)))} below n = "
                             f"{FLEX_TC_DEPTH}, `flex_limit` from there)")
    return result


# the ray / sample cases whose last round leaves warpgroup 1 past the last
# ray (tests/test_torch_k4_layout.py::DEAD_UNIT_CTA), at 8 hidden layers
DEAD_UNIT_CASES = ((2085, 64), (601, 128))
DEAD_UNIT_PASSES = 200


def flex_dead_units_phase(dev):
    """K4f + K4b at 8 hidden layers on DEAD_UNIT_CASES, DEAD_UNIT_PASSES
    passes: the dead-unit walk of K4b's recompute and dX
    (`fused_flex.cu::skip_stages`), which trapped in the mbarrier watchdog
    before its repair. Every pass's output and gradients equal the first
    pass's bit for bit. Nothing catches a fault: it fails the run."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.tools.perf.cases import flex_params

    n = 8
    result = {}
    for R, S in DEAD_UNIT_CASES:
        sched = F.unit_schedule(R, S)
        dead = sorted({(c, r, wg) for c, r, wg, _, ok in sched if not ok})
        check(len(dead) == 1 and dead[0][2] == 1, f"flex_dead_units {R}x{S}: dead items {dead}")
        params, v0 = flex_params(SEED + R + n, dev, n_hidden=n)
        gen = torch.Generator().manual_seed(SEED + R + S)
        ro, rd, z, dc, _, _ = _kernel_inputs(R, S, gen, dev)
        weights = F.pack_flex_weights(params, n, 10)
        g = torch.randn(R, S, 4, generator=gen).to(dev)
        args = (weights, ro, rd, z, dc, v0)
        first = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DEAD_UNIT_PASSES):
            out = F.fused_flex_forward(*args, n)
            grads = F.fused_flex_backward(*args, g, n)
            flat = [out, *grads[0], *grads[1:]]
            if first is None:
                first = flat
            else:
                for a, b in zip(first, flat):
                    check(torch.equal(a, b), f"flex_dead_units {R}x{S}: a pass differs from the "
                                             f"first")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(all(bool(torch.isfinite(t).all()) for t in first),
              f"flex_dead_units {R}x{S}: not finite")
        result[f"{R}x{S}"] = {"passes": DEAD_UNIT_PASSES, "seconds": wall, "dead_item": dead[0]}
        phase("flex_dead_units", f"{R}x{S}, n = {n}: {DEAD_UNIT_PASSES} passes of K4f + K4b in "
                                 f"{wall:.2f} s, each bit for bit the first (outputs and "
                                 f"{len(first) - 1} gradient tensors); the dead warpgroup-1 item "
                                 f"in CTA {dead[0][0]}, round {dead[0][1]}")
    return result


def _flex_calibration(label, calib):
    """The n ≥ FLEX_TC_DEPTH case's readings, seed by seed: each tensor's
    kernel reading, the tensor-core yardstick's, their ratio, the limit
    applied and what a lost unit (`_lost_unit`) reads. Checks that the
    factor lies between the largest ratio of a reading it decides and the
    largest factor at which the dW launch's tensors alone still catch a
    unit lost to that launch. Returns the summary."""
    # the dW launch's products: w1a, w1b, wh_i, wf, wd0 (the weights before
    # WA in `w_offsets`); wa and wrgb are dX's partial sums
    dw_tensors = {nm for nm in calib if nm.startswith("w") and nm not in ("wa", "wrgb")}

    def ratio(a, b):
        return a / b if b > 0 else float("inf")

    def pair(x):
        return f"{x[0]:.2e}" + (f"/{x[1]:.2e}" if x[1] is not None else "")

    decided, catch = [], {i: (0.0, None) for i in range(FLEX_SEEDS)}
    for name, seeds in calib.items():
        cells = []
        for i, r in enumerate(seeds):
            k, t, lim, base, f = r["kernel"], r["tc"], r["limit"], r["base"], r["fault"]
            ratios = [ratio(k[j], t[j]) for j in (0, 1) if lim[j] is not None]
            cells.append(f"s{i} {pair(k)} | {pair(t)} ({'/'.join(f'{q:.2f}' for q in ratios)}) | "
                         f"{pair(lim)} | {pair(f)}")
            for j, q in enumerate(ratios):
                if k[j] > base[j]:  # the factor decides this reading
                    decided.append((q, name, i, ("max", "norm")[j]))
            if name in dw_tensors:  # the largest factor that still catches the lost unit here
                best = max((ratio(f[j], t[j]) for j in (0, 1) if f[j] > base[j]), default=0.0)
                if best > catch[i][0]:
                    catch[i] = (best, name)
        phase("flex_kernel", f"  {label} {name:5s} kernel | tensor cores (ratio) | limit | one unit "
                             f"lost, max/norm: {'; '.join(cells)}")
    top = max(decided, default=(0.0, None, None, None))
    low = min(catch.values(), key=lambda c: c[0])
    phase("flex_kernel", f"{label}: FLEX_TC_FACTOR {FLEX_TC_FACTOR}: the largest kernel / tensor-core "
                         f"ratio of a reading above its base limit {top[0]:.3f} ({top[1]} seed {top[2]} "
                         f"{top[3]}); a unit lost to the dW launch alone is caught up to a factor of "
                         f"{low[0]:.3f} ({low[1]}, the least over the seeds)")
    check(top[0] < FLEX_TC_FACTOR < low[0],
          f"{label}: FLEX_TC_FACTOR {FLEX_TC_FACTOR} not between {top[0]} and {low[0]}")
    return {"largest_ratio": top, "lost_unit_caught_below": low}


def _save_avatar(cfg, ds, path, seed):
    """A reference-schema .ckpt of He-scaled random models (σ biased up so
    that the MLP's colour, not the background, makes the pixels) and a
    random 32-wide latent table."""
    import torch

    from nerface_tpu_torch.models.nerf_models import build_model
    from nerface_tpu_torch.tools.perf.cases import he_scale

    gen = torch.Generator().manual_seed(seed)
    coarse = build_model(cfg.models.coarse, generator=gen)
    fine = build_model(
        cfg.models.fine, num_layers=cfg.models.coarse.num_layers,
        hidden_size=cfg.models.coarse.hidden_size, generator=gen,
    )
    for m in (coarse, fine):
        he_scale(m)
        with torch.no_grad():
            m.fc_alpha.bias += SIGMA_BIAS
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
        path,
    )
    return path


def flex_serve_phase(dev, tmp, profile=False):
    """A 512² synth512_lcode avatar served in bf16 through K4f; with
    `profile` its warm frames and a frame's device time per kernel
    (`profile_phase`)."""
    import numpy as np
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels.fused_mlp import fused_paper_render
    from nerface_tpu_torch.serve import AvatarServer

    cfg = CfgNode(SYNTH512_LCODE)
    ds = synthetic_flame_dataset(H=512, W=512, n_train=8, n_val=2, n_test=2, seed=SEED)
    ckpt = _save_avatar(cfg, ds, os.path.join(tmp, "synth512_lcode.ckpt"), SEED + 5)
    server = AvatarServer(cfg, ckpt, dataset=ds, dtype=torch.bfloat16, device=dev, log=False)
    tiles = -(-server.H * server.W // min(server.settings.chunksize, server.H * server.W))
    maps = ["rgb_fine", "disp", "normals"]
    requests = [{"cmd": "ping"}, {"frame": 0, "seed": 0, "maps": maps},
                {"frame": 1, "seed": 1, "maps": maps}, {"frame": 0, "seed": 2, "maps": maps},
                {"cmd": "stop"}]
    n_renders = sum("cmd" not in r for r in requests)
    out = io.StringIO()
    F.fused_flex_forward.launches = F.fused_flex_backward.launches = 0
    fused_paper_render.launches = 0
    handled = server.serve_jsonl(io.StringIO("\n".join(map(json.dumps, requests)) + "\n"), out)
    launches = F.fused_flex_forward.launches
    check(F.fused_flex_backward.launches == 0 and fused_paper_render.launches == 0,
          "serving the flex avatar launched K4b or K2")
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    check(handled == len(requests) and len(replies) == len(requests), f"replies: {replies}")
    for req, rep in zip(requests, replies):
        check(rep.get("ok") is True, f"request {req} failed: {rep}")
    check(launches == 2 * tiles * n_renders,
          f"K4f launches {launches} != 2 x {tiles} tiles x {n_renders} frames")
    frame_ms = [r["frame_ms"] for r in replies if "frame_ms" in r]
    phase("flex_serve", f"{n_renders} synth512_lcode renders at {ds.H}x{ds.W} via serve_jsonl, frame_ms "
                        f"{frame_ms}, K4f launches {launches} = 2 x {tiles} tiles x {n_renders}")

    if profile:
        profile_phase(server, "profile_flex_serve")
    img = server.render(frame=1, seed=1, maps=tuple(maps))
    check(img["rgb_fine"].shape == (ds.H, ds.W, 3) and img["rgb_fine"].dtype == np.uint8,
          f"rgb {img['rgb_fine'].shape} {img['rgb_fine'].dtype}")
    cfg32 = CfgNode(SYNTH512_LCODE)
    cfg32.nerf.validation["chunksize"] = 16384  # bounds the f32 activations
    plain = AvatarServer(cfg32, ckpt, dataset=ds, dtype=None, device=dev, log=False)
    before = F.fused_flex_forward.launches
    ref = plain.render(frame=1, seed=1, maps=("rgb_fine",))["rgb_fine"]
    check(F.fused_flex_forward.launches == before, "the f32 plain path launched K4f")
    diff = np.abs(img["rgb_fine"].astype(np.int16) - ref.astype(np.int16))
    mean_diff, p99 = float(diff.mean()), float(np.percentile(diff, 99))
    bg = (np.clip(ds.load_background(), 0.0, 1.0) * 255.0).astype(np.int16)
    off_bg = float(np.abs(img["rgb_fine"].astype(np.int16) - bg).mean())
    spread = float(img["rgb_fine"].std())
    check(off_bg >= 10.0 and spread >= 10.0,
          f"frame {off_bg} levels off the background, std {spread}: the MLP shows little")
    check(int(diff.max()) <= FLEX_FRAME_MAX and mean_diff <= FLEX_FRAME_MEAN,
          f"bf16 K4f frame vs f32: mean {mean_diff}, max {int(diff.max())}")
    phase("flex_serve", f"mean |frame - background| {off_bg:.2f} levels, frame std {spread:.2f}; "
                        f"bf16 K4f frame vs f32 plain frame: mean |diff| {mean_diff:.4f} levels, "
                        f"p99 {p99:.0f}, max {int(diff.max())} (limits {FLEX_FRAME_MEAN}, "
                        f"{FLEX_FRAME_MAX})")
    return {"launches": launches, "frame_ms": frame_ms, "tiles": tiles,
            "mean_diff": mean_diff, "max_diff": int(diff.max())}


def _steady_steps(state, cfg, ds, dev, n_warm=3, n=15):
    """Median ms of `n` synchronised bf16 train steps after `n_warm`, from
    `state`, one at a time through the loop's step body
    (train/window.py, no graph), with the step function for further
    steps."""
    import torch

    from nerface_tpu_torch.config import FeatureFlags
    from nerface_tpu_torch.data.pipeline import RayFeed
    from nerface_tpu_torch.render.pipeline import RenderSettings
    from nerface_tpu_torch.train.loop import setup_background
    from nerface_tpu_torch.train.schedule import from_cfg
    from nerface_tpu_torch.train.state import build_optimizer
    from nerface_tpu_torch.train.window import TrainWindow

    flags = FeatureFlags.from_cfg(cfg)
    feed = RayFeed(ds, TRAIN_RAYS, background=setup_background(ds, flags), seed=SEED + 9).start()
    window = TrainWindow(state, build_optimizer(cfg, state), RenderSettings.from_cfg(cfg, "train"),
                         flags, from_cfg(cfg), SEED + 9, 1, dtype=torch.bfloat16)

    def step(i):
        window.run(1, [next(feed)])

    for i in range(n_warm):
        step(i)
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(n_warm + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, step, feed


def _profile_steps(name, step, what):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    n = 5
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(100 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    _print_profile(name, prof, n, wall, "a step", DeviceType, what)


def flex_train_phase(dev, ds, tmp, profile, card):
    """`train()` of synth512_lcode in bf16 on the card: every MLP pass is
    K4f, every gradient K4b."""
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels.fused_mlp import fused_paper_render
    from nerface_tpu_torch.ops.kernels.fused_train import fused_train_pass
    from nerface_tpu_torch.train.checkpoint import load_torch_checkpoint
    from nerface_tpu_torch.train.loop import train

    steps = FLEX_TRAIN_STEPS
    d = copy.deepcopy(SYNTH512_LCODE)
    d["experiment"].update(logdir=os.path.join(tmp, "flex"), train_iters=steps, print_every=10,
                           validate_every=1000, save_every=1000)
    cfg = CfgNode(d)
    out = io.StringIO()
    F.fused_flex_forward.launches = F.fused_flex_backward.launches = 0
    fused_train_pass.launches = fused_paper_render.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = train(cfg, dataset=ds, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4f, k4b = F.fused_flex_forward.launches, F.fused_flex_backward.launches
    print(out.getvalue(), end="", flush=True)
    tiles = -(-ds.H * ds.W // int(cfg.nerf.validation.chunksize))
    check(k4f == 2 * steps + 2 * tiles * 2,
          f"K4f launches {k4f} != 2 x {steps} steps + 2 x {tiles} tiles x 2 frames")
    check(k4b == 2 * steps, f"K4b launches {k4b} != 2 x {steps} steps")
    check(fused_train_pass.launches == 0 and fused_paper_render.launches == 0,
          "the flex run launched K1 or K2")
    printed = {int(i): float(v) for i, v in
               re.findall(r"\[TRAIN\] Iter: (\d+) Loss: (\S+)", out.getvalue())}
    want = sorted(set(range(0, steps, 10)) | {steps - 1})
    check(sorted(printed) == want, f"printed steps {sorted(printed)} != {want}")
    check(all(math.isfinite(v) for v in printed.values()), f"non-finite loss: {printed}")
    first = statistics.mean(printed[i] for i in want if i < 20)
    last = statistics.mean(printed[i] for i in want if i >= steps - 10)
    check(last < first, f"flex loss did not fall: steps < 20 {first}, last 10 steps {last}")
    path = os.path.join(tmp, "flex", "synth512_paper", f"checkpoint{steps:05d}.ckpt")
    saved = load_torch_checkpoint(path)
    groups = saved["optimizer"]["param_groups"]
    check(saved["iter"] == steps and len(groups) == 2,
          f"checkpoint iter {saved['iter']}, {len(groups)} param groups")
    check(set(saved["fine"]) == set(state.model_fine.state_dict()), "checkpoint keys")
    phase("flex_train", f"{steps} synth512_lcode steps at {ds.H}x{ds.W} (bf16, {dev.type}) in {wall:.1f} s "
                        f"with one validation and 2 saves; K4f launches {k4f} = 2 x {steps} + 2 x "
                        f"{tiles} tiles x 2 frames, K4b launches {k4b} = 2 x {steps}; printed loss, "
                        f"mean of steps 0 and 10 {first:.5f} -> of the last 10 steps {last:.5f}; "
                        f"{os.path.basename(path)} reloads, 2 param groups")
    times, step, feed = _steady_steps(state, cfg, ds, dev)
    step_ms = statistics.median(times)
    phase("flex_train", f"steady step {step_ms:.2f} ms (median of 15, synchronised; min "
                        f"{min(times):.2f}, max {max(times):.2f}), "
                        f"{TRAIN_RAYS / step_ms * 1e3:,.0f} rays/s on {card}")
    if profile:
        _profile_steps("profile_flex_train", step, "flex train step")
    feed.stop()
    return {"k4f_launches": k4f, "k4b_launches": k4b, "step_ms": step_ms,
            "rays_s": TRAIN_RAYS / step_ms * 1e3, "loss_printed": printed}


def _print_profile(name, prof, n, wall, unit, DeviceType, what=""):
    """Print the CUDA kernels' device time per `unit` (n of them ran under
    `prof`, `wall` ms each) and the top 12 kernels; returns the busy ms."""
    rows = []
    for e in prof.key_averages():
        # a user annotation's device range (e.g. Optimizer.step) spans kernels
        # that are listed on their own
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            us = getattr(e, "device_time_total", None)
            rows.append(((us if us is not None else e.cuda_time_total) / 1e3 / n, e.count // n,
                         e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    check(busy > 0.0, "the profiler saw no device time")
    phase(name, f"{what} under the profiler: {wall:.2f} ms {unit}, device busy {busy:.2f} ms "
                f"({100 * busy / wall:.1f} %), {sum(r[1] for r in rows)} kernel launches {unit}")
    for ms, count, key in rows[:12]:
        phase(name, f"  {ms:9.3f} ms {100 * ms / busy:5.1f} % x{count:<4d} {key[:90]}")
    return busy


def _k5_bytes(n_rays, n_coarse, n_fine, shared_u):
    """z and w read, u read ((R, Sf), or one (Sf,) row), the union written."""
    u = n_fine if shared_u else n_rays * n_fine
    return 4 * (2 * n_rays * n_coarse + u + n_rays * (n_coarse + n_fine))


def resample_phase(dev):
    """K5 `fused_resample` (csrc/fused_resample.cu), an entry point of its
    own as in the JAX package (nothing renders through it): driven once per
    regime on a serve tile (the counts reset just before), then held against
    its plain version, which is what `render_rays` runs today, at 2048 rays
    and at a 65536-ray tile, 64 + 64 samples, RESAMPLE_SEEDS draws a case and
    the spike case: max error ≤ RESAMPLE_TOL·far, every row sorted,
    bit-identical over 2 launches; kernel and plain ms and the bound."""
    import torch

    from nerface_tpu_torch.ops.kernels.fused_resample import (
        fused_resample,
        fused_resample_reference,
    )
    from nerface_tpu_torch.ops.math import linspace01
    from nerface_tpu_torch.tools.perf.cases import resample_inputs
    from nerface_tpu_torch.tools.perf.k3f_k5_launch_split import device_ms, k5_bare

    S = 64
    u_det = linspace01(S, device=dev)
    z, w, u = resample_inputs(TILE_RAYS, S, S, SEED + 20, dev)
    fused_resample.launches = 0
    fused_resample(z, w, u)
    fused_resample(z, w, u_det, sorted_u=True)
    torch.cuda.synchronize()
    path_launches = fused_resample.launches
    check(path_launches == 2, f"resample: {path_launches} launches for 2 calls")

    result = {"err": {}, "ms": {}, "bare_ms": {}, "device_ms": {}, "device_by": {}, "gb_s": {},
              "plain_ms": {}, "bound": {}, "launches": path_launches}
    worst = 0.0
    for R in (TRAIN_RAYS, TILE_RAYS):
        for regime in ("general", "sorted_u"):
            cases = [(i, False) for i in range(RESAMPLE_SEEDS)]
            if regime == "sorted_u":
                cases.append((RESAMPLE_SEEDS, True))  # the spike, with the linspace draws
            err = 0.0
            for i, spike in cases:
                z, w, u = resample_inputs(R, S, S, SEED + 21 + 100 * i + R, dev,
                                          RESAMPLE_SPIKE if spike else 0.0)
                sorted_u = regime == "sorted_u"
                uu = u_det if sorted_u else u
                got = fused_resample(z, w, uu, sorted_u=sorted_u)
                got2 = fused_resample(z, w, uu, sorted_u=sorted_u)
                torch.cuda.synchronize()
                ref = fused_resample_reference(z, w, uu, sorted_u)
                check(bool(torch.isfinite(got).all()), f"resample {regime} R={R}: not finite")
                check(torch.equal(got, got2), f"resample {regime} R={R} seed {i}: launches differ")
                check(bool((got[:, 1:] >= got[:, :-1]).all()),
                      f"resample {regime} R={R} seed {i}: a row is not sorted")
                e = float((got - ref).abs().max())
                check(e <= RESAMPLE_TOL * FAR,
                      f"resample {regime} R={R} seed {i}{' spike' if spike else ''}: max err {e} "
                      f"> {RESAMPLE_TOL}·{FAR}")
                err = max(err, e)
            label = f"{regime}_{R}"
            result["err"][label] = err
            worst = max(worst, err)
            z, w, u = resample_inputs(R, S, S, SEED + 30, dev)
            uu = u_det if regime == "sorted_u" else u
            srt = regime == "sorted_u"
            result["ms"][label] = _median_ms(lambda: fused_resample(z, w, uu, sorted_u=srt), iters=20)
            bare = k5_bare(z, w, uu, srt)
            result["bare_ms"][label] = _median_ms(bare, iters=20)
            result["device_ms"][label], result["device_by"][label] = device_ms(bare, "resample_kernel")
            check(result["device_ms"][label] > 0, f"resample {regime} R={R}: no device time read")
            result["gb_s"][label] = _k5_bytes(R, S, S, srt) / result["device_ms"][label] / 1e6
            result["plain_ms"][label] = _median_ms(
                lambda: fused_resample_reference(z, w, uu, srt), iters=10)
            result["bound"][label] = _bound_ms(0, _k5_bytes(R, S, S, srt))
            phase("resample_kernel",
                  f"K5 {regime} R={R} Sc={S} Sf={S}, {len(cases)} draws"
                  f"{' (the last a spike of ' + str(RESAMPLE_SPIKE) + ')' if srt else ''}: max abs "
                  f"err {err:.3g} (limit {RESAMPLE_TOL}·far = {RESAMPLE_TOL * FAR:.1e}), rows "
                  f"sorted, bit-identical over 2 launches; kernel {result['ms'][label]:.4f} ms, bare "
                  f"launch {result['bare_ms'][label]:.4f} ms, device {result['device_ms'][label]:.4f} "
                  f"ms by {result['device_by'][label]} ({result['gb_s'][label]:.0f} GB/s), "
                  f"bound {result['bound'][label][0]:.4f} ms ({result['bound'][label][1]}), plain "
                  f"(sample_pdf + merge_sorted_zvals, the pipeline's resample) "
                  f"{result['plain_ms'][label]:.4f} ms")
    result["max_abs_err"] = worst
    phase("resample_kernel", f"K5 launched {path_launches} times on its entry point (a 65536-ray "
                             f"tile, each regime once); nothing in render/ or eval/ calls it")
    return result


def _fast_contract(server, frame, seed, label):
    """The fast frame against the same server's parity frame (frame
    `frame`, seed `seed`): inside the active mask (bbox ∩ occupancy) within
    1 level; outside, each pixel the background or the parity pixel (a
    spare capacity slot renders a real ray, within 1 level: the torch ops
    around K2 run at another row count). Returns the readings."""
    import numpy as np
    import torch

    from nerface_tpu_torch.eval.driver import device_cast_to_image
    from nerface_tpu_torch.eval.renderer import _active_mask
    from nerface_tpu_torch.ops.rays import get_ray_bundle

    H, W = server.H, server.W
    fast = server.render(frame=frame, seed=seed, maps=("rgb_fine",))["rgb_fine"]
    par = server.render(frame=frame, seed=seed, maps=("rgb_fine",), fast_eval=False)["rgb_fine"]
    pose, _, _ = server._frame_defaults(frame)
    pose = torch.as_tensor(pose[:3, :4], dtype=torch.float32, device=server.device)
    ro, rd = get_ray_bundle(H, W, server.intrinsics, pose)
    active = _active_mask(ro.reshape(-1, 3), rd.reshape(-1, 3), H, W, server.fast_bbox,
                          server.occupancy, server.settings, pose=pose,
                          intrinsics=server.intrinsics).reshape(H, W).cpu().numpy()
    if server.background is not None:
        bg = device_cast_to_image(server.background.reshape(H, W, 3)).cpu().numpy()
    else:
        bg = np.full((H, W, 3), 255 if server.settings.white_background else 0, np.uint8)
    return _contract(fast, par, active, bg, label)


def _contract(fast, par, active, bg, label):
    """A fast uint8 frame against the parity frame of the same seed: the
    pixels of the (H, W) bool `active` mask within 1 level, every other
    pixel the background `bg` or the parity pixel (within 1 level)."""
    import numpy as np

    fast, par, bg = (x.astype(np.int16) for x in (fast, par, bg))
    diff = np.abs(fast - par)
    inside_max = int(diff[active].max()) if active.any() else 0
    inside_differ = int((diff[active] > 0).any(axis=-1).sum())
    out_bg = (fast == bg).all(axis=-1) & ~active
    out_par = (diff <= 1).all(axis=-1) & ~active
    check(active.any(), f"{label}: no active ray")
    check(inside_max <= 1, f"{label}: active pixels {inside_max} levels off the parity frame")
    check(bool((out_bg | out_par)[~active].all()),
          f"{label}: {int((~(out_bg | out_par))[~active].sum())} skipped pixels are neither the "
          f"background nor the parity pixel")
    return {"active": int(active.sum()), "inside_max": inside_max, "inside_differ": inside_differ,
            "skipped_bg": int(out_bg.sum()), "spare_real": int((out_par & ~out_bg).sum())}


def _fast_vs_parity_ms(server):
    """Warm synchronised rgb frames, fast and parity in turns."""
    import torch

    fast, par = [], []
    for i in range(FAST_FRAMES):
        for flag, ts in ((True, fast), (False, par)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.render(frame=i % len(server.dataset.i_test), seed=i, maps=("rgb_fine",),
                          fast_eval=flag)
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(fast), statistics.median(par), fast, par


def _fast_requests(server, name):
    """3 renders over serve_jsonl, the paper family's counts reset just
    before and read just after; returns (K2 launches, frame_ms)."""
    from nerface_tpu_torch.ops.kernels.fused_resample import fused_resample

    counters = _launch_counts()
    maps = ["rgb_fine", "disp", "normals"]
    last = len(server.dataset.i_test) - 1
    requests = [{"cmd": "ping"}, {"frame": 0, "seed": 0, "maps": maps},
                {"frame": last, "seed": 1, "maps": maps}, {"frame": 0, "seed": 2, "maps": maps},
                {"cmd": "stop"}]
    out = io.StringIO()
    for c in list(counters.values()) + [fused_resample]:
        c.launches = 0
    handled = server.serve_jsonl(io.StringIO("\n".join(map(json.dumps, requests)) + "\n"), out)
    launched = {k: c.launches for k, c in counters.items()}
    launched["K5"] = fused_resample.launches
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    check(handled == len(requests) and len(replies) == len(requests), f"{name}: {replies}")
    for req, rep in zip(requests, replies):
        check(rep.get("ok") is True, f"{name}: request {req} failed: {rep}")
    check(replies[0]["fast_eval"] is True, f"{name}: ping {replies[0]}")
    return launched, [r["frame_ms"] for r in replies if "frame_ms" in r], sum(
        "cmd" not in r for r in requests)


def _tiles_per_frame(server):
    from nerface_tpu_torch.eval.renderer import FAST_TILE

    n = server.H * server.W
    tile = min(server.settings.chunksize, n, FAST_TILE)
    cap = -(-max(1, int(n * server.settings.fast_eval_capacity)) // tile) * tile
    return min(cap, -(-n // tile) * tile) // tile


def fast_serve_phase(dev, tmp, profile):
    """SYNTH512_PAPER with `nerf.validation.fast_eval: true`, served in
    bf16: the test split's bbox union [153, 358, 153, 358] gives capacity
    0.17, 49152 rays in 3 tiles of 16384, 6 K2 launches a frame."""
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
    from nerface_tpu_torch.eval.renderer import FAST_TILE
    from nerface_tpu_torch.serve import AvatarServer

    size = FAST_SERVE_SIZE

    d = copy.deepcopy(SYNTH512_PAPER)
    d["nerf"]["validation"]["fast_eval"] = True
    cfg = CfgNode(d)
    ds = synthetic_flame_dataset(H=size, W=size, n_train=8, n_val=2, n_test=2, seed=SEED)
    ckpt = _save_avatar(cfg, ds, os.path.join(tmp, "fast.ckpt"), SEED + 2)
    server = AvatarServer(cfg, ckpt, dataset=ds, dtype=torch.bfloat16, device=dev, log=False)
    tiles = _tiles_per_frame(server)
    check(size != 512 or (server.fast_bbox.tolist() == [153, 358, 153, 358] and tiles == 3),
          f"fast_serve: bbox {server.fast_bbox.tolist()}, capacity "
          f"{server.settings.fast_eval_capacity}, {tiles} tiles")
    launched, frame_ms, n = _fast_requests(server, "fast_serve")
    check(launched == {"K1": 0, "K2": 2 * tiles * n, "K3f": 0, "K3b": 0, "K5": 0},
          f"fast_serve: launches {launched}, want K2 = 2 x {tiles} tiles x {n} frames only")
    phase("fast_serve", f"{n} fast renders at {size}x{size} via serve_jsonl (bbox "
                        f"{server.fast_bbox.tolist()}, capacity "
                        f"{server.settings.fast_eval_capacity:.4f}: {tiles} tiles of "
                        f"{FAST_TILE}), frame_ms {frame_ms}, launches {launched}")
    c = _fast_contract(server, 1, 1, "fast_serve")
    fast_ms, par_ms, fast_all, par_all = _fast_vs_parity_ms(server)
    phase("fast_serve", f"vs the same server's parity frame: {c['active']} active pixels, max "
                        f"{c['inside_max']} level off, {c['inside_differ']} differ; skipped "
                        f"pixels: {c['skipped_bg']} background, {c['spare_real']} rendered in "
                        f"spare slots (= parity within 1 level); warm rgb frame {fast_ms:.2f} ms "
                        f"fast vs {par_ms:.2f} ms parity (medians of {FAST_FRAMES}, in turns: "
                        f"{[round(t, 2) for t in fast_all]} / {[round(t, 2) for t in par_all]}); "
                        f"PR 5's record, earlier K2: {PREVIOUS_FRAME_MS['fast']} / "
                        f"{PREVIOUS_FRAME_MS['parity']} ms")
    if profile:
        profile_phase(server, "profile_fast")
    return dict(c, launches=launched["K2"], frame_ms=frame_ms, fast_ms=fast_ms, parity_ms=par_ms,
                tiles=tiles)


def occupancy_serve_phase(dev, ds, ckpt):
    """The checkpoint `[train]` saved, served in bf16 with fast_eval and the
    occupancy grid (splat mask, 128³, 2× supersampled): the grid build's
    seconds and occupancy, the active fraction and capacity, K2 launches
    and frame ms, and the fast contract against the parity frame."""
    import numpy as np
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.eval import occupancy as O
    from nerface_tpu_torch.serve import AvatarServer

    resolution = OCCUPANCY_RESOLUTION
    d = copy.deepcopy(SYNTH512_PAPER)
    d["nerf"]["validation"].update(fast_eval=True, occupancy=True,
                                   occupancy_resolution=resolution)
    cfg = CfgNode(d)
    builds = []
    real_build = O.build_occupancy_grid

    def timed_build(*a, **k):  # the tighten prepass and the grid itself
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = real_build(*a, **k)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
        return grid

    O.build_occupancy_grid = timed_build
    try:
        t0 = time.perf_counter()
        server = AvatarServer(cfg, ckpt, dataset=ds, dtype=torch.bfloat16, device=dev, log=False)
        setup_s = time.perf_counter() - t0
    finally:
        O.build_occupancy_grid = real_build
    occ = server.occupancy
    check(occ is not None and occ.boxes_lo is not None and occ.resolution == resolution,
          f"occupancy_serve: no {resolution}³ splat grid")
    i_test = np.asarray(ds.i_test)
    frac = O.active_fraction(occ, np.asarray(ds.poses)[i_test], ds.intrinsics, ds.H, ds.W,
                             server.settings.near, server.settings.far)
    tiles = _tiles_per_frame(server)
    launched, frame_ms, n = _fast_requests(server, "occupancy_serve")
    check(launched == {"K1": 0, "K2": 2 * tiles * n, "K3f": 0, "K3b": 0, "K5": 0},
          f"occupancy_serve: launches {launched}, want K2 = 2 x {tiles} tiles x {n} frames only")
    n_boxes = int(occ.boxes_valid.sum())
    phase("occupancy_serve",
          f"{os.path.basename(ckpt)} with fast_eval + occupancy (splat, {resolution}^3, 2x "
          f"supersampled): "
          f"server setup {setup_s:.2f} s, grid builds {[round(b, 3) for b in builds]} s (tighten "
          f"prepass 32^3, grid {2 * resolution}^3 pooled to {resolution}^3, 8 expressions each), "
          f"occupied "
          f"{occ.occupancy_fraction():.4f}, {n_boxes} splat boxes, bbox "
          f"{server.fast_bbox.tolist()}; active fraction {frac:.4f}, capacity "
          f"{server.settings.fast_eval_capacity:.4f} ({tiles} tiles); {n} renders via "
          f"serve_jsonl, frame_ms {frame_ms}, launches {launched}")
    c = _fast_contract(server, 0, 1, "occupancy_serve")
    fast_ms, par_ms, fast_all, par_all = _fast_vs_parity_ms(server)
    phase("occupancy_serve", f"vs the same server's parity frame: {c['active']} active pixels, "
                             f"max {c['inside_max']} level off, {c['inside_differ']} differ; "
                             f"skipped pixels: {c['skipped_bg']} background, {c['spare_real']} "
                             f"rendered in spare slots; warm rgb frame {fast_ms:.2f} ms fast vs "
                             f"{par_ms:.2f} ms parity (medians of {FAST_FRAMES}, in turns); PR 5's "
                             f"record, earlier K2: {PREVIOUS_FRAME_MS['occupancy']} ms")
    return dict(c, launches=launched["K2"], frame_ms=frame_ms, fast_ms=fast_ms, parity_ms=par_ms,
                tiles=tiles, grid_build_s=builds, setup_s=setup_s,
                occupied=occ.occupancy_fraction(), active_fraction=frac,
                capacity=server.settings.fast_eval_capacity)


def _probe_entry(res, name, headline, replaces, card):
    """A probe's entry of the kernels line: `headline` is the variant K2
    follows; every variant's numbers ride along."""
    v = res["variants"]
    return {
        "name": f"{name}_probe",
        "route": "cuda",
        "source": "nerface_tpu_torch/csrc/probes.cu",
        "replaces": replaces,
        # its own entry point, each variant once: nothing in the system runs a probe
        "launches": res["launches"],
        "max_abs_err": max(r["max_abs"] for r in v.values()),
        "ms": v[headline]["ms"],
        "plain_ms": v[headline]["plain_ms"],
        "bound_ms": v[headline]["bound"][0],
        "bound_by": v[headline]["bound"][1],
        "library_ms": None,  # no single PyTorch call computes it
        "headline_variant": headline,
        "by_variant": {k: {x: r[x] for x in r if x not in ("finite", "bound")} for k, r in v.items()},
        "card": card,
    }


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a served frame's and a train step's device time")
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

    build_phase()
    k = kernel_phase(dev)
    ks = kernel_phase(dev, small=True)
    rk = resample_phase(dev)
    pr = probes_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        server, s = serve_phase(dev, tmp)
        if args.profile:
            profile_phase(server)
        del server
        fe = fast_serve_phase(dev, tmp, args.profile)
        server, ss = serve_phase(dev, tmp, SYNTH512_SMALLER, "smaller_serve", SEED + 6)
        del server
        nf = noisy_frame_phase(dev, tmp, args.profile)
        tk = train_kernel_phase(dev)
        tks = train_kernel_phase(dev, small=True)
        pk = paper_mlp_kernel_phase(dev)
        ds = _train_dataset()
        ts = train_step_phase(dev, ds)
        tr = train_phase(dev, ds, tmp, args.profile, card)
        wt = window_train_phase(dev, ds, tmp, args.profile, card)
        ev = eval_phase(dev, tmp, card)
        me = metrics_phase(ev)
        qu = quality_phase(dev, tmp, ev, me, card)
        su = supervised_train_phase(dev, tmp, ev["dataset"], card)
        oc = occupancy_serve_phase(dev, ds, tr["checkpoint"])
        st = train_phase(dev, ds, tmp, False, card, SYNTH512_SMALLER, PAPER_TRAIN_STEPS,
                         "smaller_train")
        cs = train_step_phase(dev, ds, SYNTH512_PAPER_COARSE, "coarse_train")
        ct = train_phase(dev, ds, tmp, args.profile, card, SYNTH512_PAPER_COARSE,
                         PAPER_TRAIN_STEPS, "coarse_train")
        fk = flex_kernel_phase(dev)
        du = flex_dead_units_phase(dev)
        fs = flex_serve_phase(dev, tmp, args.profile)
        ft = flex_train_phase(dev, ds, tmp, args.profile, card)

    errs = [v for r in (k, ks) for errs in r["err"].values() for key, v in errs.items()
            if key in ("rgb", "acc", "bg_weight", "weights")]
    k2_bound = [_bound_ms(KERNEL_RAYS * S * K2_FLOP_PER_SAMPLE, _k2_bytes(KERNEL_RAYS, S, w))[0]
                for S, w in ((64, True), (128, False))]
    k1_bound = [tk["bound"][p][0] for p in ("coarse", "fine")]
    # window_train: the wrappers' calls from the host, and the kernels' runs
    # on the card that torch.profiler read (the graph replays' among them)
    wt_k1 = sum(r[m]["K1"] for r in wt["launches"].values() for m in r)
    wt_k1_runs = sum(r[m]["train_pass_kernel"] for r in wt["runs"].values() for m in r)
    wt_k2_runs = sum(r[m]["render_kernel"] for r in wt["runs"].values() for m in r)
    # the coarse-only training pass: 2048 rays at S = 64, the paper model
    k3 = "paper_64"
    kernels = {"kernels": [
        {
            "name": "fused_paper_render",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_paper_render.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_mlp.py:652",
            "modes": ["paper", "small"],
            # the frames of the four serving paths and of the eval entry point
            "launches": s["launches"] + ss["launches"] + fe["launches"] + oc["launches"]
            + sum(m["launches"] for m in ev["modes"].values()) + su["launches"]["K2"],
            "launches_by_path": {"serve": s["launches"], "smaller_serve": ss["launches"],
                                 "fast_serve": fe["launches"],
                                 "occupancy_serve": oc["launches"],
                                 **{f"eval_{k}": m["launches"] for k, m in ev["modes"].items()},
                                 "train": tr["launches"]["K2"],
                                 "window_train": sum(r[m]["K2"] for r in wt["launches"].values()
                                                     for m in r),
                                 "smaller_train": st["launches"]["K2"],
                                 "coarse_train": ct["launches"]["K2"],
                                 "supervised_train": su["launches"]["K2"]},
            "kernel_runs_by_path": {"window_train": wt_k2_runs, "eval_parity": ev["runs"]},
            "max_abs_err": max(errs),
            # one coarse (S=64, weights) + one fine (S=128) call on 4096 rays
            "ms": k["ms"]["coarse"] + k["ms"]["fine"],
            "plain_ms": k["plain_ms"]["coarse"] + k["plain_ms"]["fine"],
            "bound_ms": sum(k2_bound),
            "bound_by": "operations",
            "library_ms": None,
            "ms_by_pass": k["ms"],
            "plain_ms_by_pass": k["plain_ms"],
            "tile_ms_by_pass": k["tile_ms"],  # 65536 rays
            "small_ms_by_pass": ks["ms"],
            "small_plain_ms_by_pass": ks["plain_ms"],
            "small_tile_ms_by_pass": ks["tile_ms"],
            # the C entry alone, conditioning folded beforehand (4096 rays and the tile)
            "launch_ms_by_pass": k["launch_ms"],
            "small_launch_ms_by_pass": ks["launch_ms"],
            "tile_bound_ms_by_pass": {p: _bound_ms(TILE_RAYS * S * K2_FLOP_PER_SAMPLE,
                                                   _k2_bytes(TILE_RAYS, S, S == 64))[0]
                                      for p, S in (("coarse", 64), ("fine", 128))},
            "design": K2_DESIGN,
            "frame_ms_512": s["frame_ms"],
            "smaller_frame_ms_512": ss["frame_ms"],
            "fast_frame_ms_512": {"fast": fe["fast_ms"], "parity": fe["parity_ms"]},
            "occupancy_frame_ms_512": {"fast": oc["fast_ms"], "parity": oc["parity_ms"]},
            # cli/eval.py's summaries (bf16, 5 test frames of 512²) and the
            # quality of 300 bf16 / f32 train steps (mean test PSNR, dB)
            "eval_summary_512": {k: m["summary"] for k, m in ev["modes"].items()},
            "eval_vs_f32_levels": ev["vs_f32"],
            "eval_psnr": {k: v["PSNR"] for k, v in me.items()},
            "quality_psnr": {run: {w: v["PSNR"] for w, v in sc.items()}
                             for run, sc in qu["scores"].items()},
            "quality_ssim": {run: {w: v["SSIM"] for w, v in sc.items()}
                             for run, sc in qu["scores"].items()},
            "card": card,
        },
        {
            "name": "fused_train_pass",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_train_pass.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_train.py:69",
            "modes": ["paper", "small"],
            "launches": tr["launches"]["K1"] + st["launches"]["K1"] + wt_k1
            + ev["train"]["launches"]["K1"] + su["launches"]["K1"],
            "launches_by_path": {"train": tr["launches"]["K1"],
                                 "smaller_train": st["launches"]["K1"],
                                 "window_train": wt_k1,
                                 "eval_train": ev["train"]["launches"]["K1"],
                                 "supervised_train": su["launches"]["K1"]},
            "kernel_runs_by_path": {"window_train": wt_k1_runs},
            "max_abs_err": max(v for r in (tk, tks) for e in r["err"].values() for v in e.values()),
            # a train step's two passes: coarse (S=64) + fine (S=128), 2048 rays
            "ms": tk["ms"]["coarse"] + tk["ms"]["fine"],
            "plain_ms": tk["plain_ms"]["coarse"] + tk["plain_ms"]["fine"],
            "bound_ms": sum(k1_bound),
            "bound_by": "operations" if all(tk["bound"][p][1] == "operations"
                                            for p in ("coarse", "fine")) else "bytes",
            "library_ms": None,  # no single PyTorch call computes it
            "ms_by_pass": tk["ms"],
            "plain_ms_by_pass": tk["plain_ms"],
            # the C entry alone, operands packed beforehand, and its kernels' device ms
            "bare_ms_by_pass": tk["bare_ms"],
            "launch_split_by_pass": tk["split"],
            "small_bare_ms_by_pass": tks["bare_ms"],
            "small_launch_split_by_pass": tks["split"],
            "worst_grad_rel": tk["grad_rel"],
            "small_ms_by_pass": tks["ms"],
            "small_plain_ms_by_pass": tks["plain_ms"],
            "small_bound_ms_by_pass": {p: tks["bound"][p][0] for p in tks["bound"]},
            "small_worst_grad_rel": tks["grad_rel"],
            "train_step_ms": tr["step_ms"],
            "train_rays_s": tr["rays_s"],
            # the steady per-step ms of the execution window and of the same
            # step body one step at a time, and the device idle share of a
            # window (with --profile)
            "window_step_ms": wt["step_ms"],
            "window_device_idle": wt["idle"],
            # the host feed's draw a batch on the host's CPU, native and numpy,
            # and the device feed's top-k alone
            "feed_batch_ms": wt["feed_batch_ms"],
            "device_feed_topk_ms": wt["topk_ms"],
            # the supervised run: where SIGTERM hit, the resume point, and a
            # save's ms on the training thread, async submit vs synchronous
            "supervised": {k: su[k] for k in ("sigterm_after", "resumed_from", "save_ms",
                                             "ckpt_mb", "whole_s", "supervised_s", "phase_s")},
            "feed_rows_s": wt["feed_rows_s"],
            "smaller_train_step_ms": st["step_ms"],
            "step_vs_f32": ts,
            "card": card,
        },
        {
            "name": "fused_paper_mlp_fwd",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_paper_mlp.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_mlp.py:234",
            "modes": ["paper", "small"],
            # the paths through K3f: coarse-only training and the σ-noise frame
            "launches": ct["launches"]["K3f"] + nf["launches"],
            "launches_by_path": {"coarse_train": ct["launches"]["K3f"],
                                 "noisy_frame": nf["launches"]},
            "max_abs_err": pk["abs_err"],  # of raw rgb and σ, all cases
            "max_rel_err": pk["err"],  # relative to max|plain| per case
            # the coarse-only training pass: 2048 rays at S = 64
            "ms": pk["ms"][k3],
            "plain_ms": pk["plain_ms"][k3],
            "bound_ms": pk["bound"][k3][0],
            "bound_by": pk["bound"][k3][1],
            "library_ms": None,  # no single PyTorch call computes it
            "ms_by_case": pk["ms"],
            "plain_ms_by_case": pk["plain_ms"],
            "bound_ms_by_case": {c: b[0] for c, b in pk["bound"].items()},
            # the C entry alone, operands packed beforehand
            "bare_ms_by_case": pk["bare_ms"],
            "tflops_bare_by_case": {c: TRAIN_RAYS * int(c.split("_")[1])
                                    * paper_flop_per_sample(c.startswith("small"), False) / ms / 1e9
                                    for c, ms in pk["bare_ms"].items()},
            "tile_ms_by_case": pk["tile_ms"],  # 65536 rays
            "tile_bare_ms_by_case": pk["tile_bare_ms"],
            "tile_bound_ms_by_case": {c: b[0] for c, b in pk["tile_bound"].items()},
            "vs_k2_max_err": pk["k2_cross"],
            "design": K3F_DESIGN,
            "noisy_frame_ms_512": nf["frame_ms"],
            "card": card,
        },
        {
            "name": "fused_paper_mlp_bwd",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_paper_mlp.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_mlp.py:333",
            "modes": ["paper", "small"],
            "launches": ct["launches"]["K3b"],
            "max_abs_err": pk["grad_abs_err"],  # over every gradient tensor
            "worst_grad_rel": pk["grad_rel"],  # (max error, norm error) per case
            "ms": pk["bwd_ms"][k3],
            "plain_ms": pk["bwd_plain_ms"][k3],
            "bound_ms": pk["bwd_bound"][k3][0],
            "bound_by": pk["bwd_bound"][k3][1],
            "library_ms": None,  # no single PyTorch call computes it
            "ms_by_case": pk["bwd_ms"],
            "plain_ms_by_case": pk["bwd_plain_ms"],
            "bare_ms_by_case": pk["bwd_bare_ms"],
            "launch_split_by_case": pk["bwd_split"],
            "bound_ms_by_case": {c: b[0] for c, b in pk["bwd_bound"].items()},
            "coarse_train_step_ms": ct["step_ms"],
            "step_vs_f32": cs,
            "card": card,
        },
        {
            "name": "fused_flex_fwd",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_flex.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_flex.py:131",
            # the flex paths: served frames + training (steps and validation)
            "launches": fs["launches"] + ft["k4f_launches"],
            "launches_by_path": {"flex_serve": fs["launches"], "flex_train": ft["k4f_launches"]},
            "max_abs_err": fk["abs_err"],  # of raw rgb and σ, all cases
            "max_rel_err": fk["err"],  # relative to max|plain| per case
            # a train step's two passes at 2048 rays: coarse (S=64) + fine (S=128)
            "ms": fk["ms"]["coarse"] + fk["ms"]["fine"],
            "plain_ms": fk["plain_ms"]["coarse"] + fk["plain_ms"]["fine"],
            "bound_ms": fk["bound"]["coarse"][0] + fk["bound"]["fine"][0],
            "bound_by": "operations" if all(fk["bound"][p][1] == "operations"
                                            for p in ("coarse", "fine")) else "bytes",
            "library_ms": None,  # no single PyTorch call computes it
            "ms_by_pass": fk["ms"],
            "tile_ms_by_pass": fk["tile_ms"],  # 65536 rays
            # the C entry alone, operands packed beforehand (2048 rays and the tiles)
            "bare_ms_by_pass": fk["bare_ms"],
            "design": K4F_DESIGN,
            "frame_ms_512": fs["frame_ms"],
            "card": card,
        },
        {
            "name": "fused_flex_bwd",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_flex.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_flex.py:143",
            "launches": ft["k4b_launches"],
            "max_abs_err": fk["grad_abs_err"],  # over every gradient tensor
            "worst_grad_rel": fk["grad_rel"],  # (max error, norm error) per pass
            "ms": fk["bwd_ms"]["coarse"] + fk["bwd_ms"]["fine"],
            "plain_ms": fk["bwd_plain_ms"]["coarse"] + fk["bwd_plain_ms"]["fine"],
            "bound_ms": fk["bwd_bound"]["coarse"][0] + fk["bwd_bound"]["fine"][0],
            "bound_by": "operations" if all(fk["bwd_bound"][p][1] == "operations"
                                            for p in ("coarse", "fine")) else "bytes",
            "library_ms": None,  # no single PyTorch call computes it
            "ms_by_pass": fk["bwd_ms"],
            # the C entry alone, and its launches' device ms beside their
            # operations bound and, apart, their workspace byte floor
            "bare_ms_by_pass": fk["bwd_bare_ms"],
            "launch_split_by_pass": fk["bwd_split"],
            # K4f + K4b passes on the two cases with a dead warpgroup, each
            # bit for bit the first pass
            "dead_unit_passes": du,
            "design": K4B_DESIGN,
            "train_step_ms": ft["step_ms"],
            "train_rays_s": ft["rays_s"],
            "card": card,
        },
        {
            "name": "fused_resample",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_resample.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_mlp.py:837",
            "regimes": ["general", "sorted_u"],
            # its own entry point, as in the JAX package: nothing renders through it
            "launches": rk["launches"],
            "launches_by_path": {"resample_kernel": rk["launches"]},
            "max_abs_err": rk["max_abs_err"],
            "err_by_case": rk["err"],
            # a 65536-ray serve tile, 64 + 64 samples, general draws
            "ms": rk["ms"][f"general_{TILE_RAYS}"],
            "plain_ms": rk["plain_ms"][f"general_{TILE_RAYS}"],
            "bound_ms": rk["bound"][f"general_{TILE_RAYS}"][0],
            "bound_by": rk["bound"][f"general_{TILE_RAYS}"][1],
            "library_ms": None,  # no single PyTorch call computes it
            "ms_by_case": rk["ms"],
            "bare_ms_by_case": rk["bare_ms"],  # the C entry into a preallocated output
            "device_ms_by_case": rk["device_ms"],  # the bare launch's device time
            "device_ms_read_by": rk["device_by"],  # torch.profiler, or queued CUDA events
            "gb_s_device_by_case": rk["gb_s"],
            "plain_ms_by_case": rk["plain_ms"],
            "bound_ms_by_case": {c: b[0] for c, b in rk["bound"].items()},
            "design": K5_DESIGN,
            "card": card,
        },
        _probe_entry(pr["P2"], "chain_overlap", "twochain",
                     "tools/perf/chain_overlap_probe.py:119", card),
        _probe_entry(pr["P1"], "encoder_concat", "packed",
                     "tools/perf/encoder_concat_probe.py:77", card),
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
