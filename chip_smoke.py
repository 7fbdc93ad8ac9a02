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
               build/nerface_tpu_torch/ (K1, K3 and K4 as two builds each:
               the fixed layout classes S = 64 / 128 and the runtime class
               of every other S; K4 at h = 768 and at 1024 a build each
               besides), all eleven started together and done before the
               first timed phase; prints the seconds (the flex builds' on
               the summary line) and each kernel's ptxas registers, spills
               and shared memory.
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
               Then the long regime (Sc + Sf past 256, up to 1024):
               Sc ∈ {3, 64, 320, 1000} × Sf ∈ {1, 192, 700, 1021} within
               Sc + Sf ≤ 1024 on 2072 rays, both regimes, within
               RESAMPLE_TOL of the plain version, rows sorted,
               bit-identical, ms, plain ms and bound; a 65536-ray tile at
               64 + 256 in both regimes timed as the 64 + 64 tile. The
               path drive counts 4 launches: 64 + 64 and 64 + 256, each
               regime.
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
               off the background and a std of ≥ 10 levels). Then the TCP
               front end: `serve_tcp` on port 0 in a thread (the bound port
               read from the line it prints), one `AvatarClient` ping and
               render, its rgb equal to `handle()`'s for the same request,
               stop.
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
               dataset written to disk (EVAL_SPLIT: 8 train, 2 val, 5
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
     reenact — the cross-actor reenactment path: `tools/reenactment_demo.py`'s
               `main` at REENACT_SIZE = 128² (where the paper's 2048 rays
               and 64 + 64 samples hold), REENACT_FRAMES = 60 frames a
               synthetic tracker identity, REENACT_ITERS = 2000 bf16 steps
               on the card (configs/synth512_paper.yml with the JAX demo's
               overrides: the device feed, K = 50): two tracker
               identities, `build_dataset`, `train`, the self-reenactment
               evaluation and metrics, the driven evaluation, the triptych
               AVI. The wrappers' counts are reset at each stage's start
               and read at its end: K1 > 0 in training, K2 > 0 in each
               evaluation, K3 never. Checks: the summary's PSNR / SSIM / L1
               finite, `temporal_std` > 1, the AVI's 60 frames; then
               REENACT_F32_FRAMES = 2 driven frames of the f32 plain path
               against the bf16 ones (FRAME_MAX / FRAME_MEAN),
               `cli/build_dataset.py --mode driven` writing the demo's
               transforms_test.json, and the self-reenactment PSNR
               ≥ QUALITY_GAIN_DB above the untrained avatar's
               (checkpoint00001) on the same 10 frames. Prints the
               tracker, dataset build, training and evaluation seconds,
               each evaluation's avg_time_per_image, and the steady
               windowed step (the median ms a step between the loop's
               print lines after the first).
     reenact_64 — the same demo at 64² (512 rays, 16 + 16 samples: K1 and
               K2 at S = 16 and 32), then REENACT_WINDOW_STEPS steps of its
               config windowed against step at a time, bit for bit; in
               both, no bf16 paper pass on the plain path
               (`plain_paper_passes`, counted at the dispatch).
     sample_counts — K2, K3f, K1 and K3b of the paper model, and K4f and
               K4b of synth512_lcode's trunk (3 hidden layers), at every
               (S, rays) of SAMPLE_CASES: every layout class at 2048 rays,
               and S = 1 and the padded layouts S = 5 / 40 / 200 at a
               ray count that cuts the last item short, against their
               plain versions (K2 with a background and with none;
               SAMPLE_SEEDS = 1 seed for the others; K1 /
               K3b / K4b bit-identical over 2
               launches; each reading within its base limit ([flex_kernel]'s
               for K4) or FLEX_TC_FACTOR × the plain version's own on the
               tensor cores, and a lost 64-row unit caught by the limits
               applied wherever the base limits catch it; Σ d_dir against
               d_bd0), each kernel's ms, plain ms and bound per S, and K4's
               ms against S / 64 × its S = 64 time; then K5 at Sc ∈ {3, 16,
               24, 48, 96, 200} × Sf ∈ {1, 33, 56} (Sc + Sf ≤ 256), both
               regimes, on 2072 rays: within K5_GRID_TOL = 2e-6 of its plain
               version, rows sorted, bit-identical, ms, plain ms, bound.
               K4f / K4b also at hidden 512 (synth512_lcode_w512's trunk)
               for FLEX_W512_SAMPLE_CASES (S = 1 on 2072 rays, 24 / 192 /
               256 on 2048), the same limits and lost-unit control.
     xyz_bands — K2, K3f, K1 and K3b of the paper model, and K4f / K4b
               of synth512_lcode's trunk at hidden 256 and 512, at 11, 16
               and 20 xyz encoding bands (a K = 128 encoding, the kernels'
               runtime layout class) and at 10 (the control, K = 64), at S
               = 64, 128 and 48 on 2048 rays and 48 on 2072 (XYZ_CASES), one
               seed a case, under [sample_counts]' limits and lost-unit
               control (K4 with the tensor-core yardstick at every S),
               bit-identical over 2 launches; ms, plain ms and bound on the
               2048-ray cases, and each time against the 10-band one.
     long_rays — K2, K3f, K1 and K3b past 256 samples a ray (one ray an
               item, in up to 16 units) at S = 257, 320, 512 and 1024
               on 2048 rays and 320 / 1000 on 2072 (LONG_RAYS_CASES), one
               seed, under [sample_counts]' limits, K2 / K3f's lost unit
               caught; K1's and K3b's dW launch within DW_EXACT_TOL of the
               f64 Xᵀ·gY of their own workspace images, and a lost 64-row
               unit past it in every product (`dw_exact`, also run on every
               K1 / K3b pass of sample_counts); ms through the wrapper and
               bare, plain ms and bound; then K3b at 2048 × S = 128, 320
               and 1024 with a lost unit, DW_EXACT_SEEDS seeds each: the
               seeds whose lost unit `k3b_grad_limits` catch, and the exact
               check's (all).
     serve_64_128 — synth512_paper at 64 + 128 samples served as in phase
               4: K2 at S = 64 and 192, the frame against the f32 plain
               frame.
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
     ddp_train — data parallelism (train/distributed.py) on the eval
               dataset: (a) NCCL at world 1 through `cli/train.py
               --coordinator-address`, DDP_STEPS steps of synth512_devfeed
               at K = DDP_K (the all-reduce captured in the step's graph)
               and at K = 1, each checkpoint and printed line bit for bit
               the no-group run's, K1's and the NCCL kernels' runs from
               torch.profiler, the steady windowed step with and without
               the group in turns; (b) gloo at world 2 with both ranks on
               the card: DDP_GLOO_STEPS host-feed steps of `train()` in
               each spawned rank (K1 2 × steps a rank), the ranks bit for
               bit equal, and one DP step's gradients against the
               one-process step's within `_k1_dp_limits`; (c) NCCL at
               world min(device_count, 4) through `--num-devices` where the
               host has 2 cards or more, else one line saying so.
     sharded_serve — `AvatarServer(devices=[cuda:0] × 2)` on the eval
               phase's checkpoint, bf16, parity and fast: every map's
               floats and the served uint8 maps bit for bit the one-device
               server's (fast: outside the extra spare slots that JAX's
               capacity rule gives two devices), K2 2 × tiles a frame, the
               frame ms beside the one-device frame's; `evaluate(devices=
               ...)` over 2 test frames, the PNGs byte for byte.
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
     pe16    — synth512_pe16 (SYNTH512_PE16: synth512_paper with 16 xyz
               bands in both models) through the paper kernels at K = 128,
               no bf16 pass on the plain path: SERVE_FRAMES served 512²
               frames through K2 and one at σ-noise 0.1 through K3f, each within
               PE16_PLAIN_FRAME_* of the same frame through the kernel's
               plain version and within PE16_FRAME_* of f32 (no bf16 path
               holds [serve]'s limits at 16 bands: the plain version's own
               frame reads the same); a bf16 step through
               K1 against f32; PAPER_TRAIN_STEPS steps (the loss falls) and
               the steady step; 20 steps windowed against step at a time,
               bit for bit; the coarse-only variant's step against f32 and
               PAPER_TRAIN_STEPS steps through K3f / K3b.
     paper_64_256 — the same for synth512_paper_64_256 (64 + 256
               samples: K2 / K1 at S = 64 and 320, a long item) at 10
               bands (one σ-noise frame): the frames within
               PE16_PLAIN_FRAME_* of the plain version and within [serve]'s
               FRAME_MEAN / FRAME_MAX of f32; the coarse-only variant at
               num_coarse 320 (K3f / K3b at S = 320).
  8. flex_kernel — K4f `fused_flex_forward` and K4b `fused_flex_backward`
               (csrc/fused_flex.cu) against their plain versions on
               synth512_lcode's He-scaled weights, FLEX_SEEDS draws a case
               (FLEX_CASES): R = 2048 at S = 64 and 128 (forward and
               backward), one 65536-ray tile at each (forward), and the
               same model at 0 and 8 hidden layers at R = 2048, S = 32 and
               at 12 on 512 × 32; at hidden 512 (the kernels'
               `wide_chain_kernel` / `wide_dx_kernel`) R = 2048 at S = 64
               and 128, and 10 hidden layers on 512 × 32. Raw
               rgb and σ within FLEX_OUT_TOL of their max; every gradient
               tensor, d_v0 and d_dir within `k1_grad_limits` (from 8 hidden
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
               passes of 2085 × 64, 601 × 128, and at the runtime layouts
               2133 × 24 and 267 × 200 (their last round leaves
               warpgroup 1 past the last ray: the dead-unit walk of K4b's
               recompute and dX, `fused_flex.cu::skip_stages`), every
               pass's output and gradients equal to the first pass's bit
               for bit; passes and wall time; then the same at hidden 512
               on 2085 × 64 (a persistent grid past one round, the last
               round cut short), and at hidden 1024 (the sliced kernels,
               DEAD_UNIT_SLICED_PASSES passes). A fault fails the run.
     flex_long_rays — K4f and K4b past 256 samples a ray (one ray an item
               in up to 16 units) at hidden 256 and 512, S = 257, 320, 512
               and 1024 on 2048 rays and 320 / 1000 on 2072
               (FLEX_LONG_CASES), one seed, under [sample_counts]' limits
               and lost-unit control (the tensor-core yardstick at every
               S), K4b bit-identical over 2 launches; wrapper, bare, plain
               and bound ms on the 2048-ray cases; FLEX_LONG_DEAD_PASSES
               passes of 2071 × 320 at 8 hidden layers (a dead long item:
               the dead-unit walk), each bit for bit the first; then K4b at
               2048 × S = 128, 320 and 1024, both widths, with a lost unit,
               DW_EXACT_SEEDS seeds each: the seeds whose lost unit
               `flex_grad_limits` catch, and those the exact dW check
               (`flex_dw_exact`: the dW launch within DW_EXACT_TOL of the
               f64 Xᵀ·gY of its own workspace images) catches (all).
     flex_widths — K4f and K4b at hidden 768 and 1024 (the sliced
               kernels) on FLEX_SLICED_CASES: 2048 rays at S = 64, 128, 48
               and 320, 2072 at S = 40, 16 bands at S = 64, 0 and 8 hidden
               layers, and at 1024 S = 1024 on 256 rays; each under
               `flex_limit` / `flex_grad_limits` through the tensor-core
               yardstick (`flex_yardstick`), K4b bit-identical over 2
               launches, its dW launch held to the f64 Xᵀ·gY of its own
               images with a lost unit caught (`flex_dw_exact`, which holds
               that launch where the yardstick's limits would pass a lost
               unit); wrapper, bare, plain and bound ms of the timed cases;
               then K4b at 2048 × S = 128, h = 1024, with a lost unit,
               FLEX_SLICED_DW_SEEDS seeds, the exact check catching it.
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
     flex_64_128 — synth512_lcode at the NeRF paper's 64 + 128 samples
               (SYNTH512_LCODE_64_128: K4 at S = 64 and, through the
               runtime layout class, 192): SERVE_FRAMES frames of 512² served via
               serve_jsonl (K4f 2 × tiles a frame), each within
               FLEX_FRAME_MAX / FLEX_PLAIN_FRAME_MEAN of the same frame
               through K4f's plain version and within FRAME_MAX /
               FRAME_MEAN of the f32 plain frame; one
               bf16 step against the f32 plain step ([train_step]'s
               limits); FLEX_TRAIN_STEPS steps of `train()` (K4f / K4b
               counted, the printed loss falling), then the steady step's
               ms beside the frame's; 20 steps windowed (K = 10) against
               step at a time, bit for bit; no bf16 Flexible pass on the
               plain path anywhere in the phase (`plain_flex_passes`,
               counted at the dispatch).
     flex_w512 — the same for synth512_lcode_w512 (SYNTH512_LCODE_W512:
               hidden_size 512 in both models, 64 + 64): every bf16 pass
               through K4f / K4b's h = 512 kernels; the frames against
               f32 within FLEX_W512_FRAME_MEAN.
     flex_pe16 — the same for synth512_lcode_pe16 (SYNTH512_LCODE_PE16:
               16 xyz bands in both models, dim_xyz 99, 64 + 64): every
               bf16 pass through K4f / K4b at a K = 128 encoding (the
               runtime layout class), none on the plain path; the frames
               against K4f's plain version within PE16_PLAIN_FRAME_* and
               against f32 within PE16_FRAME_* ([pe16]'s: at 16 bands bf16
               itself moves a frame off f32).
     flex_64_256 — the same for synth512_lcode_64_256
               (SYNTH512_LCODE_64_256: 64 + 256 samples, K4 at S = 64 and,
               a long item, 320) with [flex_64_128]'s limits; then its
               hidden-512 variant (SYNTH512_LCODE_64_256_W512) served, one
               frame against K4f's plain version and f32 (the latter
               within FLEX_W512_FRAME_MEAN), and one bf16 step against f32.
     flex_w1024 — the same for synth512_lcode_w1024 (SYNTH512_LCODE_W1024:
               hidden_size 1024 in both models, mip-NeRF 360's NeRF MLP
               width, 64 + 64): every bf16 pass through the sliced kernels;
               one served frame, held to K4f's plain version within
               FLEX_PLAIN_FRAME_MEAN / FLEX_FRAME_MAX through the
               tensor-core yardstick and to f32 within the plain version's
               own distance + FLEX_SLICED_F32_MARGIN (mean) and FRAME_MAX;
               a frame the yardstick decided, rendered again through two
               wrong K4f (FLEX_FRAME_FAULTS: a lost 64-row unit a launch,
               a partial sum a layer parked in bf16), must fail its limits.
     flex_w768 — its 768-wide variant (SYNTH512_LCODE_W768): one frame
               within the same limits, one bf16 step against f32.
 11. stock_eval — `cli/eval_nerf.py` at the NeRF paper's stock settings
               (PaperNeRFModel coarse and fine, 10 xyz / 4 direction bands,
               64 + 128 samples, f32; He-scaled random weights, σ biased up
               by SIGMA_BIAS, saved as a reference-schema .ckpt) over
               STOCK_FRAMES render poses of a blender scene written at 800²
               and read with half_res (400², near 2, far 6) and of a
               forward-facing LLFF scene at fern's 378 × 504 (its
               `images_8/` present), rendered through NDC. Checks: K1–K5
               launched 0 times, and 0 hand-kernel runs among the card's
               kernels under torch.profiler (the JAX package's gate: no
               kernel takes a stock model); each frame's STOCK_CHECK_RAYS =
               2048 rays, spread over it, within STOCK_LEVELS = 1 uint8
               level of the port's plain path on the CPU
               (`run_one_iter_of_nerf`, NDC for LLFF) and not flat. Prints
               each frame's ms and `Avg time per image`.
 12. tiny_nerf — `examples/tiny_nerf.py` on the card on its synthetic data
               for TINY_ITERS = 300 iterations: the last loss below half
               the first (tests/test_lie_and_tools.py's criterion); the
               train loop's and the whole call's seconds, the last test
               PSNR.

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

# synth512_paper with num_fine 128 (the NeRF paper's 64 + 128 schedule):
# K2 serves each tile's coarse pass at S = 64 and its fine pass at S = 192
SYNTH512_PAPER_64_128 = copy.deepcopy(SYNTH512_PAPER)
for _mode in ("train", "validation"):
    SYNTH512_PAPER_64_128["nerf"][_mode]["num_fine"] = 128

# synth512_lcode with num_fine 128: K4f / K4b take each tile's and each
# train step's coarse pass at S = 64 (a fixed layout class) and its fine
# pass at S = 192 (the runtime class)
SYNTH512_LCODE_64_128 = copy.deepcopy(SYNTH512_LCODE)
for _mode in ("train", "validation"):
    SYNTH512_LCODE_64_128["nerf"][_mode]["num_fine"] = 128

# synth512_lcode with hidden_size 512 in both models (layers_dir.0 256
# wide): K4f / K4b's h = 512 kernels (`wide_chain_kernel`,
# `wide_dx_kernel`) take every bf16 pass
SYNTH512_LCODE_W512 = copy.deepcopy(SYNTH512_LCODE)
for _node in SYNTH512_LCODE_W512["models"].values():
    _node["hidden_size"] = 512
FLEX_WIDE = 512

# synth512_paper with 16 xyz encoding bands in both models (dim_xyz 99):
# past 10 bands the paper kernels read a K = 128 encoding (two 64-column
# blocks) in their runtime layout class at every S, K2, K3, K1 alike; and
# its coarse-only variant (K3f / K3b for every training pass)
SYNTH512_PE16 = copy.deepcopy(SYNTH512_PAPER)
for _node in SYNTH512_PE16["models"].values():
    _node["num_encoding_fn_xyz"] = 16
SYNTH512_PE16_COARSE = copy.deepcopy(SYNTH512_PAPER_COARSE)
SYNTH512_PE16_COARSE["models"]["coarse"]["num_encoding_fn_xyz"] = 16
# [pe16]'s served frames, levels of 8-bit rgb_fine (mean |diff|, max). At
# 16 bands the fine pass's depths follow the coarse weights, and the 2^15
# band turns what bf16 moves those weights into other colours: the plain
# version's own bf16 frame reads 0.29 / 4–5 from f32 (0.36–0.38 / 5–6 at
# σ-noise 0.1; on an H100 80GB HBM3), where [serve]'s 10-band frame reads
# 0.10 / 1. No bf16 path holds
# [serve]'s FRAME_MEAN / FRAME_MAX there, so a frame is held to the same
# frame through K2's (or K3f's) plain version, the kernel's own
# arithmetic, within PE16_PLAIN_FRAME_* (read 0.017–0.022 / 2: the plain
# version's f32 sums, not the kernel's, place the fine samples), and to f32
# within PE16_FRAME_*, fixed above the plain version's own readings.
PE16_PLAIN_FRAME_MEAN = 0.05
PE16_PLAIN_FRAME_MAX = 2
PE16_FRAME_MEAN = 0.45
PE16_FRAME_MAX = 7

# synth512_paper with 24 xyz encoding bands in both models (dim_xyz 147,
# xc = 3): past 20 bands the paper kernels read a K = 192 encoding (three
# 64-column blocks, the weight ring one stage shorter) in their runtime
# layout class at every S; and its coarse-only variant (K3f / K3b for every
# training pass). At 24 bands the fine pass's depths follow the coarse
# weights, and the 2^23 band turns the least difference in them into other
# colours: K2's frame read 0.40 / 12 levels from the same frame through
# its plain version (whose f32 sums differ from the kernel's), the plain
# version's own bf16 frame 2.205 / 18 from f32, on an NVIDIA H100 80GB
# HBM3 (PERF.md §6). So a frame is held to its plain version within
# PE16_PLAIN_FRAME_* through the tensor-core yardstick (`plain_yard`: no
# less than FLEX_TC_FACTOR × the plain version's own frame with its
# matmuls on the tensor cores), which each wrong kernel of
# PAPER_FRAME_FAULTS must fail, and to f32 within PE24_FRAME_*, fixed above
# the plain version's own readings (2.205 / 18, at σ-noise 0.1 2.205 / 19;
# the yardstick read 0.386 / 12 and 0.359 / 12).
SYNTH512_PE24 = copy.deepcopy(SYNTH512_PAPER)
for _node in SYNTH512_PE24["models"].values():
    _node["num_encoding_fn_xyz"] = 24
SYNTH512_PE24_COARSE = copy.deepcopy(SYNTH512_PAPER_COARSE)
SYNTH512_PE24_COARSE["models"]["coarse"]["num_encoding_fn_xyz"] = 24
PE24_FRAME_MEAN = 4.0
PE24_FRAME_MAX = 40

# synth512_lcode with 16 xyz encoding bands in both models (dim_xyz 99):
# past 10 bands K4f / K4b read a K = 128 encoding (two 64-column blocks) in
# their runtime layout class at every S. Its frames take [pe16]'s limits:
# K4f's plain version's own bf16 frame reads 0.25–0.27 / 4–5 levels from
# f32, the kernel's the same, and the kernel's frame 0.009 / 1–2 from the
# plain version's (on an H100 80GB HBM3, PERF.md §6)
SYNTH512_LCODE_PE16 = copy.deepcopy(SYNTH512_LCODE)
for _node in SYNTH512_LCODE_PE16["models"].values():
    _node["num_encoding_fn_xyz"] = 16

# synth512_paper_64_256: synth512_paper with num_fine 256 in training and
# validation, twice the NeRF paper's Nf = 128 (arXiv 2003.08934 §5.3), for
# final renders and the served avatar: each coarse pass at S = 64 (a fixed
# layout class), each fine pass at S = 320 (a long item: one ray in five
# units, K2 compositing it in two segments); and its coarse-only variant at
# num_coarse 320, which sends K3f / K3b through S = 320
SYNTH512_PAPER_64_256 = copy.deepcopy(SYNTH512_PAPER)
for _mode in ("train", "validation"):
    SYNTH512_PAPER_64_256["nerf"][_mode]["num_fine"] = 256
SYNTH512_PAPER_64_256_COARSE = copy.deepcopy(SYNTH512_PAPER_COARSE)
for _mode in ("train", "validation"):
    SYNTH512_PAPER_64_256_COARSE["nerf"][_mode]["num_coarse"] = 320

# synth512_lcode_64_256: synth512_lcode with num_fine 256 in training and
# validation (as synth512_paper_64_256), for a LearnableCode avatar's final
# renders: K4f / K4b take each coarse pass at S = 64 (a fixed layout class)
# and each fine pass at S = 320 (a long item: one ray in five units); and
# its hidden-512 variant (as synth512_lcode_w512), through
# `wide_chain_kernel` / `wide_dx_kernel`
SYNTH512_LCODE_64_256 = copy.deepcopy(SYNTH512_LCODE)
for _mode in ("train", "validation"):
    SYNTH512_LCODE_64_256["nerf"][_mode]["num_fine"] = 256
SYNTH512_LCODE_64_256_W512 = copy.deepcopy(SYNTH512_LCODE_64_256)
for _node in SYNTH512_LCODE_64_256_W512["models"].values():
    _node["hidden_size"] = 512

# synth512_lcode_w1024: synth512_lcode with hidden_size 1024 in both models
# (layers_dir.0 512 wide), the width of mip-NeRF 360's NeRF MLP (Barron et
# al., CVPR 2022, arXiv 2111.12077): every bf16 pass through K4f / K4b's
# sliced kernels (`sliced_chain_kernel`, `sliced_dx_kernel`); and its
# 768-wide variant, the one other width they take
SYNTH512_LCODE_W1024 = copy.deepcopy(SYNTH512_LCODE)
for _node in SYNTH512_LCODE_W1024["models"].values():
    _node["hidden_size"] = 1024
SYNTH512_LCODE_W768 = copy.deepcopy(SYNTH512_LCODE)
for _node in SYNTH512_LCODE_W768["models"].values():
    _node["hidden_size"] = 768
# [flex_w1024] / [flex_w768]'s served frame against the f32 plain frame:
# its mean within FLEX_SLICED_F32_MARGIN levels of the plain version's own
# frame's mean distance from f32 in the same run (the bf16 roundings' share
# at this width, not a fixed figure), its max within FRAME_MAX
FLEX_SLICED_F32_MARGIN = 0.02
FLEX_SLICED_PLAIN_CHUNK = 4096  # the plain frames' tiles: bounds their activations at h = 1024

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


def paper_flop_per_sample(small, backward, bands=10):
    """The paper MLP's operations a sample at `bands` xyz bands: the
    forward (K2, K3f) or the forward + dX + dW (K1, K3b). Each band past 10
    adds 6 input columns to layer 0 and to the skip layer, read by the
    forward and by dW (dX reads no encoded column)."""
    enc = 2 * 2 * 6 * (bands - 10) * 256
    if backward:
        return K1_FLOP_PER_SAMPLE - (3 * W5_FLOP if small else 0) + 2 * enc
    return K2_FLOP_PER_SAMPLE - (W5_FLOP if small else 0) + enc


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


def k4_flop_per_sample(n=None, h=256, backward=False, bands=10):
    """K4f's (or with `backward` K4b's: recompute, dX, dW) operations a
    sample at n hidden layers (FLEX_N_HIDDEN), width h and `bands` xyz
    bands, at the function's widths (`tools/perf/flex_launch_split.py`)."""
    from nerface_tpu_torch.tools.perf import flex_launch_split as FS

    n = FLEX_N_HIDDEN if n is None else n
    fwd = FS.flop_per_sample(FS.forward_kn(n, h, bands))
    return 2 * fwd + FS.flop_per_sample(FS.dx_kn(n, h)) if backward else fwd
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
# [flex_64_128]: the served K4f frame against the same frame rendered with
# K4f's plain version (the kernel's bf16 roundings, torch's f32 sums), in
# 8-bit levels (read 0.0024–0.0026 at 64 + 64 and 64 + 128 on an H100,
# PERF.md §6). Against the f32 frame it takes the paper family's
# FRAME_MAX / FRAME_MEAN, which [serve_64_128] holds at the same schedule:
# at 64 + 128 the plain version itself reads 0.104–0.115 levels from f32,
# past FLEX_FRAME_MEAN, the kernel's frame the same to 1e-4
FLEX_PLAIN_FRAME_MEAN = 0.01

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
# [flex_w512]'s served frame against the f32 plain frame, mean 8-bit levels:
# at hidden 512 the bf16 plain version's own frame reads 0.1520–0.1546 from
# f32 and the kernel's 0.1519–0.1546 (an H100, PERF.md §6), past FRAME_MEAN;
# the max stays FRAME_MAX
FLEX_W512_FRAME_MEAN = 0.17
# train_pass_kernel's instantiations, at most (K1 and K3b, each model, each
# layout class S = 64, 128 and any other S): the spilling kernel's nvcc
# time grows with each, and the script's build shares the 1200 s limit
TRAIN_PASS_INSTANTIATIONS = 12
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
             "16-byte stores. Past Sc + Sf = 256 (the long regime) a warp keeps the ray's rows in "
             "shared memory: the same scan order over lane runs, the same search, a bitonic sort in "
             "shared memory, the union as a merge by rank")
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
# K5 past Sc + Sf = 256 (its long regime): the grid Sc × Sf within Sc + Sf
# ≤ 1024 on SAMPLE_RAGGED_RAYS rays, both regimes, within RESAMPLE_TOL of
# the plain version; and a 65536-ray tile at 64 + 256 (synth512_lcode_64_256's
# and synth512_paper_64_256's resample) timed beside its byte bound
K5_LONG_COARSE = (3, 64, 320, 1000)
K5_LONG_FINE = (1, 192, 700, 1021)
K5_LONG_TILE = (64, 256)
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


PHASE_STARTS = {}  # a phase's name -> the time of its first line


def phase(name, text):
    PHASE_STARTS.setdefault(name, time.perf_counter())
    print(f"[{name}] {text}", flush=True)


def phase_seconds(t0):
    """Each phase's seconds from its first line to the next phase's first
    line (the time before a phase's first line counts to the one before
    it), from `t0`, the run's start."""
    starts = sorted(PHASE_STARTS.items(), key=lambda kv: kv[1]) + [("end", time.perf_counter())]
    return {"start": round(starts[0][1] - t0, 1),
            **{a[0]: round(b[1] - a[1], 1) for a, b in zip(starts, starts[1:])}}


@contextlib.contextmanager
def plain_flex_passes():
    """Counts, at the dispatch (`render.pipeline._apply_model`), the bf16
    passes of a Flexible-family model left to the model's plain forward:
    the calls in which K4f's wrapper launched nothing. Yields a list whose
    one item is the count."""
    import torch

    from nerface_tpu_torch.models.nerf_models import _FlexibleFamily
    from nerface_tpu_torch.ops.kernels.fused_flex import fused_flex_forward
    from nerface_tpu_torch.render import pipeline

    count = [0]
    dispatch = pipeline._apply_model

    def counted(model, *args):
        before = fused_flex_forward.launches
        out = dispatch(model, *args)
        if (args[-1] == torch.bfloat16 and isinstance(model, _FlexibleFamily)
                and fused_flex_forward.launches == before):
            count[0] += 1
        return out

    pipeline._apply_model = counted
    try:
        yield count
    finally:
        pipeline._apply_model = dispatch


def sliced_widths():
    """K4's widths past 512 (`fused_flex.SLICED_WIDTHS`): its sliced
    kernels, a build each."""
    from nerface_tpu_torch.ops.kernels.fused_flex import SLICED_WIDTHS

    return SLICED_WIDTHS


@contextlib.contextmanager
def flex_plain_version(tensor_cores=False):
    """K4f's wrapper replaced by its plain version (`fused_flex_forward_
    reference`, on whatever device the tensors are): a bf16 pass through it
    has K4f's roundings and torch's f32 sums, and launches nothing. With
    `tensor_cores`, its matmuls on the tensor cores (`tensor_core_plain`:
    its bf16-exact operands, another order of f32 sums), and nothing else
    of the render."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    kernel = F.fused_flex_forward
    if tensor_cores:
        F.fused_flex_forward = lambda *a, **k: tensor_core_plain(lambda: F.fused_flex_forward_reference(*a, **k))
    else:
        F.fused_flex_forward = lambda *a, **k: F.fused_flex_forward_reference(*a, **k)
    try:
        yield
    finally:
        F.fused_flex_forward = kernel


def _flex_forward_bf16_partials(weights, ro, rd, z, dir_c, v0, n_hidden, num_encoding_fn_xyz=10,
                                log_sampling_xyz=True):
    """K4f's plain version (`fused_flex_forward_reference`) with a modelled
    fault: every matmul's sum over the first half of its K rows rounded to
    bf16 before the second half is added, as a kernel would that parks a
    partial sum in bf16 (one rounding a layer: the least bf16
    accumulation)."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_flex as F

    def r(x):
        return x.to(torch.bfloat16).float()

    W = F._unpack([t.detach() for t in weights], n_hidden)
    Wr = {k: r(v.float()) for k, v in W.items() if k.startswith("w")}
    n_rays, n_samples = z.shape
    x3 = (ro[:, None, :] + rd[:, None, :] * z[:, :, None]).reshape(-1, 3)

    def dot(a, name):
        x, w = r(a), Wr[name]
        k = w.shape[0] // 2
        return r(x[:, :k] @ w[:k]) + x[:, k:] @ w[k:]

    a = dot(x3, "w1a") + dot(F._encode_points(x3, num_encoding_fn_xyz, log_sampling_xyz), "w1b") + v0
    for i in range(n_hidden):
        a = torch.relu(dot(a, f"wh{i}") + W[f"bh{i}"])
    feat = torch.relu(dot(a, "wf") + W["bf"])
    alpha = dot(a, "wa") + W["ba"]
    hd = (dot(feat, "wd0") + W["bd0"]).reshape(n_rays, n_samples, -1) + dir_c[:, None, :]
    rgb = dot(torch.relu(hd).reshape(n_rays * n_samples, -1), "wrgb") + W["brgb"]
    return torch.cat([rgb, alpha], -1).reshape(n_rays, n_samples, 4)


# the modelled wrong K4f that a frame held through the tensor-core
# yardstick must fail (`flex_planted_fault`)
FLEX_FRAME_FAULTS = ("lost_unit", "bf16_partial")


@contextlib.contextmanager
def flex_planted_fault(kind):
    """K4f's wrapper replaced by a wrong kernel of FLEX_FRAME_FAULTS:
    "lost_unit", the kernel with one 64-row unit of every launch's output
    lost (`lost_unit_rows`, zeroed); "bf16_partial", the plain version on
    the tensor cores with a partial sum parked in bf16
    (`_flex_forward_bf16_partials`)."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    kernel = F.fused_flex_forward
    if kind == "lost_unit":
        def lost(*a):
            return _without_rows(kernel(*a), lost_unit_rows(*a[3].shape))

        # the launch counts into the module's wrapper, this one: not the main path's
        lost.launches = 0
        F.fused_flex_forward = lost
    else:
        F.fused_flex_forward = lambda *a: tensor_core_plain(lambda: _flex_forward_bf16_partials(*a))
    try:
        yield
    finally:
        F.fused_flex_forward = kernel


# the modelled wrong K2 / K3f that a paper frame held through the
# tensor-core yardstick must fail (`paper_planted_fault`)
PAPER_FRAME_FAULTS = ("lost_unit", "third_block")
# the modelled faults rendered through the plain version's server (the
# others wrap the kernel)
PLAIN_SERVER_FAULTS = ("bf16_partial",)


def _third_block_zeroed(packed):
    """K2's packed weights (`PackedPaperWeights` at a K = 192 encoding) with
    the third xin block of W0 and W3 zeroed: chunk 2 of each chunk image."""
    import dataclasses

    from nerface_tpu_torch.ops.kernels import fused_mlp as K

    offs, blk = K.w_offsets(K.K_XIN_XL), 64 * K.HIDDEN
    wbuf = packed.wbuf_sm90.clone()
    for m in ("W0", "W3"):
        wbuf[offs[m] + 2 * blk:offs[m] + 3 * blk] = 0
    return dataclasses.replace(packed, wbuf_sm90=wbuf)


def _third_block_bundle(bundle, small=False):
    """A K3 / K1 bundle whose w0b / w3xb rows from K_XIN_WIDE − 3 on (the
    encoding's columns 128..191) are zeroed."""
    from nerface_tpu_torch.ops.kernels import fused_mlp as K

    names, out = _bundle_names(small), list(bundle)
    for n in ("w0b", "w3xb"):
        i = names.index(n)
        out[i] = bundle[i].clone()
        out[i][K.K_XIN_WIDE - 3:] = 0
    return out


@contextlib.contextmanager
def paper_planted_fault(kind):
    """K2's and K3f's wrappers, where the render pipeline and K3's
    autograd.Function call them, replaced by a wrong kernel of
    PAPER_FRAME_FAULTS: "lost_unit", the kernel with one 64-row unit of
    every launch lost (`lost_unit_rows`: K3f's raw rows zeroed, every map of
    K2's rays of those rows zeroed); "third_block", the kernel through
    weights whose third xin block of W0 and W3 is zeroed (a kernel that
    never reads the K = 192 image's last block). K2's launches count into
    its wrapper, which the caller reads before and after; K3f's, whose
    wrapper counts under its module name, into this one's, not the main
    path's."""
    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.render import pipeline

    k2, k3f = pipeline.fused_paper_render, K.fused_paper_mlp_forward
    if kind == "lost_unit":
        def wrong_k2(packed, ro, rd, z, *a, **k):
            out = dict(k2(packed, ro, rd, z, *a, **k))
            R, S = z.shape
            rows = lost_unit_rows(R, S)
            for name, v in out.items():
                out[name] = v.clone()
                out[name][rows.start // S:(rows.stop - 1) // S + 1] = 0
            return out

        def wrong_k3f(bundle, ro, rd, z, **k):
            return _without_rows(k3f(bundle, ro, rd, z, **k), lost_unit_rows(*z.shape))
    else:
        def wrong_k2(packed, *a, **k):
            return k2(_third_block_zeroed(packed), *a, **k)

        def wrong_k3f(bundle, *a, **k):
            return k3f(_third_block_bundle(bundle, k.get("small", False)), *a, **k)
    wrong_k3f.launches = 0
    pipeline.fused_paper_render, K.fused_paper_mlp_forward = wrong_k2, wrong_k3f
    try:
        yield
    finally:
        pipeline.fused_paper_render, K.fused_paper_mlp_forward = k2, k3f


@contextlib.contextmanager
def paper_plain_version(tensor_cores=False):
    """K2's and K3f's wrappers replaced by their plain versions
    (`fused_paper_render_reference` on the packed weights' state dict,
    `fused_paper_mlp_reference`, on whatever device the tensors are), where
    the render pipeline and K3's autograd.Function call them: a bf16 pass
    through them has the kernels' roundings and torch's f32 sums, and
    launches nothing. With `tensor_cores`, their matmuls on the tensor
    cores (`tensor_core_plain`), and nothing else of the render."""
    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.render import pipeline

    k2, k3f = pipeline.fused_paper_render, K.fused_paper_mlp_forward
    run = tensor_core_plain if tensor_cores else (lambda fn: fn())

    def plain_k2(params, *a, **k):
        state = params.params if isinstance(params, K.PackedPaperWeights) else params
        return run(lambda: K.fused_paper_render_reference(state, *a, **k))

    pipeline.fused_paper_render = plain_k2
    K.fused_paper_mlp_forward = lambda *a, **k: run(lambda: K.fused_paper_mlp_reference(*a, **k))
    try:
        yield
    finally:
        pipeline.fused_paper_render, K.fused_paper_mlp_forward = k2, k3f


@contextlib.contextmanager
def plain_paper_passes():
    """Counts, at the dispatch of every pass that no K2 call takes
    (`render.pipeline._apply_model`), the bf16 passes of a paper-family
    model left to the model's plain forward: the calls in which K3f's
    wrapper launched nothing. Yields a list whose one item is the count."""
    import torch

    from nerface_tpu_torch.ops.kernels.fused_mlp import fused_paper_mlp_forward
    from nerface_tpu_torch.render import pipeline

    count = [0]
    dispatch = pipeline._apply_model

    def counted(model, *args):
        before = fused_paper_mlp_forward.launches
        out = dispatch(model, *args)
        if (args[-1] == torch.bfloat16 and pipeline._fused_variant(model) is not None
                and fused_paper_mlp_forward.launches == before):
            count[0] += 1
        return out

    pipeline._apply_model = counted
    try:
        yield count
    finally:
        pipeline._apply_model = dispatch


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


def _flex_inputs(n_rays, n_samples, gen, dev, h=256):
    """K4's per-ray inputs (ro, rd, z, dir_contrib (R, h / 2)): at h = 256
    `_kernel_inputs`' draws, at 512 those with a 256-wide dir_contrib
    drawn after them."""
    import torch

    ro, rd, z, dc, _, _ = _kernel_inputs(n_rays, n_samples, gen, dev)
    if h != 256:
        dc = (torch.randn(n_rays, h // 2, generator=gen) * 0.3).to(dev)
    return ro, rd, z, dc


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


def _paper_model(seed, dev, small=False, bands=10):
    """A paper-family model (the smaller one with `small`) at the slice's
    widths and `bands` xyz encoding bands, its weights drawn from `seed`."""
    import torch

    from nerface_tpu_torch.models.nerf_models import (
        ConditionalBlendshapePaperNeRFModel,
        ConditionalBlendshapePaperSmallerNeRFModel,
    )

    cls = ConditionalBlendshapePaperSmallerNeRFModel if small else ConditionalBlendshapePaperNeRFModel
    return cls(num_encoding_fn_xyz=bands, num_encoding_fn_dir=4, include_input_dir=False,
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
    with plain_paper_passes() as plain:
        handled = server.serve_jsonl(io.StringIO("\n".join(map(json.dumps, requests)) + "\n"), out)
    launches = fused_paper_render.launches
    check(fused_paper_mlp_forward.launches == 0, f"{name}: serving launched K3f")
    check(plain[0] == 0, f"{name}: a bf16 pass took the plain path")
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    check(handled == len(requests) and len(replies) == len(requests), f"replies: {replies}")
    for req, rep in zip(requests, replies):
        check(rep.get("ok") is True, f"request {req} failed: {rep}")
    check(replies[0]["H"] == 512 and replies[0]["W"] == 512, f"ping: {replies[0]}")
    check(launches == 2 * tiles * n_renders,
          f"{name}: K2 launches {launches} != 2 x {tiles} tiles x {n_renders} frames")
    frame_ms = [r["frame_ms"] for r in replies if "frame_ms" in r]
    sc, sf = cfg.nerf.validation.num_coarse, cfg.nerf.validation.num_fine
    phase(name, f"{n_renders} renders of {cfg.models.coarse.type} at 512x512 via serve_jsonl "
                f"({sc} + {sf} samples: K2 at S = {sc} and {sc + sf}), frame_ms {frame_ms}, K2 "
                f"launches {launches} = 2 x {tiles} tiles x {n_renders}, no bf16 pass on the plain path")

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
    if name == "serve":
        f["client"] = _client_phase(server, name)
    return server, dict(f, launches=launches, frame_ms=frame_ms, tiles=tiles)


def _client_phase(server, name):
    """One `AvatarClient.render` over `serve_tcp` on port 0 (the bound port
    read from the line serve_tcp prints): its rgb equal to `handle()`'s for
    the same request, decoded from the same inline PNG encoding."""
    import base64
    import threading

    import numpy as np
    from PIL import Image

    from nerface_tpu_torch.client import AvatarClient

    req = {"frame": 1, "seed": 1, "maps": ["rgb_fine"]}
    log, server._log = server._log, True  # serve_tcp prints its port only when logging
    done = {}
    t = threading.Thread(target=lambda: done.setdefault("n", server.serve_tcp("127.0.0.1", 0)))
    out = io.StringIO()
    port = None
    try:
        with contextlib.redirect_stdout(out):
            t.start()
            deadline = time.time() + 60
            while port is None and t.is_alive() and time.time() < deadline:
                m = re.search(r"\[serve\] listening on 127\.0\.0\.1:(\d+)", out.getvalue())
                port = int(m.group(1)) if m else None
                time.sleep(0.02)
        check(port is not None, f"{name}: serve_tcp printed no port: {out.getvalue()!r}")
        with AvatarClient("127.0.0.1", port) as client:
            pong = client.ping()
            t0 = time.perf_counter()
            got = client.render(frame=req["frame"], seed=req["seed"], maps=tuple(req["maps"]))
            client_ms = (time.perf_counter() - t0) * 1e3
            client.stop_server()
        t.join(timeout=120)
    finally:
        server._log = log
    check(not t.is_alive() and done.get("n") == 3, f"{name}: serve_tcp handled {done}")
    rep = server.handle(dict(req, encode="png_base64"))
    want = np.asarray(Image.open(io.BytesIO(base64.b64decode(rep["maps"]["rgb_fine"]["png_base64"]))))
    check(pong["ok"] and pong["H"] == server.H and got["rgb_fine"].shape == want.shape
          and np.array_equal(got["rgb_fine"], want),
          f"{name}: the client's rgb differs from handle()'s "
          f"({got['rgb_fine'].shape} vs {want.shape})")
    phase(name, f"AvatarClient over serve_tcp on port 0 (bound {port}): ping, one render "
                f"{got['rgb_fine'].shape} in {client_ms:.1f} ms round trip (PNG included), "
                f"rgb equal to handle()'s for the same request; stop")
    return {"port": port, "round_trip_ms": client_ms}


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
                  r"wide_chain_kernel|wide_dx_kernel|sliced_chain_kernel|sliced_dx_kernel|reduce_rows|"
                  r"render_kernel|mlp_fwd_kernel|"
                  r"resample_kernel|chain_kernel|encoder_kernel)"
                  r"(?:ILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?(?:Lb([01])E)?|ILb([01])E)?", text)
    if not m:
        return text
    flag = {"resample_kernel": "sorted_u", "flex_chain_kernel": "save", "wide_chain_kernel": "save",
            "sliced_chain_kernel": "save"}.get(m.group(1), "small")
    ints = [m.group(2)] if m.group(2) else []
    if m.group(3):  # K5's draws a lane
        ints.append(f"FP={m.group(3)}")
    # K2's long-ray instantiations (`render_kernel<0, small, LONG>`)
    targs = ", ".join(ints + ([flag] if m.group(4) == "1" else []) + (["long"] if m.group(5) == "1" else []))
    if m.group(1) == "chain_kernel" and m.group(2):
        from nerface_tpu_torch.tools.perf.chain_overlap_probe import VARIANTS

        targs = VARIANTS[int(m.group(2))]
    if m.group(6) and m.group(1) == "encoder_kernel":
        targs = "split" if m.group(6) == "1" else "packed"
    elif m.group(6):  # the paper kernels: the model alone (S is a runtime value)
        targs = "small" if m.group(6) == "1" else ""
    return m.group(1) + (f"<{targs}>" if targs else "")


def _build_job(job):
    """One library build: (name, defines, library path, seconds)."""
    from nerface_tpu_torch.ops.kernels import build

    name, defines = job
    t0 = time.perf_counter()
    lib = build.build_library(name, defines)
    return name, defines, lib, time.perf_counter() - t0


def _report_build(name, defines, lib, secs):
    """A build's [build] lines: its nvcc seconds, each kernel's ptxas
    registers and spills, the wgmmas ptxas serialised (C75xx), and the
    shared memory its kernels take. Returns its train_pass_kernel
    instantiations."""
    from nerface_tpu_torch.ops.kernels import build

    label = name + (f" [{', '.join(defines)}]" if defines else "")
    log = open(str(lib) + ".log").read().splitlines()
    n_pass = sum("Compiling entry function" in x and "train_pass_kernel" in x for x in log)
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
    phase("build", f"{label}: {secs:.1f} s ({lib.name}); ptxas: {' | '.join(info)}")
    phase("build", f"{label} wgmma serialisation (ptxas C75xx): "
                   f"{' | '.join(serial) if serial else 'none reported'}")
    # every kernel's shared memory is the same at either encoding extent:
    # a warpgroup's xin bytes (K4's h = 512 CTA's) hold two 8 KB buffers
    # at K = 64 and one 16 KB buffer at K = 128
    extents = " (at K = 64 and at K = 128 alike)"
    if name == "fused_paper_render":
        smem = (ctypes.c_longlong * 1)()
        build.load_library(name, defines).nerface_fused_paper_render_shared_bytes(smem)
        phase("build", f"{label} shared memory a CTA (dynamic): render_kernel {smem[0]} B{extents}")
    if name in ("fused_train_pass", "fused_paper_mlp"):
        smem = (ctypes.c_longlong * 3)()
        k = "train" if name == "fused_train_pass" else "paper_mlp"
        getattr(build.load_library(name, defines), f"nerface_fused_{k}_shared_bytes")(smem)
        sizes = ([] if k == "train" else [f"mlp_fwd_kernel {smem[0]} B"]) + [
            f"train_pass_kernel {smem[k != 'train']} B",
            f"dw_wgmma_kernel {smem[1 + (k != 'train')]} B"]
        phase("build", f"{label} shared memory a CTA (dynamic): {', '.join(sizes)}{extents}")
    if name == "fused_flex" and defines == build.SAMPLE_CLASS_DEFINES["any"]:
        smem = (ctypes.c_longlong * 9)()
        build.load_library(name, defines).nerface_fused_flex_shared_bytes(smem)
        phase("build", f"fused_flex shared memory a CTA (dynamic): flex_chain_kernel {smem[0]} B, "
                       f"flex_dx_kernel {smem[1]} B, dw_wgmma_kernel {smem[2]} B, wide_chain_kernel "
                       f"{smem[3]} B, wide_dx_kernel {smem[4]} B, sliced_chain_kernel / sliced_dx_kernel "
                       f"{smem[5]} / {smem[6]} B at h = 768, {smem[7]} / {smem[8]} B at 1024 (of 232448)"
                       f"{extents}")
    return n_pass


def build_phase():
    """Every library, one nvcc each, all started together and all done
    before the first phase that times anything."""
    from concurrent.futures import ThreadPoolExecutor

    from nerface_tpu_torch.ops.kernels import build

    # K1's, K3's and K4's libraries build as two builds each (build.py's
    # LAYOUT_LIBRARIES and SAMPLE_CLASS_DEFINES: S = 64 / 128 and any other
    # S), K4's widths past 512 as a build each besides (`library_builds`)
    jobs = [(name, defines) for name in LIBRARIES for defines in build.library_builds(name)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(_build_job, jobs))
    wall = time.perf_counter() - t0
    n_pass = sum(_report_build(*b) for b in built)
    check(0 < n_pass <= TRAIN_PASS_INSTANTIATIONS,
          f"train_pass_kernel has {n_pass} instantiations (at most {TRAIN_PASS_INSTANTIATIONS})")
    flex = [secs for name, _, _, secs in built if name == "fused_flex"]
    phase("build", f"{len(jobs)} library builds in {wall:.1f} s of nvcc (each build's own seconds "
                   f"above, all started together); the flex builds (fixed / runtime class, h = 256 "
                   f"and 512 each; then h = {' and '.join(map(str, sliced_widths()))}) "
                   f"{' / '.join(f'{x:.1f}' for x in flex)} s; train_pass_kernel instantiations {n_pass} (at "
                   f"most {TRAIN_PASS_INSTANTIATIONS}: S = 64 / 128 fixed, 0 any other S, × model, "
                   f"× K1 / K3b)")
    return {"nvcc_s": wall, "train_pass_instantiations": n_pass,
            "nvcc_s_by_library": {name + "".join(f" {d}" for d in defines): secs
                                  for name, defines, _, secs in built}}


def _train_kernel_inputs(n_rays, n_samples, gen, dev):
    import torch

    ro, rd, z, _, cond, bg = _kernel_inputs(n_rays, n_samples, gen, dev)
    rd[:4] = rd[4:8]  # K1's rays all cross the head
    tgt = torch.rand(n_rays, 3, generator=gen).to(dev)
    noise = torch.randn(n_rays, n_samples, generator=gen).to(dev)
    pe_dir = torch.randn(n_rays, 24, generator=gen).to(dev)
    return ro, rd.contiguous(), z, tgt, bg, noise, pe_dir, cond


def _w_total(bands=10):
    """Elements of the packed weights at `bands` xyz bands."""
    from nerface_tpu_torch.ops.kernels.fused_mlp import w_offsets, xin_extent

    return w_offsets(xin_extent(bands))["TOTAL"]


def _k2_bytes(n_rays, n_samples, with_weights, bands=10):
    from nerface_tpu_torch.ops.kernels.fused_mlp import F_OFFSETS

    per_ray_in = 4 * (3 + 3 + 3 + 128 + n_samples)  # ro rd bg dir_c z
    per_ray_out = 4 * (3 + 4 + (n_samples if with_weights else 0))  # rgb, 4 maps, weights
    return n_rays * (per_ray_in + per_ray_out) + 2 * _w_total(bands) + 4 * F_OFFSETS["TOTAL"]


def _k1_bytes(n_rays, n_samples, bands=10):
    from nerface_tpu_torch.ops.kernels.fused_mlp import F_OFFSETS
    from nerface_tpu_torch.ops.kernels.fused_mlp import WT_OFFSETS

    per_ray_in = 4 * (3 + 3 + 3 + 3 + 128 + 2 * n_samples)  # ro rd target bg dir_c z noise
    per_ray_out = 4 * (3 + n_samples + 128)  # rgb, weights, d_dir
    weights = 2 * (_w_total(bands) + WT_OFFSETS["TOTAL"]) + 4 * F_OFFSETS["TOTAL"]
    grads = 4 * (_w_total(bands) + F_OFFSETS["TOTAL"])
    return n_rays * (per_ray_in + per_ray_out) + weights + grads


def _k1_params(seed, dev, small=False, bands=10):
    """He-scaled random weights of one paper-family model."""
    from nerface_tpu_torch.tools.perf.cases import he_scale

    model = _paper_model(seed, dev, small, bands)
    he_scale(model)
    return {k: v.detach() for k, v in model.named_parameters()}


def _bundle_names(small):
    from nerface_tpu_torch.ops.kernels.fused_mlp import bundle_names

    wn, bn = bundle_names(small)
    return ["cond0", "cond3", "dir"] + list(wn) + list(bn)


def _grad_readings(label, what, R, names, grads, rgrads, worst, tc_grads=None, control=None,
                   fault_grads=None, seed=0):
    """Each gradient tensor against the plain version's within
    `k1_grad_limits` (with `tc_grads`, the plain version's gradients on the
    tensor cores, within `k3b_grad_limits` of their own readings instead);
    updates `worst` (tensor -> (max, norm) relative readings) and returns
    the largest absolute error. With `control` (a list, `_sample_control`'s),
    appends each tensor's max and norm readings beside the yardstick's, the
    base limit (`k1_grad_limits`), the limit applied and `fault_grads'` (a
    modelled fault's gradients) readings."""
    import torch

    abs_err = 0.0
    for k, (name, g, r) in enumerate(zip(names, grads, rgrads)):
        g, r = g.float(), r.float()
        check(bool(torch.isfinite(g).all()), f"{label}: {what} grad {name} not finite")
        d = g - r
        e, scale = float(d.abs().max()), float(r.abs().max())
        e_norm, r_norm = float(d.norm()), float(r.norm())
        base = k1_grad_limits(R, name)
        tol, tol_norm = base
        if tc_grads is not None:
            tc_err = rel_err(tc_grads[k], r)
            tol, tol_norm = k3b_grad_limits(R, name, tc_err)
            if control is not None:
                f_err = rel_err(fault_grads[k], r) if fault_grads is not None else (None, None)
                for j, (kind, lim) in enumerate((("max", tol), ("norm", tol_norm))):
                    control.append(dict(kernel=what, name=name, seed=seed, kind=kind,
                                        value=(e / max(scale, 1e-30), e_norm / max(r_norm, 1e-30))[j],
                                        tc=tc_err[j], base=base[j], limit=lim, fault=f_err[j]))
        check(e <= tol * scale + 1e-6,
              f"{label}: {what} grad {name} max err {e} > {tol}·{scale} + 1e-6")
        check(e_norm <= tol_norm * r_norm + 1e-6,
              f"{label}: {what} grad {name} ‖err‖ {e_norm} > {tol_norm}·{r_norm} + 1e-6")
        w = worst.get(name, (0.0, 0.0))
        worst[name] = (max(w[0], e / max(scale, 1e-30)), max(w[1], e_norm / max(r_norm, 1e-30)))
        abs_err = max(abs_err, e)
    return abs_err


def split_rows(fn, bounds):
    """The device ms a call of `fn`'s kernels, each beside its operations
    bound and byte floor (`bounds`: {kernel: (flop, bytes, what)}), with
    the source of each number in the row's "source": by kernel name under
    torch.profiler ("profiler", tools/perf/k1_launch_split.py); where the
    profiler saw no device time, the whole call from CUDA events around
    calls queued behind a spin kernel ("queued events",
    tools/perf/k3f_k5_launch_split.py's `queued_ms`), one row "call"."""
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS
    from nerface_tpu_torch.tools.perf.k3f_k5_launch_split import queued_ms

    rows = KS.split_rows(fn, bounds)
    if rows:
        return {k: dict(r, source="profiler") for k, r in rows.items()}
    flop, nbytes = sum(b[0] for b in bounds.values()), sum(b[1] for b in bounds.values())
    row = KS.launch_row(queued_ms(fn, n=20), 1, flop, nbytes, "all the call's kernels")
    return {"call": dict(row, source="queued events")}


def split_text(short, row):
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS

    return f"{KS.row_text(short, row)} [{row['source']}]"


def _launch_split(name, what, fn, R, S, small, k3b=False):
    """`fn`, a bare launch of K1 or K3b (operands packed beforehand), timed
    (CUDA events), then its kernels' device ms a call (`split_rows`), each
    beside its operations bound and its byte floor. Returns (bare ms,
    {kernel: row})."""
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS

    bare = _median_ms(fn, iters=10)
    rows = split_rows(fn, KS.launch_bounds(R, S, small, k3b))
    for short, r in rows.items():
        phase(name, f"  {what} S={S} {split_text(short, r)}")
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


def _k3_bytes(n_rays, n_samples, backward, bands=10):
    """The bytes K3f / K3b must move: each input read once (rays, depths,
    dir_c, the packed weights; g and the transposed weights for K3b), each
    output written once ((R, S, 4); the gradients and d_dir for K3b)."""
    from nerface_tpu_torch.ops.kernels.fused_mlp import F_OFFSETS, WT_OFFSETS

    rays = n_rays * 4 * (3 + 3 + n_samples + 128)
    samples = n_rays * n_samples * 4 * 4  # (R, S, 4) f32: the output, or g
    weights = 2 * _w_total(bands) + 4 * F_OFFSETS["TOTAL"]
    if not backward:
        return rays + samples + weights
    grads = 4 * (_w_total(bands) + F_OFFSETS["TOTAL"]) + n_rays * 4 * 128
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


# [sample_counts]: (S, rays). Every layout class at TRAIN_RAYS rays, each
# S filling its units; S = 1 (64 rays a unit) and three layouts with
# padding rows (S = 5: 51 rays in 4 units, 1 padding row; 40: 3 rays in 2
# units, 8; 200: 1 ray in 4 units, 56) at SAMPLE_RAGGED_RAYS, whose last
# item is cut short at S = 1, 5 and 40.
SAMPLE_RAGGED_RAYS = 2072
SAMPLE_CASES = ((1, SAMPLE_RAGGED_RAYS), (5, SAMPLE_RAGGED_RAYS), (16, TRAIN_RAYS), (24, TRAIN_RAYS),
                (40, SAMPLE_RAGGED_RAYS), (48, TRAIN_RAYS), (96, TRAIN_RAYS), (192, TRAIN_RAYS),
                (200, SAMPLE_RAGGED_RAYS), (256, TRAIN_RAYS), (32, TRAIN_RAYS), (64, TRAIN_RAYS),
                (128, TRAIN_RAYS))
SAMPLE_SEEDS = 1  # one draw a case keeps the whole run inside its time limit
DIR_SUM_TOL = 1e-4  # Σ_rays d_dir against d_bd0: the same f32 cotangents summed by two routes
# K3b at the sample counts of [sample_counts], against its plain version
# with the yardstick beside it (`k3b_grad_limits`): a max reading is one
# flipped bf16 rounding of an activation under a random cotangent, which
# reads up to 2.44 × the yardstick's own (S = 5, PERF.md §6), so it passes
# within K1_GRAD_TOL_FEW_RAYS' max (sums whose flips weigh more) or
# FLEX_TC_FACTOR × the yardstick's; the norm, which flips barely move
# (0.82–1.30 × the yardstick's over every S, tensor and seed at 2048
# rays), within FLEX_TC_FACTOR × the yardstick's, and no less than
# K3B_NORM_FLOOR (f32 sums in another order: the heads' bias sums, which
# the yardstick gets exact, read ≤ 5e-7), or at fewer rays than
# TRAIN_RAYS, whose norms have fewer terms, K1_GRAD_TOL_FEW_RAYS' norm.
K3B_NORM_FLOOR = 1e-3
# the gradient tensors of the paper kernels' dW launch (csrc/paper_train.cuh
# `launch_pass`); wa and wrgb are dX's partial sums
DW_TENSORS = ("w0a", "w0b", "w1", "w2", "w3xa", "w3xb", "w3h", "w4", "w5", "wf", "wd0", "wd1", "wd2")
# K4b's dW launch's tensors at FLEX_N_HIDDEN hidden layers (`w_offsets`
# before WA: W1's two parts, the hidden layers, WF, WD0); wa and wrgb are
# dX's partial sums
FLEX_DW_TENSORS = ("w1a", "w1b", "wh0", "wh1", "wh2", "wf", "wd0")
# [sample_counts]' K4f / K4b at h = 512: S = 1 and 24 (runtime layouts, 64
# rays a unit and 8 in 3 units), 192 (one ray in 3 units) and 256 (the
# largest S), on ragged and whole ray counts
FLEX_W512_SAMPLE_CASES = ((1, SAMPLE_RAGGED_RAYS), (24, TRAIN_RAYS), (192, TRAIN_RAYS), (256, TRAIN_RAYS))
# [sample_counts]' K5 grid: (Sc, Sf) at Sc + Sf ≤ 256, both regimes, at
# SAMPLE_RAGGED_RAYS rays; weights in [0.5, 1) keep every pdf bin ≥ 1e-3
# (≥ 0.5 / 253), where the kernel agrees with the plain version to 2e-6
# (the reading there, PERF.md §6; fused_resample.py's docstring), its limit here
K5_GRID_COARSE = (3, 16, 24, 48, 96, 200)
K5_GRID_FINE = (1, 33, 56)
K5_GRID_TOL = 2e-6
# K2's maps: (base limit, relative to |plain|): abs errors, disp relative
K2_MAP_LIMITS = {"rgb": (2e-3, False), "acc": (2e-3, False), "bg_weight": (2e-3, False),
                 "weights": (2e-3, False), "depth": (2e-3 * FAR, False), "disp": (1e-2, True)}


def _dir_sum_error(grads, names):
    """K1's / K3b's d_dir summed over the rays against its bd0 gradient, the
    same masked f32 cotangents of the direction branch's first layer summed
    per column by the bias sums: max |difference| / max Σ|d_dir| a column.
    A row lost or counted twice among d_dir's pieces shows here at full
    size, bf16 roundings not at all."""
    g = dict(zip(names, grads))
    d_dir, bd0 = g["dir"].float(), g["bd0"].float().reshape(-1)
    return float((d_dir.sum(0) - bd0).abs().max() / d_dir.abs().sum(0).max().clamp_min(1e-30))


# The exact check of the paper kernels' dW launch (K1's and K3b's
# `dw_wgmma_kernel` + `reduce_rows`, csrc/wgmma_dw.cuh): each weight
# gradient against the f64 product of the kernel's own workspace images,
# dW = Xᵀ·bf16(gY), the same bf16 operands, so none of the bf16 flips
# upstream shows. What differs is the f32 accumulation: the tensor cores'
# over each of dW's row segments against f64 here, which read 0.9–1.3e-4
# of a tensor's max at 2048 × 257 / 320 and 4.4–4.9e-4 at 2048 × 1024 on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): it grows with the rows a
# segment sums. A lost 64-row unit
# moves a product by about sqrt(64 / rows) of its norm (≈ 5.5e-3 at 2048 ×
# 1024), where the limits against the plain version cannot see it past S ≈
# 128: the limit, on the max and on the norm, lies between.
DW_EXACT_TOL = 1e-3


def lost_unit_index(n_rays, n_samples):
    """The workspace unit of `lost_unit_rows`: the middle item's first."""
    from nerface_tpu_torch.ops.kernels.fused_mlp import unit_layout

    rays, units = unit_layout(n_samples)
    return (-(-n_rays // rays) // 2) * units


def _unimage(ws, offset, units, width):
    """A workspace buffer (`fused_train.workspace_image`'s bytes at byte
    `offset` of `ws`) back to its (64·units, width) bf16 matrix: group g of
    row r of a 64 × 64 block sits at slot g ^ (r % 8)."""
    import torch

    n = units * width * 64
    t = ws[offset:offset + 2 * n].view(torch.bfloat16).view(units, width // 64, 64, 8, 8)
    r = torch.arange(64, device=ws.device)[:, None]
    g = torch.arange(8, device=ws.device)[None, :]
    return t[:, :, r, g ^ (r % 8), :].permute(0, 2, 1, 3, 4).reshape(units * 64, width)


def dw_products(small, kx):
    """The dW launch's products, `launch_pass`'s `mats` (csrc/paper_train.cuh):
    (label, weight slot, its first row, X buffer, gY buffer)."""
    prods = [("w0", "W0", 0, "xin", "gh0"), ("w1", "W1", 0, "h0", "gh1"), ("w2", "W2", 0, "h1", "gh2"),
             ("w3x", "W3", 0, "xin", "gh3"), ("w3h", "W3", kx, "h2", "gh3"), ("w4", "W4", 0, "h3", "gh4"),
             ("wf", "WF", 0, "h4" if small else "h5", "gfeat"), ("wd0", "WD0", 0, "feat", "gx0"),
             ("wd1", "WD1", 0, "x0", "gx1"), ("wd2", "WD2", 0, "x1", "gx2")]
    return prods + ([] if small else [("w5", "W5", 0, "h4", "gh5")])


def dw_exact(launch, R, S, bands=10, small=False, label="", catch=True):
    """After `launch` (`k1_launch_split.k1_bare` / `k3b_bare`: its `out`
    and `ws`) ran: each product of `dw_products` held to the f64 Xᵀ·gY of
    the workspace's images (`_dw_exact_check`). Returns {product: (max,
    norm, lost-unit max, lost-unit norm)} relative readings."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.ops.kernels import fused_train as T

    torch.cuda.synchronize()
    kx = K.xin_extent(bands)
    lay = T.workspace_layout(R, S, kx)
    check(launch.ws.numel() == lay["total"],
          f"{label}: the workspace is {launch.ws.numel()} B, fused_train.workspace_layout says {lay['total']}")
    widths, offs = dict(T.ws_buffers(kx)), K.w_offsets(kx)
    prods = [(name, lay[xn][0], widths[xn], lay[gn][0], widths[gn], offs[slot] + row0 * widths[gn])
             for name, slot, row0, xn, gn in dw_products(small, kx)]
    return _dw_exact_check(launch, prods, T.workspace_geometry(R, S)[0], lost_unit_index(R, S), label, catch)


def _dw_exact_check(launch, prods, units, lost, label, catch, chunk=2048):
    """Each product (name, X's byte offset in `launch.ws`, its width, gY's
    offset, its width, the first element of its (X width, gY width) block
    of `launch.out["dw"]`) against the f64 Xᵀ·gY of the workspace's images
    (summed over `chunk` units at a time: an image of 2M rows at 2048 × 1024
    would not fit in f64 beside the workspace), within DW_EXACT_TOL of the
    tensor's max (and of its norm), and what the product reads without the
    workspace unit `lost`, which with `catch` must lie past the limit in
    every product the unit adds to (K3b's and K4b's cotangents are random;
    K1's, from the compositing, can be all but 0 on a ray's first unit in
    empty space, and at S = 1, whose one sample is the background's, every
    gradient is). Returns {product: (max, norm, lost-unit max, lost-unit
    norm)} relative readings."""
    import torch

    dw = launch.out["dw"]
    out = {}
    for name, ox, wx, og, wg, o in prods:
        ref = torch.zeros(wx, wg, dtype=torch.float64, device=dw.device)
        unit = None
        for u0 in range(0, units, chunk):
            u1 = min(units, u0 + chunk)
            x = _unimage(launch.ws, ox + u0 * wx * 128, u1 - u0, wx).double()
            g = _unimage(launch.ws, og + u0 * wg * 128, u1 - u0, wg).double()
            ref += x.T @ g
            if u0 <= lost < u1:
                rows = slice(64 * (lost - u0), 64 * (lost - u0) + 64)
                unit = x[rows].T @ g[rows]  # what losing the unit takes away
            del x, g
        got = dw[o:o + wx * wg].view(wx, wg).double()
        scale, norm = float(ref.abs().max()), float(ref.norm())
        out[name] = tuple(v / max(d, 1e-300) for v, d in (
            (float((got - ref).abs().max()), scale), (float((got - ref).norm()), norm),
            (float(unit.abs().max()), scale), (float(unit.norm()), norm)))
        e, e_norm, f, f_norm = out[name]
        check(e <= DW_EXACT_TOL and e_norm <= DW_EXACT_TOL,
              f"{label}: dW {name} {e:.3g}·max, {e_norm:.3g}·‖r‖ off Xᵀ·gY of its own images (limit {DW_EXACT_TOL})")
        check(not catch or max(f, f_norm) > DW_EXACT_TOL or float(unit.abs().max()) == 0.0,
              f"{label}: a lost unit moves dW {name} by {f:.3g}·max, {f_norm:.3g}·‖r‖, inside {DW_EXACT_TOL}")
        del ref, unit, got
    return out


def _dw_exact_summary(res):
    """(worst reading, its product; least lost-unit reading (the larger of
    its max and norm readings), its product: 0 where the unit adds nothing
    to a product)."""
    worst = max(res.items(), key=lambda kv: max(kv[1][:2]))
    least = min(res.items(), key=lambda kv: max(kv[1][2:]))
    return max(worst[1][:2]), worst[0], max(least[1][2:]), least[0]


def lost_unit_rows(n_rays, n_samples):
    """The flat sample rows (ray·S + sample) of one 64-row unit of the
    paper kernels' schedule (`unit_layout`): the real rows of the middle
    item's first unit."""
    from nerface_tpu_torch.ops.kernels.fused_mlp import unit_layout

    rays, _ = unit_layout(n_samples)
    first = (-(-n_rays // rays) // 2) * rays * n_samples
    return slice(first, first + min(64, rays * n_samples, n_rays * n_samples - first))


def _without_rows(t, rows):
    """`t` (R, S, C) with the flat sample rows `rows` zeroed: a kernel that
    loses them."""
    f = t.clone().reshape(-1, t.shape[-1])
    f[rows] = 0
    return f.reshape(t.shape)


def _k2_readings(got, ref, tc, rows, S):
    """K2's maps against the plain version's: {map: (kernel, tensor cores,
    one unit lost)} readings, abs (disp relative). The lost unit's rays
    come back zero."""
    import torch

    rays = slice(rows.start // S, (rows.stop - 1) // S + 1)
    out = {}
    for k, (_, rel) in K2_MAP_LIMITS.items():
        check(bool(torch.isfinite(got[k]).all()), f"K2 S={S}: kernel {k} not finite")
        lost = ref[k].clone()
        lost[rays] = 0

        def err(a, r=ref[k], rel=rel):
            d = (a - r).abs()
            return float((d / r.abs() if rel else d).max())

        out[k] = (err(got[k]), err(tc[k]), err(lost))
    return out


def _sample_control(S, control, name="sample_counts", label=None, exact=()):
    """The readings of one S in [sample_counts] (or in phase `name`, the
    case `label`) above their base limit
    (`k1_grad_limits`, K3_OUT_TOL, [kernel]'s) and within the limit applied,
    and a modelled fault: one 64-row unit lost (`lost_unit_rows`; K2 and
    K3f outputs, K3b cotangents). Checks, seed by seed, that wherever the
    base limits catch the lost unit in a kernel's readings (K3b's and
    K4b's: their dW launch's tensors), the limits applied catch it too;
    the kernels in `exact` (K3b in [long_rays], K4b at the sliced widths)
    are printed but not held, as the exact dW check (`dw_exact`,
    `flex_dw_exact`) holds that launch instead. Returns the summary."""

    def ratio(c, key="value"):
        return c[key] / c["tc"] if c["tc"] > 0 else float("inf")

    decided = [c for c in control if c["value"] > c["base"]]
    top = max(decided, key=ratio, default=None)
    by_kernel = ", ".join(f"{k} {sum(c['kernel'] == k for c in decided)}"
                          for k in sorted({c["kernel"] for c in decided})) or "none"
    caught, missed = {}, []
    dw_tensors = {"K3b": DW_TENSORS, "K4b": FLEX_DW_TENSORS, f"K4b_{FLEX_WIDE}": FLEX_DW_TENSORS}

    def not_dw(c):  # a reading of the kernel's other launches (at the sliced widths: any depth)
        if c["kernel"] in (f"K4b_{h}" for h in sliced_widths()):
            return not c["name"].startswith("w") or c["name"] in ("wa", "wrgb")
        return c["kernel"] in dw_tensors and c["name"] not in dw_tensors[c["kernel"]]

    for c in control:
        if c.get("fault") is None or not_dw(c):
            continue
        n = caught.setdefault((c["kernel"], c["seed"]), [0, 0])
        n[0] += c["fault"] > c["base"]
        n[1] += c["fault"] > c["limit"]
    for (k, seed), (by_base, by_limit) in caught.items():
        if by_base and not by_limit and k not in exact:
            missed.append(f"{k} seed {seed}")
    cells = "; ".join(f"{k} s{seed} {b}/{a}" for (k, seed), (b, a) in sorted(caught.items()))
    label = label or f"S={S}"
    phase(name,
          f"{label}: {len(decided)} of {len(control)} readings above their base limit, within the limit "
          f"applied ({by_kernel})"
          + (f", the largest kernel / tensor-core ratio {ratio(top):.3f} ({top['kernel']} {top['name']} "
             f"seed {top['seed']} {top['kind']})" if top else "")
          + f"; one 64-row unit lost, readings caught by the base limits / by the limits applied "
            f"(K3b, K4b: their dW tensors): {cells}")
    check(not missed, f"{label}: a lost unit that the base limits catch passes the limits applied: "
                      + ", ".join(missed))
    return {"decided": len(decided), "readings": len(control),
            "largest_ratio": top and (ratio(top), top["kernel"], top["name"], top["seed"], top["kind"]),
            "lost_unit_caught": {f"{k} s{seed}": v for (k, seed), v in sorted(caught.items())}}


def _flex_sample_count(S, R, dev, rows, control, h=256, bands=10, seeds=SAMPLE_SEEDS, timed=True, yard=None,
                       label=None, bare=False, n=FLEX_N_HIDDEN, exact=False):
    """K4f and K4b of synth512_lcode's He-scaled trunk (n = FLEX_N_HIDDEN
    hidden layers, `cases.flex_params`; at h = 512 synth512_lcode_w512's,
    at 768 / 1024 synth512_lcode_w768's / _w1024's; at `bands` xyz bands)
    at one (S, R) of SAMPLE_CASES (of
    FLEX_W512_SAMPLE_CASES, of XYZ_CASES) against their plain versions,
    `seeds` draws, under [flex_kernel]'s limits: raw rgb and σ within
    `flex_limit(FLEX_OUT_TOL)`, every gradient tensor, d_v0 and d_dir
    within `flex_grad_limits`, through the tensor-core yardstick where
    `flex_yardstick` holds (every S but 32 / 64 / 128) or `yard` says; K4b
    bit-identical over 2 launches. Where the yardstick decides, each
    reading goes into `control` beside what one lost 64-row unit (`rows`)
    reads. With `timed`, times each through its wrapper beside its plain
    version and its bound, and with `bare` also as the bare C launch, the
    operands packed beforehand (`flex_launch_split.bare_fwd` / `bare_bwd`).
    With `exact`, the first seed's dW launch against the products of its
    own workspace images, a lost unit caught (`flex_dw_exact`: K4b's
    "dw_exact", its summary). Returns ({K4f}, {K4b})."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.tools.perf.cases import flex_params

    label = label or f"S={S}"
    wn, bn = F.weight_names(n)
    names = list(wn) + list(bn) + ["v0", "dir"]
    yard = flex_yardstick(S, n, h) if yard is None else yard
    kf, kb = ("K4f", "K4b") if h == 256 else (f"K4f_{h}", f"K4b_{h}")  # `_sample_control`'s kernels
    k4f = {"rays": R, "hidden": h, "bands": bands, "out_rel": 0.0, "tc_rel": 0.0, "max_abs_err": 0.0}
    k4b = {"rays": R, "hidden": h, "bands": bands, "worst": {}, "max_abs_err": 0.0}
    for i in range(seeds):
        params, v0 = flex_params(SEED + 27 + 100 * i + (h if h != 256 else 0) + 1000 * (bands - 10)
                                 + (n - FLEX_N_HIDDEN), dev, n, h, bands)
        gen = torch.Generator().manual_seed(SEED + 28 + 100 * i + S)
        ro, rd, z, dc = _flex_inputs(R, S, gen, dev, h)
        weights = F.pack_flex_weights(params, n, bands)
        args = (weights, ro, rd, z, dc, v0, n, bands)
        out = F.fused_flex_forward(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K4f {label} seed {i}: output not finite")
        ref = F.fused_flex_forward_reference(*args)
        tc = tensor_core_plain(lambda: F.fused_flex_forward_reference(*args)) if yard else None
        lost = _without_rows(ref, rows)
        for part, sl in (("rgb", slice(0, 3)), ("sigma", slice(3, 4))):
            e = rel_err(out[..., sl], ref[..., sl])[0]
            e_tc = rel_err(tc[..., sl], ref[..., sl])[0] if yard else None
            lim = flex_limit(FLEX_OUT_TOL, n, e_tc)
            check(e <= lim, f"K4f {label} seed {i}: {part} max err {e:.3g}·max > {lim:.3g}"
                            + (f" (the plain version on the tensor cores: {e_tc:.3g}·max)" if yard else ""))
            if yard:
                control.append(dict(kernel=kf, name=part, seed=i, kind="max", value=e, tc=e_tc,
                                    base=FLEX_OUT_TOL, limit=lim,
                                    fault=rel_err(lost[..., sl], ref[..., sl])[0]))
                k4f["tc_rel"] = max(k4f["tc_rel"], e_tc)
            k4f["out_rel"] = max(k4f["out_rel"], e)
        k4f["max_abs_err"] = max(k4f["max_abs_err"], float((out - ref).abs().max()))
        del out, ref, tc, lost
        g = torch.randn(R, S, 4, generator=gen).to(dev)
        bargs = (*args[:6], g, n, bands)
        grads = F.fused_flex_backward(*bargs)
        grads2 = F.fused_flex_backward(*bargs)
        torch.cuda.synchronize()
        flat, flat2 = grads[0] + grads[1:], grads2[0] + grads2[1:]
        check(all(torch.equal(a, b) for a, b in zip(flat, flat2)),
              f"K4b {label} seed {i}: two launches gave different gradients")
        plain = F.fused_flex_backward_reference(*bargs)
        rflat = plain[0] + plain[1:]
        tc_flat = fault_flat = [None] * len(names)
        if yard:
            t = tensor_core_plain(lambda: F.fused_flex_backward_reference(*bargs))
            tc_flat = t[0] + t[1:]
            t = F.fused_flex_backward_reference(*args[:6], _without_rows(g, rows), n, bands)
            fault_flat = t[0] + t[1:]
        for name, a, r, t, f in zip(names, flat, rflat, tc_flat, fault_flat):
            a, r = a.float(), r.float()
            check(bool(torch.isfinite(a).all()), f"K4b {label} seed {i}: grad {name} not finite")
            e, e_norm = rel_err(a, r)
            tc_err = rel_err(t.float(), r) if t is not None else None
            tol, tol_norm = flex_grad_limits(R, name, n, tc_err, S)
            scale, r_norm = max(float(r.abs().max()), 1e-30), max(float(r.norm()), 1e-30)
            check(e <= tol + 1e-6 / scale, f"K4b {label} seed {i}: grad {name} max err {e:.4g}·max > {tol:.4g}")
            check(e_norm <= tol_norm + 1e-6 / r_norm,
                  f"K4b {label} seed {i}: grad {name} ‖err‖ {e_norm:.4g}·‖r‖ > {tol_norm:.4g}")
            if yard:
                f_err = rel_err(f.float(), r)
                for j, (kind, lim) in enumerate((("max", tol), ("norm", tol_norm))):
                    control.append(dict(kernel=kb, name=name, seed=i, kind=kind, value=(e, e_norm)[j],
                                        tc=tc_err[j], base=k1_grad_limits(R, name)[j], limit=lim,
                                        fault=f_err[j]))
            w = k4b["worst"].get(name, (0.0, 0.0))
            k4b["worst"][name] = (max(w[0], e), max(w[1], e_norm))
            k4b["max_abs_err"] = max(k4b["max_abs_err"], float((a - r).abs().max()))
        if i == 0 and timed:
            k4f.update(ms=_median_ms(lambda: F.fused_flex_forward(*args)),
                       plain_ms=_median_ms(lambda: F.fused_flex_forward_reference(*args), 1, 3),
                       bound_ms=_bound_ms(R * S * k4_flop_per_sample(n, h, False, bands),
                                          _k4_bytes(R, S, False, n, h, bands))[0])
            k4b.update(ms=_median_ms(lambda: F.fused_flex_backward(*bargs), iters=10),
                       plain_ms=_median_ms(lambda: F.fused_flex_backward_reference(*bargs), 1, 3),
                       bound_ms=_bound_ms(R * S * k4_flop_per_sample(n, h, True, bands),
                                          _k4_bytes(R, S, True, n, h, bands))[0])
            if bare:
                from nerface_tpu_torch.tools.perf import flex_launch_split as FS

                case = dict(weights=weights, ro=ro, rd=rd, z=z, dc=dc, v0=v0, g=g, n=n, bands=bands)
                k4f["bare_ms"] = _median_ms(FS.bare_fwd(case))
                fn = FS.bare_bwd(case)
                k4b["bare_ms"] = _median_ms(fn, iters=10)
                del fn
            for r, backward in ((k4f, False), (k4b, True)):
                r["bound_by"] = _bound_ms(R * S * k4_flop_per_sample(n, h, backward, bands),
                                          _k4_bytes(R, S, backward, n, h, bands))[1]
        if i == 0 and exact:
            from nerface_tpu_torch.tools.perf import flex_launch_split as FS

            fn = FS.bare_bwd(dict(weights=weights, ro=ro, rd=rd, z=z, dc=dc, v0=v0, g=g, n=n, bands=bands))
            fn()
            k4b["dw_exact"] = _dw_exact_summary(flex_dw_exact(fn, R, S, h, bands, label=f"K4b {label}", n=n))
            del fn
        del grads, grads2, flat, flat2, plain, rflat, tc_flat, fault_flat
    w = k4b.pop("worst")
    k4b["worst_max"] = max(w.items(), key=lambda kv: kv[1][0])
    k4b["worst_norm"] = max(w.items(), key=lambda kv: kv[1][1])
    return k4f, k4b


def _resample_grid(dev):
    """K5 at every (Sc, Sf) of K5_GRID_COARSE × K5_GRID_FINE with Sc + Sf
    ≤ 256 (Sc padded to its class 32 / 64 / 256, Sf to 1, 2 or 8 draws a
    lane), both regimes (per-ray draws, and the shared linspace row with
    `sorted_u`), on SAMPLE_RAGGED_RAYS rays: within K5_GRID_TOL of its
    plain version (the pipeline's sample_pdf + merge_sorted_zvals),
    rows sorted, bit-identical over 2 launches. Times each through its
    wrapper beside its plain version and its bound. Returns {"Sc+Sf
    regime": {...}}."""
    import torch

    from nerface_tpu_torch.ops.kernels.fused_resample import fused_resample, fused_resample_reference
    from nerface_tpu_torch.ops.math import linspace01

    R = SAMPLE_RAGGED_RAYS
    res = {}
    for sc in K5_GRID_COARSE:
        for sf in K5_GRID_FINE:
            if sc + sf > 256:
                continue
            g = torch.Generator().manual_seed(SEED + 31 + sc * 1000 + sf)
            z = (0.2 + (FAR - 0.2) * (torch.arange(sc) + torch.rand(R, sc, generator=g)) / sc).to(dev)
            w = (0.5 + 0.5 * torch.rand(R, sc, generator=g)).to(dev)
            for regime in ("general", "sorted_u"):
                srt = regime == "sorted_u"
                u = linspace01(sf, device=dev) if srt else torch.rand(R, sf, generator=g).to(dev)
                got = fused_resample(z, w, u, sorted_u=srt)
                again = fused_resample(z, w, u, sorted_u=srt)
                torch.cuda.synchronize()
                ref = fused_resample_reference(z, w, u, srt)
                err = float((got - ref).abs().max())
                label = f"{sc}+{sf} {regime}"
                check(got.shape == (R, sc + sf) and torch.equal(got, again),
                      f"K5 {label}: shape {tuple(got.shape)} or two launches differ")
                check(bool((got[:, 1:] >= got[:, :-1]).all()), f"K5 {label}: a row is not sorted")
                check(err <= K5_GRID_TOL, f"K5 {label}: max err {err} > {K5_GRID_TOL}")
                res[label] = {
                    "rays": R, "max_abs_err": err,
                    "ms": _median_ms(lambda: fused_resample(z, w, u, sorted_u=srt), iters=20),
                    "plain_ms": _median_ms(lambda: fused_resample_reference(z, w, u, srt), 1, 5),
                    "bound_ms": _bound_ms(0, _k5_bytes(R, sc, sf, srt))[0]}
    errs = [r["max_abs_err"] for r in res.values()]
    phase("sample_counts", f"K5 at {len(res)} shapes (Sc {K5_GRID_COARSE} × Sf {K5_GRID_FINE}, Sc + Sf ≤ "
                           f"256, both regimes), {R} rays: max err {max(errs):.3g} (limit {K5_GRID_TOL}), rows "
                           f"sorted, bit-identical over 2 launches")
    for label, r in res.items():
        phase("sample_counts", f"  K5 {label}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound "
                               f"{r['bound_ms']:.4f}, max err {r['max_abs_err']:.3g}")
    return res


def _paper_sample_case(S, R, dev, params, packed, rows, control, bands=10, seeds=SAMPLE_SEEDS, timed=True,
                       label=None, exact=False, bare=False):
    """K2, K3f, K3b and K1 of the paper model at S samples a ray on R rays
    and `bands` xyz bands, each against its plain version under
    [sample_counts]' limits (`sample_counts_phase`): K2 on the weights
    `params` (`packed` for the kernel), K3 and K1 on `seeds` draws of
    `_k1_params`; every reading and its lost-unit fault (`rows`) appended
    to `control` (`_sample_control`); Σ_rays d_dir within DIR_SUM_TOL of
    d_bd0. With `exact`, K3b's and K1's dW launch of the first seed against
    the products of their own workspace images (`dw_exact`: "dw_exact", its
    summary). With `timed`, each through its wrapper beside its
    plain version and its operations bound, and with `bare` as the bare C
    launch too ("bare_ms"). Returns (k2, k3f, k1, k3b, dir_sum)."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.ops.kernels import fused_train as T
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS
    from nerface_tpu_torch.tools.perf.k3f_k5_launch_split import k3f_bare

    label = label or f"S={S}"
    names = _bundle_names(False)
    kb = dict(num_encoding_fn_xyz=bands)
    f_fwd, f_bwd = paper_flop_per_sample(False, False, bands), paper_flop_per_sample(False, True, bands)
    # K2, as [kernel]: weights out, a background and none
    ro, rd, z, dc, cond, bg = _kernel_inputs(R, S, torch.Generator().manual_seed(SEED + S + 1000 * (bands - 10)), dev)
    k2 = {"rays": R, "max_abs_err": 0.0}
    for bg_kind in ("background", "none"):
        kw = dict(background=bg if bg_kind == "background" else None, out_weights=True, num_encoding_fn_xyz=bands)
        got = K.fused_paper_render(packed, ro, rd, z, dc, cond, **kw)
        torch.cuda.synchronize()
        ref = K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw)
        tc = tensor_core_plain(lambda: K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw))
        check(float(got["acc"][:2].abs().max()) == 0.0, f"K2 {label}: rd = 0 rays have acc != 0")
        for k, (e, e_tc, f) in _k2_readings(got, ref, tc, rows, S).items():
            base = K2_MAP_LIMITS[k][0]
            lim = tc_limit(base, e_tc)
            check(e <= lim, f"K2 {label} {bg_kind}: {k} err {e} > {lim} (base {base}, the plain version "
                            f"on the tensor cores {e_tc:.3g})")
            control.append(dict(kernel="K2", name=f"{k}/{bg_kind}", seed=0, kind="abs", value=e, tc=e_tc,
                                base=base, limit=lim, fault=f))
            if not K2_MAP_LIMITS[k][1]:
                k2["max_abs_err"] = max(k2["max_abs_err"], e)
        del got, ref, tc
    kw = dict(background=bg, out_weights=True, num_encoding_fn_xyz=bands)
    if timed:
        k2.update(
            ms=_median_ms(lambda: K.fused_paper_render(packed, ro, rd, z, dc, cond, **kw)),
            plain_ms=_median_ms(lambda: K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw),
                                1, 3),
            bound_ms=_bound_ms(R * S * f_fwd, _k2_bytes(R, S, True, bands))[0])
        if bare:
            k2["bare_ms"] = _median_ms(_bare_launch(packed, (ro, rd, z, dc, cond), kw))
    k3f, k1, k3b = ({"rays": R, "out_rel": 0.0, "tc_rel": 0.0, "max_abs_err": 0.0},
                    {"rays": R, "worst": {}, "max_abs_err": 0.0, "dw_exact": []},
                    {"rays": R, "worst": {}, "max_abs_err": 0.0, "dw_exact": []})
    dir_sum = 0.0
    for i in range(seeds):
        p = _k1_params(SEED + 23 + 100 * i, dev, bands=bands)
        gen = torch.Generator().manual_seed(SEED + 24 + 100 * i + S)
        ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_kernel_inputs(R, S, gen, dev)
        bundle = [t.contiguous() for t in T.prefold_paper_params(p, cond, pe_dir, bands)]
        # K3f and K3b
        out = K.fused_paper_mlp_forward(bundle, ro, rd, z, **kb)
        torch.cuda.synchronize()
        ref = K.fused_paper_mlp_reference(bundle, ro, rd, z, **kb)
        # the yardstick of [flex_kernel]: the plain version on the tensor
        # cores, the same bf16 operands summed in the kernel's way
        tc = tensor_core_plain(lambda: K.fused_paper_mlp_reference(bundle, ro, rd, z, **kb))
        lost = _without_rows(ref, rows)
        for part, sl in (("rgb", slice(0, 3)), ("sigma", slice(3, 4))):
            e, e_tc, f = (rel_err(x[..., sl], ref[..., sl])[0] for x in (out, tc, lost))
            lim = tc_limit(K3_OUT_TOL, e_tc)
            check(e <= lim, f"K3f {label} seed {i}: {part} max err {e:.3g}·max > {lim:.3g} "
                            f"(the plain version on the tensor cores: {e_tc:.3g}·max)")
            control.append(dict(kernel="K3f", name=part, seed=i, kind="max", value=e, tc=e_tc,
                                base=K3_OUT_TOL, limit=lim, fault=f))
            k3f["out_rel"], k3f["tc_rel"] = max(k3f["out_rel"], e), max(k3f["tc_rel"], e_tc)
        g = torch.randn(R, S, 4, generator=gen).to(dev)
        grads = K.fused_paper_mlp_backward(bundle, ro, rd, z, g, **kb)
        grads2 = K.fused_paper_mlp_backward(bundle, ro, rd, z, g, **kb)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(grads, grads2)),
              f"K3b {label} seed {i}: two launches gave different gradients")
        rgrads = K.fused_paper_mlp_backward_reference(bundle, ro, rd, z, g, **kb)
        tcg = tensor_core_plain(lambda: K.fused_paper_mlp_backward_reference(bundle, ro, rd, z, g, **kb))
        fault = K.fused_paper_mlp_backward_reference(bundle, ro, rd, z, _without_rows(g, rows), **kb)
        k3b["max_abs_err"] = max(k3b["max_abs_err"], _grad_readings(
            f"K3b {label} seed {i}", "K3b", R, names, grads, rgrads, k3b["worst"], tcg,
            control=control, fault_grads=fault, seed=i))
        dir_sum = max(dir_sum, _dir_sum_error(grads, names))
        rays = dict(ro=ro, rd=rd, z=z, g=g, tgt=tgt, bg=bg, noise=noise)
        if exact and i == 0:
            fn = KS.k3b_bare(bundle, rays, False, bands)
            fn()
            k3b["dw_exact"].append(_dw_exact_summary(dw_exact(fn, R, S, bands, label=f"K3b {label} seed {i}")))
            del fn
        if i == 0 and timed:
            k3f.update(
                ms=_median_ms(lambda: K.fused_paper_mlp_forward(bundle, ro, rd, z, **kb)),
                plain_ms=_median_ms(lambda: K.fused_paper_mlp_reference(bundle, ro, rd, z, **kb), 1, 3),
                bound_ms=_bound_ms(R * S * f_fwd, _k3_bytes(R, S, False, bands))[0])
            k3b.update(
                ms=_median_ms(lambda: K.fused_paper_mlp_backward(bundle, ro, rd, z, g, **kb), iters=10),
                plain_ms=_median_ms(lambda: K.fused_paper_mlp_backward_reference(bundle, ro, rd, z, g, **kb),
                                    1, 3),
                bound_ms=_bound_ms(R * S * f_bwd, _k3_bytes(R, S, True, bands))[0])
            if bare:
                k3f["bare_ms"] = _median_ms(k3f_bare(bundle, rays))
                k3b["bare_ms"] = _median_ms(KS.k3b_bare(bundle, rays, False, bands), iters=10)
        k3f["max_abs_err"] = max(k3f["max_abs_err"], float((out - ref).abs().max()))
        del out, ref, tc, lost, grads, grads2, rgrads, tcg, fault
        # K1: σ-noise and a background, as [train_kernel]'s passes (at
        # S = 1 the one sample is the background's: rgb is the
        # background and every gradient 0, which K1 must give too)
        kw = dict(loss_scale=2.0 / (3.0 * R), background=bg, noise=noise, noise_std=0.1, **kb)
        args = (bundle, ro, rd, z, tgt)
        got, grads, _ = T.fused_train_pass(*args, **kw)
        _, grads2, _ = T.fused_train_pass(*args, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(grads, grads2)),
              f"K1 {label} seed {i}: two launches gave different gradients")
        ref, rgrads, _ = T.fused_train_pass_reference(*args, **kw)
        for k in ("rgb", "weights"):
            e = float((got[k] - ref[k]).abs().max())
            check(e <= 2e-3, f"K1 {label} seed {i}: {k} max abs err {e} > 2e-3")
            k1["max_abs_err"] = max(k1["max_abs_err"], e)
        _grad_readings(f"K1 {label} seed {i}", "K1", R, names, grads, rgrads, k1["worst"])
        dir_sum = max(dir_sum, _dir_sum_error(grads, names))
        if exact and i == 0:
            fn = KS.k1_bare(bundle, rays, False, bands)
            fn()
            k1["dw_exact"].append(_dw_exact_summary(dw_exact(fn, R, S, bands, label=f"K1 {label} seed {i}",
                                                             catch=False)))
            del fn
        if i == 0 and timed:
            k1.update(ms=_median_ms(lambda: T.fused_train_pass(*args, **kw), iters=10),
                      plain_ms=_median_ms(lambda: T.fused_train_pass_reference(*args, **kw), 1, 3),
                      bound_ms=_bound_ms(R * S * f_bwd, _k1_bytes(R, S, bands))[0])
            if bare:
                k1["bare_ms"] = _median_ms(KS.k1_bare(bundle, rays, False, bands), iters=10)
        del got, ref, grads, grads2, rgrads
    check(dir_sum <= DIR_SUM_TOL, f"{label}: Σ d_dir vs d_bd0 {dir_sum:.2e} > {DIR_SUM_TOL}")
    for r in (k1, k3b):
        w = r.pop("worst")
        r["worst_max"] = max(w.items(), key=lambda kv: kv[1][0])
        r["worst_norm"] = max(w.items(), key=lambda kv: kv[1][1])
    return k2, k3f, k1, k3b, dir_sum


def sample_counts_phase(dev):
    """K2, K3f, K1 and K3b of the paper model at every (S, rays) of
    SAMPLE_CASES (the kernels take S at run time: whole rays in 64-row
    units, padding rows where S neither divides nor is a multiple of 64),
    each against its plain version: K2's maps as [kernel] (with a
    background and with none) and K3f within K3_OUT_TOL·max, each reading
    also passing within FLEX_TC_FACTOR × the plain version's own on the
    tensor cores ([flex_kernel]'s yardstick: bf16 roundings that flip
    between two f32 summation orders reach past those limits, the plain
    version's own as far as the kernel's); K1's rgb / weights within 2e-3
    and its gradients within `k1_grad_limits`; K3b's gradients within
    `k3b_grad_limits` of the yardstick's; K1 and K3b over SAMPLE_SEEDS
    seeds and bit-identical over 2 launches. `_sample_control` checks that
    a lost 64-row unit that the base limits catch, the limits applied catch
    too. K1's and K3b's
    d_dir summed over the rays within DIR_SUM_TOL of their bd0 gradient,
    the same cotangents summed by another route, which no rounding flip
    moves. Times each through its wrapper beside its plain version and its
    operations bound. Returns {kernel: {S: {...}}}."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.tools.perf.cases import he_scale

    res = {k: {} for k in ("K2", "K3f", "K1", "K3b", "K4f", "K4b", "control", "K4f_512", "K4b_512", "control_512")}
    model = _paper_model(SEED + 21, dev)
    he_scale(model)
    params = model.state_dict()
    packed = K.pack_paper_weights(params)
    for S, R in SAMPLE_CASES:
        rays, units = K.unit_layout(S)
        rows = lost_unit_rows(R, S)
        control = []
        k2, k3f, k1, k3b, dir_sum = _paper_sample_case(S, R, dev, params, packed, rows, control, exact=True)
        res["K2"][S] = k2
        res["K3f"][S], res["K1"][S], res["K3b"][S] = k3f, k1, k3b
        phase("sample_counts",
              f"S={S} ({rays} ray{'s' if rays > 1 else ''} in {units} unit{'s' if units > 1 else ''} an "
              f"item, {units * 64 - rays * S} padding rows), {R} rays ({R % rays or rays} in the last item): "
              f"K2 max abs err {k2['max_abs_err']:.3g} (limit 2e-3, or {FLEX_TC_FACTOR} × the plain version's "
              f"own on the tensor cores; a background and none), {k2['ms']:.3f} ms, plain "
              f"{k2['plain_ms']:.3f}, bound {k2['bound_ms']:.3f}; K3f {SAMPLE_SEEDS} seeds "
              f"{k3f['out_rel']:.2e}·max (limit {K3_OUT_TOL}, or {FLEX_TC_FACTOR} × the plain version's own, "
              f"up to {k3f['tc_rel']:.2e}·max on the tensor cores), {k3f['ms']:.3f} ms, "
              f"plain {k3f['plain_ms']:.3f}, bound {k3f['bound_ms']:.3f}")
        for k, r in (("K1", k1), ("K3b", k3b)):
            (wm, (wm_v, _)), (wn, (_, wn_v)) = r["worst_max"], r["worst_norm"]
            phase("sample_counts",
                  f"S={S}: {k} {SAMPLE_SEEDS} seeds worst grad {wm} {wm_v:.4f}·max, worst ‖err‖ {wn} "
                  f"{wn_v:.4f}·‖r‖ ({'k1_grad_limits' if k == 'K1' else 'k3b_grad_limits'}), "
                  f"bit-identical over 2 launches; {r['ms']:.3f} ms, "
                  f"plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.3f}")
        phase("sample_counts", f"S={S}: Σ_rays d_dir vs d_bd0, K1 and K3b: {dir_sum:.2e} of Σ|d_dir| "
                               f"(limit {DIR_SUM_TOL})")
        phase("sample_counts", f"S={S}: the exact dW check, the first seed (worst product reading, the lost "
                               f"unit's least; limit {DW_EXACT_TOL}): " + "; ".join(
                                   f"{k} {w:.3g} ({wn}), {f:.3g} ({fn})" for k, r in (("K1", k1), ("K3b", k3b))
                                   for w, wn, f, fn in r["dw_exact"]))
        k4f, k4b = _flex_sample_count(S, R, dev, rows, control)
        res["K4f"][S], res["K4b"][S] = k4f, k4b
        (wm, (wm_v, _)), (wn, (_, wn_v)) = k4b["worst_max"], k4b["worst_norm"]
        phase("sample_counts",
              f"S={S}: K4f {SAMPLE_SEEDS} seeds {k4f['out_rel']:.2e}·max (limit {FLEX_OUT_TOL}"
              + (f", or {FLEX_TC_FACTOR} × the plain version's own, up to {k4f['tc_rel']:.2e}·max on the "
                 f"tensor cores" if flex_yardstick(S, FLEX_N_HIDDEN) else "")
              + f"), {k4f['ms']:.3f} ms, plain {k4f['plain_ms']:.3f}, bound {k4f['bound_ms']:.3f}; K4b worst grad "
                f"{wm} {wm_v:.4f}·max, worst ‖err‖ {wn} {wn_v:.4f}·‖r‖ (`flex_grad_limits`), bit-identical "
                f"over 2 launches; {k4b['ms']:.3f} ms, plain {k4b['plain_ms']:.3f}, bound {k4b['bound_ms']:.3f}")
        res["control"][S] = _sample_control(S, control)
        torch.cuda.empty_cache()
    # K4f / K4b at h = 512 (synth512_lcode_w512's trunk): the runtime layouts'
    # extremes and the largest fixed-S one, under the same limits and control
    for S, R in FLEX_W512_SAMPLE_CASES:
        control = []
        k4f, k4b = _flex_sample_count(S, R, dev, lost_unit_rows(R, S), control, FLEX_WIDE)
        res["K4f_512"][S], res["K4b_512"][S] = k4f, k4b
        (wm, (wm_v, _)), (wn, (_, wn_v)) = k4b["worst_max"], k4b["worst_norm"]
        phase("sample_counts",
              f"S={S} h={FLEX_WIDE}, {R} rays: K4f {SAMPLE_SEEDS} seeds {k4f['out_rel']:.2e}·max (limit "
              f"{FLEX_OUT_TOL}, or {FLEX_TC_FACTOR} × the plain version's own, up to {k4f['tc_rel']:.2e}·max on "
              f"the tensor cores), {k4f['ms']:.3f} ms, plain {k4f['plain_ms']:.3f}, bound {k4f['bound_ms']:.3f}; "
              f"K4b worst grad {wm} {wm_v:.4f}·max, worst ‖err‖ {wn} {wn_v:.4f}·‖r‖ (`flex_grad_limits`), "
              f"bit-identical over 2 launches; {k4b['ms']:.3f} ms, plain {k4b['plain_ms']:.3f}, bound "
              f"{k4b['bound_ms']:.3f}")
        res["control_512"][S] = _sample_control(S, control)
        torch.cuda.empty_cache()
    # the prediction written in PERF.md before the run: from S = 48 up, K4's
    # time at S is S / 64 × its time at S = 64 at the same rays, ± 25 %
    for k in ("K4f", "K4b"):
        base = res[k][64]["ms"]
        cells = [f"S={S} {r['ms'] / (base * S / 64 * r['rays'] / res[k][64]['rays']):.2f}"
                 for S, r in sorted(res[k].items()) if S >= 48]
        phase("sample_counts", f"{k} ms / (S / 64 × the S = 64 time, per ray): {', '.join(cells)} "
                               f"(predicted 0.75–1.25)")
    res["K5"] = _resample_grid(dev)
    return res


# [xyz_bands]: the paper kernels, and K4f / K4b at hidden width 256 and
# 512, at 11..20 xyz bands (a K = 128 encoding, the runtime layout class at
# any S), 10 the control (K = 64, the fixed classes at S = 64 / 128), at
# the paper schedule's S = 64 and 128 and the
# runtime S = 48 (4 rays in 3 units, 64 padding rows an item), on whole
# (2048) and ragged (2072) ray counts; one seed a case, timed on the
# 2048-ray cases. Not S = 192: there a pass has ≈ 400k sample rows, and a
# lost 64-row unit moves K3b's dW sums by about sqrt(64 / rows) ≈ 1.3 % of
# their size, inside their bf16 flips, so `_sample_control` cannot hold
# (at 16 bands on 2072 rays the base limits caught the lost unit in some
# of K3b's readings, the limits applied in none); the card tests run S =
# 192 at 16 bands. Past 20 bands (XYZ_BANDS_XL: a K = 192 encoding, the
# ring one stage shorter) the paper kernels alone (K4 takes 1..20), their
# K1 and K3b dW launches held to the exact check (`dw_exact`) at
# XYZ_DW_EXACT_BANDS; then at the last band count a planted fault: the same
# pass through weights whose third xin block of W0 and W3 is zeroed must
# fail the limits applied (`_third_block_fault`).
XYZ_BANDS = (10, 11, 16, 20)
XYZ_BANDS_XL = (21, 24, 31)
XYZ_DW_EXACT_BANDS = (24, 31)
XYZ_CASES = ((64, TRAIN_RAYS), (128, TRAIN_RAYS), (48, TRAIN_RAYS), (48, SAMPLE_RAGGED_RAYS))
XYZ_SEEDS = 1


def xyz_bands_phase(dev):
    """K2, K3f, K1 and K3b of the paper model at every band count of
    XYZ_BANDS and XYZ_BANDS_XL, and K4f / K4b of synth512_lcode's trunk at
    hidden width 256 and 512 (FLEX_N_HIDDEN hidden layers) at those of
    XYZ_BANDS, at every (S, rays) of XYZ_CASES, each against its plain
    version under [sample_counts]' limits (`_paper_sample_case`: K2's maps, K3f within K3_OUT_TOL·max, K1
    `k1_grad_limits`, K3b `k3b_grad_limits`; `_flex_sample_count`: K4f
    `flex_limit`, K4b `flex_grad_limits`; each where flips reach past them
    within FLEX_TC_FACTOR × the tensor-core yardstick; bit-identical over 2
    launches; Σ d_dir against d_bd0), the lost 64-row unit caught wherever
    the base limits catch it (`_sample_control`), and timed beside the
    plain version and the operations bound on the 2048-ray cases; K1's and
    K3b's dW launches exact (`dw_exact`) at XYZ_DW_EXACT_BANDS; the third
    xin block's planted fault (`_third_block_fault`). Returns {kernel:
    {"L{L}_S{S}_R{R}": {...}}}, the time ratios against 10 bands and the
    fault's readings."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.tools.perf.cases import he_scale

    t0 = time.perf_counter()
    res = {k: {} for k in ("K2", "K3f", "K1", "K3b", "K4f", "K4b", f"K4f_{FLEX_WIDE}", f"K4b_{FLEX_WIDE}",
                           "control")}
    for L in XYZ_BANDS + XYZ_BANDS_XL:
        model = _paper_model(SEED + 31 + L, dev, bands=L)
        he_scale(model)
        params = model.state_dict()
        packed = K.pack_paper_weights(params, L)
        for S, R in XYZ_CASES:
            key, label = f"L{L}_S{S}_R{R}", f"L={L} S={S} R={R}"
            control = []
            k2, k3f, k1, k3b, dir_sum = _paper_sample_case(
                S, R, dev, params, packed, lost_unit_rows(R, S), control, bands=L, seeds=XYZ_SEEDS,
                timed=R == TRAIN_RAYS, label=label, exact=L in XYZ_DW_EXACT_BANDS)
            for k, r in (("K2", k2), ("K3f", k3f), ("K1", k1), ("K3b", k3b)):
                res[k][key] = dict(r, bands=L, samples=S, kx=K.xin_extent(L))
            times = "".join(f"; {k} {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.3f}"
                            for k, r in (("K2", k2), ("K3f", k3f), ("K1", k1), ("K3b", k3b)) if "ms" in r)
            exact = "".join(f"; {k} dW exact: worst {w:.2e} ({wn}), a lost unit {f:.2e} ({fn})"
                            for k, r in (("K1", k1), ("K3b", k3b)) for w, wn, f, fn in r["dw_exact"])
            (m1, (m1_v, _)), (m3, (m3_v, _)) = k1["worst_max"], k3b["worst_max"]
            phase("xyz_bands",
                  f"{label} (K = {K.xin_extent(L)}): K2 max abs err {k2['max_abs_err']:.3g}, K3f "
                  f"{k3f['out_rel']:.2e}·max (the tensor cores' own {k3f['tc_rel']:.2e}), K1 worst grad {m1} "
                  f"{m1_v:.4f}·max, K3b worst grad {m3} {m3_v:.4f}·max, within [sample_counts]' limits; K1 "
                  f"and K3b bit-identical over 2 launches; Σ d_dir vs d_bd0 {dir_sum:.2e}{exact}{times}")
            if L > F.MAX_FREQS:
                res["control"][key] = _sample_control(S, control, "xyz_bands", label)
                torch.cuda.empty_cache()
                continue
            # K4f / K4b at both widths on the same rays' schedule, the
            # yardstick at every S (as the paper kernels' K3f / K3b here)
            for h in (256, FLEX_WIDE):
                k4f, k4b = _flex_sample_count(S, R, dev, lost_unit_rows(R, S), control, h, L, XYZ_SEEDS,
                                              R == TRAIN_RAYS, True, f"{label} h={h}")
                at = "" if h == 256 else f"_{h}"
                res[f"K4f{at}"][key], res[f"K4b{at}"][key] = dict(k4f, samples=S), dict(k4b, samples=S)
                (wm, (wm_v, _)), (wn, (_, wn_v)) = k4b["worst_max"], k4b["worst_norm"]
                times = "".join(f"; {k} {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.3f}"
                                for k, r in (("K4f", k4f), ("K4b", k4b)) if "ms" in r)
                phase("xyz_bands",
                      f"{label} h={h}: K4f {k4f['out_rel']:.2e}·max (the tensor cores' own {k4f['tc_rel']:.2e}), "
                      f"K4b worst grad {wm} {wm_v:.4f}·max, worst ‖err‖ {wn} {wn_v:.4f}·‖r‖, within "
                      f"[sample_counts]' limits (`flex_limit`, `flex_grad_limits`); K4b bit-identical over 2 "
                      f"launches{times}")
            res["control"][key] = _sample_control(S, control, "xyz_bands", label)
            torch.cuda.empty_cache()
    res["third_block_fault"] = _third_block_fault(dev, XYZ_BANDS_XL[-1])
    # the predictions written in PERF.md before the runs: past 10 bands each
    # kernel's time at the same (S, rays) through its wrapper is 1.0–1.3 ×
    # its 10-band time (the paper kernels); K4f's 1.0–1.4 × at h = 256 and
    # 1.0–1.15 × at 512, K4b's 1.0–1.2 ×; past 20 bands K2's and K3f's
    # 1.5–3.5 ×, K1's and K3b's 1.0–1.3 ×
    ratios = {}
    for k in ("K2", "K3f", "K1", "K3b", "K4f", "K4b", f"K4f_{FLEX_WIDE}", f"K4b_{FLEX_WIDE}"):
        bands = XYZ_BANDS[1:] + (XYZ_BANDS_XL if k in ("K2", "K3f", "K1", "K3b") else ())
        for S, R in XYZ_CASES:
            if R != TRAIN_RAYS:
                continue
            base = res[k][f"L10_S{S}_R{R}"]["ms"]
            ratios[f"{k}_S{S}"] = {L: res[k][f"L{L}_S{S}_R{R}"]["ms"] / base for L in bands}
    phase("xyz_bands", "ms / the 10-band ms at the same S and rays (predicted 1.0–1.3; K4f 1.0–1.4, at 512 "
                       "1.0–1.15; K4b 1.0–1.2; past 20 bands K2 / K3f 1.5–3.5, K1 / K3b 1.0–1.3): " + "; ".join(
        f"{c} " + ", ".join(f"L={L} {v:.2f}" for L, v in r.items()) for c, r in ratios.items()))
    res["ratio_to_10_bands"] = ratios
    res["seconds"] = time.perf_counter() - t0
    phase("xyz_bands", f"the phase took {res['seconds']:.1f} s")
    return res


def _third_block_fault(dev, L, S=64, R=TRAIN_RAYS):
    """[xyz_bands]' pass at L bands (a three-block xin image), S and R, each
    paper kernel run through weights whose third xin block of W0 and W3 is
    zeroed (the encoding's columns 128..191: K2's packed chunk images, the
    bundle's w0b / w3xb rows from 125 for K3f, K3b and K1), as a kernel that
    never read that block would compute, against its plain version on the
    true weights: each must fail the limits applied to its readings (K2's
    maps and K3f's outputs through `tc_limit`, K1 `k1_grad_limits`, K3b
    `k3b_grad_limits` of the tensor-core yardstick). Returns {kernel: (its
    worst reading / its limit, the reading)}."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.ops.kernels import fused_train as T
    from nerface_tpu_torch.tools.perf.cases import he_scale

    check(K.xin_extent(L) == K.K_XIN_XL, f"the third-block fault needs a three-block image, not L = {L}")
    model = _paper_model(SEED + 31 + L, dev, bands=L)
    he_scale(model)
    params = model.state_dict()
    faulty = _third_block_zeroed(K.pack_paper_weights(params, L))
    ro, rd, z, dc, cond, bg = _kernel_inputs(R, S, torch.Generator().manual_seed(SEED + S + 1000 * (L - 10)), dev)
    kw = dict(background=bg, out_weights=True, num_encoding_fn_xyz=L)
    ref = K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw)
    tc = tensor_core_plain(lambda: K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw))
    got = K.fused_paper_render(faulty, ro, rd, z, dc, cond, **kw)
    e, e_tc = (float((x["rgb"] - ref["rgb"]).abs().max()) for x in (got, tc))
    out = {"K2": (e / tc_limit(K2_MAP_LIMITS["rgb"][0], e_tc), e)}
    names = _bundle_names(False)
    p = _k1_params(SEED + 23, dev, bands=L)
    gen = torch.Generator().manual_seed(SEED + 24 + S)
    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_kernel_inputs(R, S, gen, dev)
    bundle = [t.contiguous() for t in T.prefold_paper_params(p, cond, pe_dir, L)]
    fbundle = _third_block_bundle(bundle)
    kb = dict(num_encoding_fn_xyz=L)
    ref = K.fused_paper_mlp_reference(bundle, ro, rd, z, **kb)
    tc = tensor_core_plain(lambda: K.fused_paper_mlp_reference(bundle, ro, rd, z, **kb))
    got = K.fused_paper_mlp_forward(fbundle, ro, rd, z, **kb)
    out["K3f"] = max((rel_err(got[..., sl], ref[..., sl])[0]
                      / tc_limit(K3_OUT_TOL, rel_err(tc[..., sl], ref[..., sl])[0]),
                      rel_err(got[..., sl], ref[..., sl])[0]) for sl in (slice(0, 3), slice(3, 4)))
    g = torch.randn(R, S, 4, generator=gen).to(dev)
    rgrads = K.fused_paper_mlp_backward_reference(bundle, ro, rd, z, g, **kb)
    tcg = tensor_core_plain(lambda: K.fused_paper_mlp_backward_reference(bundle, ro, rd, z, g, **kb))
    grads = K.fused_paper_mlp_backward(fbundle, ro, rd, z, g, **kb)
    readings = []
    for name, a, r, t in zip(names, grads, rgrads, tcg):
        lims = k3b_grad_limits(R, name, rel_err(t, r))
        readings += [(v / lim, v) for v, lim in zip(rel_err(a, r), lims)]
    out["K3b"] = max(readings)
    kw = dict(loss_scale=2.0 / (3.0 * R), background=bg, noise=noise, noise_std=0.1, **kb)
    _, rgrads, _ = T.fused_train_pass_reference(bundle, ro, rd, z, tgt, **kw)
    _, grads, _ = T.fused_train_pass(fbundle, ro, rd, z, tgt, **kw)
    readings = []
    for name, a, r in zip(names, grads, rgrads):
        readings += [(v / lim, v) for v, lim in zip(rel_err(a, r), k1_grad_limits(R, name))]
    out["K1"] = max(readings)
    torch.cuda.synchronize()
    phase("xyz_bands", f"L={L} S={S} R={R}, the third xin block of W0 and W3 zeroed (a kernel that never reads "
                       f"it): worst reading / the limit applied " + ", ".join(
                           f"{k} {q:.3g} ({v:.3g})" for k, (q, v) in out.items()) + " (each must exceed 1)")
    for k, (q, v) in out.items():
        check(q > 1.0, f"L={L}: {k} through a zeroed third xin block reads {v:.3g}, within its limits")
    torch.cuda.empty_cache()
    return out


# [long_rays]: the paper kernels past 256 samples a ray, where an item is
# one ray in ⌈S / 64⌉ units (K2 compositing it in segments of 256 rows, K1
# and K3b keeping its rows in the workspace): S = 257 (one row into a fifth
# unit), 320 (synth512_paper_64_256's fine pass), 512 (two whole K2
# segments) and the limit on TRAIN_RAYS rays, and 320 and 1000 (24 padding
# rows in the last of 16 units) on SAMPLE_RAGGED_RAYS. One seed a case, the
# exact dW check on every K1 and K3b pass, timed through the wrappers and
# bare on the TRAIN_RAYS cases.
LONG_RAYS_CASES = ((257, TRAIN_RAYS), (320, TRAIN_RAYS), (512, TRAIN_RAYS), (1024, TRAIN_RAYS),
                   (320, SAMPLE_RAGGED_RAYS), (1000, SAMPLE_RAGGED_RAYS))
LONG_RAYS_SEEDS = 1
# the exact dW check beside the limits it stands in for: K3b at TRAIN_RAYS ×
# S with one 64-row unit lost, DW_EXACT_SEEDS seeds each (one keeps the whole
# run inside its time limit; the exact check is held on every K1 / K3b pass
# of [sample_counts] and [long_rays] besides)
DW_EXACT_S = (128, 320, 1024)
DW_EXACT_SEEDS = 1


def _dw_exact_vs_limits(dev):
    """K3b at TRAIN_RAYS × each S of DW_EXACT_S, DW_EXACT_SEEDS seeds: does
    one lost 64-row unit (`lost_unit_rows`) pass `k3b_grad_limits` against
    the plain version (any dW tensor's reading past its limit catches it)
    and the exact check (`dw_exact`: every product's)? The kernel itself
    within both. Returns {S: {"limits": seeds caught, "base": seeds the base
    limits catch, "exact": seeds caught, "seeds": n, ...}}."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.ops.kernels import fused_train as T
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS

    R, names, res = TRAIN_RAYS, _bundle_names(False), {}
    for S in DW_EXACT_S:
        rows = lost_unit_rows(R, S)
        r = res[S] = {"seeds": DW_EXACT_SEEDS, "limits": 0, "base": 0, "exact": 0, "exact_worst": 0.0,
                      "exact_lost_least": float("inf")}
        for i in range(DW_EXACT_SEEDS):
            label = f"S={S} seed {i}"
            p = _k1_params(SEED + 41 + 100 * i, dev)
            gen = torch.Generator().manual_seed(SEED + 42 + 100 * i + S)
            ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_kernel_inputs(R, S, gen, dev)
            bundle = [t.contiguous() for t in T.prefold_paper_params(p, cond, pe_dir, 10)]
            g = torch.randn(R, S, 4, generator=gen).to(dev)
            grads = K.fused_paper_mlp_backward(bundle, ro, rd, z, g)
            rgrads = K.fused_paper_mlp_backward_reference(bundle, ro, rd, z, g)
            tcg = tensor_core_plain(lambda: K.fused_paper_mlp_backward_reference(bundle, ro, rd, z, g))
            fault = K.fused_paper_mlp_backward_reference(bundle, ro, rd, z, _without_rows(g, rows))
            control = []
            _grad_readings(f"K3b {label}", "K3b", R, names, grads, rgrads, {}, tcg, control=control,
                           fault_grads=fault, seed=i)
            dw = [c for c in control if c["name"] in DW_TENSORS]
            r["limits"] += any(c["fault"] > c["limit"] for c in dw)
            r["base"] += any(c["fault"] > c["base"] for c in dw)
            del grads, rgrads, tcg, fault
            torch.cuda.empty_cache()
            fn = KS.k3b_bare(bundle, dict(ro=ro, rd=rd, z=z, g=g), False)
            fn()
            worst, _, least, _ = _dw_exact_summary(dw_exact(fn, R, S, label=f"K3b {label}"))
            r["exact"] += least > DW_EXACT_TOL
            r["exact_worst"] = max(r["exact_worst"], worst)
            r["exact_lost_least"] = min(r["exact_lost_least"], least)
            del fn
            torch.cuda.empty_cache()
        check(r["exact"] == DW_EXACT_SEEDS, f"long_rays: the exact check missed a lost unit at S={S}: {r}")
        phase("long_rays", f"the exact dW check at {R} × S={S}, K3b, {DW_EXACT_SEEDS} seeds, one 64-row unit lost: "
                           f"`k3b_grad_limits` against the plain version catch it in {r['limits']} "
                           f"(their base limits in {r['base']}), the exact check in {r['exact']}: the kernel "
                           f"within {r['exact_worst']:.3g} of Xᵀ·gY of its own images, the lost unit at least "
                           f"{r['exact_lost_least']:.3g} off (limit {DW_EXACT_TOL})")
    return res


def long_rays_phase(dev):
    """K2, K3f, K1 and K3b of the paper model at every (S, rays) of
    LONG_RAYS_CASES (S past 256: a long item), each against its plain
    version under [sample_counts]' limits (`_paper_sample_case`: K2's maps,
    K3f within K3_OUT_TOL·max, K1 `k1_grad_limits`, K3b `k3b_grad_limits`,
    each where flips reach past them within FLEX_TC_FACTOR × the
    tensor-core yardstick; bit-identical over 2 launches; Σ d_dir against
    d_bd0), K1's and K3b's dW launch exact against their own workspace
    images (`dw_exact`) with the lost unit caught there, K2 / K3f's lost
    unit caught by the limits (`_sample_control`); each timed through its
    wrapper and bare beside its plain version and its operations bound on
    the TRAIN_RAYS cases. Then `_dw_exact_vs_limits`. Returns {kernel:
    {"S{S}_R{R}": {...}}}."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_mlp as K
    from nerface_tpu_torch.tools.perf.cases import he_scale

    t0 = time.perf_counter()
    res = {k: {} for k in ("K2", "K3f", "K1", "K3b", "control")}
    model = _paper_model(SEED + 21, dev)
    he_scale(model)
    params = model.state_dict()
    packed = K.pack_paper_weights(params)
    for S, R in LONG_RAYS_CASES:
        key, label = f"S{S}_R{R}", f"S={S} R={R}"
        control = []
        timed = R == TRAIN_RAYS
        k2, k3f, k1, k3b, dir_sum = _paper_sample_case(
            S, R, dev, params, packed, lost_unit_rows(R, S), control, seeds=LONG_RAYS_SEEDS, timed=timed,
            label=label, exact=True, bare=timed)
        for k, r in (("K2", k2), ("K3f", k3f), ("K1", k1), ("K3b", k3b)):
            res[k][key] = dict(r, samples=S)
        _, units = K.unit_layout(S)
        (m1, (m1_v, _)), (m3, (m3_v, _)) = k1["worst_max"], k3b["worst_max"]
        exact = "; ".join(f"{k} dW exact within {w:.3g} ({wn}), the lost unit ≥ {f:.3g} ({fn})"
                          for k, r in (("K1", k1), ("K3b", k3b)) for w, wn, f, fn in r["dw_exact"])
        times = "".join(f"; {k} {r['ms']:.3f} ms, bare {r['bare_ms']:.3f}, plain {r['plain_ms']:.3f}, bound "
                        f"{r['bound_ms']:.3f}" for k, r in (("K2", k2), ("K3f", k3f), ("K1", k1), ("K3b", k3b))
                        if "ms" in r)
        phase("long_rays",
              f"{label} (one ray in {units} units an item, {units * 64 - S} padding rows): K2 max abs err "
              f"{k2['max_abs_err']:.3g}, K3f {k3f['out_rel']:.2e}·max (the tensor cores' own {k3f['tc_rel']:.2e}), "
              f"K1 worst grad {m1} {m1_v:.4f}·max, K3b worst grad {m3} {m3_v:.4f}·max, within [sample_counts]' "
              f"limits; K1 and K3b bit-identical over 2 launches; Σ d_dir vs d_bd0 {dir_sum:.2e}; {exact} "
              f"(limit {DW_EXACT_TOL}){times}")
        res["control"][key] = _sample_control(S, control, "long_rays", label, exact=("K3b",))
        torch.cuda.empty_cache()
    res["dw_exact_vs_limits"] = _dw_exact_vs_limits(dev)
    res["seconds"] = time.perf_counter() - t0
    phase("long_rays", f"the phase took {res['seconds']:.1f} s")
    return res



# [flex_long_rays]: K4f / K4b of synth512_lcode's trunk past 256 samples a
# ray (one ray an item in up to 16 units) at hidden 256 and 512: S = 257
# (a fifth unit of one row), 320 (synth512_lcode_64_256's fine pass), 512
# and the limit on TRAIN_RAYS, and 320 / 1000 on SAMPLE_RAGGED_RAYS (the
# last round of the persistent grid cut short; 24 padding rows at 1000).
# One seed a case, timed through the wrappers and bare on the TRAIN_RAYS
# cases; then the repeat check on a dead long item
FLEX_LONG_CASES = ((257, TRAIN_RAYS), (320, TRAIN_RAYS), (512, TRAIN_RAYS), (1024, TRAIN_RAYS),
                   (320, SAMPLE_RAGGED_RAYS), (1000, SAMPLE_RAGGED_RAYS))
# an odd ray count at S = 320, h = 256: the last round's warpgroup-1 item is
# a long item past the last ray, which K4b's recompute and dX walk with
# `skip_stages`; FLEX_LONG_DEAD_PASSES passes at 8 hidden layers
FLEX_LONG_DEAD_CASE = (2071, 320)
FLEX_LONG_DEAD_PASSES = 50


def flex_dw_products(n, h, kx):
    """K4b's dW launch's products (`fused_flex.cu::dw_products`): (label,
    the packed weight's offset name, X buffer, gY buffer) of W1, WF, WD0
    and each WH_i."""
    return ([("w1", "W1", "xin", "ga0"), ("wf", "WF", f"a{n}", "gfeat"), ("wd0", "WD0", "feat", "gx0")]
            + [(f"wh{i}", f"WH{i}", f"a{i}", f"gpre{i}") for i in range(n)])


def flex_dw_exact(launch, R, S, h, bands=10, label="", catch=True, n=FLEX_N_HIDDEN):
    """`dw_exact` for K4b at n hidden layers: after `launch`
    (`flex_launch_split.bare_bwd`, its `out` and `ws`) ran, each product of
    `flex_dw_products` held to the f64
    Xᵀ·gY of the workspace's images (`_dw_exact_check`). Returns
    {product: (max, norm, lost-unit max, lost-unit norm)} relative
    readings."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels.fused_mlp import xin_extent

    torch.cuda.synchronize()
    kx = xin_extent(bands)
    offs, total = F.workspace_layout(R, S, n, h, kx)
    check(launch.ws.numel() == total,
          f"{label}: the workspace is {launch.ws.numel()} B, fused_flex.workspace_layout says {total}")
    rays, units_an_item = F.unit_layout(S)
    widths, wo = dict(F.workspace_buffers(n, h, kx)), F.w_offsets(n, h, kx)
    prods = [(name, offs[xn], widths[xn], offs[gn], widths[gn], wo[slot])
             for name, slot, xn, gn in flex_dw_products(n, h, kx)]
    return _dw_exact_check(launch, prods, -(-R // rays) * units_an_item, lost_unit_index(R, S), label, catch)


def _flex_dw_exact_vs_limits(dev, widths=(256, FLEX_WIDE), samples=DW_EXACT_S, seeds=DW_EXACT_SEEDS,
                             phase_name="flex_long_rays"):
    """K4b at TRAIN_RAYS × each S of `samples` (DW_EXACT_S), at each hidden
    width of `widths` (256 and 512), `seeds` seeds (DW_EXACT_SEEDS), in
    phase `phase_name`: does one lost 64-row unit (`lost_unit_rows`, its
    cotangent rows zeroed) pass `flex_grad_limits` against the plain
    version (any dW tensor's reading past its limit catches it; the
    tensor-core yardstick at every S, as `[xyz_bands]` holds K4: at S = 128
    one flipped rounding read 0.021·max of a bias row against the base
    0.02 at h = 512) and the exact check (`flex_dw_exact`: every
    product's)? The kernel itself within both.
    Returns {"h{h}_S{S}": {"limits": seeds caught, "base": seeds the base
    limits catch, "exact": seeds caught, "seeds": n, ...}}."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.tools.perf import flex_launch_split as FS
    from nerface_tpu_torch.tools.perf.cases import flex_params

    R, n, res = TRAIN_RAYS, FLEX_N_HIDDEN, {}
    wn, bn = F.weight_names(n)
    names = list(wn) + list(bn) + ["v0", "dir"]
    for h in widths:
        for S in samples:
            rows = lost_unit_rows(R, S)
            r = res[f"h{h}_S{S}"] = {"seeds": seeds, "limits": 0, "base": 0, "exact": 0,
                                     "exact_worst": 0.0, "exact_lost_least": float("inf")}
            for i in range(seeds):
                label = f"K4b h={h} S={S} seed {i}"
                params, v0 = flex_params(SEED + 43 + 100 * i + h, dev, n, h)
                gen = torch.Generator().manual_seed(SEED + 44 + 100 * i + S)
                ro, rd, z, dc = _flex_inputs(R, S, gen, dev, h)
                weights = F.pack_flex_weights(params, n, 10)
                g = torch.randn(R, S, 4, generator=gen).to(dev)
                args = (weights, ro, rd, z, dc, v0)
                grads = F.fused_flex_backward(*args, g, n)
                plain = F.fused_flex_backward_reference(*args, g, n)
                tcg = tensor_core_plain(lambda: F.fused_flex_backward_reference(*args, g, n))
                fault = F.fused_flex_backward_reference(*args, _without_rows(g, rows), n)
                flat, rflat, tflat, fflat = (t[0] + t[1:] for t in (grads, plain, tcg, fault))
                limits = base = False
                for name, a, p, t, f in zip(names, flat, rflat, tflat, fflat):
                    a, p = a.float(), p.float()
                    tol = flex_grad_limits(R, name, n, rel_err(t.float(), p), S)
                    e = rel_err(a, p)
                    check(e[0] <= tol[0] + 1e-6 / max(float(p.abs().max()), 1e-30) and e[1] <= tol[1] + 1e-6 / max(
                        float(p.norm()), 1e-30), f"{label}: grad {name} {e} past {tol}")
                    if name in FLEX_DW_TENSORS:
                        fe = rel_err(f.float(), p)
                        limits |= fe[0] > tol[0] or fe[1] > tol[1]
                        b = k1_grad_limits(R, name)
                        base |= fe[0] > b[0] or fe[1] > b[1]
                r["limits"] += limits
                r["base"] += base
                del grads, plain, tcg, fault, flat, rflat, fflat, tflat
                torch.cuda.empty_cache()
                fn = FS.bare_bwd(dict(weights=weights, ro=ro, rd=rd, z=z, dc=dc, v0=v0, g=g, n=n, bands=10))
                fn()
                worst, _, least, _ = _dw_exact_summary(flex_dw_exact(fn, R, S, h, label=label))
                r["exact"] += least > DW_EXACT_TOL
                r["exact_worst"] = max(r["exact_worst"], worst)
                r["exact_lost_least"] = min(r["exact_lost_least"], least)
                del fn
                torch.cuda.empty_cache()
            check(r["exact"] == seeds, f"{phase_name}: the exact check missed a lost unit at h={h} S={S}: {r}")
            phase(phase_name, f"the exact dW check at {R} × S={S}, K4b h={h}, {seeds} seeds, one 64-row unit lost: "
                              f"`flex_grad_limits` against the plain version catch it in {r['limits']} (their base "
                              f"limits in {r['base']}), the exact check in {r['exact']}: the kernel within "
                              f"{r['exact_worst']:.3g} of Xᵀ·gY of its own images, the lost unit at least "
                              f"{r['exact_lost_least']:.3g} off (limit {DW_EXACT_TOL})")
    return res


def flex_long_rays_phase(dev):
    """K4f and K4b of synth512_lcode's trunk (FLEX_N_HIDDEN hidden layers)
    at hidden 256 and 512 at every (S, rays) of FLEX_LONG_CASES (S past
    256: a long item), each against its plain version under
    [sample_counts]' limits (`_flex_sample_count`: the tensor-core
    yardstick, K4b bit-identical over 2 launches) and the lost-unit control
    (`_sample_control`); timed through the wrappers and bare beside the
    plain versions and the bound by operations on the TRAIN_RAYS cases.
    Then FLEX_LONG_DEAD_PASSES passes on FLEX_LONG_DEAD_CASE, each bit for
    bit the first, and `_flex_dw_exact_vs_limits`. Returns {kernel:
    {"S{S}_R{R}": {...}}, ...}."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels.fused_mlp import unit_layout

    t0 = time.perf_counter()
    res = {k: {} for k in ("K4f", "K4b", f"K4f_{FLEX_WIDE}", f"K4b_{FLEX_WIDE}", "control")}
    for h in (256, FLEX_WIDE):
        at = "" if h == 256 else f"_{h}"
        for S, R in FLEX_LONG_CASES:
            key, label = f"S{S}_R{R}", f"h={h} S={S} R={R}"
            control = []
            timed = R == TRAIN_RAYS
            k4f, k4b = _flex_sample_count(S, R, dev, lost_unit_rows(R, S), control, h=h, timed=timed,
                                          label=label, bare=timed)
            res["K4f" + at][key] = dict(k4f, samples=S)
            res["K4b" + at][key] = dict(k4b, samples=S)
            _, units = unit_layout(S)
            m, (m_v, _) = k4b["worst_max"]
            times = "".join(f"; {k} {r['ms']:.3f} ms, bare {r['bare_ms']:.3f}, plain {r['plain_ms']:.3f}, bound "
                            f"{r['bound_ms']:.3f} ({r['bound_by']})" for k, r in (("K4f", k4f), ("K4b", k4b))
                            if "ms" in r)
            phase("flex_long_rays",
                  f"{label} (one ray in {units} units an item, {units * 64 - S} padding rows): K4f "
                  f"{k4f['out_rel']:.2e}·max (the tensor cores' own {k4f['tc_rel']:.2e}), K4b worst grad {m} "
                  f"{m_v:.4f}·max, within [sample_counts]' limits; K4b bit-identical over 2 launches{times}")
            res["control"][f"h{h}_{key}"] = _sample_control(S, control, "flex_long_rays", label)
            torch.cuda.empty_cache()
    R, S = FLEX_LONG_DEAD_CASE
    dead = sorted({(c, r, wg) for c, r, wg, _, ok in F.unit_schedule(R, S) if not ok})
    check(len(dead) == 1 and dead[0][2] == 1, f"flex_long_rays {R}x{S}: dead items {dead}")
    wall, n_tensors = _repeat_passes(dev, R, S, 256, 8, FLEX_LONG_DEAD_PASSES, "flex_long_rays")
    res["dead_unit_passes"] = {"case": f"{R}x{S}", "passes": FLEX_LONG_DEAD_PASSES, "seconds": wall,
                               "dead_item": dead[0]}
    phase("flex_long_rays", f"{R}x{S}, n = 8: {FLEX_LONG_DEAD_PASSES} passes of K4f + K4b in {wall:.2f} s, each bit "
                            f"for bit the first (outputs and {n_tensors - 1} gradient tensors); the dead "
                            f"warpgroup-1 item (a long item of {F.unit_layout(S)[1]} units) in CTA {dead[0][0]}, "
                            f"round {dead[0][1]}")
    res["dw_exact_vs_limits"] = _flex_dw_exact_vs_limits(dev)
    res["seconds"] = time.perf_counter() - t0
    phase("flex_long_rays", f"the phase took {res['seconds']:.1f} s")
    return res

# [flex_widths]: K4f / K4b at the sliced widths (h = 768 and 1024,
# synth512_lcode_w768's / _w1024's trunk): (S, rays, hidden layers, xyz
# bands) on TRAIN_RAYS at the paper schedule's S = 64 / 128, the runtime S =
# 48 and the long S = 320, on SAMPLE_RAGGED_RAYS at S = 40, at 16 bands,
# and at 0 and 8 hidden layers; one seed a case, timed on the n = 3,
# 10-band TRAIN_RAYS cases. At h = 1024 also S = 1024 on FLEX_SLICED_LONG_RAYS
# (its workspace at 2048 rays would be ≈ 49 GB).
FLEX_SLICED_CASES = ((64, TRAIN_RAYS, 3, 10), (128, TRAIN_RAYS, 3, 10), (48, TRAIN_RAYS, 3, 10),
                     (320, TRAIN_RAYS, 3, 10), (40, SAMPLE_RAGGED_RAYS, 3, 10), (64, TRAIN_RAYS, 3, 16),
                     (64, TRAIN_RAYS, 0, 10), (32, TRAIN_RAYS, 8, 10))
FLEX_SLICED_LONG_RAYS = 256
FLEX_SLICED_DW_SEEDS = 1  # the exact dW check at h = 1024, 2048 × 128 (every case's K4b launch too)


def flex_widths_phase(dev):
    """K4f and K4b at h = 768 and 1024 (the sliced kernels) at every case
    of FLEX_SLICED_CASES, and at h = 1024 S = 1024 on
    FLEX_SLICED_LONG_RAYS rays, against their plain versions under
    `_flex_sample_count`'s limits (the tensor-core yardstick decides at
    these widths, `flex_yardstick`; K4b bit-identical over 2 launches) and
    the lost-unit control (`_sample_control`); timed through the wrappers
    and bare beside the plain versions and the bound. Then the exact dW
    check at h = 1024 (`_flex_dw_exact_vs_limits`, 2048 × S = 128,
    FLEX_SLICED_DW_SEEDS seeds, a lost unit caught). Returns {"K4f_768":
    {case: {...}}, ..., "control": ..., "dw_exact_vs_limits": ...}."""
    import torch

    t0 = time.perf_counter()
    res = {f"{k}_{h}": {} for h in sliced_widths() for k in ("K4f", "K4b")}
    res["control"] = {}
    for h in sliced_widths():
        cases = FLEX_SLICED_CASES + (((1024, FLEX_SLICED_LONG_RAYS, 3, 10),) if h == 1024 else ())
        for S, R, n, bands in cases:
            key = f"S{S}_R{R}_n{n}_L{bands}"
            label = f"h={h} S={S} R={R} n={n} L={bands}"
            timed = n == FLEX_N_HIDDEN and bands == 10 and (R == TRAIN_RAYS or S == 1024) and S != 48
            control = []
            k4f, k4b = _flex_sample_count(S, R, dev, lost_unit_rows(R, S), control, h=h, bands=bands, timed=timed,
                                          label=label, bare=timed, n=n, exact=True)
            res[f"K4f_{h}"][key] = dict(k4f, samples=S, n_hidden=n)
            res[f"K4b_{h}"][key] = dict(k4b, samples=S, n_hidden=n)
            m, (m_v, _) = k4b["worst_max"]
            w, (_, w_v) = k4b["worst_norm"]
            times = "".join(f"; {k} {r['ms']:.3f} ms, bare {r['bare_ms']:.3f}, plain {r['plain_ms']:.3f}, bound "
                            f"{r['bound_ms']:.3f} ({r['bound_by']})" for k, r in (("K4f", k4f), ("K4b", k4b))
                            if "ms" in r)
            ex_worst, ex_at, ex_least, ex_lost = k4b["dw_exact"]
            phase("flex_widths",
                  f"{label}: K4f {k4f['out_rel']:.2e}·max (the tensor cores' own {k4f['tc_rel']:.2e}), K4b worst "
                  f"grad {m} {m_v:.4f}·max, worst ‖err‖ {w} {w_v:.4f}·‖r‖, within `flex_limit` / "
                  f"`flex_grad_limits`; K4b bit-identical over 2 launches; its dW within {ex_worst:.3g} ({ex_at}) "
                  f"of Xᵀ·gY of its own images, a lost unit at least {ex_least:.3g} off ({ex_lost}; limit "
                  f"{DW_EXACT_TOL}){times}")
            res["control"][f"h{h}_{key}"] = _sample_control(S, control, "flex_widths", label, exact=(f"K4b_{h}",))
            torch.cuda.empty_cache()
    res["dw_exact_vs_limits"] = _flex_dw_exact_vs_limits(dev, (1024,), (128,), FLEX_SLICED_DW_SEEDS, "flex_widths")
    res["seconds"] = time.perf_counter() - t0
    phase("flex_widths", f"the phase took {res['seconds']:.1f} s")
    return res


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
    K3; a Flexible-family config through K4f / K4b) against the f32 plain
    path. Every parameter the f32 step gives a gradient gets one in bf16,
    within 0.25·max."""
    import torch

    from nerface_tpu_torch.config import CfgNode, FeatureFlags
    from nerface_tpu_torch.data.pipeline import RayFeed, batch_to_device
    from nerface_tpu_torch.models.nerf_models import _FlexibleFamily
    from nerface_tpu_torch.ops.kernels.fused_flex import fused_flex_backward, fused_flex_forward
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
    fused = fused_train_eligible(mc, mf, settings, flags, torch.bfloat16, dev, num_rays=TRAIN_RAYS)
    n_pass = 2 if mf is not None else 1
    flex = isinstance(mc, _FlexibleFamily)
    want = {"K1": n_pass, "K3f": 0, "K3b": 0} if fused else {"K1": 0, "K3f": n_pass, "K3b": n_pass}
    want.update(K4f=0, K4b=0)
    if flex:  # every pass through K4f, every gradient through K4b
        want.update(K1=0, K3f=0, K3b=0, K4f=n_pass, K4b=n_pass)
    latent = torch.randn(len(ds.i_train), 32, generator=torch.Generator().manual_seed(1)) * 0.1
    counters = dict(_launch_counts(), K4f=fused_flex_forward, K4b=fused_flex_backward)
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
    via = "K4" if flex else ("K1" if fused else "K3")
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
WINDOW_TIMED = 6  # timed blocks of WINDOW_K steps each way: 60 steps
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
                "mlp_fwd_kernel", "flex_chain_kernel", "flex_dx_kernel", "wide_chain_kernel", "wide_dx_kernel",
                "resample_kernel", "resample_long_kernel")


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
EVAL_SPLIT = {"n_train": 8, "n_val": 2, "n_test": 5}
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


REENACT_SIZE = 128  # the paper's shape holds from 128² (2048 rays, 64 + 64 samples)
# the demo's smoke regime below 128² (512 rays, 16 + 16 samples): the
# kernels take it at S = 16 and 32
REENACT_SMALL_SIZE = 64
REENACT_WINDOW_STEPS = 100  # the small regime's windowed run against step at a time
REENACT_WINDOW_K = 10
REENACT_FRAMES = 60
REENACT_ITERS = 2000
REENACT_F32_FRAMES = 2  # driven frames rendered again by the f32 plain path


class _StampedOut(io.StringIO):
    """Captured standard output that also records when each [TRAIN] line
    was written: (iteration, perf_counter seconds)."""

    def __init__(self):
        super().__init__()
        self.stamps = []

    def write(self, text):
        m = re.match(r"\[TRAIN\] Iter: (\d+)", text)
        if m:
            self.stamps.append((int(m.group(1)), time.perf_counter()))
        return super().write(text)


def _steady_step_ms(stamps):
    """The median ms a step between consecutive [TRAIN] lines after the
    first interval (which holds the eager steps and the capture). The loop
    prints a line once the card has finished that step, so the intervals
    read the card's pace."""
    per = [(t1 - t0) * 1e3 / (j1 - j0) for (j0, t0), (j1, t1) in zip(stamps[1:], stamps[2:])]
    return statistics.median(per) if per else float("nan"), per


def _avi_frames(path):
    """The frame count an MJPEG AVI declares (avih dwTotalFrames) and the
    count of its index entries."""
    import struct

    with open(path, "rb") as f:
        blob = f.read()
    avih = blob.index(b"avih") + 8
    idx1 = blob.rindex(b"idx1")
    return (struct.unpack("<I", blob[avih + 16:avih + 20])[0],
            struct.unpack("<I", blob[idx1 + 4:idx1 + 8])[0] // 16)


def reenact_phase(dev, tmp, card, size=REENACT_SIZE, name="reenact"):
    """The cross-actor reenactment path (`tools/reenactment_demo.py`'s
    `main`) at size², REENACT_FRAMES frames a tracker identity,
    REENACT_ITERS bf16 steps on the card: the dataset build, K1 in
    training, K2 in its validations and both evaluations (the wrappers'
    counts reset at each stage's start and read at its end), no bf16 pass
    of the paper model on the plain path anywhere in the demo (counted at
    the dispatch, `plain_paper_passes`), the
    summary's metrics, the 60-frame AVI; then the self-reenactment PSNR
    against the untrained avatar's (checkpoint00001: the [quality] rule at
    REENACT_SIZE², above it at the small regime), REENACT_F32_FRAMES driven
    frames against the f32 plain frames of the same checkpoint, and
    `cli/build_dataset.py --mode driven` against the demo's test split. In
    the small regime (size < 128: 512 rays, 16 + 16 samples) also
    REENACT_WINDOW_STEPS steps of the demo's config windowed
    (REENACT_WINDOW_K) against step at a time, bit for bit."""
    import numpy as np
    import torch
    from PIL import Image

    from nerface_tpu_torch.cli import build_dataset as cli_build
    from nerface_tpu_torch.config import EvalFlags, load_config
    from nerface_tpu_torch.eval import driver
    from nerface_tpu_torch.metrics.harness import two_folders
    from nerface_tpu_torch.tools import dataset_builder as B
    from nerface_tpu_torch.tools import reenactment_demo as demo
    from nerface_tpu_torch.train import loop

    w = os.path.join(tmp, name)
    counters = _launch_counts()
    stages = []
    real = {"tracker": (demo, "make_tracker_identity"), "build": (B, "build_dataset"),
            "train": (loop, "train"), "evaluate": (driver, "evaluate")}
    originals = {k: getattr(mod, attr) for k, (mod, attr) in real.items()}

    def staged(name, fn):
        def run(*a, **k):
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            result = fn(*a, **k)
            torch.cuda.synchronize()
            stages.append({"stage": name, "s": time.perf_counter() - t0, "result": result,
                           "launches": {n: c.launches for n, c in counters.items()}})
            return result
        return run

    out = _StampedOut()
    argv = ["--size", str(size), "--frames", str(REENACT_FRAMES), "--iters",
            str(REENACT_ITERS), "--workdir", w, "--device", str(dev)]
    t0 = time.perf_counter()
    try:
        for k, (mod, attr) in real.items():
            setattr(mod, attr, staged(k, originals[k]))
        with contextlib.redirect_stdout(out), plain_paper_passes() as plain:
            summary = demo.main(argv)
    finally:
        for k, (mod, attr) in real.items():
            setattr(mod, attr, originals[k])
    demo_s = time.perf_counter() - t0
    plain_passes = plain[0]
    check(plain_passes == 0, f"{name}: {plain_passes} bf16 paper passes took the plain path")
    text = out.getvalue()
    by = {}
    for st in stages:
        by.setdefault(st["stage"], []).append(st)
    check(len(by.get("tracker", [])) == 2 and len(by.get("build", [])) == 1
          and len(by.get("train", [])) == 1 and len(by.get("evaluate", [])) == 2,
          f"{name}: stages {[st['stage'] for st in stages]}")
    check(f"bf16=True, {dev}" in text, f"{name}: the demo did not train in bf16 on the card")
    check("execution window: 50 steps" in text, f"{name}: training did not take the window")
    tr, (ev_self, ev_drv) = by["train"][0], by["evaluate"]
    check(tr["launches"]["K1"] > 0 and tr["launches"]["K2"] > 0
          and tr["launches"]["K3f"] == tr["launches"]["K3b"] == 0,
          f"{name}: training launches {tr['launches']} (K1 steps, K2 validations)")
    for label, ev in (("self", ev_self), ("driven", ev_drv)):
        check(ev["launches"]["K2"] > 0 and ev["launches"]["K1"] == ev["launches"]["K3f"] == 0,
              f"{name}: {label} evaluation launches {ev['launches']}")
    s_self, s_drv = summary["self_reenactment"], summary["cross_reenactment"]
    check(all(math.isfinite(s_self[k]) for k in ("psnr", "ssim", "l1")) and s_self["frames"] == 10,
          f"{name}: self-reenactment {s_self}")
    check(s_drv["temporal_std"] > 1.0 and s_drv["frames"] == REENACT_FRAMES,
          f"{name}: driven {s_drv}")
    avi = _avi_frames(summary["video"])
    check(avi == (REENACT_FRAMES, REENACT_FRAMES), f"{name}: the AVI holds {avi} frames")
    step_ms, per = _steady_step_ms(out.stamps)
    psnr = {int(m[0]): float(m[3]) for m in re.findall(_TRAIN_LINE, text)}
    tracker_s = sum(st["s"] for st in by["tracker"])
    phase(name, f"reenactment_demo.main at {size}x{size}, {REENACT_FRAMES} "
                     f"frames, {REENACT_ITERS} bf16 steps on {card}: {demo_s:.1f} s in all; two "
                     f"tracker identities rendered in {tracker_s:.1f} s, dataset build "
                     f"{by['build'][0]['s']:.2f} s, training {tr['s']:.1f} s (K1 wrapper calls "
                     f"{tr['launches']['K1']}, K2 {tr['launches']['K2']}), steady windowed step "
                     f"{step_ms:.3f} ms (median of {len(per)} print intervals: "
                     f"{[round(x, 3) for x in per]}), printed PSNR {psnr}")
    phase(name, f"self-reenactment: {s_self['frames']:.0f} frames, avg_time_per_image "
                     f"{s_self['s_per_frame'] * 1e3:.2f} ms, {ev_self['s']:.2f} s in evaluate, "
                     f"K2 {ev_self['launches']['K2']}; PSNR {s_self['psnr']:.3f} dB, SSIM "
                     f"{s_self['ssim']:.4f}, L1 {s_self['l1']:.5f}")
    phase(name, f"cross-actor driven: {s_drv['frames']:.0f} frames, avg_time_per_image "
                     f"{s_drv['s_per_frame'] * 1e3:.2f} ms, {ev_drv['s']:.2f} s in evaluate, K2 "
                     f"{ev_drv['launches']['K2']}; temporal_std {s_drv['temporal_std']:.3f}; "
                     f"{summary['video']} holds {avi[0]} frames")

    ds_dir = os.path.join(w, "target_ds")
    cfg = load_config(os.path.join(w, "cfg.yml"))
    # the driven split is the dataset's test split now: its first frames
    # again, f32 through the plain path, from the same checkpoint
    ckpt = os.path.join(w, "logs", "avatar", f"checkpoint{REENACT_ITERS:05d}.ckpt")
    for c in counters.values():
        c.launches = 0
    f32_dir = os.path.join(w, "renders_driven_f32")
    driver.evaluate(cfg, ckpt, f32_dir, eval_flags=EvalFlags(), max_frames=REENACT_F32_FRAMES,
                    log=False, dtype=None, device=dev)
    check(all(c.launches == 0 for c in counters.values()),
          f"{name}: the f32 plain path launched {[(n, c.launches) for n, c in counters.items()]}")
    vs_f32 = []
    for i in range(REENACT_F32_FRAMES):
        a = _png(os.path.join(w, "renders_driven", f"{i:04d}.png")).astype(np.int16)
        b = _png(os.path.join(f32_dir, f"{i:04d}.png")).astype(np.int16)
        diff = np.abs(a - b)
        vs_f32.append((float(diff.mean()), int(diff.max())))
        check(int(diff.max()) <= FRAME_MAX and float(diff.mean()) <= FRAME_MEAN,
              f"{name}: bf16 driven frame {i} vs f32: mean {diff.mean()}, max {diff.max()}")

    window = _reenact_window(cfg, w, dev, name) if size < 128 else None

    # cli/build_dataset.py --mode driven on the same two tracker dirs
    cli_dir = os.path.join(w, "cli_driven")
    _cli(cli_build.main, ["--source", os.path.join(w, "tracker_target"), "--target", cli_dir,
                          "--driving", os.path.join(w, "tracker_driving"), "--mode", "driven",
                          "--n-max", str(REENACT_FRAMES), "--reserve-test", "10", "--seed", "0",
                          "--neutral-driving-idx", "0", "--neutral-target-idx", "0"])
    with open(os.path.join(cli_dir, "transforms_test.json")) as fa, \
            open(os.path.join(ds_dir, "transforms_test.json")) as fb:
        check(json.load(fa) == json.load(fb),
              f"{name}: cli/build_dataset.py --mode driven wrote another transforms_test.json")

    # the untrained avatar (the first checkpoint) on the self-reenactment split
    B.generate_original_test_sequence(
        B.BuilderConfig(source=os.path.join(w, "tracker_target"), target=ds_dir,
                        reserve_test=10), log=False)
    first_dir = os.path.join(w, "renders_self_first")
    for c in counters.values():
        c.launches = 0
    driver.evaluate(cfg, os.path.join(w, "logs", "avatar", "checkpoint00001.ckpt"), first_dir,
                    eval_flags=EvalFlags(), log=False, dtype=torch.bfloat16, device=dev)
    k2_first = counters["K2"].launches
    first = two_folders(os.path.join(ds_dir, "test"), first_dir, log=False, device=dev)
    gain = s_self["psnr"] - first["PSNR"]
    min_gain = QUALITY_GAIN_DB if size >= 128 else 0.0
    check(gain >= min_gain and gain > 0.0,
          f"{name}: self-reenactment {s_self['psnr']:.3f} dB, untrained {first['PSNR']:.3f} dB")
    phase(name, f"bf16 driven frames vs the f32 plain frames of the checkpoint: (mean "
                     f"|diff|, max) {[(round(m, 4), x) for m, x in vs_f32]} levels (limits "
                     f"{FRAME_MEAN}, {FRAME_MAX}); cli/build_dataset.py --mode driven wrote the "
                     f"demo's transforms_test.json; self-reenactment {s_self['psnr']:.3f} dB vs "
                     f"the untrained avatar's {first['PSNR']:.3f} dB (checkpoint00001, K2 "
                     f"{k2_first}): +{gain:.2f} dB (limit {min_gain})")
    return {"launches": {"K1": tr["launches"]["K1"],
                         "K2": tr["launches"]["K2"] + ev_self["launches"]["K2"]
                         + ev_drv["launches"]["K2"]},
            "launches_by_stage": {"train": tr["launches"], "eval_self": ev_self["launches"],
                                  "eval_driven": ev_drv["launches"]},
            "demo_s": demo_s, "tracker_s": tracker_s, "build_s": by["build"][0]["s"],
            "train_s": tr["s"], "step_ms": step_ms, "step_ms_intervals": per,
            "eval_s": {"self": ev_self["s"], "driven": ev_drv["s"]},
            "avg_time_per_image": {"self": s_self["s_per_frame"],
                                   "driven": s_drv["s_per_frame"]},
            "summary": summary, "vs_f32": vs_f32, "untrained_psnr": first["PSNR"],
            "gain_db": gain, "plain_paper_passes": plain_passes, "window": window}


def _reenact_window(cfg, w, dev, name):
    """REENACT_WINDOW_STEPS bf16 steps of the demo's config (its dataset,
    its sample counts) windowed at REENACT_WINDOW_K against step at a time:
    the last .ckpt (parameters, latent table, Adam state) and the printed
    [TRAIN] / [VAL] lines bit for bit, K1 taking every step of both runs
    and no bf16 paper pass on the plain path."""
    import glob

    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.ops.kernels import fused_train as T
    from nerface_tpu_torch.train.loop import train

    runs = {}
    for k in (REENACT_WINDOW_K, 1):
        d = copy.deepcopy(cfg.to_dict())
        d["experiment"].update(logdir=os.path.join(w, f"window_{k}"), train_iters=REENACT_WINDOW_STEPS,
                               print_every=10, validate_every=REENACT_WINDOW_STEPS // 2,
                               save_every=REENACT_WINDOW_STEPS // 2, steps_per_execute=k)
        T.fused_train_pass.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), plain_paper_passes() as plain:
            train(CfgNode(d), dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        text = out.getvalue()
        ckpt = sorted(glob.glob(os.path.join(w, f"window_{k}", "**", "checkpoint*.ckpt"), recursive=True))[-1]
        runs[k] = {"s": time.perf_counter() - t0, "k1": T.fused_train_pass.launches,
                   "plain": plain[0], "ckpt": ckpt,
                   # the printed values, not the timings beside them
                   "lines": re.findall(_TRAIN_LINE, text) + re.findall(_VAL_LINE, text)}
        window = re.search(r"execution window: (\d+) steps", text)
        check((int(window.group(1)) if window else 1) == k, f"{name}: the run at K = {k} took another window")
        check(runs[k]["k1"] > 0 and runs[k]["plain"] == 0,
              f"{name}: K = {k}: K1 calls {runs[k]['k1']}, plain bf16 paper passes {runs[k]['plain']}")
    a, b = runs[REENACT_WINDOW_K], runs[1]
    differ = _differ(_ckpt_tensors(a["ckpt"]), _ckpt_tensors(b["ckpt"]))
    check(os.path.basename(a["ckpt"]) == os.path.basename(b["ckpt"]) and not differ,
          f"{name}: windowed vs step at a time differ in {differ[:5]} ({a['ckpt']}, {b['ckpt']})")
    check(a["lines"] == b["lines"] and len(a["lines"]) > REENACT_WINDOW_STEPS // 10,
          f"{name}: the printed lines differ: {a['lines'][:3]} vs {b['lines'][:3]}")
    phase(name, f"{REENACT_WINDOW_STEPS} bf16 steps of the demo's config windowed (K = {REENACT_WINDOW_K}, "
                f"{a['s']:.1f} s) vs step at a time ({b['s']:.1f} s): {os.path.basename(a['ckpt'])} "
                f"bit for bit, {len(a['lines'])} printed lines equal; K1 wrapper calls {a['k1']} / "
                f"{b['k1']}, plain bf16 paper passes 0 / 0")
    return {"windowed_s": a["s"], "step_s": b["s"], "k1_calls": (a["k1"], b["k1"]),
            "ckpt": os.path.basename(a["ckpt"])}


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


DDP_STEPS = 40
DDP_K = 10
DDP_GLOO_STEPS = 5  # the spawned ranks' start-up dominates; more steps only lengthen the run
DDP_WORLD_MAX = 4
DDP_TIMED_STEPS = 11  # the first timed one warms up


def state_numel(state):
    """The gradients' count of a TrainState: every trained tensor's size."""
    return sum(p.numel() for p in state.ordered_params() + [state.background_slot()]
               if p.requires_grad)


def _ddp_cfg(ds_dir, logdir, run_id, k, steps=None, device_feed=True, print_every=10,
             validate_every=20, save_every=20):
    """configs/synth512_devfeed.yml's settings (synth512_paper, the device
    feed) on the dataset at `ds_dir`, cut to `steps` steps at
    `steps_per_execute` k: print every 10, validate at 0 and 20, save every
    20 and at the end."""
    d = copy.deepcopy(SYNTH512_PAPER)
    d["experiment"].update(id=run_id, logdir=logdir, train_iters=steps or DDP_STEPS,
                           print_every=print_every,
                           validate_every=validate_every, save_every=save_every,
                           steps_per_execute=k, device_feed=device_feed)
    d["dataset"]["basedir"] = ds_dir
    return d


def _ckpt_tensors(path):
    """A .ckpt's parameters, latent table and Adam state, by name."""
    from nerface_tpu_torch.train.checkpoint import load_torch_checkpoint

    c = load_torch_checkpoint(path)
    out = {f"coarse.{k}": v for k, v in c["coarse"].items()}
    out.update({f"fine.{k}": v for k, v in c["fine"].items()})
    out["latent_codes"] = c["latent_codes"]
    for i, st in c["optimizer"]["state"].items():
        out.update({f"{f}/{i}": st[f] for f in ("step", "exp_avg", "exp_avg_sq")})
    return out


def _differ(a, b):
    """The names whose tensors are not bit for bit the same."""
    import torch

    if a.keys() != b.keys():
        return sorted(set(a) ^ set(b))
    return [k for k in a if not torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))]


def _nccl_kernels(prof):
    """(runs, device ms) of the NCCL kernels that torch.profiler read."""
    from torch.autograd import DeviceType

    runs, us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower():
            runs += e.count
            t = getattr(e, "device_time_total", None)
            us += t if t is not None else e.cuda_time_total
    return runs, us / 1e3


def _ddp_cli_run(cfg_path, dev, extra=(), profile=False):
    """`cli/train.py --bf16` on `dev` in this process, the launch counts
    reset just before and read just after, the graph replays counted, and
    with `profile` under torch.profiler: (printed text, launches, replays,
    kernel runs, (NCCL kernel runs, their device ms), wall s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from nerface_tpu_torch.cli import train as cli_train

    counters = _launch_counts()
    for c in counters.values():
        c.launches = 0
    calls = {"replays": 0}
    replay = torch.cuda.CUDAGraph.replay

    def counted_replay(g):
        calls["replays"] += 1
        return replay(g)

    argv = ["--config", cfg_path, "--device", str(dev), "--bf16", *extra]
    torch.cuda.CUDAGraph.replay = counted_replay
    runs = nccl = None
    t0 = time.perf_counter()
    try:
        if profile:
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, text = _cli(cli_train.main, argv)
                torch.cuda.synchronize()
            runs, nccl = kernel_runs(prof), _nccl_kernels(prof)
        else:
            _, text = _cli(cli_train.main, argv)
    finally:
        torch.cuda.CUDAGraph.replay = replay
    return {"text": text, "launches": {k: c.launches for k, c in counters.items()},
            "replays": calls["replays"], "runs": runs, "nccl": nccl,
            "wall": time.perf_counter() - t0}


def _k1_dp_limits(name, n_rays=None):
    """(max, norm) limits of a DP step's gradient tensor `name` (two ranks
    of n_rays / 2 rays, default TRAIN_RAYS) against the one-process step's
    (n_rays), relative to the latter's max|g| and ‖g‖: each is within
    `k1_grad_limits` of the same f32 plain gradient at its ray count, so
    their difference is within the sum (the direction branch's weights
    take its own max limit)."""
    n_rays = n_rays or TRAIN_RAYS
    key = "wd0" if "layers_dir" in name else name
    a, b = k1_grad_limits(n_rays // 2, key), k1_grad_limits(n_rays, key)
    return a[0] + b[0], a[1] + b[1]


def ddp_train_phase(dev, ds, tmp, ds_dir, card):
    """Data parallelism on the main path (train/distributed.py):

    (a) NCCL at world 1 through `cli/train.py`'s coordinator flags on the
        card: synth512_devfeed's settings, DDP_STEPS steps at K = DDP_K
        (the collective captured in the step's graph) and at K = 1, each
        checkpoint bit for bit the one-process run's (no group); K1 and
        the NCCL kernels' runs from torch.profiler; the steady windowed
        step with the group against without (medians of WINDOW_TIMED
        blocks, in turns).
    (b) gloo at world 2, both ranks on the card: synth512_paper's host
        feed (TRAIN_RAYS global rays, TRAIN_RAYS / 2 a rank through K1),
        K = 1, DDP_GLOO_STEPS steps of `train()` in each rank, the ranks'
        parameters bit for bit the same; one DP step's gradients (Adam's
        first moments) against the one-process step's on the same global
        batch within `_k1_dp_limits`.
    (c) NCCL at world min(device_count, DDP_WORLD_MAX) through
        `--num-devices`, only where the host has 2 cards or more."""
    import numpy as np
    import torch

    from nerface_tpu_torch.config import CfgNode, FeatureFlags
    from nerface_tpu_torch.data.flame import load_flame_data
    from nerface_tpu_torch.data.pipeline import RayFeed, batch_to_device
    from nerface_tpu_torch.render.pipeline import RenderSettings
    from nerface_tpu_torch.train import distributed, dryrun
    from nerface_tpu_torch.train.fused import fused_train_eligible
    from nerface_tpu_torch.train.loop import setup_background

    t_phase = time.perf_counter()
    res = {"launches": {}}

    # (a) NCCL at world 1, windowed and step at a time, against no group
    ckpts, runs = {}, {}
    for name, k, coord, profile in (("single", DDP_K, False, False),
                                    ("nccl_windowed", DDP_K, True, True),
                                    ("nccl_k1", 1, True, False)):
        logdir = os.path.join(tmp, f"ddp_{name}")
        cfg_path = _write_cfg(_ddp_cfg(ds_dir, logdir, "ddp", k), logdir + ".yml")
        extra = (["--coordinator-address", f"127.0.0.1:{distributed.free_port()}",
                  "--num-processes", "1", "--process-id", "0"] if coord else [])
        r = runs[name] = _ddp_cli_run(cfg_path, dev, extra, profile)
        check(not distributed.initialized(), f"ddp_train ({name}): the group was not left")
        ckpts[name] = _ckpt_tensors(os.path.join(logdir, "ddp", f"checkpoint{DDP_STEPS:05d}.ckpt"))
        printed = re.findall(_TRAIN_LINE, r["text"])
        check([int(p[0]) for p in printed] == list(range(0, DDP_STEPS, 10)) + [DDP_STEPS - 1],
              f"ddp_train ({name}): printed steps {[p[0] for p in printed]}")
        r["printed"] = printed
        want_k1 = 2 * DDP_STEPS if k == 1 else 2 * 2 + 2
        check(r["launches"]["K1"] == want_k1,
              f"ddp_train ({name}): K1 wrapper calls {r['launches']['K1']}, expected {want_k1}")
    for name in ("nccl_windowed", "nccl_k1"):
        bad = _differ(ckpts["single"], ckpts[name])
        check(not bad, f"ddp_train: {name} differs from the one-process run in {bad[:5]}")
        check(runs[name]["printed"] == runs["single"]["printed"],
              f"ddp_train: {name}'s printed lines differ from the one-process run's")
    win = runs["nccl_windowed"]
    check(win["replays"] == DDP_STEPS - 2,
          f"ddp_train: {win['replays']} graph replays, expected {DDP_STEPS - 2}")
    check(win["runs"]["train_pass_kernel"] == 2 * DDP_STEPS,
          f"ddp_train: K1 ran {win['runs']['train_pass_kernel']} times on the card")
    nccl_runs, nccl_ms = win["nccl"]
    res["nccl_world1"] = {"kernel_runs": nccl_runs, "device_ms": nccl_ms,
                          "device_ms_a_step": nccl_ms / DDP_STEPS}
    for name, r in runs.items():
        res["launches"][name] = r["launches"]

    # the steady windowed step with the one-rank group against without, in turns
    cfg = CfgNode(_window_cfg(tmp, WINDOW_K, True))
    steady = {"no_group": [], "nccl_world1": []}
    for turn in ("no_group", "nccl_world1", "nccl_world1", "no_group"):
        if turn == "nccl_world1":
            distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device=dev)
        try:
            steady[turn] += _window_steady(cfg, ds, dev, WINDOW_K, True)[0]
        finally:
            if turn == "nccl_world1":
                distributed.shutdown()
    res["step_ms"] = {k: statistics.median(v) for k, v in steady.items()}
    phase("ddp_train", f"(a) NCCL world 1 via --coordinator-address: {DDP_STEPS} steps of "
                       f"synth512_devfeed at {EVAL_SIZE}x{EVAL_SIZE}, K={DDP_K} "
                       f"({win['replays']} graph replays, K1 ran "
                       f"{win['runs']['train_pass_kernel']} times from {win['launches']['K1']} "
                       f"calls, {nccl_runs} NCCL kernel runs on the card, "
                       f"{nccl_ms / DDP_STEPS:.4f} ms a step) = K=1 = no group, bit for bit "
                       f"({len(ckpts['single'])} tensors of the step-{DDP_STEPS} checkpoint, "
                       f"printed lines); steady windowed step {res['step_ms']['nccl_world1']:.3f} "
                       f"ms with the group vs {res['step_ms']['no_group']:.3f} ms without "
                       f"(medians of {2 * WINDOW_TIMED} blocks of {WINDOW_K} each, in turns; "
                       f"with min {min(steady['nccl_world1']):.3f} max "
                       f"{max(steady['nccl_world1']):.3f}, without min "
                       f"{min(steady['no_group']):.3f} max {max(steady['no_group']):.3f}) on {card}")

    # (b) gloo at world 2 on the one card: DDP_GLOO_STEPS steps of train()
    gloo_cfg = _ddp_cfg(ds_dir, os.path.join(tmp, "ddp_gloo"), "ddp_gloo", 1,
                        steps=DDP_GLOO_STEPS, device_feed=False, print_every=DDP_GLOO_STEPS,
                        validate_every=0, save_every=0)
    t0 = time.perf_counter()
    ranks = distributed.spawn(dryrun.train_replica, 2, args=(gloo_cfg, str(dev), True),
                              devices=[str(dev)] * 2, backend="gloo", timeout=600)
    gloo_s = time.perf_counter() - t0
    bad = _differ(ranks[0]["arrays"], ranks[1]["arrays"])
    check(not bad, f"ddp_train (b): the ranks differ in {bad[:5]}")
    for r, out in enumerate(ranks):
        check(out["launches"]["K1"] == 2 * DDP_GLOO_STEPS,
              f"ddp_train (b): rank {r} made {out['launches']['K1']} K1 calls")
    one = dryrun.train_replica(gloo_cfg, str(dev), True)
    disk_ds = load_flame_data(ds_dir)
    upd = {}
    init = dryrun.replica_arrays(_fresh_state(CfgNode(gloo_cfg), disk_ds, "cpu"))
    for k, v in one["arrays"].items():
        d1, d2 = v - init[k], ranks[0]["arrays"][k] - init[k]
        upd[k] = float(np.linalg.norm(d2 - d1) / max(np.linalg.norm(d1), 1e-30))
    res["gloo"] = {"seconds": gloo_s, "k1_calls_a_rank": ranks[0]["launches"]["K1"],
                   "update_rel_diff_max": max(upd.values())}

    # one DP step's gradients against the one-process step's, same global batch
    cfg_b = CfgNode(gloo_cfg)
    state = _fresh_state(cfg_b, disk_ds, "cpu")
    flags = FeatureFlags.from_cfg(cfg_b)
    settings = RenderSettings.from_cfg(cfg_b, mode="train")
    bg = setup_background(disk_ds, flags)
    batch = RayFeed(disk_ds, TRAIN_RAYS, background=bg if flags.fixed_background else None,
                    seed=SEED, native=False).sample_batch()
    check(fused_train_eligible(state.model_coarse, state.model_fine, settings, flags,
                               torch.bfloat16, dev, num_rays=TRAIN_RAYS),
          "ddp_train (b): the step is not K1's")
    payload = {"state": state, "opt_cfg": {k: gloo_cfg[k] for k in ("optimizer", "scheduler")},
               "batch": batch_to_device(batch, "cpu"), "settings": settings, "flags": flags,
               "seed": 3, "dtype": torch.bfloat16, "fused": True, "device": str(dev),
               "timed_steps": DDP_TIMED_STEPS}
    single = dryrun.dp_step(payload)
    pair = dryrun.dryrun(payload, 2, timeout=600)
    bad = _differ(pair[0]["arrays"], pair[1]["arrays"])
    check(not bad, f"ddp_train (b): the DP step's ranks differ in {bad[:5]}")
    worst = {}
    for k, g1 in single["arrays"].items():
        if not k.startswith("exp_avg/"):
            continue
        g2 = pair[0]["arrays"][k]
        lim_max, lim_norm = _k1_dp_limits(k)
        e_max = float(np.abs(g2 - g1).max() / max(np.abs(g1).max(), 1e-30))
        e_norm = float(np.linalg.norm(g2 - g1) / max(np.linalg.norm(g1), 1e-30))
        check(e_max <= lim_max and e_norm <= lim_norm,
              f"ddp_train (b): {k}: max {e_max:.4f} (limit {lim_max}), norm {e_norm:.4f} "
              f"(limit {lim_norm})")
        worst[k] = (e_max, e_norm)
    res["gloo"]["step_grad_rel"] = {"max": max(v[0] for v in worst.values()),
                                    "norm": max(v[1] for v in worst.values())}
    # the step's wall ms (steps after the first, each synchronised)
    res["gloo"]["step_ms"] = {"one_process": statistics.median(single["step_ms"][1:]),
                              **{f"rank{r}": statistics.median(p["step_ms"][1:])
                                 for r, p in enumerate(pair)}}
    res["gloo"]["all_reduce_ms"] = {f"rank{r}": statistics.median(p["all_reduce_ms"][1:])
                                    for r, p in enumerate(pair)}
    res["launches"]["gloo_ranks"] = 2 * ranks[0]["launches"]["K1"]
    phase("ddp_train", f"(b) gloo world 2, both ranks on {dev}: {DDP_GLOO_STEPS} steps of "
                       f"synth512_paper ({TRAIN_RAYS} global rays, host feed, K=1) in "
                       f"{gloo_s:.1f} s, K1 called {ranks[0]['launches']['K1']} times in each "
                       f"rank, the ranks' {len(ranks[0]['arrays'])} tensors bit for bit equal; "
                       f"their updates against the one-process run's: worst relative norm "
                       f"{res['gloo']['update_rel_diff_max']:.4f} (reported, no limit); one DP "
                       f"step's gradients against the one-process step's: worst max "
                       f"{res['gloo']['step_grad_rel']['max']:.4f}, worst norm "
                       f"{res['gloo']['step_grad_rel']['norm']:.4f} of "
                       f"{len(worst)} tensors (limits k1_grad_limits({TRAIN_RAYS // 2}) + "
                       f"k1_grad_limits({TRAIN_RAYS}): trunk "
                       f"{_k1_dp_limits('coarse.fc_alpha.weight')}, direction branch "
                       f"{_k1_dp_limits('coarse.layers_dir.0.weight')}); a step at K=1 "
                       f"(median of {DDP_TIMED_STEPS - 1}, synchronised): rank 0 "
                       f"{res['gloo']['step_ms']['rank0']:.3f} ms, rank 1 "
                       f"{res['gloo']['step_ms']['rank1']:.3f} ms, the one-process step "
                       f"{res['gloo']['step_ms']['one_process']:.3f} ms; the gloo all-reduce "
                       f"of the {int(state_numel(state))} gradients + metrics alone "
                       f"{res['gloo']['all_reduce_ms']['rank0']:.3f} / "
                       f"{res['gloo']['all_reduce_ms']['rank1']:.3f} ms on {card}")

    # (c) NCCL over the host's cards
    count = torch.cuda.device_count()
    if count < 2:
        phase("ddp_train", f"(c) NCCL at world >= 2 not run: this host has {count} CUDA device")
        res["nccl_multi"] = None
    else:
        from nerface_tpu_torch.cli import train as cli_train

        world = min(count, DDP_WORLD_MAX)
        logdir = os.path.join(tmp, "ddp_multi")
        cfg_path = _write_cfg(_ddp_cfg(ds_dir, logdir, "ddp", DDP_K), logdir + ".yml")
        t0 = time.perf_counter()
        cli_train.main(["--config", cfg_path, "--bf16", "--num-devices", str(world)])
        wall = time.perf_counter() - t0
        path = os.path.join(logdir, "ddp", f"checkpoint{DDP_STEPS:05d}.ckpt")
        check(os.path.isfile(path), f"ddp_train (c): no checkpoint at {path}")
        res["nccl_multi"] = {"world": world, "seconds": wall}
        phase("ddp_train", f"(c) NCCL world {world} via --num-devices: {DDP_STEPS} steps at "
                           f"K={DDP_K} in {wall:.1f} s on {card}")
    res["seconds"] = time.perf_counter() - t_phase
    phase("ddp_train", f"the phase took {res['seconds']:.1f} s")
    return res


def _fresh_state(cfg, ds, device):
    """`train()`'s initial state for `cfg` on `ds` (the seeded weights)."""
    import torch

    from nerface_tpu_torch.config import FeatureFlags
    from nerface_tpu_torch.train.loop import build_models_from_cfg, setup_background
    from nerface_tpu_torch.train.state import create_train_state

    flags = FeatureFlags.from_cfg(cfg)
    seed = int(cfg.experiment.randomseed)
    mc, mf = build_models_from_cfg(cfg, device=device,
                                   generator=torch.Generator().manual_seed(seed))
    return create_train_state(mc, mf, flags, n_train=len(ds.i_train),
                              background=setup_background(ds, flags), device=device)


SHARDED_DEVICES = 2
SHARDED_FRAMES = 2


def _extra_slots(server, n_dev, frame):
    """(H, W) bool: the pixels that a fast frame over `n_dev` devices
    renders in spare slots where the one-device frame leaves the
    background (JAX's rule rounds the capacity to whole tiles on every
    device; the slots' order is the same)."""
    import torch

    from nerface_tpu_torch.eval import renderer
    from nerface_tpu_torch.ops.rays import get_ray_bundle

    n = server.H * server.W
    tile = min(server.settings.chunksize, renderer.FAST_TILE, n)
    x = max(1, int(n * server.settings.fast_eval_capacity))

    def cap(m):
        return min(renderer._round_up(x, tile * m), renderer._round_up(n, tile * m))

    pose = torch.as_tensor(server._frame_defaults(frame)[0][:3, :4], dtype=torch.float32,
                           device=server.device)
    ro, rd = get_ray_bundle(server.H, server.W, server.intrinsics, pose)
    inside = renderer._active_mask(ro.reshape(n, 3), rd.reshape(n, 3), server.H, server.W,
                                   server.fast_bbox, server.occupancy, server.settings,
                                   pose=pose, intrinsics=server.intrinsics)
    order = torch.argsort((~inside).to(torch.int32), stable=True).cpu()
    extra = torch.zeros(n, dtype=torch.bool)
    extra[order.repeat(2)[cap(1):cap(n_dev)]] = True
    extra[order.repeat(2)[:cap(1)]] = False
    return extra.reshape(server.H, server.W).numpy(), cap(1), cap(n_dev)


def sharded_serve_phase(dev, tmp, ev, card):
    """Sharded rendering on the main path (`render_full_frame(devices=...)`):
    `AvatarServer(devices=[dev] * SHARDED_DEVICES)` against the one-device
    server on the eval phase's trained checkpoint, bf16: the parity frames
    (each map's floats and the served uint8 maps) bit for bit, K2 launched
    2 × tiles a frame; the fast frames bit for bit wherever the one-device
    frame renders or both leave the background (JAX's capacity rule may
    give the sharded frame more spare slots, which render real rays), K2
    2 × tiles; each frame's ms beside the one-device frame's; then
    `evaluate(devices=...)` over SHARDED_FRAMES test frames, its PNGs byte
    for byte the one-device run's."""
    import numpy as np
    import torch

    from nerface_tpu_torch.config import load_config
    from nerface_tpu_torch.eval.driver import evaluate
    from nerface_tpu_torch.eval.renderer import render_full_frame
    from nerface_tpu_torch.ops.kernels.fused_mlp import fused_paper_render
    from nerface_tpu_torch.serve import AvatarServer

    t_phase = time.perf_counter()
    devices = [dev] * SHARDED_DEVICES
    res = {"launches": {}, "frame_ms": {}}
    for mode in ("parity", "fast"):
        cfg = load_config(ev["cfg"])
        if mode == "fast":
            cfg.nerf.validation["fast_eval"] = True
        one = AvatarServer(cfg, ev["ckpt"], dtype=torch.bfloat16, device=dev, log=False)
        shard = AvatarServer(cfg, ev["ckpt"], dtype=torch.bfloat16, log=False, devices=devices)
        n = one.H * one.W
        if mode == "parity":
            tiles = parity_tiles = -(-n // min(one.settings.chunksize, n))
            extra, spare = np.zeros((one.H, one.W), bool), None
        else:
            extra, cap1, cap2 = _extra_slots(one, SHARDED_DEVICES, 0)
            tiles = cap2 // min(one.settings.chunksize, 16384, n)
            spare = (cap1, cap2)
        # the frames' floats, every map
        pose = one._frame_defaults(0)[0][:3, :4]
        kw = dict(seed=0, expressions=torch.as_tensor(one._default_expression, device=dev),
                  latent_code=one.latent_codes[0], background=one.background,
                  dtype=torch.bfloat16, bbox=one.fast_bbox, occupancy=one.occupancy)
        a = render_full_frame(one.model_coarse, one.model_fine, one.H, one.W, one.intrinsics,
                              pose, one.settings, device=dev, **kw)
        fused_paper_render.launches = 0
        b = render_full_frame(one.model_coarse, one.model_fine, one.H, one.W, one.intrinsics,
                              pose, one.settings, devices=devices, **kw)
        torch.cuda.synchronize()
        launched = fused_paper_render.launches
        check(launched == 2 * tiles,
              f"sharded_serve ({mode}): K2 launched {launched} times, expected 2 x {tiles}")
        keep = torch.from_numpy(~extra).to(dev)
        for k in a:
            check(torch.equal(a[k][keep], b[k][keep]),
                  f"sharded_serve ({mode}): {k} differs from the one-device frame")
        # the served frames, timed in turns
        maps = ("rgb_fine", "acc")
        ms = {"one": [], "sharded": []}
        for _ in range(3):
            for name, srv in (("one", one), ("sharded", shard)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = srv.render(frame=0, seed=1, maps=maps)
                ms[name].append((time.perf_counter() - t0) * 1e3)
                if name == "one":
                    ref = img
                else:
                    for k in maps:
                        check(np.array_equal(img[k][~extra], ref[k][~extra]),
                              f"sharded_serve ({mode}): the served {k} differs")
        res["launches"][mode] = launched
        res["frame_ms"][mode] = {k: v[1:] for k, v in ms.items()}
        phase("sharded_serve",
              f"{mode}: AvatarServer(devices=[{dev}] x {SHARDED_DEVICES}) bf16 at "
              f"{one.H}x{one.W}: K2 {launched} launches a frame (2 x {tiles} tiles), every map "
              f"bit for bit the one-device frame's"
              + ("" if spare is None else
                 f" outside the {int(extra.sum())} pixels of the extra spare slots "
                 f"(capacity {spare[0]} rays on one device, {spare[1]} over "
                 f"{SHARDED_DEVICES})")
              + f"; warm frame ms sharded {[round(v, 3) for v in ms['sharded'][1:]]} vs one "
                f"device {[round(v, 3) for v in ms['one'][1:]]} on {card}")
        del one, shard

    # evaluate over the device list against one device
    cfg = load_config(ev["cfg"])
    out = {}
    fused_paper_render.launches = 0
    for name, kw in (("sharded", {"devices": devices}), ("one", {"device": dev})):
        savedir = os.path.join(tmp, f"sharded_eval_{name}")
        out[name] = evaluate(cfg, ev["ckpt"], savedir, dtype=torch.bfloat16, log=False,
                             max_frames=SHARDED_FRAMES, **kw)
        if name == "sharded":
            res["launches"]["evaluate"] = fused_paper_render.launches
    files = {}
    for name in out:
        root = os.path.join(tmp, f"sharded_eval_{name}")
        files[name] = {os.path.relpath(os.path.join(d, f), root):
                       open(os.path.join(d, f), "rb").read()
                       for d, _, fs in os.walk(root) for f in fs}
    check(files["one"] and files["one"] == files["sharded"],
          "sharded_serve: evaluate(devices=...) wrote other files than one device")
    check(res["launches"]["evaluate"] == 2 * parity_tiles * SHARDED_FRAMES,
          f"sharded_serve: evaluate launched K2 {res['launches']['evaluate']} times, expected "
          f"2 x {parity_tiles} tiles x {SHARDED_FRAMES} frames")
    res["eval_avg_s"] = {k: v["avg_time_per_image"] for k, v in out.items()}
    res["seconds"] = time.perf_counter() - t_phase
    phase("sharded_serve", f"evaluate(devices=[{dev}] x {SHARDED_DEVICES}) over "
                           f"{SHARDED_FRAMES} test frames: {len(files['one'])} PNGs byte for byte "
                           f"the one-device run's, K2 {res['launches']['evaluate']} launches, "
                           f"avg_time_per_image {out['sharded']['avg_time_per_image']:.4f} s vs "
                           f"{out['one']['avg_time_per_image']:.4f} s on {card}; the phase "
                           f"took {res['seconds']:.1f} s")
    return res


def _k4_bytes(n_rays, n_samples, backward, n=None, h=256, bands=10):
    """The bytes K4f / K4b must move at n hidden layers (FLEX_N_HIDDEN),
    width h and `bands` xyz bands: each input read once (rays, depths,
    dir_c, v0, weights; g and the transposed weights for K4b), each output
    written once ((R, S, 4); the gradients and d_dir for K4b)."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels.fused_mlp import xin_extent

    n = FLEX_N_HIDDEN if n is None else n
    w = F.w_offsets(n, h, xin_extent(bands))["TOTAL"]
    f, wt = F.f_offsets(n, h)["TOTAL"], F.wt_offsets(n, h)["TOTAL"]
    rays = n_rays * 4 * (3 + 3 + n_samples + h // 2)
    samples = n_rays * n_samples * 4 * 4  # (R, S, 4) f32: the output, or g
    weights = 2 * w + 4 * f
    if not backward:
        return rays + samples + weights
    return rays + samples + weights + 2 * wt + 4 * (w + f) + n_rays * 4 * (h // 2)


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


def k3b_grad_limits(n_rays, name, tc_err):
    """(max, norm) limits of K3b's gradient tensor `name` in a pass of
    `n_rays` rays, relative to the plain version's max|r| and ‖r‖, given
    the yardstick's (max, norm) readings `tc_err` (`tensor_core_plain`):
    K3B_NORM_FLOOR's comment."""
    few = max(K1_GRAD_TOL_FEW_RAYS[0], K1_DIR_BRANCH_MAX_TOL.get(name, 0.0))
    floor = K3B_NORM_FLOOR if n_rays >= TRAIN_RAYS else K1_GRAD_TOL_FEW_RAYS[1]
    return tc_limit(few, tc_err[0]), tc_limit(floor, tc_err[1])


def tc_limit(base, tc):
    """A reading's limit where bf16 roundings that flip between two f32
    summation orders reach past `base`: no less than FLEX_TC_FACTOR × `tc`,
    the same reading of the plain version on the tensor cores
    (`tensor_core_plain`)."""
    return max(base, FLEX_TC_FACTOR * tc)


def flex_limit(base, n_hidden, tc=None):
    """The limit of one reading of K4f or K4b (relative to the plain
    version's max or norm) at `n_hidden` hidden layers: `base`, and
    `tc_limit(base, tc)` where the tensor-core yardstick decides: at
    n_hidden ≥ FLEX_TC_DEPTH, and at the sample counts beside 32 / 64 /
    128 (`flex_yardstick`), as for the paper kernels there; `tc`
    is the yardstick's reading, needed there only."""
    if tc is None or tc is False:
        check(n_hidden < FLEX_TC_DEPTH, f"a reading at {n_hidden} hidden layers needs the yardstick's")
        return base
    return tc_limit(base, tc)


def flex_yardstick(n_samples, n_hidden, h=256):
    """Whether the tensor-core yardstick decides K4's readings: at
    FLEX_TC_DEPTH hidden layers and more, at every S beside the
    [flex_kernel] cases' 32 / 64 / 128 (`tc_limit`), and at every S at the
    sliced widths h = 768 / 1024, whose sums have 3–4 × h = 256's terms (at
    h = 1024, n = 3 on 2048 × 64 / 128 one flipped rounding read w1b's ‖err‖
    0.0201 and w1a's max 0.0235 against the base 0.02; on an NVIDIA H100
    80GB HBM3, PERF.md §6)."""
    return n_hidden >= FLEX_TC_DEPTH or n_samples not in (32, 64, 128) or h in sliced_widths()


def flex_grad_limits(n_rays, name, n_hidden, tc_err=None, n_samples=64):
    """(max, norm) limits of K4b's gradient tensor `name` in a pass of
    n_rays × n_samples: `k1_grad_limits`, and given the tensor-core
    yardstick's (max, norm) readings `tc_err` (needed where
    `flex_yardstick` holds) each through `tc_limit`. Below FLEX_TC_DEPTH, a
    pass of fewer sample rows than the slice's coarse pass (TRAIN_RAYS ×
    64), whose sums have fewer terms, takes K1's few-ray max (as
    `k3b_grad_limits` holds K3b there): one flipped bf16 rounding read 1.86 × the
    yardstick's max at S = 1 (on an H100, PERF.md §6); its norm keeps the
    base, so a lost 64-row unit that the base limits catch is still
    caught (`_sample_control`)."""
    tol, tol_norm = k1_grad_limits(n_rays, name)
    if tc_err is None or tc_err is False:
        check(n_hidden < FLEX_TC_DEPTH, f"a reading at {n_hidden} hidden layers needs the yardstick's")
        return tol, tol_norm
    if n_hidden < FLEX_TC_DEPTH and n_rays * n_samples < TRAIN_RAYS * 64:
        tol = k1_grad_limits(0, name)[0]
    return tc_limit(tol, tc_err[0]), tc_limit(tol_norm, tc_err[1])


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


# [flex_kernel]'s cases: (label, rays, samples a ray, hidden layers, hidden
# width); the train step's pair and the serving tiles at synth512_lcode's n
# = 3, the kernels' other chunk sequences, n = 0 and 8 (the most they took
# before any depth), 12 hidden layers, and at h = 512 synth512_lcode_w512's
# train step pair and 10 hidden layers. The two deepest on DEEP_RAYS × 32
# (256 units): the yardstick's flip noise in dW falls as 1 / √units, a lost
# unit's share as 1 / units, and on 2048 × 64 at n = 12 the noise hid the
# lost unit (caught only up to a factor of 1.048, PERF.md §6)
DEEP_RAYS = 512
FLEX_CASES = (("coarse", TRAIN_RAYS, 64, FLEX_N_HIDDEN, 256), ("fine", TRAIN_RAYS, 128, FLEX_N_HIDDEN, 256),
              ("tile64", TILE_RAYS, 64, FLEX_N_HIDDEN, 256), ("tile128", TILE_RAYS, 128, FLEX_N_HIDDEN, 256),
              ("n0_s32", TRAIN_RAYS, 32, 0, 256), ("n8_s32", TRAIN_RAYS, 32, 8, 256),
              ("n12_s32", DEEP_RAYS, 32, 12, 256),
              ("coarse_512", TRAIN_RAYS, 64, FLEX_N_HIDDEN, FLEX_WIDE),
              ("fine_512", TRAIN_RAYS, 128, FLEX_N_HIDDEN, FLEX_WIDE),
              ("n10_s32_512", DEEP_RAYS, 32, 10, FLEX_WIDE))


def flex_kernel_phase(dev):
    """K4f and K4b against their plain versions on synth512_lcode's
    He-scaled weights (and the same model at 0, 8 and 12 hidden layers;
    synth512_lcode_w512's at 3 and 10), FLEX_SEEDS draws of weights and
    inputs a case; at n = 3 the wrappers' and the bare launches' times
    (`tools/perf/flex_launch_split.py`, the wrappers' own
    `_launch_flex_*`) and K4b's device time per launch. At n ≥
    FLEX_TC_DEPTH the tensor-core yardstick and the lost-unit control
    (`_flex_calibration`)."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.tools.perf import flex_launch_split as FS
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS
    from nerface_tpu_torch.tools.perf.cases import flex_params

    result = {"err": {}, "readings": {}, "ms": {}, "plain_ms": {}, "bound": {}, "tile_ms": {},
              "bare_ms": {}, "bwd_ms": {}, "bwd_plain_ms": {}, "bwd_bound": {}, "grad_rel": {},
              "bwd_bare_ms": {}, "bwd_split": {}, "abs_err": 0.0, "grad_abs_err": 0.0}
    models = {}
    for c, (label, R, S, n, h) in enumerate(FLEX_CASES):
        if (n, h) not in models:
            models[n, h] = [flex_params(SEED + 7 + 100 * i + (n if n != FLEX_N_HIDDEN else 0)
                                        + (h if h != 256 else 0), dev, n, h)
                            for i in range(FLEX_SEEDS)]
        wn, bn = F.weight_names(n)
        names = list(wn) + list(bn) + ["v0", "dir"]
        timed = n == FLEX_N_HIDDEN
        f_fwd, f_bwd = k4_flop_per_sample(n, h), k4_flop_per_sample(n, h, True)
        worst, out_err, out_lim, calib = {}, {"rgb": 0.0, "sigma": 0.0}, {"rgb": 0.0, "sigma": 0.0}, {}
        for i, (params, v0) in enumerate(models[n, h]):
            gen = torch.Generator().manual_seed(SEED + 8 + 100 * i + c)
            ro, rd, z, dc = _flex_inputs(R, S, gen, dev, h)
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
            case = dict(weights=weights, ro=ro, rd=rd, z=z, dc=dc, v0=v0, g=g, n=n, bands=10)
            if i == 0 and timed:
                flops = R * S * f_fwd
                key = "tile_ms" if R == TILE_RAYS else "ms"
                iters = 10 if R == TILE_RAYS else 15
                result[key][label] = _median_ms(lambda: F.fused_flex_forward(*args), iters=iters)
                result["bare_ms"][label] = _median_ms(FS.bare_fwd(case), iters=iters)
                if R == TRAIN_RAYS:
                    result["plain_ms"][label] = _median_ms(
                        lambda: F.fused_flex_forward_reference(*args), warmup=1, iters=5)
                    result["bound"][label] = _bound_ms(flops, _k4_bytes(R, S, False, n, h))
            if R == TILE_RAYS:  # the serving tiles: K4f only
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
                tol, tol_norm = flex_grad_limits(R, name, n, tc_err, S)
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
                result["bwd_bound"][label] = _bound_ms(R * S * f_bwd, _k4_bytes(R, S, True, n, h))
                bwd = FS.bare_bwd(case)
                result["bwd_bare_ms"][label] = _median_ms(bwd, iters=10)
                rows = split_rows(bwd, FS.launch_bounds(R, S, n, h))
                result["bwd_split"][label] = rows
                for short, row in rows.items():
                    phase("flex_kernel", f"  K4b h={h} S={S} {split_text(short, row)}")
        result["err"][label] = out_err
        line = (f"{label} R={R} S={S} n={n} h={h}, {FLEX_SEEDS} seeds: K4f max err rgb "
                f"{out_err['rgb']:.2e}·max, σ {out_err['sigma']:.2e}·max (limits "
                f"{out_lim['rgb']:.4g}, {out_lim['sigma']:.4g})")
        if R == TILE_RAYS:
            ms, bare = result["tile_ms"][label], result["bare_ms"][label]
            line += (f"; K4f {ms:.3f} ms, bare launch {bare:.3f} ms "
                     f"({R * S * f_fwd / bare / 1e9:.1f} TFLOP/s at "
                     f"{f_fwd / 1e6:.4f} MFLOP a sample, operations bound "
                     f"{R * S * f_fwd / PEAK_BF16_FLOPS * 1e3:.3f} ms)")
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
                         f"({R * S * f_fwd / fw / 1e9:.1f} TFLOP/s, bound "
                         f"{result['bound'][label][0]:.3f}), plain {result['plain_ms'][label]:.3f} ms; "
                         f"K4b {bw:.3f} ms, bare launch {result['bwd_bare_ms'][label]:.3f} ms "
                         f"({R * S * f_bwd / bw / 1e9:.1f} TFLOP/s at "
                         f"{f_bwd / 1e6:.4f} MFLOP a sample, bound "
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
# ray (tests/test_torch_k4_layout.py::DEAD_UNIT_CTA), at 8 hidden layers:
# the fixed layout classes and two runtime ones (8 rays in 3 units, one ray
# in 4 units with 56 padding rows)
DEAD_UNIT_CASES = ((2085, 64), (601, 128), (2133, 24), (267, 200))
DEAD_UNIT_PASSES = 200
# h = 512's persistent grid: a CTA a round of one item on both warpgroups,
# so no warpgroup walks a dead item; 2085 items at S = 64 take 16 rounds
# of 132 CTAs, the last one cut short
DEAD_UNIT_WIDE_CASE = (2085, 64)
# the same grid at h = 1024 (the sliced kernels), DEAD_UNIT_SLICED_PASSES
# passes (a pass there is ≈ 15 × h = 256's work)
DEAD_UNIT_SLICED_PASSES = 20


def flex_dead_units_phase(dev):
    """K4f + K4b at 8 hidden layers on DEAD_UNIT_CASES (S = 64 and 128, and
    the runtime layouts at S = 24 and 200), DEAD_UNIT_PASSES passes: the
    dead-unit walk of K4b's recompute and dX
    (`fused_flex.cu::skip_stages`), which trapped in the mbarrier watchdog
    before its repair; then the same at h = 512 on DEAD_UNIT_WIDE_CASE, a
    persistent grid past one round with a cut-short last round, and at h =
    1024 (DEAD_UNIT_SLICED_PASSES passes). Every pass's output and
    gradients equal the first pass's bit for bit. Nothing catches a fault:
    it fails the run."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    n = 8
    result = {}
    for R, S, h in ([(R, S, 256) for R, S in DEAD_UNIT_CASES] + [(*DEAD_UNIT_WIDE_CASE, FLEX_WIDE)]
                    + [(*DEAD_UNIT_WIDE_CASE, 1024)]):
        passes = DEAD_UNIT_SLICED_PASSES if h in sliced_widths() else DEAD_UNIT_PASSES
        if h == 256:
            sched = F.unit_schedule(R, S)
            dead = sorted({(c, r, wg) for c, r, wg, _, ok in sched if not ok})
            check(len(dead) == 1 and dead[0][2] == 1, f"flex_dead_units {R}x{S}: dead items {dead}")
        else:
            items = -(-R // F.unit_layout(S)[0])
            check(F.flex_ctas(R, S, h) == F.FLEX_CTAS < items and items % F.FLEX_CTAS,
                  f"flex_dead_units {R}x{S} h={h}: {items} items on {F.flex_ctas(R, S, h)} CTAs")
            dead = [(items % F.FLEX_CTAS, items // F.FLEX_CTAS, None)]  # the first CTA with a round fewer
        wall, n_tensors = _repeat_passes(dev, R, S, h, n, passes, "flex_dead_units")
        label = f"{R}x{S}" + ("" if h == 256 else f"_h{h}")
        result[label] = {"passes": passes, "seconds": wall, "dead_item": dead[0]}
        where = (f"the dead warpgroup-1 item in CTA {dead[0][0]}, round {dead[0][1]}" if h == 256 else
                 f"h = {h}: {F.FLEX_CTAS} CTAs, CTA {dead[0][0]} on takes {dead[0][1]} rounds, the ones "
                 f"before one more")
        phase("flex_dead_units", f"{R}x{S}, n = {n}: {passes} passes of K4f + K4b in "
                                 f"{wall:.2f} s, each bit for bit the first (outputs and "
                                 f"{n_tensors - 1} gradient tensors); {where}")
    return result


def _repeat_passes(dev, R, S, h, n, passes, name):
    """`passes` passes of K4f + K4b on one R × S case of synth512_lcode's
    He-scaled trunk at width h and n hidden layers: every pass's output and
    gradients equal to the first pass's bit for bit, all finite. A fault
    fails the run. Returns (seconds, tensors compared a pass)."""
    import torch

    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.tools.perf.cases import flex_params

    params, v0 = flex_params(SEED + R + n + (h if h != 256 else 0), dev, n, h)
    gen = torch.Generator().manual_seed(SEED + R + S)
    ro, rd, z, dc = _flex_inputs(R, S, gen, dev, h)
    weights = F.pack_flex_weights(params, n, 10)
    g = torch.randn(R, S, 4, generator=gen).to(dev)
    args = (weights, ro, rd, z, dc, v0)
    first = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        out = F.fused_flex_forward(*args, n)
        grads = F.fused_flex_backward(*args, g, n)
        flat = [out, *grads[0], *grads[1:]]
        if first is None:
            first = flat
        else:
            for a, b in zip(first, flat):
                check(torch.equal(a, b), f"{name} {R}x{S}: a pass differs from the first")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(bool(torch.isfinite(t).all()) for t in first), f"{name} {R}x{S}: not finite")
    return wall, len(first)


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


# frames a config's serve check serves and holds to the plain version and
# f32 (`_serve_against_plain_and_f32`)
SERVE_FRAMES = 1  # one frame a config keeps the whole run inside its time limit
FLEX_64_128_WINDOW_STEPS = 20  # [flex_64_128]'s windowed run against step at a time
FLEX_64_128_WINDOW_K = 10


def flex_64_128_phase(dev, ds, tmp, card):
    """synth512_lcode at the NeRF paper's 64 + 128 samples
    (SYNTH512_LCODE_64_128): the coarse passes at S = 64 and the fine ones
    at S = 192 (the runtime layout class), `_flex_config_phase`."""
    return _flex_config_phase(dev, ds, tmp, card, SYNTH512_LCODE_64_128, "flex_64_128")


def flex_w512_phase(dev, ds, tmp, card):
    """synth512_lcode_w512 (SYNTH512_LCODE_W512: hidden_size 512 in both
    models, 64 + 64 samples): every bf16 pass through K4f / K4b's h = 512
    kernels, `_flex_config_phase`, its frames held to f32 within
    FLEX_W512_FRAME_MEAN."""
    return _flex_config_phase(dev, ds, tmp, card, SYNTH512_LCODE_W512, "flex_w512",
                              f32_limits=(FLEX_W512_FRAME_MEAN, FRAME_MAX))


def flex_64_256_phase(dev, ds, tmp, card):
    """synth512_lcode_64_256 (SYNTH512_LCODE_64_256: 64 + 256 samples, the
    fine passes at S = 320, long items) through `_flex_config_phase` with
    [flex_64_128]'s limits; then its hidden-512 variant
    (SYNTH512_LCODE_64_256_W512) served, one frame within
    FLEX_PLAIN_FRAME_MEAN / FLEX_FRAME_MAX of K4f's plain version and
    FLEX_W512_FRAME_MEAN / FRAME_MAX of f32, and one bf16 step against the
    f32 step ([train_step]'s limits); no bf16 Flexible pass on the plain
    path."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels.fused_mlp import fused_paper_render

    res = _flex_config_phase(dev, ds, tmp, card, SYNTH512_LCODE_64_256, "flex_64_256")
    sv = _serve_against_plain_and_f32(
        dev, tmp, card, SYNTH512_LCODE_64_256_W512, "flex_64_256", SEED + 13, F.fused_flex_forward,
        (F.fused_flex_backward, fused_paper_render), plain_flex_passes, flex_plain_version,
        (FLEX_PLAIN_FRAME_MEAN, FLEX_FRAME_MAX), (FLEX_W512_FRAME_MEAN, FRAME_MAX), "K4f",
        f"hidden {FLEX_WIDE}, 64 + 256 samples", n_frames=1, plain_chunk=2048)
    with plain_flex_passes() as plain:
        step = train_step_phase(dev, ds, SYNTH512_LCODE_64_256_W512, "flex_64_256")
    check(plain[0] == 0, f"flex_64_256: {plain[0]} bf16 flex passes of the hidden-512 step on the plain path")
    # the w512 frames, and the step's two passes of each kernel
    res["w512"] = {"serve": sv, "step_vs_f32": step}
    res["k4f_launches"] += sv["launches"] + 2
    res["k4b_launches"] += 2
    return res


def flex_w1024_phase(dev, ds, tmp, card):
    """synth512_lcode_w1024 (SYNTH512_LCODE_W1024: hidden_size 1024 in both
    models, 64 + 64 samples) through `_flex_config_phase`: every bf16 pass
    through K4f / K4b's h = 1024 kernels (`sliced_chain_kernel`,
    `sliced_dx_kernel`), none on the plain path; one served frame (the
    plain frames in FLEX_SLICED_PLAIN_CHUNK-ray tiles) within
    FLEX_PLAIN_FRAME_MEAN / FLEX_FRAME_MAX of K4f's plain version, through
    the tensor-core yardstick (at h = 1024 the kernel's frame read 0.0118
    levels from it, the plain version's own on the tensor cores 0.0127; an
    NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6), and, the mean within
    FLEX_SLICED_F32_MARGIN of the plain version's own distance from f32,
    the max within FRAME_MAX of f32."""
    return _flex_config_phase(dev, ds, tmp, card, SYNTH512_LCODE_W1024, "flex_w1024",
                              f32_limits=(None, FRAME_MAX), plain_chunk=FLEX_SLICED_PLAIN_CHUNK,
                              f32_over_plain=FLEX_SLICED_F32_MARGIN, plain_yard=True)


def flex_w768_phase(dev, ds, tmp, card):
    """synth512_lcode_w768 (SYNTH512_LCODE_W768: hidden_size 768) as
    [flex_64_256]'s hidden-512 part: one frame served within [flex_w1024]'s
    limits and one bf16 step against the f32 step ([train_step]'s limits),
    every bf16 pass through K4f / K4b's h = 768 kernels, none on the plain
    path."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels.fused_mlp import fused_paper_render

    sv = _serve_against_plain_and_f32(
        dev, tmp, card, SYNTH512_LCODE_W768, "flex_w768", SEED + 12, F.fused_flex_forward,
        (F.fused_flex_backward, fused_paper_render), plain_flex_passes, flex_plain_version,
        (FLEX_PLAIN_FRAME_MEAN, FLEX_FRAME_MAX), (None, FRAME_MAX), "K4f", "hidden 768, 64 + 64 samples",
        plain_chunk=FLEX_SLICED_PLAIN_CHUNK, f32_over_plain=FLEX_SLICED_F32_MARGIN, plain_yard=True)
    F.fused_flex_backward.launches = 0
    with plain_flex_passes() as plain:
        step = train_step_phase(dev, ds, SYNTH512_LCODE_W768, "flex_w768")
    check(plain[0] == 0, f"flex_w768: {plain[0]} bf16 flex passes of the step on the plain path")
    # the frame's launches and the step's two passes of each kernel
    return {"serve": sv, "step_vs_f32": step, "k4f_launches": sv["launches"] + 2,
            "k4b_launches": F.fused_flex_backward.launches}


def flex_pe16_phase(dev, ds, tmp, card):
    """synth512_lcode_pe16 (SYNTH512_LCODE_PE16: 16 xyz bands in both
    models, dim_xyz 99, 64 + 64 samples): every bf16 pass through K4f / K4b
    at a K = 128 encoding (the runtime layout class), `_flex_config_phase`,
    its frames held to K4f's plain version within PE16_PLAIN_FRAME_* and to
    f32 within PE16_FRAME_*."""
    return _flex_config_phase(dev, ds, tmp, card, SYNTH512_LCODE_PE16, "flex_pe16",
                              plain_limits=(PE16_PLAIN_FRAME_MEAN, PE16_PLAIN_FRAME_MAX),
                              f32_limits=(PE16_FRAME_MEAN, PE16_FRAME_MAX))


def _window_vs_step(dev, ds, tmp, cfg_dict, name, wrappers, plain_passes, family,
                    steps=FLEX_64_128_WINDOW_STEPS, k=FLEX_64_128_WINDOW_K):
    """`steps` bf16 steps of `cfg_dict` windowed (K = k, CUDA-graph
    replays) and one step at a time from the same seed: the last
    checkpoint and the printed lines equal bit for bit, no bf16 pass of the
    model family on the plain path (`plain_passes`), and the last of
    `wrappers` (the family's backward kernel) called. Returns {K: run}: its
    seconds, checkpoint, printed lines and `wrappers`' launch counts."""
    import glob

    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.train.loop import train

    runs = {}
    for kk in (k, 1):
        d = copy.deepcopy(cfg_dict)
        w = os.path.join(tmp, f"{name}_window_{kk}")
        d["experiment"].update(logdir=w, train_iters=steps, print_every=10, validate_every=1000,
                               save_every=steps // 2, steps_per_execute=kk)
        for fn in wrappers:
            fn.launches = 0
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text), plain_passes() as plain:
            train(CfgNode(d), dataset=ds, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        out_text = text.getvalue()
        window = re.search(r"execution window: (\d+) steps", out_text)
        check((int(window.group(1)) if window else 1) == kk, f"{name}: the run at K = {kk} took another window")
        ckpts = sorted(glob.glob(os.path.join(w, "**", "checkpoint*.ckpt"), recursive=True))
        runs[kk] = {"s": time.perf_counter() - t0, "plain": plain[0], "ckpt": ckpts[-1],
                    "launches": tuple(fn.launches for fn in wrappers),
                    "lines": re.findall(_TRAIN_LINE, out_text) + re.findall(_VAL_LINE, out_text)}
        check(runs[kk]["plain"] == 0 and runs[kk]["launches"][-1] > 0,
              f"{name}: K = {kk}: plain bf16 {family} passes {runs[kk]['plain']}, wrapper calls "
              f"{runs[kk]['launches']}")
    a, b = runs[k], runs[1]
    differ = _differ(_ckpt_tensors(a["ckpt"]), _ckpt_tensors(b["ckpt"]))
    check(os.path.basename(a["ckpt"]) == os.path.basename(b["ckpt"]) and not differ,
          f"{name}: windowed vs step at a time differ in {differ[:5]} ({a['ckpt']}, {b['ckpt']})")
    check(a["lines"] == b["lines"] and len(a["lines"]) > steps // 10,
          f"{name}: the printed lines differ: {a['lines'][:3]} vs {b['lines'][:3]}")
    return runs


def _fault_readings(faulty):
    """`_serve_against_plain_and_f32`'s planted-fault readings, one item a
    frame: {fault: (mean, max levels)}, or None where the yardstick did
    not decide."""
    return [x and {k: (round(m, 4), mx) for k, (m, mx) in x.items()} for x in faulty]


def _serve_against_plain_and_f32(dev, tmp, card, cfg_dict, name, seed, kernel, others, plain_passes,
                                 plain_version, plain_limits, f32_limits, what, about, n_frames=SERVE_FRAMES,
                                 plain_chunk=8192, f32_over_plain=None, plain_yard=False,
                                 faults=FLEX_FRAME_FAULTS, planted_fault=flex_planted_fault):
    """A 512² avatar of `cfg_dict` (He-scaled weights from `seed`) served in
    bf16 through `serve_jsonl`: `n_frames` of 3 frames, the forward kernel's wrapper
    `kernel` (`what`) launched 2 × tiles a frame and none of `others`, no
    bf16 pass on the model's plain forward (`plain_passes`); each frame
    within `plain_limits` (mean, max |diff| levels) of the same frame
    through the kernel's plain version (`plain_version`: the same bf16
    roundings, torch's f32 sums) and within `f32_limits` of the same
    model's f32 plain frame, the plain version's own frame against f32
    beside it (the bf16 roundings' share), the plain frames in tiles of
    `plain_chunk` rays (which bounds the plain activations). With
    `f32_over_plain`, a frame's mean limit against f32 is instead the plain
    version's own frame's mean distance from f32 plus that many levels.
    With `plain_yard` (K4f's sliced widths, the paper kernels past 20
    bands), a frame past `plain_limits` is held to them through the
    tensor-core yardstick (`tc_limit`): the same frame with the plain
    version's matmuls on the tensor cores (`plain_version(tensor_cores=
    True)`), read against the plain version's; and that frame through each
    wrong kernel of `faults` (`planted_fault`: FLEX_FRAME_FAULTS /
    `flex_planted_fault`, PAPER_FRAME_FAULTS / `paper_planted_fault`) must
    fail the limits it was held to. Returns the launches, frame_ms and
    those readings."""
    import numpy as np
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
    from nerface_tpu_torch.serve import AvatarServer

    cfg = CfgNode(cfg_dict)
    sc, sf = cfg.nerf.validation.num_coarse, cfg.nerf.validation.num_fine
    sds = synthetic_flame_dataset(H=512, W=512, n_train=8, n_val=2, n_test=2, seed=SEED)
    ckpt = _save_avatar(cfg, sds, os.path.join(tmp, f"{name}.ckpt"), seed)
    server = AvatarServer(cfg, ckpt, dataset=sds, dtype=torch.bfloat16, device=dev, log=False)
    tiles = -(-server.H * server.W // min(server.settings.chunksize, server.H * server.W))
    maps = ["rgb_fine", "disp", "normals"]
    frames = [(0, 0), (1, 1), (0, 2)][:n_frames]
    requests = ([{"cmd": "ping"}] + [{"frame": f, "seed": sd, "maps": maps} for f, sd in frames]
                + [{"cmd": "stop"}])
    out = io.StringIO()
    for fn in (kernel,) + tuple(others):
        fn.launches = 0
    with plain_passes() as plain:
        handled = server.serve_jsonl(io.StringIO("\n".join(map(json.dumps, requests)) + "\n"), out)
        served = kernel.launches
        replies = [json.loads(line) for line in out.getvalue().splitlines()]
        check(handled == len(requests) and all(r.get("ok") is True for r in replies), f"{name}: {replies}")
        check(served == 2 * tiles * len(frames) and all(fn.launches == 0 for fn in others),
              f"{name}: {what} {served} (want 2 x {tiles} x {len(frames)}), the others "
              f"{[fn.launches for fn in others]} (want 0)")
        frame_ms = [r["frame_ms"] for r in replies if "frame_ms" in r]
        imgs = [server.render(frame=f, seed=sd, maps=("rgb_fine",))["rgb_fine"] for f, sd in frames]
        serve_plain = plain[0]
    check(serve_plain == 0, f"{name}: {serve_plain} bf16 passes served on the plain path")
    cfg_ref = CfgNode(cfg_dict)
    cfg_ref.nerf.validation["chunksize"] = plain_chunk
    before = kernel.launches
    vs_f32, vs_plain = [], []
    bg = (np.clip(sds.load_background(), 0.0, 1.0) * 255.0).astype(np.int16)
    with plain_version():
        ref_server = AvatarServer(cfg_ref, ckpt, dataset=sds, dtype=torch.bfloat16, device=dev, log=False)
        plain_imgs = [ref_server.render(frame=f, seed=sd, maps=("rgb_fine",))["rgb_fine"] for f, sd in frames]
    plain_lims, yard = [plain_limits] * len(frames), [None] * len(frames)
    for j, ((f, sd), img, pimg) in enumerate(zip(frames, imgs, plain_imgs)):
        d = np.abs(img.astype(np.int16) - pimg.astype(np.int16))
        if not plain_yard or (d.mean() <= plain_limits[0] and d.max() <= plain_limits[1]):
            continue  # within the base limits: the yardstick decides nothing
        with plain_version(tensor_cores=True):
            timg = ref_server.render(frame=f, seed=sd, maps=("rgb_fine",))["rgb_fine"]
        d = np.abs(timg.astype(np.int16) - pimg.astype(np.int16))
        yard[j] = (float(d.mean()), int(d.max()))
        plain_lims[j] = (tc_limit(plain_limits[0], yard[j][0]), tc_limit(plain_limits[1], yard[j][1]))
    check(kernel.launches == before, f"{name}: the plain frames launched {what}")
    # each frame the yardstick decided, rendered again through a modelled
    # wrong kernel (`faults`), against the plain version's
    faulty = [None] * len(frames)
    for j, ((f, sd), pimg) in enumerate(zip(frames, plain_imgs)):
        if yard[j] is None:
            continue
        faulty[j] = {}
        for kind in faults:
            with planted_fault(kind):
                fimg = (ref_server if kind in PLAIN_SERVER_FAULTS else server).render(
                    frame=f, seed=sd, maps=("rgb_fine",))["rgb_fine"]
            d = np.abs(fimg.astype(np.int16) - pimg.astype(np.int16))
            faulty[j][kind] = (float(d.mean()), int(d.max()))
    del server
    before = kernel.launches
    ref_server = AvatarServer(cfg_ref, ckpt, dataset=sds, dtype=None, device=dev, log=False)
    plain_vs_f32 = []  # the plain version's own frame against f32: the bf16 roundings' share
    shows = []  # levels off the background, and the frame's spread
    for (f, sd), img, pimg in zip(frames, imgs, plain_imgs):
        ref = ref_server.render(frame=f, seed=sd, maps=("rgb_fine",))["rgb_fine"]
        shows.append((float(np.abs(img.astype(np.int16) - bg).mean()), float(img.std())))
        own = np.abs(pimg.astype(np.int16) - ref.astype(np.int16))
        plain_vs_f32.append((float(own.mean()), int(own.max())))
        for against, out in ((pimg, vs_plain), (ref, vs_f32)):
            diff = np.abs(img.astype(np.int16) - against.astype(np.int16))
            out.append((float(diff.mean()), int(diff.max())))
    check(kernel.launches == before, f"{name}: the plain frames launched {what}")
    del ref_server
    # each frame's f32 limits: fixed, or over the plain version's own distance
    f32_lims = [f32_limits if f32_over_plain is None else (own[0] + f32_over_plain, f32_limits[1])
                for own in plain_vs_f32]
    phase(name, f"{len(frames)} frames ({about}) at 512x512 via serve_jsonl ({sc} + {sf} samples: {what} at S "
                f"= {sc} and {sc + sf}), frame_ms {frame_ms} on {card}, {what} launches {served} = 2 x {tiles} "
                f"tiles x {len(frames)}, plain bf16 passes 0; each frame, mean / max |diff| levels, vs {what}'s "
                f"plain version's {[(round(m, 4), x) for m, x in vs_plain]} (limits "
                f"{[(round(m, 4), x) for m, x in plain_lims]}"
                + (f"; the plain version on the tensor cores reads {[y and (round(y[0], 4), y[1]) for y in yard]}"
                   f", a wrong {what} (mean, max levels) {_fault_readings(faulty)}" if plain_yard else "")
                + f"), vs the f32 plain frame {[(round(m, 4), x) for m, x in vs_f32]} (limits "
                f"{[(round(m, 4), x) for m, x in f32_lims]}); the plain version's own frame vs f32 "
                f"{[(round(m, 4), x) for m, x in plain_vs_f32]}; mean |frame - background| and std levels "
                f"{[(round(o, 2), round(d, 2)) for o, d in shows]}")
    for (f, sd), (off_bg, spread), a, b, plain_lim, f32_lim, fault in zip(frames, shows, vs_plain, vs_f32,
                                                                          plain_lims, f32_lims, faulty):
        check(off_bg >= 10.0 and spread >= 10.0,
              f"{name}: frame {f} {off_bg} levels off the background, std {spread}: the MLP shows little")
        for kind, (mean, mx) in (fault or {}).items():
            check(mean > plain_lim[0] or mx > plain_lim[1],
                  f"{name}: frame {f} seed {sd}: a wrong {what} ({kind}) reads mean {mean}, max {mx}, within the "
                  f"yardstick's limits {plain_lim}")
        for (mean, mx), (lim_mean, lim_max), against in ((a, plain_lim, "plain version"),
                                                         (b, f32_lim, "f32 plain path")):
            check(mx <= lim_max and mean <= lim_mean,
                  f"{name}: frame {f} seed {sd} vs the {against}: mean {mean}, max {mx} (limits {lim_mean}, "
                  f"{lim_max})")
    torch.cuda.empty_cache()
    return {"launches": served, "frame_ms": frame_ms, "vs_plain_version_levels": vs_plain,
            "vs_f32_levels": vs_f32, "plain_version_vs_f32_levels": plain_vs_f32, "f32_limits": f32_lims,
            "plain_limits": plain_lims, "tensor_core_vs_plain_version_levels": yard,
            "planted_faults_vs_plain_version_levels": faulty, "tiles": tiles}


def _flex_config_phase(dev, ds, tmp, card, cfg_dict, name, plain_limits=(FLEX_PLAIN_FRAME_MEAN, FLEX_FRAME_MAX),
                       f32_limits=(FRAME_MEAN, FRAME_MAX), plain_chunk=8192, f32_over_plain=None,
                       plain_yard=False):
    """A Flexible-family config `cfg_dict` end to end on the card: every
    bf16 pass through K4f / K4b and none left to the model's plain forward
    (`plain_flex_passes`). Serves SERVE_FRAMES frames of 512² through `serve_jsonl`
    (K4f 2 × tiles a frame, no K4b or K2), each frame within `plain_limits`
    (mean, max levels; FLEX_PLAIN_FRAME_MEAN / FLEX_FRAME_MAX by default) of
    the same frame through K4f's plain version (`flex_plain_version`) and
    within `f32_limits` of the same model's f32 plain frame
    ([serve_64_128]'s limits by default; `_serve_against_plain_and_f32`'s
    `plain_chunk`, `f32_over_plain` and `plain_yard`); one bf16 step
    against the f32 plain step ([train_step]'s limits); FLEX_TRAIN_STEPS
    steps of `train()` (the printed loss falls), then the steady step's ms
    beside the frame's; FLEX_64_128_WINDOW_STEPS steps windowed (K =
    FLEX_64_128_WINDOW_K, CUDA-graph replays) against step at a time, the
    last checkpoint and the printed lines bit for bit."""
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels.fused_mlp import fused_paper_render
    from nerface_tpu_torch.ops.kernels.fused_train import fused_train_pass
    from nerface_tpu_torch.train.loop import train

    t_phase = time.perf_counter()
    cfg = CfgNode(cfg_dict)
    sv = _serve_against_plain_and_f32(
        dev, tmp, card, cfg_dict, name, SEED + 12, F.fused_flex_forward, (F.fused_flex_backward, fused_paper_render),
        plain_flex_passes, flex_plain_version, plain_limits, f32_limits, "K4f",
        f"hidden {cfg.models.coarse.hidden_size}, {cfg.models.coarse.num_encoding_fn_xyz} xyz bands",
        plain_chunk=plain_chunk, f32_over_plain=f32_over_plain, plain_yard=plain_yard)
    served, frame_ms = sv["launches"], sv["frame_ms"]
    sc, sf = cfg.nerf.validation.num_coarse, cfg.nerf.validation.num_fine

    with plain_flex_passes() as plain:
        step = train_step_phase(dev, ds, cfg_dict, name)
        steps = FLEX_TRAIN_STEPS
        d = copy.deepcopy(cfg_dict)
        d["experiment"].update(logdir=os.path.join(tmp, name), train_iters=steps, print_every=10,
                               validate_every=1000, save_every=1000)
        F.fused_flex_forward.launches = F.fused_flex_backward.launches = 0
        fused_train_pass.launches = fused_paper_render.launches = 0
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            state = train(CfgNode(d), dataset=ds, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k4f, k4b = F.fused_flex_forward.launches, F.fused_flex_backward.launches
        val_tiles = -(-ds.H * ds.W // int(cfg.nerf.validation.chunksize))
        check(k4f == 2 * steps + 2 * val_tiles * 2 and k4b == 2 * steps,
              f"{name}: K4f {k4f} (want 2 x {steps} + 2 x {val_tiles} x 2), K4b {k4b} (want 2 x {steps})")
        check(fused_train_pass.launches == 0 and fused_paper_render.launches == 0, f"{name}: K1 or K2 ran")
        printed = {int(i): float(v) for i, v in re.findall(r"\[TRAIN\] Iter: (\d+) Loss: (\S+)", text.getvalue())}
        want = sorted(set(range(0, steps, 10)) | {steps - 1})
        check(sorted(printed) == want and all(math.isfinite(v) for v in printed.values()),
              f"{name}: printed {printed}")
        first = statistics.mean(printed[i] for i in want if i < 20)
        last = statistics.mean(printed[i] for i in want if i >= steps - 10)
        check(last < first, f"{name}: the loss did not fall: steps < 20 {first}, last 10 steps {last}")
        train_plain = plain[0]
    check(train_plain == 0, f"{name}: {train_plain} bf16 flex passes trained on the plain path")
    phase(name, f"{steps} bf16 steps of {TRAIN_RAYS} rays at {sc} + {sf} in {wall:.1f} s with one validation: "
                f"K4f launches {k4f} = 2 x {steps} + 2 x {val_tiles} tiles x 2 frames, K4b {k4b} = 2 x "
                f"{steps}, K1 and K2 0, plain bf16 flex passes 0; printed loss, mean of steps 0 and 10 "
                f"{first:.5f} -> of the last 10 steps {last:.5f}")
    with plain_flex_passes() as plain:
        times, _, feed = _steady_steps(state, CfgNode(d), ds, dev)
        feed.stop()
    check(plain[0] == 0, f"{name}: {plain[0]} bf16 flex passes of the steady steps on the plain path")
    step_ms = statistics.median(times)
    phase(name, f"steady step {step_ms:.2f} ms (median of {len(times)}, synchronised; min {min(times):.2f}, "
                f"max {max(times):.2f}), {TRAIN_RAYS / step_ms * 1e3:,.0f} rays/s; frame ms "
                f"{statistics.median(frame_ms):.2f} (median of {len(frame_ms)}); on {card}")
    del state

    runs = _window_vs_step(dev, ds, tmp, cfg_dict, name, (F.fused_flex_forward, F.fused_flex_backward),
                           plain_flex_passes, "flex")
    a, b = runs[FLEX_64_128_WINDOW_K], runs[1]
    seconds = time.perf_counter() - t_phase
    phase(name, f"{FLEX_64_128_WINDOW_STEPS} bf16 steps windowed (K = {FLEX_64_128_WINDOW_K}, {a['s']:.1f} s) "
                f"vs step at a time ({b['s']:.1f} s): {os.path.basename(a['ckpt'])} bit for bit, "
                f"{len(a['lines'])} printed lines equal; K4f / K4b wrapper calls {a['launches']} / {b['launches']}, plain "
                f"bf16 flex passes 0 / 0; the phase took {seconds:.1f} s on {card}")
    # launches: the frames served, the bf16 step's two passes, train() and the two window runs
    return {"serve_launches": served, "frame_ms": frame_ms, "vs_f32_levels": sv["vs_f32_levels"],
            "vs_plain_version_levels": sv["vs_plain_version_levels"], "f32_limits": sv["f32_limits"],
            "plain_version_vs_f32_levels": sv["plain_version_vs_f32_levels"], "step_vs_f32": step,
            "k4f_launches": served + 2 + k4f + sum(r["launches"][0] for r in runs.values()),
            "k4b_launches": 2 + k4b + sum(r["launches"][1] for r in runs.values()),
            "loss_printed": printed, "train_s": wall, "step_ms": step_ms,
            "window": {"windowed_s": a["s"], "step_s": b["s"], "ckpt": os.path.basename(a["ckpt"])},
            "seconds": seconds}


def pe16_phase(dev, ds, tmp, card):
    """synth512_pe16 (SYNTH512_PE16: synth512_paper with 16 xyz bands in
    both models, dim_xyz 99, the kernels' K = 128 encoding) end to end on
    the card (`_paper_bands_phase`), its frames within PE16_PLAIN_FRAME_*
    of the kernel's plain version and PE16_FRAME_* of f32."""
    return _paper_bands_phase(dev, ds, tmp, card, SYNTH512_PE16, SYNTH512_PE16_COARSE, "pe16", SEED + 8,
                              (PE16_FRAME_MEAN, PE16_FRAME_MAX), "16 xyz bands")


def pe24_phase(dev, ds, tmp, card):
    """synth512_pe24 (SYNTH512_PE24: synth512_paper with 24 xyz bands in
    both models, dim_xyz 147, the kernels' K = 192 encoding) end to end on
    the card (`_paper_bands_phase`), its frames within PE16_PLAIN_FRAME_*
    of the kernel's plain version through the tensor-core yardstick, a
    wrong kernel of PAPER_FRAME_FAULTS past them, and within PE24_FRAME_*
    of f32."""
    return _paper_bands_phase(dev, ds, tmp, card, SYNTH512_PE24, SYNTH512_PE24_COARSE, "pe24", SEED + 12,
                              (PE24_FRAME_MEAN, PE24_FRAME_MAX), "24 xyz bands", plain_yard=True)


def _paper_bands_phase(dev, ds, tmp, card, cfg_dict, coarse_dict, name, seed, f32_limits, about,
                       plain_yard=False):
    """A paper avatar past 10 xyz bands (`cfg_dict`, its coarse-only variant
    `coarse_dict`) end to end on the card, no bf16 paper pass left to the
    plain forward (`plain_paper_passes`): SERVE_FRAMES served 512² frames
    through K2 (weights from `seed`) and one at σ-noise 0.1 through K3f,
    each within PE16_PLAIN_FRAME_* of the same frame through the kernel's
    plain version (with `plain_yard`, through the tensor-core yardstick and
    PAPER_FRAME_FAULTS, `_serve_against_plain_and_f32`) and within
    `f32_limits` of its f32 plain frame; a bf16
    step through K1 against the f32 step ([train_step]'s limits);
    PAPER_TRAIN_STEPS steps of `train()` through K1 (the printed loss
    falls) and the steady step; FLEX_64_128_WINDOW_STEPS steps windowed
    against step at a time, bit for bit; the coarse-only variant through
    K3f / K3b: a step against f32 and PAPER_TRAIN_STEPS steps."""
    from nerface_tpu_torch.ops.kernels.fused_mlp import (
        fused_paper_mlp_backward,
        fused_paper_mlp_forward,
        fused_paper_render,
    )
    from nerface_tpu_torch.ops.kernels.fused_train import fused_train_pass

    t0 = time.perf_counter()
    limits = (PE16_PLAIN_FRAME_MEAN, PE16_PLAIN_FRAME_MAX), f32_limits
    yard = dict(plain_yard=plain_yard, faults=PAPER_FRAME_FAULTS, planted_fault=paper_planted_fault)
    sv = _serve_against_plain_and_f32(dev, tmp, card, cfg_dict, name, seed, fused_paper_render,
                                      (fused_paper_mlp_forward, fused_paper_mlp_backward), plain_paper_passes,
                                      paper_plain_version, *limits, "K2", about, **yard)
    noisy = copy.deepcopy(cfg_dict)
    noisy["nerf"]["validation"]["radiance_field_noise_std"] = 0.1
    nf = _serve_against_plain_and_f32(dev, tmp, card, noisy, name, seed + 1, fused_paper_mlp_forward,
                                      (fused_paper_render, fused_paper_mlp_backward), plain_paper_passes,
                                      paper_plain_version, *limits, "K3f", f"{about}, σ-noise 0.1", 1, **yard)
    with plain_paper_passes() as plain:
        step = train_step_phase(dev, ds, cfg_dict, name)
        tr = train_phase(dev, ds, tmp, False, card, cfg_dict, PAPER_TRAIN_STEPS, name)
        cstep = train_step_phase(dev, ds, coarse_dict, name)
        ctr = train_phase(dev, ds, tmp, False, card, coarse_dict, PAPER_TRAIN_STEPS, f"{name}_coarse")
    check(plain[0] == 0, f"{name}: {plain[0]} bf16 paper passes trained on the plain path")
    runs = _window_vs_step(dev, ds, tmp, cfg_dict, name, (fused_paper_render, fused_train_pass),
                           plain_paper_passes, "paper")
    a, b = runs[FLEX_64_128_WINDOW_K], runs[1]
    seconds = time.perf_counter() - t0
    phase(name, f"{FLEX_64_128_WINDOW_STEPS} bf16 steps windowed (K = {FLEX_64_128_WINDOW_K}, {a['s']:.1f} s) "
                f"vs step at a time ({b['s']:.1f} s): {os.path.basename(a['ckpt'])} bit for bit, "
                f"{len(a['lines'])} printed lines equal; K2 / K1 wrapper calls {a['launches']} / "
                f"{b['launches']}; plain bf16 paper passes 0 in every part of the phase; the phase took "
                f"{seconds:.1f} s on {card}")
    launches = {
        "K2": sv["launches"] + tr["launches"]["K2"] + ctr["launches"]["K2"]
        + sum(r["launches"][0] for r in runs.values()),
        "K1": 2 + tr["launches"]["K1"] + sum(r["launches"][1] for r in runs.values()),
        "K3f": nf["launches"] + 1 + ctr["launches"]["K3f"],
        "K3b": 1 + ctr["launches"]["K3b"],
    }
    return {"serve": sv, "noisy_frame": nf, "step_vs_f32": step, "train": tr, "coarse_step_vs_f32": cstep,
            "coarse_train": ctr, "window": {"windowed_s": a["s"], "step_s": b["s"],
                                            "ckpt": os.path.basename(a["ckpt"])},
            "launches": launches, "seconds": seconds}


def paper_64_256_phase(dev, ds, tmp, card):
    """synth512_paper_64_256 (SYNTH512_PAPER_64_256: 64 + 256 samples, the
    fine passes at S = 320, long items) end to end on the card, no bf16
    paper pass left to the plain forward (`plain_paper_passes`): SERVE_FRAMES
    served 512² frames through K2 (S = 64 and 320) and one at σ-noise 0.1 through
    K3f, each within PE16_PLAIN_FRAME_* of the same frame through the
    kernel's plain version and within [serve]'s FRAME_MEAN / FRAME_MAX of
    its f32 plain frame; a bf16 step through K1 against the f32
    step ([train_step]'s limits); PAPER_TRAIN_STEPS steps of `train()`
    through K1 (the printed loss falls) and the steady step;
    FLEX_64_128_WINDOW_STEPS steps windowed against step at a time, bit for
    bit; the coarse-only variant (SYNTH512_PAPER_64_256_COARSE, S = 320)
    through K3f / K3b: a step against f32 and PAPER_TRAIN_STEPS steps."""
    from nerface_tpu_torch.ops.kernels.fused_mlp import (
        fused_paper_mlp_backward,
        fused_paper_mlp_forward,
        fused_paper_render,
    )
    from nerface_tpu_torch.ops.kernels.fused_train import fused_train_pass

    t0 = time.perf_counter()
    limits = ((PE16_PLAIN_FRAME_MEAN, PE16_PLAIN_FRAME_MAX), (FRAME_MEAN, FRAME_MAX))
    sv = _serve_against_plain_and_f32(dev, tmp, card, SYNTH512_PAPER_64_256, "paper_64_256", SEED + 10,
                                      fused_paper_render, (fused_paper_mlp_forward, fused_paper_mlp_backward),
                                      plain_paper_passes, paper_plain_version, *limits, "K2", "64 + 256 samples")
    noisy = copy.deepcopy(SYNTH512_PAPER_64_256)
    noisy["nerf"]["validation"]["radiance_field_noise_std"] = 0.1
    nf = _serve_against_plain_and_f32(dev, tmp, card, noisy, "paper_64_256", SEED + 11, fused_paper_mlp_forward,
                                      (fused_paper_render, fused_paper_mlp_backward), plain_paper_passes,
                                      paper_plain_version, *limits, "K3f", "64 + 256 samples, σ-noise 0.1", 1)
    with plain_paper_passes() as plain:
        step = train_step_phase(dev, ds, SYNTH512_PAPER_64_256, "paper_64_256")
        tr = train_phase(dev, ds, tmp, False, card, SYNTH512_PAPER_64_256, PAPER_TRAIN_STEPS, "paper_64_256")
        cstep = train_step_phase(dev, ds, SYNTH512_PAPER_64_256_COARSE, "paper_64_256")
        ctr = train_phase(dev, ds, tmp, False, card, SYNTH512_PAPER_64_256_COARSE, PAPER_TRAIN_STEPS,
                          "paper_64_256_coarse")
    check(plain[0] == 0, f"paper_64_256: {plain[0]} bf16 paper passes trained on the plain path")
    runs = _window_vs_step(dev, ds, tmp, SYNTH512_PAPER_64_256, "paper_64_256", (fused_paper_render, fused_train_pass),
                           plain_paper_passes, "paper")
    a, b = runs[FLEX_64_128_WINDOW_K], runs[1]
    seconds = time.perf_counter() - t0
    phase("paper_64_256", f"{FLEX_64_128_WINDOW_STEPS} bf16 steps windowed (K = {FLEX_64_128_WINDOW_K}, "
                          f"{a['s']:.1f} s) vs step at a time ({b['s']:.1f} s): {os.path.basename(a['ckpt'])} bit "
                          f"for bit, {len(a['lines'])} printed lines equal; K2 / K1 wrapper calls {a['launches']} / "
                          f"{b['launches']}; plain bf16 paper passes 0 in every part of the phase; the phase took "
                          f"{seconds:.1f} s on {card}")
    launches = {
        "K2": sv["launches"] + tr["launches"]["K2"] + ctr["launches"]["K2"]
        + sum(r["launches"][0] for r in runs.values()),
        "K1": 2 + tr["launches"]["K1"] + sum(r["launches"][1] for r in runs.values()),
        "K3f": nf["launches"] + 1 + ctr["launches"]["K3f"],
        "K3b": 1 + ctr["launches"]["K3b"],
    }
    return {"serve": sv, "noisy_frame": nf, "step_vs_f32": step, "train": tr, "coarse_step_vs_f32": cstep,
            "coarse_train": ctr, "window": {"windowed_s": a["s"], "step_s": b["s"],
                                            "ckpt": os.path.basename(a["ckpt"])},
            "launches": launches, "seconds": seconds}


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
    lc, lf = K5_LONG_TILE
    zl, wl, ul = resample_inputs(TILE_RAYS, lc, lf, SEED + 20, dev)
    fused_resample.launches = 0
    fused_resample(z, w, u)
    fused_resample(z, w, u_det, sorted_u=True)
    fused_resample(zl, wl, ul)  # the long regime: 64 + 256
    fused_resample(zl, wl, linspace01(lf, device=dev), sorted_u=True)
    torch.cuda.synchronize()
    path_launches = fused_resample.launches
    check(path_launches == 4, f"resample: {path_launches} launches for 4 calls")
    del zl, wl, ul

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
    result["long"] = _resample_long(dev)
    result["max_abs_err"] = max(worst, result["long"]["max_abs_err"])
    phase("resample_kernel", f"K5 launched {path_launches} times on its entry point (a 65536-ray "
                             f"tile at 64 + 64 and at 64 + 256, each regime once); nothing in render/ or "
                             f"eval/ calls it")
    return result


def _resample_long(dev):
    """K5's long regime (Sc + Sf past 256, `resample_long_kernel`): every (Sc, Sf)
    of K5_LONG_COARSE × K5_LONG_FINE within Sc + Sf ≤ 1024 (the cells up to
    256 run the short kernel), both regimes (per-ray draws, and the
    linspace row with `sorted_u`), on SAMPLE_RAGGED_RAYS rays: within
    RESAMPLE_TOL of the plain version, rows sorted, bit-identical over 2
    launches, ms through the wrapper beside the plain version's and the
    byte bound; then a 65536-ray tile at K5_LONG_TILE in both regimes:
    wrapper, bare and device ms (`k3f_k5_launch_split`), GB/s, plain ms and
    the bound. Returns {"grid": {...}, "tile": {...}, "max_abs_err": x}."""
    import torch

    from nerface_tpu_torch.ops.kernels.fused_resample import SHORT_TOTAL, fused_resample, fused_resample_reference
    from nerface_tpu_torch.ops.math import linspace01
    from nerface_tpu_torch.tools.perf.cases import resample_inputs
    from nerface_tpu_torch.tools.perf.k3f_k5_launch_split import device_ms, k5_bare

    R = SAMPLE_RAGGED_RAYS
    grid, worst = {}, 0.0
    for sc in K5_LONG_COARSE:
        for sf in K5_LONG_FINE:
            if sc + sf > 1024:
                continue
            z, w, u = resample_inputs(R, sc, sf, SEED + 32 + sc * 1000 + sf, dev)
            for regime in ("general", "sorted_u"):
                srt = regime == "sorted_u"
                uu = linspace01(sf, device=dev) if srt else u
                got = fused_resample(z, w, uu, sorted_u=srt)
                again = fused_resample(z, w, uu, sorted_u=srt)
                torch.cuda.synchronize()
                ref = fused_resample_reference(z, w, uu, srt)
                err = float((got - ref).abs().max())
                label = f"{sc}+{sf} {regime}"
                check(got.shape == (R, sc + sf) and torch.equal(got, again),
                      f"K5 {label}: shape {tuple(got.shape)} or two launches differ")
                check(bool((got[:, 1:] >= got[:, :-1]).all()), f"K5 {label}: a row is not sorted")
                check(err <= RESAMPLE_TOL, f"K5 {label}: max err {err} > {RESAMPLE_TOL}")
                worst = max(worst, err)
                grid[label] = {
                    "rays": R, "long": sc + sf > SHORT_TOTAL, "max_abs_err": err,
                    "ms": _median_ms(lambda: fused_resample(z, w, uu, sorted_u=srt), iters=20),
                    "plain_ms": _median_ms(lambda: fused_resample_reference(z, w, uu, srt), 1, 5),
                    "bound_ms": _bound_ms(0, _k5_bytes(R, sc, sf, srt))[0]}
    phase("resample_kernel", f"K5 at {len(grid)} shapes (Sc {K5_LONG_COARSE} × Sf {K5_LONG_FINE}, Sc + Sf ≤ 1024, "
                             f"{sum(r['long'] for r in grid.values())} of them past {SHORT_TOTAL}: the long "
                             f"regime), both regimes, {R} rays: max err {worst:.3g} (limit {RESAMPLE_TOL}), rows "
                             f"sorted, bit-identical over 2 launches")
    for label, r in grid.items():
        phase("resample_kernel", f"  K5 {label}{' (long)' if r['long'] else ''}: {r['ms']:.4f} ms, plain "
                                 f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, max err {r['max_abs_err']:.3g}")
    sc, sf = K5_LONG_TILE
    tile = {}
    z, w, u = resample_inputs(TILE_RAYS, sc, sf, SEED + 33, dev)
    for regime in ("general", "sorted_u"):
        srt = regime == "sorted_u"
        uu = linspace01(sf, device=dev) if srt else u
        got = fused_resample(z, w, uu, sorted_u=srt)
        ref = fused_resample_reference(z, w, uu, srt)
        err = float((got - ref).abs().max())
        check(err <= RESAMPLE_TOL and bool((got[:, 1:] >= got[:, :-1]).all()),
              f"K5 tile {sc}+{sf} {regime}: max err {err} (limit {RESAMPLE_TOL}) or a row not sorted")
        worst = max(worst, err)
        bare = k5_bare(z, w, uu, srt)
        nbytes = _k5_bytes(TILE_RAYS, sc, sf, srt)
        r = tile[regime] = {"rays": TILE_RAYS, "samples": (sc, sf), "max_abs_err": err,
                            "ms": _median_ms(lambda: fused_resample(z, w, uu, sorted_u=srt), iters=20),
                            "bare_ms": _median_ms(bare, iters=20),
                            "plain_ms": _median_ms(lambda: fused_resample_reference(z, w, uu, srt), iters=10)}
        r["device_ms"], r["device_by"] = device_ms(bare, "resample_long_kernel")
        check(r["device_ms"] > 0, f"K5 tile {sc}+{sf} {regime}: no device time read")
        r["bound_ms"], r["bound_by"] = _bound_ms(0, nbytes)
        r["gb_s"] = nbytes / r["device_ms"] / 1e6
        phase("resample_kernel", f"K5 {regime} R={TILE_RAYS} Sc={sc} Sf={sf} (the long regime): max abs err "
                                 f"{err:.3g}; kernel {r['ms']:.4f} ms, bare launch {r['bare_ms']:.4f} ms, device "
                                 f"{r['device_ms']:.4f} ms by {r['device_by']} ({r['gb_s']:.0f} GB/s), bound "
                                 f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms")
    return {"grid": grid, "tile": tile, "max_abs_err": worst}


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


# ---- the stock NeRF surface: cli/eval_nerf.py and examples/tiny_nerf.py ---

# The NeRF paper's stock settings (Mildenhall et al. 2020, arXiv 2003.08934,
# §5.3): 64 coarse + 128 fine samples, PaperNeRFModel (a 6 × 256 trunk, a
# 128-wide direction branch) at 10 xyz / 4 direction bands.
STOCK_MODEL = {
    "type": "PaperNeRFModel", "num_layers": 8, "hidden_size": 256, "skip_connect_every": 4,
    "num_encoding_fn_xyz": 10, "include_input_xyz": True, "log_sampling_xyz": True,
    "use_viewdirs": True, "num_encoding_fn_dir": 4, "include_input_dir": True,
    "log_sampling_dir": True,
}
STOCK_BLENDER_SIZE = 800  # the blender scenes' frames, read with half_res: 400²
STOCK_LLFF_HW = (378, 504)  # fern's frames at factor 8
STOCK_LLFF_FACTOR = 8
STOCK_LLFF_VIEWS = 5
STOCK_CHUNK = 16384  # rays a tile
STOCK_FRAMES = 1  # one frame a scene keeps the whole run inside its time limit
STOCK_CHECK_RAYS = 2048
STOCK_LEVELS = 1  # uint8 levels between the card's frame and the CPU plain path
LEGO_CAMERA_ANGLE_X = 0.6911112070083618
TINY_ITERS = 300


def _stock_cfg(ds_dir, llff):
    node = {"chunksize": STOCK_CHUNK, "perturb": False, "num_coarse": 64, "num_fine": 128,
            "white_background": not llff, "radiance_field_noise_std": 0.0, "lindisp": False}
    dataset = ({"type": "llff", "basedir": ds_dir, "downsample_factor": STOCK_LLFF_FACTOR,
                "no_ndc": False, "near": 0.0, "far": 1.0} if llff else
               {"type": "blender", "basedir": ds_dir, "half_res": True, "testskip": 1,
                "no_ndc": True, "near": 2.0, "far": 6.0})
    return {
        "experiment": {"id": "stock", "logdir": "/tmp/unused", "randomseed": 42,
                       "train_iters": 1, "validate_every": 100, "save_every": 100,
                       "print_every": 100},
        "dataset": dataset,
        "models": {"coarse": dict(STOCK_MODEL), "fine": dict(STOCK_MODEL)},
        "optimizer": {"type": "Adam", "lr": 5.0e-4},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
        "nerf": {"use_viewdirs": True, "train": dict(node, num_random_rays=1024),
                 "validation": dict(node)},
    }


def _smooth_image(h, w, channels, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = [0.5 + 0.5 * np.sin(2 * np.pi * (rng.rand() * 3 * xx + rng.rand() * 3 * yy))
           for _ in range(channels)]
    return (np.stack(img, -1) * 255).astype(np.uint8)


def _write_blender(path):
    """A blender scene on disk: one STOCK_BLENDER_SIZE² RGBA frame a split
    on the loader's spherical poses, lego's camera_angle_x."""
    from PIL import Image

    from nerface_tpu_torch.data.flame import pose_spherical

    for k, split in enumerate(("train", "val", "test")):
        os.makedirs(os.path.join(path, split), exist_ok=True)
        s = STOCK_BLENDER_SIZE
        Image.fromarray(_smooth_image(s, s, 4, k)).save(os.path.join(path, split, "r_0.png"))
        frames = [{"file_path": f"{split}/r_0",
                   "transform_matrix": pose_spherical(40.0 * k, -30.0, 4.0).tolist()}]
        with open(os.path.join(path, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": LEGO_CAMERA_ANGLE_X, "frames": frames}, f)
    return path


def _write_llff(path):
    """A forward-facing scene on disk as fern's: `poses_bounds.npy` in the
    raw LLFF layout ([down right back] columns, [H, W, focal] at 3024 ×
    4032) and the frames in `images_8/` at 378 × 504, which the loader
    reads as they are; `images/` holds one 8 × 8 stand-in a view, since
    the loader only counts its files when `images_8/` is there."""
    import numpy as np
    from PIL import Image

    from nerface_tpu_torch.tools.dataset_builder import look_at

    n = STOCK_LLFF_VIEWS
    h, w = STOCK_LLFF_HW
    f = STOCK_LLFF_FACTOR
    for d in ("images", f"images_{f}"):
        os.makedirs(os.path.join(path, d), exist_ok=True)
    poses = np.zeros((n, 3, 5))
    for i in range(n):
        Image.fromarray(_smooth_image(8, 8, 3, i)).save(
            os.path.join(path, "images", f"IMG_{i:04d}.JPG.png"))
        Image.fromarray(_smooth_image(h, w, 3, 10 + i)).save(
            os.path.join(path, f"images_{f}", f"IMG_{i:04d}.png"))
        th = 0.3 * (i - n / 2) / n
        cam = np.array([np.sin(th), 0.1 * np.cos(3 * th), np.cos(th)]) * 4.0
        c2w = look_at(cam, np.zeros(3))[:3, :4]
        poses[i, :, 1], poses[i, :, 0], poses[i, :, 2:4] = c2w[:, 0], -c2w[:, 1], c2w[:, 2:]
        poses[i, :, 4] = [h * f, w * f, 3260.0]
    bds = np.stack([np.full(n, 2.0), np.full(n, 12.0)], -1)
    np.save(os.path.join(path, "poses_bounds.npy"), np.concatenate([poses.reshape(n, -1), bds], -1))
    return path


def _stock_ckpt(cfg, path, seed):
    """A reference-schema .ckpt of He-scaled random PaperNeRFModels, σ
    raised by SIGMA_BIAS so that the MLP's colour makes the pixels."""
    import torch

    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.tools.perf.cases import he_scale
    from nerface_tpu_torch.train.loop import build_models_from_cfg

    coarse, fine = build_models_from_cfg(CfgNode(copy.deepcopy(cfg)),
                                         generator=torch.Generator().manual_seed(seed))
    for m in (coarse, fine):
        he_scale(m)
        with torch.no_grad():
            m.fc_alpha.bias += SIGMA_BIAS
    torch.save({"iter": 0, "model_coarse_state_dict": coarse.state_dict(),
                "model_fine_state_dict": fine.state_dict(), "optimizer_state_dict": None,
                "loss": 0.0, "psnr": 0.0, "background": None, "latent_codes": None}, path)
    return path


def _hand_counters():
    """Every hand kernel's wrapper launch counter, K1–K5."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels import fused_resample as R

    return dict(_launch_counts(), K4f=F.fused_flex_forward, K4b=F.fused_flex_backward,
                K5=R.fused_resample)


def _stock_frame_check(cfg, ckpt, png, i, label):
    """Frame i's STOCK_CHECK_RAYS rays, spread over the frame, rendered by
    the port's plain path on the CPU from the same .ckpt, through
    `run_one_iter_of_nerf` (NDC for LLFF): the max uint8 level difference
    against the card's PNG."""
    import numpy as np
    import torch

    from nerface_tpu_torch.cli.eval_nerf import load_render_path
    from nerface_tpu_torch.config import CfgNode
    from nerface_tpu_torch.eval.driver import cast_to_image
    from nerface_tpu_torch.ops.rays import get_ray_bundle
    from nerface_tpu_torch.render.pipeline import RenderSettings, run_one_iter_of_nerf
    from nerface_tpu_torch.train.checkpoint import load_torch_checkpoint
    from nerface_tpu_torch.train.loop import build_models_from_cfg

    node = CfgNode(copy.deepcopy(cfg))
    render_poses, H, W, focal = load_render_path(node)
    mc, mf = build_models_from_cfg(node)
    sd = load_torch_checkpoint(ckpt)
    mc.load_state_dict(sd["coarse"], strict=True)
    mf.load_state_dict(sd["fine"], strict=True)
    intr = np.array([focal, focal, 0.5, 0.5], np.float32)
    ro, rd = get_ray_bundle(H, W, intr, torch.as_tensor(render_poses[i][:3, :4]))
    idx = torch.linspace(0, H * W - 1, STOCK_CHECK_RAYS).long()
    with torch.no_grad():
        out = run_one_iter_of_nerf(H, W, mc, mf, ro.reshape(-1, 3)[idx], rd.reshape(-1, 3)[idx],
                                   RenderSettings.from_cfg(node, "validation"), seed=i,
                                   focal=intr[:2])
    ref = cast_to_image(out[3].numpy()).astype(int)
    got = png.reshape(-1, 3)[idx.numpy()].astype(int)
    check(png.shape == (H, W, 3), f"{label}: frame {png.shape}, want {(H, W, 3)}")
    err = int(np.abs(got - ref).max())
    check(err <= STOCK_LEVELS, f"{label}: frame {i} off the CPU plain path by {err} levels")
    check(float(ref.std()) >= 10.0, f"{label}: frame {i} is flat (std {ref.std():.2f})")
    return err


def stock_eval_phase(dev, tmp, card):
    """`cli/eval_nerf.py` on the card at the NeRF paper's stock settings:
    STOCK_FRAMES render poses of a blender scene (400² at half_res) and of
    an LLFF scene (378 × 504, through NDC), f32, no hand kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from nerface_tpu_torch.cli import eval_nerf

    res = {}
    for name in ("blender", "llff"):
        llff = name == "llff"
        d = os.path.join(tmp, f"stock_{name}")
        ds = _write_llff(d) if llff else _write_blender(d)
        cfg = _stock_cfg(ds, llff)
        cfg_path = _write_cfg(cfg, os.path.join(tmp, f"stock_{name}.json"))
        ckpt = _stock_ckpt(cfg, os.path.join(tmp, f"stock_{name}.ckpt"), SEED + 20 + llff)
        out = os.path.join(tmp, f"stock_{name}_renders")
        argv = ["--config", cfg_path, "--checkpoint", ckpt, "--device", str(dev),
                "--savedir", out, "--max-frames", str(STOCK_FRAMES)]
        counters = _hand_counters()
        for c in counters.values():
            c.launches = 0
        summary, text = _cli(eval_nerf.main, argv)
        launched = {k: c.launches for k, c in counters.items()}
        check(not any(launched.values()), f"stock_eval {name}: hand kernels launched {launched}")
        check(text.count("Avg time per image: ") == STOCK_FRAMES,
              f"stock_eval {name}: printed {text!r}")
        # the same command's first frame under torch.profiler: no hand kernel
        # ran on the card, and the profiler saw the card's kernels
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _cli(eval_nerf.main, argv[:-4] + ["--savedir", out + "_prof", "--max-frames", "1"])
            torch.cuda.synchronize()
        runs = kernel_runs(prof)
        seen = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        check(seen > 0 and not any(runs.values()),
              f"stock_eval {name}: profiler saw {seen} kernel runs, hand kernels {runs}")
        errs = [_stock_frame_check(cfg, ckpt, _png(os.path.join(out, f"{i:04d}.png")), i,
                                   f"stock_eval {name}") for i in range(STOCK_FRAMES)]
        h, w = _png(os.path.join(out, "0000.png")).shape[:2]
        res[name] = {"frame_ms": [1e3 * t for t in summary["times"]],
                     "avg_time_per_image": summary["avg_time_per_image"], "hw": [h, w],
                     "levels": errs, "profiled_kernel_runs": seen}
        phase("stock_eval", f"{name} {h}x{w}, PaperNeRFModel 64 + 128 samples, f32: frame ms "
              f"{[round(v, 3) for v in res[name]['frame_ms']]}, Avg time per image "
              f"{summary['avg_time_per_image']:.4f} s; {STOCK_CHECK_RAYS} rays a frame within "
              f"{errs} levels of the CPU plain path; hand kernels: 0 launched, 0 of {seen} "
              f"profiled kernel runs; {card}")
    return res


def tiny_nerf_phase(dev, card):
    """`examples/tiny_nerf.py` on the card for TINY_ITERS iterations on its
    synthetic data: the last loss below half the first."""
    from nerface_tpu_torch.examples import tiny_nerf

    t0 = time.perf_counter()
    r, text = _cli(tiny_nerf.main, ["--iters", str(TINY_ITERS), "--display-every", "100",
                                    "--device", str(dev)])
    wall = time.perf_counter() - t0
    losses = r["losses"]
    check(len(losses) == TINY_ITERS and all(math.isfinite(v) for v in losses),
          f"tiny_nerf: losses {losses[:3]}...")
    check(losses[-1] < 0.5 * losses[0], f"tiny_nerf: loss {losses[0]} -> {losses[-1]}")
    phase("tiny_nerf", f"{TINY_ITERS} iterations: loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
          f"last test PSNR {r['psnr']:.2f} dB, train loop {r['seconds']:.2f} s, wall "
          f"{wall:.2f} s with the data; {card}")
    return {"losses": [losses[0], losses[-1]], "psnr": r["psnr"], "seconds": r["seconds"],
            "wall": wall}


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
    t_run = time.perf_counter()

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

    bd = build_phase()
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
        server, s128 = serve_phase(dev, tmp, SYNTH512_PAPER_64_128, "serve_64_128", SEED + 7)
        del server
        nf = noisy_frame_phase(dev, tmp, args.profile)
        tk = train_kernel_phase(dev)
        tks = train_kernel_phase(dev, small=True)
        pk = paper_mlp_kernel_phase(dev)
        sc = sample_counts_phase(dev)
        xb = xyz_bands_phase(dev)
        lr = long_rays_phase(dev)
        ds = _train_dataset()
        ts = train_step_phase(dev, ds)
        tr = train_phase(dev, ds, tmp, args.profile, card)
        wt = window_train_phase(dev, ds, tmp, args.profile, card)
        ev = eval_phase(dev, tmp, card)
        me = metrics_phase(ev)
        qu = quality_phase(dev, tmp, ev, me, card)
        rn = reenact_phase(dev, tmp, card)
        rn64 = reenact_phase(dev, tmp, card, REENACT_SMALL_SIZE, "reenact_64")
        su = supervised_train_phase(dev, tmp, ev["dataset"], card)
        dd = ddp_train_phase(dev, ds, tmp, ev["dataset"], card)
        sh = sharded_serve_phase(dev, tmp, ev, card)
        oc = occupancy_serve_phase(dev, ds, tr["checkpoint"])
        st = train_phase(dev, ds, tmp, False, card, SYNTH512_SMALLER, PAPER_TRAIN_STEPS,
                         "smaller_train")
        cs = train_step_phase(dev, ds, SYNTH512_PAPER_COARSE, "coarse_train")
        ct = train_phase(dev, ds, tmp, args.profile, card, SYNTH512_PAPER_COARSE,
                         PAPER_TRAIN_STEPS, "coarse_train")
        p16 = pe16_phase(dev, ds, tmp, card)
        p24 = pe24_phase(dev, ds, tmp, card)
        p256 = paper_64_256_phase(dev, ds, tmp, card)
        fk = flex_kernel_phase(dev)
        du = flex_dead_units_phase(dev)
        fl = flex_long_rays_phase(dev)
        fwd = flex_widths_phase(dev)
        fs = flex_serve_phase(dev, tmp, args.profile)
        ft = flex_train_phase(dev, ds, tmp, args.profile, card)
        f64 = flex_64_128_phase(dev, ds, tmp, card)
        fw = flex_w512_phase(dev, ds, tmp, card)
        fp16 = flex_pe16_phase(dev, ds, tmp, card)
        f256 = flex_64_256_phase(dev, ds, tmp, card)
        fw1024 = flex_w1024_phase(dev, ds, tmp, card)
        fw768 = flex_w768_phase(dev, ds, tmp, card)
        stock_eval_phase(dev, tmp, card)
        tiny_nerf_phase(dev, card)

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
    # ddp_train: the three one-card runs of (a) in this process, and the gloo
    # ranks of (b) (their K2 calls: the validations of (a))
    dd_k1 = sum(r["K1"] for name, r in dd["launches"].items() if name != "gloo_ranks") \
        + dd["launches"]["gloo_ranks"]
    dd_k2 = sum(r["K2"] for name, r in dd["launches"].items() if name != "gloo_ranks")
    sh_k2 = sum(sh["launches"].values())
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
            + sum(m["launches"] for m in ev["modes"].values()) + su["launches"]["K2"]
            + dd_k2 + sh_k2 + rn["launches"]["K2"] + s128["launches"] + rn64["launches"]["K2"]
            + p16["launches"]["K2"] + p24["launches"]["K2"] + p256["launches"]["K2"],
            "launches_by_path": {"serve": s["launches"], "smaller_serve": ss["launches"],
                                 "serve_64_128": s128["launches"],
                                 "fast_serve": fe["launches"],
                                 "occupancy_serve": oc["launches"],
                                 **{f"eval_{k}": m["launches"] for k, m in ev["modes"].items()},
                                 "train": tr["launches"]["K2"],
                                 "window_train": sum(r[m]["K2"] for r in wt["launches"].values()
                                                     for m in r),
                                 "smaller_train": st["launches"]["K2"],
                                 "coarse_train": ct["launches"]["K2"],
                                 "supervised_train": su["launches"]["K2"],
                                 "ddp_train": dd_k2, "sharded_serve": sh_k2,
                                 # the demo's validations and its two evaluations
                                 "reenact": rn["launches"]["K2"],
                                 "reenact_64": rn64["launches"]["K2"],
                                 # synth512_pe16: the served frames, validations and window runs
                                 "pe16": p16["launches"]["K2"],
                                 # synth512_pe24: the same at 24 bands
                                 "pe24": p24["launches"]["K2"],
                                 # synth512_paper_64_256: the same at S = 64 and 320
                                 "paper_64_256": p256["launches"]["K2"]},
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
            # AvatarServer(devices=[cuda:0] x 2) beside the one-device server
            "sharded_frame_ms_512": sh["frame_ms"],
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
            # the reenactment demo at 128²: each evaluation's s a frame, the
            # self-reenactment metrics and the untrained avatar's PSNR
            "reenact_avg_time_per_image_128": rn["avg_time_per_image"],
            "reenact_self": rn["summary"]["self_reenactment"],
            "reenact_untrained_psnr": rn["untrained_psnr"],
            "reenact_vs_f32_levels": rn["vs_f32"],
            "client_round_trip_ms_512": s["client"]["round_trip_ms"],
            # [sample_counts]: SAMPLE_CASES' rays at each S through the wrapper
            "by_sample_count": sc["K2"],
            # [xyz_bands]: 10 / 11 / 16 / 20 / 21 / 24 / 31 bands at each (S, rays)
            # of XYZ_CASES, the zeroed third xin block's readings / limits
            # (every paper kernel's), and synth512_pe16's and _pe24's frames
            # against f32
            "by_xyz_bands": xb["K2"],
            "xyz_bands_third_block_fault": xb["third_block_fault"],
            "pe16_frame_ms_512": p16["serve"]["frame_ms"],
            "pe16_vs_plain_version_levels": p16["serve"]["vs_plain_version_levels"],
            "pe16_vs_f32_levels": p16["serve"]["vs_f32_levels"],
            "pe16_plain_version_vs_f32_levels": p16["serve"]["plain_version_vs_f32_levels"],
            "pe24_frame_ms_512": p24["serve"]["frame_ms"],
            "pe24_vs_plain_version_levels": p24["serve"]["vs_plain_version_levels"],
            "pe24_vs_f32_levels": p24["serve"]["vs_f32_levels"],
            "pe24_plain_version_vs_f32_levels": p24["serve"]["plain_version_vs_f32_levels"],
            "pe24_plain_limits": p24["serve"]["plain_limits"],
            "pe24_tensor_core_vs_plain_version_levels": p24["serve"]["tensor_core_vs_plain_version_levels"],
            "pe24_planted_faults_vs_plain_version_levels": p24["serve"]["planted_faults_vs_plain_version_levels"],
            # [long_rays]: S past 256 through the wrapper and bare; synth512_paper_64_256's frames
            "by_long_rays": lr["K2"],
            "paper_64_256_frame_ms_512": p256["serve"]["frame_ms"],
            "paper_64_256_vs_plain_version_levels": p256["serve"]["vs_plain_version_levels"],
            "paper_64_256_vs_f32_levels": p256["serve"]["vs_f32_levels"],
            "paper_64_256_plain_version_vs_f32_levels": p256["serve"]["plain_version_vs_f32_levels"],
            "card": card,
        },
        {
            "name": "fused_train_pass",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_train_pass.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_train.py:69",
            "modes": ["paper", "small"],
            "launches": tr["launches"]["K1"] + st["launches"]["K1"] + wt_k1
            + ev["train"]["launches"]["K1"] + su["launches"]["K1"] + dd_k1
            + rn["launches"]["K1"] + rn64["launches"]["K1"] + p16["launches"]["K1"]
            + p24["launches"]["K1"] + p256["launches"]["K1"],
            "launches_by_path": {"train": tr["launches"]["K1"],
                                 "smaller_train": st["launches"]["K1"],
                                 "window_train": wt_k1,
                                 "eval_train": ev["train"]["launches"]["K1"],
                                 "supervised_train": su["launches"]["K1"],
                                 "ddp_train": dd_k1, "reenact": rn["launches"]["K1"],
                                 "reenact_64": rn64["launches"]["K1"],
                                 "pe16": p16["launches"]["K1"],
                                 "pe24": p24["launches"]["K1"],
                                 "paper_64_256": p256["launches"]["K1"]},
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
            # data parallelism: NCCL at world 1 (the NCCL kernels' runs and
            # device ms, the steady windowed step with and without the group)
            # and gloo at world 2 on the one card
            "ddp": {k: dd[k] for k in ("nccl_world1", "step_ms", "gloo", "nccl_multi")},
            "supervised": {k: su[k] for k in ("sigterm_after", "resumed_from", "save_ms",
                                             "ckpt_mb", "whole_s", "supervised_s", "phase_s")},
            "feed_rows_s": wt["feed_rows_s"],
            "smaller_train_step_ms": st["step_ms"],
            # the reenactment demo's 2000 steps at 128²: the steady windowed
            # step between print lines, and the training's wall seconds
            "reenact_step_ms": rn["step_ms"],
            "reenact_train_s": rn["train_s"],
            # the demo at 64² (512 rays, 16 + 16 samples), now through K1
            "reenact_64_step_ms": rn64["step_ms"],
            "reenact_64_train_s": rn64["train_s"],
            "reenact_64_window": rn64["window"],
            "step_vs_f32": ts,
            # [sample_counts]: SAMPLE_CASES' rays at each S through the wrapper
            "by_sample_count": sc["K1"],
            # [xyz_bands], and synth512_pe16's step against f32, steady step and window
            "by_xyz_bands": xb["K1"],
            "pe16_step_vs_f32": p16["step_vs_f32"],
            "pe16_train_step_ms": p16["train"]["step_ms"],
            "pe16_window": p16["window"],
            "pe24_step_vs_f32": p24["step_vs_f32"],
            "pe24_train_step_ms": p24["train"]["step_ms"],
            "pe24_window": p24["window"],
            # [long_rays], and synth512_paper_64_256's step against f32, steady step and window
            "by_long_rays": lr["K1"],
            "paper_64_256_step_vs_f32": p256["step_vs_f32"],
            "paper_64_256_train_step_ms": p256["train"]["step_ms"],
            "paper_64_256_window": p256["window"],
            "build": bd,  # nvcc seconds and train_pass_kernel instantiations
            "card": card,
        },
        {
            "name": "fused_paper_mlp_fwd",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_paper_mlp.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_mlp.py:234",
            "modes": ["paper", "small"],
            # the paths through K3f: coarse-only training and the σ-noise frame
            "launches": ct["launches"]["K3f"] + nf["launches"] + p16["launches"]["K3f"] + p24["launches"]["K3f"]
            + p256["launches"]["K3f"],
            "launches_by_path": {"coarse_train": ct["launches"]["K3f"],
                                 "noisy_frame": nf["launches"],
                                 # its σ-noise frame and the coarse-only variant's step and train()
                                 "pe16": p16["launches"]["K3f"],
                                 "pe24": p24["launches"]["K3f"],
                                 # its σ-noise frames and the coarse-only variant's at S = 320
                                 "paper_64_256": p256["launches"]["K3f"]},
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
            # [sample_counts]: SAMPLE_CASES' rays at each S through the wrapper
            "by_sample_count": sc["K3f"],
            "by_xyz_bands": xb["K3f"],
            "pe16_noisy_frame_ms_512": p16["noisy_frame"]["frame_ms"],
            "pe16_noisy_vs_plain_version_levels": p16["noisy_frame"]["vs_plain_version_levels"],
            "pe16_noisy_vs_f32_levels": p16["noisy_frame"]["vs_f32_levels"],
            "pe24_noisy_frame_ms_512": p24["noisy_frame"]["frame_ms"],
            "pe24_noisy_vs_plain_version_levels": p24["noisy_frame"]["vs_plain_version_levels"],
            "pe24_noisy_vs_f32_levels": p24["noisy_frame"]["vs_f32_levels"],
            "by_long_rays": lr["K3f"],
            "paper_64_256_noisy_frame_ms_512": p256["noisy_frame"]["frame_ms"],
            "paper_64_256_noisy_vs_f32_levels": p256["noisy_frame"]["vs_f32_levels"],
            "card": card,
        },
        {
            "name": "fused_paper_mlp_bwd",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_paper_mlp.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_mlp.py:333",
            "modes": ["paper", "small"],
            "launches": ct["launches"]["K3b"] + p16["launches"]["K3b"] + p24["launches"]["K3b"]
            + p256["launches"]["K3b"],
            "launches_by_path": {"coarse_train": ct["launches"]["K3b"], "pe16": p16["launches"]["K3b"],
                                 "pe24": p24["launches"]["K3b"], "paper_64_256": p256["launches"]["K3b"]},
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
            # [sample_counts]: SAMPLE_CASES' rays at each S through the wrapper
            "by_sample_count": sc["K3b"],
            # [sample_counts]' readings the tensor-core yardstick decides, and
            # its lost units caught (`_sample_control`), by S
            "sample_count_control": sc["control"],
            # [xyz_bands]: the readings, their control, the times against 10
            # bands; the coarse-only synth512_pe16 step against f32
            "by_xyz_bands": xb["K3b"],
            "xyz_bands_control": xb["control"],
            "xyz_bands_ms_ratio": xb["ratio_to_10_bands"],
            "pe16_coarse_step_vs_f32": p16["coarse_step_vs_f32"],
            "pe24_coarse_step_vs_f32": p24["coarse_step_vs_f32"],
            # [long_rays]: the readings, their control, and the exact dW check
            # beside the limits it stands in for (a lost unit at 2048 × S)
            "by_long_rays": lr["K3b"],
            "long_rays_control": lr["control"],
            "dw_exact_vs_limits": lr["dw_exact_vs_limits"],
            "paper_64_256_coarse_step_vs_f32": p256["coarse_step_vs_f32"],
            "card": card,
        },
        {
            "name": "fused_flex_fwd",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_flex.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_flex.py:131",
            # the flex paths: served frames + training (steps and validation),
            # synth512_lcode at 64 + 128 (S = 64 and 192), at hidden 512, at
            # 16 xyz bands and at 64 + 256 (S = 64 and 320, and its hidden-512
            # frames and step)
            "launches": fs["launches"] + ft["k4f_launches"] + f64["k4f_launches"] + fw["k4f_launches"]
            + fp16["k4f_launches"] + f256["k4f_launches"] + fw1024["k4f_launches"] + fw768["k4f_launches"],
            "launches_by_path": {"flex_serve": fs["launches"], "flex_train": ft["k4f_launches"],
                                 "flex_64_128": f64["k4f_launches"], "flex_w512": fw["k4f_launches"],
                                 "flex_pe16": fp16["k4f_launches"], "flex_64_256": f256["k4f_launches"],
                                 "flex_w1024": fw1024["k4f_launches"], "flex_w768": fw768["k4f_launches"]},
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
            # synth512_lcode at 64 + 128: served frames and each one's levels off f32
            "frame_ms_512_64_128": f64["frame_ms"],
            "vs_f32_levels_64_128": f64["vs_f32_levels"],
            "vs_plain_version_levels_64_128": f64["vs_plain_version_levels"],
            # [sample_counts]: SAMPLE_CASES' rays at each S through the wrapper
            "by_sample_count": sc["K4f"],
            # [xyz_bands]: 10 / 11 / 16 / 20 bands at each (S, rays) of
            # XYZ_CASES, the times against 10 bands; synth512_lcode_pe16's
            # frames against K4f's plain version and f32
            "by_xyz_bands": xb["K4f"],
            "xyz_bands_ms_ratio": {k: v for k, v in xb["ratio_to_10_bands"].items() if k.startswith("K4f_")},
            "pe16_frame_ms_512": fp16["frame_ms"],
            "pe16_vs_plain_version_levels": fp16["vs_plain_version_levels"],
            "pe16_vs_f32_levels": fp16["vs_f32_levels"],
            "pe16_plain_version_vs_f32_levels": fp16["plain_version_vs_f32_levels"],
            # [flex_long_rays]: S past 256 through the wrapper and bare at
            # hidden 256 (hidden 512 under "h512"); synth512_lcode_64_256's
            # frames (and its hidden-512 variant's)
            "by_long_rays": fl["K4f"],
            "flex_64_256_frame_ms_512": f256["frame_ms"],
            "flex_64_256_vs_plain_version_levels": f256["vs_plain_version_levels"],
            "flex_64_256_vs_f32_levels": f256["vs_f32_levels"],
            "flex_64_256_plain_version_vs_f32_levels": f256["plain_version_vs_f32_levels"],
            "flex_64_256_w512_frame_ms_512": f256["w512"]["serve"]["frame_ms"],
            "flex_64_256_w512_vs_f32_levels": f256["w512"]["serve"]["vs_f32_levels"],
            # hidden 512 (wide_chain_kernel): the train step's pair, the
            # bound by operations at the bf16 peak; its frames and sample counts
            "h512": {"ms": fk["ms"]["coarse_512"] + fk["ms"]["fine_512"],
                     "plain_ms": fk["plain_ms"]["coarse_512"] + fk["plain_ms"]["fine_512"],
                     "bound_ms": fk["bound"]["coarse_512"][0] + fk["bound"]["fine_512"][0],
                     "bound_by": fk["bound"]["coarse_512"][1],
                     "bare_ms_by_pass": {p: fk["bare_ms"][p] for p in ("coarse_512", "fine_512")},
                     "frame_ms": fw["frame_ms"], "vs_f32_levels": fw["vs_f32_levels"],
                     "vs_plain_version_levels": fw["vs_plain_version_levels"],
                     "by_sample_count": sc["K4f_512"], "by_xyz_bands": xb[f"K4f_{FLEX_WIDE}"],
                     "by_long_rays": fl[f"K4f_{FLEX_WIDE}"]},
            # hidden 768 and 1024 (sliced_chain_kernel): [flex_widths]' train
            # step pair (2048 rays at S = 64 + 128) through the wrapper and
            # bare, its bound by operations at the bf16 peak, every case;
            # synth512_lcode_w1024's / _w768's served frame
            **{f"h{h}": {"ms": fwd[f"K4f_{h}"]["S64_R2048_n3_L10"]["ms"] + fwd[f"K4f_{h}"]["S128_R2048_n3_L10"]["ms"],
                         "bare_ms": fwd[f"K4f_{h}"]["S64_R2048_n3_L10"]["bare_ms"]
                         + fwd[f"K4f_{h}"]["S128_R2048_n3_L10"]["bare_ms"],
                         "plain_ms": fwd[f"K4f_{h}"]["S64_R2048_n3_L10"]["plain_ms"]
                         + fwd[f"K4f_{h}"]["S128_R2048_n3_L10"]["plain_ms"],
                         "bound_ms": fwd[f"K4f_{h}"]["S64_R2048_n3_L10"]["bound_ms"]
                         + fwd[f"K4f_{h}"]["S128_R2048_n3_L10"]["bound_ms"],
                         "bound_by": fwd[f"K4f_{h}"]["S128_R2048_n3_L10"]["bound_by"],
                         "launches": (fw1024 if h == 1024 else fw768)["k4f_launches"],
                         "by_case": fwd[f"K4f_{h}"]} for h in sliced_widths()},
            "w1024_frame": {"frame_ms": fw1024["frame_ms"], "vs_f32_levels": fw1024["vs_f32_levels"],
                            "vs_plain_version_levels": fw1024["vs_plain_version_levels"],
                            "plain_version_vs_f32_levels": fw1024["plain_version_vs_f32_levels"],
                            "f32_limits": fw1024["f32_limits"]},
            "w768_frame": {k: fw768["serve"][k] for k in ("frame_ms", "vs_f32_levels", "vs_plain_version_levels",
                                                          "plain_version_vs_f32_levels", "f32_limits")},
            "card": card,
        },
        {
            "name": "fused_flex_bwd",
            "route": "cuda",
            "source": "nerface_tpu_torch/csrc/fused_flex.cu",
            "replaces": "nerface_tpu/ops/pallas/fused_flex.py:143",
            "launches": ft["k4b_launches"] + f64["k4b_launches"] + fw["k4b_launches"] + fp16["k4b_launches"]
            + f256["k4b_launches"] + fw1024["k4b_launches"] + fw768["k4b_launches"],
            "launches_by_path": {"flex_train": ft["k4b_launches"], "flex_64_128": f64["k4b_launches"],
                                 "flex_w512": fw["k4b_launches"], "flex_pe16": fp16["k4b_launches"],
                                 "flex_64_256": f256["k4b_launches"], "flex_w1024": fw1024["k4b_launches"],
                                 "flex_w768": fw768["k4b_launches"]},
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
            # synth512_lcode at 64 + 128: one bf16 step against f32, the windowed run
            "step_vs_f32_64_128": f64["step_vs_f32"],
            "window_64_128": f64["window"],
            # [sample_counts]: SAMPLE_CASES' rays at each S through the wrapper
            "by_sample_count": sc["K4b"],
            # [xyz_bands] (their lost-unit control is K3b's row's
            # `xyz_bands_control`), and synth512_lcode_pe16's step against
            # f32, steady step and window
            "by_xyz_bands": xb["K4b"],
            "xyz_bands_ms_ratio": {k: v for k, v in xb["ratio_to_10_bands"].items() if k.startswith("K4b_")},
            "pe16_step_vs_f32": fp16["step_vs_f32"],
            "pe16_train_step_ms": fp16["step_ms"],
            "pe16_window": fp16["window"],
            # [flex_long_rays] (their lost-unit control in "long_rays_control",
            # the exact dW check against the limits, the dead long item's
            # repeat check), and synth512_lcode_64_256's step against f32,
            # steady step and window, its hidden-512 step against f32
            "by_long_rays": fl["K4b"],
            "long_rays_control": fl["control"],
            "dw_exact_vs_limits": fl["dw_exact_vs_limits"],
            "long_dead_unit_passes": fl["dead_unit_passes"],
            "flex_64_256_step_vs_f32": f256["step_vs_f32"],
            "flex_64_256_train_step_ms": f256["step_ms"],
            "flex_64_256_window": f256["window"],
            "flex_64_256_w512_step_vs_f32": f256["w512"]["step_vs_f32"],
            # hidden 512 (wide_chain_kernel's recompute, wide_dx_kernel, dW):
            # the train step's pair, its launch split, the step and window
            "h512": {"ms": fk["bwd_ms"]["coarse_512"] + fk["bwd_ms"]["fine_512"],
                     "plain_ms": fk["bwd_plain_ms"]["coarse_512"] + fk["bwd_plain_ms"]["fine_512"],
                     "bound_ms": fk["bwd_bound"]["coarse_512"][0] + fk["bwd_bound"]["fine_512"][0],
                     "bound_by": fk["bwd_bound"]["coarse_512"][1],
                     "bare_ms_by_pass": {p: fk["bwd_bare_ms"][p] for p in ("coarse_512", "fine_512")},
                     "launch_split_by_pass": {p: fk["bwd_split"][p] for p in ("coarse_512", "fine_512")},
                     "step_ms": fw["step_ms"], "step_vs_f32": fw["step_vs_f32"], "window": fw["window"],
                     "by_sample_count": sc["K4b_512"], "sample_count_control": sc["control_512"],
                     "by_xyz_bands": xb[f"K4b_{FLEX_WIDE}"], "by_long_rays": fl[f"K4b_{FLEX_WIDE}"]},
            # hidden 768 and 1024 (sliced_chain_kernel's recompute,
            # sliced_dx_kernel, dW): [flex_widths]' train step pair, every
            # case, its lost-unit control and the exact dW check at 1024;
            # synth512_lcode_w1024's steps and window, _w768's step
            **{f"h{h}": {"ms": fwd[f"K4b_{h}"]["S64_R2048_n3_L10"]["ms"] + fwd[f"K4b_{h}"]["S128_R2048_n3_L10"]["ms"],
                         "bare_ms": fwd[f"K4b_{h}"]["S64_R2048_n3_L10"]["bare_ms"]
                         + fwd[f"K4b_{h}"]["S128_R2048_n3_L10"]["bare_ms"],
                         "plain_ms": fwd[f"K4b_{h}"]["S64_R2048_n3_L10"]["plain_ms"]
                         + fwd[f"K4b_{h}"]["S128_R2048_n3_L10"]["plain_ms"],
                         "bound_ms": fwd[f"K4b_{h}"]["S64_R2048_n3_L10"]["bound_ms"]
                         + fwd[f"K4b_{h}"]["S128_R2048_n3_L10"]["bound_ms"],
                         "bound_by": fwd[f"K4b_{h}"]["S128_R2048_n3_L10"]["bound_by"],
                         "launches": (fw1024 if h == 1024 else fw768)["k4b_launches"],
                         "by_case": fwd[f"K4b_{h}"]} for h in sliced_widths()},
            "sliced_control": fwd["control"],
            "sliced_dw_exact_vs_limits": fwd["dw_exact_vs_limits"],
            "w1024_train": {"step_ms": fw1024["step_ms"], "step_vs_f32": fw1024["step_vs_f32"],
                            "window": fw1024["window"], "loss_printed": fw1024["loss_printed"]},
            "w768_step_vs_f32": fw768["step_vs_f32"],
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
            # [sample_counts]' grid: Sc 3..200 × Sf 1..56 on 2072 rays, both regimes
            "by_shape": sc["K5"],
            # the long regime (Sc + Sf past 256): its grid on 2072 rays, and a
            # 65536-ray tile at 64 + 256 in both regimes
            "by_shape_long": rk["long"]["grid"],
            "long_tile_64_256": rk["long"]["tile"],
            "design": K5_DESIGN,
            "card": card,
        },
        _probe_entry(pr["P2"], "chain_overlap", "twochain",
                     "tools/perf/chain_overlap_probe.py:119", card),
        _probe_entry(pr["P1"], "encoder_concat", "packed",
                     "tools/perf/encoder_concat_probe.py:77", card),
    ]}
    seconds = phase_seconds(t_run)
    phase("timing", f"seconds a phase, from its first line to the next phase's first line (a phase that prints "
                    f"only at its end shows under the one before it: the build under [device]): "
                    f"{json.dumps(seconds)}; the run {time.perf_counter() - t_run:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
