"""K3f (`fused_paper_mlp_forward`) and K5 (`fused_resample`) through their
wrappers and as bare C launches, on the card, each beside its bound.

The K3f wrapper gathers the weights' chunk images and packs the f32 rows on
every call; here they are packed once and only the launch is timed,
through the wrapper's own `_launch_paper_fwd` (which counts it): the paper
model at 2048 rays (S = 64 and 128, a coarse-only training pass) and on
the 65536-ray tiles of the σ-noise frame. K5's wrapper checks its operands
and allocates the output; its bare launch is `_launch_resample` into a
preallocated output, at 2048 rays and a 65536-ray tile, 64 + 64 samples,
in the general regime (per-ray u) and with `sorted_u` (one linspace row);
at K5's tens of microseconds CUDA events around one call also hold the
host's launch overhead, so its device time under torch.profiler is read
too (or, where the profiler sees no kernel, CUDA events around launches
queued back to back), and its GB/s from that.
Rays, depths and weights come from `tools/perf/cases.py`.

`--k5-grid` times K5 alone instead, on `chip_smoke.py`'s `[sample_counts]`
grid at 2072 rays (Sc + Sf ≤ 256, the short kernel) in both regimes, each
cell's device ms read from launches queued back to back (`queued_ms`).
It calls only what every checkout of
the port with K5 has, so it times two trees against each other: run this
file with PYTHONPATH at each checkout's root, in turns (parent, change,
change, parent), each building its own library under its own build/.

    python -m nerface_tpu_torch.tools.perf.k3f_k5_launch_split [--k5-grid] [--json PATH]

It prints the card line, one line per case, and a JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_resample as K5
from nerface_tpu_torch.tools.perf._timing import card_line, median_ms
from nerface_tpu_torch.tools.perf.cases import paper_case, resample_inputs
from nerface_tpu_torch.tools.perf.k1_launch_split import (
    FORWARD_KN,
    PEAK_BF16_FLOPS,
    PEAK_BYTES_S,
    _flop,
    kernel_split,
)

K3F_CASES = ((2048, 64), (2048, 128), (65536, 64), (65536, 128))
K5_RAYS = (2048, 65536)


def k3f_work(R, S, small):
    """(operations, bytes) of one K3f call: the forward's products at the
    function's widths; the rays, depths and dir_c read, the packed
    weights and rows read, the (R, S, 4) rows written."""
    rays = R * 4 * (3 + 3 + S + 128)
    weights = 2 * K.W_OFFSETS["TOTAL"] + 4 * K.F_OFFSETS["TOTAL"]
    return R * S * _flop(FORWARD_KN, small), rays + R * S * 16 + weights


def k5_bytes(R, Sc, Sf, shared_u):
    """z and w read, u read ((R, Sf), or one (Sf,) row), the union written."""
    u = Sf if shared_u else R * Sf
    return 4 * (2 * R * Sc + u + R * (Sc + Sf))


def bound_ms(flop, nbytes):
    """(least ms, "operations" or "bytes"): the larger of the operations at
    the bf16 dense peak and the bytes at the memory rate."""
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3f_bare(bundle, rays, small=False):
    """K3f's launch alone (`_launch_paper_fwd`, the one C call), as a
    function: the operands packed and the output allocated beforehand."""
    ro, rd, z = rays["ro"], rays["rd"], rays["z"]
    R, S = z.shape
    operands = K._kernel_operands(bundle, R, ro.device, 10, True, small, transposed=False)
    out = torch.empty(R, S, 4, dtype=torch.float32, device=ro.device)
    return lambda: K._launch_paper_fwd(operands, (ro, rd, z), out, 10, small)


def k5_bare(z, w, u, sorted_u):
    """K5's launch alone (`_launch_resample`) into a preallocated output."""
    out = torch.empty(z.shape[0], z.shape[1] + u.shape[-1], dtype=torch.float32, device=z.device)
    return lambda: K5._launch_resample(z, w, u, out, sorted_u)


def queued_ms(fn, n=50, hold_cycles=20_000_000):
    """Device ms a call of `fn` from CUDA events around `n` calls queued
    behind a spin kernel (`torch.cuda._sleep`, ≈ 10 ms at the H100's clock)
    that holds the stream while the host enqueues them: the calls run back
    to back, so the host's launch overhead falls outside, and the gaps
    between launches inside."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, name):
    """(device ms, how) of a call of the kernels whose names hold `name`
    that `fn` launches: a short kernel's time without the host's launch
    overhead, which CUDA events around one call include. Read under
    torch.profiler ("profiler"); where the profiler sees no such kernel,
    from `queued_ms` ("queued events")."""
    ms = sum(ms for key, (ms, _) in kernel_split([fn], n=20).items() if name in key)
    return (ms, "profiler") if ms > 0 else (queued_ms(fn), "queued events")


def measure(dev):
    """Wrapper and bare-launch median ms of every case, beside its bound:
    {case: {...}}."""
    from nerface_tpu_torch.ops.math import linspace01

    res = {}
    for R, S in K3F_CASES:
        bundle, rays = paper_case(R, S, 7 + S, dev, False)
        args = (bundle, rays["ro"], rays["rd"], rays["z"])
        iters = 10 if R > 2048 else 20
        flop, nbytes = k3f_work(R, S, False)
        r = {"ms": median_ms(lambda: K.fused_paper_mlp_forward(*args), 3, iters),
             "bare_ms": median_ms(k3f_bare(bundle, rays), 3, iters)}
        r["bound_ms"], r["bound_by"] = bound_ms(flop, nbytes)
        r["tflops"] = flop / r["bare_ms"] / 1e9
        print(f"[k3f_k5_split] K3f {R}x{S}: wrapper {r['ms']:.3f} ms, bare launch {r['bare_ms']:.3f} ms "
              f"({r['tflops']:.1f} TFLOP/s); bound {r['bound_ms']:.3f} ms ({r['bound_by']})", flush=True)
        res[f"k3f_{R}x{S}"] = r
        del bundle, rays, args
        torch.cuda.empty_cache()
    for R in K5_RAYS:
        z, w, u = resample_inputs(R, 64, 64, 30, dev)
        for regime, uu in (("general", u), ("sorted_u", linspace01(64, device=dev))):
            srt = regime == "sorted_u"
            nbytes = k5_bytes(R, 64, 64, srt)
            bare = k5_bare(z, w, uu, srt)
            r = {"ms": median_ms(lambda: K5.fused_resample(z, w, uu, sorted_u=srt), 5, 30),
                 "bare_ms": median_ms(bare, 5, 30)}
            r["device_ms"], r["device_by"] = device_ms(bare, "resample_kernel")
            r["bound_ms"], r["bound_by"] = bound_ms(0, nbytes)
            r["gb_s"] = nbytes / r["device_ms"] / 1e6
            print(f"[k3f_k5_split] K5 {regime} {R} rays, 64 + 64: wrapper {r['ms']:.4f} ms, bare launch "
                  f"{r['bare_ms']:.4f} ms, device {r['device_ms']:.4f} ms by {r['device_by']} ({r['gb_s']:.0f} GB/s); bound "
                  f"{r['bound_ms']:.4f} ms (bytes)", flush=True)
            res[f"k5_{regime}_{R}"] = r
    return res


# chip_smoke.py's [sample_counts] K5 grid (Sc + Sf ≤ 256) on its ragged ray count
GRID_RAYS = 2072
GRID = ((3, 16, 24, 48, 96, 200), (1, 33, 56))


def measure_k5_grid(dev):
    """K5's device ms (`queued_ms`, 50 launches back to back) at every
    cell of GRID within Sc + Sf ≤ 256, both regimes: {"Sc+Sf regime @R":
    ms}."""
    from nerface_tpu_torch.ops.math import linspace01

    res = {}
    for sc in GRID[0]:
        for sf in GRID[1]:
            if sc + sf > 256:
                continue
            z, w, u = resample_inputs(GRID_RAYS, sc, sf, 31 + sc * 1000 + sf, dev)
            for regime in ("general", "sorted_u"):
                srt = regime == "sorted_u"
                uu = linspace01(sf, device=dev) if srt else u
                label = f"{sc}+{sf} {regime} @{GRID_RAYS}"
                res[label] = queued_ms(k5_bare(z, w, uu, srt))
                print(f"[k5_grid] K5 {label}: device {res[label]:.5f} ms (queued launches)", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k5-grid", action="store_true", help="time K5 alone on chip_smoke.py's grid")
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    res = measure_k5_grid(dev) if args.k5_grid else measure(dev)
    line = json.dumps({"card": card, "cases": res})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
