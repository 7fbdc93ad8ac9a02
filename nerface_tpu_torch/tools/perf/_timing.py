"""CUDA-event timing shared by the probes."""

from __future__ import annotations

import statistics

import torch


def median_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median milliseconds of `fn()` on the current CUDA stream, each call
    between two CUDA events, after `warmup` calls."""
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


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "?"
