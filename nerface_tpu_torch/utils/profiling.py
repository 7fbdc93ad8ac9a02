"""Profiling and debugging utilities.

Port of `nerface_tpu/utils/profiling.py` (the reference's vestigial hooks,
SURVEY.md §5: commented `gpu_profile` lines in
`train_transformed_rays.py:22,551,600`, wall-clock prints, and the
commented `torch.autograd.set_detect_anomaly` at :44-45): `host_rss_gb`
is copied (the train loop computes its rays/s inline, as the reference
package's does); `profile_trace` records a `torch.profiler`
trace (CPU and CUDA activities) into a directory, and `enable_debug`
turns on autograd's anomaly mode.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional


def host_rss_gb(pid: Optional[int] = None) -> Optional[float]:
    """Resident-set size of `pid` (default: this process) in GiB via
    /proc — no psutil in the image. None if the process is gone or
    /proc is unavailable; callers that need a number coalesce to 0.0."""
    path = f"/proc/{pid}/status" if pid is not None else "/proc/self/status"
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / (1024.0 * 1024.0)
    except OSError:
        return None
    return None


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Record a torch.profiler trace of the block (CPU ops, and the card's
    kernels when CUDA is available) and write it into `logdir` as a Chrome
    trace, `trace.json` (chrome://tracing, Perfetto), however the block
    ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:  # written also when the run ends in an exception (SIGTERM's exit 143)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_debug(nans: bool = True) -> None:
    """Debug-mode numerics: autograd's anomaly mode, which raises at the
    backward op that produced a NaN (torch's counterpart of JAX's
    `jax_debug_nans`). It reads every gradient back to the host, so the
    train loop runs one step a window under it."""
    import torch

    if nans:
        torch.autograd.set_detect_anomaly(True)
