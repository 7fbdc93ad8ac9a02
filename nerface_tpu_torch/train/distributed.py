"""Data parallelism over processes: one process a device, joined by
`torch.distributed`.

Port of `nerface_tpu/train/distributed.py`. JAX joins every process's chips
into one global mesh and its DP step is `shard_map` + `pmean`
(`nerface_tpu/train/step.py:172-201`). Here each rank is a process that
drives one device (`cuda:r` over NCCL on the card, the CPU over gloo), and
the train step all-reduces its gradients and metrics itself
(`GradReducer`, called by train/window.py between `backward()` and the
optimizer's step): one preallocated flat buffer, summed over the ranks and
divided by the world size. A CUDA graph captures that call with the step;
`DistributedDataParallel`'s bucket hooks would fight the capture and K1's
autograd.Function. NCCL and gloo hand every rank the same reduced bits, so
every rank ends each step with the same parameters and optimizer state.

Data: every rank builds the same initial weights from the seeded generator
(`check_replicas_agree` holds them to it at set-up and at a resume). The
host feed's ranks all draw the same global batch from the shared seed and
keep their block of it (`local_batch`, JAX's `global_batch`); the device
feed's rank r draws block r of the step itself
(`data/device_feed.py::DeviceRayFeed.draw(position=r)`). Either way each
ray keeps its global index, which keys its draws, so a DP step computes
what the one-process step computes over the whole batch, up to the order
of the sums.

`spawn` starts the ranks of one host (start method spawn) and joins them:
`cli/train.py --num-devices N` runs through it.
"""

from __future__ import annotations

import os
import queue as queue_mod
import signal
import socket
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

#: batch entries carrying a per-ray leading axis (split over the ranks);
#: everything else (expression vector, latent index) is shared.
RAY_KEYS = frozenset({
    "ray_origins", "ray_directions", "target_rgb", "background_rgb",
    "pixel_indices", "ray_index",
})


def _dist():
    import torch.distributed as dist

    return dist


def initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Join this process to the group as rank `process_id` of
    `num_processes`. `coordinator_address` is HOST:PORT (rank 0 listens
    there) or an init URL such as `file:///path`. `backend` defaults to
    NCCL for a CUDA `device` and gloo otherwise; a CUDA device becomes this
    process's current device first."""
    dist = _dist()
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kwargs = {}
    if backend == "nccl":
        # the communicator is made here, not at the first collective (which
        # may be inside a CUDA graph capture)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init, world_size=int(num_processes),
                            rank=int(process_id), **kwargs)


def world_size() -> int:
    return _dist().get_world_size() if initialized() else 1


def rank() -> int:
    return _dist().get_rank() if initialized() else 0


def is_primary() -> bool:
    """True on the rank that owns logging and checkpoint IO."""
    return rank() == 0


def backend() -> Optional[str]:
    return str(_dist().get_backend()) if initialized() else None


def process_ray_slice(n_rays: int) -> slice:
    """This rank's contiguous block of the global ray axis."""
    nproc = world_size()
    if n_rays % nproc:
        raise ValueError(f"{n_rays} rays not divisible by {nproc} processes")
    per = n_rays // nproc
    r = rank()
    return slice(r * per, (r + 1) * per)


def local_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The global batch (the same on every rank) → this rank's block: the
    ray entries sliced, `ray_index` added as the block's global indices,
    the other entries whole. With one rank, the batch as it is."""
    if world_size() == 1:
        return batch
    n = next(v.shape[0] for k, v in batch.items() if k in RAY_KEYS)
    sl = process_ray_slice(n)
    out = {k: (v[sl] if k in RAY_KEYS else v) for k, v in batch.items()}
    if "ray_index" not in out:
        first = batch["ray_origins"]
        if isinstance(first, torch.Tensor):
            out["ray_index"] = torch.arange(sl.start, sl.stop, device=first.device)
        else:
            out["ray_index"] = np.arange(sl.start, sl.stop, dtype=np.int32)
    return out


def all_reduce_mean_(flat: torch.Tensor) -> torch.Tensor:
    """`flat` ← its mean over the ranks, in place (a sum, then a division by
    the world size, as JAX's `pmean`). In a group of one rank the
    collective still runs, and the bits stay as they are."""
    if initialized():
        _dist().all_reduce(flat)
        n = world_size()
        if n > 1:
            flat.div_(n)
    return flat


class GradReducer:
    """The DP step's one collective: a step's gradients, in `params`' order
    (the optimizer's: `TrainState.ordered_params()`, then the background
    slot), and its metric vector, copied into one flat f32 buffer allocated
    here, averaged over the ranks by one all-reduce and copied back. The
    buffer never moves, so a CUDA graph may capture the call (the copies
    write into the gradients' storage; they never rebind them). A parameter
    with no gradient keeps none; its part of the buffer stays zero."""

    def __init__(self, params: Iterable[torch.Tensor], n_metrics: int):
        self.params = [p for p in params if p.requires_grad]
        dev = self.params[0].device
        numel = sum(p.numel() for p in self.params)
        self.flat = torch.zeros(numel + int(n_metrics), dtype=torch.float32, device=dev)
        self.views: List[torch.Tensor] = []
        off = 0
        for p in self.params:
            self.views.append(self.flat[off:off + p.numel()])
            off += p.numel()
        self.metrics = self.flat[off:]

    def __call__(self, metrics: torch.Tensor) -> torch.Tensor:
        """Average the gradients in place; returns the averaged metrics (a
        view of the buffer)."""
        for p, v in zip(self.params, self.views):
            if p.grad is not None:
                v.copy_(p.grad.reshape(-1))
        self.metrics.copy_(metrics)
        all_reduce_mean_(self.flat)
        for p, v in zip(self.params, self.views):
            if p.grad is not None:
                p.grad.copy_(v.view(p.grad.shape))
        return self.metrics


def check_replicas_agree(tensors: Sequence[torch.Tensor], what: str) -> None:
    """Raise unless every rank holds the same `tensors`: two f64 checksums
    (the sum, and a sum weighted by position), their max and min over the
    ranks from one all-reduce."""
    if world_size() == 1:
        return
    x = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
    w = torch.linspace(1.0, 2.0, x.numel(), dtype=torch.float64, device=x.device)
    c = torch.stack([x.sum(), (x * w).sum()])
    both = torch.cat([c, -c])
    _dist().all_reduce(both, op=_dist().ReduceOp.MAX)
    if not torch.equal(both[:2], -both[2:]):
        raise RuntimeError(f"the ranks disagree on {what}: checksums max {both[:2].tolist()}, "
                           f"min {(-both[2:]).tolist()}")


def barrier() -> None:
    if initialized():
        _dist().barrier()


def shutdown() -> None:
    """The end of a run: wait for every rank, then leave the group."""
    if initialized():
        dist = _dist()
        dist.barrier()
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on the loopback that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_GRACE_S = 10.0


def _rank_main(r, nprocs, init, backend_name, devices, fn, args, results):
    device = devices[r] if devices is not None else None
    initialize(init, nprocs, r, backend_name, device)
    try:
        out = fn(*args)
        shutdown()
    except SystemExit as e:  # the CLI's SIGTERM → 143
        os._exit(e.code if isinstance(e.code, int) else int(e.code is not None))
    results.put((r, out))


def spawn(
    fn: Callable,
    nprocs: int,
    args: tuple = (),
    devices: Optional[Sequence] = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout: Optional[float] = None,
) -> List[Any]:
    """Run `fn(*args)` on `nprocs` ranks, each a process of its own (start
    method spawn), rank r on `devices[r]`, joined into one group over
    `backend` (default: NCCL for CUDA devices, else gloo) at `init_method`
    (default: a free loopback port). `fn` must be importable by name.
    Returns each rank's return value, in rank order. A rank that fails
    stops the others and raises here. SIGTERM to this process is passed on
    to the ranks, and once they are gone this process exits with 143."""
    mp = torch.multiprocessing.get_context("spawn")
    init = init_method or f"127.0.0.1:{free_port()}"
    results = mp.Queue()
    procs = [mp.Process(target=_rank_main, daemon=False,
                        args=(r, nprocs, init, backend, list(devices) if devices else None,
                              fn, args, results))
             for r in range(nprocs)]
    stopping = []

    def on_term(*_):
        stopping.append(True)
        for p in procs:
            if p.pid is not None and p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    main_thread = threading.current_thread() is threading.main_thread()
    prev = signal.signal(signal.SIGTERM, on_term) if main_thread else None
    out: Dict[int, Any] = {}
    failed = None
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < nprocs:
            try:
                r, v = results.get(timeout=0.2)
                out[r] = v
                continue
            except queue_mod.Empty:
                pass
            if stopping:
                break
            if any(p.exitcode not in (None, 0) for p in procs):
                failed = f"exit codes {[p.exitcode for p in procs]}"
                break
            if all(p.exitcode == 0 for p in procs) and results.empty():
                failed = "a rank exited without a result"
                break
            if deadline is not None and time.monotonic() > deadline:
                failed = f"no result after {timeout} s"
                break
    finally:
        if failed is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        # a rank blocked in a collective whose peer has gone never returns
        # to Python to take its SIGTERM: it is killed after a grace period
        for p in procs:
            if p.pid is None:  # never started
                continue
            p.join(_GRACE_S)
            if p.is_alive():
                p.kill()
                p.join()
        if main_thread:
            signal.signal(signal.SIGTERM, prev)
    if stopping:
        raise SystemExit(143)
    if failed is not None:
        raise RuntimeError(f"{nprocs} spawned ranks failed: {failed}")
    return [out[r] for r in range(nprocs)]
