"""The data-parallel dryrun: one DP train step on N ranks, each a process
of its own, against the one-process step.

The counterpart of `__graft_entry__.dryrun_multichip(n, n_processes)`: the
ranks join one group (gloo on the CPU, or gloo with every rank on one card
where NCCL would refuse two ranks on one GPU), each takes its block of one
global batch (`distributed.local_batch`) and its rows of the injected
draws, and runs the window's step body (`window.train_step`) with the
all-reduce. `dp_step` is a rank's side, run by `distributed.spawn`;
`dryrun` spawns it and returns every rank's updated state; `train_replica`
is a rank's whole `train()` run, for the same checks over many steps.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nerface_tpu_torch.config import CfgNode
from nerface_tpu_torch.train import distributed
from nerface_tpu_torch.train.state import build_optimizer
from nerface_tpu_torch.train.window import train_step


def replica_arrays(state, optimizer=None) -> Dict[str, np.ndarray]:
    """Every parameter and, with the `optimizer`, its Adam moments
    (`exp_avg/...`, `exp_avg_sq/...`), by name, as numpy."""
    named = [(f"coarse.{n}", p) for n, p in state.model_coarse.named_parameters()]
    if state.model_fine is not None:
        named += [(f"fine.{n}", p) for n, p in state.model_fine.named_parameters()]
    if state.latent_codes is not None:
        named.append(("latent_codes", state.latent_codes))
    if state.train_background:
        named.append(("background", state.background))
    out = {}
    for name, p in named:
        out[name] = p.detach().cpu().numpy().copy()
        st = optimizer.state.get(p, {}) if optimizer is not None else {}
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                out[f"{k}/{name}"] = st[k].detach().cpu().numpy().copy()
    return out


def dp_step(payload: Dict[str, Any]) -> Dict[str, Any]:
    """One rank's DP step. `payload`: `state` (a TrainState), `opt_cfg` (the
    optimizer and scheduler config as a dict), `batch` and `draws` (the
    global batch and its draws, tensors), `settings`, `flags`, `seed`,
    `dtype`, `device`, and `timed_steps` n. Returns the rank's `arrays`
    (`replica_arrays`) and `metrics` (the step's METRIC_KEYS vector), both
    after the one step; with n, then the wall ms of n more steps on the same
    batch (`step_ms`) and of n all-reduces alone (`all_reduce_ms`), each
    synchronised."""
    torch.set_num_threads(1)
    dev = torch.device(payload.get("device") or "cpu")
    # a copy of its own: a spawned rank receives the caller's CPU tensors in
    # shared memory, which every rank would update
    state = copy.deepcopy(payload["state"])
    for m in (state.model_coarse, state.model_fine):
        if m is not None:
            m.to(dev)
    if state.latent_codes is not None:
        state.latent_codes.data = state.latent_codes.data.to(dev)
    if state.background is not None:
        state.background.data = state.background.data.to(dev)
    optimizer = build_optimizer(CfgNode(payload["opt_cfg"]), state)
    batch = {k: v.to(dev) for k, v in payload["batch"].items()}
    n = batch["ray_origins"].shape[0]
    batch = distributed.local_batch(batch)
    sl = distributed.process_ray_slice(n)
    draws = {k: v[sl].to(dev) for k, v in (payload.get("draws") or {}).items()} or None
    reducer = None
    if distributed.initialized():
        from nerface_tpu_torch.train.window import METRIC_KEYS

        reducer = distributed.GradReducer(
            [p for g in optimizer.param_groups for p in g["params"]], len(METRIC_KEYS))
    def step():
        return train_step(state, optimizer, batch, payload.get("seed", 0), payload["settings"],
                          payload["flags"], dtype=payload.get("dtype"),
                          fused=payload.get("fused", False), reducer=reducer, draws=draws)

    vec = step()
    out = {"arrays": replica_arrays(state, optimizer), "metrics": vec.detach().cpu().numpy()}
    n_timed = int(payload.get("timed_steps") or 0)
    if n_timed:
        out["step_ms"] = _timed(step, n_timed, dev)
        if reducer is not None:
            out["all_reduce_ms"] = _timed(lambda: reducer(vec), n_timed, dev)
    return out


def _timed(fn, n, dev) -> List[float]:
    """`fn`'s wall ms, `n` calls, each synchronised on the device."""
    import time

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ms = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def dryrun(payload: Dict[str, Any], world: int, backend: str = "gloo",
           init_method: Optional[str] = None, timeout: Optional[float] = None) -> List[Dict]:
    """`dp_step` on `world` spawned ranks; every rank's result, in rank
    order."""
    return distributed.spawn(dp_step, world, args=(payload,), backend=backend,
                             devices=[payload.get("device") or "cpu"] * world,
                             init_method=init_method, timeout=timeout)


def train_replica(cfg_dict: Dict[str, Any], device, bf16: bool = False,
                  **train_kwargs) -> Dict[str, Any]:
    """A rank's `train()` of the config `cfg_dict` on `device` (the dataset
    read from its `dataset.basedir`): its parameters (`replica_arrays`) and
    the launches of the paper family's kernel wrappers it made (K1, K2)."""
    from nerface_tpu_torch.ops.kernels import fused_mlp, fused_train
    from nerface_tpu_torch.train.loop import train

    counters = {"K1": fused_train.fused_train_pass, "K2": fused_mlp.fused_paper_render}
    for c in counters.values():
        c.launches = 0
    state = train(CfgNode(cfg_dict), dtype=torch.bfloat16 if bf16 else None, device=device,
                  **train_kwargs)
    return {"arrays": replica_arrays(state), "launches": {k: c.launches for k, c in counters.items()}}
