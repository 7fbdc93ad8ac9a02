"""Checkpoint interop in the reference's `.ckpt` schema.

Port of the torch-interop half of `nerface_tpu/train/checkpoint.py`: the
reference's `torch.save` dict (`train_transformed_rays.py:554-572`) with
`model_coarse_state_dict` / `model_fine_state_dict` under the reference's
parameter names, `background` and `latent_codes`. A checkpoint written by
the reference or by the JAX package's `export_torch_checkpoint` loads here
with no JAX at all. Orbax directories are not read: orbax needs JAX.

`params_from_jax` carries a numpy parameter tree of the JAX package (its
params are dicts keyed by the same state-dict names) into tensors for
`load_state_dict(strict=True)`.

Training: `save_torch_checkpoint` writes a train state in that schema with
the Adam state as `optimizer_state_dict` (the reference's two param
groups; the JAX package's `load_torch_checkpoint` +
`import_torch_optimizer_state` read it), to a temporary file renamed into
place; `AsyncCheckpointWriter` writes it from a worker thread;
`latest_checkpoint` finds a run's newest complete `.ckpt` (the
supervisor's resume point); and `restore_train_state` resumes
from such a file — written by the port, the reference or the JAX
package's `export_torch_checkpoint`: weights, latent table, background,
step and Adam moments; `train_state_from_jax` does the same from a JAX
`TrainState` pulled to numpy. The latent table and a trainable background keep
training after a resume (the reference's resume rebinds them to fresh
tensors its optimizer never sees; PARITY.md).
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from nerface_tpu_torch.train.state import conform_optimizer_state


def params_from_jax(numpy_tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{name: array} (the JAX package's per-model params, pulled to numpy)
    -> {name: f32 tensor}, in the tree's key order."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        for k, v in numpy_tree.items()
    }


def load_torch_checkpoint(path: str, device=None) -> Dict[str, Any]:
    """Read a reference-schema `.ckpt`. Returns {"iter", "coarse", "fine",
    "background", "latent_codes", "optimizer"}: coarse/fine are state dicts
    (fine may be None), background and latent_codes tensors or None, all on
    `device` (the CPU by default); optimizer the saved
    `optimizer_state_dict` as it is, or None."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)

    def _sd(sd: Optional[Mapping[str, torch.Tensor]]):
        if sd is None:
            return None
        return {k: v.detach().to(device=device, dtype=torch.float32) for k, v in sd.items()}

    def _t(v):
        return None if v is None else v.detach().to(device=device, dtype=torch.float32)

    return {
        "iter": int(ckpt.get("iter", 0)),
        "coarse": _sd(ckpt["model_coarse_state_dict"]),
        "fine": _sd(ckpt.get("model_fine_state_dict")),
        "background": _t(ckpt.get("background")),
        "latent_codes": _t(ckpt.get("latent_codes")),
        "optimizer": ckpt.get("optimizer_state_dict"),
    }


def _payload(state, optimizer, loss, psnr) -> Dict[str, Any]:
    """The `.ckpt`'s dict (`train_transformed_rays.py:554-572`) holding the
    live tensors themselves, the optimizer's LR and the metrics as they
    are (tensors or numbers): no copy, no read from the card."""

    def sd(module):
        return None if module is None else {k: v.detach() for k, v in module.state_dict().items()}

    def t(x):
        return None if x is None else x.detach()

    return {
        "iter": int(state.step),
        "model_coarse_state_dict": sd(state.model_coarse),
        "model_fine_state_dict": sd(state.model_fine),
        "optimizer_state_dict": optimizer.state_dict(),
        "loss": loss,
        "psnr": psnr,
        "background": t(state.background),
        "latent_codes": t(state.latent_codes),
    }


def _tree_map(fn, x):
    """`fn` on every tensor of a nest of dicts, lists and tuples."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


def _finish_payload(payload: Dict[str, Any]) -> Dict[str, Any]:
    """A payload whose tensors are on the host as the schema holds them:
    the LRs and the metrics as floats."""
    opt = payload["optimizer_state_dict"]
    opt["param_groups"] = [
        dict(g, lr=float(g["lr"])) if isinstance(g["lr"], torch.Tensor) else g
        for g in opt["param_groups"]
    ]
    payload["loss"], payload["psnr"] = float(payload["loss"]), float(payload["psnr"])
    return payload


def _write_atomic(payload: Dict[str, Any], path: str) -> str:
    """`torch.save` to `path`.tmp, synced to the disk, then a rename: a
    process killed while writing leaves a `.tmp` that `latest_checkpoint`
    skips, never a torn `.ckpt`."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def save_torch_checkpoint(path: str, state, optimizer, loss=0.0, psnr=0.0) -> str:
    """Write `state` (train/state.py) and `optimizer` as a reference-schema
    `.ckpt` (`train_transformed_rays.py:554-572`), atomically; returns
    `path`. `loss` and `psnr` may be 0-d tensors."""
    payload = _tree_map(lambda x: x.cpu(), _payload(state, optimizer, loss, psnr))
    return _write_atomic(_finish_payload(payload), path)


class AsyncCheckpointWriter:
    """Checkpoint writes off the training thread (the port of
    `nerface_tpu/train/checkpoint.py::AsyncCheckpointWriter`).

    `submit` clones the state's tensors, the optimizer's state and the
    metrics on the current (training) stream, records an event after the
    clones and hands them to one worker thread, which copies them to
    pinned host memory on a stream of its own once the event has
    completed and writes the `.ckpt` as `save_torch_checkpoint` does, so
    the training thread neither reads the card nor waits for the disk. At
    most one write is in flight: a second `submit` first drains the
    previous one, bounding the snapshots to one. `finish()` joins the
    worker and re-raises a failed write; call it before reading the
    checkpoint directory. The clones are never made inside a captured
    graph: the loop submits between windows."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._future = None
        self._stream = None

    def submit(self, path: str, state, optimizer, loss=0.0, psnr=0.0):
        self.drain()
        snap = _tree_map(lambda x: x.clone(), _payload(state, optimizer, loss, psnr))
        ready = None
        dev = next(state.model_coarse.parameters()).device
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=dev)
        self._future = self._pool.submit(self._write, path, snap, ready)

    def _write(self, path, snap, ready):
        if ready is not None:
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(ready)
                snap = _tree_map(
                    lambda x: torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(
                        x, non_blocking=True) if x.is_cuda else x,
                    snap,
                )
            self._stream.synchronize()
        return _write_atomic(_finish_payload(snap), path)

    def drain(self):
        if self._future is not None:
            fut, self._future = self._future, None
            fut.result()

    def finish(self):
        try:
            self.drain()
        finally:
            self._pool.shutdown(wait=True)


_CKPT_NAME = re.compile(r"checkpoint(\d+)\.ckpt")


def checkpoint_step(path: str) -> int:
    """Step number of a `checkpoint{step}.ckpt` basename (-1 if none).

    Numeric, not lexical: `checkpoint{step:05d}` grows to 6 digits past
    step 99999 (the reference's paper schedule runs to 1M), where string
    order would rank `checkpoint100001` below `checkpoint95001`."""
    m = _CKPT_NAME.fullmatch(os.path.basename(path))
    return int(m.group(1)) if m else -1


def is_complete_checkpoint(path: str) -> bool:
    """True for a `checkpoint{step}.ckpt` file: `save_torch_checkpoint`
    renames it into place only once written, so a process killed
    mid-save leaves a `.tmp`, which this rejects."""
    return checkpoint_step(path) >= 0 and os.path.isfile(path)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Highest-step complete `checkpoint{step}.ckpt` under `ckpt_dir`."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [os.path.join(ckpt_dir, d) for d in os.listdir(ckpt_dir)]
    cands = [p for p in cands if is_complete_checkpoint(p)]
    return max(cands, key=checkpoint_step) if cands else None


def restore_train_state(state, optimizer, ckpt: Dict[str, Any]):
    """Load a `load_torch_checkpoint` dict into `state` and `optimizer`
    (made by `create_train_state` / `build_optimizer` for the same config)
    in place; returns `state`."""
    with torch.no_grad():
        for which, module in (("coarse", state.model_coarse), ("fine", state.model_fine)):
            if module is not None and ckpt.get(which) is not None:
                module.load_state_dict(ckpt[which], strict=True)
        codes = ckpt.get("latent_codes")
        if codes is not None and state.latent_codes is not None:
            if tuple(codes.shape) != tuple(state.latent_codes.shape):
                raise ValueError(
                    f"checkpoint latent_codes {tuple(codes.shape)} != the run's "
                    f"{tuple(state.latent_codes.shape)}"
                )
            state.latent_codes.copy_(codes)
        if ckpt.get("background") is not None and state.background is not None:
            state.background.copy_(ckpt["background"].reshape(state.background.shape))
    state.step = int(ckpt.get("iter", 0))
    if ckpt.get("optimizer") is not None:
        lr = optimizer.param_groups[0]["lr"]
        capturable = [g.get("capturable") for g in optimizer.param_groups]
        optimizer.load_state_dict(ckpt["optimizer"])
        conform_optimizer_state(optimizer, lr, capturable)
    return state


def _find_adam_state(opt_state):
    """The (count, mu, nu) node inside an optax state pulled to numpy."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for x in opt_state:
            found = _find_adam_state(x)
            if found is not None:
                return found
    return None


def train_state_from_jax(
    numpy_state: Any, state, optimizer: torch.optim.Adam
):
    """Load a JAX `TrainState` pulled to numpy (`jax.device_get`) into the
    port's `state` and `optimizer`, which `create_train_state` and
    `build_optimizer` made for the same config: coarse/fine params
    (`params_from_jax`), the latent table, the background (trained or
    fixed), the step, and Adam's count/mu/nu as step/exp_avg/exp_avg_sq in
    the reference order. Returns `state`."""
    params: Mapping[str, Any] = numpy_state.params
    with torch.no_grad():
        for which, module in (("coarse", state.model_coarse), ("fine", state.model_fine)):
            if module is not None:
                sd = params_from_jax(params[which])
                module.load_state_dict(sd, strict=True)
        if state.latent_codes is not None:
            state.latent_codes.copy_(torch.as_tensor(np.array(params["latent_codes"], np.float32)))
        bg = params.get("background")
        if bg is None:
            bg = numpy_state.fixed_background
        if bg is not None and state.background is not None:
            state.background.copy_(torch.as_tensor(np.array(bg, np.float32)))
    state.step = int(np.asarray(numpy_state.step))

    adam = _find_adam_state(numpy_state.opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the JAX optimizer state")
    count = float(np.asarray(adam.count))
    entries: List[tuple] = []
    for which, module in (("coarse", state.model_coarse), ("fine", state.model_fine)):
        if module is not None:
            for name, p in module.named_parameters():
                entries.append((p, adam.mu[which][name], adam.nu[which][name]))
    if state.latent_codes is not None:
        entries.append((state.latent_codes, adam.mu["latent_codes"], adam.nu["latent_codes"]))
    if state.train_background:
        entries.append((state.background, adam.mu["background"], adam.nu["background"]))
    capturable = [g.get("capturable") for g in optimizer.param_groups]
    for p, mu, nu in entries:
        optimizer.state[p] = {
            "step": torch.tensor(count),
            "exp_avg": torch.as_tensor(np.array(mu, np.float32), device=p.device),
            "exp_avg_sq": torch.as_tensor(np.array(nu, np.float32), device=p.device),
        }
    conform_optimizer_state(optimizer, optimizer.param_groups[0]["lr"], capturable)
    return state

