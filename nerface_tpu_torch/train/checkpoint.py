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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def params_from_jax(numpy_tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{name: array} (the JAX package's per-model params, pulled to numpy)
    -> {name: f32 tensor}, in the tree's key order."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        for k, v in numpy_tree.items()
    }


def load_torch_checkpoint(path: str, device=None) -> Dict[str, Any]:
    """Read a reference-schema `.ckpt`. Returns {"iter", "coarse", "fine",
    "background", "latent_codes"}: coarse/fine are state dicts (fine may be
    None), background and latent_codes tensors or None, all on `device`
    (the CPU by default)."""
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
    }
