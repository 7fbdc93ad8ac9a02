"""The losses of one training step.

Port of the loss half of `nerface_tpu/train/step.py`: everything between
the reference's `run_one_iter_of_nerf` call and `loss.backward()`
(`train_transformed_rays.py:336-400`); the backward, the optimizer's step
and the LR write are the train step's (train/window.py):

* coarse MSE + fine MSE against the target RGB (:355-362,382);
* the latent regularizer ‖code‖·0.0005, added ×10 when enabled (:370-372,386);
* the supervised background loss: the per-ray squared error summed over
  RGB, weighted by the fine background weight, mean ×0.001 (:375-380);
* PSNR from the coarse + fine MSE, before the regularizers (:383).

`compute_losses` is the f32 path: `render_rays` unfused, with autograd.
The train step takes `fused_losses` (K1, train/fused.py) when the step is
eligible, else `compute_losses`; both draw the same numbers. A bf16
Flexible-family step goes through `compute_losses` too: each pass's MLP is
one `fused_flex_mlp` call (render/pipeline.py), whose forward is K4f and
whose backward autograd hands to K4b.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nerface_tpu_torch.config.flags import FeatureFlags
from nerface_tpu_torch.ops.math import mse2psnr
from nerface_tpu_torch.ops.safe import safe_norm
from nerface_tpu_torch.render.pipeline import RenderSettings, render_rays
from nerface_tpu_torch.train.fused import background_prior, conditioning
from nerface_tpu_torch.train.state import TrainState


def compute_losses(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    seed,
    settings: RenderSettings,
    flags: FeatureFlags,
    dtype=None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
):
    """(total, metrics) of one step through the unfused render path
    (`_compute_losses`, train/step.py:35-118 of the JAX package).
    `draws` may inject t_rand, u, noise_c and noise_f."""
    draws = draws or {}
    expression, latent = conditioning(state, batch, flags)
    bg = background_prior(state, batch, flags)
    out = render_rays(
        state.model_coarse, state.model_fine,
        batch["ray_origins"], batch["ray_directions"], settings, seed=seed,
        expressions=expression, latent_code=latent, background_prior=bg, dtype=dtype,
        ray_index=batch.get("ray_index"), t_rand=draws.get("t_rand"), u=draws.get("u"),
        noise_c=draws.get("noise_c"), noise_f=draws.get("noise_f"),
    )
    target = batch["target_rgb"][..., :3]
    dev = target.device
    coarse_loss = torch.mean((out["rgb_coarse"][..., :3] - target) ** 2)
    fine_loss = None
    if out["rgb_fine"] is not None:
        fine_loss = torch.mean((out["rgb_fine"][..., :3] - target) ** 2)
    loss = coarse_loss + (fine_loss if fine_loss is not None else 0.0)

    latent_code_loss = torch.zeros((), device=dev)
    if flags.train_latent_codes and not flags.disable_latent_codes:
        latent_code_loss = safe_norm(latent) * 0.0005
    background_loss = torch.zeros((), device=dev)
    if flags.supervised_train_background and bg is not None:
        per_ray = torch.sum((bg[..., :3] - target) ** 2, dim=-1)
        background_loss = torch.mean(per_ray * out["bg_weight"]) * 0.001

    total = loss
    if flags.regularize_latent_codes:
        total = total + latent_code_loss * 10.0
    if flags.supervised_train_background:
        total = total + background_loss
    metrics = {
        "loss": loss.detach(),
        "coarse_loss": coarse_loss.detach(),
        "fine_loss": fine_loss.detach() if fine_loss is not None else torch.zeros((), device=dev),
        "psnr": mse2psnr(loss.detach()),
        "latent_code_loss": latent_code_loss.detach(),
        "background_loss": background_loss.detach(),
    }
    return total, metrics
