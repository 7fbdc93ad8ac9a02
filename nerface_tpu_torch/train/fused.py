"""The training losses through the one-pass fused kernel.

Port of `nerface_tpu/train/fused.py`. For the paper family
(`ConditionalBlendshapePaperNeRFModel`, or its smaller variant for both
models: K1's `small` mode) in bf16, both passes of a step are one
`FusedTrainPass` each (K1: `ops/kernels/fused_train.py`), whose
forward launches the kernel and whose backward hands the kernel's
gradients to `prefold_paper_params`, plain differentiable torch, so
`total.backward()` reaches the modules, the latent table and a trainable
background. The draws are the f32 path's (`render/pipeline.py`): the same
streams, or the same injected arrays. Loss semantics are
`train/step.py::compute_losses`'s (`train_transformed_rays.py:336-400`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nerface_tpu_torch.config.flags import FeatureFlags
from nerface_tpu_torch.models.nerf_models import HIDDEN
from nerface_tpu_torch.ops.kernels.fused_mlp import MAX_FREQS, MAX_SAMPLES, kernel_pass_ok
from nerface_tpu_torch.ops.kernels.fused_train import fused_train_loss, prefold_paper_params
from nerface_tpu_torch.ops.math import mse2psnr
from nerface_tpu_torch.ops.safe import safe_norm
from nerface_tpu_torch.ops.sampling import (
    STREAM_NOISE_COARSE,
    STREAM_NOISE_FINE,
    merge_sorted_zvals,
    per_ray_normal,
    sample_pdf,
    stratified_zvals,
)
from nerface_tpu_torch.render.pipeline import (
    RenderSettings,
    _direction_branch_input,
    _fused_variant,
)


def fused_train_eligible(
    model_coarse, model_fine, settings: RenderSettings, flags: FeatureFlags, dtype, device,
    num_rays: int,
) -> bool:
    """Whether a step can train through K1 with the f32 path's semantics:
    bf16, the same paper-family variant for both passes (the smaller one
    with the 76-dim expression), ≥ 1 fine sample, view directions, the xyz
    input included, a latent vector (the table or the zeros ablation), both
    passes' sample counts (coarse, coarse + fine) in 1..MAX_SAMPLES, and on
    the card the JAX package's rule for its Pallas kernel at `num_rays`,
    the step's rays on this rank: a ray tile for both passes
    (`kernel_pass_ok`; `nerface_tpu/train/fused.py:43-74`,
    `fused_train_available`)."""
    if dtype != torch.bfloat16:
        return False
    models = (model_coarse, model_fine)
    small = _fused_variant(model_coarse)
    if small is None or small != _fused_variant(model_fine):
        return False
    if small and any(m.dim_expression != 76 for m in models):
        return False
    if settings.num_fine <= 0 or not settings.no_ndc:
        return False
    if not settings.use_viewdirs or settings.encode_dir is None:
        return False
    enc = settings.encode_xyz
    if not enc.include_input or enc.num_encoding_functions > MAX_FREQS:
        return False
    if any(m.dim_xyz != 3 + 6 * enc.num_encoding_functions for m in models):
        return False
    if not (flags.train_latent_codes or flags.disable_latent_codes):
        return False
    s_all = settings.num_coarse + settings.num_fine
    if torch.device(device).type == "cuda":
        return kernel_pass_ok(num_rays, settings.num_coarse) and kernel_pass_ok(num_rays, s_all)
    return 1 <= settings.num_coarse and s_all <= MAX_SAMPLES


def background_prior(state, batch, flags: FeatureFlags) -> Optional[torch.Tensor]:
    """The batch's (R, 3) background pixels: gathered from the trainable
    background (differentiable), or the fixed one's."""
    if state.train_background:
        return state.background.reshape(-1, 3)[batch["pixel_indices"].long()]
    if flags.fixed_background:
        if "background_rgb" in batch:
            return batch["background_rgb"]
        if state.background is not None:
            return state.background.reshape(-1, 3)[batch["pixel_indices"].long()]
    return None


def conditioning(state, batch, flags: FeatureFlags):
    """(expression, latent): the batch's expression (zeros when disabled)
    and its frame's latent code (zeros under the disable ablation, None
    when the config uses none)."""
    expression = batch["expression"]
    if flags.disable_expressions:
        expression = torch.zeros_like(expression)
    latent = None
    if flags.train_latent_codes and not flags.disable_latent_codes:
        # index_select, not [t]: indexing by a 0-d tensor reads it back to the host
        latent = state.latent_codes.index_select(
            0, batch["latent_index"].reshape(1).long()).reshape(-1)
    elif flags.disable_latent_codes:
        latent = torch.zeros(32, device=expression.device)
    return expression, latent


def fused_losses(
    state,
    batch: Dict[str, torch.Tensor],
    seed,
    settings: RenderSettings,
    flags: FeatureFlags,
    draws: Optional[Dict[str, torch.Tensor]] = None,
):
    """(total, metrics) of one step through K1; `total.backward()` gives
    the gradients. `seed` is an int or `step_seed`'s 0-d tensor form.
    `draws` may inject t_rand, noise_c, u and noise_f."""
    draws = draws or {}
    ro = batch["ray_origins"].reshape(-1, 3).contiguous()
    rd = batch["ray_directions"].reshape(-1, 3).contiguous()
    target = batch["target_rgb"][..., :3].contiguous()
    num_rays = ro.shape[0]
    dev = ro.device
    ray_index = batch.get("ray_index")
    if ray_index is None:
        ray_index = torch.arange(num_rays, device=dev)
    expression, latent = conditioning(state, batch, flags)
    train_latent = flags.train_latent_codes and not flags.disable_latent_codes
    bg = background_prior(state, batch, flags)
    if bg is not None:
        bg = bg.contiguous()
    sup_bg = bool(flags.supervised_train_background) and bg is not None

    near = torch.full((num_rays, 1), settings.near, device=dev)
    far = torch.full((num_rays, 1), settings.far, device=dev)
    z_vals = stratified_zvals(
        near, far, settings.num_coarse, lindisp=settings.lindisp, perturb=settings.perturb,
        t_rand=draws.get("t_rand"), seed=seed, ray_index=ray_index,
    )
    pe_dir = settings.encode_dir(_direction_branch_input(rd, near, far))
    L = settings.encode_xyz.num_encoding_functions
    std = float(settings.radiance_field_noise_std)
    noise_c = noise_f = None
    if std > 0.0:
        noise_c = draws.get("noise_c")
        if noise_c is None:
            noise_c = per_ray_normal(seed, STREAM_NOISE_COARSE, ray_index, settings.num_coarse)
        noise_c = noise_c.contiguous()

    cond = torch.cat([expression * (1.0 / 3.0), latent])
    small = bool(_fused_variant(state.model_coarse))
    # the smaller model: the expression block of layers_dir.0 starts after
    # the declared dir width
    dir_off = (HIDDEN + state.model_coarse.dim_dir) if small else 0
    bundles = [
        prefold_paper_params(dict(m.named_parameters()), cond, pe_dir, L, small=small,
                             dir_expr_offset=dir_off)
        for m in (state.model_coarse, state.model_fine)
    ]
    common = dict(
        background=bg, noise_std=std, white_background=settings.white_background,
        loss_scale=2.0 / (3.0 * num_rays), train_bg=state.train_background,
        num_encoding_fn_xyz=L, log_sampling_xyz=settings.encode_xyz.log_sampling, small=small,
    )
    coarse_loss, _, w_c, _, _ = fused_train_loss(
        bundles[0], ro, rd, z_vals, target, noise=noise_c, sup_bg_scale=0.0, **common
    )

    # hierarchical resample (no gradient), the f32 path's draws
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(
        z_mid, w_c[..., 1:-1], settings.num_fine, det=not settings.perturb,
        u=draws.get("u"), seed=seed, ray_index=ray_index,
    )
    z_all = merge_sorted_zvals(z_vals, z_samples).contiguous()
    if std > 0.0:
        noise_f = draws.get("noise_f")
        if noise_f is None:
            noise_f = per_ray_normal(seed, STREAM_NOISE_FINE, ray_index, z_all.shape[-1])
        noise_f = noise_f.contiguous()
    fine_total, _, _, fine_loss, background_loss = fused_train_loss(
        bundles[1], ro, rd, z_all, target, noise=noise_f,
        sup_bg_scale=(0.001 / num_rays) if sup_bg else 0.0, **common
    )

    total = coarse_loss + fine_total
    latent_code_loss = torch.zeros((), device=dev)
    if train_latent:
        latent_code_loss = safe_norm(latent) * 0.0005
        if flags.regularize_latent_codes:
            total = total + latent_code_loss * 10.0
    loss = coarse_loss.detach() + fine_loss
    metrics = {
        "loss": loss,
        "coarse_loss": coarse_loss.detach(),
        "fine_loss": fine_loss,
        "psnr": mse2psnr(loss),
        "latent_code_loss": latent_code_loss.detach(),
        "background_loss": background_loss,
    }
    return total, metrics
