"""The rendering pipeline: coarse pass → hierarchical resample → fine pass
→ composite.

Port of `nerface_tpu/render/pipeline.py` (reference `train_utils.py`
`run_network` :9-33, `predict_and_render_radiance` :36-162). Kept
reference semantics (SURVEY.md §2.4):

* the direction-branch input is columns [-3:] of the reference's 8-float
  ray record, **[rd_z, near, far]** (`train_utils.py:14`), not the
  normalized view direction;
* the background overwrites the last sample's radiance before compositing;
* hierarchical sampling uses coarse weights[..., 1:-1] over z-midpoints,
  det when perturb is off, detached, merged and sorted with the coarse
  depths;
* `bg_weight` is the last pass's background-sample weight per ray;
* `ray_directions_ablation` feeds the direction branch per ray.

Path choice, in bf16 (`dtype=torch.bfloat16`), for the paper family
(`ConditionalBlendshapePaperNeRFModel` and its smaller variant):

* with `settings.fused_render` (set by `eval/renderer.py::
  render_full_frame` only: eval is never differentiated) and σ-noise 0,
  each pass is one `fused_paper_render` call (K2: MLP + compositing,
  forward only) over the model's weights packed once (`_kernel_weights`);
* otherwise each pass's MLP is one `fused_paper_mlp` call (K3f; its
  backward is K3b) over the differentiable `prefold_paper_params` bundle,
  composited by `volume_render_radiance_field` with the σ-noise, as the
  JAX package composites it with XLA (`pipeline.py:240-267`). Both take
  any sample count in 1..MAX_SAMPLES (1024); on the card a pass goes to
  them where the JAX package's tile rule sends it to Pallas
  (`_paper_kernels_take`: the ray count a multiple of 8), else it runs the
  model's plain forward.

For an eligible Flexible-family model in bf16, each pass's MLP is one
`fused_flex_mlp` call (K4f; its backward is K4b), with the conditioning
folded into `v0` and the direction contribution in differentiable torch;
`flex_fused_eligible` takes the same 1..MAX_SAMPLES and tile rule.
Otherwise the model runs as PyTorch ops; in f32 this is the path held to
the JAX package's f32 XLA path.

Draws: `t_rand` (R, num_coarse), `u` (R, num_fine) and the σ-noise normals
`noise_c` (R, num_coarse) and `noise_f` (R, num_coarse + num_fine) may be
injected; otherwise they come from the port's per-ray hash of (seed,
ray_index), one stream per kind of draw, as the JAX package splits its key
four ways. The unfused path is plain differentiable torch: the f32
training path takes its gradients by autograd through it.

`render_rays` refuses NDC rays, as the JAX package's does: the stock LLFF
configs project upstream, in `run_one_iter_of_nerf` (the reference's
7-tuple wrapper) or in `eval/renderer.py::render_full_frame`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from nerface_tpu_torch.models.mlp import cond_contribution, linear_cols
from nerface_tpu_torch.models.nerf_models import (
    HIDDEN,
    ConditionalBlendshapePaperNeRFModel,
    ConditionalBlendshapePaperSmallerNeRFModel,
)
from nerface_tpu_torch.ops.compositing import inject_background, volume_render_radiance_field
from nerface_tpu_torch.ops.encoding import positional_encoding
from nerface_tpu_torch.ops.kernels.fused_flex import flex_fused_eligible, fused_flex_mlp
from nerface_tpu_torch.ops.kernels.fused_mlp import (
    MAX_FREQS,
    MAX_SAMPLES,
    fused_paper_mlp,
    fused_paper_render,
    kernel_pass_ok,
    pack_paper_weights,
)
from nerface_tpu_torch.ops.kernels.fused_train import prefold_paper_params
from nerface_tpu_torch.ops.rays import ndc_rays
from nerface_tpu_torch.ops.sampling import (
    STREAM_NOISE_COARSE,
    STREAM_NOISE_FINE,
    merge_sorted_zvals,
    per_ray_normal,
    sample_pdf,
    stratified_zvals,
)


@dataclasses.dataclass(frozen=True)
class EncodeSpec:
    num_encoding_functions: int
    include_input: bool
    log_sampling: bool

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return positional_encoding(
            x,
            num_encoding_functions=self.num_encoding_functions,
            include_input=self.include_input,
            log_sampling=self.log_sampling,
        )


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Render configuration: `getattr(cfg.nerf, mode)` plus the dataset's
    near/far bounds. `fused_render` lets a paper-family pass take the
    forward-only K2; only the full-frame renderer sets it.

    Fast eval (`eval/renderer.py`): only the rays inside the frame's head
    bbox, or touching an occupied voxel of an occupancy grid
    (`eval/occupancy.py`), run the radiance field; `fast_eval_capacity` is
    the fraction of H·W rays rendered. The occupancy fields keep the JAX
    package's meaning and defaults (`nerface_tpu/render/pipeline.py:91-125`):
    the render-time mask ("splat" or "probe"), the grid's side, the probes a
    ray, the dilation steps (0 for splat, 1 for probe), the probe block (0:
    from the conservativeness bound) and the capacity's headroom over the
    measured active fraction."""

    num_coarse: int = 64
    num_fine: int = 64
    perturb: bool = True
    radiance_field_noise_std: float = 0.0
    white_background: bool = False
    lindisp: bool = False
    use_viewdirs: bool = True
    near: float = 0.2
    far: float = 0.8
    no_ndc: bool = True
    encode_xyz: EncodeSpec = EncodeSpec(10, True, True)
    encode_dir: Optional[EncodeSpec] = EncodeSpec(4, False, True)
    chunksize: int = 65536
    fast_eval: bool = False
    fused_render: bool = False
    fast_eval_capacity: float = 0.6
    occupancy: bool = False
    occupancy_mask: str = "splat"
    occupancy_resolution: int = 128
    occupancy_probes: int = 128
    occupancy_dilate: int = 0
    occupancy_block: int = 0
    occupancy_margin: float = 1.05

    @classmethod
    def from_cfg(cls, cfg, mode: str = "train") -> "RenderSettings":
        node = getattr(cfg.nerf, mode)
        encode_dir = None
        if cfg.models.coarse.use_viewdirs:
            encode_dir = EncodeSpec(
                cfg.models.coarse.num_encoding_fn_dir,
                cfg.models.coarse.include_input_dir,
                cfg.models.coarse.log_sampling_dir,
            )
        mask = str(node.get("occupancy_mask", "splat"))
        return cls(
            num_coarse=node.num_coarse,
            num_fine=node.num_fine,
            perturb=bool(node.perturb),
            radiance_field_noise_std=float(node.radiance_field_noise_std),
            white_background=bool(node.white_background),
            lindisp=bool(node.lindisp),
            use_viewdirs=bool(cfg.nerf.use_viewdirs),
            near=float(cfg.dataset.near),
            far=float(cfg.dataset.far),
            no_ndc=bool(cfg.dataset.no_ndc),
            encode_xyz=EncodeSpec(
                cfg.models.coarse.num_encoding_fn_xyz,
                cfg.models.coarse.include_input_xyz,
                cfg.models.coarse.log_sampling_xyz,
            ),
            encode_dir=encode_dir,
            chunksize=int(node.chunksize),
            fast_eval=bool(node.get("fast_eval", False)),
            fast_eval_capacity=float(node.get("fast_eval_capacity", 0.6)),
            occupancy=bool(node.get("occupancy", False)),
            occupancy_mask=mask,
            occupancy_resolution=int(node.get("occupancy_resolution", 128)),
            occupancy_probes=int(node.get("occupancy_probes", 128)),
            occupancy_dilate=int(node.get("occupancy_dilate", 0 if mask == "splat" else 1)),
            occupancy_block=int(node.get("occupancy_block", 0)),
            occupancy_margin=float(node.get("occupancy_margin", 1.05)),
        )


def _fused_variant(model) -> Optional[bool]:
    """None for a model no paper-family kernel takes; else the kernels'
    `small` flag (True: the smaller paper model)."""
    if isinstance(model, ConditionalBlendshapePaperSmallerNeRFModel):
        return True
    if isinstance(model, ConditionalBlendshapePaperNeRFModel):
        return False
    return None


def _fused_model_ok(model, encode_xyz: EncodeSpec, pe_dir, expr, latent) -> bool:
    """The paper-family kernels' checks on the model and the per-frame
    inputs (`nerface_tpu/render/pipeline.py:187-206`), plus the kernels'
    band limit."""
    small = _fused_variant(model)
    if small is None:
        return False
    if pe_dir is None or expr is None or latent is None:
        return False
    if expr.ndim != 1 or latent.ndim != 1:
        return False
    if not encode_xyz.include_input or model.dim_xyz != 3 + 6 * encode_xyz.num_encoding_functions:
        return False
    if encode_xyz.num_encoding_functions > MAX_FREQS:
        return False
    # forward() slices the first pe_dir-width dir columns; so does the fold
    if model.dim_dir < pe_dir.shape[-1]:
        return False
    return not small or model.dim_expression == 76


def _paper_kernels_take(n_rays: int, n_samples: int, device) -> bool:
    """Whether a paper-family pass goes to K2 / K3: on the card the JAX
    package's rule for its Pallas kernels (`kernel_pass_ok`: the tile
    picker finds a tile) within the kernels' 1..MAX_SAMPLES; on the CPU,
    where the kernels' plain versions run, any ray count in that domain."""
    if torch.device(device).type == "cuda":
        return kernel_pass_ok(n_rays, n_samples)
    return 1 <= n_samples <= MAX_SAMPLES


def _fused_render_eligible(model, n_rays, n_samples, pe_dir, expr, latent, settings, dtype,
                           device) -> bool:
    """Whether a pass can be one `fused_paper_render` call: only where the
    caller set `settings.fused_render` (K2 has no backward), at σ-noise 0
    and where the kernels take the pass (`nerface_tpu/render/pipeline.py:
    328-345`)."""
    if dtype != torch.bfloat16 or not settings.fused_render:
        return False
    if settings.radiance_field_noise_std > 0.0:
        return False
    return _paper_kernels_take(n_rays, n_samples, device) and _fused_model_ok(
        model, settings.encode_xyz, pe_dir, expr, latent
    )


def _fused_conditioning(model, pe_dir, expr, latent):
    """(cond, dir_contrib, small) for a K2 call: cond = [expr/3; latent],
    the per-ray direction-branch contribution pe_dir @ W_dir0[:, 256:].T
    and, for the smaller model, its expression columns' (starting at the
    declared dir width) folded in."""
    small = bool(_fused_variant(model))
    cond = torch.cat([expr * (1.0 / 3.0), latent])
    dd = pe_dir.shape[-1]
    dir_contrib = linear_cols(model.layers_dir[0], pe_dir, HIDDEN, HIDDEN + dd)
    if small:
        dir_contrib = dir_contrib + cond_contribution(
            model.layers_dir[0], [(expr * (1.0 / 3.0), model.dim_expression)],
            HIDDEN + model.dim_dir,
        )
    return cond, dir_contrib, small


def _kernel_weights(model, encode_xyz: EncodeSpec):
    """The model's weights packed for the kernel, kept on the model and
    packed again only when a parameter is replaced or updated in place (a
    CUDA-graph replay bumps no version: train/window.py bumps them after
    its replays)."""
    key = (encode_xyz.num_encoding_functions, encode_xyz.log_sampling) + tuple(
        (p.data_ptr(), p._version) for p in model.parameters()
    )
    cached = getattr(model, "_kernel_weights_cache", None)
    if cached is None or cached[0] != key:
        packed = pack_paper_weights(
            model.state_dict(), encode_xyz.num_encoding_functions, encode_xyz.log_sampling
        )
        cached = model._kernel_weights_cache = (key, packed)
    return cached[1]


def _fused_pass(model, ro, rd, z_vals, pe_dir, expr, latent, background, settings, out_weights):
    cond, dir_contrib, small = _fused_conditioning(model, pe_dir, expr, latent)
    return fused_paper_render(
        _kernel_weights(model, settings.encode_xyz), ro, rd, z_vals, dir_contrib, cond,
        background=background,
        white_background=settings.white_background,
        num_encoding_fn_xyz=settings.encode_xyz.num_encoding_functions,
        log_sampling_xyz=settings.encode_xyz.log_sampling,
        out_weights=out_weights,
        small=small,
    )


def _paper_pass(model, ro, rd, z_vals, encode_xyz, pe_dir, expr, latent):
    """One `fused_paper_mlp` call (K3) for a paper-family model
    (`nerface_tpu/render/pipeline.py:256-267`) over the differentiable
    `prefold_paper_params` bundle of its parameters."""
    small = bool(_fused_variant(model))
    L = encode_xyz.num_encoding_functions
    bundle = prefold_paper_params(
        dict(model.named_parameters()), torch.cat([expr * (1.0 / 3.0), latent]), pe_dir, L,
        small=small, dir_expr_offset=(HIDDEN + model.dim_dir) if small else 0,
    )
    return fused_paper_mlp(
        [t.contiguous() for t in bundle], ro.contiguous(), rd.contiguous(), z_vals.contiguous(),
        num_encoding_fn_xyz=L, log_sampling_xyz=encode_xyz.log_sampling, small=small,
    )


def _flex_pass(model, ro, rd, z_vals, encode_xyz, pe_dir, expr, latent):
    """One `fused_flex_mlp` call for a Flexible-family model
    (`nerface_tpu/render/pipeline.py:268-317`): v0 = layer1's bias + its
    conditioning columns applied to the prepared (expr, latent), and the
    per-ray direction contribution, both differentiable f32 torch. The
    model's width h (256 or 512) goes to the kernels as their shapes: v0
    (1, h), dir_contrib (R, h / 2)."""
    e, l = model._prepare(
        expr if model.takes_expression else None, latent if model.takes_latent else None, None
    )
    h = model.hidden_size
    v0 = model.layer1.bias
    segs = model._cond_segments_layer1(e, l)
    if segs:
        v0 = v0 + cond_contribution(model.layer1, segs, model.dim_xyz)
    dd = pe_dir.shape[-1]
    dir_contrib = linear_cols(model.layers_dir[0], pe_dir, h, h + dd)
    return fused_flex_mlp(
        dict(model.named_parameters()), ro.contiguous(), rd.contiguous(), z_vals.contiguous(),
        dir_contrib.contiguous(), v0[None, :].contiguous(), n_hidden=model.num_layers - 1,
        num_encoding_fn_xyz=encode_xyz.num_encoding_functions,
        log_sampling_xyz=encode_xyz.log_sampling,
    )


def _apply_model(model, ro, rd, z_vals, encode_xyz, pe_dir, expr, latent, dtype):
    """Evaluate the radiance field at the samples: in bf16 with 2-D rays
    and per-frame conditioning, one K3 call for a paper-family model (where
    the kernels take the pass, `_paper_kernels_take`) or one K4 call for an
    eligible Flexible-family model (`flex_fused_eligible`: hidden width 256
    or 512 at any depth, on the card the same ray-count rule); else
    positional-encode the points and run the model."""
    if (
        dtype == torch.bfloat16
        and ro.ndim == 2
        and z_vals.ndim == 2
        and pe_dir is not None
        and pe_dir.ndim == 2
        and _fused_model_ok(model, encode_xyz, pe_dir, expr, latent)
        and _paper_kernels_take(z_vals.shape[0], z_vals.shape[-1], ro.device)
    ):
        return _paper_pass(model, ro, rd, z_vals, encode_xyz, pe_dir, expr, latent)
    if (
        dtype == torch.bfloat16
        and ro.ndim == 2
        and z_vals.ndim == 2
        and pe_dir is not None
        and pe_dir.ndim == 2
        and (expr is None or expr.ndim == 1)
        and (latent is None or latent.ndim == 1)
        and (not model.takes_expression or expr is not None)
        and (not model.takes_latent or latent is not None)
        and flex_fused_eligible(model, encode_xyz, pe_dir, z_vals.shape[0], z_vals.shape[-1],
                                ro.device)
    ):
        return _flex_pass(model, ro, rd, z_vals, encode_xyz, pe_dir, expr, latent)
    pts = ro[..., None, :] + rd[..., None, :] * z_vals[..., :, None]
    return model(
        encode_xyz(pts), pe_dir,
        expr if model.takes_expression else None,
        latent if model.takes_latent else None,
        dtype=dtype,
    )


def _direction_branch_input(rd: torch.Tensor, near: torch.Tensor, far: torch.Tensor):
    """The reference's de-facto view-direction input: columns [-3:] of the
    8-float ray record = [rd_z, near, far] (`train_utils.py:14`)."""
    shape = rd.shape[:-1]
    return torch.stack(
        [rd[..., 2], near[..., 0].expand(shape), far[..., 0].expand(shape)], dim=-1
    )


def render_rays(
    model_coarse,
    model_fine,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    settings: RenderSettings,
    seed=0,
    expressions: Optional[torch.Tensor] = None,
    latent_code: Optional[torch.Tensor] = None,
    background_prior: Optional[torch.Tensor] = None,
    ray_directions_ablation: Optional[torch.Tensor] = None,
    dtype=None,
    ray_index: Optional[torch.Tensor] = None,
    t_rand: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
    noise_c: Optional[torch.Tensor] = None,
    noise_f: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """Render a batch of rays (R, 3). Returns coarse/fine rgb/disp/acc/depth
    maps, the per-sample weights of the last unfused pass (None after a
    fused fine pass), and the background-sample weight per ray.

    `ray_index` (global ray indices, default arange(R)) keys the port's
    own draws, so any tiling of a frame draws the same numbers."""
    if not settings.no_ndc:
        raise NotImplementedError(
            "NDC ray path is only used by the stock LLFF configs; "
            "use ops.rays.ndc_rays upstream."
        )
    ro = ray_origins.reshape(-1, 3)
    rd = ray_directions.reshape(-1, 3)
    num_rays = ro.shape[0]
    if ray_index is None:
        ray_index = torch.arange(num_rays, device=ro.device)
    near = torch.full((num_rays, 1), settings.near, dtype=ro.dtype, device=ro.device)
    far = torch.full((num_rays, 1), settings.far, dtype=ro.dtype, device=ro.device)
    std = float(settings.radiance_field_noise_std)
    if std > 0.0 and noise_c is None:
        noise_c = per_ray_normal(seed, STREAM_NOISE_COARSE, ray_index, settings.num_coarse)

    # ---- coarse pass -------------------------------------------------------
    z_vals = stratified_zvals(
        near, far, settings.num_coarse, lindisp=settings.lindisp,
        perturb=settings.perturb, t_rand=t_rand, seed=seed, ray_index=ray_index,
    )
    pe_dir = None
    if settings.use_viewdirs and settings.encode_dir is not None:
        dir_src = rd if ray_directions_ablation is None else ray_directions_ablation.reshape(-1, 3)
        pe_dir = settings.encode_dir(_direction_branch_input(dir_src, near, far))

    if _fused_render_eligible(
        model_coarse, ro.shape[0], settings.num_coarse, pe_dir, expressions, latent_code,
        settings, dtype, ro.device,
    ):
        fc = _fused_pass(
            model_coarse, ro, rd, z_vals, pe_dir, expressions, latent_code,
            background_prior, settings, out_weights=True,
        )
        rgb_coarse, disp_coarse, acc_coarse = fc["rgb"], fc["disp"], fc["acc"]
        weights, depth_coarse = fc["weights"], fc["depth"]
    else:
        radiance = _apply_model(
            model_coarse, ro, rd, z_vals, settings.encode_xyz, pe_dir,
            expressions, latent_code, dtype,
        )
        radiance = inject_background(radiance, background_prior)
        rgb_coarse, disp_coarse, acc_coarse, weights, depth_coarse = (
            volume_render_radiance_field(
                radiance, z_vals, rd,
                radiance_field_noise_std=std,
                white_background=settings.white_background,
                background_prior=background_prior,
                noise=noise_c,
                return_depth=True,
            )
        )

    out: Dict[str, Any] = {
        "rgb_coarse": rgb_coarse,
        "disp_coarse": disp_coarse,
        "acc_coarse": acc_coarse,
        "depth_coarse": depth_coarse,
        "rgb_fine": None,
        "disp_fine": None,
        "acc_fine": None,
        "depth_fine": None,
    }

    if settings.num_fine > 0:
        if model_fine is None:
            raise ValueError("num_fine > 0 requires a fine model")
        # ---- hierarchical resample ----------------------------------------
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(
            z_mid, weights[..., 1:-1], settings.num_fine,
            det=(not settings.perturb), u=u, seed=seed, ray_index=ray_index,
        )
        z_all = merge_sorted_zvals(z_vals, z_samples)
        if _fused_render_eligible(
            model_fine, ro.shape[0], z_all.shape[-1], pe_dir, expressions, latent_code,
            settings, dtype, ro.device,
        ):
            fr = _fused_pass(
                model_fine, ro, rd, z_all, pe_dir, expressions, latent_code,
                background_prior, settings, out_weights=False,
            )
            out.update(
                rgb_fine=fr["rgb"], disp_fine=fr["disp"],
                acc_fine=fr["acc"], depth_fine=fr["depth"],
            )
            out["weights"] = None
            out["bg_weight"] = fr["bg_weight"]
            return out

        radiance = _apply_model(
            model_fine, ro, rd, z_all, settings.encode_xyz, pe_dir,
            expressions, latent_code, dtype,
        )
        radiance = inject_background(radiance, background_prior)
        if std > 0.0 and noise_f is None:
            noise_f = per_ray_normal(seed, STREAM_NOISE_FINE, ray_index, z_all.shape[-1])
        rgb_fine, disp_fine, acc_fine, weights, depth_fine = volume_render_radiance_field(
            radiance, z_all, rd,
            radiance_field_noise_std=std,
            white_background=settings.white_background,
            background_prior=background_prior,
            noise=noise_f,
            return_depth=True,
        )
        out.update(
            rgb_fine=rgb_fine, disp_fine=disp_fine, acc_fine=acc_fine,
            depth_fine=depth_fine,
        )

    out["weights"] = weights
    out["bg_weight"] = weights[..., -1]
    return out


def run_one_iter_of_nerf(
    height: int,
    width: int,
    model_coarse,
    model_fine,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    settings: RenderSettings,
    seed=0,
    expressions: Optional[torch.Tensor] = None,
    background_prior: Optional[torch.Tensor] = None,
    latent_code: Optional[torch.Tensor] = None,
    ray_directions_ablation: Optional[torch.Tensor] = None,
    mode: str = "train",
    dtype=None,
    focal=None,
) -> Tuple:
    """The reference's 7-tuple (rgb_coarse, disp_coarse, acc_coarse,
    rgb_fine, disp_fine, acc_fine, bg_weight), image-shaped in validation
    mode (`train_utils.py:270-290`; the JAX package's
    `render/pipeline.py::run_one_iter_of_nerf`).

    Ray tensors may be (H, W, 3) or flat (R, 3). With `settings.no_ndc`
    false (LLFF) the rays are projected to NDC and near / far become 0 / 1
    (`train_utils.py:198-207`); `focal` (a scalar or [fx, fy]) is required
    then."""
    img_shape = ray_directions.shape[:-1]
    if not settings.no_ndc:
        if focal is None:
            raise ValueError("NDC rendering requires `focal`")
        ray_origins, ray_directions = ndc_rays(
            height, width, focal, 1.0, ray_origins.reshape(-1, 3), ray_directions.reshape(-1, 3)
        )
        settings = dataclasses.replace(settings, no_ndc=True, near=0.0, far=1.0)
    out = render_rays(
        model_coarse, model_fine,
        ray_origins.reshape(-1, 3), ray_directions.reshape(-1, 3), settings, seed=seed,
        expressions=expressions, latent_code=latent_code,
        background_prior=(
            background_prior.reshape(-1, 3) if background_prior is not None else None
        ),
        ray_directions_ablation=(
            ray_directions_ablation.reshape(-1, 3)
            if ray_directions_ablation is not None else None
        ),
        dtype=dtype,
    )
    results = [
        out["rgb_coarse"], out["disp_coarse"], out["acc_coarse"],
        out["rgb_fine"], out["disp_fine"], out["acc_fine"], out["bg_weight"],
    ]
    if mode == "validation":
        shapes = [img_shape + (3,), img_shape, img_shape] * 2 + [img_shape]
        results = [r.reshape(s) if r is not None else None for r, s in zip(results, shapes)]
    return tuple(results)
