"""Random inputs of the kernels' checks and timings, made from a seed.

`chip_smoke.py`, the tools under `tools/perf/` and the card tests draw
their rays and He-scaled weights from here: rays through a head at the
origin seen from z = 0.5, depths in [0.2, 1.4], and weights of the
repo's models scaled by HE_GAIN.
"""

from __future__ import annotations

import torch

# Random weights are PyTorch's default init times √6, He's variance 2/fan_in:
# as in a trained field, activations keep their size through the layers
# (at the default init they fade, and the output is nearly the last bias).
HE_GAIN = 6.0 ** 0.5
D_XYZ = 63  # the encoded xyz: 3 + 2·3·10 bands
FAR = 0.8  # synth512_paper's far plane: K5's depths lie in [0.2, FAR]


def he_scale(model):
    """Every `.weight` of `model` times HE_GAIN, in place."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".weight"):
                p.mul_(HE_GAIN)
    return model


def ray_draws(n_rays, n_samples, gen):
    """ro, rd and the sorted depths z of a pass (CPU f32), drawn from `gen`
    in that order."""
    ro = torch.randn(n_rays, 3, generator=gen) * 0.05 + torch.tensor([0.0, 0.0, 0.5])
    rd = torch.randn(n_rays, 3, generator=gen) * torch.tensor([0.2, 0.2, 0.05])
    rd[:, 2] -= 1.0
    z = 0.2 + torch.cumsum(torch.rand(n_rays, n_samples, generator=gen) * (1.2 / n_samples), -1)
    return ro, rd, z


def conditioning(gen):
    """A [expression / 3; latent code] row: 76 + 32 values."""
    return torch.cat([torch.randn(76, generator=gen) * 0.5 / 3.0, torch.randn(32, generator=gen) * 0.1])


def render_inputs(n_rays, n_samples, gen, dev):
    """A render call's inputs on `dev`: ro, rd, z, dir_contrib (R, 128),
    the conditioning and a background (R, 3)."""
    ro, rd, z = ray_draws(n_rays, n_samples, gen)
    dc = torch.randn(n_rays, 128, generator=gen) * 0.3
    cond = conditioning(gen)
    bg = torch.rand(n_rays, 3, generator=gen)
    return [t.to(dev).contiguous() for t in (ro, rd, z, dc, cond, bg)]


def resample_inputs(n_rays, n_coarse, n_fine, seed, dev, spike=0.0):
    """K5's inputs: coarse depths as the pipeline draws them (stratified
    over [0.2, FAR], jittered: sorted per ray), weights in [0.1, 1) and
    general draws u (R, Sf). Every bin's pdf stays ≥ 1e-3: at a bin under
    the reference's 1e-5 clamp, or of pdf ~1e-4, the draw at a cdf knot
    moves by up to a bin with the cdf's last ulp, which no two orders of
    f32 sums share (PERF.md). A nonzero `spike` puts that mass on one bin:
    the draws crowd into it, among the coarse depths around it."""
    g = torch.Generator().manual_seed(seed)
    t = (torch.arange(n_coarse) + torch.rand(n_rays, n_coarse, generator=g)) / n_coarse
    z = 0.2 + (FAR - 0.2) * t
    w = 0.1 + 0.9 * torch.rand(n_rays, n_coarse, generator=g)
    if spike:
        w[:, min(7, n_coarse - 2)] = spike
    u = torch.rand(n_rays, n_fine, generator=g)
    return [x.to(dev).contiguous() for x in (z, w, u)]


def paper_params(seed, dev, small=False, bands=10):
    """He-scaled random weights of the paper model (or the smaller one) at
    `bands` xyz encoding bands, as a state dict of detached tensors."""
    from nerface_tpu_torch.models.nerf_models import (
        ConditionalBlendshapePaperNeRFModel,
        ConditionalBlendshapePaperSmallerNeRFModel,
    )

    cls = ConditionalBlendshapePaperSmallerNeRFModel if small else ConditionalBlendshapePaperNeRFModel
    model = cls(num_encoding_fn_xyz=bands, num_encoding_fn_dir=4, include_input_dir=False, device=dev,
                generator=torch.Generator().manual_seed(seed))
    return {k: v.detach() for k, v in he_scale(model).named_parameters()}


def paper_case(R, S, seed, dev, small=False, bands=10):
    """He-scaled random paper-family weights at `bands` xyz bands prefolded
    into K1's bundle, and a pass's rays (σ-noise, a background, a cotangent
    g)."""
    from nerface_tpu_torch.ops.kernels import fused_train as T

    params = paper_params(seed, dev, small, bands)
    g = torch.Generator().manual_seed(seed + 1)
    ro, rd, z = ray_draws(R, S, g)
    cond = conditioning(g)
    rays = dict(ro=ro, rd=rd, z=z, tgt=torch.rand(R, 3, generator=g), bg=torch.rand(R, 3, generator=g),
                noise=torch.randn(R, S, generator=g), pe_dir=torch.randn(R, 24, generator=g),
                g=torch.randn(R, S, 4, generator=g) * 1e-3)
    rays = {k: v.to(dev).contiguous() for k, v in rays.items()}
    bundle = [t.contiguous() for t in
              T.prefold_paper_params(params, cond.to(dev), rays["pe_dir"], bands, small=small)]
    return bundle, rays


def flex_params(seed, dev, n_hidden=3, hidden=256, bands=10):
    """He-scaled random weights of one synth512_lcode model (the state-dict
    params; `n_hidden` hidden layers after layer1, 3 in the config; hidden
    width 256, or 512 / 768 / 1024 as synth512_lcode_w512 / _w768 /
    _w1024 (any of `fused_flex.WIDTHS`); `bands` xyz encoding bands,
    10 in the config, 16 in synth512_lcode_pe16) and a per-frame v0 =
    layer1's bias + its conditioning columns applied to a random [expr / 3;
    latent]."""
    from nerface_tpu_torch.models.nerf_models import ConditionalBlendshapeLearnableCodeNeRFModel

    model = ConditionalBlendshapeLearnableCodeNeRFModel(
        num_layers=n_hidden + 1, hidden_size=hidden, num_encoding_fn_xyz=bands,
        # no skip layer engages (synth512_lcode's 4 at n = 3)
        skip_connect_every=max(4, n_hidden + 1),
        num_encoding_fn_dir=4, include_input_dir=False, device=dev,
        generator=torch.Generator().manual_seed(seed),
    )
    params = {k: v.detach() for k, v in he_scale(model).named_parameters()}
    cond = conditioning(torch.Generator().manual_seed(seed + 1))
    w1 = params["layer1.weight"]
    v0 = (params["layer1.bias"] + w1[:, 3 + 6 * bands:] @ cond.to(dev))[None, :].contiguous()
    return params, v0


def flex_case(R, S, seed, dev, n_hidden=3, hidden=256, bands=10):
    """`flex_params`' weights packed for K4 (`pack_flex_weights`), its v0,
    and a pass's rays, dir_contrib (R, hidden / 2) and cotangent g."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    params, v0 = flex_params(seed, dev, n_hidden, hidden, bands)
    g = torch.Generator().manual_seed(seed + 2)
    ro, rd, z = ray_draws(R, S, g)
    case = dict(ro=ro, rd=rd, z=z, dc=torch.randn(R, hidden // 2, generator=g) * 0.3,
                g=torch.randn(R, S, 4, generator=g))
    case = {k: v.to(dev).contiguous() for k, v in case.items()}
    case.update(weights=F.pack_flex_weights(params, n_hidden, bands), v0=v0, n=n_hidden, bands=bands)
    return case
