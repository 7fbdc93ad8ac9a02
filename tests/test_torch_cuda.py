"""PyTorch port, the hand-written CUDA kernels on the card: `fused_paper_render`
(K2), `fused_train_pass` (K1), `fused_paper_mlp_forward` /
`fused_paper_mlp_backward` (K3f / K3b), each for the paper model and in its
`small` mode for the smaller one, `fused_flex_forward` /
`fused_flex_backward` (K4f / K4b) and `fused_resample` (K5) against their
plain PyTorch versions (bf16 operands for the MLP kernels) on the same CUDA
tensors. The training loop's execution window (train/window.py): a
windowed run of each kernel family against the same run one step at a
time, bit for bit, and a render after a window.

Every test here is marked `cuda` and skips on a host with no card. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances are those of `chip_smoke.py`: rgb, acc, bg_weight and weights
atol 2e-3 (the f32 sums run in another order, which can flip a bf16
rounding of an activation), depth atol 2e-3·far, disp rtol 1e-2.
"""

import pytest
import torch

from chip_smoke import (
    FLEX_OUT_TOL,
    FLEX_TC_DEPTH,
    K3_OUT_TOL,
    RESAMPLE_SPIKE,
    RESAMPLE_TOL,
    SIGMA_BIAS,
    _bundle_names,
    _k1_params,
    flex_grad_limits,
    flex_limit,
    k1_grad_limits,
    rel_err,
    tensor_core_plain,
)
from nerface_tpu_torch.models.nerf_models import (
    ConditionalBlendshapePaperNeRFModel,
    ConditionalBlendshapePaperSmallerNeRFModel,
)
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.tools.perf.cases import HE_GAIN, flex_params, ray_draws, resample_inputs

torch.set_num_threads(1)

FAR = 0.8


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 GEMMs
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(cuda_device):
    m = ConditionalBlendshapePaperNeRFModel(
        num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False,
        device=cuda_device, generator=torch.Generator().manual_seed(0),
    )
    return m.state_dict()


def _inputs(n_rays, n_samples, dev, seed):
    """Rays through a head at the origin; rays 0-1 with rd = 0 (acc = 0)
    and 2-3 with |rd| = 1e-9 (acc ~ 1e-5)."""
    g = torch.Generator().manual_seed(seed)
    ro, rd, z = ray_draws(n_rays, n_samples, g)
    rd[0:2] = 0.0
    rd[2:4] = 1e-9
    dc = torch.randn(n_rays, 128, generator=g) * 0.3
    cond = torch.randn(108, generator=g) * 0.2
    bg = torch.rand(n_rays, 3, generator=g)
    return [t.to(dev).contiguous() for t in (ro, rd, z, dc, cond, bg)]


def _assert_close(got, ref):
    for k, v in got.items():
        assert torch.isfinite(v).all(), k
    for k in ("rgb", "acc", "bg_weight", "weights"):
        if k in ref:
            torch.testing.assert_close(got[k], ref[k], atol=2e-3, rtol=0, msg=k)
    torch.testing.assert_close(got["depth"], ref["depth"], atol=2e-3 * FAR, rtol=0)
    torch.testing.assert_close(got["disp"], ref["disp"], atol=0, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_rays,S,with_bg,white",
    [(512, 64, True, False), (512, 128, True, False), (301, 64, False, True),
     (77, 128, True, False), (1000, 32, False, False)],
    ids=["coarse", "fine", "ragged-white", "ragged-fine", "s32"],
)
def test_kernel_matches_plain(cuda_device, params, n_rays, S, with_bg, white):
    """Rows past the last ray of a ragged last tile are masked (301·64 and
    77·128 are not multiples of the 128-row tile)."""
    ro, rd, z, dc, cond, bg = _inputs(n_rays, S, cuda_device, seed=S + n_rays)
    kw = dict(background=bg if with_bg else None, white_background=white, out_weights=True)
    before = K.fused_paper_render.launches
    got = K.fused_paper_render(params, ro, rd, z, dc, cond, **kw)
    torch.cuda.synchronize()
    assert K.fused_paper_render.launches == before + 1
    ref = K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw)
    assert set(got) == set(ref) and got["weights"].shape == (n_rays, S)
    assert float(got["acc"][:2].abs().max()) == 0.0
    _assert_close(got, ref)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device, params):
    ro, rd, z, dc, cond, bg = _inputs(64, 64, cuda_device, seed=1)
    before = K.fused_paper_render.launches
    with pytest.raises(ValueError, match="samples per ray"):
        K.fused_paper_render(params, ro, rd, z[:, :16].contiguous(), dc, cond)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_paper_render(params, ro, rd, z.t().contiguous().t(), dc, cond)
    with pytest.raises(TypeError, match="float32"):
        K.fused_paper_render(params, ro.double(), rd, z, dc, cond)
    with pytest.raises(ValueError, match="ray_directions is on"):
        K.fused_paper_render(params, ro, rd.cpu(), z, dc, cond)
    assert K.fused_paper_render.launches == before


@pytest.mark.cuda
def test_packed_weights_give_the_same_result(cuda_device, params):
    """The serving path's once-packed weights (conditioning folded per
    call) launch the same kernel on the same bytes as a state dict."""
    ro, rd, z, dc, cond, bg = _inputs(300, 64, cuda_device, seed=3)
    kw = dict(background=bg, out_weights=True)
    a = K.fused_paper_render(params, ro, rd, z, dc, cond, **kw)
    b = K.fused_paper_render(K.pack_paper_weights(params), ro, rd, z, dc, cond, **kw)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize(
    "n_rays,S",
    [(0, 64), (1, 64), (5, 128), (3, 32), (333, 128), (2049, 64)],
    ids=["none", "one", "fewer-than-clusters", "one-tile", "odd-tiles", "ragged"],
)
def test_kernel_edges_bit_identical(cuda_device, small, n_rays, S):
    """The persistent 2-CTA cluster grid at its edges: no ray, one ray,
    fewer tile pairs than co-resident clusters, an odd tile count (a
    cluster's second CTA has no tile) and a ragged last tile; each against
    the plain version and bit-identical over 2 launches."""
    m = (ConditionalBlendshapePaperSmallerNeRFModel if small else ConditionalBlendshapePaperNeRFModel)(
        num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False,
        device=cuda_device, generator=torch.Generator().manual_seed(11),
    )
    params = m.state_dict()
    # rays 4.. of _inputs all cross the head
    ro, rd, z, dc, cond, bg = _inputs(n_rays + 4, S, cuda_device, seed=n_rays + S)
    ro, rd, z, dc, bg = (t[4:].contiguous() for t in (ro, rd, z, dc, bg))
    kw = dict(background=bg, out_weights=True, small=small)
    packed = K.pack_paper_weights(params)
    a = K.fused_paper_render(packed, ro, rd, z, dc, cond, **kw)
    b = K.fused_paper_render(packed, ro, rd, z, dc, cond, **kw)
    torch.cuda.synchronize()
    assert a["weights"].shape == (n_rays, S)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    if n_rays:
        _assert_close(a, K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw))


# -- the design probes P1 / P2 (csrc/probes.cu) ------------------------------


# 65536 rows take a persistent CTA through several passes of its loop
# (132 CTAs take at most 256 rows each a pass)
PROBE_ROWS = [2048, 65536]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", PROBE_ROWS)
@pytest.mark.parametrize("variant", ["single", "twochain_1wg", "twochain", "twochain_pingpong",
                                     "fourchain", "bwd_mix", "bias_sums"])
def test_chain_probe_matches_plain(cuda_device, variant, rows):
    from nerface_tpu_torch.tools.perf import chain_overlap_probe as P2

    g = torch.Generator().manual_seed(0)
    x = (torch.randn(rows, 256, generator=g) * 0.05).to(cuda_device)
    w = (torch.randn(256, 256, generator=g) * 0.06).to(torch.bfloat16).to(cuda_device)
    before = P2.chain_overlap.launches
    got = P2.chain_overlap(x, w, variant)
    ref = P2.chain_reference(x, w, variant)
    torch.cuda.synchronize()
    assert P2.chain_overlap.launches == before + 1
    assert torch.isfinite(got).all()
    max_tol, norm_tol = P2.tolerance(variant)
    assert float((got - ref).abs().max()) <= max_tol * float(ref.abs().max())
    assert float((got - ref).norm()) <= norm_tol * float(ref.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", PROBE_ROWS)
def test_bwd_mix_probe_dw_matches_plain(cuda_device, rows):
    """bwd_mix's aᵀ·gy product (MN-major operands from shared memory) on
    the last 64 rows, which a CTA reaches on a later pass at 65536 rows."""
    from nerface_tpu_torch.tools.perf import chain_overlap_probe as P2

    g = torch.Generator().manual_seed(2)
    x = (torch.randn(rows, 256, generator=g) * 0.05).to(cuda_device)
    w = (torch.randn(256, 256, generator=g) * 0.06).to(torch.bfloat16).to(cuda_device)
    dw = torch.full((256, 256), float("nan"), device=cuda_device)
    P2.chain_overlap(x, w, "bwd_mix", dw=dw)
    ref = P2.bwd_mix_dw_reference(x, w)
    torch.cuda.synchronize()
    assert torch.isfinite(dw).all()
    assert float((dw - ref).abs().max()) <= P2.TOL[0] * float(ref.abs().max())
    assert float((dw - ref).norm()) <= P2.TOL[1] * float(ref.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", PROBE_ROWS)
@pytest.mark.parametrize("variant", ["split", "packed"])
def test_encoder_probe_matches_plain(cuda_device, variant, rows):
    from nerface_tpu_torch.tools.perf import encoder_concat_probe as P1

    g = torch.Generator().manual_seed(1)
    x3, enc = torch.randn(rows, 3, generator=g), torch.randn(rows, 60, generator=g)
    wa = torch.randn(3, 256, generator=g).to(torch.bfloat16)
    wb = torch.randn(60, 256, generator=g).to(torch.bfloat16)
    x3, enc, wa, wb = (t.to(cuda_device) for t in (x3, enc, wa, wb))
    got = P1.encoder_concat(x3, enc, wa, wb, variant)
    ref = P1.encoder_reference(x3, enc, wa, wb, variant)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= P1.TOL * float(ref.abs().max())


# -- K1: fused_train_pass ---------------------------------------------------
# Tolerances are chip_smoke.py's: rgb and weights atol 2e-3; each gradient
# tensor within `k1_grad_limits`' max error (relative to max|plain|) and
# norm error (relative to ‖plain‖), read on the card (PERF.md).


@pytest.fixture(scope="module")
def he_params(params):
    """chip_smoke's K1 weights: He-scaled (at the default init the
    activations fade, and many gradients with them)."""
    return {k: v * HE_GAIN if k.endswith(".weight") else v for k, v in params.items()}


def _train_inputs(R, S, dev, seed):
    g = torch.Generator().manual_seed(seed)
    ro, rd, z, dc, cond, bg = _inputs(R, S, "cpu", seed)
    rd[:4] = rd[4:8]
    tgt = torch.rand(R, 3, generator=g)
    noise = torch.randn(R, S, generator=g)
    pe_dir = torch.randn(R, 24, generator=g)
    return [t.to(dev).contiguous() for t in (ro, rd, z, tgt, bg, noise, pe_dir, cond)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "R,S,kind",
    [(512, 64, "noise"), (77, 128, "noise"), (301, 32, "white"), (301, 32, "train_bg")],
    ids=["coarse", "fine-ragged", "s32-white-ragged", "s32-train-bg"],
)
def test_train_kernel_matches_plain(cuda_device, he_params, R, S, kind):
    from nerface_tpu_torch.ops.kernels import fused_train as T

    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(R, S, cuda_device, seed=R + S)
    params = he_params
    if kind == "white":  # opaque rays, as chip_smoke's white case
        params = dict(params, **{"fc_alpha.bias": params["fc_alpha.bias"] + SIGMA_BIAS})
    bundle = [t.contiguous() for t in T.prefold_paper_params(params, cond, pe_dir, 10)]
    kw = dict(loss_scale=2.0 / (3.0 * R))
    if kind == "noise":
        kw.update(background=bg, noise=noise, noise_std=0.1)
    elif kind == "white":
        kw.update(white_background=True)
    else:
        kw.update(background=bg, train_bg=True, sup_bg_scale=0.001 / R)
    before = T.fused_train_pass.launches
    got, grads, d_bg = T.fused_train_pass(bundle, ro, rd, z, tgt, **kw)
    _, grads2, _ = T.fused_train_pass(bundle, ro, rd, z, tgt, **kw)
    torch.cuda.synchronize()
    assert T.fused_train_pass.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2)), "not deterministic"
    ref, rgrads, rd_bg = T.fused_train_pass_reference(bundle, ro, rd, z, tgt, **kw)
    for k in ("rgb", "weights"):
        torch.testing.assert_close(got[k], ref[k], atol=2e-3, rtol=0, msg=k)
    names = _bundle_names(False)
    pairs = list(zip(names, grads, rgrads))
    if kind == "train_bg":
        pairs.append(("bg", d_bg, rd_bg))
    for name, g, r in pairs:
        assert torch.isfinite(g).all(), name
        tol, tol_norm = k1_grad_limits(R, name)
        torch.testing.assert_close(g, r, atol=tol * float(r.abs().max()) + 1e-6, rtol=0, msg=name)
        err, ref_norm = float((g - r).norm()), float(r.norm())
        assert err <= tol_norm * ref_norm + 1e-6, f"{name}: ‖err‖ {err} > {tol_norm}·{ref_norm}"


@pytest.mark.cuda
def test_train_kernel_refuses_what_it_does_not_take(cuda_device, params):
    from nerface_tpu_torch.ops.kernels import fused_train as T

    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(64, 64, cuda_device, seed=2)
    bundle = T.prefold_paper_params(params, cond, pe_dir, 10)
    before = T.fused_train_pass.launches
    with pytest.raises(ValueError, match="samples per ray"):
        T.fused_train_pass(bundle, ro, rd, z[:, :16].contiguous(), tgt, loss_scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        T.fused_train_pass(bundle, ro, rd, z.t().contiguous().t(), tgt, loss_scale=1.0)
    with pytest.raises(TypeError, match="float32"):
        T.fused_train_pass(bundle, ro.double(), rd, z, tgt, loss_scale=1.0)
    with pytest.raises(ValueError, match="target is on"):
        T.fused_train_pass(bundle, ro, rd, z, tgt.cpu(), loss_scale=1.0)
    assert T.fused_train_pass.launches == before


# -- K4: fused_flex_forward / fused_flex_backward -----------------------------
# Tolerances are chip_smoke.py's: raw rgb and σ each within FLEX_OUT_TOL of
# their max|plain|; each gradient tensor (d_v0 and d_dir included) within
# `k1_grad_limits`, read on the card (PERF.md). Weights: synth512_lcode's
# model He-scaled, v0 its layer1 fold of a random conditioning.


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(512, 64), (77, 128), (301, 32)],
                         ids=["coarse", "fine-ragged", "s32-ragged"])
def test_flex_kernels_match_plain(cuda_device, R, S):
    """Rows past the last ray of a ragged last tile are masked (77·128 and
    301·32 are not multiples of the 128-row tile)."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    params, v0 = flex_params(R + S, cuda_device)
    ro, rd, z, dc, _, _ = _inputs(R, S, cuda_device, seed=R + S)
    weights = F.pack_flex_weights(params, 3, 10)
    g = torch.randn(R, S, 4, generator=torch.Generator().manual_seed(S)).to(cuda_device)
    args = (weights, ro, rd, z, dc, v0)
    before = (F.fused_flex_forward.launches, F.fused_flex_backward.launches)
    out = F.fused_flex_forward(*args, 3)
    grads = F.fused_flex_backward(*args, g, 3)
    grads2 = F.fused_flex_backward(*args, g, 3)
    torch.cuda.synchronize()
    assert (F.fused_flex_forward.launches, F.fused_flex_backward.launches) == (
        before[0] + 1, before[1] + 2)
    flat, flat2 = grads[0] + grads[1:], grads2[0] + grads2[1:]
    assert all(torch.equal(a, b) for a, b in zip(flat, flat2)), "not deterministic"
    ref = F.fused_flex_forward_reference(*args, 3)
    assert torch.isfinite(out).all()
    for sl in (slice(0, 3), slice(3, 4)):
        torch.testing.assert_close(out[..., sl], ref[..., sl],
                                   atol=FLEX_OUT_TOL * float(ref[..., sl].abs().max()), rtol=0)
    rgrads = F.fused_flex_backward_reference(*args, g, 3)
    wn, bn = F.weight_names(3)
    for name, a, r in zip(wn + bn + ("v0", "dir"), flat, rgrads[0] + rgrads[1:]):
        a, r = a.float(), r.float()
        assert torch.isfinite(a).all(), name
        tol, tol_norm = k1_grad_limits(R, name)
        torch.testing.assert_close(a, r, atol=tol * float(r.abs().max()) + 1e-6, rtol=0, msg=name)
        err, ref_norm = float((a - r).norm()), float(r.norm())
        assert err <= tol_norm * ref_norm + 1e-6, f"{name}: ‖err‖ {err} > {tol_norm}·{ref_norm}"


@pytest.mark.cuda
def test_flex_kernels_refuse_what_they_do_not_take(cuda_device):
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    params, v0 = flex_params(1, cuda_device)
    ro, rd, z, dc, _, _ = _inputs(64, 64, cuda_device, seed=2)
    weights = F.pack_flex_weights(params, 3, 10)
    g = torch.zeros(64, 64, 4, device=cuda_device)
    before = (F.fused_flex_forward.launches, F.fused_flex_backward.launches)
    with pytest.raises(ValueError, match="samples per ray"):
        F.fused_flex_forward(weights, ro, rd, z[:, :16].contiguous(), dc, v0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        F.fused_flex_forward(weights, ro, rd, z.t().contiguous().t(), dc, v0, 3)
    with pytest.raises(TypeError, match="float32"):
        F.fused_flex_forward(weights, ro.double(), rd, z, dc, v0, 3)
    with pytest.raises(ValueError, match="hidden layers"):
        F.fused_flex_forward(weights, ro, rd, z, dc, v0, 9)
    f32_mats = tuple(w.float() for w in weights)
    with pytest.raises(ValueError, match="bfloat16"):
        F.fused_flex_forward(f32_mats, ro, rd, z, dc, v0, 3)
    with pytest.raises(ValueError, match="g has shape"):
        F.fused_flex_backward(weights, ro, rd, z, dc, v0, g[:, :32].contiguous(), 3)
    assert (F.fused_flex_forward.launches, F.fused_flex_backward.launches) == before


# -- the smaller model: K2 and K1 in their `small` mode -----------------------
# chip_smoke.py's tolerances, as above.


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays,S", [(512, 64), (77, 128)], ids=["coarse", "fine-ragged"])
def test_render_kernel_small_matches_plain(cuda_device, n_rays, S):
    params = _k1_params(5, cuda_device, small=True)
    ro, rd, z, dc, cond, bg = _inputs(n_rays, S, cuda_device, seed=S + n_rays + 1)
    kw = dict(background=bg, out_weights=True, small=True)
    before = K.fused_paper_render.launches
    got = K.fused_paper_render(params, ro, rd, z, dc, cond, **kw)
    torch.cuda.synchronize()
    assert K.fused_paper_render.launches == before + 1
    _assert_close(got, K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw))
    with pytest.raises(ValueError, match="small"):
        K.fused_paper_render(K.pack_paper_weights(params), ro, rd, z, dc, cond,
                             background=bg)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(512, 64), (77, 128)], ids=["coarse", "fine-ragged"])
def test_train_kernel_small_matches_plain(cuda_device, R, S):
    from nerface_tpu_torch.ops.kernels import fused_train as T

    params = _k1_params(6, cuda_device, small=True)
    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(R, S, cuda_device, seed=R + S + 1)
    bundle = [t.contiguous() for t in T.prefold_paper_params(params, cond, pe_dir, 10, small=True)]
    kw = dict(loss_scale=2.0 / (3.0 * R), background=bg, noise=noise, noise_std=0.1, small=True)
    got, grads, _ = T.fused_train_pass(bundle, ro, rd, z, tgt, **kw)
    _, grads2, _ = T.fused_train_pass(bundle, ro, rd, z, tgt, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2)), "not deterministic"
    ref, rgrads, _ = T.fused_train_pass_reference(bundle, ro, rd, z, tgt, **kw)
    for k in ("rgb", "weights"):
        torch.testing.assert_close(got[k], ref[k], atol=2e-3, rtol=0, msg=k)
    _assert_grads_close(_bundle_names(True), grads, rgrads, R)


def _assert_grads_close(names, grads, rgrads, R):
    assert len(names) == len(grads) == len(rgrads)
    for name, g, r in zip(names, grads, rgrads):
        assert torch.isfinite(g).all(), name
        tol, tol_norm = k1_grad_limits(R, name)
        torch.testing.assert_close(g, r, atol=tol * float(r.abs().max()) + 1e-6, rtol=0, msg=name)
        err, ref_norm = float((g - r).norm()), float(r.norm())
        assert err <= tol_norm * ref_norm + 1e-6, f"{name}: ‖err‖ {err} > {tol_norm}·{ref_norm}"


# -- K1 and K3b's persistent grid (paper_train.cuh) ---------------------------
# Ray counts past one round of the grid (132 CTAs × 2 items), each ragged:
# the last item of a round is cut short, and at S = 32 the last item holds
# one live ray and one past the end.
PERSISTENT_CASES = [(2085, 64), (601, 128), (1111, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("R,S", PERSISTENT_CASES, ids=["s64", "s128", "s32"])
def test_train_kernel_persistent_grid(cuda_device, small, R, S):
    from nerface_tpu_torch.ops.kernels import fused_train as T

    params = _k1_params(8, cuda_device, small=small)
    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(R, S, cuda_device, seed=R + S + 3)
    bundle = [t.contiguous() for t in T.prefold_paper_params(params, cond, pe_dir, 10, small=small)]
    kw = dict(loss_scale=2.0 / (3.0 * R), background=bg, noise=noise, noise_std=0.1, small=small)
    _, ctas = T.workspace_geometry(R, S)
    assert ctas == T.K1_CTAS and R > 2 * T.K1_CTAS * (64 // S if S < 64 else 1)
    got, grads, _ = T.fused_train_pass(bundle, ro, rd, z, tgt, **kw)
    _, grads2, _ = T.fused_train_pass(bundle, ro, rd, z, tgt, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2)), "not deterministic"
    ref, rgrads, _ = T.fused_train_pass_reference(bundle, ro, rd, z, tgt, **kw)
    for k in ("rgb", "weights"):
        torch.testing.assert_close(got[k], ref[k], atol=2e-3, rtol=0, msg=k)
    _assert_grads_close(_bundle_names(small), grads, rgrads, R)


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("R,S", PERSISTENT_CASES, ids=["s64", "s128", "s32"])
def test_paper_mlp_backward_persistent_grid(cuda_device, small, R, S):
    from nerface_tpu_torch.ops.kernels.fused_train import prefold_paper_params

    params = _k1_params(9, cuda_device, small=small)
    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(R, S, cuda_device, seed=R + S + 4)
    bundle = [t.contiguous() for t in prefold_paper_params(
        params, cond, pe_dir, 10, small=small, dir_expr_offset=(256 + 24) if small else 0)]
    g = (torch.randn(R, S, 4, generator=torch.Generator().manual_seed(S)) / R).to(cuda_device)
    args = (bundle, ro, rd, z, g)
    grads = K.fused_paper_mlp_backward(*args, small=small)
    grads2 = K.fused_paper_mlp_backward(*args, small=small)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2)), "not deterministic"
    rgrads = K.fused_paper_mlp_backward_reference(*args, small=small)
    _assert_grads_close(_bundle_names(small), grads, rgrads, R)


# -- K4f and K4b's persistent grid (csrc/fused_flex.cu) ----------------------
# The same ragged ray counts past one round of the 132-CTA grid, at 0, 3 and
# 8 hidden layers: the chunk sequences and the workspace follow n. At 8
# the outputs and gradients are held to `flex_limit` / `flex_grad_limits`
# (chip_smoke.py): no less than FLEX_TC_FACTOR × what the plain version
# reads on the tensor cores.


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 3, 8])
@pytest.mark.parametrize("R,S", PERSISTENT_CASES, ids=["s64", "s128", "s32"])
def test_flex_kernels_persistent_grid(cuda_device, n, R, S):
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    params, v0 = flex_params(R + n, cuda_device, n_hidden=n)
    ro, rd, z, dc, _, _ = _inputs(R, S, cuda_device, seed=R + S + n)
    weights = F.pack_flex_weights(params, n, 10)
    g = torch.randn(R, S, 4, generator=torch.Generator().manual_seed(S + n)).to(cuda_device)
    args = (weights, ro, rd, z, dc, v0)
    assert max(c for c, *_ in F.unit_schedule(R, S)) == F.FLEX_CTAS - 1
    out, out2 = F.fused_flex_forward(*args, n), F.fused_flex_forward(*args, n)
    grads = F.fused_flex_backward(*args, g, n)
    grads2 = F.fused_flex_backward(*args, g, n)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    flat, flat2 = grads[0] + grads[1:], grads2[0] + grads2[1:]
    assert all(torch.equal(a, b) for a, b in zip(flat, flat2)), "not deterministic"
    ref = F.fused_flex_forward_reference(*args, n)
    deep = n >= FLEX_TC_DEPTH
    tc_ref = tensor_core_plain(lambda: F.fused_flex_forward_reference(*args, n)) if deep else None
    for sl in (slice(0, 3), slice(3, 4)):
        tol = flex_limit(FLEX_OUT_TOL, n, deep and rel_err(tc_ref[..., sl], ref[..., sl])[0])
        torch.testing.assert_close(out[..., sl], ref[..., sl],
                                   atol=tol * float(ref[..., sl].abs().max()), rtol=0)
    rgrads = F.fused_flex_backward_reference(*args, g, n)
    rflat = rgrads[0] + rgrads[1:]
    tc = tensor_core_plain(lambda: F.fused_flex_backward_reference(*args, g, n)) if deep else None
    tc_flat = tc[0] + tc[1:] if deep else [None] * len(rflat)
    wn, bn = F.weight_names(n)
    for name, a, r, t in zip(wn + bn + ("v0", "dir"), flat, rflat, tc_flat):
        assert torch.isfinite(a).all(), name
        tol, tol_norm = flex_grad_limits(R, name, n, t is not None and rel_err(t, r))
        e_max, e_norm = rel_err(a, r)
        assert e_max <= tol + 1e-6 / max(float(r.abs().max()), 1e-30), f"{name}: max err {e_max} > {tol}"
        assert e_norm <= tol_norm + 1e-6 / max(float(r.norm()), 1e-30), f"{name}: ‖err‖ {e_norm} > {tol_norm}"


DEAD_UNIT_CASES = [(2085, 64), (601, 128)]  # warpgroup 1's last item past the last ray
DEAD_UNIT_PASSES = 50


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", DEAD_UNIT_CASES, ids=["s64", "s128"])
def test_flex_dead_units_repeat_bit_for_bit(cuda_device, R, S):
    """K4f + K4b at 8 hidden layers on the two cases whose last round has a
    dead warpgroup (the walk of `fused_flex.cu::skip_stages`, where the
    watchdog trapped before its repair), DEAD_UNIT_PASSES times: every
    pass's output and gradients equal the first pass's bit for bit."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    n = 8
    params, v0 = flex_params(R + n, cuda_device, n_hidden=n)
    ro, rd, z, dc, _, _ = _inputs(R, S, cuda_device, seed=R + S + n)
    weights = F.pack_flex_weights(params, n, 10)
    g = torch.randn(R, S, 4, generator=torch.Generator().manual_seed(S + n)).to(cuda_device)
    args = (weights, ro, rd, z, dc, v0)
    first = None
    for _ in range(DEAD_UNIT_PASSES):
        out = F.fused_flex_forward(*args, n)
        grads = F.fused_flex_backward(*args, g, n)
        flat = [out] + list(grads[0]) + list(grads[1:])
        if first is None:
            first = flat
        else:
            assert all(torch.equal(a, b) for a, b in zip(first, flat))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(1, 32), (1, 64), (1, 128), (3, 32)],
                         ids=["half-unit", "one-unit", "one-ray-two-units", "ragged-item"])
def test_flex_kernels_passes_below_one_round(cuda_device, R, S):
    """Passes smaller than one unit or item: one CTA, a dead warpgroup,
    rows past the last ray inside a live unit (S = 32)."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    params, v0 = flex_params(R + S + 11, cuda_device)
    ro, rd, z, dc, _, _ = _inputs(R, S, cuda_device, seed=R + S + 11)
    weights = F.pack_flex_weights(params, 3, 10)
    g = torch.randn(R, S, 4, generator=torch.Generator().manual_seed(R + S)).to(cuda_device)
    args = (weights, ro, rd, z, dc, v0)
    assert len({c for c, *_ in F.unit_schedule(R, S)}) == 1
    out = F.fused_flex_forward(*args, 3)
    grads, grads2 = F.fused_flex_backward(*args, g, 3), F.fused_flex_backward(*args, g, 3)
    torch.cuda.synchronize()
    flat, flat2 = grads[0] + grads[1:], grads2[0] + grads2[1:]
    assert all(torch.equal(a, b) for a, b in zip(flat, flat2)), "not deterministic"
    ref = F.fused_flex_forward_reference(*args, 3)
    for sl in (slice(0, 3), slice(3, 4)):
        torch.testing.assert_close(out[..., sl], ref[..., sl],
                                   atol=FLEX_OUT_TOL * float(ref[..., sl].abs().max()), rtol=0)
    rgrads = F.fused_flex_backward_reference(*args, g, 3)
    wn, bn = F.weight_names(3)
    _assert_grads_close(wn + bn + ("v0", "dir"), [t.float() for t in flat],
                        [t.float() for t in rgrads[0] + rgrads[1:]], R)


# -- K3: fused_paper_mlp_forward / fused_paper_mlp_backward -------------------
# chip_smoke.py's tolerances: raw rgb and σ each within K3_OUT_TOL of their
# max|plain|; each gradient tensor within `k1_grad_limits`.


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("R,S", [(512, 64), (77, 128), (301, 32)],
                         ids=["coarse", "fine-ragged", "s32-ragged"])
def test_paper_mlp_kernels_match_plain(cuda_device, small, R, S):
    """Rows past the last ray of a ragged last tile are masked."""
    from nerface_tpu_torch.ops.kernels.fused_train import prefold_paper_params

    params = _k1_params(7, cuda_device, small=small)
    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(R, S, cuda_device, seed=R + S + 2)
    bundle = [t.contiguous() for t in prefold_paper_params(
        params, cond, pe_dir, 10, small=small, dir_expr_offset=(256 + 24) if small else 0)]
    g = torch.randn(R, S, 4, generator=torch.Generator().manual_seed(S)).to(cuda_device)
    args = (bundle, ro, rd, z)
    before = (K.fused_paper_mlp_forward.launches, K.fused_paper_mlp_backward.launches)
    out = K.fused_paper_mlp_forward(*args, small=small)
    out2 = K.fused_paper_mlp_forward(*args, small=small)
    grads = K.fused_paper_mlp_backward(*args, g, small=small)
    grads2 = K.fused_paper_mlp_backward(*args, g, small=small)
    torch.cuda.synchronize()
    assert (K.fused_paper_mlp_forward.launches, K.fused_paper_mlp_backward.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    ref = K.fused_paper_mlp_reference(*args, small=small)
    assert out.shape == (R, S, 4) and torch.isfinite(out).all()
    for sl in (slice(0, 3), slice(3, 4)):
        torch.testing.assert_close(out[..., sl], ref[..., sl],
                                   atol=K3_OUT_TOL * float(ref[..., sl].abs().max()), rtol=0)
    rgrads = K.fused_paper_mlp_backward_reference(*args, g, small=small)
    _assert_grads_close(_bundle_names(small), grads, rgrads, R)


@pytest.mark.cuda
def test_paper_mlp_autograd_reaches_the_modules(cuda_device):
    """The render pipeline's K3 branch on the card: autograd through the
    prefold hands K3b's gradients to every applied parameter."""
    from nerface_tpu_torch.models.nerf_models import ConditionalBlendshapePaperSmallerNeRFModel
    from nerface_tpu_torch.render.pipeline import EncodeSpec, _paper_pass

    m = ConditionalBlendshapePaperSmallerNeRFModel(
        num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False,
        device=cuda_device, generator=torch.Generator().manual_seed(8),
    )
    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(256, 64, cuda_device, seed=9)
    expr, latent = cond[:76] * 3.0, cond[76:].clone().requires_grad_(True)
    before = K.fused_paper_mlp_backward.launches
    out = _paper_pass(m, ro, rd, z, EncodeSpec(10, True, True), pe_dir, expr, latent)
    out.square().sum().backward()
    assert K.fused_paper_mlp_backward.launches == before + 1
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in m.parameters())
    assert latent.grad is not None and latent.grad.abs().sum() > 0


@pytest.mark.cuda
def test_paper_mlp_kernels_refuse_what_they_do_not_take(cuda_device, params):
    from nerface_tpu_torch.ops.kernels.fused_train import prefold_paper_params

    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(64, 64, cuda_device, seed=2)
    bundle = prefold_paper_params(params, cond, pe_dir, 10)
    g = torch.zeros(64, 64, 4, device=cuda_device)
    before = (K.fused_paper_mlp_forward.launches, K.fused_paper_mlp_backward.launches)
    with pytest.raises(ValueError, match="samples per ray"):
        K.fused_paper_mlp_forward(bundle, ro, rd, z[:, :16].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_paper_mlp_forward(bundle, ro, rd, z.t().contiguous().t())
    with pytest.raises(TypeError, match="float32"):
        K.fused_paper_mlp_forward(bundle, ro.double(), rd, z)
    with pytest.raises(ValueError, match="bundle has"):
        K.fused_paper_mlp_forward(bundle, ro, rd, z, small=True)
    with pytest.raises(ValueError, match="g has shape"):
        K.fused_paper_mlp_backward(bundle, ro, rd, z, g[:, :32].contiguous())
    with pytest.raises(ValueError, match="dir_contrib has shape"):
        K.fused_paper_mlp_forward(bundle, ro[:32].contiguous(), rd[:32].contiguous(),
                                  z[:32].contiguous())
    assert (K.fused_paper_mlp_forward.launches, K.fused_paper_mlp_backward.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "R,Sc,Sf,regime,spike",
    [(2048, 64, 64, "general", False), (2048, 64, 64, "sorted_u", False),
     (2048, 64, 64, "sorted_u", True), (77, 32, 16, "general", False),
     (301, 128, 128, "general", False), (300, 128, 100, "sorted_u", False)],
    ids=["general", "sorted_u", "sorted_u-spike", "ragged-32", "128+128", "128+100"],
)
def test_resample_kernel_matches_plain(cuda_device, R, Sc, Sf, regime, spike):
    """K5 against its plain version (the pipeline's sample_pdf +
    merge_sorted_zvals) within chip_smoke's RESAMPLE_TOL·far, rows sorted,
    bit-identical over two launches; a ragged last CTA (77 rays) and a
    non-power-of-two Sf in both regimes."""
    from nerface_tpu_torch.ops.kernels import fused_resample as K5
    from nerface_tpu_torch.ops.math import linspace01

    z, w, u = resample_inputs(R, Sc, Sf, R + Sc + Sf, cuda_device, RESAMPLE_SPIKE if spike else 0.0)
    sorted_u = regime == "sorted_u"
    if sorted_u:
        u = linspace01(Sf, device=cuda_device)
    before = K5.fused_resample.launches
    got = K5.fused_resample(z, w, u, sorted_u=sorted_u)
    again = K5.fused_resample(z, w, u, sorted_u=sorted_u)
    torch.cuda.synchronize()
    assert K5.fused_resample.launches == before + 2
    assert torch.equal(got, again) and got.shape == (R, Sc + Sf)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    ref = K5.fused_resample_reference(z, w, u, sorted_u)
    torch.testing.assert_close(got, ref, atol=RESAMPLE_TOL * FAR, rtol=0)


@pytest.mark.cuda
def test_resample_kernel_refuses_what_it_does_not_take(cuda_device):
    from nerface_tpu_torch.ops.kernels import fused_resample as K5

    z, w, u = resample_inputs(64, 64, 64, 1, cuda_device)
    before = K5.fused_resample.launches
    with pytest.raises(ValueError, match="coarse samples"):
        K5.fused_resample(z[:, :48].contiguous(), w[:, :48].contiguous(), u)
    with pytest.raises(ValueError, match="fine samples"):
        K5.fused_resample(z, w, torch.rand(64, 129, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        K5.fused_resample(z.t().contiguous().t(), w, u)
    with pytest.raises(TypeError, match="float32"):
        K5.fused_resample(z, w.double(), u)
    with pytest.raises(ValueError, match="u is on"):
        K5.fused_resample(z, w, u.cpu())
    assert K5.fused_resample.launches == before


# -- K3f on the shared chain and K5 as a persistent kernel ----------------------


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("R,S", [(1111, 128), (2085, 64), (600, 32), (265, 64), (77, 128), (5, 32)],
                         ids=["s128-rounds", "s64-rounds", "s32-rounds", "s64-ragged", "s128-ragged",
                              "s32-few-rays"])
def test_paper_mlp_forward_persistent_grid(cuda_device, small, R, S):
    """K3f past one round of the 132-CTA grid (R > 2·132·rays an item) and
    at ragged R, each S, both modes: raw rgb and σ within K3_OUT_TOL of the
    plain version, bit-identical over two launches, and no row written past
    the last ray (the launch writes into the head of a larger NaN buffer)."""
    from nerface_tpu_torch.ops.kernels.fused_train import prefold_paper_params

    params = _k1_params(11, cuda_device, small=small)
    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(R, S, cuda_device, seed=R + S + 5)
    bundle = [t.contiguous() for t in prefold_paper_params(
        params, cond, pe_dir, 10, small=small, dir_expr_offset=(256 + 24) if small else 0)]
    args = (bundle, ro, rd, z)
    out = K.fused_paper_mlp_forward(*args, small=small)
    operands = K._kernel_operands(bundle, R, ro.device, 10, True, small, transposed=False)
    big = torch.full((R + 2, S, 4), float("nan"), device=ro.device)
    before = K.fused_paper_mlp_forward.launches
    K._launch_paper_fwd(operands, (ro, rd, z), big, 10, small)
    torch.cuda.synchronize()
    assert K.fused_paper_mlp_forward.launches == before + 1
    assert torch.equal(big[:R], out) and torch.isnan(big[R:]).all()
    ref = K.fused_paper_mlp_reference(*args, small=small)
    assert torch.isfinite(out).all()
    for sl in (slice(0, 3), slice(3, 4)):
        torch.testing.assert_close(out[..., sl], ref[..., sl],
                                   atol=K3_OUT_TOL * float(ref[..., sl].abs().max()), rtol=0)


def _away_from_knots(w, u, gap=1e-6):
    """u moved at least `gap` off the knots of the reference's cdf (in
    float64): near a knot of a tiny-pdf bin the draw jumps across the bin
    with the cdf's last ulp, which no two orders of f32 sums share."""
    ww = w[:, 1:-1].double() + 1e-5
    cdf = torch.cumsum(ww / ww.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    uu = u.double().clone()
    for _ in range(4):
        near = (uu[:, :, None] - cdf[:, None, :]).abs().min(-1).values < gap
        if not near.any():
            break
        uu = torch.where(near, (uu + 5 * gap).clamp(max=1 - 1e-6), uu)
    return uu.float().contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("Sc", [32, 64, 128])
@pytest.mark.parametrize("Sf,draws", [(37, "rows"), (100, "shared"), (64, "linspace"), (16, "sorted_rows"),
                                      (64, "spike"), (64, "spike_rows"), (48, "tiny")])
def test_resample_kernel_shapes_and_draws(cuda_device, Sc, Sf, draws):
    """K5 at each Sc with Sf that are not powers of two, per-ray and shared
    u in the general regime, the linspace row and sorted per-ray draws with
    `sorted_u`, the spike in both regimes, and tiny-pdf bins (every third
    weight 0, the draws kept off the cdf's knots): within RESAMPLE_TOL·far
    of the plain version, rows sorted, bit-identical over two launches, on
    2085 rays (past one round of the persistent grid's warps)."""
    from nerface_tpu_torch.ops.kernels import fused_resample as K5
    from nerface_tpu_torch.ops.math import linspace01

    R = 2085
    z, w, u = resample_inputs(R, Sc, Sf, R + Sc + Sf, cuda_device,
                              RESAMPLE_SPIKE if draws.startswith("spike") else 0.0)
    sorted_u = draws in ("linspace", "sorted_rows", "spike")
    if draws == "shared":
        u = u[0].contiguous()
    elif draws in ("linspace", "spike"):
        u = linspace01(Sf, device=cuda_device)
    elif draws == "sorted_rows":
        u = torch.sort(u, -1).values.contiguous()
    elif draws == "tiny":
        w[:, ::3] = 0.0
        u = _away_from_knots(w.cpu(), u.cpu()).to(cuda_device)
    got = K5.fused_resample(z, w, u, sorted_u=sorted_u)
    again = K5.fused_resample(z, w, u, sorted_u=sorted_u)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and got.shape == (R, Sc + Sf)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    ref = K5.fused_resample_reference(z, w, u, sorted_u)
    torch.testing.assert_close(got, ref, atol=RESAMPLE_TOL * FAR, rtol=0)


# -- the execution window (train/window.py) ----------------------------------
WINDOW_RAYS = 256


def _window_cfg(cfg_dict, k, device_feed, logdir):
    import copy

    from nerface_tpu_torch.config import CfgNode

    d = copy.deepcopy(cfg_dict)
    d["experiment"].update(logdir=logdir, train_iters=7, print_every=5, validate_every=5,
                           save_every=5, steps_per_execute=k, device_feed=device_feed)
    d["nerf"]["train"]["num_random_rays"] = WINDOW_RAYS
    return CfgNode(d)


@pytest.fixture(scope="module")
def window_dataset():
    from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset

    return synthetic_flame_dataset(H=32, W=32, n_train=4, n_val=1, n_test=1, with_images=True,
                                   num_samples=16)


@pytest.mark.cuda
@pytest.mark.parametrize("config,device_feed", [("paper", True), ("paper", False),
                                                ("coarse", True), ("lcode", True)],
                         ids=["paper-device_feed", "paper-host_feed", "coarse-device_feed",
                              "lcode-device_feed"])
def test_window_equals_step_at_a_time(cuda_device, window_dataset, tmp_path, config,
                                      device_feed):
    """`train()` at 256 rays over the windows [0..0], [1..5], [6..6] (K = 5,
    CUDA-graph replays, async validation at 0 and 5) against K = 1 (the
    same step body, eager, sync validation): the parameters, the latent
    table, the optimizer state and the printed lines bit for bit. Each
    hand kernel ran as many times on the card in both (torch.profiler's
    kernel records, the replays' among them): the step's kernels 7 times
    a pass (K1 for the paper model, K3f / K3b for the coarse-only one, K4f
    / K4b for synth512_lcode) and the validations' K2 (or K4f). The
    wrappers count their calls from the host: at K = 5 the 2 eager steps',
    the capture's and the validations'."""
    import io
    import re
    from contextlib import redirect_stdout

    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SYNTH512_LCODE, SYNTH512_PAPER, SYNTH512_PAPER_COARSE, kernel_runs
    from nerface_tpu_torch.ops.kernels import fused_flex, fused_mlp, fused_train
    from nerface_tpu_torch.train import checkpoint as ckpt
    from nerface_tpu_torch.train.loop import train

    cfg_dict = {"paper": SYNTH512_PAPER, "coarse": SYNTH512_PAPER_COARSE,
                "lcode": SYNTH512_LCODE}[config]
    wrappers = [fused_train.fused_train_pass, fused_mlp.fused_paper_render,
                fused_mlp.fused_paper_mlp_forward, fused_mlp.fused_paper_mlp_backward,
                fused_flex.fused_flex_forward, fused_flex.fused_flex_backward]
    out = {}
    for k in (1, 5):
        for c in wrappers:
            c.launches = 0
        text = io.StringIO()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with redirect_stdout(text):
                state = train(_window_cfg(cfg_dict, k, device_feed, str(tmp_path / f"k{k}")),
                              dataset=window_dataset, dtype=torch.bfloat16, device=cuda_device)
            torch.cuda.synchronize()
        lines = re.findall(r"\[TRAIN\] Iter: .* LatentReg: \S+|\[VAL\] Iter: \d+ loss: \S+ PSNR: \S+",
                           text.getvalue())
        calls = {c.__name__: c.launches for c in wrappers if c.launches}
        out[k] = (state, calls, kernel_runs(prof), sorted(lines))
    (s1, c1, r1, p1), (s5, c5, r5, p5) = out[1], out[5]
    assert p1 == p5 and len(p1) == 3 + 2, (p1, p5)
    # 7 steps (3 of them from the host at K = 5: 2 eager, the capture); 2
    # validations of 1 frame, one tile, a launch a pass
    n_pass = 1 if config == "coarse" else 2
    runs = {"paper": {"train_pass_kernel": 2 * 7, "render_kernel": 2 * 2},
            "coarse": {"mlp_fwd_kernel": 7, "train_pass_kernel": 7, "render_kernel": 2},
            # K4b recomputes the forward: one more flex_chain_kernel a pass
            "lcode": {"flex_chain_kernel": 2 * 2 * 7 + 2 * 2, "flex_dx_kernel": 2 * 7}}[config]
    assert r1 == r5, (r1, r5)
    assert {n: c for n, c in r1.items() if n in runs} == runs, r1

    def calls(steps):
        return {"paper": {"fused_train_pass": 2 * steps, "fused_paper_render": 2 * 2},
                "coarse": {"fused_paper_mlp_forward": steps, "fused_paper_mlp_backward": steps,
                           "fused_paper_render": 2},
                "lcode": {"fused_flex_forward": n_pass * steps + 2 * 2,
                          "fused_flex_backward": n_pass * steps}}[config]

    assert c1 == calls(7) and c5 == calls(3), (c1, c5)
    assert s1.step == s5.step == 7
    for ma, mb in ((s1.model_coarse, s5.model_coarse), (s1.model_fine, s5.model_fine)):
        if ma is None:
            continue
        for (name, pa), pb in zip(ma.named_parameters(), mb.parameters()):
            assert torch.equal(pa, pb), name
    assert torch.equal(s1.latent_codes, s5.latent_codes)
    oa = ckpt.load_torch_checkpoint(str(tmp_path / "k1" / "synth512_paper" / "checkpoint00007.ckpt"))
    ob = ckpt.load_torch_checkpoint(str(tmp_path / "k5" / "synth512_paper" / "checkpoint00007.ckpt"))
    for key, st in oa["optimizer"]["state"].items():
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[f], ob["optimizer"]["state"][key][f]), (key, f)


@pytest.mark.cuda
def test_render_after_a_window_sees_the_updated_weights(cuda_device, window_dataset):
    """K2's packed weights are cached on the model by (data_ptr, _version);
    graph replays update the parameters in place without bumping
    `_version`, so the window bumps it. A frame of the live models rendered
    before a window (which fills the cache) and again after it equals the
    frame of a fresh copy of the trained models."""
    import copy

    from chip_smoke import SYNTH512_PAPER
    from nerface_tpu_torch.config import FeatureFlags
    from nerface_tpu_torch.data.device_feed import DeviceRayFeed
    from nerface_tpu_torch.eval.renderer import render_full_frame
    from nerface_tpu_torch.render.pipeline import RenderSettings
    from nerface_tpu_torch.train.loop import build_models_from_cfg, setup_background
    from nerface_tpu_torch.train.schedule import from_cfg
    from nerface_tpu_torch.train.state import build_optimizer, create_train_state
    from nerface_tpu_torch.train.window import TrainWindow

    ds = window_dataset
    cfg = _window_cfg(SYNTH512_PAPER, 5, True, "")
    flags = FeatureFlags.from_cfg(cfg)
    bg = setup_background(ds, flags)
    mc, mf = build_models_from_cfg(cfg, device=cuda_device,
                                   generator=torch.Generator().manual_seed(0))
    state = create_train_state(mc, mf, flags, n_train=len(ds.i_train), background=bg,
                               device=cuda_device)
    window = TrainWindow(state, build_optimizer(cfg, state), RenderSettings.from_cfg(cfg, "train"),
                         flags, from_cfg(cfg), 42, 5, dtype=torch.bfloat16,
                         device_feed=DeviceRayFeed(ds, WINDOW_RAYS, device=cuda_device))
    settings = RenderSettings.from_cfg(cfg, "validation")
    i = int(ds.i_val[0])
    expr = torch.as_tensor(ds.expressions[i], device=cuda_device)

    def frame(c, f):
        out = render_full_frame(c, f, ds.H, ds.W, ds.intrinsics, ds.poses[i][:3, :4], settings,
                                seed=3, expressions=expr,
                                latent_code=torch.zeros(32, device=cuda_device),
                                dtype=torch.bfloat16, device=cuda_device)
        return out["rgb_fine"]

    before = frame(state.model_coarse, state.model_fine)
    window.run(1)
    window.run(5)  # an eager step, the capture, 4 replays
    assert window.replays == 4
    after = frame(state.model_coarse, state.model_fine)
    fresh = frame(copy.deepcopy(state.model_coarse), copy.deepcopy(state.model_fine))
    torch.cuda.synchronize()
    assert not torch.equal(before, fresh)
    assert torch.equal(after, fresh)

