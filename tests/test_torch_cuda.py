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
rounding of an activation), depth atol 2e-3·far, disp rtol 1e-2. At the
sample counts the paper kernels take at run time beside 32 / 64 / 128
(`_yardstick`), K2's and K3f's readings also pass within `tc_limit`,
FLEX_TC_FACTOR × the plain version's own reading on the tensor cores, and
K3b's gradients within `k3b_grad_limits` of it, as in `chip_smoke.py
[sample_counts]`; K1 keeps its limits.
"""

import pytest
import torch

from chip_smoke import (
    FLEX_OUT_TOL,
    K3_OUT_TOL,
    RESAMPLE_SPIKE,
    RESAMPLE_TOL,
    SIGMA_BIAS,
    _bundle_names,
    _k1_params,
    flex_grad_limits,
    flex_limit,
    flex_yardstick,
    k1_grad_limits,
    k3b_grad_limits,
    rel_err,
    tc_limit,
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


def _past_the_limit(z, limit=K.MAX_SAMPLES):
    """z's rows at one sample past `limit`: the kernels' one MAX_SAMPLES
    (1024; K4's `fused_flex.MAX_SAMPLES` is the same)."""
    n = limit + 1
    return z.repeat(1, -(-n // z.shape[1]))[:, :n].contiguous()


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


def _yardstick(S):
    """Whether the tensor-core yardstick (`tc_limit`) applies at S: the
    sample counts the paper kernels take beside 32 / 64 / 128."""
    return S not in (32, 64, 128)


def _tc_abs(tc, ref):
    """max |tc − ref|, or 0 without a yardstick."""
    return 0.0 if tc is None else float((tc - ref).abs().max())


def _assert_close(got, ref, tc=None):
    """K2's maps against the plain version's; with `tc` (the plain version
    on the tensor cores), each within `tc_limit` of its own reading."""
    for k, v in got.items():
        assert torch.isfinite(v).all(), k
    for k in ("rgb", "acc", "bg_weight", "weights"):
        if k in ref:
            atol = tc_limit(2e-3, _tc_abs(tc and tc[k], ref[k]))
            torch.testing.assert_close(got[k], ref[k], atol=atol, rtol=0, msg=k)
    atol = tc_limit(2e-3 * FAR, _tc_abs(tc and tc["depth"], ref["depth"]))
    torch.testing.assert_close(got["depth"], ref["depth"], atol=atol, rtol=0)
    rtol = 1e-2 if tc is None else tc_limit(1e-2, float(((tc["disp"] - ref["disp"]) / ref["disp"]).abs().max()))
    torch.testing.assert_close(got["disp"], ref["disp"], atol=0, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_rays,S,with_bg,white",
    [(512, 64, True, False), (512, 128, True, False), (301, 64, False, True),
     (77, 128, True, False), (1000, 32, False, False), (512, 16, True, False),
     (301, 24, True, False), (77, 96, False, True), (64, 192, True, False),
     (40, 256, True, False), (530, 1, True, False), (530, 1, False, False), (301, 5, True, False),
     (301, 40, False, False), (77, 200, False, True)],
    ids=["coarse", "fine", "ragged-white", "ragged-fine", "s32", "s16", "s24-ragged",
         "s96-ragged-white", "s192", "s256", "s1", "s1-no-bg", "s5-ragged", "s40-ragged-no-bg",
         "s200-ragged-white"],
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
    tc = _yardstick(S) and tensor_core_plain(
        lambda: K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw))
    _assert_close(got, ref, tc or None)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device, params):
    ro, rd, z, dc, cond, bg = _inputs(64, 64, cuda_device, seed=1)
    before = K.fused_paper_render.launches
    with pytest.raises(ValueError, match="samples per ray"):
        K.fused_paper_render(params, ro, rd, _past_the_limit(z), dc, cond)
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
    [(0, 64), (1, 64), (5, 128), (3, 32), (333, 128), (2049, 64), (2049, 24), (333, 192)],
    ids=["none", "one", "fewer-than-clusters", "one-tile", "odd-tiles", "ragged", "s24-ragged",
         "s192-odd-tiles"],
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
    [(512, 64, "noise"), (77, 128, "noise"), (301, 32, "white"), (301, 32, "train_bg"),
     (512, 16, "noise"), (301, 24, "noise"), (77, 96, "white"), (64, 192, "train_bg"),
     (40, 256, "noise"), (530, 1, "noise"), (301, 5, "noise"), (301, 40, "white"),
     (77, 200, "train_bg")],
    ids=["coarse", "fine-ragged", "s32-white-ragged", "s32-train-bg", "s16", "s24-ragged",
         "s96-white-ragged", "s192-train-bg", "s256", "s1", "s5-ragged", "s40-white-ragged",
         "s200-train-bg-ragged"],
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
    if kind == "train_bg":
        names, grads, rgrads = names + ["bg"], list(grads) + [d_bg], list(rgrads) + [rd_bg]
    _assert_grads_close(names, grads, rgrads, R)


@pytest.mark.cuda
def test_train_kernel_refuses_what_it_does_not_take(cuda_device, params):
    from nerface_tpu_torch.ops.kernels import fused_train as T

    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(64, 64, cuda_device, seed=2)
    bundle = T.prefold_paper_params(params, cond, pe_dir, 10)
    before = T.fused_train_pass.launches
    with pytest.raises(ValueError, match="samples per ray"):
        T.fused_train_pass(bundle, ro, rd, _past_the_limit(z), tgt, loss_scale=1.0)
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
# `k1_grad_limits`, read on the card (PERF.md); where `flex_yardstick`
# holds (8 hidden layers, an S beside 32 / 64 / 128) `flex_limit` /
# `flex_grad_limits`: no less than FLEX_TC_FACTOR × the plain version's
# own reading on the tensor cores. Weights: synth512_lcode's model
# He-scaled, v0 its layer1 fold of a random conditioning.


def _assert_flex_close(out, flat, args, g, R, S, n, bands=10, yard=None):
    """K4f's output and K4b's gradients (flat: the weights', d_v0, d_dir)
    against the plain versions at `bands` xyz bands within `flex_limit` /
    `flex_grad_limits`, with the tensor-core yardstick where `flex_yardstick`
    holds (or `yard` says; at every S at the sliced widths 768 / 1024)."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    yard = flex_yardstick(S, n, args[5].shape[-1]) if yard is None else yard
    ref = F.fused_flex_forward_reference(*args, n, bands)
    tc_ref = tensor_core_plain(lambda: F.fused_flex_forward_reference(*args, n, bands)) if yard else None
    assert torch.isfinite(out).all()
    for sl in (slice(0, 3), slice(3, 4)):
        tol = flex_limit(FLEX_OUT_TOL, n, yard and rel_err(tc_ref[..., sl], ref[..., sl])[0])
        torch.testing.assert_close(out[..., sl], ref[..., sl],
                                   atol=tol * float(ref[..., sl].abs().max()), rtol=0)
    rgrads = F.fused_flex_backward_reference(*args, g, n, bands)
    rflat = rgrads[0] + rgrads[1:]
    tc = tensor_core_plain(lambda: F.fused_flex_backward_reference(*args, g, n, bands)) if yard else None
    tc_flat = tc[0] + tc[1:] if yard else [None] * len(rflat)
    wn, bn = F.weight_names(n)
    for name, a, r, t in zip(wn + bn + ("v0", "dir"), flat, rflat, tc_flat):
        a, r = a.float(), r.float()
        assert torch.isfinite(a).all(), name
        tol, tol_norm = flex_grad_limits(R, name, n, t is not None and rel_err(t.float(), r), S)
        e_max, e_norm = rel_err(a, r)
        assert e_max <= tol + 1e-6 / max(float(r.abs().max()), 1e-30), f"{name}: max err {e_max} > {tol}"
        assert e_norm <= tol_norm + 1e-6 / max(float(r.norm()), 1e-30), f"{name}: ‖err‖ {e_norm} > {tol_norm}"


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(512, 64), (77, 128), (301, 32), (530, 1), (301, 24), (77, 96),
                                 (64, 192), (40, 256), (77, 200)],
                         ids=["coarse", "fine-ragged", "s32-ragged", "s1", "s24-ragged",
                              "s96-ragged", "s192", "s256", "s200-ragged"])
def test_flex_kernels_match_plain(cuda_device, R, S):
    """Rows past the last ray of a ragged last tile are masked (77·128 and
    301·32 are not multiples of the 128-row tile); the runtime layouts
    (S = 1: 64 rays a unit; 24: 8 rays in 3 units; 96: 2 in 3; 192: one
    ray in 3; 200: one in 4 with 56 padding rows) with a cut-short last
    item."""
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
    _assert_flex_close(out, flat, args, g, R, S, 3)


@pytest.mark.cuda
def test_flex_kernels_refuse_what_they_do_not_take(cuda_device):
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    params, v0 = flex_params(1, cuda_device)
    ro, rd, z, dc, _, _ = _inputs(64, 64, cuda_device, seed=2)
    weights = F.pack_flex_weights(params, 3, 10)
    g = torch.zeros(64, 64, 4, device=cuda_device)
    before = (F.fused_flex_forward.launches, F.fused_flex_backward.launches)
    with pytest.raises(ValueError, match="1..1024 samples per ray"):
        F.fused_flex_forward(weights, ro, rd, _past_the_limit(z, F.MAX_SAMPLES), dc, v0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        F.fused_flex_forward(weights, ro, rd, z.t().contiguous().t(), dc, v0, 3)
    with pytest.raises(TypeError, match="float32"):
        F.fused_flex_forward(weights, ro.double(), rd, z, dc, v0, 3)
    with pytest.raises(ValueError, match="hidden layers"):
        F.fused_flex_forward(weights, ro, rd, z, dc, v0, 9)  # 9 hidden layers' weights, 3 given
    with pytest.raises(ValueError, match="n_hidden"):
        F.fused_flex_forward(weights, ro, rd, z, dc, v0, -1)
    for h in (128, 1280):  # JAX's kernel takes 1280; the port's take h up to 1024
        with pytest.raises(ValueError, match="hidden width 256, 512, 768 or 1024"):
            F.fused_flex_forward(weights, ro, rd, z, torch.zeros(64, h // 2, device=cuda_device),
                                 torch.zeros(1, h, device=cuda_device), 3)
    f32_mats = tuple(w.float() for w in weights)
    with pytest.raises(ValueError, match="bfloat16"):
        F.fused_flex_forward(f32_mats, ro, rd, z, dc, v0, 3)
    with pytest.raises(ValueError, match="g has shape"):
        F.fused_flex_backward(weights, ro, rd, z, dc, v0, g[:, :32].contiguous(), 3)
    assert (F.fused_flex_forward.launches, F.fused_flex_backward.launches) == before


@pytest.mark.cuda
def test_flex_entry_points_refuse_what_the_kernels_do_not_take(cuda_device):
    """The C entry points of K4f / K4b return cudaErrorInvalidValue (1) for
    S outside 1..1024, for an S whose layout class the build does not hold
    (the fixed build at S = 24 or 32), for a hidden width a build does not
    hold (768 and 1024 only in their own builds, 1280 in none) and for n <
    0: no S or width runs another's layout. Nothing is launched."""
    import ctypes

    from nerface_tpu_torch.ops.kernels.build import SAMPLE_CLASS_DEFINES, flex_sliced_defines, load_library
    from nerface_tpu_torch.ops.kernels.fused_flex import SLICED_WIDTHS

    out = torch.zeros(8, 4, device=cuda_device)
    null = ctypes.c_void_p(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda_device).cuda_stream)

    def fwd(lib, S, h=256, n=3):
        # ray pointers are never read: the entry refuses before it launches
        return lib.nerface_fused_flex_fwd(null, null, null, null, null, null, ctypes.c_void_p(out.data_ptr()),
                                          8, S, 10, n, h, stream)

    fixed = load_library("fused_flex", SAMPLE_CLASS_DEFINES["fixed"])
    runtime = load_library("fused_flex", SAMPLE_CLASS_DEFINES["any"])
    for h in (256, 512):
        for lib in (fixed, runtime):
            for S in (0, -1, 1025, 2048):
                assert fwd(lib, S, h) == 1, S
                assert lib.nerface_fused_flex_workspace_bytes(8, S, 10, 3, h) == -1, S
            for bad in (0, 128, 384, 1280, 2048):
                assert fwd(lib, 64, bad) == 1 and fwd(lib, 24, bad) == 1, bad
                assert lib.nerface_fused_flex_workspace_bytes(8, 64, 10, 3, bad) == -1, bad
            for other in (768, 1024):  # each in its own build: a layout-class build refuses it
                assert fwd(lib, 64, other) == 1 and fwd(lib, 24, other) == 1, other
            assert fwd(lib, 64, h, -1) == 1 and lib.nerface_fused_flex_workspace_bytes(8, 64, 10, -1, h) == -1
            assert lib.nerface_fused_flex_workspace_bytes(8, 24, 10, 12, h) > 0  # any depth
        assert fwd(fixed, 24, h) == 1 and fwd(fixed, 32, h) == 1
    for h in SLICED_WIDTHS:
        lib = load_library("fused_flex", flex_sliced_defines(h))
        for S in (0, 1025):
            assert fwd(lib, S, h) == 1, S
        for other in (256, 512, 1280) + tuple(x for x in SLICED_WIDTHS if x != h):
            assert fwd(lib, 64, other) == 1 and fwd(lib, 24, other) == 1, other
        assert fwd(lib, 64, h, -1) == 1 and lib.nerface_fused_flex_workspace_bytes(8, 64, 10, 12, h) > 0
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


# K4f / K4b at hidden width 512 (the two consumer warpgroups share each
# unit: csrc/fused_flex.cu's wide_chain_kernel / wide_dx_kernel) and at 12
# hidden layers at both widths: (h, n, R, S); ragged passes, the runtime
# layouts, one past one round of the 132-CTA grid (a CTA a round of one
# item at 512).
FLEX_WIDE_CASES = [(512, 3, 512, 64), (512, 3, 77, 128), (512, 3, 301, 24), (512, 3, 530, 1),
                   (512, 3, 40, 256), (512, 0, 301, 32), (512, 12, 2085, 64), (512, 12, 267, 200),
                   (256, 12, 2085, 64), (256, 12, 301, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,n,R,S", FLEX_WIDE_CASES, ids=[f"h{h}_n{n}_{R}x{S}" for h, n, R, S in FLEX_WIDE_CASES])
def test_flex_wide_and_deep_kernels_match_plain(cuda_device, h, n, R, S):
    """The kernels against their plain versions within `flex_limit` /
    `flex_grad_limits` (the tensor-core yardstick at n ≥ 8 and beside S =
    32 / 64 / 128), each launch counted once, K4b bit-identical over two
    launches."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    params, v0 = flex_params(R + S + n, cuda_device, n_hidden=n, hidden=h)
    ro, rd, z, _, _, _ = _inputs(R, S, cuda_device, seed=R + S + n)
    dc = (torch.randn(R, h // 2, generator=torch.Generator().manual_seed(n)) * 0.3).to(cuda_device)
    weights = F.pack_flex_weights(params, n, 10)
    g = torch.randn(R, S, 4, generator=torch.Generator().manual_seed(S + n)).to(cuda_device)
    args = (weights, ro, rd, z, dc, v0)
    before = (F.fused_flex_forward.launches, F.fused_flex_backward.launches)
    out = F.fused_flex_forward(*args, n)
    grads = F.fused_flex_backward(*args, g, n)
    grads2 = F.fused_flex_backward(*args, g, n)
    torch.cuda.synchronize()
    assert (F.fused_flex_forward.launches, F.fused_flex_backward.launches) == (before[0] + 1, before[1] + 2)
    assert grads[1].shape == (1, h) and grads[2].shape == (R, h // 2)
    flat, flat2 = grads[0] + grads[1:], grads2[0] + grads2[1:]
    assert all(torch.equal(a, b) for a, b in zip(flat, flat2)), "not deterministic"
    _assert_flex_close(out, flat, args, g, R, S, n)


# K4f / K4b at hidden width 768 and 1024 (csrc/fused_flex.cu's sliced
# kernels: both consumer warpgroups on each unit, each layer's columns in
# slices of 256, in a build of each width's own): (h, n, R, S); the train
# step's pair, ragged passes, the runtime layouts (S = 24, 1, 200), long
# items (S = 320, 1024), 0 and 8 hidden layers, a grid past one round of
# 132 CTAs with a cut-short last round (2085 × 64).
FLEX_SLICED_CASES = [(768, 3, 512, 64), (768, 3, 77, 128), (768, 0, 301, 24), (768, 8, 530, 1),
                     (768, 3, 40, 320), (1024, 3, 512, 64), (1024, 3, 77, 128), (1024, 0, 301, 24),
                     (1024, 8, 2085, 64), (1024, 3, 64, 1024), (1024, 3, 267, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,n,R,S", FLEX_SLICED_CASES,
                         ids=[f"h{h}_n{n}_{R}x{S}" for h, n, R, S in FLEX_SLICED_CASES])
def test_flex_sliced_kernels_match_plain(cuda_device, h, n, R, S):
    """The sliced kernels against their plain versions within `flex_limit`
    / `flex_grad_limits` (the tensor-core yardstick at every S at these
    widths), each launch counted once, K4b bit-identical over two
    launches."""
    test_flex_wide_and_deep_kernels_match_plain(cuda_device, h, n, R, S)


@pytest.mark.cuda
@pytest.mark.parametrize("h,R,S", [(768, 77, 64), (1024, 301, 24)], ids=["h768_s64", "h1024_s24"])
def test_flex_sliced_kernels_take_16_bands(cuda_device, h, R, S):
    """The sliced kernels at 16 xyz bands (a two-block xin image, W1 two
    chunks of each slice), as `test_flex_kernels_take_11_and_20_bands`."""
    _check_flex_kernels_at(cuda_device, h, 16, R, S, seed=R + h)


# -- K4f / K4b at 11..20 xyz bands (a K = 128 encoding) ---------------------
# Past 10 bands both widths' kernels read two 64-column blocks of [xyz; PE;
# 0] in the runtime layout class at any S, W1 two chunks. Held to their
# plain versions as in chip_smoke.py [xyz_bands]: `flex_limit` /
# `flex_grad_limits` with the tensor-core yardstick; K4b bit-identical over
# two launches.


def _check_flex_kernels_at(dev, h, L, R, S, seed, n=3):
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    params, v0 = flex_params(seed, dev, n_hidden=n, hidden=h, bands=L)
    ro, rd, z, _, _, _ = _inputs(R, S, dev, seed=seed + 1)
    dc = (torch.randn(R, h // 2, generator=torch.Generator().manual_seed(seed)) * 0.3).to(dev)
    weights = F.pack_flex_weights(params, n, L)
    g = torch.randn(R, S, 4, generator=torch.Generator().manual_seed(S + L)).to(dev)
    args = (weights, ro, rd, z, dc, v0)
    before = (F.fused_flex_forward.launches, F.fused_flex_backward.launches)
    out = F.fused_flex_forward(*args, n, L)
    grads = F.fused_flex_backward(*args, g, n, L)
    grads2 = F.fused_flex_backward(*args, g, n, L)
    torch.cuda.synchronize()
    assert (F.fused_flex_forward.launches, F.fused_flex_backward.launches) == (before[0] + 1, before[1] + 2)
    assert grads[0][1].shape == (6 * L, h)  # w1b
    flat, flat2 = grads[0] + grads[1:], grads2[0] + grads2[1:]
    assert all(torch.equal(a, b) for a, b in zip(flat, flat2)), "not deterministic"
    _assert_flex_close(out, flat, args, g, R, S, n, L, yard=True)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [256, 512])
@pytest.mark.parametrize("L", [11, 20])
@pytest.mark.parametrize("R,S", [(512, 64), (77, 128), (301, 24), (40, 256)], ids=["s64", "s128", "s24", "s256"])
def test_flex_kernels_take_11_and_20_bands(cuda_device, h, L, R, S):
    """K4f and K4b at both widths at the band counts where the K = 128
    encoding starts and ends, at the fixed layout classes' S (which run the
    runtime class past 10 bands) and at runtime ones, against their plain
    versions."""
    _check_flex_kernels_at(cuda_device, h, L, R, S, seed=L + S + h)


# ray counts past one round of the grid, each ragged, at 16 bands; 2085 ×
# 64 has a dead warpgroup in the h = 256 recompute (the dead-unit walk)
FLEX_PE16_PERSISTENT_CASES = [(2085, 64), (601, 128), (2133, 24), (267, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("h", [256, 512])
@pytest.mark.parametrize("R,S", FLEX_PE16_PERSISTENT_CASES, ids=["s64", "s128", "s24", "s200"])
def test_flex_kernels_persistent_grid_at_16_bands(cuda_device, h, R, S):
    """K4f and K4b at 16 bands on passes past one round of the persistent
    grid: the one 16 KB xin buffer (a warpgroup's at h = 256, the CTA's at
    512) carries the encoders round after round, and the recompute's dead
    units take it by thread 0 alone."""
    _check_flex_kernels_at(cuda_device, h, 16, R, S, seed=R + S + h)


@pytest.mark.cuda
def test_flex_entry_points_take_1_to_20_bands(cuda_device):
    """K4f's and K4b's C entry points, in both builds and at both widths,
    return cudaErrorInvalidValue (1) for n_freqs outside 1..20 before they
    read a pointer, and the workspace size is -1 there; from 10 to 11 bands
    the workspace grows by xin's 64 more columns a unit and dW's partial
    rows' 64 more rows of W1 a segment, and no more to 20. Nothing is
    launched."""
    import ctypes

    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels.build import SAMPLE_CLASS_DEFINES, load_library

    null = ctypes.c_void_p(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda_device).cuda_stream)
    for defines in SAMPLE_CLASS_DEFINES.values():
        lib = load_library("fused_flex", defines)
        for h in (256, 512):
            for L in (0, -1, 21, 64):
                assert lib.nerface_fused_flex_fwd(*[null] * 7, 8, 64, L, 3, h, stream) == 1, L
                assert lib.nerface_fused_flex_bwd(*[null] * 12, 8, 64, L, 3, h, stream) == 1, L
                assert lib.nerface_fused_flex_workspace_bytes(2048, 64, L, 3, h) == -1, L
            ws = {L: lib.nerface_fused_flex_workspace_bytes(2048, 64, L, 3, h) for L in (1, 10, 11, 16, 20)}
            assert ws[1] == ws[10] and ws[11] == ws[16] == ws[20], ws
            units = 2048  # one ray in one unit at S = 64
            assert ws[11] - ws[10] >= units * 64 * 128 + F.dw_segments(3, h, 128) * 64 * h * 4 - 256 * 3, ws
            assert ws[11] == F.workspace_layout(2048, 64, 3, h, 128)[1], ws
            assert ws[10] == F.workspace_layout(2048, 64, 3, h)[1], ws
    torch.cuda.synchronize()


# -- the smaller model: K2 and K1 in their `small` mode -----------------------
# chip_smoke.py's tolerances, as above.


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays,S", [(512, 64), (77, 128), (301, 5), (77, 200)],
                         ids=["coarse", "fine-ragged", "s5-ragged", "s200-ragged"])
def test_render_kernel_small_matches_plain(cuda_device, n_rays, S):
    params = _k1_params(5, cuda_device, small=True)
    ro, rd, z, dc, cond, bg = _inputs(n_rays, S, cuda_device, seed=S + n_rays + 1)
    kw = dict(background=bg, out_weights=True, small=True)
    before = K.fused_paper_render.launches
    got = K.fused_paper_render(params, ro, rd, z, dc, cond, **kw)
    torch.cuda.synchronize()
    assert K.fused_paper_render.launches == before + 1
    tc = _yardstick(S) and tensor_core_plain(
        lambda: K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw))
    _assert_close(got, K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw), tc or None)
    with pytest.raises(ValueError, match="small"):
        K.fused_paper_render(K.pack_paper_weights(params), ro, rd, z, dc, cond,
                             background=bg)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(512, 64), (77, 128), (301, 5), (77, 200)],
                         ids=["coarse", "fine-ragged", "s5-ragged", "s200-ragged"])
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


def _assert_grads_close(names, grads, rgrads, R, tc_grads=None):
    """Each gradient within `k1_grad_limits`; with `tc_grads` (K3b's plain
    version on the tensor cores), within `k3b_grad_limits` of their
    readings instead."""
    assert len(names) == len(grads) == len(rgrads)
    for k, (name, g, r) in enumerate(zip(names, grads, rgrads)):
        assert torch.isfinite(g).all(), name
        tol, tol_norm = k1_grad_limits(R, name)
        if tc_grads is not None:
            tol, tol_norm = k3b_grad_limits(R, name, rel_err(tc_grads[k], r))
        torch.testing.assert_close(g, r, atol=tol * float(r.abs().max()) + 1e-6, rtol=0, msg=name)
        err, ref_norm = float((g - r).norm()), float(r.norm())
        assert err <= tol_norm * ref_norm + 1e-6, f"{name}: ‖err‖ {err} > {tol_norm}·{ref_norm}"


# -- K1 and K3b's persistent grid (paper_train.cuh) ---------------------------
# Ray counts past one round of the grid (132 CTAs × 2 items), each ragged:
# the last item of a round is cut short, and at S = 32 the last item holds
# one live ray and one past the end.
PERSISTENT_CASES = [(2085, 64), (601, 128), (1111, 32)]
# the paper kernels take any S: also S = 24 (8 rays in 3 units) and 192 (3 units a ray),
# each past one round of the grid
PAPER_PERSISTENT_CASES = PERSISTENT_CASES + [(2200, 24), (601, 192)]
# K4 too, at two runtime layouts whose last round leaves warpgroup 1 past
# the last ray (tests/test_torch_k4_layout.py::DEAD_UNIT_CTA): 2133 × 24
# (267 items of 8 rays, the last of 5) and 267 × 200 (one ray in 4 units,
# 56 padding rows)
FLEX_PERSISTENT_CASES = PERSISTENT_CASES + [(2133, 24), (267, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("R,S", PAPER_PERSISTENT_CASES, ids=["s64", "s128", "s32", "s24", "s192"])
def test_train_kernel_persistent_grid(cuda_device, small, R, S):
    from nerface_tpu_torch.ops.kernels import fused_train as T

    params = _k1_params(8, cuda_device, small=small)
    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(R, S, cuda_device, seed=R + S + 3)
    bundle = [t.contiguous() for t in T.prefold_paper_params(params, cond, pe_dir, 10, small=small)]
    kw = dict(loss_scale=2.0 / (3.0 * R), background=bg, noise=noise, noise_std=0.1, small=small)
    _, ctas = T.workspace_geometry(R, S)
    assert ctas == T.K1_CTAS and R > 2 * T.K1_CTAS * T.unit_layout(S)[0]
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
@pytest.mark.parametrize("R,S", PAPER_PERSISTENT_CASES, ids=["s64", "s128", "s32", "s24", "s192"])
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


# -- the paper kernels at 11..20 xyz bands (a K = 128 encoding) ------------------
# Past 10 bands K2, K3f, K3b and K1 read two 64-column blocks of [xyz; PE;
# 0] in their runtime layout class at any S. Held to their plain versions
# as in chip_smoke.py [xyz_bands]: K2's maps and K3f within `tc_limit`, K3b
# within `k3b_grad_limits` of the tensor-core yardstick, K1 within
# `k1_grad_limits`; K1 and K3b bit-identical over two launches.


def _paper_band_case(dev, small, L, R, S, seed):
    """(K2's params, K1 / K3's bundle, rays) of a paper-family model at L bands."""
    from nerface_tpu_torch.ops.kernels.fused_train import prefold_paper_params

    params = _k1_params(seed, dev, small=small, bands=L)
    ro, rd, z, tgt, bg, noise, pe_dir, cond = _train_inputs(R, S, dev, seed=seed + R + S)
    bundle = [t.contiguous() for t in prefold_paper_params(
        params, cond, pe_dir, L, small=small, dir_expr_offset=(256 + 24) if small else 0)]
    _, _, _, dc, _, _ = _inputs(R, S, dev, seed=seed + 1)
    return params, bundle, (ro, rd, z, tgt, bg, noise, dc, cond)


def _check_paper_kernels_at(dev, small, L, R, S, seed):
    from nerface_tpu_torch.ops.kernels import fused_train as T

    params, bundle, (ro, rd, z, tgt, bg, noise, dc, cond) = _paper_band_case(dev, small, L, R, S, seed)
    kb = dict(num_encoding_fn_xyz=L, small=small)
    kw = dict(background=bg, out_weights=True, **kb)
    launches = (K.fused_paper_render.launches, K.fused_paper_mlp_forward.launches,
                K.fused_paper_mlp_backward.launches, T.fused_train_pass.launches)
    got = K.fused_paper_render(K.pack_paper_weights(params, L), ro, rd, z, dc, cond, **kw)
    got2 = K.fused_paper_render(params, ro, rd, z, dc, cond, **kw)
    torch.cuda.synchronize()
    for k in got:
        assert torch.equal(got[k], got2[k]), k
    ref = K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw)
    _assert_close(got, ref, tensor_core_plain(lambda: K.fused_paper_render_reference(params, ro, rd, z, dc, cond,
                                                                                         **kw)))
    out = K.fused_paper_mlp_forward(bundle, ro, rd, z, **kb)
    refo = K.fused_paper_mlp_reference(bundle, ro, rd, z, **kb)
    tco = tensor_core_plain(lambda: K.fused_paper_mlp_reference(bundle, ro, rd, z, **kb))
    for sl in (slice(0, 3), slice(3, 4)):
        tol = tc_limit(K3_OUT_TOL, rel_err(tco[..., sl], refo[..., sl])[0])
        torch.testing.assert_close(out[..., sl], refo[..., sl], atol=tol * float(refo[..., sl].abs().max()), rtol=0)
    g = (torch.randn(R, S, 4, generator=torch.Generator().manual_seed(S + L)) / R).to(dev)
    grads = K.fused_paper_mlp_backward(bundle, ro, rd, z, g, **kb)
    grads2 = K.fused_paper_mlp_backward(bundle, ro, rd, z, g, **kb)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2)), "K3b not deterministic"
    assert grads[3 + 1].shape == (6 * L, 256)  # w0b
    _assert_grads_close(_bundle_names(small), grads, K.fused_paper_mlp_backward_reference(bundle, ro, rd, z, g, **kb),
                        R, tensor_core_plain(lambda: K.fused_paper_mlp_backward_reference(bundle, ro, rd, z, g, **kb)))
    kw1 = dict(loss_scale=2.0 / (3.0 * R), background=bg, noise=noise, noise_std=0.1, **kb)
    got, grads, _ = T.fused_train_pass(bundle, ro, rd, z, tgt, **kw1)
    _, grads2, _ = T.fused_train_pass(bundle, ro, rd, z, tgt, **kw1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2)), "K1 not deterministic"
    ref, rgrads, _ = T.fused_train_pass_reference(bundle, ro, rd, z, tgt, **kw1)
    for k in ("rgb", "weights"):
        torch.testing.assert_close(got[k], ref[k], atol=2e-3, rtol=0, msg=k)
    _assert_grads_close(_bundle_names(small), grads, rgrads, R)
    assert (K.fused_paper_render.launches, K.fused_paper_mlp_forward.launches,
            K.fused_paper_mlp_backward.launches, T.fused_train_pass.launches) == (
        launches[0] + 2, launches[1] + 1, launches[2] + 2, launches[3] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("L", [11, 20])
@pytest.mark.parametrize("R,S", [(512, 64), (77, 128), (301, 24), (40, 256)], ids=["s64", "s128", "s24", "s256"])
def test_paper_kernels_take_11_and_20_bands(cuda_device, small, L, R, S):
    """K2, K3f, K3b and K1 at the band counts where the K = 128 encoding
    starts and ends, at the fixed layout classes' S (which run the runtime
    class past 10 bands) and at runtime ones, against their plain versions."""
    _check_paper_kernels_at(cuda_device, small, L, R, S, seed=L + S)


# ray counts past one round of the grid (132 CTAs, or 66 two-CTA clusters
# for K2, × 2 items), each ragged, at 16 bands
PE16_PERSISTENT_CASES = [(2085, 64), (601, 128), (2200, 24), (601, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("R,S", PE16_PERSISTENT_CASES, ids=["s64", "s128", "s24", "s192"])
def test_paper_kernels_persistent_grid_at_16_bands(cuda_device, small, R, S):
    """K2 and K1 (and K3f / K3b) at 16 bands on a pass past one round of
    their persistent grids: the one 16 KB xin buffer a warpgroup carries
    the encoders round after round."""
    from nerface_tpu_torch.ops.kernels import fused_train as T

    _, ctas = T.workspace_geometry(R, S)
    assert ctas == T.K1_CTAS and R > 2 * T.K1_CTAS * T.unit_layout(S)[0]
    _check_paper_kernels_at(cuda_device, small, 16, R, S, seed=R + S)


# ... and at 21..31 bands (a K = 192 encoding: three 64-column blocks, the
# ring one stage shorter), the same checks, at the band counts where that
# extent starts and ends and at synth512_pe24's 24; then ray counts past
# one round of the grid, each ragged, at 24 bands: K1 and K3b bit-identical
# over two launches there too.
@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("L", [21, 24, 31])
@pytest.mark.parametrize("R,S", [(512, 64), (77, 128), (301, 24), (40, 320)], ids=["s64", "s128", "s24", "s320"])
def test_paper_kernels_take_21_to_31_bands(cuda_device, small, L, R, S):
    """K2, K3f, K3b and K1 at 21, 24 and 31 bands, at the fixed layout
    classes' S (which run the runtime class past 10 bands), at runtime ones
    and past 256 (a long item), against their plain versions."""
    _check_paper_kernels_at(cuda_device, small, L, R, S, seed=L + S)


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("R,S", PE16_PERSISTENT_CASES, ids=["s64", "s128", "s24", "s192"])
def test_paper_kernels_persistent_grid_at_24_bands(cuda_device, small, R, S):
    """K2 and K1 (and K3f / K3b) at 24 bands on a pass past one round of
    their persistent grids: the one 24 KB xin buffer a warpgroup, in the
    ring's last stage and the xin array, carries the encoders round after
    round while the ring runs one stage short; K1 and K3b bit-identical
    over two launches."""
    from nerface_tpu_torch.ops.kernels import fused_train as T

    _, ctas = T.workspace_geometry(R, S)
    assert ctas == T.K1_CTAS and R > 2 * T.K1_CTAS * T.unit_layout(S)[0]
    _check_paper_kernels_at(cuda_device, small, 24, R, S, seed=R + S + 24)


@pytest.mark.cuda
def test_paper_entry_points_take_1_to_20_bands(cuda_device):
    """The C entry points of K2, K3f, K3b and K1, in every build, return
    cudaErrorInvalidValue (1) for n_freqs outside 1..31 (1..20 before the
    three-block xin image) before they read a pointer, and the workspace
    sizes are -1 there; at 11 and 20 the workspace is larger than at 10 by
    xin's 64 more columns (and dW's partial rows' 2·64 more rows of W0 /
    W3), at 21 and 31 by 128 more. Nothing is launched."""
    import ctypes

    from nerface_tpu_torch.ops.kernels.build import SAMPLE_CLASS_DEFINES, load_library

    null = ctypes.c_void_p(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda_device).cuda_stream)
    k2 = load_library("fused_paper_render")
    f0 = ctypes.c_float(0.0)
    for L in (0, -1, 32, 64):
        assert k2.nerface_fused_paper_render(*[null] * 13, 8, 64, L, 0, 0, stream) == 1, L
    for defines in SAMPLE_CLASS_DEFINES.values():
        k1 = load_library("fused_train_pass", defines)
        k3 = load_library("fused_paper_mlp", defines)
        for L in (0, -1, 32, 64):
            assert k1.nerface_fused_train_pass(*[null] * 17, 8, 64, L, 0, 0, f0, f0, f0, stream) == 1, L
            assert k3.nerface_fused_paper_mlp_fwd(*[null] * 7, 8, 64, L, 0, stream) == 1, L
            assert k3.nerface_fused_paper_mlp_bwd(*[null] * 12, 8, 64, L, 0, stream) == 1, L
            assert k1.nerface_fused_train_workspace_bytes(2048, 64, L) == -1, L
            assert k3.nerface_fused_paper_mlp_workspace_bytes(2048, 64, L) == -1, L
        for lib, fn in ((k1, "nerface_fused_train_workspace_bytes"), (k3, "nerface_fused_paper_mlp_workspace_bytes")):
            ws = {L: getattr(lib, fn)(2048, 64, L) for L in (1, 10, 11, 20, 21, 31)}
            assert ws[1] == ws[10] and ws[11] == ws[20] and ws[21] == ws[31], ws
            units = 2048  # one ray in one unit at S = 64
            assert ws[11] - ws[10] >= units * 64 * 128 + 7 * 2 * 64 * 256 * 4 - 256 * 2, ws
            assert ws[21] - ws[11] >= units * 64 * 128 + 7 * 2 * 64 * 256 * 4 - 256 * 2, ws
    torch.cuda.synchronize()


# Long items: S past 256, one ray in ⌈S / 64⌉ units (K2 composites it in
# segments of 256 rows, K1 / K3b keep its rows in a workspace slab), at 10
# and 16 bands, both models: a fifth unit of one row (257), five whole
# units (320), two whole K2 segments (512), the limit, 24 padding rows
# (1000); odd ray counts leave the last pair's second warpgroup past the
# last ray, and 601 rays run past one round of the 132-CTA grid.
LONG_CASES = [(77, 257), (301, 320), (40, 512), (8, 1024), (301, 1000), (601, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("L", [10, 16])
@pytest.mark.parametrize("R,S", LONG_CASES, ids=[f"{R}x{S}" for R, S in LONG_CASES])
def test_paper_kernels_take_long_rays(cuda_device, small, L, R, S):
    """K2, K3f, K3b and K1 past 256 samples a ray against their plain
    versions, K1 / K3b bit-identical over 2 launches."""
    _check_paper_kernels_at(cuda_device, small, L, R, S, seed=L + S + R)


@pytest.mark.cuda
def test_paper_entry_points_take_the_new_limit(cuda_device):
    """The C entry points of K2, K3f, K3b and K1, in every build, return
    cudaErrorInvalidValue (1) for S outside 1..1024 before they read a
    pointer; the workspace is `fused_train.workspace_layout`'s bytes, the
    long items' slab included past 256. Nothing is launched."""
    import ctypes

    from nerface_tpu_torch.ops.kernels import fused_train as T
    from nerface_tpu_torch.ops.kernels.build import SAMPLE_CLASS_DEFINES, load_library

    null = ctypes.c_void_p(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda_device).cuda_stream)
    k2 = load_library("fused_paper_render")
    f0 = ctypes.c_float(0.0)
    for S in (0, -1, K.MAX_SAMPLES + 1, 2048):
        assert k2.nerface_fused_paper_render(*[null] * 13, 8, S, 10, 0, 0, stream) == 1, S
    for defines in SAMPLE_CLASS_DEFINES.values():
        k1 = load_library("fused_train_pass", defines)
        k3 = load_library("fused_paper_mlp", defines)
        for S in (0, -1, K.MAX_SAMPLES + 1, 2048):
            assert k1.nerface_fused_train_pass(*[null] * 17, 8, S, 10, 0, 0, f0, f0, f0, stream) == 1, S
            assert k3.nerface_fused_paper_mlp_fwd(*[null] * 7, 8, S, 10, 0, stream) == 1, S
            assert k3.nerface_fused_paper_mlp_bwd(*[null] * 12, 8, S, 10, 0, stream) == 1, S
        for R, S, L in ((2048, 64, 10), (301, 200, 10), (2048, 320, 10), (2048, 1024, 16), (77, 1000, 10)):
            want = T.workspace_layout(R, S, K.xin_extent(L))["total"]
            assert k1.nerface_fused_train_workspace_bytes(R, S, L) == want, (R, S, L)
            assert k3.nerface_fused_paper_mlp_workspace_bytes(R, S, L) == want, (R, S, L)
    torch.cuda.synchronize()


# -- K4f and K4b's persistent grid (csrc/fused_flex.cu) ----------------------
# The same ragged ray counts past one round of the 132-CTA grid, at 0, 3 and
# 8 hidden layers: the chunk sequences and the workspace follow n. At 8
# the outputs and gradients are held to `flex_limit` / `flex_grad_limits`
# (chip_smoke.py): no less than FLEX_TC_FACTOR × what the plain version
# reads on the tensor cores.


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 3, 8])
@pytest.mark.parametrize("R,S", FLEX_PERSISTENT_CASES, ids=["s64", "s128", "s32", "s24", "s200"])
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
    _assert_flex_close(out, flat, args, g, R, S, n)


# warpgroup 1's last item past the last ray, the fixed layouts and two runtime ones
DEAD_UNIT_CASES = [(2085, 64), (601, 128), (2133, 24), (267, 200)]
DEAD_UNIT_PASSES = 50


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", DEAD_UNIT_CASES, ids=["s64", "s128", "s24", "s200"])
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
@pytest.mark.parametrize("R,S", [(1, 32), (1, 64), (1, 128), (3, 32), (1, 24), (5, 5), (1, 255)],
                         ids=["half-unit", "one-unit", "one-ray-two-units", "ragged-item",
                              "s24-one-ray", "s5-five-rays", "s255"])
def test_flex_kernels_passes_below_one_round(cuda_device, R, S):
    """Passes smaller than one unit or item: one CTA, a dead warpgroup,
    rows past the last ray inside a live unit (S = 32, and at runtime
    layouts: one ray of an 8-ray item at S = 24, 5 of 51 at S = 5, one
    ray in 4 units with one padding row at S = 255)."""
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
    _assert_flex_close(out, flat, args, g, R, S, 3)


# -- K3: fused_paper_mlp_forward / fused_paper_mlp_backward -------------------
# chip_smoke.py's tolerances: raw rgb and σ each within K3_OUT_TOL of their
# max|plain|; each gradient tensor within `k1_grad_limits`.


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("R,S", [(512, 64), (77, 128), (301, 32), (512, 16), (301, 24), (77, 96),
                                 (64, 192), (40, 256), (530, 1), (301, 5), (301, 40), (77, 200)],
                         ids=["coarse", "fine-ragged", "s32-ragged", "s16", "s24-ragged",
                              "s96-ragged", "s192", "s256", "s1", "s5-ragged", "s40-ragged",
                              "s200-ragged"])
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
    tc = _yardstick(S) and tensor_core_plain(lambda: K.fused_paper_mlp_reference(*args, small=small))
    assert out.shape == (R, S, 4) and torch.isfinite(out).all()
    for sl in (slice(0, 3), slice(3, 4)):
        tol = tc_limit(K3_OUT_TOL, rel_err(tc[..., sl], ref[..., sl])[0] if tc is not False else 0.0)
        torch.testing.assert_close(out[..., sl], ref[..., sl],
                                   atol=tol * float(ref[..., sl].abs().max()), rtol=0)
    rgrads = K.fused_paper_mlp_backward_reference(*args, g, small=small)
    tc_grads = _yardstick(S) and tensor_core_plain(
        lambda: K.fused_paper_mlp_backward_reference(*args, g, small=small))
    _assert_grads_close(_bundle_names(small), grads, rgrads, R, tc_grads or None)


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
        K.fused_paper_mlp_forward(bundle, ro, rd, _past_the_limit(z))
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
     (301, 128, 128, "general", False), (300, 128, 100, "sorted_u", False),
     (301, 3, 56, "general", False), (77, 24, 200, "general", False), (300, 24, 200, "sorted_u", False),
     (2085, 200, 56, "general", False), (300, 200, 56, "sorted_u", True), (77, 48, 33, "general", True)],
    ids=["general", "sorted_u", "sorted_u-spike", "ragged-32", "128+128", "128+100", "3+56", "24+200",
         "24+200-sorted_u", "200+56", "200+56-sorted_u-spike", "48+33-spike"],
)
def test_resample_kernel_matches_plain(cuda_device, R, Sc, Sf, regime, spike):
    """K5 against its plain version (the pipeline's sample_pdf +
    merge_sorted_zvals) within chip_smoke's RESAMPLE_TOL·far, rows sorted,
    bit-identical over two launches; a ragged last CTA (77 rays) and a
    non-power-of-two Sf in both regimes; Sc padded to its class (3 and 24
    to 32, 48 to 64, 200 to 256) and 8 draws a lane (Sf = 200)."""
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
        K5.fused_resample(z[:, :2].contiguous(), w[:, :2].contiguous(), u)
    with pytest.raises(ValueError, match="fine samples"):
        K5.fused_resample(z, w, torch.rand(64, 961, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        K5.fused_resample(z.t().contiguous().t(), w, u)
    with pytest.raises(TypeError, match="float32"):
        K5.fused_resample(z, w.double(), u)
    with pytest.raises(ValueError, match="u is on"):
        K5.fused_resample(z, w, u.cpu())
    assert K5.fused_resample.launches == before


@pytest.mark.cuda
def test_resample_entry_point_refuses_what_the_kernel_does_not_take(cuda_device):
    """K5's C entry point returns cudaErrorInvalidValue (1) outside 3 ≤ Sc,
    1 ≤ Sf, Sc + Sf ≤ 1024 and launches nothing."""
    import ctypes

    from nerface_tpu_torch.ops.kernels.build import load_library

    lib = load_library("fused_resample")
    out = torch.zeros(4, 4, device=cuda_device)
    null = ctypes.c_void_p(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda_device).cuda_stream)
    for sc, sf in ((2, 64), (0, 1), (64, 0), (64, 961), (1023, 2), (3, 1022)):
        for sorted_u in (0, 1):
            assert lib.nerface_fused_resample(null, null, null, 0, ctypes.c_void_p(out.data_ptr()), 4, sc, sf,
                                              sorted_u, stream) == 1, (sc, sf)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))



# K5's long regime (Sc + Sf past 256, up to 1024: a warp a ray, the rows in
# shared memory, a merge by rank): both regimes, per-ray and shared u, Sc
# classes 32 .. 1024, Sf up to 1021, ragged ray counts and one past a round
# of the persistent grid; the spike crowds the draws into one bin.
K5_LONG_CASES = [(2072, 64, 256, "general", False), (2072, 64, 256, "sorted_u", False),
                 (77, 128, 896, "general", False), (301, 3, 1021, "sorted_u", False),
                 (301, 3, 1021, "general", False), (301, 1000, 24, "general", False),
                 (77, 512, 512, "general", False), (300, 512, 512, "sorted_u", False),
                 (2085, 320, 1, "general", False), (301, 255, 2, "sorted_u", False),
                 (300, 64, 700, "shared", False), (2072, 64, 256, "general", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,Sc,Sf,draws,spike", K5_LONG_CASES,
                         ids=[f"{R}x{a}+{b}-{d}{'-spike' if sp else ''}" for R, a, b, d, sp in K5_LONG_CASES])
def test_resample_kernel_long_regime(cuda_device, R, Sc, Sf, draws, spike):
    """K5 past Sc + Sf = 256 against its plain version within
    RESAMPLE_TOL·far, rows sorted, bit-identical over two launches, each
    launch counted."""
    from nerface_tpu_torch.ops.kernels import fused_resample as K5
    from nerface_tpu_torch.ops.math import linspace01

    z, w, u = resample_inputs(R, Sc, Sf, R + Sc + Sf, cuda_device, RESAMPLE_SPIKE if spike else 0.0)
    sorted_u = draws == "sorted_u"
    if sorted_u:
        u = linspace01(Sf, device=cuda_device)
    elif draws == "shared":
        u = u[0].contiguous()
    before = K5.fused_resample.launches
    got = K5.fused_resample(z, w, u, sorted_u=sorted_u)
    again = K5.fused_resample(z, w, u, sorted_u=sorted_u)
    torch.cuda.synchronize()
    assert K5.fused_resample.launches == before + 2
    assert torch.equal(got, again) and got.shape == (R, Sc + Sf)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    ref = K5.fused_resample_reference(z, w, u, sorted_u)
    torch.testing.assert_close(got, ref, atol=RESAMPLE_TOL * FAR, rtol=0)


# K4f / K4b past 256 samples a ray: one ray an item in ⌈S / 64⌉ units, at
# both widths and at 10 and 16 bands; a fifth unit of one row (257), five
# whole units (320), the limit, 24 padding rows (1000); at h = 256 an odd
# ray count leaves the last round's warpgroup-1 item, a long one, past the
# last ray (the dead-unit walk), and 601 rays run past one round of the
# 132-CTA grid.
FLEX_LONG_CASES = [(77, 257), (301, 320), (40, 512), (8, 1024), (301, 1000), (601, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("h", [256, 512])
@pytest.mark.parametrize("L", [10, 16])
@pytest.mark.parametrize("R,S", FLEX_LONG_CASES, ids=[f"{R}x{S}" for R, S in FLEX_LONG_CASES])
def test_flex_kernels_take_long_rays(cuda_device, h, L, R, S):
    """K4f and K4b past 256 samples a ray against their plain versions
    (the tensor-core yardstick), K4b bit-identical over 2 launches."""
    _check_flex_kernels_at(cuda_device, h, L, R, S, seed=R + S + h + L)


@pytest.mark.cuda
def test_flex_long_dead_unit_repeats_bit_for_bit(cuda_device):
    """2071 rays × S = 320 at 8 hidden layers, h = 256: the last round's
    warpgroup-1 item is a dead long item of five units, which K4b's
    recompute and dX walk with `skip_stages`; 20 passes of K4f + K4b each
    equal the first bit for bit."""
    from nerface_tpu_torch.ops.kernels import fused_flex as F

    R, S, n = 2071, 320, 8
    assert sum(not ok for *_, ok in F.unit_schedule(R, S)) == 5
    params, v0 = flex_params(R + n, cuda_device, n_hidden=n)
    ro, rd, z, dc, _, _ = _inputs(R, S, cuda_device, seed=R + S + n)
    weights = F.pack_flex_weights(params, n, 10)
    g = torch.randn(R, S, 4, generator=torch.Generator().manual_seed(S + n)).to(cuda_device)
    args = (weights, ro, rd, z, dc, v0)
    first = None
    for _ in range(20):
        out = F.fused_flex_forward(*args, n)
        grads = F.fused_flex_backward(*args, g, n)
        flat = [out] + list(grads[0]) + list(grads[1:])
        if first is None:
            first = flat
        else:
            assert all(torch.equal(a, b) for a, b in zip(first, flat))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in first)


@pytest.mark.cuda
def test_flex_entry_points_take_the_new_limit(cuda_device):
    """K4f's and K4b's C entry points, in both builds and at both widths,
    return cudaErrorInvalidValue (1) past 1024 before they read a pointer,
    and take 1024: the workspace is `fused_flex.workspace_layout`'s bytes
    at 2048 × 1024 (past 2^31 at either width) and at 2071 × 320. Nothing
    is launched."""
    import ctypes

    from nerface_tpu_torch.ops.kernels import fused_flex as F
    from nerface_tpu_torch.ops.kernels.build import SAMPLE_CLASS_DEFINES, load_library
    from nerface_tpu_torch.ops.kernels.fused_mlp import xin_extent

    out = torch.zeros(8, 4, device=cuda_device)
    null = ctypes.c_void_p(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda_device).cuda_stream)
    for defines in SAMPLE_CLASS_DEFINES.values():
        lib = load_library("fused_flex", defines)
        for h in (256, 512):
            for S in (F.MAX_SAMPLES + 1, 2048):
                assert lib.nerface_fused_flex_fwd(null, null, null, null, null, null, ctypes.c_void_p(out.data_ptr()),
                                                  8, S, 10, 3, h, stream) == 1, S
                assert lib.nerface_fused_flex_workspace_bytes(8, S, 10, 3, h) == -1, S
            for R, S, L in ((2048, F.MAX_SAMPLES, 10), (2048, F.MAX_SAMPLES, 16), (2071, 320, 10)):
                want = F.workspace_layout(R, S, 3, h, xin_extent(L))[1]
                assert lib.nerface_fused_flex_workspace_bytes(R, S, L, 3, h) == want, (R, S, L, h)
                assert R < 2048 or want > 2 ** 31
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))

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



@pytest.mark.cuda
def test_gloo_dp_step_on_one_card(cuda_device, window_dataset, tmp_path):
    """The DP step at world 2 over gloo with both ranks on the card (NCCL
    refuses two ranks on one GPU): one bf16 step of the paper model through
    K1 on each rank's half of a global batch of 2 × WINDOW_RAYS rays. The
    ranks' parameters and Adam moments are bit for bit the same, and the
    averaged gradients (Adam's first moments) are within `_k1_dp_limits`
    of the one-process step's on the whole batch."""
    import numpy as np

    from chip_smoke import SYNTH512_PAPER, _fresh_state, _k1_dp_limits
    from nerface_tpu_torch.config import FeatureFlags
    from nerface_tpu_torch.data.pipeline import RayFeed, batch_to_device
    from nerface_tpu_torch.render.pipeline import RenderSettings
    from nerface_tpu_torch.train import dryrun
    from nerface_tpu_torch.train.loop import setup_background

    cfg = _window_cfg(SYNTH512_PAPER, 1, False, str(tmp_path))
    ds = window_dataset
    flags = FeatureFlags.from_cfg(cfg)
    bg = setup_background(ds, flags)
    batch = RayFeed(ds, 2 * WINDOW_RAYS, background=bg if flags.fixed_background else None,
                    seed=3, native=False).sample_batch()
    payload = {"state": _fresh_state(cfg, ds, "cpu"),
               "opt_cfg": {"optimizer": dict(cfg.optimizer), "scheduler": dict(cfg.scheduler)},
               "batch": batch_to_device(batch, "cpu"),
               "settings": RenderSettings.from_cfg(cfg, "train"), "flags": flags, "seed": 3,
               "dtype": torch.bfloat16, "fused": True, "device": str(cuda_device)}
    one = dryrun.dp_step(payload)
    ranks = dryrun.dryrun(payload, 2, init_method=f"file://{tmp_path}/rendezvous", timeout=300)
    a, b = ranks[0]["arrays"], ranks[1]["arrays"]
    assert a.keys() == b.keys() == one["arrays"].keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    seen = 0
    for k, g1 in one["arrays"].items():
        if k.startswith("exp_avg/"):
            lim_max, lim_norm = _k1_dp_limits(k, 2 * WINDOW_RAYS)
            d = a[k] - g1
            assert np.abs(d).max() <= lim_max * np.abs(g1).max(), k
            assert np.linalg.norm(d) <= lim_norm * np.linalg.norm(g1), k
            seen += 1
    assert seen >= 40
