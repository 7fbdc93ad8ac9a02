"""PyTorch port, K4 fused Flexible MLP (`nerface_tpu_torch/ops/kernels/fused_flex.py`).

* The plain forward and backward in bf16 against the JAX package's Pallas
  kernels `_fused_flex_fwd` / `_fused_flex_bwd`, run in interpret mode on
  the CPU as tests/test_pallas.py runs them (R = 8, S = 16, h = 256, two
  sequential grid steps in the backward), for the LearnableCode,
  Blendshape and Flexible classes, with each class's own v0 fold and
  direction contribution. Raw [rgb, σ] atol 2e-3·max|JAX| (readings
  ≤ 1.0e-3 over 10 draws of each class). Each gradient, d_v0 and d_dir
  included: max error 0.08·max|JAX| and norm error 0.04·‖JAX‖. Both round
  the same operands to bf16 at the same points, but their f32 sums run in
  another order, and at 128 sample rows one flipped relu mask or bf16
  rounding of an activation moves a whole row's outer product in a
  weight gradient whose terms cancel: over 10 draws of each class the
  readings reach 4.6e-2·max and 2.5e-2·‖·‖ (4.4e-2 and 9.2e-3 on the
  draws below, the Blendshape class's wh1 / w1b); on a draw without a flip
  every tensor agrees within 2e-3·max plus one bf16 ulp of the matrix
  gradients, which both VJPs return in bf16 (`fused_flex.py:297-299`), and
  the interpreter itself departs from its own formula run by JAX outside
  it by as much as the port does (up to 2.5e-2·‖·‖ on w1a).
* The plain backward in f32 against torch autograd of the f32 forward:
  atol 1e-5·max + 1e-12 (f32 sums in another order).
* `FusedFlexMLP` hands the backward's gradients to the params (matrix
  gradients bf16-representable), v0 and dir_contrib; the wrappers on CPU
  tensors are the plain versions; the packed layouts match the .cu file;
  `flex_fused_eligible` takes what the kernel takes (any S up to 256,
  on the card where the JAX package's tile rule sends the pass to Pallas).

The CUDA kernels themselves are tested in tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.models.mlp import cond_contribution as jax_cond_contribution
from nerface_tpu.models.mlp import linear_cols as jax_linear_cols
from nerface_tpu.ops.encoding import _encoding_matrix
from nerface_tpu.ops.pallas import fused_flex as JF
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.ops.kernels import fused_flex as F
from nerface_tpu_torch.ops.kernels.fused_mlp import K_XIN
from nerface_tpu_torch.render.pipeline import EncodeSpec
from nerface_tpu_torch.train.checkpoint import params_from_jax

torch.set_num_threads(1)

CU = pathlib.Path(F.__file__).resolve().parents[2] / "csrc" / "fused_flex.cu"
R, S, H, NH = 8, 16, 256, 3
KW = dict(num_layers=4, hidden_size=256, skip_connect_every=3, num_encoding_fn_xyz=10,
          num_encoding_fn_dir=4)
CLASSES = ["ConditionalBlendshapeLearnableCodeNeRFModel", "ConditionalBlendshapeNeRFModel",
           "FlexibleNeRFModel"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(
        ro=(rng.randn(R, 3) * 0.1).astype(f), rd=rng.randn(R, 3).astype(f),
        z=np.cumsum(rng.rand(R, S) * 0.05, -1).astype(f),
        pe_dir=rng.randn(R, 24).astype(f), expr=(rng.randn(76) * 0.1).astype(f),
        latent=(rng.randn(32) * 0.1).astype(f), g=rng.randn(R, S, 4).astype(f),
    )


def _jax_fold(jm, jp, x):
    """The JAX pipeline's v0 (1, h) and dir_contrib (R, h/2) for this model
    (`nerface_tpu/render/pipeline.py:294-309`)."""
    e = jnp.asarray(x["expr"]) if jm.takes_expression else None
    l = jnp.asarray(x["latent"]) if jm.takes_latent else None
    e, l = jm._prepare(jp, e, l, None)
    v0 = jp["layer1.bias"]
    segs = jm._cond_segments_layer1(e, l)
    if segs:
        v0 = v0 + jax_cond_contribution(jp, "layer1", segs, jm.dim_xyz)
    dc = jax_linear_cols(jp, "layers_dir.0", jnp.asarray(x["pe_dir"]), H, H + 24)
    return np.asarray(v0)[None, :], np.asarray(dc)


def _jax_weights(jp):
    """`fused_flex_mlp`'s weight tuple (`fused_flex.py:344-356`)."""
    def w(n):
        return jp[n + ".weight"]

    def b(n):
        return jp[n + ".bias"][None, :]

    mats = [w("layer1")[:, :3].T, w("layer1")[:, 3:63].T]
    mats += [w(f"layers_xyz.{i}").T for i in range(NH)]
    mats += [w("fc_feat").T, w("fc_alpha").T, w("layers_dir.0")[:, :H].T, w("fc_rgb").T]
    biases = [b(f"layers_xyz.{i}") for i in range(NH)]
    biases += [b("fc_feat"), b("fc_alpha"), b("layers_dir.0"), b("fc_rgb")]
    return tuple(m.astype(jnp.bfloat16) for m in mats) + tuple(biases)


def _case(name):
    jm = JAX_MODELS[name](**KW)
    jp = jm.init(jax.random.PRNGKey(2))
    x = _inputs(seed=len(name))
    v0, dc = _jax_fold(jm, jp, x)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    targs = (F.pack_flex_weights(tp, NH, 10), _t(x["ro"]), _t(x["rd"]), _t(x["z"]), _t(dc),
             _t(v0))
    return jp, x, v0, dc, targs


def _pairs(port, jax_grads):
    """[(name, port gradient, JAX gradient as f32 numpy)]: the weights',
    then d_v0 and d_dir."""
    grads, d_v0, d_dir = port
    wn, bn = F.weight_names(NH)
    out = []
    for n, a, b in zip(wn + bn + ("v0", "dir"), grads + (d_v0, d_dir), jax_grads):
        b = np.asarray(b.astype(jnp.float32))
        assert a.dtype == (torch.bfloat16 if n in wn else torch.float32), n
        assert tuple(a.shape) == b.shape, n
        out.append((n, a.float().numpy(), b))
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_plain_matches_jax_kernel(name):
    jp, x, v0, dc, targs = _case(name)
    C, phase = _encoding_matrix(3, 10, True)
    args = tuple(jnp.asarray(a) for a in (x["ro"], x["rd"], x["z"], dc, v0, C, phase[None, :]))
    out, res = JF._fused_flex_fwd(S, 4, NH, H, *args, *_jax_weights(jp))
    jgrads = JF._fused_flex_bwd(S, 4, NH, H, res, jnp.asarray(x["g"]))
    got = F.fused_flex_forward_reference(*targs, NH)
    out = np.asarray(out)
    assert got.shape == out.shape == (R, S, 4)
    np.testing.assert_allclose(got.numpy(), out, atol=2e-3 * np.abs(out).max(), rtol=0)
    port = F.fused_flex_backward_reference(*targs, _t(x["g"]), NH)
    for n, a, b in _pairs(port, jgrads[7:] + (jgrads[4], jgrads[3])):
        assert np.abs(a - b).max() <= 0.08 * np.abs(b).max() + 1e-9, n
        assert np.linalg.norm(a - b) <= 0.04 * np.linalg.norm(b) + 1e-9, n


def test_pipeline_fold_matches_jax_fused_flex_mlp():
    """The port's `_flex_pass` (v0 fold after `_prepare`, direction
    contribution, packing) through the plain version against JAX
    `fused_flex_mlp` run in interpret mode, for the compressed-expression
    LearnableCode class whose `_prepare` runs a layer: atol 2e-3·max."""
    from nerface_tpu.ops.pallas.fused_flex import fused_flex_mlp as jax_fused_flex_mlp
    from nerface_tpu_torch.render.pipeline import _flex_pass

    name = "ConditionalCompressedBlendshapeLearnableCodeNeRFModel"
    jm = JAX_MODELS[name](**KW)
    jp = jm.init(jax.random.PRNGKey(4))
    x = _inputs(seed=3)
    v0, dc = _jax_fold(jm, jp, x)
    ref = np.asarray(jax_fused_flex_mlp(
        jp, jnp.asarray(x["ro"]), jnp.asarray(x["rd"]), jnp.asarray(x["z"]), jnp.asarray(dc),
        jnp.asarray(v0), n_hidden=NH, hidden_size=H, num_encoding_fn_xyz=10, rays_per_tile=4,
    ))
    tm = MODELS[name](**KW)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}), strict=True)
    got = _flex_pass(tm, _t(x["ro"]), _t(x["rd"]), _t(x["z"]), EncodeSpec(10, True, True),
                     _t(x["pe_dir"]), _t(x["expr"]), _t(x["latent"]))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=2e-3 * np.abs(ref).max(), rtol=0)


def _f32_weights(seed):
    rng = np.random.RandomState(seed)
    wn, bn = F.weight_names(NH)
    shapes = {"w1a": (3, H), "w1b": (60, H), "wa": (H, 1), "wd0": (H, 128), "wrgb": (128, 3)}
    out = []
    for n in wn:
        shp = shapes.get(n, (H, H))
        out.append(torch.from_numpy((rng.randn(*shp) * np.sqrt(2.0 / shp[0])).astype(np.float32)))
    widths = {"ba": 1, "bd0": 128, "brgb": 3}
    for n in bn:
        out.append(torch.from_numpy((rng.randn(1, widths.get(n, H)) * 0.1).astype(np.float32)))
    return out


def test_f32_plain_backward_equals_autograd():
    x = _inputs(seed=9)
    weights = [w.requires_grad_(True) for w in _f32_weights(1)]
    rng = np.random.RandomState(2)
    dc = _t((rng.randn(R, 128) * 0.3).astype(np.float32)).requires_grad_(True)
    v0 = _t((rng.randn(1, H) * 0.3).astype(np.float32)).requires_grad_(True)
    ro, rd, z, g = (_t(x[k]) for k in ("ro", "rd", "z", "g"))
    W = dict(zip(sum(F.weight_names(NH), ()), weights))
    rgb, alpha, *_ = F._forward_reference(W, ro, rd, z, dc, v0, NH, 10, True, torch.float32)
    torch.sum(torch.cat([rgb, alpha], -1).reshape(R, S, 4) * g).backward()
    grads, d_v0, d_dir = F.fused_flex_backward_reference(weights, ro, rd, z, dc, v0, g, NH,
                                                         mm_dtype=torch.float32)
    names = sum(F.weight_names(NH), ()) + ("v0", "dir")
    for n, a, leaf in zip(names, grads + (d_v0, d_dir), weights + [v0, dc]):
        scale = float(leaf.grad.abs().max())
        torch.testing.assert_close(a, leaf.grad, atol=1e-5 * scale + 1e-12, rtol=0, msg=n)


def test_autograd_function_hands_out_the_backward():
    name = "ConditionalBlendshapeLearnableCodeNeRFModel"
    m = MODELS[name](**KW, generator=torch.Generator().manual_seed(0))
    params = dict(m.named_parameters())
    x = _inputs(seed=5)
    rng = np.random.RandomState(6)
    dc = _t((rng.randn(R, 128) * 0.3).astype(np.float32)).requires_grad_(True)
    v0 = _t((rng.randn(1, H) * 0.3).astype(np.float32)).requires_grad_(True)
    ro, rd, z, g = (_t(x[k]) for k in ("ro", "rd", "z", "g"))
    before = (F.fused_flex_forward.launches, F.fused_flex_backward.launches)
    out = F.fused_flex_mlp(params, ro, rd, z, dc, v0, n_hidden=NH, num_encoding_fn_xyz=10)
    weights = F.pack_flex_weights({k: v.detach() for k, v in params.items()}, NH, 10)
    torch.testing.assert_close(out.detach(), F.fused_flex_forward_reference(
        weights, ro, rd, z, dc, v0, NH), atol=0, rtol=0)
    torch.sum(out * g).backward()
    assert (F.fused_flex_forward.launches, F.fused_flex_backward.launches) == before
    grads, d_v0, d_dir = F.fused_flex_backward_reference(weights, ro, rd, z, dc, v0, g, NH)
    gw = dict(zip(sum(F.weight_names(NH), ()), grads))
    torch.testing.assert_close(v0.grad, d_v0, atol=0, rtol=0)
    torch.testing.assert_close(dc.grad, d_dir, atol=0, rtol=0)
    l1 = m.layer1.weight.grad
    torch.testing.assert_close(l1[:, :3], gw["w1a"].float().T, atol=0, rtol=0)
    torch.testing.assert_close(l1[:, 3:63], gw["w1b"].float().T, atol=0, rtol=0)
    assert float(l1[:, 63:].abs().max()) == 0.0  # the conditioning enters through v0
    assert m.layer1.bias.grad is None
    for i in range(NH):
        torch.testing.assert_close(m.layers_xyz[i].weight.grad, gw[f"wh{i}"].float().T,
                                   atol=0, rtol=0)
        torch.testing.assert_close(m.layers_xyz[i].bias.grad, gw[f"bh{i}"][0], atol=0, rtol=0)
    d0 = m.layers_dir[0].weight.grad
    torch.testing.assert_close(d0[:, :H], gw["wd0"].float().T, atol=0, rtol=0)
    for mod, wname, bname in ((m.fc_feat, "wf", "bf"), (m.fc_alpha, "wa", "ba"),
                              (m.fc_rgb, "wrgb", "brgb")):
        torch.testing.assert_close(mod.weight.grad, gw[wname].float().T, atol=0, rtol=0)
        torch.testing.assert_close(mod.bias.grad, gw[bname][0], atol=0, rtol=0)
        # the matrix gradients leave the VJP in the weights' bf16
        assert torch.equal(mod.weight.grad, mod.weight.grad.to(torch.bfloat16).float())


def test_wrappers_on_cpu_are_the_plain_versions():
    x = _inputs(seed=7)
    weights = F.pack_flex_weights(
        {k: v.detach() for k, v in MODELS["FlexibleNeRFModel"](**KW).named_parameters()}, NH, 10)
    rng = np.random.RandomState(8)
    dc = _t((rng.randn(R, 128) * 0.3).astype(np.float32))
    v0 = _t((rng.randn(1, H) * 0.3).astype(np.float32))
    args = (weights, _t(x["ro"]), _t(x["rd"]), _t(x["z"]), dc, v0)
    before = (F.fused_flex_forward.launches, F.fused_flex_backward.launches)
    assert torch.equal(F.fused_flex_forward(*args, NH), F.fused_flex_forward_reference(*args, NH))
    a = F.fused_flex_backward(*args, _t(x["g"]), NH)
    b = F.fused_flex_backward_reference(*args, _t(x["g"]), NH)
    assert all(torch.equal(p, q) for p, q in zip(a[0] + a[1:], b[0] + b[1:]))
    assert (F.fused_flex_forward.launches, F.fused_flex_backward.launches) == before
    meta = [torch.empty(t.shape, device="meta") for t in args[1:]]
    with pytest.raises(ValueError, match="cuda or cpu"):
        F.fused_flex_forward(weights, *meta, NH)
    with pytest.raises(ValueError, match="expected"):
        F.fused_flex_forward(weights[:-1], *args[1:], NH)


def cuda_offsets(src, h):
    """`Offsets<h>`'s constants as written in csrc/fused_flex.cu."""
    block = src[src.index(f"struct Offsets<{h}> {{"):]
    block = block[:block.index("};")]
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"static constexpr int (F[WFT]_OFF_\w+) = (\d+);", block)}


def test_offsets_match_cuda_source():
    """`w_offsets` / `f_offsets` / `wt_offsets` at each width and depth
    equal csrc/fused_flex.cu's `Offsets<h>` and `flex_layout`'s rule (the
    WH_i, BH_i and WHT_i after them, h² or h apart, at any n), at the
    10-band extent K = 64 (tests/test_torch_flex_bands.py holds K = 128)."""
    src = CU.read_text()
    assert "MAX_HIDDEN" not in src and not hasattr(F, "MAX_HIDDEN")  # any depth
    for h in F.WIDTHS:
        c = cuda_offsets(src, h)
        hh, dh = h * h, h // 2
        for n in (0, 1, 3, 8, 9, 12):
            wa = c["FW_OFF_WH"] + n * hh
            want_w = {"W1": c["FW_OFF_W1"], "WF": c["FW_OFF_WF"], "WD0": c["FW_OFF_WD0"],
                      "WA": wa, "WRGB": wa + h, "TOTAL": wa + h + dh * 3}
            want_w.update({f"WH{i}": c["FW_OFF_WH"] + i * hh for i in range(n)})
            assert F.w_offsets(n, h) == want_w
            want_f = {k: c[f"FF_OFF_{k}"] for k in ("V0", "BF", "BD0", "BA", "BRGB", "FREQS")}
            want_f.update({f"BH{i}": c["FF_OFF_BH"] + i * h for i in range(n)})
            want_f["TOTAL"] = c["FF_OFF_BH"] + n * h
            assert F.f_offsets(n, h) == want_f
            want_t = {"WD0T": c["FT_OFF_WD0T"], "WFT": c["FT_OFF_WFT"],
                      "TOTAL": c["FT_OFF_WHT"] + n * hh}
            want_t.update({f"WHT{i}": c["FT_OFF_WHT"] + i * hh for i in range(n)})
            assert F.wt_offsets(n, h) == want_t
    layout = src[src.index("__host__ __device__ inline Layout flex_layout(int n, int kx) {"):]
    layout = layout[:layout.index("return L;")]
    for line in ("L.wh = flex_w_off<H>(OH::FW_OFF_WH, kx);", "L.wa = L.wh + n * H * H;", "L.wrgb = L.wa + H;",
                 "L.f_total = OH::FF_OFF_BH + n * H;", "L.part_cols = L.f_total + H + (H / 2) * 3;"):
        assert line in layout, line
    # the wgmma chain K2 shares, K1's operand images and dW, reduce_rows
    for header in ("wgmma_chain.cuh", "paper_train.cuh", "wgmma_dw.cuh", "grad_tile.cuh"):
        assert f'#include "{header}"' in src, header


def test_kernel_layouts_pack_and_unpack():
    """The weights land at `w_offsets` / `f_offsets` (W1 zero-padded to
    K = 64), the transposed buffer holds Wᵀ at `wt_offsets`, and gradients
    laid out in the kernel's f32 buffers come back by name."""
    weights = _f32_weights(3)
    names = sum(F.weight_names(NH), ())
    W = {k: (v.to(torch.bfloat16) if k.startswith("w") else v) for k, v in zip(names, weights)}
    v0 = torch.randn(1, H)
    freqs = torch.tensor([1.0, 2.0])
    wbuf, fbuf = F.pack_kernel_operands(W, v0, NH, freqs)
    wo, fo, to = F.w_offsets(NH), F.f_offsets(NH), F.wt_offsets(NH)
    assert wbuf.dtype == torch.bfloat16 and wbuf.numel() == wo["TOTAL"]
    assert fbuf.numel() == fo["TOTAL"]
    w1 = wbuf[:K_XIN * H].reshape(K_XIN, H)
    assert torch.equal(w1[:3], W["w1a"]) and torch.equal(w1[3:63], W["w1b"])
    assert float(w1[63:].float().abs().max()) == 0.0
    assert torch.equal(wbuf[wo["WH2"]:wo["WH2"] + H * H].reshape(H, H), W["wh2"])
    assert torch.equal(wbuf[wo["WRGB"]:].reshape(128, 3), W["wrgb"])
    assert torch.equal(fbuf[fo["V0"]:fo["V0"] + H], v0[0])
    assert torch.equal(fbuf[fo["FREQS"]:fo["FREQS"] + 2], freqs)
    assert torch.equal(fbuf[fo["BH1"]:fo["BH1"] + H], W["bh1"][0])
    wt = F.pack_transposed_weights(W, NH)
    assert wt.numel() == to["TOTAL"]
    assert torch.equal(wt[:to["WFT"]].reshape(128, H), W["wd0"].T)
    assert torch.equal(wt[to["WHT0"]:to["WHT1"]].reshape(H, H), W["wh0"].T)

    dw = torch.zeros(wo["TOTAL"])
    df = torch.zeros(fo["TOTAL"])
    rng = torch.Generator().manual_seed(0)
    gw = {k: torch.randn(v.shape, generator=rng) for k, v in W.items() if k.startswith("w")}
    gb = {k: torch.randn(v.shape, generator=rng) for k, v in W.items() if k.startswith("b")}
    d_v0 = torch.randn(1, H, generator=rng)
    pad = torch.zeros(K_XIN - 63, H)
    mats = {"W1": torch.cat([gw["w1a"], gw["w1b"], pad]), "WF": gw["wf"], "WD0": gw["wd0"],
            "WA": gw["wa"], "WRGB": gw["wrgb"]}
    mats.update({f"WH{i}": gw[f"wh{i}"] for i in range(NH)})
    for k, m in mats.items():
        dw[wo[k]:wo[k] + m.numel()] = m.reshape(-1)
    rows = {"V0": d_v0, "BF": gb["bf"], "BD0": gb["bd0"], "BA": gb["ba"], "BRGB": gb["brgb"]}
    rows.update({f"BH{i}": gb[f"bh{i}"] for i in range(NH)})
    for k, r in rows.items():
        df[fo[k]:fo[k] + r.numel()] = r.reshape(-1)
    uw, ub, uv0 = F._split_kernel_grads(dw, df, NH, 60)
    assert torch.equal(uv0, d_v0)
    for k in gw:
        assert torch.equal(uw[k], gw[k]), k
    for k in gb:
        assert torch.equal(ub[k], gb[k]), k


def test_eligibility():
    enc = EncodeSpec(10, True, True)
    pe_dir = torch.zeros(4, 24)

    def ok(name="ConditionalBlendshapeLearnableCodeNeRFModel", S=64, dev="cuda", enc=enc, R=2048,
           **kw):
        m = MODELS[name](**dict(KW, include_input_dir=False, **kw))
        return F.flex_fused_eligible(m, enc, pe_dir, R, S, dev)

    assert ok() and ok("FlexibleNeRFModel") and ok(S=128) and ok(S=16, dev="cpu")
    assert ok(S=16) and ok(S=192) and ok(S=1) and ok(S=256)  # the kernels take any S up to 1024
    assert ok(S=257) and ok(S=1024) and ok(S=1024, dev="cpu")
    assert not ok(S=1025) and not ok(S=1025, dev="cpu")
    assert not ok(R=2047) and ok(R=2047, dev="cpu")  # the JAX tile rule, on the card
    assert not ok(num_layers=6, skip_connect_every=3)  # a skip layer engages
    assert ok(num_layers=6, skip_connect_every=4)  # the would-be skip is the last layer
    assert not ok(use_viewdirs=False)
    assert ok(hidden_size=512) and ok(hidden_size=512, num_layers=13, skip_connect_every=13)  # h = 512, any depth
    assert ok(hidden_size=768) and ok(hidden_size=1024, num_layers=9, skip_connect_every=9)  # the sliced kernels
    assert not ok(hidden_size=1280)  # JAX admits it; the port's kernels take h up to 1024
    assert not ok(enc=EncodeSpec(10, False, True))
    assert not ok(num_encoding_fn_xyz=6)  # the model's width is not the encoding's
    assert not F.flex_fused_eligible(MODELS["ConditionalBlendshapePaperNeRFModel"](
        num_encoding_fn_xyz=10), enc, pe_dir, 2048, 64, "cuda")
