"""PyTorch port, K4 (`ops/kernels/fused_flex.py`, `csrc/fused_flex.cu`) at
hidden width 512 and at any depth.

* The plain forward and backward against the JAX package's Pallas kernels
  `_fused_flex_fwd` / `_fused_flex_bwd` in interpret mode (R = 8, S = 16,
  `params_from_jax` weights, numpy inputs from a seed), for the three
  classes of tests/test_torch_flex_kernel.py, at h = 512 with n = 0, 3 and
  10 hidden layers and at h = 256 with n = 9 and 12 (past the 8 the kernels
  took before): raw [rgb, σ] within 2e-3·max|JAX|, each gradient (d_v0
  and d_dir included) within 0.08·max|JAX| and 0.04·‖JAX‖, that file's
  limits, the max one at n ≥ 8 through a yardstick (below).
  Readings (this file's draws; `test_plain_matches_jax_kernel_at_width`
  prints them with -s): raw ≤ 7.0e-4·max; gradients ≤ 6.7e-2·max and
  ≤ 1.9e-2·‖·‖ in every case but h = 512, n = 10, FlexibleNeRFModel:
  1.68e-1·max (wh2) and 3.3e-2·‖·‖, its yardstick 1.26e-1, so its max
  limit 0.189. The yardstick widens one other case: h = 256, n = 12,
  ConditionalBlendshapeNeRFModel, yardstick 8.1e-2, limit 0.121, reading
  5.1e-3. `test_limits_catch_a_planted_fault` shows the limits still
  fail a zeroed wh row and a lost 64-row unit at the widest case.
* The slice: `render_rays` of a `ConditionalBlendshapeLearnableCodeNeRFModel`
  at hidden 512 (8 rays, 8 + 8 samples, JAX's draws injected) against JAX
  `render_rays` on the same weights: f32 within 1e-4
  (tests/test_torch_serve.py's twin at h = 256), bf16 through K4's plain
  version against JAX's bf16 pass through its Pallas kernel within 2e-3
  (the raw limit above; maps in [0, 1]).
* Dispatch: `flex_fused_eligible` on the card against JAX's
  `flex_fused_eligible` and its tile rule over h ∈ {128, 256, 512, 768,
  1024, 1280}, n ∈ {0, 3, 8, 9, 12}, an engaged skip and ragged ray counts:
  the two agree wherever the port's widths reach (up to 1024); h = 1280,
  the first width past them, runs the plain path.
* Layouts at h = 512, n = 12: the workspace carve replayed from
  `fused_flex.cu`'s source against `workspace_layout`, dW's products and
  segments, and the entry points' refusal of any other width.
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
from nerface_tpu.ops import sampling as jax_sampling
from nerface_tpu.ops.encoding import _encoding_matrix
from nerface_tpu.ops.pallas import fused_flex as JF
from nerface_tpu.render import pipeline as jax_pipeline
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.ops.kernels import fused_flex as F
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.render.pipeline import EncodeSpec
from nerface_tpu_torch.train.checkpoint import params_from_jax

torch.set_num_threads(1)

CU = (pathlib.Path(F.__file__).resolve().parents[2] / "csrc" / "fused_flex.cu").read_text()
R, S = 8, 16
CLASSES = ["ConditionalBlendshapeLearnableCodeNeRFModel", "ConditionalBlendshapeNeRFModel",
           "FlexibleNeRFModel"]
# (hidden width, hidden layers after layer1)
DOMAIN = [(512, 0), (512, 3), (256, 9), (256, 12), (512, 10)]


def _kw(h, n):
    # skip_connect_every past the last layer: no skip engages at any depth
    return dict(num_layers=n + 1, hidden_size=h, skip_connect_every=n + 2, num_encoding_fn_xyz=10,
                num_encoding_fn_dir=4)


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


def _jax_fold(jm, jp, x, h):
    """The JAX pipeline's v0 (1, h) and dir_contrib (R, h / 2)."""
    e = jnp.asarray(x["expr"]) if jm.takes_expression else None
    l = jnp.asarray(x["latent"]) if jm.takes_latent else None
    e, l = jm._prepare(jp, e, l, None)
    v0 = jp["layer1.bias"]
    segs = jm._cond_segments_layer1(e, l)
    if segs:
        v0 = v0 + jax_cond_contribution(jp, "layer1", segs, jm.dim_xyz)
    dc = jax_linear_cols(jp, "layers_dir.0", jnp.asarray(x["pe_dir"]), h, h + 24)
    return np.asarray(v0)[None, :], np.asarray(dc)


def _jax_weights(jp, h, n):
    """`fused_flex_mlp`'s weight tuple (`fused_flex.py:344-356`)."""
    def w(k):
        return jp[k + ".weight"]

    def b(k):
        return jp[k + ".bias"][None, :]

    mats = [w("layer1")[:, :3].T, w("layer1")[:, 3:63].T]
    mats += [w(f"layers_xyz.{i}").T for i in range(n)]
    mats += [w("fc_feat").T, w("fc_alpha").T, w("layers_dir.0")[:, :h].T, w("fc_rgb").T]
    biases = [b(f"layers_xyz.{i}") for i in range(n)]
    biases += [b("fc_feat"), b("fc_alpha"), b("layers_dir.0"), b("fc_rgb")]
    return tuple(m.astype(jnp.bfloat16) for m in mats) + tuple(biases)


# chip_smoke.py's depth rule: from FLEX_TC_DEPTH hidden layers on, bf16
# roundings that flip between two f32 summation orders compound through the
# chain (a flipped relu in one sample row moves a whole row's outer product
# in a weight gradient whose terms cancel), so a max reading passes within
# 0.08 or within FLEX_TC_FACTOR × the yardstick: the largest max reading of
# the plain version against itself on the same network with its hidden
# units permuted (the same function and bf16 operands, other f32 sum
# orders), over YARD_DRAWS permutations. The norm limit stays 0.04.
FLEX_TC_DEPTH, FLEX_TC_FACTOR, YARD_DRAWS = 8, 1.5, 3


def _yardstick(targs, g, n, port, seed):
    """max over tensors of max|y − port| / max|port|, y the plain backward
    of the network with each hidden layer's units permuted (seed), mapped
    back."""
    weights, ro, rd, z, dc, v0 = targs
    W = dict(F._unpack(list(weights), n))
    gen = torch.Generator().manual_seed(seed)
    perms = [torch.randperm(v0.shape[-1], generator=gen) for _ in range(n + 1)]  # a_0..a_n's units
    W["w1a"], W["w1b"] = W["w1a"][:, perms[0]], W["w1b"][:, perms[0]]
    for i in range(n):
        W[f"wh{i}"], W[f"bh{i}"] = W[f"wh{i}"][perms[i]][:, perms[i + 1]], W[f"bh{i}"][:, perms[i + 1]]
    W["wf"], W["wa"] = W["wf"][perms[n]], W["wa"][perms[n]]
    wn, bn = F.weight_names(n)
    yg, y_v0, y_dir = F.fused_flex_backward_reference(tuple(W[k] for k in wn + bn), ro, rd, z, dc,
                                                      v0[:, perms[0]], g, n)
    inv = [torch.argsort(p) for p in perms]
    Y = dict(zip(wn + bn, yg))
    Y["w1a"], Y["w1b"] = Y["w1a"][:, inv[0]], Y["w1b"][:, inv[0]]
    for i in range(n):
        Y[f"wh{i}"], Y[f"bh{i}"] = Y[f"wh{i}"][inv[i]][:, inv[i + 1]], Y[f"bh{i}"][:, inv[i + 1]]
    Y["wf"], Y["wa"] = Y["wf"][inv[n]], Y["wa"][inv[n]]
    ys = tuple(Y[k] for k in wn + bn) + (y_v0[:, inv[0]], y_dir)
    ps = port[0] + (port[1], port[2])
    return max(float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
               for a, b in zip(ys, ps))


def _case(h, n, name):
    """One case: JAX's raw rows and gradients through its Pallas kernels,
    the port's plain-version inputs (weights, ro, rd, z, dir_c, v0) and
    the cotangent g."""
    jm = JAX_MODELS[name](**_kw(h, n))
    jp = jm.init(jax.random.PRNGKey(h + n))
    x = _inputs(seed=len(name) + n)
    v0, dc = _jax_fold(jm, jp, x, h)
    C, phase = _encoding_matrix(3, 10, True)
    args = tuple(jnp.asarray(a) for a in (x["ro"], x["rd"], x["z"], dc, v0, C, phase[None, :]))
    out, res = JF._fused_flex_fwd(S, 4, n, h, *args, *_jax_weights(jp, h, n))
    jgrads = JF._fused_flex_bwd(S, 4, n, h, res, jnp.asarray(x["g"]))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    targs = (F.pack_flex_weights(tp, n, 10), _t(x["ro"]), _t(x["rd"]), _t(x["z"]), _t(dc), _t(v0))
    return np.asarray(out), jgrads, targs, _t(x["g"])


def _grad_readings(h, n, targs, g, jgrads):
    """The port's plain backward against JAX's gradients: [(tensor,
    max|Δ| / max|JAX|, ‖Δ‖ / ‖JAX‖)], the max limit those readings are
    held to, and the yardstick (0 below FLEX_TC_DEPTH)."""
    port = F.fused_flex_backward_reference(*targs, g, n)
    grads, d_v0, d_dir = port
    wn, bn = F.weight_names(n)
    assert d_v0.shape == (1, h) and d_dir.shape == (R, h // 2)
    max_limit, yard = 0.08, 0.0
    if n >= FLEX_TC_DEPTH:
        yard = max(_yardstick(targs, g, n, port, seed) for seed in range(YARD_DRAWS))
        max_limit = max(0.08, FLEX_TC_FACTOR * yard)
    rows = []
    for k, a, b in zip(wn + bn + ("v0", "dir"), grads + (d_v0, d_dir), jgrads[7:] + (jgrads[4], jgrads[3])):
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        assert a.shape == b.shape, k
        rows.append((k, float(np.abs(a - b).max() / np.abs(b).max()),
                     float(np.linalg.norm(a - b) / np.linalg.norm(b))))
    return rows, max_limit, yard


@pytest.mark.parametrize("name", CLASSES)
@pytest.mark.parametrize("h,n", DOMAIN, ids=[f"h{h}_n{n}" for h, n in DOMAIN])
def test_plain_matches_jax_kernel_at_width(h, n, name):
    out, jgrads, targs, g = _case(h, n, name)
    got = F.fused_flex_forward_reference(*targs, n)
    assert got.shape == out.shape == (R, S, 4)
    raw = np.abs(got.numpy() - out).max() / np.abs(out).max()
    assert raw <= 2e-3, raw
    rows, max_limit, yard = _grad_readings(h, n, targs, g, jgrads)
    for k, e_max, e_norm in rows:
        assert e_max <= max_limit + 1e-9, (k, e_max, max_limit)
        assert e_norm <= 0.04 + 1e-9, (k, e_norm)
    print(f"h={h} n={n} {name}: raw {raw:.2e}·max, gradients ≤ {max(r[1] for r in rows):.2e}·max, "
          f"{max(r[2] for r in rows):.2e}·norm; max limit {max_limit:.3f} (yardstick {yard:.3e})")


@pytest.mark.parametrize("fault", ["zeroed_wh_row", "lost_unit"])
def test_limits_catch_a_planted_fault(fault):
    """At the case whose max limit the yardstick widens most (h = 512, n =
    10, FlexibleNeRFModel: 1.5 × 0.126 = 0.189), the norm limit of 0.04
    alone still fails a fault planted in the port: one row of wh5 zeroed in
    its packed weights (≥ 0.24·‖·‖ in 21 of 32 tensors), or the cotangent
    of the second 64-row unit dropped (chip_smoke's lost-unit control,
    ≥ 5·‖·‖ in wa). The max limit, its yardstick taken on the faulty port
    as the test above would, fails it too."""
    h, n = 512, 10
    _, jgrads, targs, g = _case(h, n, "FlexibleNeRFModel")
    if fault == "zeroed_wh_row":
        weights = list(targs[0])
        i = F.weight_names(n)[0].index(f"wh{n // 2}")
        weights[i] = weights[i].clone()
        weights[i][7] = 0
        targs = (tuple(weights),) + targs[1:]
    else:
        g = g.clone()
        g[R // 2:] = 0  # rays 4..7: sample rows 64..127, the second unit
    rows, max_limit, _ = _grad_readings(h, n, targs, g, jgrads)
    assert any(e_norm > 0.04 for _, _, e_norm in rows), rows
    assert any(e_max > max_limit for _, e_max, _ in rows), (rows, max_limit)


def _render_pair(dtype, h=512):
    """JAX's and the port's `render_rays` of one h-wide LearnableCode
    avatar (coarse and fine models from one init) on 8 rays, JAX's draws
    injected."""
    name, nc, nf = "ConditionalBlendshapeLearnableCodeNeRFModel", 8, 8
    kw = dict(num_layers=4, hidden_size=h, num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
              include_input_dir=False)
    jm = JAX_MODELS[name](**kw)
    jp = jm.init(jax.random.PRNGKey(5))
    tm = MODELS[name](**kw)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}), strict=True)
    rng = np.random.RandomState(3)
    ro = (rng.randn(R, 3) * 0.05).astype(np.float32)
    rd = (rng.randn(R, 3) * [0.1, 0.1, 0.0] - [0, 0, 1]).astype(np.float32)
    bg = rng.rand(R, 3).astype(np.float32)
    expr = (rng.randn(76) * 0.1).astype(np.float32)
    latent = (rng.randn(32) * 0.1).astype(np.float32)
    common = dict(num_coarse=nc, num_fine=nf, perturb=True, near=0.2, far=0.8)
    jset = jax_pipeline.RenderSettings(
        **common, encode_xyz=jax_pipeline.EncodeSpec(10, True, True),
        encode_dir=jax_pipeline.EncodeSpec(4, False, True), fused="on" if dtype else "off")
    tset = pipeline.RenderSettings(
        **common, encode_xyz=EncodeSpec(10, True, True), encode_dir=EncodeSpec(4, False, True))
    key = jax.random.PRNGKey(9)
    idx = jnp.arange(R, dtype=jnp.int32)
    ref = jax_pipeline.render_rays(
        jm, jm, jp, jp, jnp.asarray(ro), jnp.asarray(rd), jset, key=key, expressions=jnp.asarray(expr),
        latent_code=jnp.asarray(latent), background_prior=jnp.asarray(bg), ray_index=idx,
        dtype=jnp.bfloat16 if dtype else None)
    k_strat, _, k_pdf, _ = jax.random.split(key, 4)
    t_rand = np.asarray(jax_sampling.per_ray_uniform(k_strat, idx, nc))
    u = np.asarray(jax_sampling.per_ray_uniform(k_pdf, idx, nf))
    with torch.no_grad():
        got = pipeline.render_rays(
            tm, tm, _t(ro), _t(rd), tset, expressions=_t(expr), latent_code=_t(latent),
            background_prior=_t(bg), t_rand=_t(t_rand), u=_t(u), dtype=dtype)
    return got, ref


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16_k4"])
def test_render_rays_at_512_matches_jax(dtype, monkeypatch):
    calls = []
    real = pipeline.fused_flex_mlp
    monkeypatch.setattr(pipeline, "fused_flex_mlp", lambda *a, **k: calls.append(a[3].shape) or real(*a, **k))
    got, ref = _render_pair(dtype)
    # bf16: both passes through K4 (its plain version on CPU tensors)
    assert calls == ([] if dtype is None else [(R, 8), (R, 16)])
    atol = 1e-4 if dtype is None else 2e-3
    for k in ("rgb_coarse", "acc_coarse", "rgb_fine", "acc_fine", "bg_weight"):
        a, b = got[k].float().numpy(), np.asarray(ref[k], np.float32)
        assert a.shape == b.shape and np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)
    for k in ("depth_coarse", "depth_fine"):
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(ref[k], np.float32),
                                   atol=atol * 0.8, rtol=0, err_msg=k)


def _jax_rule(jm, enc, pe_dir, n_rays):
    """Whether the JAX package sends the pass to its Pallas kernel: its
    `flex_fused_eligible` and its tile picker finding a tile (n_rays a
    multiple of 8)."""
    return JF.flex_fused_eligible(jm, enc, pe_dir) and n_rays % 8 == 0


@pytest.mark.parametrize("h", [128, 256, 512, 768, 1024, 1280])
def test_dispatch_matches_jax_rule(h):
    from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec

    enc, jenc = EncodeSpec(10, True, True), JaxEncodeSpec(10, True, True)
    pe_dir = torch.zeros(4, 24)
    for n in (0, 3, 8, 9, 12):
        for skip in (n + 2, 3):  # none engaged; one engaged from 4 layers on
            kw = dict(num_layers=n + 1, hidden_size=h, skip_connect_every=skip, num_encoding_fn_xyz=10,
                      num_encoding_fn_dir=4, include_input_dir=False)
            name = "ConditionalBlendshapeLearnableCodeNeRFModel"
            jm, tm = JAX_MODELS[name](**kw), MODELS[name](**kw)
            for n_rays in (2048, 2072, 2047, 8):
                jax_ok = _jax_rule(jm, jenc, jnp.zeros((4, 24)), n_rays)
                got = F.flex_fused_eligible(tm, enc, pe_dir, n_rays, 64, "cuda")
                assert got == (jax_ok and h in F.WIDTHS), (h, n, skip, n_rays)
                if h == 1280:  # JAX's kernel takes it; past the port's widths, the plain path
                    assert not got
                    assert jax_ok or n_rays % 8 or skip != n + 2
                if h in F.WIDTHS and jax_ok:  # any depth
                    assert got


def test_wrappers_refuse_other_widths_and_depths():
    x = _inputs(1)
    args = (_t(x["ro"]), _t(x["rd"]), _t(x["z"]))
    for h in (128, 1280):  # below 256, and the first width past MAX_WIDTH
        from nerface_tpu_torch.tools.perf.cases import flex_params

        params, v0 = flex_params(1, torch.device("cpu"), 1, 256)
        weights = F.pack_flex_weights(params, 1, 10)
        bad_v0, dc = torch.zeros(1, h), torch.zeros(R, h // 2)
        with pytest.raises(ValueError, match="hidden width 256, 512, 768 or 1024"):
            F.fused_flex_forward(weights, *args, dc, bad_v0, 1)
        with pytest.raises(ValueError, match="hidden width 256, 512, 768 or 1024"):
            F.fused_flex_backward(weights, *args, dc, bad_v0, _t(x["g"]), 1)
    with pytest.raises(ValueError, match="n_hidden"):
        F.fused_flex_forward(weights, *args, torch.zeros(R, 128), v0, -1)


def _carve_replay(n_rays, n_samples, n, h, kx=64):
    """`carve` in fused_flex.cu, replayed line by line from the source at
    the encoding's extent kx: {buffer: byte offset}, total bytes."""
    body = CU[CU.index("size_t carve("):CU.index("// -- K4f and the recompute")]
    rays, units_an_item = F.unit_layout(n_samples)
    units = -(-n_rays // rays) * units_an_item
    ctas = F.flex_ctas(n_rays, n_samples, h)
    env = {"kx": kx, "h": h, "dh": h // 2, "n": n, "mask": F.mask_bytes(h),
           "part_cols": F.f_offsets(n, h)["TOTAL"] + h + 3 * (h // 2)}
    offs, o = {}, 0
    steps = re.findall(r"w\.(\w+) = (img|imgs|bits|static_cast<float\*>\(take)\(([^;]*)\);", body)
    assert [s[0] for s in steps] == ["xin", "act0", "feat", "x0", "gx0", "gfeat", "gpre0", "ga0", "fmask",
                                     "amask0", "warp_part", "tile_part", "dw_part"]
    for name, kind, arg in steps:
        arg = arg.replace("L.", "").replace("(size_t)", "").replace("sizeof(float)", "4")
        if kind == "img":
            sizes = [units * eval(arg, {}, env) * 128]
        elif kind == "imgs":
            width, count = arg.split(", ")
            sizes = [units * eval(width, {}, env) * 128] * eval(count, {}, env)
        elif kind == "bits":
            sizes = [units * env["mask"]] * eval(arg, {}, env)
        else:
            expr = arg.rstrip(")").replace("mask_bytes", "mask")
            expr = expr.replace("dw_segments_of(L, units)", str(F.dw_segments(n, h, kx, units)))
            expr = re.sub(r"\bwa\b", str(F.w_offsets(n, h, kx)["WA"]), expr)
            sizes = [eval(expr, {}, dict(env, ctas=ctas, WARPS_A_CTA=F.WARPS_A_CTA))]
        offs[name] = o
        for nbytes in sizes:
            o = (o + nbytes + 255) // 256 * 256
    return offs, o


@pytest.mark.parametrize("R_,S_,n,h", [(2048, 64, 12, 512), (2072, 24, 12, 512), (2048, 128, 12, 256),
                                       (301, 200, 3, 512)])
def test_workspace_carve_at_width_and_depth(R_, S_, n, h):
    offs, total = F.workspace_layout(R_, S_, n, h)
    got, got_total = _carve_replay(R_, S_, n, h)
    assert got_total == total
    for k, v in got.items():
        key = {"act0": "a0", "gpre0": "gpre0" if n else "ga0", "amask0": "amask1" if n else "warp_part"}.get(k, k)
        assert offs[key] == v, k


def test_dw_products_and_entry_refusals_match_source():
    body = CU[CU.index("void dw_products("):CU.index("// dW's row segments")]
    calls = re.findall(r"blocks\(([^;]*)\);", body)
    dims = [tuple(x.strip() for x in c.split(", ")[2:4]) for c in calls if not c.startswith("const")]
    assert dims == [("L.kx", "L.h"), ("L.h", "L.h"), ("L.h", "L.dh"), ("L.h", "L.h")]
    assert "for (int i = 0; i < L.n; ++i)" in body and "ndim > 256 ? 256 : ndim" in body
    for h, n in ((256, 12), (512, 12), (512, 0)):
        for kx in (64, 128):  # W1's product at the encoding's extent
            mats = [(kx, h), (h, h), (h, h // 2)] + [(h, h)] * n
            assert F.dw_products(n, h, kx) == tuple((k, min(c, 256)) for k, c in mats for _ in range(0, c, 256))
    code = re.sub(r"//.*", "", CU)
    valid = code[code.index("bool valid("):code.index("}", code.index("bool valid("))]
    assert "hidden >= HIDDEN && hidden <= MAX_WIDTH && hidden % HIDDEN == 0" in valid and "n_hidden >= 0" in valid
    assert "constexpr int WIDE = 512;" in CU and f"constexpr int MAX_WIDTH = {F.MAX_WIDTH};" in CU
    assert "default:" not in code
    assert F.WIDTHS == tuple(range(256, F.MAX_WIDTH + 1, 256))
    for entry in ("nerface_fused_flex_fwd(", "nerface_fused_flex_bwd(", "nerface_fused_flex_workspace_bytes("):
        body = code[code.index(entry):]
        body = body[:body.index("\n}\n")]
        assert re.search(r"if \(!valid\(n_rays, n_samples, \w+, n_hidden, hidden\)\) return", body), entry
    # no width runs another's layout: the h = 512 flag runs the wide kernels, the other h = 256's
    for struct, wide, narrow in (("Forward", "launch_wide_chain<SF, false>", "launch_chain<SF, false>"),
                                 ("Backward", "launch_wide_backward<SF>", "launch_backward<SF>")):
        body = code[code.index(f"struct {struct} {{"):]
        body = body[:body.index("\n};\n")]
        assert re.search(r"if constexpr \(WIDE_H\) \{\s*return " + re.escape(wide) + r"\(.*\} else \{\s*return "
                         + re.escape(narrow) + r"\(", body, re.S), struct
    for entry, struct in (("nerface_fused_flex_fwd(", "Forward"), ("nerface_fused_flex_bwd(", "Backward")):
        body = code[code.index(entry):]
        assert f"dispatch_pass<{struct}>(n_samples, hidden == WIDE," in body[:body.index("\n}\n")], entry
