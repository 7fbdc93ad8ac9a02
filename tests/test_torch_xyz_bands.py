"""PyTorch port: the paper-family kernels (K2, K3f, K3b, K1) at 11 to 20 xyz
encoding bands.

Past 10 bands the encoding [xyz; PE] has 69..123 columns: the kernels pad
it to K = 128 (two 64-column blocks, `fused_mlp.xin_extent`), W0 and W3
hold 128 encoding rows (`w_layout(128)`), and K1's workspace image of xin
is 128 wide. The 10-band layout stays K = 64, its offsets unchanged.

* (a) Dispatch. Asked for the card (`device="cuda"`, no card needed),
  `_fused_render_eligible`, the `_apply_model` branch (`_fused_model_ok`
  and `_paper_kernels_take`) and `fused_train_eligible` admit exactly L =
  1..31 of the paper family and refuse 32 (1..20 until the paper kernels
  took a three-block xin image, tests/test_torch_xyz_bands_xl.py); the
  wrappers raise a ValueError naming 1..31 past it (on the CPU too, whose
  wrappers run the plain versions). K4 keeps 20: `flex_fused_eligible`
  takes L = 11 and refuses 21, and `_apply_model` sends a 21-band Flexible
  pass to the plain forward (tests/test_torch_flex_bands.py holds K4 past
  10 bands).
* (b) The plain versions against the JAX package's Pallas kernels in
  interpret mode at L = 11, 16 and 20, S = 16 and 48, the paper and the
  smaller model, inputs from a numpy seed, the weights loaded by
  `params_from_jax`, with `tests/test_torch_sample_counts.py`'s stated
  tolerances: K2 rgb / acc / bg_weight / weights atol 2e-3, depth
  2e-3·far, disp rtol 1e-2; K3 forward 0.01·max, its VJP 0.08·max /
  0.04·‖·‖; K1 rgb / weights atol 2e-4, gradients 0.06·max (0.15 on
  d_dir) / 0.04·‖·‖. Both sides round the same operands to bf16 and sum
  in f32 in other orders.
* (c) Layout. `w_layout(128)`, `F_LAYOUT` and `WT_LAYOUT` against the
  offsets `csrc/mma_tile.cuh`'s `w_off` gives (its expression read from the
  header and evaluated here); the 10-band offsets are the ones the K = 64
  kernels read, pinned. Packing at 16 bands and splitting the buffer back
  (`_split_kernel_grads`, the kernels' gradient layout) round-trips every
  matrix; the chunk images unpack to it. The encoder's task mirror
  (`encode_task` / `encode_units`) writes each of the 128 columns of every
  row once, at the image's bytes, and the 10-band mirror covers its 64.
* (d) The slice as a whole: a 16-band paper step at 16 + 16 samples
  through `fused_losses` in bf16 on the CPU (K1's plain version) against
  the JAX package's fused step `fused_value_and_grad` (its Pallas kernel
  in interpret mode) with the JAX draws: loss and metrics rtol 1e-3, the
  coarse model's and the latent codes' gradients within 5e-3·max
  (`test_torch_sample_counts.py`'s step; read ≤ 1.7e-4). The fine model's
  within 0.06·max, K1's limit of (b): its sample depths follow the coarse
  weights, which the two packages' bf16 MLPs give a few 1e-3 apart, and
  the 2^15 top band turns that into phases that no longer agree (read
  0.027·max on the fine layers_dir.1; at 10 bands that file's step holds
  5e-3 everywhere).
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.config.flags import FeatureFlags as JaxFlags
from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.ops.pallas.fused_mlp import fused_paper_mlp as jax_fused_paper_mlp
from nerface_tpu.ops.pallas.fused_mlp import fused_paper_render as jax_fused_render
from nerface_tpu.ops.pallas.fused_train import fused_train_pass as jax_train_pass
from nerface_tpu.ops.pallas.fused_train import prefold_paper_params as jax_prefold
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerface_tpu.render.pipeline import _fused_conditioning as jax_fused_conditioning
from nerface_tpu.train.fused import fused_value_and_grad as jax_fused_value_and_grad
from nerface_tpu.train.state import TrainState as JaxTrainState
from nerface_tpu.train.state import build_optimizer as jax_build_optimizer
from nerface_tpu_torch.config import CfgNode
from nerface_tpu_torch.config.flags import FeatureFlags
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.ops.kernels import fused_flex as F
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_train as T
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings
from nerface_tpu_torch.train import checkpoint as ckpt
from nerface_tpu_torch.train.checkpoint import params_from_jax
from nerface_tpu_torch.train.fused import fused_losses, fused_train_eligible
from nerface_tpu_torch.train.state import build_optimizer, create_train_state
from test_torch_train import _batch, _opt_cfg, _port_grads

torch.set_num_threads(1)

CSRC = pathlib.Path(K.__file__).resolve().parents[2] / "csrc"
FAMILY = {False: "ConditionalBlendshapePaperNeRFModel",
          True: "ConditionalBlendshapePaperSmallerNeRFModel"}
FAR = 0.8
DIR_OFF = 256 + 24  # the smaller model's expression block of layers_dir.0
BANDS = [11, 16, 20]
SAMPLES = [16, 48]


def _kw(L, **extra):
    return dict(num_encoding_fn_xyz=L, num_encoding_fn_dir=4, include_input_dir=False, **extra)


def _t(a):
    return torch.from_numpy(np.array(a))


def _settings(L, noise=0.1, sc=16, sf=16):
    kw = dict(num_coarse=sc, num_fine=sf, perturb=True, radiance_field_noise_std=noise,
              white_background=False, near=0.2, far=FAR)
    return (RenderSettings(**kw, encode_xyz=EncodeSpec(L, True, True), encode_dir=EncodeSpec(4, False, True)),
            JaxRenderSettings(**kw, encode_xyz=JaxEncodeSpec(L, True, True),
                              encode_dir=JaxEncodeSpec(4, False, True), fused="off"))


# -- (a) dispatch --------------------------------------------------------------

@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_dispatch_takes_1_to_20_bands(small, monkeypatch):
    """On the card K2, K3 and K1 take a 2048-ray pass at S = 64 and 48 for
    L = 1..20 and, since the three-block xin image, 21..31, and refuse L =
    32 (the plain forward runs it); on the CPU the same band rule holds
    (the kernels' plain versions take 1..31)."""
    taken = []
    monkeypatch.setattr(pipeline, "_paper_pass", lambda *a: taken.append(a[4].num_encoding_functions) or "K3")
    flags = FeatureFlags()
    pe_dir, expr, latent = torch.zeros(2048, 24), torch.zeros(76), torch.zeros(32)
    for L in range(1, 33):
        m = MODELS[FAMILY[small]](**_kw(L), generator=torch.Generator().manual_seed(L))
        monkeypatch.setattr(m, "forward", lambda *a, **k: "plain")
        want = L <= 31
        tset, _ = _settings(L, noise=0.0, sc=64, sf=64)
        render = dataclasses.replace(tset, fused_render=True)
        for S in (64, 48):
            for dev in ("cuda", torch.device("cuda", 0)):
                assert pipeline._fused_render_eligible(m, 2048, S, pe_dir[:2], expr, latent, render,
                                                       torch.bfloat16, dev) == want, (L, S)
            assert pipeline._fused_model_ok(m, tset.encode_xyz, pe_dir, expr, latent) == want, L
            assert pipeline._paper_kernels_take(2048, S, "cuda")
            z = torch.linspace(0.2, 0.8, S).expand(2048, S)
            out = pipeline._apply_model(m, torch.zeros(2048, 3), torch.ones(2048, 3), z, tset.encode_xyz,
                                        pe_dir, expr, latent, torch.bfloat16)
            assert out == ("K3" if want else "plain"), (L, S)
        for dev in ("cuda", "cpu"):
            assert fused_train_eligible(m, m, tset, flags, torch.bfloat16, dev, num_rays=2048) == want, (L, dev)
    assert taken == [L for L in range(1, 32) for _ in (64, 48)]


def test_flexible_models_keep_their_ten_band_limit(monkeypatch):
    """K4's band limit, which stood at 10 (one 64-column xin block) and is
    now 20 (a two-block xin image past 10), below the paper kernels' 31:
    `flex_fused_eligible` takes a LearnableCode model at 10, 11, 16 and 20
    bands and refuses 21 and 31 on the card and on the CPU, `_apply_model`
    runs a 21- or 31-band Flexible pass on the model's plain forward, and
    the kernel's operand check takes 11 and refuses 21 naming 1..20."""
    assert F.MAX_FREQS == 20 and K.MAX_FREQS == 31
    name = "ConditionalBlendshapeLearnableCodeNeRFModel"
    pe_dir, expr, latent = torch.zeros(2048, 24), torch.zeros(76), torch.zeros(32)
    monkeypatch.setattr(pipeline, "_flex_pass", lambda *a: "K4")
    for L in (10, 11, 16, 20, 21, 31):
        m = MODELS[name](**_kw(L, hidden_size=256))
        monkeypatch.setattr(m, "forward", lambda *a, **k: "plain")
        for dev in ("cuda", "cpu"):
            assert F.flex_fused_eligible(m, EncodeSpec(L, True, True), pe_dir, 2048, 64, dev) == (L <= 20), (L, dev)
        z = torch.linspace(0.2, 0.8, 64).expand(2048, 64)
        out = pipeline._apply_model(m, torch.zeros(2048, 3), torch.ones(2048, 3), z, EncodeSpec(L, True, True),
                                    pe_dir, expr, latent, torch.bfloat16)
        assert out == ("K4" if L <= 20 else "plain"), L
    args = (torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(8, 64), torch.zeros(8, 128), torch.zeros(1, 256), 3)
    with pytest.raises(ValueError, match=r"1\.\.20 xyz encoding bands"):
        F._kernel_call(None, *args, 21)
    with pytest.raises(ValueError, match="weights, expected"):  # 11 bands pass the band check
        F._kernel_call((), *args, 11)


def test_wrappers_raise_past_20_bands():
    """A direct call at L = 32 (or 0) raises a ValueError naming 1..31, on
    the CPU too (past 20 until the paper kernels took 21..31); L = 20 and 31
    run."""
    R, S = 2, 8
    rng = np.random.RandomState(0)
    ro, rd = _t(rng.randn(R, 3).astype(np.float32)), _t(rng.randn(R, 3).astype(np.float32))
    z = torch.linspace(0.2, 0.8, S).expand(R, S).contiguous()
    for L in (32, 0, 20, 31):
        m = MODELS[FAMILY[False]](**_kw(max(L, 1)))
        bundle = T.prefold_paper_params(m.state_dict(), torch.zeros(108), torch.zeros(R, 24), L)
        calls = {
            "K3f": lambda: K.fused_paper_mlp_forward(bundle, ro, rd, z, num_encoding_fn_xyz=L),
            "K3b": lambda: K.fused_paper_mlp_backward(bundle, ro, rd, z, torch.zeros(R, S, 4),
                                                      num_encoding_fn_xyz=L),
            "K1": lambda: T.fused_train_pass(bundle, ro, rd, z, torch.zeros(R, 3), loss_scale=1.0,
                                             num_encoding_fn_xyz=L),
            "K2": lambda: K.fused_paper_render(m.state_dict(), ro, rd, z, torch.zeros(R, 128),
                                               torch.zeros(108), num_encoding_fn_xyz=L),
            "pack": lambda: K.pack_paper_weights(m.state_dict(), L),
        }
        for name, call in calls.items():
            if L in (20, 31):
                call()
                continue
            with pytest.raises(ValueError, match=r"1\.\.31 xyz encoding bands"):
                call()
    with pytest.raises(ValueError, match=r"1\.\.31 xyz encoding bands"):
        K.check_bands(32)


# -- (b) the plain versions against the TPU kernels ------------------------------

@pytest.fixture(scope="module", params=[(s, L) for s in (False, True) for L in BANDS],
                ids=[f"{'small' if s else 'paper'}-L{L}" for s in (False, True) for L in BANDS])
def family(request):
    """(small, L, JAX model, JAX params, the port's module on the same weights)."""
    small, L = request.param
    jm = JAX_MODELS[FAMILY[small]](**_kw(L))
    jp = jm.init(jax.random.PRNGKey(11 + L))
    tm = MODELS[FAMILY[small]](**_kw(L))
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}), strict=True)
    assert tm.dim_xyz == 3 + 6 * L
    return small, L, jm, jp, tm


def _grid(a, bits):
    """`a` rounded to a multiple of 2^-bits, as f32."""
    return (np.round(np.asarray(a, np.float64) * 2.0 ** bits) / 2.0 ** bits).astype(np.float32)


def _inputs(R, S, seed):
    """The rays on a grid where ro + rd·z is exact in f32 (ro a multiple of
    2^-10, rd of 2^-8 below 2, z of 2^-12 below 1: the product and the sum
    need at most 21 bits), so both packages' sample points are the same
    bits. The top band multiplies a point by 2^(L-1), up to 2^19: one ulp
    of a point (XLA on the CPU contracts ro + rd·z into one rounding, the
    port and its CUDA kernel round twice) moves its phase by up to 0.03 rad
    and the two encodings apart, which is not what these tests compare."""
    rng = np.random.RandomState(seed)
    f = np.float32
    step = _grid(rng.rand(R, S) * ((FAR - 0.2) / S), 12).clip(2.0 ** -12)
    return dict(
        ro=_grid(rng.randn(R, 3) * 0.05 + [0, 0, 0.5], 10),
        rd=_grid(rng.randn(R, 3) * [0.2, 0.2, 0.05] - [0, 0, 1], 8),
        z=_grid(0.2 + np.cumsum(step.astype(np.float64), -1), 12),
        target=rng.rand(R, 3).astype(f), bg=rng.rand(R, 3).astype(f),
        noise=rng.randn(R, S).astype(f), pe_dir=rng.randn(R, 24).astype(f),
        expr=(rng.randn(76) * 0.5).astype(f), latent=(rng.randn(32) * 0.1).astype(f),
        g=rng.randn(R, S, 4).astype(f),
    )


def _close_tensor(name, got, want, max_tol, norm_tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    d = got - want
    assert np.abs(d).max() <= max_tol * np.abs(want).max() + 1e-9, (name, np.abs(d).max())
    assert np.linalg.norm(d) <= norm_tol * np.linalg.norm(want) + 1e-9, name


@pytest.mark.parametrize("S", SAMPLES)
def test_k2_plain_matches_jax_kernel(family, S):
    small, L, jm, jp, tm = family
    x = _inputs(16, S, seed=S + L)
    jcond, jdc, _ = jax_fused_conditioning(jm, jp, jnp.asarray(x["pe_dir"]),
                                           jnp.asarray(x["expr"]), jnp.asarray(x["latent"]))
    ref = jax_fused_render(jp, jnp.asarray(x["ro"]), jnp.asarray(x["rd"]), jnp.asarray(x["z"]),
                           jdc, jcond, background=jnp.asarray(x["bg"]), out_weights=True,
                           num_encoding_fn_xyz=L, small=small)
    got = K.fused_paper_render_reference(
        tm.state_dict(), _t(x["ro"]), _t(x["rd"]), _t(x["z"]), _t(jdc), _t(jcond),
        background=_t(x["bg"]), out_weights=True, num_encoding_fn_xyz=L, small=small)
    assert set(got) == set(ref) and got["weights"].shape == (16, S)
    # the wrapper on CPU tensors is the plain version, through the packed weights too
    wrapped = K.fused_paper_render(K.pack_paper_weights(tm.state_dict(), L), _t(x["ro"]), _t(x["rd"]),
                                   _t(x["z"]), _t(jdc), _t(jcond), background=_t(x["bg"]), out_weights=True,
                                   num_encoding_fn_xyz=L, small=small)
    for k in got:
        assert torch.equal(wrapped[k], got[k]), k
    for k in ("rgb", "acc", "bg_weight", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=2e-3, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(ref["depth"]), atol=2e-3 * FAR, rtol=0)
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(ref["disp"]), rtol=1e-2)


@pytest.mark.parametrize("S", SAMPLES)
def test_k3_plain_matches_jax_kernel_forward_and_vjp(family, S):
    """The pipeline's K3 branch (`_paper_pass`: prefold, then the plain
    forward and, through autograd, the plain backward) against JAX
    `_fused_conditioning` + `fused_paper_mlp` in interpret mode."""
    small, L, jm, jp, tm = family
    R = 8
    x = _inputs(R, S, seed=S + L + 1)
    enc = EncodeSpec(L, True, True)

    def jax_fn(params, e, lat):
        cond, dc, _ = jax_fused_conditioning(jm, params, jnp.asarray(x["pe_dir"]), e, lat)
        return jax_fused_paper_mlp(params, jnp.asarray(x["ro"]), jnp.asarray(x["rd"]),
                                   jnp.asarray(x["z"]), dc, cond, num_encoding_fn_xyz=L,
                                   small=small)

    jout, vjp = jax.vjp(jax_fn, jp, jnp.asarray(x["expr"]), jnp.asarray(x["latent"]))
    jg_params, jg_expr, jg_latent = vjp(jnp.asarray(x["g"]))
    e = _t(x["expr"]).requires_grad_(True)
    lat = _t(x["latent"]).requires_grad_(True)
    tm.zero_grad(set_to_none=True)
    out = pipeline._paper_pass(tm, _t(x["ro"]), _t(x["rd"]), _t(x["z"]), enc, _t(x["pe_dir"]), e, lat)
    assert out.shape == (R, S, 4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=0.01 * float(np.abs(jout).max()), rtol=0)
    (out * _t(x["g"])).sum().backward()
    grads = dict(tm.named_parameters())
    seen = 0
    for name, want in jg_params.items():
        want = np.asarray(want)
        if not np.any(want):  # layers_dir.3 of the paper model: never applied
            assert grads[name].grad is None, name
            continue
        _close_tensor(name, grads[name].grad.numpy(), want, 0.08, 0.04)
        seen += 1
    assert seen == (22 if small else 24)
    _close_tensor("expr", e.grad.numpy(), jg_expr, 0.08, 0.04)
    _close_tensor("latent", lat.grad.numpy(), jg_latent, 0.08, 0.04)


@pytest.mark.parametrize("S", SAMPLES)
def test_k1_plain_matches_jax_kernel(family, S):
    small, L, jm, jp, tm = family
    R = 16
    x = _inputs(R, S, seed=S + L + 2)
    cond = np.concatenate([x["expr"] / 3.0, x["latent"]]).astype(np.float32)
    off = DIR_OFF if small else 0
    jb = jax_prefold(jp, jnp.asarray(cond), jnp.asarray(x["pe_dir"]), L, small=small, dir_expr_offset=off)
    tb = T.prefold_paper_params(tm.state_dict(), _t(cond), _t(x["pe_dir"]), L, small=small,
                                dir_expr_offset=off)
    kw = dict(noise_std=0.1, loss_scale=2.0 / (3.0 * R), small=small, num_encoding_fn_xyz=L)
    rays = ("ro", "rd", "z", "target")
    jo, jg, _ = jax_train_pass(jb, *(jnp.asarray(x[k]) for k in rays),
                               background=jnp.asarray(x["bg"]), noise=jnp.asarray(x["noise"]), **kw)
    to, tg, _ = T.fused_train_pass_reference(tb, *(_t(x[k]) for k in rays), background=_t(x["bg"]),
                                             noise=_t(x["noise"]), **kw)
    for k in ("rgb", "weights"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=2e-4, rtol=0, err_msg=k)
    wn, bn = K.bundle_names(small)
    names = ["d_cond0", "d_cond3", "d_dir"] + list(wn) + list(bn)
    assert len(tg) == len(jg) == len(names)
    assert tg[names.index("w0b")].shape == (6 * L, 256)
    for name, a, b in zip(names, tg, jg):
        _close_tensor(name, a.numpy(), np.asarray(b), 0.15 if name == "d_dir" else 0.06, 0.04)


# -- (c) the layout --------------------------------------------------------------

MMA = (CSRC / "mma_tile.cuh").read_text()
CHAIN = (CSRC / "wgmma_chain.cuh").read_text()


def _c_expr(expr):
    """A C expression of ints, `a ? b : c` and all, as Python."""
    branch = r"((?:\([^()]*\)|[^():?])+)"
    while "?" in expr:
        new = re.sub(r"\(([^?()]+) \? " + branch + " : " + branch + r"\)", r"((\2) if (\1) else (\3))", expr)
        assert new != expr, expr
        expr = new
    return expr


def _c_constants():
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", MMA)}


def test_wide_offsets_are_the_headers():
    """`w_layout(kx)`'s offsets are `w_off(W_OFF_*, kx)` as the header
    computes it, at every extent (the three-block one too); at K_XIN they
    are the 10-band constants the kernels have always read; F_LAYOUT holds
    31 bands in 32 slots (20 before the three-block image); WT_LAYOUT has
    no encoding row."""
    c = _c_constants()
    assert (c["K_XIN"], c["K_XIN_WIDE"], c["K_XIN_XL"]) == (K.K_XIN, K.K_XIN_WIDE, K.K_XIN_XL) == (64, 128, 192)
    assert "constexpr int MAX_FREQS = (K_XIN_XL - 3) / 6;" in MMA and K.MAX_FREQS == 31
    assert c["FREQ_SLOTS"] == K.FREQ_SLOTS == 32
    body = re.search(r"constexpr int w_off\(int off, int kx\) \{\s*return (.+?);\n\}", MMA, re.S).group(1)
    w_off = eval("lambda off, kx: " + _c_expr(" ".join(body.split())), dict(c))
    w64 = {k[6:]: v for k, v in c.items() if k.startswith("W_OFF_")}
    assert w64 == K.W_OFFSETS == K.w_offsets(64)
    assert K.W_OFFSETS == {"W0": 0, "W1": 16384, "W2": 81920, "W3": 147456, "W4": 229376, "W5": 294912,
                           "WF": 360448, "WD0": 425984, "WD1": 458752, "WD2": 475136, "WA": 491520,
                           "WRGB": 491776, "TOTAL": 492160}
    for kx in (64, 128, 192):
        offs = K.w_offsets(kx)
        assert {name: w_off(v, kx) for name, v in w64.items()} == offs, kx
        assert offs["W1"] == kx * 256 and offs["W4"] - offs["W3"] == (kx + 256) * 256
        # w3h, the skip layer's h2 rows, start kx rows into W3
        assert w_off(w64["W3"] + 64 * 256, kx) == offs["W3"] + kx * 256
    assert K.w_offsets(128)["TOTAL"] == 492160 + 2 * 64 * 256
    f = {k[6:]: v for k, v in c.items() if k.startswith("F_OFF_")}
    assert f == K.F_OFFSETS and f["TOTAL"] - f["FREQS"] == 32
    assert dict(K.F_LAYOUT)["FREQS"] == K.FREQ_SLOTS == K.MAX_FREQS + 1
    train = (CSRC / "paper_train.cuh").read_text()
    wt = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int WT_OFF_(\w+) = (\d+);", train)}
    assert wt == K.WT_OFFSETS and "W3HT" in wt and not any(n.startswith("W0") for n in wt)
    assert [K.xin_extent(L) for L in range(1, 32)] == [64] * 10 + [128] * 10 + [192] * 11
    assert ("return 3 + 6 * n_freqs <= K_XIN ? K_XIN : (3 + 6 * n_freqs <= K_XIN_WIDE ? K_XIN_WIDE : K_XIN_XL);"
            in MMA)


@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("L", [10, 16, 20])
def test_pack_and_split_round_trip(L, small):
    """Packing a bundle at L bands (`pack_kernel_operands`, the weights in
    `w_layout(xin_extent(L))`) and reading the buffer back through the
    kernels' gradient layout (`_split_kernel_grads`) gives every matrix and
    bias row; the zero padding is zero; the chunk images (K2's
    `pack_sm90_chunks`, K1's one gather) unpack to the same buffer."""
    from test_torch_k2_layout import unpack_chunk_image

    g = torch.Generator().manual_seed(L + 100 * small)
    n_enc, kx = 6 * L, K.xin_extent(L)
    wn, bn = K.bundle_names(small)
    shapes = K._matrix_shapes(n_enc)
    widths = {"ba": 1, "brgb": 3, "bd0": K.DIR_HIDDEN, "bd1": K.DIR_HIDDEN, "bd2": K.DIR_HIDDEN}
    W = {n: torch.randn(*shapes[n], generator=g) for n in wn}
    B = {n: torch.randn(widths.get(n, K.HIDDEN), generator=g) for n in bn}
    cond0, cond3 = torch.randn(K.HIDDEN, generator=g), torch.randn(K.HIDDEN, generator=g)
    freqs = K._device_bands(L, True, torch.device("cpu"))
    wbuf, fbuf = K.pack_kernel_operands(cond0, cond3, dict(W, **B), freqs)
    offs = K.w_offsets(kx)
    assert wbuf.numel() == offs["TOTAL"] and fbuf.numel() == K.F_OFFSETS["TOTAL"]
    (c0, c3), gw, gb = K._split_kernel_grads(wbuf.float(), fbuf, n_enc, small)
    for n in wn:
        assert torch.equal(gw[n], W[n].to(torch.bfloat16).float()), n
    for n in bn:
        assert torch.equal(gb[n].reshape(-1), B[n]), n
    assert torch.equal(c0.reshape(-1), cond0) and torch.equal(c3.reshape(-1), cond3)
    fr = fbuf[K.F_OFFSETS["FREQS"]:K.F_OFFSETS["TOTAL"]]
    assert torch.equal(fr[:L], freqs.float()) and not fr[L:].any()
    w0 = wbuf[offs["W0"]:offs["W1"]].reshape(kx, K.HIDDEN)
    w3 = wbuf[offs["W3"]:offs["W4"]].reshape(kx + K.HIDDEN, K.HIDDEN)
    assert not w0[3 + n_enc:].float().any() and not w3[3 + n_enc:kx].float().any()
    img = K.pack_sm90_chunks(wbuf, kx)
    assert img.numel() == offs["TOTAL"]
    for name, k, n in K.w_layout(kx):
        got = img[offs[name]:offs[name] + k * n]
        if name in K.SM90_CHUNKED:
            got = unpack_chunk_image(got, k, n)
        assert torch.equal(got.reshape(k, n).view(torch.int16),
                           wbuf[offs[name]:offs[name] + k * n].reshape(k, n).view(torch.int16)), name
    bundle = [cond0[None], cond3[None], torch.zeros(4, K.DIR_HIDDEN)] + [W[n] for n in wn] + [B[n][None] for n in bn]
    _, w_img, f_img, wt_img = K._kernel_operands(bundle, 4, torch.device("cpu"), L, True, small, transposed=True)
    assert torch.equal(w_img.view(torch.int16), img.view(torch.int16)) and torch.equal(f_img, fbuf)
    assert wt_img.numel() == K.WT_OFFSETS["TOTAL"]


def _encoder_writes(xc):
    """The bytes each encode task of a unit writes, as `encode_units` /
    `encode_task` compute them: task t < 128·xc, row t % 64, columns
    [32·(t / 64), +32) in pairs, column c at block c / 64 (XIN_BYTES apart)
    + sw128(row, c % 64). Returns {(row, col): byte offset}."""
    xin_bytes = 64 * 128

    def sw128(row, col):
        return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1)

    seen = {}
    for task in range(128 * xc):
        r, c0 = task & 63, (task >> 6) * 32
        block = (c0 >> 6) * xin_bytes
        for j in range(0, 32, 2):
            c = c0 + j
            off = block + sw128(r, c & 63)
            for e in (0, 1):  # the pair's two bf16
                assert (r, c + e) not in seen, (task, r, c + e)
                seen[(r, c + e)] = off + 2 * e
    return seen


@pytest.mark.parametrize("xc", [1, 2])
def test_encoder_writes_every_column_once(xc):
    """The encoder's tasks at xc blocks (one at ≤ 10 bands, two from 11)
    write each of the 64·xc columns of every row exactly once, each at its
    own bytes of the 8·xc KB image, which are the workspace image's
    (`fused_train.workspace_image`, the bytes K1's dW reads)."""
    assert "const int xc = g.xc(), tasks = 128 * xc;" in CHAIN
    assert "for (int task = e; task < tasks; task += CHAIN_ENCODERS * 32)" in CHAIN
    assert "const int block = (c0 >> 6) * XIN_BYTES;  // the task's 32 columns lie in one block" in CHAIN
    assert "const int off = block + sw128(r, c & 63);" in CHAIN
    assert "const int n_cols = row < g.rows() && ray < a.n_rays ? 3 + 6 * a.n_freqs : 0;" in CHAIN
    seen = _encoder_writes(xc)
    kx = 64 * xc
    assert set(seen) == {(r, c) for r in range(64) for c in range(kx)}
    assert sorted(seen.values()) == list(range(0, 64 * kx * 2, 2))
    m = torch.arange(64 * kx, dtype=torch.int32).reshape(64, kx).to(torch.int16).view(torch.bfloat16)
    img = T.workspace_image(m).view(torch.int16).numpy().view(np.uint16)
    for (r, c), off in seen.items():
        assert int(img[off // 2]) == (r * kx + c) & 0xFFFF, (r, c)


def test_one_xin_buffer_a_warpgroup_at_two_blocks():
    """At xc = 2 a warpgroup's two 8 KB buffers are one 16 KB buffer: every
    unit uses buffer 0 and its barriers' phase flips each unit; at xc = 1
    the units alternate the two buffers, each phase flipping every second
    unit. The encoder waits on the empty barrier's other parity."""
    assert "int xin_buf(int k, int xc) { return xc == 1 ? k & 1 : 0; }" in CHAIN
    assert "int xin_phase(int k, int xc) { return xc == 1 ? (k >> 1) & 1 : k & 1; }" in CHAIN
    assert "mbar_wait(&xin_empty[wg][b], xin_phase(done[wg], xc) ^ 1);" in CHAIN
    assert "int xc() const { return SF ? 1 : l.xc; }" in CHAIN
    # the unit k's buffer is free again once unit k - nb (its last user) has arrived
    for xc, nb in ((1, 2), (2, 1)):
        uses = {}
        for k in range(12):
            b = (k & 1) if xc == 1 else 0
            ph = ((k >> 1) & 1) if xc == 1 else (k & 1)
            n = uses.setdefault(b, 0)
            assert ph == n & 1, (xc, k)  # the n-th use of a buffer waits for phase n % 2
            uses[b] = n + 1
        assert len(uses) == nb
    sources = [(CSRC / n).read_text() for n in ("fused_paper_render.cu", "fused_paper_mlp.cu", "paper_train.cuh")]
    assert all("xin_buf(" in s and "xin_phase(" in s for s in sources)


# -- (d) the slice: a 16-band step ------------------------------------------------

def test_16_band_step_matches_jax_fused_step():
    """A 16-band paper avatar's bf16 step at 16 + 16 samples through
    `fused_losses` (K1's plain version for both passes) against the JAX
    package's fused step (its Pallas kernel in interpret mode) from the
    same weights, batch and draws."""
    from test_torch_train import SC, SF, _jax_draws

    L, R = 16, 64
    jm = JAX_MODELS[FAMILY[False]](**_kw(L))
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    params = {"coarse": dict(jp), "fine": dict(jp), "background": None,
              "latent_codes": jnp.asarray(rng.randn(4, 32).astype(np.float32) * 0.1)}
    jopt = jax_build_optimizer(JaxCfgNode(_opt_cfg()))
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params, opt_state=jopt.init(params),
                           fixed_background=None)
    flags, jflags = FeatureFlags(), JaxFlags()

    def port_model():
        return MODELS[FAMILY[False]](**_kw(L), generator=torch.Generator().manual_seed(0))

    state = create_train_state(port_model(), port_model(), flags, n_train=4)
    opt = build_optimizer(CfgNode(_opt_cfg()), state)
    ckpt.train_state_from_jax(jax.device_get(jstate), state, opt)
    tset, jset = _settings(L, 0.1, SC, SF)
    assert fused_train_eligible(state.model_coarse, state.model_fine, tset, flags, torch.bfloat16, "cuda",
                                num_rays=R)
    jb, tb = _batch(R, seed=13)
    key = jax.random.PRNGKey(2)
    (jtot, jmet), jg = jax_fused_value_and_grad(jstate.params, jb, key, jm, jm, jset, jflags,
                                                jstate.fixed_background)
    total, metrics = fused_losses(state, tb, 0, tset, flags, draws=_jax_draws(key, R))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtot), rtol=1e-3)
    for k in jmet:
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]), rtol=1e-3, atol=1e-6, err_msg=k)
    port = _port_grads(state)
    seen = 0
    for path, v in jax.tree_util.tree_leaves_with_path(jg):
        name, v = jax.tree_util.keystr(path), np.asarray(v)
        got = port[name]
        if got is None:  # never reached the loss (layers_dir.3)
            assert not np.any(v), name
            continue
        tol = 0.06 if name.startswith("['fine']") else 5e-3
        np.testing.assert_allclose(got.numpy(), v, atol=tol * np.abs(v).max() + 1e-9, rtol=0, err_msg=name)
        seen += 1
    assert seen >= 30
    assert port["['coarse']['layers_xyz.0.weight']"].shape == (256, 3 + 6 * L + 108)
