"""PyTorch port: the paper-family kernels (K2, K3f, K3b, K1) at every sample
count their TPU kernels take.

* (a) Dispatch. `fused_train_eligible` and `render/pipeline.py`'s
  `_fused_render_eligible` / `_paper_kernels_take`, asked for the card
  (`device="cuda"`, no card needed), admit exactly what the JAX package's
  tile rule admits (`_pick_rays_per_tile` finds a tile: the test of
  `fused_paper_mlp_available` without its TPU-backend test) for every S in
  1..256 and a few ray counts, and past 256 up to the kernels' limit
  (`fused_mlp.MAX_SAMPLES`, 1024 since the long items; 256 before), and
  refuse above it, where a direct wrapper call raises a ValueError that
  names the limit. `unit_layout`'s items hold whole rays in at most four
  64-row units up to S = 256, one ray in ⌈S / 64⌉ units past it
  (tests/test_torch_long_rays.py holds S past 256).
* (b) The plain versions against the JAX package's Pallas kernels in
  interpret mode at S ∈ {16, 24, 48, 96, 192}, the paper and the smaller
  model, draws injected: K2 `fused_paper_render_reference` against
  `fused_paper_render` (rgb / acc / bg_weight / weights atol 2e-3, depth
  2e-3·far, disp rtol 1e-2: tests/test_torch_smaller.py's limits); K3
  through the pipeline's `_paper_pass` (the plain forward and backward)
  against `fused_paper_mlp` and `jax.vjp` (forward 0.01·max, K3f's limit
  in chip_smoke.py, K3_OUT_TOL; gradients 0.08·max / 0.04·‖·‖:
  tests/test_torch_paper_mlp.py's); K1 `fused_train_pass_reference`
  against `fused_train_pass` with σ-noise and a background (rgb / weights
  atol 2e-4: tests/test_torch_train_kernel.py's; each gradient within
  chip_smoke.py's `k1_grad_limits` for a pass of few rays, 0.06·max, 0.15
  on d_dir, / 0.04·‖·‖). Both sides round the same operands to bf16; the
  f32 sums run in other orders, so a bf16 rounding flips here and there,
  and with more sample rows than the older files' S = 16 / 32 more of
  them: one flip moved a K3 output by 1.9e-3·max (S = 16, the paper
  model) and a K1 gradient element by 7.6e-3·max (w2, the smaller model,
  S = 96: 4 of its 65536), past those files' 1e-3 and 5e-3.
* (c) The reenactment demo's bf16 step at 16 + 16 samples through
  `train/fused.py::fused_losses` (K1's plain version) against the JAX
  package's fused step `fused_value_and_grad` (its Pallas kernel in
  interpret mode), with the JAX draws: the same limits as K1's (b) on
  every gradient, the loss and metrics at rtol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.ops.pallas.fused_mlp import _pick_rays_per_tile as jax_pick_rays_per_tile
from nerface_tpu.ops.pallas.fused_mlp import fused_paper_mlp as jax_fused_paper_mlp
from nerface_tpu.ops.pallas.fused_mlp import fused_paper_render as jax_fused_render
from nerface_tpu.ops.pallas.fused_train import fused_train_pass as jax_train_pass
from nerface_tpu.ops.pallas.fused_train import prefold_paper_params as jax_prefold
from nerface_tpu.render.pipeline import _fused_conditioning as jax_fused_conditioning
from nerface_tpu.train.fused import fused_value_and_grad as jax_fused_value_and_grad
from nerface_tpu_torch.config.flags import FeatureFlags
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_train as T
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.render.pipeline import EncodeSpec
from nerface_tpu_torch.train.checkpoint import params_from_jax
from nerface_tpu_torch.train.fused import fused_losses, fused_train_eligible
from test_torch_train import _batch, _jax_draws, _pair, _port_grads, _settings

torch.set_num_threads(1)

KW = dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False)
FAMILY = {False: "ConditionalBlendshapePaperNeRFModel",
          True: "ConditionalBlendshapePaperSmallerNeRFModel"}
ENC = EncodeSpec(10, True, True)
FAR = 0.8
DIR_OFF = 256 + 24  # the smaller model's expression block of layers_dir.0
NEW_S = [16, 24, 48, 96, 192]
RAY_COUNTS = [0, 8, 16, 301, 512, 2048, 4100, 65536]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_rule(n_rays, n_samples):
    """The JAX package's rule for its Pallas kernels: a ray tile of
    `_pick_rays_per_tile` (`fused_paper_mlp_available` without its
    TPU-backend test)."""
    tr = jax_pick_rays_per_tile(n_rays, n_samples)
    return tr >= 8 and n_rays % tr == 0


# -- (a) dispatch --------------------------------------------------------------

@pytest.fixture(scope="module")
def paper_models():
    return {small: MODELS[FAMILY[small]](**KW, generator=torch.Generator().manual_seed(1))
            for small in (False, True)}


@pytest.mark.parametrize("n_rays", RAY_COUNTS)
def test_train_eligibility_is_the_jax_tile_rule(paper_models, n_rays):
    """K1 takes a step on the card exactly where the JAX package's
    `fused_train_available` would send both passes to Pallas, for every
    coarse S in 1..256 and fine counts up to a merged MAX_SAMPLES (1024);
    past it it refuses. On the CPU it takes any ray count within the same
    domain."""
    tset, _ = _settings()
    flags = FeatureFlags()
    m = paper_models[False]
    top = K.MAX_SAMPLES
    for sc in range(1, 257):
        for sf in sorted({1, 7, 16, 64, 128, 256 - sc, 257 - sc, top - sc, top + 1 - sc} - {0}):
            s = dataclasses.replace(tset, num_coarse=sc, num_fine=sf)
            got = fused_train_eligible(m, m, s, flags, torch.bfloat16, "cuda", num_rays=n_rays)
            want = sc + sf <= top and _jax_rule(n_rays, sc) and _jax_rule(n_rays, sc + sf)
            assert got == want, (n_rays, sc, sf)
            assert fused_train_eligible(m, m, s, flags, torch.bfloat16, "cpu", n_rays) == (sc + sf <= top)


@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("n_rays", RAY_COUNTS)
def test_render_dispatch_is_the_jax_tile_rule(paper_models, n_rays, small):
    """K2 (`_fused_render_eligible`) and K3 (`_paper_kernels_take`, the
    `_apply_model` branch) take a pass on the card exactly where the JAX
    package sends it to Pallas, S in 1..MAX_SAMPLES (1024; S in 1..299
    here, and S around the limit); never above it."""
    tset, _ = _settings(noise=0.0)
    settings = dataclasses.replace(tset, fused_render=True)
    m = paper_models[small]
    pe_dir, expr, latent = torch.zeros(2, 24), torch.zeros(76), torch.zeros(32)
    top = K.MAX_SAMPLES
    for S in list(range(1, 300)) + [top - 1, top, top + 1, top + 2]:
        want = S <= top and _jax_rule(n_rays, S)
        for dev in ("cuda", torch.device("cuda", 0)):
            assert pipeline._fused_render_eligible(m, n_rays, S, pe_dir, expr, latent, settings,
                                                   torch.bfloat16, dev) == want, (n_rays, S)
        assert pipeline._paper_kernels_take(n_rays, S, "cuda") == want, (n_rays, S)
        assert pipeline._paper_kernels_take(n_rays, S, "cpu") == (S <= top)
        assert K.kernel_pass_ok(n_rays, S) == want


def test_wrappers_raise_past_the_limit():
    """A direct call at S = MAX_SAMPLES + 1 (1025; or 0) raises a ValueError
    naming the limit, on the CPU too, whose wrappers run the plain
    versions."""
    bundle, rays = _paper_case(2, K.MAX_SAMPLES + 1)
    ro, rd, z = rays["ro"], rays["rd"], rays["z"]
    calls = {
        "K3f": lambda: K.fused_paper_mlp_forward(bundle, ro, rd, z),
        "K3b": lambda: K.fused_paper_mlp_backward(bundle, ro, rd, z, rays["g"]),
        "K1": lambda: T.fused_train_pass(bundle, ro, rd, z, rays["tgt"], loss_scale=1.0),
        "K2": lambda: K.fused_paper_render(
            MODELS[FAMILY[False]](**KW).state_dict(), ro, rd, z, torch.zeros(2, 128),
            torch.zeros(108)),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match=r"1\.\.1024 samples per ray"):
            call()
    with pytest.raises(ValueError, match=r"1\.\.1024 samples per ray"):
        K.check_samples(0)


def test_layout_class_builds():
    """K1's and K3's libraries build as two builds (`build.layout_library`):
    S = 64 and 128, each a fixed layout class, in the build that holds the
    fixed classes (`csrc/mma_tile.cuh`: NERFACE_SAMPLE_CLASSES bit 2, the
    `dispatch_pass` cases 128 / 129 / 256 / 257), every other S in the one
    of the runtime class (bit 1)."""
    import pathlib
    import re

    from nerface_tpu_torch.ops.kernels import build

    src = (pathlib.Path(build.__file__).resolve().parents[2] / "csrc" / "mma_tile.cuh").read_text()
    fixed = sorted({int(c) // 2 for c in re.findall(r"case (\d+):", src)})
    assert tuple(fixed) == build.FIXED_SAMPLES == (64, 128)
    assert "#if NERFACE_SAMPLE_CLASSES & 2" in src and "#if NERFACE_SAMPLE_CLASSES & 1" in src
    for S in range(1, K.MAX_SAMPLES + 1):
        want = "NERFACE_SAMPLE_CLASSES=2" if S in fixed else "NERFACE_SAMPLE_CLASSES=1"
        assert build.sample_class_defines(S) == (want,), S


def _paper_case(R, S):
    from nerface_tpu_torch.tools.perf.cases import paper_case

    return paper_case(R, S, 0, torch.device("cpu"))


def test_unit_layout_holds_whole_rays():
    """At every S in 1..256 (ITEM_ROWS) an item is whole rays in 1..4 units
    (256 rows at most); where S divides 64 or is a multiple of it the units
    hold no padding, and otherwise no other ray count up to 256 / S pads a
    smaller share. Past 256 up to MAX_SAMPLES an item is one ray in ⌈S /
    64⌉ units (a long item)."""
    for S in range(K.ITEM_ROWS + 1, K.MAX_SAMPLES + 1):
        assert K.unit_layout(S) == (1, -(-S // 64)), S
    for S in range(1, K.ITEM_ROWS + 1):
        rays, units = K.unit_layout(S)
        assert 1 <= units <= 4 and rays >= 1, S
        assert (units - 1) * 64 < rays * S <= units * 64 <= K.ITEM_ROWS, S
        if 64 % S == 0 or S % 64 == 0:
            assert rays * S == units * 64, S
        for n in range(1, K.ITEM_ROWS // S + 1):
            u = -(-(n * S) // 64)
            assert n * units <= rays * u, (S, n)  # n's share of real rows is no larger


# -- (b) the plain versions against the TPU kernels ------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["paper", "small"])
def family(request):
    """(small, JAX model, JAX params, the port's module on the same weights)."""
    small = request.param
    jm = JAX_MODELS[FAMILY[small]](**KW)
    jp = jm.init(jax.random.PRNGKey(11))
    tm = MODELS[FAMILY[small]](**KW)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}), strict=True)
    return small, jm, jp, tm


def _inputs(R, S, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(
        ro=(rng.randn(R, 3) * 0.05 + [0, 0, 0.5]).astype(f),
        rd=(rng.randn(R, 3) * [0.2, 0.2, 0.05] - [0, 0, 1]).astype(f),
        z=(0.2 + np.cumsum(rng.rand(R, S) * ((FAR - 0.2) / S), -1)).astype(f),
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


@pytest.mark.parametrize("S", NEW_S)
def test_k2_plain_matches_jax_kernel(family, S):
    small, jm, jp, tm = family
    x = _inputs(16, S, seed=S)
    jcond, jdc, _ = jax_fused_conditioning(jm, jp, jnp.asarray(x["pe_dir"]),
                                           jnp.asarray(x["expr"]), jnp.asarray(x["latent"]))
    ref = jax_fused_render(jp, jnp.asarray(x["ro"]), jnp.asarray(x["rd"]), jnp.asarray(x["z"]),
                           jdc, jcond, background=jnp.asarray(x["bg"]), out_weights=True,
                           small=small)
    got = K.fused_paper_render_reference(
        tm.state_dict(), _t(x["ro"]), _t(x["rd"]), _t(x["z"]), _t(jdc), _t(jcond),
        background=_t(x["bg"]), out_weights=True, small=small)
    assert set(got) == set(ref) and got["weights"].shape == (16, S)
    for k in ("rgb", "acc", "bg_weight", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=2e-3, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(ref["depth"]), atol=2e-3 * FAR,
                               rtol=0)
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(ref["disp"]), rtol=1e-2)


@pytest.mark.parametrize("S", NEW_S)
def test_k3_plain_matches_jax_kernel_forward_and_vjp(family, S):
    """The pipeline's K3 branch (`_paper_pass`: prefold, then the plain
    forward and, through autograd, the plain backward) against JAX
    `_fused_conditioning` + `fused_paper_mlp` in interpret mode."""
    small, jm, jp, tm = family
    R = 8
    x = _inputs(R, S, seed=S + 1)

    def jax_fn(params, e, lat):
        cond, dc, _ = jax_fused_conditioning(jm, params, jnp.asarray(x["pe_dir"]), e, lat)
        return jax_fused_paper_mlp(params, jnp.asarray(x["ro"]), jnp.asarray(x["rd"]),
                                   jnp.asarray(x["z"]), dc, cond, num_encoding_fn_xyz=10,
                                   small=small)

    jout, vjp = jax.vjp(jax_fn, jp, jnp.asarray(x["expr"]), jnp.asarray(x["latent"]))
    jg_params, jg_expr, jg_latent = vjp(jnp.asarray(x["g"]))
    e = _t(x["expr"]).requires_grad_(True)
    lat = _t(x["latent"]).requires_grad_(True)
    tm.zero_grad(set_to_none=True)
    out = pipeline._paper_pass(tm, _t(x["ro"]), _t(x["rd"]), _t(x["z"]), ENC, _t(x["pe_dir"]),
                               e, lat)
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


@pytest.mark.parametrize("S", NEW_S)
def test_k1_plain_matches_jax_kernel(family, S):
    small, jm, jp, tm = family
    R = 16
    x = _inputs(R, S, seed=S + 2)
    cond = np.concatenate([x["expr"] / 3.0, x["latent"]]).astype(np.float32)
    off = DIR_OFF if small else 0
    jb = jax_prefold(jp, jnp.asarray(cond), jnp.asarray(x["pe_dir"]), 10, small=small,
                     dir_expr_offset=off)
    tb = T.prefold_paper_params(tm.state_dict(), _t(cond), _t(x["pe_dir"]), 10, small=small,
                                dir_expr_offset=off)
    kw = dict(noise_std=0.1, loss_scale=2.0 / (3.0 * R), small=small)
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
    for name, a, b in zip(names, tg, jg):
        _close_tensor(name, a.numpy(), np.asarray(b), 0.15 if name == "d_dir" else 0.06, 0.04)


# -- (c) the demo's step at 16 + 16 ----------------------------------------------

def test_demo_step_at_16_plus_16_matches_jax_fused_step():
    """The 64² reenactment regime's sample counts (`tools/reenactment_demo.py`:
    16 + 16) through `fused_losses` in bf16 on the CPU (K1's plain version
    for both passes) against the JAX package's fused step."""
    jm, jstate, _, jflags, state, _, flags = _pair({})
    tset, jset = _settings(0.1)
    assert (tset.num_coarse, tset.num_fine) == (16, 16)
    R = 64
    assert fused_train_eligible(state.model_coarse, state.model_fine, tset, flags,
                                torch.bfloat16, "cuda", num_rays=R)
    jb, tb = _batch(R, seed=11)
    key = jax.random.PRNGKey(1)
    (jtot, jmet), jg = jax_fused_value_and_grad(jstate.params, jb, key, jm, jm, jset, jflags,
                                                jstate.fixed_background)
    total, metrics = fused_losses(state, tb, 0, tset, flags, draws=_jax_draws(key, R))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtot), rtol=1e-3)
    for k in jmet:
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]), rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    port = _port_grads(state)
    seen = 0
    for path, v in jax.tree_util.tree_leaves_with_path(jg):
        name, v = jax.tree_util.keystr(path), np.asarray(v)
        got = port[name]
        if got is None:  # never reached the loss (layers_dir.3)
            assert not np.any(v), name
            continue
        np.testing.assert_allclose(got.numpy(), v, atol=5e-3 * np.abs(v).max() + 1e-9, rtol=0,
                                   err_msg=name)
        seen += 1
    assert seen >= 30
