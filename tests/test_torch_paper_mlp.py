"""PyTorch port, K3 (`fused_paper_mlp`, forward K3f and backward K3b) and the
paper family's passes that K1 and K2 do not take, held against the JAX
package on the CPU.

Tolerances, with their reasons:

* The plain version in bf16 against the JAX package's Pallas
  `fused_paper_mlp`, run in interpret mode as tests/test_pallas.py runs
  it, both modes (the paper model and the smaller one): raw [rgb, σ] atol
  1e-3·max — both round the same operands to bf16 at the same points, and
  only the f32 sum order differs, which can flip an activation's bf16
  rounding. Gradients through `jax.vjp` and through the port's autograd
  (prefold → K3 → the parameters, the expression and the latent code):
  each tensor's max error ≤ 0.08·max and norm error ≤ 0.04·norm, K4's
  limits (tests/test_torch_flex_kernel.py): the bf16 cotangents and the
  bf16 rounding of the matrix gradients flip here and there.
* The autograd.Function on CPU tensors in f32 against torch autograd of
  the same f32 forward: atol 1e-5·max (f32 sums in another order).
* The repair: a bf16 coarse-only step of the paper model at σ-noise 0
  against `jax.value_and_grad(_compute_losses)` (f32): loss rtol 0.03,
  every parameter JAX gives a nonzero gradient gets one, within 0.25·max
  + 2e-6 (tests/test_torch_train.py's envelope for bf16 against f32).
  Before the repair the port rendered that pass through K2, which has no
  backward, and 1 of the coarse model's 26 parameters got a gradient.
* `train()` of both packages, f32, 3 steps of a coarse-only config: losses
  rtol 1e-4, parameters as tests/test_torch_train.py holds them.

The CUDA kernels themselves are tested in tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import copy
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerface_tpu.native
from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.data.flame import load_flame_data as jax_load_flame_data
from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.ops.pallas.fused_mlp import fused_paper_mlp as jax_fused_paper_mlp
from nerface_tpu.render.pipeline import _fused_conditioning as jax_fused_conditioning
from nerface_tpu.train.loop import train as jax_train
from nerface_tpu.train.step import _compute_losses
from nerface_tpu_torch.config import CfgNode
from nerface_tpu_torch.data.flame import load_flame_data
from nerface_tpu_torch.eval.renderer import render_full_frame
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings
from nerface_tpu_torch.train.checkpoint import params_from_jax
from nerface_tpu_torch.train.loop import build_models_from_cfg, train
from nerface_tpu_torch.train.step import compute_losses
from test_torch_train import (  # noqa: F401 (dataset_dir is a fixture)
    _batch,
    _pair,
    _settings,
    _train_cfg,
    dataset_dir,
)

torch.set_num_threads(1)

KW = dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False)
FAMILY = {False: "ConditionalBlendshapePaperNeRFModel",
          True: "ConditionalBlendshapePaperSmallerNeRFModel"}
ENC = EncodeSpec(10, True, True)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=[False, True], ids=["paper", "small"])
def family(request):
    """(small, JAX model, JAX params, the port's module on the same weights)."""
    small = request.param
    jm = JAX_MODELS[FAMILY[small]](**KW)
    jp = jm.init(jax.random.PRNGKey(7))
    tm = MODELS[FAMILY[small]](**KW)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}), strict=True)
    return small, jm, jp, tm


def _inputs(R, S, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    ro = (rng.randn(R, 3) * 0.05 + [0, 0, 0.5]).astype(f)
    rd = (rng.randn(R, 3) * [0.2, 0.2, 0.05] - [0, 0, 1]).astype(f)
    z = (0.2 + np.cumsum(rng.rand(R, S) * (1.2 / S), -1)).astype(f)
    pe_dir = rng.randn(R, 24).astype(f)
    expr = (rng.randn(76) * 0.5).astype(f)
    latent = (rng.randn(32) * 0.1).astype(f)
    g = rng.randn(R, S, 4).astype(f)
    return ro, rd, z, pe_dir, expr, latent, g


def _close_tensor(name, got, want, max_tol, norm_tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    d = got - want
    assert np.abs(d).max() <= max_tol * np.abs(want).max() + 1e-9, (name, np.abs(d).max())
    assert np.linalg.norm(d) <= norm_tol * np.linalg.norm(want) + 1e-9, name


def test_plain_matches_jax_kernel_forward_and_vjp(family):
    """The pipeline's K3 branch (`_paper_pass`: prefold → fused_paper_mlp)
    against JAX `_fused_conditioning` + `fused_paper_mlp` in interpret mode."""
    small, jm, jp, tm = family
    R, S = 8, 16
    ro, rd, z, pe_dir, expr, latent, g = _inputs(R, S, seed=3)

    def jax_fn(params, e, lat):
        cond, dc, jsmall = jax_fused_conditioning(jm, params, jnp.asarray(pe_dir), e, lat)
        assert jsmall is small
        return jax_fused_paper_mlp(params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), dc,
                                   cond, num_encoding_fn_xyz=10, rays_per_tile=4, small=small)

    jout, vjp = jax.vjp(jax_fn, jp, jnp.asarray(expr), jnp.asarray(latent))
    jg_params, jg_expr, jg_latent = vjp(jnp.asarray(g))

    e, lat = _t(expr).requires_grad_(True), _t(latent).requires_grad_(True)
    tm.zero_grad(set_to_none=True)
    out = pipeline._paper_pass(tm, _t(ro), _t(rd), _t(z), ENC, _t(pe_dir), e, lat)
    assert out.shape == (R, S, 4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-3 * float(np.abs(jout).max()), rtol=0)
    (out * _t(g)).sum().backward()
    grads = dict(tm.named_parameters())
    seen = 0
    for name, want in jg_params.items():
        want = np.asarray(want)
        got = grads[name].grad
        if not np.any(want):  # layers_dir.3 of the paper model: never applied
            assert got is None, name
            continue
        _close_tensor(name, got.numpy(), want, 0.08, 0.04)
        seen += 1
    assert seen == (22 if small else 24)  # all but the unused layers_dir.3
    _close_tensor("expr", e.grad.numpy(), jg_expr, 0.08, 0.04)
    _close_tensor("latent", lat.grad.numpy(), jg_latent, 0.08, 0.04)


def test_autograd_function_f32_equals_autograd(family):
    """In f32 the Function's backward (recompute + the hand-written trunk
    backward) is torch autograd of its forward; in bf16 its matrix
    gradients leave rounded to bf16."""
    small, _, _, tm = family
    R, S = 6, 32
    ro, rd, z, pe_dir, expr, latent, g = _inputs(R, S, seed=4)
    from nerface_tpu_torch.ops.kernels.fused_train import prefold_paper_params

    base = [t.detach() for t in prefold_paper_params(
        dict(tm.named_parameters()), _t(np.concatenate([expr / 3.0, latent]).astype(np.float32)),
        _t(pe_dir), 10, small=small, dir_expr_offset=(256 + 24) if small else 0)]
    a = [t.clone().requires_grad_(True) for t in base]
    out = K.fused_paper_mlp(a, _t(ro), _t(rd), _t(z), small=small, mm_dtype=torch.float32)
    (out * _t(g)).sum().backward()

    b = [t.clone().requires_grad_(True) for t in base]
    cond0, cond3, dir_c, W, B = K._unbundle(b, small)
    W.update(B)
    x3 = K._points(_t(ro), _t(rd), _t(z))
    enc = K._encode_points(x3, 10, True)
    rgb, sigma, _ = K._trunk_forward_reference(W, cond0, cond3, dir_c, x3, enc, R, S, torch.float32)
    ref = torch.cat([rgb, sigma[..., None]], -1)
    torch.testing.assert_close(out, ref.detach(), atol=1e-6, rtol=0)
    (ref * _t(g)).sum().backward()
    for i, (x, y) in enumerate(zip(a, b)):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-5 * float(y.grad.abs().max()) + 1e-12,
                                   rtol=0, msg=f"bundle[{i}]")

    c = [t.clone().requires_grad_(True) for t in base]
    (K.fused_paper_mlp(c, _t(ro), _t(rd), _t(z), small=small) * _t(g)).sum().backward()
    n_w = len(K.bundle_names(small)[0])
    for i, t in enumerate(c):
        rounded = torch.equal(t.grad, t.grad.to(torch.bfloat16).float())
        assert rounded or not 3 <= i < 3 + n_w, i


def test_wrappers_on_cpu_are_the_plain_versions(family):
    small, _, _, tm = family
    ro, rd, z, pe_dir, expr, latent, g = _inputs(4, 16, seed=5)
    from nerface_tpu_torch.ops.kernels.fused_train import prefold_paper_params

    bundle = prefold_paper_params(
        dict(tm.named_parameters()), _t(np.concatenate([expr / 3.0, latent]).astype(np.float32)),
        _t(pe_dir), 10, small=small)
    args = (bundle, _t(ro), _t(rd), _t(z))
    before = (K.fused_paper_mlp_forward.launches, K.fused_paper_mlp_backward.launches)
    assert torch.equal(K.fused_paper_mlp_forward(*args, small=small),
                       K.fused_paper_mlp_reference(*args, small=small))
    for x, y in zip(K.fused_paper_mlp_backward(*args, _t(g), small=small),
                    K.fused_paper_mlp_backward_reference(*args, _t(g), small=small)):
        assert torch.equal(x, y)
    assert (K.fused_paper_mlp_forward.launches, K.fused_paper_mlp_backward.launches) == before
    with pytest.raises(ValueError, match="bundle has"):
        K.fused_paper_mlp_forward(bundle, *args[1:], small=not small)
    meta = [torch.empty(t.shape, device="meta") for t in args[1:]]
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.fused_paper_mlp_forward(bundle, *meta, small=small)


def test_bf16_coarse_only_step_trains_every_weight():
    """The fault this repairs: a bf16 pass of `render_rays` outside the
    full-frame renderer went through K2, which has no backward, so a bf16
    coarse-only step (K1 refuses num_fine 0) trained almost nothing. Now
    the pass's MLP is K3, whose backward reaches every weight."""
    jm, jstate, _, jflags, state, _, flags = _pair({})
    # σ raised in both packages: at the default init σ ≤ 0 everywhere, the
    # fixed background on the last sample makes every pixel, and nothing
    # reaches the weights
    jstate.params["coarse"]["fc_alpha.bias"] = jstate.params["coarse"]["fc_alpha.bias"] + 2.0
    with torch.no_grad():
        state.model_coarse.fc_alpha.bias += 2.0
    tset, jset = _settings(noise=0.0, perturb=False)
    # 32 samples: a count the kernels are built for, where the pass could
    # take K2
    tset = dataclasses.replace(tset, num_coarse=32, num_fine=0)
    jset = dataclasses.replace(jset, num_coarse=32, num_fine=0)
    R = 32
    jb, tb = _batch(R, seed=13)
    key = jax.random.PRNGKey(2)

    def loss_fn(params):
        return _compute_losses(params, jb, key, jm, jm, jset, jflags, jstate.fixed_background)

    (jtot, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    total, _ = compute_losses(state, tb, 0, tset, flags, dtype=torch.bfloat16)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtot), rtol=0.03)
    n_nonzero = 0
    for name, p in state.model_coarse.named_parameters():
        want = np.asarray(jg["coarse"][name])
        if not np.any(want):
            continue
        n_nonzero += 1
        assert p.grad is not None, f"{name}: JAX gives a gradient, the port none"
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=0.25 * np.abs(want).max() + 2e-6, err_msg=name)
    assert n_nonzero == 24  # all 26 but layers_dir.3, never applied
    want = np.asarray(jg["latent_codes"])
    np.testing.assert_allclose(state.latent_codes.grad.numpy(), want, rtol=0,
                               atol=0.25 * np.abs(want).max() + 2e-6)
    assert all(p.grad is None for p in state.model_fine.parameters())


def test_only_the_full_frame_renderer_takes_k2(monkeypatch):
    """K2 runs where `settings.fused_render` is set: `render_full_frame`
    sets it (eval is never differentiated); a bf16 `render_rays` call
    elsewhere goes through K3, and so does a frame at σ-noise > 0."""
    calls = {"K2": 0, "K3": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(pipeline, "fused_paper_render", spy("K2", pipeline.fused_paper_render))
    monkeypatch.setattr(pipeline, "fused_paper_mlp", spy("K3", pipeline.fused_paper_mlp))
    m = MODELS[FAMILY[False]](**KW, generator=torch.Generator().manual_seed(1))
    settings = RenderSettings(num_coarse=32, num_fine=32, perturb=False,
                              encode_xyz=ENC, encode_dir=EncodeSpec(4, False, True))
    expr, latent = torch.randn(76) * 0.1, torch.randn(32) * 0.1
    intr = np.array([8.0, 8.0, 0.5, 0.5], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 1.0

    def frame(s):
        return render_full_frame(m, m, 4, 4, intr, pose, s, expressions=expr, latent_code=latent,
                                 dtype=torch.bfloat16, device="cpu")

    frame(settings)
    assert calls == {"K2": 2, "K3": 0}
    ro, rd = torch.zeros(8, 3), torch.randn(8, 3)
    out = pipeline.render_rays(m, m, ro, rd, settings, expressions=expr, latent_code=latent,
                               dtype=torch.bfloat16)
    assert calls == {"K2": 2, "K3": 2} and out["rgb_fine"].shape == (8, 3)
    frame(dataclasses.replace(settings, radiance_field_noise_std=0.1))
    assert calls == {"K2": 2, "K3": 4}
    # f32 takes neither
    pipeline.render_rays(m, m, ro, rd, settings, expressions=expr, latent_code=latent)
    assert calls == {"K2": 2, "K3": 4}


def test_apply_model_runs_other_shapes_plainly():
    """K3 takes 2-D rays and per-frame conditioning; (R, S) rays of another
    layout run the model's own bf16 forward, which agrees with K3's plain
    version on the same samples."""
    m = MODELS[FAMILY[True]](**KW, generator=torch.Generator().manual_seed(2))
    ro, rd, z, pe_dir, expr, latent, _ = _inputs(4, 16, seed=6)
    args = (_t(z), ENC, _t(pe_dir), _t(expr), _t(latent), torch.bfloat16)
    flat = pipeline._apply_model(m, _t(ro), _t(rd), *args)
    plain = m(ENC(_t(ro)[:, None, :] + _t(rd)[:, None, :] * _t(z)[..., None]), _t(pe_dir),
              _t(expr), _t(latent), dtype=torch.bfloat16)
    np.testing.assert_allclose(flat.detach().numpy(), plain.detach().numpy(),
                               atol=1e-2 * float(plain.abs().max()), rtol=0)
    assert pipeline._fused_variant(m) is True
    assert pipeline._fused_variant(MODELS["FlexibleNeRFModel"]()) is None
    assert not pipeline._fused_model_ok(m, ENC, _t(pe_dir), _t(expr)[None], _t(latent))
    assert not pipeline._fused_model_ok(m, EncodeSpec(11, True, True), _t(pe_dir), _t(expr),
                                        _t(latent))


def test_coarse_only_train_matches_jax_train(dataset_dir, tmp_path, capsys, monkeypatch):
    """`train()` of both packages, f32 on the CPU, 3 steps of a coarse-only
    config (no models.fine, num_fine 0) from the same checkpoint: the loop,
    the resume and the saves carry a run with no fine model."""
    monkeypatch.setattr(nerface_tpu.native, "available", lambda: False)
    d = _train_cfg(dataset_dir, str(tmp_path / "runs"))
    del d["models"]["fine"]
    for mode in ("train", "validation"):
        d["nerf"][mode]["num_fine"] = 0
    d["experiment"].update(validate_every=2, save_every=2)
    cfg = CfgNode(d)
    mc, mf = build_models_from_cfg(cfg, generator=torch.Generator().manual_seed(4))
    assert mf is None
    start = str(tmp_path / "start.ckpt")
    torch.save({"iter": 0, "model_coarse_state_dict": mc.state_dict(),
                "model_fine_state_dict": None, "optimizer_state_dict": None, "loss": 0.0,
                "psnr": 0.0, "background": None, "latent_codes": torch.zeros(4, 32)}, start)
    jstate = jax_train(JaxCfgNode(copy.deepcopy(d)), load_checkpoint=start,
                       dataset=jax_load_flame_data(dataset_dir), log=False)
    pattern = r"\[TRAIN\] Iter: \d+ Loss: ([0-9.]+)"
    jax_losses = [float(v) for v in re.findall(pattern, capsys.readouterr().out)]
    state = train(cfg, load_checkpoint=start, dataset=load_flame_data(dataset_dir), device="cpu")
    out = capsys.readouterr().out
    losses = [float(v) for v in re.findall(pattern, out)]
    assert "[VAL]" in out
    assert state.model_fine is None and jstate.params["fine"] is None
    assert state.step == int(jstate.step) == 3
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    lr = 5e-4
    for name, p in state.model_coarse.named_parameters():
        got, want = p.detach().numpy(), np.asarray(jstate.params["coarse"][name])
        np.testing.assert_allclose(got, want, atol=10 * lr, rtol=0, err_msg=name)
        assert np.mean(np.abs(got - want) <= 1e-5) >= 0.99, name
    saved = torch.load(str(tmp_path / "runs" / "slice" / "checkpoint00003.ckpt"), weights_only=True)
    assert saved["model_fine_state_dict"] is None and saved["iter"] == 3
