"""PyTorch port, the stock NeRF surface against the JAX package on the CPU:

* `ops/rays.py`: `ndc_rays` (scalar and [fx, fy] focal), `rodrigues`
  (values and gradients, θ = 0 included), `get_ray_bundle_axis_angles`,
  against JAX within 1e-5·max; `ray_bundle_numpy` array for array.
* `utils/lie.py`: hat, vee, so3_exp, so3_log, se3_exp and se3_log against
  JAX within 1e-5·max; each map's gradient at θ = 0 and θ = 1e-9 finite
  and within 1e-4·max of `jax.grad` (the exact branch must be fed a safe
  θ: `torch.where` passes 0 · NaN = NaN to a branch it did not take).
* `data/blender.py` and `data/llff.py` on synthetic fixtures
  (tests/test_loaders.py's), array for array: splits, `testskip`,
  `half_res`, `debug`, `spherify`, no recentring, `path_zflat`, minify
  (the written `images_{factor}/` PNGs too) and the reuse of an existing
  `images_{factor}/`.
* `render/pipeline.py`: `run_one_iter_of_nerf` through NDC against JAX's
  (image-shaped and flat, within 1e-5·max); it raises without `focal`, and
  `render_rays` keeps JAX's NDC refusal.
* `cli/eval_nerf.py --device cpu` against JAX's `eval_nerf` on one
  JAX-exported `.ckpt`: a 20 × 20 blender set (PaperNeRFModel) and a
  16 × 12 LLFF set through NDC (ReplicateNeRFModel), every PNG within
  1 level; an orbax directory is refused.
* `examples/tiny_nerf.py`: one step against JAX's on the same jitter
  (loss rtol 1e-5, rgb 1e-5·max, gradients 1e-4·max but the σ output
  row's 5e-3·max, tests/test_torch_stock_models.py's reason), the
  synthetic data equal to JAX's, and the convergence test of
  tests/test_lie_and_tools.py (60 Adam steps halve the loss).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_loaders import _make_blender_dataset, _make_llff_dataset

from nerface_tpu.data import blender as jax_blender
from nerface_tpu.data import llff as jax_llff
from nerface_tpu.ops import rays as jax_rays
from nerface_tpu.utils import lie as jax_lie
from nerface_tpu_torch.data import blender, llff
from nerface_tpu_torch.ops import rays
from nerface_tpu_torch.utils import lie

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _t(a, requires_grad=False):
    return torch.tensor(np.array(a), dtype=torch.float32, requires_grad=requires_grad)


def _close(got, ref, tol=FWD_TOL, msg=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, msg
    assert np.isfinite(got).all(), msg
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=msg)


# ---- ops/rays.py ---------------------------------------------------------


def _forward_facing_rays(H=6, W=8, focal=7.0):
    ro, rd = jax_rays.get_ray_bundle(H, W, jnp.asarray([focal, focal * 1.1, 0.5, 0.5]),
                                     jnp.asarray(np.eye(4)[:3, :4], jnp.float32))
    rng = np.random.RandomState(0)
    ro = np.asarray(ro).reshape(-1, 3) + rng.randn(H * W, 3).astype(np.float32) * 0.05
    return ro, np.asarray(rd).reshape(-1, 3)


@pytest.mark.parametrize("focal", [7.0, [7.0, 7.7]], ids=["scalar", "fx_fy"])
def test_ndc_rays_match_jax(focal):
    ro, rd = _forward_facing_rays()
    jo, jd = jax_rays.ndc_rays(6, 8, jnp.asarray(focal), 1.0, jnp.asarray(ro), jnp.asarray(rd))
    to, td = rays.ndc_rays(6, 8, focal, 1.0, _t(ro), _t(rd))
    _close(to, jo)
    _close(td, jd)


@pytest.mark.parametrize("theta", [0.0, 1e-9, 0.3, 2.5])
def test_rodrigues_matches_jax(theta):
    axis = np.array([0.3, -0.5, 0.8], np.float32)
    w = (axis / np.linalg.norm(axis) * theta).astype(np.float32)
    C = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    jR, jg = jax.value_and_grad(lambda x: jnp.sum(jax_rays.rodrigues(x) * C))(jnp.asarray(w))
    tw = _t(w, requires_grad=True)
    R = rays.rodrigues(tw)
    torch.sum(R * _t(C)).backward()
    _close(R, jax_rays.rodrigues(jnp.asarray(w)))
    _close(torch.sum(R * _t(C)), jR)
    _close(tw.grad, jg, GRAD_TOL)


def test_axis_angle_bundle_matches_jax():
    pose = np.array([[0.2, -0.4, 0.1], [0.3, 0.1, 2.0]], np.float32)
    intr = np.array([9.0, 8.0, 0.45, 0.55], np.float32)
    jo, jd = jax_rays.get_ray_bundle_axis_angles(5, 7, intr, jnp.asarray(pose))
    to, td = rays.get_ray_bundle_axis_angles(5, 7, intr, _t(pose))
    _close(to, jo)
    _close(td, jd)


@pytest.mark.parametrize("intrinsics", [11.0, [11.0, 12.0, 0.4, 0.6]], ids=["scalar", "fxfycxcy"])
def test_ray_bundle_numpy_exact(intrinsics):
    c2w = np.random.RandomState(2).randn(4, 4).astype(np.float32)
    jo, jd = jax_rays.ray_bundle_numpy(5, 7, intrinsics, c2w)
    to, td = rays.ray_bundle_numpy(5, 7, intrinsics, c2w)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(td, jd)


# ---- utils/lie.py --------------------------------------------------------


def _random_inputs(name, rng):
    if name in ("hat", "so3_exp"):
        return rng.randn(5, 3).astype(np.float32)
    if name == "vee":
        return rng.randn(5, 3, 3).astype(np.float32)
    if name == "se3_exp":
        return (rng.randn(5, 6) * 0.7).astype(np.float32)
    if name == "so3_log":
        return np.asarray(jax_lie.so3_exp(jnp.asarray(rng.randn(5, 3).astype(np.float32) * 0.8)))
    return np.asarray(jax_lie.se3_exp(jnp.asarray((rng.randn(5, 6) * 0.5).astype(np.float32))))


@pytest.mark.parametrize("name", ["hat", "vee", "so3_exp", "so3_log", "se3_exp", "se3_log"])
def test_lie_values_match_jax(name):
    x = _random_inputs(name, np.random.RandomState(3))
    _close(getattr(lie, name)(_t(x)), getattr(jax_lie, name)(jnp.asarray(x)), msg=name)
    assert lie.so3_exponential_map is lie.so3_exp


def _at_theta(name, theta):
    """The map's input at rotation angle θ: w = θ·axis for the exp maps
    (with a translation for se3_exp), exp of that for the log maps."""
    axis = np.array([0.6, -0.0, 0.8], np.float32)
    w = (axis * theta).astype(np.float32)
    if name == "so3_exp":
        return w
    xi = np.concatenate([np.float32([0.3, -0.2, 0.5]), w]).astype(np.float32)
    if name == "se3_exp":
        return xi
    if name == "so3_log":
        return np.asarray(jax_lie.so3_exp(jnp.asarray(w)))
    return np.asarray(jax_lie.se3_exp(jnp.asarray(xi)))


@pytest.mark.parametrize("theta", [0.0, 1e-9])
@pytest.mark.parametrize("name", ["so3_exp", "so3_log", "se3_exp", "se3_log"])
def test_lie_gradients_at_zero_match_jax(name, theta):
    x = _at_theta(name, theta)
    jout = getattr(jax_lie, name)(jnp.asarray(x))
    C = np.random.RandomState(4).randn(*jout.shape).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(getattr(jax_lie, name)(v) * C))(jnp.asarray(x))
    tx = _t(x, requires_grad=True)
    out = getattr(lie, name)(tx)
    torch.sum(out * _t(C)).backward()
    _close(out, jout, msg=name)
    assert torch.isfinite(tx.grad).all(), name
    _close(tx.grad, jg, GRAD_TOL, msg=name)


# ---- data/blender.py, data/llff.py ----------------------------------------


def _same_dataclass(a, b):
    assert type(a).__name__ == type(b).__name__
    for field in a.__dataclass_fields__:
        x, y = getattr(a, field), getattr(b, field)
        if field == "i_split":
            assert len(x) == len(y) == 3
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        elif isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, field
            np.testing.assert_array_equal(x, y, err_msg=field)
        else:
            assert x == y, field


@pytest.mark.parametrize("kw", [{}, {"testskip": 2}, {"half_res": True}, {"debug": True}],
                         ids=["default", "testskip", "half_res", "debug"])
def test_blender_loader_matches_jax(kw, tmp_path):
    n = (3, 4, 4) if "testskip" in kw else (3, 2, 2)
    base = _make_blender_dataset(str(tmp_path / "b"), n=n)
    got, ref = blender.load_blender_data(base, **kw), jax_blender.load_blender_data(base, **kw)
    _same_dataclass(got, ref)
    np.testing.assert_array_equal(got.intrinsics, ref.intrinsics)
    assert got.hwf == ref.hwf


@pytest.mark.parametrize("kw", [
    {"factor": 1},
    {"factor": 1, "spherify": True},
    {"factor": 1, "recenter": False, "bd_factor": None},
    {"factor": 1, "path_zflat": True},
    {"factor": 2},
], ids=["default", "spherify", "no_recenter", "zflat", "minify"])
def test_llff_loader_matches_jax(kw, tmp_path):
    base = _make_llff_dataset(str(tmp_path / "port"))
    jbase = str(tmp_path / "jax")
    shutil.copytree(base, jbase)
    got, ref = llff.load_llff_data(base, **kw), jax_llff.load_llff_data(jbase, **kw)
    _same_dataclass(got, ref)
    assert got.hwf == ref.hwf
    if kw["factor"] != 1:
        d = f"images_{kw['factor']}"
        names = sorted(os.listdir(os.path.join(jbase, d)))
        assert sorted(os.listdir(os.path.join(base, d))) == names and names
        for f in names:
            with open(os.path.join(base, d, f), "rb") as a, open(os.path.join(jbase, d, f), "rb") as b:
                assert a.read() == b.read(), f


def test_llff_minify_reuses_existing_images(tmp_path):
    """An `images_{factor}/` with as many images as `images/` is read as it
    is (JAX `llff.py:177-183`), and the [H, W, focal] column follows its
    size (:226-227)."""
    from PIL import Image

    base = _make_llff_dataset(str(tmp_path / "l"))
    os.makedirs(os.path.join(base, "images_4"))
    for i in range(5):
        img = np.full((5, 7, 3), 40 * i, np.uint8)
        Image.fromarray(img).save(os.path.join(base, "images_4", f"im_{i:03d}.png"))
    got, ref = llff.load_llff_data(base, factor=4), jax_llff.load_llff_data(base, factor=4)
    _same_dataclass(got, ref)
    assert got.images.shape == (5, 5, 7, 3) and got.hwf == [5, 7, 12.5]
    np.testing.assert_array_equal(got.images[2], np.float32(80 / 255))


# ---- render/pipeline.py: NDC ---------------------------------------------


def _stock_pair(seed=0):
    from nerface_tpu.models import MODELS as JAX_MODELS
    from nerface_tpu_torch.models.nerf_models import MODELS
    from nerface_tpu_torch.train.checkpoint import params_from_jax

    kw = dict(hidden_size=32, num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
    jm = JAX_MODELS["ReplicateNeRFModel"](**kw)
    jc, jf = jm.init(jax.random.PRNGKey(seed)), jm.init(jax.random.PRNGKey(seed + 1))
    tc, tf = MODELS["ReplicateNeRFModel"](**kw), MODELS["ReplicateNeRFModel"](**kw)
    for t, j in ((tc, jc), (tf, jf)):
        t.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in j.items()}), strict=True)
        for name, p in t.named_parameters():  # σ up: rays that composite colour
            if name == "fc_alpha.bias":
                with torch.no_grad():
                    p += 3.0
        j["fc_alpha.bias"] = j["fc_alpha.bias"] + 3.0
    return jm, jc, jf, tc, tf


def _ndc_settings(no_ndc=False):
    from nerface_tpu.render.pipeline import EncodeSpec as JES
    from nerface_tpu.render.pipeline import RenderSettings as JRS
    from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings

    kw = dict(num_coarse=8, num_fine=4, perturb=False, radiance_field_noise_std=0.0,
              no_ndc=no_ndc, near=1.0, far=6.0)
    return (RenderSettings(**kw, encode_xyz=EncodeSpec(4, True, True),
                           encode_dir=EncodeSpec(2, True, True)),
            JRS(**kw, encode_xyz=JES(4, True, True), encode_dir=JES(2, True, True), fused="off"))


@pytest.mark.parametrize("mode", ["validation", "train"])
def test_run_one_iter_of_nerf_ndc_matches_jax(mode):
    from nerface_tpu.render.pipeline import run_one_iter_of_nerf as jax_run
    from nerface_tpu_torch.render.pipeline import run_one_iter_of_nerf

    jm, jc, jf, tc, tf = _stock_pair()
    tset, jset = _ndc_settings()
    H, W, focal = 6, 8, 7.0
    ro, rd = _forward_facing_rays(H, W, focal)
    ro, rd = ro.reshape(H, W, 3), rd.reshape(H, W, 3)
    ref = jax_run(H, W, jm, jm, jc, jf, jnp.asarray(ro), jnp.asarray(rd), jset, mode=mode,
                  focal=jnp.asarray([focal, focal]))
    with torch.no_grad():
        got = run_one_iter_of_nerf(H, W, tc, tf, _t(ro), _t(rd), tset, mode=mode,
                                   focal=[focal, focal])
    assert len(got) == 7
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, msg=str(i))
    if mode == "validation":
        assert got[0].shape == (H, W, 3) and got[6].shape == (H, W)


def test_ndc_needs_focal_and_render_rays_refuses_ndc():
    from nerface_tpu_torch.render.pipeline import render_rays, run_one_iter_of_nerf

    _, _, _, tc, tf = _stock_pair()
    tset, _ = _ndc_settings()
    ro, rd = _forward_facing_rays()
    with pytest.raises(ValueError, match="focal"):
        run_one_iter_of_nerf(6, 8, tc, tf, _t(ro), _t(rd), tset)
    with pytest.raises(NotImplementedError, match="ndc_rays upstream"):
        render_rays(tc, tf, _t(ro), _t(rd), tset)


# ---- cli/eval_nerf.py ----------------------------------------------------


def _eval_nerf_cfg(ds_dir, model_type, llff_set):
    model = {"type": model_type, "num_layers": 4, "hidden_size": 32, "skip_connect_every": 3,
             "num_encoding_fn_xyz": 4, "include_input_xyz": True, "log_sampling_xyz": True,
             "use_viewdirs": True, "num_encoding_fn_dir": 2, "include_input_dir": False,
             "log_sampling_dir": True}
    dataset = ({"type": "llff", "basedir": ds_dir, "downsample_factor": 2, "no_ndc": False,
                "near": 0.0, "far": 1.0} if llff_set else
               {"type": "blender", "basedir": ds_dir, "half_res": False, "testskip": 1,
                "no_ndc": True, "near": 2.0, "far": 6.0})
    node = {"chunksize": 128, "perturb": False, "num_coarse": 8, "num_fine": 8,
            "white_background": False, "radiance_field_noise_std": 0.0, "lindisp": False}
    return {
        "experiment": {"id": "stock", "logdir": "/tmp/unused", "randomseed": 42,
                       "train_iters": 1, "validate_every": 100, "save_every": 100,
                       "print_every": 100},
        "dataset": dataset,
        "models": {"coarse": dict(model), "fine": dict(model)},
        "optimizer": {"type": "Adam", "lr": 5.0e-4},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
        "nerf": {"use_viewdirs": True, "train": dict(node, num_random_rays=64),
                 "validation": dict(node)},
    }


def _jax_ckpt(cfg_path, path):
    """A JAX-exported `.ckpt` of eval_nerf's models, every weight ×1.5 and
    the σ bias raised, so that the frames are not flat."""
    from nerface_tpu.config import load_config
    from nerface_tpu.config.flags import FeatureFlags
    from nerface_tpu.train.checkpoint import export_torch_checkpoint
    from nerface_tpu.train.loop import build_models_from_cfg
    from nerface_tpu.train.state import create_train_state

    cfg = load_config(cfg_path)
    mc, mf = build_models_from_cfg(cfg)
    flags = FeatureFlags(train_latent_codes=False, fixed_background=False,
                         disable_latent_codes=True)
    state, _ = create_train_state(jax.random.PRNGKey(5), mc, mf, cfg, flags, n_train=1)
    export_torch_checkpoint(path, state)
    sd = torch.load(path, weights_only=True)
    for m in ("model_coarse_state_dict", "model_fine_state_dict"):
        for k in sd[m]:
            if k.endswith(".weight"):
                sd[m][k] = sd[m][k] * 1.5
        sd[m]["fc_alpha.bias"] = sd[m]["fc_alpha.bias"] + 1.0
    torch.save(sd, path)
    return path


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.int32)


@pytest.mark.parametrize("dataset", ["blender", "llff"])
def test_eval_nerf_cli_matches_jax(dataset, tmp_path, capsys):
    from nerface_tpu.cli import eval_nerf as jax_eval_nerf
    from nerface_tpu_torch.cli import eval_nerf

    if dataset == "llff":
        ds_dir = _make_llff_dataset(str(tmp_path / "llff"))
        cfg = _eval_nerf_cfg(ds_dir, "ReplicateNeRFModel", True)
        shape = (12, 16)
    else:
        ds_dir = _make_blender_dataset(str(tmp_path / "blender"), H=20, W=20)
        cfg = _eval_nerf_cfg(ds_dir, "PaperNeRFModel", False)
        shape = (20, 20)
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    ckpt = _jax_ckpt(cfg_path, str(tmp_path / "model.ckpt"))
    argv = ["--config", cfg_path, "--checkpoint", ckpt, "--save-disparity-image",
            "--max-frames", "2"]
    jax_eval_nerf.main(argv + ["--savedir", str(tmp_path / "jax")])
    capsys.readouterr()
    summary = eval_nerf.main(argv + ["--savedir", str(tmp_path / "port"), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert summary["frames"] == 2 and printed.count("Avg time per image: ") == 2
    for name in ("0000.png", "0001.png", "disparity/0000.png", "disparity/0001.png"):
        got, ref = _png(tmp_path / "port" / name), _png(tmp_path / "jax" / name)
        assert got.shape[:2] == shape, name
        assert np.abs(got - ref).max() <= 1, name
        if not name.startswith("disparity"):
            assert ref.std() > 2.0, name  # the field, not a flat frame


def test_eval_nerf_refuses_an_orbax_directory(tmp_path):
    from nerface_tpu.cli.eval_nerf import build_parser as jax_parser
    from nerface_tpu_torch.cli import eval_nerf

    with pytest.raises(SystemExit, match="--export-torch"):
        eval_nerf.main(["--config", "unused.yml", "--checkpoint", str(tmp_path)])
    ours = {a.dest: a.default for a in eval_nerf.build_parser()._actions}
    theirs = {a.dest: a.default for a in jax_parser()._actions}
    assert ours == dict(theirs, device="cuda")


# ---- examples/tiny_nerf.py ----------------------------------------------


def _tiny_from_jax(params):
    from nerface_tpu_torch.examples.tiny_nerf import init_model

    model = init_model()
    sd = {}
    for i, layer in zip((0, 2, 4), params):
        sd[f"{i}.weight"] = torch.from_numpy(np.array(layer["w"]).T.copy())
        sd[f"{i}.bias"] = torch.from_numpy(np.array(layer["b"]))
    model.load_state_dict(sd, strict=True)
    return model


def test_tiny_nerf_step_matches_jax():
    from nerface_tpu.examples import tiny_nerf as jax_tiny
    from nerface_tpu_torch.examples import tiny_nerf

    images, poses, focal = jax_tiny.make_synthetic_tiny_data(n=3, H=16, W=16)
    params = jax_tiny.init_model(jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(4)
    jloss, jrgb, jg = jax_tiny.run_one_iter_of_tinynerf(
        params, 16, 16, focal, jnp.asarray(poses[1]), jnp.asarray(images[1]), key,
        near=0.2, far=1.2)
    u = jax.random.uniform(key, (16, 16, 32))
    model = _tiny_from_jax(params)
    loss, rgb = tiny_nerf.run_one_iter_of_tinynerf(
        model, 16, 16, float(focal), poses[1], images[1], near=0.2, far=1.2, u=_t(u))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _close(rgb, jrgb)
    for i, layer in zip((0, 2, 4), jg):
        w, b = np.asarray(layer["w"]).T, np.asarray(layer["b"])
        gw, gb = model[i].weight.grad.numpy(), model[i].bias.grad.numpy()
        if i == 4:  # the σ output's row: tests/test_torch_stock_models.py's limit
            _close(gw[3], w[3], 5e-3, "sigma row")
            _close(gb[3:], b[3:], 5e-3, "sigma bias")
            w, b, gw, gb = w[:3], b[:3], gw[:3], gb[:3]
        _close(gw, w, GRAD_TOL, f"{i}.weight")
        _close(gb, b, GRAD_TOL, f"{i}.bias")


def test_tiny_nerf_synthetic_data_matches_jax():
    from nerface_tpu.examples import tiny_nerf as jax_tiny
    from nerface_tpu_torch.examples import tiny_nerf

    got = tiny_nerf.make_synthetic_tiny_data(n=4, H=12, W=12)
    ref = jax_tiny.make_synthetic_tiny_data(n=4, H=12, W=12)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_tiny_nerf_overfits_synthetic():
    """tests/test_lie_and_tools.py::TestTinyNerf on the port: 60 Adam steps
    at 24², jitter from a torch.Generator, halve the loss."""
    from nerface_tpu_torch.examples.tiny_nerf import (
        init_model,
        make_synthetic_tiny_data,
        run_one_iter_of_tinynerf,
    )

    images, poses, focal = make_synthetic_tiny_data(n=6, H=24, W=24)
    model = init_model(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    pick, jitter = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    losses = []
    for _ in range(60):
        idx = int(torch.randint(0, len(images), (), generator=pick))
        loss, _ = run_one_iter_of_tinynerf(model, 24, 24, float(focal), poses[idx], images[idx],
                                           near=0.2, far=1.2, generator=jitter)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.5 * losses[0]
