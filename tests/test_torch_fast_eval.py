"""PyTorch port, fast eval (`nerface_tpu_torch/eval/renderer.py`'s fast
branch, `eval/occupancy.py`, the fast `AvatarServer` and `cli/serve.py
--fast-eval`) against the JAX package.

* The port's fast `render_full_frame` against JAX's on the same weights
  (JAX-initialised, carried by `params_from_jax`), f32 on the CPU with
  `perturb: False` (no draws), for a bbox, an occupancy grid (splat and
  probe masks) and both: every pixel within the tolerance of the port's
  parity tests (`test_torch_serve.py::test_render_rays_with_jax_draws`:
  atol 1e-4, disp rtol 1e-4), the skipped pixels bit-equal.
* JAX's contracts (`tests/test_fast_eval.py`, `tests/test_occupancy.py`)
  held on the port with its own draws: active rays equal the port's parity
  frame, skipped rays are exactly the background with bg_weight 1,
  capacity overflow degrades to background, the no-background defaults,
  a capacity rounded past H·W.
* The fast server against the JAX server on one `.ckpt`, the per-request
  override both ways, and the CLI over stdio.
"""

import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.eval import occupancy as J
from nerface_tpu.eval.renderer import render_full_frame as jax_render_full_frame
from nerface_tpu.models import MODELS
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerface_tpu.serve import AvatarServer as JaxAvatarServer
from nerface_tpu_torch.config import CfgNode
from nerface_tpu_torch.eval import occupancy as T
from nerface_tpu_torch.eval.renderer import render_full_frame
from nerface_tpu_torch.models.nerf_models import ConditionalBlendshapePaperNeRFModel
from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings
from nerface_tpu_torch.serve import AvatarServer
from nerface_tpu_torch.train.checkpoint import params_from_jax
from test_torch_serve import _cfg_dict, avatar  # noqa: F401  (the module fixture)

torch.set_num_threads(1)

H = W = 16
NEAR, FAR = 0.2, 0.8
BBOX = np.array([4, 11, 3, 12], np.int32)  # [h0, h1, w0, w1], inclusive
INTR = np.array([20.0, 20.0, 0.5, 0.5], np.float32)
POSE = np.eye(4, dtype=np.float32)[:3, :4]
KW = dict(num_encoding_fn_xyz=4, num_encoding_fn_dir=2, include_input_dir=False)


@pytest.fixture(scope="module")
def scene():
    jmodel = MODELS["ConditionalBlendshapePaperNeRFModel"](**KW)
    kc, kf = jax.random.split(jax.random.PRNGKey(0))
    pc, pf = jmodel.init(kc), jmodel.init(kf)
    # σ raised, so that a pixel the field renders is the MLP's colour and
    # not (exactly) the background the skipped pixels take
    pc, pf = ({k: (v + 10.0 if k == "fc_alpha.bias" else v) for k, v in p.items()}
              for p in (pc, pf))
    models = []
    for p in (pc, pf):
        m = ConditionalBlendshapePaperNeRFModel(**KW)
        m.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in p.items()}), strict=True)
        models.append(m.eval().requires_grad_(False))
    rng = np.random.RandomState(0)
    expr = rng.randn(76).astype(np.float32) * 0.1
    latent = rng.randn(32).astype(np.float32) * 0.1
    bg = rng.rand(H, W, 3).astype(np.float32)
    return (jmodel, pc, pf), models, expr, latent, bg


def _settings(cls, enc, **kw):
    kw.setdefault("chunksize", 64)
    kw.setdefault("perturb", False)
    kw.setdefault("radiance_field_noise_std", 0.0)
    return cls(num_coarse=6, num_fine=6, near=NEAR, far=FAR, encode_xyz=enc(4, True, True),
               encode_dir=enc(2, False, True), **kw)


def _port(models, settings, expr, latent, bg, **kw):
    return render_full_frame(
        models[0], models[1], H, W, INTR, POSE, settings,
        expressions=torch.from_numpy(expr.copy()), latent_code=torch.from_numpy(latent.copy()),
        background=torch.from_numpy(bg.copy()) if bg is not None else None, **kw)


def _left_half_grid():
    """An 8³ grid over the frustum box, occupied in its lower-x half (the
    JAX tests' grid), for both packages."""
    lo, hi = J.ray_aabb(np.eye(4, dtype=np.float32)[None], INTR, H, W, NEAR, FAR)
    g = np.zeros((8, 8, 8), bool)
    g[:4] = True
    return (J.OccupancyGrid(jnp.asarray(g), jnp.asarray(lo), jnp.asarray(hi)),
            T.OccupancyGrid(torch.from_numpy(g), torch.from_numpy(lo), torch.from_numpy(hi)))


@pytest.mark.parametrize("case", ["bbox", "splat", "probe", "bbox+splat"])
def test_fast_frame_matches_jax(scene, case):
    (jmodel, pc, pf), models, expr, latent, bg = scene
    jocc = tocc = None
    if case != "bbox":
        jocc, tocc = _left_half_grid()
        if "splat" in case:
            jocc, tocc = jocc.with_boxes(round_to=64), tocc.with_boxes(round_to=64)
    bbox = BBOX if "bbox" in case else None
    cap = 0.45 if case == "bbox" else 0.7
    jset = _settings(JaxRenderSettings, JaxEncodeSpec, fast_eval=True, fast_eval_capacity=cap)
    tset = _settings(RenderSettings, EncodeSpec, fast_eval=True, fast_eval_capacity=cap)
    ref = jax_render_full_frame(jmodel, jmodel, pc, pf, H, W, INTR, POSE, jset,
                                key=jax.random.PRNGKey(3), expressions=jnp.asarray(expr),
                                latent_code=jnp.asarray(latent), background=jnp.asarray(bg),
                                bbox=bbox, occupancy=jocc)
    got = _port(models, tset, expr, latent, bg, bbox=bbox, occupancy=tocc)
    assert set(got) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape, k
        if k.startswith("disp"):
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, atol=1e-4, rtol=0, err_msg=k)
    skipped = np.all(np.asarray(ref["rgb_fine"]) == bg, axis=-1)
    assert 0 < skipped.sum() < H * W
    np.testing.assert_array_equal(got["rgb_fine"].numpy()[skipped], bg[skipped])
    assert (got["bg_weight"].numpy()[skipped] == 1.0).all()


def _inside():
    ii, jj = np.mgrid[0:H, 0:W]
    return (ii >= BBOX[0]) & (ii <= BBOX[1]) & (jj >= BBOX[2]) & (jj <= BBOX[3])


def _noisy(**kw):
    return _settings(RenderSettings, EncodeSpec, perturb=True, radiance_field_noise_std=0.1, **kw)


def test_inside_matches_parity_outside_is_background(scene):
    """The port's own draws (perturb, σ-noise), keyed by global ray index."""
    _, models, expr, latent, bg = scene
    full = _port(models, _noisy(), expr, latent, bg, seed=3)
    fast = _port(models, _noisy(fast_eval=True, fast_eval_capacity=0.45), expr, latent, bg,
                 seed=3, bbox=BBOX)
    inside = _inside()
    for k in ("rgb_fine", "rgb_coarse"):
        torch.testing.assert_close(fast[k][inside], full[k][inside], rtol=1e-5, atol=1e-5)
    f_out, full_out = fast["rgb_fine"].numpy()[~inside], full["rgb_fine"].numpy()[~inside]
    is_bg = np.all(f_out == bg[~inside], axis=-1)
    near_full = np.all(np.abs(f_out - full_out) < 1e-4, axis=-1)
    assert np.all(is_bg | near_full)
    # capacity 0.45 of 256 rays = 128 slots, 80 inside: 48 spare slots
    assert near_full.sum() >= 48 and is_bg.sum() >= f_out.shape[0] - 48
    assert (fast["bg_weight"].numpy()[~inside][is_bg] == 1.0).all()


def test_capacity_overflow_falls_back_to_background(scene):
    _, models, expr, latent, bg = scene
    fast = _port(models, _noisy(fast_eval=True, fast_eval_capacity=0.1, chunksize=16), expr,
                 latent, bg, seed=3, bbox=BBOX)
    rgb = fast["rgb_fine"].numpy()
    assert np.isfinite(rgb).all()
    np.testing.assert_array_equal(rgb[int(BBOX[1])], bg[int(BBOX[1])])


def test_no_background_defaults(scene):
    _, models, expr, latent, _ = scene
    for white in (False, True):
        fast = _port(models, _noisy(fast_eval=True, fast_eval_capacity=0.45,
                                    white_background=white), expr, latent, None, seed=3, bbox=BBOX)
        assert np.isfinite(fast["rgb_fine"].numpy()).all()
        # the last raster pixel is past every capacity slot: skipped
        assert (fast["rgb_fine"][H - 1, W - 1] == (1.0 if white else 0.0)).all()
        assert fast["acc_fine"][H - 1, W - 1] == 0.0 and fast["bg_weight"][H - 1, W - 1] == 0.0
        assert fast["depth_fine"][H - 1, W - 1] == np.float32(FAR)
        assert fast["disp_fine"][H - 1, W - 1] == np.float32(1.0) / np.float32(FAR)


def test_capacity_rounds_past_frame_size(scene):
    """round_up(256, 48) = 288 slots for 256 rays: the order wraps."""
    _, models, expr, latent, bg = scene
    full = _port(models, _noisy(chunksize=48), expr, latent, bg, seed=3)
    fast = _port(models, _noisy(fast_eval=True, fast_eval_capacity=1.0, chunksize=48), expr,
                 latent, bg, seed=3, bbox=np.array([0, H - 1, 0, W - 1], np.int32))
    torch.testing.assert_close(fast["rgb_fine"], full["rgb_fine"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask", ["probe", "splat"])
def test_occupancy_kept_rays_match_parity(scene, mask):
    _, models, expr, latent, bg = scene
    _, occ = _left_half_grid()
    if mask == "splat":
        occ = occ.with_boxes(round_to=64)
    s = _noisy(fast_eval=True, fast_eval_capacity=0.7)
    full = _port(models, _noisy(), expr, latent, bg, seed=3)
    fast = _port(models, s, expr, latent, bg, seed=3, occupancy=occ)
    from nerface_tpu_torch.eval.renderer import _active_mask
    from nerface_tpu_torch.ops.rays import get_ray_bundle

    ro, rd = get_ray_bundle(H, W, INTR, torch.from_numpy(POSE))
    kept = _active_mask(ro.reshape(-1, 3), rd.reshape(-1, 3), H, W, None, occ, s,
                        pose=torch.from_numpy(POSE), intrinsics=INTR).reshape(H, W).numpy()
    assert 0 < kept.sum() < H * W
    a, b = full["rgb_fine"].numpy(), fast["rgb_fine"].numpy()
    np.testing.assert_allclose(b[kept], a[kept], rtol=1e-5, atol=1e-5)
    is_bg = np.isclose(b[~kept], bg[~kept], atol=1e-6).all(axis=-1)
    is_real = np.isclose(b[~kept], a[~kept], rtol=1e-4, atol=1e-4).all(axis=-1)
    assert (is_bg | is_real).all() and is_bg.sum() > 0


def test_frame_follows_the_models_device(scene):
    """With no `device`, the rays go where the coarse model's parameters
    are (a meta-device model here: the frame comes out on meta, where the
    CPU rays of the old default met meta weights and failed), on both
    renderers."""
    _, models, expr, latent, bg = scene
    metas = [ConditionalBlendshapePaperNeRFModel(**KW, device="meta") for _ in range(2)]
    kw = dict(expressions=torch.from_numpy(expr.copy()).to("meta"),
              latent_code=torch.from_numpy(latent.copy()).to("meta"),
              background=torch.from_numpy(bg.copy()).to("meta"))
    for s, extra in ((_noisy(), {}), (_noisy(fast_eval=True), {"bbox": BBOX})):
        out = render_full_frame(metas[0], metas[1], H, W, INTR, POSE, s, **kw, **extra)
        assert all(v.device.type == "meta" for v in out.values())
        assert out["rgb_fine"].shape == (H, W, 3)
    out = _port(models, _noisy(), expr, latent, bg)
    assert out["rgb_fine"].device.type == "cpu"


# -- the fast server ---------------------------------------------------------


def _fast_cfg(ds_dir, cls):
    cfg = cls(_cfg_dict(ds_dir))
    cfg.nerf.validation["fast_eval"] = True
    return cfg


def test_fast_server_matches_jax_server(avatar):  # noqa: F811
    """One `.ckpt`, `fast_eval: true` on both: the same bbox union and
    capacity, and uint8 frames within 1 level (rgb ≥ 99 % equal), as the
    parity servers' tests hold them."""
    ds_dir, ckpt, _, _ = avatar
    jsrv = JaxAvatarServer(_fast_cfg(ds_dir, JaxCfgNode), checkpoint=ckpt, log=False)
    tsrv = AvatarServer(_fast_cfg(ds_dir, CfgNode), checkpoint=ckpt, device="cpu", log=False)
    np.testing.assert_array_equal(tsrv.fast_bbox, jsrv.fast_bbox)
    assert tsrv.settings.fast_eval_capacity == jsrv.settings.fast_eval_capacity
    assert tsrv.occupancy is None
    for frame in (0, 1):
        ref = jsrv.render(frame=frame, maps=("rgb_fine", "rgb_coarse", "acc"))
        got = tsrv.render(frame=frame, maps=("rgb_fine", "rgb_coarse", "acc"))
        for name in ref:
            diff = np.abs(got[name].astype(np.int16) - ref[name].astype(np.int16))
            assert diff.max() <= 1, name
            # acc ≈ 1 truncates to 254 or 255 by its last bits
            assert name == "acc" or (diff == 0).mean() >= 0.99, name


def test_fast_eval_override_both_ways(avatar):  # noqa: F811
    ds_dir, ckpt, _, parity = avatar
    fast = AvatarServer(_fast_cfg(ds_dir, CfgNode), checkpoint=ckpt, device="cpu", log=False)
    ref = parity.render(frame=1, maps=("rgb_fine",))["rgb_fine"]
    # a fast server asked for the parity frame renders it
    np.testing.assert_array_equal(fast.render(frame=1, fast_eval=False)["rgb_fine"], ref)
    fast_frame = fast.render(frame=1)["rgb_fine"]
    np.testing.assert_array_equal(fast.render(frame=1, fast_eval=True)["rgb_fine"], fast_frame)
    bb = fast.fast_bbox
    np.testing.assert_array_equal(fast_frame[bb[0]:bb[1] + 1, bb[2]:bb[3] + 1],
                                  ref[bb[0]:bb[1] + 1, bb[2]:bb[3] + 1])
    assert (fast_frame != ref).any()  # skipped pixels show the background
    # a parity server asked for a fast frame refuses, as the JAX server does
    with pytest.raises(ValueError, match="built without"):
        parity.render(frame=1, fast_eval=True)
    reply = parity.handle({"frame": 1, "fast_eval": True})
    assert not reply["ok"] and "fast_eval" in reply["error"]
    assert parity.handle({"cmd": "ping"})["fast_eval"] is False


def test_cli_fast_eval_over_stdio(avatar, tmp_path, monkeypatch, capsys):  # noqa: F811
    from nerface_tpu_torch.cli.serve import main

    ds_dir, ckpt, _, _ = avatar
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(CfgNode(_cfg_dict(ds_dir)).dump())
    requests = "\n".join(json.dumps(r) for r in
                         ({"cmd": "ping"}, {"frame": 0}, {"cmd": "stop"})) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(requests))
    main(["--config", str(cfg_path), "--checkpoint", ckpt, "--stdio", "--device", "cpu",
          "--fast-eval"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines[0]["ok"] and lines[0]["fast_eval"] is True
    assert lines[1]["ok"] and lines[1]["frame_ms"] > 0
    assert lines[-1] == {"ok": True, "cmd": "stop"}
