"""PyTorch port, sharded rendering (`render_full_frame(devices=...)`, JAX's
`mesh`: `_render_frame_sharded` and `_render_frame_fast_sharded`), and
its callers: `evaluate(devices=...)`, `AvatarServer(devices=...)`,
`cli/eval.py` / `cli/serve.py --num-devices`.

On the CPU a device list repeats the CPU, which drives the split into
blocks, each block's tiles and the gather, as one card does on the card:

* the sharded parity frame equals the one-device frame bit for bit, with
  the port's own draws (perturb and σ-noise on: every ray keeps its global
  index), at 2 and 3 devices and where the tile is cut to ⌈n / n_dev⌉;
* the sharded fast frame (bbox, bbox with an occupancy grid) equals the
  one-device fast frame bit for bit where the capacities agree; at 3
  devices the capacity rounds to 3 tiles and the active pixels are equal;
* both against JAX's sharded render on a 2-device mesh at `perturb: False`
  within the port's fast-eval tolerance (`tests/test_torch_fast_eval.py`:
  atol 1e-4, disp rtol 1e-4);
* `evaluate`, the server and both CLIs give the one-device files and
  frames byte for byte.
"""

import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nerface_tpu.eval.renderer import render_full_frame as jax_render_full_frame
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from chip_smoke import _extra_slots
from nerface_tpu_torch.config import CfgNode
from nerface_tpu_torch.eval import renderer
from nerface_tpu_torch.eval.driver import evaluate
from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings
from nerface_tpu_torch.serve import AvatarServer
from test_torch_fast_eval import (  # noqa: F401  (scene: the module fixture)
    BBOX,
    H,
    INTR,
    POSE,
    W,
    _left_half_grid,
    _noisy,
    _port,
    _settings,
    scene,
)
from test_torch_serve import _cfg_dict, avatar  # noqa: F401  (the module fixture)

torch.set_num_threads(1)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("n_dev,chunk", [(2, 64), (3, 64), (3, 256)])
def test_sharded_parity_frame_equals_one_device(scene, n_dev, chunk):
    _, models, expr, latent, bg = scene
    s = _noisy(chunksize=chunk)
    one = _port(models, s, expr, latent, bg, seed=3)
    _equal(_port(models, s, expr, latent, bg, seed=3, devices=["cpu"] * n_dev), one)


@pytest.mark.parametrize("case", ["bbox", "bbox+occupancy"])
def test_sharded_fast_frame_equals_one_device(scene, case):
    _, models, expr, latent, bg = scene
    occ = _left_half_grid()[1].with_boxes(round_to=64) if "occupancy" in case else None
    s = _noisy(fast_eval=True, fast_eval_capacity=0.45)
    one = _port(models, s, expr, latent, bg, seed=3, bbox=BBOX, occupancy=occ)
    # 0.45 of 256 rays is 128 slots: 2 tiles of 64 on one device, 1 on each of 2
    _equal(_port(models, s, expr, latent, bg, seed=3, bbox=BBOX, occupancy=occ,
                 devices=["cpu"] * 2), one)
    # 3 devices round the capacity to 3 tiles: the active pixels are the same
    three = _port(models, s, expr, latent, bg, seed=3, bbox=BBOX, occupancy=occ,
                  devices=["cpu"] * 3)
    from nerface_tpu_torch.ops.rays import get_ray_bundle

    ro, rd = get_ray_bundle(H, W, INTR, torch.from_numpy(POSE))
    active = renderer._active_mask(ro.reshape(-1, 3), rd.reshape(-1, 3), H, W, BBOX, occ, s,
                                   pose=torch.from_numpy(POSE), intrinsics=INTR).reshape(H, W)
    assert 0 < int(active.sum()) < H * W
    for k in one:
        assert torch.equal(three[k][active], one[k][active]), k


@pytest.mark.parametrize("fast", [False, True])
def test_sharded_frame_matches_jax_mesh(scene, fast):
    (jmodel, pc, pf), models, expr, latent, bg = scene
    kw = dict(fast_eval=True, fast_eval_capacity=0.45) if fast else {}
    jset = _settings(JaxRenderSettings, JaxEncodeSpec, **kw)
    tset = _settings(RenderSettings, EncodeSpec, **kw)
    bbox = BBOX if fast else None
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    ref = jax_render_full_frame(jmodel, jmodel, pc, pf, H, W, INTR, POSE, jset,
                                key=jax.random.PRNGKey(3), expressions=jnp.asarray(expr),
                                latent_code=jnp.asarray(latent), background=jnp.asarray(bg),
                                bbox=bbox, mesh=mesh)
    got = _port(models, tset, expr, latent, bg, bbox=bbox, devices=["cpu"] * 2)
    assert set(got) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape, k
        if k.startswith("disp"):
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, atol=1e-4, rtol=0, err_msg=k)


def test_replica_is_made_once_and_follows_the_weights(scene):
    _, models, *_ = scene
    m = models[0]
    assert renderer._replica(m, torch.device("cpu")) is m
    meta = torch.device("meta")
    r1 = renderer._replica(m, meta)
    assert r1 is not m and next(r1.parameters()).device == meta
    assert renderer._replica(m, meta) is r1
    p = next(m.parameters())
    with torch.no_grad():
        p.add_(0.0)  # a write bumps the weights' version: a new replica
    assert renderer._replica(m, meta) is not r1
    assert next(m.parameters()).device.type == "cpu"


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_evaluate_over_devices_writes_the_one_device_files(avatar, tmp_path):  # noqa: F811
    ds_dir, ckpt, _, _ = avatar
    cfg = CfgNode(_cfg_dict(ds_dir, perturb=True))
    evaluate(cfg, ckpt, str(tmp_path / "one"), save_disparity_image=True, log=False,
             device="cpu")
    summary = evaluate(cfg, ckpt, str(tmp_path / "two"), save_disparity_image=True, log=False,
                       devices=["cpu", "cpu"])
    assert summary["frames"] == 2
    one, two = _files(tmp_path / "one"), _files(tmp_path / "two")
    assert len(one) == 6 and one == two


def _fast_cfg(ds_dir):
    cfg = CfgNode(_cfg_dict(ds_dir, perturb=True))
    cfg.nerf.validation["fast_eval"] = True
    return cfg


def test_server_over_devices_serves_the_one_device_frames(avatar):  # noqa: F811
    ds_dir, ckpt, _, parity = avatar
    two = AvatarServer(CfgNode(_cfg_dict(ds_dir)), checkpoint=ckpt, log=False,
                       devices=["cpu", "cpu"])
    assert two.device.type == "cpu" and two.handle({"cmd": "ping"})["device"] == "cpu"
    maps = ("rgb_fine", "rgb_coarse", "disp", "acc")
    for frame in (0, 1):
        a, b = parity.render(frame=frame, maps=maps), two.render(frame=frame, maps=maps)
        for k in maps:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    fast_one = AvatarServer(_fast_cfg(ds_dir), checkpoint=ckpt, device="cpu", log=False)
    for n_dev in (2, 3):
        fast = AvatarServer(_fast_cfg(ds_dir), checkpoint=ckpt, log=False,
                            devices=["cpu"] * n_dev)
        # JAX's rule rounds the capacity to whole tiles on every device: the
        # sharded frame may render more spare slots, which hold real rays
        extra = _extra_slots(fast_one, n_dev, 0)[0]
        a = fast_one.render(frame=0, seed=4, maps=maps)
        b = fast.render(frame=0, seed=4, maps=maps)
        for k in maps:
            if k == "disp":  # min-max normalised over the frame
                continue
            np.testing.assert_array_equal(a[k][~extra], b[k][~extra], err_msg=f"fast {k}")
        if not extra.any():
            np.testing.assert_array_equal(a["disp"], b["disp"])


def test_cli_eval_and_serve_num_devices_on_the_cpu(avatar, tmp_path, monkeypatch,  # noqa: F811
                                                    capsys):
    from nerface_tpu_torch.cli import eval as cli_eval
    from nerface_tpu_torch.cli import serve as cli_serve

    ds_dir, ckpt, _, _ = avatar
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(CfgNode(_cfg_dict(ds_dir, perturb=True)).dump())
    base = ["--config", str(cfg_path), "--checkpoint", ckpt, "--device", "cpu"]
    cli_eval.main(base + ["--savedir", str(tmp_path / "one")])
    cli_eval.main(base + ["--savedir", str(tmp_path / "two"), "--num-devices", "2"])
    assert _files(tmp_path / "one") == _files(tmp_path / "two")
    capsys.readouterr()

    def serve(extra):
        requests = "\n".join(json.dumps(r) for r in (
            {"frame": 1, "encode": "png_base64", "maps": ["rgb_fine", "disp"]},
            {"cmd": "stop"})) + "\n"
        monkeypatch.setattr(sys, "stdin", io.StringIO(requests))
        cli_serve.main(base + ["--stdio"] + extra)
        return [json.loads(line) for line in capsys.readouterr().out.splitlines()
                if line.startswith("{")]

    one, two = serve([]), serve(["--num-devices", "3"])
    assert one[0]["ok"] and two[0]["ok"]
    assert one[0]["maps"] == two[0]["maps"]
