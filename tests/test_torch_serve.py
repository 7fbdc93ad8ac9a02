"""PyTorch port, the whole serving slice: `nerface_tpu_torch.serve.AvatarServer`
(→ render_full_frame → render_rays → model / fused render) against the JAX
package's `AvatarServer`, both in f32 on the CPU, on one checkpoint written
by the JAX package (`create_train_state` + `export_torch_checkpoint`, no
training) over a 16×16 synthetic dataset from the JAX package's generator.
Validation uses `perturb: False`, so no random draws enter the frames;
`render_rays` with `perturb: True` is held to JAX with JAX's own draws
injected."""

import copy
import importlib.util
import io
import json
import pathlib
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.config.flags import FeatureFlags as JaxFeatureFlags
from nerface_tpu.data.flame import load_flame_data as jax_load_flame_data
from nerface_tpu.data.synthetic import make_synthetic_flame_dataset
from nerface_tpu.ops import sampling as jax_sampling
from nerface_tpu.render import pipeline as jax_pipeline
from nerface_tpu.serve import AvatarServer as JaxAvatarServer
from nerface_tpu.train.checkpoint import export_torch_checkpoint
from nerface_tpu.train.loop import build_models_from_cfg
from nerface_tpu.train.state import create_train_state
from nerface_tpu_torch.config import CfgNode, load_config
from nerface_tpu_torch.data.flame import load_flame_data
from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
from nerface_tpu_torch.eval.renderer import render_full_frame
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.serve import AvatarServer

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
H = W = 16


def _cfg_dict(basedir, perturb=False, n_samples=16):
    model = {
        "type": "ConditionalBlendshapePaperNeRFModel", "num_encoding_fn_xyz": 10,
        "num_encoding_fn_dir": 4, "include_input_xyz": True, "include_input_dir": False,
        "use_viewdirs": True, "num_layers": 4, "hidden_size": 256,
        "log_sampling_xyz": True, "log_sampling_dir": True,
    }
    return {
        "experiment": {"id": "t", "logdir": "/nonexistent", "randomseed": 42},
        "dataset": {"basedir": basedir, "type": "blender", "no_ndc": True,
                    "near": 0.2, "far": 0.8, "half_res": False, "testskip": 1},
        "models": {"coarse": dict(model), "fine": dict(model)},
        "optimizer": {"type": "Adam", "lr": 5e-4},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
        "nerf": {
            "use_viewdirs": True,
            "validation": {"chunksize": 128, "perturb": perturb, "num_coarse": n_samples,
                           "num_fine": n_samples, "white_background": False,
                           "radiance_field_noise_std": 0.0, "lindisp": False},
        },
    }


@pytest.fixture(scope="module")
def avatar(tmp_path_factory):
    """(dataset dir, .ckpt path, JAX server, port server): random JAX
    weights and a random latent table, exported in the reference schema."""
    tmp = tmp_path_factory.mktemp("torch_serve")
    ds_dir = make_synthetic_flame_dataset(
        str(tmp / "ds"), H=H, W=W, n_train=3, n_val=1, n_test=2, num_samples=8
    )
    jcfg = JaxCfgNode(_cfg_dict(ds_dir))
    mc, mf = build_models_from_cfg(jcfg)
    state, _ = create_train_state(
        jax.random.PRNGKey(1), mc, mf, jcfg, JaxFeatureFlags(), n_train=3,
        background=jnp.zeros((H, W, 3)),
    )
    rng = np.random.RandomState(0)
    state.params["latent_codes"] = jnp.asarray(rng.randn(3, 32).astype(np.float32) * 0.3)
    ckpt = str(tmp / "avatar.ckpt")
    export_torch_checkpoint(ckpt, state)
    jax_server = JaxAvatarServer(jcfg, checkpoint=ckpt, log=False)
    port_server = AvatarServer(CfgNode(_cfg_dict(ds_dir)), checkpoint=ckpt, device="cpu",
                               log=False)
    return ds_dir, ckpt, jax_server, port_server


@pytest.mark.parametrize("frame", [0, 1])
def test_served_frame_matches_jax_server(avatar, frame):
    """uint8 rgb_fine within 1 level of the JAX server's, ≥ 99 % equal
    (f32 on both sides: only the order of f32 sums differs, so a level
    changes only where a value sits on a rounding boundary)."""
    _, _, jax_server, port_server = avatar
    ref = jax_server.render(frame=frame, maps=("rgb_fine", "rgb_coarse"))
    got = port_server.render(frame=frame, maps=("rgb_fine", "rgb_coarse"))
    for name in ("rgb_fine", "rgb_coarse"):
        assert got[name].shape == (H, W, 3) and got[name].dtype == np.uint8
        diff = np.abs(got[name].astype(np.int16) - ref[name].astype(np.int16))
        assert diff.max() <= 1, name
        assert (diff == 0).mean() >= 0.99, name


def test_other_maps_match_jax_server(avatar):
    _, _, jax_server, port_server = avatar
    maps = ("disp", "depth", "acc", "normals")
    ref = jax_server.render(frame=1, maps=maps)
    got = port_server.render(frame=1, maps=maps)
    for name in maps:
        assert got[name].shape == ref[name].shape and got[name].dtype == np.uint8, name
        diff = np.abs(got[name].astype(np.int16) - ref[name].astype(np.int16))
        assert diff.max() <= 1, name


def test_render_rays_with_jax_draws(avatar):
    """perturb: True, JAX's per-ray draws injected (the same split of the
    key that `render_rays` makes): atol 1e-4 — f32 sum order, carried
    through the resampling's cdf."""
    _, _, jax_server, port_server = avatar
    js = jax_server
    R = 64
    rng = np.random.RandomState(2)
    ro = np.tile(js._default_pose[:3, 3], (R, 1)).astype(np.float32)
    rd = (rng.randn(R, 3) * [0.05, 0.05, 0.0] - [0, 0, 1]).astype(np.float32) @ js._default_pose[:3, :3].T
    rd = rd.astype(np.float32)
    bg = rng.rand(R, 3).astype(np.float32)
    expr = np.asarray(js._default_expression)
    latent = np.asarray(js.latent_codes[1])
    jset = jax_pipeline.RenderSettings(
        num_coarse=16, num_fine=16, perturb=True, near=0.2, far=0.8,
        encode_xyz=jax_pipeline.EncodeSpec(10, True, True),
        encode_dir=jax_pipeline.EncodeSpec(4, False, True),
    )
    key = jax.random.PRNGKey(9)
    idx = jnp.arange(R, dtype=jnp.int32)
    ref = jax_pipeline.render_rays(
        js.model_coarse, js.model_fine, js.params_coarse, js.params_fine,
        jnp.asarray(ro), jnp.asarray(rd), jset, key=key, expressions=jnp.asarray(expr),
        latent_code=jnp.asarray(latent), background_prior=jnp.asarray(bg), ray_index=idx,
    )
    k_strat, _, k_pdf, _ = jax.random.split(key, 4)
    t_rand = np.asarray(jax_sampling.per_ray_uniform(k_strat, idx, 16))
    u = np.asarray(jax_sampling.per_ray_uniform(k_pdf, idx, 16))
    tset = pipeline.RenderSettings(
        num_coarse=16, num_fine=16, perturb=True, near=0.2, far=0.8,
        encode_xyz=pipeline.EncodeSpec(10, True, True),
        encode_dir=pipeline.EncodeSpec(4, False, True),
    )
    ps = port_server
    with torch.no_grad():
        got = pipeline.render_rays(
            ps.model_coarse, ps.model_fine, torch.from_numpy(ro), torch.from_numpy(rd), tset,
            expressions=torch.from_numpy(expr.copy()), latent_code=torch.from_numpy(latent.copy()),
            background_prior=torch.from_numpy(bg), t_rand=torch.from_numpy(t_rand.copy()),
            u=torch.from_numpy(u.copy()),
        )
    for k in ("rgb_coarse", "acc_coarse", "depth_coarse", "rgb_fine", "acc_fine",
              "depth_fine", "bg_weight", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=0,
                                   err_msg=k)
    for k in ("disp_coarse", "disp_fine"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, err_msg=k)


def test_frame_is_the_same_for_any_tiling(avatar):
    """The port's own draws are keyed by global ray index (perturb on)."""
    _, _, _, ps = avatar
    settings = pipeline.RenderSettings.from_cfg(
        CfgNode(_cfg_dict("", perturb=True)), mode="validation"
    )
    args = (ps.model_coarse, ps.model_fine, H, W, ps.intrinsics, ps._default_pose[:3, :4],
            settings)
    kw = dict(seed=4, expressions=torch.from_numpy(ps._default_expression.copy()),
              latent_code=ps.latent_codes[0], background=ps.background)
    a = render_full_frame(*args, tile=48, **kw)
    b = render_full_frame(*args, tile=256, **kw)
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=1e-6, rtol=0)
    c = render_full_frame(*args, tile=256, **dict(kw, seed=5))
    assert not torch.equal(a["rgb_fine"], c["rgb_fine"])


def test_bf16_server_goes_through_fused_render(avatar, monkeypatch):
    """dtype=bf16: both passes of each tile are one fused_paper_render call
    (its plain version on the CPU) at sample counts the kernel takes, and
    the frame stays within a few levels of the f32 frame (bf16 matmul
    operands)."""
    ds_dir, ckpt, _, ps = avatar
    calls = []
    real = pipeline.fused_paper_render

    def counting(*a, **k):
        calls.append(a[3].shape[-1])
        return real(*a, **k)

    monkeypatch.setattr(pipeline, "fused_paper_render", counting)
    cfg = CfgNode(_cfg_dict(ds_dir, n_samples=32))
    srv = AvatarServer(cfg, checkpoint=ckpt, device="cpu", dtype=torch.bfloat16, log=False)
    got = srv.render(frame=0)["rgb_fine"]
    tiles = H * W // 128
    assert calls == [32, 64] * tiles  # coarse S=32, fine S=64, per tile
    ref = AvatarServer(cfg, checkpoint=ckpt, device="cpu", log=False).render(frame=0)["rgb_fine"]
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.mean() <= 1.0 and np.percentile(diff, 99) <= 4


def test_jsonl_protocol(avatar):
    _, _, _, ps = avatar
    requests = "\n".join([
        json.dumps({"cmd": "ping"}),
        "not json at all",
        json.dumps({"frame": 0, "maps": ["rgb_fine", "nope"]}),
        json.dumps({"cmd": "reboot"}),
        json.dumps({"frame": 1, "seed": 2, "maps": ["rgb_fine", "disp"]}),
        json.dumps({"fast_eval": True}),
        json.dumps({"cmd": "stop"}),
        json.dumps({"cmd": "ping"}),  # after stop: never handled
    ])
    out = io.StringIO()
    n = ps.serve_jsonl(io.StringIO(requests), out)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert n == 7 and len(lines) == 7
    assert lines[0]["ok"] and lines[0]["H"] == H and lines[0]["n_test_frames"] == 2
    assert lines[0]["n_latent_codes"] == 3
    assert not lines[1]["ok"] and "bad json" in lines[1]["error"]
    assert not lines[2]["ok"] and "unknown maps" in lines[2]["error"]
    assert not lines[3]["ok"] and "unknown cmd" in lines[3]["error"]
    assert lines[4]["ok"] and lines[4]["frame_ms"] > 0
    assert not lines[5]["ok"] and "fast_eval" in lines[5]["error"]
    assert lines[6] == {"ok": True, "cmd": "stop"}


def test_tcp_loop(avatar):
    _, _, _, ps = avatar
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    counts = {}
    t = threading.Thread(target=lambda: counts.setdefault("n", ps.serve_tcp("127.0.0.1", port)))
    t.start()
    conn = None
    for _ in range(50):
        try:
            conn = socket.create_connection(("127.0.0.1", port), timeout=30)
            break
        except OSError:
            time.sleep(0.1)
    if conn is None:
        pytest.fail(f"server on port {port} never accepted a connection")
    with conn, conn.makefile("rw", encoding="utf-8") as stream:
        stream.write(json.dumps({"frame": 1}) + "\n" + json.dumps({"cmd": "ping"}) + "\n")
        stream.flush()
        assert json.loads(stream.readline())["frame_ms"] > 0  # in arrival order
        assert json.loads(stream.readline())["cmd"] == "ping"
        stream.write(json.dumps({"cmd": "stop"}) + "\n")
        stream.flush()
        assert json.loads(stream.readline())["cmd"] == "stop"
    t.join(timeout=60)
    assert not t.is_alive() and counts["n"] == 3


def test_cli_stdio(avatar, tmp_path, monkeypatch, capsys):
    import sys

    from nerface_tpu_torch.cli.serve import build_parser, main

    ds_dir, ckpt, _, _ = avatar
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(CfgNode(_cfg_dict(ds_dir)).dump())
    requests = json.dumps({"cmd": "ping"}) + "\n" + json.dumps({"cmd": "stop"}) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(requests))
    main(["--config", str(cfg_path), "--checkpoint", ckpt, "--stdio", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines[0]["ok"] and lines[0]["device"] == "cpu" and lines[-1]["cmd"] == "stop"
    base = ["--config", "c.yml", "--checkpoint", "k", "--stdio"]
    args = build_parser().parse_args(base + ["--bf16", "--num-devices", "4"])
    assert args.bf16 and args.num_devices == 4 and args.device == "cuda"
    assert build_parser().parse_args(base + ["--fast-eval"]).fast_eval
    with pytest.raises(SystemExit, match="this host has 0 CUDA device"):
        main(base + ["--num-devices", "2"])


def test_fast_eval_config_serves(avatar):
    """`fast_eval: true` builds a fast server (bbox union of the test
    split) that reports it and renders; the JAX server's bbox and capacity."""
    ds_dir, ckpt, _, _ = avatar
    cfg = CfgNode(_cfg_dict(ds_dir))
    cfg.nerf.validation["fast_eval"] = True
    srv = AvatarServer(cfg, checkpoint=ckpt, device="cpu", log=False)
    jcfg = JaxCfgNode(_cfg_dict(ds_dir))
    jcfg.nerf.validation["fast_eval"] = True
    jsrv = JaxAvatarServer(jcfg, checkpoint=ckpt, log=False)
    np.testing.assert_array_equal(srv.fast_bbox, jsrv.fast_bbox)
    assert srv.settings.fast_eval_capacity == jsrv.settings.fast_eval_capacity
    assert srv.handle({"cmd": "ping"})["fast_eval"] is True
    reply = srv.handle({"frame": 0})
    assert reply["ok"] and reply["frame_ms"] > 0


def test_synthetic_dataset_matches_generator_files(avatar):
    """The in-memory synthetic dataset holds what the JAX generator wrote,
    and the port's loader reads the files as the JAX loader does."""
    ds_dir = avatar[0]
    disk = load_flame_data(ds_dir)
    jdisk = jax_load_flame_data(ds_dir)
    for name in ("images", "poses", "expressions", "bboxes", "intrinsics", "render_poses"):
        np.testing.assert_array_equal(getattr(disk, name), getattr(jdisk, name), err_msg=name)
    np.testing.assert_array_equal(disk.load_background(), jdisk.load_background())
    mem = synthetic_flame_dataset(n_train=3, n_val=1, n_test=2, H=H, W=W)
    assert mem.images is None and (mem.H, mem.W) == (H, W)
    for name in ("poses", "expressions", "bboxes", "intrinsics", "render_poses"):
        np.testing.assert_array_equal(getattr(mem, name), getattr(disk, name), err_msg=name)
    for a, b in zip(mem.i_split, disk.i_split):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mem.load_background(), disk.load_background())
    np.testing.assert_array_equal(mem.load_index_map(), disk.load_index_map())


def test_image_casts_match_jax():
    """The uint8 casts of the served maps: bit-equal to the JAX package's
    (f32 clip·255 then round-half-even, truncation, min-max)."""
    from nerface_tpu.eval import driver as jdriver
    from nerface_tpu.serve import _u8_minmax as jax_minmax
    from nerface_tpu.serve import _u8_unit as jax_unit
    from nerface_tpu_torch.eval import driver
    from nerface_tpu_torch.serve import _u8_minmax, _u8_unit

    rng = np.random.RandomState(1)
    # out-of-range values hit the clamp; the ramp lands many x·255 on .5
    x = np.concatenate([rng.uniform(-0.3, 1.3, 4096), np.arange(511) / 510.0]).astype(np.float32)
    x = x.reshape(-1, 1, 1).repeat(3, axis=2)
    np.testing.assert_array_equal(driver.device_cast_to_image(torch.from_numpy(x)).numpy(),
                                  np.asarray(jdriver.device_cast_to_image(jnp.asarray(x))))
    np.testing.assert_array_equal(driver.cast_to_image(x), jdriver.cast_to_image(x))
    n = rng.uniform(0.0, 255.0, (9, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(driver.device_uint8(torch.from_numpy(n)).numpy(),
                                  np.asarray(jdriver.device_uint8(jnp.asarray(n))))
    d = rng.uniform(0.1, 5.0, (33, 7)).astype(np.float32)
    np.testing.assert_array_equal(_u8_minmax(torch.from_numpy(d)).numpy(),
                                  np.asarray(jax_minmax(jnp.asarray(d))))
    np.testing.assert_array_equal(_u8_unit(torch.from_numpy(d / 5)).numpy(),
                                  np.asarray(jax_unit(jnp.asarray(d / 5))))
    np.testing.assert_array_equal(driver.cast_to_disparity_image(d),
                                  jdriver.cast_to_disparity_image(d))


def test_chip_smoke_config_is_synth512_paper():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert CfgNode(copy.deepcopy(chip_smoke.SYNTH512_PAPER)) == load_config(
        str(REPO / "configs" / "synth512_paper.yml")
    )
