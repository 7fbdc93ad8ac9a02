"""PyTorch port, the reenactment path's host side, on the CPU.

* `client.AvatarClient` against the port's `AvatarServer.serve_tcp` on
  port 0 (the bound port read from the line `serve_tcp` prints), on the
  tiny avatar of `tests/test_torch_serve.py`: ping, a render equal to
  `handle()`'s for the same request (and to JAX's client on the same
  server), a failing request, pipelined ordering, two clients at once.
* `tools/reenactment_demo.py`: `make_tracker_identity` writes JAX's files
  byte for byte (JAX's demo loaded by path; it imports `nerface_tpu` only
  inside its functions); `scaled_config` is JAX's overrides applied to
  `configs/synth512_paper.yml` (JAX's own function, its reference config
  path pointed at that file); the demo end to end on the CPU in f32 at 8²
  writes a `summary.json` with every field and the triptych AVI.
* `train/loop.py::train_from_config_file` against JAX's on one YAML file.

Decoded PNGs and files compare exactly; the training losses at rtol 1e-4
and the parameters at `tests/test_torch_train.py`'s tolerances.
"""

import base64
import copy
import importlib.util
import io
import json
import os
import re
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from nerface_tpu.client import AvatarClient as JaxAvatarClient
from nerface_tpu.train.loop import train_from_config_file as jax_train_from_config_file
from nerface_tpu_torch.client import AvatarClient
from nerface_tpu_torch.config import CfgNode
from nerface_tpu_torch.serve import AvatarServer
from nerface_tpu_torch.tools import reenactment_demo as demo
from nerface_tpu_torch.train import loop
from test_torch_serve import H, _cfg_dict, avatar  # noqa: F401  (a fixture)
from test_torch_train import _train_cfg, dataset_dir, pin_numpy_feeds  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_reenactment_demo", os.path.join(ROOT, "tools", "reenactment_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the client ------------------------------------------------------------------

@pytest.fixture
def tcp_server(avatar, capsys):
    """The port's server on the tiny avatar, `serve_tcp` on port 0 in a
    thread; yields (server, bound port) and checks the loop ended."""
    ds_dir, ckpt, _, _ = avatar
    server = AvatarServer(CfgNode(_cfg_dict(ds_dir)), checkpoint=ckpt, device="cpu", log=True)
    done = {}
    t = threading.Thread(target=lambda: done.setdefault("n", server.serve_tcp("127.0.0.1", 0)))
    t.start()
    text, port = "", None
    deadline = time.time() + 60
    while port is None and t.is_alive() and time.time() < deadline:
        text += capsys.readouterr().out
        m = re.search(r"\[serve\] listening on 127\.0\.0\.1:(\d+)", text)
        if m:
            port = int(m.group(1))
        time.sleep(0.02)
    if port is None:
        pytest.fail(f"serve_tcp never printed its port: {text!r}")
    assert port > 0
    try:
        yield server, port
    finally:
        t.join(timeout=30)
        if t.is_alive():  # a failed test left the loop running: stop it
            with socket.create_connection(("127.0.0.1", port), timeout=30) as conn:
                conn.sendall(b'{"cmd": "stop"}\n')
                conn.recv(1024)
            t.join(timeout=60)
    assert not t.is_alive() and done["n"] > 0


def _decode(response):
    return {name: np.asarray(Image.open(io.BytesIO(base64.b64decode(p["png_base64"]))))
            for name, p in response["maps"].items()}


def test_client_render_equals_handle(tcp_server):
    server, port = tcp_server
    req = {"frame": 1, "seed": 5, "maps": ["rgb_fine", "disp"]}
    with AvatarClient("127.0.0.1", port) as client, JaxAvatarClient("127.0.0.1", port) as jc:
        pong = client.ping()
        assert pong["ok"] and pong["H"] == H and pong["device"] == "cpu"
        got = client.render(frame=1, seed=5, maps=("rgb_fine", "disp"))
        want = _decode(server.handle(dict(req, encode="png_base64")))
        assert sorted(got) == sorted(want) == ["disp", "rgb_fine"]
        for name in want:
            assert got[name].dtype == np.uint8
            np.testing.assert_array_equal(got[name], want[name])
        direct = server.render(frame=1, seed=5, maps=("rgb_fine", "disp"))
        np.testing.assert_array_equal(got["rgb_fine"], direct["rgb_fine"])
        # the JAX package's client speaks the same protocol
        jgot = jc.render(frame=1, seed=5, maps=("rgb_fine", "disp"))
        for name in want:
            np.testing.assert_array_equal(jgot[name], got[name])
        expr = np.linspace(-0.5, 0.5, 76)
        pose = server.dataset.poses[server.dataset.i_test[0]]
        a = client.render(expression=expr, pose=pose, latent_index=2, maps=("rgb_fine",))
        b = _decode(server.handle({"expression": expr.astype(np.float32).tolist(),
                                   "pose": pose.astype(np.float32).reshape(-1).tolist(),
                                   "latent_index": 2, "encode": "png_base64"}))
        np.testing.assert_array_equal(a["rgb_fine"], b["rgb_fine"])
        with pytest.raises(RuntimeError, match="render failed"):
            client.render(frame=999)
        assert client.request({"cmd": "nope"})["ok"] is False
        client.stop_server()


def test_client_pipelined_ordering_and_two_clients(tcp_server):
    """A burst of renders and a ping on one connection come back in arrival
    order; an idle connection does not block a second client."""
    _, port = tcp_server
    with AvatarClient("127.0.0.1", port) as idle, AvatarClient("127.0.0.1", port) as client:
        burst = "".join(json.dumps(r) + "\n" for r in (
            {"seed": 1}, {"seed": 2, "maps": ["disp"]}, {"cmd": "ping"}, {"frame": 0}))
        client._stream.write(burst)
        client._stream.flush()
        replies = [json.loads(client._stream.readline()) for _ in range(4)]
        assert [("frame_ms" in r, r.get("cmd")) for r in replies] == [
            (True, None), (True, None), (False, "ping"), (True, None)]
        assert all(r["ok"] for r in replies)
        assert idle.ping()["ok"] and client.ping()["requests_served"] >= 3
        idle.stop_server()


# -- the demo ----------------------------------------------------------------------

def test_make_tracker_identity_equals_jax(tmp_path):
    jax_demo = _jax_demo()
    for side, fn in (("port", demo.make_tracker_identity), ("jax", jax_demo.make_tracker_identity)):
        fn(str(tmp_path / side), 6, seed=2, neutral_e0=-0.4, H=12, W=16, yaw_amp=6.0)
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                   for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert len(names) == 6 + 4
    for rel in names:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


@pytest.mark.parametrize("size", [64, 128])
def test_scaled_config_is_jax_overrides_on_synth512_paper(monkeypatch, size):
    """JAX's `scaled_config` run on `configs/synth512_paper.yml` (its
    reference config path redirected there) gives the port's config."""
    import builtins

    jax_demo = _jax_demo()
    opened = []

    def redirect(path, *a, **k):
        opened.append(path)
        return builtins.open(demo.PAPER_CONFIG, *a, **k)

    monkeypatch.setattr(jax_demo, "open", redirect, raising=False)
    want = jax_demo.scaled_config("/data/ds", "/data/logs", 2000, size)
    assert opened and opened[0].endswith("dave_dvp_lcode_fixed_bg_512_paper_model.yml")
    got = demo.scaled_config("/data/ds", "/data/logs", 2000, size)
    assert got == want
    if size >= 128:  # the paper's shape and the device feed
        assert got["experiment"]["device_feed"] is True
        assert got["nerf"]["validation"]["chunksize"] == size * size
        assert got["nerf"]["train"]["num_coarse"] == got["nerf"]["train"]["num_fine"] == 64
    else:
        assert got["nerf"]["train"]["num_random_rays"] == 512
    with open(os.path.join(ROOT, "configs", "synth512_paper.yml")) as f:
        assert yaml.safe_load(f)["models"] == got["models"]


SIGMA_BIAS = 10.0  # chip_smoke.py's: σ raised so that the MLP's colour makes the pixels


def _brighten(path):
    """The checkpoint's models He-scaled with σ biased up, as chip_smoke.py's
    random avatars: a few CPU iterations leave the avatar showing the
    background, whose pixels do not move with the driving expression, and
    the demo's hard check would then stop it."""
    from nerface_tpu_torch.tools.perf.cases import HE_GAIN

    ck = torch.load(path, weights_only=False)
    for key in ("model_coarse_state_dict", "model_fine_state_dict"):
        sd = ck[key]
        for name in sd:
            if name.endswith(".weight"):
                sd[name] = sd[name] * HE_GAIN
        sd["fc_alpha.bias"] = sd["fc_alpha.bias"] + SIGMA_BIAS
    torch.save(ck, path)


def test_demo_end_to_end_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The demo's every stage at 8², 16 frames (6 to train on, the 10
    reserved for self-reenactment), 2 iterations, f32 on the CPU."""
    real_train = loop.train
    calls = []

    def train_then_brighten(cfg, **kw):
        calls.append(kw)
        state = real_train(cfg, **kw)
        logdir = os.path.join(cfg.experiment.logdir, cfg.experiment.id)
        for name in os.listdir(logdir):
            if name.endswith(".ckpt"):
                _brighten(os.path.join(logdir, name))
        return state

    monkeypatch.setattr(loop, "train", train_then_brighten)
    w = str(tmp_path / "demo")
    summary = demo.main(["--device", "cpu", "--size", "8", "--frames", "16", "--iters", "2",
                         "--workdir", w])
    out = capsys.readouterr().out
    assert "bf16=False" in out and len(calls) == 1
    assert calls[0]["dtype"] is None and calls[0]["device"] == torch.device("cpu")
    assert re.findall(r"\[TRAIN\] Iter: (\d+)", out) == ["0", "1"]
    with open(os.path.join(w, "summary.json")) as f:
        assert json.load(f) == summary
    assert sorted(summary) == ["cross_reenactment", "self_reenactment", "video"]
    s, c = summary["self_reenactment"], summary["cross_reenactment"]
    assert sorted(s) == ["frames", "l1", "psnr", "s_per_frame", "ssim"] and s["frames"] == 10
    assert sorted(c) == ["frames", "s_per_frame", "temporal_std"] and c["frames"] == 16
    assert all(np.isfinite(v) for v in list(s.values()) + list(c.values()))
    assert c["temporal_std"] > 1.0
    blob = open(summary["video"], "rb").read()
    avih = blob.index(b"avih") + 8
    assert struct.unpack("<I", blob[avih + 16:avih + 20])[0] == 16  # dwTotalFrames
    w_px, h_px = struct.unpack("<2I", blob[avih + 32:avih + 40])
    assert (w_px, h_px) == (3 * 8, 8)  # driving | reenacted | normals, 7² scaled to 8
    assert sorted(os.listdir(os.path.join(w, "renders_driven", "normals")))[-1] == "0015.png"
    assert os.path.isfile(os.path.join(w, "renders_self", "metrics.txt"))
    args = demo.build_parser().parse_args([])
    assert args.device == "cuda" and args.bf16 is None and args.workdir.endswith("reenact_demo")


# -- train_from_config_file --------------------------------------------------------

def test_train_from_config_file_equals_jax(dataset_dir, tmp_path, capsys, monkeypatch):  # noqa: F811
    """Both packages' `train_from_config_file` on one YAML file, 2 f32 steps
    on the CPU from one checkpoint, on their numpy host feeds."""
    from nerface_tpu_torch.train.loop import build_models_from_cfg

    pin_numpy_feeds(monkeypatch)
    d = _train_cfg(dataset_dir, str(tmp_path / "runs"))
    d["experiment"]["train_iters"] = 2
    path = str(tmp_path / "cfg.yml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    mc, mf = build_models_from_cfg(CfgNode(copy.deepcopy(d)),
                                   generator=torch.Generator().manual_seed(3))
    start = str(tmp_path / "start.ckpt")
    torch.save({"iter": 0, "model_coarse_state_dict": mc.state_dict(),
                "model_fine_state_dict": mf.state_dict(), "optimizer_state_dict": None,
                "loss": 0.0, "psnr": 0.0, "background": None,
                "latent_codes": torch.zeros(4, 32)}, start)
    jstate = jax_train_from_config_file(path, load_checkpoint=start, log=False)
    jax_losses = re.findall(r"\[TRAIN\] Iter: \d+ Loss: ([0-9.]+)", capsys.readouterr().out)
    state = loop.train_from_config_file(path, load_checkpoint=start, device="cpu")
    losses = re.findall(r"\[TRAIN\] Iter: \d+ Loss: ([0-9.]+)", capsys.readouterr().out)
    assert state.step == int(jstate.step) == 2 and len(losses) == len(jax_losses) == 2
    np.testing.assert_allclose([float(v) for v in losses], [float(v) for v in jax_losses],
                               rtol=1e-4)
    lr = 5e-4
    for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
        for name, p in m.named_parameters():
            got, want = p.detach().numpy(), np.asarray(jstate.params[which][name])
            np.testing.assert_allclose(got, want, atol=10 * lr, rtol=0, err_msg=name)
            assert np.mean(np.abs(got - want) <= 1e-5) >= 0.99, name
