"""PyTorch port, the production run's sidecars on the CPU: atomic `.ckpt`
writes, `latest_checkpoint`, `AsyncCheckpointWriter`, SIGTERM's exit 143
through the loop's `finally`, a resumed run equal to the uninterrupted one
bit for bit, `ScalarWriter` and the loop's TensorBoard panels, and the
train CLI's new flags.
"""

import copy
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import yaml

from nerface_tpu_torch.cli import train as cli_train
from nerface_tpu_torch.config import CfgNode, FeatureFlags
from nerface_tpu_torch.data.flame import load_flame_data
from nerface_tpu_torch.train import checkpoint as ckpt
from nerface_tpu_torch.train.loop import train, validate
from nerface_tpu_torch.train.state import build_optimizer
from nerface_tpu_torch.utils.tb import ScalarWriter
from test_torch_train import _train_cfg, dataset_dir  # noqa: F401 (dataset_dir is a fixture)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _cfg(dataset_dir, logdir, **experiment):
    d = _train_cfg(dataset_dir, str(logdir))
    d["experiment"].update(experiment)
    return d


def _states_equal(a, b):
    """Parameters, latent table and Adam state of two `.ckpt` dicts, bit for bit."""
    for which in ("coarse", "fine"):
        assert a[which].keys() == b[which].keys()
        for k in a[which]:
            assert torch.equal(a[which][k], b[which][k]), (which, k)
    assert torch.equal(a["latent_codes"], b["latent_codes"])
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for key in oa["state"]:
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa["state"][key][f], ob["state"][key][f]), (key, f)


@pytest.fixture(scope="module")
def trained(dataset_dir, tmp_path_factory):
    """6 CPU steps saved at steps 1, 4 and 6, with validation at 0 and 2."""
    logdir = tmp_path_factory.mktemp("trained")
    cfg = CfgNode(_cfg(dataset_dir, logdir, train_iters=6, save_every=3, print_every=2,
                       validate_every=2))
    state = train(cfg, dataset=load_flame_data(dataset_dir), device="cpu")
    run_dir = os.path.join(str(logdir), "slice")
    optimizer = build_optimizer(cfg, state)  # with the saved Adam state
    ckpt.restore_train_state(state, optimizer, ckpt.load_torch_checkpoint(
        os.path.join(run_dir, "checkpoint00006.ckpt")))
    return {"cfg": cfg, "state": state, "optimizer": optimizer, "dir": run_dir}


def test_checkpoint_step_is_numeric():
    assert ckpt.checkpoint_step("/x/checkpoint100001.ckpt") == 100001
    assert ckpt.checkpoint_step("checkpoint00005.ckpt") == 5
    for name in ("checkpoint00005.ckpt.tmp", "checkpoint.ckpt", "ckpt00005.ckpt", "checkpoint00005"):
        assert ckpt.checkpoint_step(name) == -1, name


def test_latest_checkpoint_skips_partial_files(tmp_path):
    assert ckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    for name in ("checkpoint95001.ckpt", "checkpoint100001.ckpt", "checkpoint00002.ckpt"):
        (tmp_path / name).write_bytes(b"x")
    (tmp_path / "checkpoint200001.ckpt.tmp").write_bytes(b"partial")
    (tmp_path / "checkpoint300001.ckpt").mkdir()  # not a file
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint100001.ckpt")
    assert not ckpt.is_complete_checkpoint(str(tmp_path / "checkpoint200001.ckpt.tmp"))
    assert ckpt.is_complete_checkpoint(str(tmp_path / "checkpoint95001.ckpt"))


def test_the_loop_saves_complete_checkpoints(trained):
    names = sorted(os.listdir(trained["dir"]))
    assert [n for n in names if n.endswith(".ckpt")] == [
        "checkpoint00001.ckpt", "checkpoint00004.ckpt", "checkpoint00006.ckpt"]
    assert not [n for n in names if n.endswith(".tmp")]
    assert ckpt.latest_checkpoint(trained["dir"]).endswith("checkpoint00006.ckpt")
    last = ckpt.load_torch_checkpoint(ckpt.latest_checkpoint(trained["dir"]))
    assert last["iter"] == 6
    for name, p in trained["state"].model_fine.named_parameters():
        assert torch.equal(last["fine"][name], p.detach()), name


def test_save_is_atomic(trained, tmp_path, monkeypatch):
    """A save that dies while writing leaves a `.tmp` and no `.ckpt`."""
    path = str(tmp_path / "checkpoint00007.ckpt")
    real_save = torch.save

    def dying_save(obj, f):
        real_save({"partial": torch.zeros(3)}, f)
        raise KeyboardInterrupt("killed mid-save")

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_torch_checkpoint(path, trained["state"], trained["optimizer"])
    assert not os.path.exists(path) and os.path.exists(path + ".tmp")
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    monkeypatch.setattr(torch, "save", real_save)
    ckpt.save_torch_checkpoint(path, trained["state"], trained["optimizer"])
    assert ckpt.latest_checkpoint(str(tmp_path)) == path


def test_async_save_equals_sync_save(trained, tmp_path):
    state, opt = trained["state"], trained["optimizer"]
    sync = ckpt.save_torch_checkpoint(str(tmp_path / "sync.ckpt"), state, opt, loss=0.25,
                                      psnr=torch.tensor(31.5))
    writer = ckpt.AsyncCheckpointWriter()
    writer.submit(str(tmp_path / "async.ckpt"), state, opt, loss=torch.tensor(0.25), psnr=31.5)
    # the snapshot is taken at submit: a later change to the state is not in it
    with torch.no_grad():
        state.latent_codes.add_(1.0)
    writer.submit(str(tmp_path / "async2.ckpt"), state, opt)  # drains the first
    writer.finish()
    with torch.no_grad():
        state.latent_codes.sub_(1.0)
    raw_sync = torch.load(sync, weights_only=True)
    raw_async = torch.load(str(tmp_path / "async.ckpt"), weights_only=True)
    assert raw_sync["loss"] == raw_async["loss"] == 0.25
    assert raw_sync["psnr"] == raw_async["psnr"] == 31.5
    assert isinstance(raw_async["optimizer_state_dict"]["param_groups"][0]["lr"], float)
    a, b = ckpt.load_torch_checkpoint(sync), ckpt.load_torch_checkpoint(str(tmp_path / "async.ckpt"))
    _states_equal(a, b)
    later = ckpt.load_torch_checkpoint(str(tmp_path / "async2.ckpt"))
    assert torch.equal(later["latent_codes"], a["latent_codes"] + 1.0)


def test_a_failed_write_is_raised_at_finish(trained, tmp_path, monkeypatch):
    def broken(payload, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write_atomic", broken)
    writer = ckpt.AsyncCheckpointWriter()
    writer.submit(str(tmp_path / "checkpoint00001.ckpt"), trained["state"], trained["optimizer"])
    with pytest.raises(OSError, match="disk full"):
        writer.finish()
    writer = ckpt.AsyncCheckpointWriter()
    writer.submit(str(tmp_path / "checkpoint00001.ckpt"), trained["state"], trained["optimizer"])
    with pytest.raises(OSError, match="disk full"):  # or at the next submit
        writer.submit(str(tmp_path / "checkpoint00002.ckpt"), trained["state"], trained["optimizer"])
    writer.finish()


@pytest.mark.parametrize("k", [1, 3])
def test_resumed_run_equals_the_uninterrupted_run(trained, dataset_dir, tmp_path, k):
    """6 steps, or 3 steps resumed from the step-4 checkpoint to 6 (the
    feed's stream continues at batch 4), equal bit for bit; at K = 1 and K
    = 3 (eager on the CPU, cut to the cadences)."""
    cfg = CfgNode(_cfg(dataset_dir, tmp_path, train_iters=6, save_every=3, print_every=3,
                       validate_every=0, steps_per_execute=k))
    train(cfg, load_checkpoint=os.path.join(trained["dir"], "checkpoint00004.ckpt"),
          dataset=load_flame_data(dataset_dir), device="cpu")
    resumed = ckpt.load_torch_checkpoint(str(tmp_path / "slice" / "checkpoint00006.ckpt"))
    whole = ckpt.load_torch_checkpoint(os.path.join(trained["dir"], "checkpoint00006.ckpt"))
    assert resumed["iter"] == whole["iter"] == 6
    _states_equal(resumed, whole)


def test_sigterm_exits_143_through_the_finally(dataset_dir, tmp_path):
    """The train CLI turns SIGTERM into exit 143 with the loop's and the
    profiler's `finally` run: the trace is written and the newest
    checkpoint is complete."""
    d = _cfg(dataset_dir, tmp_path / "runs", train_iters=100000, save_every=2, print_every=1000,
             validate_every=0)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(d))
    logdir = tmp_path / "runs" / "slice"
    proc = subprocess.Popen(
        [sys.executable, "-m", "nerface_tpu_torch.cli.train", "--config", str(path), "--device",
         "cpu", "--profile", str(tmp_path / "prof")],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.time()
        while ckpt.latest_checkpoint(str(logdir)) is None:
            assert proc.poll() is None, proc.stderr.read()
            assert time.time() - t0 < 240, "no checkpoint"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 143, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert not [n for n in os.listdir(logdir) if n.endswith(".tmp")]
    last = ckpt.load_torch_checkpoint(ckpt.latest_checkpoint(str(logdir)))
    assert last["iter"] >= 1 and last["optimizer"] is not None


def test_scalar_writer_writes_the_config_without_tensorboardx(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # its import raises ImportError
    cfg = CfgNode({"experiment": {"id": "x", "train_iters": 3}})
    w = ScalarWriter(str(tmp_path / "log"), cfg=cfg)
    assert not w.active
    w.scalar("train/psnr", 1.0, 0)
    w.image("validation/rgb_coarse", torch.zeros(4, 4, 3).numpy(), 0)
    w.close()
    assert yaml.safe_load((tmp_path / "log" / "config.yml").read_text()) == cfg.to_dict()
    assert os.listdir(tmp_path / "log") == ["config.yml"]


def test_validation_logs_nothing_to_an_inactive_writer(trained, dataset_dir, tmp_path,
                                                       monkeypatch):
    """Without tensorboardX, validation neither copies its panels to the
    host nor hands the writer anything, and its metrics are unchanged."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    w = ScalarWriter(str(tmp_path / "log"))
    calls = []
    monkeypatch.setattr(w, "scalar", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(w, "image", lambda *a, **k: calls.append(a))
    ds = load_flame_data(dataset_dir)
    flags = FeatureFlags.from_cfg(trained["cfg"])
    logged = validate(trained["cfg"], ds, trained["state"], flags, 6, writer=w)
    plain = validate(trained["cfg"], ds, trained["state"], flags, 6)
    assert calls == []
    assert {k: v for k, v in logged.items() if k != "time"} == \
        {k: v for k, v in plain.items() if k != "time"}


def test_the_loop_logs_the_jax_packages_panels(trained):
    """config.yml and, through tensorboardX, the train scalars, host RSS
    and the validation scalars and images."""
    pytest.importorskip("tensorboardX")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    assert yaml.safe_load(open(os.path.join(trained["dir"], "config.yml"))) == \
        trained["cfg"].to_dict()
    acc = EventAccumulator(trained["dir"])
    acc.Reload()
    tags = acc.Tags()
    want = {"train/coarse_loss", "train/fine_loss", "train/psnr", "train/rays_per_sec",
            "train/rays_per_sec_inst", "host/rss_gb", "train/code_loss", "validation/loss",
            "validation/coarse_loss", "validation/fine_loss", "validation/psnr"}
    assert want <= set(tags["scalars"]), tags["scalars"]
    assert [e.step for e in acc.Scalars("train/psnr")] == [0, 2, 4, 5]
    assert [e.step for e in acc.Scalars("validation/psnr")] == [0, 2, 4]
    assert {"validation/rgb_coarse", "validation/rgb_fine", "validation/img_target"} <= \
        set(tags["images"]), tags["images"]
    assert all(e.value > 0 for e in acc.Scalars("host/rss_gb"))


def test_cli_flags(dataset_dir, tmp_path, capsys):
    """--debug-nans runs one step a window and says so; --matmul-precision
    sets torch's; --export-torch is accepted and changes nothing."""
    d = _cfg(dataset_dir, tmp_path / "runs", train_iters=2, save_every=2, print_every=2,
             steps_per_execute=2)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(d))
    prev = torch.get_float32_matmul_precision()
    handler = signal.getsignal(signal.SIGTERM)
    try:
        cli_train.main(["--config", str(path), "--device", "cpu", "--debug-nans",
                        "--matmul-precision", "highest", "--export-torch"])
        assert torch.is_anomaly_enabled()
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.autograd.set_detect_anomaly(False)
        torch.set_float32_matmul_precision(prev)
        signal.signal(signal.SIGTERM, handler)
    out = capsys.readouterr().out
    assert "anomaly detection on (--debug-nans): one step a window instead of 2" in out
    assert ckpt.latest_checkpoint(str(tmp_path / "runs" / "slice")).endswith("checkpoint00002.ckpt")
    assert copy.deepcopy(cli_train.build_parser().parse_args(
        ["--config", "c.yml", "--matmul-precision", "default"]).matmul_precision) == "default"
