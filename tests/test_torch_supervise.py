"""PyTorch port, supervised training (`nerface_tpu_torch/cli/supervise.py`):
every case of the JAX package's tests/test_supervise.py against the port —
checkpoint-arg ownership, crash recovery, RSS-limit recycling, the stall
timeout, the outage probe, max restarts, an interrupted supervisor — then
end to end on the CPU with the port's train CLI as the child: a tiny run
completes, and a run whose child is stopped by SIGTERM resumes from the
newest complete `.ckpt` and ends bit for bit where an uninterrupted run
ends.
"""

import os
import signal
import subprocess as sp
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch
import yaml

from chip_smoke import _children
from nerface_tpu_torch.cli.supervise import (
    CUDA_PROBE,
    backend_ready,
    build_parser,
    child_argv,
    newest_mtime,
    rss_gb,
    strip_load_checkpoint,
    supervise,
)
from nerface_tpu_torch.data.synthetic import make_synthetic_flame_dataset
from nerface_tpu_torch.train import checkpoint as ckpt
from test_torch_train import _train_cfg

ROOT = Path(__file__).resolve().parents[1]


class TestArgSurgery:
    def test_strip_space_form(self):
        rest, c = strip_load_checkpoint(["--config", "c.yml", "--load-checkpoint", "/x", "--bf16"])
        assert rest == ["--config", "c.yml", "--bf16"] and c == "/x"

    def test_strip_eq_form(self):
        rest, c = strip_load_checkpoint(["--load-checkpoint=/y", "--bf16"])
        assert rest == ["--bf16"] and c == "/y"

    def test_strip_absent(self):
        rest, c = strip_load_checkpoint(["--config", "c.yml"])
        assert rest == ["--config", "c.yml"] and c == ""

    def test_strip_dangling_value_fails_fast(self):
        with pytest.raises(SystemExit):
            strip_load_checkpoint(["--config", "c.yml", "--load-checkpoint"])

    def test_child_argv_prefers_logdir_latest(self, tmp_path):
        for name in ("checkpoint95001.ckpt", "checkpoint100001.ckpt"):
            (tmp_path / name).write_bytes(b"x")
        (tmp_path / "checkpoint200001.ckpt.tmp").write_bytes(b"partial")
        argv = child_argv("m", ["--config", "c.yml"], str(tmp_path), "/user.ckpt")
        assert argv[-2:] == ["--load-checkpoint", str(tmp_path / "checkpoint100001.ckpt")]

    def test_child_argv_falls_back_to_user_ckpt(self, tmp_path):
        (tmp_path / "checkpoint00004.ckpt.tmp").write_bytes(b"partial")
        argv = child_argv("m", ["--config", "c.yml"], str(tmp_path), "/user.ckpt")
        assert argv[-2:] == ["--load-checkpoint", "/user.ckpt"]

    def test_child_argv_no_ckpt(self, tmp_path):
        argv = child_argv("m", ["--config", "c.yml"], str(tmp_path), "")
        assert "--load-checkpoint" not in argv
        assert argv[:3] == [sys.executable, "-m", "m"]

    def test_default_child_is_the_ports_train_cli(self):
        assert build_parser().parse_args(["--"]).child_module == "nerface_tpu_torch.cli.train"

    def test_rss_of_self(self):
        v = rss_gb(os.getpid())
        assert v is not None and 0 < v < 200

    def test_rss_of_dead_pid(self):
        assert rss_gb(2**22 - 1) is None


def _write_cfg(tmp_path):
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(textwrap.dedent(
        f"""
        experiment:
          id: sup
          logdir: {tmp_path}/logs
          randomseed: 42
          train_iters: 8
          print_every: 4
          validate_every: 0
          save_every: 4
        """
    ))
    return str(cfg)


def _fake_child(tmp_path, monkeypatch, body, name="fake_child", state_dir=None):
    """A runnable fake-train module on the child's PYTHONPATH. The body sees
    argv, a `logdir` var, and a `runs` counter (kept in `state_dir`, by
    default the supervised logdir)."""
    state = str(state_dir or tmp_path / "logs" / "sup")
    (tmp_path / f"{name}.py").write_text(textwrap.dedent(
        f"""
        import os, sys, time
        logdir = {str(tmp_path / 'logs' / 'sup')!r}
        state = {state!r}
        os.makedirs(state, exist_ok=True)
        runs_f = os.path.join(state, "runs.txt")
        with open(runs_f, "a") as f:
            f.write(" ".join(sys.argv[1:]) + chr(10))
        runs = sum(1 for _ in open(runs_f))
        """
    ) + textwrap.dedent(body))
    monkeypatch.setenv("PYTHONPATH", str(tmp_path) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return name


def _args(extra):
    return build_parser().parse_args(extra)


def _runs(path):
    return path.read_text().splitlines()


class TestSupervise:
    def test_crash_recovery_resumes_from_latest(self, tmp_path, monkeypatch):
        cfg = _write_cfg(tmp_path)
        mod = _fake_child(tmp_path, monkeypatch, """
            if runs == 1:
                # trained a while, checkpointed, died mid-save of the next, crashed
                open(os.path.join(logdir, "checkpoint00004.ckpt"), "wb").write(b"x")
                open(os.path.join(logdir, "checkpoint00008.ckpt.tmp"), "wb").write(b"x")
                sys.exit(1)
            i = sys.argv.index("--load-checkpoint")
            assert sys.argv[i + 1].endswith("checkpoint00004.ckpt"), sys.argv
            sys.exit(0)
            """)
        rc = supervise(_args(["--poll-seconds", "0.2", "--max-restarts", "3",
                              "--child-module", mod, "--", "--config", cfg]))
        assert rc == 0
        assert len(_runs(tmp_path / "logs" / "sup" / "runs.txt")) == 2

    def test_rss_limit_recycles_child(self, tmp_path, monkeypatch):
        cfg = _write_cfg(tmp_path)
        mod = _fake_child(tmp_path, monkeypatch, """
            if runs == 1:
                ballast = bytearray(400 * 1024 * 1024)  # ~0.4 GiB resident
                time.sleep(120)  # the supervisor must recycle us well before this
            sys.exit(0)
            """)
        rc = supervise(_args(["--rss-limit-gb", "0.2", "--poll-seconds", "0.5",
                              "--grace-seconds", "5", "--max-restarts", "3",
                              "--child-module", mod, "--", "--config", cfg]))
        assert rc == 0
        assert len(_runs(tmp_path / "logs" / "sup" / "runs.txt")) == 2

    def test_stall_timeout_recycles_hung_child(self, tmp_path, monkeypatch):
        cfg = _write_cfg(tmp_path)
        mod = _fake_child(tmp_path, monkeypatch, """
            if runs == 1:
                time.sleep(120)  # hang: no writes, no exit, no RSS growth
            sys.exit(0)
            """)
        rc = supervise(_args(["--stall-timeout-seconds", "10", "--poll-seconds", "0.5",
                              "--grace-seconds", "5", "--max-restarts", "3",
                              "--child-module", mod, "--", "--config", cfg]))
        assert rc == 0
        assert len(_runs(tmp_path / "logs" / "sup" / "runs.txt")) == 2

    def test_outage_recycles_do_not_burn_restart_budget(self, tmp_path, monkeypatch):
        state = tmp_path / "state"  # outside the supervised logdir
        mod = _fake_child(tmp_path, monkeypatch, """
            if runs <= 2:
                time.sleep(120)  # outage hang: silent, no logdir writes
            sys.exit(0)
            """, name="fake_outage", state_dir=state)
        cfg = _write_cfg(tmp_path)
        rc = supervise(_args(["--stall-timeout-seconds", "10", "--poll-seconds", "0.5",
                              "--grace-seconds", "5", "--max-restarts", "1",
                              "--outage-probe-seconds", "0.2", "--outage-probe-command", "true",
                              "--child-module", mod, "--", "--config", cfg]))
        assert rc == 0
        assert len(_runs(state / "runs.txt")) == 3  # 2 free outage recycles + the success

    def test_backend_probe(self):
        assert backend_ready(_args(["--outage-probe-command", "true", "--"])) is True
        assert backend_ready(_args(["--outage-probe-command", "false", "--"])) is False
        # a wedged driver HANGS the probe: the timeout must kill it
        assert backend_ready(_args(["--outage-probe-command", "sleep 30",
                                    "--outage-probe-timeout-seconds", "0.5", "--"])) is False

    def test_default_probe_is_a_cuda_tensor(self):
        assert "torch.zeros(1, device='cuda')" in CUDA_PROBE
        assert backend_ready(_args(["--"])) is torch.cuda.is_available()

    def test_crash_loop_during_outage_gates_on_probe(self, tmp_path, monkeypatch):
        state = tmp_path / "state"
        mod = _fake_child(tmp_path, monkeypatch, """
            if runs <= 2:
                sys.exit(1)  # device-init crash: instant, no writes
            sys.exit(0)
            """, name="fake_initcrash", state_dir=state)
        cfg = _write_cfg(tmp_path)
        probe_n = tmp_path / "probe_n"
        probe = (f"n=$(cat {probe_n} 2>/dev/null || echo 0); n=$((n+1)); "
                 f"echo $n > {probe_n}; [ $n -ge 3 ]")
        rc = supervise(_args(["--poll-seconds", "0.1", "--max-restarts", "1",
                              "--outage-probe-seconds", "0.2", "--outage-probe-command", probe,
                              "--child-module", mod, "--", "--config", cfg]))
        # run 1 crashes during the outage (free), run 2 with the device up
        # (burns the single restart), run 3 completes
        assert rc == 0
        assert len(_runs(state / "runs.txt")) == 3

    def test_newest_mtime(self, tmp_path):
        assert newest_mtime(str(tmp_path / "missing")) == 0.0
        sub = tmp_path / "a" / "b"
        sub.mkdir(parents=True)
        (sub / "f.txt").write_text("x")
        assert newest_mtime(str(tmp_path)) > 0.0

    def test_max_restarts_gives_up(self, tmp_path, monkeypatch):
        cfg = _write_cfg(tmp_path)
        mod = _fake_child(tmp_path, monkeypatch, "sys.exit(3)\n")
        rc = supervise(_args(["--poll-seconds", "0.1", "--max-restarts", "2",
                              "--child-module", mod, "--", "--config", cfg]))
        assert rc == 1
        assert len(_runs(tmp_path / "logs" / "sup" / "runs.txt")) == 3  # initial + 2 restarts

    @pytest.mark.parametrize("signame", ["SIGINT", "SIGTERM"])
    def test_interrupt_stops_child(self, tmp_path, monkeypatch, signame):
        """A killed supervisor must not orphan the child (it would keep the
        card's memory): ctrl-C and a service manager's SIGTERM both."""
        cfg = _write_cfg(tmp_path)
        mod = _fake_child(tmp_path, monkeypatch, """
            open(os.path.join(logdir, "child.pid"), "w").write(str(os.getpid()))
            time.sleep(120)
            """)
        sup = sp.Popen([sys.executable, "-m", "nerface_tpu_torch.cli.supervise",
                        "--poll-seconds", "0.2", "--grace-seconds", "5",
                        "--child-module", mod, "--", "--config", cfg], cwd=ROOT,
                       env=os.environ.copy())
        pid_f = tmp_path / "logs" / "sup" / "child.pid"
        for _ in range(150):
            if pid_f.exists() and pid_f.read_text():
                break
            time.sleep(0.2)
        child_pid = int(pid_f.read_text())
        sup.send_signal(getattr(signal, signame))
        sup.wait(timeout=30)
        for _ in range(50):
            try:
                os.kill(child_pid, 0)
            except ProcessLookupError:
                return  # the child is gone
            time.sleep(0.2)
        os.kill(child_pid, signal.SIGKILL)
        raise AssertionError("child survived supervisor interrupt")


# -- end to end: the port's train CLI as the child, on the CPU ----------------


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    return make_synthetic_flame_dataset(str(tmp_path_factory.mktemp("synth_sup") / "ds"),
                                        n_train=4, n_val=2, n_test=1, H=16, W=16)


def _e2e_cfg(synth_dir, tmp_path, name, **experiment):
    d = _train_cfg(synth_dir, str(tmp_path / "logs"))
    d["experiment"].update(id=name, validate_every=0, **experiment)
    path = tmp_path / f"{name}.yml"
    path.write_text(yaml.safe_dump(d))
    return str(path), tmp_path / "logs" / name


@pytest.fixture
def one_thread(monkeypatch):
    """The children's torch on one thread: the same summation order in every
    process, and a light load on the host."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_e2e_real_train_completes(synth_dir, tmp_path, one_thread):
    cfg, logdir = _e2e_cfg(synth_dir, tmp_path, "tiny", train_iters=6, save_every=3)
    rc = supervise(_args(["--poll-seconds", "1", "--max-restarts", "1", "--",
                          "--config", cfg, "--device", "cpu"]))
    assert rc == 0
    assert ckpt.latest_checkpoint(str(logdir)).endswith("checkpoint00006.ckpt")


def test_e2e_sigterm_resumes_bit_for_bit(synth_dir, tmp_path, one_thread):
    """The supervisor over the port's train CLI; once a checkpoint is
    complete its child gets SIGTERM and exits 143, and the supervisor
    relaunches it from the newest complete `.ckpt`: the last checkpoint's
    parameters and Adam state equal an uninterrupted run's bit for bit."""
    steps = dict(train_iters=40, save_every=4, print_every=4)
    cfg, logdir = _e2e_cfg(synth_dir, tmp_path, "whole", **steps)
    sp.run([sys.executable, "-m", "nerface_tpu_torch.cli.train", "--config", cfg, "--device",
            "cpu"], cwd=ROOT, check=True, stdout=sp.DEVNULL)
    cfg2, logdir2 = _e2e_cfg(synth_dir, tmp_path, "supervised", **steps)
    out = tmp_path / "supervise.log"
    with open(out, "w") as f:
        sup = sp.Popen([sys.executable, "-m", "nerface_tpu_torch.cli.supervise",
                        "--poll-seconds", "0.2", "--max-restarts", "2", "--outage-probe-seconds",
                        "0", "--", "--config", cfg2, "--device", "cpu"], cwd=ROOT,
                       stdout=f, stderr=sp.STDOUT)
        try:
            t0 = time.time()
            while ckpt.latest_checkpoint(str(logdir2)) is None:
                assert sup.poll() is None and time.time() - t0 < 240, out.read_text()
                time.sleep(0.05)
            children = _children(sup.pid)
            assert len(children) == 1
            os.kill(children[0], signal.SIGTERM)
            assert sup.wait(timeout=300) == 0, out.read_text()
        finally:
            if sup.poll() is None:
                sup.kill()
    text = out.read_text()
    assert "child exited 143" in text, text
    relaunch = [line for line in text.splitlines() if "launch (restart 1)" in line]
    assert len(relaunch) == 1 and "--load-checkpoint" in relaunch[0], text
    resumed_from = relaunch[0].split("--load-checkpoint")[1].strip()
    assert ckpt.checkpoint_step(resumed_from) >= 1 and os.path.isfile(resumed_from)
    a = ckpt.load_torch_checkpoint(str(logdir / "checkpoint00040.ckpt"))
    b = ckpt.load_torch_checkpoint(str(logdir2 / "checkpoint00040.ckpt"))
    for which in ("coarse", "fine"):
        for k in a[which]:
            assert torch.equal(a[which][k], b[which][k]), (which, k)
    assert torch.equal(a["latent_codes"], b["latent_codes"])
    assert a["optimizer"]["state"].keys() == b["optimizer"]["state"].keys()
    for key in a["optimizer"]["state"]:
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a["optimizer"]["state"][key][f], b["optimizer"]["state"][key][f])
