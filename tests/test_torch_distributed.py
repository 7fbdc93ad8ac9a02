"""PyTorch port, data parallelism (`nerface_tpu_torch/train/distributed.py`,
the DP step of `train/window.py`, the device feed's positions and
`cli/train.py`'s `--num-devices` / coordinator flags), held against the
JAX package on the CPU over gloo.

Tolerances, with their reasons:

* The DP step at world 2 (two spawned ranks, f32, JAX's draws injected):
  every rank's parameters and Adam moments bit for bit the same (one
  all-reduce hands both the same bits); against the port's one-process
  step on the whole batch rtol 1e-5 / atol 1e-7, the tolerance of
  `tests/test_distributed.py` (the same sums split in two halves);
  against JAX's `make_train_step(mesh=Mesh(jax.devices()[:2]))` the
  single-step rules of `tests/test_torch_train.py`: Adam's first moment
  (0.1·g) atol 2e-4·max + 1e-10, the σ head's 5e-3·max, the second
  (0.001·g²) twice those, the parameters atol 10·lr with ≥ 99 % of
  elements within 1e-5 (one Adam step moves a parameter by ≈ lr·sign(g),
  which a gradient near 0 may flip between two summation orders).
* The CLI: `--num-devices 2 --device cpu` and two processes joined by
  `--coordinator-address` leave the same step-6 checkpoint, rtol 1e-5 /
  atol 1e-7 (`tests/test_distributed.py:234`), on the host feed and the
  device feed; on the host feed, also the one-process run's.

Every subprocess has its own timeout of at most 180 s, so a hung rank
fails its test instead of eating the suite's clock.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nerface_tpu.data.synthetic import make_synthetic_flame_dataset
from nerface_tpu.train import distributed as jax_distributed
from nerface_tpu.train.step import make_train_step
from nerface_tpu_torch.cli import train as cli_train
from nerface_tpu_torch.data.device_feed import DeviceRayFeed
from nerface_tpu_torch.data.pipeline import RayFeed
from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
from nerface_tpu_torch.ops.sampling import step_seed
from nerface_tpu_torch.train import checkpoint as ckpt
from nerface_tpu_torch.train import distributed, dryrun
from test_torch_train import FLAG_CASES, _batch, _jax_draws, _opt_cfg, _pair, _settings

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT = 180


def _as_rank(monkeypatch, r, world):
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    monkeypatch.setattr(distributed, "rank", lambda: r)


# -- helpers ------------------------------------------------------------------


def test_ray_keys_equal_jax():
    assert distributed.RAY_KEYS == jax_distributed.RAY_KEYS


def test_process_ray_slice(monkeypatch):
    assert distributed.process_ray_slice(64) == slice(0, 64)
    assert distributed.is_primary() and distributed.world_size() == 1
    _as_rank(monkeypatch, 1, 2)
    assert distributed.process_ray_slice(64) == slice(32, 64)
    assert not distributed.is_primary()
    _as_rank(monkeypatch, 2, 3)
    with pytest.raises(ValueError, match="64 rays not divisible by 3 processes"):
        distributed.process_ray_slice(64)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_local_batch(monkeypatch, kind):
    rng = np.random.RandomState(0)
    batch = {"ray_origins": rng.rand(8, 3).astype(np.float32),
             "target_rgb": rng.rand(8, 3).astype(np.float32),
             "pixel_indices": np.arange(8, dtype=np.int32) * 3,
             "expression": rng.rand(76).astype(np.float32), "latent_index": np.int32(2)}
    if kind == "torch":
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    assert distributed.local_batch(batch) is batch  # one rank: the batch as it is
    _as_rank(monkeypatch, 1, 2)
    out = distributed.local_batch(batch)
    for k in ("ray_origins", "target_rgb", "pixel_indices"):
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(batch[k])[4:8])
    assert out["expression"] is batch["expression"]
    assert out["latent_index"] is batch["latent_index"]
    np.testing.assert_array_equal(np.asarray(out["ray_index"]), np.arange(4, 8))
    # a batch with global indices keeps them, sliced
    batch["ray_index"] = batch["pixel_indices"]
    np.testing.assert_array_equal(np.asarray(distributed.local_batch(batch)["ray_index"]),
                                  np.arange(4, 8) * 3)


def test_parser_accepts_coordinator_flags():
    args = cli_train.build_parser().parse_args([
        "--config", "x.yml", "--coordinator-address", "localhost:1234",
        "--num-processes", "2", "--process-id", "1",
    ])
    assert args.coordinator_address == "localhost:1234"
    assert args.num_processes == 2 and args.process_id == 1


def test_coordinator_needs_process_args():
    with pytest.raises(SystemExit, match="num-processes"):
        cli_train.main(["--config", "x.yml", "--coordinator-address", "localhost:1"])


def test_num_devices_beyond_the_cards_is_refused():
    with pytest.raises(SystemExit, match="--num-devices 2: this host has 0 CUDA device"):
        cli_train.main(["--config", "x.yml", "--num-devices", "2"])


# -- the DP step ----------------------------------------------------------------


def _dp_case(case):
    flags_kw, bg_kind, with_bg, noise, white, perturb = FLAG_CASES[case]
    R = 32
    bg = np.random.RandomState(3).rand(8, 8, 3).astype(np.float32) if bg_kind else None
    jm, jstate, jopt, jflags, state, _, flags = _pair(flags_kw, bg)
    tset, jset = _settings(noise, white, perturb)
    jb, tb = _batch(R, seed=7, with_pixels=bg_kind is not None, with_bg=with_bg)
    key = jax.random.PRNGKey(1)
    payload = {"state": state, "opt_cfg": _opt_cfg(), "batch": tb,
               "draws": _jax_draws(key, R), "settings": tset, "flags": flags, "seed": 0}
    return payload, (jm, jstate, jopt, jflags, jset, jb, key)


def _jax_mesh_step(jm, jstate, jopt, jflags, jset, jb, key):
    """JAX's DP step over a 2-device mesh: new params and Adam moments."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    step = make_train_step(jm, jm, jset, jflags, jopt, mesh=mesh, donate=False)
    new, _ = step(jstate, jb, key)
    adam = ckpt._find_adam_state(jax.device_get(new.opt_state))
    return jax.device_get(new.params), adam


def _jax_leaf(tree, name):
    if name in ("latent_codes", "background"):
        return np.asarray(tree[name])
    which, pname = name.split(".", 1)
    return np.asarray(tree[which][pname])


@pytest.mark.parametrize("case", ["fixed_bg", "train_sup_bg"])
def test_dp_step_matches_jax_mesh_step_and_one_process(case, tmp_path):
    payload, jax_args = _dp_case(case)
    one = dryrun.dp_step(payload)  # the one-process step, whole batch
    ranks = dryrun.dryrun(payload, 2, init_method=f"file://{tmp_path}/rendezvous",
                          timeout=SUBPROCESS_TIMEOUT)

    a, b = ranks[0]["arrays"], ranks[1]["arrays"]
    assert set(a) == set(b) == set(one["arrays"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"ranks differ: {k}")
    np.testing.assert_array_equal(ranks[0]["metrics"], ranks[1]["metrics"])
    for k in a:
        np.testing.assert_allclose(a[k], one["arrays"][k], rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(ranks[0]["metrics"], one["metrics"], rtol=1e-5, atol=1e-7)

    params, adam = _jax_mesh_step(*jax_args)
    lr = 5e-4
    seen = 0
    for name in [k for k in a if "/" not in k]:
        want = _jax_leaf(params, name)
        got = a[name]
        np.testing.assert_allclose(got, want, atol=10 * lr, rtol=0, err_msg=name)
        assert np.mean(np.abs(got - want) <= 1e-5) >= 0.99, name
        rel = 5e-3 if "fc_alpha" in name else 2e-4
        for moment, tree, k in (("exp_avg", adam.mu, 1), ("exp_avg_sq", adam.nu, 2)):
            want_m = _jax_leaf(tree, name)
            got_m = a.get(f"{moment}/{name}")
            if got_m is None:  # never reached the loss (layers_dir.3)
                assert np.abs(want_m).max() == 0.0, name
                continue
            scale = float(np.abs(want_m).max())
            np.testing.assert_allclose(got_m, want_m, atol=k * rel * scale + 1e-10, rtol=0,
                                       err_msg=f"{moment}/{name}")
            seen += 1
    assert seen >= 60


# -- the feeds ------------------------------------------------------------------


@pytest.fixture(scope="module")
def ds():
    return synthetic_flame_dataset(H=20, W=24, n_train=6, n_val=1, n_test=1, with_images=True,
                                   num_samples=4)


def test_device_feed_positions(ds):
    bg = ds.load_background()
    feed = DeviceRayFeed(ds, num_rays=40, background=bg, device="cpu")
    seed = step_seed(5, 3)
    base = feed.draw(seed)
    p0, p1 = feed.draw(seed, position=0), feed.draw(seed, position=1)
    # position 0 is the one-device stream bit for bit, with its global indices
    assert set(p0) == set(base) | {"ray_index"}
    for k in base:
        assert torch.equal(p0[k], base[k]), k
    np.testing.assert_array_equal(p0["ray_index"].numpy(), np.arange(40))
    np.testing.assert_array_equal(p1["ray_index"].numpy(), np.arange(40, 80))
    # one frame a step, its own pixels a position
    for k in ("expression", "latent_index", "frame_index"):
        assert torch.equal(p0[k], p1[k]), k
    assert not torch.equal(p0["pixel_indices"], p1["pixel_indices"])
    assert len(set(p1["pixel_indices"].tolist())) == 40
    # the tensor seed's draw equals the int seed's at a position
    p1_int = feed.draw(int(seed), position=1)
    for k in p1:
        assert torch.equal(p1[k], p1_int[k]), k


@pytest.mark.parametrize("native", [True, False])
def test_host_feed_rank_keeps_its_slice(ds, native, monkeypatch):
    feed = RayFeed(ds, num_rays=64, background=ds.load_background(), seed=3, native=native)
    glob = feed.sample_batch()
    for r in range(2):
        _as_rank(monkeypatch, r, 2)
        got = distributed.local_batch(glob)
        for k, v in glob.items():
            want = v[32 * r:32 * (r + 1)] if k in distributed.RAY_KEYS else v
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        np.testing.assert_array_equal(got["ray_index"], np.arange(32 * r, 32 * (r + 1)))


# -- the CLI ----------------------------------------------------------------------

_CLI_CFG = """\
experiment:
  id: mpcli
  logdir: {logdir}
  randomseed: 42
  train_iters: 6
  validate_every: 0
  save_every: 6
  print_every: 3
dataset:
  type: blender
  basedir: {basedir}
  half_res: False
  testskip: 1
  no_ndc: True
  near: 0.2
  far: 0.8
models:
  coarse:
    type: ConditionalBlendshapePaperNeRFModel
    num_layers: 4
    hidden_size: 32
    skip_connect_every: 3
    include_input_xyz: True
    log_sampling_xyz: True
    num_encoding_fn_xyz: 4
    use_viewdirs: True
    include_input_dir: False
    num_encoding_fn_dir: 2
    log_sampling_dir: True
  fine:
    type: ConditionalBlendshapePaperNeRFModel
    num_layers: 4
    hidden_size: 32
    skip_connect_every: 3
    num_encoding_fn_xyz: 4
    include_input_xyz: True
    log_sampling_xyz: True
    use_viewdirs: True
    include_input_dir: False
    num_encoding_fn_dir: 2
    log_sampling_dir: True
optimizer:
  type: Adam
  lr: 5.0E-4
scheduler:
  lr_decay: 250
  lr_decay_factor: 0.1
nerf:
  use_viewdirs: True
  encode_position_fn: positional_encoding
  encode_direction_fn: positional_encoding
  train:
    num_random_rays: 64
    chunksize: 2048
    perturb: True
    num_coarse: 8
    num_fine: 8
    white_background: False
    radiance_field_noise_std: 0.1
    lindisp: False
  validation:
    chunksize: 4096
    perturb: True
    num_coarse: 8
    num_fine: 8
    white_background: False
    radiance_field_noise_std: 0.
    lindisp: False
"""


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    return make_synthetic_flame_dataset(
        str(tmp_path_factory.mktemp("dp_cli") / "data"), n_train=4, n_val=2, n_test=2, H=24,
        W=24,
    )


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "2"
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _train(cfg, *extra):
    return [sys.executable, "-m", "nerface_tpu_torch.cli.train", "--config", cfg,
            "--device", "cpu", *extra]


def _run(cmd):
    p = subprocess.run(cmd, env=_env(), cwd=REPO, timeout=SUBPROCESS_TIMEOUT,
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    return p.stdout


def _run_pair(cfg, extra):
    """Two ranks launched by hand with the coordinator flags; a port that
    was taken between its probe and rank 0's bind is tried once more."""
    for attempt in range(2):
        port = distributed.free_port()
        procs = [subprocess.Popen(
            _train(cfg, "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", "2",
                   "--process-id", str(pid), *extra),
            env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(2)]
        try:
            outs = [p.communicate(timeout=SUBPROCESS_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(p.returncode == 0 for p in procs):
            return outs
        if attempt == 0 and any("EADDRINUSE" in o or "address already in use" in o.lower()
                                for o in outs):
            continue
        raise AssertionError([o[-3000:] for o in outs])


def _ckpt_arrays(logdir):
    path = ckpt.latest_checkpoint(logdir)
    assert path and ckpt.checkpoint_step(path) == 6, path
    c = ckpt.load_torch_checkpoint(path)
    out = {f"coarse.{k}": v for k, v in c["coarse"].items()}
    out.update({f"fine.{k}": v for k, v in c["fine"].items()})
    out["latent_codes"] = c["latent_codes"]
    for i, st in c["optimizer"]["state"].items():
        out.update({f"{k}/{i}": st[k] for k in ("exp_avg", "exp_avg_sq")})
    return {k: v.float().numpy() for k, v in out.items()}


def _write_cfg(tmp_path, name, basedir):
    logdir = str(tmp_path / name)
    p = tmp_path / f"{name}.yml"
    p.write_text(_CLI_CFG.format(logdir=logdir, basedir=basedir))
    return str(p), os.path.join(logdir, "mpcli")


@pytest.mark.parametrize("feed", ["host", "device"])
def test_spawned_cli_matches_coordinator_launched(cli_data, tmp_path, feed):
    extra = ["--device-feed"] if feed == "device" else []
    cfg_spawn, log_spawn = _write_cfg(tmp_path, "spawned", cli_data)
    cfg_pair, log_pair = _write_cfg(tmp_path, "pair", cli_data)
    out = _run(_train(cfg_spawn, "--num-devices", "2", *extra))
    outs = _run_pair(cfg_pair, extra)
    # rank 0 alone prints and writes the run's files
    assert out.count("[TRAIN] Iter: 3 ") == 1, out
    assert sum(o.count("[TRAIN] Iter:") for o in outs) == 3, outs
    for logdir in (log_spawn, log_pair):
        configs = [f for _, _, files in os.walk(os.path.dirname(logdir)) for f in files
                   if f == "config.yml"]
        assert configs == ["config.yml"], logdir
    a, b = _ckpt_arrays(log_spawn), _ckpt_arrays(log_pair)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7, err_msg=k)
    if feed == "host":
        # the host feed's global batch split over the ranks: the one-process
        # run's checkpoint too (`tests/test_distributed.py`'s comparison)
        cfg_one, log_one = _write_cfg(tmp_path, "one", cli_data)
        _run(_train(cfg_one))
        c = _ckpt_arrays(log_one)
        for k in a:
            np.testing.assert_allclose(a[k], c[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_spawner_passes_sigterm_on(cli_data, tmp_path):
    """`cli/supervise.py`'s contract under `--num-devices`: SIGTERM to the
    spawning process reaches the ranks, and it exits with 143 once they
    are gone."""
    import signal
    import time

    cfg, _ = _write_cfg(tmp_path, "stopped", cli_data)
    text = pathlib.Path(cfg).read_text().replace("train_iters: 6", "train_iters: 100000")
    pathlib.Path(cfg).write_text(text.replace("print_every: 3", "print_every: 1"))
    p = subprocess.Popen(_train(cfg, "--num-devices", "2"), env=_env(), cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + SUBPROCESS_TIMEOUT
        for line in p.stdout:
            if "[TRAIN] Iter:" in line or time.monotonic() > deadline:
                break
        p.send_signal(signal.SIGTERM)
        p.stdout.close()
        assert p.wait(timeout=60) == 143
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
