"""PyTorch port, the eval / reenactment slice: `nerface_tpu_torch.eval.driver`
(`evaluate` → render_full_frame → render_rays) and `cli/eval.py` against
the JAX package's, both in f32 on the CPU, on one `.ckpt` written by the
JAX package (`create_train_state` with a random latent table +
`export_torch_checkpoint`, no training) over a 16×16 synthetic dataset
from the JAX package's generator, at the tiny paper config of
`tests/test_eval_driver.py` with validation `perturb: False` and σ-noise
0, so no random draws enter the frames.

Every PNG the two drivers write (rgb, normals, disparity, error) is held
within 1 level of JAX's, and ≥ 99 % of its values equal: f32 on both
sides, only the order of f32 sums differs, so a level moves only where a
value sits on a rounding boundary. Measured: a mean |difference| of 0 on
every file of every case, but one file of the occupancy case (0.0015
levels). The kept difference at acc = 0 (the
port's K2 gives a disparity of 1e10 where JAX's gives NaN, ROADMAP Queue
3) does not show here: these runs take the plain f32 path, where both
compute depth/acc."""

import dataclasses
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerface_tpu.cli import eval as jax_cli_eval
from nerface_tpu.cli import metrics as jax_cli_metrics
from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.config.flags import EvalFlags as JaxEvalFlags
from nerface_tpu.config.flags import FeatureFlags as JaxFeatureFlags
from nerface_tpu.data.synthetic import make_synthetic_flame_dataset
from nerface_tpu.eval import driver as J
from nerface_tpu.train.checkpoint import export_torch_checkpoint
from nerface_tpu.train.loop import build_models_from_cfg
from nerface_tpu.train.state import create_train_state
from nerface_tpu_torch.cli import eval as cli_eval
from nerface_tpu_torch.cli import metrics as cli_metrics
from nerface_tpu_torch.config import CfgNode
from nerface_tpu_torch.config.flags import EvalFlags
from nerface_tpu_torch.eval import driver as T
from nerface_tpu_torch.serve import AvatarServer

torch.set_num_threads(1)

H = W = 16
N_TEST = 3


def _cfg_dict(basedir, **validation):
    model = {
        "type": "ConditionalBlendshapePaperNeRFModel", "num_encoding_fn_xyz": 4,
        "num_encoding_fn_dir": 2, "include_input_xyz": True, "include_input_dir": False,
        "use_viewdirs": True, "num_layers": 4, "hidden_size": 32,
        "log_sampling_xyz": True, "log_sampling_dir": True,
    }
    val = {"chunksize": 128, "perturb": False, "num_coarse": 8, "num_fine": 8,
           "white_background": False, "radiance_field_noise_std": 0.0, "lindisp": False,
           "occupancy_resolution": 16}
    val.update(validation)
    return {
        "experiment": {"id": "t", "logdir": "/nonexistent", "randomseed": 42},
        "dataset": {"basedir": basedir, "type": "blender", "no_ndc": True,
                    "near": 0.2, "far": 0.8, "half_res": False, "testskip": 1},
        "models": {"coarse": dict(model), "fine": dict(model)},
        "optimizer": {"type": "Adam", "lr": 5e-4},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
        "nerf": {"use_viewdirs": True, "validation": val},
    }


@pytest.fixture(scope="module")
def avatar(tmp_path_factory):
    """(dataset dir, the same dataset without index_map.npy, .ckpt path,
    a second .ckpt whose σ varies over space): random JAX weights, a random
    latent table, exported in the reference schema. The random field's σ
    spreads by 0.002 only, so no voxel or every voxel clears the occupancy
    threshold; the second file scales the σ head by 200 and shifts it so
    that the threshold cuts the field (about a third of the grid occupied)."""
    tmp = tmp_path_factory.mktemp("torch_eval")
    ds_dir = make_synthetic_flame_dataset(
        str(tmp / "ds"), H=H, W=W, n_train=3, n_val=1, n_test=N_TEST, num_samples=8
    )
    no_map = str(tmp / "ds_no_index_map")
    shutil.copytree(ds_dir, no_map)
    os.remove(os.path.join(no_map, "index_map.npy"))
    jcfg = JaxCfgNode(_cfg_dict(ds_dir))
    mc, mf = build_models_from_cfg(jcfg)
    state, _ = create_train_state(
        jax.random.PRNGKey(3), mc, mf, jcfg, JaxFeatureFlags(), n_train=3,
        background=jnp.zeros((H, W, 3)),
    )
    rng = np.random.RandomState(0)
    state.params["latent_codes"] = jnp.asarray(rng.randn(3, 32).astype(np.float32) * 0.3)
    ckpt = str(tmp / "avatar.ckpt")
    export_torch_checkpoint(ckpt, state)
    sd = torch.load(ckpt, weights_only=True)
    threshold = -np.log1p(-1e-2) / (0.6 / 8)  # default_sigma_threshold(0.2, 0.8, 8)
    for m in ("model_coarse_state_dict", "model_fine_state_dict"):
        sd[m]["fc_alpha.weight"] = sd[m]["fc_alpha.weight"] * 200.0
        sd[m]["fc_alpha.bias"] = torch.full_like(sd[m]["fc_alpha.bias"], threshold + 4.3)
    ckpt_field = str(tmp / "field.ckpt")
    torch.save(sd, ckpt_field)
    return ds_dir, no_map, ckpt, ckpt_field


def _pngs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(".png"))


def _assert_pngs_close(jax_dir, port_dir):
    """The same files; each within 1 level of JAX's, ≥ 99 % of its values
    equal. Returns {file: mean |difference|}."""
    names = _pngs(jax_dir)
    assert names and _pngs(port_dir) == names
    means = {}
    for name in names:
        a = np.asarray(Image.open(os.path.join(jax_dir, name)), np.int16)
        b = np.asarray(Image.open(os.path.join(port_dir, name)), np.int16)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        diff = np.abs(a - b)
        means[name] = float(diff.mean())
        assert diff.max() <= 1, f"{name}: max {diff.max()} levels, mean {diff.mean():.4f}"
        assert (diff == 0).mean() >= 0.99, f"{name}: {(diff != 0).mean():.4f} of values differ"
    return means


def _run_both(tmp_path, ds_dir, ckpt, flags=None, max_frames=None, log=False, **validation):
    jcfg = JaxCfgNode(_cfg_dict(ds_dir, **validation))
    tcfg = CfgNode(_cfg_dict(ds_dir, **validation))
    jflags = JaxEvalFlags(**flags) if flags is not None else None
    tflags = EvalFlags(**flags) if flags is not None else None
    kw = dict(save_disparity_image=True, save_error_image=True, max_frames=max_frames, log=log)
    jsum = J.evaluate(jcfg, ckpt, str(tmp_path / "jax"), jflags, **kw)
    tsum = T.evaluate(tcfg, ckpt, str(tmp_path / "port"), tflags, device="cpu", **kw)
    return jsum, tsum


# -- the driver's host pieces, bit for bit ------------------------------------


@pytest.mark.parametrize("which", ["jet_colormap", "error_image", "cast_to_disparity_image"])
def test_driver_casts_equal_jax(which):
    rng = np.random.RandomState(7)
    if which == "jet_colormap":
        # every control point, the ends, and values outside [0, 1]
        x = np.concatenate([rng.rand(4096), [0.0, 0.11, 0.365, 0.5, 0.635, 0.89, 1.0, -0.5, 1.5]])
        args = (x,)
    elif which == "error_image":
        gt = rng.rand(24, 20, 3)
        args = (gt, np.round(np.clip(gt + rng.randn(24, 20, 3) * 0.05, 0, 1) * 255) / 255.0)
    else:
        args = ((rng.rand(24, 20) * 3.0 + 0.5).astype(np.float32),)
    got, ref = getattr(T, which)(*args), getattr(J, which)(*args)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    if which == "error_image":  # an identical pair: no error, no division by 0
        np.testing.assert_array_equal(T.error_image(args[0], args[0]),
                                      J.error_image(args[0], args[0]))


# -- evaluate against JAX's ---------------------------------------------------

CASES = {
    "default": {},
    "frontalize": {"frontalize": True},
    "interpolate_mouth": {"interpolate_mouth": True},
    "ablate_expression": {"ablate": "expression"},
    "ablate_latent_code": {"ablate": "latent_code"},
    "ablate_view_dir": {"ablate": "view_dir"},
    "no_lcode": {"no_lcode": True},
    "no_background": {"no_background": True},
    "nerf": {"nerf": True},
    "per_frame_latent": {"fix_latent_code_index": False},
}


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_matches_jax(avatar, tmp_path, case):
    ds_dir, _, ckpt, _ = avatar
    flags = CASES[case]
    jsum, tsum = _run_both(tmp_path, ds_dir, ckpt, flags=flags if flags else None)
    assert tsum["frames"] == jsum["frames"] == N_TEST
    _assert_pngs_close(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("mode", ["fast_eval", "occupancy"])
def test_fast_evaluate_matches_jax(avatar, tmp_path, capsys, mode):
    """fast_eval (the bbox union) and occupancy (an 8³ grid of the field
    that varies, probe mask): the same set-up and the same frames as JAX's
    fast driver. The mouth sweep is on, so the grid's expression sample
    takes its extremes too. The splat mask's grid build (a 32³ prepass)
    takes tens of seconds in the port's plain CPU forward: its functions
    are held against JAX's in tests/test_torch_occupancy.py, and the card's
    `[eval]` runs it end to end."""
    ds_dir, _, ckpt, ckpt_field = avatar
    validation = {"fast_eval": True}
    if mode == "occupancy":
        validation.update(occupancy=True, occupancy_mask="probe", occupancy_resolution=8)
        ckpt = ckpt_field
    _run_both(tmp_path, ds_dir, ckpt, flags={"interpolate_mouth": True}, log=True, **validation)
    out = capsys.readouterr().out
    setup = [line for line in out.splitlines() if line.startswith("[fast-eval]")]
    assert len(setup) == (4 if mode == "occupancy" else 2) and setup[0] == setup[len(setup) // 2]
    if mode == "occupancy":
        assert setup[1] == setup[3]
        occupied = float(re.search(r"\(([0-9.]+) occupied\)", setup[3]).group(1))
        assert 0.1 < occupied < 0.9, setup[3]
    _assert_pngs_close(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("per_frame", [False, True], ids=["pinned", "per_frame"])
def test_identity_index_map_matches_jax(avatar, tmp_path, per_frame):
    """A dataset without index_map.npy: both fall back to the identity map,
    for the pinned row and the per-frame rows."""
    _, no_map, ckpt, _ = avatar
    _run_both(tmp_path, no_map, ckpt, flags={"fix_latent_code_index": not per_frame})
    _assert_pngs_close(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_summary_and_max_frames(avatar, tmp_path):
    ds_dir, _, ckpt, _ = avatar
    tsum = T.evaluate(CfgNode(_cfg_dict(ds_dir)), ckpt, str(tmp_path), max_frames=2,
                      save_disparity_image=True, log=False, device="cpu")
    assert set(tsum) == {"frames", "avg_time_per_image", "setup_s", "frame_loop_s"}
    assert tsum["frames"] == 2.0 and tsum["avg_time_per_image"] > 0
    assert tsum["setup_s"] > 0 and tsum["frame_loop_s"] >= 2 * tsum["avg_time_per_image"]
    assert _pngs(str(tmp_path)) == ["0000.png", "0001.png", "disparity/0000.png",
                                    "disparity/0001.png", "normals/0000.png",
                                    "normals/0001.png"]


def test_server_frame_equals_evaluate_frame(avatar, tmp_path):
    """The server and the driver share their set-up (`load_avatar`): the
    server's frame 0 at seed 0 is the driver's first PNG."""
    ds_dir, _, ckpt, _ = avatar
    cfg = CfgNode(_cfg_dict(ds_dir))
    T.evaluate(cfg, ckpt, str(tmp_path), log=False, device="cpu", max_frames=1)
    server = AvatarServer(cfg, checkpoint=ckpt, device="cpu", log=False)
    np.testing.assert_array_equal(server.render(frame=0)["rgb_fine"],
                                  np.asarray(Image.open(str(tmp_path / "0000.png"))))


def test_default_device_without_cuda_raises(avatar, tmp_path):
    """No fallback: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    ds_dir, _, ckpt, _ = avatar
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.evaluate(CfgNode(_cfg_dict(ds_dir)), ckpt, str(tmp_path), log=False)
    assert not os.path.exists(tmp_path / "0000.png")


# -- the saver ----------------------------------------------------------------


def test_saver_failure_fails_the_run(tmp_path):
    saver = T._AsyncSaver()
    saver.save(str(tmp_path / "ok.png"), np.zeros((4, 4, 3), np.uint8))
    saver.save(str(tmp_path / "missing" / "x.png"), torch.zeros(4, 4, 3, dtype=torch.uint8))
    with pytest.raises(FileNotFoundError):
        saver.shutdown()
    assert os.path.exists(tmp_path / "ok.png")


def test_saver_bounds_its_backlog(tmp_path, monkeypatch):
    """At most SAVER_BACKLOG writes wait: the next `save` joins the oldest."""
    import threading

    gate = threading.Event()
    real = T._save_png

    def slow(*a):
        gate.wait(10)
        real(*a)

    monkeypatch.setattr(T, "_save_png", slow)
    saver = T._AsyncSaver(workers=1)
    img = np.zeros((2, 2, 3), np.uint8)
    for i in range(T.SAVER_BACKLOG):
        saver.save(str(tmp_path / f"{i}.png"), img)
    assert len(saver._futures) == T.SAVER_BACKLOG
    gate.set()
    saver.save(str(tmp_path / "last.png"), img, fn=lambda a: a + 1)
    assert len(saver._futures) == T.SAVER_BACKLOG
    saver.shutdown()
    assert len(os.listdir(tmp_path)) == T.SAVER_BACKLOG + 1
    assert np.asarray(Image.open(tmp_path / "last.png")).max() == 1


# -- the CLIs -----------------------------------------------------------------


def test_cli_eval_parser_is_jax_parser_plus_device_and_bf16():
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.required,
                         tuple(a.choices) if a.choices else None, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    jax_opts = options(jax_cli_eval.build_parser())
    port_opts = options(cli_eval.build_parser())
    assert set(port_opts) - set(jax_opts) == {"device", "bf16"}
    for dest, (flags, default, required, choices, kind) in jax_opts.items():
        assert port_opts[dest] == (flags, default, required, choices, kind), dest
    assert port_opts["device"][1] == "cuda" and port_opts["bf16"][1] is False
    args = cli_eval.build_parser().parse_args(["--config", "c", "--checkpoint", "k"])
    assert args.device == "cuda" and not args.bf16
    jm, tm = options(jax_cli_metrics.build_parser()), options(cli_metrics.build_parser())
    assert set(tm) - set(jm) == {"device"} and all(tm[d] == jm[d] for d in jm)


def test_cli_refusals():
    with pytest.raises(SystemExit, match="this host has 0 CUDA device"):
        cli_eval.main(["--config", "c.yml", "--checkpoint", "k", "--num-devices", "2"])
    with pytest.raises(SystemExit, match="folders"):
        cli_metrics.main(["--gt_path", "a", "--images_path", "b", "--mode", "images"])


def test_cli_eval_then_metrics_write_jax_files(avatar, tmp_path, capsys):
    """`cli/eval.py` then `cli/metrics.py`, end to end on the CPU, write the
    files JAX's CLIs write, under the same names, and the same scores
    within the frames' 1-level difference."""
    import yaml

    ds_dir, _, ckpt, _ = avatar
    cfg_path = tmp_path / "c.yml"
    cfg_path.write_text(yaml.safe_dump(_cfg_dict(ds_dir)))
    common = ["--config", str(cfg_path), "--checkpoint", ckpt, "--save-disparity-image",
              "--save-error-image", "--fast-eval"]
    jax_cli_eval.main(common + ["--savedir", str(tmp_path / "jax")])
    cli_eval.main(common + ["--savedir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count(f"Rendered {N_TEST} frames; avg time per image:") == 2
    gt = os.path.join(ds_dir, "test")
    jax_cli_metrics.main(["--gt_path", gt, "--images_path", str(tmp_path / "jax")])
    summary = cli_metrics.main(["--gt_path", gt, "--images_path", str(tmp_path / "port"),
                                "--device", "cpu"])
    names = _pngs(str(tmp_path / "jax"))
    assert _pngs(str(tmp_path / "port")) == names
    assert sum(n.startswith("L2/") for n in names) == N_TEST
    for d in ("jax", "port"):
        assert os.path.isfile(tmp_path / d / "metrics.txt")
    assert np.isnan(summary["LPIPS"]) and np.isfinite(summary["PSNR"])
    jtext = (tmp_path / "jax" / "metrics.txt").read_text().splitlines()
    ttext = (tmp_path / "port" / "metrics.txt").read_text().splitlines()
    assert len(jtext) == len(ttext)
    # the same layout line for line; the numbers within the frames' difference
    for a, b in zip(jtext, ttext):
        a, b = a.replace(str(tmp_path / "jax"), "DIR"), b.replace(str(tmp_path / "port"), "DIR")
        ka, _, va = a.rpartition("\t")
        kb, _, vb = b.rpartition("\t")
        assert ka == kb
        if va != vb:
            assert abs(float(va) - float(vb)) <= 0.05 * max(abs(float(va)), 1e-3), (a, b)


def test_cli_flags_reach_evaluate(avatar, tmp_path, monkeypatch):
    """The CLI's ablation flags and the config's `eval` node merge as JAX's
    CLI merges them."""
    seen = {}

    def fake_evaluate(cfg, **kw):
        seen.update(kw, cfg=cfg)
        return {"frames": 0.0, "avg_time_per_image": 0.0}

    monkeypatch.setattr(T, "evaluate", fake_evaluate)
    import yaml

    ds_dir, _, ckpt, _ = avatar
    d = _cfg_dict(ds_dir)
    d["eval"] = {"frontalize": True}
    cfg_path = tmp_path / "c.yml"
    cfg_path.write_text(yaml.safe_dump(d))
    cli_eval.main(["--config", str(cfg_path), "--checkpoint", ckpt, "--nerf", "--occupancy",
                   "--per-frame-latent", "--bf16", "--device", "cpu", "--max-frames", "2"])
    flags = seen["eval_flags"]
    assert flags == EvalFlags(nerf=True, frontalize=True, fix_latent_code_index=False)
    assert flags.no_background and flags.no_expressions and flags.no_lcode
    assert seen["cfg"].nerf.validation.fast_eval and seen["cfg"].nerf.validation.occupancy
    assert seen["dtype"] is torch.bfloat16 and seen["device"] == "cpu"
    assert seen["max_frames"] == 2
    assert dataclasses.asdict(flags)["ablate"] is None
