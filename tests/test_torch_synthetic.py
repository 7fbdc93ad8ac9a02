"""PyTorch port, the on-disk synthetic dataset and its CLIs, on the CPU.

* `make_synthetic_flame_dataset` writes what the JAX package's writes at
  32², the default scene and the `compact` one: the same file names, the
  same JSON, the same decoded PNGs and index map.
* `cli/generate_synthetic.py` writes what the JAX package's CLI writes,
  and refuses `--splat` without `--mesh` as it does.
* The loader reads the frames with Pillow: the arrays the JAX package's
  loader reads with imageio.
* The two CLIs end to end: generate a dataset, then train
  `configs/synth512_devfeed.yml`'s settings on it (the device feed, a
  window of 5, async validation) at a small size on the CPU.
"""

import json
import os
import re

import numpy as np
import pytest
import yaml
from PIL import Image

from nerface_tpu.cli import generate_synthetic as jax_gen_cli
from nerface_tpu.data.synthetic import make_synthetic_flame_dataset as jax_make
from nerface_tpu_torch.cli import generate_synthetic as gen_cli
from nerface_tpu_torch.cli import train as cli_train
from nerface_tpu_torch.data.flame import load_flame_data
from nerface_tpu_torch.data.synthetic import make_synthetic_flame_dataset
from nerface_tpu_torch.train import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_dataset(a, b):
    assert _files(a) == _files(b)
    for rel in _files(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".json"):
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb), rel
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pa)), np.asarray(Image.open(pb)),
                                          err_msg=rel)
        else:
            np.testing.assert_array_equal(np.load(pa), np.load(pb), err_msg=rel)


@pytest.mark.parametrize("compact", [False, True], ids=["default", "compact"])
def test_generator_files_equal_jax(tmp_path, compact):
    kw = dict(n_train=3, n_val=1, n_test=1, H=32, W=32, seed=4, compact=compact)
    a = make_synthetic_flame_dataset(str(tmp_path / "port"), **kw)
    b = jax_make(str(tmp_path / "jax"), **kw)
    _assert_same_dataset(a, b)
    ds = load_flame_data(a)
    assert ds.images.shape == (5, 32, 32, 3)


@pytest.mark.parametrize("sampling", ["LATTICE", "RANDOM", "HELIX"])
def test_generate_synthetic_cli_equals_jax(tmp_path, capsys, sampling):
    argv = ["--n-train", "2", "--n-val", "1", "--n-test", "1", "--size", "16", "--seed", "3",
            "--sampling", sampling]
    gen_cli.main(["--target", str(tmp_path / "port")] + argv)
    jax_gen_cli.main(["--target", str(tmp_path / "jax")] + argv)
    _assert_same_dataset(str(tmp_path / "port"), str(tmp_path / "jax"))
    # --splat needs --mesh, as in JAX's CLI (tests/test_torch_tools.py runs both modes)
    for cli in (gen_cli, jax_gen_cli):
        with pytest.raises(SystemExit, match="--splat requires --mesh"):
            cli.main(["--target", str(tmp_path / "m"), "--splat"])


def test_loader_reads_the_frames_without_imageio(tmp_path, monkeypatch):
    """The loader reads the PNG frames with Pillow alone (the card's host
    has no imageio): the arrays the JAX package's loader reads with
    imageio."""
    import sys

    from nerface_tpu.data.flame import load_flame_data as jax_load

    d = make_synthetic_flame_dataset(str(tmp_path / "ds"), n_train=2, n_val=1, n_test=1, H=16,
                                     W=16)
    want = jax_load(d)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    got = load_flame_data(d)
    assert got.images.dtype == want.images.dtype
    np.testing.assert_array_equal(got.images, want.images)


def test_clis_generate_and_train_the_devfeed_config(tmp_path, capsys):
    data = str(tmp_path / "synth")
    gen_cli.main(["--target", data, "--n-train", "4", "--n-val", "2", "--n-test", "1",
                  "--size", "16"])
    with open(os.path.join(ROOT, "configs", "synth512_devfeed.yml")) as f:
        d = yaml.safe_load(f)
    assert d["experiment"]["device_feed"] is True and d["experiment"]["steps_per_execute"] == "auto"
    # the config's settings at a small size
    d["dataset"]["basedir"] = data
    d["experiment"].update(logdir=str(tmp_path / "runs"), print_every=5, validate_every=5,
                           save_every=5)
    d["nerf"]["train"].update(num_random_rays=64, num_coarse=8, num_fine=8)
    d["nerf"]["validation"].update(chunksize=128, num_coarse=8, num_fine=8)
    for node in d["models"].values():
        node.update(num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
    path = tmp_path / "devfeed.yml"
    path.write_text(yaml.safe_dump(d))
    capsys.readouterr()
    cli_train.main(["--config", str(path), "--device", "cpu", "--max-iters", "11",
                    "--device-feed", "--steps-per-execute", "5"])
    out = capsys.readouterr().out
    assert "[train] execution window: 5 steps" in out
    assert re.findall(r"\[TRAIN\] Iter: (\d+) Loss", out) == ["0", "5", "10"]
    assert sorted(re.findall(r"\[VAL\] Iter: (\d+)", out)) == ["0", "10", "5"]
    saved = ckpt.load_torch_checkpoint(
        str(tmp_path / "runs" / "synth512_devfeed" / "checkpoint00011.ckpt"))
    assert saved["iter"] == 11 and len(saved["optimizer"]["param_groups"]) == 2
