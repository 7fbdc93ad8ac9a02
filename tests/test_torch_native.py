"""PyTorch port, the native host sampler (`nerface_tpu_torch/native`) and
the native path of `RayFeed`, held against the JAX package's on the CPU.

Everything is compared bit for bit: the two libraries are built from
byte-identical sources with the same g++ flags, so on one machine they
compute the same bits, and the port's native `RayFeed` draws JAX's native
batches. The loader's build is held to one complete library when several
processes build into an empty directory at once.
"""

import inspect
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import nerface_tpu.native
from nerface_tpu.data.pipeline import RayFeed as JaxRayFeed
from nerface_tpu_torch import native
from nerface_tpu_torch.data.pipeline import RayFeed
from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
from test_torch_train import jax_native

ROOT = Path(__file__).resolve().parents[1]


def test_source_is_a_byte_identical_copy():
    assert native.SRC.read_bytes() == Path(nerface_tpu.native._SRC).read_bytes()


def test_flags_are_the_jax_packages():
    src = inspect.getsource(nerface_tpu.native._compile)
    words = src[src.index('"g++"'):src.index('"-o"')].replace('"', " ").replace(",", " ").split()
    assert list(native.CXX_FLAGS) == words[1:]


@pytest.mark.parametrize("H,W,bbox,p", [(32, 32, (8, 24, 4, 20), 0.9), (24, 40, (0, 24, 0, 40), 0.5),
                                        (48, 16, (30, 31, 2, 15), 0.99)])
def test_importance_map_matches_jax(H, W, bbox, p):
    jn = jax_native()
    got = native.importance_map(H, W, bbox, p=p)
    assert np.array_equal(got, jn.importance_map(H, W, bbox, p=p))
    assert got.dtype == np.float64 and got.shape == (H * W,)


@pytest.mark.parametrize("k", [1, 64, 2048])
def test_gumbel_topk_matches_jax(k):
    jn = jax_native()
    probs = native.importance_map(64, 64, (10, 50, 20, 44), p=0.9)
    probs[:100] = 0.0  # pixels of no mass are never drawn
    for seed in (0, 7, 2**63 - 2):
        got = native.gumbel_topk(probs, k, seed)
        assert np.array_equal(got, jn.gumbel_topk(probs, k, seed))
        assert len(set(got.tolist())) == k and (got >= 100).all()


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("with_bg", [False, True])
def test_assemble_batch_matches_jax(channels, with_bg):
    jn = jax_native()
    rng = np.random.RandomState(channels + 2 * with_bg)
    n, k = 600, 77
    dirs = rng.randn(n, 3).astype(np.float32)
    image = rng.rand(n, channels).astype(np.float32)
    bgf = rng.rand(n, 3).astype(np.float32) if with_bg else None
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    pose[:3, 3] = [0.1, -0.2, 0.5]
    sel = rng.choice(n, size=k, replace=False).astype(np.int64)
    got = native.assemble_batch(sel, dirs, image, pose, bgf)
    want = jn.assemble_batch(sel, dirs, image, pose, bgf)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("with_bg", [False, True])
def test_ray_feed_matches_jax_native_feed(with_bg):
    """The port's native `RayFeed` (its default) equals the JAX package's
    native `RayFeed` bit for bit, over batches from several indices."""
    jax_native()
    ds = synthetic_flame_dataset(H=32, W=28, n_train=5, n_val=1, n_test=1, with_images=True)
    bg = ds.load_background() if with_bg else None
    for start in (0, 5, 1000):
        jfeed = JaxRayFeed(ds, num_rays=128, background=bg, seed=11, start_batch=start)
        assert jfeed._native is not None
        feed = RayFeed(ds, num_rays=128, background=bg, seed=11, start_batch=start)
        for _ in range(3):
            a, b = jfeed.sample_batch(), feed.sample_batch()
            assert set(a) == set(b) and ("background_rgb" in b) == with_bg
            for key in a:
                assert np.asarray(b[key]).dtype == np.asarray(a[key]).dtype, key
                np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]), err_msg=key)


def test_native_and_numpy_paths_draw_other_batches():
    ds = synthetic_flame_dataset(H=32, W=28, n_train=5, n_val=1, n_test=1, with_images=True)
    a = RayFeed(ds, num_rays=128, seed=11).sample_batch()
    b = RayFeed(ds, num_rays=128, seed=11, native=False).sample_batch()
    assert a["frame_index"] == b["frame_index"]  # the frame is drawn first, the same way
    assert not np.array_equal(a["pixel_indices"], b["pixel_indices"])


def test_concurrent_builds_load_one_library(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    working library, the same file, and no temporary file is left."""
    build = tmp_path / "build"
    code = textwrap.dedent(
        """
        import sys
        from pathlib import Path
        import numpy as np
        from nerface_tpu_torch import native
        native.BUILD_DIR = Path(sys.argv[1])
        probs = native.importance_map(16, 16, (4, 12, 4, 12))
        print(native.build_library(), native.gumbel_topk(probs, 8, 3).tolist())
        """
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1
    libs = sorted(p.name for p in build.iterdir() if p.suffix == ".so")
    assert len(libs) == 1 and lines.pop().startswith(str(build / libs[0]))
    assert not [p for p in build.iterdir() if p.name.endswith(".tmp")]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A build that fails raises, and a native `RayFeed` raises with it: it
    never falls back to the numpy draws, which are other batches."""
    bad = tmp_path / "ray_sampler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library(tmp_path / "build")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build2")
    ds = synthetic_flame_dataset(H=16, W=16, n_train=2, n_val=1, n_test=1, with_images=True)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        RayFeed(ds, num_rays=16)
    RayFeed(ds, num_rays=16, native=False).sample_batch()  # the numpy path needs no library
