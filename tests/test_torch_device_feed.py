"""PyTorch port, the device ray feed (`nerface_tpu_torch/data/device_feed.py`)
held against the JAX package's `DeviceRayFeed` on the CPU.

* Frame t's log-importance row, built on the fly from its bbox's two
  values, equals the JAX feed's dense `log_maps[t]` bit for bit, for
  bboxes inside, across and outside the frame, empty and full ones.
* With the frame index and the Gumbel keys injected into both (the JAX
  draws by monkeypatching `jax.random.randint` / `jax.random.gumbel`, as
  `DeviceRayFeed._draw` calls them), the batches agree: the same pixels in
  the same order, targets, origins, expression, indices and background
  exact, directions to 1e-6 (a (R, 3) @ (3, 3) product summed in another
  order).
* The port's own draws: the `RayFeed` schema, no pixel twice, the bbox's
  share of the draws (`tests/test_device_feed.py:25-70`), and determinism
  in (seed, step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.data.device_feed import DeviceRayFeed as JaxDeviceRayFeed
from nerface_tpu_torch.data.device_feed import DeviceRayFeed
from nerface_tpu_torch.data.pipeline import RayFeed
from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
from nerface_tpu_torch.ops.sampling import step_seed

H, W = 20, 24


@pytest.fixture(scope="module")
def ds():
    d = synthetic_flame_dataset(H=H, W=W, n_train=6, n_val=1, n_test=1, with_images=True,
                                num_samples=4)
    # bboxes of every kind numpy slices: inside, past the edges, a negative
    # start (numpy counts it from the end), empty, the whole frame
    d.bboxes[:6] = np.array([[6, 14, 7, 17], [0, H, 0, W], [15, 40, 20, 30], [-5, H, 3, 9],
                             [4, 4, 2, 9], [6, 14, 7, 17]], np.int32)
    return d


def test_log_row_equals_jax_log_maps(ds):
    jfeed = JaxDeviceRayFeed(ds, num_rays=16)
    feed = DeviceRayFeed(ds, num_rays=16, device="cpu")
    maps = np.asarray(jfeed.log_maps)
    assert feed.log_in.shape == (6,)  # two values a frame, no dense map
    for t in range(6):
        row = feed.log_row(torch.tensor([t])).numpy()
        assert row.dtype == np.float32
        np.testing.assert_array_equal(row, maps[t], err_msg=f"frame {t}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_injected_draws_equal_jax_draw(ds, seed, monkeypatch):
    rng = np.random.RandomState(seed)
    t = int(rng.randint(0, 6))
    g = rng.gumbel(size=H * W).astype(np.float32)
    bg = ds.load_background()
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(t, jnp.int32))
    monkeypatch.setattr(jax.random, "gumbel", lambda *a, **k: jnp.asarray(g))
    want = JaxDeviceRayFeed(ds, num_rays=50, background=bg)._draw(None, None)
    got = DeviceRayFeed(ds, num_rays=50, background=bg, device="cpu").draw(
        0, frame=t, gumbel=torch.from_numpy(g))
    assert set(got) == set(want)
    for k in want:
        w, v = np.asarray(want[k]), got[k].numpy()
        assert v.shape == w.shape and v.dtype == w.dtype, k
        if k == "ray_directions":
            np.testing.assert_allclose(v, w, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v, w, err_msg=k)


def test_batch_schema_matches_ray_feed(ds):
    bg = ds.load_background()
    host = RayFeed(ds, num_rays=32, background=bg, seed=0).sample_batch()
    dev = DeviceRayFeed(ds, num_rays=32, background=bg, device="cpu").draw(step_seed(0, 3))
    assert set(dev) == set(host)
    for k in host:
        assert tuple(dev[k].shape) == np.asarray(host[k]).shape, k
        assert dev[k].dtype == torch.from_numpy(np.asarray(host[k])).dtype, k


def test_rays_and_targets_of_the_drawn_frame(ds):
    feed = DeviceRayFeed(ds, num_rays=16, device="cpu")
    b = feed.draw(step_seed(5, 11))
    i = int(b["frame_index"])
    sel = b["pixel_indices"].long().numpy()
    pose = ds.poses[i]
    np.testing.assert_allclose(b["ray_directions"].numpy(),
                               feed.dirs_cam.numpy()[sel] @ pose[:3, :3].T, rtol=1e-5)
    np.testing.assert_array_equal(b["ray_origins"].numpy(),
                                  np.broadcast_to(pose[:3, 3], (16, 3)))
    img = ds.images[i].reshape(-1, 3)
    np.testing.assert_allclose(b["target_rgb"].numpy(), img[sel], atol=1 / 255.0 + 1e-6)


def test_without_replacement_and_importance(ds):
    feed = DeviceRayFeed(ds, num_rays=64, device="cpu")
    in_frac = []
    for step in range(12):
        b = feed.draw(step_seed(0, step))
        sel = b["pixel_indices"].numpy()
        assert len(set(sel.tolist())) == 64
        t = int(b["frame_index"])
        (h0, h1, w0, w1) = feed.bounds[t].tolist()
        if h1 - h0 in (0, H):  # the empty and the whole-frame bbox weigh every pixel alike
            continue
        rows, cols = sel // W, sel % W
        in_frac.append(np.mean((rows >= h0) & (rows < h1) & (cols >= w0) & (cols < w1)))
    assert in_frac and np.mean(in_frac) > 0.4  # the map biases the draws into the bbox


def test_deterministic_in_seed_and_step(ds):
    feed = DeviceRayFeed(ds, num_rays=32, device="cpu")
    a = feed.draw(step_seed(7, 3))
    b = feed.draw(step_seed(7, torch.tensor(3)))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    c = feed.draw(step_seed(7, 4))
    assert not torch.equal(a["pixel_indices"], c["pixel_indices"])
    frames = {int(feed.draw(step_seed(7, s))["frame_index"]) for s in range(40)}
    assert frames == set(range(6))  # every frame comes up
