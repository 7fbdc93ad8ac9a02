"""PyTorch port, the metrics: `nerface_tpu_torch.metrics` (PSNR, L1, SSIM,
LPIPS and the folder harness) against the JAX package's
`nerface_tpu.metrics` on seeded images. Both are host numpy in float64
(LPIPS torch on the CPU on both sides), so the scalars agree to a relative
1e-12, `metrics.txt` is the same text and the L2 heat maps the same bytes."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from nerface_tpu.metrics import harness as JH
from nerface_tpu.metrics import image as JI
from nerface_tpu.metrics import lpips as JL
from nerface_tpu_torch.metrics import harness as TH
from nerface_tpu_torch.metrics import image as TI
from nerface_tpu_torch.metrics import lpips as TL

torch.set_num_threads(1)

REL = 1e-12


def _pair(kind, seed=0):
    rng = np.random.RandomState(seed)
    shape = (37, 29) if kind == "grey" else (37, 29, 3)
    a = rng.rand(*shape)
    b = np.clip(a + rng.randn(*shape) * 0.07, 0.0, 1.0)
    if kind == "range2":
        a, b = a * 2.0 - 1.0, b * 2.0 - 1.0
    return a, b, (2.0 if kind == "range2" else 1.0)


@pytest.mark.parametrize("kind", ["rgb", "grey", "range2"])
@pytest.mark.parametrize("metric", ["psnr", "l1", "ssim"])
def test_image_metric_matches_jax(metric, kind):
    a, b, data_range = _pair(kind)
    kw = {} if metric == "l1" else {"data_range": data_range}
    got, ref = getattr(TI, metric)(a, b, **kw), getattr(JI, metric)(a, b, **kw)
    assert isinstance(got, float)
    assert abs(got - ref) <= REL * abs(ref), (got, ref)


def test_identical_images():
    a, _, _ = _pair("rgb")
    assert TI.psnr(a, a) == JI.psnr(a, a) == float("inf")
    assert TI.l1(a, a) == 0.0
    assert abs(TI.ssim(a, a) - 1.0) <= 1e-12


def test_ssim_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="shape mismatch"):
        TI.ssim(np.zeros((8, 8, 3)), np.zeros((8, 9, 3)))


def test_scalar_metric_is_a_running_mean():
    m, j = TH.ScalarMetric(), JH.ScalarMetric()
    assert m.peek() == j.peek() == 0.0
    for x in (3.0, 4.5, -1.25):
        m.update(x)
        j.update(x)
    assert m.peek() == j.peek() == (3.0 + 4.5 - 1.25) / 3 and repr(m) == repr(j)
    m.reset()
    assert m.num_observations == 0 and m.peek() == 0.0


@pytest.fixture()
def folders(tmp_path):
    """A ground-truth folder (RGBA PNGs named as a dataset's, f_0..f_10) and
    a generated one (RGB, 0000..0003): numeric sort, not lexicographic."""
    rng = np.random.RandomState(5)
    gt, gen = tmp_path / "gt", tmp_path / "gen"
    gt.mkdir()
    gen.mkdir()
    for i in (0, 1, 2, 10, 11):
        img = (rng.rand(64, 72, 4) * 255).astype(np.uint8)
        img[..., 3] = 255
        Image.fromarray(img).save(gt / f"f_{i}.png")
    for i in range(4):
        img = (rng.rand(64, 72, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(gen / f"{i:04d}.png")
    (gen / "notes.txt").write_text("not an image")
    return str(gt), str(gen)


@pytest.mark.parametrize("data_range", [1.0, 2.0])
def test_two_folders_matches_jax(folders, data_range):
    """The same `metrics.txt` text and the same L2 PNG bytes as JAX's
    harness on the same folders (JAX's first, its files kept apart)."""
    gt, gen = folders
    jsum = JH.two_folders(gt, gen, data_range=data_range, log=False)
    jtext = open(os.path.join(gen, "metrics.txt")).read()
    jl2 = {f: open(os.path.join(gen, "L2", f), "rb").read() for f in os.listdir(os.path.join(gen, "L2"))}
    os.remove(os.path.join(gen, "metrics.txt"))
    for f in jl2:
        os.remove(os.path.join(gen, "L2", f))
    tsum = TH.two_folders(gt, gen, data_range=data_range, log=False, device="cpu")
    assert open(os.path.join(gen, "metrics.txt")).read() == jtext
    assert sorted(os.listdir(os.path.join(gen, "L2"))) == ["0000.png", "0001.png", "0002.png",
                                                          "0003.png"]
    for f, data in jl2.items():
        assert open(os.path.join(gen, "L2", f), "rb").read() == data, f
    assert tsum.keys() == jsum.keys() and np.isnan(tsum["LPIPS"])
    for k in ("L1", "PSNR", "SSIM"):
        assert tsum[k] == jsum[k], k


def test_two_folders_refuses_more_generated_than_ground_truth(folders, tmp_path):
    gt, gen = folders
    with pytest.raises(ValueError, match="generated images"):
        TH.two_folders(gen, gt, log=False, device="cpu")


def _lpips_weights(path, seed=0):
    """A combined LPIPS-alex state dict of seeded random weights, in the
    layout of an lpips-package checkpoint (net.slice<k>.<layer>.*) and the
    heads `lin{i}.model.1.weight`."""
    gen = torch.Generator().manual_seed(seed)
    shapes = {0: (64, 3, 11, 11), 3: (192, 64, 5, 5), 6: (384, 192, 3, 3),
              8: (256, 384, 3, 3), 10: (256, 256, 3, 3)}
    sd = {}
    for i, (o, c, kh, kw) in shapes.items():
        fan = c * kh * kw
        sd[f"net.slice{i // 3 + 1}.{i}.weight"] = torch.randn(o, c, kh, kw, generator=gen) / fan**0.5
        sd[f"net.slice{i // 3 + 1}.{i}.bias"] = torch.randn(o, generator=gen) * 0.01
    for i, c in enumerate((64, 192, 384, 256, 256)):
        sd[f"lin{i}.model.1.weight"] = torch.rand(1, c, 1, 1, generator=gen) / c
    torch.save(sd, path)
    return path


def test_lpips_matches_jax(tmp_path):
    """The port's LPIPSAlex against the JAX package's (both torch) on one
    combined file of seeded weights: atol 1e-6."""
    path = _lpips_weights(str(tmp_path / "lpips.pth"))
    rng = np.random.RandomState(3)
    a = rng.rand(64, 72, 3)
    b = np.clip(a + rng.randn(64, 72, 3) * 0.1, 0, 1)
    got = TL.LPIPSAlex(path, device="cpu")(a, b)
    ref = JL.LPIPSAlex(path)(a, b)
    assert got > 0 and abs(got - ref) <= 1e-6, (got, ref)
    assert TL.LPIPSAlex(path, device="cpu")(a, a) == 0.0


def test_lpips_export_combined_loads(tmp_path):
    """`export_combined` of a torchvision-layout AlexNet and lpips heads
    gives the same scorer as JAX's `export_combined` file."""
    src = torch.load(_lpips_weights(str(tmp_path / "w.pth"), seed=1), weights_only=True)
    alex = {f"features.{k.split('.')[-2]}.{k.split('.')[-1]}": v for k, v in src.items()
            if k.startswith("net.")}
    alex["classifier.1.weight"] = torch.zeros(2, 2)
    heads = {f"lins.{i}.weight": src[f"lin{i}.model.1.weight"] for i in range(5)}
    torch.save(alex, tmp_path / "alex.pth")
    torch.save(heads, tmp_path / "heads.pth")
    TL.export_combined(str(tmp_path / "alex.pth"), str(tmp_path / "heads.pth"),
                       str(tmp_path / "port.pth"))
    JL.export_combined(str(tmp_path / "alex.pth"), str(tmp_path / "heads.pth"),
                       str(tmp_path / "jax.pth"))
    port, jax_sd = torch.load(tmp_path / "port.pth"), torch.load(tmp_path / "jax.pth")
    assert port.keys() == jax_sd.keys() and all(torch.equal(port[k], jax_sd[k]) for k in port)
    rng = np.random.RandomState(4)
    a, b = rng.rand(64, 64, 3), rng.rand(64, 64, 3)
    got = TL.LPIPSAlex(str(tmp_path / "port.pth"), device="cpu")(a, b)
    assert abs(got - TL.LPIPSAlex(str(tmp_path / "w.pth"), device="cpu")(a, b)) <= 1e-6


def test_lpips_gate_and_harness_with_weights(folders, tmp_path):
    """Without a file LPIPS is unavailable and nan; with one the harness
    scores it as JAX's does."""
    assert not TL.lpips_available(None) and not TL.lpips_available(str(tmp_path / "none.pth"))
    path = _lpips_weights(str(tmp_path / "lpips.pth"))
    assert TL.lpips_available(path)
    gt, gen = folders
    jsum = JH.two_folders(gt, gen, lpips_weights=path, save_l2_images=False, log=False)
    tsum = TH.two_folders(gt, gen, lpips_weights=path, save_l2_images=False, log=False,
                          device="cpu")
    assert np.isfinite(tsum["LPIPS"]) and abs(tsum["LPIPS"] - jsum["LPIPS"]) <= 1e-6
    assert not os.path.exists(os.path.join(gen, "L2"))
