"""PyTorch port, ray ops: rays, encoding, compositing and sampling of
`nerface_tpu_torch.ops` against `nerface_tpu.ops` on the same numpy inputs
(and, for the random draws, JAX's own `per_ray_uniform` draws injected into
the port). f32 on both sides; atol 1e-5 — the two differ only in the order
of f32 sums (XLA's vs torch's reductions and cumsum), a few ulps of
quantities of size ~1."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.ops import compositing as jcomp
from nerface_tpu.ops import encoding as jenc
from nerface_tpu.ops import rays as jrays
from nerface_tpu.ops import sampling as jsamp
from nerface_tpu_torch.ops import compositing as tcomp
from nerface_tpu_torch.ops import encoding as tenc
from nerface_tpu_torch.ops import math as tmath
from nerface_tpu_torch.ops import rays as trays
from nerface_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(1)

ATOL = 1e-5
PORT = pathlib.Path(__file__).resolve().parents[1] / "nerface_tpu_torch"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("n", [2, 16, 64, 128])
def test_linspace01_matches_jnp_bitwise(n):
    np.testing.assert_array_equal(
        tmath.linspace01(n).numpy(), np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32))
    )


def test_get_ray_bundle():
    rng = np.random.RandomState(0)
    pose = np.eye(4, dtype=np.float32)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    pose[:3, :3] = q.astype(np.float32)
    pose[:3, 3] = rng.randn(3).astype(np.float32) * 0.3
    intr = np.array([17.0, 19.0, 0.45, 0.55], np.float32)
    ro_j, rd_j = jrays.get_ray_bundle(6, 9, intr, pose)
    ro_t, rd_t = trays.get_ray_bundle(6, 9, intr, _t(pose))
    assert ro_t.shape == rd_t.shape == (6, 9, 3)
    _close(ro_t, ro_j)
    _close(rd_t, rd_j)


@pytest.mark.parametrize(
    "n_fns,include_input,log_sampling",
    [(10, True, True), (4, False, True), (6, True, False), (0, True, True)],
)
def test_positional_encoding(n_fns, include_input, log_sampling):
    x = np.random.RandomState(1).uniform(-0.6, 0.6, (50, 3)).astype(np.float32)
    ref = jenc.positional_encoding(jnp.asarray(x), n_fns, include_input, log_sampling)
    got = tenc.positional_encoding(_t(x), n_fns, include_input, log_sampling)
    assert got.shape == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("with_bg,white", [(True, False), (False, False), (False, True)])
def test_volume_render(with_bg, white):
    rng = np.random.RandomState(2)
    R, S = 12, 16
    rad = rng.randn(R, S, 4).astype(np.float32) * 3.0
    z = np.cumsum(rng.rand(R, S).astype(np.float32) * 0.05, -1) + 0.2
    rd = rng.randn(R, 3).astype(np.float32)
    bg = rng.rand(R, 3).astype(np.float32) if with_bg else None
    rad_j = jcomp.inject_background(jnp.asarray(rad), None if bg is None else jnp.asarray(bg))
    rad_t = tcomp.inject_background(_t(rad), None if bg is None else _t(bg))
    _close(rad_t, rad_j)
    ref = jcomp.volume_render_radiance_field(
        rad_j, jnp.asarray(z), jnp.asarray(rd), white_background=white,
        background_prior=None if bg is None else jnp.asarray(bg), return_depth=True,
    )
    got = tcomp.volume_render_radiance_field(
        rad_t, _t(z), _t(rd), white_background=white,
        background_prior=None if bg is None else _t(bg), return_depth=True,
    )
    for g, r in zip(got, ref):
        _close(g, r)


def test_volume_render_noise_is_injected():
    rng = np.random.RandomState(3)
    rad = _t(rng.randn(4, 8, 4).astype(np.float32))
    z = _t(np.cumsum(rng.rand(4, 8).astype(np.float32), -1))
    rd = _t(rng.randn(4, 3).astype(np.float32))
    with pytest.raises(ValueError):
        tcomp.volume_render_radiance_field(rad, z, rd, radiance_field_noise_std=0.1)
    noise = _t(rng.randn(4, 8).astype(np.float32))
    shifted = rad.clone()
    shifted[..., 3] += 0.1 * noise
    a = tcomp.volume_render_radiance_field(rad, z, rd, radiance_field_noise_std=0.1, noise=noise)
    b = tcomp.volume_render_radiance_field(shifted, z, rd)
    for x, y in zip(a[:4], b[:4]):
        torch.testing.assert_close(x, y)


def _near_far(R):
    return np.full((R, 1), 0.2, np.float32), np.full((R, 1), 0.8, np.float32)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_zvals_det(lindisp):
    near, far = _near_far(5)
    ref = jsamp.stratified_zvals(None, jnp.asarray(near), jnp.asarray(far), 32,
                                 lindisp=lindisp, perturb=False)
    got = tsamp.stratified_zvals(_t(near), _t(far), 32, lindisp=lindisp, perturb=False)
    _close(got, ref)


def test_stratified_zvals_with_jax_draws():
    R, S = 9, 64
    near, far = _near_far(R)
    key = jax.random.PRNGKey(7)
    idx = jnp.arange(100, 100 + R, dtype=jnp.int32)
    ref = jsamp.stratified_zvals(key, jnp.asarray(near), jnp.asarray(far), S, ray_index=idx)
    t_rand = jsamp.per_ray_uniform(key, idx, S)
    got = tsamp.stratified_zvals(_t(near), _t(far), S, t_rand=_t(t_rand))
    _close(got, ref)


def _pdf_inputs(R=7, B=63):
    rng = np.random.RandomState(4)
    z = np.sort(rng.uniform(0.2, 0.8, (R, B + 1)).astype(np.float32), -1)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    w = rng.rand(R, B - 1).astype(np.float32) ** 4
    return z, bins, w


def test_sample_pdf_det():
    _, bins, w = _pdf_inputs()
    ref = jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 64, det=True)
    got = tsamp.sample_pdf(_t(bins), _t(w), 64, det=True)
    _close(got, ref)


def test_sample_pdf_with_jax_draws():
    _, bins, w = _pdf_inputs()
    key = jax.random.PRNGKey(11)
    idx = jnp.arange(bins.shape[0], dtype=jnp.int32)
    ref = jsamp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 64, ray_index=idx)
    u = jsamp.per_ray_uniform(key, idx, 64)
    got = tsamp.sample_pdf(_t(bins), _t(w), 64, u=_t(u))
    _close(got, ref)


def test_merge_sorted_zvals():
    z, bins, w = _pdf_inputs()
    s = np.random.RandomState(5).uniform(0.2, 0.8, (z.shape[0], 64)).astype(np.float32)
    ref = jsamp.merge_sorted_zvals(jnp.asarray(z), jnp.asarray(s))
    got = tsamp.merge_sorted_zvals(_t(z), _t(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


class TestOwnDraws:
    """The port's counter-hash draws: uniform on [0, 1), keyed by (seed,
    stream, global ray index, sample), the same for any tiling."""

    def test_tiling_invariant(self):
        idx = torch.arange(1000, 1300)
        full = tsamp.per_ray_uniform(5, tsamp.STREAM_PDF, idx, 64)
        parts = torch.cat(
            [tsamp.per_ray_uniform(5, tsamp.STREAM_PDF, idx[a:b], 64)
             for a, b in ((0, 7), (7, 128), (128, 300))]
        )
        torch.testing.assert_close(full, parts, rtol=0, atol=0)

    def test_streams_seeds_and_range(self):
        idx = torch.arange(4096)
        a = tsamp.per_ray_uniform(0, tsamp.STREAM_STRATIFIED, idx, 64)
        b = tsamp.per_ray_uniform(0, tsamp.STREAM_PDF, idx, 64)
        c = tsamp.per_ray_uniform(1, tsamp.STREAM_STRATIFIED, idx, 64)
        assert a.dtype == torch.float32 and a.min() >= 0 and a.max() < 1
        # 262144 draws: mean 0.5 ± 5.6e-4 (1 sigma), variance 1/12
        assert abs(float(a.mean()) - 0.5) < 3e-3
        assert abs(float(a.var()) - 1 / 12) < 2e-3
        assert not torch.equal(a, b) and not torch.equal(a, c)
        # rows and columns are not shifted copies of one another
        assert float((a[1:] == a[:-1]).float().mean()) < 1e-3
        assert float((a[:, 1:] == a[:, :-1]).float().mean()) < 1e-3

    def test_stratified_uses_ray_index(self):
        near, far = _near_far(10)
        idx = torch.arange(40, 50)
        whole = tsamp.stratified_zvals(_t(near), _t(far), 16, seed=3, ray_index=idx)
        tail = tsamp.stratified_zvals(_t(near[5:]), _t(far[5:]), 16, seed=3, ray_index=idx[5:])
        torch.testing.assert_close(whole[5:], tail, rtol=0, atol=0)


def _imports_jax(path: pathlib.Path) -> bool:
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            if any(a.name == "jax" or a.name.startswith("jax.") for a in node.names):
                return True
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module == "jax" or node.module.startswith("jax."):
                return True
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
            if any(n == "nerface_tpu" or n.startswith("nerface_tpu.") for n in names):
                return True
    return False


def test_port_never_imports_jax():
    """The port's sources import neither jax nor the JAX package (checked on
    the source: this interpreter may have jax loaded already)."""
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(p) for p in files if _imports_jax(p)]
    assert offenders == []


def test_ast_check_catches_jax_imports(tmp_path):
    for src in ("import jax", "import jax.numpy as jnp", "from jax import numpy",
                "from jax.experimental import pallas", "import nerface_tpu.ops",
                "from nerface_tpu.ops import rays"):
        p = tmp_path / "m.py"
        p.write_text(src + "\n")
        assert _imports_jax(p), src
    p = tmp_path / "ok.py"
    p.write_text("import jaxlib_free\nimport nerface_tpu_torch.ops\n")
    assert not _imports_jax(p)
