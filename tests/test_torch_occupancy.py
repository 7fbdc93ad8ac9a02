"""PyTorch port, occupancy-grid ray skipping (`nerface_tpu_torch/eval/
occupancy.py`): each function against its JAX counterpart
(`nerface_tpu/eval/occupancy.py`) on the same inputs, the cases of the JAX
package's `tests/test_occupancy.py`. The masks (probe, blocked, splat) must
agree bool for bool; the grid build on JAX-initialised weights carried by
`params_from_jax` agrees in σ to 1e-4·max and in the grid everywhere σ is
not within that tolerance of the threshold; a grid saved by JAX loads here."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.data.flame import load_flame_data as jax_load_flame_data
from nerface_tpu.data.synthetic import make_synthetic_flame_dataset
from nerface_tpu.eval import occupancy as J
from nerface_tpu.models import MODELS
from nerface_tpu.ops.rays import get_ray_bundle as jax_get_ray_bundle
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerface_tpu_torch.data.flame import load_flame_data
from nerface_tpu_torch.eval import occupancy as T
from nerface_tpu_torch.models.nerf_models import ConditionalBlendshapePaperNeRFModel
from nerface_tpu_torch.ops.rays import get_ray_bundle
from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings
from nerface_tpu_torch.train.checkpoint import params_from_jax

torch.set_num_threads(1)

H = W = 16
NEAR, FAR = 0.2, 0.8
INTR = np.array([20.0, 20.0, 0.5, 0.5], np.float32)


def _grids(g, lo, hi):
    """The same boolean grid for both packages."""
    g = np.asarray(g, bool)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    return (J.OccupancyGrid(jnp.asarray(g), jnp.asarray(lo), jnp.asarray(hi)),
            T.OccupancyGrid(torch.from_numpy(g.copy()), torch.from_numpy(lo.copy()),
                            torch.from_numpy(hi.copy())))


def _rays(pose, intr=INTR):
    ro, rd = get_ray_bundle(H, W, intr, torch.from_numpy(np.asarray(pose, np.float32)[:3, :4]))
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def _eq(a, b):
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _unit(occupied, res=8):
    g = np.zeros((res, res, res), bool)
    for v in occupied:
        g[v] = True
    return _grids(g, np.zeros(3), np.ones(3))


@pytest.mark.parametrize("case", ["hit_and_miss", "outside_aabb", "all_occupied"])
def test_probe_mask_matches_jax(case):
    if case == "hit_and_miss":
        j, t = _unit([(4, 4, 4)])
        ro, rd, near, far = [[0.5625, 0.5625, 0.0], [0.9, 0.9, 0.0]], [[0, 0, 1.0]] * 2, 0.0, 1.0
    elif case == "outside_aabb":
        j, t = _unit([(0, 0, 0)])
        ro, rd, near, far = [[5.0, 5.0, 5.0]], [[0, 0, 1.0]], 0.0, 1.0
    else:
        j, t = _unit([tuple(v) for v in np.ndindex(8, 8, 8)])
        ro, rd, near, far = [[0.5, 0.5, 0.1], [3.0, 3.0, 3.0]], [[0, 0, 1.0]] * 2, 0.0, 0.5
    ro, rd = np.asarray(ro, np.float32), np.asarray(rd, np.float32)
    ref = J.ray_occupancy_mask(j, jnp.asarray(ro), jnp.asarray(rd), near, far, 64)
    got = T.ray_occupancy_mask(t, torch.from_numpy(ro), torch.from_numpy(rd), near, far, 64)
    _eq(ref, got)


def test_probe_mask_on_a_frustum_matches_jax():
    """Random grids over the frustum box, every pixel's ray, the JAX
    tests' near/far. The probe depths follow jnp.linspace's formula to an
    ulp (XLA's CPU code contracts it differently for some counts)."""
    np.testing.assert_allclose(T._linspace(NEAR, FAR, 256).numpy(),
                               np.asarray(jnp.linspace(NEAR, FAR, 256, dtype=jnp.float32)),
                               rtol=2e-7, atol=0)
    lo, hi = J.ray_aabb(np.eye(4, dtype=np.float32)[None], INTR, H, W, NEAR, FAR)
    rng = np.random.RandomState(7)
    pose = np.eye(4, dtype=np.float32)
    ro, rd = _rays(pose)
    jro, jrd = jax_get_ray_bundle(H, W, jnp.asarray(INTR), jnp.asarray(pose[:3, :4]))
    for _ in range(3):
        j, t = _grids(rng.rand(8, 8, 8) < 0.04, lo, hi)
        ref = J.ray_occupancy_mask(j, jro.reshape(-1, 3), jrd.reshape(-1, 3), NEAR, FAR, 256)
        _eq(ref, T.ray_occupancy_mask(t, ro, rd, NEAR, FAR, 256))


def test_ray_aabb_matches_jax():
    rng = np.random.RandomState(1)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = rng.randn(3, 3) * 0.1
    for a, b in zip(J.ray_aabb(poses, INTR, H, W, NEAR, FAR),
                    T.ray_aabb(poses, INTR, H, W, NEAR, FAR)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
        assert b.dtype == np.float32


def test_dilate_and_sigma_threshold_match_jax():
    rng = np.random.RandomState(2)
    g = rng.rand(9, 9, 9) < 0.05
    for steps in (0, 1, 2):
        _eq(J._dilate(jnp.asarray(g), steps), T._dilate(torch.from_numpy(g), steps))
    assert T.default_sigma_threshold(NEAR, FAR, 6) == J.default_sigma_threshold(NEAR, FAR, 6)


def test_with_boxes_matches_jax():
    rng = np.random.RandomState(7)
    j, t = _grids(rng.rand(8, 8, 8) < 0.2, np.zeros(3), np.ones(3))
    jb, tb = j.with_boxes(round_to=16), t.with_boxes(round_to=16)
    for name in ("boxes_lo", "boxes_hi", "boxes_valid"):
        _eq(getattr(jb, name), getattr(tb, name))
    assert tb.boxes_lo.dtype == torch.float32


def _front(occupied, res=8):
    """res³ grid over a box in front of an identity-pose camera (the JAX
    tests' `_front_grid`)."""
    g = np.zeros((res, res, res), bool)
    for v in occupied:
        g[v] = True
    return _grids(g, [-0.3, -0.3, -0.9], [0.3, 0.3, -0.3])


def test_splat_mask_matches_jax():
    """Random front grids, the camera jittered as in the JAX tests, and a
    box behind the camera (the whole frame splatted)."""
    rng = np.random.RandomState(3)
    for trial in range(4):
        j, t = _front([tuple(v) for v in rng.randint(0, 8, size=(20, 3))])
        pose = np.eye(4, dtype=np.float32)[:3, :4]
        pose[:, 3] = rng.randn(3) * 0.05
        if trial == 3:
            pose[2, 3] = -0.5  # inside the box: corners behind the camera
        jb, tb = j.with_boxes(round_to=8), t.with_boxes(round_to=8)
        ref = J.ray_occupancy_mask_splat(jb, jnp.asarray(pose), INTR, H, W)
        got = T.ray_occupancy_mask_splat(tb, torch.from_numpy(pose), INTR, H, W)
        _eq(ref, got)
        assert got.shape == (H * W,) and got.dtype == torch.bool


def test_blocked_mask_and_conservative_block_match_jax():
    intr = np.array([40.0, 40.0, 0.5, 0.5], np.float32)
    pose = np.eye(4, dtype=np.float32)
    lo, hi = J.ray_aabb(pose[None], intr, H, W, NEAR, FAR)
    rng = np.random.RandomState(7)
    ro, rd = _rays(pose, intr)
    jro, jrd = jax_get_ray_bundle(H, W, jnp.asarray(intr), jnp.asarray(pose[:3, :4]))
    for _ in range(3):
        g = rng.rand(8, 8, 8) < 0.04
        j, t = _grids(np.asarray(J._dilate(jnp.asarray(g), 1)), lo, hi)
        b = J.conservative_block(j, intr, FAR, H, W, dilate=1)
        assert T.conservative_block(t, intr, FAR, H, W, dilate=1) == b
        for block in sorted({1, 2, 4, b}):
            ref = J.ray_occupancy_mask_blocked(j, jro.reshape(-1, 3), jrd.reshape(-1, 3), H, W,
                                               NEAR, FAR, 256, block)
            _eq(ref, T.ray_occupancy_mask_blocked(t, ro, rd, H, W, NEAR, FAR, 256, block))
    j, t = _unit([(4, 4, 4)])
    for f, h, w in ((2000.0, 512, 512), (4.0, 512, 512), (2000.0, 510, 512), (2000.0, 511, 512)):
        intr = np.array([f, f, 0.5, 0.5])
        assert (T.conservative_block(t, intr, 0.8, h, w)
                == J.conservative_block(j, intr, 0.8, h, w))


@pytest.mark.parametrize("block", [1, 4])
def test_active_fraction_matches_jax(block):
    lo, hi = J.ray_aabb(np.eye(4, dtype=np.float32)[None], INTR, H, W, NEAR, FAR)
    rng = np.random.RandomState(4)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[1, :3, 3] = [0.02, -0.01, 0.0]
    j, t = _grids(rng.rand(8, 8, 8) < 0.1, lo, hi)
    args = (poses, INTR, H, W, NEAR, FAR, 128)
    assert T.active_fraction(t, *args, block=block) == J.active_fraction(j, *args, block=block)
    jb, tb = _front([tuple(v) for v in rng.randint(0, 8, size=(20, 3))])
    jb, tb = jb.with_boxes(round_to=8), tb.with_boxes(round_to=8)
    assert T.active_fraction(tb, *args) == J.active_fraction(jb, *args)
    all_occ = _grids(np.ones((8, 8, 8)), lo, hi)[1]
    assert T.active_fraction(all_occ, *args) > 0.95
    assert T.active_fraction(_grids(np.zeros((8, 8, 8)), lo, hi)[1], *args) == 0.0


def test_grid_saved_by_jax_loads(tmp_path):
    rng = np.random.RandomState(5)
    j, _ = _grids(rng.rand(8, 8, 8) < 0.3, [-0.1, -0.2, -0.3], [0.4, 0.5, 0.6])
    path = str(tmp_path / "occ.npz")
    j.save(path)
    t = T.OccupancyGrid.load(path)
    _eq(j.grid, t.grid)
    _eq(j.aabb_lo, t.aabb_lo)
    _eq(j.aabb_hi, t.aabb_hi)
    assert t.occupancy_fraction() == j.occupancy_fraction()
    t.save(str(tmp_path / "back.npz"))
    back = J.OccupancyGrid.load(str(tmp_path / "back.npz"))
    _eq(back.grid, t.grid)


# -- the grid build --------------------------------------------------------

KW = dict(num_encoding_fn_xyz=4, num_encoding_fn_dir=2, include_input_dir=False)


@pytest.fixture(scope="module")
def paper_pair():
    jmodel = MODELS["ConditionalBlendshapePaperNeRFModel"](**KW)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tmodel = ConditionalBlendshapePaperNeRFModel(**KW)
    tmodel.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jparams.items()}),
                           strict=True)
    tmodel.eval().requires_grad_(False)
    rng = np.random.RandomState(0)
    exprs = [rng.randn(76).astype(np.float32) * 0.5 for _ in range(2)]
    latent = rng.randn(32).astype(np.float32) * 0.1
    return jmodel, jparams, tmodel, exprs, latent


def _jax_sigma(jmodel, jparams, lo, hi, res, exprs, latent, enc_x, enc_d):
    """σ max over the expressions at the voxel centres, as JAX's
    `build_occupancy_grid` evaluates it."""
    c = (jnp.arange(res, dtype=jnp.float32) + 0.5) / res
    g = jnp.stack(jnp.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 1, 3)
    pts = g * (jnp.asarray(hi) - jnp.asarray(lo)) + jnp.asarray(lo)
    d = enc_d(jnp.asarray([[0.0, 0.0, -1.0]]))
    dirs = jnp.broadcast_to(d, (pts.shape[0], d.shape[-1]))
    best = None
    for e in exprs:
        s = jmodel.apply(jparams, enc_x(pts), dirs, jnp.asarray(e), jnp.asarray(latent))[..., 3]
        best = s.reshape(-1) if best is None else jnp.maximum(best, s.reshape(-1))
    return np.asarray(best).reshape(res, res, res)


@pytest.mark.parametrize("supersample,dilate", [(1, 0), (1, 1), (2, 0)])
def test_build_occupancy_grid_matches_jax(paper_pair, supersample, dilate):
    jmodel, jparams, tmodel, exprs, latent = paper_pair
    lo, hi = np.array([-0.4, -0.3, -0.2], np.float32), np.array([0.3, 0.4, 0.5], np.float32)
    res = 6
    jx, jd = JaxEncodeSpec(4, True, True), JaxEncodeSpec(2, False, True)
    sigma = _jax_sigma(jmodel, jparams, lo, hi, res * supersample, exprs, latent, jx, jd)
    thr = float(np.median(sigma))  # a grid about half occupied
    ref = J.build_occupancy_grid(jmodel, jparams, jx, jd, lo, hi, resolution=res,
                                 expressions=exprs, latent_code=latent, sigma_threshold=thr,
                                 dilate=dilate, chunk=100, supersample=supersample)
    got = T.build_occupancy_grid(tmodel, EncodeSpec(4, True, True), EncodeSpec(2, False, True),
                                 lo, hi, resolution=res, expressions=exprs, latent_code=latent,
                                 sigma_threshold=thr, dilate=dilate, chunk=100,
                                 supersample=supersample)
    _eq(ref.aabb_lo, got.aabb_lo)
    # the port's σ at the same points, to 1e-4 of its largest value
    tol = 1e-4 * float(np.abs(sigma).max())
    per_expr = []
    for e in exprs:
        tsig = []
        T.build_occupancy_grid(
            _SigmaTap(tmodel, tsig), EncodeSpec(4, True, True), EncodeSpec(2, False, True), lo,
            hi, resolution=res * supersample, expressions=[e], latent_code=latent,
            sigma_threshold=thr, dilate=0, chunk=100)
        per_expr.append(torch.cat(tsig))
    tsigma = torch.stack(per_expr).amax(0)
    np.testing.assert_allclose(tsigma.reshape(sigma.shape).numpy(), sigma, atol=tol, rtol=0)
    # the grids agree wherever σ is clear of the threshold (a sub-voxel near
    # it may flip any output voxel it pools or dilates into)
    near = np.abs(sigma - thr) <= tol
    if supersample > 1:
        r = res
        near = near.reshape(r, 2, r, 2, r, 2).any(axis=(1, 3, 5))
    if dilate:
        near = np.asarray(J._dilate(jnp.asarray(near), dilate))
    g_ref, g_got = np.asarray(ref.grid), got.grid.numpy()
    assert 0 < g_ref.sum() < g_ref.size
    np.testing.assert_array_equal(g_got[~near], g_ref[~near])


class _SigmaTap(torch.nn.Module):
    """The model, recording each chunk's σ."""

    def __init__(self, model, out):
        super().__init__()
        self.model, self.out = model, out
        self.takes_expression, self.takes_latent = model.takes_expression, model.takes_latent

    def forward(self, *a, **k):
        y = self.model(*a, **k)
        self.out.append(y[..., 3].reshape(-1))
        return y


class _JaxBall:
    """The JAX tests' fake field: σ 100 inside a ball, 0 outside."""

    takes_expression = False
    takes_latent = False

    def __init__(self, center, radius):
        self.center, self.radius = jnp.asarray(center, jnp.float32), float(radius)

    def apply(self, params, pe_xyz, pe_dir, expr=None, latent=None, dtype=None):
        d = jnp.linalg.norm(pe_xyz[..., :3] - self.center, axis=-1, keepdims=True)
        sigma = jnp.where(d < self.radius, 100.0, 0.0)
        return jnp.concatenate([jnp.zeros(sigma.shape[:-1] + (3,)), sigma], axis=-1)


class _TorchBall(torch.nn.Module):
    takes_expression = False
    takes_latent = False

    def __init__(self, center, radius):
        super().__init__()
        self.center, self.radius = torch.tensor(center, dtype=torch.float32), float(radius)

    def forward(self, pe_xyz, pe_dir, expr=None, latent=None, dtype=None):
        d = torch.linalg.norm(pe_xyz[..., :3] - self.center, dim=-1, keepdim=True)
        sigma = torch.where(d < self.radius, 100.0, 0.0)
        return torch.cat([torch.zeros(sigma.shape[:-1] + (3,)), sigma], dim=-1)


def test_ball_field_grid_and_tighten_aabb_match_jax():
    """The JAX tests' ball: the same grid, and the same tightened box."""
    args = (np.zeros(3, np.float32), np.ones(3, np.float32))
    for res, dilate in ((16, 0), (16, 1)):
        ref = J.build_occupancy_grid(_JaxBall([0.5] * 3, 0.2), {}, JaxEncodeSpec(0, True, True),
                                     None, *args, resolution=res, sigma_threshold=1.0,
                                     dilate=dilate, chunk=1024)
        got = T.build_occupancy_grid(_TorchBall([0.5] * 3, 0.2), EncodeSpec(0, True, True), None,
                                     *args, resolution=res, sigma_threshold=1.0, dilate=dilate,
                                     chunk=1024)
        _eq(ref.grid, got.grid)
    ref = J.tighten_aabb(_JaxBall([0.4, 0.5, 0.6], 0.15), {}, JaxEncodeSpec(0, True, True), None,
                         *args, None, None, 1.0)
    got = T.tighten_aabb(_TorchBall([0.4, 0.5, 0.6], 0.15), EncodeSpec(0, True, True), None,
                         *args, None, None, 1.0)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, np.asarray(a))
    empty = T.tighten_aabb(_TorchBall([5.0] * 3, 0.1), EncodeSpec(0, True, True), None, *args,
                           None, None, 1.0)
    np.testing.assert_array_equal(empty[1], args[1])


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    return make_synthetic_flame_dataset(str(tmp_path_factory.mktemp("occ_ds")), H=H, W=W,
                                        n_train=2, n_val=1, n_test=3, num_samples=8)


@pytest.mark.parametrize("mask", ["splat", "probe"])
def test_fast_eval_setup_matches_jax(dataset_dir, mask):
    """bbox, capacity, probes and block of the shared setup, with a ball at
    the synthetic head's place as the field."""
    jds, tds = jax_load_flame_data(dataset_dir, test=True), load_flame_data(dataset_dir, test=True)
    i_test = np.asarray(tds.i_test)
    poses, exprs = np.asarray(tds.poses)[i_test], np.asarray(tds.expressions)[i_test]
    common = dict(num_coarse=8, num_fine=8, perturb=False, near=NEAR, far=FAR, fast_eval=True,
                  occupancy=True, occupancy_mask=mask, occupancy_resolution=8,
                  occupancy_dilate=0 if mask == "splat" else 1)
    js = JaxRenderSettings(encode_xyz=JaxEncodeSpec(0, True, True), encode_dir=None, **common)
    ts = RenderSettings(encode_xyz=EncodeSpec(0, True, True), encode_dir=None, **common)
    center = (poses[0, :3, 3] + 0.5 * (NEAR + FAR) * (-poses[0, :3, 2])).tolist()
    jbbox, jset, jocc = J.fast_eval_setup(jds, poses, exprs, js, _JaxBall(center, 0.1), {})
    tbbox, tset, tocc = T.fast_eval_setup(tds, poses, exprs, ts, _TorchBall(center, 0.1))
    np.testing.assert_array_equal(tbbox, jbbox)
    for name in ("fast_eval_capacity", "occupancy_probes", "occupancy_block"):
        assert getattr(tset, name) == getattr(jset, name), name
    _eq(jocc.grid, tocc.grid)
    assert 0 < tocc.occupancy_fraction() < 1
    assert (tocc.boxes_lo is not None) == (mask == "splat")
    # bbox only: the capacity is the bbox union's area ·1.05
    _, jset0, _ = J.fast_eval_setup(jds, poses, exprs, JaxRenderSettings(fast_eval=True), None, {})
    _, tset0, occ0 = T.fast_eval_setup(tds, poses, exprs, RenderSettings(fast_eval=True), None)
    assert occ0 is None and tset0.fast_eval_capacity == jset0.fast_eval_capacity


def test_settings_from_cfg_read_the_occupancy_keys():
    from nerface_tpu_torch.config import CfgNode

    from nerface_tpu.config import CfgNode as JaxCfgNode

    node = {"num_coarse": 8, "num_fine": 8, "perturb": False, "radiance_field_noise_std": 0.0,
            "white_background": False, "lindisp": False, "chunksize": 1024, "fast_eval": True,
            "occupancy": True, "occupancy_resolution": 32, "occupancy_probes": 96,
            "occupancy_mask": "probe"}
    d = {
        "dataset": {"near": 0.2, "far": 0.8, "no_ndc": True},
        "models": {"coarse": {"num_encoding_fn_xyz": 4, "include_input_xyz": True,
                              "log_sampling_xyz": True, "use_viewdirs": True,
                              "num_encoding_fn_dir": 2, "include_input_dir": False,
                              "log_sampling_dir": True}},
        "nerf": {"use_viewdirs": True, "validation": node},
    }
    cfg, jcfg = CfgNode(copy.deepcopy(d)), JaxCfgNode(copy.deepcopy(d))
    s = RenderSettings.from_cfg(cfg, mode="validation")
    j = JaxRenderSettings.from_cfg(jcfg, mode="validation")
    for f in ("fast_eval", "fast_eval_capacity", "occupancy", "occupancy_mask",
              "occupancy_resolution", "occupancy_probes", "occupancy_dilate", "occupancy_block",
              "occupancy_margin"):
        assert getattr(s, f) == getattr(j, f), f
    assert s.occupancy_dilate == 1  # the probe mode's default
    del cfg.nerf.validation["occupancy_mask"]
    assert RenderSettings.from_cfg(cfg, mode="validation").occupancy_dilate == 0
