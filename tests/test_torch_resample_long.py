"""PyTorch port: the resample K5 past 256 samples a ray, up to Sc + Sf =
`fused_resample.MAX_TOTAL` (1024, the port's one sample limit).

Past SHORT_TOTAL (256) a ray no longer fits a warp's registers, and
`csrc/fused_resample.cu` runs its long regime (`resample_long_kernel`): one warp a
ray, the ray's rows in shared memory, the cdf in the short kernel's order
of sums, the same search and interpolation, a bitonic sort of the draws in
shared memory in the general regime, and the union as a merge by rank.

* (a) The plain version against the JAX package's `fused_resample` in
  interpret mode at (Sc, Sf) = (64, 256), (128, 896), (3, 1021), (1000,
  24) and (512, 512), per-ray draws and the linspace row with `sorted_u`,
  8 rays, coarse weights in [0.1, 1) (no pdf bin near the 1e-5 clamp):
  atol 1e-5 (tests/test_torch_resample.py's), every row sorted.
* (b) A numpy mirror of `resample_long_kernel` in float32: its row is exactly the
  sorted union of z and its own draws (ties included, z first) and within
  1e-5 of the plain version at those shapes and at the regime's edges; at
  Sc ≤ 256 its draws are the short kernel's (`_k5_warp`) bit for bit; its
  sort and searches are the source's.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.ops.pallas.fused_mlp import fused_resample as jax_fused_resample
from nerface_tpu_torch.ops.kernels import fused_resample as K5
from nerface_tpu_torch.ops.math import linspace01
from test_torch_k3f_k5_layout import _k5_warp, _pow2_at_least

torch.set_num_threads(1)

K5_CU = (pathlib.Path(K5.__file__).resolve().parents[2] / "csrc" / "fused_resample.cu").read_text()
LANE = np.arange(32)
PAIRS = [(64, 256), (128, 896), (3, 1021), (1000, 24), (512, 512)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _ray_inputs(R, Sc, Sf, seed, sorted_u):
    rng = np.random.RandomState(seed)
    z = (0.2 + 0.6 * (np.arange(Sc) + rng.rand(R, Sc)) / Sc).astype(np.float32)
    w = (0.1 + 0.9 * rng.rand(R, Sc)).astype(np.float32)
    u = np.array(jnp.linspace(0.0, 1.0, Sf, dtype=jnp.float32)) if sorted_u else rng.rand(R, Sf).astype(np.float32)
    return z, w, u


# -- (a) the plain version against the TPU kernel ----------------------------------

@pytest.mark.parametrize("regime", ["general", "sorted_u"])
@pytest.mark.parametrize("Sc,Sf", PAIRS, ids=[f"{a}+{b}" for a, b in PAIRS])
def test_plain_matches_jax_kernel_past_256(Sc, Sf, regime):
    R = 8
    sorted_u = regime == "sorted_u"
    z, w, u = _ray_inputs(R, Sc, Sf, Sc * 1000 + Sf, sorted_u)
    ref = np.asarray(jax_fused_resample(jnp.asarray(z), jnp.asarray(w), jnp.asarray(u), sorted_u=sorted_u))
    got = K5.fused_resample(_t(z), _t(w), _t(u), sorted_u).numpy()  # the wrapper on the CPU: the plain version
    assert got.shape == (R, Sc + Sf) and Sc + Sf > K5.SHORT_TOTAL
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert (np.diff(got, axis=-1) >= 0).all()
    if sorted_u:
        np.testing.assert_array_equal(linspace01(Sf).numpy(), u)


# -- (b) a mirror of the long regime ---------------------------------------------------

def _rank(row, v, steps, less):
    """`rank_in`: #{i < 2·steps − 1 : row[i] < v (or ≤ v)}, a binary search
    of the sorted row padded with +inf, for every v at once."""
    pos = np.zeros(v.shape, np.int64)
    while steps:
        r = row[pos + steps - 1]
        pos += np.where(r < v if less else r <= v, steps, 0)
        steps >>= 1
    return pos


def _bitonic(s, nf):
    """The general regime's sort: nf values, the pairs of each stage by the
    source's index map."""
    s = s.copy()
    size = 2
    while size <= nf:
        j = size >> 1
        while j:
            p = np.arange(nf // 2)
            i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
            a, b = s[i], s[i | j]
            up = (i & size) == 0
            s[i], s[i | j] = np.where(up, np.minimum(a, b), np.maximum(a, b)), np.where(up, np.maximum(a, b),
                                                                                        np.minimum(a, b))
            j >>= 1
        size <<= 1
    return s


def _k5_long(z, w, u, sorted_regime):
    """One ray through `resample_long_kernel`'s warp, in float32: z, w (Sc,), u
    (Sf,) -> the (Sc + Sf,) row and the draws."""
    f32 = np.float32
    Sc, Sf = len(z), len(u)
    sc = max(32, _pow2_at_least(Sc))
    per, B = sc // 32, Sc - 1
    nz, ns, nf = _pow2_at_least(Sc + 1), _pow2_at_least(Sf + 1), _pow2_at_least(Sf)
    zr = np.full(max(nz, sc), np.inf, f32)
    zr[:Sc] = z
    wr = np.zeros(sc, f32)
    wr[:Sc] = w
    i = per * LANE[:, None] + np.arange(per)[None, :]
    inner = (i >= 1) & (i <= Sc - 2)
    wk = np.where(inner, (wr[i] + f32(1e-5)).astype(f32), f32(0))
    part = np.zeros(32, f32)
    for k in range(per):
        part = (part + wk[:, k]).astype(f32)
    for o in (16, 8, 4, 2, 1):
        part = (part + part[LANE ^ o]).astype(f32)
    total = part[0]
    c, run = np.zeros((32, per), f32), np.zeros(32, f32)
    for k in range(per):
        run = np.where(inner[:, k], (run + (wk[:, k] / total).astype(f32)).astype(f32), run)
        c[:, k] = run
    incl = run.copy()
    for o in (1, 2, 4, 8, 16):
        incl = np.where(LANE >= o, (incl + incl[np.maximum(LANE - o, 0)]).astype(f32), incl)
    excl = np.where(LANE == 0, f32(0), incl[np.maximum(LANE - 1, 0)]).astype(f32)
    cdf = np.where(i < B, (excl[:, None] + c).astype(f32), np.inf).astype(f32).reshape(-1)
    ii = np.arange(sc)
    bins = np.where(ii < B, (f32(0.5) * (zr[np.minimum(ii + 1, len(zr) - 1)] + zr[ii]).astype(f32)).astype(f32),
                    f32(0))
    uq = u.astype(f32)
    pos = _rank(cdf, uq, sc // 2, less=False)
    below, above = np.maximum(pos - 1, 0), np.minimum(pos, B - 1)
    denom = (cdf[above] - cdf[below]).astype(f32)
    denom = np.where(denom < f32(1e-5), f32(1), denom).astype(f32)
    t = ((uq - cdf[below]).astype(f32) / denom).astype(f32)
    draws = (bins[below] + (t * (bins[above] - bins[below]).astype(f32)).astype(f32)).astype(f32)
    s = np.full(ns, np.inf, f32)
    s[:Sf] = draws
    if not sorted_regime:
        s[:nf] = _bitonic(s[:nf], nf)
    return _merge_by_rank(zr, Sc, s, Sf)[0], draws


def _merge_by_rank(zr, Sc, s, Sf):
    """Step 4: z[i] to i + #(draws < z[i]), draw j to j + #(z ≤ draw j),
    each list padded with +inf past its length to one less than a power of
    two. Returns (the row, z's places, the draws' places)."""
    nz, ns = _pow2_at_least(Sc + 1), _pow2_at_least(Sf + 1)
    zp = np.full(max(nz, len(zr)), np.inf, np.float32)
    zp[:Sc] = zr[:Sc]
    sp = np.full(ns, np.inf, np.float32)
    sp[:Sf] = s[:Sf]
    at_z = np.arange(Sc) + _rank(sp, zp[:Sc], ns // 2, less=True)
    at_s = np.arange(Sf) + _rank(zp, sp[:Sf], nz // 2, less=False)
    row = np.full(Sc + Sf, np.nan, np.float32)
    row[at_z], row[at_s] = zp[:Sc], sp[:Sf]
    assert not np.isnan(row).any()  # the ranks are a permutation
    return row, at_z, at_s


@pytest.mark.parametrize("regime", ["general", "sorted_u"])
@pytest.mark.parametrize("Sc,Sf", PAIRS + [(320, 1), (3, 254), (255, 2), (64, 193), (1023, 1)],
                         ids=[f"{a}+{b}" for a, b in PAIRS + [(320, 1), (3, 254), (255, 2), (64, 193), (1023, 1)]])
def test_long_mirror_gives_the_sorted_union(Sc, Sf, regime):
    """The mirror's row is exactly the sorted union of z and its own draws
    and within 1e-5 of the plain version, 3 rays."""
    R = 3
    sorted_u = regime == "sorted_u"
    z, w, u = _ray_inputs(R, Sc, Sf, Sc + 7 * Sf, sorted_u)
    uu = np.broadcast_to(u, (R, Sf)) if sorted_u else u
    ref = K5.fused_resample_reference(_t(z), _t(w), _t(u), sorted_u).numpy()
    for r in range(R):
        row, draws = _k5_long(z[r], w[r], uu[r], sorted_u)
        assert np.array_equal(row, np.sort(np.concatenate([z[r], draws])))
        np.testing.assert_allclose(row, ref[r], atol=1e-5, rtol=0)


def test_long_merge_places_ties_z_first():
    """Draws equal to coarse depths and to each other, coarse depths equal
    to each other, lists as long as a power of two: the merge by rank is a
    permutation, the row the sorted union, and each z before the draws
    equal to it (the reference's z-first order)."""
    rng = np.random.RandomState(3)
    for Sc, Sf in ((300, 700), (512, 512), (3, 1021), (1000, 24), (64, 256)):
        z = np.sort(rng.choice(np.linspace(0.2, 0.8, 50, dtype=np.float32), Sc))
        s = np.sort(np.concatenate([rng.choice(z, Sf // 2), rng.rand(Sf - Sf // 2).astype(np.float32)]))
        row, at_z, at_s = _merge_by_rank(z, Sc, s, Sf)
        assert np.array_equal(row, np.sort(np.concatenate([z, s])))
        for i in range(0, Sc, 7):
            ties = at_s[s == z[i]]
            assert (ties > at_z[i]).all()


@pytest.mark.parametrize("Sc", [3, 24, 64, 200, 256])
def test_long_draws_are_the_short_kernels_below_256(Sc):
    """At Sc ≤ 256 the long regime's cdf, bins and draws are the short
    kernel's bit for bit (the same class SC, the same order of sums): the
    draws of both mirrors at the same rays and u."""
    Sf = min(56, 256 - Sc)
    for seed in range(3):
        z, w, u = _ray_inputs(1, Sc, Sf, seed + Sc, False)
        _, short = _k5_warp(z[0], w[0], u[0], False)
        _, long = _k5_long(z[0], w[0], u[0], False)
        assert np.array_equal(short, long), (Sc, seed)


def test_long_kernel_is_the_mirror():
    """The mirror's steps are the source's: the class and the search
    lengths, the order of the cdf's sums, the search, the sort's index map
    and the ranks."""
    assert "const int sc = pow2_at_least(n_coarse < 32 ? 32 : n_coarse);" in K5_CU
    assert ("const int nz = pow2_at_least(n_coarse + 1), ns = pow2_at_least(n_fine + 1), "
            "nf = pow2_at_least(n_fine);") in K5_CU
    assert "part = __fadd_rn(part, (i >= 1 && i <= n_coarse - 2) ? __fadd_rn(m.cdf[at(i)], 1e-5f) : 0.f);" in K5_CU
    assert "m.cdf[at(i)] = i < B ? __fadd_rn(excl, m.cdf[at(i)]) : pos_inf();" in K5_CU
    assert "const int pos = rank_in<false>(m.cdf, uq, sc / 2);" in K5_CU
    assert "const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));" in K5_CU
    assert "m.cdf[at(i + rank_in<true>(m.s, v, ns / 2))] = v;" in K5_CU
    assert "m.cdf[at(j + rank_in<false>(m.z, v, nz / 2))] = v;" in K5_CU
    assert "if (n_coarse + n_fine > SHORT_OUT) {" in K5_CU and "constexpr int SHORT_OUT = 256;" in K5_CU
    assert K5.SHORT_TOTAL == 256


def test_grid_timer_is_chip_smokes_grid():
    """`k3f_k5_launch_split --k5-grid`, the ≤ 256 grid's A/B timer, times
    `chip_smoke.py`'s `[sample_counts]` grid on its ray count."""
    import importlib.util

    from nerface_tpu_torch.tools.perf import k3f_k5_launch_split as KS

    path = pathlib.Path(K5.__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_k5_long_tests", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert KS.GRID == (cs.K5_GRID_COARSE, cs.K5_GRID_FINE) and KS.GRID_RAYS == cs.SAMPLE_RAGGED_RAYS
    # the long regime's grid in chip_smoke.py holds cells on both sides of 256
    cells = [sc + sf for sc in cs.K5_LONG_COARSE for sf in cs.K5_LONG_FINE if sc + sf <= 1024]
    assert min(cells) <= K5.SHORT_TOTAL < max(cells) and sum(c > K5.SHORT_TOTAL for c in cells) == 7
    assert cs.K5_LONG_TILE == (64, 256)
