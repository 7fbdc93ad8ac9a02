"""PyTorch port: the Flexible-family kernels K4f / K4b and the resample K5 at
every sample count their TPU kernels take.

* (a) Dispatch. `flex_fused_eligible`, asked for the card (`device="cuda"`,
  no card needed), admits exactly what the JAX package sends to its Pallas
  kernel (its `flex_fused_eligible` and a ray tile of `_pick_rays_per_tile`,
  `nerface_tpu/render/pipeline.py:287-292`) for every S in 1..299 at R =
  2048, 2072 and 2047 (the limit, `fused_mlp.MAX_SAMPLES` = 1024, and
  past it in tests/test_torch_flex_long_rays.py), where a direct wrapper
  call past the limit raises a ValueError that names it. `csrc/fused_flex.cu`'s entry
  points admit exactly 1..MAX_SAMPLES and dispatch each S to its own layout
  class, with no branch that runs another S's layout.
* (b) The plain versions against the JAX package's Pallas kernels in
  interpret mode, as `tests/test_torch_flex_kernel.py::
  test_plain_matches_jax_kernel` runs them, at S ∈ {16, 24, 48, 96, 192}
  and 0 and 3 hidden layers: `fused_flex_forward_reference` against
  `_fused_flex_fwd` (raw [rgb, σ] within 2e-3·max|JAX|, that file's limit),
  `fused_flex_backward_reference` against `_fused_flex_bwd` (each gradient,
  d_v0 and d_dir within 0.08·max and 0.04·‖·‖, that file's limits).
* (c) K5: `fused_resample_reference` against JAX's `fused_resample` in
  interpret mode at chip_smoke.py's `[sample_counts]` grid, Sc ∈ {3, 16,
  24, 48, 96, 200} × Sf ∈ {1, 33, 56} (Sc + Sf ≤ 256), both regimes, atol
  1e-5 (tests/test_torch_resample.py's).
* (d) Layout. A mirror of the runtime flex schedule (`unit_schedule` and
  the kernels' row arithmetic) covers every sample row once and pads only
  an item's last unit, at every S in 1..256 (past it,
  tests/test_torch_flex_long_rays.py); K5's padded search counts
  only the real cdf entries, and its padded network keeps every real value
  and drops every pad, at every (Sc, Sf) of its domain.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.ops.encoding import _encoding_matrix
from nerface_tpu.ops.pallas import fused_flex as JF
from nerface_tpu.ops.pallas.fused_mlp import _pick_rays_per_tile as jax_pick_rays_per_tile
from nerface_tpu.ops.pallas.fused_mlp import fused_resample as jax_fused_resample
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.ops.kernels import fused_flex as F
from nerface_tpu_torch.ops.kernels import fused_resample as K5
from nerface_tpu_torch.ops.math import linspace01
from nerface_tpu_torch.render.pipeline import EncodeSpec
from test_torch_k3f_k5_layout import _pow2_at_least, k5_class

torch.set_num_threads(1)

CSRC = pathlib.Path(F.__file__).resolve().parents[2] / "csrc"
H = 256
NEW_S = [16, 24, 48, 96, 192]
RAY_COUNTS = [2048, 2072, 2047]
KW = dict(num_layers=4, hidden_size=256, skip_connect_every=3, num_encoding_fn_xyz=10,
          num_encoding_fn_dir=4, include_input_dir=False)
# [sample_counts]' K5 grid (chip_smoke.py)
K5_COARSE = [3, 16, 24, 48, 96, 200]
K5_FINE = [1, 33, 56]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_rule(n_rays, n_samples):
    """The JAX pipeline's test for its Pallas Flexible kernel: a ray tile of
    `_pick_rays_per_tile` (`fused_paper_mlp_available` without its
    TPU-backend test)."""
    tr = jax_pick_rays_per_tile(n_rays, n_samples)
    return tr >= 8 and n_rays % tr == 0


# -- (a) dispatch --------------------------------------------------------------

@pytest.mark.parametrize("n_rays", RAY_COUNTS)
@pytest.mark.parametrize("name,kw", [
    ("ConditionalBlendshapeLearnableCodeNeRFModel", {}), ("FlexibleNeRFModel", {}),
    ("ConditionalBlendshapeNeRFModel", dict(num_layers=6, skip_connect_every=3)),
], ids=["lcode", "flexible", "skip"])
def test_flex_dispatch_is_the_jax_rule(n_rays, name, kw):
    """On the card K4 takes a pass exactly where the JAX package takes its
    Pallas kernel, S in 1..MAX_SAMPLES (1024; the skip-layer model:
    nowhere): every S in 1..299 here. On the CPU, where the plain versions
    run, every ray count."""
    args = dict(KW, **kw)
    m = MODELS[name](**args)
    jm = JAX_MODELS[name](**args)
    pe_dir = torch.zeros(4, 24)
    static = JF.flex_fused_eligible(jm, JaxEncodeSpec(10, True, True), jnp.zeros((4, 24)))
    assert F.MAX_SAMPLES == 1024
    for S in range(1, 300):
        want = static and S <= F.MAX_SAMPLES and _jax_rule(n_rays, S)
        for dev in ("cuda", torch.device("cuda", 0)):
            got = F.flex_fused_eligible(m, EncodeSpec(10, True, True), pe_dir, n_rays, S, dev)
            assert got == want, (name, n_rays, S)
        assert F.flex_fused_eligible(m, EncodeSpec(10, True, True), pe_dir, n_rays, S, "cpu") == (
            static and S <= F.MAX_SAMPLES)


def test_apply_model_leaves_a_ragged_pass_to_the_plain_forward(monkeypatch):
    """The repair of the dispatch's ray-count rule: `_apply_model` hands the
    pass's ray count to `flex_fused_eligible`, so a bf16 pass of 2047 rays
    (no ray tile in JAX) runs the model's plain forward on the card and one
    of 2048 runs K4. The eligibility is asked for the card; `_flex_pass`
    and the plain forward are recorders."""
    from nerface_tpu_torch.render import pipeline

    m = MODELS["ConditionalBlendshapeLearnableCodeNeRFModel"](**KW)
    real = pipeline.flex_fused_eligible
    asked, taken = [], []
    monkeypatch.setattr(pipeline, "flex_fused_eligible",
                        lambda model, enc, pe, R, S, dev: asked.append((R, S)) or real(model, enc, pe, R, S, "cuda"))
    monkeypatch.setattr(pipeline, "_flex_pass", lambda *a: taken.append(a[1].shape[0]) or "K4")
    monkeypatch.setattr(m, "forward", lambda *a, **k: "plain")
    expr, latent = torch.zeros(76), torch.zeros(32)
    for R in (2048, 2047):
        z = torch.linspace(0.2, 0.8, 24).expand(R, 24)
        out = pipeline._apply_model(m, torch.zeros(R, 3), torch.ones(R, 3), z, EncodeSpec(10, True, True),
                                    torch.zeros(R, 24), expr, latent, torch.bfloat16)
        assert out == ("K4" if R == 2048 else "plain"), R
    assert asked == [(2048, 24), (2047, 24)] and taken == [2048]


def test_wrappers_raise_past_the_limit():
    """A direct K4f / K4b call at S = 1025 (or 0) raises a ValueError
    naming the limit, on the CPU too, whose wrappers run the plain
    versions; so does K5 past Sc + Sf = 1024 or below Sc = 3."""
    from nerface_tpu_torch.tools.perf.cases import flex_case

    for S in (1025, 0):
        c = flex_case(2, 1, 0, torch.device("cpu"), 3)
        z = c["z"].repeat(1, S)[:, :S].contiguous() if S else c["z"][:, :0]
        g = c["g"].repeat(1, max(S, 1), 1)[:, :S].contiguous()
        args = (c["weights"], c["ro"], c["rd"], z, c["dc"], c["v0"])
        with pytest.raises(ValueError, match=r"1\.\.1024 samples per ray"):
            F.fused_flex_forward(*args, 3)
        with pytest.raises(ValueError, match=r"1\.\.1024 samples per ray"):
            F.fused_flex_backward(*args, g, 3)
    z = torch.sort(torch.rand(2, 200), -1).values
    with pytest.raises(ValueError, match="at most 1024"):
        K5.fused_resample(z, torch.rand(2, 200), torch.rand(2, 825))
    with pytest.raises(ValueError, match="at least 3"):
        K5.fused_resample(z[:, :2], torch.rand(2, 2), torch.rand(2, 5))
    assert K5.fused_resample(z, torch.rand(2, 200), torch.rand(2, 824)).shape == (2, 1024)


def test_entry_points_take_exactly_the_kernels_domain():
    """The repair of the entry points' dispatch: `fused_flex.cu` admits S in
    1..MAX_SAMPLES (and refuses the rest with cudaErrorInvalidValue), and
    both entry points hand S to `dispatch_pass` with its own `UnitLayout`:
    there is no `switch (n_samples)` whose `default:` runs S = 128's layout
    for another S. K5's entry point admits 3 ≤ Sc, 1 ≤ Sf, Sc + Sf ≤ 1024
    (MAX_OUT, the header's MAX_SAMPLES), past 256 in its long regime."""
    cu = (CSRC / "fused_flex.cu").read_text()
    code = re.sub(r"//.*", "", cu)
    assert "switch (n_samples)" not in code and "default:" not in code
    valid = code[code.index("bool valid("):code.index("}", code.index("bool valid("))]
    assert "n_samples >= 1 && n_samples <= MAX_SAMPLES" in valid
    assert code.count("UnitLayout::of(n_samples, xc)") == 2
    # the xin image's blocks, xc = xin_extent(n_freqs) / K_XIN (mma_tile.cuh's
    # `dispatch_pass`: a pass of two runs the runtime class at any S)
    assert code.count("xin_extent(n_freqs)") == 3
    assert "dispatch_pass<Forward>(n_samples, hidden == WIDE, xc, fa, " in code
    assert "dispatch_pass<Backward>(n_samples, hidden == WIDE, xc, fa, da, st)" in code
    assert code.count("if (!valid(n_rays, n_samples, n_freqs, n_hidden, hidden)) return (int)cudaErrorInvalidValue;") == 2
    assert not re.search(r"(?<!Unit)Schedule<", code)  # the fixed-S schedule is gone
    for fn in ("flex_chain_kernel", "flex_dx_kernel", "fwd_produce", "fwd_consume", "dx_produce", "dx_unit",
               "dx_consume", "wide_chain_kernel", "wide_dx_kernel", "wide_fwd_produce", "wide_fwd_consume",
               "wide_dx_produce", "wide_dx_unit"):
        body = code[code.index(fn + "("):]
        assert "UnitSchedule<SF, 1>" in body[:body.index("\n}\n")], fn
    k5 = re.sub(r"//.*", "", (CSRC / "fused_resample.cu").read_text())
    assert "n_coarse < MIN_COARSE || n_fine < 1 || n_coarse + n_fine > MAX_OUT" in k5
    assert re.search(r"constexpr int MIN_COARSE = 3;", k5)
    assert re.search(r"constexpr int MAX_OUT = nerface::sm90::MAX_SAMPLES;", k5)
    assert "if (n_coarse + n_fine > SHORT_OUT) {" in k5
    from nerface_tpu_torch.ops.kernels import build

    assert "fused_flex" in build.LAYOUT_LIBRARIES


# -- (b) the plain versions against the TPU kernels ------------------------------

def _weights(n, seed):
    """`fused_flex_mlp`'s weight tuple (`fused_flex.py:344-356`) of the JAX
    LearnableCode model at n + 1 layers, initialised from `seed`, as numpy
    f32 (the matrices' values bf16-exact): (matrices, biases)."""
    jm = JAX_MODELS["ConditionalBlendshapeLearnableCodeNeRFModel"](**dict(KW, num_layers=n + 1))
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(seed)).items()}
    mats = [jp["layer1.weight"][:, :3].T, jp["layer1.weight"][:, 3:63].T]
    mats += [jp[f"layers_xyz.{i}.weight"].T for i in range(n)]
    mats += [jp[f"{k}.weight"].T for k in ("fc_feat", "fc_alpha")] + [jp["layers_dir.0.weight"][:, :H].T,
                                                                       jp["fc_rgb.weight"].T]
    mats = [np.asarray(jnp.asarray(m).astype(jnp.bfloat16).astype(jnp.float32)) for m in mats]
    biases = [jp[f"layers_xyz.{i}.bias"][None, :] for i in range(n)]
    biases += [jp[f"{k}.bias"][None, :] for k in ("fc_feat", "fc_alpha", "layers_dir.0", "fc_rgb")]
    return mats, [b.astype(np.float32) for b in biases]


def _flex_inputs(R, S, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(
        ro=(rng.randn(R, 3) * 0.1).astype(f), rd=rng.randn(R, 3).astype(f),
        z=np.cumsum(rng.rand(R, S) * (0.8 / S), -1).astype(f),
        dc=(rng.randn(R, 128) * 0.3).astype(f), v0=(rng.randn(1, H) * 0.1).astype(f),
        g=rng.randn(R, S, 4).astype(f),
    )


@pytest.mark.parametrize("n", [0, 3])
@pytest.mark.parametrize("S", NEW_S)
def test_flex_plain_matches_jax_kernel(S, n):
    """K4f's and K4b's plain versions against the Pallas kernels in
    interpret mode (8 rays, two grid steps of 4)."""
    R = 8
    mats, biases = _weights(n, seed=S + n)
    x = _flex_inputs(R, S, seed=S + 10 * n)
    C, phase = _encoding_matrix(3, 10, True)
    args = tuple(jnp.asarray(a) for a in (x["ro"], x["rd"], x["z"], x["dc"], x["v0"], C, phase[None, :]))
    jw = tuple(jnp.asarray(m).astype(jnp.bfloat16) for m in mats) + tuple(jnp.asarray(b) for b in biases)
    out, res = JF._fused_flex_fwd(S, 4, n, H, *args, *jw)
    jgrads = JF._fused_flex_bwd(S, 4, n, H, res, jnp.asarray(x["g"]))
    tw = tuple(_t(m).to(torch.bfloat16) for m in mats) + tuple(_t(b) for b in biases)
    targs = (tw, _t(x["ro"]), _t(x["rd"]), _t(x["z"]), _t(x["dc"]), _t(x["v0"]))
    got = F.fused_flex_forward_reference(*targs, n)
    out = np.asarray(out)
    assert got.shape == out.shape == (R, S, 4)
    np.testing.assert_allclose(got.numpy(), out, atol=2e-3 * np.abs(out).max(), rtol=0)
    grads, d_v0, d_dir = F.fused_flex_backward_reference(*targs, _t(x["g"]), n)
    wn, bn = F.weight_names(n)
    want = jgrads[7:] + (jgrads[4], jgrads[3])
    for name, a, b in zip(wn + bn + ("v0", "dir"), grads + (d_v0, d_dir), want):
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 0.08 * np.abs(b).max() + 1e-9, name
        assert np.linalg.norm(a - b) <= 0.04 * np.linalg.norm(b) + 1e-9, name


# -- (c) K5 against the TPU kernel ------------------------------------------------

def _k5_cases():
    return [(sc, sf) for sc in K5_COARSE for sf in K5_FINE if sc + sf <= 256]


@pytest.mark.parametrize("regime", ["general", "sorted_u"])
@pytest.mark.parametrize("Sc,Sf", _k5_cases())
def test_resample_plain_matches_jax_kernel(Sc, Sf, regime):
    """16 rays, coarse weights in [0.1, 1) (every bin's pdf ≥ 1e-3 at Sc ≤
    96; ≥ 5e-4 at 200), per-ray draws or the linspace row."""
    R = 16
    rng = np.random.RandomState(Sc * 1000 + Sf)
    z = (0.2 + 0.6 * (np.arange(Sc) + rng.rand(R, Sc)) / Sc).astype(np.float32)
    w = (0.1 + 0.9 * rng.rand(R, Sc)).astype(np.float32)
    sorted_u = regime == "sorted_u"
    u = np.array(jnp.linspace(0.0, 1.0, Sf, dtype=jnp.float32)) if sorted_u else (
        rng.rand(R, Sf).astype(np.float32))
    ref = np.asarray(jax_fused_resample(jnp.asarray(z), jnp.asarray(w), jnp.asarray(u), sorted_u=sorted_u))
    got = K5.fused_resample_reference(_t(z), _t(w), _t(u), sorted_u).numpy()
    assert got.shape == (R, Sc + Sf)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert (np.diff(got, axis=-1) >= 0).all()
    if sorted_u:
        np.testing.assert_array_equal(linspace01(Sf).numpy(), u)


# -- (d) layout ---------------------------------------------------------------------

@pytest.mark.parametrize("S0", [1, 65, 129, 193])
def test_runtime_schedule_covers_every_row_once(S0):
    """For each S in [S0, S0 + 64) (1..256 over the four cases), at a ray
    count past one round of the 132-CTA grid whose last item is cut short
    and at one ray: the kernels' row arithmetic (item row i of unit u is u·
    64 + t, real below rays·S, the pass's row ray0·S + i, its ray ray0 + i
    // S by `ray_of`'s multiply-shift) maps the live units' rows onto every
    sample row exactly once; padding rows lie only in an item's last unit,
    rows past the last ray only in the last item."""
    for S in range(S0, S0 + 64):
        rays, units = F.unit_layout(S)
        div = ((1 << 24) + S - 1) // S
        for R in (2 * F.FLEX_CTAS * rays + rays // 2 + 1, 1):
            seen = np.zeros(R * S, np.int32)
            n_items = -(-R // rays)
            for _, _, _, unit, live in F.unit_schedule(R, S):
                if not live:
                    continue
                item, u = divmod(unit, units)
                i = u * 64 + np.arange(64)
                ray = item * rays + ((i * div) >> 24)
                real = i < rays * S
                assert (((i * div) >> 24)[real] == i[real] // S).all()
                pad = ~real
                if pad.any():
                    assert u == units - 1, (S, R)
                past = real & (ray >= R)
                if past.any():
                    assert item == n_items - 1, (S, R)
                store = real & (ray < R)
                rows = item * rays * S + i[store]
                assert (rows == ray[store] * S + i[store] % S).all()
                seen[rows] += 1
            assert (seen == 1).all(), (S, R)
            assert len(F.unit_schedule(R, S)) == -(-n_items // 2) * 2 * units


def test_workspace_counts_padding_units_at_every_s():
    """K4b's workspace (`workspace_layout`, `carve`) holds a unit image for
    every unit of every item, padding units included, at each S."""
    for S in range(1, F.MAX_SAMPLES + 1):
        rays, units = F.unit_layout(S)
        R = 3 * rays + 1
        offs, total = F.workspace_layout(R, S, 3)
        need = -(-R // rays) * units
        assert offs["a0"] - offs["xin"] >= need * F.K_XIN * 128
        assert total > offs["dw_part"]


def test_resample_search_counts_only_real_entries():
    """K5's branch-free search over the cdf padded with +inf to Sc's class
    counts #{cdf ≤ u} over the Sc − 1 real entries for every Sc in 3..255:
    u at every knot, between knots, at 0 and 1."""
    rng = np.random.RandomState(0)
    for Sc in range(3, 256):
        SC, _ = k5_class(Sc, 1)
        B = Sc - 1
        pdf = (rng.rand(B - 1) + 1e-5).astype(np.float32)
        cdf = np.concatenate([[0.0], np.cumsum(pdf / pdf.sum())]).astype(np.float32)
        padded = np.concatenate([cdf, np.full(SC - B, np.inf, np.float32)])
        u = np.concatenate([cdf, (cdf[:-1] + cdf[1:]) / 2, [0.0, 1.0], rng.rand(8)]).astype(np.float32)
        pos = np.zeros(u.shape, np.int64)
        step = SC // 2
        while step:
            pos += np.where(padded[pos + step - 1] <= u, step, 0)
            step >>= 1
        assert (pos == np.searchsorted(cdf, u, side="right")).all(), Sc
        assert (np.minimum(pos, B - 1) <= Sc - 2).all()


def _merge_stage(v, size, j):
    """`bitonic_stage<E>` on a batch of warps' (32, E) registers."""
    E = v.shape[2]
    lane = np.arange(32)
    if j >= E:
        b = v[:, lane ^ (j // E)]
        i0 = lane * E
        keep_max = ((i0 & j) == 0) != ((i0 & size) == 0)
        return np.where(keep_max[None, :, None], np.maximum(v, b), np.minimum(v, b))
    out = v.copy()
    for e in range(E):
        if e & j:
            continue
        up = (((lane * E + e) & size) == 0)[None, :]
        lo, hi = np.minimum(v[:, :, e], v[:, :, e ^ j]), np.maximum(v[:, :, e], v[:, :, e ^ j])
        out[:, :, e], out[:, :, e ^ j] = np.where(up, lo, hi), np.where(up, hi, lo)
    return out


def test_resample_padded_network_keeps_every_real_value():
    """At every (Sc, Sf) with 3 ≤ Sc, 1 ≤ Sf, Sc + Sf ≤ 256: z padded with
    +inf to its class in the lanes below SC / E, the sorted draws (+inf past
    Sf) placed descending after them as the kernel's shuffles place them,
    the merge's log2(N) stages give the sorted union of the real values in
    the row's first Sc + Sf positions and only pads after."""
    rng = np.random.RandomState(1)
    by_class = {}
    for sc in range(3, 256):
        for sf in range(1, 257 - sc):
            by_class.setdefault(k5_class(sc, sf), []).append((sc, sf))
    assert sum(len(v) for v in by_class.values()) == 253 * 254 // 2
    for (SC, FP), cases in by_class.items():
        N = _pow2_at_least(SC + 32 * FP)
        E = N // 32
        ZL = SC // E
        assert N <= 512 and E % FP == 0 and SC % E == 0
        nb = len(cases)
        sc = np.array([c[0] for c in cases])[:, None]
        sf = np.array([c[1] for c in cases])[:, None]
        z = np.sort(rng.rand(nb, SC).astype(np.float32), -1)
        z = np.where(np.arange(SC)[None] < sc, z, np.inf).astype(np.float32)
        d = np.sort(rng.rand(nb, 32 * FP).astype(np.float32), -1)
        d = np.where(np.arange(32 * FP)[None] < sf, d, np.inf).astype(np.float32)
        pos = np.arange(32)[:, None] * E + np.arange(E)[None, :]
        q = N - 1 - pos
        v = np.where(q[None] < sf[:, :, None], d[:, np.minimum(q, 32 * FP - 1)], np.inf)
        v = np.where((np.arange(32) < ZL)[None, :, None], z[:, np.minimum(pos, SC - 1)], v).astype(np.float32)
        j = N // 2
        while j:
            v = _merge_stage(v, N, j)
            j >>= 1
        row = v.reshape(nb, -1)
        for k, (c_sc, c_sf) in enumerate(cases):
            want = np.sort(np.concatenate([z[k, :c_sc], d[k, :c_sf]]))
            assert np.array_equal(row[k, :c_sc + c_sf], want), (c_sc, c_sf)
            assert np.isinf(row[k, c_sc + c_sf:]).all(), (c_sc, c_sf)
