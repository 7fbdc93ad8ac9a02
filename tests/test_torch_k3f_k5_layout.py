"""PyTorch port, K3f on the shared wgmma chain (`csrc/fused_paper_mlp.cu`,
`csrc/paper_chain.cuh`) and K5 as a persistent register kernel
(`csrc/fused_resample.cu`), checked without a card:

* K3f's weights, gathered from the bundle by one cached index, are the
  image K2 takes (`pack_sm90_chunks` of `pack_kernel_operands`), bit for
  bit, for both models; the f32 rows are `pack_kernel_operands`' rows;
* a host mirror of K3f's persistent unit schedule and of its output-row
  mapping (the kernel's index formulas, transcribed and tied to the source)
  writes every (ray, sample) row exactly once, at each S, at ragged R and
  past one round of the 132-CTA grid;
* K2 and K3f run one copy of the chain (the layer and chunk sequences live
  in `paper_chain.cuh` only) and no mma.sync code is left in `csrc/`;
* K3f's wrapper on CPU tensors is the plain version and counts no launch;
* K5's kernel checks refuse what the kernel does not take, and a numpy
  mirror of the new kernel's warp (the scan, the branch-free search, the
  shuffle sort, the placement and the bitonic merge of the union) gives
  the sorted union exactly and agrees with the plain version within
  RESAMPLE_TOL·far, in both regimes, at every Sc and at Sf that are not
  powers of two;
* the launch-split tool's operations and bytes for K3f and K5 match
  chip_smoke.py's.

Needs no JAX: the kernels themselves are held to their plain versions on
the card (`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_resample as K5
from nerface_tpu_torch.ops.math import linspace01
from nerface_tpu_torch.tools.perf.cases import paper_case
from test_torch_k2_layout import _bits

torch.set_num_threads(1)

CSRC = pathlib.Path(K.__file__).resolve().parents[2] / "csrc"
K3_CU = (CSRC / "fused_paper_mlp.cu").read_text()
K2_CU = (CSRC / "fused_paper_render.cu").read_text()
CHAIN = (CSRC / "paper_chain.cuh").read_text()
K5_CU = (CSRC / "fused_resample.cu").read_text()
FAR = 0.8
RESAMPLE_TOL = 1e-5


# -- K3f: the weights' one gather ------------------------------------------------

@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_forward_gather_is_the_image_k2_takes(small):
    """The bundle's matrices through the forward part of
    `_backward_weight_gather` (what K3f takes) are
    `pack_sm90_chunks(pack_kernel_operands(...))`, K2's `wbuf_sm90`, bit for
    bit."""
    bundle, _ = paper_case(4, 64, 3, torch.device("cpu"), small)
    cond0, cond3, _, W, B = K._unbundle(bundle, small)
    src = torch.cat([W["w1"].new_zeros(1)] + [W[n].reshape(-1) for n in K.bundle_names(small)[0]])
    idx = K._backward_weight_gather(small, 60, torch.device("cpu"))[K.WT_OFFSETS["TOTAL"]:]
    got = src.to(torch.bfloat16)[idx]
    Wk = dict(W, **{k: v.reshape(-1) for k, v in B.items()})
    wbuf, _ = K.pack_kernel_operands(cond0.reshape(-1), cond3.reshape(-1), Wk, torch.ones(10))
    want = K.pack_sm90_chunks(wbuf)
    assert got.numel() == K.W_OFFSETS["TOTAL"]
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_kernel_operands_forward_packs_no_plain_buffer(small, monkeypatch):
    """`_kernel_operands(transposed=False)` no longer calls
    `pack_kernel_operands`: it hands K3f the gather's images and the f32
    rows `pack_kernel_operands` would give, and no transposed trunk."""
    dev = torch.device("cpu")
    bundle, _ = paper_case(6, 32, 4, dev, small)
    cond0, cond3, _, W, B = K._unbundle(bundle, small)
    Wk = dict(W, **{k: v.reshape(-1) for k, v in B.items()})
    wbuf, fbuf = K.pack_kernel_operands(cond0.reshape(-1), cond3.reshape(-1), Wk,
                                        K._device_bands(10, True, dev))

    def refuse(*a, **k):
        raise AssertionError("pack_kernel_operands called")

    monkeypatch.setattr(K, "pack_kernel_operands", refuse)
    dir_c, w, f, wt = K._kernel_operands(bundle, 6, dev, 10, True, small, transposed=False)
    assert wt is None and torch.equal(dir_c, bundle[2])
    assert torch.equal(_bits(w), _bits(K.pack_sm90_chunks(wbuf))) and torch.equal(f, fbuf)
    _, w_back, f_back, _ = K._kernel_operands(bundle, 6, dev, 10, True, small, transposed=True)
    assert torch.equal(_bits(w), _bits(w_back)) and torch.equal(f, f_back)


# -- K3f: the persistent schedule and the output rows ------------------------------

def _k1_ctas():
    hdr = (CSRC / "paper_train.cuh").read_text()
    return int(re.search(r"constexpr int K1_CTAS = (\d+);", hdr).group(1))


def test_schedule_formulas_are_the_sources():
    """The mirror below transcribes these lines: the grid (k1::pass_ctas),
    the consumers' unit loop and the producer's round loop, the unit
    layout (`UnitLayout::of`, whose rule `fused_mlp.unit_layout` is) and
    item, and the row each thread stores."""
    wc = (CSRC / "wgmma_chain.cuh").read_text()
    assert "if (64 % s == 0) {\n      rays = 64 / s;" in wc
    assert "} else if (s % 64 != 0) {" in wc
    assert "int rays = 1, units = (s + 63) / 64;" in wc
    assert "if (n * units > rays * u) {  // n / u > rays / units" in wc
    assert "constexpr int ITEM_ROWS = 256;" in wc and K.ITEM_ROWS == 256
    assert "return (round * CTAS + rank) * CHAIN_CONSUMERS + wg;" in wc
    assert "kernel<<<k1::pass_ctas(a.n_rays, a.l.S), PAPER_THREADS, FWD_SMEM_BYTES, st>>>(a);" in K3_CU
    assert "const UnitSchedule<SF, 1> g{a.l};" in K3_CU
    body = K3_CU[K3_CU.index("void fwd_consume("):K3_CU.index("__global__")]
    assert "const int round = blockIdx.x + (k / units) * gridDim.x;" in body
    assert "if (round >= n_rounds) break;" in body
    assert "const int units = g.units();" in body
    assert "const int item = g.item(round, 0, wg);" in body
    assert "g, item * g.wg_rays(), k % units, a.n_rays, hs, hc);" in body
    assert "const int rows = g.rows();" in body
    assert "const int i0 = (k % units) * 64 + r0;" in body
    assert "i0 < rows ? item * g.wg_rays() + g.ray_of(i0) : a.n_rays" in body
    assert "i0 + 8 < rows ? item * g.wg_rays() + g.ray_of(i0 + 8) : a.n_rays" in body
    assert "const size_t row = (size_t)item * rows + i0 + 8 * h;" in body
    assert "if ((lane & 3) == 0 && ray_h[h] < a.n_rays)" in body
    assert "*reinterpret_cast<float4*>(a.out + row * 4)" in body
    assert "paper_feed<SMALL, 1>(sm, a, g, 0, blockIdx.x, gridDim.x, n_rounds);" in K3_CU
    produce = CHAIN[CHAIN.index("void paper_produce("):CHAIN.index("void paper_feed(")]
    assert "for (int round = round0; round < n_rounds; round += step) {" in produce
    assert "for (int u = 0; u < units; ++u) {" in produce
    # the paper_train.cuh helper the mirror uses for r0
    assert "int frag_row() { return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2); }" in (
        CSRC / "paper_train.cuh").read_text()


def _fwd_rows(R, S):
    """Every float4 row store of a K3f launch, as the kernel's formulas
    give them: (cta, round, wg, ray, sample row) for each thread that
    stores, in each CTA's order."""
    wg_rays, units = K.unit_layout(S)
    rows = wg_rays * S
    rounds = -(-R // (2 * wg_rays))
    ctas = min(rounds, _k1_ctas())
    stores = []
    t = np.arange(128)
    lane, r0 = t & 31, ((t >> 5) & 3) * 16 + ((t & 31) >> 2)
    for cta in range(ctas):
        for wg in range(2):
            k = 0
            while True:
                rnd = cta + (k // units) * ctas
                if rnd >= rounds:
                    break
                item = 2 * rnd + wg  # G::item(round, 0, wg)
                i0 = (k % units) * 64 + r0
                for h in range(2):
                    i = i0 + 8 * h
                    ray = np.where(i < rows, item * wg_rays + i // S, R)
                    ok = ((lane & 3) == 0) & (ray < R)
                    for g_row, rr in zip(item * rows + i[ok], ray[ok]):
                        stores.append((cta, rnd, wg, int(rr), int(g_row)))
                k += 1
    return stores, ctas


@pytest.mark.parametrize("S", [1, 16, 24, 32, 64, 96, 128, 192, 256])
@pytest.mark.parametrize("R", [1, 3, 77, 263, 264, 265, 1111])
def test_output_rows_written_exactly_once(R, S):
    """Each (ray, sample) row of the (R, S, 4) output is stored once, by
    a thread whose ray holds that row, and nothing past the last ray nor
    from a padding row; each warpgroup walks its rounds in order, and past
    one round of the grid (R > 2·132·rays an item) a CTA takes a second
    one."""
    stores, ctas = _fwd_rows(R, S)
    rows = np.array([g for *_, g in stores])
    assert len(rows) == R * S and np.array_equal(np.sort(rows), np.arange(R * S))
    assert all(g // S == ray for _, _, _, ray, g in stores)
    per_item = K.unit_layout(S)[0]
    assert ctas == min(-(-R // (2 * per_item)), _k1_ctas())
    for c in range(ctas):
        for wg in range(2):
            mine = [r for cc, r, w, *_ in stores if cc == c and w == wg]
            assert mine == sorted(mine)
    if R > 2 * _k1_ctas() * per_item:
        assert any(r >= ctas for _, r, *_ in stores)


def test_k2_and_k3f_run_one_chain():
    """The paper model's layer sequence and chunk sequence exist once, in
    paper_chain.cuh, and both kernels run them; K3f has no cluster and
    its shared memory is the chain's alone; no mma.sync tile is left."""
    for src in (K2_CU, K3_CU):
        assert '#include "paper_chain.cuh"' in src
        assert "paper_unit<SMALL, " in src and "paper_feed<SMALL, " in src and "paper_setup<" in src
        assert "chain_layer<" not in src and "load_layer(" not in src
    assert "paper_unit<SMALL, CLUSTER>" in K2_CU and "paper_unit<SMALL, 1>" in K3_CU
    assert "__cluster_dims__" not in K3_CU
    assert "sizeof(PaperChainSmem) + ATOM_BYTES" in K3_CU
    for path in CSRC.glob("*.cu*"):
        text = re.sub(r"//.*", "", path.read_text())  # the code, not its comments
        for token in ("mma.sync", "ldmatrix", "cp.async.cg", "RenderSmem", "render_tile", "launch_tiles"):
            assert token not in text, (path.name, token)


@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_forward_wrapper_on_cpu_is_the_plain_version(small):
    bundle, rays = paper_case(3, 32, 8, torch.device("cpu"), small)
    before = K.fused_paper_mlp_forward.launches
    got = K.fused_paper_mlp_forward(bundle, rays["ro"], rays["rd"], rays["z"], small=small)
    ref = K.fused_paper_mlp_reference(bundle, rays["ro"], rays["rd"], rays["z"], small=small)
    assert K.fused_paper_mlp_forward.launches == before
    assert got.shape == (3, 32, 4) and torch.equal(got, ref)


# -- K5: the checks, and a mirror of the warp ---------------------------------------

def _k5_args(R=4, Sc=64, Sf=64):
    z = torch.sort(torch.rand(R, Sc, generator=torch.Generator().manual_seed(1)), -1).values
    return z, torch.rand(R, Sc), torch.rand(R, Sf)


@pytest.mark.parametrize(
    "change,error,match",
    [("coarse2", ValueError, "coarse samples"), ("fine0", ValueError, "fine samples"),
     ("fine193", ValueError, "fine samples"), ("double", TypeError, "float32"),
     ("strided", ValueError, "contiguous")],
)
def test_resample_checks_refuse_what_the_kernel_does_not_take(change, error, match):
    """Outside 3 ≤ Sc, 1 ≤ Sf, Sc + Sf ≤ 1024 (64 + 961 = 1025; the case
    keeps its name from the limit of 256, 64 + 193), or an operand the
    kernel cannot read."""
    z, w, u = _k5_args()
    if change == "coarse2":
        z, w = z[:, :2].contiguous(), w[:, :2].contiguous()
    elif change == "fine0":
        u = u[:, :0]
    elif change == "fine193":
        u = torch.rand(4, 961)
    elif change == "double":
        w = w.double()
    else:
        z = z.t().contiguous().t()
    with pytest.raises(error, match=match):
        K5.check_kernel_operands(z, w, u)


@pytest.mark.parametrize("Sc,Sf", [(32, 128), (64, 64), (128, 128), (128, 1), (3, 253), (48, 129),
                                   (255, 1), (200, 56), (64, 256), (3, 1021), (1023, 1)])
def test_resample_checks_take_the_kernels_shapes(Sc, Sf):
    K5.check_kernel_operands(*_k5_args(3, Sc, Sf))
    K5.check_kernel_operands(*_k5_args(3, Sc, Sf)[:2], torch.rand(Sf))


def _pow2_at_least(x):
    p = 1
    while p < x:
        p <<= 1
    return p


LANE = np.arange(32)


def _stage(v, size, j):
    """`bitonic_stage<E>` on a warp's (32, E) registers."""
    E = v.shape[1]
    if j >= E:
        b = v[LANE ^ (j // E)]
        i0 = LANE * E
        keep_max = ((i0 & j) == 0) != ((i0 & size) == 0)
        return np.where(keep_max[:, None], np.maximum(v, b), np.minimum(v, b))
    out = v.copy()
    for e in range(E):
        if e & j:
            continue
        up = ((LANE * E + e) & size) == 0
        lo, hi = np.minimum(v[:, e], v[:, e ^ j]), np.maximum(v[:, e], v[:, e ^ j])
        out[:, e], out[:, e ^ j] = np.where(up, lo, hi), np.where(up, hi, lo)
    return out


def k5_class(Sc, Sf):
    """(SC, FP): Sc's class, the least power of two ≥ Sc from 32, and the
    draws a lane (`fused_resample.cu`'s template arguments)."""
    return max(32, _pow2_at_least(Sc)), 1 if Sf <= 32 else (2 if Sf <= 64 else (4 if Sf <= 128 else 8))


def _k5_warp(z, w, u, sorted_regime):
    """One ray through the kernel's warp, in float32: z, w (Sc,), u (Sf,)
    -> the (Sc + Sf,) row and the draws. z and w padded to Sc's class
    (z +inf, w 0), the cdf's padded entries +inf."""
    f32 = np.float32
    Sc, Sf = len(z), len(u)
    SC, FP = k5_class(Sc, Sf)
    PER = SC // 32
    N = _pow2_at_least(SC + 32 * FP)
    E, B = N // 32, Sc - 1
    ZL = SC // E
    i = PER * LANE[:, None] + np.arange(PER)[None, :]
    zp = np.concatenate([z.astype(f32), np.full(SC - Sc, np.inf, f32)])
    wp = np.concatenate([w.astype(f32), np.zeros(SC - Sc, f32)])
    zv, wv = zp.reshape(32, PER), wp.reshape(32, PER)
    inner = (i >= 1) & (i <= Sc - 2)
    wk = np.where(inner, wv + f32(1e-5), f32(0)).astype(f32)
    part = np.zeros(32, f32)
    for k in range(PER):
        part = (part + wk[:, k]).astype(f32)
    for o in (16, 8, 4, 2, 1):
        part = (part + part[LANE ^ o]).astype(f32)
    total = part[0]
    c, run = np.zeros((32, PER), f32), np.zeros(32, f32)
    for k in range(PER):
        run = np.where(inner[:, k], run + wk[:, k] / total, run).astype(f32)
        c[:, k] = run
    incl = run.copy()
    for o in (1, 2, 4, 8, 16):
        t = incl[np.maximum(LANE - o, 0)]
        incl = np.where(LANE >= o, incl + t, incl).astype(f32)
    excl = np.where(LANE == 0, f32(0), incl[np.maximum(LANE - 1, 0)]).astype(f32)
    z_next = zv[np.minimum(LANE + 1, 31), 0]
    cdf = np.where(i < B, excl[:, None] + c, np.inf).astype(f32).reshape(-1)
    zn = np.concatenate([zv[:, 1:], z_next[:, None]], 1)
    bins = (f32(0.5) * (zn + zv).astype(f32)).astype(f32).reshape(-1)
    s = np.full((32, FP), np.inf, f32)
    for lane in range(32):
        for k in range(FP):
            q = FP * lane + k
            if q >= Sf:
                continue
            uq, pos, step = f32(u[q]), 0, SC // 2
            while step:
                pos += step if cdf[pos + step - 1] <= uq else 0
                step >>= 1
            below, above = max(pos - 1, 0), min(pos, B - 1)
            denom = f32(cdf[above] - cdf[below])
            denom = f32(1) if denom < f32(1e-5) else denom
            t = f32(f32(uq - cdf[below]) / denom)
            s[lane, k] = f32(bins[below] + f32(t * f32(bins[above] - bins[below])))
    draws = s.reshape(-1)[:Sf].copy()
    if not sorted_regime:
        size = 2
        while size <= 32 * FP:
            j = size >> 1
            while j:
                s = _stage(s, size, j)
                j >>= 1
            size <<= 1
    v = np.zeros((32, E), f32)
    for e in range(E):
        q = N - 1 - (E * LANE + e)
        slot = FP - 1 - e % FP
        assert ((q % FP) == slot).all()
        t = s[(q // FP) & 31, slot]
        v[:, e] = np.where(LANE < ZL, zp[np.minimum(E * LANE + e, SC - 1)],
                           np.where(q < Sf, t, np.inf))
    j = N // 2
    while j:
        v = _stage(v, N, j)
        j >>= 1
    return v.reshape(-1)[:Sc + Sf], draws


@pytest.mark.parametrize("regime", ["general", "sorted_u"])
@pytest.mark.parametrize("Sc,Sf", [(32, 1), (32, 37), (32, 128), (64, 64), (64, 100), (128, 16),
                                   (128, 128), (3, 56), (24, 200), (48, 33), (200, 56)])
def test_resample_warp_mirror_gives_the_sorted_union(Sc, Sf, regime):
    """The mirror's row is exactly the sorted union of z and its own
    draws, and within RESAMPLE_TOL·far of the plain version (rays as
    chip_smoke.py draws them, per-ray u or the linspace row)."""
    R = 6
    g = torch.Generator().manual_seed(Sc * 1000 + Sf)
    z = 0.2 + (FAR - 0.2) * (torch.arange(Sc) + torch.rand(R, Sc, generator=g)) / Sc
    w = 0.1 + 0.9 * torch.rand(R, Sc, generator=g)
    u = linspace01(Sf).expand(R, Sf) if regime == "sorted_u" else torch.rand(R, Sf, generator=g)
    ref = K5.fused_resample_reference(z, w, u.contiguous(), regime == "sorted_u").numpy()
    for r in range(R):
        row, draws = _k5_warp(z[r].numpy(), w[r].numpy(), u[r].numpy(), regime == "sorted_u")
        assert np.array_equal(row, np.sort(np.concatenate([z[r].numpy(), draws])))
        np.testing.assert_allclose(row, ref[r], atol=RESAMPLE_TOL * FAR, rtol=0)


def test_resample_kernel_shapes_are_the_sources():
    """The mirror's shapes are the kernel's: the network's size, the draws
    a lane, and the placement's slot and lane."""
    assert "constexpr int N = pow2_at_least(SC + 32 * FP);" in K5_CU
    assert "const int fp = n_fine <= 32 ? 1 : (n_fine <= 64 ? 2 : (n_fine <= 128 ? 4 : 8));" in K5_CU
    assert "if (n_coarse <= 32) return launch<32>(" in K5_CU and "return launch<256>(" in K5_CU
    assert "c[k] = PER * lane + k < B ? __fadd_rn(excl, c[k]) : pos_inf();" in K5_CU
    assert "const int q = N - 1 - (E * lane + e);" in K5_CU
    assert "__shfl_sync(FULL, s[FP - 1 - e % FP], (q / FP) & 31);" in K5_CU
    assert "for (int step = SC / 2; step > 0; step >>= 1) pos += m.cdf[pos + step - 1] <= uq ? step : 0;" in K5_CU
    assert "for (int j = N / 2; j > 0; j >>= 1) bitonic_stage<E>(v, N, j, lane);" in K5_CU


def test_launch_split_bounds_match_chip_smoke():
    """`k3f_k5_launch_split`'s operations and bytes are chip_smoke.py's:
    K3f's at 2048 × 64 and a tile, K5's at a tile in both regimes."""
    import importlib.util

    from nerface_tpu_torch.tools.perf import k3f_k5_launch_split as KS

    path = pathlib.Path(K.__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_k3f_tests", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for R, S in ((2048, 64), (65536, 128)):
        flop, nbytes = KS.k3f_work(R, S, False)
        assert flop == R * S * cs.paper_flop_per_sample(False, False)
        assert nbytes == cs._k3_bytes(R, S, False)
    for shared in (False, True):
        assert KS.k5_bytes(65536, 64, 64, shared) == cs._k5_bytes(65536, 64, 64, shared)
    assert abs(KS.k5_bytes(65536, 64, 64, False) / cs.PEAK_BYTES_S * 1e3 - 0.0250) < 1e-4
