"""PyTorch port, the layouts of K4f's and K4b's wgmma kernels
(`csrc/fused_flex.cu`, `csrc/wgmma_chain.cuh`; `ops/kernels/fused_flex.py`):
the weights' chunk images, gathered in one cached index, equal imaging
`pack_kernel_operands` / `pack_transposed_weights` element for element;
the workspace's image offsets round-trip a matrix through every buffer and
the carve's order is the Python mirror's; the relu masks' bits
(`store_mask` / `apply_mask`) keep exactly the positive bf16 values, each
in the thread whose accumulator holds it; the unit schedule covers every
sample row once; the split tool's kernels and operations match the
sources and chip_smoke.py. Needs no JAX and no card: the kernels
themselves are held to their plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from nerface_tpu_torch.ops.kernels import fused_flex as F
from nerface_tpu_torch.ops.kernels import fused_train as T
from nerface_tpu_torch.ops.kernels.fused_mlp import sm90_chunk_image
from test_torch_k1_layout import _image_offset
from test_torch_k2_layout import _bits, unpack_chunk_image

torch.set_num_threads(1)

CSRC = pathlib.Path(F.__file__).resolve().parents[2] / "csrc"
CU = (CSRC / "fused_flex.cu").read_text()
H, D = F.HIDDEN, F.DIR_HIDDEN


def _weights(n, n_enc=60, seed=0):
    """Random bf16 matrices of `weight_names(n)` by name."""
    g = torch.Generator().manual_seed(seed + n)
    shapes = F._matrix_shapes(n, n_enc)
    return {k: torch.randn(*shapes[k], generator=g).to(torch.bfloat16) for k in F.weight_names(n)[0]}


@pytest.mark.parametrize("n", [0, 1, 3, 8])
@pytest.mark.parametrize("transposed", [False, True], ids=["forward", "backward"])
def test_weight_gather_equals_packing_then_images(n, transposed):
    """One gather from the matrices gives each chunked matrix of
    `pack_kernel_operands` as `sm90_chunk_image`, the heads row-major, at
    `w_offsets`; with `transposed` the images of `pack_transposed_weights`
    at `wt_offsets` first; element for element."""
    W = _weights(n)
    src = torch.cat([W["w1a"].new_zeros(1)] + [W[k].reshape(-1) for k in F.weight_names(n)[0]])
    got = src[F._flex_weight_gather(n, 60, torch.device("cpu"), transposed)]
    wo, to = F.w_offsets(n), F.wt_offsets(n)
    fwd = F.pack_kernel_operands(
        dict(W, **{b: torch.zeros(1, 1) for b in F.weight_names(n)[1]}), torch.zeros(1, H), n,
        torch.ones(10))[0]
    want = []
    if transposed:
        wt = F.pack_transposed_weights(W, n)
        for name in [k for k in to if k != "TOTAL"]:
            k, c = (D, H) if name == "WD0T" else (H, H)
            want.append(sm90_chunk_image(wt[to[name]:to[name] + k * c].reshape(k, c)))
    for name in [k for k in wo if k != "TOTAL"]:
        shape = {"W1": (64, H), "WD0": (H, D), "WA": (H, 1), "WRGB": (D, 3)}.get(name, (H, H))
        m = fwd[wo[name]:wo[name] + shape[0] * shape[1]].reshape(shape)
        want.append(m.reshape(-1) if name in ("WA", "WRGB") else sm90_chunk_image(m))
    want = torch.cat(want)
    assert got.dtype == torch.bfloat16 and got.numel() == want.numel()
    assert torch.equal(_bits(got), _bits(want))
    if transposed:
        # the forward images start on a 1024-byte boundary of the buffer
        assert (2 * to["TOTAL"]) % 1024 == 0
        # WD0ᵀ's image unpacks to wd0ᵀ bit for bit
        assert torch.equal(_bits(unpack_chunk_image(got[:D * H], D, H)), _bits(W["wd0"].T.contiguous()))


def test_kernel_operands_split_the_one_gather():
    """`_kernel_operands` hands the kernel the forward images and the
    transposed ones of the one gather, and the f32 rows of
    `pack_kernel_operands`, on the weights' device."""
    n = 3
    W = _weights(n, seed=5)
    g = torch.Generator().manual_seed(1)
    for b in F.weight_names(n)[1]:
        W[b] = torch.randn(1, {"ba": 1, "brgb": 3, "bd0": D}.get(b, H), generator=g)
    v0 = torch.randn(1, H, generator=g)
    wimg, fbuf, wtimg = F._kernel_operands(W, v0, n, 10, True, True)
    fimg, fbuf2 = F._kernel_operands(W, v0, n, 10, True, False)
    assert torch.equal(_bits(wimg), _bits(fimg)) and torch.equal(fbuf, fbuf2)
    assert wtimg.numel() == F.wt_offsets(n)["TOTAL"] and wimg.numel() == F.w_offsets(n)["TOTAL"]
    _, want_rows = F.pack_kernel_operands(W, v0, n, F._device_bands(10, True, torch.device("cpu")))
    assert torch.equal(fbuf, want_rows)


def test_workspace_carve_matches_cuda_source():
    """The carve takes the image buffers in `workspace_buffers` order, the
    relu masks in `mask_buffers` order, then the partial rows and dW's
    segments; the masks' size and the grid's constants agree."""
    carve = CU[CU.index("size_t carve("):CU.index("// -- K4f and the recompute")]
    order = re.findall(r"w\.(\w+)(?:\[i\])? = (img|bits|static_cast)", carve)
    names = [x[0] for x in order]
    assert names == ["xin", "act", "feat", "x0", "gx0", "gfeat", "gpre", "ga0", "fmask", "amask", "warp_part",
                     "tile_part", "dw_part"]
    widths = dict(re.findall(r"w\.(\w+)(?:\[i\])? = img\((\w+)\)", carve))
    consts = {"K_XIN": F.K_XIN, "HIDDEN": H, "DIR_HIDDEN": D}
    mirror = dict(F.workspace_buffers(3))
    assert {"xin": mirror["xin"], "act": mirror["a0"], "feat": mirror["feat"], "x0": mirror["x0"],
            "gx0": mirror["gx0"], "gfeat": mirror["gfeat"], "gpre": mirror["gpre0"],
            "ga0": mirror["ga0"]} == {k: consts[v] for k, v in widths.items()}
    m = re.search(r"constexpr int MASK_BYTES = ([\w *+/]+);", CU).group(1)
    assert eval(m, {}, consts) == F.MASK_BYTES
    k1_ctas = re.search(r"constexpr int K1_CTAS = (\d+);", (CSRC / "paper_train.cuh").read_text()).group(1)
    assert int(k1_ctas) == F.FLEX_CTAS == T.K1_CTAS
    assert "int flex_ctas(int n_rays, int n_samples) { return k1::pass_ctas(n_rays, n_samples); }" in CU
    wave = re.search(r"constexpr int DWG_WAVE = (\d+);", (CSRC / "wgmma_dw.cuh").read_text()).group(1)
    assert int(wave) == F.DWG_WAVE
    assert [F.dw_segments(n) for n in (0, 3, 8)] == [26, 12, 6]  # 132 / (5 + 2n)


@functools.lru_cache(maxsize=None)
def _unit_offsets(width):
    """Element offsets (in bf16) of a unit image's (row, col), by the
    `.cuh`'s `image_offset`."""
    rows, cols = np.meshgrid(np.arange(64), np.arange(width), indexing="ij")
    return torch.from_numpy(np.vectorize(_image_offset)(rows, cols) // 2)


@pytest.mark.parametrize("R,S,n", [(2048, 128, 3), (1111, 32, 8), (1, 64, 0)])
def test_workspace_images_round_trip_every_buffer(R, S, n):
    """A random matrix per buffer written as its unit images
    (`workspace_image`) at `workspace_layout`'s offset comes back element by
    element at the `.cuh`'s `image_offset`; each buffer spans its units'
    images and no two pieces of the workspace overlap."""
    offs, total = F.workspace_layout(R, S, n)
    units = -(-R // (64 // S if S < 64 else 1)) * (S // 64 if S > 64 else 1)
    names = list(offs)
    ends = [offs[names[i + 1]] if i + 1 < len(names) else total for i in range(len(names))]
    assert all(offs[a] < offs[b] for a, b in zip(names, names[1:])) and total % 256 == 0
    widths = dict(F.workspace_buffers(n))
    for name, end in zip(names, ends):
        need = units * widths[name] * 128 if name in widths else (
            units * F.MASK_BYTES if name in F.mask_buffers(n) else 0)
        assert end - offs[name] >= need, name
    g = torch.Generator().manual_seed(R + S + n)
    for name, width in F.workspace_buffers(n):
        rows = min(units, 2) * 64  # the layout repeats unit by unit
        m = torch.randint(-30000, 30000, (rows, width), generator=g, dtype=torch.int16)
        piece = _bits(T.workspace_image(m.view(torch.bfloat16)))  # the piece from its offset on
        for u in range(rows // 64):
            got = piece[u * 64 * width + _unit_offsets(width)]
            assert torch.equal(got, m[u * 64:(u + 1) * 64]), (name, u)


def _fragment_positions(t):
    """(row, col) of element e of pair p of warpgroup thread t's 64 × 256
    accumulator (`k1::frag_row`, `fold_col`): [p][e]."""
    lw, lane = t >> 5, t & 31
    r0, q = 16 * lw + lane // 4, lane & 3
    return [[(r0 + 8 * (p & 1), 8 * (p >> 1) + 2 * q + e) for e in range(2)] for p in range(64)]


def test_mask_bits_keep_exactly_the_positive_values():
    """`store_mask`'s test `bits - 1 < 0x7fff` is `value > 0` for every
    bf16 pattern but NaN's (exhaustive), and its words, replayed for every
    thread of a warpgroup and read back by `apply_mask`'s rule, mask each
    element of a 64 × 256 activation (zeros, -0 and negatives included) as
    [a > 0]: each element in exactly one thread and bit."""
    body = CU[CU.index("__device__ __forceinline__ void store_mask("):CU.index("// -- K4f and the recompute")]
    assert "lo - 1u < 0x7fffu" in body and "w[p / 16] |= b << (2 * (p % 16));" in body
    apply = CU[CU.index("__device__ __forceinline__ void apply_mask("):]
    assert "(w[p / 16] >> (2 * (p % 16) + e)) & 1u" in apply
    bits = np.arange(65536, dtype=np.uint32)
    vals = torch.from_numpy(bits.astype(np.int32).astype(np.int16)).view(torch.bfloat16).float().numpy()
    keep = (bits - np.uint32(1)) < 0x7FFF  # uint32: 0 wraps to the top
    nan = np.isnan(vals)
    assert np.array_equal(keep[~nan], (vals > 0)[~nan])
    rng = np.random.RandomState(3)
    a = rng.randn(64, 256).astype(np.float32)
    a[rng.rand(64, 256) < 0.3] = 0.0
    a[0, :8] = -0.0
    ab = torch.from_numpy(a).to(torch.bfloat16)
    u16 = _bits(ab).numpy().astype(np.uint32) & 0xFFFF
    seen = np.zeros((64, 256), np.int32)
    for t in range(128):
        pos = _fragment_positions(t)
        w = [0, 0, 0, 0]
        for p in range(64):
            lo, hi = (int(u16[pos[p][e]]) for e in range(2))
            b = (1 if (lo - 1) % (1 << 32) < 0x7FFF else 0) | (2 if (hi - 1) % (1 << 32) < 0x7FFF else 0)
            w[p // 16] |= b << (2 * (p % 16))
        for p in range(64):
            for e in range(2):
                r, c = pos[p][e]
                assert bool((w[p // 16] >> (2 * (p % 16) + e)) & 1) == bool(ab[r, c].float() > 0)
                seen[r, c] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("S", [32, 64, 128])
@pytest.mark.parametrize("R", [1, 3, 263, 264, 265, 1111, 2085])
def test_unit_schedule_covers_every_row_once(R, S):
    """The persistent grid's mirror: every sample row of the pass lies in
    exactly one live unit taken once, by a CTA below FLEX_CTAS; rows of a
    live unit past the last ray exist only in its last item; ray counts
    below one unit (R = 1 at S = 32), past one round of 132 CTAs (R >
    2·132·rays an item) and not a multiple of a unit or an item."""
    sched = F.unit_schedule(R, S)
    live = [unit for _, _, _, unit, ok in sched if ok]
    assert len(live) == len(set(live))
    rows = np.zeros(max(live) * 64 + 64, np.int32)
    for unit in live:
        rows[unit * 64:unit * 64 + 64] += 1
    assert (rows[:R * S] == 1).all() and (rows[R * S:] == 1).all()
    assert len(rows) - R * S < 64 * (64 // S if S < 64 else 1)  # only the last item overhangs
    ctas = {c for c, *_ in sched}
    assert ctas == set(range(len(ctas))) and len(ctas) <= F.FLEX_CTAS
    per_item = 64 // S if S < 64 else 1
    if R > 2 * F.FLEX_CTAS * per_item:
        assert len(ctas) == F.FLEX_CTAS and any(r >= F.FLEX_CTAS for _, r, *_ in sched)
    # every CTA walks its rounds in order, each round's two warpgroups
    for c in ctas:
        mine = [(r, wg) for cc, r, wg, *_ in sched if cc == c]
        assert mine == sorted(mine)


# the card tests' ragged cases (tests/test_torch_cuda.py::PERSISTENT_CASES)
# and the CTA whose last round leaves warpgroup 1 past the last ray
DEAD_UNIT_CTA = {(2085, 64): 118, (601, 128): 36, (1111, 32): None}


def test_persistent_cases_reach_the_dead_unit_walk():
    """The card tests reach the dead-unit walk (`fused_flex.cu::skip_stages`,
    K4b's recompute and dX): 2085 × 64 and 601 × 128 end on a round whose
    warpgroup 1 item lies past the last ray, in CTA 118 and CTA 36, the
    blocks of the watchdog's traps; 1111 × 32's last item is live."""
    from test_torch_cuda import PERSISTENT_CASES

    assert sorted(PERSISTENT_CASES) == sorted(DEAD_UNIT_CTA)
    for (R, S), cta in DEAD_UNIT_CTA.items():
        dead = {(c, r, wg) for c, r, wg, _, ok in F.unit_schedule(R, S) if not ok}
        if cta is None:
            assert dead == set()
        else:
            rounds = -(-R // (F.CONSUMERS * (64 // S if S < 64 else 1)))
            assert dead == {(cta, rounds - 1, 1)}
            assert (rounds - 1) % F.FLEX_CTAS == cta


def _chip_smoke():
    import importlib.util

    path = pathlib.Path(F.__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_k4_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("S", [64, 128])
def test_launch_split_covers_the_backward(S):
    """`flex_launch_split`: K4b's launches are the kernels the sources
    define, their operations add up to chip_smoke.py's K4B_FLOP_PER_SAMPLE
    at n = 3 (recompute 0.623, dX 0.591, dW 0.623 MFLOP a sample), each
    row reads its time against the operations bound with the workspace's
    bytes a floor apart, and the floor lies above the bound."""
    from nerface_tpu_torch.tools.perf import flex_launch_split as FS
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS

    cs = _chip_smoke()
    src = CU + (CSRC / "wgmma_dw.cuh").read_text() + (CSRC / "grad_tile.cuh").read_text()
    globals_ = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(", src))
    bounds = FS.launch_bounds(2048, S, 3)
    assert set(bounds) == set(FS.K4B_KERNELS) and set(bounds) <= globals_
    assert sum(b[0] for b in bounds.values()) == 2048 * S * cs.K4B_FLOP_PER_SAMPLE
    per_sample = {k: b[0] / (2048 * S) for k, b in bounds.items()}
    assert (per_sample["flex_chain_kernel"], per_sample["dw_wgmma_kernel"]) == (cs.K4F_FLOP_PER_SAMPLE,) * 2
    assert round(per_sample["flex_dx_kernel"] / 1e6, 3) == 0.591
    for name in ("flex_chain_kernel", "flex_dx_kernel", "dw_wgmma_kernel"):
        row = KS.launch_row(1.0, 1, *bounds[name])
        assert row["byte_floor_ms"] > row["ops_bound_ms"], name
        text = KS.row_text(name, row)
        assert "operations bound" in text and "byte floor" in text
