"""PyTorch port, the layouts of K1's and K3b's wgmma pass
(`csrc/paper_train.cuh`, `csrc/wgmma_dw.cuh`; `fused_train.py`,
`fused_mlp.py`): the dX operands' chunk images (`pack_sm90_chunks` over the
transposed trunk) hold every Wᵀ bit for bit; the workspace's operand images
(`workspace_image`) give every matrix back element by element at the byte
offsets the header's `image_offset` computes; the warp-level data movement
of the kernel (`quad_transpose` in `store_frag` / `load_frag`, the column
sums' reduce-scatter `scatter_sum`), replayed lane by lane, writes exactly
those images and sums exactly those columns; and the buffers, widths, chunk
sequences, dW products and constants agree with the sources. Needs no JAX.
The kernels themselves are held to their plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_train as T
from test_torch_k2_layout import _bits, _state, unpack_chunk_image

torch.set_num_threads(1)

CSRC = pathlib.Path(K.__file__).resolve().parents[2] / "csrc"
HDR = (CSRC / "paper_train.cuh").read_text()
DW = (CSRC / "wgmma_dw.cuh").read_text()
CONST = {"K_XIN": K.K_XIN, "HIDDEN": K.HIDDEN, "DIR_HIDDEN": K.DIR_HIDDEN}


def _image_offset(row, col):
    """`image_offset` and `sw128` as the headers write them, evaluated here."""
    sw = re.search(r"int sw128\(int row, int col\) \{\s*return (.+?);",
                   (CSRC / "wgmma_tile.cuh").read_text(), re.S).group(1)
    img = re.search(r"int image_offset\(int row, int col\) \{\s*return (.+?);", HDR, re.S).group(1)
    img = img.replace("sw128(row, col & 63)", f"({sw.replace('col', '(col & 63)')})")
    return eval(img, {}, {"row": row, "col": col, "ROW_BYTES": 128, "BLOCK_BYTES": 64 * 128})


def _bundle(small, seed=3):
    params = {k: v for k, v in _state(small, seed).items()}
    g = torch.Generator().manual_seed(seed)
    cond = torch.randn(108, generator=g) * 0.2
    pe_dir = torch.randn(4, 24, generator=g)
    return [t.contiguous() for t in T.prefold_paper_params(
        params, cond, pe_dir, 10, small=small, dir_expr_offset=(256 + 24) if small else 0)]


@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_backward_operands_are_chunk_images(small):
    """K1's and K3b's operands: the forward weights as K2's chunk images,
    and each transposed matrix (out, in) as the chunk image of the B of
    gy·Wᵀ (K = out, N = in), bit for bit."""
    bundle = _bundle(small)
    cond0, cond3, _, W, B = K._unbundle(bundle, small)
    _, wimg, _, wtimg = K._kernel_operands(bundle, 4, torch.device("cpu"), 10, True, small,
                                           transposed=True)
    # K3f's forward operands are the same images, from a gather of their own
    _, wfwd, _, none = K._kernel_operands(bundle, 4, torch.device("cpu"), 10, True, small,
                                          transposed=False)
    wplain, _ = K.pack_kernel_operands(cond0.reshape(-1), cond3.reshape(-1),
                                       dict(W, **{k: v.reshape(-1) for k, v in B.items()}),
                                       K._device_bands(10, True, torch.device("cpu")))
    assert none is None and torch.equal(_bits(wfwd), _bits(wimg))
    assert wimg.numel() == wplain.numel() == K.W_OFFSETS["TOTAL"]
    for name, k, n in K.W_LAYOUT:
        o = K.W_OFFSETS[name]
        got = wimg[o:o + k * n]
        got = unpack_chunk_image(got, k, n) if name in K.SM90_CHUNKED else got.reshape(k, n)
        assert torch.equal(_bits(got), _bits(wplain[o:o + k * n].reshape(k, n))), name
    assert wtimg.dtype == torch.bfloat16 and wtimg.numel() == K.WT_OFFSETS["TOTAL"]
    for name, k, n in K.WT_LAYOUT:
        o = K.WT_OFFSETS[name]
        got = unpack_chunk_image(wtimg[o:o + k * n], k, n)
        src = K.WT_SOURCE[name]
        want = W[src].T if src in W else torch.zeros(k, n)
        assert torch.equal(_bits(got), _bits(want.to(torch.bfloat16))), name


@pytest.mark.parametrize("width", [64, 128, 256])
def test_workspace_image_unpacks_element_by_element(width):
    units = 3
    m = torch.arange(units * 64 * width, dtype=torch.int32).remainder(32749).to(torch.int16)
    m = m.reshape(units * 64, width).view(torch.bfloat16)
    img = _bits(T.workspace_image(m)).numpy()
    assert img.size == m.numel()
    mb = _bits(m).numpy()
    rows, cols = np.meshgrid(np.arange(64), np.arange(width), indexing="ij")
    offs = np.vectorize(_image_offset)(rows, cols)
    assert (offs % 2 == 0).all() and len(np.unique(offs)) == offs.size
    for u in range(units):
        got = img[u * 64 * width + offs // 2]
        assert np.array_equal(got, mb[u * 64:(u + 1) * 64]), u


def _fragments(m, lw):
    """A-fragment pairs a[p] of warp lw's threads for a 64 × N unit."""
    n = m.shape[1]
    frag = np.zeros((32, n // 4, 2), m.dtype)
    for lane in range(32):
        r0, q = 16 * lw + lane // 4, lane & 3
        for p in range(n // 4):
            row, col = r0 + 8 * (p & 1), 8 * (p >> 1) + 2 * q
            frag[lane, p] = m[row, col:col + 2]
    return frag


def _quad_transpose(w):
    """`quad_transpose` replayed: w[lane][t] over a warp's 32 lanes."""
    w = [list(x) for x in w]
    for b in (1, 2):
        new = [list(x) for x in w]
        for lane in range(32):
            hi, partner = bool(lane & 3 & b), lane ^ b
            phi = bool(partner & 3 & b)
            for t0 in range(4):
                if t0 & b:
                    continue
                t1 = t0 | b
                recv = w[partner][t0] if phi else w[partner][t1]  # the partner's send
                if hi:
                    new[lane][t0] = recv
                else:
                    new[lane][t1] = recv
        w = new
    return w


@pytest.mark.parametrize("n", [128, 256])
def test_fragment_stores_write_the_workspace_image(n):
    """store_frag's word trade and 16-byte stores, replayed lane by lane
    for the four warps of a warpgroup, give `workspace_image`; and
    load_frag's loads, traded back, give each thread its fragment."""
    rng = np.random.RandomState(n)
    m = rng.randint(-30000, 30000, size=(64, n)).astype(np.int16)
    img = np.full(64 * n, -1, np.int64)
    for lw in range(4):
        frag = _fragments(m, lw)
        for h in range(2):
            for bb in range(n // 32):
                w = [[tuple(frag[lane, 8 * bb + 2 * t + h]) for t in range(4)] for lane in range(32)]
                w = _quad_transpose(w)
                back = _quad_transpose(w)
                for lane in range(32):
                    assert back[lane] == [tuple(frag[lane, 8 * bb + 2 * t + h]) for t in range(4)]
                    r0, q = 16 * lw + lane // 4, lane & 3
                    off = _image_offset(r0 + 8 * h, 8 * (4 * bb + q)) // 2
                    img[off:off + 8] = np.array(w[lane]).reshape(-1)
    want = _bits(T.workspace_image(torch.from_numpy(m).view(torch.bfloat16))).numpy()
    assert np.array_equal(img, want)


@pytest.mark.parametrize("n", [128, 256])
def test_colsum_reduce_scatter_sums_every_column(n):
    """colsum's fold of a thread's two rows and `scatter_sum` over lane ^
    16, 8, 4, replayed: lane g·4 + q ends with the column sums over the
    warp's 16 rows of fold_col(g·N/32 + k), k < N/32, and every column is
    held by exactly one lane."""
    rng = np.random.RandomState(n + 1)
    m = rng.randint(-8, 8, size=(16, n)).astype(np.float64)  # exact sums
    nv = n // 4
    v = np.zeros((32, nv))
    for lane in range(32):
        q = lane & 3
        for j in range(n // 8):
            for e in range(2):
                col = 8 * j + 2 * q + e
                v[lane, 2 * j + e] = m[lane // 4, col] + m[lane // 4 + 8, col]
    size = nv
    for L in (16, 8, 4):
        new = v.copy()
        for lane in range(32):
            upper = bool(lane & L)
            partner = v[lane ^ L]
            half = size // 2
            for i in range(half):
                send = partner[i + half] if not bool((lane ^ L) & L) else partner[i]
                keep = v[lane, i + half] if upper else v[lane, i]
                new[lane, i] = keep + send
        v, size = new, size // 2
    seen = set()
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for k in range(n // 32):
            i = g * (n // 32) + k
            col = 8 * (i >> 1) + 2 * q + (i & 1)
            assert v[lane, k] == m[:, col].sum(), (lane, k)
            seen.add(col)
    assert seen == set(range(n))


def test_workspace_layout_matches_cuda_source():
    enum = re.search(r"enum WsBuffer \{(.+?)\};", HDR, re.S).group(1)
    names = [x.strip() for x in enum.replace("\n", " ").split(",") if x.strip()]
    assert names[-1] == "WS_BUFFERS"
    assert [n[3:].lower() for n in names[:-1]] == [b for b, _ in T.WS_BUFFERS]
    width = re.search(r"constexpr int ws_width\(int b, int kx\) \{(.+?)\n\}", HDR, re.S).group(1)
    assert width.strip().startswith("return b == WS_XIN ? kx")
    narrow = set(re.findall(r"b == (WS_\w+)", width.split("?", 1)[1]))
    assert T.WS_BUFFERS == T.ws_buffers(K.K_XIN)
    for kx in (K.K_XIN, K.K_XIN_WIDE):
        for name, w in T.ws_buffers(kx):
            cu = "WS_" + name.upper()
            want = kx if cu == "WS_XIN" else K.DIR_HIDDEN if cu in narrow else K.HIDDEN
            assert w == want, name
    for const, value in (("K1_CTAS", T.K1_CTAS), ("WARPS_A_CTA", T.WARPS_A_CTA)):
        m = re.search(rf"constexpr int {const} = ([\w *+()]+);", HDR)
        assert eval(m.group(1), {}, {"CONSUMERS": 2}) == value, const
    assert re.search(rf"constexpr int DWG_SEGS = {T.DWG_SEGS};", DW)
    part = re.search(r"constexpr int PART_COLS = PART_WRGB \+ DIR_HIDDEN \* 3;", HDR)
    assert part and T.PART_COLS == K.F_OFFSETS["TOTAL"] + K.HIDDEN + 3 * K.DIR_HIDDEN
    # carve: the bf16 buffers in enum order, then the partial rows, dW's
    # segments and a long item's rows (none up to S = 256)
    carve = HDR[HDR.index("inline size_t carve("):HDR.index("inline long long workspace_bytes(")]
    order = [m.group(1) for m in re.finditer(r"w\.([\w\[\]]+) = ", carve)]
    assert order == ["buf[b]", "warp_part", "tile_part", "dw_part", "rows", "kx"]  # kx: xin's width, no bytes
    assert [k for k in T.workspace_layout(2048, 64) if k != "total"] == (
        [b for b, _ in T.WS_BUFFERS] + ["warp_part", "tile_part", "dw_part", "rows"])
    assert "ctas * WARPS_A_CTA * PART_COLS" in carve and "DWG_SEGS * w_off(W_OFF_WA, kx)" in carve


@pytest.mark.parametrize("R,S,units,ctas", [(2048, 128, 4096, 132), (2048, 64, 2048, 132),
                                            (301, 32, 151, 76), (77, 128, 154, 39), (1, 32, 1, 1)])
def test_workspace_geometry(R, S, units, ctas):
    assert T.workspace_geometry(R, S) == (units, ctas)


def test_chunk_sequences_match_cuda_source():
    """The producer streams a round's chunks as each unit's forward
    (W_LAYOUT's chunked matrices) and then each unit's dX (WT_LAYOUT),
    the smaller model skipping W5 and W5ᵀ; the consumers' layer<N, chunks>
    sequence is the same, forward and dX."""
    body = HDR[HDR.index("void round_layers("):HDR.index("// The producer:")]
    for kx in (K.K_XIN, K.K_XIN_WIDE):
        env = dict(CONST, kx=kx)
        seq = [(m.group(1), m.group(2), eval(m.group(3), {}, env), eval(m.group(4), {}, env))
               for m in re.finditer(r"fn\((WT?) \+ (?:w_off\()?WT?_OFF_(\w+)(?:, kx\))?, ([\w +]+), (\w+)\);",
                                    body)]
        chunked = [(n, k, c) for n, k, c in K.w_layout(kx) if n in K.SM90_CHUNKED]
        assert [(s[1], s[2], s[3]) for s in seq if s[0] == "W"] == chunked
        assert [(s[1], s[2], s[3]) for s in seq if s[0] == "WT"] == list(K.WT_LAYOUT)
    assert "if (!SMALL) fn(W + w_off(W_OFF_W5, kx)," in body and "if (!SMALL) fn(WT + WT_OFF_W5T," in body
    fwd = [(n, k, c) for n, k, c in K.W_LAYOUT if n in K.SM90_CHUNKED]
    fu = HDR[HDR.index("void forward_unit("):HDR.index("// -- dX")]
    layers = [(eval(m.group(1), {}, CONST), int(m.group(2)))
              for m in re.finditer(r"\blayer<(\w+), (\d+), \d+>\(", fu)]
    assert layers == [(n, k // 64) for _, k, n in fwd]
    dx = HDR[HDR.index("void dx_unit("):HDR.index("// A consumer warpgroup over its items")]
    layers = [(eval(m.group(1), {}, CONST), int(m.group(2)))
              for m in re.finditer(r"\blayer<(\w+), (\d+), \d+>\(", dx)]
    assert layers == [(n, k // 64) for _, k, n in K.WT_LAYOUT]


@pytest.mark.parametrize("kx", [64, 128])
def test_dw_products_cover_every_matrix_once(kx):
    """launch_pass's dW list: each product's X and gY widths are its
    matrix's K and N, and the products tile `w_layout(kx)` below WA
    exactly, at both encoding extents (`O` is `w_off(·, kx)`)."""
    lp = HDR[HDR.index("int launch_pass("):]
    prods = re.findall(r"\{B\((?:SMALL \? WS_H4 : )?(WS_\w+)\), B\((WS_\w+)\), (\w+), (\w+), ([\w +*()]+)\}", lp)
    assert len(prods) == 11 and prods[-1][0] == "WS_H4" and prods[-1][1] == "WS_GH5"
    assert "auto O = [&](int off) { return w_off(off, kx); };" in lp and "const int kx = ws.kx;" in lp
    widths = dict(("WS_" + n.upper(), w) for n, w in T.ws_buffers(kx))
    offs = K.w_offsets(kx)
    env = dict(CONST, kx=kx, O=lambda name: offs[name])
    covered = np.zeros(offs["WA"], np.int32)
    for x, g, kd, nd, off in prods:
        kdim, ndim = eval(kd, {}, env), eval(nd, {}, env)
        assert widths[x] == kdim and widths[g] == ndim, (x, g)
        o = eval(re.sub(r"W_OFF_(\w+)", r"'\1'", off), {}, env)
        covered[o:o + kdim * ndim] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("n_freq", [4, 10])
@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_backward_operands_gather_equals_packing_then_images(small, n_freq):
    """K1's and K3b's weight images, gathered straight from the bundle in
    one index (`_backward_weight_gather`, cached per band count), equal
    packing the buffers and imaging each matrix, at any band count; the
    transposed trunk leads the one buffer, so the forward weights start on
    a 1024-byte boundary of it."""
    g = torch.Generator().manual_seed(n_freq + 10 * small)
    n_enc = 6 * n_freq
    wn, bn = K.bundle_names(small)
    shapes = K._matrix_shapes(n_enc)
    widths = {"ba": 1, "brgb": 3, "bd0": K.DIR_HIDDEN, "bd1": K.DIR_HIDDEN, "bd2": K.DIR_HIDDEN}
    bundle = ([torch.randn(1, K.HIDDEN, generator=g), torch.randn(1, K.HIDDEN, generator=g),
               torch.randn(4, K.DIR_HIDDEN, generator=g)]
              + [torch.randn(*shapes[n], generator=g) for n in wn]
              + [torch.randn(1, widths.get(n, K.HIDDEN), generator=g) for n in bn])
    _, wimg, fbuf, wtimg = K._kernel_operands(bundle, 4, torch.device("cpu"), n_freq, True, small,
                                              transposed=True)
    W = dict(zip(wn, bundle[3:3 + len(wn)]))
    wplain, fplain = K.pack_kernel_operands(
        bundle[0].reshape(-1), bundle[1].reshape(-1),
        dict(W, **{n: b.reshape(-1) for n, b in zip(bn, bundle[3 + len(wn):])}),
        K._device_bands(n_freq, True, torch.device("cpu")))
    wt = K.pack_transposed_weights(W)
    wt_want = torch.cat([K.sm90_chunk_image(wt[K.WT_OFFSETS[n]:K.WT_OFFSETS[n] + k * c]
                                            .reshape(k, c)) for n, k, c in K.WT_LAYOUT])
    assert torch.equal(_bits(wimg), _bits(K.pack_sm90_chunks(wplain)))
    assert torch.equal(_bits(wtimg), _bits(wt_want))
    assert torch.equal(fbuf, fplain)
    gap = (wimg.data_ptr() - wtimg.data_ptr())
    assert gap == 2 * K.WT_OFFSETS["TOTAL"] and gap % 1024 == 0


def _chip_smoke():
    import importlib.util

    path = pathlib.Path(K.__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_launch_split_covers_the_pass(small):
    """`k1_launch_split`: the kernels it names are the pass's launches in
    the sources, their operations add up to the pass's (chip_smoke's
    `paper_flop_per_sample`), and a row reads its time against the
    operations bound, the workspace bytes as a floor beside it."""
    from nerface_tpu_torch.tools.perf import k1_launch_split as KS

    src = HDR + DW + (CSRC / "grad_tile.cuh").read_text()
    globals_ = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(", src))
    for k3b in (False, True):
        bounds = KS.launch_bounds(2048, 64, small, k3b)
        assert set(bounds) <= globals_, set(bounds) - globals_
        flop = sum(b[0] for b in bounds.values())
        assert flop == pytest.approx(2048 * 64 * _chip_smoke().paper_flop_per_sample(small, True),
                                     rel=1e-3)
    flop, nbytes, part = KS.launch_bounds(2048, 128, small)["train_pass_kernel"]
    row = KS.launch_row(2.0, 1, flop, nbytes, part)
    assert row["ops_bound_ms"] == pytest.approx(flop / KS.PEAK_BF16_FLOPS * 1e3)
    assert row["byte_floor_ms"] == pytest.approx(nbytes / KS.PEAK_BYTES_S * 1e3)
    assert row["of_ops_bound"] == pytest.approx(row["ops_bound_ms"] / 2.0)
    assert "operations bound" in KS.row_text("train_pass_kernel", row)


# -- the unit schedule at any S: rows, the encoder, d_dir's pieces ------------------

LAYOUT_S = [1, 5, 16, 24, 40, 96, 128, 192, 256]


@pytest.mark.parametrize("S", LAYOUT_S + [32, 64])
@pytest.mark.parametrize("R", [2085, 2048, 1111, 77])
def test_dead_warpgroups_read_inside_the_workspace(R, S):
    """`consume`'s unit indices (the lines held by
    `test_runtime_schedule_formulas_are_the_sources`), replayed over every
    pair of a pass: a warpgroup past the last ray (the last pair of a
    ragged pass) computes on the first unit's images, so every unit whose
    activation and cotangent images a consumer loads lies inside the
    workspace (`pass_units` live units): a read past it can fault on the
    card (K3b's small-model pass at 2085 × 64 did)."""
    rays, units = K.unit_layout(S)
    n_items = -(-R // rays)
    pass_units = n_items * units
    for pair in range(-(-n_items // 2)):
        for wg in range(2):
            item = 2 * pair + wg  # g.item(pair, 0, wg)
            unit0 = item * units if item < n_items else 0
            assert all(unit0 + u < pass_units for u in range(units)), (R, S, item)


def test_runtime_schedule_formulas_are_the_sources():
    """The replay below transcribes these lines of paper_train.cuh: the
    consumers' items and rows, the encoder's valid rows (wgmma_chain.cuh's
    `encode_task`), the middle's zeroed padding, and d_dir's pieces (a
    warp's first / last ray, the interior rays written directly, the column
    pass carrying a ray's sum across units); a row's ray is `ray_of`'s
    multiply and shift, which `test_ray_of_is_row_over_s` holds exact."""
    wc = (CSRC / "wgmma_chain.cuh").read_text()
    assert "const int q = g.ray_of(row);  // the item's ray of the row" in wc
    assert "const int ray = ray0 + q;" in wc
    assert "const int n_cols = row < g.rows() && ray < a.n_rays ? 3 + 6 * a.n_freqs : 0;" in wc
    assert "const float zz = a.z[(size_t)ray * g.samples() + (row - q * g.samples())];" in wc
    assert "const int item = g.item(pair, 0, wg);" in HDR
    assert "const int ray0 = item * g.wg_rays();" in HDR
    assert "const int unit0 = live ? item * g.units() : 0;" in HDR
    assert "forward_unit<SF, SMALL>(sm, a, ring, acc, act, wg, u, unit0 + u, ray0, live, units);" in HDR
    assert "dx_unit<SF, SMALL>(sm, a, ring, acc, act, wg, u, unit0 + u, ray0, part, live, dx_units);" in HDR
    assert "const int row = u * 64 + frag_row(), rows = g.rows();" in HDR
    assert "const int ray_a = row < rows ? ray0 + g.ray_of(row) : a.n_rays;" in HDR
    assert "const int ray_b = row + 8 < rows ? ray0 + g.ray_of(row + 8) : a.n_rays;" in HDR
    assert "const int w0 = u * 64 + 16 * w, rows = l.rows();" in HDR
    assert "fa = w0 < rows ? l.ray_of(w0) : -1;" in HDR
    assert "fb = w0 < rows ? l.ray_of(min(w0 + 15, rows - 1)) : -1;" in HDR
    assert "if (!live || wr.fa == wr.fb) return;" in HDR
    assert "const int ra = ia < rows ? l.ray_of(ia) : -1, rb = ib < rows ? l.ray_of(ib) : -1;" in HDR
    assert "float* slot = slots[j == wr.fa ? 0 : 1];" in HDR
    assert "} else if (ray0 + j < n_rays) {" in HDR
    assert "const float total = cur * S < u * 64 ? dacc[t] + sum : sum;" in HDR
    assert "if ((cur + 1) * S > u * 64 + 64) {" in HDR
    assert "for (int slot = 0; slot < (wr.fb > wr.fa ? 2 : 1); ++slot) {" in HDR
    assert "if (wr.fa >= 0 && wr.fa == wr.fb) {" in HDR
    k1 = (CSRC / "fused_train_pass.cu").read_text()
    assert "for (int r = l.rows() + (threadIdx.x & 127); r < l.units() * 64; r += 128) {" in k1
    assert "for (int r = lw; r < l.wg_rays(); r += 4) {" in k1
    # the layout classes: S = 64 and 128 as constants, one ray over S / 64 units
    wc = (CSRC / "wgmma_chain.cuh").read_text()
    for line in ("int samples() const { return SF ? SF : l.S; }", "int wg_rays() const { return SF ? 1 : l.rays; }",
                 "int units() const { return SF ? SF / 64 : l.units; }",
                 "int rows() const { return SF ? SF : l.rays * l.S; }",
                 "int ray_of(int row) const { return SF ? row / SF : l.ray_of(row); }"):
        assert line in wc, line
    assert all(K.unit_layout(S) == (1, S // 64) for S in (64, 128))
    mma = (CSRC / "mma_tile.cuh").read_text()
    assert "return FN<64, false>::run(args...);" in mma and "return FN<128, true>::run(args...);" in mma


def _replay_items(R, S):
    """Every thread row of every unit of a pass, as the consumers walk them:
    (item, unit u, row of the item, its ray or R for a padding row)."""
    rays, units = K.unit_layout(S)
    n_items = -(-R // rays)
    pairs = -(-n_items // 2)
    rows = rays * S
    r0 = ((np.arange(128) >> 5) & 3) * 16 + ((np.arange(128) & 31) >> 2)
    out = []
    for pair in range(pairs):
        for wg in range(2):
            item = 2 * pair + wg
            for u in range(units):
                for h in range(2):
                    row = u * 64 + r0 + 8 * h
                    ray = np.where(row < rows, item * rays + row // S, R)
                    out += [(item, u, int(i), int(r)) for i, r in zip(row, ray)]
    return out, n_items, units


@pytest.mark.parametrize("S", LAYOUT_S)
@pytest.mark.parametrize("R", [1, 7, 77, 264, 1001])
def test_unit_schedule_covers_every_sample_row_once(R, S):
    """Replayed row by row, the consumers' units give every (ray, sample)
    of the pass exactly one accumulator row (held by a quad's four lanes,
    each its own column pairs), the encoder writes the same rows' points
    and zeros elsewhere, padding rows are marked invalid (ray = R, no dir_c,
    no point) and the workspace units run 0 .. items·units − 1."""
    seen, n_items, units = _replay_items(R, S)
    rays, _ = K.unit_layout(S)
    real = {}
    for item, u, row, ray in seen:
        if ray < R:
            assert ray == item * rays + row // S and row < rays * S
            real[(ray, row % S)] = real.get((ray, row % S), 0) + 1
        else:
            assert row >= rays * S or item * rays + row // S >= R
    assert sorted(real) == [(r, s) for r in range(R) for s in range(S)]
    assert set(real.values()) == {4}  # a quad's four lanes share rows r0 and r0 + 8
    # the encoder (`encode_task`): unit u's row r is the item's row u·64 + r
    encoded = []
    for item, u in {(i, u) for i, u, *_ in seen}:
        row = u * 64 + np.arange(64)
        ray = item * rays + row // S
        ok = (row < rays * S) & (ray < R)
        encoded += list(zip(ray[ok], row[ok] % S))
    assert sorted(encoded) == sorted(real)
    assert {(i, u) for i, u, *_ in seen} == {(i, u) for i in range(-(-n_items // 2) * 2)
                                             for u in range(units)}
    assert T.workspace_geometry(R, S)[0] == n_items * units


def _replay_d_dir(R, S, values):
    """d_dir as dx_unit assembles it (`DirPieces`, then `dir_pieces`),
    replayed on one column: `values` (R·S,) the rows' gx0 entries."""
    rays, units = K.unit_layout(S)
    rows = rays * S
    n_items = -(-R // rays)
    d_dir = np.full(R, np.nan)

    def warp_rays(u, w):
        w0 = u * 64 + 16 * w
        return (w0 // S, min(w0 + 15, rows - 1) // S) if w0 < rows else (-1, -1)

    for item in range(n_items):
        ray0 = item * rays
        val = np.zeros(units * 64)
        n_real = min(rows, (R - ray0) * S)
        val[:n_real] = values[ray0 * S:ray0 * S + n_real]
        dacc = None
        for u in range(units):
            slots = {}
            for w in range(4):
                fa, fb = warp_rays(u, w)
                if fa < 0:
                    continue
                idx = u * 64 + 16 * w + np.arange(16)
                ray_of = np.where(idx < rows, idx // S, -1)
                for j in range(fa, fb + 1):
                    s = val[idx][ray_of == j].sum()
                    if j in (fa, fb):
                        slots[(w, 0 if j == fa else 1)] = s
                    elif ray0 + j < R:
                        assert np.isnan(d_dir[ray0 + j])
                        d_dir[ray0 + j] = s
            cur, acc = -1, 0.0
            pieces = []
            for w in range(4):
                fa, fb = warp_rays(u, w)
                if fa < 0:
                    break
                for slot in range(2 if fb > fa else 1):
                    pieces.append((fb if slot else fa, slots[(w, slot)]))
            pieces.append((None, 0.0))
            for j, v in pieces:
                if j == cur:
                    acc += v
                    continue
                if cur >= 0:
                    total = dacc + acc if cur * S < u * 64 else acc
                    if (cur + 1) * S > u * 64 + 64:
                        dacc = total
                    elif ray0 + cur < R:
                        assert np.isnan(d_dir[ray0 + cur])
                        d_dir[ray0 + cur] = total
                cur, acc = (j if j is not None else -1), v
    return d_dir


@pytest.mark.parametrize("S", LAYOUT_S)
@pytest.mark.parametrize("R", [1, 7, 77, 264])
def test_d_dir_pieces_sum_each_ray_once(R, S):
    """d_dir's assembly, replayed on integer rows: every ray gets the sum
    of exactly its own rows, written once, whether its rows lie in one
    warp, across warps, across units, or inside a warp between two others."""
    values = np.random.RandomState(S).randint(1, 1000, size=R * S).astype(np.float64)
    got = _replay_d_dir(R, S, values)
    assert np.array_equal(got, values.reshape(R, S).sum(1))


def test_ray_of_is_row_over_s():
    """`UnitLayout::ray_of`, (row · ⌈2^24 / S⌉) >> 24 as the header writes
    it, is row // S for every item row (below ITEM_ROWS) at every S of the
    kernels, and its product stays within 32 bits."""
    wc = (CSRC / "wgmma_chain.cuh").read_text()
    assert "return UnitLayout{s, rays, units, ((1u << 24) + (uint32_t)s - 1u) / (uint32_t)s, xc};" in wc
    assert "int ray_of(int row) const { return (int)(((uint32_t)row * div) >> 24); }" in wc
    S = np.arange(1, K.MAX_SAMPLES + 1, dtype=np.uint64)[:, None]
    row = np.arange(K.ITEM_ROWS, dtype=np.uint64)[None, :]
    div = ((1 << 24) + S - 1) // S
    assert int((row * div).max()) < 2 ** 32
    assert np.array_equal((row * div) >> 24, row // S)
