"""PyTorch port, K2's weight layout for wgmma (`fused_mlp.pack_sm90_chunks`,
`PackedPaperWeights.wbuf_sm90`): the chunk images hold every matrix bit for
bit, for the paper and the smaller (`small`) model; the chunk sequence, the
chunk size and the swizzle agree with `csrc/fused_paper_render.cu` and
`csrc/wgmma_tile.cuh`; and the wrapper on CPU tensors with packed weights is
still the plain version. Needs no JAX: the layout is the port's own. The
kernel that reads the images is held to the plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` `[kernel]`)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from nerface_tpu_torch.models.nerf_models import (
    ConditionalBlendshapePaperNeRFModel,
    ConditionalBlendshapePaperSmallerNeRFModel,
)
from nerface_tpu_torch.ops.kernels import fused_mlp as K

torch.set_num_threads(1)

CSRC = pathlib.Path(K.__file__).resolve().parents[2] / "csrc"
CU_CONSTANTS = {"K_XIN": K.K_XIN, "HIDDEN": K.HIDDEN, "DIR_HIDDEN": K.DIR_HIDDEN}


def unpack_chunk_image(img: torch.Tensor, k_rows: int, n: int) -> torch.Tensor:
    """The (k_rows, n) bf16 matrix of a chunk image, read element by element
    where the kernel's B operand has it: chunk k // 64, byte n·128 +
    (((k % 64) // 8) ^ (n % 8))·16 + (k % 8)·2 (an index computation of its
    own, not the packer's gather)."""
    flat = img.view(torch.int16).numpy()
    k = np.arange(k_rows)[:, None]
    col = np.arange(n)[None, :]
    kk = k % 64
    off = (k // 64) * (64 * n) + col * 64 + ((kk // 8) ^ (col % 8)) * 8 + kk % 8
    return torch.from_numpy(flat[off].copy()).view(torch.bfloat16)


def _state(small, seed):
    cls = ConditionalBlendshapePaperSmallerNeRFModel if small else ConditionalBlendshapePaperNeRFModel
    m = cls(num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False,
            generator=torch.Generator().manual_seed(seed))
    return m.state_dict()


def _bits(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_chunk_images_hold_every_matrix_bit_for_bit(small):
    params = _state(small, 4)
    packed = K.pack_paper_weights(params)
    W = K._layout_matrices(params, 63, 108, small)
    freqs = torch.ones(10)
    wbuf, _ = K.pack_kernel_operands(params["layers_xyz.0.bias"], params["layers_xyz.3.bias"], W,
                                     freqs)
    zero = torch.zeros(1, K.HIDDEN)
    plain = {
        "W0": torch.cat([W["w0a"], W["w0b"], zero]),
        "W3": torch.cat([W["w3xa"], W["w3xb"], zero, W["w3h"]]),
        "W5": W["w5"] if not small else torch.zeros(K.HIDDEN, K.HIDDEN),
        **{n.upper(): W[n] for n in ("w1", "w2", "w4", "wf", "wd0", "wd1", "wd2", "wa", "wrgb")},
    }
    img = packed.wbuf_sm90
    assert img.dtype == torch.bfloat16 and img.numel() == K.W_OFFSETS["TOTAL"]
    for name, k, n in K.W_LAYOUT:
        o = K.W_OFFSETS[name]
        part = img[o:o + k * n]
        m = unpack_chunk_image(part, k, n) if name in K.SM90_CHUNKED else part.reshape(k, n)
        assert torch.equal(_bits(m), _bits(wbuf[o:o + k * n].reshape(k, n))), name
        assert torch.equal(_bits(m), _bits(plain[name].to(torch.bfloat16))), name
    if small:
        o = K.W_OFFSETS["W5"]
        assert not img[o:o + K.HIDDEN * K.HIDDEN].float().any()


def _cu_value(expr, kx=K.K_XIN):
    return eval(expr, {}, dict(CU_CONSTANTS, kx=kx))


def test_chunk_sequence_matches_cuda_source():
    """The producer streams, and the consumers multiply, the chunked
    matrices of W_LAYOUT in its order, 64 K rows a chunk (of `w_layout(kx)`
    at every encoding extent: the producer's K of W0 and W3 is kx, its
    offsets `w_off`, through the ring's stages at kx); the smaller model
    skips W5 on both sides. Both sequences live in paper_chain.cuh, which
    K2 (and K3f) run."""
    assert '#include "paper_chain.cuh"' in (CSRC / "fused_paper_render.cu").read_text()
    src = (CSRC / "paper_chain.cuh").read_text()
    hdr = (CSRC / "wgmma_tile.cuh").read_text()
    assert re.search(rf"constexpr int KCH = {K.SM90_KCH};", hdr)
    assert re.search(rf"constexpr int ROW_BYTES = {2 * K.SM90_KCH};", hdr)
    want = [(name, k, n) for name, k, n in K.W_LAYOUT if name in K.SM90_CHUNKED]
    produce = src[src.index("void paper_produce("):src.index("void paper_feed(")]
    assert "W + w_off(off, kx), k, n, rank, stages);" in produce
    assert "const int stages = ring_stages<PAPER_RING>(kx / K_XIN);" in produce
    for kx in (K.K_XIN, K.K_XIN_WIDE, K.K_XIN_XL):
        loads = [(m.group(1), _cu_value(m.group(2), kx), _cu_value(m.group(3), kx))
                 for m in re.finditer(r"load\(W_OFF_(\w+), ([\w +]+), (\w+)\);", produce)]
        assert loads == [(name, k, n) for name, k, n in K.w_layout(kx) if name in K.SM90_CHUNKED]
    assert re.search(r"if \(!SMALL\) load\(W_OFF_W5,", produce)
    body = src[src.index("void paper_unit("):]
    layers = [(_cu_value(m.group(1)), int(m.group(2)))
              for m in re.finditer(r"\bpaper_layer<(\w+), (\d+), \d+, CTAS>\(", body)]
    assert layers == [(n, k // K.SM90_KCH) for _, k, n in want]
    w5 = body.index("if constexpr (!SMALL)")
    assert body.index("paper_layer<HIDDEN, 4, 0, CTAS>", w5) < body.index("F_OFF_B5", w5)


def test_swizzle_matches_header():
    """`sw128` in the header, evaluated here, is the byte offset the packer
    writes each element to."""
    hdr = (CSRC / "wgmma_tile.cuh").read_text()
    expr = re.search(r"int sw128\(int row, int col\) \{\s*return (.+?);", hdr, re.S).group(1)
    m = torch.arange(64 * 16, dtype=torch.int16).reshape(64, 16).to(torch.bfloat16)
    flat = _bits(K.sm90_chunk_image(m)).numpy()
    for row in range(16):
        for col in range(64):
            off = eval(expr, {}, {"row": row, "col": col, "ROW_BYTES": 128})
            assert off % 2 == 0 and flat[off // 2] == _bits(m)[col, row], (row, col)


@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_wrapper_on_cpu_with_packed_weights_is_the_plain_version(small):
    params = _state(small, 5)
    rng = np.random.RandomState(6)
    R, S = 4, 32
    ro = torch.from_numpy(rng.randn(R, 3).astype(np.float32) * 0.05 + np.float32([0, 0, 0.5]))
    rd = torch.from_numpy((rng.randn(R, 3) * [0.2, 0.2, 0.05] - [0, 0, 1]).astype(np.float32))
    z = torch.from_numpy(0.2 + np.cumsum(rng.rand(R, S).astype(np.float32) * (1.2 / S), -1))
    dc = torch.from_numpy(rng.randn(R, 128).astype(np.float32) * 0.3)
    cond = torch.from_numpy(rng.randn(108).astype(np.float32) * 0.2)
    bg = torch.from_numpy(rng.rand(R, 3).astype(np.float32))
    kw = dict(background=bg, out_weights=True, small=small)
    before = K.fused_paper_render.launches
    got = K.fused_paper_render(K.pack_paper_weights(params), ro, rd, z, dc, cond, **kw)
    ref = K.fused_paper_render_reference(params, ro, rd, z, dc, cond, **kw)
    assert K.fused_paper_render.launches == before
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_cluster_default_and_ablation_loader():
    """K2 builds as a 2-CTA cluster unless NERFACE_K2_CLUSTER says 1, and
    the cluster ablation's loader hands the wrapper the variant library
    only inside its `with` block."""
    from nerface_tpu_torch.ops.kernels import build
    from nerface_tpu_torch.tools.perf import k2_cluster_ablation as A

    src = (CSRC / "fused_paper_render.cu").read_text()
    assert re.search(r"#define NERFACE_K2_CLUSTER 2\n", src)
    assert "constexpr int CLUSTER = NERFACE_K2_CLUSTER;" in src
    assert A.VARIANTS["cluster2"] == () and A.VARIANTS["cluster1"] == ("NERFACE_K2_CLUSTER=1",)
    real, seen = build.load_library, []
    build.load_library = lambda name="fused_paper_render", defines=(): seen.append((name, defines))
    try:
        with A.variant(A.VARIANTS["cluster1"]):
            build.load_library("fused_paper_render")
            build.load_library("probes")
        build.load_library("fused_paper_render")
    finally:
        build.load_library = real
    assert seen == [("fused_paper_render", ("NERFACE_K2_CLUSTER=1",)), ("probes", ()),
                    ("fused_paper_render", ())]


# -- the unit schedule at any S: K2's items, rows and compositing ------------------

@pytest.mark.parametrize("S", [1, 5, 16, 24, 40, 96, 128, 192, 256])
@pytest.mark.parametrize("R", [1, 9, 77, 530, 1001])
def test_k2_schedule_composites_every_ray_once(R, S):
    """K2's cluster rounds (2 CTAs × 2 consumer warpgroups a round), replayed
    row by row: every (ray, sample) is one accumulator row of the item that
    holds the ray, padding rows carry ray n_rays; each ray is composited once,
    by warp r % 4 of its warpgroup, from its item's rows r·S .. r·S + S − 1,
    every sample by one lane (samples [l·spl, (l+1)·spl), spl = ⌈S / 32⌉),
    and its background weight by the lane of sample S − 1."""
    src = (CSRC / "fused_paper_render.cu").read_text()
    chain = (CSRC / "paper_chain.cuh").read_text()
    assert "const int ray0 = g.item(pair, (int)rank, wg) * g.wg_rays();" in src
    assert "const int row = u * 64 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);" in chain
    assert "const int ray_a = row < rows ? ray0 + g.ray_of(row) : n_rays;" in chain
    assert ("for (int r = lw; r < g.wg_rays() && ray0 + r < a.n_rays; r += 4)\n"
            "      composite_ray(sigma, rgb, a, r * g.samples(), lane, ray0 + r, g.samples());") in src
    assert "const int spl = (S + 31) >> 5;" in src
    assert "const int s = lane * spl + q;" in src and "if (q >= spl || s >= S) continue;" in src
    assert "if (s == S - 1) a.bgw[ray] = w;" in src
    rays, units = K.unit_layout(S)
    rows = rays * S
    rounds = -(-R // (2 * 2 * rays))  # UnitSchedule<CLUSTER>::rounds, CLUSTER = 2
    spl = -(-S // 32)
    r0 = ((np.arange(128) >> 5) & 3) * 16 + ((np.arange(128) & 31) >> 2)
    held, composited, owned = {}, {}, {}
    for rnd in range(rounds):
        for rank in range(2):
            for wg in range(2):
                item = (rnd * 2 + rank) * 2 + wg
                ray0 = item * rays
                for u in range(units):
                    for h in range(2):
                        row = u * 64 + r0 + 8 * h
                        ray = np.where(row < rows, ray0 + row // S, R)
                        for i, r in zip(row, ray):
                            if r < R:
                                held[(int(r), int(i % S))] = (item, int(i))
                for lw in range(4):
                    r = lw
                    while r < rays and ray0 + r < R:
                        assert ray0 + r not in composited
                        composited[ray0 + r] = (item, lw)
                        for lane in range(32):
                            for q in range(spl):
                                s = lane * spl + q
                                if s < S:
                                    assert held[(ray0 + r, s)] == (item, r * S + s)
                                    owned[(ray0 + r, s)] = owned.get((ray0 + r, s), 0) + 1
                        r += 4
    assert sorted(held) == [(r, s) for r in range(R) for s in range(S)]
    assert sorted(composited) == list(range(R))
    assert set(owned.values()) == {1} and len(owned) == R * S
    assert (S - 1) // spl < 32  # sample S − 1 has a lane, which writes bgw
