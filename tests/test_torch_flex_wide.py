"""PyTorch port, K4 (`ops/kernels/fused_flex.py`, `csrc/fused_flex.cu`) at
hidden width 768 and 1024, the sliced kernels (`sliced_chain_kernel`,
`sliced_dx_kernel`: each layer's columns in slices of 256).

* The plain forward and backward against the JAX package's Pallas kernels
  `_fused_flex_fwd` / `_fused_flex_bwd` in interpret mode (R = 8, S = 16,
  `params_from_jax` weights, numpy inputs from a seed) at h = 768 and 1024,
  n = 0 and 3 hidden layers, two classes, with
  tests/test_torch_flex_width.py's limits: raw [rgb, σ] within
  2e-3·max|JAX|, each gradient (d_v0 and d_dir included) within
  0.08·max|JAX| and 0.04·‖JAX‖ (its `_grad_readings`: the yardstick from
  FLEX_TC_DEPTH hidden layers on, none here). Readings (these draws, `-s`
  prints them): raw ≤ 1.3e-3·max, gradients ≤ 5.4e-2·max and
  ≤ 7.2e-3·‖·‖.
* The slice: `render_rays` of a 1024-wide
  `ConditionalBlendshapeLearnableCodeNeRFModel` (8 rays, 8 + 8 samples,
  JAX's draws injected) against JAX `render_rays` on the same weights: f32
  within 1e-4, bf16 through K4's plain version against JAX's bf16 pass
  through its Pallas kernel within 2e-3.
* Dispatch: `flex_fused_eligible` on the card against JAX's
  `flex_fused_eligible` and its tile rule over h ∈ {256, 512, 768, 1024,
  1280, 2048}: the two agree up to MAX_WIDTH = 1024; past it JAX runs its
  kernel and the port the plain path.
* Layouts at h = 768 / 1024, read from the source: `Offsets<h>` and
  `flex_w_off` against `w_offsets` / `f_offsets` / `wt_offsets` (pinned),
  the workspace carve against `workspace_layout`, dW's products (WD0's 384
  columns at h = 768 as 256 + 128) and segments, `slice_mask`'s words
  against `mask_bytes`, each sliced kernel's shared memory struct summed
  field by field against 232,448 bytes (and the sizes the card reported),
  the entry points' refusal past MAX_WIDTH and the builds that hold each
  width (`build.flex_sliced_defines`, `_lib`).
"""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.ops.kernels import build
from nerface_tpu_torch.ops.kernels import fused_flex as F
from nerface_tpu_torch.render.pipeline import EncodeSpec

from test_torch_flex_bands import _cuda_offsets, _flex_w_off
from test_torch_flex_width import _carve_replay, _case, _grad_readings, _jax_rule, _render_pair

torch.set_num_threads(1)

CSRC = pathlib.Path(F.__file__).resolve().parents[2] / "csrc"
CU = (CSRC / "fused_flex.cu").read_text()
CODE = re.sub(r"//.*", "", CU)
SLICED = (768, 1024)
CLASSES = ["ConditionalBlendshapeLearnableCodeNeRFModel", "FlexibleNeRFModel"]


# -- (a) the plain versions against the TPU kernels --------------------------------

@pytest.mark.parametrize("name", CLASSES)
@pytest.mark.parametrize("h,n", [(h, n) for h in SLICED for n in (0, 3)],
                         ids=[f"h{h}_n{n}" for h in SLICED for n in (0, 3)])
def test_plain_matches_jax_kernel_at_sliced_width(h, n, name):
    out, jgrads, targs, g = _case(h, n, name)
    got = F.fused_flex_forward_reference(*targs, n)
    assert got.shape == out.shape == (8, 16, 4)
    raw = np.abs(got.numpy() - out).max() / np.abs(out).max()
    assert raw <= 2e-3, raw
    rows, max_limit, yard = _grad_readings(h, n, targs, g, jgrads)
    assert yard == 0.0 and max_limit == 0.08
    for k, e_max, e_norm in rows:
        assert e_max <= max_limit + 1e-9, (k, e_max, max_limit)
        assert e_norm <= 0.04 + 1e-9, (k, e_norm)
    print(f"h={h} n={n} {name}: raw {raw:.2e}·max, gradients ≤ {max(r[1] for r in rows):.2e}·max, "
          f"{max(r[2] for r in rows):.2e}·norm")


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16_k4"])
def test_render_rays_at_1024_matches_jax(dtype, monkeypatch):
    from nerface_tpu_torch.render import pipeline

    calls = []
    real = pipeline.fused_flex_mlp
    monkeypatch.setattr(pipeline, "fused_flex_mlp", lambda *a, **k: calls.append(a[4].shape) or real(*a, **k))
    got, ref = _render_pair(dtype, h=1024)
    # bf16: both passes through K4 (its plain version on CPU tensors), dir_contrib 512 wide
    assert calls == ([] if dtype is None else [(8, 512), (8, 512)])
    atol = 1e-4 if dtype is None else 2e-3
    for k in ("rgb_coarse", "acc_coarse", "rgb_fine", "acc_fine", "bg_weight"):
        a, b = got[k].float().numpy(), np.asarray(ref[k], np.float32)
        assert a.shape == b.shape and np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)
    for k in ("depth_coarse", "depth_fine"):
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(ref[k], np.float32),
                                   atol=atol * 0.8, rtol=0, err_msg=k)


# -- (b) the dispatch ------------------------------------------------------------

@pytest.mark.parametrize("h", [256, 512, 768, 1024, 1280, 2048])
def test_dispatch_matches_jax_rule_up_to_the_limit(h):
    enc, jenc = EncodeSpec(10, True, True), JaxEncodeSpec(10, True, True)
    pe_dir = torch.zeros(4, 24)
    for n in (0, 3, 8):
        kw = dict(num_layers=n + 1, hidden_size=h, skip_connect_every=n + 2, num_encoding_fn_xyz=10,
                  num_encoding_fn_dir=4, include_input_dir=False)
        name = "ConditionalBlendshapeLearnableCodeNeRFModel"
        jm, tm = JAX_MODELS[name](**kw), MODELS[name](**kw)
        for n_rays, S in ((2048, 64), (2048, 1024), (2072, 40), (2047, 64)):
            jax_ok = _jax_rule(jm, jenc, jnp.zeros((4, 24)), n_rays)
            got = F.flex_fused_eligible(tm, enc, pe_dir, n_rays, S, "cuda")
            assert got == (jax_ok and h <= F.MAX_WIDTH), (h, n, n_rays, S)
            assert F.flex_fused_eligible(tm, enc, pe_dir, n_rays, S, "cpu") == (h <= F.MAX_WIDTH)
    assert h in F.WIDTHS or h > F.MAX_WIDTH


# -- (c) the layout ----------------------------------------------------------------

PINNED_W = {768: {"W1": 0, "WF": 49152, "WD0": 638976, "WH0": 933888, "WH1": 1523712, "WH2": 2113536,
                  "WA": 2703360, "WRGB": 2704128, "TOTAL": 2705280},
            1024: {"W1": 0, "WF": 65536, "WD0": 1114112, "WH0": 1638400, "WH1": 2686976, "WH2": 3735552,
                   "WA": 4784128, "WRGB": 4785152, "TOTAL": 4786688}}
PINNED_F = {768: {"V0": 0, "BF": 768, "BD0": 1536, "BA": 1920, "BRGB": 1921, "FREQS": 1924, "BH0": 1944,
                  "BH1": 2712, "BH2": 3480, "TOTAL": 4248},
            1024: {"V0": 0, "BF": 1024, "BD0": 2048, "BA": 2560, "BRGB": 2561, "FREQS": 2564, "BH0": 2584,
                   "BH1": 3608, "BH2": 4632, "TOTAL": 5656}}


@pytest.mark.parametrize("h", SLICED)
def test_sliced_offsets_are_the_sources(h):
    """`w_offsets` / `f_offsets` / `wt_offsets` at h = 768 / 1024 against
    `Offsets<h>` and `flex_w_off` read from the source, at kx = 64 and 128
    and n = 0 / 3 / 12; the 10-band offsets pinned."""
    c = _cuda_offsets(h)
    w_off = _flex_w_off(h)
    dh = h // 2
    for kx in (64, 128):
        for n in (0, 3, 12):
            wh = w_off(c["FW_OFF_WH"], kx)
            want = {"W1": w_off(c["FW_OFF_W1"], kx), "WF": w_off(c["FW_OFF_WF"], kx),
                    "WD0": w_off(c["FW_OFF_WD0"], kx), "WA": wh + n * h * h, "WRGB": wh + n * h * h + h,
                    "TOTAL": wh + n * h * h + h + 3 * dh}
            want.update({f"WH{i}": wh + i * h * h for i in range(n)})
            assert F.w_offsets(n, h, kx) == want, (kx, n)
            want_f = {k: c[f"FF_OFF_{k}"] for k in ("V0", "BF", "BD0", "BA", "BRGB", "FREQS")}
            want_f.update({f"BH{i}": c["FF_OFF_BH"] + i * h for i in range(n)})
            want_f["TOTAL"] = c["FF_OFF_BH"] + n * h
            assert F.f_offsets(n, h) == want_f
            want_t = {"WD0T": c["FT_OFF_WD0T"], "WFT": c["FT_OFF_WFT"], "TOTAL": c["FT_OFF_WHT"] + n * h * h}
            want_t.update({f"WHT{i}": c["FT_OFF_WHT"] + i * h * h for i in range(n)})
            assert F.wt_offsets(n, h) == want_t
    assert F.w_offsets(3, h) == PINNED_W[h] and F.f_offsets(3, h) == PINNED_F[h]
    assert "offsets_ok<768>() && offsets_ok<1024>()" in CODE


@pytest.mark.parametrize("R_,S_,n,h", [(2048, 64, 3, 768), (2072, 40, 3, 1024), (256, 1024, 3, 1024),
                                       (2085, 64, 8, 1024), (301, 200, 0, 768)])
def test_workspace_carve_at_sliced_width(R_, S_, n, h):
    for kx in (64, 128):
        offs, total = F.workspace_layout(R_, S_, n, h, kx)
        got, got_total = _carve_replay(R_, S_, n, h, kx)
        assert got_total == total
        for k, v in got.items():
            key = {"act0": "a0", "gpre0": "gpre0" if n else "ga0", "amask0": "amask1" if n else "warp_part"}.get(k, k)
            assert offs[key] == v, k


def test_workspace_sizes_at_1024():
    """≈ 23 KB a sample row at h = 1024, n = 3: 2048 rays × 128 samples
    take ≈ 6 GB, × 1024 samples ≈ 49 GB (so the card's S = 1024 case runs on
    256 rays); the grid is h = 512's, one item a CTA a round."""
    _, total = F.workspace_layout(2048, 128, 3, 1024)
    assert 22e3 < total / (2048 * 128) < 24e3 and 5.8e9 < total < 6.4e9
    assert 48e9 < F.workspace_layout(2048, 1024, 3, 1024)[1] < 50e9
    for R, S in ((2048, 64), (2085, 64), (256, 1024), (2072, 40)):
        assert F.flex_ctas(R, S, 1024) == F.flex_ctas(R, S, 768) == F.flex_ctas(R, S, 512)
        assert F.unit_schedule(R, S, 1024) == F.unit_schedule(R, S, 512)


def _dw_products_replay(n, h, kx):
    """`dw_products` in fused_flex.cu, replayed from the source: each
    `blocks(...)` call's (K, N) split by the source's block rule."""
    body = CODE[CODE.index("void dw_products("):CODE.index("int dw_segments_of(")]
    assert "const int nb = ndim > 256 ? 256 : ndim;" in body and "for (int c = 0; c < ndim; c += nb)" in body
    assert "kdim, ndim - c < nb ? ndim - c : nb, out_off + c, ndim," in " ".join(body.split())
    env = {"L": type("L", (), {"kx": kx, "h": h, "dh": h // 2, "n": n})}
    out = []
    for call in re.findall(r"blocks\(([^;]*)\);", body):
        kdim, ndim = (eval(x.strip(), {}, env) for x in call.split(", ")[2:4])
        count = n if "ws.act(i)" in call else 1
        for _ in range(count):
            nb = 256 if ndim > 256 else ndim
            out += [(kdim, ndim - c if ndim - c < nb else nb) for c in range(0, ndim, nb)]
    # the hidden layers come last in the source's order: W1, WF, WD0, WH_i
    return tuple(out)


@pytest.mark.parametrize("h", SLICED)
def test_dw_products_and_segments_at_sliced_width(h):
    wave = int(re.search(r"constexpr int DWG_WAVE = (\d+);", (CSRC / "wgmma_dw.cuh").read_text()).group(1))
    seg_units = int(re.search(r"constexpr int DW_SEG_UNITS = (\d+);", CU).group(1))
    launch = (CSRC / "wgmma_dw.cuh").read_text()
    assert "(mats[i].ndim != 128 && mats[i].ndim != 256)" in launch  # what dW takes: 128 or 256 columns
    for n in (0, 3, 12):
        for kx in (64, 128):
            prods = F.dw_products(n, h, kx)
            assert prods == _dw_products_replay(n, h, kx), (n, kx)
            assert all(c in (128, 256) for _, c in prods)
            # every column of every product once: W1 kx × h, WF h × h, WD0 h × h / 2, WH_i h × h
            assert sum(k * c for k, c in prods) == kx * h + h * h + h * h // 2 + n * h * h
            tasks = sum((k // 64 + 1) // 2 for k, _ in prods)
            for units in (1, 4096, 32768):
                want = max(1 if tasks >= wave else wave // tasks, -(-units // seg_units))
                assert F.dw_segments(n, h, kx, units) == want
    assert F.dw_products(0, 768)[-1] == (768, 128)  # WD0's last 128 columns


def test_slice_mask_words_are_mask_bytes():
    """`slice_mask`: per unit 2·H words (2 a thread of each of the h / 128
    column blocks), `Layout::mask_bytes` = `mask_bytes(h)`; block 2s + wg
    is warpgroup wg's share of slice s; the mask writer and reader take the
    same 128-column fragments."""
    body = re.search(r"uint32_t\* slice_mask\(uint32_t\* buf, int unit, int block\) \{\n(.*?)\n\}", CU, re.S).group(1)
    assert "buf + (size_t)unit * (2 * H) + ((size_t)block * 128 + (threadIdx.x & 127)) * 2" in body
    for h in SLICED:
        assert 2 * h * 4 == F.mask_bytes(h)
        assert h // 128 * 128 * 2 * 4 == F.mask_bytes(h)
    assert CODE.count("slice_mask<H>(ws.amask(i), unit, 2 * s + wg)") == 1
    assert CODE.count("slice_mask<H>(ws.fmask, unit, 2 * s + wg)") == 1
    assert CODE.count("slice_mask<H>(mask, unit, 2 * s + wg)") == 1


def _smem_bytes(struct, h):
    """The dynamic shared memory of `struct` (a sliced kernel's) at width h,
    its fields summed from the source with their alignment, the struct
    aligned to 1024 bytes, + the 1 KB alignment pad."""
    body = CU[CU.index(f"struct alignas(ATOM_BYTES) {struct} {{"):]
    body = body[:body.index("\n};")]
    ring = re.search(r"static constexpr int RING = H <= (\d+) \? (\d+) : (\d+);", CU)
    chain = (CSRC / "wgmma_chain.cuh").read_text()
    env = {"H": h, "RING": int(ring.group(2)) if h <= int(ring.group(1)) else int(ring.group(3)),
           "SSTAGE": eval(re.search(r"constexpr int SSTAGE = ([^;]+);", CU).group(1),
                          {"KCH": 64, "SLICE": int(re.search(r"constexpr int SLICE = (\d+);", CU).group(1))}),
           "XIN_BYTES": eval(re.search(r"constexpr int XIN_BYTES = ([^;]+);", chain).group(1), {"ROW_BYTES": 128}),
           "ROW_BYTES": 128, "CONSUMERS": 2, "DIR_HIDDEN": 128}
    off, align = 0, 1
    sizes = {"unsigned char": 1, "float": 4, "uint64_t": 8}
    fields = re.findall(r"^\s*(unsigned char|float|uint64_t) (\w+)((?:\[[^\]]+\])+);", body, re.M)
    assert len(fields) >= 8
    for typ, _, dims in fields:
        size = sizes[typ]
        count = math.prod(eval(d.replace("Sliced<H>::RING", "RING"), {}, env) for d in re.findall(r"\[([^\]]+)\]", dims))
        off = -(-off // size) * size + size * count
    return -(-off // 1024) * 1024 + 1024


def test_sliced_shared_memory_fits():
    """Each sliced kernel's shared memory, summed from its struct in the
    source: the ring (3 stages of 32 KB at h = 768, 2 at 1024), the h-wide
    exchange or cotangent image, the heads' f32 weights, within the
    232,448 bytes a CTA may take; the sizes the card's build reported
    (`nerface_fused_flex_shared_bytes`, NVIDIA H100 80GB HBM3)."""
    card = {("SlicedFwdSmem", 768): 224256, ("SlicedDxSmem", 768): 226304,
            ("SlicedFwdSmem", 1024): 227328, ("SlicedDxSmem", 1024): 229376}
    for (struct, h), want in card.items():
        got = _smem_bytes(struct, h)
        assert got == want and got <= 232448, (struct, h, got)
    assert "sizeof(SlicedFwdSmem<768>) + ATOM_BYTES <= 232448" in CODE
    assert "sizeof(SlicedDxSmem<768>) + ATOM_BYTES <= 232448" in CODE


def test_entry_points_refuse_past_the_limit():
    """Every C entry point checks `valid`, which admits the multiples of
    HIDDEN up to MAX_WIDTH (1024, `fused_flex.MAX_WIDTH`); h = 768 / 1024
    run only in the build of their own width (NERFACE_SLICED_WIDTH, with no
    layout class of the narrower widths), every other build refuses them;
    the wrappers load that build; on the CPU they refuse 1280."""
    valid = CODE[CODE.index("bool valid("):CODE.index("}", CODE.index("bool valid("))]
    assert "hidden >= HIDDEN && hidden <= MAX_WIDTH && hidden % HIDDEN == 0" in valid
    assert int(re.search(r"constexpr int MAX_WIDTH = (\d+);", CU).group(1)) == F.MAX_WIDTH == 1024
    assert F.WIDTHS == (256, 512, 768, 1024)
    for entry in ("nerface_fused_flex_fwd(", "nerface_fused_flex_bwd(", "nerface_fused_flex_workspace_bytes("):
        body = CODE[CODE.index(entry):]
        body = body[:body.index("\n}\n")]
        assert re.search(r"if \(!valid\(n_rays, n_samples, \w+, n_hidden, hidden\)\) return", body), entry
    assert "if (hidden > WIDE) return sliced_forward(hidden, fa, " in CODE
    assert "hidden > WIDE ? sliced_backward(hidden, fa, da, st)" in " ".join(CODE.split())
    for fn in ("sliced_forward", "sliced_backward"):
        body = CODE[CODE.index(f"int {fn}("):]
        body = body[:body.index("\n}\n")]
        assert "#if NERFACE_SLICED_WIDTH" in body and "if (hidden == NERFACE_SLICED_WIDTH) return" in body
        assert body.rstrip().endswith("return (int)cudaErrorInvalidValue;")
    assert "#define NERFACE_SLICED_WIDTH 0" in CU
    assert F.SLICED_WIDTHS == SLICED
    sliced = tuple(("NERFACE_SAMPLE_CLASSES=0", f"NERFACE_SLICED_WIDTH={h}") for h in SLICED)
    assert tuple(map(build.flex_sliced_defines, SLICED)) == sliced
    assert build.library_builds("fused_flex") == tuple(build.SAMPLE_CLASS_DEFINES.values()) + sliced
    assert build.library_builds("fused_train_pass") == tuple(build.SAMPLE_CLASS_DEFINES.values())
    assert build.library_builds("probes") == ((),)
    x = torch.zeros(8, 3)
    for h in (1280, 2048):
        with pytest.raises(ValueError, match="hidden width 256, 512, 768 or 1024"):
            F.fused_flex_forward((), x, x, torch.zeros(8, 16), torch.zeros(8, h // 2), torch.zeros(1, h), 3)


def test_wrappers_load_each_widths_build(monkeypatch):
    """`_lib` hands h = 768 / 1024 to their own build at any S and band
    count, h = 256 / 512 to the layout-class builds."""
    seen = []
    monkeypatch.setattr(build, "load_library", lambda name, defines=(): seen.append((name, defines)) or "lib")
    for h in SLICED:
        for S, L in ((64, 10), (128, 10), (24, 10), (64, 16)):
            assert F._lib(S, L, h) == "lib"
            assert seen[-1] == ("fused_flex", build.flex_sliced_defines(h))
    for h in (256, 512):
        F._lib(64, 10, h)
        assert seen[-1] == ("fused_flex", build.SAMPLE_CLASS_DEFINES["fixed"])
        F._lib(24, 10, h)
        assert seen[-1] == ("fused_flex", build.SAMPLE_CLASS_DEFINES["any"])
