"""PyTorch port: the paper-family kernels (K2, K3f, K3b, K1) past 256
samples a ray, up to `fused_mlp.MAX_SAMPLES` (1024).

Past ITEM_ROWS (256) rows an item is one ray in ⌈S / 64⌉ 64-row units (a
long item, `UnitLayout::of`); K2 composites it in segments of ITEM_ROWS
rows, carrying the log transmittance and the sums from one to the next;
K1 and K3b keep its rows' raw σ / rgb and their cotangents in a slab of
the workspace (`item_row_floats`), and K1's middle composites the ray
forward and back in segments (`composite_long`). K4 takes the same limit
(`fused_flex.MAX_SAMPLES` is `fused_mlp.MAX_SAMPLES`;
tests/test_torch_flex_long_rays.py holds it there).

* (a) Dispatch. Asked for the card (`device="cuda"`, no card needed),
  `_paper_kernels_take`, `_fused_render_eligible` and
  `fused_train_eligible` admit S up to 1024 where the JAX package's tile
  rule sends a pass to Pallas and refuse 1025; on the CPU the same domain.
  K4 takes the same limit on both devices. The wrappers raise past 1024,
  on the CPU too.
* (b) Layout. Every S in 257..1024 is one ray in ⌈S / 64⌉ units, as the
  header's rule gives it; `ray_of` is row // S on every row of such an
  item (and every row below ITEM_ROWS up to 1024); K2's segments, as its
  consumer loop calls `composite_segment`, and K1's `composite_long`
  segments take each sample once; the workspace's slab as `carve` sizes it
  (`fused_train.workspace_layout`).
* (c) The plain versions against the JAX package's Pallas kernels in
  interpret mode at S = 257, 320, 512 and 1024, the paper and the smaller
  model at 10 and 16 bands (each S with both models and both band counts
  across its two cases), inputs from a numpy seed on
  tests/test_torch_xyz_bands.py's grid (ro + rd·z exact in f32), weights
  by `params_from_jax`: K2 rgb / acc / bg_weight / weights atol 2e-3,
  depth 2e-3·far, disp rtol 1e-2; K3 forward 0.01·max, its VJP 0.08·max /
  0.04·‖·‖; K1 rgb / weights atol 2e-4, gradients 0.08·max / 0.04·‖·‖.
* (d) The slice: synth512_paper_64_256's sample counts (64 + 256) in a
  bf16 step through `fused_losses` (K1's plain version at S = 64 and 320)
  against the JAX package's `fused_value_and_grad` (its Pallas kernel in
  interpret mode) with the JAX draws, and in one f32 `train()` step and one
  f32 `render_full_frame` against the JAX package's.
"""

import copy
import dataclasses
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.data.flame import load_flame_data as jax_load_flame_data
from nerface_tpu.data.synthetic import make_synthetic_flame_dataset
from nerface_tpu.eval.renderer import render_full_frame as jax_render_full_frame
from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.ops import sampling as jsamp
from nerface_tpu.ops.pallas.fused_mlp import _pick_rays_per_tile as jax_pick_rays_per_tile
from nerface_tpu.ops.pallas.fused_mlp import fused_paper_mlp as jax_fused_paper_mlp
from nerface_tpu.ops.pallas.fused_mlp import fused_paper_render as jax_fused_render
from nerface_tpu.ops.pallas.fused_train import fused_train_pass as jax_train_pass
from nerface_tpu.ops.pallas.fused_train import prefold_paper_params as jax_prefold
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerface_tpu.render.pipeline import _fused_conditioning as jax_fused_conditioning
from nerface_tpu.train.fused import fused_value_and_grad as jax_fused_value_and_grad
from nerface_tpu.train.loop import train as jax_train
from nerface_tpu_torch.config import CfgNode
from nerface_tpu_torch.config.flags import FeatureFlags
from nerface_tpu_torch.data.flame import load_flame_data
from nerface_tpu_torch.eval.renderer import render_full_frame
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.ops.kernels import fused_flex as F
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_train as T
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings
from nerface_tpu_torch.train.checkpoint import params_from_jax
from nerface_tpu_torch.train.fused import fused_losses, fused_train_eligible
from nerface_tpu_torch.train.loop import build_models_from_cfg, train
from test_torch_train import _batch, _pair, _port_grads, _train_cfg, pin_numpy_feeds

torch.set_num_threads(1)

CSRC = pathlib.Path(K.__file__).resolve().parents[2] / "csrc"
FAMILY = {False: "ConditionalBlendshapePaperNeRFModel",
          True: "ConditionalBlendshapePaperSmallerNeRFModel"}
FAR = 0.8
DIR_OFF = 256 + 24  # the smaller model's expression block of layers_dir.0
LIMIT = 1024
# synth512_paper_64_256: the paper's 64 coarse samples, 256 fine
SC, SF = 64, 256
# (S, small, bands): each S with both models and both band counts
CASES = [(257, False, 10), (257, True, 16), (320, True, 10), (320, False, 16),
         (512, False, 10), (512, True, 16), (LIMIT, True, 10), (LIMIT, False, 16)]
RAY_COUNTS = [8, 16, 301, 2048, 2072, 65536]


def _kw(L):
    return dict(num_encoding_fn_xyz=L, num_encoding_fn_dir=4, include_input_dir=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_rule(n_rays, n_samples):
    """The JAX package's rule for its Pallas kernels: a ray tile of
    `_pick_rays_per_tile` (`fused_paper_mlp_available` without its
    TPU-backend test)."""
    tr = jax_pick_rays_per_tile(n_rays, n_samples)
    return tr >= 8 and n_rays % tr == 0


def _case_id(c):
    return f"S{c[0]}-{'small' if c[1] else 'paper'}-L{c[2]}"


# -- (a) dispatch --------------------------------------------------------------

def test_the_paper_kernels_limit_is_one_constant():
    """The wrappers, the dispatch and the C entry points read one limit:
    `fused_mlp.MAX_SAMPLES`, `MAX_SAMPLES` in the header, which every
    paper entry point checks; K4 reads the same (`fused_flex.MAX_SAMPLES`,
    its `valid`)."""
    assert K.MAX_SAMPLES == LIMIT and F.MAX_SAMPLES == LIMIT
    wc = (CSRC / "wgmma_chain.cuh").read_text()
    assert f"constexpr int MAX_SAMPLES = {K.MAX_SAMPLES};" in wc and "PAPER_MAX_SAMPLES" not in wc
    check = "if (n_samples < 1 || n_samples > MAX_SAMPLES) return (int)cudaErrorInvalidValue;"
    for name, n in (("fused_paper_render.cu", 1), ("fused_train_pass.cu", 1), ("fused_paper_mlp.cu", 2)):
        code = re.sub(r"//.*", "", (CSRC / name).read_text())
        assert code.count(check) == n, name
        assert "PAPER_MAX_SAMPLES" not in code, name
    flex = re.sub(r"//.*", "", (CSRC / "fused_flex.cu").read_text())
    assert "PAPER_MAX_SAMPLES" not in flex and "n_samples <= MAX_SAMPLES" in flex


@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_dispatch_takes_the_new_limit(small):
    """K2 and K3 take a pass on the card where the JAX package's tile rule
    sends it to Pallas, at S up to 1024 and not at 1025; on the CPU any
    ray count in that domain. K1 takes a step whose merged fine pass is up
    to 1024 samples."""
    m = MODELS[FAMILY[small]](**_kw(10), generator=torch.Generator().manual_seed(1))
    tset = RenderSettings(num_coarse=SC, num_fine=SF, perturb=True, radiance_field_noise_std=0.0,
                          white_background=False, near=0.2, far=FAR, encode_xyz=EncodeSpec(10, True, True),
                          encode_dir=EncodeSpec(4, False, True), fused_render=True)
    pe_dir, expr, latent = torch.zeros(2, 24), torch.zeros(76), torch.zeros(32)
    for n_rays in RAY_COUNTS:
        for S in (255, 256, 257, 320, 384, 512, 1000, LIMIT - 1, LIMIT, LIMIT + 1, 2048):
            want = S <= LIMIT and _jax_rule(n_rays, S)
            assert want == (S <= LIMIT and n_rays % 8 == 0), (n_rays, S)  # JAX tiles 8 rays past 128
            assert pipeline._paper_kernels_take(n_rays, S, "cuda") == want, (n_rays, S)
            assert pipeline._paper_kernels_take(n_rays, S, "cpu") == (S <= LIMIT), S
            assert K.kernel_pass_ok(n_rays, S) == want
            for dev in ("cuda", torch.device("cuda", 0)):
                assert pipeline._fused_render_eligible(m, n_rays, S, pe_dir, expr, latent, tset,
                                                       torch.bfloat16, dev) == want, (n_rays, S)
        flags = FeatureFlags()
        for sc, sf in ((SC, SF), (64, 960), (64, 961), (320, 704), (512, 512), (1, 1023), (1, 1024)):
            s = dataclasses.replace(tset, num_coarse=sc, num_fine=sf)
            want = sc + sf <= LIMIT
            assert fused_train_eligible(m, m, s, flags, torch.bfloat16, "cuda", num_rays=n_rays) == (
                want and n_rays % 8 == 0), (n_rays, sc, sf)
            assert fused_train_eligible(m, m, s, flags, torch.bfloat16, "cpu", n_rays) == want, (sc, sf)


def test_flexible_kernels_keep_256():
    """K4 takes the paper kernels' limit now (the name kept from when it
    stopped at 256): `flex_fused_eligible` admits S = 257 and 1024 on the
    card and on the CPU and refuses 1025, its wrappers raise naming
    1..1024, and `_apply_model` sends a Flexible pass at 257 to K4 as a
    paper pass at 257 goes to K3."""
    m = MODELS["ConditionalBlendshapeLearnableCodeNeRFModel"](**_kw(10), hidden_size=256)
    enc = EncodeSpec(10, True, True)
    pe_dir = torch.zeros(2048, 24)
    for dev in ("cuda", "cpu"):
        assert F.flex_fused_eligible(m, enc, pe_dir, 2048, 256, dev)
        assert F.flex_fused_eligible(m, enc, pe_dir, 2048, 257, dev)
        assert F.flex_fused_eligible(m, enc, pe_dir, 2048, LIMIT, dev)
        assert not F.flex_fused_eligible(m, enc, pe_dir, 2048, LIMIT + 1, dev)
    assert F.kernel_pass_ok(2048, 257) and F.kernel_pass_ok(2048, LIMIT) and not F.kernel_pass_ok(2048, LIMIT + 1)
    with pytest.raises(ValueError, match=r"1\.\.1024 samples per ray"):
        F.check_samples(LIMIT + 1)
    args = (torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(8, LIMIT + 1), torch.zeros(8, 128),
            torch.zeros(1, 256), 3)
    with pytest.raises(ValueError, match=r"1\.\.1024 samples per ray"):
        F._kernel_call(None, *args, 10)


def test_apply_model_sends_a_long_paper_pass_to_k3(monkeypatch):
    taken = []
    monkeypatch.setattr(pipeline, "_paper_pass", lambda *a: taken.append(a[3].shape[-1]) or "K3")
    monkeypatch.setattr(pipeline, "_flex_pass", lambda *a: "K4")
    pe_dir, expr, latent = torch.zeros(8, 24), torch.zeros(76), torch.zeros(32)
    paper = MODELS[FAMILY[False]](**_kw(10))
    flex = MODELS["ConditionalBlendshapeLearnableCodeNeRFModel"](**_kw(10), hidden_size=256)
    for m in (paper, flex):
        monkeypatch.setattr(m, "forward", lambda *a, **k: "plain")
    for S in (257, 320, LIMIT, LIMIT + 1):
        z = torch.linspace(0.2, 0.8, S).expand(8, S)
        args = (torch.zeros(8, 3), torch.ones(8, 3), z, EncodeSpec(10, True, True), pe_dir, expr, latent,
                torch.bfloat16)
        assert pipeline._apply_model(paper, *args) == ("K3" if S <= LIMIT else "plain"), S
        assert pipeline._apply_model(flex, *args) == ("K4" if S <= LIMIT else "plain"), S
    assert taken == [257, 320, LIMIT]


def test_wrappers_raise_past_the_new_limit():
    """A direct call at S = 1025 raises a ValueError naming 1..1024, on the
    CPU too, whose wrappers run the plain versions; S = 1024 runs."""
    from nerface_tpu_torch.tools.perf.cases import paper_case

    for S in (LIMIT + 1, LIMIT):
        bundle, rays = paper_case(2, S, 0, torch.device("cpu"))
        ro, rd, z = rays["ro"], rays["rd"], rays["z"]
        calls = {
            "K3f": lambda: K.fused_paper_mlp_forward(bundle, ro, rd, z),
            "K3b": lambda: K.fused_paper_mlp_backward(bundle, ro, rd, z, rays["g"]),
            "K1": lambda: T.fused_train_pass(bundle, ro, rd, z, rays["tgt"], loss_scale=1.0),
            "K2": lambda: K.fused_paper_render(
                MODELS[FAMILY[False]](**_kw(10)).state_dict(), ro, rd, z, torch.zeros(2, 128),
                torch.zeros(108)),
        }
        for name, call in calls.items():
            if S == LIMIT:
                call()
                continue
            with pytest.raises(ValueError, match=r"1\.\.1024 samples per ray"):
                call()


# -- (b) layout ------------------------------------------------------------------

def _header_layout(S):
    """`UnitLayout::of` as the header writes it (its loop read from the
    source below), for S on the host."""
    rays, units = 1, (S + 63) // 64
    if 64 % S == 0:
        rays = 64 // S
    elif S % 64 != 0:
        n = 2
        while n * S <= K.ITEM_ROWS:
            u = (n * S + 63) // 64
            if n * units > rays * u:
                rays, units = n, u
            n += 1
    return rays, units


def test_long_items_are_one_ray_and_ray_of_is_exact():
    wc = (CSRC / "wgmma_chain.cuh").read_text()
    assert "for (int n = 2; n * s <= ITEM_ROWS; ++n) {" in wc
    assert "int ray_of(int row) const { return (int)(((uint32_t)row * div) >> 24); }" in wc
    assert "bool long_item() const { return SF ? false : l.units * 64 > ITEM_ROWS; }" in wc
    for S in range(1, LIMIT + 1):
        rays, units = K.unit_layout(S)
        assert (rays, units) == _header_layout(S), S
        assert (units * 64 > K.ITEM_ROWS) == (S > K.ITEM_ROWS), S
        if S > K.ITEM_ROWS:
            assert (rays, units) == (1, -(-S // 64)), S
    # ray_of: every row of every item (a long item's up to S + 63) and every
    # row below ITEM_ROWS, at every S of the domain
    S = np.arange(1, LIMIT + 1, dtype=np.uint64)[:, None]
    row = np.arange(LIMIT + 64, dtype=np.uint64)[None, :]
    units = np.array([K.unit_layout(int(s))[1] for s in S[:, 0]], np.uint64)[:, None]
    inside = row < np.maximum(units * 64, K.ITEM_ROWS)
    div = ((1 << 24) + S - 1) // S
    assert int((row * div)[inside].max()) < 2 ** 32
    assert np.array_equal(((row * div) >> 24)[inside], np.broadcast_to(row // S, inside.shape)[inside])


def _k2_segments(S):
    """The (s0, n) segments K2's consumer composites for a long ray, by the
    loop of `consume` in csrc/fused_paper_render.cu: after a unit u with su
    = u & 3 == 3 and more units to come, segment (u >> 2)·ITEM_ROWS of
    ITEM_ROWS; after the last unit, ((units − 1) >> 2)·ITEM_ROWS to S."""
    _, units = K.unit_layout(S)
    segs = [((u >> 2) * K.ITEM_ROWS, K.ITEM_ROWS) for u in range(units)
            if u & (K.ITEM_ROWS // 64 - 1) == K.ITEM_ROWS // 64 - 1 and u + 1 < units]
    s0 = ((units - 1) >> 2) * K.ITEM_ROWS
    return segs + [(s0, S - s0)]


def test_k2_segments_take_each_sample_once():
    cu = (CSRC / "fused_paper_render.cu").read_text()
    assert "if constexpr (LONG) {\n        if (su == ITEM_ROWS / 64 - 1 && u + 1 < g.units()) {" in cu
    assert "composite_segment(sigma, rgb, sm.carry[wg], a, lane, ray0, g.samples(), (u >> 2) * ITEM_ROWS, ITEM_ROWS);" in cu
    assert "const int s0 = ((g.units() - 1) >> 2) * ITEM_ROWS;" in cu
    assert "const int su = LONG ? u & (ITEM_ROWS / 64 - 1) : u;" in cu and "const int row = su * 64 + r0 + 8 * h;" in cu
    # a pass past ITEM_ROWS rows an item runs the LONG instantiations
    assert "if (args.l.units * 64 > ITEM_ROWS) return RenderLaunch<SF, SMALL, true>::run(args, stream);" in cu
    for S in range(K.ITEM_ROWS + 1, LIMIT + 1):
        seen = np.zeros(S, int)
        for s0, n in _k2_segments(S):
            assert 1 <= n <= K.ITEM_ROWS and s0 % K.ITEM_ROWS == 0, (S, s0, n)
            # lane l's samples [l·spl, (l+1)·spl) below n, spl = ⌈n / 32⌉, at most MAX_SPL = 8
            spl = -(-n // 32)
            assert spl <= K.ITEM_ROWS // 32
            for lane in range(32):
                for q in range(spl):
                    if lane * spl + q < n:
                        seen[s0 + lane * spl + q] += 1
        assert (seen == 1).all(), S


def test_k1_long_segments_take_each_sample_once():
    cu = (CSRC / "fused_train_pass.cu").read_text()
    assert "const int n_seg = (S + ITEM_ROWS - 1) / ITEM_ROWS;" in cu
    assert cu.count("const int s0 = seg * ITEM_ROWS, n = min(ITEM_ROWS, S - s0), spl = (n + 31) >> 5;") == 2
    assert "for (int seg = 0; seg < n_seg; ++seg) {" in cu and "for (int seg = n_seg - 1; seg >= 0; --seg) {" in cu
    for S in range(K.ITEM_ROWS + 1, LIMIT + 1):
        n_seg = -(-S // K.ITEM_ROWS)
        seen = np.zeros(S, int)
        for seg in range(n_seg):
            s0 = seg * K.ITEM_ROWS
            n = min(K.ITEM_ROWS, S - s0)
            spl = -(-n // 32)
            idx = [s0 + lane * spl + q for lane in range(32) for q in range(spl) if lane * spl + q < n]
            seen[idx] += 1
        assert (seen == 1).all(), S


def test_workspace_rows_slab_as_carve_lays_it_out():
    """The long items' slab: 8 f32 a row of 64·units rows, one a consumer
    warpgroup of each CTA, after dW's segments; none up to ITEM_ROWS.
    `workspace_layout` is `carve`; at 2048 rays × 1024 samples the whole
    workspace is ≈ 18.5 GB (the operand images, 8832 B a row), the slab
    8.65 MB."""
    hdr = (CSRC / "paper_train.cuh").read_text()
    assert ("__host__ __device__ inline int item_row_floats(int units) { return units * 64 > ITEM_ROWS ? "
            "8 * 64 * units : 0; }") in hdr
    carve = hdr[hdr.index("inline size_t carve("):hdr.index("inline long long workspace_bytes(")]
    assert "take((size_t)ctas * CONSUMERS * item_row_floats(item_units) * sizeof(float))" in carve
    assert "Geometry(n_samples).l.units, nullptr);" in hdr
    assert "return {b, b + n, b + 4 * n, b + 5 * n};" in hdr  # σ, rgb, g_σ, g_rgb
    for S in (64, 128, 200, 256):
        assert T.workspace_layout(2048, S)["rows"][1] == 0, S
    lay = T.workspace_layout(2048, LIMIT)
    units, ctas = T.workspace_geometry(2048, LIMIT)
    assert (units, ctas) == (2048 * 16, 132)
    assert lay["rows"][1] == 132 * 2 * 8 * 64 * 16 * 4 == 8650752
    row_bytes = sum(w for _, w in T.ws_buffers()) * 2
    assert row_bytes == 8832
    assert lay["total"] > units * 64 * row_bytes > 18.5e9
    offs = [v[0] for k, v in lay.items() if k != "total"]
    assert offs == sorted(offs) and all(o % 256 == 0 for o in offs)


def test_exact_dw_check_reads_the_dw_launch_and_its_images():
    """chip_smoke.py's exact dW check (`dw_exact`) holds each product of the
    dW launch to the f64 Xᵀ·gY of the workspace's images: its products are
    `launch_pass`'s `mats` in the header (X buffer, gY buffer, weight slot,
    W3's h2 rows after its kx xin rows; the smaller model's fc_feat reads h4
    and has no W5), and `_unimage` gives back the matrix
    `fused_train.workspace_image` laid out, at every width."""
    import chip_smoke as C

    hdr = (CSRC / "paper_train.cuh").read_text()
    start = hdr.index("const DwgMat mats[] = {")
    mats = re.findall(r"\{B\(([^)]+)\), B\((WS_\w+)\), \w+, \w+, O\(W_OFF_(\w+)\)( \+ kx \* HIDDEN)?\}",
                      hdr[start:hdr.index("};", start)])
    assert len(mats) == 11
    for small in (False, True):
        want = []
        for x, g, slot, h_rows in mats:
            if slot == "W5" and small:
                continue
            x = ("WS_H4" if small else "WS_H5") if "?" in x else x
            want.append((slot, 64 if h_rows else 0, x[3:].lower(), g[3:].lower()))
        assert [p[1:] for p in C.dw_products(small, 64)] == want, small
    for width in (64, 128, 256):
        m = torch.randn(3 * 64, width).to(torch.bfloat16)
        img = T.workspace_image(m).view(torch.uint8)
        ws = torch.zeros(256 + img.numel(), dtype=torch.uint8)
        ws[256:] = img
        assert torch.equal(C._unimage(ws, 256, 3, width), m), width
    # the lost unit: the middle item's first, as `lost_unit_rows` drops its rows
    for R, S in ((2048, 64), (2072, 5), (2048, 320), (2072, 1000)):
        rays, units = K.unit_layout(S)
        rows = C.lost_unit_rows(R, S)
        assert rows.start == (C.lost_unit_index(R, S) // units) * rays * S


# -- (c) the plain versions against the TPU kernels ------------------------------

@functools.lru_cache(maxsize=None)
def _family(small, L):
    """(JAX model, JAX params, the port's module on the same weights)."""
    jm = JAX_MODELS[FAMILY[small]](**_kw(L))
    jp = jm.init(jax.random.PRNGKey(21 + L))
    tm = MODELS[FAMILY[small]](**_kw(L))
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}), strict=True)
    return jm, jp, tm


def _grid(a, bits):
    """`a` rounded to a multiple of 2^-bits, as f32."""
    return (np.round(np.asarray(a, np.float64) * 2.0 ** bits) / 2.0 ** bits).astype(np.float32)


def _inputs(R, S, seed):
    """tests/test_torch_xyz_bands.py's rays: ro + rd·z exact in f32, so both
    packages' sample points are the same bits at 16 bands."""
    rng = np.random.RandomState(seed)
    f = np.float32
    step = _grid(rng.rand(R, S) * ((FAR - 0.2) / S), 12).clip(2.0 ** -12)
    return dict(
        ro=_grid(rng.randn(R, 3) * 0.05 + [0, 0, 0.5], 10),
        rd=_grid(rng.randn(R, 3) * [0.2, 0.2, 0.05] - [0, 0, 1], 8),
        z=_grid(0.2 + np.cumsum(step.astype(np.float64), -1), 12),
        target=rng.rand(R, 3).astype(f), bg=rng.rand(R, 3).astype(f),
        noise=rng.randn(R, S).astype(f), pe_dir=rng.randn(R, 24).astype(f),
        expr=(rng.randn(76) * 0.5).astype(f), latent=(rng.randn(32) * 0.1).astype(f),
        g=rng.randn(R, S, 4).astype(f),
    )


def _close_tensor(name, got, want, max_tol, norm_tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    d = got - want
    assert np.abs(d).max() <= max_tol * np.abs(want).max() + 1e-9, (name, np.abs(d).max())
    assert np.linalg.norm(d) <= norm_tol * np.linalg.norm(want) + 1e-9, name


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_k2_plain_matches_jax_kernel(case):
    S, small, L = case
    jm, jp, tm = _family(small, L)
    R = 8
    x = _inputs(R, S, seed=S + L)
    jcond, jdc, _ = jax_fused_conditioning(jm, jp, jnp.asarray(x["pe_dir"]),
                                           jnp.asarray(x["expr"]), jnp.asarray(x["latent"]))
    ref = jax_fused_render(jp, jnp.asarray(x["ro"]), jnp.asarray(x["rd"]), jnp.asarray(x["z"]),
                           jdc, jcond, background=jnp.asarray(x["bg"]), out_weights=True,
                           num_encoding_fn_xyz=L, small=small)
    # the wrapper on CPU tensors: the plain version, through the packed weights
    got = K.fused_paper_render(K.pack_paper_weights(tm.state_dict(), L), _t(x["ro"]), _t(x["rd"]),
                               _t(x["z"]), _t(jdc), _t(jcond), background=_t(x["bg"]), out_weights=True,
                               num_encoding_fn_xyz=L, small=small)
    assert set(got) == set(ref) and got["weights"].shape == (R, S)
    for k in ("rgb", "acc", "bg_weight", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=2e-3, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(ref["depth"]), atol=2e-3 * FAR, rtol=0)
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(ref["disp"]), rtol=1e-2)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_k3_plain_matches_jax_kernel_forward_and_vjp(case):
    """The pipeline's K3 branch (`_paper_pass`: prefold, then the plain
    forward and, through autograd, the plain backward) against JAX
    `_fused_conditioning` + `fused_paper_mlp` in interpret mode."""
    S, small, L = case
    jm, jp, tm = _family(small, L)
    R = 8
    x = _inputs(R, S, seed=S + L + 1)

    def jax_fn(params, e, lat):
        cond, dc, _ = jax_fused_conditioning(jm, params, jnp.asarray(x["pe_dir"]), e, lat)
        return jax_fused_paper_mlp(params, jnp.asarray(x["ro"]), jnp.asarray(x["rd"]),
                                   jnp.asarray(x["z"]), dc, cond, num_encoding_fn_xyz=L,
                                   small=small)

    jout, vjp = jax.vjp(jax_fn, jp, jnp.asarray(x["expr"]), jnp.asarray(x["latent"]))
    jg_params, jg_expr, jg_latent = vjp(jnp.asarray(x["g"]))
    e = _t(x["expr"]).requires_grad_(True)
    lat = _t(x["latent"]).requires_grad_(True)
    tm.zero_grad(set_to_none=True)
    out = pipeline._paper_pass(tm, _t(x["ro"]), _t(x["rd"]), _t(x["z"]), EncodeSpec(L, True, True),
                               _t(x["pe_dir"]), e, lat)
    assert out.shape == (R, S, 4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=0.01 * float(np.abs(jout).max()), rtol=0)
    (out * _t(x["g"])).sum().backward()
    grads = dict(tm.named_parameters())
    seen = 0
    for name, want in jg_params.items():
        want = np.asarray(want)
        if not np.any(want):  # layers_dir.3 of the paper model: never applied
            assert grads[name].grad is None, name
            continue
        _close_tensor(name, grads[name].grad.numpy(), want, 0.08, 0.04)
        seen += 1
    assert seen == (22 if small else 24)
    _close_tensor("expr", e.grad.numpy(), jg_expr, 0.08, 0.04)
    _close_tensor("latent", lat.grad.numpy(), jg_latent, 0.08, 0.04)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_k1_plain_matches_jax_kernel(case):
    S, small, L = case
    jm, jp, tm = _family(small, L)
    R = 8
    x = _inputs(R, S, seed=S + L + 2)
    cond = np.concatenate([x["expr"] / 3.0, x["latent"]]).astype(np.float32)
    off = DIR_OFF if small else 0
    jb = jax_prefold(jp, jnp.asarray(cond), jnp.asarray(x["pe_dir"]), L, small=small, dir_expr_offset=off)
    tb = T.prefold_paper_params(tm.state_dict(), _t(cond), _t(x["pe_dir"]), L, small=small,
                                dir_expr_offset=off)
    kw = dict(noise_std=0.1, loss_scale=2.0 / (3.0 * R), small=small, num_encoding_fn_xyz=L)
    rays = ("ro", "rd", "z", "target")
    jo, jg, _ = jax_train_pass(jb, *(jnp.asarray(x[k]) for k in rays),
                               background=jnp.asarray(x["bg"]), noise=jnp.asarray(x["noise"]), **kw)
    to, tg, _ = T.fused_train_pass(tb, *(_t(x[k]) for k in rays), background=_t(x["bg"]),
                                   noise=_t(x["noise"]), **kw)
    for k in ("rgb", "weights"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=2e-4, rtol=0, err_msg=k)
    wn, bn = K.bundle_names(small)
    names = ["d_cond0", "d_cond3", "d_dir"] + list(wn) + list(bn)
    assert len(tg) == len(jg) == len(names)
    for name, a, b in zip(names, tg, jg):
        _close_tensor(name, a.numpy(), np.asarray(b), 0.08, 0.04)


# -- (d) the slice at 64 + 256 ---------------------------------------------------

def _draws(key, R):
    """The JAX pipeline's draws for `key` (its 4-way split) at SC + SF, as
    tensors."""
    idx = jnp.arange(R, dtype=jnp.int32)
    k_strat, k_noise_c, k_pdf, k_noise_f = jax.random.split(key, 4)
    d = {
        "t_rand": jsamp.per_ray_uniform(k_strat, idx, SC),
        "noise_c": jsamp.per_ray_normal(k_noise_c, idx, SC),
        "u": jsamp.per_ray_uniform(k_pdf, idx, SF),
        "noise_f": jsamp.per_ray_normal(k_noise_f, idx, SC + SF),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_step_at_64_plus_256_matches_jax_fused_step():
    """synth512_paper_64_256's training passes (S = 64 and 320) through
    `fused_losses` in bf16 on the CPU (K1's plain version for both) against
    the JAX package's fused step (its Pallas kernel in interpret mode), the
    JAX draws injected, σ-noise 0.1: loss and metrics rtol 1e-3, every
    gradient within K1's 0.08·max of (c)."""
    jm, jstate, _, jflags, state, _, flags = _pair({})
    kw = dict(num_coarse=SC, num_fine=SF, perturb=True, radiance_field_noise_std=0.1,
              white_background=False, near=0.2, far=0.8)
    tset = RenderSettings(**kw, encode_xyz=EncodeSpec(10, True, True), encode_dir=EncodeSpec(4, False, True))
    jset = JaxRenderSettings(**kw, encode_xyz=JaxEncodeSpec(10, True, True),
                             encode_dir=JaxEncodeSpec(4, False, True), fused="off")
    R = 16
    assert fused_train_eligible(state.model_coarse, state.model_fine, tset, flags, torch.bfloat16, "cuda",
                                num_rays=R)
    jb, tb = _batch(R, seed=13)
    key = jax.random.PRNGKey(2)
    (jtot, jmet), jg = jax_fused_value_and_grad(jstate.params, jb, key, jm, jm, jset, jflags,
                                                jstate.fixed_background)
    before = T.fused_train_pass.launches
    total, metrics = fused_losses(state, tb, 0, tset, flags, draws=_draws(key, R))
    total.backward()
    assert T.fused_train_pass.launches == before  # the CPU runs the plain version and counts no launch
    np.testing.assert_allclose(float(total.detach()), float(jtot), rtol=1e-3)
    for k in jmet:
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]), rtol=1e-3, atol=1e-6, err_msg=k)
    port = _port_grads(state)
    seen = 0
    for path, v in jax.tree_util.tree_leaves_with_path(jg):
        name, v = jax.tree_util.keystr(path), np.asarray(v)
        got = port[name]
        if got is None:  # never reached the loss (layers_dir.3)
            assert not np.any(v), name
            continue
        _close_tensor(name, got.numpy(), v, 0.08, 0.04)
        seen += 1
    assert seen >= 30


@pytest.fixture(scope="module")
def dataset_32(tmp_path_factory):
    return make_synthetic_flame_dataset(
        str(tmp_path_factory.mktemp("long_rays_ds") / "ds"), H=32, W=32, n_train=2, n_val=1,
        n_test=1, num_samples=8,
    )


def test_train_at_64_plus_256_matches_jax_train(dataset_32, tmp_path, capsys, monkeypatch):
    """One f32 `train()` step of synth512_paper_64_256's sample counts (64 +
    256, perturb off, σ-noise 0) on a 32² image, 32 rays, from the same
    reference-schema checkpoint, against JAX `train()`, both host feeds on
    their numpy paths (tests/test_torch_train.py's whole-slice limits)."""
    pin_numpy_feeds(monkeypatch)
    d = _train_cfg(dataset_32, str(tmp_path / "runs"))
    d["experiment"]["train_iters"] = 1
    for node in (d["nerf"]["train"], d["nerf"]["validation"]):
        node.update(num_coarse=SC, num_fine=SF)
    d["nerf"]["train"]["num_random_rays"] = 32
    cfg = CfgNode(d)
    mc, mf = build_models_from_cfg(cfg, generator=torch.Generator().manual_seed(5))
    start = str(tmp_path / "start.ckpt")
    torch.save({"iter": 0, "model_coarse_state_dict": mc.state_dict(),
                "model_fine_state_dict": mf.state_dict(), "optimizer_state_dict": None,
                "loss": 0.0, "psnr": 0.0, "background": None,
                "latent_codes": torch.zeros(2, 32)}, start)
    jstate = jax_train(JaxCfgNode(copy.deepcopy(d)), load_checkpoint=start,
                       dataset=jax_load_flame_data(dataset_32), log=False)
    jax_out = capsys.readouterr().out
    jax_losses = [float(v) for v in re.findall(r"\[TRAIN\] Iter: \d+ Loss: ([0-9.]+)", jax_out)]
    state = train(cfg, load_checkpoint=start, dataset=load_flame_data(dataset_32), device="cpu")
    losses = [float(v) for v in re.findall(r"\[TRAIN\] Iter: \d+ Loss: ([0-9.]+)", capsys.readouterr().out)]
    assert state.step == int(jstate.step) == 1
    assert len(jax_losses) == len(losses) == 1
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    lr = 5e-4
    for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
        for name, p in m.named_parameters():
            got, want = p.detach().numpy(), np.asarray(jstate.params[which][name])
            np.testing.assert_allclose(got, want, atol=10 * lr, rtol=0, err_msg=name)
            assert np.mean(np.abs(got - want) <= 1e-5) >= 0.99, name


def test_frame_at_64_plus_256_matches_jax():
    """One f32 `render_full_frame` of a 16² frame at 64 + 256 samples
    (perturb off, σ-noise 0), the paper model's weights from JAX, against
    the JAX package's: every map atol 1e-4, disparity rtol 1e-4."""
    H = W = 16
    intr = np.array([20.0, 20.0, 0.5, 0.5], np.float32)
    pose = np.eye(4, dtype=np.float32)[:3, :4]
    jmodel = JAX_MODELS[FAMILY[False]](**_kw(10))
    kc, kf = jax.random.split(jax.random.PRNGKey(4))
    pc, pf = jmodel.init(kc), jmodel.init(kf)
    models = []
    for p in (pc, pf):
        m = MODELS[FAMILY[False]](**_kw(10))
        m.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in p.items()}), strict=True)
        models.append(m.eval().requires_grad_(False))
    rng = np.random.RandomState(4)
    expr = rng.randn(76).astype(np.float32) * 0.1
    latent = rng.randn(32).astype(np.float32) * 0.1
    bg = rng.rand(H, W, 3).astype(np.float32)
    kw = dict(num_coarse=SC, num_fine=SF, near=0.2, far=FAR, chunksize=128, perturb=False,
              radiance_field_noise_std=0.0)
    jset = JaxRenderSettings(**kw, encode_xyz=JaxEncodeSpec(10, True, True), encode_dir=JaxEncodeSpec(4, False, True))
    tset = RenderSettings(**kw, encode_xyz=EncodeSpec(10, True, True), encode_dir=EncodeSpec(4, False, True))
    ref = jax_render_full_frame(jmodel, jmodel, pc, pf, H, W, intr, pose, jset, key=jax.random.PRNGKey(3),
                                expressions=jnp.asarray(expr), latent_code=jnp.asarray(latent),
                                background=jnp.asarray(bg))
    got = render_full_frame(models[0], models[1], H, W, intr, pose, tset, expressions=_t(expr),
                            latent_code=_t(latent), background=_t(bg))
    assert set(got) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape, k
        if k.startswith("disp"):
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, atol=1e-4, rtol=0, err_msg=k)
