"""PyTorch port: the paper-family kernels (K2, K3f, K3b, K1) at 21 to 31 xyz
encoding bands.

Past 20 bands the encoding [xyz; PE] has 129..189 columns: the kernels pad
it to K = 192 (three 64-column blocks, `fused_mlp.xin_extent`), W0 and W3
hold 192 encoding rows (`w_layout(192)`), K1's workspace image of xin is
192 wide, and the f32 rows hold 31 bands in FREQ_SLOTS = 32 slots. A
consumer warpgroup's three-block xin buffer (24 KB) does not fit beside
the weight ring, so at xc = 3 the ring runs one stage fewer and the two
warpgroups' buffers take its last stage and run on into the xin array
(`xin_at`, `ring_stages` in csrc/wgmma_chain.cuh). K4 keeps 20 bands.

* (a) Dispatch: asked for the card (`device="cuda"`, no card needed) the
  paper family is admitted at L = 21, 24 and 31 and refused at 32
  (`_fused_render_eligible`, `_fused_model_ok`, `fused_train_eligible`,
  the wrappers' ValueError), and K4 is still refused at 21.
* (b) The plain versions against the JAX package's Pallas kernels in
  interpret mode at L = 21, 24 and 31, S = 16 and 48, the paper and the
  smaller model: tests/test_torch_xyz_bands.py's cases and tolerances (K2
  rgb / acc / bg_weight / weights atol 2e-3, depth 2e-3·far, disp rtol
  1e-2; K3 forward 0.01·max, its VJP 0.08·max / 0.04·‖·‖; K1 rgb /
  weights atol 2e-4, gradients 0.06·max, 0.15 on d_dir, / 0.04·‖·‖), on
  its exact ray grid: the top band multiplies a point by up to 2^30, so
  both packages must see the same point bits, which they then encode in
  the same order, sin(fl(fl(x·f) + φ)).
* (c) Layout: `w_layout(192)`, `F_LAYOUT` and `WT_LAYOUT` against the
  offsets `csrc/mma_tile.cuh`'s `w_off` gives; packing at 21, 24 and 31
  bands round-trips through the kernels' gradient layout and the chunk
  images; the encoder mirror at xc = 3 writes each of the 192 columns of
  a row once, at the workspace image's bytes; the xc = 3 buffers of both
  warpgroups lie in the ring's last stage and the xin array, apart from
  each other and from the stages the shorter ring runs, in K2's / K3f's
  and K1's / K3b's shared memory alike.
* (d) A 21-band paper step at 16 + 16 samples through `fused_losses` in
  bf16 on the CPU (K1's plain version) against the JAX package's fused
  step `fused_value_and_grad` (its Pallas kernel in interpret mode), both
  given the same coarse and fine depths on the exact grid (the
  stratified and resampled depths injected in both packages) and the
  JAX draws: loss and metrics rtol 1e-3, every gradient within
  5e-3·max. With drawn fine depths, which follow the coarse weights that
  two bf16 MLPs give a few 1e-3 apart, the 2^20 top band would turn the
  fine pass's phases into other numbers, which is not what this compares.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerface_tpu.train.fused as jax_fused_module
import nerface_tpu_torch.train.fused as port_fused_module
from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.config.flags import FeatureFlags as JaxFlags
from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.train.fused import fused_value_and_grad as jax_fused_value_and_grad
from nerface_tpu.train.state import TrainState as JaxTrainState
from nerface_tpu.train.state import build_optimizer as jax_build_optimizer
from nerface_tpu_torch.config import CfgNode
from nerface_tpu_torch.config.flags import FeatureFlags
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.ops.kernels import fused_flex as F
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_train as T
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.render.pipeline import EncodeSpec
from nerface_tpu_torch.train import checkpoint as ckpt
from nerface_tpu_torch.train.checkpoint import params_from_jax
from nerface_tpu_torch.train.fused import fused_losses, fused_train_eligible
from nerface_tpu_torch.train.state import build_optimizer, create_train_state
from test_torch_train import _batch, _opt_cfg, _port_grads
from test_torch_xyz_bands import (
    CHAIN,
    CSRC,
    FAMILY,
    MMA,
    SAMPLES,
    _c_constants,
    _c_expr,
    _encoder_writes,
    _grid,
    _kw,
    _settings,
    _t,
)
# the (b) and (c) checks of the 11..20-band file, run here at 21..31 bands
from test_torch_xyz_bands import test_encoder_writes_every_column_once as _encoder_case
from test_torch_xyz_bands import test_k1_plain_matches_jax_kernel as _k1_case
from test_torch_xyz_bands import test_k2_plain_matches_jax_kernel as _k2_case
from test_torch_xyz_bands import test_k3_plain_matches_jax_kernel_forward_and_vjp as _k3_case
from test_torch_xyz_bands import test_pack_and_split_round_trip as _pack_case

torch.set_num_threads(1)

BANDS_XL = [21, 24, 31]


# -- (a) dispatch --------------------------------------------------------------

@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
def test_dispatch_takes_21_to_31_bands(small, monkeypatch):
    """On the card K2, K3 and K1 take a 2048-ray pass at S = 64 and 48 at
    L = 21, 24 and 31 and refuse L = 32 (the plain forward runs it); the
    wrappers raise at 32 naming 1..31, on the CPU too; K4 refuses 21."""
    monkeypatch.setattr(pipeline, "_paper_pass", lambda *a: "K3")
    flags = FeatureFlags()
    pe_dir, expr, latent = torch.zeros(2048, 24), torch.zeros(76), torch.zeros(32)
    for L in (21, 24, 31, 32):
        m = MODELS[FAMILY[small]](**_kw(L), generator=torch.Generator().manual_seed(L))
        monkeypatch.setattr(m, "forward", lambda *a, **k: "plain")
        want = L <= 31
        tset, _ = _settings(L, noise=0.0, sc=64, sf=64)
        assert pipeline._fused_model_ok(m, tset.encode_xyz, pe_dir, expr, latent) == want, L
        for S in (64, 48):
            z = torch.linspace(0.2, 0.8, S).expand(2048, S)
            out = pipeline._apply_model(m, torch.zeros(2048, 3), torch.ones(2048, 3), z, tset.encode_xyz,
                                        pe_dir, expr, latent, torch.bfloat16)
            assert out == ("K3" if want else "plain"), (L, S)
        for dev in ("cuda", "cpu"):
            assert fused_train_eligible(m, m, tset, flags, torch.bfloat16, dev, num_rays=2048) == want, (L, dev)
    with pytest.raises(ValueError, match=r"1\.\.31 xyz encoding bands"):
        K.check_bands(32)
    K.check_bands(31)
    lc = MODELS["ConditionalBlendshapeLearnableCodeNeRFModel"](**_kw(21, hidden_size=256))
    assert not F.flex_fused_eligible(lc, EncodeSpec(21, True, True), pe_dir, 2048, 64, "cuda")
    assert F.MAX_FREQS == 20 < K.MAX_FREQS == 31


# -- (b) the plain versions against the TPU kernels ------------------------------

@pytest.fixture(scope="module", params=[(s, L) for s in (False, True) for L in BANDS_XL],
                ids=[f"{'small' if s else 'paper'}-L{L}" for s in (False, True) for L in BANDS_XL])
def family(request):
    """(small, L, JAX model, JAX params, the port's module on the same weights)."""
    small, L = request.param
    jm = JAX_MODELS[FAMILY[small]](**_kw(L))
    jp = jm.init(jax.random.PRNGKey(11 + L))
    tm = MODELS[FAMILY[small]](**_kw(L))
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}), strict=True)
    assert tm.dim_xyz == 3 + 6 * L and K.xin_extent(L) == K.K_XIN_XL
    return small, L, jm, jp, tm


@pytest.mark.parametrize("S", SAMPLES)
def test_k2_plain_matches_jax_kernel_past_20_bands(family, S):
    _k2_case(family, S)


@pytest.mark.parametrize("S", SAMPLES)
def test_k3_plain_matches_jax_kernel_past_20_bands(family, S):
    _k3_case(family, S)


@pytest.mark.parametrize("S", SAMPLES)
def test_k1_plain_matches_jax_kernel_past_20_bands(family, S):
    _k1_case(family, S)


# -- (c) the layout --------------------------------------------------------------

def test_three_block_offsets_are_the_headers():
    """`w_layout(192)`'s offsets are `w_off(W_OFF_*, 192)` as the header
    computes it (its expression read and evaluated here): W0 and W3 hold
    192 encoding rows, every later offset 2·128·256 past the 10-band one;
    F_LAYOUT's 32 band slots and WT_LAYOUT (no encoding row) are the
    headers'; `xin_extent` as the header's expression gives it."""
    c = _c_constants()
    body = re.search(r"constexpr int w_off\(int off, int kx\) \{\s*return (.+?);\n\}", MMA, re.S).group(1)
    w_off = eval("lambda off, kx: " + _c_expr(" ".join(body.split())), dict(c))
    w64 = {k[6:]: v for k, v in c.items() if k.startswith("W_OFF_")}
    offs = K.w_offsets(192)
    assert {name: w_off(v, 192) for name, v in w64.items()} == offs
    assert offs["W1"] == 192 * 256 and offs["W4"] - offs["W3"] == (192 + 256) * 256
    assert w_off(w64["W3"] + 64 * 256, 192) == offs["W3"] + 192 * 256
    assert offs["TOTAL"] == K.W_OFFSETS["TOTAL"] + 2 * 128 * 256
    f = {k[6:]: v for k, v in c.items() if k.startswith("F_OFF_")}
    assert f == K.F_OFFSETS and f["TOTAL"] - f["FREQS"] == c["FREQ_SLOTS"] == 32 and f["TOTAL"] % 2 == 0
    assert T.PART_COLS % 2 == 0  # K1's partial rows: float2 pairs at even columns
    train = (CSRC / "paper_train.cuh").read_text()
    wt = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int WT_OFF_(\w+) = (\d+);", train)}
    assert wt == K.WT_OFFSETS
    ext = re.search(r"constexpr int xin_extent\(int n_freqs\) \{\s*return (.+?);\n\}", MMA, re.S).group(1)
    xin_extent = eval("lambda n_freqs: " + _c_expr("(" + " ".join(ext.split()) + ")"), dict(c))
    assert [xin_extent(L) for L in range(1, 32)] == [K.xin_extent(L) for L in range(1, 32)]
    assert [K.xin_extent(L) for L in (20, 21, 31)] == [128, 192, 192]
    assert T.ws_buffers(192)[0] == ("xin", 192)


@pytest.mark.parametrize("small", [False, True], ids=["paper", "small"])
@pytest.mark.parametrize("L", BANDS_XL)
def test_pack_and_split_round_trip_past_20_bands(L, small):
    """tests/test_torch_xyz_bands.py's round trip at 21, 24 and 31 bands:
    W0 / W3 in 192 rows, zero past 3 + 6L, three chunks of each."""
    _pack_case(L, small)


def test_encoder_writes_every_column_once_at_three_blocks():
    """At xc = 3 the encoder's 384 tasks write each of the 192 columns of
    every row once, at the workspace image's bytes (the first two blocks
    as at xc = 2)."""
    _encoder_case(3)
    three, two = _encoder_writes(3), _encoder_writes(2)
    assert {k: v for k, v in three.items() if k[1] < 128} == two


def _shared_layout(src, struct):
    """(stage bytes, ring stages, xin array bytes) of a kernel's shared
    memory struct, read from its declaration."""
    body = src[src.index(f"struct alignas(ATOM_BYTES) {struct} {{"):]
    ring = re.search(r"unsigned char ring\[(\w+)\]\[(\w+)\];", body)
    xin = re.search(r"unsigned char xin\[(\w+)\]\[2\]\[([\w* ]+)\];", body)
    return ring.group(1), ring.group(2), xin


@pytest.mark.parametrize("which", ["K2_K3f", "K1_K3b"])
def test_three_block_buffers_fit_the_ring_they_shorten(which):
    """`xin_at` at xc = 3: warpgroup wg's 24 KB buffer starts CHAIN_STAGE
    before the xin array (the ring's last stage, which xin directly
    follows: the headers' static_asserts) plus wg·24 KB. The two buffers
    are disjoint, lie inside [the last stage, the xin array's end), and
    miss every stage the ring runs at xc = 3 (`ring_stages`: one fewer);
    at xc = 1 / 2 `xin_at` is xin[wg][b] and the ring runs all stages."""
    assert ("return xc == 3 ? xin[0][0] - CHAIN_STAGE + wg * 3 * XIN_BYTES : xin[wg][b];" in CHAIN)
    assert "return xc == 3 ? RING - 1 : RING;" in CHAIN
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", CHAIN)}
    xin_bytes = 64 * 128
    stage = 64 * 256 * 2  # CHAIN_STAGE: one 64 × 256 bf16 chunk image
    assert "constexpr int CHAIN_STAGE = KCH * 256 * 2;" in CHAIN and consts["CHAIN_CONSUMERS"] == 2
    if which == "K2_K3f":
        src = (CSRC / "paper_chain.cuh").read_text()
        ring, _, _ = _shared_layout(src, "PaperChainSmem")
        assert ring == "PAPER_RING"
        n = int(re.search(r"constexpr int PAPER_RING = (\d+);", src).group(1))
        assert "ring_stages<PAPER_RING>(g.xc())" in src and "ring_stages<PAPER_RING>(kx / K_XIN)" in src
        assert "xin_at(sm.xin, wg, b, g.xc())" in src
        for cu in ("fused_paper_render.cu", "fused_paper_mlp.cu"):
            assert "smem_u32(xin_at(sm.xin, wg, b, g.xc()))" in (CSRC / cu).read_text(), cu
    else:
        src = (CSRC / "paper_train.cuh").read_text()
        ring, _, _ = _shared_layout(src, "Smem")
        assert ring == "RING"
        n = int(re.search(r"constexpr int RING = (\d+);", src).group(1))
        assert src.count("ring_stages<RING>(g.xc())") == 2 and "ring_stages<RING>(kx / K_XIN)" in src
        assert "smem_u32(xin_at(sm.xin, wg, b, g.xc()))" in src and "xin_at(sm.xin, wg, b, g.xc())" in src
    assert "offsetof(" in src and "xin follows the ring (`xin_at`)" in src
    xin0 = n * stage  # the xin array's first byte, from the ring's
    xin_end = xin0 + 2 * 2 * xin_bytes
    runs = n - 1  # the stages the ring runs at xc = 3
    spans = [(xin0 - stage + wg * 3 * xin_bytes, xin0 - stage + (wg + 1) * 3 * xin_bytes) for wg in range(2)]
    assert spans[0][1] <= spans[1][0]
    for lo, hi in spans:
        assert runs * stage <= lo and hi <= xin_end
    # the sum of shared memory is unchanged: nothing new past the ring and xin
    assert spans[1][1] - spans[0][0] == 2 * 3 * xin_bytes <= stage + 2 * 2 * xin_bytes


# -- (d) the slice: a 21-band step -------------------------------------------------

def test_21_band_step_with_injected_depths_matches_jax_fused_step(monkeypatch):
    """A 21-band paper avatar's bf16 step at 16 + 16 samples through
    `fused_losses` (K1's plain version for both passes) against the JAX
    package's fused step (its Pallas kernel in interpret mode) from the
    same weights and batch, the rays and both passes' depths on the exact
    grid and injected in both packages (their stratified and resampled
    depths replaced), the noise draws JAX's."""
    from test_torch_train import SC, SF, _jax_draws

    L, R = 21, 64
    jm = JAX_MODELS[FAMILY[False]](**_kw(L))
    jp = jm.init(jax.random.PRNGKey(4))
    rng = np.random.RandomState(1)
    params = {"coarse": dict(jp), "fine": dict(jp), "background": None,
              "latent_codes": jnp.asarray(rng.randn(4, 32).astype(np.float32) * 0.1)}
    jopt = jax_build_optimizer(JaxCfgNode(_opt_cfg()))
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params, opt_state=jopt.init(params),
                           fixed_background=None)
    flags, jflags = FeatureFlags(), JaxFlags()

    def port_model():
        return MODELS[FAMILY[False]](**_kw(L), generator=torch.Generator().manual_seed(0))

    state = create_train_state(port_model(), port_model(), flags, n_train=4)
    opt = build_optimizer(CfgNode(_opt_cfg()), state)
    ckpt.train_state_from_jax(jax.device_get(jstate), state, opt)
    tset, jset = _settings(L, 0.1, SC, SF)
    assert fused_train_eligible(state.model_coarse, state.model_fine, tset, flags, torch.bfloat16, "cuda",
                                num_rays=R)
    jb, tb = _batch(R, seed=17)
    # the rays and both passes' depths on tests/test_torch_xyz_bands.py's
    # grid: every sample point ro + rd·z is exact in f32 in both packages
    ro = _grid(rng.randn(R, 3) * 0.05 + [0, 0, 0.5], 10)
    rd = _grid(rng.randn(R, 3) * [0.2, 0.2, 0.05] - [0, 0, 1], 8)
    z_c = _grid(np.sort(0.2 + rng.rand(R, SC) * 0.6, -1), 12)
    z_f = _grid(np.sort(0.2 + rng.rand(R, SF) * 0.6, -1), 12)
    jb = dict(jb, ray_origins=jnp.asarray(ro), ray_directions=jnp.asarray(rd))
    tb = dict(tb, ray_origins=_t(ro), ray_directions=_t(rd))
    monkeypatch.setattr(jax_fused_module, "stratified_zvals", lambda *a, **k: jnp.asarray(z_c))
    monkeypatch.setattr(jax_fused_module, "sample_pdf", lambda *a, **k: jnp.asarray(z_f))
    monkeypatch.setattr(port_fused_module, "stratified_zvals", lambda *a, **k: _t(z_c))
    monkeypatch.setattr(port_fused_module, "sample_pdf", lambda *a, **k: _t(z_f))
    key = jax.random.PRNGKey(5)
    (jtot, jmet), jg = jax_fused_value_and_grad(jstate.params, jb, key, jm, jm, jset, jflags,
                                                jstate.fixed_background)
    total, metrics = fused_losses(state, tb, 0, tset, flags, draws=_jax_draws(key, R))
    total.backward()
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
        np.testing.assert_allclose(got.numpy(), v, atol=5e-3 * np.abs(v).max() + 1e-9, rtol=0, err_msg=name)
        seen += 1
    assert seen >= 30
    assert port["['fine']['layers_xyz.0.weight']"].shape == (256, 3 + 6 * L + 108)
