"""PyTorch port: the Flexible-family kernels K4f / K4b past 256 samples a
ray, up to the port's one sample limit `fused_mlp.MAX_SAMPLES` (1024).

Past ITEM_ROWS (256) rows an item is one ray in ⌈S / 64⌉ 64-row units (a
long item, `UnitLayout::of`); K4f and K4b compute and store every row on
its own, so a long item is more units of the same walk, d_dir carried
across them by `dir_pieces`.

* (a) Dispatch. One limit: `fused_flex` takes `fused_mlp`'s MAX_SAMPLES,
  `kernel_pass_ok` and `check_samples`, `fused_resample.MAX_TOTAL` is the
  same value, and so is the header's one `MAX_SAMPLES`, which every
  paper, Flexible and resample C entry point checks. Asked for the card
  (no card needed), `flex_fused_eligible` admits S up to 1024 where the
  JAX package's tile rule sends a pass to Pallas and refuses 1025, at
  both widths and at 10 and 16 bands; on the CPU the same domain. The
  wrappers raise past 1024 on the CPU too; `_apply_model` sends a long
  Flexible pass to K4 and one past the limit to the plain forward.
* (b) Layout. `unit_schedule` covers every sample row once at S in
  257..1024, at both widths (at h = 512 both warpgroups on each unit);
  the dead-unit walk is reached when the last item is long (an odd ray
  count); `workspace_layout` is `carve` replayed from the source at S =
  1024 and h = 512, past 2^31 bytes, and every unit or row offset into a
  buffer is formed in 64 bits (a source check); dW's row segments fill a
  wave and hold at most 2048 units each.
* (c) The plain versions against the JAX package's Flexible Pallas
  kernels in interpret mode at S = 257, 320, 512 and 1024 (8 rays), h =
  256 and 512, 10 and 16 bands (each value in two of the four cases),
  inputs from a numpy seed on tests/test_torch_xyz_bands.py's grid,
  weights by `params_from_jax`: raw [rgb, σ] within 2e-3·max (the stated
  limit of tests/test_torch_flex_kernel.py), every gradient by `jax.vjp`'s
  cotangent within 0.08·max and 0.04·‖·‖.
* (d) The slice: synth512_lcode_64_256's sample counts (64 + 256, the
  fine passes at S = 320) in a bf16 step through `compute_losses` (K4's
  plain version for both passes) against the JAX package's bf16 step
  through its Flexible Pallas kernel in interpret mode, with the JAX
  draws (tests/test_torch_flex_bands.py's limits: loss rtol 1e-3, the
  coarse model and the latent codes 5e-3·max, the fine model 0.06·max);
  one f32 `train()` step and one f32 `render_full_frame` against the JAX
  package's.
"""

import copy
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerface_tpu.ops.pallas.fused_mlp as jax_fused_mlp
from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.config.flags import FeatureFlags as JaxFlags
from nerface_tpu.data.flame import load_flame_data as jax_load_flame_data
from nerface_tpu.data.synthetic import make_synthetic_flame_dataset
from nerface_tpu.eval.renderer import render_full_frame as jax_render_full_frame
from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.ops import sampling as jsamp
from nerface_tpu.ops.encoding import _encoding_matrix
from nerface_tpu.ops.pallas import fused_flex as JF
from nerface_tpu.ops.pallas.fused_mlp import _pick_rays_per_tile as jax_pick_rays_per_tile
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerface_tpu.train.loop import train as jax_train
from nerface_tpu.train.state import TrainState as JaxTrainState
from nerface_tpu.train.state import build_optimizer as jax_build_optimizer
from nerface_tpu.train.step import _compute_losses
from nerface_tpu_torch.config import CfgNode, FeatureFlags
from nerface_tpu_torch.data.flame import load_flame_data
from nerface_tpu_torch.eval.renderer import render_full_frame
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.ops.kernels import fused_flex as F
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_resample as K5
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings
from nerface_tpu_torch.train import checkpoint as ckpt
from nerface_tpu_torch.train.checkpoint import params_from_jax
from nerface_tpu_torch.train.loop import build_models_from_cfg, train
from nerface_tpu_torch.train.state import build_optimizer, create_train_state
from nerface_tpu_torch.train.step import compute_losses
from test_torch_flex_bands import _jax_weights
from test_torch_flex_train import OPT, _batch
from test_torch_flex_train import _train_cfg as _flex_train_cfg
from test_torch_flex_width import _carve_replay, _jax_fold
from test_torch_train import pin_numpy_feeds
from test_torch_xyz_bands import _grid

torch.set_num_threads(1)

CSRC = pathlib.Path(F.__file__).resolve().parents[2] / "csrc"
NAME = "ConditionalBlendshapeLearnableCodeNeRFModel"
LIMIT = 1024
FAR = 0.8
N = 3  # hidden layers: every bundled config's num_layers 4
# synth512_lcode_64_256: the paper's 64 coarse samples, 256 fine
SC, SF = 64, 256
# (S, h, bands): each S once, each width and band count twice
CASES = [(257, 256, 10), (320, 512, 16), (512, 256, 16), (LIMIT, 512, 10)]


def _kw(L=10, h=256, n=N):
    # skip_connect_every past the last layer: no skip engages
    return dict(num_layers=n + 1, hidden_size=h, skip_connect_every=n + 2, num_encoding_fn_xyz=L,
                num_encoding_fn_dir=4, include_input_dir=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_rule(n_rays, n_samples):
    """The JAX pipeline's test for its Pallas Flexible kernel: a ray tile of
    `_pick_rays_per_tile` (`fused_paper_mlp_available` without its
    TPU-backend test)."""
    tr = jax_pick_rays_per_tile(n_rays, n_samples)
    return tr >= 8 and n_rays % tr == 0


def _code(name):
    """A source file without its comments."""
    return re.sub(r"//.*", "", (CSRC / name).read_text())


# -- (a) dispatch ----------------------------------------------------------------

def test_one_sample_limit_for_every_kernel():
    """`fused_flex` and `fused_resample` read `fused_mlp`'s limit, and the
    header's one `MAX_SAMPLES` is that value: the paper entry points, K4's
    `valid` and K5's entry check it, and no second constant is left."""
    assert K.MAX_SAMPLES == F.MAX_SAMPLES == K5.MAX_TOTAL == LIMIT
    assert F.kernel_pass_ok is K.kernel_pass_ok and F.check_samples is K.check_samples
    chain = _code("wgmma_chain.cuh")
    assert chain.count("constexpr int MAX_SAMPLES = 1024;") == 1
    for path in CSRC.glob("*.cu*"):
        text = path.read_text()
        assert "PAPER_MAX_SAMPLES" not in text and not re.search(r"MAX_SAMPLES = (?!1024)", text), path.name
    check = "if (n_samples < 1 || n_samples > MAX_SAMPLES) return (int)cudaErrorInvalidValue;"
    for name, n in (("fused_paper_render.cu", 1), ("fused_train_pass.cu", 1), ("fused_paper_mlp.cu", 2)):
        assert _code(name).count(check) == n, name
    flex = _code("fused_flex.cu")
    valid = flex[flex.index("bool valid("):flex.index("}", flex.index("bool valid("))]
    assert "n_samples >= 1 && n_samples <= MAX_SAMPLES" in valid
    k5 = _code("fused_resample.cu")
    assert '#include "wgmma_chain.cuh"' in k5
    assert "constexpr int MAX_OUT = nerface::sm90::MAX_SAMPLES;" in k5
    assert "static_assert(MAX_OUT == 1024" in k5
    assert "n_coarse < MIN_COARSE || n_fine < 1 || n_coarse + n_fine > MAX_OUT" in k5


@pytest.mark.parametrize("h,L", [(256, 10), (512, 16)], ids=["h256-L10", "h512-L16"])
def test_flex_dispatch_takes_the_limit(h, L):
    """On the card K4 takes a pass where the JAX package takes its Pallas
    kernel, S up to 1024, and not at 1025; on the CPU every ray count in
    that domain."""
    m = MODELS[NAME](**_kw(L, h))
    enc, pe_dir = EncodeSpec(L, True, True), torch.zeros(4, 24)
    for R in (8, 2047, 2048, 2072):
        for S in (256, 257, 320, 384, 512, 1000, LIMIT - 1, LIMIT, LIMIT + 1, 2048):
            want = S <= LIMIT and _jax_rule(R, S)
            assert want == (S <= LIMIT and R % 8 == 0), (R, S)  # JAX tiles 8 rays past 128
            for dev in ("cuda", torch.device("cuda", 0)):
                assert F.flex_fused_eligible(m, enc, pe_dir, R, S, dev) == want, (R, S)
            assert F.flex_fused_eligible(m, enc, pe_dir, R, S, "cpu") == (S <= LIMIT), (R, S)
            assert F.kernel_pass_ok(R, S) == want


def test_wrappers_raise_past_the_limit():
    """K4f / K4b at S = 1025 (or 0) raise a ValueError naming 1..1024 on the
    CPU too, whose wrappers run the plain versions, and S = 1024 runs; K5
    refuses Sc + Sf = 1025 and takes 1024 in both regimes."""
    from nerface_tpu_torch.tools.perf.cases import flex_case

    for S in (LIMIT + 1, 0, LIMIT):
        c = flex_case(2, max(S, 1), 0, torch.device("cpu"), 1)
        g = c["g"]
        args = (c["weights"], c["ro"], c["rd"], c["z"][:, :S].contiguous(), c["dc"], c["v0"])
        if S == LIMIT:
            assert F.fused_flex_forward(*args, 1).shape == (2, LIMIT, 4)
            assert F.fused_flex_backward(*args, g, 1)[2].shape == (2, 128)
            continue
        with pytest.raises(ValueError, match=r"1\.\.1024 samples per ray"):
            F.fused_flex_forward(*args, 1)
        with pytest.raises(ValueError, match=r"1\.\.1024 samples per ray"):
            F.fused_flex_backward(*args, g[:, :S].contiguous(), 1)
    z = torch.sort(torch.rand(2, 64), -1).values
    with pytest.raises(ValueError, match="at most 1024"):
        K5.fused_resample(z, torch.rand(2, 64), torch.rand(2, 961))
    u = torch.sort(torch.rand(960)).values
    for sorted_u in (False, True):
        assert K5.fused_resample(z, torch.rand(2, 64), u, sorted_u).shape == (2, LIMIT)


def test_apply_model_sends_a_long_flexible_pass_to_k4(monkeypatch):
    """A bf16 Flexible pass at S = 257, 320 and 1024 goes to K4 (asked for
    the card), one at 1025 to the model's plain forward."""
    taken = []
    real = pipeline.flex_fused_eligible
    monkeypatch.setattr(pipeline, "flex_fused_eligible",
                        lambda model, enc, pe, R, S, dev: real(model, enc, pe, R, S, "cuda"))
    monkeypatch.setattr(pipeline, "_flex_pass", lambda *a: taken.append(a[3].shape[-1]) or "K4")
    m = MODELS[NAME](**_kw())
    monkeypatch.setattr(m, "forward", lambda *a, **k: "plain")
    expr, latent = torch.zeros(76), torch.zeros(32)
    for S in (257, 320, LIMIT, LIMIT + 1):
        z = torch.linspace(0.2, 0.8, S).expand(8, S)
        out = pipeline._apply_model(m, torch.zeros(8, 3), torch.ones(8, 3), z, EncodeSpec(10, True, True),
                                    torch.zeros(8, 24), expr, latent, torch.bfloat16)
        assert out == ("K4" if S <= LIMIT else "plain"), S
    assert taken == [257, 320, LIMIT]


# -- (b) layout --------------------------------------------------------------------

def _rows_of(R, S, h):
    """How often the live units of `unit_schedule` store each sample row,
    by the kernels' row arithmetic (item row i of unit u is u·64 + t, real
    below rays·S, the pass's row ray0·S + i, its ray by `ray_of`'s
    multiply-shift), once a unit (at h = 512 both warpgroups store their
    columns of the same rows)."""
    rays, units = F.unit_layout(S)
    div = ((1 << 24) + S - 1) // S
    seen = np.zeros(R * S, np.int32)
    for _, _, wg, unit, live in F.unit_schedule(R, S, h):
        if not live or (h != 256 and wg == 1):
            continue
        item, u = divmod(unit, units)
        i = u * 64 + np.arange(64)
        q = (i * div) >> 24
        real = i < rays * S
        assert (q[real] == i[real] // S).all()
        if (~real).any():
            assert u == units - 1
        store = real & (item * rays + q < R)
        seen[item * rays * S + i[store]] += 1
    return seen


@pytest.mark.parametrize("h", [256, 512])
def test_long_schedule_covers_every_row_once(h):
    """At every S in 257..1024 an item is one ray in ⌈S / 64⌉ units and
    the schedule stores each sample row once (3 rays); past one round of
    the 132-CTA grid too (2·132 + 3 rays) at S = 257, 320, 1000 and
    1024."""
    for S in range(257, LIMIT + 1):
        assert F.unit_layout(S) == (1, -(-S // 64))
        assert (_rows_of(3, S, h) == 1).all(), S
    for S in (257, 320, 1000, LIMIT):
        R = 2 * F.FLEX_CTAS + 3
        assert (_rows_of(R, S, h) == 1).all(), S
        sched = F.unit_schedule(R, S, h)
        assert len(sched) == (-(-R // 2) * 2 if h == 256 else 2 * R) * -(-S // 64)


def test_dead_unit_walk_with_a_long_last_item():
    """h = 256: at an odd ray count the last round's warpgroup-1 item is
    past the last ray, a long item of five units at S = 320, which the
    recompute and dX skip (`skip_stages`); at 2072 rays no item is dead
    and the last round of the persistent grid is cut short (CTAs 0..111
    take 8 rounds, the others 7). h = 512 walks no dead item."""
    rounds = -(-2071 // 2)
    dead = [(c, r, wg, unit) for c, r, wg, unit, ok in F.unit_schedule(2071, 320) if not ok]
    assert [d[:3] for d in dead] == [((rounds - 1) % F.FLEX_CTAS, rounds - 1, 1)] * 5
    assert [d[3] for d in dead] == list(range(2071 * 5, 2072 * 5))
    sched = F.unit_schedule(2072, 320)
    assert all(ok for *_, ok in sched)
    per_cta = np.bincount([c for c, r, wg, u, ok in sched if wg == 0 and u % 5 == 0], minlength=F.FLEX_CTAS)
    assert (per_cta[:1036 % F.FLEX_CTAS] == 8).all() and (per_cta[1036 % F.FLEX_CTAS:] == 7).all()
    assert all(ok for *_, ok in F.unit_schedule(2071, 320, 512))
    assert F.flex_ctas(2071, 320, 512) == F.flex_ctas(2071, 320) == F.FLEX_CTAS


@pytest.mark.parametrize("h,kx", [(256, 64), (512, 64), (512, 128)])
def test_workspace_at_the_limit(h, kx):
    """K4b's workspace at 2048 rays × S = 1024 is `carve` replayed from the
    source: 11.53 GiB at h = 256, 22.84 GiB at h = 512 (23.09 at K = 128),
    past 2^31 bytes, as its h-wide buffers alone are from unit 16384 on;
    dW's row segments fill a wave (12 at h = 256, 3 at h = 512, n = 3) and
    hold at most DW_SEG_UNITS = 2048 units: 16 of them at 2048 × 1024 (the
    source's constant and rule)."""
    offs, total = F.workspace_layout(2048, LIMIT, N, h, kx)
    got, got_total = _carve_replay(2048, LIMIT, N, h, kx)
    assert got_total == total
    want = {256: 11.53, 512: 22.84 if kx == 64 else 23.09}[h]
    assert abs(total / 2 ** 30 - want) < 0.01, total / 2 ** 30
    units = 2048 * 16
    assert offs["a0"] - offs["xin"] == units * kx * 128
    assert units * h * 128 >= 2 ** 31 if h == 512 else (N + 1) * units * h * 128 >= 2 ** 31
    assert F.dw_segments(N, h, kx) == {256: 12, 512: 3}[h]
    assert F.dw_segments(N, h, kx, units) == 16 and F.dw_segments(N, h, kx, 2048 * 4) == {256: 12, 512: 4}[h]
    cu = _code("fused_flex.cu")
    assert f"constexpr int DW_SEG_UNITS = {F.DW_SEG_UNITS};" in cu
    assert "const int rows = (units + DW_SEG_UNITS - 1) / DW_SEG_UNITS;" in cu and "return wave > rows ? wave : rows;" in cu
    assert cu.count("dw_segments_of(L, units)") == 2


def test_in_buffer_offsets_are_formed_in_64_bits():
    """Every product of a unit, a row or a buffer index with a byte or
    element size inside K4b's workspace and K4's rows is formed in 64 bits
    (a pass reaches 32768 units and 2M rows at 2048 × 1024, the h = 512
    buffers 2^31 bytes): `unit_image`, `unit_mask`, `wide_mask`, `carve`,
    `Workspace::act` / `gpre` / `amask` (size_t strides), dW's column
    blocks and its bulk loads, and the rows of z, the output and g."""
    cu = _code("fused_flex.cu")
    for line in ("return buf + (size_t)unit * width * ROW_BYTES;",
                 "return buf + (size_t)unit * (MASK_BYTES / 4) + 4 * (threadIdx.x & 127);",
                 "return buf + (size_t)unit * (WIDE_MASK_BYTES / 4) + 4 * (wg * 128 + (threadIdx.x & 127));",
                 "size_t hbytes;", "size_t mask_words;",
                 "return act0 + i * hbytes;", "return gpre0 + i * hbytes;", "return amask0 + i * mask_words;",
                 "w.hbytes = (size_t)units * L.h * ROW_BYTES;", "w.mask_words = (size_t)units * L.mask_bytes / 4;",
                 "take((size_t)units * width * ROW_BYTES)", "run((size_t)units * width * ROW_BYTES, count)",
                 "run((size_t)units * L.mask_bytes, count)", "G ? G + (size_t)c * ROW_BYTES : nullptr"):
        assert line in cu, line
    # no unit, row or ray index multiplied in 32 bits
    for m in re.finditer(r"(\(size_t\))?\b(unit|ray0|ray|row)\s*\*\s*(\w+)", cu):
        if m.group(2) == "ray" and m.group(3) == "3":
            continue  # ro / rd (R, 3): below 2^31 at any ray count the card holds
        if m.group(2) == "row" and m.group(3) == "4":
            assert re.search(r"const size_t row = ", cu)  # `row` is a size_t where it scales g / out
            continue
        assert m.group(1), m.group(0)
    dw = _code("wgmma_dw.cuh")
    assert "M.G + (size_t)u * M.g_ld * ROW_BYTES" in dw and "M.X + (size_t)u * M.kdim * ROW_BYTES" in dw
    chain = _code("wgmma_chain.cuh")
    assert "a.z[(size_t)ray * g.samples() + (row - q * g.samples())]" in chain



def test_exact_dw_check_reads_k4bs_products():
    """chip_smoke.py's exact dW check for K4b (`flex_dw_exact`) reads the
    products of K4b's dW launch (`fused_flex.cu::dw_products`: W1 from xin
    and ga0, WF from a_n and gfeat, WD0 from feat and gx0, each WH_i from
    a_i and gpre_i), and `_dw_exact_check` sums Xᵀ·gY in chunks of units:
    a dW equal to the product passes, one without a unit's rows fails."""
    from types import SimpleNamespace

    import chip_smoke as C
    from nerface_tpu_torch.ops.kernels import fused_train as T

    cu = _code("fused_flex.cu")
    body = cu[cu.index("void dw_products("):cu.index("int dw_segments_of(")]
    for line in ("blocks(ws.xin, ws.ga0, L.kx, L.h, 0);", "blocks(ws.act0 ? ws.act(L.n) : nullptr, ws.gfeat, L.h, L.h, L.wf);",
                 "blocks(ws.feat, ws.gx0, L.h, L.dh, L.wd0);",
                 "blocks(ws.act0 ? ws.act(i) : nullptr, ws.gpre0 ? ws.gpre(i) : nullptr, L.h, L.h, L.wh + i * L.h * L.h);"):
        assert line in body, line
    assert C.flex_dw_products(2, 256, 64) == [("w1", "W1", "xin", "ga0"), ("wf", "WF", "a2", "gfeat"),
                                              ("wd0", "WD0", "feat", "gx0"), ("wh0", "WH0", "a0", "gpre0"),
                                              ("wh1", "WH1", "a1", "gpre1")]
    for n in (0, 3):
        names = set(dict(F.workspace_buffers(n, 512, 128)))
        assert all(x in names and g in names for _, _, x, g in C.flex_dw_products(n, 512, 128))
    gen = torch.Generator().manual_seed(0)
    units, wx, wg = 5, 128, 64
    X = torch.randn(64 * units, wx, generator=gen).to(torch.bfloat16)
    G = torch.randn(64 * units, wg, generator=gen).to(torch.bfloat16)
    ws = torch.cat([T.workspace_image(m).view(torch.uint8) for m in (X, G)])
    prods = [("p", 0, wx, X.numel() * 2, wg, 3)]
    exact = X.double().T @ G.double()
    lost = slice(128, 192)  # unit 2
    for dw, ok in ((exact, True), (exact - X[lost].double().T @ G[lost].double(), False)):
        launch = SimpleNamespace(ws=ws, out={"dw": torch.cat([torch.zeros(3), dw.float().reshape(-1)])})
        if ok:
            (e, e_norm, f, f_norm), = C._dw_exact_check(launch, prods, units, 2, "t", True, chunk=2).values()
            assert e < 1e-6 and e_norm < 1e-6 and min(f, f_norm) > C.DW_EXACT_TOL
        else:
            with pytest.raises(C.SmokeFailure, match="off Xᵀ·gY"):
                C._dw_exact_check(launch, prods, units, 2, "t", True, chunk=2)

# -- (c) the plain versions against the TPU kernels ------------------------------

def _inputs(R, S, seed):
    """Rays on the grid where ro + rd·z is exact in f32
    (tests/test_torch_xyz_bands.py's `_inputs`), the conditioning and a
    cotangent."""
    rng = np.random.RandomState(seed)
    f = np.float32
    step = _grid(rng.rand(R, S) * ((FAR - 0.2) / S), 12).clip(2.0 ** -12)
    return dict(
        ro=_grid(rng.randn(R, 3) * 0.05 + [0, 0, 0.5], 10),
        rd=_grid(rng.randn(R, 3) * [0.2, 0.2, 0.05] - [0, 0, 1], 8),
        z=_grid(0.2 + np.cumsum(step.astype(np.float64), -1), 12),
        pe_dir=rng.randn(R, 24).astype(f), expr=(rng.randn(76) * 0.1).astype(f),
        latent=(rng.randn(32) * 0.1).astype(f), g=rng.randn(R, S, 4).astype(f),
    )


@pytest.mark.parametrize("case", CASES, ids=[f"S{S}-h{h}-L{L}" for S, h, L in CASES])
def test_plain_matches_jax_kernel(case):
    """K4f's and K4b's plain versions against `_fused_flex_fwd` /
    `_fused_flex_bwd` in interpret mode (8 rays, two grid steps of 4)."""
    S, h, L = case
    R = 8
    jm = JAX_MODELS[NAME](**_kw(L, h))
    jp = jm.init(jax.random.PRNGKey(S + h + L))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    x = _inputs(R, S, seed=S + L)
    v0, dc = _jax_fold(jm, jp, x, h)
    C, phase = _encoding_matrix(3, L, True)
    args = tuple(jnp.asarray(a) for a in (x["ro"], x["rd"], x["z"], dc, v0, C, phase[None, :]))
    out, res = JF._fused_flex_fwd(S, 4, N, h, *args, *_jax_weights(jp, h, N, L))
    jgrads = JF._fused_flex_bwd(S, 4, N, h, res, jnp.asarray(x["g"]))
    weights = F.pack_flex_weights(tp, N, L)
    targs = (weights, _t(x["ro"]), _t(x["rd"]), _t(x["z"]), _t(dc), _t(v0))
    got = F.fused_flex_forward(*targs, N, L)  # the wrapper on CPU tensors: the plain version
    out = np.asarray(out)
    assert got.shape == out.shape == (R, S, 4)
    raw = np.abs(got.numpy() - out).max() / np.abs(out).max()
    assert raw <= 2e-3, raw
    grads, d_v0, d_dir = F.fused_flex_backward(*targs, _t(x["g"]), N, L)
    wn, bn = F.weight_names(N)
    worst = (0.0, 0.0)
    for k, a, b in zip(wn + bn + ("v0", "dir"), grads + (d_v0, d_dir), jgrads[7:] + (jgrads[4], jgrads[3])):
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        assert a.shape == b.shape, k
        e_max = float(np.abs(a - b).max() / np.abs(b).max())
        e_norm = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert e_max <= 0.08 and e_norm <= 0.04, (k, e_max, e_norm)
        worst = (max(worst[0], e_max), max(worst[1], e_norm))
    print(f"S={S} h={h} L={L}: raw {raw:.2e}·max, gradients ≤ {worst[0]:.2e}·max, {worst[1]:.2e}·norm")


# -- (d) the slice at 64 + 256 ------------------------------------------------------

def _jax_draws(key, R):
    """The JAX step's draws at 64 + 256 (`step.py`'s key split)."""
    idx = jnp.arange(R, dtype=jnp.int32)
    k_strat, k_noise_c, k_pdf, k_noise_f = jax.random.split(key, 4)
    d = {"t_rand": jsamp.per_ray_uniform(k_strat, idx, SC), "noise_c": jsamp.per_ray_normal(k_noise_c, idx, SC),
         "u": jsamp.per_ray_uniform(k_pdf, idx, SF), "noise_f": jsamp.per_ray_normal(k_noise_f, idx, SC + SF)}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_step_at_64_plus_256_matches_jax_step(monkeypatch):
    """A LearnableCode avatar's bf16 step at 64 + 256 samples through
    `compute_losses` (K4's plain version at S = 64 and 320) against the
    JAX package's bf16 step through its Flexible Pallas kernel, from the
    same weights, batch and draws."""
    Rs = 8
    jm = JAX_MODELS[NAME](**_kw())
    jp = jm.init(jax.random.PRNGKey(5))
    rng = np.random.RandomState(1)
    params = {"coarse": dict(jp), "fine": dict(jp), "background": None,
              "latent_codes": jnp.asarray(rng.randn(4, 32).astype(np.float32) * 0.1)}
    jopt = jax_build_optimizer(JaxCfgNode(dict(OPT)))
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params, opt_state=jopt.init(params),
                           fixed_background=None)
    flags = FeatureFlags()
    state = create_train_state(MODELS[NAME](**_kw()), MODELS[NAME](**_kw()), flags, n_train=4)
    opt = build_optimizer(CfgNode(dict(OPT)), state)
    ckpt.train_state_from_jax(jax.device_get(jstate), state, opt)
    common = dict(num_coarse=SC, num_fine=SF, perturb=True, radiance_field_noise_std=0.1, near=0.2, far=FAR)
    tset = RenderSettings(**common, encode_xyz=EncodeSpec(10, True, True), encode_dir=EncodeSpec(4, False, True))
    jset = JaxRenderSettings(**common, encode_xyz=JaxEncodeSpec(10, True, True),
                             encode_dir=JaxEncodeSpec(4, False, True), fused="on")
    # the JAX pipeline's tile rule without its TPU-backend test: its
    # Flexible Pallas kernel runs in interpret mode on the CPU
    monkeypatch.setattr(jax_fused_mlp, "fused_paper_mlp_available", lambda n, tr: tr >= 8 and n % tr == 0)
    jcalls, calls = [], []
    jreal, real = JF.fused_flex_mlp, pipeline.fused_flex_mlp
    monkeypatch.setattr(JF, "fused_flex_mlp", lambda *a, **k: jcalls.append(a[3].shape) or jreal(*a, **k))
    monkeypatch.setattr(pipeline, "fused_flex_mlp", lambda *a, **k: calls.append(a[3].shape) or real(*a, **k))
    jb, tb = _batch(Rs, seed=9)
    key = jax.random.PRNGKey(2)

    def loss_fn(p):
        return _compute_losses(p, jb, key, jm, jm, jset, JaxFlags(), None, dtype=jnp.bfloat16)

    (jtot, _), jg = jax.value_and_grad(loss_fn, has_aux=True)(jstate.params)
    assert jcalls == [(Rs, SC), (Rs, SC + SF)]  # both passes through JAX's Flexible kernel
    total, _ = compute_losses(state, tb, 0, tset, flags, dtype=torch.bfloat16, draws=_jax_draws(key, Rs))
    total.backward()
    assert calls == [(Rs, SC), (Rs, SC + SF)]  # both passes through K4 (its plain version here)
    np.testing.assert_allclose(float(total.detach()), float(jtot), rtol=1e-3)
    port = {}
    for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
        for name, p in m.named_parameters():
            port[f"['{which}']['{name}']"] = p.grad
    port["['latent_codes']"] = state.latent_codes.grad
    seen, worst = 0, {}
    for path, v in jax.tree_util.tree_leaves_with_path(jg):
        name, v = jax.tree_util.keystr(path), np.asarray(v)
        got = port[name].numpy()
        tol = 0.06 if name.startswith("['fine']") else 5e-3
        worst[name] = float(np.abs(got - v).max() / max(np.abs(v).max(), 1e-30))
        np.testing.assert_allclose(got, v, atol=tol * np.abs(v).max() + 1e-9, rtol=0, err_msg=name)
        seen += 1
    assert seen == 2 * 16 + 1  # 8 layers a model, the latent table
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    print(f"64 + 256 step: loss {float(total.detach()):.6f} vs {float(jtot):.6f}; worst gradients (·max) {top}")


def test_train_at_64_plus_256_matches_jax_train(tmp_path, capsys, monkeypatch):
    """One f32 `train()` step of a LearnableCode avatar at 64 + 256 (perturb
    off, σ-noise 0) on a 32² image, 32 rays, from the same reference-schema
    checkpoint, against JAX `train()`, both host feeds on their numpy
    paths (tests/test_torch_flex_train.py's whole-slice limits)."""
    pin_numpy_feeds(monkeypatch)
    ds_dir = make_synthetic_flame_dataset(str(tmp_path / "ds"), H=32, W=32, n_train=2, n_val=1, n_test=1,
                                          num_samples=8)
    d = _flex_train_cfg(ds_dir, str(tmp_path / "runs"))
    d["experiment"]["train_iters"] = 1
    for node in (d["nerf"]["train"], d["nerf"]["validation"]):
        node.update(num_coarse=SC, num_fine=SF)
    d["nerf"]["train"]["num_random_rays"] = 32
    cfg = CfgNode(d)
    mc, mf = build_models_from_cfg(cfg, generator=torch.Generator().manual_seed(6))
    start = str(tmp_path / "start.ckpt")
    torch.save({"iter": 0, "model_coarse_state_dict": mc.state_dict(),
                "model_fine_state_dict": mf.state_dict(), "optimizer_state_dict": None,
                "loss": 0.0, "psnr": 0.0, "background": None,
                "latent_codes": torch.zeros(2, 32)}, start)
    jstate = jax_train(JaxCfgNode(copy.deepcopy(d)), load_checkpoint=start,
                       dataset=jax_load_flame_data(ds_dir), log=False)
    jax_losses = [float(v) for v in re.findall(r"\[TRAIN\] Iter: \d+ Loss: ([0-9.]+)", capsys.readouterr().out)]
    state = train(cfg, load_checkpoint=start, dataset=load_flame_data(ds_dir), device="cpu")
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
    np.testing.assert_allclose(state.latent_codes.detach().numpy(),
                               np.asarray(jstate.params["latent_codes"]), atol=10 * lr)


def test_frame_at_64_plus_256_matches_jax():
    """One f32 `render_full_frame` of a 16² frame at 64 + 256 samples
    (perturb off, σ-noise 0), a LearnableCode model's weights from JAX,
    against the JAX package's: every map atol 1e-4, disparity rtol 1e-4."""
    H = W = 16
    intr = np.array([20.0, 20.0, 0.5, 0.5], np.float32)
    pose = np.eye(4, dtype=np.float32)[:3, :4]
    jmodel = JAX_MODELS[NAME](**_kw())
    kc, kf = jax.random.split(jax.random.PRNGKey(8))
    pc, pf = jmodel.init(kc), jmodel.init(kf)
    models = []
    for p in (pc, pf):
        m = MODELS[NAME](**_kw())
        m.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in p.items()}), strict=True)
        models.append(m.eval().requires_grad_(False))
    rng = np.random.RandomState(8)
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
