"""PyTorch port: the Flexible family's kernels (K4f, K4b) at 11 to 20 xyz
encoding bands.

Past 10 bands the encoding [xyz; PE] has 69..123 columns: K4 pads it to K =
128 (two 64-column blocks, `fused_mlp.xin_extent`), W1 holds 128 rows
(`w_offsets(n, h, 128)`: every later weight moves by 64·h), and K4b's
workspace image of xin and W1's dW product are 128 wide. The 10-band
layout keeps K = 64 and its weight offsets; the f32 rows' FREQS holds 20
bands now (was 16), which moves BH_i by 4 at every band count.

* (a) Dispatch. Asked for the card (`device="cuda"`, no card needed),
  `flex_fused_eligible` takes a LearnableCode model at L = 1..20 at hidden
  width 256 and 512 and refuses 21, and `_apply_model` sends L = 1..20 to
  K4 and 21 to the model's plain forward; the wrappers raise a ValueError
  naming 1..20 past it, on the CPU too.
* (b) K4's plain versions against the JAX package's Pallas kernels
  `_fused_flex_fwd` / `_fused_flex_bwd` in interpret mode at L = 11, 16
  and 20, S = 16 and 48, h = 256 and 512, one hidden layer, inputs from a
  numpy seed on tests/test_torch_xyz_bands.py's grid (ro + rd·z exact in
  f32: the top band multiplies a point's last ulp into 0.03 rad), with
  tests/test_torch_flex_kernel.py's stated tolerances: raw [rgb, σ] within
  2e-3·max|JAX| (`RAW_TOL`; that file read ≤ 1.0e-3 over 10 draws, this
  one up to 1.23e-3 at h = 512, L = 11, S = 48), each gradient, d_v0 and
  d_dir within 0.08·max|JAX| and 0.04·‖JAX‖ (read ≤ 6.2e-2·max at h =
  256, L = 11, S = 16, one flipped bf16 rounding; ≤ 1.0e-2·‖·‖; `-s`
  prints each case).
* (c) Layout. `w_offsets` / `f_offsets` / `wt_offsets` at kx = 128 against
  `fused_flex.cu`'s `flex_w_off` and `flex_layout`, their expressions read
  from the source and evaluated here; the 10-band offsets pinned (and the
  new F offsets: BH0 at 664 / 1304); packing at 16 and 20 bands and
  splitting back (`_split_kernel_grads`) round-trips every matrix, the
  kernels' one gather giving the chunk images of the packed weights;
  `workspace_buffers`, `dw_products` and `workspace_layout` against `carve`
  and `dw_products` replayed from the source at kx = 128; the kernels'
  xin protocol at two blocks (`xin_buf` / `xin_phase`, the dead unit's
  stage count, the wide encoder's tasks) as read from the source.
* (d) The slice as a whole: a 16-band LearnableCode avatar's bf16 step at
  16 + 16 samples through `compute_losses` (`render_rays`, K4's plain
  version on CPU tensors for both passes) against the JAX package's step
  (`_compute_losses` under `jax.value_and_grad`, bf16, `fused="on"`: its
  Flexible Pallas kernel in interpret mode for both passes, reached by
  giving `fused_paper_mlp_available` its tile rule without the TPU-backend
  test) with the JAX draws injected: loss rtol 1e-3, the coarse model's
  and the latent codes' gradients within 5e-3·max, the fine model's within
  0.06·max: its depths follow the coarse weights, which the two packages'
  bf16 sums give a few 1e-3 apart, and the 2^15 top band turns that into
  phases that no longer agree (tests/test_torch_xyz_bands.py's reasoning
  for the paper model's step). Readings: loss equal to 6 digits, the
  coarse model ≤ 1.1e-3·max, the latent codes 1.8e-4, the fine model's
  fc_feat 0.059 (weight and bias: one relu of feat flipped by the shifted
  depths moves a whole row), every other fine tensor ≤ 0.011.
"""

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
from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.ops.encoding import _encoding_matrix
from nerface_tpu.ops.pallas import fused_flex as JF
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerface_tpu.train.state import TrainState as JaxTrainState
from nerface_tpu.train.state import build_optimizer as jax_build_optimizer
from nerface_tpu.train.step import _compute_losses
from nerface_tpu_torch.config import CfgNode, FeatureFlags
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.ops.kernels import fused_flex as F
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings
from nerface_tpu_torch.train import checkpoint as ckpt
from nerface_tpu_torch.train.checkpoint import params_from_jax
from nerface_tpu_torch.train.state import build_optimizer, create_train_state
from nerface_tpu_torch.train.step import compute_losses
from test_torch_flex_train import OPT, SC, SF, _batch, _jax_draws
from test_torch_flex_width import _carve_replay, _jax_fold
from test_torch_k2_layout import unpack_chunk_image
from test_torch_xyz_bands import _c_expr, _grid

torch.set_num_threads(1)

CU = (pathlib.Path(F.__file__).resolve().parents[2] / "csrc" / "fused_flex.cu").read_text()
CHAIN = (pathlib.Path(F.__file__).resolve().parents[2] / "csrc" / "wgmma_chain.cuh").read_text()
NAME = "ConditionalBlendshapeLearnableCodeNeRFModel"
BANDS = [11, 16, 20]
SAMPLES = [16, 48]
WIDTHS = [256, 512]
R, N = 8, 1  # rays and hidden layers of (b)
FAR = 0.8
RAW_TOL = 2e-3


def _kw(L, h=256, n=3):
    # skip_connect_every past the last layer: no skip engages
    return dict(num_layers=n + 1, hidden_size=h, skip_connect_every=n + 2, num_encoding_fn_xyz=L,
                num_encoding_fn_dir=4, include_input_dir=False)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- (a) dispatch --------------------------------------------------------------

@pytest.mark.parametrize("h", WIDTHS)
def test_dispatch_takes_1_to_20_bands(h, monkeypatch):
    """On the card K4 takes a 2048-ray pass at S = 64 and 48 for L = 1..20
    and refuses 21 (the plain forward runs it); on the CPU the same band
    rule holds."""
    taken = []
    monkeypatch.setattr(pipeline, "_flex_pass", lambda *a: taken.append(a[4].num_encoding_functions) or "K4")
    pe_dir, expr, latent = torch.zeros(2048, 24), torch.zeros(76), torch.zeros(32)
    for L in range(1, 22):
        m = MODELS[NAME](**_kw(L, h), generator=torch.Generator().manual_seed(L))
        monkeypatch.setattr(m, "forward", lambda *a, **k: "plain")
        want, enc = L <= 20, EncodeSpec(L, True, True)
        for S in (64, 48):
            for dev in ("cuda", torch.device("cuda", 0), "cpu"):
                assert F.flex_fused_eligible(m, enc, pe_dir, 2048, S, dev) == want, (L, S, dev)
            z = torch.linspace(0.2, 0.8, S).expand(2048, S)
            out = pipeline._apply_model(m, torch.zeros(2048, 3), torch.ones(2048, 3), z, enc, pe_dir, expr, latent,
                                        torch.bfloat16)
            assert out == ("K4" if want else "plain"), (L, S)
    assert taken == [L for L in range(1, 21) for _ in (64, 48)]


def test_wrappers_raise_past_20_bands():
    """A direct call of K4f or K4b at L = 21 (or 0) raises a ValueError
    naming 1..20, on the CPU too; L = 20 runs."""
    from nerface_tpu_torch.tools.perf.cases import flex_case

    for L in (21, 0, 20):
        c = flex_case(2, 8, 0, torch.device("cpu"), 1, 256, max(L, 1))
        args = (c["weights"], c["ro"], c["rd"], c["z"], c["dc"], c["v0"])
        calls = (lambda: F.fused_flex_forward(*args, 1, L), lambda: F.fused_flex_backward(*args, c["g"], 1, L))
        for call in calls:
            if L == 20:
                call()
                continue
            with pytest.raises(ValueError, match=r"1\.\.20 xyz encoding bands"):
                call()


# -- (b) the plain versions against the TPU kernels ------------------------------

@pytest.fixture(scope="module", params=[(h, L) for h in WIDTHS for L in BANDS],
                ids=[f"h{h}-L{L}" for h in WIDTHS for L in BANDS])
def family(request):
    """(h, L, JAX model, JAX params, the port's params on the same weights)."""
    h, L = request.param
    jm = JAX_MODELS[NAME](**_kw(L, h, N))
    jp = jm.init(jax.random.PRNGKey(7 + L + h))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    assert jm.dim_xyz == 3 + 6 * L
    return h, L, jm, jp, tp


def _inputs(S, seed):
    """The rays on a grid where ro + rd·z is exact in f32
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


def _jax_weights(jp, h, n, L):
    """`fused_flex_mlp`'s weight tuple (`fused_flex.py:344-356`) at L bands."""
    def w(k):
        return jp[k + ".weight"]

    def b(k):
        return jp[k + ".bias"][None, :]

    mats = [w("layer1")[:, :3].T, w("layer1")[:, 3:3 + 6 * L].T]
    mats += [w(f"layers_xyz.{i}").T for i in range(n)]
    mats += [w("fc_feat").T, w("fc_alpha").T, w("layers_dir.0")[:, :h].T, w("fc_rgb").T]
    biases = [b(f"layers_xyz.{i}") for i in range(n)]
    biases += [b("fc_feat"), b("fc_alpha"), b("layers_dir.0"), b("fc_rgb")]
    return tuple(m.astype(jnp.bfloat16) for m in mats) + tuple(biases)


@pytest.mark.parametrize("S", SAMPLES)
def test_plain_matches_jax_kernel(family, S):
    h, L, jm, jp, tp = family
    x = _inputs(S, seed=S + L + h)
    v0, dc = _jax_fold(jm, jp, x, h)
    C, phase = _encoding_matrix(3, L, True)
    args = tuple(jnp.asarray(a) for a in (x["ro"], x["rd"], x["z"], dc, v0, C, phase[None, :]))
    out, res = JF._fused_flex_fwd(S, 4, N, h, *args, *_jax_weights(jp, h, N, L))
    jgrads = JF._fused_flex_bwd(S, 4, N, h, res, jnp.asarray(x["g"]))
    weights = F.pack_flex_weights(tp, N, L)
    assert weights[1].shape == (6 * L, h)
    targs = (weights, _t(x["ro"]), _t(x["rd"]), _t(x["z"]), _t(dc), _t(v0))
    got = F.fused_flex_forward_reference(*targs, N, L)
    out = np.asarray(out)
    assert got.shape == out.shape == (R, S, 4)
    raw = np.abs(got.numpy() - out).max() / np.abs(out).max()
    assert raw <= RAW_TOL, raw
    # the wrappers on CPU tensors are the plain versions
    assert torch.equal(F.fused_flex_forward(*targs, N, L), got)
    grads, d_v0, d_dir = F.fused_flex_backward_reference(*targs, _t(x["g"]), N, L)
    wn, bn = F.weight_names(N)
    worst = (0.0, 0.0)
    for k, a, b in zip(wn + bn + ("v0", "dir"), grads + (d_v0, d_dir), jgrads[7:] + (jgrads[4], jgrads[3])):
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        assert a.shape == b.shape, k
        e_max = float(np.abs(a - b).max() / np.abs(b).max())
        e_norm = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert e_max <= 0.08 and e_norm <= 0.04, (k, e_max, e_norm)
        worst = (max(worst[0], e_max), max(worst[1], e_norm))
    print(f"h={h} L={L} S={S}: raw {raw:.2e}·max, gradients ≤ {worst[0]:.2e}·max, {worst[1]:.2e}·norm")


# -- (c) the layout --------------------------------------------------------------

def _flex_w_off(h):
    """`flex_w_off<h>` as fused_flex.cu writes it, as a Python function of
    (offset, kx)."""
    body = re.search(r"constexpr int flex_w_off\(int off, int kx\) \{\s*return (.+?);\n\}", CU, re.S).group(1)
    body = " ".join(body.split()).replace("Offsets<H>::FW_OFF_W1", "W1")
    return eval("lambda off, kx: " + _c_expr(body), {"W1": 0, "K_XIN": 64, "H": h})


def _cuda_offsets(h):
    block = CU[CU.index(f"struct Offsets<{h}> {{"):]
    block = block[:block.index("};")]
    return {m.group(1): int(m.group(2)) for m in re.finditer(r"static constexpr int (F[WFT]_OFF_\w+) = (\d+);", block)}


@pytest.mark.parametrize("h", WIDTHS)
def test_wide_offsets_are_the_sources(h):
    """`w_offsets(n, h, kx)` is `flex_layout`'s rule on `flex_w_off`, both
    read from the source, at kx = 64 and 128 and n = 0 / 3 / 12; at 64 the
    10-band constants the kernels have always read; `f_offsets` holds 20
    bands at every band count; `wt_offsets` has no encoding row."""
    c = _cuda_offsets(h)
    w_off = _flex_w_off(h)
    layout = CU[CU.index("__host__ __device__ inline Layout flex_layout(int n, int kx) {"):]
    layout = layout[:layout.index("return L;")]
    for line in ("L.kx = kx;", "L.wf = flex_w_off<H>(OH::FW_OFF_WF, kx);", "L.wd0 = flex_w_off<H>(OH::FW_OFF_WD0, kx);",
                 "L.wh = flex_w_off<H>(OH::FW_OFF_WH, kx);", "L.wa = L.wh + n * H * H;", "L.wrgb = L.wa + H;"):
        assert line in layout, line
    for kx in (64, 128):
        for n in (0, 3, 12):
            wh = w_off(c["FW_OFF_WH"], kx)
            want = {"W1": w_off(c["FW_OFF_W1"], kx), "WF": w_off(c["FW_OFF_WF"], kx),
                    "WD0": w_off(c["FW_OFF_WD0"], kx), "WA": wh + n * h * h, "WRGB": wh + n * h * h + h,
                    "TOTAL": wh + n * h * h + h + 3 * (h // 2)}
            want.update({f"WH{i}": wh + i * h * h for i in range(n)})
            assert F.w_offsets(n, h, kx) == want, (kx, n)
        assert F.w_offsets(3, h, kx)["WF"] == kx * h
    assert F.w_offsets(3, h, 128)["TOTAL"] - F.w_offsets(3, h)["TOTAL"] == 64 * h
    # the 10-band offsets, pinned: the weights as before; BH_i 4 later (FREQS holds 20)
    pinned_w = {256: {"W1": 0, "WF": 16384, "WD0": 81920, "WH0": 114688, "WH1": 180224, "WH2": 245760,
                      "WA": 311296, "WRGB": 311552, "TOTAL": 311936},
                512: {"W1": 0, "WF": 32768, "WD0": 294912, "WH0": 425984, "WH1": 688128, "WH2": 950272,
                      "WA": 1212416, "WRGB": 1212928, "TOTAL": 1213696}}
    pinned_f = {256: {"V0": 0, "BF": 256, "BD0": 512, "BA": 640, "BRGB": 641, "FREQS": 644, "BH0": 664,
                      "BH1": 920, "BH2": 1176, "TOTAL": 1432},
                512: {"V0": 0, "BF": 512, "BD0": 1024, "BA": 1280, "BRGB": 1281, "FREQS": 1284, "BH0": 1304,
                      "BH1": 1816, "BH2": 2328, "TOTAL": 2840}}
    assert F.w_offsets(3, h) == pinned_w[h]
    assert F.f_offsets(3, h) == pinned_f[h]
    # K4's 20 band slots and limit (FLEX_MAX_FREQS), below the paper kernels' 31
    assert c["FF_OFF_BH"] - c["FF_OFF_FREQS"] == F.MAX_FREQS == 20 and K.MAX_FREQS == 31
    assert "constexpr int FLEX_MAX_FREQS = (K_XIN_WIDE - 3) / 6;" in CU
    assert F.wt_offsets(3, h) == {"WD0T": 0, "WFT": h // 2 * h, "WHT0": (h // 2 + h) * h,
                                  "WHT1": (h // 2 + 2 * h) * h, "WHT2": (h // 2 + 3 * h) * h,
                                  "TOTAL": (h // 2 + 4 * h) * h}


@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("L", [10, 16, 20])
def test_pack_and_split_round_trip(L, h):
    """Packing at L bands (`pack_kernel_operands`: W1 = [w1a; w1b; 0] in kx
    rows) and reading the buffer back through the kernel's gradient layout
    (`_split_kernel_grads`) gives every matrix and bias row; W1's pad and
    the unused band slots are zero; the kernels' one cached gather gives
    the packed weights' chunk images (W1's kx / 64 chunks unpack to its
    rows) and the transposed weights' before them."""
    n, n_enc, kx = 3, 6 * L, K.xin_extent(L)
    g = torch.Generator().manual_seed(L + h)
    shapes = F._matrix_shapes(n, n_enc, h)
    wn, bn = F.weight_names(n)
    W = {k: torch.randn(*shapes[k], generator=g).to(torch.bfloat16) for k in wn}
    widths = {"ba": 1, "brgb": 3, "bd0": h // 2}
    W.update({k: torch.randn(1, widths.get(k, h), generator=g) for k in bn})
    v0 = torch.randn(1, h, generator=g)
    freqs = K._device_bands(L, True, torch.device("cpu"))
    wbuf, fbuf = F.pack_kernel_operands(W, v0, n, freqs)
    wo, fo = F.w_offsets(n, h, kx), F.f_offsets(n, h)
    assert wbuf.numel() == wo["TOTAL"] and fbuf.numel() == fo["TOTAL"]
    w1 = wbuf[:kx * h].reshape(kx, h)
    assert torch.equal(w1[:3], W["w1a"]) and torch.equal(w1[3:3 + n_enc], W["w1b"])
    assert not w1[3 + n_enc:].float().any()
    fr = fbuf[fo["FREQS"]:fo["FREQS"] + F.MAX_FREQS]
    assert torch.equal(fr[:L], freqs.float()) and not fr[L:].any()
    gw, gb, d_v0 = F._split_kernel_grads(wbuf.float(), fbuf, n, n_enc, h)
    for k in wn:
        assert torch.equal(gw[k], W[k].float()), k
    for k in bn:
        assert torch.equal(gb[k], W[k]), k
    assert torch.equal(d_v0, v0)
    both = torch.cat([torch.zeros(1, dtype=torch.bfloat16)] + [W[k].reshape(-1) for k in wn])
    img = both[F._flex_weight_gather(n, n_enc, torch.device("cpu"), True, h)]
    wt_total = F.wt_offsets(n, h)["TOTAL"]
    wt_images = torch.cat([F.sm90_chunk_image(m) for m in F._transposed_matrices(W, n).values()])
    assert torch.equal(img[:wt_total].view(torch.int16), wt_images.view(torch.int16))
    fwd = img[wt_total:]
    assert fwd.numel() == wo["TOTAL"]
    for name in ("W1", "WF", "WD0", "WH1"):
        k, cols = {"W1": (kx, h), "WF": (h, h), "WD0": (h, h // 2), "WH1": (h, h)}[name]
        got = unpack_chunk_image(fwd[wo[name]:wo[name] + k * cols], k, cols)
        assert torch.equal(got.reshape(k, cols).view(torch.int16),
                           wbuf[wo[name]:wo[name] + k * cols].reshape(k, cols).view(torch.int16)), name
    assert torch.equal(fwd[wo["WA"]:], wbuf[wo["WA"]:])  # the heads stay row-major
    operands = F._kernel_operands(W, v0, n, L, True, True)
    assert torch.equal(operands[0].view(torch.int16), fwd.view(torch.int16)) and torch.equal(operands[1], fbuf)
    assert operands[2].numel() == wt_total


@pytest.mark.parametrize("R_,S_,n,h", [(2048, 64, 3, 256), (2072, 24, 3, 512), (301, 200, 12, 256),
                                       (2048, 128, 12, 512)])
def test_workspace_matches_carve_at_two_blocks(R_, S_, n, h):
    """At kx = 128 the workspace mirror (`workspace_layout`,
    `workspace_buffers`) equals `carve` replayed from the source, xin 128
    wide; dW's products take W1 at K = 128 (one CTA, two column blocks),
    so dW's segments are those of K = 64."""
    offs, total = F.workspace_layout(R_, S_, n, h, 128)
    got, got_total = _carve_replay(R_, S_, n, h, 128)
    assert got_total == total
    for k, v in got.items():
        key = {"act0": "a0", "gpre0": "gpre0" if n else "ga0", "amask0": "amask1" if n else "warp_part"}.get(k, k)
        assert offs[key] == v, k
    assert dict(F.workspace_buffers(n, h, 128))["xin"] == 128
    assert F.dw_products(n, h, 128)[0] == (128, min(h, 256))
    assert F.dw_segments(n, h, 128) == F.dw_segments(n, h)
    rays, units_an_item = K.unit_layout(S_)
    units = -(-R_ // rays) * units_an_item
    assert offs["a0"] - offs["xin"] == units * 128 * 128
    small, _ = F.workspace_layout(R_, S_, n, h)
    assert small["a0"] - small["xin"] == units * 64 * 128


def test_two_block_protocol_in_the_source():
    """The kernels' xin protocol past 10 bands, as read from the source:
    each consumer (h = 256 and 512) takes its buffer and phase from
    `xin_buf` / `xin_phase` at the pass's xc and hands xc to layer1's
    chain; the recompute's dead unit waits and releases that buffer by
    thread 0 alone and skips xc + 4n + 8 ring stages, which are the
    producer's loads of a unit (W1's L.kx / 64 chunks, 4 for each WH_i, WF
    and WD0); the wide encoder runs 2·64·xc tasks into `xin_buf`'s buffer;
    the recompute's xin images are L.kx wide; both entry points take xc
    from `xin_extent`."""
    code = re.sub(r"//.*", "", CU)
    consume = code[code.index("void fwd_consume("):code.index("__global__ void __launch_bounds__(FLEX_THREADS, 1) "
                                                              "flex_chain_kernel(")]
    assert "const int xc = g.xc();" in consume
    assert "const int b = xin_buf(units, xc), ph = xin_phase(units, xc);" in consume
    dead = consume[consume.index("if (SAVE && !live)"):consume.index("continue;")]
    assert "mbar_wait(&sm.xin_full[wg][b], ph);" in dead and "mbar_arrive(&sm.xin_empty[wg][b]);" in dead
    assert "if ((threadIdx.x & 127) == 0) {" in dead
    assert "skip_stages<RING>(sm, ring, xc + 4 * n + 4 + 4, release);" in dead
    assert "layer<HIDDEN, 1, 1, FRESH>(acc, act, xin, sm, ring, release, xc);" in consume
    assert "mbar_wait(&sm.xin_full[wg][b], ph);" in consume[consume.index("continue;"):]
    produce = code[code.index("void fwd_produce("):code.index("void fwd_consume(")]
    loads = re.findall(r"load\(([^;]*)\);", produce)
    assert loads == ["O::FW_OFF_W1, L.kx, HIDDEN", "L.wh + i * HH, HIDDEN, HIDDEN", "L.wf, HIDDEN, HIDDEN",
                     "L.wd0, HIDDEN, DIR_HIDDEN"]
    for n in (0, 3, 12):
        for xc in (1, 2):  # the producer's chunks of a unit: k / 64 each
            assert (64 * xc + n * 256 + 256 + 256) // 64 == xc + 4 * n + 4 + 4
    assert "unit_image(a.ws.xin, L.kx, item * g.units() + u)" in code
    wide = code[code.index("void wide_encode("):code.index("void wide_fwd_consume(")]
    assert "const int xc = g.xc(), tasks = 128 * xc;" in wide
    assert "const int b = xin_buf(done, xc);" in wide and "xin_phase(done, xc) ^ 1" in wide
    assert "unit_image(xg, K_XIN * xc, item * g.units() + u)" in wide
    assert "for (int task = e; task < tasks; task += ENCODERS * 32)" in wide
    wconsume = code[code.index("void wide_fwd_consume("):code.index("wide_chain_kernel(const FwdArgs a)")]
    assert "const int b = xin_buf(units, xc);" in wconsume and "xin_phase(units, xc)" in wconsume
    assert "wide_layer<WHALF, 1>(acc, smem_u32(sm.xin[b]), sm, ring, wg, release, xc);" in wconsume
    wproduce = code[code.index("void wide_fwd_produce("):code.index("void wide_encode(")]
    assert "load(OW::FW_OFF_W1, L.kx, WIDE);" in wproduce
    for kernel in ("flex_chain_kernel", "wide_chain_kernel", "wide_dx_kernel"):
        body = code[code.index(kernel + "(const"):]
        assert re.search(r"flex_layout<\w+>\(a\.n_hidden, K_XIN \* g\.xc\(\)\)", body[:body.index("\n}\n")]), kernel
    assert "flex_layout<HIDDEN>(a.n_hidden, K_XIN * UnitSchedule<SF, 1>{a.l}.xc())" in code
    assert "int xc() const { return SF ? 1 : l.xc; }" in CHAIN
    assert "chain_layer<N, NCH, NCH, WRING, true, 0, WSTAGE>(acc, no_a, a_img, stages, sm.full, ring, release, xc);" \
        in code


# -- (d) the slice: a 16-band step ------------------------------------------------

def test_16_band_step_matches_jax_step(monkeypatch):
    """A 16-band LearnableCode avatar's bf16 step at 16 + 16 samples
    through `compute_losses` (K4's plain version for both passes) against
    the JAX package's bf16 step through its Flexible Pallas kernel, from
    the same weights, batch and draws."""
    L, Rs = 16, 32
    kw = _kw(L)
    jm = JAX_MODELS[NAME](**kw)
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    params = {"coarse": dict(jp), "fine": dict(jp), "background": None,
              "latent_codes": jnp.asarray(rng.randn(4, 32).astype(np.float32) * 0.1)}
    jopt = jax_build_optimizer(JaxCfgNode(dict(OPT)))
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params, opt_state=jopt.init(params),
                           fixed_background=None)
    flags = FeatureFlags()
    state = create_train_state(MODELS[NAME](**kw), MODELS[NAME](**kw), flags, n_train=4)
    opt = build_optimizer(CfgNode(dict(OPT)), state)
    ckpt.train_state_from_jax(jax.device_get(jstate), state, opt)
    common = dict(num_coarse=SC, num_fine=SF, perturb=True, radiance_field_noise_std=0.1, near=0.2, far=FAR)
    tset = RenderSettings(**common, encode_xyz=EncodeSpec(L, True, True), encode_dir=EncodeSpec(4, False, True))
    jset = JaxRenderSettings(**common, encode_xyz=JaxEncodeSpec(L, True, True),
                             encode_dir=JaxEncodeSpec(4, False, True), fused="on")
    # the JAX pipeline's tile rule without its TPU-backend test: its
    # Flexible Pallas kernel runs in interpret mode on the CPU
    monkeypatch.setattr(jax_fused_mlp, "fused_paper_mlp_available", lambda n, tr: tr >= 8 and n % tr == 0)
    jcalls, calls = [], []
    jreal, real = JF.fused_flex_mlp, pipeline.fused_flex_mlp
    monkeypatch.setattr(JF, "fused_flex_mlp", lambda *a, **k: jcalls.append(a[3].shape) or jreal(*a, **k))
    monkeypatch.setattr(pipeline, "fused_flex_mlp", lambda *a, **k: calls.append(a[3].shape) or real(*a, **k))
    jb, tb = _batch(Rs, seed=7)
    key = jax.random.PRNGKey(1)

    def loss_fn(p):
        return _compute_losses(p, jb, key, jm, jm, jset, JaxFlags(), None, dtype=jnp.bfloat16)

    (jtot, jmet), jg = jax.value_and_grad(loss_fn, has_aux=True)(jstate.params)
    assert jcalls == [(Rs, SC), (Rs, SC + SF)]  # both passes through JAX's Flexible kernel
    total, _ = compute_losses(state, tb, 0, tset, flags, dtype=torch.bfloat16, draws=_jax_draws(key, Rs))
    total.backward()
    assert calls == [(Rs, SC), (Rs, SC + SF)]  # both passes through K4
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
        err = float(np.abs(got - v).max() / max(np.abs(v).max(), 1e-30))
        worst[name] = err
        np.testing.assert_allclose(got, v, atol=tol * np.abs(v).max() + 1e-9, rtol=0, err_msg=name)
        seen += 1
    assert seen == 2 * 16 + 1  # 8 layers a model, the latent table
    assert port["['coarse']['layer1.weight']"].shape == (256, 3 + 6 * L + 76 + 32)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    print(f"16-band step: loss {float(total):.6f} vs {float(jtot):.6f}; worst gradients (·max) {top}")
