"""PyTorch port, K2 fused render (`nerface_tpu_torch/ops/kernels/fused_mlp.py`).

* The plain version in bf16 against the JAX package's Pallas kernel
  `fused_paper_render`, run in interpret mode on the CPU as
  tests/test_pallas.py runs it. Tolerances: rgb, acc, weights and
  bg_weight atol 2e-3 — both round the same operands to bf16, but the f32
  sums run in another order, which can flip an activation's bf16 rounding
  (2^-8 relative) on its way through the network; depth atol 2e-3·far;
  disp rtol 1e-2.
* The plain version in f32 against JAX `inject_background` +
  `volume_render_radiance_field` on the f32 model: atol 1e-5 (sum order).
* Rays with acc → 0 and fully opaque rays.
* The packed operand layout: offsets equal to the .cu file's, and a torch
  emulation of the kernel's reads of the packed buffers; packing once per
  model and folding only the conditioning per call gives the same buffers
  bit for bit, and the render path packs a model once.

The CUDA kernel itself is tested in tests/test_torch_cuda.py, which imports
no JAX so that it runs on a host with the card.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.models import MODELS
from nerface_tpu.models.mlp import linear_cols
from nerface_tpu.ops.compositing import inject_background, volume_render_radiance_field
from nerface_tpu.ops.encoding import positional_encoding
from nerface_tpu.ops.pallas.fused_mlp import fused_paper_render as jax_fused_render
from nerface_tpu_torch.ops.encoding import _frequency_bands
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.train.checkpoint import params_from_jax

torch.set_num_threads(1)

CU = pathlib.Path(K.__file__).resolve().parents[2] / "csrc" / "fused_paper_render.cu"
FAR = 0.8


@pytest.fixture(scope="module")
def model():
    jm = MODELS["ConditionalBlendshapePaperNeRFModel"](
        num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False
    )
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()})


def _inputs(R, S, seed=0, edge=False):
    """Rays in the frustum of a head at the origin; with `edge`, rays 0-1
    have rd = 0 (acc = 0 exactly) and rays 2-3 |rd| = 1e-9 (acc ~ 1e-5)."""
    rng = np.random.RandomState(seed)
    ro = rng.randn(R, 3).astype(np.float32) * 0.05 + np.array([0, 0, 0.5], np.float32)
    rd = (rng.randn(R, 3) * [0.2, 0.2, 0.05] - [0, 0, 1]).astype(np.float32)
    z = 0.2 + np.cumsum(rng.rand(R, S).astype(np.float32) * (1.2 / S), -1).astype(np.float32)
    if edge:
        rd[0:2] = 0.0
        rd[2:4] = 1e-9
    pe_dir = rng.randn(R, 24).astype(np.float32)
    expr = rng.randn(76).astype(np.float32) * 0.5
    latent = rng.randn(32).astype(np.float32) * 0.1
    bg = rng.rand(R, 3).astype(np.float32)
    return ro, rd, z, pe_dir, expr, latent, bg


def _cond(jp, pe_dir, expr, latent):
    cond = np.concatenate([expr * (1.0 / 3.0), latent]).astype(np.float32)
    dc = np.asarray(linear_cols(jp, "layers_dir.0", jnp.asarray(pe_dir), 256, 256 + 24))
    return cond, dc


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_against_kernel_tolerances(got, ref, with_weights=True):
    for k in ("rgb", "acc", "bg_weight") + (("weights",) if with_weights else ()):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=2e-3, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(ref["depth"]), atol=2e-3 * FAR,
                               rtol=0)
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(ref["disp"]), rtol=1e-2)


@pytest.mark.parametrize("S", [16, 64])
@pytest.mark.parametrize("with_bg", [True, False], ids=["bg", "nobg"])
def test_bf16_plain_matches_jax_kernel(model, S, with_bg):
    jm, jp, tp = model
    ro, rd, z, pe_dir, expr, latent, bg = _inputs(16, S, seed=S)
    cond, dc = _cond(jp, pe_dir, expr, latent)
    bgx = bg if with_bg else None
    ref = jax_fused_render(
        jp, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jnp.asarray(dc),
        jnp.asarray(cond), background=None if bgx is None else jnp.asarray(bgx),
        out_weights=True,
    )
    got = K.fused_paper_render_reference(
        tp, _t(ro), _t(rd), _t(z), _t(dc), _t(cond),
        background=None if bgx is None else _t(bgx), out_weights=True,
    )
    assert set(got) == set(ref)
    assert got["rgb"].shape == (16, 3) and got["weights"].shape == (16, S)
    _check_against_kernel_tolerances(got, ref)


@pytest.mark.parametrize("with_bg,white", [(True, False), (False, True)])
def test_f32_plain_matches_unfused_jax(model, with_bg, white):
    jm, jp, tp = model
    R, S = 16, 64
    ro, rd, z, pe_dir, expr, latent, bg = _inputs(R, S, seed=3)
    cond, dc = _cond(jp, pe_dir, expr, latent)
    bgx = bg if with_bg else None
    pts = ro[:, None, :] + rd[:, None, :] * z[:, :, None]
    rad = jm.apply(jp, positional_encoding(jnp.asarray(pts), 10, True, True),
                   jnp.asarray(pe_dir), jnp.asarray(expr), jnp.asarray(latent))
    rad = inject_background(rad, None if bgx is None else jnp.asarray(bgx))
    rgb, disp, acc, w, depth = volume_render_radiance_field(
        rad, jnp.asarray(z), jnp.asarray(rd), white_background=white,
        background_prior=None if bgx is None else jnp.asarray(bgx), return_depth=True,
    )
    got = K.fused_paper_render_reference(
        tp, _t(ro), _t(rd), _t(z), _t(dc), _t(cond),
        background=None if bgx is None else _t(bgx), white_background=white,
        out_weights=True, mm_dtype=torch.float32,
    )
    for k, r in (("rgb", rgb), ("acc", acc), ("weights", w), ("bg_weight", w[:, -1]),
                 ("depth", depth)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(r), atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(disp), rtol=1e-5)


def test_acc_to_zero_rays(model):
    """rd = 0: no distance is travelled, every alpha is 0, acc = depth = 0.
    The kernel's guard gives disp = 1/max(1e-10, 0/1e-38) = 1e10 where the
    unfused depth/acc is NaN; |rd| = 1e-9 leaves acc ~ 1e-5 > 0. The JAX
    kernel, run by XLA on the CPU, flushes the denormal 1e-38 to zero and
    returns NaN at acc = 0, so the two are compared on the other rays."""
    jm, jp, tp = model
    ro, rd, z, pe_dir, expr, latent, bg = _inputs(16, 64, seed=5, edge=True)
    cond, dc = _cond(jp, pe_dir, expr, latent)
    ref = jax_fused_render(
        jp, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jnp.asarray(dc),
        jnp.asarray(cond), background=jnp.asarray(bg), out_weights=True,
    )
    got = K.fused_paper_render_reference(
        tp, _t(ro), _t(rd), _t(z), _t(dc), _t(cond), background=_t(bg), out_weights=True,
    )
    for k, v in got.items():
        assert torch.isfinite(v).all(), k
    assert float(got["acc"][:2].abs().max()) == 0.0
    np.testing.assert_array_equal(got["disp"][:2].numpy(), np.float32(1e10))
    assert 0.0 < float(got["acc"][2:4].min()) < 1e-3
    _check_against_kernel_tolerances(
        {k: v[2:] for k, v in got.items()}, {k: np.asarray(v)[2:] for k, v in ref.items()}
    )


def test_opaque_rays(model):
    """σ·d far past 104 (exp underflows to exactly 0): alpha == 1 on the
    first sample, whose weight takes everything; finite everywhere."""
    jm, jp, tp = model
    jp_hot = dict(jp, **{"fc_alpha.bias": jp["fc_alpha.bias"] + 1e5})
    tp_hot = dict(tp, **{"fc_alpha.bias": tp["fc_alpha.bias"] + 1e5})
    ro, rd, z, pe_dir, expr, latent, bg = _inputs(16, 16, seed=6)
    cond, dc = _cond(jp, pe_dir, expr, latent)
    ref = jax_fused_render(
        jp_hot, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jnp.asarray(dc),
        jnp.asarray(cond), background=jnp.asarray(bg), out_weights=True,
    )
    got = K.fused_paper_render_reference(
        tp_hot, _t(ro), _t(rd), _t(z), _t(dc), _t(cond), background=_t(bg), out_weights=True,
    )
    for k, v in got.items():
        assert torch.isfinite(v).all(), k
    np.testing.assert_allclose(got["weights"][:, 0].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(got["depth"].numpy(), z[:, 0], rtol=1e-6)
    _check_against_kernel_tolerances(got, ref)


def test_offsets_match_cuda_source():
    """The offsets live in the header the kernel includes (shared with K1)."""
    src = CU.read_text()
    assert '#include "mma_tile.cuh"' in src
    src += (CU.parent / "mma_tile.cuh").read_text()
    for prefix, offsets in (("W", K.W_OFFSETS), ("F", K.F_OFFSETS)):
        found = {
            m.group(1): int(m.group(2))
            for m in re.finditer(rf"constexpr int {prefix}_OFF_(\w+) = (\d+);", src)
        }
        assert found == offsets


def _emulate_kernel_reads(wbuf, fbuf, ro, rd, z, dc, n_freqs):
    """The kernel's MLP as torch ops over the packed buffers: the same
    offsets, the zero-padded K=64 [xyz; PE] input, the K=320 skip layer."""
    Wf, F = wbuf.float(), fbuf

    def mat(name):
        _, rows, cols = next(e for e in K.W_LAYOUT if e[0] == name)
        o = K.W_OFFSETS[name]
        return Wf[o:o + rows * cols].reshape(rows, cols)

    def row(name, n):
        o = K.F_OFFSETS[name]
        return F[o:o + n]

    def bf(t):
        return t.to(torch.bfloat16).float()

    R, S = z.shape
    x = (ro[:, None, :] + rd[:, None, :] * z[:, :, None]).reshape(-1, 3)
    freqs = row("FREQS", n_freqs)
    cols = [x]
    for p in range(6 * n_freqs):
        d, phase = (p % 6) % 3, (np.float32(np.pi / 2) if p % 6 >= 3 else np.float32(0))
        cols.append(torch.sin(x[:, d:d + 1] * freqs[p // 6] + phase))
    xin = torch.cat(cols, dim=1)
    xin = bf(torch.cat([xin, xin.new_zeros(xin.shape[0], K.K_XIN - xin.shape[1])], dim=1))
    h = bf(torch.relu(xin @ mat("W0") + row("COND0", 256)))
    h = bf(torch.relu(h @ mat("W1") + row("B1", 256)))
    h = bf(torch.relu(h @ mat("W2") + row("B2", 256)))
    h = bf(torch.relu(torch.cat([xin, h], dim=1) @ mat("W3") + row("COND3", 256)))
    h = bf(torch.relu(h @ mat("W4") + row("B4", 256)))
    h = bf(torch.relu(h @ mat("W5") + row("B5", 256)))
    feat = bf(h @ mat("WF") + row("BF", 256))
    sigma = (feat @ mat("WA") + row("BA", 1)).reshape(R, S)
    hd = (feat @ mat("WD0") + row("BD0", 128)).reshape(R, S, 128) + dc[:, None, :]
    x = bf(torch.relu(hd)).reshape(-1, 128)
    x = bf(torch.relu(x @ mat("WD1") + row("BD1", 128)))
    x = bf(torch.relu(x @ mat("WD2") + row("BD2", 128)))
    rgb = (x @ mat("WRGB") + row("BRGB", 3)).reshape(R, S, 3)
    return rgb, sigma


@pytest.mark.parametrize("n_freqs", [10, 6])
def test_packed_layout_reproduces_plain(n_freqs):
    """Reading the packed buffers as the kernel does gives the plain
    version's result: the layout, the zero padding and the K=320 skip
    layer are right before the kernel ever runs."""
    from nerface_tpu_torch.models.nerf_models import ConditionalBlendshapePaperNeRFModel

    m = ConditionalBlendshapePaperNeRFModel(
        num_encoding_fn_xyz=n_freqs, num_encoding_fn_dir=4, include_input_dir=False,
        generator=torch.Generator().manual_seed(1),
    )
    params = m.state_dict()
    ro, rd, z, pe_dir, expr, latent, bg = _inputs(8, 32, seed=7)
    cond = _t(np.concatenate([expr / 3.0, latent]).astype(np.float32))
    dc = _t(pe_dir) @ params["layers_dir.0.weight"][:, 256:].T
    d_pe = 3 + 6 * n_freqs
    cond0, cond3, W = K._layout_weights(params, cond, d_pe, 108)
    freqs = _t(_frequency_bands(n_freqs, True))
    wbuf, fbuf = K.pack_kernel_operands(cond0, cond3, W, freqs)
    assert wbuf.dtype == torch.bfloat16 and wbuf.numel() == K.W_OFFSETS["TOTAL"]
    assert fbuf.dtype == torch.float32 and fbuf.numel() == K.F_OFFSETS["TOTAL"]
    rgb, sigma = _emulate_kernel_reads(wbuf, fbuf, _t(ro), _t(rd), _t(z), dc, n_freqs)
    got = K._composite_reference(rgb, sigma, _t(z), _t(rd), _t(bg), False, True)
    ref = K.fused_paper_render_reference(
        params, _t(ro), _t(rd), _t(z), dc, cond, background=_t(bg),
        num_encoding_fn_xyz=n_freqs, out_weights=True,
    )
    _check_against_kernel_tolerances(got, ref)


@pytest.mark.parametrize("n_freqs", [10, 6])
def test_packed_once_equals_packed_per_call(n_freqs):
    """`pack_paper_weights` + `_fold_conditioning` (the serving path's
    per-call work) gives exactly the buffers of a full pack with the
    conditioning folded in."""
    from nerface_tpu_torch.models.nerf_models import ConditionalBlendshapePaperNeRFModel

    m = ConditionalBlendshapePaperNeRFModel(
        num_encoding_fn_xyz=n_freqs, num_encoding_fn_dir=4, include_input_dir=False,
        generator=torch.Generator().manual_seed(2),
    )
    params = m.state_dict()
    packed = K.pack_paper_weights(params, n_freqs, True)
    for seed in (3, 4):
        _, _, _, _, expr, latent, _ = _inputs(2, 16, seed=seed)
        cond = _t(np.concatenate([expr / 3.0, latent]).astype(np.float32))
        freqs = _t(_frequency_bands(n_freqs, True))
        wbuf, fbuf = K.pack_kernel_operands(*K._layout_weights(params, cond, 3 + 6 * n_freqs, 108),
                                            freqs)
        assert torch.equal(packed.wbuf_sm90, K.pack_sm90_chunks(wbuf))
        torch.testing.assert_close(K._fold_conditioning(packed, cond), fbuf, rtol=0, atol=0)
    with pytest.raises(ValueError, match="float32"):
        K.pack_paper_weights({k: v.double() for k, v in params.items()}, n_freqs, True)
    with pytest.raises(ValueError, match="bands"):
        K.pack_paper_weights(params, K.MAX_FREQS + 1, True)


def test_render_path_packs_a_model_once(model):
    """`_kernel_weights` packs on first use, hands the same buffers to
    later passes, and packs again when the weights are loaded anew."""
    from nerface_tpu_torch.models.nerf_models import ConditionalBlendshapePaperNeRFModel
    from nerface_tpu_torch.render.pipeline import EncodeSpec, _kernel_weights

    m = ConditionalBlendshapePaperNeRFModel(
        num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False,
        generator=torch.Generator().manual_seed(5),
    ).requires_grad_(False)
    enc = EncodeSpec(10, True, True)
    first = _kernel_weights(m, enc)
    assert _kernel_weights(m, enc) is first
    m.load_state_dict(model[2], strict=True)
    again = _kernel_weights(m, enc)
    assert again is not first
    assert torch.equal(again.wbuf_sm90, K.pack_paper_weights(model[2]).wbuf_sm90)


def test_wrapper_on_cpu_is_the_plain_version(model):
    _, jp, tp = model
    ro, rd, z, pe_dir, expr, latent, bg = _inputs(8, 16, seed=8)
    cond, dc = _cond(jp, pe_dir, expr, latent)
    before = K.fused_paper_render.launches
    a = K.fused_paper_render(tp, _t(ro), _t(rd), _t(z), _t(dc), _t(cond), background=_t(bg))
    b = K.fused_paper_render_reference(tp, _t(ro), _t(rd), _t(z), _t(dc), _t(cond),
                                       background=_t(bg))
    c = K.fused_paper_render(K.pack_paper_weights(tp), _t(ro), _t(rd), _t(z), _t(dc), _t(cond),
                             background=_t(bg))
    assert K.fused_paper_render.launches == before  # no kernel launched
    assert set(a) == {"rgb", "disp", "acc", "depth", "bg_weight"}
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        torch.testing.assert_close(c[k], b[k], rtol=0, atol=0)


def test_wrapper_refuses_other_devices(model):
    _, _, tp = model
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.fused_paper_render(tp, meta, meta, torch.empty(4, 64, device="meta"),
                             torch.empty(4, 128, device="meta"), torch.empty(108, device="meta"))
