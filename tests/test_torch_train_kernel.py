"""PyTorch port, K1 fused training pass (`nerface_tpu_torch/ops/kernels/fused_train.py`).

* `prefold_paper_params` against the JAX package's, in f32: atol 1e-6
  (the same f32 products and folds).
* The plain version in bf16 against the JAX package's Pallas kernel
  `fused_train_pass`, run in interpret mode on the CPU as
  tests/test_fused_train.py runs it, at R = 16 with S = 16 and 32, with and
  without a background, σ-noise, a white background, a trainable
  background with the supervised background term: rgb and weights atol
  2e-4 (a flipped bf16 rounding of one activation moves a colour by
  ~2e-5 here); every gradient atol 5e-3·max|JAX| + 1e-9. Both round the same
  operands to bf16 at the same points; only the f32 summation order
  differs (the TPU kernel's triangular matmuls, per-tile sums), which can
  flip the bf16 rounding of a cotangent here and there (readings:
  ≤ 1.3e-3·max, wd1 with a white background).
* The plain version in f32 against torch autograd of its own forward:
  gradients atol 1e-5·max + 1e-12 (f32 sums in another order).
* The autograd.Function: backward hands `grad_output ×` the pass's
  gradients to the bundle and the background; the wrapper on CPU tensors is
  the plain version; the packed layouts match the .cu file.

The CUDA kernel itself is tested in tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.models import MODELS
from nerface_tpu.ops.pallas.fused_train import fused_train_pass as jax_train_pass
from nerface_tpu.ops.pallas.fused_train import prefold_paper_params as jax_prefold
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_train as T
from nerface_tpu_torch.train.checkpoint import params_from_jax

torch.set_num_threads(1)

CU = pathlib.Path(T.__file__).resolve().parents[2] / "csrc" / "fused_train_pass.cu"
R = 16
NAMES = ["d_cond0", "d_cond3", "d_dir"] + list(K.WEIGHT_NAMES) + list(K.BIAS_NAMES)


@pytest.fixture(scope="module")
def model():
    jm = MODELS["ConditionalBlendshapePaperNeRFModel"](
        num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False
    )
    jp = jm.init(jax.random.PRNGKey(0))
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()})


def _inputs(S, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    ro = (rng.randn(R, 3) * 0.05 + [0, 0, 0.5]).astype(f)
    rd = (rng.randn(R, 3) * [0.2, 0.2, 0.05] - [0, 0, 1]).astype(f)
    z = (0.2 + np.cumsum(rng.rand(R, S) * (1.2 / S), -1)).astype(f)
    return dict(
        ro=ro, rd=rd, z=z, target=rng.rand(R, 3).astype(f), bg=rng.rand(R, 3).astype(f),
        noise=rng.randn(R, S).astype(f), pe_dir=rng.randn(R, 24).astype(f),
        cond=np.concatenate([rng.randn(76) * 0.5 / 3, rng.randn(32) * 0.1]).astype(f),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = {
    "bg": dict(bg=True),
    "bg_noise": dict(bg=True, noise_std=0.1),
    "white": dict(white_background=True),
    "train_bg_sup": dict(bg=True, train_bg=True, sup_bg_scale=0.001 / R, noise_std=0.1),
}


def _case_kwargs(case, x, wrap):
    kw = dict(CASES[case])
    has_bg = kw.pop("bg", False)
    out = dict(kw, loss_scale=2.0 / (3.0 * R))
    out["background"] = wrap(x["bg"]) if has_bg else None
    out["noise"] = wrap(x["noise"]) if kw.get("noise_std", 0.0) > 0 else None
    return out


@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_plain_matches_jax_kernel(model, S, case):
    jp, tp = model
    x = _inputs(S, seed=S + len(case))
    jb = jax_prefold(jp, jnp.asarray(x["cond"]), jnp.asarray(x["pe_dir"]), 10)
    tb = T.prefold_paper_params(tp, _t(x["cond"]), _t(x["pe_dir"]), 10)
    jo, jg, jbg = jax_train_pass(
        jb, *(jnp.asarray(x[k]) for k in ("ro", "rd", "z", "target")),
        **_case_kwargs(case, x, lambda a: jnp.asarray(a)),
    )
    to, tg, tbg = T.fused_train_pass_reference(
        tb, *(_t(x[k]) for k in ("ro", "rd", "z", "target")), **_case_kwargs(case, x, _t)
    )
    for k in ("rgb", "weights"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=2e-4, rtol=0, err_msg=k)
    assert len(tg) == len(jg) == len(NAMES)
    for name, a, b in zip(NAMES, tg, jg):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=5e-3 * np.abs(b).max() + 1e-9, rtol=0,
                                   err_msg=name)
    if CASES[case].get("train_bg"):
        np.testing.assert_allclose(tbg.numpy(), np.asarray(jbg), atol=5e-3 * np.abs(jbg).max(),
                                   rtol=0)
    else:
        assert tbg is None and jbg is None


def test_prefold_matches_jax(model):
    jp, tp = model
    x = _inputs(16, seed=1)
    jb = jax_prefold(jp, jnp.asarray(x["cond"]), jnp.asarray(x["pe_dir"]), 10)
    tb = T.prefold_paper_params(tp, _t(x["cond"]), _t(x["pe_dir"]), 10)
    assert len(tb) == len(jb) == 28
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def _f32_forward_loss(bundle, x, case):
    """The plain version's forward in f32 as autograd-able torch, and the
    pass's loss (MSE, + the supervised background term)."""
    cond0, cond3, dir_c, W, B = K._unbundle(bundle)
    kw = _case_kwargs(case, x, _t)
    ro, rd, z, tgt = (_t(x[k]) for k in ("ro", "rd", "z", "target"))
    bg = kw["background"]
    if bg is not None and kw.get("train_bg"):
        bg = bg.clone().requires_grad_(True)
    n, S = z.shape
    x3 = (ro[:, None, :] + rd[:, None, :] * z[:, :, None]).reshape(-1, 3)
    enc = K._encode_points(x3, 10, True)
    h = torch.relu(x3 @ W["w0a"] + enc @ W["w0b"] + cond0)
    h = torch.relu(h @ W["w1"] + B["b1"])
    h2 = torch.relu(h @ W["w2"] + B["b2"])
    h = torch.relu(x3 @ W["w3xa"] + enc @ W["w3xb"] + h2 @ W["w3h"] + cond3)
    h = torch.relu(h @ W["w4"] + B["b4"])
    h = torch.relu(h @ W["w5"] + B["b5"])
    feat = h @ W["wf"] + B["bf"]
    sigma = (feat @ W["wa"] + B["ba"]).reshape(n, S)
    hd = ((feat @ W["wd0"] + B["bd0"]).reshape(n, S, 128) + dir_c[:, None, :]).reshape(-1, 128)
    h = torch.relu(torch.relu(hd) @ W["wd1"] + B["bd1"])
    h = torch.relu(h @ W["wd2"] + B["bd2"])
    raw = (h @ W["wrgb"] + B["brgb"]).reshape(n, S, 3)
    if kw.get("noise_std", 0.0) > 0:
        sigma = sigma + kw["noise"] * kw["noise_std"]
    out = K._composite_reference(raw, sigma, z, rd, bg, kw.get("white_background", False), True)
    loss = torch.mean((out["rgb"] - tgt) ** 2)
    if kw.get("sup_bg_scale", 0.0) > 0:
        loss = loss + torch.mean(torch.sum((bg - tgt) ** 2, -1) * out["weights"][:, -1]) * 0.001
    return loss, out, bg


@pytest.mark.parametrize("case", list(CASES))
def test_f32_plain_equals_autograd(model, case):
    """The hand-written backward in f32 is the gradient of the forward."""
    _, tp = model
    x = _inputs(16, seed=9)
    bundle = [t.detach().clone().requires_grad_(True) for t in
              T.prefold_paper_params(tp, _t(x["cond"]), _t(x["pe_dir"]), 10)]
    loss, out, bg = _f32_forward_loss(bundle, x, case)
    loss.backward()
    to, tg, tbg = T.fused_train_pass_reference(
        bundle, *(_t(x[k]) for k in ("ro", "rd", "z", "target")), **_case_kwargs(case, x, _t),
        mm_dtype=torch.float32,
    )
    torch.testing.assert_close(to["rgb"], out["rgb"].detach(), atol=1e-6, rtol=0)
    for name, g, b in zip(NAMES, tg, bundle):
        scale = float(b.grad.abs().max())
        torch.testing.assert_close(g, b.grad, atol=1e-5 * scale + 1e-12, rtol=0, msg=name)
    if CASES[case].get("train_bg"):
        torch.testing.assert_close(tbg, bg.grad, atol=1e-5 * float(bg.grad.abs().max()), rtol=0)


def test_autograd_function_hands_out_the_pass_gradients(model):
    _, tp = model
    x = _inputs(16, seed=4)
    bundle = [t.detach().clone().requires_grad_(True) for t in
              T.prefold_paper_params(tp, _t(x["cond"]), _t(x["pe_dir"]), 10)]
    kw = _case_kwargs("train_bg_sup", x, _t)
    bg = kw.pop("background").clone().requires_grad_(True)
    ro, rd, z, tgt = (_t(x[k]) for k in ("ro", "rd", "z", "target"))
    loss, rgb, weights, mse, bg_loss = T.fused_train_loss(bundle, ro, rd, z, tgt, background=bg,
                                                          **kw)
    assert not any(t.requires_grad for t in (rgb, weights, mse, bg_loss))
    (3.0 * loss).backward()
    outs, grads, d_bg = T.fused_train_pass_reference(
        bundle, ro, rd, z, tgt, background=bg.detach(), **kw
    )
    per_ray = torch.sum((bg.detach() - tgt) ** 2, -1)
    want_mse = torch.mean((outs["rgb"] - tgt) ** 2)
    want_bg = torch.mean(per_ray * outs["weights"][:, -1]) * 1e-3
    torch.testing.assert_close(mse, want_mse, atol=0, rtol=0)
    torch.testing.assert_close(bg_loss, want_bg, atol=0, rtol=0)
    torch.testing.assert_close(loss.detach(), want_mse + want_bg, atol=0, rtol=0)
    for name, b, g in zip(NAMES, bundle, grads):
        torch.testing.assert_close(b.grad, 3.0 * g, atol=0, rtol=0, msg=name)
    torch.testing.assert_close(bg.grad, 3.0 * d_bg, atol=0, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version(model):
    _, tp = model
    x = _inputs(16, seed=5)
    tb = T.prefold_paper_params(tp, _t(x["cond"]), _t(x["pe_dir"]), 10)
    args = [_t(x[k]) for k in ("ro", "rd", "z", "target")]
    kw = _case_kwargs("bg_noise", x, _t)
    before = T.fused_train_pass.launches
    a = T.fused_train_pass(tb, *args, **kw)
    b = T.fused_train_pass_reference(tb, *args, **kw)
    assert T.fused_train_pass.launches == before
    for k in ("rgb", "weights"):
        assert torch.equal(a[0][k], b[0][k])
    assert all(torch.equal(g, h) for g, h in zip(a[1], b[1]))
    with pytest.raises(ValueError, match="noise array"):
        T.fused_train_pass(tb, *args, noise_std=0.1, loss_scale=1.0)
    with pytest.raises(ValueError, match="background"):
        T.fused_train_pass(tb, *args, train_bg=True, loss_scale=1.0)
    meta = [torch.empty(t.shape, device="meta") for t in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        T.fused_train_pass(tb, *meta, loss_scale=1.0)


def test_offsets_match_cuda_source():
    """The transposed layout lives in paper_train.cuh, which K1 and K3b
    include (the layer code is K2's, mma_tile.cuh, through grad_tile.cuh)."""
    src = CU.read_text()
    assert "#include \"paper_train.cuh\"" in src
    header = (CU.parent / "paper_train.cuh").read_text()
    found = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int WT_OFF_(\w+) = (\d+);", header)}
    assert found == K.WT_OFFSETS
    assert "#include \"grad_tile.cuh\"" in header
    assert "#include \"mma_tile.cuh\"" in (CU.parent / "grad_tile.cuh").read_text()


def test_kernel_gradient_layout_unpacks(model):
    """Gradients laid out in the kernel's packed f32 buffers (the forward
    weight layout and the bias-row layout, W0/W3 padded to K = 64/320)
    come back as the bundle's gradients; the transposed buffer holds Wᵀ."""
    _, tp = model
    x = _inputs(16, seed=6)
    tb = T.prefold_paper_params(tp, _t(x["cond"]), _t(x["pe_dir"]), 10)
    _, grads, _ = T.fused_train_pass_reference(
        tb, *(_t(x[k]) for k in ("ro", "rd", "z", "target")), loss_scale=0.1
    )
    _, _, _, gw, gb = K._unbundle(grads)
    dw = torch.zeros(K.W_OFFSETS["TOTAL"])
    df = torch.zeros(K.F_OFFSETS["TOTAL"])
    pad = torch.zeros(K.K_XIN - 63, 256)
    mats = {"W0": torch.cat([gw["w0a"], gw["w0b"], pad]),
            "W3": torch.cat([gw["w3xa"], gw["w3xb"], pad, gw["w3h"]]),
            "W1": gw["w1"], "W2": gw["w2"], "W4": gw["w4"], "W5": gw["w5"], "WF": gw["wf"],
            "WD0": gw["wd0"], "WD1": gw["wd1"], "WD2": gw["wd2"], "WA": gw["wa"],
            "WRGB": gw["wrgb"]}
    for name, m in mats.items():
        o = K.W_OFFSETS[name]
        dw[o:o + m.numel()] = m.reshape(-1)
    rows = {"COND0": grads[0], "COND3": grads[1], "B1": gb["b1"], "B2": gb["b2"], "B4": gb["b4"],
            "B5": gb["b5"], "BF": gb["bf"], "BD0": gb["bd0"], "BD1": gb["bd1"],
            "BD2": gb["bd2"], "BA": gb["ba"], "BRGB": gb["brgb"]}
    for name, r in rows.items():
        o = K.F_OFFSETS[name]
        df[o:o + r.numel()] = r.reshape(-1)
    (c0, c3), uw, ub = K._split_kernel_grads(dw, df, 60)
    assert torch.equal(c0, grads[0]) and torch.equal(c3, grads[1])
    for k in K.WEIGHT_NAMES:
        assert torch.equal(uw[k], gw[k]), k
    for k in K.BIAS_NAMES:
        assert torch.equal(ub[k], gb[k]), k
    _, _, _, W, _ = K._unbundle(tb)
    wt = K.pack_transposed_weights(W)
    assert wt.dtype == torch.bfloat16 and wt.numel() == K.WT_OFFSETS["TOTAL"]
    for name, k, n in K.WT_LAYOUT:
        o = K.WT_OFFSETS[name]
        got = wt[o:o + k * n].reshape(k, n)
        assert torch.equal(got, W[K.WT_SOURCE[name]].T.to(torch.bfloat16)), name
