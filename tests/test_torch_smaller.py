"""PyTorch port, the smaller paper model
(`ConditionalBlendshapePaperSmallerNeRFModel`, reference `models.py:266-338`)
and the `small` modes of K1 and K2, held against the JAX package on the CPU.

Tolerances, with their reasons:

* The model's f32 forward against JAX `apply`: atol 1e-5·max (each
  256-wide dot summed in another order); bf16 operands on both sides:
  atol 5e-3·max (a flipped bf16 rounding of an activation).
* The `small` prefold against the JAX package's: atol 1e-6 (the same f32
  products and folds).
* K2's plain version in its `small` mode against the JAX package's Pallas
  `fused_paper_render(small=True)` in interpret mode: tests/
  test_torch_fused_render.py's tolerances (rgb, acc, weights, bg_weight
  atol 2e-3; depth 2e-3·far; disp rtol 1e-2).
* K1's plain version in its `small` mode against the JAX package's Pallas
  `fused_train_pass(small=True)` in interpret mode: tests/
  test_torch_train_kernel.py's (rgb and weights atol 2e-4; every gradient
  atol 5e-3·max + 1e-9).
* A bf16 step of the smaller model through `fused_losses` (K1's plain
  version) against `jax.value_and_grad(_compute_losses)` (f32): loss rtol
  0.03, gradients atol 0.25·max + 2e-6 (tests/test_torch_train.py's
  envelope for bf16 operands against f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.config.flags import FeatureFlags as JaxFlags
from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.ops.encoding import positional_encoding
from nerface_tpu.ops.pallas.fused_mlp import fused_paper_render as jax_fused_render
from nerface_tpu.ops.pallas.fused_train import fused_train_pass as jax_train_pass
from nerface_tpu.ops.pallas.fused_train import prefold_paper_params as jax_prefold
from nerface_tpu.render.pipeline import _fused_conditioning as jax_fused_conditioning
from nerface_tpu.train.state import TrainState as JaxTrainState
from nerface_tpu.train.state import build_optimizer as jax_build_optimizer
from nerface_tpu.train.step import _compute_losses
from nerface_tpu_torch.config import CfgNode, FeatureFlags
from nerface_tpu_torch.models.nerf_models import (
    MODELS,
    ConditionalBlendshapePaperSmallerNeRFModel,
    build_model,
)
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_train as T
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.train import checkpoint as ckpt
from nerface_tpu_torch.train.fused import fused_losses, fused_train_eligible
from nerface_tpu_torch.train.state import build_optimizer, create_train_state
from test_torch_train import _batch, _compare_grads, _jax_draws, _opt_cfg, _settings

torch.set_num_threads(1)

SMALL = "ConditionalBlendshapePaperSmallerNeRFModel"
KW = dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False)
DIR_OFF = 256 + 24  # layers_dir.0's expression block: after the declared dir width
FAR = 0.8


@pytest.fixture(scope="module")
def pair():
    jm = JAX_MODELS[SMALL](**KW)
    jp = jm.init(jax.random.PRNGKey(3))
    tm = ConditionalBlendshapePaperSmallerNeRFModel(**KW)
    tm.load_state_dict(ckpt.params_from_jax({k: np.asarray(v) for k, v in jp.items()}),
                       strict=True)
    return jm, jp, tm


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(R, S, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(
        ro=(rng.randn(R, 3) * 0.05 + [0, 0, 0.5]).astype(f),
        rd=(rng.randn(R, 3) * [0.2, 0.2, 0.05] - [0, 0, 1]).astype(f),
        z=(0.2 + np.cumsum(rng.rand(R, S) * (1.2 / S), -1)).astype(f),
        target=rng.rand(R, 3).astype(f), bg=rng.rand(R, 3).astype(f),
        noise=rng.randn(R, S).astype(f), pe_dir=rng.randn(R, 24).astype(f),
        expr=(rng.randn(76) * 0.5).astype(f), latent=(rng.randn(32) * 0.1).astype(f),
    )


def test_state_dict_names_and_checkpoint_load(pair, tmp_path):
    """The JAX `init` dict's names and order (the Adam order): 5 trunk
    layers, layers_dir.0 reading [feat; dirs; expr], 3 direction layers;
    a reference-schema .ckpt of those weights loads with strict=True."""
    jm, jp, tm = pair
    sd = tm.state_dict()
    assert list(sd) == list(jp)
    assert "layers_xyz.5.weight" not in sd and "layers_dir.3.weight" not in sd
    assert tuple(sd["layers_dir.0.weight"].shape) == (128, 256 + 24 + 76)
    for k, v in jp.items():
        assert tuple(sd[k].shape) == v.shape, k
    path = str(tmp_path / "small.ckpt")
    torch.save({"iter": 3, "model_coarse_state_dict": sd, "model_fine_state_dict": sd,
                "background": None, "latent_codes": torch.zeros(2, 32)}, path)
    loaded = ckpt.load_torch_checkpoint(path)
    cfg = CfgNode({"type": SMALL, "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4,
                   "include_input_xyz": True, "include_input_dir": False, "use_viewdirs": True,
                   "num_layers": 4, "hidden_size": 256})
    m = build_model(cfg)
    assert isinstance(m, ConditionalBlendshapePaperSmallerNeRFModel) and SMALL in MODELS
    m.load_state_dict(loaded["fine"], strict=True)
    for k, v in m.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_forward_matches_jax_apply(pair, dtype):
    jm, jp, tm = pair
    x = _inputs(6, 16, seed=1)
    pts = x["ro"][:, None, :] + x["rd"][:, None, :] * x["z"][:, :, None]
    pe = positional_encoding(jnp.asarray(pts), 10, True, True)
    ref = np.asarray(jm.apply(jp, pe, jnp.asarray(x["pe_dir"]), jnp.asarray(x["expr"]),
                              jnp.asarray(x["latent"]),
                              dtype=jnp.bfloat16 if dtype else None))
    got = tm(_t(pe), _t(x["pe_dir"]), _t(x["expr"]), _t(x["latent"]),
             dtype=torch.bfloat16 if dtype else None).detach().numpy()
    assert got.shape == ref.shape == (6, 16, 4)
    np.testing.assert_allclose(got, ref, atol=(5e-3 if dtype else 1e-5) * np.abs(ref).max(),
                               rtol=0)


def test_conditioning_and_prefold_match_jax(pair):
    """The expression folds into dir_contrib at the declared dir width, in
    K2's conditioning and in the kernel bundle (26 tensors: no w5, b5)."""
    jm, jp, tm = pair
    x = _inputs(8, 16, seed=2)
    jcond, jdc, small = jax_fused_conditioning(jm, jp, jnp.asarray(x["pe_dir"]),
                                               jnp.asarray(x["expr"]), jnp.asarray(x["latent"]))
    cond, dc, tsmall = pipeline._fused_conditioning(tm, _t(x["pe_dir"]), _t(x["expr"]),
                                                    _t(x["latent"]))
    assert small is True and tsmall is True
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), atol=1e-6, rtol=0)
    np.testing.assert_allclose(dc.detach().numpy(), np.asarray(jdc), atol=1e-6, rtol=0)
    jb = jax_prefold(jp, jcond, jnp.asarray(x["pe_dir"]), 10, small=True, dir_expr_offset=DIR_OFF)
    tb = T.prefold_paper_params(dict(tm.named_parameters()), cond, _t(x["pe_dir"]), 10,
                                small=True, dir_expr_offset=DIR_OFF)
    assert len(tb) == len(jb) == 26
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)
    # the bundle's dir_contrib is K2's
    torch.testing.assert_close(tb[2], dc, atol=1e-6, rtol=0)


@pytest.mark.parametrize("S,with_bg", [(16, True), (64, False)])
def test_k2_small_plain_matches_jax_kernel(pair, S, with_bg):
    jm, jp, tm = pair
    x = _inputs(16, S, seed=S)
    jcond, jdc, _ = jax_fused_conditioning(jm, jp, jnp.asarray(x["pe_dir"]),
                                           jnp.asarray(x["expr"]), jnp.asarray(x["latent"]))
    bg = x["bg"] if with_bg else None
    ref = jax_fused_render(
        jp, jnp.asarray(x["ro"]), jnp.asarray(x["rd"]), jnp.asarray(x["z"]), jdc, jcond,
        background=None if bg is None else jnp.asarray(bg), out_weights=True, small=True,
    )
    got = K.fused_paper_render_reference(
        tm.state_dict(), _t(x["ro"]), _t(x["rd"]), _t(x["z"]), _t(jdc), _t(jcond),
        background=None if bg is None else _t(bg), out_weights=True, small=True,
    )
    assert set(got) == set(ref)
    for k in ("rgb", "acc", "bg_weight", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=2e-3, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(ref["depth"]), atol=2e-3 * FAR,
                               rtol=0)
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(ref["disp"]), rtol=1e-2)


@pytest.mark.parametrize("S", [16, 32])
def test_k1_small_plain_matches_jax_kernel(pair, S):
    jm, jp, tm = pair
    x = _inputs(16, S, seed=S + 1)
    cond = np.concatenate([x["expr"] / 3.0, x["latent"]]).astype(np.float32)
    jb = jax_prefold(jp, jnp.asarray(cond), jnp.asarray(x["pe_dir"]), 10, small=True,
                     dir_expr_offset=DIR_OFF)
    tb = T.prefold_paper_params(tm.state_dict(), _t(cond), _t(x["pe_dir"]), 10, small=True,
                                dir_expr_offset=DIR_OFF)
    kw = dict(noise_std=0.1, loss_scale=2.0 / (3.0 * 16), small=True)
    jo, jg, _ = jax_train_pass(jb, *(jnp.asarray(x[k]) for k in ("ro", "rd", "z", "target")),
                               background=jnp.asarray(x["bg"]), noise=jnp.asarray(x["noise"]), **kw)
    to, tg, _ = T.fused_train_pass_reference(
        tb, *(_t(x[k]) for k in ("ro", "rd", "z", "target")), background=_t(x["bg"]),
        noise=_t(x["noise"]), **kw)
    for k in ("rgb", "weights"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=2e-4, rtol=0, err_msg=k)
    wn, bn = K.bundle_names(True)
    names = ["d_cond0", "d_cond3", "d_dir"] + list(wn) + list(bn)
    assert len(tg) == len(jg) == len(names) == 26
    for name, a, b in zip(names, tg, jg):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=5e-3 * np.abs(b).max() + 1e-9, rtol=0,
                                   err_msg=name)


def test_packed_layouts_leave_w5_zero(pair):
    _, _, tm = pair
    sd = tm.state_dict()
    packed = K.pack_paper_weights(sd)
    o, n = K.W_OFFSETS["W5"], 256 * 256
    assert not packed.wbuf_sm90[o:o + n].float().any()
    o = K.F_OFFSETS["B5"]
    assert not packed.fbuf[o:o + 256].any()
    with pytest.raises(ValueError, match="small"):  # called as the paper model
        K.fused_paper_render(packed, *(torch.zeros(2, n) for n in (3, 3, 32, 128)),
                             torch.zeros(108))
    _, _, _, W, _ = K._unbundle(T.prefold_paper_params(sd, torch.zeros(108), torch.zeros(2, 24),
                                                       10, small=True), True)
    wt = K.pack_transposed_weights(W)
    o = K.WT_OFFSETS["W5T"]
    assert wt.numel() == K.WT_OFFSETS["TOTAL"] and not wt[o:o + n].float().any()


def test_fused_train_eligibility_needs_one_variant():
    tset, _ = _settings()
    flags = FeatureFlags()
    small = ConditionalBlendshapePaperSmallerNeRFModel(**KW)
    paper = MODELS["ConditionalBlendshapePaperNeRFModel"](**KW)
    assert fused_train_eligible(small, small, tset, flags, torch.bfloat16, "cpu", 64)
    assert not fused_train_eligible(small, paper, tset, flags, torch.bfloat16, "cpu", 64)
    assert not fused_train_eligible(paper, small, tset, flags, torch.bfloat16, "cpu", 64)
    no_expr = ConditionalBlendshapePaperSmallerNeRFModel(**KW, include_expression=False)
    assert not fused_train_eligible(no_expr, no_expr, tset, flags, torch.bfloat16, "cpu", 64)


def test_bf16_step_through_fused_losses_matches_jax_f32(pair):
    """K1's `small` plain version through `fused_losses` against the JAX
    package's f32 XLA path, with its draws; the port's state is the JAX
    TrainState's (`train_state_from_jax`: weights and Adam order)."""
    jm, jp, _ = pair
    params = {"coarse": dict(jp), "fine": dict(jp), "background": None,
              "latent_codes": jnp.asarray(np.random.RandomState(0).randn(4, 32).astype(np.float32)
                                          * 0.1)}
    jopt = jax_build_optimizer(JaxCfgNode(_opt_cfg()))
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           opt_state=jopt.init(params), fixed_background=None)
    flags = FeatureFlags()
    state = create_train_state(ConditionalBlendshapePaperSmallerNeRFModel(**KW),
                               ConditionalBlendshapePaperSmallerNeRFModel(**KW), flags, n_train=4)
    opt = build_optimizer(CfgNode(_opt_cfg()), state)
    ckpt.train_state_from_jax(jax.device_get(jstate), state, opt)
    tset, jset = _settings(0.1)
    R = 64
    assert fused_train_eligible(state.model_coarse, state.model_fine, tset, flags, torch.bfloat16,
                                "cpu", R)
    jb, tb = _batch(R, seed=11)
    key = jax.random.PRNGKey(1)

    def loss_fn(p):
        return _compute_losses(p, jb, key, jm, jm, jset, JaxFlags(), None)

    (jtot, jm_), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    total, metrics = fused_losses(state, tb, 0, tset, flags, draws=_jax_draws(key, R))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtot), rtol=0.03)
    for k in jm_:
        np.testing.assert_allclose(float(metrics[k]), float(jm_[k]), rtol=0.03, atol=1e-6,
                                   err_msg=k)
    _compare_grads(state, jg, 0.25, 2e-6)
