"""PyTorch port, the stock NeRF models: `VeryTinyNeRFModel`,
`MultiHeadNeRFModel`, `ReplicateNeRFModel` and `PaperNeRFModel` as
nn.Modules, and the auxiliary `ImageEncoder` / `DiscriminatorModel`,
against the JAX package's `apply` on JAX-initialised weights carried over
by `params_from_jax` and loaded with `load_state_dict(strict=True)`.

* Forwards, flat (N, D) and structured (R, S, D) input, at a narrow width
  where the class has one (the paper model's 256 / 128 are fixed): f32 on
  both sides, max |Δ| ≤ 1e-5·max|JAX| (the two frameworks sum each dot
  product in another order).
* A JAX `export_torch_checkpoint` `.ckpt` of each class loads with
  `strict=True` and computes what JAX computes.
* One f32 training step of each class through the port's
  `compute_losses` against `jax.value_and_grad(_compute_losses)` with the
  JAX package's draws injected: loss rtol 1e-5, every gradient within
  1e-4·max|JAX|, except the σ head's, within 5e-3·max|JAX|: torch's
  cumprod backward divides by its input and JAX's does not, and the σ
  head's terms cancel (ROADMAP.md Queue 3, "f32 gradients of the unfused
  path"; tests/test_torch_flex_train.py holds the Flexible family's σ head
  to the same limit). They read 4.7e-5 to 1.6e-3 here. A tensor torch
  leaves without a gradient (`layers_dir.3`, never applied) has JAX's
  gradient zero.
* `build_model` gives each stock class JAX's parameter shapes, with the
  reference's quirks; no kernel takes a stock model, even in bf16 with the
  eval renderer's `fused_render`.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.config.flags import FeatureFlags as JaxFlags
from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.models import DiscriminatorModel as JaxDiscriminator
from nerface_tpu.models import ImageEncoder as JaxImageEncoder
from nerface_tpu.ops import sampling as jsamp
from nerface_tpu.ops.encoding import positional_encoding
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerface_tpu.train import checkpoint as jax_ckpt
from nerface_tpu.train.state import TrainState as JaxTrainState
from nerface_tpu.train.state import build_optimizer as jax_build_optimizer
from nerface_tpu.train.step import _compute_losses
from nerface_tpu_torch.config import CfgNode, FeatureFlags
from nerface_tpu_torch.data.pipeline import batch_to_device
from nerface_tpu_torch.models.encoder import DiscriminatorModel, ImageEncoder
from nerface_tpu_torch.models.nerf_models import MODELS, build_model
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings
from nerface_tpu_torch.train import checkpoint as ckpt
from nerface_tpu_torch.train.state import create_train_state
from nerface_tpu_torch.train.step import compute_losses

torch.set_num_threads(1)

# each class at a narrow width, with the bands its PE(xyz) input needs
# (VeryTiny and MultiHead read 6 bands whatever the config says)
STOCK = {
    "VeryTinyNeRFModel": (dict(filter_size=32), 6, 4, False),
    "MultiHeadNeRFModel": (dict(hidden_size=32), 6, 4, False),
    "ReplicateNeRFModel": (dict(hidden_size=32, num_encoding_fn_xyz=4, num_encoding_fn_dir=2), 4,
                           2, True),
    "PaperNeRFModel": (dict(num_encoding_fn_xyz=4, num_encoding_fn_dir=2), 4, 2, True),
}
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
SIGMA_HEAD_TOL = 5e-3
# the layers whose only output is σ
SIGMA_HEAD = {"MultiHeadNeRFModel": "layer3_1.", "ReplicateNeRFModel": "fc_alpha.",
              "PaperNeRFModel": "fc_alpha."}


def _jax_params(name, seed=0):
    kw = STOCK[name][0]
    jm = JAX_MODELS[name](**kw)
    return jm, jm.init(jax.random.PRNGKey(seed))


def _pair(name, seed=0):
    jm, jp = _jax_params(name, seed)
    tm = MODELS[name](**STOCK[name][0])
    tm.load_state_dict(ckpt.params_from_jax({k: np.asarray(v) for k, v in jp.items()}), strict=True)
    return jm, jp, tm


def _inputs(name, R=5, S=7, seed=1):
    _, lx, ld, inc_dir = STOCK[name]
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.5, 0.5, (R, S, 3)).astype(np.float32)
    dirs = rng.randn(R, 3).astype(np.float32)
    pe_xyz = positional_encoding(jnp.asarray(pts), lx, True, True)
    pe_dir = positional_encoding(jnp.asarray(dirs), ld, inc_dir, True)
    return pe_xyz, pe_dir


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, msg=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, msg
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max(), err_msg=msg)


@pytest.mark.parametrize("layout", ["structured", "flat"])
@pytest.mark.parametrize("name", list(STOCK))
def test_forward_matches_jax_f32(name, layout):
    jm, jp, tm = _pair(name)
    assert list(tm.state_dict()) == list(jp)  # the JAX init order: Adam's order
    pe_xyz, pe_dir = _inputs(name)
    if layout == "flat":
        S = pe_xyz.shape[1]
        pe_xyz = pe_xyz.reshape(-1, pe_xyz.shape[-1])
        pe_dir = jnp.repeat(pe_dir, S, axis=0)
    ref = jm.apply(jp, pe_xyz, pe_dir)
    got = tm(_t(pe_xyz), _t(pe_dir))
    _close(got, ref, FWD_TOL, name)
    assert not tm.takes_expression and not tm.takes_latent


def test_image_encoder_matches_jax():
    jm = JaxImageEncoder()
    jp = jm.init(jax.random.PRNGKey(1))
    tm = ImageEncoder()
    assert list(tm.state_dict()) == list(jp) == [
        f"cnn_layers.{i}.{p}" for i in (0, 3, 6, 9, 12) for p in ("weight", "bias")]
    tm.load_state_dict(ckpt.params_from_jax({k: np.asarray(v) for k, v in jp.items()}),
                       strict=True)
    x = np.random.RandomState(2).randn(2, 3, 256, 256).astype(np.float32)
    got = tm(_t(x))
    assert got.shape == (2, 128, 1, 1)
    _close(got, jm.apply(jp, jnp.asarray(x)), FWD_TOL)


def test_discriminator_matches_jax():
    jm = JaxDiscriminator()
    jp = jm.init(jax.random.PRNGKey(1))
    tm = DiscriminatorModel()
    assert list(tm.state_dict()) == list(jp) == [
        f"model.{i}.{p}" for i in (0, 2, 4) for p in ("weight", "bias")]
    tm.load_state_dict(ckpt.params_from_jax({k: np.asarray(v) for k, v in jp.items()}),
                       strict=True)
    x = np.random.RandomState(3).randn(6, 32).astype(np.float32)
    _close(tm(_t(x)), jm.apply(jp, jnp.asarray(x)), FWD_TOL)


OPT = {"optimizer": {"type": "Adam", "lr": 5e-4},
       "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1}}


def _jax_state(name, seed):
    """A JAX TrainState of one class, coarse and fine from two inits, with no
    latent table and no background (the stock models' run)."""
    _, jc = _jax_params(name, seed)
    _, jf = _jax_params(name, seed + 1)
    params = {"coarse": dict(jc), "fine": dict(jf), "latent_codes": None, "background": None}
    jopt = jax_build_optimizer(JaxCfgNode(copy.deepcopy(OPT)))
    return JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                         opt_state=jopt.init(params), fixed_background=None)


@pytest.mark.parametrize("name", list(STOCK))
def test_jax_exported_ckpt_loads_strict(name, tmp_path):
    jstate = _jax_state(name, seed=4)
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.export_torch_checkpoint(path, jstate)
    loaded = ckpt.load_torch_checkpoint(path)
    jm = JAX_MODELS[name](**STOCK[name][0])
    pe_xyz, pe_dir = _inputs(name, seed=5)
    for which in ("coarse", "fine"):
        tm = MODELS[name](**STOCK[name][0])
        tm.load_state_dict(loaded[which], strict=True)
        _close(tm(_t(pe_xyz), _t(pe_dir)), jm.apply(jstate.params[which], pe_xyz, pe_dir),
               FWD_TOL, which)


SC = SF = 8
FLAGS = dict(train_latent_codes=False, fixed_background=False)


def _settings(name):
    _, lx, ld, inc_dir = STOCK[name]
    kw = dict(num_coarse=SC, num_fine=SF, perturb=True, radiance_field_noise_std=0.1,
              near=2.0, far=6.0)
    return (RenderSettings(**kw, encode_xyz=EncodeSpec(lx, True, True),
                           encode_dir=EncodeSpec(ld, inc_dir, True)),
            JaxRenderSettings(**kw, encode_xyz=JaxEncodeSpec(lx, True, True),
                              encode_dir=JaxEncodeSpec(ld, inc_dir, True), fused="off"))


def _batch(R, seed):
    rng = np.random.RandomState(seed)
    rd = rng.randn(R, 3).astype(np.float32) * 0.3
    rd[:, 2] = -1.0
    b = {
        "ray_origins": (rng.randn(R, 3) * 0.1).astype(np.float32) + np.float32([0, 0, 4.0]),
        "ray_directions": rd,
        "target_rgb": rng.rand(R, 3).astype(np.float32),
        "expression": (rng.randn(76) * 0.1).astype(np.float32),
        "latent_index": np.int32(0),
        "ray_index": np.arange(R, dtype=np.int32),
    }
    return {k: jnp.asarray(v) for k, v in b.items()}, batch_to_device(b, "cpu")


def _jax_draws(key, R):
    idx = jnp.arange(R, dtype=jnp.int32)
    k_strat, k_noise_c, k_pdf, k_noise_f = jax.random.split(key, 4)
    d = {
        "t_rand": jsamp.per_ray_uniform(k_strat, idx, SC),
        "noise_c": jsamp.per_ray_normal(k_noise_c, idx, SC),
        "u": jsamp.per_ray_uniform(k_pdf, idx, SF),
        "noise_f": jsamp.per_ray_normal(k_noise_f, idx, SC + SF),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("name", list(STOCK))
def test_step_matches_jax_value_and_grad(name, monkeypatch):
    """One f32 step, the JAX package's draws injected: no hand kernel runs
    (the stock models take no conditioning), loss and every gradient equal
    JAX's."""
    jstate = _jax_state(name, seed=6)
    jm = JAX_MODELS[name](**STOCK[name][0])
    tset, jset = _settings(name)
    R = 24
    jb, tb = _batch(R, seed=7)
    key = jax.random.PRNGKey(2)

    def loss_fn(params):
        return _compute_losses(params, jb, key, jm, jm, jset, JaxFlags(**FLAGS), None)

    (jtot, jmetrics), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)

    flags = FeatureFlags(**FLAGS)
    kw = STOCK[name][0]
    state = create_train_state(MODELS[name](**kw), MODELS[name](**kw), flags, n_train=1)
    for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
        m.load_state_dict(ckpt.params_from_jax(
            {k: np.asarray(v) for k, v in jstate.params[which].items()}), strict=True)
    for k in ("fused_flex_mlp", "fused_paper_mlp", "fused_paper_render"):
        monkeypatch.setattr(pipeline, k, lambda *a, **kw: pytest.fail("a kernel ran"))
    total, metrics = compute_losses(state, tb, 0, tset, flags, draws=_jax_draws(key, R))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtot), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["psnr"]), float(jmetrics["psnr"]), rtol=1e-5)
    seen = 0
    for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
        for pname, p in m.named_parameters():
            ref = np.asarray(jg[which][pname])
            if p.grad is None:
                assert pname.startswith("layers_dir.3.") and not ref.any(), pname
                continue
            sigma = name in SIGMA_HEAD and pname.startswith(SIGMA_HEAD[name])
            tol = SIGMA_HEAD_TOL if sigma else GRAD_TOL
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max(),
                                       err_msg=f"{which}.{pname}")
            seen += 1
    unused = 2 if name == "PaperNeRFModel" else 0  # layers_dir.3's weight and bias
    assert seen == 2 * (len(jstate.params["coarse"]) - unused)


def _model_cfg(type_name, **kw):
    d = {"type": type_name, "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4,
         "include_input_xyz": True, "include_input_dir": False, "use_viewdirs": True,
         "num_layers": 4, "hidden_size": 256}
    d.update(kw)
    return d


def test_build_model_quirks_match_jax():
    """VeryTiny takes `filter_size`, so build_model's hidden_size is
    swallowed; the paper model's widths are fixed and `layers_dir.3` is
    created; ReplicateNeRFModel halves its width after the σ head."""
    from nerface_tpu.models import build_model as jax_build_model

    for name in STOCK:
        cfg = _model_cfg(name, hidden_size=64)
        tm = build_model(CfgNode(copy.deepcopy(cfg)))
        jp = jax_build_model(JaxCfgNode(copy.deepcopy(cfg))).init(jax.random.PRNGKey(0))
        shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
        assert shapes == {k: tuple(v.shape) for k, v in jp.items()}, name
    tiny = build_model(CfgNode(_model_cfg("VeryTinyNeRFModel", hidden_size=64)))
    assert tiny.layer2.weight.shape == (128, 128)
    paper = build_model(CfgNode(_model_cfg("PaperNeRFModel", hidden_size=64)))
    assert paper.layers_xyz[3].weight.shape == (256, 63 + 256)
    assert "layers_dir.3.weight" in paper.state_dict()


@pytest.mark.parametrize("name", list(STOCK))
def test_no_kernel_takes_a_stock_model(name, monkeypatch):
    """In bf16 with the eval renderer's `fused_render`, a stock model still
    runs its own forward (the JAX package gates its kernels on the paper
    and Flexible families): no wrapper of K2, K3 or K4 is called."""
    import dataclasses

    for k in ("fused_flex_mlp", "fused_paper_mlp", "fused_paper_render"):
        monkeypatch.setattr(pipeline, k, lambda *a, **kw: pytest.fail("a kernel ran"))
    kw = STOCK[name][0]
    tset, _ = _settings(name)
    tset = dataclasses.replace(tset, fused_render=True, radiance_field_noise_std=0.0)
    _, tb = _batch(16, seed=8)
    with torch.no_grad():
        out = pipeline.render_rays(MODELS[name](**kw), MODELS[name](**kw), tb["ray_origins"],
                                   tb["ray_directions"], tset, dtype=torch.bfloat16,
                                   expressions=tb["expression"], latent_code=torch.zeros(32))
    assert out["rgb_fine"].shape == (16, 3) and torch.isfinite(out["rgb_fine"]).all()
