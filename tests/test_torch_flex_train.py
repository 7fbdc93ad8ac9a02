"""PyTorch port, training the Flexible family: `ConditionalBlendshapeLearnableCodeNeRFModel`
through the port's render pipeline and train loop, held against the JAX
package on the CPU.

* `_apply_model` sends an eligible Flexible model in bf16 to K4
  (`fused_flex_mlp`, its plain version on CPU tensors) and an ineligible
  one (a skip layer engaged, no view directions) or an f32 call to the
  model's own forward.
* One f32 step of `compute_losses` with the JAX package's draws injected
  against `jax.value_and_grad(_compute_losses)`: loss rtol 1e-5, every
  gradient atol 2e-4·max|JAX| + 1e-10 (the same f32 math summed in another
  order; tests/test_torch_train.py's limits for the paper model). The σ
  head's gradients 5e-3·max: their terms cancel.
* One bf16 step through K4 by autograd (K4f forward, K4b backward: their
  plain versions here) against the JAX f32 path: loss rtol 0.03, gradients
  atol 0.25·max + 2e-6 — tests/test_fused_train.py's envelope for bf16
  operands against f32.
* The whole slice: `train()` of both packages, f32, 3 steps from one
  reference-schema checkpoint on a 16×16 dataset (perturb off, σ-noise 0:
  no random draws): per-step losses rtol 1e-4; final parameters atol
  10·lr, ≥ 99 % of elements within 1e-5 (Adam's first steps move a
  parameter by ≈ lr·sign(g), so a gradient near 0 may flip its step).
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.config.flags import FeatureFlags as JaxFlags
from nerface_tpu.data.flame import load_flame_data as jax_load_flame_data
from nerface_tpu.data.synthetic import make_synthetic_flame_dataset
from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.ops import sampling as jsamp
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerface_tpu.train.loop import train as jax_train
from nerface_tpu.train.state import TrainState as JaxTrainState
from nerface_tpu.train.state import build_optimizer as jax_build_optimizer
from nerface_tpu.train.step import _compute_losses
from nerface_tpu_torch.config import CfgNode, FeatureFlags
from nerface_tpu_torch.data.flame import load_flame_data
from nerface_tpu_torch.data.pipeline import batch_to_device
from nerface_tpu_torch.models.nerf_models import MODELS
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings
from nerface_tpu_torch.train import checkpoint as ckpt
from nerface_tpu_torch.train.loop import build_models_from_cfg, train
from nerface_tpu_torch.train.state import build_optimizer, create_train_state
from nerface_tpu_torch.train.step import compute_losses
from test_torch_train import pin_numpy_feeds

torch.set_num_threads(1)

NAME = "ConditionalBlendshapeLearnableCodeNeRFModel"
KW = dict(num_layers=4, hidden_size=256, num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
          include_input_dir=False)
SC = SF = 16
OPT = {"optimizer": {"type": "Adam", "lr": 5e-4},
       "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1}}


def _settings(noise=0.1):
    kw = dict(num_coarse=SC, num_fine=SF, perturb=True, radiance_field_noise_std=noise,
              near=0.2, far=0.8)
    return (
        RenderSettings(**kw, encode_xyz=EncodeSpec(10, True, True),
                       encode_dir=EncodeSpec(4, False, True)),
        JaxRenderSettings(**kw, encode_xyz=JaxEncodeSpec(10, True, True),
                          encode_dir=JaxEncodeSpec(4, False, True), fused="off"),
    )


def _pair():
    """A JAX TrainState and the port's state on its weights (both models
    from one init, a random latent table)."""
    jm = JAX_MODELS[NAME](**KW)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = {"coarse": dict(jp), "fine": dict(jp),
              "latent_codes": jnp.asarray(rng.randn(4, 32).astype(np.float32) * 0.1),
              "background": None}
    jopt = jax_build_optimizer(JaxCfgNode(copy.deepcopy(OPT)))
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           opt_state=jopt.init(params), fixed_background=None)
    flags = FeatureFlags()
    state = create_train_state(MODELS[NAME](**KW), MODELS[NAME](**KW), flags, n_train=4)
    opt = build_optimizer(CfgNode(copy.deepcopy(OPT)), state)
    ckpt.train_state_from_jax(jax.device_get(jstate), state, opt)
    return jm, jstate, JaxFlags(), state, flags


def _batch(R, seed):
    rng = np.random.RandomState(seed)
    rd = rng.randn(R, 3).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    b = {
        "ray_origins": np.zeros((R, 3), np.float32),
        "ray_directions": rd,
        "target_rgb": rng.rand(R, 3).astype(np.float32),
        "background_rgb": rng.rand(R, 3).astype(np.float32),
        "expression": (rng.randn(76) * 0.1).astype(np.float32),
        "latent_index": np.int32(1),
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


def _compare_grads(state, jgrads, rel, floor, sigma_head_rel):
    port = {}
    for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
        for name, p in m.named_parameters():
            port[f"['{which}']['{name}']"] = p.grad
    port["['latent_codes']"] = state.latent_codes.grad
    seen = 0
    for path, v in jax.tree_util.tree_leaves_with_path(jgrads):
        name = jax.tree_util.keystr(path)
        v = np.asarray(v)
        r = sigma_head_rel if "fc_alpha" in name else rel
        np.testing.assert_allclose(port[name].numpy(), v, atol=r * np.abs(v).max() + floor,
                                   rtol=0, err_msg=name)
        seen += 1
    assert seen == 2 * 16 + 1  # 8 layers a model, the latent table


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16_k4"])
def test_step_matches_jax_value_and_grad(dtype, monkeypatch):
    jm, jstate, jflags, state, flags = _pair()
    tset, jset = _settings()
    R = 32
    jb, tb = _batch(R, seed=7)
    key = jax.random.PRNGKey(1)

    def loss_fn(params):
        return _compute_losses(params, jb, key, jm, jm, jset, jflags, None)

    (jtot, jmetrics), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    calls = []
    real = pipeline.fused_flex_mlp
    monkeypatch.setattr(pipeline, "fused_flex_mlp",
                        lambda *a, **k: calls.append(a[3].shape) or real(*a, **k))
    total, metrics = compute_losses(state, tb, 0, tset, flags, dtype=dtype,
                                    draws=_jax_draws(key, R))
    total.backward()
    if dtype is None:
        assert calls == []
        np.testing.assert_allclose(float(total.detach()), float(jtot), rtol=1e-5)
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5,
                                       atol=1e-9, err_msg=k)
        _compare_grads(state, jg, 2e-4, 1e-10, 5e-3)
    else:
        assert calls == [(R, SC), (R, SC + SF)]  # both passes through K4
        np.testing.assert_allclose(float(total.detach()), float(jtot), rtol=0.03)
        _compare_grads(state, jg, 0.25, 2e-6, 0.25)


def test_apply_model_dispatch(monkeypatch):
    """bf16 + an eligible Flexible model (hidden 256, 512, 768 or 1024) →
    one K4 call; a skip layer engaged, no view directions, hidden 1280 (the
    first width past the kernels'), or f32 → the model's own forward."""
    calls = []
    real = pipeline.fused_flex_mlp
    monkeypatch.setattr(pipeline, "fused_flex_mlp", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.RandomState(3)
    R, S = 4, 8
    ro = torch.from_numpy(rng.randn(R, 3).astype(np.float32) * 0.1)
    rd = torch.from_numpy(rng.randn(R, 3).astype(np.float32))
    z = torch.from_numpy(np.sort(rng.rand(R, S).astype(np.float32), -1))
    pe_dir = torch.from_numpy(rng.randn(R, 24).astype(np.float32))
    expr = torch.from_numpy(rng.randn(76).astype(np.float32) * 0.1)
    latent = torch.from_numpy(rng.randn(32).astype(np.float32) * 0.1)
    enc = EncodeSpec(10, True, True)

    def run(model, dtype=torch.bfloat16, pe=pe_dir):
        forwards = []
        handle = model.register_forward_hook(lambda *a: forwards.append(1))
        before = len(calls)
        out = pipeline._apply_model(model, ro, rd, z, enc, pe, expr, latent, dtype)
        handle.remove()
        return len(calls) - before, len(forwards), out

    m = MODELS[NAME](**KW)
    n_k4, n_fwd, out = run(m)
    assert (n_k4, n_fwd) == (1, 0) and out.shape == (R, S, 4)
    # the K4 call computes the model's function (bf16 operands: 0.02·max)
    ref = m(enc(ro[:, None, :] + rd[:, None, :] * z[..., None]), pe_dir, expr, latent)
    torch.testing.assert_close(out, ref, atol=0.02 * float(ref.detach().abs().max()), rtol=0)
    assert run(m, dtype=None)[:2] == (0, 1)
    skip = MODELS[NAME](**dict(KW, num_layers=6, skip_connect_every=3))
    assert run(skip)[:2] == (0, 1)
    no_dirs = MODELS[NAME](**dict(KW, use_viewdirs=False))
    assert run(no_dirs, pe=None)[:2] == (0, 1)
    wide = MODELS[NAME](**dict(KW, hidden_size=512))
    assert run(wide)[:2] == (1, 0)  # h = 512: K4
    wider = MODELS[NAME](**dict(KW, hidden_size=1280))
    assert run(wider)[:2] == (0, 1)  # JAX's kernel takes 1280; the port's stop at 1024


def _train_cfg(basedir, logdir):
    model = {
        "type": NAME, "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4,
        "include_input_xyz": True, "include_input_dir": False, "use_viewdirs": True,
        "num_layers": 4, "hidden_size": 256, "skip_connect_every": 3,
        "log_sampling_xyz": True, "log_sampling_dir": True,
    }
    node = {"chunksize": 256, "perturb": False, "num_coarse": SC, "num_fine": SF,
            "white_background": False, "radiance_field_noise_std": 0.0, "lindisp": False}
    return {
        "experiment": {"id": "flex", "logdir": logdir, "randomseed": 42, "train_iters": 3,
                       "validate_every": 0, "save_every": 0, "print_every": 1,
                       "steps_per_execute": "auto"},
        "dataset": {"type": "blender", "basedir": basedir, "half_res": False, "testskip": 1,
                    "no_ndc": True, "near": 0.2, "far": 0.8},
        "models": {"coarse": dict(model), "fine": dict(model)},
        **copy.deepcopy(OPT),
        "nerf": {"use_viewdirs": True, "encode_position_fn": "positional_encoding",
                 "encode_direction_fn": "positional_encoding",
                 "train": dict(node, num_random_rays=64), "validation": dict(node)},
    }


def test_whole_slice_matches_jax_train(tmp_path, capsys, monkeypatch):
    pin_numpy_feeds(monkeypatch)  # both packages' host feeds on their numpy paths
    ds_dir = make_synthetic_flame_dataset(str(tmp_path / "ds"), H=16, W=16, n_train=4, n_val=2,
                                          n_test=1, num_samples=8)
    d = _train_cfg(ds_dir, str(tmp_path / "runs"))
    cfg = CfgNode(d)
    mc, mf = build_models_from_cfg(cfg, generator=torch.Generator().manual_seed(3))
    start = str(tmp_path / "start.ckpt")
    torch.save({"iter": 0, "model_coarse_state_dict": mc.state_dict(),
                "model_fine_state_dict": mf.state_dict(), "optimizer_state_dict": None,
                "loss": 0.0, "psnr": 0.0, "background": None,
                "latent_codes": torch.zeros(4, 32)}, start)

    jstate = jax_train(JaxCfgNode(copy.deepcopy(d)), load_checkpoint=start,
                       dataset=jax_load_flame_data(ds_dir), log=False)
    jax_losses = [float(v) for v in re.findall(r"\[TRAIN\] Iter: \d+ Loss: ([0-9.]+)",
                                               capsys.readouterr().out)]
    state = train(cfg, load_checkpoint=start, dataset=load_flame_data(ds_dir), device="cpu")
    losses = [float(v) for v in re.findall(r"\[TRAIN\] Iter: \d+ Loss: ([0-9.]+)",
                                           capsys.readouterr().out)]
    assert state.step == int(jstate.step) == 3
    assert len(jax_losses) == len(losses) == 3
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    lr = 5e-4
    for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
        for name, p in m.named_parameters():
            got, want = p.detach().numpy(), np.asarray(jstate.params[which][name])
            np.testing.assert_allclose(got, want, atol=10 * lr, rtol=0, err_msg=name)
            assert np.mean(np.abs(got - want) <= 1e-5) >= 0.99, name
    np.testing.assert_allclose(state.latent_codes.detach().numpy(),
                               np.asarray(jstate.params["latent_codes"]), atol=10 * lr)


def test_validation_renders_models_without_a_latent(monkeypatch):
    """`validate()` hands a 32-wide zero latent to every model; one that
    takes none (ConditionalBlendshapeNeRFModel) renders through K4 in bf16
    all the same, both passes of each tile."""
    from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
    from nerface_tpu_torch.train.loop import validate

    d = _train_cfg("", "/nonexistent")
    for node in d["models"].values():
        node["type"] = "ConditionalBlendshapeNeRFModel"
    cfg = CfgNode(d)
    ds = synthetic_flame_dataset(H=8, W=8, n_train=2, n_val=1, n_test=1, with_images=True)
    flags = FeatureFlags.from_cfg(cfg)
    mc, mf = build_models_from_cfg(cfg, generator=torch.Generator().manual_seed(0))
    assert not mc.takes_latent and flags.train_latent_codes
    state = create_train_state(mc, mf, flags, n_train=2)
    calls = []
    real = pipeline.fused_flex_mlp
    monkeypatch.setattr(pipeline, "fused_flex_mlp", lambda *a, **k: calls.append(1) or real(*a, **k))
    out = validate(cfg, ds, state, flags, 0, num_frames=1, dtype=torch.bfloat16)
    assert np.isfinite(out["loss"]) and len(calls) == 2


def test_checkpoint_interop_with_the_expression_compressors(tmp_path):
    """A JAX `export_torch_checkpoint` of the compressed-expression
    LearnableCode model (its `layer_expr`) after one optax update resumes
    the port with params, Adam moments and count equal, by name; and
    `train_state_from_jax` gives the same state."""
    from nerface_tpu.train import checkpoint as jax_ckpt

    name = "ConditionalCompressedBlendshapeLearnableCodeNeRFModel"
    jm = JAX_MODELS[name](**KW)
    jp = jm.init(jax.random.PRNGKey(6))
    rng = np.random.RandomState(1)
    params = {"coarse": dict(jp), "fine": dict(jp),
              "latent_codes": jnp.asarray(rng.randn(4, 32).astype(np.float32)),
              "background": None}
    jopt = jax_build_optimizer(JaxCfgNode(copy.deepcopy(OPT)))
    grads = jax.tree.map(lambda v: jnp.asarray(rng.randn(*v.shape).astype(np.float32)), params)
    _, jos = jopt.update(grads, jopt.init(params), params)
    jstate = JaxTrainState(step=jnp.asarray(1, jnp.int32), params=params, opt_state=jos,
                           fixed_background=None)
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.export_torch_checkpoint(path, jstate, lr=5e-4)
    adam = jax_ckpt._find_adam_state(jos)
    flags = FeatureFlags()
    for load in ("ckpt", "state"):
        state = create_train_state(MODELS[name](**KW), MODELS[name](**KW), flags, n_train=4)
        opt = build_optimizer(CfgNode(copy.deepcopy(OPT)), state)
        if load == "ckpt":
            ckpt.restore_train_state(state, opt, ckpt.load_torch_checkpoint(path))
        else:
            ckpt.train_state_from_jax(jax.device_get(jstate), state, opt)
        assert list(dict(state.model_fine.named_parameters())) == list(jp)
        assert "layer_expr.weight" in jp
        for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
            for pname, p in m.named_parameters():
                np.testing.assert_array_equal(p.detach().numpy(),
                                              np.asarray(params[which][pname]), err_msg=pname)
                np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(),
                                              np.asarray(adam.mu[which][pname]), err_msg=pname)
                np.testing.assert_array_equal(opt.state[p]["exp_avg_sq"].numpy(),
                                              np.asarray(adam.nu[which][pname]), err_msg=pname)
        assert int(opt.state[state.latent_codes]["step"]) == 1 and state.step == 1
