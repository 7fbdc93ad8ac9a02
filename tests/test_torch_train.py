"""PyTorch port, the training slice: `nerface_tpu_torch.train` and what it
runs, held against the JAX package on the CPU.

Tolerances, with their reasons:

* One f32 step with the JAX package's own draws injected (its 4-way key
  split: `per_ray_uniform` / `per_ray_normal`) against
  `jax.value_and_grad(_compute_losses)`: loss rtol 1e-5, every gradient
  atol 2e-4·max|JAX| + 1e-10 — the same f32 math, summed in another order:
  a gradient that is a sum of many terms of both signs (the σ head's bias)
  keeps their rounding at ~1e-4 of its size, and the 2^9 band of the
  encoding multiplies ulp differences in the resampled depths by 512
  (readings ≤ 2.1e-5·max). The σ head's gradients atol 5e-3·max: with a
  white background and no prior its terms cancel to ~1e-3 of their size,
  and torch's cumprod backward divides by 1 − α + 1e-10 where JAX's does
  not (reading 2.3e-3·max).
* The fused path (K1's plain bf16 version on the CPU) against the JAX f32
  XLA path, in the cases of tests/test_fused_train.py:133-200: loss and
  metrics rtol 0.03, gradients atol 0.25·max + 2e-6 — that test's
  envelope for bf16 operands against f32.
* Adam + the LR schedule against optax's over 5 steps on the same
  gradients: parameters atol 1e-3·lr (a few ulps of a parameter: the f32
  rounding of the same update), moments atol 1e-5·max.
* `RayFeed`: bit-identical batches, the numpy path of both packages and
  the native path of both.
* The whole slice, `train()` of both packages for 3 steps on the same
  weights and data with deterministic draws: per-step losses rtol 1e-4;
  final parameters atol 10·lr, ≥ 99 % of elements within 1e-5 — Adam's
  first steps move a parameter by ≈ lr·sign(g), so a gradient near 0 may
  flip its step between two f32 summation orders.
"""

import copy
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerface_tpu.native
from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.config.flags import FeatureFlags as JaxFlags
from nerface_tpu.data.flame import load_flame_data as jax_load_flame_data
from nerface_tpu.data.pipeline import RayFeed as JaxRayFeed
from nerface_tpu.data.synthetic import make_synthetic_flame_dataset
from nerface_tpu.models import MODELS
from nerface_tpu.ops import sampling as jsamp
from nerface_tpu.ops.safe import safe_norm as jax_safe_norm
from nerface_tpu.render.pipeline import EncodeSpec as JaxEncodeSpec
from nerface_tpu.render.pipeline import RenderSettings as JaxRenderSettings
from nerface_tpu.train import checkpoint as jax_ckpt
from nerface_tpu.train.loop import train as jax_train
from nerface_tpu.train.schedule import from_cfg as jax_schedule_from_cfg
from nerface_tpu.train.state import build_optimizer as jax_build_optimizer
from nerface_tpu.train.state import TrainState as JaxTrainState
from nerface_tpu.train.step import _compute_losses
from nerface_tpu_torch.cli import train as cli_train
from nerface_tpu_torch.config import CfgNode, FeatureFlags
from nerface_tpu_torch.data.flame import load_flame_data
from nerface_tpu_torch.data.pipeline import RayFeed, batch_to_device
from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
from nerface_tpu_torch.models.nerf_models import ConditionalBlendshapePaperNeRFModel
from nerface_tpu_torch.ops.safe import safe_norm
from nerface_tpu_torch.ops.sampling import per_ray_normal
from nerface_tpu_torch.render.pipeline import EncodeSpec, RenderSettings
from nerface_tpu_torch.train import checkpoint as ckpt
from nerface_tpu_torch.train import loop as loop_mod
from nerface_tpu_torch.train.fused import fused_losses, fused_train_eligible
from nerface_tpu_torch.train.loop import build_models_from_cfg, train
from nerface_tpu_torch.train.schedule import from_cfg as schedule_from_cfg
from nerface_tpu_torch.train.state import build_optimizer, create_train_state, set_lr
from nerface_tpu_torch.train.step import compute_losses

torch.set_num_threads(1)

SC = SF = 16


def pin_numpy_feeds(monkeypatch):
    """Both packages' host feeds on their numpy paths: the JAX package's
    `RayFeed` takes it when its native library is not `available()`, the
    port's with `native=False` (`train()` builds `loop.RayFeed`)."""
    monkeypatch.setattr(nerface_tpu.native, "available", lambda: False)
    monkeypatch.setattr(loop_mod, "RayFeed", functools.partial(RayFeed, native=False))


def jax_native():
    """The JAX package's native module with its library loaded. Its loader
    builds beside the source without a lock and remembers a failed load
    (ROADMAP Queue 3), so a load that failed while another test worker was
    still writing the library is tried again."""
    import time

    for _ in range(10):
        if nerface_tpu.native.available():
            return nerface_tpu.native
        nerface_tpu.native._tried = False
        time.sleep(1.0)
    raise AssertionError("the JAX package's native library does not load")


def _opt_cfg(lr_decay=250):
    return {"optimizer": {"type": "Adam", "lr": 5e-4},
            "scheduler": {"lr_decay": lr_decay, "lr_decay_factor": 0.1}}


def _jax_model():
    return MODELS["ConditionalBlendshapePaperNeRFModel"](
        num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False
    )


def _port_model():
    return ConditionalBlendshapePaperNeRFModel(
        num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False,
        generator=torch.Generator().manual_seed(0),
    )


@functools.lru_cache(maxsize=None)
def _jax_init():
    jm = _jax_model()
    return jm, jm.init(jax.random.PRNGKey(0))


def _pair(flags_kw, bg=None, lr_decay=250):
    """A JAX TrainState and the port's state + optimizer on its weights
    (via `train_state_from_jax`), with a random latent table."""
    jm, jp = _jax_init()
    jflags = JaxFlags(**flags_kw)
    # create_train_state's layout, on one shared init (both models alike)
    params = {"coarse": dict(jp), "fine": dict(jp), "latent_codes": None, "background": None}
    if jflags.train_latent_codes and not jflags.disable_latent_codes:
        rng = np.random.RandomState(0)
        params["latent_codes"] = jnp.asarray(rng.randn(4, 32).astype(np.float32) * 0.1)
    fixed = None
    if bg is not None:
        if jflags.train_background:
            params["background"] = jnp.asarray(bg)
        elif jflags.fixed_background:
            fixed = jnp.asarray(bg)
    jopt = jax_build_optimizer(JaxCfgNode(_opt_cfg(lr_decay)))
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           opt_state=jopt.init(params), fixed_background=fixed)
    flags = FeatureFlags(**flags_kw)
    state = create_train_state(_port_model(), _port_model(), flags, n_train=4, background=bg)
    opt = build_optimizer(CfgNode(_opt_cfg(lr_decay)), state)
    ckpt.train_state_from_jax(jax.device_get(jstate), state, opt)
    return jm, jstate, jopt, jflags, state, opt, flags


def _settings(noise=0.1, white=False, perturb=True):
    kw = dict(num_coarse=SC, num_fine=SF, perturb=perturb, radiance_field_noise_std=noise,
              white_background=white, near=0.2, far=0.8)
    return (
        RenderSettings(**kw, encode_xyz=EncodeSpec(10, True, True),
                       encode_dir=EncodeSpec(4, False, True)),
        JaxRenderSettings(**kw, encode_xyz=JaxEncodeSpec(10, True, True),
                          encode_dir=JaxEncodeSpec(4, False, True), fused="off"),
    )


def _batch(R, seed, with_pixels=False, with_bg=True):
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
    if with_pixels:
        b["pixel_indices"] = rng.randint(0, 64, size=(R,)).astype(np.int32)
    if not with_bg or with_pixels:
        del b["background_rgb"]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    return jb, batch_to_device(b, "cpu")


def _jax_draws(key, R):
    """The JAX pipeline's draws for `key` (its 4-way split), as tensors."""
    idx = jnp.arange(R, dtype=jnp.int32)
    k_strat, k_noise_c, k_pdf, k_noise_f = jax.random.split(key, 4)
    d = {
        "t_rand": jsamp.per_ray_uniform(k_strat, idx, SC),
        "noise_c": jsamp.per_ray_normal(k_noise_c, idx, SC),
        "u": jsamp.per_ray_uniform(k_pdf, idx, SF),
        "noise_f": jsamp.per_ray_normal(k_noise_f, idx, SC + SF),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _port_grads(state):
    g = {}
    for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
        for name, p in m.named_parameters():
            g[f"['{which}']['{name}']"] = p.grad
    if state.latent_codes is not None:
        g["['latent_codes']"] = state.latent_codes.grad
    if state.train_background:
        g["['background']"] = state.background.grad
    return g


def _compare_grads(state, jgrads, rel, floor, sigma_head_rel=None):
    port = _port_grads(state)
    seen = 0
    for path, v in jax.tree_util.tree_leaves_with_path(jgrads):
        name = jax.tree_util.keystr(path)
        v = np.asarray(v)
        got = port[name]
        scale = float(np.abs(v).max())
        if got is None:  # never reached the loss (layers_dir.3)
            assert scale == 0.0, name
            continue
        r = sigma_head_rel if sigma_head_rel and "fc_alpha" in name else rel
        np.testing.assert_allclose(got.numpy(), v, atol=r * scale + floor, rtol=0, err_msg=name)
        seen += 1
    assert seen >= 30


FLAG_CASES = {
    "fixed_bg": ({}, None, True, 0.1, False, True),
    "train_sup_bg": (dict(train_background=True, supervised_train_background=True,
                          fixed_background=False), "bg", False, 0.1, False, True),
    "white_no_prior": (dict(fixed_background=False), None, False, 0.1, True, True),
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_f32_step_matches_jax_value_and_grad(case):
    flags_kw, bg_kind, with_bg, noise, white, perturb = FLAG_CASES[case]
    R = 32
    bg = np.random.RandomState(3).rand(8, 8, 3).astype(np.float32) if bg_kind else None
    jm, jstate, _, jflags, state, _, flags = _pair(flags_kw, bg)
    tset, jset = _settings(noise, white, perturb)
    jb, tb = _batch(R, seed=7, with_pixels=bg_kind is not None, with_bg=with_bg)
    key = jax.random.PRNGKey(1)

    def loss_fn(params):
        return _compute_losses(params, jb, key, jm, jm, jset, jflags, jstate.fixed_background)

    (jtot, jm_), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    total, metrics = compute_losses(state, tb, 0, tset, flags, draws=_jax_draws(key, R))
    total.backward()
    np.testing.assert_allclose(float(total), float(jtot), rtol=1e-5)
    for k in jm_:
        np.testing.assert_allclose(float(metrics[k]), float(jm_[k]), rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    _compare_grads(state, jg, 2e-4, 1e-10, sigma_head_rel=5e-3)


FUSED_CASES = {
    "noise": ({}, None, True, 0.1, False, True),
    "no_noise_det": ({}, None, True, 0.0, False, False),
    "white_no_prior": (dict(fixed_background=False), None, False, 0.1, True, True),
    "train_sup_bg": (dict(train_background=True, supervised_train_background=True,
                          fixed_background=False), "bg", False, 0.1, False, True),
    "disable_latent": (dict(disable_latent_codes=True), None, True, 0.1, False, True),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_path_matches_jax_f32_path(case):
    """K1's plain bf16 version (the wrapper on CPU tensors) through
    `fused_losses` against the JAX package's f32 XLA path, with its draws."""
    flags_kw, bg_kind, with_bg, noise, white, perturb = FUSED_CASES[case]
    R = 64
    bg = np.random.RandomState(3).rand(8, 8, 3).astype(np.float32) if bg_kind else None
    jm, jstate, _, jflags, state, _, flags = _pair(flags_kw, bg)
    tset, jset = _settings(noise, white, perturb)
    jb, tb = _batch(R, seed=11, with_pixels=bg_kind is not None, with_bg=with_bg)
    key = jax.random.PRNGKey(1)
    assert fused_train_eligible(state.model_coarse, state.model_fine, tset, flags,
                                torch.bfloat16, "cpu")

    def loss_fn(params):
        return _compute_losses(params, jb, key, jm, jm, jset, jflags, jstate.fixed_background)

    (jtot, jm_), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    total, metrics = fused_losses(state, tb, 0, tset, flags, draws=_jax_draws(key, R))
    total.backward()
    np.testing.assert_allclose(float(total), float(jtot), rtol=0.03)
    for k in jm_:
        np.testing.assert_allclose(float(metrics[k]), float(jm_[k]), rtol=0.03, atol=1e-6,
                                   err_msg=k)
    _compare_grads(state, jg, 0.25, 2e-6)


def test_adam_and_schedule_match_optax():
    """The same gradients, fed for 5 steps, move the port's parameters and
    Adam moments as optax.adam + exponential_lr does (lr_decay 0.002: the
    LR falls by 10× every 2 steps, so the post-step offset matters). The LR
    goes through the train step's path, `from_cfg` written by `set_lr`
    into the optimizer's LR tensor, and equals the JAX package's schedule
    bit for bit at every step."""
    _, jstate, jopt, _, state, opt, _ = _pair({}, None, lr_decay=0.002)
    sched = schedule_from_cfg(CfgNode(_opt_cfg(0.002)))
    jsched = jax_schedule_from_cfg(JaxCfgNode(_opt_cfg(0.002)))
    params = [p for p in state.ordered_params()]
    jparams = jstate.params
    jos = jstate.opt_state
    rng = np.random.RandomState(0)
    for step in range(5):
        grads = {"coarse": {}, "fine": {}}
        for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
            for name, p in m.named_parameters():
                g = (rng.randn(*p.shape) * 1e-3).astype(np.float32)
                grads[which][name] = jnp.asarray(g)
                p.grad = torch.from_numpy(g)
        g = (rng.randn(4, 32) * 1e-3).astype(np.float32)
        grads["latent_codes"] = jnp.asarray(g)
        grads["background"] = None
        state.latent_codes.grad = torch.from_numpy(g)
        updates, jos = jopt.update(grads, jos, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step()
        state.step += 1
        set_lr(opt, sched(torch.tensor(state.step)))
        for group in opt.param_groups:
            assert group["lr"].item() == np.float32(jsched(state.step)), state.step
    for which, m in (("coarse", state.model_coarse), ("fine", state.model_fine)):
        for name, p in m.named_parameters():
            want = np.asarray(jparams[which][name])
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=1e-3 * 5e-4,
                                       err_msg=name)
    adam = ckpt._find_adam_state(jax.device_get(jos))
    for got, want in ((opt.state[params[0]]["exp_avg"], adam.mu["coarse"]["layers_xyz.0.weight"]),
                      (opt.state[state.latent_codes]["exp_avg_sq"], adam.nu["latent_codes"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert float(opt.state[params[0]]["step"]) == int(adam.count) == 5


def _ray_feeds_equal(jfeed, native):
    ds, bg = jfeed.dataset, jfeed._background_flat
    bg = None if bg is None else bg.reshape(ds.H, ds.W, -1)
    feed = RayFeed(ds, num_rays=50, background=bg, seed=5, native=native)
    jb = [jfeed.sample_batch() for _ in range(4)]
    tb = [next(feed) for _ in range(4)]
    for a, b in zip(jb, tb):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
    # a resumed feed continues the stream; the prefetch thread gives the same
    resumed = RayFeed(ds, num_rays=50, background=bg, seed=5, start_batch=3,
                      native=native).start()
    try:
        b3 = next(resumed)
    finally:
        resumed.stop()
    for k in jb[3]:
        np.testing.assert_array_equal(np.asarray(b3[k]), np.asarray(jb[3][k]), err_msg=k)


def test_ray_feed_matches_jax_numpy_path(monkeypatch):
    pin_numpy_feeds(monkeypatch)
    ds = synthetic_flame_dataset(H=24, W=20, n_train=4, n_val=1, n_test=1, with_images=True)
    jfeed = JaxRayFeed(ds, num_rays=50, background=ds.load_background(), seed=5)
    assert jfeed._native is None
    _ray_feeds_equal(jfeed, native=False)


def test_ray_feed_matches_jax_native_path():
    jax_native()
    ds = synthetic_flame_dataset(H=24, W=20, n_train=4, n_val=1, n_test=1, with_images=True)
    jfeed = JaxRayFeed(ds, num_rays=50, background=ds.load_background(), seed=5)
    assert jfeed._native is not None
    _ray_feeds_equal(jfeed, native=True)


def test_safe_norm_gradient_at_zero():
    x = torch.zeros(32, requires_grad=True)
    safe_norm(x).backward()
    assert torch.equal(x.grad, torch.zeros(32))
    v = np.random.RandomState(0).randn(32).astype(np.float32)
    y = torch.from_numpy(v).requires_grad_(True)
    n = safe_norm(y)
    n.backward()
    np.testing.assert_allclose(float(n), float(jax_safe_norm(jnp.asarray(v))), rtol=1e-6)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jax.grad(jax_safe_norm)(jnp.asarray(v))),
                               rtol=1e-6)


def test_per_ray_normal():
    idx = torch.arange(4096)
    n = per_ray_normal(3, 1, idx, 64)
    assert n.shape == (4096, 64) and n.dtype == torch.float32 and torch.isfinite(n).all()
    assert abs(float(n.mean())) < 0.01 and abs(float(n.std()) - 1.0) < 0.01
    # a ray's draws depend only on (seed, stream, its index)
    assert torch.equal(per_ray_normal(3, 1, idx[100:200], 64), n[100:200])
    assert not torch.equal(per_ray_normal(3, 3, idx[:8], 64), n[:8])
    assert not torch.equal(per_ray_normal(4, 1, idx[:8], 64), n[:8])


def test_checkpoint_interop_both_ways(tmp_path):
    """A port checkpoint (after one Adam step) loads in the JAX package's
    `load_torch_checkpoint` + `import_torch_weights` (with
    `import_torch_optimizer_state`); a JAX `export_torch_checkpoint` resumes
    the port: params, moments and count equal."""
    flags_kw = dict(train_background=True, fixed_background=False)
    bg = np.random.RandomState(1).rand(8, 8, 3).astype(np.float32)
    jm, jstate, jopt, jflags, state, opt, flags = _pair(flags_kw, bg)
    tset, _ = _settings(0.1)
    _, tb = _batch(16, seed=2, with_pixels=True, with_bg=False)
    total, _ = compute_losses(state, tb, 0, tset, flags)
    total.backward()
    opt.step()
    state.step += 1
    path = str(tmp_path / "port.ckpt")
    ckpt.save_torch_checkpoint(path, state, opt, loss=1.0, psnr=2.0)
    loaded = jax_ckpt.import_torch_weights(jstate, jax_ckpt.load_torch_checkpoint(path))
    assert int(loaded.step) == 1
    for name, p in state.model_fine.named_parameters():
        np.testing.assert_array_equal(np.asarray(loaded.params["fine"][name]), p.detach().numpy())
    np.testing.assert_array_equal(np.asarray(loaded.params["background"]),
                                  state.background.detach().numpy())
    adam = jax_ckpt._find_adam_state(loaded.opt_state)
    assert int(adam.count) == 1
    p0 = next(state.model_coarse.parameters())
    np.testing.assert_array_equal(np.asarray(adam.mu["coarse"]["layers_xyz.0.weight"]),
                                  opt.state[p0]["exp_avg"].numpy())
    np.testing.assert_array_equal(np.asarray(adam.nu["background"]),
                                  opt.state[state.background]["exp_avg_sq"].numpy())
    assert len(torch.load(path, weights_only=True)["optimizer_state_dict"]["param_groups"]) == 2

    # JAX -> port: moments from one optax update on random gradients
    rng = np.random.RandomState(4)
    grads = jax.tree.map(lambda v: jnp.asarray(rng.randn(*v.shape).astype(np.float32)),
                         jstate.params)
    _, jos = jopt.update(grads, jstate.opt_state, jstate.params)
    jstate.opt_state = jos
    jpath = str(tmp_path / "jax.ckpt")
    jax_ckpt.export_torch_checkpoint(jpath, jstate, lr=5e-4)
    state2 = create_train_state(_port_model(), _port_model(), flags, n_train=4, background=bg)
    opt2 = build_optimizer(CfgNode(_opt_cfg()), state2)
    ckpt.restore_train_state(state2, opt2, ckpt.load_torch_checkpoint(jpath))
    jadam = jax_ckpt._find_adam_state(jos)
    for name, p in state2.model_coarse.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jstate.params["coarse"][name]))
        np.testing.assert_array_equal(opt2.state[p]["exp_avg"].numpy(),
                                      np.asarray(jadam.mu["coarse"][name]))
    np.testing.assert_array_equal(state2.latent_codes.detach().numpy(),
                                  np.asarray(jstate.params["latent_codes"]))
    np.testing.assert_array_equal(opt2.state[state2.background]["exp_avg_sq"].numpy(),
                                  np.asarray(jadam.nu["background"]))
    assert int(opt2.state[state2.latent_codes]["step"]) == 1
    assert opt2.param_groups[1]["params"][0] is state2.background


def _train_cfg(basedir, logdir):
    model = {
        "type": "ConditionalBlendshapePaperNeRFModel", "num_encoding_fn_xyz": 10,
        "num_encoding_fn_dir": 4, "include_input_xyz": True, "include_input_dir": False,
        "use_viewdirs": True, "num_layers": 4, "hidden_size": 256, "skip_connect_every": 3,
        "log_sampling_xyz": True, "log_sampling_dir": True,
    }
    node = {"chunksize": 256, "perturb": False, "num_coarse": SC, "num_fine": SF,
            "white_background": False, "radiance_field_noise_std": 0.0, "lindisp": False}
    return {
        "experiment": {"id": "slice", "logdir": logdir, "randomseed": 42, "train_iters": 3,
                       "validate_every": 0, "save_every": 0, "print_every": 1,
                       "steps_per_execute": "auto"},
        "dataset": {"type": "blender", "basedir": basedir, "half_res": False, "testskip": 1,
                    "no_ndc": True, "near": 0.2, "far": 0.8},
        "models": {"coarse": dict(model), "fine": dict(model)},
        **_opt_cfg(),
        "nerf": {"use_viewdirs": True, "encode_position_fn": "positional_encoding",
                 "encode_direction_fn": "positional_encoding",
                 "train": dict(node, num_random_rays=64), "validation": dict(node)},
    }


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    return make_synthetic_flame_dataset(
        str(tmp_path_factory.mktemp("train_ds") / "ds"), H=16, W=16, n_train=4, n_val=2,
        n_test=1, num_samples=8,
    )


def _whole_slice(dataset_dir, tmp_path, capsys):
    """`train()` of both packages, f32 on the CPU, 3 steps from the same
    reference-schema checkpoint on the same 16×16 dataset (perturb off,
    σ-noise 0: no random draws) and the same feed seed."""
    d = _train_cfg(dataset_dir, str(tmp_path / "runs"))
    cfg = CfgNode(d)
    mc, mf = build_models_from_cfg(cfg, generator=torch.Generator().manual_seed(3))
    start = str(tmp_path / "start.ckpt")
    torch.save({"iter": 0, "model_coarse_state_dict": mc.state_dict(),
                "model_fine_state_dict": mf.state_dict(), "optimizer_state_dict": None,
                "loss": 0.0, "psnr": 0.0, "background": None,
                "latent_codes": torch.zeros(4, 32)}, start)

    jstate = jax_train(JaxCfgNode(copy.deepcopy(d)), load_checkpoint=start,
                       dataset=jax_load_flame_data(dataset_dir), log=False)
    jax_out = capsys.readouterr().out
    jax_losses = [float(v) for v in re.findall(r"\[TRAIN\] Iter: \d+ Loss: ([0-9.]+)", jax_out)]
    state = train(cfg, load_checkpoint=start, dataset=load_flame_data(dataset_dir), device="cpu")
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


def test_whole_slice_matches_jax_train(dataset_dir, tmp_path, capsys, monkeypatch):
    """Both packages' host feeds on their numpy paths."""
    pin_numpy_feeds(monkeypatch)
    _whole_slice(dataset_dir, tmp_path, capsys)


def test_whole_slice_matches_jax_train_native(dataset_dir, tmp_path, capsys):
    """Both packages' host feeds on their native paths, each's default."""
    jax_native()
    _whole_slice(dataset_dir, tmp_path, capsys)


def test_cli_trains_on_the_cpu(dataset_dir, tmp_path, capsys):
    import yaml

    d = _train_cfg(dataset_dir, str(tmp_path / "runs"))
    d["experiment"]["save_every"] = 1
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(d))
    cli_train.main(["--config", str(path), "--device", "cpu", "--max-iters", "2"])
    out = capsys.readouterr().out
    assert len(re.findall(r"\[TRAIN\] Iter: \d+ Loss", out)) == 2
    saved = ckpt.load_torch_checkpoint(str(tmp_path / "runs" / "slice" / "checkpoint00002.ckpt"))
    assert saved["iter"] == 2 and len(saved["optimizer"]["param_groups"]) == 2
    with pytest.raises(SystemExit, match="ROADMAP.*DDP"):
        cli_train.main(["--config", str(path), "--device", "cpu", "--num-devices", "2"])
    # the device feed and --steps-per-execute are ported: they train
    cli_train.main(["--config", str(path), "--device", "cpu", "--max-iters", "2",
                    "--device-feed", "--steps-per-execute", "4"])
    assert len(re.findall(r"\[TRAIN\] Iter: \d+ Loss", capsys.readouterr().out)) == 2
