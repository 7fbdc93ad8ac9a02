"""PyTorch port, the execution window (`nerface_tpu_torch/train/window.py`)
and the loop around it (`train/loop.py`), on the CPU.

On the CPU a window runs its steps one at a time through the card's step
body and bookkeeping (there is no graph), so every comparison here is bit
for bit:

* `_effective_window` equals the JAX package's on a grid;
* the draws from a 0-d step tensor equal their int forms, and the LR
  from one equals the JAX package's schedule;
* `train()` at K = 5 equals K = 1 — windows [0..0], [1..5], [6..6] as in
  `tests/test_megastep.py:157` — in its parameters, its optimizer state and
  its printed lines, for the host feed and the device feed;
* a resume from a mid-run checkpoint continues the stream
  (`test_megastep.py:298`);
* async validation prints what sync validation prints, and a failing
  render fails the run (`tests/test_async_val.py:46, :79`).

Held against the JAX package: each optimizer against its optax twin over
3 steps of the same gradients from the same parameters at optax's defaults
(parameters atol 1e-3·lr: a few ulps of a parameter, the same update
rounded in another order), and the blurred background against
`nerface_tpu/utils/smoothing.py::gaussian_smooth` to 1e-6.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.config.flags import FeatureFlags as JaxFlags
from nerface_tpu.train.loop import _effective_window as jax_effective_window
from nerface_tpu.train.loop import setup_background as jax_setup_background
from nerface_tpu.train.schedule import exponential_lr as jax_exponential_lr
from nerface_tpu.train.state import build_optimizer as jax_build_optimizer
from nerface_tpu_torch.config import CfgNode, FeatureFlags
from nerface_tpu_torch.data.synthetic import synthetic_flame_dataset
from nerface_tpu_torch.ops import sampling as S
from nerface_tpu_torch.train import checkpoint as ckpt
from nerface_tpu_torch.train import loop as loop_mod
from nerface_tpu_torch.train.loop import _effective_window, setup_background, train
from nerface_tpu_torch.train.schedule import exponential_lr
from nerface_tpu_torch.train.state import TrainState, build_optimizer, set_lr

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ds():
    return synthetic_flame_dataset(H=16, W=16, n_train=4, n_val=2, n_test=1, with_images=True,
                                   num_samples=8)


def _cfg(logdir, train_iters=7, **exp):
    model = {
        "type": "ConditionalBlendshapePaperNeRFModel", "num_encoding_fn_xyz": 4,
        "num_encoding_fn_dir": 2, "include_input_xyz": True, "include_input_dir": False,
        "use_viewdirs": True, "num_layers": 4, "hidden_size": 256, "skip_connect_every": 3,
        "log_sampling_xyz": True, "log_sampling_dir": True,
    }
    node = {"chunksize": 256, "perturb": True, "num_coarse": 8, "num_fine": 8,
            "white_background": False, "radiance_field_noise_std": 0.1, "lindisp": False}
    experiment = {"id": "win", "logdir": logdir, "randomseed": 42, "train_iters": train_iters,
                  "validate_every": 0, "save_every": 5, "print_every": 5}
    experiment.update(exp)
    return CfgNode({
        "experiment": experiment,
        "dataset": {"type": "blender", "basedir": "", "half_res": False, "testskip": 1,
                    "no_ndc": True, "near": 0.2, "far": 0.8},
        "models": {"coarse": dict(model), "fine": dict(model)},
        "optimizer": {"type": "Adam", "lr": 5e-4},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
        "nerf": {"use_viewdirs": True, "encode_position_fn": "positional_encoding",
                 "encode_direction_fn": "positional_encoding",
                 "train": dict(node, num_random_rays=64),
                 "validation": dict(node, radiance_field_noise_std=0.0)},
    })


def _train(cfg, ds, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = train(cfg, dataset=ds, device="cpu", **kw)
    return state, out.getvalue()


def _train_lines(text):
    """The [TRAIN] lines without their rays/s (a wall-clock reading)."""
    return re.findall(r"(\[TRAIN\] Iter: \d+ Loss: .* LatentReg: \S+)", text)


def _val_lines(text):
    return re.findall(r"\[VAL\] Iter: (\d+) loss: (\S+) PSNR: (\S+)", text)


def _assert_same_state(a, b):
    assert a.step == b.step
    for ma, mb in ((a.model_coarse, b.model_coarse), (a.model_fine, b.model_fine)):
        for (name, pa), pb in zip(ma.named_parameters(), mb.parameters()):
            assert torch.equal(pa, pb), name
    assert torch.equal(a.latent_codes, b.latent_codes)


def _assert_same_optimizer(path_a, path_b):
    oa = ckpt.load_torch_checkpoint(path_a)["optimizer"]
    ob = ckpt.load_torch_checkpoint(path_b)["optimizer"]
    assert oa["state"].keys() == ob["state"].keys() and len(oa["state"]) > 0
    for key in oa["state"]:
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa["state"][key][f], ob["state"][key][f]), (key, f)
    assert oa["param_groups"] == ob["param_groups"]


@pytest.mark.parametrize("requested", [1, 4, 7, 50, 64])
def test_effective_window_matches_jax(requested):
    grid = [[100, 1000, 5000], [100, 0, 0], [0, 0, 0], [7], [10, 20, 20], [6, 4, 0], [1]]
    for cadences in grid:
        for multiprocess in (False, True):
            assert (_effective_window(requested, cadences, multiprocess)
                    == jax_effective_window(requested, cadences, multiprocess)), cadences


@pytest.mark.parametrize("seed,step", [(0, 0), (42, 7), (2**32 - 1, 10**6), (12345, 2**31 + 5)])
def test_tensor_seed_draws_equal_int_draws(seed, step):
    st, tt = torch.tensor(seed, dtype=torch.int64), torch.tensor(step, dtype=torch.int64)
    s_int = S.step_seed(seed, step)
    s_t = S.step_seed(st, tt)
    assert s_t.dtype == torch.int64 and s_t.dim() == 0 and int(s_t) == s_int
    assert int(S.step_seed(seed, tt)) == int(S.step_seed(st, step)) == s_int
    idx = torch.arange(37) * 101
    for stream in range(6):
        assert torch.equal(S.per_ray_bits(s_int, stream, idx, 5), S.per_ray_bits(s_t, stream, idx, 5))
        assert torch.equal(S.per_ray_uniform(s_int, stream, idx, 9),
                           S.per_ray_uniform(s_t, stream, idx, 9))
        assert torch.equal(S.per_ray_normal(s_int, stream, idx, 4),
                           S.per_ray_normal(s_t, stream, idx, 4))
    near, far = torch.full((37, 1), 0.2), torch.full((37, 1), 0.8)
    z = S.stratified_zvals(near, far, 8, seed=s_int, ray_index=idx)
    assert torch.equal(z, S.stratified_zvals(near, far, 8, seed=s_t, ray_index=idx))
    w = torch.rand(37, 6, generator=torch.Generator().manual_seed(0))
    bins = torch.linspace(0.2, 0.8, 7).expand(37, 7)
    assert torch.equal(S.sample_pdf(bins, w, 5, seed=s_int, ray_index=idx),
                       S.sample_pdf(bins, w, 5, seed=s_t, ray_index=idx))


def test_lr_tensor_form_equals_the_schedule():
    """The port's schedule, read from a step tensor, equals the JAX
    package's f32 schedule bit for bit."""
    for decay in (250, 0.002):
        jax_sched, sched = jax_exponential_lr(5e-4, decay, 0.1), exponential_lr(5e-4, decay, 0.1)
        for k in list(range(8)) + [999, 10**5, 10**6]:
            assert sched(torch.tensor(k)).item() == np.float32(jax_sched(k)), (decay, k)


@pytest.mark.parametrize("device_feed", [False, True], ids=["host_feed", "device_feed"])
def test_window_equals_step_at_a_time(ds, tmp_path, device_feed):
    runs = {}
    for k in (1, 5):
        runs[k] = _train(_cfg(str(tmp_path / f"k{k}"), validate_every=5), ds,
                         steps_per_execute=k, device_feed=device_feed)
    (s1, out1), (s5, out5) = runs[1], runs[5]
    assert "[train] execution window: 5 steps" in out5
    _assert_same_state(s1, s5)
    assert s5.step == 7
    lines = _train_lines(out5)
    assert lines == _train_lines(out1)
    assert [int(re.search(r"Iter: (\d+)", x).group(1)) for x in lines] == [0, 5, 6]
    # K = 5 validates asynchronously by default, K = 1 synchronously
    assert _val_lines(out5) == _val_lines(out1) and len(_val_lines(out1)) == 2
    for name in ("checkpoint00001.ckpt", "checkpoint00006.ckpt", "checkpoint00007.ckpt"):
        _assert_same_optimizer(str(tmp_path / "k1" / "win" / name),
                               str(tmp_path / "k5" / "win" / name))


@pytest.mark.parametrize("device_feed", [False, True], ids=["host_feed", "device_feed"])
def test_resume_mid_window_continues_stream(ds, tmp_path, device_feed):
    full, _ = _train(_cfg(str(tmp_path / "full"), train_iters=10, save_every=0), ds,
                     steps_per_execute=5, device_feed=device_feed)
    _train(_cfg(str(tmp_path / "ab"), train_iters=5), ds, steps_per_execute=5,
           device_feed=device_feed)
    ck = str(tmp_path / "ab" / "win" / "checkpoint00005.ckpt")
    assert ckpt.load_torch_checkpoint(ck)["iter"] == 5
    resumed, _ = _train(_cfg(str(tmp_path / "ab"), train_iters=10, save_every=0), ds,
                        steps_per_execute=5, device_feed=device_feed, load_checkpoint=ck)
    _assert_same_state(full, resumed)


def test_async_validation_matches_sync(ds, tmp_path):
    s_sync, out_sync = _train(_cfg(str(tmp_path / "sync"), train_iters=12, validate_every=4,
                                   save_every=0, print_every=4, async_val=False), ds,
                              steps_per_execute=4)
    s_async, out_async = _train(_cfg(str(tmp_path / "async"), train_iters=12, validate_every=4,
                                     save_every=0, print_every=4, async_val=True), ds,
                                steps_per_execute=4)
    v_sync, v_async = _val_lines(out_sync), _val_lines(out_async)
    assert [v[0] for v in v_sync] == ["0", "4", "8"]
    assert v_sync == v_async
    _assert_same_state(s_sync, s_async)


def test_async_validation_render_failure_surfaces(ds, tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("validation render exploded")

    monkeypatch.setattr(loop_mod, "validate", boom)
    with pytest.raises(RuntimeError, match="validation render exploded"):
        _train(_cfg(str(tmp_path / "boom"), train_iters=8, validate_every=4, save_every=0,
                    print_every=4, async_val=True), ds, steps_per_execute=4)


def test_checkpoint_keeps_a_float_lr_and_resume_the_lr_tensor(ds, tmp_path):
    state, _ = _train(_cfg(str(tmp_path / "a"), train_iters=5), ds, steps_per_execute=5)
    path = str(tmp_path / "a" / "win" / "checkpoint00005.ckpt")
    groups = torch.load(path, weights_only=True)["optimizer_state_dict"]["param_groups"]
    assert len(groups) == 2 and all(isinstance(g["lr"], float) for g in groups)
    opt = build_optimizer(_cfg(""), state)
    lr = opt.param_groups[0]["lr"]
    ckpt.restore_train_state(state, opt, ckpt.load_torch_checkpoint(path))
    assert all(g["lr"] is lr for g in opt.param_groups)
    assert state.step == 5


OPT_CASES = ["adam", "flat_adam", "adamw", "sgd", "rmsprop"]


@pytest.mark.parametrize("kind", OPT_CASES)
def test_optimizer_matches_optax(kind):
    """3 steps of the same gradients from the same parameters, with the
    reference's LR schedule (lr_decay 0.002: the LR falls 10× every 2
    steps, so the post-step LR write matters)."""
    d = {"optimizer": {"type": kind, "lr": 5e-4},
         "scheduler": {"lr_decay": 0.002, "lr_decay_factor": 0.1}}
    rng = np.random.RandomState(3)
    shapes = [(6, 5), (5,), (4, 32)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    coarse = torch.nn.Linear(6, 5)
    with torch.no_grad():
        coarse.weight.copy_(torch.from_numpy(init[0].T.copy()))
        coarse.bias.copy_(torch.from_numpy(init[1]))
    state = TrainState(coarse, None, torch.nn.Parameter(torch.from_numpy(init[2].copy())), None,
                       False, 0)
    opt = build_optimizer(CfgNode(d), state)
    sched = exponential_lr(5e-4, 0.002, 0.1)
    jopt = jax_build_optimizer(JaxCfgNode(d))
    jparams = {"w": jnp.asarray(init[0].T.copy()), "b": jnp.asarray(init[1]),
               "latent": jnp.asarray(init[2])}
    jstate = jopt.init(jparams)
    params = {"w": coarse.weight, "b": coarse.bias, "latent": state.latent_codes}
    for step in range(3):
        grads = {k: (rng.randn(*v.shape) * 1e-2).astype(np.float32) for k, v in jparams.items()}
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        set_lr(opt, sched(torch.tensor(step + 1)))
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0,
                                   atol=1e-3 * 5e-4, err_msg=f"{kind} {k}")
        assert not np.array_equal(p.detach().numpy(), init[["w", "b", "latent"].index(k)]
                                  if k != "w" else init[0].T)


def test_blur_background_matches_jax(ds):
    flags = dict(train_background=True, blur_background=True)
    got = setup_background(ds, FeatureFlags(**flags))
    want = jax_setup_background(ds, JaxFlags(**flags))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    plain = setup_background(ds, FeatureFlags(train_background=True))
    assert np.abs(plain - got).max() > 1e-3  # the blur did something


def test_cumprod_gradient_without_the_zero_test_equals_torch():
    """The compositing's transmittance takes torch's cumprod gradient for
    inputs with no zero without torch's test for zeros (a read back to the
    host, refused inside a captured graph): the same values and gradients
    bit for bit, and a one-sample axis passes the gradient through."""
    from nerface_tpu_torch.ops.math import cumprod_exclusive

    gen = torch.Generator().manual_seed(0)
    for shape in ((64, 33), (5, 7, 16), (9, 1)):
        x = (torch.rand(shape, generator=gen) * 0.9 + 1e-10).requires_grad_()
        g = torch.randn(shape, generator=gen)
        c = torch.cumprod(x, dim=-1)
        a = torch.cat([torch.ones_like(c[..., :1]), c[..., :-1]], dim=-1)
        b = cumprod_exclusive(x)
        (ga,) = torch.autograd.grad(a, x, g)
        (gb,) = torch.autograd.grad(b, x, g)
        assert torch.equal(a, b) and torch.equal(ga, gb), shape
