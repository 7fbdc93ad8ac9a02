"""PyTorch port, serving the Flexible family: `nerface_tpu_torch.serve.AvatarServer`
on a `ConditionalBlendshapeLearnableCodeNeRFModel` checkpoint written by the
JAX package (`create_train_state` + `export_torch_checkpoint`, a random
latent table), against the JAX package's `AvatarServer`, both in f32 on the
CPU over a 16×16 synthetic dataset (validation `perturb: False`: no random
draws). Also: the bf16 server runs each pass of each tile as one K4 call,
the server's default device is the card, and chip_smoke's synth512_lcode
configuration is synth512_paper with the Flexible model.
"""

import copy
import importlib.util
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.config.flags import FeatureFlags as JaxFeatureFlags
from nerface_tpu.data.synthetic import make_synthetic_flame_dataset
from nerface_tpu.serve import AvatarServer as JaxAvatarServer
from nerface_tpu.train.checkpoint import export_torch_checkpoint
from nerface_tpu.train.loop import build_models_from_cfg
from nerface_tpu.train.state import create_train_state
from nerface_tpu_torch.config import CfgNode, load_config
from nerface_tpu_torch.models.nerf_models import ConditionalBlendshapeLearnableCodeNeRFModel
from nerface_tpu_torch.render import pipeline
from nerface_tpu_torch.serve import AvatarServer

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
H = W = 16
NAME = "ConditionalBlendshapeLearnableCodeNeRFModel"


def _cfg_dict(basedir, n_samples=16):
    model = {
        "type": NAME, "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4,
        "include_input_xyz": True, "include_input_dir": False, "use_viewdirs": True,
        "num_layers": 4, "hidden_size": 256, "log_sampling_xyz": True, "log_sampling_dir": True,
    }
    return {
        "experiment": {"id": "t", "logdir": "/nonexistent", "randomseed": 42},
        "dataset": {"basedir": basedir, "type": "blender", "no_ndc": True,
                    "near": 0.2, "far": 0.8, "half_res": False, "testskip": 1},
        "models": {"coarse": dict(model), "fine": dict(model)},
        "optimizer": {"type": "Adam", "lr": 5e-4},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
        "nerf": {
            "use_viewdirs": True,
            "validation": {"chunksize": 128, "perturb": False, "num_coarse": n_samples,
                           "num_fine": n_samples, "white_background": False,
                           "radiance_field_noise_std": 0.0, "lindisp": False},
        },
    }


@pytest.fixture(scope="module")
def avatar(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flex_serve")
    ds_dir = make_synthetic_flame_dataset(
        str(tmp / "ds"), H=H, W=W, n_train=3, n_val=1, n_test=2, num_samples=8
    )
    jcfg = JaxCfgNode(_cfg_dict(ds_dir))
    mc, mf = build_models_from_cfg(jcfg)
    state, _ = create_train_state(
        jax.random.PRNGKey(1), mc, mf, jcfg, JaxFeatureFlags(), n_train=3,
        background=jnp.zeros((H, W, 3)),
    )
    rng = np.random.RandomState(0)
    state.params["latent_codes"] = jnp.asarray(rng.randn(3, 32).astype(np.float32) * 0.3)
    ckpt = str(tmp / "lcode.ckpt")
    export_torch_checkpoint(ckpt, state)
    jax_server = JaxAvatarServer(jcfg, checkpoint=ckpt, log=False)
    port_server = AvatarServer(CfgNode(_cfg_dict(ds_dir)), checkpoint=ckpt, device="cpu",
                               log=False)
    return ds_dir, ckpt, jax_server, port_server


@pytest.mark.parametrize("frame", [0, 1])
def test_served_frame_matches_jax_server(avatar, frame):
    """uint8 maps within 1 level of the JAX server's, ≥ 99 % of rgb equal
    (f32 on both sides: only the order of f32 sums differs)."""
    _, _, jax_server, port_server = avatar
    assert isinstance(port_server.model_fine, ConditionalBlendshapeLearnableCodeNeRFModel)
    maps = ("rgb_fine", "rgb_coarse", "disp", "acc")
    ref = jax_server.render(frame=frame, maps=maps)
    got = port_server.render(frame=frame, maps=maps)
    for name in maps:
        assert got[name].shape == ref[name].shape and got[name].dtype == np.uint8, name
        diff = np.abs(got[name].astype(np.int16) - ref[name].astype(np.int16))
        assert diff.max() <= 1, name
        if name.startswith("rgb"):
            assert (diff == 0).mean() >= 0.99, name


def test_bf16_server_goes_through_k4(avatar, monkeypatch):
    """dtype=bf16: each pass of each tile is one fused_flex_mlp call (its
    plain version on the CPU), and the frame stays within a few levels of
    the f32 frame (bf16 matmul operands)."""
    ds_dir, ckpt, _, _ = avatar
    calls = []
    real = pipeline.fused_flex_mlp
    monkeypatch.setattr(pipeline, "fused_flex_mlp",
                        lambda *a, **k: calls.append(a[3].shape[-1]) or real(*a, **k))
    cfg = CfgNode(_cfg_dict(ds_dir, n_samples=32))
    srv = AvatarServer(cfg, checkpoint=ckpt, device="cpu", dtype=torch.bfloat16, log=False)
    got = srv.render(frame=0)["rgb_fine"]
    assert calls == [32, 64] * (H * W // 128)  # coarse S=32, fine S=64, per tile
    ref = AvatarServer(cfg, checkpoint=ckpt, device="cpu", log=False).render(frame=0)["rgb_fine"]
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.mean() <= 1.0 and np.percentile(diff, 99) <= 4


def test_server_defaults_to_the_card():
    assert inspect.signature(AvatarServer).parameters["device"].default == "cuda"


def test_chip_smoke_config_is_synth512_paper_with_the_flexible_model():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    lcode = copy.deepcopy(chip_smoke.SYNTH512_LCODE)
    for node in lcode["models"].values():
        assert node.pop("type") == NAME
    paper = CfgNode(copy.deepcopy(chip_smoke.SYNTH512_PAPER))
    for node in paper.models.values():
        node.pop("type")
    assert CfgNode(lcode) == paper
    assert CfgNode(copy.deepcopy(chip_smoke.SYNTH512_PAPER)) == load_config(
        str(REPO / "configs" / "synth512_paper.yml"))
