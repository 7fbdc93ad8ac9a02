"""PyTorch port, the Flexible model family: each of the 8 `_FlexibleFamily`
classes as an nn.Module against the JAX package's `MODELS[...].apply`, on
JAX-initialised params carried over by `params_from_jax` and loaded with
`load_state_dict(strict=True)`.

Widths: the reference's hidden 256 with 10 xyz / 4 direction bands
(num_layers 4: no skip layer engages), and a narrow case with num_layers 6,
skip_connect_every 3 that engages the skip at layer 3 (its concat order
(x, xyz, cond) and the init/forward width quirk of the LearnableCode
models). Tolerance: f32 on both sides, atol 1e-5·max|JAX| — the two
frameworks sum each dot product in a different order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.config import CfgNode as JaxCfgNode
from nerface_tpu.models import MODELS as JAX_MODELS
from nerface_tpu.ops.encoding import positional_encoding
from nerface_tpu_torch.config import CfgNode
from nerface_tpu_torch.models.nerf_models import MODELS, _FlexibleFamily, build_model
from nerface_tpu_torch.train.checkpoint import params_from_jax

torch.set_num_threads(1)

FLEX = [
    "FlexibleNeRFModel",
    "ConditionalNeRFModel",
    "ConditionalBlendshapeNeRFModel",
    "ConditionalBlendshapeLearnableCodeNeRFModel",
    "ConditionalCompressedBlendshapeLearnableCodeNeRFModel",
    "ConditionalCompressedBlendshapeNeRFModel",
    "ConditionalBlendshapeNeRFModel_v2",
    "ConditionalAutoEncoderNeRFModel",
]
SHAPES = {
    "ref": dict(num_layers=4, hidden_size=256, skip_connect_every=4, num_encoding_fn_xyz=10,
                num_encoding_fn_dir=4, include_input_dir=False),
    "skip": dict(num_layers=6, hidden_size=64, skip_connect_every=3, num_encoding_fn_xyz=6,
                 num_encoding_fn_dir=4, include_input_dir=True),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(name, shape, seed=0):
    kw = SHAPES[shape]
    jm = JAX_MODELS[name](**kw)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = MODELS[name](**kw)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}), strict=True)
    return jm, jp, tm


def _inputs(name, shape, R=5, S=7):
    kw = SHAPES[shape]
    rng = np.random.RandomState(1)
    pts = rng.uniform(-0.3, 0.3, (R, S, 3)).astype(np.float32)
    dirs = rng.randn(R, 3).astype(np.float32)
    e_dim = 15 if name.endswith("_v2") else 76
    expr = (rng.randn(e_dim) * 0.5).astype(np.float32)
    latent = (rng.randn(32) * 0.1).astype(np.float32)
    pe_xyz = np.asarray(positional_encoding(jnp.asarray(pts), kw["num_encoding_fn_xyz"], True, True))
    pe_dir = np.asarray(positional_encoding(jnp.asarray(dirs), kw["num_encoding_fn_dir"],
                                            kw["include_input_dir"], True))
    return pe_xyz, pe_dir, expr, latent


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", FLEX)
def test_forward_matches_jax_f32(name, shape):
    jm, jp, tm = _pair(name, shape)
    assert list(tm.state_dict()) == list(jp)  # the JAX init order: Adam's order
    pe_xyz, pe_dir, expr, latent = _inputs(name, shape)
    e = expr if jm.takes_expression else None
    l = latent if jm.takes_latent else None
    ref = np.asarray(jm.apply(jp, jnp.asarray(pe_xyz), jnp.asarray(pe_dir),
                              None if e is None else jnp.asarray(e),
                              None if l is None else jnp.asarray(l)))
    got = tm(_t(pe_xyz), _t(pe_dir), None if e is None else _t(e),
             None if l is None else _t(l)).detach().numpy()
    assert got.shape == ref.shape == pe_xyz.shape[:2] + (4,)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    # flat rows with per-row directions give the structured result
    R, S, D = pe_xyz.shape
    flat = tm(_t(pe_xyz.reshape(R * S, D)), _t(np.repeat(pe_dir, S, axis=0)),
              None if e is None else _t(e), None if l is None else _t(l))
    np.testing.assert_allclose(flat.detach().numpy().reshape(R, S, 4), got, atol=1e-5, rtol=0)


def test_skip_layer_engages_and_quirks_are_kept():
    """num_layers 6 / skip every 3: layers_xyz.3 reads [x; xyz; cond] and
    is sized [h; xyz; expr; latent] for LearnableCode; layer1 has no relu
    (a negative pre-activation reaches the next layer)."""
    _, jp, tm = _pair("ConditionalBlendshapeLearnableCodeNeRFModel", "skip")
    d_xyz = 3 + 6 * 6
    assert tuple(tm.layers_xyz[3].weight.shape) == (64, 64 + d_xyz + 76 + 32)
    assert tm._is_skip_forward(3, 5) and not tm._is_skip_forward(4, 5)
    pe_xyz, pe_dir, expr, latent = _inputs("ConditionalBlendshapeLearnableCodeNeRFModel", "skip")
    with torch.no_grad():
        x = torch.nn.functional.linear(_t(pe_xyz).reshape(-1, d_xyz),
                                       tm.layer1.weight[:, :d_xyz], tm.layer1.bias)
    assert float(x.min()) < 0.0


@pytest.mark.parametrize("name", FLEX)
def test_build_model_builds_every_class(name):
    node = {"type": name, "num_layers": 4, "hidden_size": 256, "skip_connect_every": 3,
            "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4, "include_input_xyz": True,
            "include_input_dir": False, "use_viewdirs": True, "log_sampling_xyz": True,
            "log_sampling_dir": True}
    from nerface_tpu.models.nerf_models import build_model as jax_build_model

    m = build_model(CfgNode(dict(node)), generator=torch.Generator().manual_seed(0))
    jm = jax_build_model(JaxCfgNode(dict(node)))
    assert isinstance(m, _FlexibleFamily) and m.skip_connect_every == 4  # not forwarded
    jp = jm.init(jax.random.PRNGKey(0))
    assert list(m.state_dict()) == list(jp)
    for k, v in jp.items():
        assert tuple(m.state_dict()[k].shape) == v.shape, k
    # nn.Linear's default init: U(-1/sqrt(in), 1/sqrt(in))
    w = m.layer1.weight
    assert float(w.detach().abs().max()) <= 1.0 / np.sqrt(w.shape[1])


def test_no_viewdirs_head_matches_jax():
    kw = dict(num_layers=3, hidden_size=32, num_encoding_fn_xyz=4, use_viewdirs=False)
    jm = JAX_MODELS["ConditionalBlendshapeNeRFModel"](**kw)
    jp = jm.init(jax.random.PRNGKey(5))
    tm = MODELS["ConditionalBlendshapeNeRFModel"](**kw)
    tm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}), strict=True)
    assert "fc_out.weight" in tm.state_dict() and not hasattr(tm, "fc_feat")
    rng = np.random.RandomState(2)
    pe = np.asarray(positional_encoding(jnp.asarray(rng.randn(4, 6, 3).astype(np.float32)),
                                        4, True, True))
    expr = (rng.randn(76) * 0.3).astype(np.float32)
    ref = np.asarray(jm.apply(jp, jnp.asarray(pe), None, jnp.asarray(expr)))
    got = tm(_t(pe), None, _t(expr)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
