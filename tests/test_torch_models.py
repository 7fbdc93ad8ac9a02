"""PyTorch port, models: `ConditionalBlendshapePaperNeRFModel` as an
nn.Module against the JAX package's `MODELS[...].apply` at full width
(256 trunk, 128 direction branch, 10 xyz / 4 direction bands), on
JAX-initialised params carried over by `params_from_jax` and loaded with
`load_state_dict(strict=True)`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.config import CfgNode
from nerface_tpu.models import MODELS
from nerface_tpu.ops.encoding import positional_encoding
from nerface_tpu_torch.models.nerf_models import (
    ConditionalBlendshapePaperNeRFModel,
    build_model,
)
from nerface_tpu_torch.train.checkpoint import params_from_jax

torch.set_num_threads(1)

KW = dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False)


@pytest.fixture(scope="module")
def pair():
    jmodel = MODELS["ConditionalBlendshapePaperNeRFModel"](**KW)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tmodel = ConditionalBlendshapePaperNeRFModel(**KW)
    tmodel.load_state_dict(
        params_from_jax({k: np.asarray(v) for k, v in jparams.items()}), strict=True
    )
    rng = np.random.RandomState(0)
    R, S = 6, 16
    pts = rng.uniform(-0.3, 0.3, (R, S, 3)).astype(np.float32)
    dirs = rng.randn(R, 3).astype(np.float32)
    expr = rng.randn(76).astype(np.float32) * 0.5
    latent = rng.randn(32).astype(np.float32) * 0.1
    pe_xyz = positional_encoding(jnp.asarray(pts), 10, True, True)
    pe_dir = positional_encoding(jnp.asarray(dirs), 4, False, True)
    return jmodel, jparams, tmodel, (pe_xyz, pe_dir, expr, latent)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_state_dict_names_match_reference(pair):
    jmodel, jparams, tmodel, _ = pair
    sd = tmodel.state_dict()
    assert list(sd) == list(jparams)  # same names, same registration order
    assert "layers_dir.3.weight" in sd  # created, never applied (reference quirk)
    for k, v in jparams.items():
        assert tuple(sd[k].shape) == v.shape, k


def test_structured_forward_matches_jax_f32(pair):
    """(R, S, Dx) samples with per-ray directions. f32; atol 1e-5·scale: the
    two frameworks sum each 256-wide dot in a different order."""
    jmodel, jparams, tmodel, (pe_xyz, pe_dir, expr, latent) = pair
    ref = np.asarray(jmodel.apply(jparams, pe_xyz, pe_dir, jnp.asarray(expr), jnp.asarray(latent)))
    got = tmodel(_t(pe_xyz), _t(pe_dir), _t(expr), _t(latent)).detach().numpy()
    assert got.shape == ref.shape == (6, 16, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_flat_forward_matches_structured(pair):
    """Flat rows with per-row directions give the structured result."""
    _, _, tmodel, (pe_xyz, pe_dir, expr, latent) = pair
    R, S, D = pe_xyz.shape
    flat_dir = np.repeat(np.asarray(pe_dir), S, axis=0)
    a = tmodel(_t(pe_xyz), _t(pe_dir), _t(expr), _t(latent)).reshape(R * S, 4)
    b = tmodel(_t(np.asarray(pe_xyz).reshape(R * S, D)), _t(flat_dir), _t(expr), _t(latent))
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_bf16_forward_matches_jax_bf16(pair):
    """dtype=bf16 on both sides: bf16 operands, f32 products and sums. The
    sums' order differs, which can flip a bf16 rounding of an activation
    (one bf16 ulp, 2^-8 relative) before the next layer: atol 5e-3·scale."""
    jmodel, jparams, tmodel, (pe_xyz, pe_dir, expr, latent) = pair
    ref = np.asarray(jmodel.apply(
        jparams, pe_xyz, pe_dir, jnp.asarray(expr), jnp.asarray(latent), dtype=jnp.bfloat16
    ))
    got = tmodel(
        _t(pe_xyz), _t(pe_dir), _t(expr), _t(latent), dtype=torch.bfloat16
    ).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=5e-3 * np.abs(ref).max(), rtol=0)


def test_seeded_init_is_reproducible_and_torch_like():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = ConditionalBlendshapePaperNeRFModel(**KW, generator=g1).state_dict()
    b = ConditionalBlendshapePaperNeRFModel(**KW, generator=g2).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = a["layers_xyz.1.weight"]
    bound = 1.0 / 16.0  # 1/sqrt(256)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound


def _model_cfg(type_name):
    return CfgNode({
        "type": type_name, "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4,
        "include_input_xyz": True, "include_input_dir": False, "use_viewdirs": True,
        "num_layers": 4, "hidden_size": 256,
    })


def test_build_model():
    """`build_model` builds every one of the JAX package's 14 `MODELS` keys,
    and `MODELS` holds them in JAX's order."""
    from nerface_tpu_torch.models.nerf_models import MODELS as PORT_MODELS

    m = build_model(_model_cfg("ConditionalBlendshapePaperNeRFModel"))
    assert isinstance(m, ConditionalBlendshapePaperNeRFModel)
    assert m.dim_xyz == 63 and m.dim_dir == 24 and m.dim_cond == 108
    assert list(PORT_MODELS) == list(MODELS) and len(PORT_MODELS) == 14  # MODELS: JAX's
    for name in MODELS:
        assert type(build_model(_model_cfg(name))) is PORT_MODELS[name]
