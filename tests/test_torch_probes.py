"""PyTorch port, the Hopper design probes P1 and P2
(`nerface_tpu_torch/tools/perf/{encoder_concat,chain_overlap}_probe.py`):
each probe's plain PyTorch version against the JAX probe's kernel body
(`tools/perf/*.py`, imported from its file) run through
`pl.pallas_call(..., interpret=True)` on a grid of 2 blocks of the TPU
probe's TILE rows on the CPU, the same numpy inputs on both sides; and each
wrapper on CPU tensors is its plain version.

Tolerances, relative to max|JAX|:
- P2, max error 1e-2 and norm error 2e-3: both sides round every layer's
  input to bf16 and sum in f32, in other orders; where the orders put an
  activation on the other side of a bf16 rounding boundary, the flip (2^-8
  of it) travels on through the remaining layers of the 12-deep chain
  (read here: 4.2e-3 and 8.0e-4; bwd_mix 6.0e-4 and 1.2e-4).
- P1, 1e-5: one layer of the same bf16 products, f32 sums in another order
  (read: 2.6e-7).
The CUDA kernels are held to these plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` `[probes]`).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerface_tpu_torch.tools.perf import chain_overlap_probe as P2
from nerface_tpu_torch.tools.perf import encoder_concat_probe as P1

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
P2_TOL = (1e-2, 2e-3)
P1_TOL = 1e-5
# each port variant and the TPU kernel with the same output
P2_JAX = {
    "single": "kernel_single", "twochain_1wg": "kernel_twochain", "twochain": "kernel_twochain",
    "twochain_pingpong": "kernel_twochain", "fourchain": "kernel_fourchain",
    "bwd_mix": "kernel_bwd_mix", "bias_sums": "kernel_bias_sums",
}


def _jax_probe(name):
    spec = importlib.util.spec_from_file_location(f"tpu_{name}", ROOT / "tools" / "perf" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_p2():
    return _jax_probe("chain_overlap_probe")


@pytest.fixture(scope="module")
def jax_p1():
    return _jax_probe("encoder_concat_probe")


def _bf16_torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)


def _p2_inputs(tile, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2 * tile, 256) * 0.05).astype(np.float32)
    w = jnp.asarray((rng.randn(256, 256) * 0.06).astype(np.float32)).astype(jnp.bfloat16)
    return x, w


@pytest.mark.parametrize("variant", P2.VARIANTS)
def test_chain_plain_matches_jax_probe(jax_p2, variant):
    T = jax_p2.TILE
    x, w = _p2_inputs(T)
    spec = pl.BlockSpec((T, 256), lambda i: (i, 0))
    ref = np.asarray(pl.pallas_call(
        getattr(jax_p2, P2_JAX[variant]), grid=(2,),
        in_specs=[spec, pl.BlockSpec((256, 256), lambda i: (0, 0))], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((2 * T, 256), jnp.float32), interpret=True,
    )(jnp.asarray(x), w))
    got = P2.chain_reference(torch.from_numpy(x), _bf16_torch(w), variant).numpy()
    d = np.abs(got - ref)
    assert np.isfinite(got).all()
    assert d.max() <= P2_TOL[0] * np.abs(ref).max()
    assert np.linalg.norm(d) <= P2_TOL[1] * np.linalg.norm(ref)


def test_bwd_mix_dw_plain_matches_jax_probe(jax_p2):
    """bwd_mix's first dW term on the last 64 rows, as `kernel_bwd_mix`
    forms it (the probe's `_dot`, the mask, the bf16 dot_general over the
    rows), which the TPU kernel then discards; the port's kernel writes it
    out when asked, and `bwd_mix_dw_reference` is what the card's check
    holds it to. P2's tolerance: the f32 sums of a·W in another order flip
    the bf16 rounding of some gy elements (read here: 0.24 % of dW's
    elements move, by at most 6.1e-5·max)."""
    x, w = _p2_inputs(64, seed=4)
    a = jnp.asarray(x[-64:])
    gy = jax_p2._dot(a, w) * (a > 0).astype(jnp.float32)
    ref = np.asarray(jax.lax.dot_general(
        a.astype(jnp.bfloat16), gy.astype(jnp.bfloat16), (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))
    xt, wt = torch.from_numpy(x), _bf16_torch(w)
    got = P2.bwd_mix_dw_reference(xt, wt).numpy()
    d = np.abs(got - ref)
    assert d.max() <= P2_TOL[0] * np.abs(ref).max()
    assert np.linalg.norm(d) <= P2_TOL[1] * np.linalg.norm(ref)
    dw = torch.empty(256, 256)
    P2.chain_overlap(xt, wt, "bwd_mix", dw=dw)
    assert torch.equal(dw, torch.from_numpy(got))
    with pytest.raises(ValueError, match="bwd_mix only"):
        P2.chain_overlap(xt, wt, "single", dw=dw)


@pytest.mark.parametrize("variant", P1.VARIANTS)
def test_encoder_plain_matches_jax_probe(jax_p1, variant):
    T = jax_p1.TILE
    rng = np.random.RandomState(1)
    x3 = rng.randn(2 * T, 3).astype(np.float32)
    enc = rng.randn(2 * T, 60).astype(np.float32)
    wa = jnp.asarray(rng.randn(3, 256).astype(np.float32)).astype(jnp.bfloat16)
    wb = jnp.asarray(rng.randn(60, 256).astype(np.float32)).astype(jnp.bfloat16)

    def rows(c):
        return pl.BlockSpec((T, c), lambda i: (i, 0))

    def whole(s):
        return pl.BlockSpec(s, lambda i: (0, 0))

    if variant == "split":
        kern, ws, specs = jax_p1.kernel_split, (wa, wb), [whole((3, 256)), whole((60, 256))]
    else:
        kern, ws, specs = jax_p1.kernel_packed, (jnp.concatenate([wa, wb]),), [whole((63, 256))]
    ref = np.asarray(pl.pallas_call(
        kern, grid=(2,), in_specs=[rows(3), rows(60)] + specs, out_specs=rows(256),
        out_shape=jax.ShapeDtypeStruct((2 * T, 256), jnp.float32), interpret=True,
    )(x3, enc, *ws))
    got = P1.encoder_reference(torch.from_numpy(x3), torch.from_numpy(enc), _bf16_torch(wa),
                               _bf16_torch(wb), variant).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=P1_TOL * np.abs(ref).max())


def test_wrappers_on_cpu_are_the_plain_versions():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(256, 256, generator=g) * 0.05
    w = (torch.randn(256, 256, generator=g) * 0.06).to(torch.bfloat16)
    before = P2.chain_overlap.launches
    for v in P2.VARIANTS:
        assert torch.equal(P2.chain_overlap(x, w, v, depth=4), P2.chain_reference(x, w, v, 4))
    x3, enc = torch.randn(128, 3, generator=g), torch.randn(128, 60, generator=g)
    wa = torch.randn(3, 256, generator=g).to(torch.bfloat16)
    wb = torch.randn(60, 256, generator=g).to(torch.bfloat16)
    for v in P1.VARIANTS:
        assert torch.equal(P1.encoder_concat(x3, enc, wa, wb, v),
                           P1.encoder_reference(x3, enc, wa, wb, v))
    assert P2.chain_overlap.launches == before
    with pytest.raises(ValueError, match="variant"):
        P2.chain_reference(x, w, "threechain")


@pytest.mark.parametrize("variant", P1.VARIANTS)
def test_encoder_weight_images_hold_the_weights(variant):
    """The P1 weight images are the chunk images of the zero-padded
    matrices the kernel multiplies: unpacked, they give wa and wb back."""
    from test_torch_k2_layout import unpack_chunk_image

    g = torch.Generator().manual_seed(3)
    wa = torch.randn(3, 256, generator=g).to(torch.bfloat16)
    wb = torch.randn(60, 256, generator=g).to(torch.bfloat16)
    img = P1.pack_weights(wa, wb, variant)
    if variant == "packed":
        m = unpack_chunk_image(img, 64, 256)
        assert torch.equal(m[:3], wa) and torch.equal(m[3:63], wb) and not m[63:].float().any()
    else:
        ma = unpack_chunk_image(img[:64 * 256], 64, 256)
        mb = unpack_chunk_image(img[64 * 256:], 64, 256)
        assert torch.equal(ma[:3], wa) and not ma[3:].float().any()
        assert torch.equal(mb[:60], wb) and not mb[60:].float().any()
