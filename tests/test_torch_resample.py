"""PyTorch port, K5 (`ops/kernels/fused_resample.py`): the plain version of
the fused resample (the pipeline's `sample_pdf` + `merge_sorted_zvals`)
against the JAX package's `fused_resample` Pallas kernel in interpret mode,
as `tests/test_pallas.py` runs it on the CPU, and against JAX `sample_pdf` +
`merge_sorted_zvals` with the same draws. Inputs come from numpy seeds; the
same u goes to both sides. Tolerance atol 1e-5, the JAX kernel's own
contract against its XLA twin (f32 sums in another order move a drawn depth
by a few ulps of the cdf over the bin's slope), and every output row sorted.
The CUDA kernel itself is held to this plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` `[resample_kernel]`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerface_tpu.ops import sampling as jax_sampling
from nerface_tpu.ops.pallas.fused_mlp import fused_resample as jax_fused_resample
from nerface_tpu_torch.ops.kernels import fused_resample as K5
from nerface_tpu_torch.ops.math import linspace01

torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(R, Sc, seed, spike=False):
    """Sorted coarse depths and random weights, as tests/test_pallas.py
    makes them; `spike` puts most of the mass on one bin, so many samples
    crowd one interval and meet the coarse depths around it."""
    rng = np.random.RandomState(seed)
    z = np.cumsum(rng.rand(R, Sc).astype(np.float32) * 0.01 + 0.002, -1)
    w = rng.rand(R, Sc).astype(np.float32)
    if spike:
        w[:, 7] = 1e3
    return z, w, rng


def _check(got, ref):
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=0)
    assert (np.diff(got, axis=-1) >= 0).all()


@pytest.mark.parametrize(
    "regime,R,Sc,Sf,spike",
    [("general", 16, 64, 64, False), ("general", 8, 32, 16, False),
     ("sorted_u", 16, 64, 64, False), ("sorted_u", 8, 32, 16, False),
     ("sorted_u", 16, 64, 64, True)],
    ids=["general-16-64-64", "general-8-32-16", "sorted_u-16-64-64", "sorted_u-8-32-16",
         "sorted_u-16-64-64-spike"],
)
def test_plain_matches_jax_kernel(regime, R, Sc, Sf, spike):
    """Both regimes: general (R, Sf) draws, and the shared (Sf,) linspace
    row with `sorted_u` (the port's linspace01 is jnp.linspace(0, 1) bit
    for bit, so both sides draw at the same u). The spike case is the JAX
    package's own (64 + 64 samples, linspace draws). Where a bin's pdf is
    tiny, the reference itself is ill-conditioned: a draw in a tail bin of
    pdf ~ 2e-5 turns the ulp of a cdf near 1, which the two sides' f32 sums
    round apart, into ulp/pdf of the bin's width (3.4e-5 read with general
    draws), and at a bin under the 1e-5 clamp the draw at u = 1 jumps by a
    whole bin with the cdf's last ulp (Sc = 32 with the spike)."""
    z, w, rng = _inputs(R, Sc, seed=R + Sc, spike=spike)
    if regime == "general":
        u = rng.rand(R, Sf).astype(np.float32)
    else:
        u = np.array(jnp.linspace(0.0, 1.0, Sf, dtype=jnp.float32))
        np.testing.assert_array_equal(linspace01(Sf).numpy(), u)
    sorted_u = regime == "sorted_u"
    ref = jax_fused_resample(jnp.asarray(z), jnp.asarray(w), jnp.asarray(u), sorted_u=sorted_u)
    got = K5.fused_resample(torch.from_numpy(z), torch.from_numpy(w), torch.from_numpy(u),
                            sorted_u=sorted_u)
    assert got.shape == (R, Sc + Sf) and got.dtype == torch.float32
    _check(got, ref)
    torch.testing.assert_close(
        K5.fused_resample_reference(torch.from_numpy(z), torch.from_numpy(w),
                                    torch.from_numpy(u), sorted_u), got, atol=0, rtol=0)


@pytest.mark.parametrize("det", [False, True], ids=["random", "det"])
def test_plain_matches_jax_sample_pdf_and_merge(det):
    """JAX `sample_pdf` draws its u from the key (`jax.random.uniform` of
    the key at (R, Sf) without ray indices) or, with `det`, at the
    linspace; the same u is handed to the port."""
    R, Sc, Sf = 16, 64, 64
    z, w, _ = _inputs(R, Sc, seed=3)
    zj, wj = jnp.asarray(z), jnp.asarray(w)
    key = jax.random.PRNGKey(5)
    if det:
        u = np.array(jnp.linspace(0.0, 1.0, Sf, dtype=jnp.float32))
    else:
        u = np.array(jax.random.uniform(key, (R, Sf), dtype=jnp.float32))
    zs = jax_sampling.sample_pdf(None if det else key, 0.5 * (zj[:, 1:] + zj[:, :-1]),
                                 wj[:, 1:-1], Sf, det=det)
    ref = jax_sampling.merge_sorted_zvals(zj, zs)
    got = K5.fused_resample(torch.from_numpy(z), torch.from_numpy(w), torch.from_numpy(u),
                            sorted_u=det)
    _check(got, ref)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    z, w, rng = _inputs(4, 32, seed=1)
    zt = torch.from_numpy(z).requires_grad_()
    before = K5.fused_resample.launches
    got = K5.fused_resample(zt, torch.from_numpy(w), torch.from_numpy(rng.rand(4, 8).astype(np.float32)))
    assert K5.fused_resample.launches == before
    assert not got.requires_grad  # detached, as the reference detaches the samples


def test_wrapper_refuses_bad_shapes():
    z, w, rng = _inputs(4, 32, seed=2)
    z, w = torch.from_numpy(z), torch.from_numpy(w)
    u = torch.from_numpy(rng.rand(4, 8).astype(np.float32))
    with pytest.raises(ValueError, match="z_vals and weights"):
        K5.fused_resample(z, w[:, :16], u)
    with pytest.raises(ValueError, match="z_vals and weights"):
        K5.fused_resample(z[0], w[0], u)
    with pytest.raises(ValueError, match="u must be"):
        K5.fused_resample(z, w, u[:3])
    with pytest.raises(ValueError, match="u must be"):
        K5.fused_resample(z, w, u[None])
    with pytest.raises(ValueError, match="at least 3"):
        K5.fused_resample(z[:, :2], w[:, :2], u)
    # neither the CPU nor the card: refused, never run by the plain version
    with pytest.raises(ValueError, match="cuda or cpu"):
        K5.fused_resample(z.to("meta"), w.to("meta"), u.to("meta"))
