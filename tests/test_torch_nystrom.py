"""Generalized Nyström of the port held against the JAX package's.

``_nystrom_svd_from_omegas`` gets the two Gaussian matrices that JAX
``nystrom_svd`` draws from its key. Tolerances: singular values rtol 1e-4
(f32/c64) / 1e-9 (f64/c128) on those above the dtype's floor relative to
the largest (a pseudoinverse sits in the pipeline); reconstructions atol
the same times sigma_1 = 1. From a generator, the accuracy gate of
``tests/test_sampling.py::TestNystromSVD``: rel err below ten times the
first dropped singular value, U orthonormal to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc
from rusty_compression_tpu.parallel.batch import (
    batched_nystrom as jax_batched_nystrom)
from test_torch_parity import (block_keys, jax_nystrom_omegas,  # noqa: F401
                               low_rank, n, port, t)

SHAPE = (120, 90)
K = 20
TOL = {np.float32: 1e-4, np.complex64: 1e-4, np.float64: 1e-9,
       np.complex128: 1e-9}


@pytest.mark.parametrize("dtype,stabilize,small_svd", [
    (np.float32, True, "direct"), (np.float64, True, "direct"),
    (np.complex64, True, "direct"), (np.complex128, True, "direct"),
    (np.float64, False, "direct"), (np.float64, True, "gram")])
def test_nystrom_given_the_jax_omegas(port, dtype, stabilize, small_svd):
    from rusty_compression_tpu_torch.sampling import _nystrom_svd_from_omegas

    a = low_rank(100, SHAPE, 1e-6, dtype)
    key = jax.random.key(101)
    want = rc.nystrom_svd(jnp.asarray(a), key, k=K, small_svd=small_svd,
                          stabilize=stabilize)
    omega, psi_h = jax_nystrom_omegas(key, *SHAPE, K, 8, dtype)
    got = _nystrom_svd_from_omegas(port.rt.DenseOperator(t(a)), t(omega),
                                   t(psi_h), K, small_svd, stabilize)
    assert got.rank == K and got.u.shape == (SHAPE[0], K)
    # the unstabilized pinv and the Gram small SVD both lose digits
    tol = TOL[dtype] * (1e3 if not stabilize or small_svd == "gram" else 1)
    np.testing.assert_allclose(n(got.s), np.asarray(want.s), rtol=tol)
    np.testing.assert_allclose(n(got.to_mat()), np.asarray(want.to_mat()),
                               atol=tol)
    np.testing.assert_allclose(n(got.u.mH @ got.u), np.eye(K),
                               atol=max(tol, 1e-4 if a.itemsize <= 8 else 0))


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
def test_accuracy_within_theory_from_a_generator(port, dtype):
    torch, rt = port.torch, port.rt
    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(1)
    a = rt.random_approximate_low_rank_matrix(g, (200, 150), 1.0, 1e-10,
                                              dtype=tdt)
    k = 40
    svd = rt.nystrom_svd(a, g, k=k)
    sigma_next = 10.0 ** (-10.0 * k / 149)
    assert float(rt.rel_diff_fro(svd.to_mat(), a)) < 10 * sigma_next
    assert svd.rank == k
    assert float(torch.linalg.norm(svd.u.mH @ svd.u - torch.eye(k))) < 1e-4


def test_batched_nystrom_matches_jax(port, monkeypatch):
    from rusty_compression_tpu_torch.parallel import batched_nystrom
    from test_torch_parity import feed_gaussians

    blocks = np.stack([low_rank(102 + i, SHAPE, 1e-6, np.float64)
                       for i in range(3)])
    key = jax.random.key(103)
    want = jax_batched_nystrom(jnp.asarray(blocks), key, K, oversample=6)
    pairs = [jax_nystrom_omegas(k, *SHAPE, K, 6, np.float64)
             for k in block_keys(key, 3)]
    left = feed_gaussians(monkeypatch, [np.stack([p[0] for p in pairs]),
                                        np.stack([p[1] for p in pairs])])
    got = batched_nystrom(t(blocks), port.torch.Generator(), K, oversample=6)
    assert not left and got.u.shape == (3, SHAPE[0], K)
    np.testing.assert_allclose(n(got.s), np.asarray(want.s), rtol=1e-9)
    recon = jax.vmap(lambda s: s.to_mat())(want)
    np.testing.assert_allclose(n(got.to_mat()), np.asarray(recon), atol=1e-9)
    with pytest.raises(ValueError, match="block stack"):
        batched_nystrom(t(blocks[0]), port.torch.Generator(), K)


def test_two_passes_and_the_sketch_widths(port):
    """One ``matmat`` of width l = k + p and one ``conj_matmat`` of width
    l2 = max(int(1.5 l), l + 4): the operator is touched twice."""
    torch, rt = port.torch, port.rt
    a = t(low_rank(104, SHAPE, 1e-6, np.float64))
    calls = []

    class Counting(rt.DenseOperator):
        def matmat(self, x):
            calls.append(("matmat", x.shape[-1]))
            return super().matmat(x)

        def conj_matmat(self, x):
            calls.append(("conj_matmat", x.shape[-1]))
            return super().conj_matmat(x)

    g = torch.Generator().manual_seed(0)
    rt.nystrom_svd(Counting(a), g, k=4, oversample=0)
    assert calls == [("matmat", 4), ("conj_matmat", 8)]       # l + 4 wins
    calls.clear()
    rt.nystrom_svd(Counting(a), g, k=12, oversample=8)
    assert calls == [("matmat", 20), ("conj_matmat", 30)]     # int(1.5 l)


def test_nystrom_of_a_composite_operator(port):
    """``TestOperatorCombinators.test_composite_compression``: B @ C is
    compressed without being formed."""
    torch, rt = port.torch, port.rt
    b = t(low_rank(105, (80, 40), 1e-8, np.float64))
    c = t(low_rank(106, (40, 60), 1e-8, np.float64))
    op = rt.as_linear_operator(b) @ rt.as_linear_operator(c)
    assert op.shape == (80, 60)
    svd = rt.nystrom_svd(op, torch.Generator().manual_seed(3), k=25)
    assert float(rt.rel_diff_fro(svd.to_mat(), b @ c)) < 1e-6


def test_nystrom_block_is_nystrom_svd(port):
    from rusty_compression_tpu_torch.parallel import nystrom_block

    torch = port.torch
    a = t(low_rank(107, SHAPE, 1e-6, np.float64))
    got = nystrom_block(a, torch.Generator().manual_seed(5), K, oversample=6)
    want = port.rt.nystrom_svd(a, torch.Generator().manual_seed(5), K,
                               oversample=6)
    for name in ("u", "s", "vt"):
        assert torch.equal(getattr(got, name), getattr(want, name))
