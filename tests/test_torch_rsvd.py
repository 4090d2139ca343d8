"""The rSVD half of the port held against the JAX package: orthonormalize,
compute_svd, range_finder, SVD containers, rsvd_block / batched_rsvd.

The port's inner ``_..._from_omega`` functions get the Gaussian matrix the
JAX function drew from its key. Range bases are compared by projector
(Householder and eigenvector signs may differ between the two LAPACK
paths). Tolerances: singular values rtol 1e-5 (f32) / 1e-10 (f64);
reconstruction errors within 1e-6 of the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc
from test_torch_parity import (jax_gaussian, low_rank, n, port,  # noqa: F401
                               projector, t)

RTOL = {np.float32: 1e-5, np.float64: 1e-10}
SHAPE = (60, 40)


@pytest.mark.parametrize("dtype,power_iters", [(np.float32, 2)])
def test_range_finder_given_the_jax_omega(port, dtype, power_iters):
    from rusty_compression_tpu_torch.sampling import _range_finder_from_omega

    a = low_rank(20, SHAPE, 1e-4, dtype)
    key = jax.random.key(21)
    want = jax.jit(lambda x, k: rc.range_finder(x, k, 12, power_iters))(
        jnp.asarray(a), key)
    omega = jax_gaussian(key, (SHAPE[1], 12), dtype)
    got = _range_finder_from_omega(port.rt.DenseOperator(t(a)), t(omega),
                                   power_iters)
    np.testing.assert_allclose(projector(n(got)), projector(np.asarray(want)),
                               atol=10 * RTOL[dtype])


@pytest.mark.parametrize("method", ["scholqr3", "svqb", "qr"])
def test_orthonormalize_matches_jax(port, method):
    y = low_rank(22, SHAPE, 1e-2, np.float64)[:, :12]
    want = np.asarray(jax.jit(lambda x: rc.orthonormalize(x, method))(
        jnp.asarray(y)))
    got = n(port.rt.orthonormalize(t(y), method))
    np.testing.assert_allclose(got.T @ got, np.eye(12), atol=1e-12)
    np.testing.assert_allclose(projector(got), projector(want), atol=1e-12)
    if method == "scholqr3":  # no sign freedom: the same Q
        np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("method,dtype", [("direct", np.float32),
                                          ("gram", np.float64)])
def test_compute_svd_matches_jax(port, method, dtype):
    """f64 for gram: it squares the condition number, so f32 singular
    values near 1e-2 carry ~1e-3 relative eigensolver noise."""
    a = low_rank(23, (12, 40), 1e-2, dtype)
    _, js, _ = rc.compute_svd(jnp.asarray(a), method=method)
    u, s, vt = port.rt.compute_svd(t(a), method=method)
    np.testing.assert_allclose(n(s), np.asarray(js), rtol=RTOL[dtype])
    np.testing.assert_allclose(n(u * s[None, :] @ vt), a,
                               atol=100 * RTOL[dtype])


@pytest.mark.parametrize("small_svd", ["direct", "gram"])
def test_rsvd_block_given_the_jax_omega(port, small_svd):
    from rusty_compression_tpu_torch.parallel.batch import (
        _rsvd_block_from_omega)

    from rusty_compression_tpu.parallel.batch import rsvd_block

    a = low_rank(24, SHAPE, 1e-4, np.float32)
    key = jax.random.key(25)
    want = jax.jit(lambda x, k: rsvd_block(x, k, 10, oversample=4,
                                           power_iters=1,
                                           small_svd=small_svd))(
        jnp.asarray(a), key)
    omega = jax_gaussian(key, (SHAPE[1], 14), np.float32)
    got = _rsvd_block_from_omega(t(a), t(omega), 10, power_iters=1,
                                 small_svd=small_svd)
    np.testing.assert_allclose(n(got.s), np.asarray(want.s),
                               rtol=RTOL[np.float32])
    err = float(port.rt.rel_diff_fro(got.to_mat(), t(a)))
    jerr = float(rc.rel_diff_fro(want.to_mat(), jnp.asarray(a)))
    assert abs(err - jerr) <= 1e-6


def test_svd_tolerance_matches_jax(port):
    a = low_rank(26, SHAPE, 1e-8, np.float64)
    want = rc.SVD.compute_from(jnp.asarray(a)).compress_svd_tolerance(1e-4)
    got = port.rt.SVD.compute_from(t(a)).compress_svd_tolerance(1e-4)
    assert got.rank == want.rank
    np.testing.assert_allclose(n(got.s), np.asarray(want.s), rtol=1e-10)
    with pytest.raises(port.rt.CompressionError):
        got.compress_svd_tolerance(1e-9)


def test_batched_rsvd_from_a_generator(port):
    """Independent per-block sketches from one generator: every block of
    the stack reaches the HMT error class of its spectrum."""
    torch, rt = port.torch, port.rt
    from rusty_compression_tpu_torch.parallel import (batched_rel_diff_fro,
                                                      batched_rsvd)

    blocks = t(np.stack([low_rank(s, SHAPE, 1e-4) for s in range(3)]))
    g = torch.Generator().manual_seed(0)
    svd = batched_rsvd(blocks, g, 10, oversample=5, power_iters=1)
    assert svd.u.shape == (3, 60, 10) and svd.s.shape == (3, 10)
    sigma_next = 1e-4 ** (10 / 39)  # sigma_11 / sigma_1 of the fixture
    assert torch.all(batched_rel_diff_fro(svd, blocks) < 3 * sigma_next)
    with pytest.raises(ValueError, match="block stack"):
        batched_rsvd(blocks[0], g, 10)
