"""The port's one-read sketched IDs held against the JAX package, each
given the Gaussian sketch the JAX function drew from its key.

Tolerances: ``col_ind`` / ``row_ind`` exactly equal; the gathered C (and
the rows R of a row ID) bitwise equal; other factors to 1e-5 (f32) or
1e-10 (f64) of their largest entry; the skeleton as in
``tests/test_sampling.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc
from test_torch_parity import (assert_same_two_sided, jax_sketch,  # noqa: F401
                               low_rank, n, port, t)
from torch_threads import one_thread  # noqa: F401 (autouse)

ATOL = {np.float32: 1e-5, np.float64: 1e-10}
SHAPE, RANK, WIDTH = (60, 40), 12, 20   # WIDTH = rank + oversample 8


def _close(got, want, dtype):
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want,
                               atol=ATOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_column_id_given_the_jax_sketch(port, dtype):
    from rusty_compression_tpu_torch.sampling import (
        _sketched_column_id_from_sketch)

    a = low_rank(30, SHAPE, 1e-3, dtype)
    key = jax.random.key(31)
    want = jax.jit(lambda x, k: rc.sketched_column_id(x, k, rank=RANK))(
        jnp.asarray(a), key)
    g_h = jax_sketch(key, SHAPE[0], WIDTH, dtype)
    got = _sketched_column_id_from_sketch(port.rt.DenseOperator(t(a)),
                                          t(g_h), RANK)
    np.testing.assert_array_equal(n(got.col_ind), np.asarray(want.col_ind))
    np.testing.assert_array_equal(n(got.c), np.asarray(want.c))
    np.testing.assert_array_equal(n(got.c), a[:, n(got.col_ind[:RANK])])
    _close(got.z, want.z, dtype)


@pytest.mark.parametrize("dtype", [np.float32])
def test_row_id_given_the_jax_sketch(port, dtype):
    from rusty_compression_tpu_torch.sampling import (
        _sketched_row_id_from_sketch)

    a = low_rank(32, SHAPE, 1e-3, dtype)
    key = jax.random.key(33)
    want = jax.jit(lambda x, k: rc.sketched_row_id(x, k, rank=RANK))(
        jnp.asarray(a), key)
    g_h = jax_sketch(key, SHAPE[1], WIDTH, dtype)   # sketch of A^H
    got = _sketched_row_id_from_sketch(port.rt.DenseOperator(t(a)),
                                       t(g_h), RANK)
    np.testing.assert_array_equal(n(got.row_ind), np.asarray(want.row_ind))
    np.testing.assert_array_equal(n(got.r), a[n(got.row_ind[:RANK]), :])
    _close(got.x, want.x, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_two_sided_id_given_the_jax_sketch(port, dtype):
    from rusty_compression_tpu_torch.sampling import (
        _sketched_column_id_from_sketch)

    a = low_rank(34, SHAPE, 1e-3, dtype)
    key = jax.random.key(35)
    want = jax.jit(lambda x, k: rc.sketched_two_sided_id(x, k, rank=RANK))(
        jnp.asarray(a), key)
    g_h = jax_sketch(key, SHAPE[0], WIDTH, dtype)
    got = _sketched_column_id_from_sketch(
        port.rt.DenseOperator(t(a)), t(g_h), RANK).two_sided_id()
    assert_same_two_sided(got, want, ATOL[dtype])
    sk = a[np.ix_(n(got.row_ind[:RANK]), n(got.col_ind[:RANK]))]
    tol = 1e-4 if dtype == np.float32 else 1e-9
    np.testing.assert_allclose(n(got.x), sk, rtol=tol,
                               atol=tol * np.abs(sk).max())


def test_tolerance_mode_given_the_jax_sketch(port):
    """tol= picks the rank on the sketch diagonal: same rank, same leading
    pivots, same factors; an unreachable tolerance under max_rank raises.
    The cut (tol/2 = 5e-3) keeps the squared diagonal ratios far above
    eps, where the downdated norm table still decides the pivots."""
    dtype, floor, tol = np.float32, 1e-4, 1e-2
    from rusty_compression_tpu_torch.sampling import (
        _sketched_column_id_from_sketch)

    a = low_rank(36, SHAPE, floor, dtype)
    key = jax.random.key(37)
    want = rc.sketched_two_sided_id(jnp.asarray(a), key, tol=tol)
    op = port.rt.DenseOperator(t(a))
    g_h = t(jax_sketch(key, SHAPE[0], SHAPE[1], dtype))  # full-width sketch
    got = _sketched_column_id_from_sketch(op, g_h, tol=tol).two_sided_id()
    k = want.rank
    assert got.rank == k
    np.testing.assert_array_equal(n(got.col_ind[:k]),
                                  np.asarray(want.col_ind[:k]))
    np.testing.assert_array_equal(n(got.row_ind[:k]),
                                  np.asarray(want.row_ind[:k]))
    for name in ("c", "x", "r"):
        _close(getattr(got, name), getattr(want, name), dtype)
    err = float(port.rt.rel_diff_fro(got.to_mat(), t(a)))
    assert err < 5 * tol
    with pytest.raises(port.rt.CompressionError):
        _sketched_column_id_from_sketch(op, g_h[:, :15], tol=tol, max_rank=7)


def test_matrix_free_operator_gathers_through_matmat(port):
    """An operator without a cheap dense view gets its k columns through
    one one-hot product of width k, the same columns as the dense path."""
    torch, rt = port.torch, port.rt
    from rusty_compression_tpu_torch.sampling import (
        _sketched_column_id_from_sketch)

    a = t(low_rank(38, SHAPE, 1e-3, np.float64))
    widths = []

    class MatmatOnly(rt.LinearOperator):
        shape, dtype, device = SHAPE, torch.float64, torch.device("cpu")

        def matmat(self, x):
            widths.append(x.shape[-1])
            return a @ x

        def conj_matmat(self, x):
            return a.mT @ x

    g_h = t(np.random.default_rng(39).standard_normal((SHAPE[0], WIDTH)))
    want = _sketched_column_id_from_sketch(rt.DenseOperator(a), g_h, RANK)
    got = _sketched_column_id_from_sketch(MatmatOnly(), g_h, RANK)
    assert not MatmatOnly().has_cheap_dense() and widths == [RANK]
    np.testing.assert_array_equal(n(got.col_ind), n(want.col_ind))
    np.testing.assert_array_equal(n(got.c), n(want.c))


def test_rank_and_tol_are_exclusive(port):
    g = port.torch.Generator().manual_seed(0)
    a = t(low_rank(40, SHAPE, 1e-3))
    with pytest.raises(ValueError, match="exactly one"):
        port.rt.sketched_column_id(a, g)
    with pytest.raises(ValueError, match="exactly one"):
        port.rt.sketched_row_id(a, g, rank=4, tol=1e-2)
