"""The PyTorch port's foundations held against the JAX package, and the
helpers the other ``test_torch_*`` files share.

torch and the port are imported on first use (the ``port`` fixture and
the helpers), not when this file is collected: every test worker collects
every test file, and importing torch there would cost each worker seconds
before any test runs.

Inputs are made with numpy from a seed. Where the JAX package draws a
Gaussian matrix from a key, the ``jax_*`` helpers repeat its key splits
and draw, so that the port's inner ``_..._from_omega`` /
``_..._from_sketch`` functions get the very matrix the JAX function used.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc


@pytest.fixture(scope="module")
def port():
    """``(torch, rusty_compression_tpu_torch)``, imported on first use.
    One intra-op thread: the test workers already share the cores."""
    import torch

    import rusty_compression_tpu_torch

    torch.set_num_threads(1)

    return types.SimpleNamespace(torch=torch, rt=rusty_compression_tpu_torch)


def low_rank(seed: int, shape, sigma_min: float, dtype=np.float32):
    """``U diag(geomspace(1, sigma_min)) V^T`` with random orthonormal U, V."""
    rng = np.random.default_rng(seed)
    m, n = shape
    k = min(m, n)
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((n, k)))
    return ((u * np.geomspace(1.0, sigma_min, k)) @ v.T).astype(dtype)


def t(x):
    """numpy / JAX array -> CPU tensor (index arrays as int64)."""
    import torch

    arr = np.asarray(x)
    if np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.int64)
    return torch.tensor(arr)


def n(x) -> np.ndarray:
    """tensor / JAX array -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def jax_gaussian(key, shape, dtype) -> np.ndarray:
    """``random_gaussian(key, shape, dtype)`` of the JAX package."""
    return np.asarray(rc.random_gaussian(key, shape, dtype=dtype))


def jax_sketch(key, rows: int, width: int, dtype) -> np.ndarray:
    """The ``G^H`` that JAX ``sketched_column_id(op, key, ...)`` draws: the
    first key of ``jax.random.split(key)`` (sampling.py:461-463)."""
    k_sketch, _ = jax.random.split(key)
    return jax_gaussian(k_sketch, (rows, width), dtype)


def block_keys(key, count: int):
    """Per-block keys of the JAX batched entry points
    (parallel/batch.py:144)."""
    return jax.random.split(key, count)


def projector(q: np.ndarray) -> np.ndarray:
    """``Q Q^H``: compares two orthonormal bases whatever their signs."""
    return q @ q.conj().T


def assert_same_two_sided(got, want, atol: float) -> None:
    """Pivots exactly equal; factors to ``atol`` times each factor's
    largest entry."""
    np.testing.assert_array_equal(n(got.col_ind), np.asarray(want.col_ind))
    np.testing.assert_array_equal(n(got.row_ind), np.asarray(want.row_ind))
    for name in ("c", "x", "r"):
        ref = np.asarray(getattr(want, name))
        np.testing.assert_allclose(n(getattr(got, name)), ref,
                                   atol=atol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# Foundations: utils, errors, compression selector, interop
# ---------------------------------------------------------------------------


def test_error_classes_mirror_the_jax_package(port):
    from rusty_compression_tpu.utils import errors as jerr

    for name in jerr.__all__:
        cls = getattr(port.rt, name)
        assert issubclass(cls, port.rt.RustyCompressionError)
        assert cls.__mro__[1].__name__ == getattr(jerr, name).__mro__[1].__name__


@pytest.mark.parametrize("mode", ["COL", "ROW", "COLINV", "ROWINV"])
def test_apply_matrix_permutation(port, mode):
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((3, 5, 5))
    perm = np.stack([rng.permutation(5) for _ in range(3)]).astype(np.int32)
    want = np.stack([np.asarray(rc.apply_matrix_permutation(
        mat[b], perm[b], getattr(rc.MatrixPermutationMode, mode)))
        for b in range(3)])
    got = port.rt.apply_matrix_permutation(
        t(mat), t(perm), getattr(port.rt.MatrixPermutationMode, mode))
    np.testing.assert_array_equal(n(got), want)
    inv = port.rt.invert_permutation_vector(t(perm[0]))
    np.testing.assert_array_equal(
        n(inv), np.asarray(rc.invert_permutation_vector(perm[0])))


def test_metrics(port):
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((2, 4, 6, 5))
    np.testing.assert_allclose(n(port.rt.rel_diff_fro(t(a), t(b))),
                               np.asarray(rc.rel_diff_fro(a, b)), rtol=1e-12)
    np.testing.assert_allclose(n(port.rt.rel_diff_l2(t(a), t(b))),
                               np.asarray(rc.rel_diff_l2(a, b)), rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "complex128"])
def test_random_matrices(port, dtype):
    torch, rt = port.torch, port.rt
    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    x = rt.random_gaussian(g, (400, 300), dtype=tdt)
    assert x.dtype == tdt and x.shape == (400, 300)
    # complex entries have variance 2, as in the JAX package
    var = 2.0 if tdt.is_complex else 1.0
    assert abs(float((x.abs() ** 2).mean()) - var) < 0.05 * var
    q = rt.random_orthogonal_matrix(g, (20, 50), dtype=tdt)
    np.testing.assert_allclose(n(q @ q.mH), np.eye(20), atol=1e-5)
    a = rt.random_approximate_low_rank_matrix(g, (30, 20), 1.0, 1e-3,
                                              dtype=tdt)
    s = torch.linalg.svdvals(a)
    np.testing.assert_allclose(n(s), np.geomspace(1.0, 1e-3, 20), rtol=1e-3)


def test_matmul_precision_policy(port):
    torch, rt = port.torch, port.rt
    assert rt.default_precision() == "highest"
    before = torch.get_float32_matmul_precision()
    with rt.matmul_precision("high"):
        assert torch.get_float32_matmul_precision() == "high"
    with rt.matmul_precision("default"):
        assert torch.get_float32_matmul_precision() == "medium"
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(ValueError):
        with rt.matmul_precision("bf16"):
            pass


def test_kernel_matrices(port):
    from rusty_compression_tpu.utils import kernel_matrices as jkm

    from rusty_compression_tpu_torch.utils import kernel_matrices as km

    np.testing.assert_allclose(n(km.hilbert(7)), np.asarray(jkm.hilbert(7)),
                               rtol=1e-15)
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.5, 0.5, (40, 3))
    y = rng.uniform(-0.5, 0.5, (30, 3)) + np.array([3.0, 0.0, 0.0])
    np.testing.assert_allclose(n(km.laplace_kernel_block(t(x), t(y))),
                               np.asarray(jkm.laplace_kernel_block(x, y)),
                               rtol=1e-13)
    cloud = km.random_cloud(port.torch.Generator().manual_seed(0), 500,
                            (3.0, 0.0, 0.0))
    assert float((cloud - t(np.array([3.0, 0, 0]))).abs().max()) <= 0.5


def test_compression_selector(port):
    rt = port.rt
    assert rt.CompressionType.RANK(5) == rt.Rank(5)
    assert rt.CompressionType.ADAPTIVE(1e-3).tol == 1e-3


def test_interop_from_numpy(port):
    """JAX containers and operands arrive as the port's, leaf for leaf."""
    from rusty_compression_tpu_torch import interop

    a = low_rank(3, (30, 20), 1e-3, np.float64)
    jqr = rc.QR.compute_from(jnp.asarray(a), max_rank=8)
    qr = interop.from_numpy(jqr)
    assert isinstance(qr, port.rt.QR) and qr.ind.dtype == port.torch.int64
    for name in ("q", "r", "ind"):
        np.testing.assert_array_equal(n(getattr(qr, name)),
                                      np.asarray(getattr(jqr, name)))
    op = interop.from_numpy(a)
    assert isinstance(op, port.rt.DenseOperator) and op.shape == (30, 20)
