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

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc

from torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def port():
    """``(torch, rusty_compression_tpu_torch)``, imported on first use
    (at one thread: ``one_thread``)."""
    import torch

    import rusty_compression_tpu_torch

    return types.SimpleNamespace(torch=torch, rt=rusty_compression_tpu_torch)


def low_rank(seed: int, shape, sigma_min: float, dtype=np.float32,
             rank: int | None = None):
    """``U diag(geomspace(1, sigma_min)) V^H`` with random orthonormal U, V
    (complex for a complex ``dtype``), of rank ``min(shape)`` unless
    ``rank`` says less."""
    rng = np.random.default_rng(seed)
    m, n = shape
    k = min(m, n) if rank is None else rank
    cplx = np.issubdtype(dtype, np.complexfloating)

    def gaussian(rows):
        g = rng.standard_normal((rows, k))
        return g + 1j * rng.standard_normal((rows, k)) if cplx else g

    u, _ = np.linalg.qr(gaussian(m))
    v, _ = np.linalg.qr(gaussian(n))
    return ((u * np.geomspace(1.0, sigma_min, k)) @ v.conj().T).astype(dtype)


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


@contextlib.contextmanager
def one_rank_mesh():
    """A ``"blocks"`` mesh of one rank on the CPU (``make_mesh`` makes its
    group from an in-process store), destroyed on exit so that it cannot
    leak into the next test of the worker."""
    import torch.distributed as dist

    from rusty_compression_tpu_torch.parallel import make_mesh

    try:
        yield make_mesh(device_type="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


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

    np.testing.assert_allclose(n(km.hilbert(7, device="cpu")),
                               np.asarray(jkm.hilbert(7)),
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
    qr = interop.from_numpy(jqr, device="cpu")
    assert isinstance(qr, port.rt.QR) and qr.ind.dtype == port.torch.int64
    for name in ("q", "r", "ind"):
        np.testing.assert_array_equal(n(getattr(qr, name)),
                                      np.asarray(getattr(jqr, name)))
    op = interop.from_numpy(a, device="cpu")
    assert isinstance(op, port.rt.DenseOperator) and op.shape == (30, 20)


def test_one_thread_in_torch_and_the_blas(port):
    """The test workers share the cores: while a port test module runs,
    torch and every BLAS numpy or scipy loaded use one thread."""
    from threadpoolctl import threadpool_info

    assert port.torch.get_num_threads() == 1
    pools = [p for p in threadpool_info() if p["user_api"] == "blas"]
    assert pools and all(p["num_threads"] == 1 for p in pools)


def test_every_port_test_file_takes_one_thread():
    """Each ``test_torch_*.py`` imports the autouse ``one_thread``."""
    import ast
    from pathlib import Path

    def takes_it(path):
        return any(isinstance(node, ast.ImportFrom)
                   and node.module == "torch_threads"
                   and "one_thread" in [a.name for a in node.names]
                   for node in ast.parse(path.read_text()).body)

    files = sorted(Path(__file__).parent.glob("test_torch_*.py"))
    assert len(files) > 20
    assert [f.name for f in files if not takes_it(f)] == []


# ---------------------------------------------------------------------------
# Helpers of the tolerance-driven slice
# ---------------------------------------------------------------------------


def decade_block(seed: int, shape, per_decade: int, dtype=np.float64):
    """``U diag(10^(-j / per_decade)) V^H``: every ``per_decade`` columns
    the spectrum falls by ten, so an adaptive sampler with that block size
    sees its residual estimate fall by about ten a round, far from any
    tolerance that is not a power of ten times the first estimate."""
    rng = np.random.default_rng(seed)
    m, ncols = shape
    k = min(m, ncols)
    cplx = np.issubdtype(dtype, np.complexfloating)

    def gaussian(rows):
        g = rng.standard_normal((rows, k))
        return g + 1j * rng.standard_normal((rows, k)) if cplx else g

    u, _ = np.linalg.qr(gaussian(m))
    v, _ = np.linalg.qr(gaussian(ncols))
    sigma = 10.0 ** (-np.arange(k) / per_decade)
    return ((u * sigma) @ v.conj().T).astype(dtype)


def jax_adaptive_omegas(key, ncols: int, blk: int, count: int, dtype):
    """The Gaussian matrices of JAX ``_adaptive_loop(op, key, ...)``:
    ``key, k0 = split(key)`` for the first probe and ``key, k1 =
    split(key)`` in each round (sampling.py:184, :221)."""
    out = []
    for _ in range(count):
        key, sub = jax.random.split(key)
        out.append(jax_gaussian(sub, (ncols, blk), dtype))
    return out


def jax_adaptive_omegas_stack(key, lanes: int, ncols: int, blk: int,
                              count: int, dtype):
    """The same for ``vmap`` over ``split(key, lanes)``: one (lanes, n, blk)
    matrix a round."""
    per_lane = [jax_adaptive_omegas(k, ncols, blk, count, dtype)
                for k in block_keys(key, lanes)]
    return [np.stack([lane[i] for lane in per_lane]) for i in range(count)]


def jax_nystrom_omegas(key, m: int, ncols: int, k: int, oversample: int,
                       dtype, psi_oversample: float = 1.5):
    """``Omega`` and ``Psi^H`` of JAX ``nystrom_svd`` (sampling.py:364-368)."""
    l = k + oversample
    l2 = max(int(l * psi_oversample), l + 4)
    k_om, k_ps = jax.random.split(key)
    return (jax_gaussian(k_om, (ncols, l), dtype),
            jax_gaussian(k_ps, (m, l2), dtype))


def feed_gaussians(monkeypatch, mats):
    """Make the port's samplers take ``mats``, in order, where they would
    draw a Gaussian matrix from their generator (shapes are checked), so
    that a public entry point computes on the JAX package's draws. Returns
    the queue: what is left of it was not drawn."""
    import rusty_compression_tpu_torch.sampling as sampling

    queue = list(mats)

    def fake(generator, shape, dtype=None, device=None):
        mat = queue.pop(0)
        assert tuple(mat.shape) == tuple(shape), (mat.shape, shape)
        return t(mat)

    monkeypatch.setattr(sampling, "random_gaussian", fake)
    return queue
