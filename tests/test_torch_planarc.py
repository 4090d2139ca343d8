"""The port's complex entry points (``planarc``) held to the contracts of
``tests/test_planarc.py`` and against the JAX ``planar_*`` on the same
block.

The JAX module captures on the real (2m, 2n) realification and finishes in
host c128; the port runs natively in the input's complex dtype, so the two
share no random matrix and are compared by class: same rank, reconstruction
error inside the same bound (a multiple of the known spectrum's
``sigma_k``), bitwise skeleton columns and rows, skeleton entries within
1e-3. Inputs are the geomspace(1, 1e-10) fixture of the JAX suite, made
with numpy from a seed.
"""

import jax
import numpy as np
import pytest

import rusty_compression_tpu as rc
from test_torch_parity import low_rank, n, port, t  # noqa: F401 (fixture)
from torch_threads import one_thread  # noqa: F401 (autouse)

DTYPES = [np.complex64, np.complex128]
SHAPES = [(120, 80), (80, 120)]  # thin / thick


def fixture(shape, dtype, seed=50):
    return low_rank(seed, shape, 1e-10, dtype)


def spectrum_err(shape, k):
    return 10.0 ** (-10.0 * k / (min(shape) - 1))


def rel(got, a):
    return np.linalg.norm(n(got) - a) / np.linalg.norm(a)


def _gen(port, seed):
    return port.torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
class TestPlanarContracts:
    def test_rank_truncation(self, port, shape, dtype):
        a = fixture(shape, dtype)
        svd = port.rt.planar_rsvd(t(a), _gen(port, 1), rank=30)
        assert svd.rank == 30
        assert rel(svd.to_mat(), a) < 10 * spectrum_err(shape, 30)
        assert n(svd.u).dtype == np.dtype(dtype)
        u = n(svd.u)
        assert np.abs(u.conj().T @ u - np.eye(30)).max() < 1e-4

    def test_tolerance_truncation(self, port, shape, dtype):
        a = fixture(shape, dtype)
        svd = port.rt.planar_rsvd(t(a), _gen(port, 2), rank=48, tol=1e-4)
        expect = int(np.ceil(0.4 * (min(shape) - 1)))  # the crossing
        assert abs(svd.rank - expect) <= 2, (svd.rank, expect)
        assert rel(svd.to_mat(), a) < 5e-4

    def test_column_id_exact_columns(self, port, shape, dtype):
        a = fixture(shape, dtype)
        cid = port.rt.planar_column_id(t(a), _gen(port, 4), rank=30)
        assert cid.rank == 30
        np.testing.assert_array_equal(n(cid.c), a[:, n(cid.col_ind)[:30]])
        assert rel(cid.to_mat(), a) < 50 * spectrum_err(shape, 30)

    def test_row_id_exact_rows(self, port, shape, dtype):
        a = fixture(shape, dtype)
        rid = port.rt.planar_row_id(t(a), _gen(port, 5), rank=30)
        assert rid.rank == 30
        np.testing.assert_array_equal(n(rid.r), a[n(rid.row_ind)[:30], :])
        assert rel(rid.to_mat(), a) < 50 * spectrum_err(shape, 30)

    def test_two_sided_id_skeleton(self, port, shape, dtype):
        a = fixture(shape, dtype)
        ts = port.rt.planar_two_sided_id(t(a), _gen(port, 6), rank=30)
        assert ts.rank == 30 and tuple(ts.x.shape) == (30, 30)
        skel = a[np.ix_(n(ts.row_ind)[:30], n(ts.col_ind)[:30])]
        assert np.abs(n(ts.x) - skel).max() / np.abs(skel).max() < 1e-3
        assert rel(ts.to_mat(), a) < 100 * spectrum_err(shape, 30)


@pytest.mark.parametrize("dtype", DTYPES)
def test_unreachable_tolerance_raises(port, dtype):
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((80, 80))
                        + 1j * rng.standard_normal((80, 80)))
    flat = ((q * np.linspace(1.0, 0.5, 80)) @ q.conj().T).astype(dtype)
    with pytest.raises(port.rt.CompressionError):
        port.rt.planar_rsvd(t(flat), _gen(port, 3), rank=40, tol=1e-10)
    with pytest.raises(ValueError, match="rank= and/or tol="):
        port.rt.planar_rsvd(t(flat), _gen(port, 3))


def test_capture_residual_and_width(port):
    """``A ~= Qc B`` at the f32 class, and the capture is ``size`` complex
    columns wide (the realified JAX capture came out twice as wide)."""
    a = fixture((150, 100), np.complex64)
    qc, b = port.rt.planar_range_capture(t(a), _gen(port, 7), 40)
    assert tuple(qc.shape) == (150, 40) and tuple(b.shape) == (40, 100)
    assert rel(qc @ b, a) < 1e-4
    g = n(qc).conj().T @ n(qc)
    assert np.abs(g - np.eye(40)).max() < 1e-5


def test_over_deep_rank_clamps_to_numerical_rank(port):
    a = fixture((120, 80), np.complex64)  # sigma to 1e-10 over 80
    cid = port.rt.planar_column_id(t(a), _gen(port, 10), rank=70)
    assert cid.rank < 70   # sigma_70 ~ 10^-8.9 is below the f32 floor
    assert rel(cid.to_mat(), a) < 1e-3
    ts = port.rt.planar_two_sided_id(t(a), _gen(port, 11), rank=70)
    assert rel(ts.to_mat(), a) < 1e-3


def test_real_input_is_promoted_and_stacks_are_refused(port):
    a = low_rank(51, (60, 40), 1e-6, np.float32)
    cid = port.rt.planar_column_id(t(a), _gen(port, 12), rank=10)
    assert cid.c.dtype == port.torch.complex64
    np.testing.assert_array_equal(n(cid.c).real, a[:, n(cid.col_ind)[:10]])
    with pytest.raises(ValueError, match="expected a matrix"):
        port.rt.planar_rsvd(t(a)[None], _gen(port, 12), rank=5)


@pytest.mark.parametrize("shape", SHAPES)
def test_same_class_as_the_jax_planar_ids(port, shape):
    """Same block, same rank: both two-sided IDs inside 100 sigma_k (the
    JAX suite's bound), the port within 10x of the JAX error or of
    sigma_k, and the JAX factors move through ``interop.from_numpy``
    (complex numpy leaves) into the port's container unchanged."""
    from rusty_compression_tpu_torch import interop

    a = fixture(shape, np.complex64)
    k = 30
    want = rc.planar_two_sided_id(a, jax.random.key(6), rank=k)
    got = port.rt.planar_two_sided_id(t(a), _gen(port, 6), rank=k)
    assert got.rank == want.rank == k
    e_jax, e_port = rel(want.to_mat(), a), rel(got.to_mat(), a)
    bound = spectrum_err(shape, k)
    assert e_jax < 100 * bound and e_port < 100 * bound, (e_jax, e_port)
    assert e_port < 10 * max(e_jax, bound), (e_jax, e_port)
    moved = interop.from_numpy(want, device="cpu")
    assert isinstance(moved, port.rt.TwoSidedID)
    assert moved.x.is_complex() and moved.col_ind.dtype == port.torch.int64
    np.testing.assert_allclose(n(moved.to_mat()), np.asarray(want.to_mat()),
                               atol=1e-6)

    jsvd = rc.planar_rsvd(a, jax.random.key(1), rank=k)
    svd = port.rt.planar_rsvd(t(a), _gen(port, 1), rank=k)
    np.testing.assert_allclose(n(svd.s), np.asarray(jsvd.s), rtol=1e-3)


def test_wide_complex_block_on_the_cpu(port):
    """The 8192^2 complex configuration at its small size (1024^2, 96
    singular values to 1e-9, rank 43): the core's QRCP and the LQ of C are
    both wider than 512 and take the blocked route on the CPU. Gates: rel
    err <= 10 sigma_43, skeleton within 1e-3, C bitwise."""
    a = low_rank(68, (1024, 1024), 1e-9, np.complex64, rank=96)
    ts = port.rt.planar_two_sided_id(t(a), _gen(port, 68), rank=43)
    assert ts.rank == 43
    assert rel(ts.to_mat(), a) <= 10 * np.geomspace(1.0, 1e-9, 96)[43]
    skel = a[np.ix_(n(ts.row_ind)[:43], n(ts.col_ind)[:43])]
    assert np.abs(n(ts.x) - skel).max() / np.abs(skel).max() <= 1e-3
    cid = port.rt.planar_column_id(t(a), _gen(port, 68), rank=43)
    np.testing.assert_array_equal(n(cid.c), a[:, n(cid.col_ind)[:43]])


def test_public_names(port):
    from rusty_compression_tpu import planarc as jplanarc

    for name in jplanarc.__all__:
        assert name in port.rt.__all__ and callable(getattr(port.rt, name))
