"""The port's pivoted QR / LQ and the QR, LQ and ID containers held
against the JAX package on the same numpy inputs.

Tolerances: pivots exactly equal; factors to 1e-5 (f32) or 1e-10 (f64)
of each factor's largest entry (same algorithm, another summation order).
Shapes stay at n <= 512, where the JAX package resolves ``"gs"``; the
blocked route has ``test_torch_blocked_qr.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc
from test_torch_parity import low_rank, n, port, t  # noqa: F401 (fixture)

ATOL = {np.float32: 1e-5, np.float64: 1e-10}


def _close(got, want, dtype):
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want,
                               atol=ATOL[dtype] * max(np.abs(want).max(), 1))


@pytest.mark.parametrize("dtype,shape,max_rank", [
    (np.float32, (40, 30), None), (np.float64, (30, 40), 10)])
def test_pivoted_qr_auto_matches_jax(port, dtype, shape, max_rank):
    a = low_rank(10, shape, 1e-2, dtype)
    jq, jr, jind = rc.pivoted_qr(jnp.asarray(a), max_rank=max_rank)
    q, r, ind = port.rt.pivoted_qr(t(a), max_rank=max_rank)
    np.testing.assert_array_equal(n(ind), np.asarray(jind))
    _close(q, jq, dtype)
    _close(r, jr, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pivoted_lq_matches_jax(port, dtype):
    a = low_rank(11, (30, 40), 1e-2, dtype)
    jl, jq, jind = rc.pivoted_lq(jnp.asarray(a), max_rank=10, mode="gs")
    l, q, ind = port.rt.pivoted_lq(t(a), max_rank=10, mode="gs")
    np.testing.assert_array_equal(n(ind), np.asarray(jind))
    _close(l, jl, dtype)
    _close(q, jq, dtype)


@pytest.mark.parametrize("max_rank", [None, 10])
def test_column_id_matches_jax(port, max_rank):
    """Full rank (exact identity Z) and rank-deficient (triangular solve)."""
    a = low_rank(12, (40, 30), 1e-3, np.float64)
    want = rc.QR.compute_from(jnp.asarray(a), max_rank=max_rank).column_id()
    got = port.rt.QR.compute_from(t(a), max_rank=max_rank).column_id()
    np.testing.assert_array_equal(n(got.col_ind), np.asarray(want.col_ind))
    _close(got.c, want.c, np.float64)
    _close(got.z, want.z, np.float64)


@pytest.mark.parametrize("max_rank", [None, 10])
def test_row_id_matches_jax(port, max_rank):
    a = low_rank(13, (30, 40), 1e-3, np.float64)
    want = rc.LQ.compute_from(jnp.asarray(a), max_rank=max_rank).row_id()
    got = port.rt.LQ.compute_from(t(a), max_rank=max_rank).row_id()
    np.testing.assert_array_equal(n(got.row_ind), np.asarray(want.row_ind))
    _close(got.x, want.x, np.float64)
    _close(got.r, want.r, np.float64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_two_sided_id_from_jax_factors(port, dtype):
    """The JAX QR moved through ``interop.from_numpy`` gives the JAX
    two-sided ID, and its skeleton is the submatrix of A."""
    from rusty_compression_tpu_torch import interop

    from test_torch_parity import assert_same_two_sided

    a = low_rank(14, (40, 30), 1e-2, dtype)
    jqr = rc.QR.compute_from(jnp.asarray(a), max_rank=10)
    want = jqr.column_id().two_sided_id()
    got = interop.from_numpy(jqr, device="cpu").column_id().two_sided_id()
    assert_same_two_sided(got, want, ATOL[dtype])
    sk = a[np.ix_(n(got.row_ind[:10]), n(got.col_ind[:10]))]
    np.testing.assert_allclose(n(got.x), sk, atol=1e-4 * np.abs(sk).max())


def test_qr_tolerance_and_range_estimate_match_jax(port):
    a = low_rank(15, (40, 30), 1e-8, np.float64)
    want = rc.QR.compute_from(jnp.asarray(a)).compress_qr_tolerance(1e-4)
    got = port.rt.QR.compute_from(t(a)).compress_qr_tolerance(1e-4)
    assert got.rank == want.rank
    with pytest.raises(port.rt.CompressionError):
        port.rt.QR.compute_from(t(a), max_rank=5).compress_qr_tolerance(1e-6)
    q = np.linalg.qr(a @ np.random.default_rng(0).standard_normal((30, 10)))[0]
    want = rc.QR.compute_from_range_estimate(jnp.asarray(q), jnp.asarray(a))
    got = port.rt.QR.compute_from_range_estimate(t(q), t(a))
    np.testing.assert_array_equal(n(got.ind), np.asarray(want.ind))
    _close(got.to_mat(), want.to_mat(), np.float64)


@pytest.mark.parametrize("dtype,device,m,n_,k,expect", [
    ("float32", "cuda", 24, 16384, 16, "kernel"),   # the 16384^2 sketch
    ("float32", "cuda", 200, 100, 100, "kernel"),   # n <= 128
    ("float32", "cpu", 24, 300, 16, "gs"),
    ("float64", "cuda", 24, 300, 16, "gs"),         # the JAX dtype routing
    ("float32", "cuda", 4096, 100, 100, "kernel"),  # K1 as a grid
    ("float32", "cpu", 24, 2048, 16, "blocked"),
    ("float32", "cuda", 300, 300, 200, "blocked"),
    ("float32", "cuda", 16384, 16384, 16, "blocked"),  # over 12 MiB, wide
    # c64 takes K2 on the card (the JAX package kept complex off its kernel)
    ("complex64", "cuda", 53, 8192, 43, "kernel"),
    ("complex64", "cuda", 43, 8192, 43, "kernel"),
    ("complex64", "cuda", 2048, 100, 100, "kernel"),   # K2 as a grid
    ("complex64", "cpu", 53, 300, 43, "gs"),
    ("complex64", "cpu", 53, 8192, 43, "blocked"),
    ("complex128", "cuda", 53, 300, 43, "gs"),
    ("complex128", "cuda", 53, 8192, 43, "blocked"),
])
def test_resolve_mode_keeps_the_jax_thresholds(port, dtype, device, m, n_, k,
                                              expect):
    from rusty_compression_tpu_torch.ops.pivoted_qr import _resolve_mode

    torch = port.torch
    got = _resolve_mode("auto", m, n_, k, getattr(torch, dtype),
                        torch.device(device))
    assert got == expect


@pytest.mark.parametrize("dtype,m,n_,k", [
    ("float32", 2048, 2048, 16),     # a whole block of the 2048^2 stack
    ("complex64", 1024, 1024, 16),   # a whole block of a c64 stack
])
def test_auto_takes_the_jax_route_for_whole_blocks(port, dtype, m, n_, k):
    """A working set over the JAX package's 12 MiB bound goes blocked on
    the card, as ``_pallas_fits`` sends it there, though Q fits K1/K2."""
    from rusty_compression_tpu_torch.ops.kernels.qrcp import kernel_fits
    from rusty_compression_tpu_torch.ops.pivoted_qr import _resolve_mode

    dt = getattr(port.torch, dtype)
    assert kernel_fits(m, k, dt.itemsize)
    assert _resolve_mode("auto", m, n_, k, dt,
                         port.torch.device("cuda")) == "blocked"


@pytest.mark.parametrize("dtype,m,n_,k", [
    ("float32", 24, 16384, 16), ("float32", 16, 16384, 16),
    ("float32", 24, 2048, 16), ("float32", 136, 256, 128),
    ("float32", 72, 1024, 64), ("float32", 80, 144, 72),
    ("complex64", 53, 8192, 43), ("complex64", 43, 8192, 43),
    ("complex64", 37, 1024, 27), ("complex64", 27, 1024, 27),
    ("complex64", 35, 1024, 27),
])
def test_auto_keeps_the_kernel_on_held_panels(port, dtype, m, n_, k):
    """Every panel ``chip_smoke.py`` phase 2 holds stays on the kernel:
    through ``_resolve_mode`` at small rank or width, else as the pivot
    rule of the blocked RRQR's shortlist."""
    from rusty_compression_tpu_torch.ops.pivoted_qr import (
        _pivot_rule, _resolve_mode, _working_set_fits)

    torch = port.torch
    dt, cuda = getattr(torch, dtype), torch.device("cuda")
    assert _working_set_fits(m, n_, k, dt.itemsize)
    if k <= 64 or n_ <= 128:
        assert _resolve_mode("auto", m, n_, k, dt, cuda) == "kernel"
    else:
        assert _pivot_rule("auto", dt, cuda) == "kernel"
