"""The port's tol <= 1e-8 interpolative decompositions (``highacc_id.py``,
native f64/c128) held against the JAX package's.

The deterministic tails get the same f64/c128 input on both sides: the
pivoted QR of a core (the port's rule against LAPACK ``?geqp3``: pivots
equal up to the rank on cores with distinct column norms), the truncation
rank, the interpolation coefficients, the column ID of a core and the row
ID of skeleton columns, with factors within 1e-12 of their largest entry.
End to end the two capture from different random matrices and are held to
their contracts: rel err <= 5 tol (two-sided: 10 tol), ranks within 2 of
each other, skeletons bitwise A's entries. The JAX package's end-to-end
results come from ``tests/torch_refs/test_torch_highacc_id.npz``
(``make_refs.py``); its deterministic tails run live.
"""

import types

import jax
import numpy as np
import pytest
import scipy.linalg

from rusty_compression_tpu import highacc_id as jhid
from rusty_compression_tpu.utils.errors import CompressionError as JaxError
from test_torch_highacc import (A_CPLX, A_REAL, TOL, core_of,  # noqa: F401
                                crossing, decaying, flat, gen)
from test_torch_parity import n, port, t  # noqa: F401
from torch_refs import Refs
from torch_threads import one_thread  # noqa: F401 (autouse)

refs = Refs(__file__)


@pytest.fixture(scope="module")
def jax_ids():
    """The JAX package's IDs of the module's inputs (stored): their
    factors and rank."""
    key = jax.random.key(1)
    calls = {
        "column": lambda: jhid.refined_column_id(A_REAL, key, tol=TOL),
        "col": lambda: jhid.refined_two_sided_id(A_REAL, key, tol=TOL,
                                                 side="col"),
        "row": lambda: jhid.refined_two_sided_id(A_REAL, key, tol=TOL,
                                                 side="row"),
        "complex": lambda: jhid.refined_column_id(A_CPLX, key, tol=TOL),
    }

    def fields(call):
        out = call()
        names = ("c", "z") if hasattr(out, "z") else ("c", "x", "r")
        return {"rank": out.rank,
                **{name: np.asarray(getattr(out, name)) for name in names}}

    return {name: types.SimpleNamespace(**{
        k: (int(v) if k == "rank" else v)
        for k, v in refs(name, (A_REAL, A_CPLX),
                         lambda c=call: fields(c)).items()})
        for name, call in calls.items()}


def rel_fro(x, a):
    return float(np.linalg.norm(x - a) / np.linalg.norm(a))


def assert_close(got, want):
    """Within 1e-12 of the largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The deterministic tails
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("width", [56, 70])
def test_core_pivots_match_geqp3(port, complex_, width):
    q, b = core_of(A_CPLX if complex_ else A_REAL, width)
    _, r, piv = jhid._host_qrcp(b)
    rb, ind = port.rt.highacc_id._core_qrcp(t(b))
    kf = jhid._truncation_rank(np.diagonal(r), TOL, None, False)
    np.testing.assert_array_equal(n(ind)[:kf], piv[:kf])
    np.testing.assert_array_equal(np.sort(n(ind)), np.arange(b.shape[1]))
    d, dw = np.abs(np.diagonal(n(rb))), np.abs(np.diagonal(r))
    np.testing.assert_allclose(d[:kf], dw[:kf], rtol=0, atol=1e-12 * dw[0])
    assert np.array_equal(n(rb), np.triu(n(rb)))


def test_the_downdated_rule_loses_the_pivots(port):
    """Why ``_core_qrcp`` recomputes its norms: the plain rule (downdated
    norms, ``pivoted_qr(mode="gs")``) leaves ``?geqp3``'s pivots before the
    rank on this core, the port's rule does not."""
    _, b = core_of(A_REAL, 70)
    _, r, piv = jhid._host_qrcp(b)
    kf = jhid._truncation_rank(np.diagonal(r), TOL, None, False)
    plain = n(port.rt.pivoted_qr(t(b), mode="gs")[2])
    ours = n(port.rt.highacc_id._core_qrcp(t(b))[1])
    assert np.array_equal(ours[:kf], piv[:kf])
    assert not np.array_equal(plain[:kf], piv[:kf])


@pytest.mark.parametrize("diag,tol,rank,captured", [
    ([1, 1e-3, 1e-9, 1e-4, 1e-6, 1e-10, 1e-12], 1e-8, None, False),
    ([1, 1e-3, 1e-9, 1e-4, 1e-6, 1e-10, 1e-12], 1e-8, 2, False),
    (list(np.geomspace(1, 1e-5, 10)), 1e-8, None, False),
    (list(np.geomspace(1, 1e-5, 10)), 1e-8, None, True),
    (list(np.geomspace(1, 1e-12, 30)), 1e-8, None, False),
    (list(np.geomspace(1, 1e-12, 30)), None, 7, False),
    ([-2.0, 1.0, -1e-9, 0.0], 1e-8, None, False)])
def test_truncation_rank_matches_jax(port, diag, tol, rank, captured):
    d = np.asarray(diag, dtype=np.float64)
    try:
        want = jhid._truncation_rank(d, tol, rank, captured)
    except JaxError:
        with pytest.raises(port.rt.CompressionError):
            port.rt.highacc_id._truncation_rank(t(d), tol, rank, captured)
        return
    assert port.rt.highacc_id._truncation_rank(t(d), tol, rank,
                                               captured) == want


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("kf", [12, 30, 70])
def test_interp_coefficients_match_jax(port, complex_, kf):
    _, b = core_of(A_CPLX if complex_ else A_REAL, 70)
    _, r, piv = jhid._host_qrcp(b)
    want = jhid._interp_coefficients(r, piv, kf, b.shape[1])
    got = port.rt.highacc_id._interp_coefficients(t(r), t(piv), kf,
                                                  b.shape[1])
    assert_close(got, want)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("tol,rank", [(TOL, None), (None, 25), (1e-5, None)])
def test_column_id_from_core_matches_jax(port, complex_, tol, rank):
    a = A_CPLX if complex_ else A_REAL
    _, b = core_of(a, 70)
    want = jhid._column_id_from_core(a, b, tol, rank, False)
    got = port.rt.highacc_id._column_id_from_core(t(a), t(b), tol, rank,
                                                  False)
    assert got.rank == want.rank
    np.testing.assert_array_equal(n(got.col_ind)[:got.rank],
                                  want.col_ind[:want.rank])
    np.testing.assert_array_equal(n(got.c), want.c)
    assert_close(got.z, want.z)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("tol,rank", [(None, 20), (TOL, None)])
def test_row_id_of_columns_matches_jax(port, complex_, tol, rank):
    """Pivots equal up to the rank. X agrees to 1e-12 where C is well
    conditioned (rank 20); at the tolerance's rank cond(C) is ~1e8, X is
    determined only to ~1e-8 and both packages reconstruct C to 1e-12."""
    a = A_CPLX if complex_ else A_REAL
    _, b = core_of(a, 70)
    cid = jhid._column_id_from_core(a, b, tol, rank, False)
    x, pivr = jhid._host_row_id_of_columns(cid.c)
    got_x, got_piv = port.rt.highacc_id._host_row_id_of_columns(t(cid.c))
    kf = cid.rank
    np.testing.assert_array_equal(n(got_piv)[:kf], pivr[:kf])
    if rank is not None:
        assert_close(got_x, x)
    for xx, piv in ((n(got_x), n(got_piv)), (x, pivr)):
        assert_close(xx @ cid.c[piv[:kf]], cid.c)


# ---------------------------------------------------------------------------
# End to end against the JAX package
# ---------------------------------------------------------------------------


def test_column_id_matches_jax(port, jax_ids):
    want = jax_ids["column"]
    got = port.rt.refined_column_id(t(A_REAL), gen(port), tol=TOL)
    assert rel_fro(np.asarray(want.c) @ want.z, A_REAL) <= 5 * TOL
    assert rel_fro(n(got.c) @ n(got.z), A_REAL) <= 5 * TOL
    assert abs(got.rank - want.rank) <= 2
    assert crossing(60) - 2 <= got.rank <= crossing(60) + 8
    ind = n(got.col_ind)
    np.testing.assert_array_equal(n(got.c), A_REAL[:, ind[:got.rank]])
    assert got.c.dtype == got.z.dtype == port.torch.float64


@pytest.mark.parametrize("side", ["col", "row"])
def test_two_sided_id_matches_jax(port, jax_ids, side):
    want = jax_ids[side]
    got = port.rt.refined_two_sided_id(t(A_REAL), gen(port), tol=TOL,
                                       side=side)
    assert rel_fro(np.asarray(want.c) @ want.x @ want.r, A_REAL) <= 10 * TOL
    assert rel_fro(n(got.c) @ n(got.x) @ n(got.r), A_REAL) <= 10 * TOL
    assert abs(got.rank - want.rank) <= 2
    ri, ci = n(got.row_ind)[:got.rank], n(got.col_ind)[:got.rank]
    np.testing.assert_array_equal(n(got.x), A_REAL[ri[:, None], ci])


def test_complex_column_id_matches_jax(port, jax_ids):
    want = jax_ids["complex"]
    got = port.rt.refined_column_id(A_CPLX, gen(port), tol=TOL)
    assert got.c.dtype == port.torch.complex128
    assert rel_fro(np.asarray(want.c) @ want.z, A_CPLX) <= 5 * TOL
    assert rel_fro(n(got.c) @ n(got.z), A_CPLX) <= 5 * TOL
    assert abs(got.rank - want.rank) <= 2
    ind = n(got.col_ind)
    np.testing.assert_array_equal(n(got.c), A_CPLX[:, ind[:got.rank]])


# ---------------------------------------------------------------------------
# Contracts of tests/test_highacc_id.py, on the port
# ---------------------------------------------------------------------------


def test_row_id_rows_bitwise(port):
    a = decaying(5, 256, 192, decay_rank=80)
    rid = port.rt.refined_row_id(t(a), gen(port), tol=TOL)
    assert rel_fro(n(rid.x) @ n(rid.r), a) <= 5 * TOL
    np.testing.assert_array_equal(n(rid.r), a[n(rid.row_ind)[:rid.rank]])


def test_complex_row_id_adjoint_convention(port):
    a = decaying(6, 180, 220, decay_rank=50, complex_=True)
    rid = port.rt.refined_row_id(a, gen(port), tol=1e-6)
    assert rel_fro(n(rid.x) @ n(rid.r), a) <= 5e-6
    assert not rid.x.is_conj()


@pytest.mark.parametrize("side", ["col", "row"])
def test_complex_two_sided_skeleton_bitwise(port, side):
    a = decaying(9, 160, 140, decay_rank=50, complex_=True)
    ts = port.rt.refined_two_sided_id(t(a), gen(port), tol=TOL, side=side)
    assert rel_fro(n(ts.c) @ n(ts.x) @ n(ts.r), a) <= 10 * TOL
    ri, ci = n(ts.row_ind)[:ts.rank], n(ts.col_ind)[:ts.rank]
    np.testing.assert_array_equal(n(ts.x), a[ri[:, None], ci])


@pytest.mark.parametrize("side", ["col", "row"])
def test_fixed_rank_two_sided_id(port, side):
    a = decaying(10, 256, 256, decay_rank=60)
    ts = port.rt.refined_two_sided_id(t(a), gen(port), rank=30, side=side)
    assert ts.rank == 30
    s = np.linalg.svd(a, compute_uv=False)
    e_opt = np.sqrt((s[30:] ** 2).sum() / (s ** 2).sum())
    assert rel_fro(n(ts.c) @ n(ts.x) @ n(ts.r), a) <= 20 * e_opt


def test_unreachable_tolerance_and_bad_side(port):
    with pytest.raises(port.rt.CompressionError):
        port.rt.refined_column_id(t(flat(3, 96)), gen(port), tol=1e-10)
    with pytest.raises(ValueError):
        port.rt.refined_two_sided_id(t(A_REAL), gen(port), rank=10,
                                     side="diag")


def test_hilbert_config_2h_small(port):
    """Config 2h at 256: rel err <= 5e-8, columns bitwise, the core's
    pivots up to the rank equal to ``?geqp3``'s on the same core."""
    from rusty_compression_tpu_torch.utils.kernel_matrices import hilbert

    h = hilbert(256, dtype=port.torch.float64, device="cpu")
    cid = port.rt.refined_column_id(h, gen(port), tol=TOL)
    hn = n(h)
    assert rel_fro(n(cid.c) @ n(cid.z), hn) <= 5 * TOL
    np.testing.assert_array_equal(n(cid.c), hn[:, n(cid.col_ind)[:cid.rank]])
    _, b, _, _ = port.rt.refined_capture(h, gen(port), tol=TOL)
    _, _, piv = scipy.linalg.qr(n(b), mode="economic", pivoting=True)
    _, ind = port.rt.highacc_id._core_qrcp(b)
    np.testing.assert_array_equal(n(ind)[:cid.rank], piv[:cid.rank])


def test_reference_example_parity(port):
    """examples/interpolative_decomposition.rs: 500 x 100, geomspace(1,
    1e-10) over 100, two-sided ID at rank 20 within 10 x optimal."""
    rng = np.random.default_rng(42)
    sig = np.geomspace(1.0, 1e-10, 100)
    u, _ = np.linalg.qr(rng.standard_normal((500, 100)))
    v, _ = np.linalg.qr(rng.standard_normal((100, 100)))
    a = (u * sig) @ v.T
    ts = port.rt.refined_two_sided_id(t(a), gen(port), rank=20)
    e_opt = np.sqrt((sig[20:] ** 2).sum() / (sig ** 2).sum())
    assert rel_fro(n(ts.c) @ n(ts.x) @ n(ts.r), a) <= 10 * e_opt
    np.testing.assert_array_equal(
        n(ts.x), a[n(ts.row_ind)[:20][:, None], n(ts.col_ind)[:20]])
