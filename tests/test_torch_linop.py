"""The operator family of the port held against the JAX package's: factor
containers as operators, ``matvec`` closures, the combinators, sparse
matrices, and the coercions of ``as_linear_operator``.

The same numpy matrices go into both packages. Products agree to 1e-12
(f64/c128) or 1e-5 (f32/c64) of the largest entry: one or two GEMMs in
another summation order. The JAX side comes from
``tests/torch_refs/test_torch_linop.npz`` (``make_refs.py``), but for the
``matvec`` closures, which run live.
"""

import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc
from test_torch_parity import jax_sketch, low_rank, n, port, t  # noqa: F401
from torch_refs import Refs
from torch_threads import one_thread  # noqa: F401 (autouse)

refs = Refs(__file__)


def close(got, want, dtype=np.float64):
    want = np.asarray(want)
    tol = 1e-5 if np.dtype(dtype).itemsize <= 8 and np.dtype(dtype) in (
        np.dtype(np.float32), np.dtype(np.complex64)) else 1e-12
    np.testing.assert_allclose(n(got), want, atol=tol * np.abs(want).max())


def probes(shape, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((shape[1], 3)).astype(dtype)
    y = rng.standard_normal((shape[0], 3)).astype(dtype)
    return x, y


# -- factor containers ------------------------------------------------------


@pytest.mark.parametrize("kind", ["SVD", "ColumnID", "TwoSidedID"])
def test_factored_operator_matches_jax(port, kind):
    from rusty_compression_tpu_torch import interop

    a = low_rank(110, (60, 45), 1e-8, np.float64)
    x, y = probes((60, 45))

    def jax_side():
        jqr = rc.QR.compute_from(jnp.asarray(a), max_rank=20)
        factors = {"SVD": lambda: rc.SVD.compute_from(jnp.asarray(a)),
                   "ColumnID": jqr.column_id,
                   "TwoSidedID": lambda: jqr.column_id().two_sided_id()}[
            kind]()
        op = rc.as_linear_operator(factors)
        return {"type": type(op).__name__, "shape": op.shape,
                "matmat": op.matmat(jnp.asarray(x)),
                "conj_matmat": op.conj_matmat(jnp.asarray(y)),
                "to_dense": op.to_dense(),
                **{f"factor {f.name}": getattr(factors, f.name)
                   for f in dataclasses.fields(factors)}}

    want = refs(f"factored {kind}", (a, x, y), jax_side)
    # the JAX container, rebuilt from its stored leaves (nothing runs)
    factors = getattr(rc, kind)(**{
        name.split(" ", 1)[1]: v for name, v in want.items()
        if name.startswith("factor ")})
    got = port.rt.as_linear_operator(interop.from_numpy(factors,
                                                        device="cpu"))
    assert type(got).__name__ == str(want["type"]) == "FactoredOperator"
    assert got.shape == tuple(want["shape"]) == (60, 45)
    assert got.dtype == port.torch.float64 and got.batch_shape == ()
    assert got.has_cheap_dense()
    close(got.matmat(t(x)), want["matmat"])
    close(got.conj_matmat(t(y)), want["conj_matmat"])
    close(got.to_dense(), want["to_dense"])


def test_factored_operator_rejects_non_container(port):
    with pytest.raises(TypeError, match="not a factorization container"):
        port.rt.FactoredOperator(object())


def test_recompress_a_two_sided_id_matrix_free(port):
    """``TestFactoredOperator.test_recompress_two_sided_id_matrix_free``:
    the rank-60 factored form goes back through the adaptive SVD."""
    torch, rt = port.torch, port.rt
    g = torch.Generator().manual_seed(0)
    a = rt.random_approximate_low_rank_matrix(g, (200, 150), 1.0, 1e-10)
    tsid = rt.QR.compute_from(a, max_rank=60).column_id().two_sided_id()
    op = rt.as_linear_operator(tsid)
    svd, _ = rt.randomized_adaptive_svd(op, g, rel_tol=1e-3, sample_size=10)
    assert svd.rank <= 60
    assert float(rt.rel_diff_fro(svd.to_mat(), a)) < 5e-3


# -- matvec closures --------------------------------------------------------


def function_ops(port, a, with_adjoint=True):
    ta, ja = t(a), jnp.asarray(a)
    got = port.rt.FunctionOperator(
        lambda v: ta @ v, a.shape, dtype=ta.dtype, device="cpu",
        conj_matvec=(lambda v: ta.mH @ v) if with_adjoint else None)
    want = rc.FunctionOperator(
        lambda v: ja @ v, a.shape, dtype=ja.dtype,
        conj_matvec=(lambda v: jnp.conj(ja).T @ v) if with_adjoint else None)
    return got, want


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_function_operator_matches_jax(port, dtype):
    a = low_rank(111, (50, 40), 1e-6, dtype)
    got, want = function_ops(port, a)
    x, y = probes(a.shape, dtype)
    close(got.matmat(t(x)), want.matmat(jnp.asarray(x)), dtype)
    close(got.conj_matmat(t(y)), want.conj_matmat(jnp.asarray(y)), dtype)
    close(got.matvec(t(x[:, 0])), want.matvec(jnp.asarray(x[:, 0])), dtype)
    close(got.conj_matvec(t(y[:, 0])),
          want.conj_matvec(jnp.asarray(y[:, 0])), dtype)
    assert got.shape == want.shape and not got.has_cheap_dense()
    close(got.to_dense(), a, dtype)


def test_function_operator_defaults(port):
    """f32 where no dtype is given, as in the JAX package; the card where
    no device is given."""
    sig = inspect.signature(port.rt.FunctionOperator.__init__)
    assert sig.parameters["device"].default == "cuda"
    op = port.rt.FunctionOperator(lambda v: v, (4, 4), device="cpu")
    assert op.dtype == port.torch.float32
    assert rc.FunctionOperator(lambda v: v, (4, 4)).dtype == jnp.float32


def test_function_operator_without_adjoint(port):
    """``sample_range_by_rank`` needs no adjoint; what needs it raises the
    named error, in both packages."""
    torch, rt = port.torch, port.rt
    a = low_rank(112, (150, 100), 1e-10, np.float64)
    got, want = function_ops(port, a, with_adjoint=False)
    g = torch.Generator().manual_seed(2)
    q = rt.sample_range_by_rank(got, g, 30)
    ta = t(a)
    err = torch.linalg.norm(ta - q @ (q.mT @ ta)) / torch.linalg.norm(ta)
    assert float(err) < 5 * 10 ** (-10 * 30 / 99)
    with pytest.raises(NotImplementedError, match="conj_matvec"):
        got.conj_matmat(torch.ones((150, 3), dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="conj_matvec"):
        rt.sample_range_adaptive(got, g, 1e-5, sample_size=10)

    def jax_side():  # the JAX package's messages
        out = {}
        for name, call in (
                ("conj_matmat", lambda: want.conj_matmat(jnp.ones((150, 3)))),
                ("sample", lambda: rc.sample_range_adaptive(
                    want, jax.random.key(5), 1e-5, sample_size=10))):
            try:
                call()
                out[name] = "no error"
            except NotImplementedError as ex:
                out[name] = f"NotImplementedError: {ex}"
        return out

    raised = refs("without adjoint", a, jax_side)
    for name in ("conj_matmat", "sample"):
        assert re.match("NotImplementedError: .*conj_matvec",
                        str(raised[name])), raised[name]


def test_function_operator_through_the_samplers(port):
    """``TestFunctionOperator``: adaptive sampling, the range-estimate SVD
    and power iteration on closures."""
    torch, rt = port.torch, port.rt
    a = low_rank(113, (150, 100), 1e-10, np.float64)
    op, _ = function_ops(port, a)
    g = torch.Generator().manual_seed(3)
    q, residuals = rt.sample_range_adaptive(op, g, 1e-5, sample_size=10)
    assert residuals[-1][1] < 1e-5
    svd = rt.SVD.compute_from_range_estimate(q, op)
    assert float(rt.rel_diff_fro(svd.to_mat(), t(a))) < 5e-5
    q = rt.sample_range_power_iteration(op, g, 30, it_count=2)
    ta = t(a)
    err = torch.linalg.norm(ta - q @ (q.mT @ ta)) / torch.linalg.norm(ta)
    assert float(err) < 5 * 10 ** (-10 * 30 / 99)


def test_function_operator_lets_vmap_raise(port):
    """A closure that ``torch.func.vmap`` cannot transform (a branch on a
    tensor's value) is not caught."""
    torch = port.torch

    def bad(v):
        return v if float(v.sum()) > 0 else -v

    op = port.rt.FunctionOperator(bad, (4, 4), torch.float64, device="cpu")
    with pytest.raises(RuntimeError):
        op.matmat(torch.eye(4, dtype=torch.float64))


# -- combinators ------------------------------------------------------------


def combinators(ns, b, c):
    """The same expressions in either package's namespace ``ns``."""
    B, C = ns.as_linear_operator(b), ns.as_linear_operator(c)
    return {
        "composite": B @ C.H,
        "sum": B + C,
        "sum_of_three": ns.SumOperator(B, C, B),
        "scaled": 3.0 * B,
        "scaled_right": B * 0.5,
        "scaled_complex": (2.0 + 1.0j) * B,
        "adjoint": B.H,
        "adjoint_twice": B.H.H,
        "nested": 0.5 * (B + C) @ C.H,
    }


@pytest.mark.parametrize("kind", [
    "composite", "sum", "sum_of_three", "scaled", "scaled_right",
    "scaled_complex", "adjoint", "adjoint_twice", "nested"])
def test_combinators_match_jax(port, kind):
    rng = np.random.default_rng(114)
    b, c = rng.standard_normal((2, 30, 20))
    got = combinators(port.rt, t(b), t(c))[kind]
    cplx = kind == "scaled_complex"
    x, y = probes(got.shape, np.complex128 if cplx else np.float64)

    def jax_side():
        op = combinators(rc, jnp.asarray(b), jnp.asarray(c))[kind]
        return {"type": type(op).__name__, "shape": op.shape,
                "matmat": op.matmat(jnp.asarray(x)),
                "conj_matmat": op.conj_matmat(jnp.asarray(y)),
                "to_dense": op.to_dense()}

    want = refs(f"combinator {kind}", (b, c, x, y), jax_side)
    assert type(got).__name__ == str(want["type"])
    assert got.shape == tuple(want["shape"])
    assert got.dtype == (port.torch.complex128 if cplx
                         else port.torch.float64)
    close(got.matmat(t(x)), want["matmat"])
    close(got.conj_matmat(t(y)), want["conj_matmat"])
    close(got.to_dense(), want["to_dense"])


def test_combinator_checks(port):
    torch, rt = port.torch, port.rt
    b = rt.as_linear_operator(torch.randn(8, 4))
    with pytest.raises(ValueError, match="cannot compose"):
        _ = b @ b
    with pytest.raises(ValueError, match="shape mismatch"):
        _ = b + b.H
    with pytest.raises(ValueError, match="at least one term"):
        rt.SumOperator()
    with pytest.raises(ValueError, match="scalar"):
        rt.ScaledOperator(torch.ones(2), b)
    x = torch.randn(4, 2)
    assert torch.equal(b @ x, b.matmat(x))      # a tensor: the product
    mixed = rt.as_linear_operator(torch.randn(8, 4, dtype=torch.float64)) + b
    assert mixed.dtype == torch.float64          # promotion, as result_type


def test_combinators_feed_the_range_finder(port):
    """``test_combinators_jit_and_sample``."""
    torch, rt = port.torch, port.rt
    b = t(low_rank(115, (60, 60), 1e-8, np.float64))
    op = 0.5 * (rt.as_linear_operator(b) + rt.as_linear_operator(b))
    q = rt.range_finder(op, torch.Generator().manual_seed(1), 20,
                        power_iters=1)
    resid = torch.linalg.norm(b - q @ (q.mT @ b)) / torch.linalg.norm(b)
    assert float(resid) < 1e-2


# -- sparse -----------------------------------------------------------------


def sparse_matrix(dtype, shape=(60, 40), count=120, seed=0):
    rng = np.random.default_rng(seed)
    dense = np.zeros(shape, dtype)
    idx = rng.integers(0, shape, (count, 2))
    vals = rng.standard_normal(count)
    if np.issubdtype(dtype, np.complexfloating):
        vals = vals + 1j * rng.standard_normal(count)
    dense[idx[:, 0], idx[:, 1]] = vals
    return dense


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
def test_sparse_operator_matches_jax(port, dtype):
    from jax.experimental import sparse as jsparse

    dense = sparse_matrix(dtype)
    x, y = probes(dense.shape, dtype)

    def jax_side():
        op = rc.SparseOperator(jsparse.BCOO.fromdense(jnp.asarray(dense)))
        return {"shape": op.shape, "matmat": op.matmat(jnp.asarray(x)),
                "conj_matmat": op.conj_matmat(jnp.asarray(y))}

    want = refs(f"sparse {np.dtype(dtype).name}", (dense, x, y), jax_side)
    got = port.rt.SparseOperator(t(dense).to_sparse_coo())
    assert got.shape == tuple(want["shape"]) and got.has_cheap_dense()
    assert got.a.is_sparse and got.a._nnz() == np.count_nonzero(dense)
    close(got.matmat(t(x)), want["matmat"], dtype)
    close(got.conj_matmat(t(y)), want["conj_matmat"], dtype)
    close(got.conj_matmat(t(y)), dense.conj().T @ y, dtype)
    np.testing.assert_array_equal(n(got.to_dense()), dense)


@pytest.mark.parametrize("source", ["scipy_csr", "scipy_coo_array",
                                    "torch_csr", "torch_coo", "dense"])
def test_sparse_coercions(port, source):
    """Where the JAX package takes a BCOO matrix, the port takes a torch
    sparse tensor of any layout or a scipy.sparse matrix."""
    import scipy.sparse as sp
    from jax.experimental import sparse as jsparse

    torch, rt = port.torch, port.rt
    dense = sparse_matrix(np.float64)
    make = {"scipy_csr": lambda: sp.csr_matrix(dense),
            "scipy_coo_array": lambda: sp.coo_array(dense),
            "torch_csr": lambda: t(dense).to_sparse_csr(),
            "torch_coo": lambda: t(dense).to_sparse_coo(),
            "dense": lambda: t(dense)}[source]
    op = (rt.SparseOperator(make()) if source == "dense"
          else rt.as_linear_operator(make(), device="cpu"))
    assert type(op).__name__ == "SparseOperator"
    jax_type = refs("bcoo coercion", np.eye(6), lambda: {"type": type(
        rc.as_linear_operator(jsparse.BCOO.fromdense(jnp.eye(6)))).__name__})
    assert str(jax_type["type"]) == "SparseOperator"
    assert op.device.type == "cpu" and op.dtype == torch.float64
    x, y = probes(dense.shape)
    close(op.matmat(t(x)), dense @ x)
    close(op.conj_matmat(t(y)), dense.T @ y)
    with pytest.raises(ValueError, match="sparse matrix"):
        rt.SparseOperator(torch.zeros(2, 3, 4))


def test_sparse_plus_low_rank_compression(port):
    """``test_sparse_plus_lowrank_compression``: a near field below the
    tolerance plus a rank-12 far field compresses to the far field's
    rank."""
    torch, rt = port.torch, port.rt
    size = 120
    near = 1e-9 * sparse_matrix(np.float64, (size, size), 200, seed=1)
    g = torch.Generator().manual_seed(2)
    far = rt.SVD.compute_from(rt.random_approximate_low_rank_matrix(
        g, (size, size), 1.0, 1e-12)).compress_svd_rank(12)
    op = rt.SparseOperator(t(near)) + rt.as_linear_operator(far)
    assert type(op).__name__ == "SumOperator"
    q, _ = rt.sample_range_adaptive(op, g, 1e-5, 6)
    assert q.shape[1] <= 24
    dense = t(near) + far.to_mat()
    resid = torch.linalg.norm(dense - q @ (q.mT @ dense)) \
        / torch.linalg.norm(dense)
    assert float(resid) < 1e-4


# -- coercion and the selector gather ---------------------------------------


def test_as_linear_operator_refuses_what_it_cannot_read(port):
    rt = port.rt
    with pytest.raises(TypeError, match="cannot interpret"):
        rt.as_linear_operator(object())
    with pytest.raises(TypeError, match="cannot interpret"):
        rt.as_linear_operator(port.torch.zeros(3))  # not a matrix
    qr = rt.QR.compute_from(port.torch.eye(4))
    with pytest.raises(TypeError, match="QR/LQ containers"):
        rt.as_linear_operator(qr)
    op = rt.DenseOperator(port.torch.eye(3))
    assert rt.as_linear_operator(op) is op
    assert rt.as_linear_operator(np.eye(3), device="cpu").shape == (3, 3)


def test_host_inputs_default_to_the_card(port):
    """A numpy array or a scipy.sparse matrix is put on the card unless the
    caller asks for the CPU (the defaults are read from the signatures:
    there is no card here); ``compress`` puts one on its generator's
    device."""
    import scipy.sparse as sp

    torch, rt = port.torch, port.rt
    for fn in (rt.SparseOperator.__init__, rt.as_linear_operator):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    dense = sparse_matrix(np.float64)
    for host in (sp.csr_matrix(dense), dense):
        op = rt.SparseOperator(host, device="cpu")
        assert op.device.type == "cpu" and op.a.is_sparse
        np.testing.assert_array_equal(n(op.to_dense()), dense)
    # a tensor is taken where it lies, whatever ``device`` says
    assert rt.SparseOperator(t(dense).to_sparse_coo()).device.type == "cpu"
    assert rt.as_linear_operator(t(dense)).device.type == "cpu"
    g = torch.Generator().manual_seed(0)
    cfg = rt.CompressionConfig.RANK(4)
    for host in (sp.csr_matrix(dense), dense):
        assert rt.compress(host, g, cfg).u.device == g.device


def test_sketched_column_id_gathers_by_selector_product(port):
    """An operator without a cheap dense view: the k columns of C come
    from ONE product with a one-hot selector (n, k), never from
    ``to_dense()``; the result equals the JAX package's on the same
    sketch (pivots equal, factors to 1e-10)."""
    from rusty_compression_tpu_torch.sampling import (
        _sketched_column_id_from_sketch)

    a = low_rank(116, (90, 70), 1e-8, np.float64)
    op, jop = function_ops(port, a)
    widths = []
    matmat = op.matmat
    op.matmat = lambda x: widths.append(x.shape) or matmat(x)
    op.to_dense = None  # must not be called
    def jax_side():
        key = jax.random.key(117)
        cid = rc.sketched_column_id(jop, key, rank=12)
        return {"col_ind": cid.col_ind, "c": cid.c, "z": cid.z,
                "g_h": jax_sketch(key, 90, 20, np.float64)}

    want = refs("sketched column id", a, jax_side)
    got = _sketched_column_id_from_sketch(op, t(want["g_h"]), 12)
    assert widths == [(70, 12)]
    np.testing.assert_array_equal(n(got.col_ind), want["col_ind"])
    close(got.c, want["c"])
    np.testing.assert_allclose(n(got.z), want["z"], atol=1e-10)
    np.testing.assert_array_equal(n(got.c), a[:, n(got.col_ind[:12])])
