"""Randomized range sampling, the adaptive range finder, generalized
Nyström and one-read sketched IDs (port of
``rusty_compression_tpu.sampling``).

* ``sample_range_by_rank`` — one sketch GEMM + truncated pivoted QR.
* ``sample_range_power_iteration`` — subspace iteration with a
  re-orthonormalization after each half step (the documented semantics:
  each iteration refines the previous iterate).
* ``range_finder`` — HMT range finder: Gaussian sketch, power
  iterations, unpivoted orthonormalization; keeps all ``size`` columns.
* ``adaptive_range_finder`` / ``sample_range_adaptive`` — HMT blocked
  adaptive sampling to a relative tolerance with the 10·sqrt(2/pi)
  probabilistic factor, two block Gram–Schmidt passes and the residual
  history; ``randomized_adaptive_qr`` / ``randomized_adaptive_svd``
  factorize what it found.
* ``nystrom_svd`` — single-pass generalized Nyström SVD.
* ``sketched_column_id`` / ``sketched_row_id`` / ``sketched_two_sided_id``
  — interpolative decompositions from ONE read of the operator: QRCP of a
  row sketch picks the columns and the coefficients, then a k-column
  gather.

Everything touches the operator only through ``matmat`` / ``conj_matmat``.
Each entry point draws its Gaussian matrices from the ``torch.Generator``
it is given and hands them to an inner ``_..._from_omega(s)`` /
``_..._from_sketch`` function that takes the matrices, so that a test can
feed the JAX package's own draws. Operators with a leading batch axis
(``DenseOperator`` of a (B, m, n) stack) get one independent Gaussian
matrix per block.
"""

from __future__ import annotations

import contextlib
import math

import torch

from .linop import AdjointOperator, LinearOperator, as_linear_operator
from .ops.orthogonalize import cholesky_qr2, orthonormalize
from .ops.pivoted_qr import pivoted_qr
from .ops.svd import compute_svd
from .ops.triangular import triangular_solve
from .utils.dtypes import eps, herm, real_dtype
from .utils.precision import matmul_precision, with_precision
from .utils.profiling import span
from .utils.random_matrix import random_gaussian

__all__ = [
    "HMT_TOL_FACTOR",
    "max_col_norm",
    "range_finder",
    "sample_range_by_rank",
    "sample_range_power_iteration",
    "sample_range_adaptive",
    "adaptive_range_finder",
    "randomized_adaptive_qr",
    "randomized_adaptive_svd",
    "nystrom_svd",
    "sketched_column_id",
    "sketched_row_id",
    "sketched_two_sided_id",
]

#: HMT probabilistic bound factor 10 * sqrt(2/pi) (Halko–Martinsson–Tropp
#: §4.3).
HMT_TOL_FACTOR = 10.0 * math.sqrt(2.0 / math.pi)


def max_col_norm(a: torch.Tensor) -> torch.Tensor:
    """Maximum Euclidean column norm over the last two axes."""
    return torch.linalg.vector_norm(a, dim=-2).amax(-1)


def _gaussian_for(op: LinearOperator, generator: torch.Generator, rows: int,
                  cols: int) -> torch.Tensor:
    """One (rows, cols) Gaussian matrix per block of ``op``."""
    return random_gaussian(generator, (*op.batch_shape, rows, cols),
                           dtype=op.dtype, device=op.device)


@with_precision
def sample_range_by_rank(op, generator: torch.Generator, k: int, p: int = 5,
                         **qr_kwargs) -> torch.Tensor:
    """Orthonormal basis for the dominant rank-``k`` range of ``op``:
    sketch ``Y = A @ Omega`` with Gaussian ``Omega`` (n, k+p), pivoted-QR
    the sketch, keep the first ``k`` Q columns."""
    op = as_linear_operator(op)
    omega = _gaussian_for(op, generator, op.ncols, k + p)
    return _sample_range_power_iteration_from_omega(op, omega, k, 0,
                                                    **qr_kwargs)


@with_precision
def sample_range_power_iteration(op, generator: torch.Generator, k: int,
                                 p: int = 5, it_count: int = 0,
                                 ortho: str = "auto",
                                 **qr_kwargs) -> torch.Tensor:
    """Rank-``k`` range basis refined by ``it_count`` subspace iterations:
    apply ``A A^H`` ``it_count`` times with a re-orthonormalization after
    each half step, then pivoted-QR the final iterate and keep ``k``
    columns. ``it_count=0`` is ``sample_range_by_rank``."""
    op = as_linear_operator(op)
    omega = _gaussian_for(op, generator, op.ncols, k + p)
    return _sample_range_power_iteration_from_omega(op, omega, k, it_count,
                                                    ortho, **qr_kwargs)


def _sample_range_power_iteration_from_omega(op: LinearOperator,
                                             omega: torch.Tensor, k: int,
                                             it_count: int = 0,
                                             ortho: str = "auto",
                                             **qr_kwargs) -> torch.Tensor:
    """``sample_range_power_iteration`` given ``omega`` (..., n, k + p)."""
    y = op.matmat(omega)
    for _ in range(it_count):
        q = orthonormalize(y, ortho)
        w = orthonormalize(op.conj_matmat(q), ortho)
        y = op.matmat(w)
    q, _, _ = pivoted_qr(y, max_rank=min(k, *y.shape[-2:]), **qr_kwargs)
    return q


@with_precision
def range_finder(op, generator: torch.Generator, size: int,
                 power_iters: int = 0, ortho: str = "auto",
                 sketch_precision: str | None = None,
                 mid_ortho: str | None = None,
                 final_passes: int | None = None) -> torch.Tensor:
    """HMT range finder: the full ``size``-column orthonormal sketch basis.

    One Gaussian sketch, ``power_iters`` power iterations, unpivoted
    orthonormalization; downstream truncation (``SVD.compress_svd_rank``)
    benefits from the oversampled basis.

    ``sketch_precision`` lowers the matmul precision of the operator
    applications only (``"high"`` lets them run in TF32); the
    orthonormalizations and everything downstream keep the process's
    policy. The sampling products only steer the subspace, so use it only
    where the target residual lies above the sketch's noise. ``mid_ortho``
    names the re-orthonormalization between the products (default:
    ``ortho``; ``"nsqb"`` needs no eigh there); ``final_passes`` goes to
    the final one (svqb only).
    """
    op = as_linear_operator(op)
    omega = _gaussian_for(op, generator, op.ncols, size)
    return _range_finder_from_omega(op, omega, power_iters, ortho,
                                    sketch_precision, mid_ortho, final_passes)


def _range_finder_from_omega(op: LinearOperator, omega: torch.Tensor,
                             power_iters: int = 0, ortho: str = "auto",
                             sketch_precision: str | None = None,
                             mid_ortho: str | None = None,
                             final_passes: int | None = None) -> torch.Tensor:
    def sketch_ctx():
        return (matmul_precision(sketch_precision) if sketch_precision
                else contextlib.nullcontext())

    with span("rc.range_finder"):
        with sketch_ctx():
            y = op.matmat(omega)
        mid = mid_ortho or ortho
        for _ in range(power_iters):
            # Mid-iteration re-orthonormalizations only stabilize the
            # iterate: one svqb pass is enough there; the final basis gets
            # the full one.
            q = orthonormalize(y, mid, passes=1)
            with sketch_ctx():
                w_raw = op.conj_matmat(q)
            w = orthonormalize(w_raw, mid, passes=1)
            with sketch_ctx():
                y = op.matmat(w)
        return orthonormalize(y, ortho, passes=final_passes)


# ---------------------------------------------------------------------------
# Adaptive sampling
# ---------------------------------------------------------------------------


def _adaptive_loop(op: LinearOperator, omegas, rel_tol: float,
                   sample_size: int, max_iters: int, ortho: str = "auto"):
    """The adaptive range finder given its Gaussian matrices.

    ``omegas`` is an iterator of (..., n, sample_size) matrices: the first
    probes the operator, and each round takes one more for the fresh probe
    of the residual. Buffers ``q`` (..., m, cap) and ``b_mat`` (..., cap, n)
    with ``cap = max_iters * sample_size`` are preallocated; each round
    appends ``sample_size`` orthonormal columns, and everything beyond a
    matrix's ``ncols`` stays exactly zero.

    On a stack every matrix stops at its own rank: the stop flag, the
    stall count and the history live on the device, a matrix that has
    stopped is frozen with ``torch.where``, and the loop runs while any
    matrix is active. Deciding that takes one read of a device flag on
    the host in each round (and one more that ends the loop, unless the
    cap ends it); ``_adaptive_loop.host_reads`` counts them.

    Returns ``(q, b_mat, ncols, n_iters, hist)``; ``ncols`` and
    ``n_iters`` are int64 tensors of the batch's shape.
    """
    batch, (m, n) = op.batch_shape, op.shape
    dt, dev = op.dtype, op.device
    rdt = real_dtype(dt)
    blk = sample_size
    floor = 50.0 * eps(rdt)

    y = op.matmat(next(omegas))
    # Randomized estimate of the operator norm from the first probe block.
    op_norm = HMT_TOL_FACTOR * max_col_norm(y)
    safe_op_norm = torch.where(op_norm > 0, op_norm, 1.0)

    q = torch.zeros((*batch, m, max_iters * blk), dtype=dt, device=dev)
    b_mat = torch.zeros((*batch, max_iters * blk, n), dtype=dt, device=dev)
    hist = torch.zeros((*batch, max_iters), dtype=rdt, device=dev)
    n_iters = torch.zeros(batch, dtype=torch.int64, device=dev)
    stall = torch.zeros(batch, dtype=torch.int64, device=dev)
    max_norm = op_norm

    # Every active matrix has run exactly `it` rounds, so the column offset
    # is one host integer for the whole stack.
    for it in range(max_iters):
        active = (max_norm / safe_op_norm >= rel_tol) & (stall < 2)
        _adaptive_loop.host_reads += 1
        if not bool(active.any()):
            break
        grow = active[..., None, None]
        ncols = it * blk
        if ncols:
            # Block Gram–Schmidt against the basis so far, twice ("twice
            # is enough"): after heavy deflation one pass leaves the probe
            # visibly non-orthogonal to the basis in f32.
            qp = q[..., :ncols]
            y = y - qp @ (herm(qp) @ y)
            y = y - qp @ (herm(qp) @ y)
        q_new = orthonormalize(y, ortho)
        b_new = herm(op.conj_matmat(q_new))
        q[..., ncols:ncols + blk] = torch.where(grow, q_new, 0.0)
        b_mat[..., ncols:ncols + blk, :] = torch.where(grow, b_new, 0.0)
        # Fresh probe of the residual A - Q B.
        omega = next(omegas)
        y_new = op.matmat(omega) - q[..., :ncols + blk] @ (
            b_mat[..., :ncols + blk, :] @ omega)
        new_norm = HMT_TOL_FACTOR * max_col_norm(y_new)
        # Noise-floor detector: stop when the estimate has BOTH stopped
        # shrinking AND sits within ~50 eps of the operator norm. Slowly
        # decaying spectra shrink by a few percent a block far above the
        # floor and must go on.
        stalled = (new_norm / safe_op_norm < floor) & (new_norm
                                                        > 0.9 * max_norm)
        stall = torch.where(active, torch.where(stalled, stall + 1, 0), stall)
        hist[..., it] = torch.where(active, new_norm / safe_op_norm, 0.0)
        y = torch.where(grow, y_new, y)
        max_norm = torch.where(active, new_norm, max_norm)
        n_iters = n_iters + active
    return q, b_mat, n_iters * blk, n_iters, hist


_adaptive_loop.host_reads = 0


def _gaussians(op: LinearOperator, generator: torch.Generator, cols: int):
    """An endless iterator of (..., n, cols) Gaussian matrices for ``op``."""
    while True:
        yield _gaussian_for(op, generator, op.ncols, cols)


def _max_iters(op: LinearOperator, sample_size: int, max_rank) -> int:
    if max_rank is None:
        max_rank = min(op.shape)
    return max(1, -(-int(max_rank) // int(sample_size)))


@with_precision
def adaptive_range_finder(op, generator: torch.Generator, rel_tol: float,
                          sample_size: int, max_rank: int | None = None,
                          ortho: str = "auto"):
    """Adaptive range finder with padded outputs, for one operator or a
    stack.

    Returns ``(q_padded, b_padded, ncols, n_iters, history)``: only the
    first ``ncols`` columns of ``q_padded`` (and rows of ``b_padded`` =
    ``Q^H A``) are meaningful, the rest is zero, and ``history[..., i]`` is
    the estimated relative residual after ``(i + 1) * sample_size``
    columns. ``sample_range_adaptive`` slices the buffers for one matrix.
    """
    op = as_linear_operator(op)
    sample_size = int(sample_size)
    return _adaptive_loop(op, _gaussians(op, generator, sample_size), rel_tol,
                          sample_size, _max_iters(op, sample_size, max_rank),
                          ortho)


@with_precision
def sample_range_adaptive(op, generator: torch.Generator, rel_tol: float,
                          sample_size: int, max_rank: int | None = None,
                          ortho: str = "auto"):
    """Adaptively sample the range of one operator to a relative tolerance.

    Returns ``(q, residuals)``: ``q`` (m, rank) holds the orthonormal range
    columns accepted and ``residuals`` is the history
    ``[(rank, rel_res), ...]``, the estimated relative residual after each
    appended block. The error check is probabilistic (HMT bound with the
    factor 10·sqrt(2/pi)). Reads the achieved rank on the host; a stack
    goes through ``adaptive_range_finder``.
    """
    op = as_linear_operator(op)
    sample_size = int(sample_size)
    return _sample_range_adaptive_from_omegas(
        op, _gaussians(op, generator, sample_size), rel_tol, sample_size,
        max_rank, ortho)


def _sample_range_adaptive_from_omegas(op: LinearOperator, omegas,
                                       rel_tol: float, sample_size: int,
                                       max_rank: int | None = None,
                                       ortho: str = "auto"):
    if op.batch_shape:
        raise ValueError("sample_range_adaptive takes one operator, not a "
                         "stack; adaptive_range_finder takes a stack")
    q, _, ncols, n_iters, hist = _adaptive_loop(
        op, omegas, rel_tol, sample_size,
        _max_iters(op, sample_size, max_rank), ortho)
    hist = hist[:int(n_iters)].tolist()
    residuals = [((i + 1) * sample_size, h) for i, h in enumerate(hist)]
    return q[:, :len(hist) * sample_size], residuals


@with_precision
def randomized_adaptive_qr(op, generator: torch.Generator, rel_tol: float,
                           sample_size: int, max_rank: int | None = None,
                           ortho: str = "auto", **qr_kwargs):
    """Adaptively sample, then factorize: ``(qr, residual_history)`` with
    ``qr`` a pivoted QR of the discovered range (rank = the achieved
    sampling rank)."""
    from .models.qr import QR  # deferred: models layer sits above sampling

    q, hist = sample_range_adaptive(op, generator, rel_tol, sample_size,
                                    max_rank, ortho)
    return QR.compute_from_range_estimate(q, op, **qr_kwargs), hist


@with_precision
def randomized_adaptive_svd(op, generator: torch.Generator, rel_tol: float,
                            sample_size: int, max_rank: int | None = None,
                            ortho: str = "auto", small_svd: str = "direct"):
    """Adaptive sampling followed by the sketch SVD:
    ``(svd, residual_history)``."""
    from .models.svd import SVD  # deferred: models layer sits above sampling

    q, hist = sample_range_adaptive(op, generator, rel_tol, sample_size,
                                    max_rank, ortho)
    return SVD.compute_from_range_estimate(q, op, method=small_svd), hist


# ---------------------------------------------------------------------------
# Generalized Nyström (single-pass) factorization
# ---------------------------------------------------------------------------


@with_precision
def nystrom_svd(op, generator: torch.Generator, k: int, oversample: int = 8,
                psi_oversample: float = 1.5, small_svd: str = "direct",
                stabilize: bool = True):
    """Single-pass randomized SVD by the generalized Nyström method.

    ``A ~= (A Omega) (Psi A Omega)^+ (Psi A)`` with Gaussian sketches
    ``Omega`` (n, l) and ``Psi`` (l2, m), l = k + p, l2 ~ 1.5 l
    (Nakatsukasa, arXiv:2009.11392: the oversized second sketch is what
    makes the pseudoinverse stable).

    The operator is touched exactly twice, one ``matmat`` and one
    ``conj_matmat``, against ``2q + 2`` passes for power-iterated HMT: the
    bandwidth-optimal path when the spectrum decays fast enough that power
    iteration is not needed. Returns an ``SVD`` truncated to rank ``k``.
    """
    op = as_linear_operator(op)
    m, n = op.shape
    l = k + oversample
    l2 = max(int(l * psi_oversample), l + 4)
    omega = _gaussian_for(op, generator, n, l)
    psi_h = _gaussian_for(op, generator, m, l2)  # Psi^H
    return _nystrom_svd_from_omegas(op, omega, psi_h, k, small_svd, stabilize)


def _nystrom_svd_from_omegas(op: LinearOperator, omega: torch.Tensor,
                             psi_h: torch.Tensor, k: int,
                             small_svd: str = "direct",
                             stabilize: bool = True):
    """``nystrom_svd`` given ``Omega`` (..., n, l) and ``Psi^H``
    (..., m, l2)."""
    from .models.svd import SVD  # deferred: models layer sits above sampling

    y = op.matmat(omega)              # (m, l): pass 1 over the operator
    w = herm(op.conj_matmat(psi_h))   # (l2, n) = Psi A: pass 2
    core = w @ omega                  # (l2, l) = Psi A Omega (small)
    if stabilize:
        # QR-based application of the pseudoinverse, the stable form:
        # A ~= Y pinv(core) W = Y R^{-1} Q^H W.
        q_c, r_c = torch.linalg.qr(core, mode="reduced")
        z = herm(q_c) @ w                                     # (l, n)
        yr = triangular_solve(r_c, y, left_side=False, lower=False)
    else:
        yr = y @ torch.linalg.pinv(core)
        z = w
    u_z, s, vt = compute_svd(z, method=small_svd)
    u = yr @ u_z
    # yr's columns are not orthonormal: re-orthonormalize the lifted factor
    q_u, r_u = cholesky_qr2(u)
    u_r, s2, vt2 = compute_svd(r_u * s[..., None, :].to(r_u.dtype),
                               method=small_svd)
    return SVD((q_u @ u_r)[..., :k], s2[..., :k], (vt2 @ vt)[..., :k, :])


# ---------------------------------------------------------------------------
# One-read sketched interpolative decompositions
# ---------------------------------------------------------------------------


def _sketch_width(m: int, n: int, rank, oversample: int, tol,
                  max_rank) -> int:
    if (rank is None) == (tol is None):
        raise ValueError("pass exactly one of rank= or tol=")
    if tol is not None:
        cap = min(m, n) if max_rank is None else min(int(max_rank), m, n)
        return min(cap + oversample, m, n)
    return min(rank + oversample, m, n)


@with_precision
def sketched_column_id(op, generator: torch.Generator,
                       rank: int | None = None, oversample: int = 8,
                       tol: float | None = None, max_rank: int | None = None,
                       **qr_kwargs):
    """Column interpolative decomposition ``A ~= C Z`` from ONE read.

    Pivots and coefficients come from the QRCP of the row sketch
    ``S = G A`` ((k+p, n), Gaussian ``G``): ``Z = R11^{-1} [R11 | R12]``,
    the least-squares solution ``argmin_Z ||G C Z - G A||_F``; then
    ``C = A[:, col_ind[:rank]]`` is a k-column gather, bitwise columns of
    ``A``.

    ``tol=`` instead of ``rank=``: the truncation rank comes from the
    ``|r_jj / r_00| < tol/2`` rule on the sketch diagonal, within
    ``max_rank`` (default ``min(m, n)``); an unreachable tolerance raises
    ``CompressionError``. Tolerance mode takes one matrix, not a batch.
    """
    op = as_linear_operator(op)
    m, n = op.shape
    l = _sketch_width(m, n, rank, oversample, tol, max_rank)
    g_h = _gaussian_for(op, generator, m, l)
    # the same generator goes on to draw the blocked QRCP's pivot sketch,
    # after the row sketch: two independent Gaussian matrices
    qr_kwargs.setdefault("generator", generator)
    return _sketched_column_id_from_sketch(op, g_h, rank, tol=tol,
                                           max_rank=max_rank, **qr_kwargs)


def _sketched_column_id_from_sketch(op: LinearOperator, g_h: torch.Tensor,
                                    rank: int | None = None,
                                    tol: float | None = None,
                                    max_rank: int | None = None,
                                    **qr_kwargs):
    """``sketched_column_id`` given ``G^H`` (..., m, l)."""
    from .models.interp_decomp import ColumnID  # deferred: models layer
    from .models.qr import QR                   # sits above sampling

    if (rank is None) == (tol is None):
        raise ValueError("pass exactly one of rank= or tol=")
    l = g_h.shape[-1]
    s = herm(op.conj_matmat(g_h))                            # (l, n) = G A
    qr_s = QR.compute_from(s, max_rank=l if tol is not None else
                           min(rank, l), **qr_kwargs)
    if tol is not None:
        # the 0.5x tightening covers the sketched-LS error multiple; the
        # cut may land in the oversample margin, so clamp to max_rank
        qr_s = qr_s.compress_qr_tolerance(0.5 * float(tol))
        if max_rank is not None:
            qr_s = qr_s.compress_qr_rank(int(max_rank))
    cid_s = qr_s.column_id()   # z and col_ind from the sketch; c discarded
    piv = cid_s.col_ind[..., :cid_s.rank]
    if op.has_cheap_dense():
        c = torch.take_along_dim(op.to_dense(), piv.unsqueeze(-2), dim=-1)
    else:
        # matrix-free: k columns through a one-hot selector product, a
        # k-column read instead of materializing the operator
        sel = torch.nn.functional.one_hot(piv, op.ncols).to(op.dtype).mT
        c = op.matmat(sel)
    return ColumnID(c=c, z=cid_s.z, col_ind=cid_s.col_ind)


@with_precision
def sketched_row_id(op, generator: torch.Generator, rank: int | None = None,
                    oversample: int = 8, tol: float | None = None,
                    max_rank: int | None = None, **qr_kwargs):
    """Row interpolative decomposition ``A ~= X R`` from one read: the
    mirror of ``sketched_column_id`` on ``A^H``, with ``R`` literal rows
    of ``A``."""
    op = as_linear_operator(op)
    m, n = op.shape
    l = _sketch_width(n, m, rank, oversample, tol, max_rank)
    g_h = _gaussian_for(op, generator, n, l)
    qr_kwargs.setdefault("generator", generator)
    return _sketched_row_id_from_sketch(op, g_h, rank, tol=tol,
                                        max_rank=max_rank, **qr_kwargs)


def _sketched_row_id_from_sketch(op: LinearOperator, g_h: torch.Tensor,
                                 rank: int | None = None,
                                 tol: float | None = None,
                                 max_rank: int | None = None, **qr_kwargs):
    """``sketched_row_id`` given the sketch of ``A^H``, (..., n, l)."""
    from .models.interp_decomp import RowID  # deferred: models layer

    cid = _sketched_column_id_from_sketch(AdjointOperator(op), g_h, rank,
                                          tol=tol, max_rank=max_rank,
                                          **qr_kwargs)
    return RowID(x=herm(cid.z), r=herm(cid.c), row_ind=cid.col_ind)


@with_precision
def sketched_two_sided_id(op, generator: torch.Generator,
                          rank: int | None = None, oversample: int = 8,
                          tol: float | None = None,
                          max_rank: int | None = None, **qr_kwargs):
    """Two-sided interpolative decomposition ``A ~= C X R`` from ONE read:
    ``sketched_column_id`` followed by the LQ -> row-ID of the (m, k)
    ``C`` panel, which touches only the k gathered columns."""
    return sketched_column_id(op, generator, rank, oversample, tol=tol,
                              max_rank=max_rank,
                              **qr_kwargs).two_sided_id()
