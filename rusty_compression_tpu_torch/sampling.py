"""Randomized range sampling and one-read sketched IDs (port of
``rusty_compression_tpu.sampling``).

* ``range_finder`` — HMT range finder: Gaussian sketch, power
  iterations, unpivoted orthonormalization; keeps all ``size`` columns.
* ``sample_range_by_rank`` — one sketch GEMM + truncated pivoted QR.
* ``sketched_column_id`` / ``sketched_row_id`` / ``sketched_two_sided_id``
  — interpolative decompositions from ONE read of the operator: QRCP of a
  row sketch picks the columns and the coefficients, then a k-column
  gather.

Each entry point draws its Gaussian matrix from the ``torch.Generator`` it
is given and hands it to an inner ``_..._from_omega`` /
``_..._from_sketch`` function that takes the matrix, so that a test can
feed the JAX package's own Gaussian matrix. Operators with a leading
batch axis (``DenseOperator`` of a (B, m, n) stack) get one independent
Gaussian matrix per block.
"""

from __future__ import annotations

import torch

from .linop import AdjointOperator, LinearOperator, as_linear_operator
from .ops.orthogonalize import orthonormalize
from .ops.pivoted_qr import pivoted_qr
from .utils.dtypes import herm
from .utils.precision import with_precision
from .utils.random_matrix import random_gaussian

__all__ = [
    "range_finder",
    "sample_range_by_rank",
    "sketched_column_id",
    "sketched_row_id",
    "sketched_two_sided_id",
]


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
    return _sample_range_by_rank_from_omega(op, omega, k, **qr_kwargs)


def _sample_range_by_rank_from_omega(op: LinearOperator, omega: torch.Tensor,
                                     k: int, **qr_kwargs) -> torch.Tensor:
    y = op.matmat(omega)
    q, _, _ = pivoted_qr(y, max_rank=min(k, *y.shape[-2:]), **qr_kwargs)
    return q


@with_precision
def range_finder(op, generator: torch.Generator, size: int,
                 power_iters: int = 0, ortho: str = "auto") -> torch.Tensor:
    """HMT range finder: the full ``size``-column orthonormal sketch basis.

    One Gaussian sketch, ``power_iters`` power iterations, unpivoted
    orthonormalization; downstream truncation (``SVD.compress_svd_rank``)
    benefits from the oversampled basis.
    """
    op = as_linear_operator(op)
    omega = _gaussian_for(op, generator, op.ncols, size)
    return _range_finder_from_omega(op, omega, power_iters, ortho)


def _range_finder_from_omega(op: LinearOperator, omega: torch.Tensor,
                             power_iters: int = 0,
                             ortho: str = "auto") -> torch.Tensor:
    y = op.matmat(omega)
    for _ in range(power_iters):
        # Mid-iteration re-orthonormalizations only stabilize the iterate:
        # one svqb pass is enough there; the final basis gets the full one.
        q = orthonormalize(y, ortho, passes=1)
        w = orthonormalize(op.conj_matmat(q), ortho, passes=1)
        y = op.matmat(w)
    return orthonormalize(y, ortho)


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
