"""Complex randomized factorizations: SVD, column ID, row ID and two-sided
ID of a c64/c128 matrix (port of ``rusty_compression_tpu.planarc``).

The JAX module exists because its TPU rejects every complex dtype: it
captures the range on the real (2m, 2n) realification, recovers the
complex basis with a host c128 QR, projects with four real GEMMs and runs
the small complex core in host numpy. The card takes complex dtypes, so
the same entry points run here natively in the input's complex dtype on
the input's device:

    range_finder -> B = Qc^H A -> SVD or pivoted QR of the (L, n) core
    (K2 on the card for c64) -> column_id -> exact column gather
    -> LQ of C (K2 again) -> row ID

with the reference's rules kept: rank and ``tol`` truncation, the clamp to
the numerically alive rank, ``C`` made of bitwise columns of the input,
``X`` from the LQ of ``C``.

Not ported, and why:

* the realification ``[[Re A, -Im A], [Im A, Re A]]`` and the planar
  four-GEMM projection: the card multiplies complex matrices;
* the host c128 QR of the recovered basis and the host numpy core
  (``qrcp_host``): they stood in for complex kernels the TPU lacks;
* host numpy factors: the containers hold tensors on the input's device.

The capture is ``size`` complex columns wide. The JAX module's basis came
out ``2 * size`` wide only because the realified spectrum holds every
singular value twice.
"""

from __future__ import annotations

import torch

from .linop import DenseOperator
from .models.interp_decomp import ColumnID, RowID, TwoSidedID
from .models.qr import QR
from .models.svd import SVD
from .sampling import _gaussian_for, _range_finder_from_omega
from .utils.dtypes import eps, herm
from .utils.precision import with_precision

__all__ = ["planar_range_capture", "planar_rsvd", "planar_column_id",
           "planar_row_id", "planar_two_sided_id"]


def _complex_operator(a: torch.Tensor) -> DenseOperator:
    """``a`` as an operator in the complex class of its dtype (a real
    matrix is promoted, as the JAX module's output dtype rule does)."""
    if a.ndim != 2:
        raise ValueError(f"expected a matrix, got shape {tuple(a.shape)}")
    if not a.is_complex():
        a = a.to(torch.complex128 if a.dtype == torch.float64
                 else torch.complex64)
    return DenseOperator(a)


def _omega(op: DenseOperator, generator: torch.Generator,
           size: int) -> torch.Tensor:
    return _gaussian_for(op, generator, op.ncols, min(int(size), *op.shape))


def _capture_from_omega(op: DenseOperator, omega: torch.Tensor,
                        power_iters: int):
    """``(Qc, B = Qc^H A)`` given the Gaussian test matrix (n, L)."""
    qc = _range_finder_from_omega(op, omega, power_iters)
    return qc, herm(op.conj_matmat(qc))


@with_precision
def planar_range_capture(a: torch.Tensor, generator: torch.Generator,
                         size: int, power_iters: int = 1):
    """Complex range basis and projected core: ``(qc, b)`` with ``qc``
    (m, L) orthonormal, L = min(size, m, n), and ``b = qc^H a`` (L, n), in
    ``a``'s complex dtype on its device."""
    op = _complex_operator(a)
    return _capture_from_omega(op, _omega(op, generator, size), power_iters)


@with_precision
def planar_rsvd(a: torch.Tensor, generator: torch.Generator,
                rank: int | None = None, tol: float | None = None,
                oversample: int = 10, power_iters: int = 1) -> SVD:
    """Randomized SVD of a complex matrix, sketch-then-factorize.

    ``rank`` keeps the leading ``rank`` triples; ``tol`` truncates before
    the first ``s_i / s_0 < tol`` and raises ``CompressionError`` if the
    captured spectrum never drops below ``tol``; with both, the smaller
    rank wins.
    """
    if rank is None and tol is None:
        raise ValueError("need rank= and/or tol=")
    op = _complex_operator(a)
    size = int(rank) if rank is not None else max(16, min(op.shape) // 4)
    qc, b = _capture_from_omega(op, _omega(op, generator,
                                           size + int(oversample)),
                                power_iters)
    svd = SVD.compute_from(b)
    if tol is not None:
        svd = svd.compress_svd_tolerance(tol)
    if rank is not None:
        svd = svd.compress_svd_rank(rank)
    return SVD(qc @ svd.u, svd.s, svd.vt)


def _column_id_from_omega(op: DenseOperator, omega: torch.Tensor, rank: int,
                          power_iters: int,
                          generator: torch.Generator | None = None
                          ) -> ColumnID:
    """``planar_column_id`` given the Gaussian test matrix (n, L);
    ``generator`` goes to the pivoted QR of the core (its blocked mode
    draws a pivot sketch)."""
    _, b = _capture_from_omega(op, omega, power_iters)
    qr_b = QR.compute_from(b, max_rank=int(rank), generator=generator)
    # Clamp to the numerically alive rank (the reference clamps max_rank to
    # the available rank): diagonal entries under 32 eps |r_00| of the
    # capture's working precision are noise, and a Z-solve against them
    # returns garbage, not a deeper ID. Read on the host: one
    # synchronisation per call.
    d = torch.diagonal(qr_b.r, dim1=-2, dim2=-1).abs()
    floor = 32 * eps(op.dtype) * torch.clamp(d[0], min=1e-30)
    k = max(int((d >= floor).sum()), 1)
    cid_b = qr_b.compress_qr_rank(k).column_id()  # z, col_ind; c discarded
    c = op.a[:, cid_b.col_ind[:k]]                # exact columns of the input
    return ColumnID(c=c, z=cid_b.z, col_ind=cid_b.col_ind)


@with_precision
def planar_column_id(a: torch.Tensor, generator: torch.Generator, rank: int,
                     oversample: int = 10, power_iters: int = 1) -> ColumnID:
    """Column ID ``A ~= C Z`` of a complex matrix by the randomized
    QRCP-of-the-core route: the pivots come from the pivoted QR of the
    projected core ``B = Qc^H A`` (``QR.compute_from_range_estimate``'s
    pattern), ``Z = [I | R11^{-1} R12]`` inverse-permuted, and ``C`` is an
    exact column subset of the input. A rank request past the numerically
    alive rank of the capture is clamped."""
    op = _complex_operator(a)
    omega = _omega(op, generator, int(rank) + int(oversample))
    return _column_id_from_omega(op, omega, rank, power_iters, generator)


@with_precision
def planar_row_id(a: torch.Tensor, generator: torch.Generator, rank: int,
                  oversample: int = 10, power_iters: int = 1) -> RowID:
    """Row ID ``A ~= X R`` of a complex matrix: the column ID of ``A^H``,
    so ``R`` is exact rows of ``A``."""
    cid = planar_column_id(herm(_complex_operator(a).a), generator, rank,
                           oversample=oversample, power_iters=power_iters)
    return RowID(x=herm(cid.z), r=herm(cid.c), row_ind=cid.col_ind)


@with_precision
def planar_two_sided_id(a: torch.Tensor, generator: torch.Generator,
                        rank: int, oversample: int = 10,
                        power_iters: int = 1) -> TwoSidedID:
    """Two-sided ID ``A ~= C X R`` of a complex matrix: the column ID, then
    the pivoted LQ and row ID of its ``C``; ``X`` lands entrywise at the
    skeleton submatrix ``A[row_ind[:k], col_ind[:k]]``."""
    return planar_column_id(a, generator, rank, oversample=oversample,
                            power_iters=power_iters).two_sided_id()
