"""QR / LQ factorization containers and conversions (port of
``rusty_compression_tpu.models.qr``).

Compress by rank or tolerance, QR -> ColumnID, LQ -> RowID, and the
randomized ``compute_from_range_estimate``. Pivot convention:
``ind[j] = k`` means column ``j`` of ``q @ r`` is column ``k`` of the
original matrix. A batch of factorizations carries a leading batch axis
on every field. Tolerance truncation that slices is per matrix and reads
the rank on the host; the ``_masked`` forms keep the padded shape, zero
what lies beyond the rank and stay on the device, so they take a batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..linop import as_linear_operator
from ..ops.pivoted_qr import pivoted_lq, pivoted_qr
from ..ops.triangular import solve_upper_triangular, triangular_solve
from ..utils.dtypes import herm
from ..utils.errors import CompressionError
from ..utils.permutation import MatrixPermutationMode, apply_matrix_permutation
from ..utils.precision import with_precision
from .compression import Adaptive, CompressionType, Rank
from .interp_decomp import ColumnID, RowID

__all__ = ["QR", "LQ"]


def _tolerance_position(diag_ratios: torch.Tensor, tol: float):
    """Truncation rank for a relative tolerance, or None if unreachable.

    The cut lands at the first position from which every later ratio is
    below ``tol`` (the suffix-max envelope of the ratios); for a
    non-increasing diagonal this is the reference's first-crossing scan.
    Runs on the host.
    """
    if not (0.0 <= tol < 1.0):
        raise ValueError("Require 0 <= tol < 1.0")
    ratios = np.abs(diag_ratios.detach().cpu().numpy())
    if ratios.ndim != 1:
        raise ValueError("tolerance truncation takes one matrix, not a batch")
    envelope = np.maximum.accumulate(ratios[::-1])[::-1]
    below = envelope < tol
    idx = int(np.argmax(below))
    if not below[idx]:
        return None
    return idx


def _tolerance_rank_device(diag: torch.Tensor, tol: float):
    """``_tolerance_position`` without the host: ``(rank, ok)`` over the
    last axis of ``diag`` (..., k). ``rank`` (int64) is the suffix-max
    envelope's truncation rank, or ``k`` where the tolerance is
    unreachable; ``ok`` is False there (the masked API's stand-in for
    ``CompressionError``)."""
    ratios = (diag / diag[..., :1]).abs()
    envelope = torch.flip(
        torch.cummax(torch.flip(ratios, (-1,)), dim=-1).values, (-1,))
    below = envelope < tol
    ok = below[..., -1]
    rank = torch.argmax(below.to(torch.uint8), dim=-1)  # the first True
    return torch.where(ok, rank, diag.shape[-1]), ok


def _keep(size: int, rank: torch.Tensor) -> torch.Tensor:
    """(..., size) bool: index < rank, for ``rank`` of shape (...)."""
    return torch.arange(size, device=rank.device) < rank[..., None]


def _mask_cols(a: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Zero the columns at index >= rank (shape kept)."""
    return a * _keep(a.shape[-1], rank)[..., None, :].to(a.dtype)


def _mask_rows(a: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Zero the rows at index >= rank (shape kept)."""
    return a * _keep(a.shape[-2], rank)[..., :, None].to(a.dtype)


def _identity_like(ref: torch.Tensor, rank: int) -> torch.Tensor:
    """(..., rank, rank) identity with the batch axes of ``ref``."""
    eye = torch.eye(rank, dtype=ref.dtype, device=ref.device)
    return eye.expand(*ref.shape[:-2], rank, rank)


@dataclasses.dataclass(frozen=True)
class QR:
    """Pivoted QR decomposition ``A P = Q R``.

    q: (m, k) orthonormal columns; r: (k, n) upper triangular over the
    permuted columns; ind: (n,) int64 pivot vector.
    """

    q: torch.Tensor
    r: torch.Tensor
    ind: torch.Tensor

    @property
    def nrows(self) -> int:
        return self.q.shape[-2]

    @property
    def ncols(self) -> int:
        return self.r.shape[-1]

    @property
    def rank(self) -> int:
        return self.q.shape[-1]

    @classmethod
    def compute_from(cls, a: torch.Tensor, max_rank=None, **kwargs) -> "QR":
        """Pivoted QR of a dense matrix (or batch)."""
        return cls(*pivoted_qr(a, max_rank=max_rank, **kwargs))

    @classmethod
    @with_precision
    def compute_from_range_estimate(cls, range_: torch.Tensor, op,
                                    **kwargs) -> "QR":
        """Randomized QR from an orthonormal range estimate: factorize the
        small sketch ``B = (A^H Q)^H`` (k, n) and lift Q back."""
        op = as_linear_operator(op)
        b = herm(op.conj_matmat(range_))
        qr_b = cls.compute_from(b, **kwargs)
        return cls(range_ @ qr_b.q, qr_b.r, qr_b.ind)

    @with_precision
    def to_mat(self) -> torch.Tensor:
        """``Q @ (R with the inverse column permutation)``."""
        return self.q @ apply_matrix_permutation(
            self.r, self.ind, MatrixPermutationMode.COLINV)

    def compress_qr_rank(self, max_rank: int) -> "QR":
        """Keep the leading ``max_rank`` columns of Q / rows of R (clamped
        to the available rank)."""
        max_rank = min(int(max_rank), self.rank)
        return QR(self.q[..., :max_rank], self.r[..., :max_rank, :],
                  self.ind)

    def compress_qr_tolerance(self, tol: float) -> "QR":
        """Truncate before the first ``|r_ii / r_00| < tol``; raise
        ``CompressionError`` if the diagonal never drops below ``tol``."""
        d = torch.diagonal(self.r, dim1=-2, dim2=-1)
        pos = _tolerance_position(d / d[..., :1], tol)
        if pos is None:
            raise CompressionError(
                f"Could not compress to relative tolerance {tol!r}")
        return self.compress_qr_rank(pos)

    def compress_qr_tolerance_masked(self, tol: float):
        """Tolerance truncation that masks instead of slicing, on the
        device, for one factorization or a batch.

        Returns ``(rank, qr_masked, ok)``: ``qr_masked`` keeps the padded
        shape with the columns of Q and rows of R beyond ``rank`` zeroed
        (``to_mat`` and the factored products are exact for the truncated
        factorization); ``ok`` is False where the tolerance was
        unreachable, and ``rank`` is then the full rank."""
        rank, ok = _tolerance_rank_device(
            torch.diagonal(self.r, dim1=-2, dim2=-1), tol)
        masked = QR(_mask_cols(self.q, rank), _mask_rows(self.r, rank),
                    self.ind)
        return rank, masked, ok

    def compress(self, compression_type: CompressionType) -> "QR":
        """Dispatch on the compression selector."""
        if isinstance(compression_type, Adaptive):
            return self.compress_qr_tolerance(compression_type.tol)
        if isinstance(compression_type, Rank):
            return self.compress_qr_rank(compression_type.rank)
        raise TypeError(f"unknown compression type: {compression_type!r}")

    @with_precision
    def column_id(self) -> ColumnID:
        """Column interpolative decomposition from this QR.

        Full rank: ``C = Q R`` and ``Z`` is the inverse-permuted identity.
        Rank-deficient: ``Z = [I | R11^{-1} R12]`` (one batched triangular
        solve), inverse-permuted; ``C = Q R11``.
        """
        rank, ncols = self.rank, self.ncols
        eye = _identity_like(self.r, rank)
        if rank == ncols:
            z = apply_matrix_permutation(eye, self.ind,
                                         MatrixPermutationMode.COLINV)
            return ColumnID(self.q @ self.r, z, self.ind)
        r11 = self.r[..., :rank]
        z_tail = solve_upper_triangular(r11, self.r[..., rank:])
        z = apply_matrix_permutation(torch.cat([eye, z_tail], dim=-1),
                                     self.ind, MatrixPermutationMode.COLINV)
        return ColumnID(self.q @ r11, z, self.ind)


@dataclasses.dataclass(frozen=True)
class LQ:
    """Pivoted LQ decomposition ``P A = L Q``.

    l: (m, k) lower triangular over permuted rows; q: (k, n) orthonormal
    rows; ind: (m,) int64 pivot vector (row ``j`` of ``L Q`` is row
    ``ind[j]`` of the original).
    """

    l: torch.Tensor
    q: torch.Tensor
    ind: torch.Tensor

    @property
    def nrows(self) -> int:
        return self.l.shape[-2]

    @property
    def ncols(self) -> int:
        return self.q.shape[-1]

    @property
    def rank(self) -> int:
        return self.q.shape[-2]

    @classmethod
    def compute_from(cls, a: torch.Tensor, max_rank=None, **kwargs) -> "LQ":
        """Pivoted LQ = (pivoted QR of A^H)^H."""
        return cls(*pivoted_lq(a, max_rank=max_rank, **kwargs))

    @with_precision
    def to_mat(self) -> torch.Tensor:
        """``(L with the inverse row permutation) @ Q``."""
        return apply_matrix_permutation(
            self.l, self.ind, MatrixPermutationMode.ROWINV) @ self.q

    def compress_lq_rank(self, max_rank: int) -> "LQ":
        """Keep the leading ``max_rank`` rows of Q / columns of L."""
        max_rank = min(int(max_rank), self.rank)
        return LQ(self.l[..., :max_rank], self.q[..., :max_rank, :],
                  self.ind)

    def compress_lq_tolerance(self, tol: float) -> "LQ":
        """Mirror of ``QR.compress_qr_tolerance`` on the L diagonal."""
        d = torch.diagonal(self.l, dim1=-2, dim2=-1)
        pos = _tolerance_position(d / d[..., :1], tol)
        if pos is None:
            raise CompressionError(
                f"Could not compress to relative tolerance {tol!r}")
        return self.compress_lq_rank(pos)

    def compress_lq_tolerance_masked(self, tol: float):
        """Mirror of ``QR.compress_qr_tolerance_masked`` on the L
        diagonal: ``(rank, lq_masked, ok)``."""
        rank, ok = _tolerance_rank_device(
            torch.diagonal(self.l, dim1=-2, dim2=-1), tol)
        masked = LQ(_mask_cols(self.l, rank), _mask_rows(self.q, rank),
                    self.ind)
        return rank, masked, ok

    def compress(self, compression_type: CompressionType) -> "LQ":
        """Dispatch on the compression selector."""
        if isinstance(compression_type, Adaptive):
            return self.compress_lq_tolerance(compression_type.tol)
        if isinstance(compression_type, Rank):
            return self.compress_lq_rank(compression_type.rank)
        raise TypeError(f"unknown compression type: {compression_type!r}")

    @with_precision
    def row_id(self) -> RowID:
        """Row interpolative decomposition from this LQ.

        Full rank: ``X`` = inverse-row-permuted identity, ``R = L Q``.
        Rank-deficient: ``X = [I; L21 L11^{-1}]`` via one right-hand
        triangular solve, inverse-row-permuted; ``R = L11 Q``.
        """
        rank, nrows = self.rank, self.nrows
        eye = _identity_like(self.l, rank)
        if rank == nrows:
            x = apply_matrix_permutation(eye, self.ind,
                                         MatrixPermutationMode.ROWINV)
            return RowID(x, self.l @ self.q, self.ind)
        l11 = self.l[..., :rank, :]
        x_tail = triangular_solve(l11, self.l[..., rank:, :],
                                  left_side=False, lower=True)
        x = apply_matrix_permutation(torch.cat([eye, x_tail], dim=-2),
                                     self.ind, MatrixPermutationMode.ROWINV)
        return RowID(x, l11 @ self.q, self.ind)
