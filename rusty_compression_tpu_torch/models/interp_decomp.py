"""Interpolative decomposition containers (port of
``rusty_compression_tpu.models.interp_decomp``).

* ``ColumnID``:   ``A ~= C Z``   — C is a column subset of A (col_ind).
* ``RowID``:      ``A ~= X R``   — R is a row subset of A (row_ind).
* ``TwoSidedID``: ``A ~= C X R`` — X is the skeleton submatrix
  ``A[row_ind[:k], col_ind[:k]]``.

Frozen dataclasses of tensors. A batch of decompositions carries a
leading batch axis on every field; the methods act on the last two axes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.dtypes import herm
from ..utils.precision import with_precision

__all__ = ["ColumnID", "RowID", "TwoSidedID"]


@dataclasses.dataclass(frozen=True)
class ColumnID:
    """Column interpolative decomposition ``A ~= C Z``.

    c: (m, k) columns of A; z: (k, n); col_ind: ``col_ind[i] = j`` means
    column ``i`` of C is column ``j`` of A.
    """

    c: torch.Tensor
    z: torch.Tensor
    col_ind: torch.Tensor

    @property
    def nrows(self) -> int:
        return self.c.shape[-2]

    @property
    def ncols(self) -> int:
        return self.z.shape[-1]

    @property
    def rank(self) -> int:
        return self.c.shape[-1]

    @with_precision
    def to_mat(self) -> torch.Tensor:
        """``C @ Z``."""
        return self.c @ self.z

    @with_precision
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Factored product ``C (Z x)``."""
        return self.c @ (self.z @ x)

    @with_precision
    def conj_apply(self, x: torch.Tensor) -> torch.Tensor:
        """Factored adjoint product ``Z^H (C^H x)``."""
        return herm(self.z) @ (herm(self.c) @ x)

    @with_precision
    def two_sided_id(self) -> "TwoSidedID":
        """Two-sided ID via pivoted LQ + row-ID of C."""
        from .qr import LQ  # deferred: models.qr imports this module

        row_id = LQ.compute_from(self.c).row_id()
        return TwoSidedID(c=row_id.x, x=row_id.r, r=self.z,
                          row_ind=row_id.row_ind, col_ind=self.col_ind)


@dataclasses.dataclass(frozen=True)
class RowID:
    """Row interpolative decomposition ``A ~= X R``.

    x: (m, k); r: (k, n) rows of A; row_ind: ``row_ind[i] = j`` means row
    ``i`` of R is row ``j`` of A.
    """

    x: torch.Tensor
    r: torch.Tensor
    row_ind: torch.Tensor

    @property
    def nrows(self) -> int:
        return self.x.shape[-2]

    @property
    def ncols(self) -> int:
        return self.r.shape[-1]

    @property
    def rank(self) -> int:
        return self.r.shape[-2]

    @with_precision
    def to_mat(self) -> torch.Tensor:
        """``X @ R``."""
        return self.x @ self.r

    @with_precision
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Factored product ``X (R x)``."""
        return self.x @ (self.r @ x)

    @with_precision
    def conj_apply(self, x: torch.Tensor) -> torch.Tensor:
        """Factored adjoint product ``R^H (X^H x)``."""
        return herm(self.r) @ (herm(self.x) @ x)

    @with_precision
    def two_sided_id(self) -> "TwoSidedID":
        """Two-sided ID via pivoted QR + column-ID of R."""
        from .qr import QR  # deferred: models.qr imports this module

        col_id = QR.compute_from(self.r).column_id()
        return TwoSidedID(c=self.x, x=col_id.c, r=col_id.z,
                          row_ind=self.row_ind, col_ind=col_id.col_ind)


@dataclasses.dataclass(frozen=True)
class TwoSidedID:
    """Two-sided interpolative decomposition ``A ~= C X R``; ``X`` equals
    the skeleton submatrix ``A[row_ind[:k], col_ind[:k]]``."""

    c: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    row_ind: torch.Tensor
    col_ind: torch.Tensor

    @property
    def nrows(self) -> int:
        return self.c.shape[-2]

    @property
    def ncols(self) -> int:
        return self.r.shape[-1]

    @property
    def rank(self) -> int:
        return self.x.shape[-2]

    @with_precision
    def to_mat(self) -> torch.Tensor:
        """``C @ X @ R``."""
        return self.c @ (self.x @ self.r)

    @with_precision
    def apply(self, y: torch.Tensor) -> torch.Tensor:
        """Factored product ``C (X (R y))``."""
        return self.c @ (self.x @ (self.r @ y))

    @with_precision
    def conj_apply(self, y: torch.Tensor) -> torch.Tensor:
        """Factored adjoint product ``R^H (X^H (C^H y))``."""
        return herm(self.r) @ (herm(self.x) @ (herm(self.c) @ y))
