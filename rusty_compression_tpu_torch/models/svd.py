"""SVD container, compression and conversions (port of
``rusty_compression_tpu.models.svd``).

The SVD factors, rank/tolerance truncation on the singular values, and
the sketch-then-SVD entry point ``compute_from_range_estimate``: the
dense SVD only ever runs on the small (k, n) sketch. A batch carries a
leading batch axis on every field.
"""

from __future__ import annotations

import dataclasses

import torch

from ..linop import as_linear_operator
from ..ops.svd import compute_svd
from ..utils.dtypes import herm
from ..utils.errors import CompressionError
from ..utils.precision import with_precision
from .compression import Adaptive, CompressionType, Rank

__all__ = ["SVD"]


@dataclasses.dataclass(frozen=True)
class SVD:
    """Singular value decomposition ``A = U diag(s) Vt``.

    u: (m, k); s: (k,) real, descending; vt: (k, n).
    """

    u: torch.Tensor
    s: torch.Tensor
    vt: torch.Tensor

    @property
    def nrows(self) -> int:
        return self.u.shape[-2]

    @property
    def ncols(self) -> int:
        return self.vt.shape[-1]

    @property
    def rank(self) -> int:
        return self.u.shape[-1]

    @classmethod
    def compute_from(cls, a: torch.Tensor, method: str = "direct") -> "SVD":
        """Economy SVD of a dense matrix (or batch)."""
        return cls(*compute_svd(a, method=method))

    @classmethod
    @with_precision
    def compute_from_range_estimate(cls, range_: torch.Tensor, op,
                                    method: str = "direct") -> "SVD":
        """Randomized SVD from an orthonormal range estimate: SVD the small
        sketch ``B = (A^H Q)^H`` and lift ``U = Q Uhat``. ``method="gram"``
        takes the Gram-EVD small SVD, valid when the target tolerance is
        well above ``sqrt(eps)``."""
        op = as_linear_operator(op)
        b = herm(op.conj_matmat(range_))
        svd_b = cls.compute_from(b, method=method)
        return cls(range_ @ svd_b.u, svd_b.s, svd_b.vt)

    @with_precision
    def to_mat(self) -> torch.Tensor:
        """``U @ (s * Vt)`` with the row scaling fused."""
        return self.u @ (self.s.to(self.vt.dtype)[..., :, None] * self.vt)

    def compress_svd_rank(self, max_rank: int) -> "SVD":
        """Keep the leading ``max_rank`` singular triplets (clamped)."""
        max_rank = min(int(max_rank), self.s.shape[-1])
        return SVD(self.u[..., :max_rank], self.s[..., :max_rank],
                   self.vt[..., :max_rank, :])

    def compress_svd_tolerance(self, tol: float) -> "SVD":
        """Truncate before the first ``s_i / s_0 < tol``; raise
        ``CompressionError`` if the spectrum never drops below ``tol``."""
        from .qr import _tolerance_position  # shared host scan

        pos = _tolerance_position(self.s / self.s[..., :1], tol)
        if pos is None:
            raise CompressionError(
                f"Could not compress to relative tolerance {tol!r}")
        return self.compress_svd_rank(pos)

    def compress(self, compression_type: CompressionType) -> "SVD":
        """Dispatch on the compression selector."""
        if isinstance(compression_type, Adaptive):
            return self.compress_svd_tolerance(compression_type.tol)
        if isinstance(compression_type, Rank):
            return self.compress_svd_rank(compression_type.rank)
        raise TypeError(f"unknown compression type: {compression_type!r}")

    @with_precision
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Factored product ``U (s * (Vt x))``."""
        return self.u @ (self.s.to(self.vt.dtype)[..., :, None]
                         * (self.vt @ x))

    @with_precision
    def conj_apply(self, x: torch.Tensor) -> torch.Tensor:
        """Factored adjoint product ``V (s * (U^H x))``."""
        return herm(self.vt) @ (self.s.to(self.vt.dtype)[..., :, None]
                                * (herm(self.u) @ x))
