"""Matrix-free linear operator protocol (port of ``rusty_compression_tpu.linop``).

An operator exposes ``A @ X`` (``matmat``, one GEMM) and ``A^H @ X``
(``conj_matmat``); the sampling routines are written against this
protocol.

Ported so far: ``LinearOperator``, ``DenseOperator``, ``AdjointOperator``
and ``as_linear_operator``. A ``DenseOperator`` may wrap a (B, m, n) stack:
``shape`` is then the shape of one block, ``batch_shape`` is ``(B,)`` and
every product acts block by block.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.dtypes import herm

__all__ = ["LinearOperator", "DenseOperator", "AdjointOperator",
           "as_linear_operator"]


class LinearOperator:
    """Base class for matrix-free operators.

    Subclasses implement ``matmat``, ``conj_matmat`` (for the algorithms
    that need the adjoint), and the ``shape``, ``dtype`` and ``device``
    properties.
    """

    @property
    def shape(self) -> tuple[int, int]:
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    @property
    def batch_shape(self) -> tuple[int, ...]:
        """Leading batch axes of the operator (``()`` for one matrix)."""
        return ()

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """Return ``A @ x`` for a (ncols, k) matrix ``x``."""
        raise NotImplementedError

    def conj_matmat(self, x: torch.Tensor) -> torch.Tensor:
        """Return ``A^H @ x`` for a (nrows, k) matrix ``x``."""
        raise NotImplementedError

    def to_dense(self) -> torch.Tensor:
        """Materialize the operator as a dense matrix (A @ I)."""
        return self.matmat(torch.eye(self.ncols, dtype=self.dtype,
                                     device=self.device))

    def has_cheap_dense(self) -> bool:
        """True when ``to_dense`` is a cheap view rather than the derived
        full-read fallback ``matmat(eye(n))``: the one-read sketched IDs
        then gather k columns from it instead of a one-hot product."""
        return type(self).to_dense is not LinearOperator.to_dense


class DenseOperator(LinearOperator):
    """A dense (m, n) tensor, or a (B, m, n) stack, as a ``LinearOperator``."""

    def __init__(self, a):
        a = torch.as_tensor(a)
        if a.ndim < 2:
            raise ValueError(
                f"DenseOperator needs a matrix, got shape {tuple(a.shape)}")
        self.a = a

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.a.shape[-2:])

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.a.shape[:-2])

    @property
    def dtype(self) -> torch.dtype:
        return self.a.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self.a @ x

    def conj_matmat(self, x: torch.Tensor) -> torch.Tensor:
        return herm(self.a) @ x

    def to_dense(self) -> torch.Tensor:
        return self.a


class AdjointOperator(LinearOperator):
    """``A = B^H``: swaps the two protocol products."""

    def __init__(self, op):
        self.op = as_linear_operator(op)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.op.ncols, self.op.nrows)

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return self.op.batch_shape

    @property
    def dtype(self) -> torch.dtype:
        return self.op.dtype

    @property
    def device(self) -> torch.device:
        return self.op.device

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.conj_matmat(x)

    def conj_matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.matmat(x)

    def to_dense(self) -> torch.Tensor:
        return herm(self.op.to_dense())

    def has_cheap_dense(self) -> bool:
        return self.op.has_cheap_dense()


def as_linear_operator(op) -> LinearOperator:
    """Coerce a tensor, numpy array or operator to a ``LinearOperator``."""
    if isinstance(op, LinearOperator):
        return op
    if isinstance(op, (torch.Tensor, np.ndarray)):
        return DenseOperator(op)
    raise TypeError(
        f"cannot interpret {type(op).__name__} as a linear operator; "
        "expected a tensor, a numpy array or a LinearOperator")
