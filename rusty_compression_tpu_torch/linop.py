"""Matrix-free linear operator protocol (port of ``rusty_compression_tpu.linop``).

An operator exposes ``A @ X`` (``matmat``, one GEMM) and ``A^H @ X``
(``conj_matmat``); the sampling routines are written against this
protocol.

``matmat`` is the required primitive (one GEMM) and ``matvec`` is derived
from it; ``FunctionOperator`` goes the other way for a caller who has only
a ``matvec`` closure. Every operator also says where it lives (``device``),
because the samplers draw their Gaussian matrices there. A
``DenseOperator`` may wrap a (B, m, n) stack: ``shape`` is then the shape
of one block, ``batch_shape`` is ``(B,)`` and every product acts block by
block.

Operators: ``DenseOperator``, ``FactoredOperator`` (a factor container),
``FunctionOperator`` (closures), ``SparseOperator`` (``torch.sparse``; the
JAX package's is BCOO), and the algebra ``CompositeOperator`` (``A @ B``),
``SumOperator`` (``A + B``), ``ScaledOperator`` (``alpha * A``),
``AdjointOperator`` (``A.H``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .utils.dtypes import herm

__all__ = ["LinearOperator", "DenseOperator", "FactoredOperator",
           "FunctionOperator", "CompositeOperator", "SumOperator",
           "ScaledOperator", "AdjointOperator", "SparseOperator",
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

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` for a vector ``x`` (derived from ``matmat``)."""
        return self.matmat(x[..., :, None])[..., 0]

    def conj_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``A^H @ x`` for a vector ``x`` (derived from ``conj_matmat``)."""
        return self.conj_matmat(x[..., :, None])[..., 0]

    def to_dense(self) -> torch.Tensor:
        """Materialize the operator as a dense matrix (A @ I)."""
        return self.matmat(torch.eye(self.ncols, dtype=self.dtype,
                                     device=self.device))

    def has_cheap_dense(self) -> bool:
        """True when ``to_dense`` is a cheap view rather than the derived
        full-read fallback ``matmat(eye(n))``: the one-read sketched IDs
        then gather k columns from it instead of a one-hot product."""
        return type(self).to_dense is not LinearOperator.to_dense

    def __matmul__(self, other):
        if isinstance(other, LinearOperator) or (
                hasattr(other, "apply") and hasattr(other, "conj_apply")):
            return CompositeOperator(self, other)
        return self.matmat(other)

    def __add__(self, other):
        return SumOperator(self, other)

    def __mul__(self, alpha):
        return ScaledOperator(alpha, self)

    __rmul__ = __mul__

    @property
    def H(self):
        """The adjoint operator ``A^H``."""
        return AdjointOperator(self)


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


class FactoredOperator(LinearOperator):
    """A factorization container viewed as a matrix-free operator.

    Wraps anything that has ``apply`` / ``conj_apply`` / ``nrows`` /
    ``ncols`` (``SVD`` and the three ID containers), so that factored forms
    go back into the sampling pipelines: recompressing a rank-200 two-sided
    ID to rank 50 costs O((m + n) k) a product and never assembles the
    matrix.
    """

    def __init__(self, factors):
        for attr in ("apply", "conj_apply", "nrows", "ncols"):
            if not hasattr(factors, attr):
                raise TypeError(
                    f"{type(factors).__name__} does not expose {attr}; "
                    "not a factorization container")
        self.factors = factors

    @functools.cached_property
    def _leaf(self) -> torch.Tensor:
        """The container's first tensor: its dtype, device and batch axes
        stand for the whole container."""
        for value in vars(self.factors).values():
            if isinstance(value, torch.Tensor) and value.ndim >= 2:
                return value
        raise TypeError(f"{type(self.factors).__name__} holds no matrix")

    @property
    def shape(self) -> tuple[int, int]:
        return (self.factors.nrows, self.factors.ncols)

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self._leaf.shape[:-2])

    @property
    def dtype(self) -> torch.dtype:
        return self._leaf.dtype

    @property
    def device(self) -> torch.device:
        return self._leaf.device

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self.factors.apply(x)

    def conj_matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self.factors.conj_apply(x)

    def to_dense(self) -> torch.Tensor:
        return self.factors.to_mat()


class FunctionOperator(LinearOperator):
    """Operator from ``matvec`` closures: the minimum protocol.

    ``matmat`` is derived by ``torch.func.vmap`` over the columns of ``X``,
    so the closure has to be something ``vmap`` can transform: no in-place
    write into a captured tensor and no branch on a tensor's value
    (``vmap`` raises on both, and this class lets it). ``conj_matvec`` is
    optional: without it the operator serves ``sample_range_by_rank`` and
    plain products; power iteration, adaptive sampling and the
    range-estimate factorizations need the adjoint and raise a named
    error.

    The closures decide where the products run; ``device`` says where the
    samplers make the matrices they feed them: the card unless the caller
    names another device.
    """

    def __init__(self, matvec, shape, dtype: torch.dtype | None = None,
                 conj_matvec=None, device="cuda"):
        self._matvec = matvec
        self._conj_matvec = conj_matvec
        self._shape = (int(shape[0]), int(shape[1]))
        self._dtype = torch.float32 if dtype is None else dtype
        self._device = torch.device(device)

    @property
    def shape(self) -> tuple[int, int]:
        return self._shape

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self._device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._matvec(x)

    def conj_matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self._conj_matvec is None:
            raise NotImplementedError(
                "FunctionOperator was built without conj_matvec; power "
                "iteration, adaptive sampling, and the range-estimate "
                "factorizations need the adjoint action A^H x")
        return self._conj_matvec(x)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        return torch.func.vmap(self._matvec, in_dims=1, out_dims=1)(x)

    def conj_matmat(self, x: torch.Tensor) -> torch.Tensor:
        if self._conj_matvec is None:
            self.conj_matvec(x[:, 0])  # raises the named error
        return torch.func.vmap(self._conj_matvec, in_dims=1, out_dims=1)(x)


class CompositeOperator(LinearOperator):
    """Product ``A = L @ R`` of two operators, applied factored: the
    samplers then cost ``O((cost_L + cost_R) k)`` and never form the
    product."""

    def __init__(self, left, right):
        left, right = as_linear_operator(left), as_linear_operator(right)
        if left.ncols != right.nrows:
            raise ValueError(
                f"cannot compose {left.shape} @ {right.shape}")
        self.left, self.right = left, right

    @property
    def shape(self) -> tuple[int, int]:
        return (self.left.nrows, self.right.ncols)

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(torch.broadcast_shapes(self.left.batch_shape,
                                            self.right.batch_shape))

    @property
    def dtype(self) -> torch.dtype:
        return torch.promote_types(self.left.dtype, self.right.dtype)

    @property
    def device(self) -> torch.device:
        return self.left.device

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self.left.matmat(self.right.matmat(x))

    def conj_matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self.right.conj_matmat(self.left.conj_matmat(x))


class SumOperator(LinearOperator):
    """Sum ``A = B + C + ...`` of conforming operators (e.g. a sparse near
    field plus a low-rank far field)."""

    def __init__(self, *terms):
        terms = tuple(as_linear_operator(t) for t in terms)
        if not terms:
            raise ValueError("SumOperator needs at least one term")
        if len({t.shape for t in terms}) != 1:
            raise ValueError(
                f"shape mismatch: {[t.shape for t in terms]}")
        self.terms = terms

    @property
    def shape(self) -> tuple[int, int]:
        return self.terms[0].shape

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(torch.broadcast_shapes(
            *(t.batch_shape for t in self.terms)))

    @property
    def dtype(self) -> torch.dtype:
        return functools.reduce(torch.promote_types,
                                (t.dtype for t in self.terms))

    @property
    def device(self) -> torch.device:
        return self.terms[0].device

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        out = self.terms[0].matmat(x)
        for t in self.terms[1:]:
            out = out + t.matmat(x)
        return out

    def conj_matmat(self, x: torch.Tensor) -> torch.Tensor:
        out = self.terms[0].conj_matmat(x)
        for t in self.terms[1:]:
            out = out + t.conj_matmat(x)
        return out


class ScaledOperator(LinearOperator):
    """``A = alpha * B`` for a scalar ``alpha``; a complex scalar times a
    real operator is a complex operator (promotion, not coercion)."""

    def __init__(self, alpha, op):
        self.op = as_linear_operator(op)
        like = torch.empty(1, dtype=self.op.dtype)
        self.alpha = torch.as_tensor(alpha).to(
            dtype=torch.result_type(like, alpha), device=self.op.device)
        if self.alpha.ndim:
            raise ValueError("ScaledOperator takes a scalar, got shape "
                             f"{tuple(self.alpha.shape)}")

    @property
    def shape(self) -> tuple[int, int]:
        return self.op.shape

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return self.op.batch_shape

    @property
    def dtype(self) -> torch.dtype:
        return self.alpha.dtype

    @property
    def device(self) -> torch.device:
        return self.op.device

    def _inner(self, product, x: torch.Tensor) -> torch.Tensor:
        """``product(x)``; a real operator under a complex scalar meets
        complex ``x`` and acts on its two planes (``torch.matmul`` does not
        promote)."""
        if x.is_complex() and not self.op.dtype.is_complex:
            return torch.complex(product(x.real), product(x.imag))
        return product(x)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha * self._inner(self.op.matmat, x)

    def conj_matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha.conj() * self._inner(self.op.conj_matmat, x)


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


class SparseOperator(LinearOperator):
    """A sparse matrix as an operator, through ``torch.sparse`` (the JAX
    package's is BCOO). Products cost O(nnz k); with the algebra above this
    covers "sparse near field + low-rank far field":
    ``SumOperator(SparseOperator(S), FactoredOperator(F))``.

    Takes a torch sparse tensor of any layout, a ``scipy.sparse`` matrix,
    or a dense tensor or array (whose zeros are dropped). The matrix and
    its conjugate transpose are both kept, as coalesced COO tensors, built
    once here: the adjoint of a sparse tensor is not available for every
    layout and dtype on the card, and a transposed product would densify.
    A torch tensor is taken where it lies; a host matrix (scipy, array) is
    put on ``device``, the card unless the caller asks for the CPU.
    """

    def __init__(self, a, device="cuda"):
        if _is_scipy_sparse(a):
            coo = a.tocoo()
            a = torch.sparse_coo_tensor(
                torch.as_tensor(np.stack([coo.row, coo.col]),
                                dtype=torch.int64, device=device),
                torch.as_tensor(coo.data, device=device), coo.shape,
                check_invariants=True)
        elif not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a, device=device)
        if a.ndim != 2:
            raise ValueError(f"expected a sparse matrix, got ndim {a.ndim}")
        a = a.to_sparse_coo().coalesce()
        self.a = a
        self.a_h = torch.sparse_coo_tensor(
            a.indices().flip(0), a.values().conj_physical(),
            (a.shape[1], a.shape[0]), check_invariants=False).coalesce()

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.a.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.a.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sparse.mm(self.a, x)

    def conj_matmat(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sparse.mm(self.a_h, x)

    def to_dense(self) -> torch.Tensor:
        return self.a.to_dense()


def _is_scipy_sparse(a) -> bool:
    """Whether ``a`` is a ``scipy.sparse`` matrix or array, without
    importing scipy for every other input."""
    return type(a).__module__.startswith("scipy.sparse")


def as_linear_operator(op, device="cuda") -> LinearOperator:
    """Coerce a tensor, an array, a sparse matrix (torch or scipy), an
    operator or a factorization container to a ``LinearOperator``. What
    lies on the host as no tensor (a numpy array, a ``scipy.sparse``
    matrix) is put on ``device``, the card unless the caller asks for the
    CPU; tensors and operators stay where they are."""
    if isinstance(op, LinearOperator):
        return op
    if hasattr(op, "apply") and hasattr(op, "conj_apply"):
        return FactoredOperator(op)
    if _is_scipy_sparse(op) or (isinstance(op, torch.Tensor)
                                and op.layout != torch.strided):
        return SparseOperator(op, device=device)
    try:
        if isinstance(op, np.ndarray):
            op = torch.as_tensor(op, device=device)
        return DenseOperator(op)
    except (TypeError, ValueError, RuntimeError) as e:
        raise TypeError(
            f"cannot interpret {type(op).__name__} as a linear operator; "
            "expected a tensor, an array, a sparse matrix, a "
            "LinearOperator, or a factorization container with "
            "apply/conj_apply (QR/LQ containers have no factored apply: "
            "convert via to_mat() or column_id()/row_id())") from e
