"""Triangular solves for interpolative-decomposition coefficients (port of
``rusty_compression_tpu.ops.triangular``).

The whole right-hand-side block is solved in one BLAS-3-shaped call,
``torch.linalg.solve_triangular`` (trsm), batched over leading axes.
The JAX package's Neumann-product triangular inverse is not ported: it
existed only because XLA's TPU trsm ran its matmuls at bf16.
"""

from __future__ import annotations

import torch

__all__ = ["solve_upper_triangular", "solve_lower_triangular",
           "triangular_solve"]


def triangular_solve(r: torch.Tensor, b: torch.Tensor, *,
                     left_side: bool = True,
                     lower: bool = False) -> torch.Tensor:
    """Solve ``r @ x = b`` (``left_side``) or ``x @ r = b`` with triangular
    ``r``; batched over leading axes."""
    return torch.linalg.solve_triangular(r, b, upper=not lower,
                                         left=left_side)


def solve_upper_triangular(r: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``r @ x = b`` with ``r`` upper triangular, ``b`` (k, j)."""
    return triangular_solve(r, b, left_side=True, lower=False)


def solve_lower_triangular(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``l @ x = b`` with ``l`` lower triangular, ``b`` (k, j)."""
    return triangular_solve(l, b, left_side=True, lower=True)
