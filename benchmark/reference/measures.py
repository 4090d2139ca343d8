"""What the check measures on a factorization of one block, in float64,
from the block itself and the factors the program returned.

Every function takes one block ``a`` (m, n) of any real dtype and works
through it in panels of rows, so that no second block-sized float64 tensor
is held; the block is read as it is (its own dtype), and each product is
formed in float64.
"""

from __future__ import annotations

import torch

ROWS = 2048   # rows of the block a panel holds in float64


def _panels(m: int):
    for r0 in range(0, m, ROWS):
        yield slice(r0, min(m, r0 + ROWS))


def fro(a: torch.Tensor) -> float:
    """||a||_F in float64."""
    return sum(float(torch.linalg.vector_norm(a[s].double()) ** 2)
               for s in _panels(a.shape[0])) ** 0.5


def rel_resid(a: torch.Tensor, left: torch.Tensor,
              right: torch.Tensor) -> float:
    """``||a - left @ right||_F / ||a||_F``, with ``left`` (m, k) and
    ``right`` (k, n) taken in float64."""
    left, right = left.double(), right.double()
    num = sum(float(torch.linalg.vector_norm(a[s].double() - left[s] @ right)
                    ** 2) for s in _panels(a.shape[0]))
    return num ** 0.5 / fro(a)


def proj_resid(a: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
               vt: torch.Tensor) -> float:
    """``||U^T a - diag(s) Vt||_F / ||a||_F``: zero in exact arithmetic
    for a truncated SVD taken from ``B = Q^T a`` with ``U = Q Uhat``."""
    u = u.double()
    uta = sum(u[p].T @ a[p].double() for p in _panels(a.shape[0]))
    return float(torch.linalg.vector_norm(
        uta - s.double()[:, None] * vt.double())) / fro(a)


def orth_err(x: torch.Tensor) -> float:
    """``max |X^T X - I|`` of the columns of ``x`` (m, k)."""
    x = x.double()
    eye = torch.eye(x.shape[1], dtype=torch.float64, device=x.device)
    return float((x.T @ x - eye).abs().max())


def gather(a: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """``a[rows][:, cols]`` in ``a``'s dtype."""
    return a[rows.long()][:, cols.long()]


def is_index_set(ind: torch.Tensor, size: int, k: int) -> bool:
    """The first ``k`` entries of ``ind`` are distinct indices below
    ``size``."""
    head = ind[:k].long()
    return (head.numel() == k and bool((head >= 0).all())
            and bool((head < size).all())
            and int(torch.unique(head).numel()) == k)


def identity_err(x: torch.Tensor) -> float:
    """``max |x - I|`` of a square ``x``."""
    eye = torch.eye(x.shape[0], dtype=torch.float64, device=x.device)
    return float((x.double() - eye).abs().max())
