"""tol <= 1e-8 interpolative decompositions in native float64 / complex128
(port of ``rusty_compression_tpu.highacc_id``).

1. **Capture** — ``highacc.refined_capture`` gives an orthonormal basis Q
   (m, L) and the core ``B = Q^H A`` (L, n) with ``||A - Q B||`` at the f64
   floor (fixed rounds) or just below ``tol`` (growth). All of the
   O(m n L) work.
2. **Pivot** — a column-pivoted QR of the small core on its device
   (``_core_qrcp``), with ``?geqp3``'s choice of pivots.
3. **Coefficients** — ``Z = [I | R11^{-1} R12] P^{-1}`` by one triangular
   solve. The skeleton columns (rows, submatrix) are gathered verbatim from
   A, so they are bitwise A's entries.

Error model: ``rel_err <= eps_cap (1 + ||Z||) + ||R22||_F / ||A||_F``.
Pivot conventions follow the JAX package: ``ind[j] = k`` means column j of
the factorization is column k of A.

The factors are the port's ``ColumnID`` / ``RowID`` / ``TwoSidedID`` with
f64/c128 tensors on the input's device (int64 index vectors). The JAX
package pivots on the host with LAPACK because its accelerator has no f64;
here the pivots are taken on the card, and ``_host_row_id_of_columns``
keeps its name though nothing of it runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .highacc import _as_wide, _read, refined_capture
from .models.interp_decomp import ColumnID, RowID, TwoSidedID
from .ops.pivoted_qr import _full_permutation
from .utils.errors import CompressionError

__all__ = ["refined_column_id", "refined_row_id", "refined_two_sided_id"]


def _core_qrcp(b: torch.Tensor):
    """Column-pivoted Gram–Schmidt QR of a small matrix, ``min(L, n)``
    steps: ``(r, ind)`` with ``b[:, ind] ~= q r``, ``r`` upper triangular.

    The pivot is the column of largest residual norm, as in ``?geqp3``,
    with the norms recomputed from the residual each step. The plain
    pivot rule (``qrcp_panel_plain``) downdates them, and at tol 1e-8 the
    squared norms it subtracts cancel to roundoff: on a captured core of
    ``hilbert(1024)`` it left ``?geqp3``'s pivots at step 14 of 16 (Laplace
    block, step 97 of 143). ``?geqp3`` recomputes a norm whenever its
    downdate has cancelled that far. One reorthogonalization pass per
    pivot column.
    """
    m, n = b.shape
    k = min(m, n)
    resid = b.resolve_conj()
    q = b.new_zeros((m, k))
    r = b.new_zeros((k, n))
    piv = torch.zeros(k, dtype=torch.int64, device=b.device)
    used = torch.zeros(n, dtype=torch.bool, device=b.device)
    for i in range(k):
        norms = torch.linalg.vector_norm(resid, dim=0).masked_fill(used, -1.0)
        j = torch.argmax(norms).reshape(1)  # the first of equal maxima
        v = resid.index_select(1, j)[:, 0]
        v = v - q @ (q.mH @ v)
        nv = torch.linalg.vector_norm(v)
        qi = v * torch.where(nv > 0, 1.0 / torch.where(nv > 0, nv, 1.0), 0.0)
        r_row = qi.conj() @ resid
        resid = resid - qi[:, None] * r_row[None, :]
        used.index_fill_(0, j, True)
        q[:, i] = qi
        r[i] = r_row
        piv[i:i + 1] = j
    ind = _full_permutation(piv, n)
    return torch.triu(r[:, ind]), ind


def _truncation_rank(diag: torch.Tensor, tol: float | None, rank: int | None,
                     growth_captured: bool) -> int:
    """Reference tolerance semantics on the core's R diagonal: truncate
    before the first ``|r_ii / r_00| < tol`` of the suffix-max envelope
    (robust to transient dips); ``CompressionError`` if it never drops
    below ``tol``, unless the growth capture certified the residual at the
    tolerance (the full core rank is then the answer)."""
    d = np.abs(np.asarray(_read(diag.abs())[0]))
    kf = d.shape[0]
    if tol is not None:
        ratios = d / max(d[0], np.finfo(np.float64).tiny)
        envelope = np.maximum.accumulate(ratios[::-1])[::-1]
        below = envelope < tol
        idx = int(np.argmax(below))
        if below[idx]:
            kf = idx
        elif not growth_captured:
            raise CompressionError(
                f"Could not compress to relative tolerance {tol!r}")
    if rank is not None:
        kf = min(kf, int(rank))
    return max(kf, 1)


def _interp_coefficients(rb: torch.Tensor, piv: torch.Tensor, kf: int,
                         n: int) -> torch.Tensor:
    """``Z = [I | R11^{-1} R12]`` inverse-column-permuted: one triangular
    solve and a scatter."""
    eye = torch.eye(kf, dtype=rb.dtype, device=rb.device)
    if kf < n:
        t = torch.linalg.solve_triangular(rb[:kf, :kf], rb[:kf, kf:],
                                          upper=True)
        zp = torch.cat([eye, t], dim=1)
    else:
        zp = eye
    z = torch.empty((kf, n), dtype=rb.dtype, device=rb.device)
    z[:, piv] = zp
    return z


def _column_id_from_core(a: torch.Tensor, b: torch.Tensor, tol, rank,
                         growth_captured: bool) -> ColumnID:
    """Column ID of A from its core ``B = Q^H A``: the pivots and
    coefficients of B carry over to A because ``A ~= Q B``."""
    rb, piv = _core_qrcp(b)
    kf = _truncation_rank(torch.diagonal(rb), tol, rank, growth_captured)
    z = _interp_coefficients(rb, piv, kf, a.shape[1])
    return ColumnID(a[:, piv[:kf]], z, piv)


def refined_column_id(a, generator: torch.Generator, rank: int | None = None,
                      tol: float | None = None,
                      **capture_kwargs) -> ColumnID:
    """Column ID ``A ~= C Z`` at the f64 accuracy class. ``C`` holds
    verbatim columns of ``A``; with ``tol`` alone the rank is discovered by
    the growth capture, ``rank=`` / ``round_rank=`` run fixed rounds.
    Raises ``CompressionError`` when the tolerance is unreachable.
    Further keywords go to ``refined_capture``."""
    a = _as_wide(a, generator)
    _, b, _, captured = refined_capture(a, generator, rank=rank, tol=tol,
                                        **capture_kwargs)
    growth = rank is None and capture_kwargs.get("round_rank") is None
    return _column_id_from_core(a, b, tol, rank, captured and growth)


def refined_row_id(a, generator: torch.Generator, rank: int | None = None,
                   tol: float | None = None, **capture_kwargs) -> RowID:
    """Row ID ``A ~= X R``: the conjugate-transposed column ID of ``A^H``.
    ``R`` holds verbatim rows of ``A``."""
    a = _as_wide(a, generator)
    cid = refined_column_id(a.mH, generator, rank=rank, tol=tol,
                            **capture_kwargs)
    row_ind = cid.col_ind
    return RowID(cid.z.mH.resolve_conj(), a[row_ind[:cid.rank], :], row_ind)


def _host_row_id_of_columns(c: torch.Tensor):
    """Row ID of a tall full-column-rank ``C`` (m, kf): pivoted LQ of C
    (the pivoted QR of ``C^H``), then ``X = [I; L21 L11^{-1}]``
    inverse-row-permuted. Returns ``(x, row_ind)``."""
    m, kf = c.shape
    rc, pivr = _core_qrcp(c.mH)
    x_perm = c.new_empty((m, kf))
    x_perm[:kf] = torch.eye(kf, dtype=c.dtype, device=c.device)
    if m > kf:
        # X2 L11 = L21 with L11 = rc[:, :kf]^H lower triangular
        x_perm[kf:] = torch.linalg.solve_triangular(
            rc[:, :kf].mH, rc[:, kf:].mH, upper=False, left=False)
    x = torch.empty_like(x_perm)
    x[pivr] = x_perm
    return x, pivr


def refined_two_sided_id(a, generator: torch.Generator,
                         rank: int | None = None, tol: float | None = None,
                         side: str = "col", **capture_kwargs) -> TwoSidedID:
    """Two-sided ID ``A ~= C X R`` at the f64 accuracy class; ``X`` is the
    verbatim skeleton ``A[row_ind[:k], col_ind[:k]]``. ``side="col"``: the
    column ID of A, then the row ID of its skeleton columns; ``side="row"``:
    the row ID of A, then the column ID of its skeleton rows."""
    if side not in ("col", "row"):
        raise ValueError(f"side must be 'col' or 'row', got {side!r}")
    a = _as_wide(a, generator)
    if side == "col":
        cid = refined_column_id(a, generator, rank=rank, tol=tol,
                                **capture_kwargs)
        kf = cid.rank
        x, pivr = _host_row_id_of_columns(cid.c)
        skel = a[pivr[:kf][:, None], cid.col_ind[:kf]]
        return TwoSidedID(c=x, x=skel, r=cid.z, row_ind=pivr,
                          col_ind=cid.col_ind)
    rid = refined_row_id(a, generator, rank=rank, tol=tol, **capture_kwargs)
    kf = rid.rank
    # the column ID of the skeleton rows R = A[I, :], exact: R has full
    # row rank kf
    rb, pivc = _core_qrcp(rid.r)
    z = _interp_coefficients(rb, pivc, kf, a.shape[1])
    skel = a[rid.row_ind[:kf][:, None], pivc[:kf]]
    return TwoSidedID(c=rid.x, x=skel, r=z, row_ind=rid.row_ind,
                      col_ind=pivc)
