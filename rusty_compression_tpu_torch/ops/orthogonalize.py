"""Tall-skinny orthonormalization (port of ``rusty_compression_tpu.ops.orthogonalize``).

* ``cholesky_qr`` / ``cholesky_qr2`` — CholeskyQR and CholeskyQR2
  (Yamamoto et al. 2015): Gram GEMM + small Cholesky + triangular solve.
* ``shifted_cholesky_qr3`` — shifted CholeskyQR3 (Fukaya et al. 2020),
  robust to cond(Y) ~ 1/sqrt(eps) and beyond.
* ``svqb`` — SVQB (Stathopoulos & Wu 2002): robust at any condition
  number, one small eigh per pass.
* ``qr`` — Householder (``torch.linalg.qr``).

``orthonormalize(method="auto")`` is Householder on both CPU and CUDA for
now (the TPU picked svqb because its Householder was slow; the choice for
the card waits for a measurement). The small Cholesky is
``torch.linalg.cholesky_ex``: the JAX package's pure-JAX Cholesky existed
only because XLA's TPU Cholesky ran its matmuls at bf16. ``nsqb`` waits
for the Newton–Schulz polar module.

All functions act on the last two axes and batch over leading ones.
"""

from __future__ import annotations

import torch

from ..utils.dtypes import eps, herm
from ..utils.precision import with_precision
from .triangular import triangular_solve

__all__ = ["cholesky_qr", "cholesky_qr2", "shifted_cholesky_qr3", "svqb",
           "orthonormalize"]


def _shift_magnitude(g: torch.Tensor, m: int) -> torch.Tensor:
    """Fukaya et al.'s sCholQR shift ``11 (m l + l (l+1)) eps ||G||_F``
    per matrix; guarantees ``G + s I`` is numerically PD for any
    numerically full-rank ``Y`` with ``m`` rows."""
    l = g.shape[-1]
    gnorm = torch.linalg.matrix_norm(g, ord="fro")
    return (11.0 * (m * l + l * (l + 1)) * eps(g.dtype)) * gnorm


def _chol(g: torch.Tensor, m: int, always_shift: bool = False):
    """Lower Cholesky of the (l, l) Gram matrix, guarded against
    breakdown: a matrix whose plain factorization fails (G indefinite
    under roundoff) takes the shifted factorization, which always
    exists. Decided per matrix of a batch."""
    s = _shift_magnitude(g, m)
    s = torch.where(s > 0, s, s + 1.0).to(g.dtype)
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    shifted = torch.linalg.cholesky_ex(g + s[..., None, None] * eye)[0]
    if always_shift:
        return shifted
    plain, info = torch.linalg.cholesky_ex(g)
    ok = (info == 0) & torch.isfinite(plain).all(-1).all(-1)
    return torch.where(ok[..., None, None], plain, shifted)


@with_precision
def cholesky_qr(y: torch.Tensor, always_shift: bool = False):
    """One CholeskyQR pass: ``G = Y^H Y``, ``R = chol(G)^H``,
    ``Q = Y R^{-1}``. Returns ``(q, r)``; breakdown-guarded."""
    g = herm(y) @ y
    r = herm(_chol(g, y.shape[-2], always_shift))
    return triangular_solve(r, y, left_side=False, lower=False), r


@with_precision
def cholesky_qr2(y: torch.Tensor):
    """CholeskyQR2: a second pass restores orthogonality to machine
    precision when the first pass was merely well-defined."""
    q1, r1 = cholesky_qr(y)
    q2, r2 = cholesky_qr(q1)
    return q2, r2 @ r1


@with_precision
def shifted_cholesky_qr3(y: torch.Tensor):
    """Shifted CholeskyQR + CholeskyQR2: the robust all-GEMM path."""
    q1, r1 = cholesky_qr(y, always_shift=True)
    q2, r2 = cholesky_qr2(q1)
    return q2, r2 @ r1


def svqb(y: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """SVQB orthonormalization: ``G = Y^H Y`` diagonally scaled,
    eigendecomposed, eigenvalues clipped at ``l * eps * lambda_max``,
    ``Q = Y D V L^{-1/2}``; dominant directions first."""
    l = y.shape[-1]
    for _ in range(passes):
        g = herm(y) @ y
        dg = torch.diagonal(g, dim1=-2, dim2=-1).real
        d = torch.where(dg > 0, torch.rsqrt(torch.clamp(dg, min=1e-30)), 1.0)
        d = d.to(y.dtype)
        gs = g * d[..., :, None] * d[..., None, :]
        lam, v = torch.linalg.eigh(gs)
        clip = l * eps(y.dtype) * torch.clamp(lam[..., -1:], min=1e-30)
        inv_sqrt = torch.rsqrt(torch.maximum(lam, clip)).to(y.dtype)
        y = (y * d[..., None, :]) @ (v * inv_sqrt[..., None, :])
        y = torch.flip(y, dims=(-1,))  # descending eigenvalue order
    return y


@with_precision
def orthonormalize(y: torch.Tensor, method: str = "auto",
                   passes: int | None = None) -> torch.Tensor:
    """Orthonormal basis of the columns of tall-skinny ``y``.

    ``method``: ``"auto"`` (Householder), ``"qr"``, ``"cholqr2"``,
    ``"scholqr3"``, ``"svqb"``. ``passes`` applies to svqb only.
    """
    if method in ("auto", "qr"):
        return torch.linalg.qr(y, mode="reduced")[0]
    if method == "cholqr2":
        return cholesky_qr2(y)[0]
    if method == "scholqr3":
        return shifted_cholesky_qr3(y)[0]
    if method == "svqb":
        return svqb(y) if passes is None else svqb(y, passes=passes)
    raise ValueError(f"unknown orthonormalization method {method!r}")
