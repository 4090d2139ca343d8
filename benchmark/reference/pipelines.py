"""Plain reference pipelines of the three entries the cells time, in the
dtype of their input.

They follow the published algorithms, not the port's code:

* the growth capture (Halko, Martinsson and Tropp's range finder, run in
  rounds on the exact residual ``R = A - Q Q^T A`` until ``||R||_F /
  ||A||_F <= tol / 2``; widths 32, 32, then doubling to 256, one power
  iteration a round, the new block deflated twice against the basis);
* column-pivoted QR by LAPACK's ``?geqp3`` on the host (SciPy);
* the interpolative decomposition ``Z = [I | R11^-1 R12] P^T`` of the
  core, the row ID of the skeleton columns through the pivoted QR of
  ``C^T``, and the skeleton gathered from A;
* the core's SVD by LAPACK on the host;
* the fixed-rank randomized SVD of a stack, block by block.

Departures: a capture stops at ``cap`` columns (1024) and the pipeline
goes on with what it has, where the program raises or grows on; at the
float64 tolerance of the cells the cap is never reached (the program's
captures end at 256 columns), and the float32 control reaches it. Where no
``|r_ii / r_00|`` (or ``s_i / s_0``) falls below ``tol``, every captured
direction is kept.

Put in the program's place in a lower precision than the configuration's,
these are a cell's control (``cells/*.json``). Matmuls run without the
card's TF32; ``tf32=True`` rounds both operands of every matrix product to
TF32's ten bits of mantissa (to nearest) and accumulates in float32, which
is what the tensor cores compute in TF32, whatever kernel the library
would pick.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import scipy.linalg
import torch

CAP = 1024


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to the nearest TF32 value (ten explicit bits
    of mantissa)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32_: bool) -> torch.Tensor:
    return tf32(a) @ tf32(b) if tf32_ else a @ b


def _orth(y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(y)[0]


def _widths(cap: int):
    l, total = 32, 0
    while total < cap:
        w = min(l, cap - total)
        yield w
        total += w
        if total >= 64:
            l = min(2 * l, 256)


def growth_capture(a: torch.Tensor, gen: torch.Generator, tol: float,
                   cap: int = CAP, power_iters: int = 1) -> torch.Tensor:
    """An orthonormal basis Q (m, L) with ``||A - Q Q^T A||_F <= tol / 2
    ||A||_F``, or L = cap."""
    _no_tf32()
    m, n = a.shape
    cap = min(cap, m, n)
    norm_a = torch.linalg.matrix_norm(a)
    basis = a.new_zeros((m, 0))
    r = a.clone()
    for l in _widths(cap):
        omega = torch.randn((n, l), generator=gen, dtype=a.dtype,
                            device=a.device)
        y = r @ omega
        for _ in range(power_iters):
            y = r @ _orth(r.T @ _orth(y))
        q = _orth(y)
        for _ in range(2):
            q = _orth(q - basis @ (basis.T @ q))
        basis = torch.cat([basis, q], dim=1)
        r = r - q @ (q.T @ r)
        if float(torch.linalg.matrix_norm(r) / norm_a) <= 0.5 * tol:
            break
    return _orth(basis)


def _geqp3(x: torch.Tensor):
    """``(r, perm)`` of LAPACK's column-pivoted QR of ``x`` on the host."""
    r, perm = scipy.linalg.qr(x.detach().cpu().numpy(), mode="r",
                              pivoting=True)
    return r, perm


def _cut(d: np.ndarray, tol: float) -> int:
    """Rank before the first ``d_i / d_0 < tol`` of the suffix-max
    envelope; all of them where none falls below."""
    ratios = np.abs(d) / max(abs(d[0]), np.finfo(np.float64).tiny)
    below = np.maximum.accumulate(ratios[::-1])[::-1] < tol
    return int(np.argmax(below)) if below.any() else d.shape[0]


def _id_coefficients(r: np.ndarray, perm: np.ndarray, k: int, n: int):
    """``Z`` (k, n) with ``Z[:, perm] = [I | R11^-1 R12]``."""
    zp = np.eye(k, n, dtype=r.dtype)
    if k < n:
        zp[:, k:] = scipy.linalg.solve_triangular(r[:k, :k], r[:k, k:n])
    z = np.empty_like(zp)
    z[:, perm] = zp
    return z


def refined_two_sided_id(a: torch.Tensor, gen: torch.Generator, tol: float,
                         cap: int = CAP) -> SimpleNamespace:
    """``A ~= C X R`` at ``tol``: the column ID of A from its core, then the
    row ID of its skeleton columns; X gathered from A."""
    m, n = a.shape
    q = growth_capture(a, gen, tol, cap)
    r, perm = _geqp3(q.T @ a)
    k = _cut(np.diag(r), tol)
    z = _id_coefficients(r, perm, k, n)
    cols = torch.as_tensor(perm[:k].copy(), device=a.device)
    c = a[:, cols]
    rc, permc = _geqp3(c.T)
    xc = _id_coefficients(rc, permc, k, m).T
    rows = torch.as_tensor(permc[:k].copy(), device=a.device)
    dev = a.device
    return SimpleNamespace(
        c=torch.as_tensor(xc, device=dev), x=a[rows][:, cols],
        r=torch.as_tensor(z, device=dev),
        row_ind=torch.as_tensor(permc, device=dev),
        col_ind=torch.as_tensor(perm, device=dev))


def refined_rsvd(a: torch.Tensor, gen: torch.Generator, tol: float,
                 cap: int = CAP) -> SimpleNamespace:
    """``A ~= U diag(s) Vt`` at ``tol``: the SVD of the captured core, cut
    before the first ``s_i / s_0 < tol``."""
    q = growth_capture(a, gen, tol, cap)
    uh, s, vt = np.linalg.svd((q.T @ a).cpu().numpy(), full_matrices=False)
    k = _cut(s, tol)
    dev = a.device
    return SimpleNamespace(u=q @ torch.as_tensor(uh[:, :k], device=dev),
                           s=torch.as_tensor(s[:k], device=dev),
                           vt=torch.as_tensor(vt[:k], device=dev))


def rsvd(a: torch.Tensor, gen: torch.Generator, rank: int,
         oversample: int = 5, tf32: bool = False) -> SimpleNamespace:
    """The fixed-rank randomized SVD of each block of a (B, m, n) stack:
    ``Q = qr(A Omega)``, the SVD of ``Q^T A``, ``U = Q Uhat``."""
    _no_tf32()
    u, s, vt = [], [], []
    for blk in a:
        omega = torch.randn((blk.shape[1], rank + oversample), generator=gen,
                            dtype=a.dtype, device=a.device)
        q = _orth(_mm(blk, omega, tf32))
        uh, sb, vb = torch.linalg.svd(_mm(q.T, blk, tf32),
                                      full_matrices=False)
        u.append(_mm(q, uh[:, :rank], tf32))
        s.append(sb[:rank])
        vt.append(vb[:rank])
    return SimpleNamespace(u=torch.stack(u), s=torch.stack(s),
                           vt=torch.stack(vt))
