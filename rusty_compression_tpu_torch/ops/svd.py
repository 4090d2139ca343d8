"""Economy SVD backend (port of ``rusty_compression_tpu.ops.svd``).

* ``"direct"`` — full accuracy; the default. ``torch.linalg.svd``; a real
  f32 / f64 card stack whose long side is at least twice its short one k,
  and whose tall orientation K5 (``ops/kernels/tsqr.py``) takes, is
  factored as K5's QR of that orientation and one batched SVD of the
  (k, k) factor (``_svd_through_qr``).
* ``"gram"`` — eigendecomposition of the smaller Gram matrix, then the
  other factor by one GEMM. Faster for wide/tall matrices; singular
  values below ``sqrt(eps) * s_max`` are inaccurate.

The JAX package's host branch for complex input is not ported: it exists
because the TPU rejects complex dtypes, and the card does not.
"""

from __future__ import annotations

import math

import torch

from ..utils.dtypes import herm, real_dtype
from ..utils.precision import with_precision
from .kernels import tsqr

__all__ = ["compute_svd"]


def _gram_svd(a: torch.Tensor):
    """Economy SVD via EVD of the smaller Gram matrix (GEMM + eigh)."""
    m, n = a.shape[-2:]
    rdt = real_dtype(a.dtype)
    g = a @ herm(a) if m <= n else herm(a) @ a
    w, x = torch.linalg.eigh(g)              # ascending eigenvalues
    w = torch.flip(w, dims=(-1,))
    x = torch.flip(x, dims=(-1,))
    s = torch.sqrt(torch.clamp(w, min=0)).to(rdt)
    inv_s = torch.where(s > 0, 1.0 / torch.where(s > 0, s, 1.0), 0.0)
    inv_s = inv_s.to(a.dtype)
    if m <= n:
        return x, s, (herm(x) @ a) * inv_s[..., :, None]
    return (a @ x) * inv_s[..., None, :], s, herm(x)


def _svd_through_qr(a: torch.Tensor):
    """Economy SVD of a real f32 / f64 (..., m, n) through the thin QR of
    its tall orientation ``y`` (``a^H`` when m < n, else ``a``): ``y = Q R``
    by ``tsqr.tsqr`` (K5 on the card, its plain version on the CPU), one
    batched SVD of the (..., k, k) factor (``R^H`` or ``R``), and one thin
    GEMM that lifts it: ``vt = W^H Q^H`` (wide) or ``u = Q U`` (tall). The
    same work as cuSOLVER's ``gesvdj`` of a long matrix, which also takes a
    Householder QR of the long side before its Jacobi sweeps, with the QR
    for the whole stack in one call."""
    *lead, m, n = a.shape
    k = min(m, n)
    wide = m < n
    y = (herm(a) if wide else a).reshape(math.prod(lead), max(m, n), k)
    q, r = tsqr.tsqr(y, want_r=True)
    q = q.reshape(*lead, max(m, n), k)
    r = r.reshape(*lead, k, k)
    if wide:
        u, s, wh = torch.linalg.svd(herm(r))
        return u, s, wh @ herm(q)
    u, s, vt = torch.linalg.svd(r)
    return q @ u, s, vt


def _through_qr_takes(a: torch.Tensor) -> bool:
    """Whether ``compute_svd(a, "direct")`` takes ``_svd_through_qr``: K5
    takes ``a``'s tall orientation (a real f32 / f64 tensor on the card, k =
    min(m, n) <= 128, ``tsqr.kernel_takes``' rule for single panels) and
    its long side is at least twice k (for a square core a QR first only
    doubles the work). Reads only the device, the dtype and the shape."""
    *lead, m, n = a.shape
    k = min(m, n)
    return (max(m, n) >= 2 * k
            and tsqr.kernel_takes(a.device, a.dtype, math.prod(lead),
                                  max(m, n), k))


@with_precision
def compute_svd(a: torch.Tensor, method: str = "direct"):
    """Economy SVD ``a = u @ diag(s) @ vt`` over the last two axes, with
    ``s`` real and descending. ``method`` is ``"direct"`` or ``"gram"``.
    ``compute_svd.through_qr_count`` counts the calls that took
    ``_svd_through_qr``."""
    if method == "direct":
        if _through_qr_takes(a):
            compute_svd.through_qr_count += 1
            return _svd_through_qr(a)
        return torch.linalg.svd(a, full_matrices=False)
    if method == "gram":
        return _gram_svd(a)
    raise ValueError(f"unknown SVD method {method!r}")


compute_svd.through_qr_count = 0
