"""Economy SVD backend (port of ``rusty_compression_tpu.ops.svd``).

* ``"direct"`` — ``torch.linalg.svd``: full accuracy; the default.
* ``"gram"`` — eigendecomposition of the smaller Gram matrix, then the
  other factor by one GEMM. Faster for wide/tall matrices; singular
  values below ``sqrt(eps) * s_max`` are inaccurate.

The JAX package's host branch for complex input is not ported: it exists
because the TPU rejects complex dtypes, and the card does not.
"""

from __future__ import annotations

import torch

from ..utils.dtypes import herm, real_dtype
from ..utils.precision import with_precision

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


@with_precision
def compute_svd(a: torch.Tensor, method: str = "direct"):
    """Economy SVD ``a = u @ diag(s) @ vt`` over the last two axes, with
    ``s`` real and descending. ``method`` is ``"direct"`` or ``"gram"``."""
    if method == "direct":
        return torch.linalg.svd(a, full_matrices=False)
    if method == "gram":
        return _gram_svd(a)
    raise ValueError(f"unknown SVD method {method!r}")
