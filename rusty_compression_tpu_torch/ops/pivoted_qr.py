"""Rank-revealing column-pivoted QR (port of ``rusty_compression_tpu.ops.pivoted_qr``).

Modes:

* ``"gs"`` — pivoted Gram–Schmidt QRCP in plain PyTorch: the classical
  max-residual-norm pivot rule with norm downdating and one
  reorthogonalization pass (``qrcp_panel_plain``, the port of the JAX
  ``_qrcp_gs``).
* ``"kernel"`` — the same pivot rule in one hand-written CUDA kernel
  (K1, ``ops/kernels/qrcp.py``); takes the place of the JAX package's
  ``"pallas"`` mode. f32 only.
* ``"blocked"`` — randomized blocked RRQR; not ported yet (ROADMAP.md,
  "Still to port", item 1) and raises ``NotImplementedError``.

Output contract: ``a[..., :, ind] ~= q @ r`` with q (..., m, k) orthonormal
columns, r (..., k, n) upper triangular with non-increasing ``|r_ii|``,
and ind (..., n) int64: position ``j`` holds original column ``ind[j]``.
Leading axes are a batch of independent matrices; one kernel launch
covers the whole batch.
"""

from __future__ import annotations

import torch

from ..utils.precision import with_precision
from .kernels.qrcp import kernel_fits, qrcp_panel, qrcp_panel_plain

__all__ = ["pivoted_qr", "pivoted_lq"]


def _full_permutation(piv: torch.Tensor, n: int) -> torch.Tensor:
    """Extend the k chosen pivots (..., k) to a full length-n permutation:
    chosen pivots first (selection order), then the unchosen columns
    ascending."""
    k = piv.shape[-1]
    if k == n:
        return piv
    used = torch.zeros((*piv.shape[:-1], n), dtype=torch.uint8,
                       device=piv.device).scatter(-1, piv, 1)
    # A stable sort of the mask puts the unchosen columns first, ascending.
    rest = torch.argsort(used, dim=-1, stable=True)
    return torch.cat([piv, rest[..., :n - k]], dim=-1)


def _resolve_mode(mode: str, m: int, n: int, k: int, dtype: torch.dtype,
                  device: torch.device) -> str:
    """Resolve ``"auto"`` with the JAX package's thresholds: the fused
    kernel where the JAX package picked Pallas (f32 on the accelerator,
    small rank or width, fits the kernel), the plain loop for f64 or the
    CPU up to n = 512, the blocked RRQR beyond."""
    if mode != "auto":
        return mode
    if k <= 64 or n <= 128:
        if (dtype == torch.float32 and device.type == "cuda"
                and kernel_fits(m, k)):
            return "kernel"
        if n <= 512:
            return "gs"
    return "blocked"


@with_precision
def pivoted_qr(a: torch.Tensor, max_rank: int | None = None, *,
               mode: str = "auto"):
    """Column-pivoted (rank-revealing) QR: ``a[..., :, ind] ~= q @ r``.

    Args:
      a: (..., m, n) matrix or batch (f32/f64/c64/c128).
      max_rank: number of factorization steps; ``None`` means the full
        ``min(m, n)``.
      mode: ``"gs"``, ``"kernel"``, ``"blocked"`` (not ported) or
        ``"auto"`` (see the module docstring).

    Returns:
      ``(q, r, ind)`` — q (..., m, k), r (..., k, n) upper triangular over
      the permuted columns, ind (..., n) int64.
    """
    if a.ndim < 2:
        raise ValueError(
            f"pivoted_qr expects a matrix, got shape {tuple(a.shape)}")
    m, n = a.shape[-2:]
    k = min(m, n) if max_rank is None else min(int(max_rank), m, n)
    mode = _resolve_mode(mode, m, n, k, a.dtype, a.device)
    if mode == "gs":
        q, r_orig, piv = qrcp_panel_plain(a, k)
    elif mode == "kernel":
        q, r_orig, piv = qrcp_panel(a.contiguous(), k)
        piv = piv.long()
    elif mode == "blocked":
        raise NotImplementedError(
            "pivoted_qr mode 'blocked' (randomized blocked RRQR, "
            "_qrcp_blocked) is not ported yet: ROADMAP.md, 'Still to port', "
            "item 1")
    else:
        raise ValueError(f"unknown pivoted_qr mode: {mode!r}")
    ind = _full_permutation(piv, n)
    r = torch.triu(torch.take_along_dim(r_orig, ind.unsqueeze(-2), dim=-1))
    return q, r, ind


def pivoted_lq(a: torch.Tensor, max_rank: int | None = None, **kwargs):
    """Pivoted LQ: ``a[..., ind, :] ~= l @ q`` with ``l`` lower triangular,
    the conjugate transpose of the pivoted QR of ``a^H``."""
    q, r, ind = pivoted_qr(a.mH, max_rank, **kwargs)
    return r.mH, q.mH, ind
