"""Rank-revealing column-pivoted QR (port of ``rusty_compression_tpu.ops.pivoted_qr``).

Modes:

* ``"gs"`` — pivoted Gram–Schmidt QRCP in plain PyTorch: the classical
  max-residual-norm pivot rule with norm downdating and one
  reorthogonalization pass (``qrcp_panel_plain``, the port of the JAX
  ``_qrcp_gs``).
* ``"kernel"`` — the same pivot rule in one hand-written CUDA kernel
  (K1 for f32, K2 for c64, ``ops/kernels/qrcp.py``); takes the place of
  the JAX package's ``"pallas"`` mode.
* ``"blocked"`` — randomized blocked RRQR in the HQRRP family
  (Martinsson/Quintana-Ortí/Heavner/van de Geijn, arXiv:1512.02671): a
  Gaussian sketch ``S = G @ A`` selects a whole panel of pivots at once by
  the pivot rule on the small sketch, the panel is orthogonalized with
  one block Gram–Schmidt pass + thin QR, and the R rows and the sketch
  are updated with GEMMs.

Output contract: ``a[..., :, ind] ~= q @ r`` with q (..., m, k) orthonormal
columns, r (..., k, n) upper triangular with non-increasing ``|r_ii|``
(exactly for ``gs``/``kernel``; RRQR-grade approximately for
``blocked``), and ind (..., n) int64: position ``j`` holds original column
``ind[j]``. Leading axes are a batch of independent matrices; one kernel
launch covers the whole batch.
"""

from __future__ import annotations

import torch

from ..utils.dtypes import real_dtype
from ..utils.precision import with_precision
from ..utils.random_matrix import random_gaussian
from .kernels.qrcp import (abs2, kernel_fits, qrcp_panel, qrcp_panel_complex,
                           qrcp_panel_plain)

__all__ = ["pivoted_qr", "pivoted_lq"]

_KERNEL_DTYPES = (torch.float32, torch.complex64)


def _panel_kernel(dtype: torch.dtype):
    """The fused panel wrapper for ``dtype``: K1 for f32, K2 for c64."""
    return qrcp_panel_complex if dtype == torch.complex64 else qrcp_panel


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    """1/x with 0 where x == 0 (rank-deficient guard)."""
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Blocked randomized-pivot RRQR (HQRRP-style)
# ---------------------------------------------------------------------------


def _select_block_pivots(s: torch.Tensor, used: torch.Tensor, b: int):
    """Choose ``b`` pivot columns from sketch ``s`` (..., l, n), excluding
    columns already ``used`` (..., n) bool: the Gram–Schmidt pivot rule on
    the sketch alone, without a reorthogonalization pass (l is small).
    Returns the pivots (..., b) int64 in selection order and the updated
    mask."""
    resid = s
    norms = abs2(s).sum(-2).to(real_dtype(s.dtype))
    piv = []
    for _ in range(b):
        j = torch.argmax(norms.masked_fill(used, -torch.inf), dim=-1,
                         keepdim=True)
        v = torch.take_along_dim(resid, j.unsqueeze(-2), dim=-1)[..., 0]
        nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        qi = v * _safe_inv(nv).to(s.dtype)
        r_row = (qi.conj().unsqueeze(-2) @ resid)[..., 0, :]
        resid = resid - qi.unsqueeze(-1) * r_row.unsqueeze(-2)
        norms = torch.clamp(norms - abs2(r_row), min=0.0)
        used = used.scatter(-1, j, True)
        piv.append(j)
    return torch.cat(piv, dim=-1), used


def _panel_qr(panel: torch.Tensor, method: str) -> torch.Tensor:
    """Q of the thin QR (upper-triangular R) of the (..., m, b) pivot panel.

    ``"house"`` — Householder (``torch.linalg.qr``). ``"scholqr3"`` —
    shifted CholeskyQR3: all GEMMs and two small Cholesky factorizations.
    scholqr3 silently corrupts the basis beyond cond ~ 1/u, which
    smooth-kernel panels reach, so a (b, b) self-check sends a panel whose
    ``Q^H Q`` is off by 1e-3 or more back through Householder. The check
    is read on the host (the JAX package's ``lax.cond`` has no twin): one
    synchronisation per panel, only when ``scholqr3`` is asked for.
    """
    if method == "house":
        return torch.linalg.qr(panel)[0]
    if method != "scholqr3":
        raise ValueError(f"unknown panel_qr {method!r}: expected 'house', "
                         f"'scholqr3' or 'auto'")
    from .orthogonalize import shifted_cholesky_qr3

    q = shifted_cholesky_qr3(panel)[0]
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    healthy = (q.mH @ q - eye).abs().amax((-2, -1)) < 1e-3
    if bool(healthy.all()):
        return q
    return torch.where(healthy[..., None, None], q,
                       torch.linalg.qr(panel)[0])


def _pivot_rule(pivot_kernel: str, dtype: torch.dtype, device: torch.device,
                l: int, b: int) -> str:
    """Resolve ``pivot_kernel``: ``"auto"`` is the fused kernel for f32 and
    c64 on the card when the (l, c) shortlist's Q fits it, else the plain
    rule."""
    if pivot_kernel == "auto":
        fits = (device.type == "cuda" and dtype in _KERNEL_DTYPES
                and kernel_fits(l, b, dtype.itemsize))
        return "kernel" if fits else "plain"
    if pivot_kernel not in ("kernel", "plain"):
        raise ValueError(f"unknown pivot_kernel {pivot_kernel!r}: expected "
                         f"'kernel', 'plain' or 'auto'")
    return pivot_kernel


def _qrcp_blocked(a: torch.Tensor, k: int, block: int, oversample: int,
                  generator: torch.Generator, panel_method: str = "auto",
                  pivot_kernel: str = "auto", candidate_factor: int = 2):
    """Blocked randomized-pivot RRQR: draws the (..., l, m) Gaussian sketch
    matrix (one per matrix of a batch) and runs
    ``_qrcp_blocked_from_gaussian``."""
    g = random_gaussian(generator, (*a.shape[:-2], block + oversample,
                                    a.shape[-2]), dtype=a.dtype,
                        device=a.device)
    return _qrcp_blocked_from_gaussian(a, g, k, block, panel_method,
                                       pivot_kernel, candidate_factor)


def _qrcp_blocked_from_gaussian(a: torch.Tensor, g: torch.Tensor, k: int,
                                block: int, panel_method: str = "auto",
                                pivot_kernel: str = "auto",
                                candidate_factor: int = 2):
    """Blocked RRQR of ``a`` (..., m, n) given the sketch matrix ``g``
    (..., l, m). Returns ``(q, r_orig, piv)`` as ``qrcp_panel_plain`` does.

    Left-looking: the residual matrix is never formed. Each panel is
    deflated on demand from the original columns with the R rows already
    computed (``panel = a[:, piv] - Q R[:, piv]``, then one
    reorthogonalization pass against Q), and one full-width GEMM per panel
    remains, the R rows ``q_blk^H a``. Pivots come from the sketch
    ``g @ a``, downdated HQRRP-style after each panel but the last.

    Tournament shortlist: with ``candidate_factor = c > 0`` each panel
    first takes the ``c * b`` unchosen columns of largest sketch norm, then
    runs the sequential pivot rule on that (l, c*b) subsketch only;
    ``0`` runs the rule at full width.

    One Python loop over the panels with prefix-width deflation (panel i
    deflates against exactly the ``i * b`` finished columns), for any
    number of panels: the JAX package's ``fori_loop`` form exists only to
    bound its trace and computes the same thing. ``q`` and ``r`` are
    filled in place, panel by panel.
    """
    *batch, m, n = a.shape
    l = g.shape[-2]
    if panel_method == "auto":
        # Householder off the TPU, as in the JAX package.
        panel_method = "house"
    rule = _pivot_rule(pivot_kernel, a.dtype, a.device, l, block)

    def run_pivot_rule(s, used_mask, b):
        if rule == "plain":
            return _select_block_pivots(s, used_mask, b)[0]
        # pivots only; the kernel takes (m, n) or (B, m, n)
        if s.ndim > 3:
            s, used_mask = s.flatten(0, -3), used_mask.flatten(0, -2)
        _, _, piv = _panel_kernel(s.dtype)(s.contiguous(), b, used=used_mask)
        return piv.long().reshape(*batch, b)

    def select_pivots(sketch, used, b):
        c = min(n, candidate_factor * b) if candidate_factor else n
        if c < n:
            norms = abs2(sketch).sum(-2).to(real_dtype(a.dtype))
            cand = torch.topk(norms.masked_fill(used, -torch.inf), c,
                              dim=-1).indices
            # A used column enters the shortlist only when fewer than c
            # unchosen columns remain (the last panels of a full
            # factorization); its mask keeps it unpickable.
            piv_local = run_pivot_rule(
                torch.take_along_dim(sketch, cand.unsqueeze(-2), dim=-1),
                torch.take_along_dim(used, cand, dim=-1), b)
            piv = torch.take_along_dim(cand, piv_local, dim=-1)
        else:
            piv = run_pivot_rule(sketch, used, b)
        return piv, used.scatter(-1, piv, True)

    sketch = g @ a  # (..., l, n), downdated as pivots are consumed
    used = torch.zeros((*batch, n), dtype=torch.bool, device=a.device)
    q = a.new_empty((*batch, m, k))
    r = a.new_empty((*batch, k, n))
    pivs = []
    offset = 0
    while offset < k:
        b = min(block, k - offset)
        piv, used = select_pivots(sketch, used, b)
        gather = piv.unsqueeze(-2)
        panel = torch.take_along_dim(a, gather, dim=-1)  # original columns
        if offset:
            qp = q[..., :offset]
            panel = panel - qp @ torch.take_along_dim(r[..., :offset, :],
                                                      gather, dim=-1)
            panel = panel - qp @ (qp.mH @ panel)
        q_blk = _panel_qr(panel, panel_method)
        r_rows = q_blk.mH @ a  # (..., b, n): the one full-width GEMM
        if offset + b < k:
            sketch = sketch - (g @ q_blk) @ r_rows  # HQRRP downdate
        q[..., offset:offset + b] = q_blk
        r[..., offset:offset + b, :] = r_rows
        pivs.append(piv)
        offset += b
    return q, r, torch.cat(pivs, dim=-1)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


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


def _working_set_fits(m: int, n: int, k: int, itemsize: int) -> bool:
    """The JAX package's bound on a fused panel's working set
    (``_pallas_fits``: the panel and its residual, Q, R and two norm
    vectors under 12 MiB), at the element size of ``itemsize``."""
    return itemsize * (2 * m * n + m * k + k * n + 2 * n) < 12 * 2**20


def _resolve_mode(mode: str, m: int, n: int, k: int, dtype: torch.dtype,
                  device: torch.device) -> str:
    """Resolve ``"auto"`` with the JAX package's thresholds: the fused
    kernel where the JAX package picked Pallas (small rank or width, on
    the accelerator, a working set under its 12 MiB bound and a Q that
    fits the kernel), the plain loop for f64/c128, the CPU or a larger
    working set up to n = 512, the blocked RRQR beyond. A whole 2048^2
    f32 block at k = 16 (32.3 MiB) goes blocked, as in the JAX package.

    In the small-rank branch the JAX package means the exact pivot rule
    (its 12 MB fit rule covers a 1024^2 f32 matrix at k = 64, whose Q does
    not fit this card's kernel). Where the port has to go blocked there,
    ``pivoted_qr`` runs the pivot rule over the whole width of the sketch
    instead of a tournament shortlist (``pivot_candidates=None``): one
    panel, every column a candidate, as the exact rule has it.

    Unlike the JAX package, auto picks the kernel for c64 too: there it
    was held back only until the compiled complex kernel was validated on
    the target backend, and ``chip_smoke.py`` is that validation of K2 on
    the card."""
    if mode != "auto":
        return mode
    if k <= 64 or n <= 128:
        if (dtype in _KERNEL_DTYPES and device.type == "cuda"
                and _working_set_fits(m, n, k, dtype.itemsize)
                and kernel_fits(m, k, dtype.itemsize)):
            return "kernel"
        if n <= 512:
            return "gs"
    return "blocked"


@with_precision
def pivoted_qr(a: torch.Tensor, max_rank: int | None = None, *,
               mode: str = "auto", block_size: int = 128,
               sketch_oversample: int = 8, panel_qr: str = "auto",
               pivot_kernel: str = "auto",
               pivot_candidates: int | None = None,
               generator: torch.Generator | None = None):
    """Column-pivoted (rank-revealing) QR: ``a[..., :, ind] ~= q @ r``.

    Args:
      a: (..., m, n) matrix or batch (f32/f64/c64/c128).
      max_rank: number of factorization steps; ``None`` means the full
        ``min(m, n)``.
      mode: ``"gs"``, ``"kernel"``, ``"blocked"`` or ``"auto"`` (see the
        module docstring).
      block_size / sketch_oversample: blocked-mode panel width and the
        sketch's extra rows.
      panel_qr: blocked-mode panel factorization — ``"house"``
        (Householder), ``"scholqr3"`` (all-GEMM shifted CholeskyQR3 with a
        Householder redo of unhealthy panels) or ``"auto"`` (Householder).
      pivot_kernel: blocked-mode pivot selection on the sketch —
        ``"kernel"`` (K1/K2, pivots only), ``"plain"`` (the PyTorch loop)
        or ``"auto"`` (the kernel for f32/c64 on the card when it fits).
      pivot_candidates: blocked-mode tournament shortlist factor (0 runs
        the pivot rule on all n columns; see
        ``_qrcp_blocked_from_gaussian``). ``None`` is 0 where ``"auto"``
        goes blocked at small rank (k <= 64 or n <= 128: one panel, and a
        shortlist of 2k columns out of n loses the good pivots of, say, a
        Hilbert matrix), else 2, the JAX package's default.
      generator: draws the blocked mode's sketch matrix on ``a``'s device;
        a generator seeded with 0 when none is given.

    Returns:
      ``(q, r, ind)`` — q (..., m, k), r (..., k, n) upper triangular over
      the permuted columns, ind (..., n) int64.
    """
    if a.ndim < 2:
        raise ValueError(
            f"pivoted_qr expects a matrix, got shape {tuple(a.shape)}")
    m, n = a.shape[-2:]
    k = min(m, n) if max_rank is None else min(int(max_rank), m, n)
    if pivot_candidates is None:
        small_rank = mode == "auto" and (k <= 64 or n <= 128)
        pivot_candidates = 0 if small_rank else 2
    mode = _resolve_mode(mode, m, n, k, a.dtype, a.device)
    if mode == "gs":
        q, r_orig, piv = qrcp_panel_plain(a, k)
    elif mode == "kernel":
        # a lazy conjugate (pivoted_lq's a.mH) has to be written out
        q, r_orig, piv = _panel_kernel(a.dtype)(
            a.resolve_conj().contiguous(), k)
        piv = piv.long()
    elif mode == "blocked":
        if generator is None:
            generator = torch.Generator(device=a.device).manual_seed(0)
        q, r_orig, piv = _qrcp_blocked(
            a, k, min(block_size, k), sketch_oversample, generator, panel_qr,
            pivot_kernel, pivot_candidates)
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
