"""Batched block compression (port of ``rusty_compression_tpu.parallel.batch``).

A stack of same-shape blocks (B, m, n) goes through one pipeline whose
every step acts on the whole stack: batched GEMMs, batched small
factorizations, and one K1 (c64: K2) launch (grid = B) per pivoted QR
panel. This is the JAX package's ``vmap`` written out as a leading batch
axis. Each block gets an independent Gaussian sketch, drawn from one
``torch.Generator``. The adaptive entry runs the whole stack through one
loop in which every block stops at its own rank (``sampling._adaptive_loop``).
"""

from __future__ import annotations

import torch

from ..linop import as_linear_operator
from ..models.interp_decomp import ColumnID, RowID, TwoSidedID
from ..models.qr import LQ, QR
from ..models.svd import SVD
from ..ops.svd import compute_svd
from ..sampling import (_adaptive_loop, _gaussian_for, _gaussians,
                        _max_iters, _range_finder_from_omega, nystrom_svd,
                        sketched_two_sided_id)
from ..utils.metrics import rel_diff_fro
from ..utils.precision import with_precision

__all__ = [
    "rsvd_block",
    "nystrom_block",
    "column_id_block",
    "row_id_block",
    "two_sided_id_block",
    "sketched_two_sided_id_block",
    "batched_rsvd",
    "batched_nystrom",
    "batched_column_id",
    "batched_row_id",
    "batched_two_sided_id",
    "batched_sketched_two_sided_id",
    "batched_rel_diff_fro",
    "adaptive_rsvd_block",
    "batched_adaptive_rsvd",
]


@with_precision
def rsvd_block(a: torch.Tensor, generator: torch.Generator, rank: int,
               oversample: int = 5, power_iters: int = 0,
               ortho: str = "auto", small_svd: str = "direct",
               sketch_precision: str | None = None) -> SVD:
    """Fixed-rank randomized SVD of one dense block (or a stack, or an
    operator).

    The HMT ``range_finder`` keeps the full ``rank + oversample`` basis,
    the dense SVD runs only on the small projection, and truncation to
    ``rank`` happens on the singular values. ``sketch_precision`` lowers
    only the sampling GEMMs (see ``sampling.range_finder``).
    """
    op = as_linear_operator(a)
    omega = _gaussian_for(op, generator, op.ncols, rank + oversample)
    return _rsvd_block_from_omega(op, omega, rank, power_iters, ortho,
                                  small_svd, sketch_precision)


def _rsvd_block_from_omega(a, omega: torch.Tensor, rank: int,
                           power_iters: int = 0, ortho: str = "auto",
                           small_svd: str = "direct",
                           sketch_precision: str | None = None) -> SVD:
    """``rsvd_block`` given the Gaussian test matrix ``omega``
    (..., n, rank + oversample)."""
    op = as_linear_operator(a)
    q = _range_finder_from_omega(op, omega, power_iters, ortho,
                                 sketch_precision)
    svd = SVD.compute_from_range_estimate(q, op, method=small_svd)
    return svd.compress_svd_rank(rank)


@with_precision
def nystrom_block(a, generator: torch.Generator, rank: int,
                  oversample: int = 8, small_svd: str = "direct",
                  **nystrom_kwargs) -> SVD:
    """Single-pass generalized Nyström SVD of one block (or a stack): two
    passes over the operator (see ``sampling.nystrom_svd`` for the
    accuracy trade)."""
    return nystrom_svd(a, generator, k=rank, oversample=oversample,
                       small_svd=small_svd, **nystrom_kwargs)


@with_precision
def column_id_block(a: torch.Tensor, generator: torch.Generator, rank: int,
                    **qr_kwargs) -> ColumnID:
    """Fixed-rank column interpolative decomposition of one block (or a
    stack): pivoted QR truncated at ``rank`` steps, then the
    rank-deficient ``column_id`` conversion. ``generator`` draws the
    blocked RRQR's pivot sketch."""
    qr = QR.compute_from(a, max_rank=rank, generator=generator, **qr_kwargs)
    return qr.column_id()


@with_precision
def row_id_block(a: torch.Tensor, generator: torch.Generator, rank: int,
                 **qr_kwargs) -> RowID:
    """Fixed-rank row interpolative decomposition of one block (or a
    stack), through the truncated pivoted LQ."""
    lq = LQ.compute_from(a, max_rank=rank, generator=generator, **qr_kwargs)
    return lq.row_id()


@with_precision
def two_sided_id_block(a: torch.Tensor, generator: torch.Generator,
                       rank: int, **qr_kwargs) -> TwoSidedID:
    """Fixed-rank two-sided interpolative decomposition of one block (or a
    stack): QR -> ColumnID -> TwoSidedID. Reads the block twice (the pivot
    sketch and the R rows); ``sketched_two_sided_id_block`` reads it once."""
    return column_id_block(a, generator, rank, **qr_kwargs).two_sided_id()


@with_precision
def sketched_two_sided_id_block(a: torch.Tensor, generator: torch.Generator,
                                rank: int, oversample: int = 8,
                                **qr_kwargs) -> TwoSidedID:
    """One-read fixed-rank two-sided ID of one block (or a stack): QRCP of
    the sketch + k-column gather, so the block is read once."""
    return sketched_two_sided_id(a, generator, rank, oversample, **qr_kwargs)


def _check_stack(blocks: torch.Tensor) -> None:
    if blocks.ndim != 3:
        raise ValueError(
            f"expected a (B, m, n) block stack, got shape "
            f"{tuple(blocks.shape)}")


def batched_rsvd(blocks: torch.Tensor, generator: torch.Generator, rank: int,
                 oversample: int = 5, power_iters: int = 0,
                 **kwargs) -> SVD:
    """Randomized SVD of a ``(B, m, n)`` block stack with per-block
    independent sketches. Returns an ``SVD`` whose fields have a leading
    batch axis (u: (B, m, k), s: (B, k), vt: (B, k, n))."""
    _check_stack(blocks)
    return rsvd_block(blocks, generator, rank, oversample=oversample,
                      power_iters=power_iters, **kwargs)


def batched_nystrom(blocks: torch.Tensor, generator: torch.Generator,
                    rank: int, **kwargs) -> SVD:
    """Single-pass Nyström SVD of a ``(B, m, n)`` block stack."""
    _check_stack(blocks)
    return nystrom_block(blocks, generator, rank, **kwargs)


def batched_column_id(blocks: torch.Tensor, generator: torch.Generator,
                      rank: int, **qr_kwargs) -> ColumnID:
    """Column ID of a ``(B, m, n)`` block stack (fields carry a leading
    batch axis)."""
    _check_stack(blocks)
    return column_id_block(blocks, generator, rank, **qr_kwargs)


def batched_row_id(blocks: torch.Tensor, generator: torch.Generator,
                   rank: int, **qr_kwargs) -> RowID:
    """Row ID of a ``(B, m, n)`` block stack."""
    _check_stack(blocks)
    return row_id_block(blocks, generator, rank, **qr_kwargs)


def batched_two_sided_id(blocks: torch.Tensor, generator: torch.Generator,
                         rank: int, **qr_kwargs) -> TwoSidedID:
    """Two-sided ID of a ``(B, m, n)`` block stack by the two-read route
    (``two_sided_id_block``)."""
    _check_stack(blocks)
    return two_sided_id_block(blocks, generator, rank, **qr_kwargs)


def batched_sketched_two_sided_id(blocks: torch.Tensor,
                                  generator: torch.Generator, rank: int,
                                  **kwargs) -> TwoSidedID:
    """One-read two-sided ID of a ``(B, m, n)`` block stack; two K1
    launches cover the whole stack (the sketch QRCP and the LQ of C)."""
    _check_stack(blocks)
    return sketched_two_sided_id_block(blocks, generator, rank, **kwargs)


def batched_rel_diff_fro(factors, blocks: torch.Tensor) -> torch.Tensor:
    """Per-block relative Frobenius reconstruction error (B,); ``factors``
    is any batched container with a ``to_mat`` method."""
    return rel_diff_fro(factors.to_mat(), blocks)


@with_precision
def adaptive_rsvd_block(a, generator: torch.Generator, rel_tol: float,
                        sample_size: int, max_rank: int | None = None,
                        ortho: str = "auto", small_svd: str = "direct"):
    """Tolerance-driven randomized SVD of one block (or a stack, or an
    operator) with padded outputs.

    Runs the adaptive range finder and factorizes the padded sketch. The
    shapes are padded to ``max_rank`` rounded up to whole blocks; the rows
    of the sketch beyond the achieved rank are zero, and the singular
    triplets beyond it are returned as exact zeros.

    Returns ``(svd_padded, rank, history)``: ``rank`` (int64 tensor) is the
    achieved rank and ``history[..., i]`` the estimated relative residual
    after block ``i`` (zero-padded).
    """
    op = as_linear_operator(a)
    sample_size = int(sample_size)
    return _adaptive_rsvd_block_from_omegas(
        op, _gaussians(op, generator, sample_size), rel_tol, sample_size,
        max_rank, ortho, small_svd)


def _adaptive_rsvd_block_from_omegas(a, omegas, rel_tol: float,
                                     sample_size: int,
                                     max_rank: int | None = None,
                                     ortho: str = "auto",
                                     small_svd: str = "direct"):
    """``adaptive_rsvd_block`` given the iterator of Gaussian matrices that
    ``sampling._adaptive_loop`` takes."""
    op = as_linear_operator(a)
    q, b_mat, ncols, _, hist = _adaptive_loop(
        op, omegas, rel_tol, sample_size,
        _max_iters(op, sample_size, max_rank), ortho)
    u_b, s, vt = compute_svd(b_mat, method=small_svd)
    # b_mat has at most ncols nonzero singular values and they come first;
    # what the small SVD leaves of the others (roundoff, an arbitrary basis
    # of the null space) is masked, so the padding is exactly zero.
    return SVD(q @ u_b, s, vt)._masked(ncols), ncols, hist


@with_precision
def _adaptive_rsvd_sliced(a, generator: torch.Generator, rel_tol: float,
                          sample_size: int, max_rank: int | None = None,
                          ortho: str = "auto", small_svd: str = "direct"):
    """``adaptive_rsvd_block`` of one matrix or operator for a caller that
    wants the SVD at the achieved rank: ``(svd, history)``. The rank is
    read on the host and the sketch sliced to it before the small SVD,
    which then factorizes (rank, n) and not the padded (cap, n) with its
    zero rows; there is nothing left to mask. A stack cannot be sliced
    (every block has its own rank) and takes the padded form."""
    op = as_linear_operator(a)
    if op.batch_shape:
        raise ValueError("one matrix or operator, not a stack; "
                         "adaptive_rsvd_block takes a stack")
    sample_size = int(sample_size)
    q, b_mat, ncols, _, hist = _adaptive_loop(
        op, _gaussians(op, generator, sample_size), rel_tol, sample_size,
        _max_iters(op, sample_size, max_rank), ortho)
    rank = int(ncols)
    u_b, s, vt = compute_svd(b_mat[:rank], method=small_svd)
    return SVD(q[:, :rank] @ u_b, s, vt), hist


def batched_adaptive_rsvd(blocks: torch.Tensor, generator: torch.Generator,
                          rel_tol: float, sample_size: int,
                          max_rank: int | None = None, **kwargs):
    """Adaptive-rank randomized SVD of a ``(B, m, n)`` stack: every block
    runs the same loop and stops at its own rank (blocks that converge
    early are frozen while the others go on).

    Returns ``(svd_padded, ranks, histories)``: the SVD's fields carry the
    batch axis at the padded rank; ``ranks`` (B,) are the achieved ranks;
    ``histories`` (B, max_iters) the residual curves (zero beyond each
    block's round count).
    """
    _check_stack(blocks)
    return adaptive_rsvd_block(blocks, generator, rel_tol, sample_size,
                               max_rank, **kwargs)
