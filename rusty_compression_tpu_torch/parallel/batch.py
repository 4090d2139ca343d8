"""Batched block compression (port of ``rusty_compression_tpu.parallel.batch``).

A stack of same-shape blocks (B, m, n) goes through one pipeline whose
every step acts on the whole stack: batched GEMMs, batched small
factorizations, and one K1 launch (grid = B) per pivoted QR. This is the
JAX package's ``vmap`` written out as a leading batch axis. Each block
gets an independent Gaussian sketch, drawn from one ``torch.Generator``.
Fixed-rank paths only.
"""

from __future__ import annotations

import torch

from ..linop import as_linear_operator
from ..models.interp_decomp import TwoSidedID
from ..models.svd import SVD
from ..sampling import (_gaussian_for, _range_finder_from_omega,
                        sketched_two_sided_id)
from ..utils.metrics import rel_diff_fro
from ..utils.precision import with_precision

__all__ = [
    "rsvd_block",
    "sketched_two_sided_id_block",
    "batched_rsvd",
    "batched_sketched_two_sided_id",
    "batched_rel_diff_fro",
]


@with_precision
def rsvd_block(a: torch.Tensor, generator: torch.Generator, rank: int,
               oversample: int = 5, power_iters: int = 0,
               ortho: str = "auto", small_svd: str = "direct") -> SVD:
    """Fixed-rank randomized SVD of one dense block (or a stack).

    The HMT ``range_finder`` keeps the full ``rank + oversample`` basis,
    the dense SVD runs only on the small projection, and truncation to
    ``rank`` happens on the singular values.
    """
    op = as_linear_operator(a)
    omega = _gaussian_for(op, generator, op.ncols, rank + oversample)
    return _rsvd_block_from_omega(a, omega, rank, power_iters, ortho,
                                  small_svd)


def _rsvd_block_from_omega(a: torch.Tensor, omega: torch.Tensor, rank: int,
                           power_iters: int = 0, ortho: str = "auto",
                           small_svd: str = "direct") -> SVD:
    """``rsvd_block`` given the Gaussian test matrix ``omega``
    (..., n, rank + oversample)."""
    op = as_linear_operator(a)
    q = _range_finder_from_omega(op, omega, power_iters, ortho)
    svd = SVD.compute_from_range_estimate(q, op, method=small_svd)
    return svd.compress_svd_rank(rank)


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
