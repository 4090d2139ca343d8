"""Block stacks through one front door (port of the one-device part of
``rusty_compression_tpu.parallel.mesh``).

``compress_blocks`` and ``compress_blocks_adaptive`` send a ``(B, m, n)``
stack to the batched pipeline of the requested method. The JAX module also
shards the stack over a device mesh and caches one compiled program per
configuration; here one card runs the stack, nothing is compiled, so
there is no cache, and a ``mesh`` other than ``None`` is refused until the
multi-card layer is ported (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import torch

from .batch import (batched_adaptive_rsvd, batched_column_id,
                    batched_nystrom, batched_row_id, batched_rsvd,
                    batched_sketched_two_sided_id, batched_two_sided_id)

__all__ = ["compress_blocks", "compress_blocks_adaptive"]

_METHODS = {
    "rsvd": batched_rsvd,
    "nystrom": batched_nystrom,
    "column_id": batched_column_id,
    "row_id": batched_row_id,
    "two_sided_id": batched_two_sided_id,
    "sketched_two_sided_id": batched_sketched_two_sided_id,
}


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharding a block stack over a device mesh is not ported yet "
            "(ROADMAP Queue 1 item 4: mesh / sharded / distributed); pass "
            "mesh=None to run the stack on one card")


def compress_blocks(blocks: torch.Tensor, generator: torch.Generator,
                    rank: int, method: str = "rsvd", mesh=None, **kwargs):
    """Compress a ``(B, m, n)`` block stack at a fixed rank.

    ``method`` is one of ``"rsvd"``, ``"nystrom"``, ``"column_id"``,
    ``"row_id"``, ``"two_sided_id"``, ``"sketched_two_sided_id"``; extra
    keywords go to the per-block pipeline (``oversample``, ``power_iters``,
    ``mode`` ...).
    """
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{sorted(_METHODS)}")
    _refuse_mesh(mesh)
    return _METHODS[method](blocks, generator, int(rank), **kwargs)


def compress_blocks_adaptive(blocks: torch.Tensor,
                             generator: torch.Generator, rel_tol: float,
                             sample_size: int, max_rank: int | None = None,
                             mesh=None, **kwargs):
    """Tolerance-driven analogue of ``compress_blocks``: every block of the
    stack finds its own rank. Returns ``(svd_padded, ranks, histories)``
    (see ``parallel.batch.batched_adaptive_rsvd``)."""
    _refuse_mesh(mesh)
    return batched_adaptive_rsvd(blocks, generator, float(rel_tol),
                                 int(sample_size), max_rank, **kwargs)
