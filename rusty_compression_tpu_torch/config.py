"""Frozen configuration dataclass and the one-call compression front door
(port of ``rusty_compression_tpu.config``).

Every knob of the pipelines is an explicit field of ``CompressionConfig``
with the reference's default; ``compress`` routes a dense matrix, an
operator, a (B, m, n) stack or a list of heterogeneous blocks to the
pipeline of the requested method in rank or tolerance mode.

Not ported, and why: ``_compress_planar``, ``_compress_planar_list`` and
``use_host_complex``. They exist because the TPU rejects complex dtypes;
the card takes them, so a complex target goes down the same paths as a
real one (K2 picks the pivots of a c64 ID on the card, and a complex list
takes the block stream).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from .linop import SparseOperator, _is_scipy_sparse

__all__ = ["CompressionConfig", "compress"]

_METHODS = ("rsvd", "nystrom", "column_id", "row_id", "two_sided_id",
            "sketched_two_sided_id")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Every knob of the compression pipelines in one frozen record.

    Exactly one of ``rank`` / ``rel_tol`` must be set (the reference's
    ``CompressionType::{RANK, ADAPTIVE}`` split).
    """

    # -- what to compute ---------------------------------------------------
    rank: int | None = None          # fixed target rank
    rel_tol: float | None = None     # adaptive relative tolerance
    method: str = "rsvd"             # rsvd | nystrom | column_id | row_id
    #                                # | two_sided_id | sketched_two_sided_id

    # -- sampling knobs (the reference's defaults) ---------------------------
    oversample: int = 5              # p
    power_iters: int = 0             # it_count
    sample_size: int = 10            # adaptive probe block size
    max_rank: int | None = None      # adaptive rank cap

    # -- numerical-kernel knobs ----------------------------------------------
    ortho: str = "auto"              # qr | cholqr2 | scholqr3 | svqb | auto
    small_svd: str = "direct"        # direct | gram
    precision: str | None = None     # highest | high | default | None=policy
    qr_mode: str = "auto"            # gs | kernel | blocked | auto
    block_size: int = 128            # blocked-RRQR panel width
    bucket_floor: int = 128          # scheduler shape-bucket grid floor

    # -- tol <= 1e-8 pipeline -------------------------------------------------
    highacc: bool = False            # route through the refined pipeline
    round_rank: int | None = None    # per-round capture rank (highacc)

    def __post_init__(self):
        if (self.rank is None) == (self.rel_tol is None):
            raise ValueError(
                "set exactly one of rank= (fixed) or rel_tol= (adaptive)")
        if self.method not in _METHODS:
            raise ValueError(f"unknown method {self.method!r}")
        if self.rel_tol is not None and self.method != "rsvd":
            raise ValueError(
                "adaptive (rel_tol) compression produces an SVD; use "
                "method='rsvd'")
        if self.method == "nystrom" and self.power_iters:
            raise ValueError(
                "nystrom is the single-pass method; power_iters does not "
                "apply (use method='rsvd' for power iteration)")
        if self.highacc and self.rel_tol is None:
            raise ValueError("highacc is the tolerance pipeline; set "
                             "rel_tol= (and usually round_rank=)")
        if self.highacc and self.round_rank is None and self.rank is None:
            raise ValueError("highacc needs round_rank= (the per-round "
                             "capture size cannot be derived from the "
                             "tolerance alone)")
        if self.qr_mode == "pallas":
            raise ValueError(
                "qr_mode='pallas' names the JAX package's TPU kernel; the "
                "fused CUDA kernel's mode here is 'kernel'")

    # convenience constructors mirroring the reference enum spelling
    @classmethod
    def RANK(cls, k: int, **kwargs) -> "CompressionConfig":
        return cls(rank=k, **kwargs)

    @classmethod
    def ADAPTIVE(cls, tol: float, **kwargs) -> "CompressionConfig":
        return cls(rel_tol=tol, **kwargs)


def compress(target: Any, generator: torch.Generator,
             config: CompressionConfig, mesh=None):
    """Compress ``target`` according to ``config``.

    ``target`` is a dense (m, n) matrix or a ``LinearOperator`` (one
    compression), a (B, m, n) stack (batched) or a list of blocks of any
    shapes (the block stream, ``parallel.scheduler``). Returns what the JAX
    package's ``compress`` returns: the method's container; in tolerance
    mode ``(svd, history)`` for one target, with the SVD sliced to the
    achieved rank, and ``(svd_padded, ranks, histories)`` for a stack; a
    list of ``BlockResult`` in submission order for a list.
    ``generator`` draws every Gaussian matrix and lives on the target's
    device; a numpy or ``scipy.sparse`` target is put on the generator's
    device.

    ``mesh`` (``parallel.make_mesh``) shards a stack or a list over its
    ``"blocks"`` axis, one process per card: every rank passes the same
    target and a generator in the same state. A stack returns the rank's
    slice (``parallel.gather_factors`` makes it whole; with ``highacc`` the
    list of the slice's ``RefinedSVD``s), a list the whole list of
    ``BlockResult``s on every rank. One matrix or operator is not sharded
    by a mesh (a ``parallel.RowShardedOperator`` splits its rows), and
    passing one with a mesh raises.
    """
    from .parallel import compress_blocks, compress_blocks_adaptive
    from .parallel.batch import (_adaptive_rsvd_sliced, column_id_block,
                                 nystrom_block, row_id_block, rsvd_block,
                                 sketched_two_sided_id_block,
                                 two_sided_id_block)

    c = config
    if isinstance(target, np.ndarray):
        target = torch.as_tensor(target, device=generator.device)
    elif _is_scipy_sparse(target):
        target = SparseOperator(target, device=generator.device)
    common: dict = {}
    if c.precision is not None:
        common["precision"] = c.precision

    if mesh is not None and not isinstance(target, (list, tuple)) and (
            hasattr(target, "matmat") or np.ndim(target) != 3):
        raise ValueError(
            "mesh= shards a (B, m, n) stack or a list of blocks over "
            "'blocks'; one matrix or operator runs on one card (a "
            "parallel.RowShardedOperator splits its rows over a mesh)")
    if c.highacc:
        return _compress_highacc(target, generator, c, mesh)

    if isinstance(target, (list, tuple)):
        from .parallel.scheduler import compress_heterogeneous

        kwargs = dict(method=c.method, mesh=mesh,
                      bucket_floor=c.bucket_floor, **common)
        if c.rel_tol is not None:
            kwargs.update(rel_tol=c.rel_tol, sample_size=c.sample_size,
                          max_rank=c.max_rank, ortho=c.ortho,
                          small_svd=c.small_svd)
        else:
            kwargs.update(rank=c.rank)
            if c.method == "rsvd":
                kwargs.update(oversample=c.oversample,
                              power_iters=c.power_iters, ortho=c.ortho,
                              small_svd=c.small_svd)
            elif c.method == "nystrom":
                kwargs.update(oversample=c.oversample,
                              small_svd=c.small_svd)
            else:
                kwargs.update(mode=c.qr_mode, block_size=c.block_size)
        return compress_heterogeneous(target, generator, **kwargs)

    if (c.rel_tol is not None and c.rel_tol < 1e-7
            and getattr(target, "dtype", None) in (torch.float32,
                                                   torch.complex64)):
        warnings.warn(
            f"rel_tol={c.rel_tol:g} is below the accuracy floor of a "
            f"{target.dtype} target (~1e-7); the adaptive sampler will "
            "stall at the roundoff floor. Pass the target in float64 / "
            "complex128.", stacklevel=2)

    ndim = 2 if hasattr(target, "matmat") else np.ndim(target)

    if ndim == 3:
        if c.rel_tol is not None:
            return compress_blocks_adaptive(
                target, generator, c.rel_tol, c.sample_size, c.max_rank,
                mesh=mesh, ortho=c.ortho, small_svd=c.small_svd, **common)
        if c.method == "rsvd":
            kwargs = dict(oversample=c.oversample,
                          power_iters=c.power_iters, ortho=c.ortho,
                          small_svd=c.small_svd, **common)
        elif c.method == "nystrom":
            kwargs = dict(oversample=c.oversample, small_svd=c.small_svd,
                          **common)
        else:
            kwargs = dict(mode=c.qr_mode, block_size=c.block_size, **common)
        return compress_blocks(target, generator, c.rank, method=c.method,
                               mesh=mesh, **kwargs)

    # one matrix or operator
    if c.rel_tol is not None:
        svd, _, history = _adaptive_rsvd_sliced(
            target, generator, c.rel_tol, c.sample_size, c.max_rank,
            ortho=c.ortho, small_svd=c.small_svd, **common)
        return svd, history
    if c.method == "rsvd":
        return rsvd_block(target, generator, c.rank, c.oversample,
                          c.power_iters, c.ortho, c.small_svd, **common)
    if c.method == "nystrom":
        return nystrom_block(target, generator, c.rank, c.oversample,
                             c.small_svd, **common)
    block_fns = {"column_id": column_id_block, "row_id": row_id_block,
                 "two_sided_id": two_sided_id_block,
                 "sketched_two_sided_id": sketched_two_sided_id_block}
    return block_fns[c.method](target, generator, c.rank, mode=c.qr_mode,
                               block_size=c.block_size, **common)


def _compress_highacc(target: Any, generator: torch.Generator,
                      c: CompressionConfig, mesh=None):
    """The tol <= 1e-8 pipeline (``highacc.refined_rsvd``, native f64/c128).

    Dense targets only: its residual rounds need the matrix entries. One
    matrix returns ``(RefinedSVD, history)``; a (B, m, n) stack returns a
    list of ``RefinedSVD`` in order (``refined_rsvd_batch``); a list of
    blocks goes through ``compress_heterogeneous_refined`` and returns
    ``BlockResult``s.
    ``c.oversample`` (the reference's p = 5) is not forwarded, as in the
    JAX package: the refined pipeline keeps its own default (10).

    On a ``mesh`` (which the JAX package's highacc route ignores) a list
    goes through the refined stream on the mesh; a stack's blocks are dealt
    over ``"blocks"``, each with the generator it gets unsharded, and the
    rank returns its slice's results.
    """
    from .highacc import _spawn, refined_rsvd, refined_rsvd_batch
    from .parallel.mesh import _shard_range
    from .parallel.scheduler import compress_heterogeneous_refined

    rk = int(c.round_rank if c.round_rank is not None else c.rank)
    if isinstance(target, (list, tuple)):
        return compress_heterogeneous_refined(
            target, generator, rel_tol=c.rel_tol, round_rank=rk,
            bucket_floor=c.bucket_floor, mesh=mesh)
    if mesh is not None:
        lo, hi = _shard_range(len(target), mesh, "blocks")
        gens = _spawn(generator, len(target))[lo:hi]
        return [refined_rsvd(b, g, round_rank=rk, tol=c.rel_tol)
                for b, g in zip(target[lo:hi], gens)]
    if hasattr(target, "matmat"):
        raise ValueError(
            "highacc needs dense matrix entries (its residual rounds form "
            "A - U W from A itself); materialize the operator first")
    if np.ndim(target) == 3:
        return refined_rsvd_batch(list(target), generator, round_rank=rk,
                                  tol=c.rel_tol)
    out = refined_rsvd(target, generator, round_rank=rk, tol=c.rel_tol)
    return out, out.history
