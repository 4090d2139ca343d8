"""Device-mesh data parallelism for block compression (port of
``rusty_compression_tpu.parallel.mesh``).

A stack of independent blocks is sharded over the ``"blocks"`` axis of a
``torch.distributed.device_mesh.DeviceMesh`` and compressed with one process
per card: each rank runs the batched pipeline of ``parallel.batch`` on its
own contiguous slice of the stack, on its own card, with no collective in
the compute. That is a correctness rule here and not only a speed rule: the
adaptive loop reads a stop flag once a round on each rank, so ranks whose
blocks converge at different rounds run different numbers of rounds (the
JAX package's per-device stopping under ``shard_map``), and a collective
inside the loop would deadlock them.

Every rank holds the whole stack and the same generator; the sharded call
draws what the unsharded call draws (``utils.random_matrix.sharded_draws``)
and returns the factors of its own slice, in the unsharded call's
containers; ``distributed.gather_factors`` makes them whole. Nothing is
compiled, so there is no program cache.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils.random_matrix import sharded_draws
from .batch import (batched_adaptive_rsvd, batched_column_id,
                    batched_nystrom, batched_row_id, batched_rsvd,
                    batched_sketched_two_sided_id, batched_two_sided_id)
from .distributed import _backend

__all__ = [
    "make_mesh",
    "shard_blocks",
    "compress_blocks",
    "compress_blocks_adaptive",
    "replicate",
]

_METHODS = {
    "rsvd": batched_rsvd,
    "nystrom": batched_nystrom,
    "column_id": batched_column_id,
    "row_id": batched_row_id,
    "two_sided_id": batched_two_sided_id,
    "sketched_two_sided_id": batched_sketched_two_sided_id,
}


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, ...] = ("blocks",),
              shape: tuple[int, ...] | None = None,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over the ranks of the process group.

    Default is a 1-D ``"blocks"`` data-parallel mesh. Pass ``axis_names=
    ("blocks", "rows")`` and a ``shape`` to combine block data parallelism
    with row-sharded operators (``parallel.sharded``). One process drives
    one card, so the mesh spans the whole group: ``n_devices``, if given,
    must be the world size. On a single process with no group, a group of
    one rank is made here from an in-process store (NCCL on ``"cuda"``,
    Gloo on ``"cpu"``), so that ``mesh=make_mesh()`` runs on one card;
    ``torch.distributed.destroy_process_group()`` ends it.
    """
    from torch.distributed.device_mesh import init_device_mesh

    backend = _backend(device_type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices in a process group of {world}: one "
            f"process drives one card, so start {n} processes (torchrun "
            f"--nproc-per-node {n}) for a mesh of {n}")
    if shape is None:
        shape = (n,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _shard_range(count: int, mesh, axis: str) -> tuple[int, int]:
    """``(lo, hi)`` of this rank's contiguous slice of ``count`` blocks."""
    n_shards = _axis_size(mesh, axis)
    if count % n_shards:
        raise ValueError(
            f"block count {count} not divisible by mesh axis {axis!r} "
            f"({n_shards}); pad the stack (see parallel.scheduler) first")
    per = count // n_shards
    lo = per * mesh.get_local_rank(axis)
    return lo, lo + per


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def shard_blocks(blocks, mesh, axis: str = "blocks") -> torch.Tensor:
    """This rank's slice of a ``(B, m, n)`` stack (a tensor or a numpy
    array, whole on every rank), on its card. ``B`` must divide evenly by
    the axis size (pad with zero blocks upstream, as the scheduler does)."""
    lo, hi = _shard_range(len(blocks), mesh, axis)
    return _to_device(blocks[lo:hi], _device(mesh))


def replicate(x, mesh) -> torch.Tensor:
    """``x`` whole on this rank's card (every rank holds the same value)."""
    return _to_device(x, _device(mesh))


def _sharded(blocks, mesh, axis: str):
    """``(local stack, draw context)`` of a sharded call."""
    lo, hi = _shard_range(len(blocks), mesh, axis)
    local = _to_device(blocks[lo:hi], _device(mesh))
    return local, sharded_draws(lo, hi, len(blocks))


def compress_blocks(blocks, generator: torch.Generator, rank: int,
                    method: str = "rsvd", mesh=None, axis: str = "blocks",
                    **kwargs):
    """Compress a ``(B, m, n)`` block stack at a fixed rank, optionally
    sharded over a mesh.

    ``method`` is one of ``"rsvd"``, ``"nystrom"``, ``"column_id"``,
    ``"row_id"``, ``"two_sided_id"``, ``"sketched_two_sided_id"``; extra
    keywords go to the per-block pipeline (``oversample``, ``power_iters``,
    ``mode`` ...). With ``mesh``, every rank passes the whole stack and a
    generator in the same state, on its own card; each computes the blocks
    of its slice over ``axis`` and returns their factors (gather them with
    ``distributed.gather_factors``), equal to those blocks' factors of the
    unsharded call.
    """
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{sorted(_METHODS)}")
    fn = _METHODS[method]
    if mesh is None:
        return fn(blocks, generator, int(rank), **kwargs)
    local, draws = _sharded(blocks, mesh, axis)
    with draws:
        return fn(local, generator, int(rank), **kwargs)


def compress_blocks_adaptive(blocks, generator: torch.Generator,
                             rel_tol: float, sample_size: int,
                             max_rank: int | None = None, mesh=None,
                             axis: str = "blocks", **kwargs):
    """Tolerance-driven analogue of ``compress_blocks``: every block of the
    (optionally mesh-sharded) stack finds its own rank. Returns
    ``(svd_padded, ranks, histories)`` (see
    ``parallel.batch.batched_adaptive_rsvd``). On a mesh each rank's loop
    stops when its own blocks have converged."""
    args = (float(rel_tol), int(sample_size), max_rank)
    if mesh is None:
        return batched_adaptive_rsvd(blocks, generator, *args, **kwargs)
    local, draws = _sharded(blocks, mesh, axis)
    with draws:
        return batched_adaptive_rsvd(local, generator, *args, **kwargs)
