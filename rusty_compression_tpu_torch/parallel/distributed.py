"""Process groups and ordered gathering (port of
``rusty_compression_tpu.parallel.distributed``).

JAX is single-controller: one process addresses every device of a host,
and ``jax.distributed`` joins the hosts. PyTorch runs one process per card
under ``torch.distributed`` (started by ``torchrun --nproc-per-node N``, or
by any launcher that gives each process its rank), on one host or many, so
one layer covers both. The backend follows the device: NCCL for ``"cuda"``,
Gloo for ``"cpu"``; neither stands in for the other.

Design choices that remove communication, as in the JAX package:

* **Sketches are derived, not broadcast.** Every rank holds the same
  generator seed and draws what the unsharded call draws
  (``utils.random_matrix.sharded_draws``), keeping its own blocks' part.
* **Block compressions are independent**: no collective runs inside the
  compute; the factors are gathered once, in submission order, by
  ``gather_factors``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "global_mesh",
    "local_block_slice",
    "gather_factors",
]

#: the backend of each device type; a card never runs Gloo in its place
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _launched() -> bool:
    """True under a launcher that sets torchrun's variables."""
    return all(v in os.environ for v in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device_type: str = "cuda",
               timeout: datetime.timedelta | None = None) -> bool:
    """Join the process group (idempotent).

    Returns True once a group exists: one made here from the arguments
    (``init_method`` such as ``"tcp://host:port"``, ``world_size``,
    ``rank``) or from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the card), or
    one that exists already. On a single process with neither it does
    nothing and returns False, so it is safe to call at program start.
    """
    if dist.is_initialized():
        return True
    if init_method is None and world_size is None and not _launched():
        return False
    backend = _backend(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              if rank is None else
                              int(rank) % torch.cuda.device_count())
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None
                            else int(world_size),
                            rank=-1 if rank is None else int(rank), **kwargs)
    return True


def _backend(device_type: str) -> str:
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r}; expected one of "
                         f"{sorted(BACKENDS)}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' but torch finds no CUDA "
                           "device; pass device_type='cpu' to run on the CPU")
    return BACKENDS[device_type]


def global_mesh(axis_name: str = "blocks", device_type: str = "cuda"):
    """1-D mesh over every rank of the process group."""
    from .mesh import make_mesh

    return make_mesh(axis_names=(axis_name,), device_type=device_type)


def local_block_slice(n_blocks: int) -> slice:
    """Submission-order slice of blocks owned by this process.

    Blocks are dealt out contiguously, so that the final gather is a plain
    ordered concatenation (the north star's "factors gathered in submission
    order"). Without a process group the one process owns every block.
    """
    size, rank = ((dist.get_world_size(), dist.get_rank())
                  if dist.is_initialized() else (1, 0))
    per = -(-n_blocks // size)
    lo = per * rank
    return slice(lo, min(lo + per, n_blocks))


def _host(x):
    """Tensors of a nested structure as numpy, other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _host(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _gather_leaf(x: np.ndarray, group) -> np.ndarray:
    """One batched leaf gathered along its leading axis: the ranks' leaves
    zero-padded to the largest extent of each later axis (a stack's SVD at
    each rank's own largest rank: the padding is the masked triplets'
    zeros), one ``all_gather``, concatenated in rank order."""
    local = torch.from_numpy(np.ascontiguousarray(x)).to(
        _collective_device(group))
    shapes: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(shapes, tuple(local.shape), group=group)
    tail = tuple(max(s[d] for s in shapes) for d in range(1, local.ndim))
    padded = local.new_zeros((local.shape[0], *tail))
    padded[tuple(slice(0, d) for d in local.shape)] = local
    parts = [local.new_zeros((s[0], *tail)) for s in shapes]
    if padded.is_complex():
        dist.all_gather([torch.view_as_real(p) for p in parts],
                        torch.view_as_real(padded), group=group)
    else:
        dist.all_gather(parts, padded, group=group)
    return torch.cat(parts).cpu().numpy()


def _collective_device(group) -> torch.device:
    """Where a collective's buffers live: the rank's card under NCCL, the
    host under Gloo (which also serves ranks that share one card, and moves
    a CUDA tensor through the host)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_factors(factors, mesh=None, axis: str = "blocks"):
    """Factors of a sharded call made whole on every rank, as host numpy.

    ``factors`` is what a sharded call returned on this rank: a factor
    container (``SVD``, ``ColumnID`` ...), a tensor, or a tuple of them
    (``compress_blocks_adaptive``), each batched over its leading axis; or
    a list with one item per block (``refined_rsvd_fused_batch``). With a
    ``mesh`` the ranks' parts are gathered over ``axis``: each batched
    tensor by one ``all_gather`` along its leading axis, a list by
    concatenating the ranks' lists; the result, in submission order, is
    the same on every rank and has the unsharded call's layout, with
    tensors as numpy arrays. Without a mesh the factors are copied to the
    host as they are.
    """
    host = _host(factors)
    if mesh is None:
        return host
    group = mesh.get_group(axis)
    if isinstance(host, list):
        parts: list = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, host, group=group)
        return [item for part in parts for item in part]
    return _gather_tree(host, group)


def _gather_tree(x, group):
    if isinstance(x, np.ndarray):
        return _gather_leaf(x, group)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _gather_tree(getattr(x, f.name), group)
                          for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_gather_tree(v, group) for v in x))
    if isinstance(x, tuple):
        return tuple(_gather_tree(v, group) for v in x)
    raise TypeError(f"gather_factors cannot gather a {type(x).__name__}")
