"""Row-sharded linear operators: model parallelism for one big operator
(port of ``rusty_compression_tpu.parallel.sharded``).

Block data parallelism (``parallel.mesh``) covers the north-star workload;
this module covers an operator too tall for one card. Its rows are split
over a mesh axis, each rank holding ``m / size`` rows on its card, and the
two protocol products each make one collective over that axis's group:

* ``conj_matmat`` (``Z = A^H @ Y``): each rank multiplies its rows' part,
  ``A_blk^H @ Y_blk``, and one ``all_reduce(SUM)`` gives every rank the
  whole product.
* ``matmat`` (``Y = A @ X``): each rank multiplies its row block, and one
  ``all_gather`` gives every rank the whole ``Y``. Here the port differs
  from the JAX package on purpose: there the rows of ``Y`` stay sharded
  and XLA gathers them where a later step needs them; here every product
  comes back whole on every rank, so that the samplers
  (``sample_range_*``, the adaptive loop) and
  ``SVD.compute_from_range_estimate``, which only touch the operator
  through these two products, run on it unmodified.

Every rank of the axis holds the same replicated inputs and so takes the
same decisions (a stop flag, a rank), and makes the same collectives in
the same order. Complex products travel as their real views
(``torch.view_as_real``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..linop import LinearOperator
from .distributed import _collective_device
from .mesh import _axis_size, _device, _to_device

__all__ = ["RowShardedOperator"]


def _real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


class RowShardedOperator(LinearOperator):
    """Dense ``(m, n)`` operator with its rows split over a mesh axis.

    Every rank passes the whole matrix (a tensor or a numpy array) and
    keeps rows ``[r m / size, (r + 1) m / size)`` on its card, ``r`` its
    coordinate on ``axis``; ``m`` must divide by the axis size. Exactly
    one collective per product (see the module docstring).
    """

    def __init__(self, a, mesh, axis: str = "rows"):
        size = _axis_size(mesh, axis)
        m, n = a.shape
        if m % size:
            raise ValueError(f"row count {m} not divisible by mesh axis "
                             f"{axis!r} ({size})")
        self.mesh, self.axis = mesh, axis
        self.group = mesh.get_group(axis)
        per = m // size
        self.lo = per * mesh.get_local_rank(axis)
        self.a = _to_device(a[self.lo:self.lo + per], _device(mesh))
        self._shape = (int(m), int(n))

    @property
    def shape(self) -> tuple[int, int]:
        return self._shape

    @property
    def dtype(self) -> torch.dtype:
        return self.a.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device

    def _through(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on the device the group's collectives use."""
        return x.to(_collective_device(self.group))

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ X``: the local row block's product and one ``all_gather``
        of the row blocks (the result is whole on every rank)."""
        part = self._through(self.a @ x)
        parts = [torch.empty_like(part) for _ in
                 range(dist.get_world_size(self.group))]
        dist.all_gather([_real(p) for p in parts], _real(part),
                        group=self.group)
        return torch.cat(parts, dim=-2).to(self.device)

    def conj_matmat(self, y: torch.Tensor) -> torch.Tensor:
        """``A^H @ Y`` for a whole ``Y``: the local rows' partial product
        and one ``all_reduce(SUM)``."""
        rows = self.a.shape[0]
        part = self._through(self.a.mH @ y[..., self.lo:self.lo + rows, :])
        dist.all_reduce(_real(part), op=dist.ReduceOp.SUM, group=self.group)
        return part.to(self.device)

    def to_dense(self) -> torch.Tensor:
        """The whole matrix on every rank (one ``all_gather``)."""
        part = self._through(self.a)
        parts = [torch.empty_like(part) for _ in
                 range(dist.get_world_size(self.group))]
        dist.all_gather([_real(p) for p in parts], _real(part),
                        group=self.group)
        return torch.cat(parts).to(self.device)
