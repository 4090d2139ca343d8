"""Moving the JAX package's factors and operands into the port.

``from_numpy`` takes a factor container of the JAX package (``QR``,
``LQ``, ``SVD``, ``ColumnID``, ``RowID``, ``TwoSidedID``) or an operand,
reads each leaf with ``np.asarray``, and builds the port's container of
the same name, or a ``DenseOperator``, on the chosen device, so that both
packages compute on the same numbers. It matches containers by class and
field names and imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .linop import DenseOperator
from .models.interp_decomp import ColumnID, RowID, TwoSidedID
from .models.qr import LQ, QR
from .models.svd import SVD

__all__ = ["from_numpy"]

_CONTAINERS = {cls.__name__: cls
               for cls in (QR, LQ, SVD, ColumnID, RowID, TwoSidedID)}


def _tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.int64)  # index vectors: torch gathers take int64
    return torch.tensor(arr, device=device)


def from_numpy(obj, device="cpu"):
    """The port's counterpart of ``obj`` on ``device``.

    ``obj`` is a factor container (anything whose class name is one of the
    port's containers and whose dataclass fields match), or an array,
    which becomes a ``DenseOperator``.
    """
    name = type(obj).__name__
    if name in _CONTAINERS and dataclasses.is_dataclass(obj):
        cls = _CONTAINERS[name]
        return cls(**{f.name: _tensor(getattr(obj, f.name), device)
                      for f in dataclasses.fields(cls)})
    return DenseOperator(_tensor(obj, device))
