"""Permutation utilities (port of ``rusty_compression_tpu.utils.permutation``).

Semantics:

* ``perm[i] = j``: after a forward permutation, position ``i`` of the
  result holds entry ``j`` of the original.
* The inverse ``inv`` satisfies ``inv[perm[i]] = i``.
* ``COL``/``ROW`` apply the forward permutation to columns/rows;
  ``COLINV``/``ROWINV`` apply the inverse.

Permutation vectors may carry the same leading batch axes as the
matrices they permute (one permutation per block).
"""

from __future__ import annotations

import enum

import torch

__all__ = [
    "MatrixPermutationMode",
    "VectorPermutationMode",
    "invert_permutation_vector",
    "apply_matrix_permutation",
    "apply_vector_permutation",
]


class MatrixPermutationMode(enum.Enum):
    """Matrix permutation modes."""

    COL = "col"
    ROW = "row"
    COLINV = "colinv"
    ROWINV = "rowinv"


class VectorPermutationMode(enum.Enum):
    """Vector permutation modes."""

    INV = "inv"
    NOINV = "noinv"


def invert_permutation_vector(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation vector (last axis): if ``perm[i] = j``
    then ``inv[j] = i``."""
    n = perm.shape[-1]
    ar = torch.arange(n, dtype=perm.dtype, device=perm.device)
    return torch.empty_like(perm).scatter_(-1, perm, ar.expand_as(perm))


def apply_matrix_permutation(mat: torch.Tensor, perm: torch.Tensor,
                             mode: MatrixPermutationMode) -> torch.Tensor:
    """Permute the rows or columns of ``mat`` (last two axes).

    ``COL``: ``out[..., :, i] = mat[..., :, perm[..., i]]``;
    ``ROW``: ``out[..., i, :] = mat[..., perm[..., i], :]``;
    ``COLINV``/``ROWINV`` use the inverse permutation.
    """
    perm = perm.to(device=mat.device, dtype=torch.int64)
    # one permutation for every matrix of a batch: broadcast it
    perm = perm.reshape((1,) * (mat.ndim - 1 - perm.ndim) + perm.shape)
    if mode in (MatrixPermutationMode.COLINV, MatrixPermutationMode.ROWINV):
        perm = invert_permutation_vector(perm)
    if mode in (MatrixPermutationMode.COL, MatrixPermutationMode.COLINV):
        return torch.take_along_dim(mat, perm.unsqueeze(-2), dim=-1)
    return torch.take_along_dim(mat, perm.unsqueeze(-1), dim=-2)


def apply_vector_permutation(vec: torch.Tensor, perm: torch.Tensor,
                             mode: VectorPermutationMode) -> torch.Tensor:
    """Permute a vector (last axis): ``out[..., i] = vec[..., perm[..., i]]``
    (``NOINV``) or the same with the inverse permutation (``INV``)."""
    perm = perm.to(device=vec.device, dtype=torch.int64)
    perm = perm.reshape((1,) * (vec.ndim - perm.ndim) + perm.shape)
    if mode is VectorPermutationMode.INV:
        perm = invert_permutation_vector(perm)
    return torch.take_along_dim(vec, perm, dim=-1)
