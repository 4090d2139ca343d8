"""Compression selector (port of ``rusty_compression_tpu.models.compression``).

The reference's ``CompressionType::{ADAPTIVE(f64), RANK(usize)}``: the
single knob threaded through every ``compress``.
"""

from __future__ import annotations

import dataclasses

__all__ = ["CompressionType", "Rank", "Adaptive"]


class CompressionType:
    """Base marker; use ``CompressionType.RANK(k)`` / ``.ADAPTIVE(tol)``."""

    RANK: type
    ADAPTIVE: type


@dataclasses.dataclass(frozen=True)
class Rank(CompressionType):
    """Compress to a fixed target rank (clamped to the available rank)."""

    rank: int


@dataclasses.dataclass(frozen=True)
class Adaptive(CompressionType):
    """Compress to a relative tolerance in ``[0, 1)``.

    Truncation keeps entries strictly before the first diagonal/singular
    value whose ratio to the leading one drops below ``tol``; if the
    spectrum never drops below ``tol``, compression fails with
    ``CompressionError``.
    """

    tol: float


CompressionType.RANK = Rank
CompressionType.ADAPTIVE = Adaptive
