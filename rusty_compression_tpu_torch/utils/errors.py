"""Error taxonomy (port of ``rusty_compression_tpu.utils.errors``).

Mirrors the reference error enum: ``LinalgError``, ``CompressionError``
(requested tolerance unreachable), ``LayoutError``, ``PivotedQRError``,
under one base class, with the JAX package's names.
"""

from __future__ import annotations

__all__ = [
    "RustyCompressionError",
    "LinalgError",
    "CompressionError",
    "LayoutError",
    "PivotedQRError",
]


class RustyCompressionError(Exception):
    """Base class for all errors raised by this framework."""


class LinalgError(RustyCompressionError):
    """A dense linear-algebra primitive failed (non-finite result, ...)."""


class CompressionError(RustyCompressionError):
    """Could not compress to the desired tolerance.

    Raised when a tolerance-driven truncation finds no diagonal/singular
    value below the requested relative tolerance (the reference returns
    an error rather than silently keeping full rank).
    """


class LayoutError(RustyCompressionError):
    """Incompatible array layout or shape."""


class PivotedQRError(RustyCompressionError):
    """The pivoted QR factorization failed."""
