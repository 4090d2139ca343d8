"""Scalar/dtype policy helpers (port of ``rusty_compression_tpu.utils.dtypes``).

The reference library is generic over f32, f64, c64 and c128; one code
path here is generic over torch dtypes, and these helpers carry the dtype
relationships (real counterpart, complex detection, Hermitian transpose).
"""

from __future__ import annotations

import torch

__all__ = ["real_dtype", "is_complex", "herm", "eps"]


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """Real counterpart of a (possibly complex) dtype."""
    if dtype == torch.complex64:
        return torch.float32
    if dtype == torch.complex128:
        return torch.float64
    return dtype


def is_complex(dtype: torch.dtype) -> bool:
    return dtype.is_complex


def herm(x: torch.Tensor) -> torch.Tensor:
    """Hermitian (conjugate) transpose of the last two axes (a view)."""
    return x.mH


def eps(dtype: torch.dtype) -> float:
    """Machine epsilon of the real counterpart of ``dtype``."""
    return float(torch.finfo(real_dtype(dtype)).eps)
