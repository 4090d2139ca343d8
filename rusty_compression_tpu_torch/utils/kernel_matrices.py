"""Kernel test matrices (port of ``rusty_compression_tpu.utils.kernel_matrices``).

* ``hilbert`` — ``1 / (i + j + 1)``: exponentially decaying spectrum.
* ``laplace_kernel_block`` — interaction block ``1 / (4 pi |x_i - y_j|)``
  between two well-separated 3-D point clouds: the admissible H-matrix
  off-diagonal block, numerically low rank.

Built on the device of the inputs (``hilbert``, which has none: on the
card unless told otherwise), O(mn).
"""

from __future__ import annotations

import math

import torch

__all__ = ["hilbert", "laplace_kernel_block", "random_cloud"]


def hilbert(n: int, dtype: torch.dtype = torch.float64,
            device="cuda") -> torch.Tensor:
    """Hilbert matrix ``H[i, j] = 1 / (i + j + 1)`` (n, n), built on
    ``device``: the card unless the caller names another device (the CPU
    tests pass ``device="cpu"``)."""
    i = torch.arange(n, dtype=dtype, device=device)
    return 1.0 / (i[:, None] + i[None, :] + 1.0)


def random_cloud(generator: torch.Generator, n: int, center,
                 radius: float = 0.5, dtype: torch.dtype = torch.float64,
                 device=None) -> torch.Tensor:
    """``n`` uniform points in a cube of half-width ``radius`` around
    ``center`` (3-vector), on ``device`` (default: the generator's)."""
    device = generator.device if device is None else device
    c = torch.as_tensor(center, dtype=dtype, device=device)
    u = torch.rand((n, 3), generator=generator, dtype=dtype, device=device)
    return c + (2.0 * radius) * u - radius


def laplace_kernel_block(targets: torch.Tensor, sources: torch.Tensor,
                         dtype: torch.dtype | None = None) -> torch.Tensor:
    """Laplace single-layer block ``K[i, j] = 1 / (4 pi |x_i - y_j|)``
    between targets (..., m, 3) and sources (..., n, 3).

    The squared distance is summed one coordinate at a time, so the
    working set stays at two (m, n) planes rather than an (m, n, 3) one.
    """
    x, y = targets, sources
    if dtype is not None:
        x, y = x.to(dtype), y.to(dtype)
    d2 = torch.zeros(x.shape[:-1] + (y.shape[-2],), dtype=x.dtype,
                     device=x.device)
    for c in range(3):
        d2 += (x[..., :, None, c] - y[..., None, :, c]) ** 2
    return 1.0 / (4.0 * math.pi * torch.sqrt(d2))
