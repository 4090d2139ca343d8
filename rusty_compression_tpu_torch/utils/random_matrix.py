"""Random matrix generation (port of ``rusty_compression_tpu.utils.random_matrix``).

Gaussian test/sketch matrices, random orthogonal matrices, and the
synthetic approximately-low-rank fixture with a geometrically spaced
spectrum. An explicit ``torch.Generator`` takes the place of the JAX
package's keys; the two give different numbers from the same seed, so
tests that compare the packages feed both the same numpy-made matrices.
"""

from __future__ import annotations

import math

import torch

from .dtypes import herm, real_dtype

__all__ = [
    "random_gaussian",
    "random_orthogonal_matrix",
    "random_approximate_low_rank_matrix",
]


def random_gaussian(generator: torch.Generator, shape,
                    dtype: torch.dtype = torch.float64,
                    device=None) -> torch.Tensor:
    """Standard Gaussian matrix, entrywise N(0, 1), on ``device``
    (default: the generator's device).

    For complex dtypes the real and imaginary parts are each N(0, 1), as
    in the JAX package (entries of variance 2).
    """
    device = generator.device if device is None else device
    if dtype.is_complex:
        rdt = real_dtype(dtype)
        re = torch.randn(shape, generator=generator, dtype=rdt, device=device)
        im = torch.randn(shape, generator=generator, dtype=rdt, device=device)
        return torch.complex(re, im)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def random_orthogonal_matrix(generator: torch.Generator, shape,
                             dtype: torch.dtype = torch.float64,
                             device=None) -> torch.Tensor:
    """Random matrix with orthonormal columns (m >= n) or rows (n > m):
    the left singular vectors of a Gaussian matrix, with the tall/wide
    swap of the reference."""
    m, n = shape
    swapped = n > m
    if swapped:
        m, n = n, m
    g = random_gaussian(generator, (m, n), dtype=dtype, device=device)
    u, _, _ = torch.linalg.svd(g, full_matrices=False)
    return herm(u) if swapped else u


def random_approximate_low_rank_matrix(generator: torch.Generator, shape,
                                       sigma_max: float, sigma_min: float,
                                       dtype: torch.dtype = torch.float64,
                                       device=None) -> torch.Tensor:
    """``U @ diag(sigma) @ Vt`` with singular values geometrically spaced
    in ``[sigma_min, sigma_max]`` and random orthogonal ``U``, ``Vt``."""
    if not sigma_min < sigma_max:
        raise ValueError("`sigma_min` must be smaller than `sigma_max`")
    if not sigma_min > 0.0:
        raise ValueError("`sigma_min` must be positive.")
    m, n = shape
    k = min(m, n)
    u = random_orthogonal_matrix(generator, (m, k), dtype=dtype, device=device)
    vt = random_orthogonal_matrix(generator, (k, n), dtype=dtype,
                                  device=device)
    sing = torch.logspace(math.log10(sigma_max), math.log10(sigma_min), k,
                          dtype=real_dtype(dtype), device=u.device)
    return (u * sing.to(u.dtype)) @ vt
