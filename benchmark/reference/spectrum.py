"""The singular values of a block, in float64, by a plain randomized range
capture with a wide margin: ``width`` Gaussian columns, ``power`` power
iterations with a Householder re-orthonormalization after each product,
then the exact SVD of the captured ``(width, n)`` core on the host.

For the BEM blocks of the benchmark (singular values that fall by eight
orders within a few hundred) a capture of 512 columns with two power
iterations gives each of the leading singular values to rounding; where
``width`` reaches ``min(m, n)`` the values are the block's exact ones.
"""

from __future__ import annotations

import numpy as np
import torch


def singular_values(a: torch.Tensor, gen: torch.Generator, width: int = 512,
                    power: int = 2) -> np.ndarray:
    """Descending singular values (float64, on the host) of ``a`` (m, n)."""
    m, n = a.shape
    a64 = a.double()
    if width >= min(m, n):
        return torch.linalg.svdvals(a64).cpu().numpy()
    omega = torch.randn((n, width), generator=gen, dtype=torch.float64,
                        device=a.device)
    q = torch.linalg.qr(a64 @ omega)[0]
    for _ in range(power):
        q = torch.linalg.qr(a64.T @ q)[0]
        q = torch.linalg.qr(a64 @ q)[0]
    core = (q.T @ a64).cpu().numpy()
    del a64
    return np.linalg.svd(core, compute_uv=False)


def crossing(sigma: np.ndarray, tol: float) -> int:
    """The number of singular values with ``s_i / s_0 >= tol``."""
    return int(np.count_nonzero(sigma / sigma[0] >= tol))
