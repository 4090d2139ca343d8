"""Fixed-rank two-sided interpolative decomposition (twin of
``examples/interpolative_decomposition.py``).

Builds a 500x100 matrix whose singular values decay geometrically from 1
to 1e-10, pivoted-QRs it, compresses to rank 20, converts to a column ID
and then a two-sided ID, and reports the relative Frobenius error of each
stage and how far the skeleton ``X`` is from ``A[row_ind[:k],
col_ind[:k]]``.

In f64, the JAX example's branch off the TPU (the card has native f64). At
n = 100 ``auto`` takes the plain pivot rule (``gs``) and no kernel, as the
JAX package does.

Run: ``python -m rusty_compression_tpu_torch.examples.interpolative_decomposition``
"""

from __future__ import annotations

import numpy as np
import torch

import rusty_compression_tpu_torch as rt
from rusty_compression_tpu_torch.examples import resolve_device

M, N, RANK = 500, 100, 20


def run(a: np.ndarray, generator: torch.Generator) -> dict:
    """QR -> rank 20 -> column ID -> two-sided ID of ``a`` on the
    generator's device; the errors of each stage, the skeleton's distance
    from ``A[rows, cols]`` and the index vectors."""
    mat = torch.from_numpy(np.asarray(a)).to(generator.device)
    qr = rt.QR.compute_from(mat, generator=generator).compress(
        rt.CompressionType.RANK(RANK))
    col_id = qr.column_id()
    two_sided = col_id.two_sided_id()
    skel = mat[two_sided.row_ind[:RANK], :][:, two_sided.col_ind[:RANK]]
    return {
        "qr_rank": qr.rank,
        "qr_rel_err": float(rt.rel_diff_fro(qr.to_mat(), mat)),
        "column_id_rank": col_id.rank,
        "column_id_rel_err": float(rt.rel_diff_fro(col_id.to_mat(), mat)),
        "two_sided_rank": two_sided.rank,
        "two_sided_rel_err": float(rt.rel_diff_fro(two_sided.to_mat(), mat)),
        "skeleton_err": float((two_sided.x - skel).abs().max()),
        "col_ind": two_sided.col_ind.cpu().numpy(),
        "row_ind": two_sided.row_ind.cpu().numpy(),
        "sigma_next": 10.0 ** (-10.0 * RANK / (a.shape[1] - 1)),
    }


def make_input(device) -> np.ndarray:
    gen = torch.Generator(device=device).manual_seed(42)
    return rt.random_approximate_low_rank_matrix(
        gen, (M, N), sigma_max=1.0, sigma_min=1e-10,
        dtype=torch.float64).cpu().numpy()


def main(device=None) -> dict:
    dev = resolve_device(device)
    print(f"Compressing a {M}x{N} matrix with geomspace spectrum "
          f"(1 -> 1e-10) at rank {RANK}.\n")
    out = run(make_input(dev), torch.Generator(device=dev).manual_seed(0))
    print(f"QR compressed:      rank {out['qr_rank']}, rel error "
          f"{out['qr_rel_err']:.3e}")
    print(f"Column ID:          rank {out['column_id_rank']}, rel error "
          f"{out['column_id_rel_err']:.3e}")
    print(f"Two-sided ID:       rank {out['two_sided_rank']}, rel error "
          f"{out['two_sided_rel_err']:.3e}")
    print(f"Skeleton exactness: max |X - A[rows, cols]| = "
          f"{out['skeleton_err']:.3e}")
    print(f"\n(sigma_{RANK + 1}/sigma_1 = {out['sigma_next']:.3e} — the "
          f"best possible rank-{RANK} error for this spectrum.)")
    return out


if __name__ == "__main__":
    main()
