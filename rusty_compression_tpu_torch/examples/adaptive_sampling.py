"""Adaptive randomized range sampling with its residual history (twin of
``examples/adaptive_sampling.py``).

Builds a 500x200 matrix (spectrum 1 -> 1e-10), samples its range
adaptively to relative tolerance 1e-5 in blocks of 5 columns, prints the
sampler's estimated residual beside the exact ``||A - Q Q^T A||_F /
||A||_F`` at each rank (and plots both when matplotlib is there), then
finishes the compression with ``QR.compute_from_range_estimate`` and
reports its error.

In f64 at tol 1e-5, the JAX example's branch off the TPU (the card has
native f64). Writes ``residuals.png`` beside this module.

Run: ``python -m rusty_compression_tpu_torch.examples.adaptive_sampling``
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import rusty_compression_tpu_torch as rt
from rusty_compression_tpu_torch.examples import resolve_device

M, N = 500, 200
REL_TOL, SAMPLE_SIZE = 1e-5, 5


def run(a: np.ndarray, generator: torch.Generator) -> dict:
    """``sample_range_adaptive`` of ``a`` on the generator's device, the
    exact residual at each rank of its history, and the QR from the range
    estimate with its error."""
    mat = torch.from_numpy(np.asarray(a)).to(generator.device)
    q, residuals = rt.sample_range_adaptive(mat, generator, REL_TOL,
                                            SAMPLE_SIZE)
    a64, qn = np.asarray(a), q.cpu().numpy()
    a_norm = np.linalg.norm(a64)
    ranks = [r for r, _ in residuals]
    exact = []
    for r in ranks:
        qr_ = qn[:, :min(r, qn.shape[1])]
        exact.append(float(np.linalg.norm(a64 - qr_ @ (qr_.T @ a64))
                           / a_norm))
    qr = rt.QR.compute_from_range_estimate(q, mat)
    return {"rank": int(q.shape[1]), "blocks": len(residuals),
            "ranks": ranks, "estimated": [float(e) for _, e in residuals],
            "exact": exact, "qr_rank": qr.rank,
            "qr_rel_err": float(rt.rel_diff_fro(qr.to_mat(), mat))}


def make_input(device) -> np.ndarray:
    gen = torch.Generator(device=device).manual_seed(0)
    return rt.random_approximate_low_rank_matrix(
        gen, (M, N), sigma_max=1.0, sigma_min=1e-10,
        dtype=torch.float64).cpu().numpy()


def plot(out: dict, path: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.semilogy(out["ranks"], out["estimated"], "o-",
                label="estimated (HMT probe)")
    ax.semilogy(out["ranks"], out["exact"], "s--",
                label="exact ||A - QQ^T A|| / ||A||")
    ax.axhline(REL_TOL, color="gray", lw=0.8, label=f"tol {REL_TOL:.0e}")
    ax.set_xlabel("rank")
    ax.set_ylabel("relative residual")
    ax.set_title(f"Adaptive range sampling convergence ({M}x{N})")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)


def main(device=None) -> dict:
    dev = resolve_device(device)
    print(f"Adaptively sampling the range of a {M}x{N} matrix "
          f"(tol {REL_TOL:.0e}, block size {SAMPLE_SIZE})...")
    out = run(make_input(dev), torch.Generator(device=dev).manual_seed(1))
    print(f"Converged at rank {out['rank']} after {out['blocks']} blocks.")
    print(f"{'rank':>6} {'estimated':>12} {'exact':>12}")
    for r, e, x in zip(out["ranks"], out["estimated"], out["exact"]):
        print(f"{r:>6} {e:>12.3e} {x:>12.3e}")
    try:
        path = Path(__file__).with_name("residuals.png")
        plot(out, path)
        print(f"\nWrote {path}")
    except ImportError:
        print("\n(matplotlib unavailable — skipping residuals.png)")
    print(f"\nQR from range estimate: rank {out['qr_rank']}, "
          f"rel error {out['qr_rel_err']:.3e} (tol {REL_TOL:.0e})")
    return out


if __name__ == "__main__":
    main()
