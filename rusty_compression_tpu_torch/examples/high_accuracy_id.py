"""Two-sided interpolative decomposition at tol 1e-8 (twin of
``examples/high_accuracy_id.py``).

Builds the reference fixture, a 1500x500 matrix with spectrum
geomspace(1, 1e-10) (300x80 with ``RC_EXAMPLE_SMALL`` set), and
decomposes it with ``highacc_id.refined_two_sided_id(tol=1e-8)``: the
rank is discovered by the growth capture, and the skeleton ``X`` is taken
verbatim from A, so ``X == A[row_ind, col_ind]`` holds bitwise. Gates:
``||C X R - A||_F / ||A||_F <= 10 tol`` and the bitwise skeleton. The
card computes in native f64.

Run: ``python -m rusty_compression_tpu_torch.examples.high_accuracy_id``
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from rusty_compression_tpu_torch.examples import (gate, resolve_device,
                                                  seconds_since)
from rusty_compression_tpu_torch.highacc_id import refined_two_sided_id

SMALL = bool(os.environ.get("RC_EXAMPLE_SMALL"))
M, N = (300, 80) if SMALL else (1500, 500)
TOL = 1e-8


def make_input(m: int = M, n: int = N):
    """``(a, crossing)``: the reference fixture and the first rank whose
    singular value is below ``TOL``."""
    rng = np.random.default_rng(0)
    sig = np.geomspace(1.0, 1e-10, n)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * sig) @ v.T, int(np.argmax(sig / sig[0] < TOL))


def run(a: np.ndarray, generator: torch.Generator) -> dict:
    """``refined_two_sided_id`` of ``a`` on the generator's device, with the
    JAX example's gates."""
    dev = generator.device
    t0 = time.perf_counter()
    ts = refined_two_sided_id(torch.from_numpy(a).to(dev), generator,
                              tol=TOL)
    wall = seconds_since(t0, dev)
    c, x, r = (t.cpu().numpy() for t in (ts.c, ts.x, ts.r))
    err = float(np.linalg.norm(c @ (x @ r) - a) / np.linalg.norm(a))
    ri = ts.row_ind.cpu().numpy()[:ts.rank]
    ci = ts.col_ind.cpu().numpy()[:ts.rank]
    skel_exact = bool(np.array_equal(x, a[ri[:, None], ci]))
    gate(err <= 10 * TOL, err)
    gate(skel_exact, "the skeleton is not A[row_ind, col_ind]")
    return {"rank": ts.rank, "rel_err": err, "skeleton_bitwise": skel_exact,
            "row_ind": ri, "col_ind": ci, "seconds": wall}


def main(device=None) -> dict:
    dev = resolve_device(device)
    a, crossing = make_input()
    out = run(a, torch.Generator(device=dev).manual_seed(0))
    print(f"A: {M}x{N}, spectrum 1 -> 1e-10, tol {TOL:g} "
          f"(crossing at rank {crossing})")
    print(f"discovered rank: {out['rank']}")
    print(f"rel_diff_fro(C X R, A) = {out['rel_err']:.3e}  (f64-measured)")
    print(f"skeleton X == A[row_ind, col_ind] bitwise: "
          f"{out['skeleton_bitwise']}")
    print(f"wall: {out['seconds']:.2f}s (cold)")
    print("OK")
    return out


if __name__ == "__main__":
    main()
