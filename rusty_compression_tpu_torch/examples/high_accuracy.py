"""tol-1e-8 compression, the north-star tolerance (twin of
``examples/high_accuracy.py``).

Compresses a 2048x2048 matrix whose spectrum decays to 1e-10 over 120
ranks (512 and 60 with ``RC_EXAMPLE_SMALL`` set) to relative tolerance
1e-8 with ``highacc.refined_rsvd_fused``, and verifies the residual in
full f64 on the host, the rank against the spectrum's crossing and the
orthogonality of U. The card computes in native f64, so the pipeline is
the JAX package's without its f32 emulation of f64.

Run: ``python -m rusty_compression_tpu_torch.examples.high_accuracy``
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from rusty_compression_tpu_torch.examples import (device_name, gate,
                                                  resolve_device,
                                                  seconds_since)
from rusty_compression_tpu_torch.highacc import refined_rsvd_fused

SMALL = bool(os.environ.get("RC_EXAMPLE_SMALL"))
M = 512 if SMALL else 2048
DECAY_RANK = 60 if SMALL else 120
TOL = 1e-8


def make_input(m: int = M, decay_rank: int = DECAY_RANK):
    """``(a, sig)``: the f64 matrix of the JAX example and its spectrum."""
    rng = np.random.default_rng(0)
    r_gen = decay_rank + 40
    sig = 10.0 ** (-10.0 * np.arange(r_gen) / (decay_rank - 1))
    u, _ = np.linalg.qr(rng.standard_normal((m, r_gen)))
    v, _ = np.linalg.qr(rng.standard_normal((m, r_gen)))
    return (u * sig) @ v.T, sig


def run(a: np.ndarray, sig: np.ndarray, generator: torch.Generator,
        decay_rank: int = DECAY_RANK) -> dict:
    """``refined_rsvd_fused`` of ``a`` on the generator's device, with the
    JAX example's gates: residual <= 5 tol, rank within 2 of the first
    ``sigma_i / sigma_0 < tol``."""
    dev = generator.device
    t0 = time.perf_counter()
    out = refined_rsvd_fused(torch.from_numpy(a).to(dev), generator,
                             round_rank=int(decay_rank * 1.1), tol=TOL)
    wall = seconds_since(t0, dev)
    resid = out.residual_fro(a)  # exact host f64 verification
    u64 = out.to_f64()[0].cpu().numpy()
    ortho = float(np.abs(u64.T @ u64 - np.eye(out.rank)).max())
    expect = int(np.searchsorted(-sig / sig[0], -TOL))
    gate(resid <= 5 * TOL, resid)
    gate(abs(out.rank - expect) <= 2, (out.rank, expect))
    return {"rank": out.rank, "crossing": expect, "residual": resid,
            "orthogonality": ortho, "seconds": wall}


def main(device=None) -> dict:
    dev = resolve_device(device)
    a, sig = make_input()
    print(f"device: {device_name(dev)}  matrix: {M}x{M} f64, spectrum 1 -> 1e-10 over "
          f"{DECAY_RANK} ranks")
    out = run(a, sig, torch.Generator(device=dev).manual_seed(0))
    print(f"rank {out['rank']} at tol {TOL:g}: rel residual "
          f"{out['residual']:.3e} (gate 5e-8), U orthogonality "
          f"{out['orthogonality']:.1e}, {out['seconds']:.2f} s (cold)")
    print("OK: f64-accuracy-class compression on", device_name(dev))
    return out


if __name__ == "__main__":
    main()
