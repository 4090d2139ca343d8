"""Complex (c64 / c128) compression (twin of
``examples/complex_operators.py``).

Builds a 1024x1024 c64 matrix whose spectrum decays to 1e-10 over 60
ranks and compresses it at rank 27 through the standard class (c64):
``planar_rsvd``, ``planar_two_sided_id`` (K2 picks the pivots of its
sketch and of the LQ of C), ``QR.compute_from`` -> ``column_id()`` and
``compress(..., RANK(k, method="two_sided_id"))``; then through the c128
class, ``refined_rsvd_planar`` of the c128 copy at tol 1e-8 (gate 5e-8).
The JAX example keeps complex math off a TPU that rejects it; the card
takes complex dtypes natively, so everything here runs on the device.

Run: ``python -m rusty_compression_tpu_torch.examples.complex_operators``
"""

from __future__ import annotations

import time

import numpy as np
import torch

import rusty_compression_tpu_torch as rt
from rusty_compression_tpu_torch.examples import (device_name, gate,
                                                  resolve_device,
                                                  seconds_since)

SIZE, RANK = 1024, 27
R_GEN, DECAY = 96, 60  # the spectrum decays to 1e-10 over 60 ranks
ROUND_RANK, TOL = 66, 1e-8


def make_input(size: int = SIZE):
    """``(a, sig)``: the c64 matrix of the JAX example and its spectrum."""
    rng = np.random.default_rng(0)
    sig = 10.0 ** (-10.0 * np.arange(R_GEN) / (DECAY - 1))
    u, _ = np.linalg.qr(rng.standard_normal((size, R_GEN))
                        + 1j * rng.standard_normal((size, R_GEN)))
    v, _ = np.linalg.qr(rng.standard_normal((size, R_GEN))
                        + 1j * rng.standard_normal((size, R_GEN)))
    return ((u * sig) @ v.conj().T).astype(np.complex64), sig


def _rel(rec: torch.Tensor, a: torch.Tensor) -> float:
    return float(rt.rel_diff_fro(rec, a))


def run(a: np.ndarray, generator: torch.Generator) -> dict:
    """Both accuracy classes on the generator's device; the errors the JAX
    example prints, and its one gate (the c128 residual <= 5 tol)."""
    dev, rank = generator.device, RANK
    at = torch.from_numpy(a).to(dev)
    out = {}

    t0 = time.perf_counter()
    svd = rt.planar_rsvd(at, generator, rank=rank)
    out["rsvd_seconds"] = seconds_since(t0, dev)
    out["rsvd_rel_err"] = _rel(svd.to_mat(), at)

    t0 = time.perf_counter()
    ts = rt.planar_two_sided_id(at, generator, rank=rank)
    out["two_sided_seconds"] = seconds_since(t0, dev)
    out["two_sided_rank"] = ts.rank
    out["two_sided_rel_err"] = _rel(ts.to_mat(), at)
    skel = at[ts.row_ind[:ts.rank][:, None], ts.col_ind[:ts.rank]]
    out["skeleton_err"] = float((ts.x - skel).abs().max() / skel.abs().max())

    # the standard front door: the caller never names planarc
    cid = rt.QR.compute_from(at, generator=generator).compress(
        rt.Rank(rank)).column_id()
    out["column_id_rel_err"] = _rel(cid.to_mat(), at)
    ts2 = rt.compress(at, generator,
                      rt.CompressionConfig.RANK(rank, method="two_sided_id"))
    out["compress_two_sided_rank"] = ts2.rank
    out["compress_two_sided_rel_err"] = _rel(ts2.to_mat(), at)

    a128 = a.astype(np.complex128)
    t0 = time.perf_counter()
    ref = rt.refined_rsvd_planar(torch.from_numpy(a128).to(dev), generator,
                                 round_rank=ROUND_RANK, tol=TOL)
    out["refined_seconds"] = seconds_since(t0, dev)
    out["refined_rank"] = ref.rank
    out["refined_residual"] = ref.residual_fro(a128)
    gate(out["refined_residual"] <= 5 * TOL, out["refined_residual"])
    return out


def main(device=None) -> dict:
    dev = resolve_device(device)
    a, sig = make_input()
    print(f"matrix: {SIZE}x{SIZE} c64, spectrum 1 -> 1e-10 over {DECAY} "
          f"ranks")
    print(f"device: {device_name(dev)} (takes complex dtypes: all the "
          f"complex math runs on it)\n")
    out = run(a, torch.Generator(device=dev).manual_seed(1))
    k = RANK
    print(f"planar rSVD rank {k}: rel err {out['rsvd_rel_err']:.2e} "
          f"(spectrum position {sig[k]:.2e}), {out['rsvd_seconds']:.2f} s")
    print(f"planar two-sided ID rank {out['two_sided_rank']}: rel err "
          f"{out['two_sided_rel_err']:.2e}, skeleton entrywise "
          f"{out['skeleton_err']:.2e}, {out['two_sided_seconds']:.2f} s")
    print(f"standard-API c64 QR -> column ID rank {k}: rel err "
          f"{out['column_id_rel_err']:.2e} (dispatched device)")
    print(f"rt.compress c64 two-sided ID rank "
          f"{out['compress_two_sided_rank']}: rel err "
          f"{out['compress_two_sided_rel_err']:.2e}")
    print(f"refined planar rSVD tol {TOL:g}: rank {out['refined_rank']}, "
          f"rel resid {out['refined_residual']:.2e}, "
          f"{out['refined_seconds']:.2f} s")
    return out


if __name__ == "__main__":
    main()
