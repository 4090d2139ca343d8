"""Hierarchical matrix compression, the north-star workload end to end
(twin of ``examples/hmatrix.py``).

1. points on the unit sphere (``N_POINTS``, default 3000) and a cluster
   tree by median bisection, built on the host in numpy (a copy of the
   JAX example's code, so the partition is the same);
2. the admissibility condition ``min(diam(s), diam(t)) <= eta dist(s, t)``
   splits the Laplace kernel matrix into admissible (low-rank) and dense
   blocks;
3. the far-field blocks are built on the device from one tensor of the
   points, kept there, and compressed to relative tolerance 1e-6 through
   one ``compress_heterogeneous`` stream (heterogeneous shapes, ranks
   found per block);
4. the near-field blocks (the 1/r singularity cut off at distance 1e-2)
   are built on the device, and the H-matrix matvec (``factors.apply``
   and ``index_add_``) is checked against the JAX example's dense
   operator: the cut-off kernel everywhere but on the far field, where it
   is exact. The reference is applied one panel of rows at a time, so the
   N x N matrix is never held.

In f64 at tol 1e-6, the JAX example's branch off the TPU (the card has
native f64). The memory is counted as there: the dense matrix at N^2 x 8
bytes, the H-matrix as its near blocks plus every tensor of each block's
factors.

Run: ``python -m rusty_compression_tpu_torch.examples.hmatrix``
(``N_POINTS`` to scale; 32768 is the size run on the card).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from rusty_compression_tpu_torch.examples import (example_mesh, gate,
                                                  resolve_device,
                                                  seconds_since)
from rusty_compression_tpu_torch.parallel import compress_heterogeneous
from rusty_compression_tpu_torch.utils.kernel_matrices import (
    laplace_kernel_block)
from rusty_compression_tpu_torch.utils.random_matrix import random_gaussian

TOL, SAMPLE_SIZE, CUTOFF = 1e-6, 8, 1e-2
#: rows of the dense reference applied at a time (2048 x N at N = 32768:
#: 0.5 GB a plane)
PANEL_ROWS = 2048

# -- cluster tree (the JAX example's, examples/hmatrix.py:47-95) ------------


class Cluster:
    def __init__(self, indices, points):
        self.indices = indices
        self.points = points[indices]
        self.center = self.points.mean(axis=0)
        self.radius = float(np.linalg.norm(
            self.points - self.center, axis=1).max())
        self.children = []


def build_tree(points, leaf_size=64):
    def split(idx):
        c = Cluster(idx, points)
        if len(idx) > leaf_size:
            spread = points[idx].max(0) - points[idx].min(0)
            ax = int(np.argmax(spread))
            med = np.median(points[idx, ax])
            left = idx[points[idx, ax] <= med]
            right = idx[points[idx, ax] > med]
            if len(left) and len(right):
                c.children = [split(left), split(right)]
        return c

    return split(np.arange(len(points)))


def admissible(s, t, eta=1.5):
    dist = np.linalg.norm(s.center - t.center) - s.radius - t.radius
    return dist > 0 and 2 * min(s.radius, t.radius) <= eta * dist


def partition(s, t, eta=1.5):
    """Recursive block partition: (admissible, inadmissible) leaf pairs."""
    if admissible(s, t, eta):
        return [(s, t)], []
    if not s.children and not t.children:
        return [], [(s, t)]
    # split the larger cluster
    ss = s.children if (s.children and (not t.children or
                                        s.radius >= t.radius)) else [s]
    ts = t.children if (t.children and (not s.children or
                                        t.radius > s.radius)) else [t]
    adm, inadm = [], []
    for a in ss:
        for b in ts:
            x, y = partition(a, b, eta)
            adm += x
            inadm += y
    return adm, inadm


# -- the workload -------------------------------------------------------------


def sphere_points(n_points: int) -> np.ndarray:
    """The JAX example's points: ``default_rng(0)`` normals, normalised."""
    g = np.random.default_rng(0).standard_normal((n_points, 3))
    return g / np.linalg.norm(g, axis=1, keepdims=True)


def _cluster_indices(pairs, device) -> dict:
    """Each cluster's index vector on the device, from one copy."""
    clusters = {}
    for s, t in pairs:
        clusters.setdefault(id(s), s)
        clusters.setdefault(id(t), t)
    order = list(clusters.values())
    flat = torch.from_numpy(np.concatenate(
        [c.indices for c in order]).astype(np.int64)).to(device)
    out, lo = {}, 0
    for c in order:
        out[id(c)] = flat[lo:lo + len(c.indices)]
        lo += len(c.indices)
    return out


#: the near field's cut-off kernel value, ``1 / (4 pi CUTOFF)``
CAP = 1.0 / (4.0 * math.pi * CUTOFF)


def _near_block(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``1 / (4 pi max(|x_i - y_j|, CUTOFF))``: the Laplace block capped at
    ``CAP`` (a coincident pair's infinity included)."""
    return laplace_kernel_block(x, y).clamp(max=CAP)


def _to_device(factors_list, device):
    """Every container of ``factors_list`` on ``device``, its tensors cut
    from one host-to-device copy."""
    leaves = [[getattr(f, fl.name) for fl in dataclasses.fields(f)]
              for f in factors_list]
    flat = torch.cat([t.reshape(-1) for ts in leaves for t in ts]).to(device)
    out, lo = [], 0
    for f, ts in zip(factors_list, leaves):
        parts = {}
        for fl, t in zip(dataclasses.fields(f), ts):
            parts[fl.name] = flat[lo:lo + t.numel()].view(t.shape)
            lo += t.numel()
        out.append(type(f)(**parts))
    return out


def dense_apply(pts: torch.Tensor, x: torch.Tensor, far: list, far_idx
                ) -> torch.Tensor:
    """The JAX example's dense operator applied to ``x``: the cut-off kernel
    over every panel of ``PANEL_ROWS`` rows, plus, on the far field, the
    difference between the exact kernel and the cut-off one (nonzero only
    where two points of an admissible block are closer than the cut-off:
    ``max(K - CAP, 0)``)."""
    n = pts.shape[0]
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    for lo in range(0, n, PANEL_ROWS):
        y[lo:lo + PANEL_ROWS] = _near_block(pts[lo:lo + PANEL_ROWS], pts) @ x
    if far:
        peaks = torch.stack([b.amax() for b in far]).cpu()
        for i in torch.nonzero(peaks > CAP).flatten().tolist():
            s_idx, t_idx = far_idx[i]
            y.index_add_(0, s_idx, (far[i] - CAP).clamp(min=0) @ x[t_idx])
    return y


def run(points: np.ndarray, x: np.ndarray, generator: torch.Generator
        ) -> dict:
    """The H-matrix workload on ``points`` (N, 3) on the generator's
    device: partition, far-field stream, near field, memory, and the
    matvec of ``x`` (N,) against the dense operator, gated at 50 tol.
    The two products come back on the host as ``y_h`` (the H-matrix's) and
    ``y_d`` (the dense operator's)."""
    dev = generator.device
    n_points = len(points)
    out: dict = {"n_points": n_points, "tol": TOL}
    t0 = time.perf_counter()
    tree = build_tree(points)
    adm, inadm = partition(tree, tree)
    out["partition_seconds"] = time.perf_counter() - t0
    out["admissible"], out["dense"] = len(adm), len(inadm)
    if not adm:
        return out

    t0 = time.perf_counter()
    pts = torch.from_numpy(points).to(dev)
    idx = _cluster_indices(adm + inadm, dev)
    far_idx = [(idx[id(s)], idx[id(t)]) for s, t in adm]
    far = [laplace_kernel_block(pts[si], pts[ti]) for si, ti in far_idx]
    out["far_build_seconds"] = seconds_since(t0, dev)
    out["far_bytes"] = sum(b.numel() * b.element_size() for b in far)
    out["far_max_side"] = max(max(b.shape) for b in far)

    t0 = time.perf_counter()
    results = compress_heterogeneous(far, generator, rel_tol=TOL,
                                     sample_size=SAMPLE_SIZE,
                                     mesh=example_mesh())
    out["stream_seconds"] = time.perf_counter() - t0
    out["ranks"] = [r.rank for r in results]
    out["max_rel_residual"] = max(r.rel_residual for r in results)

    t0 = time.perf_counter()
    near_idx = [(idx[id(s)], idx[id(t)]) for s, t in inadm]
    near = [_near_block(pts[si], pts[ti]) for si, ti in near_idx]
    out["near_build_seconds"] = seconds_since(t0, dev)

    out["dense_bytes"] = n_points * n_points * 8
    out["h_bytes"] = sum(b.numel() * b.element_size() for b in near) + sum(
        sum(getattr(r.factors, f.name).nbytes
            for f in dataclasses.fields(r.factors)) for r in results)

    t0 = time.perf_counter()
    xd = torch.from_numpy(x).to(dev)
    y_h = torch.zeros(n_points, dtype=xd.dtype, device=dev)
    factors = _to_device([r.factors for r in results], dev)
    for (si, ti), f in zip(far_idx, factors):
        y_h.index_add_(0, si, f.apply(xd[ti][:, None])[:, 0])
    for (si, ti), b in zip(near_idx, near):
        y_h.index_add_(0, si, b @ xd[ti])
    out["matvec_seconds"] = seconds_since(t0, dev)

    t0 = time.perf_counter()
    y_d = dense_apply(pts, xd, far, far_idx)
    out["reference_seconds"] = seconds_since(t0, dev)
    out["matvec_rel_err"] = float(torch.linalg.vector_norm(y_h - y_d)
                                  / torch.linalg.vector_norm(y_d))
    out["y_h"], out["y_d"] = y_h.cpu().numpy(), y_d.cpu().numpy()
    gate(out["matvec_rel_err"] < 50 * TOL,
         "H-matrix matvec accuracy regression")
    return out


def main(device=None) -> dict:
    dev = resolve_device(device)
    n_points = int(os.environ.get("N_POINTS", 3000))
    points = sphere_points(n_points)
    x = random_gaussian(torch.Generator(device=dev).manual_seed(2),
                        (n_points,), dtype=torch.float64).cpu().numpy()
    out = run(points, x, torch.Generator(device=dev).manual_seed(1))
    print(f"{n_points} points on the unit sphere -> "
          f"{out['admissible']} admissible + {out['dense']} dense blocks")
    if not out["admissible"]:
        print("no admissible blocks at this size — nothing to compress "
              "(increase N_POINTS); exiting")
        return out
    ranks = out["ranks"]
    print(f"far-field compressed: ranks min {min(ranks)} / "
          f"median {int(np.median(ranks))} / max {max(ranks)}, "
          f"max rel residual {out['max_rel_residual']:.2e}")
    print(f"memory: dense {out['dense_bytes']/2**20:.1f} MiB -> H-matrix "
          f"{out['h_bytes']/2**20:.1f} MiB "
          f"({out['dense_bytes']/out['h_bytes']:.1f}x)")
    print(f"H-matrix matvec rel error vs dense: {out['matvec_rel_err']:.2e} "
          f"(tol {out['tol']:g})")
    print("OK")
    return out


if __name__ == "__main__":
    main()
