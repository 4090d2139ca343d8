"""End-to-end H-matrix block workload with a resumable checkpoint (twin of
``examples/block_workload.py``).

Makes eight admissible Laplace blocks (interactions between
well-separated clusters of varying size), compresses them to relative
tolerance 1e-6 through one ``compress_heterogeneous`` stream, logs one
``MetricsLogger`` record per block, writes a checkpoint with
``io.save_block_results``, then drops block 3 from its manifest, checks
that it alone is pending, re-runs it and appends it, and checks that
nothing is pending. Each block's clouds come from two generators seeded
from one base seed at 2i and 2i + 1 (the JAX example's ``fold_in``). In
f64, the JAX example's branch off the TPU.

Run: ``python -m rusty_compression_tpu_torch.examples.block_workload``
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

import rusty_compression_tpu_torch as rt
from rusty_compression_tpu_torch.examples import (example_mesh, gate,
                                                  resolve_device)
from rusty_compression_tpu_torch.parallel import compress_heterogeneous
from rusty_compression_tpu_torch.utils.kernel_matrices import (
    laplace_kernel_block, random_cloud)

SIZES = [(300, 200), (512, 512), (300, 200), (150, 400), (512, 512),
         (200, 200), (300, 200), (640, 300)]
REL_TOL, SAMPLE_SIZE, DROPPED = 1e-6, 8, 3


def _fold(seed: int, i: int) -> int:
    """The seed of stream ``i`` of base ``seed``."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def make_blocks(seed: int, device="cpu") -> list[np.ndarray]:
    """Admissible blocks: clusters of varying size, 3-4 apart."""
    blocks = []
    for i, (m, n) in enumerate(SIZES):
        gt = torch.Generator(device=device).manual_seed(_fold(seed, 2 * i))
        gs = torch.Generator(device=device).manual_seed(
            _fold(seed, 2 * i + 1))
        x = random_cloud(gt, m, (0.0, 0.0, 0.0))
        y = random_cloud(gs, n, (3.0 + 0.5 * (i % 3), 0.0, 0.0))
        blocks.append(laplace_kernel_block(x, y).cpu().numpy())
    return blocks


def run(blocks: list[np.ndarray], generator: torch.Generator, ckpt: str,
        log=None) -> dict:
    """Stream ``blocks`` on the generator's device, checkpoint them into
    ``ckpt``, lose block 3 and recover it; the JAX example's checks."""
    dev = generator.device
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=dev))
    results = compress_heterogeneous(
        blocks, torch.Generator(device=dev).manual_seed(seed),
        rel_tol=REL_TOL, sample_size=SAMPLE_SIZE, mesh=example_mesh())
    if log is not None:
        logger = rt.MetricsLogger(log)
        for r in results:
            logger.write(r.record())
    total = sum(b.nbytes for b in blocks)
    stored = sum(sum(getattr(r.factors, f.name).nbytes
                     for f in dataclasses.fields(r.factors))
                 for r in results)

    rt.io.save_block_results(ckpt, results)
    manifest = os.path.join(ckpt, "manifest.jsonl")
    with open(manifest) as f:
        lines = f.readlines()
    with open(manifest, "w") as f:
        f.writelines(line for line in lines
                     if json.loads(line)["block"] != DROPPED)
    pending = rt.io.pending_blocks(ckpt, len(blocks))
    gate(pending == [DROPPED], pending)

    redo = compress_heterogeneous(
        [blocks[i] for i in pending],
        torch.Generator(device=dev).manual_seed(seed), rel_tol=REL_TOL,
        sample_size=SAMPLE_SIZE)
    redo = [dataclasses.replace(r, index=pending[i])
            for i, r in enumerate(redo)]
    rt.io.save_block_results(ckpt, redo, append=True)
    after = rt.io.pending_blocks(ckpt, len(blocks))
    gate(after == [], after)
    return {"blocks": len(blocks), "ranks": [r.rank for r in results],
            "max_residual": max(r.rel_residual for r in results),
            "total_bytes": total, "stored_bytes": stored,
            "pending_after_loss": pending, "pending_after_recovery": after,
            "redo_rank": redo[0].rank}


def main(device=None) -> dict:
    dev = resolve_device(device)
    blocks = make_blocks(0, device=dev)
    total_mb = sum(b.nbytes for b in blocks) / 2**20
    print(f"{len(blocks)} admissible blocks, {total_mb:.1f} MiB total, "
          f"{torch.cuda.device_count() if dev.type == 'cuda' else 1} "
          f"device(s)")
    ckpt = os.path.join(tempfile.mkdtemp(prefix="rc_demo_"), "ckpt")
    out = run(blocks, torch.Generator(device=dev).manual_seed(1), ckpt,
              log=sys.stdout)
    stored = out["stored_bytes"] / 2**20
    print(f"\ncompression ratio: {total_mb:.1f} MiB -> {stored:.2f} MiB "
          f"({total_mb / stored:.1f}x), max residual "
          f"{out['max_residual']:.2e}")
    print(f"checkpoint: {ckpt}")
    print(f"after simulated failure, pending blocks: "
          f"{out['pending_after_loss']}")
    print(f"recovered; pending now: {out['pending_after_recovery']}")
    return out


if __name__ == "__main__":
    main()
