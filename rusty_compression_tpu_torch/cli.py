"""Command-line block-compression runner (port of ``rusty_compression_tpu.cli``).

Reads a directory of dense blocks (``.npy`` files, one matrix each; the
submission order is the sorted file order) or one ``.npz`` bundle,
compresses every block (fixed rank or tolerance) through the block stream
of ``parallel.scheduler``, and writes a checkpoint directory with a
``manifest.jsonl`` (resumable: finished blocks are skipped on a re-run
with ``--resume``).

Usage::

    python -m rusty_compression_tpu_torch INPUT -o CKPT_DIR --rank 100
    python -m rusty_compression_tpu_torch INPUT -o CKPT_DIR --tol 1e-8 \\
        --highacc --metrics metrics.jsonl
    torchrun --nproc-per-node 4 -m rusty_compression_tpu_torch INPUT \\
        -o CKPT_DIR --rank 100 --mesh

With ``--mesh`` the stream is sharded over a ``"blocks"`` mesh of every
process of the group (``parallel.make_mesh``): under ``torchrun`` one
process per card, without a launcher a group of one. Every rank reads the
inputs and, with ``--resume``, the manifest, so all agree on the pending
blocks; only rank 0 writes checkpoints and metrics and prints. The
arguments and the printed summary are the JAX package's, with ``--device``
(default ``cuda``). Not ported: its persistent compilation cache and its
``JAX_PLATFORMS`` handling (nothing is compiled here, and the device is an
argument).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def _load_blocks(path: str) -> list[np.ndarray]:
    """The block stream with bounded host memory: an ``.npy`` directory is
    opened as memory maps (nothing is read until the stream packs a block
    into its chunk); an ``.npz`` bundle is read eagerly. Submission order
    is the sorted name order."""
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
        if not files:
            raise SystemExit(f"no .npy blocks found in {path}")
        return [np.load(os.path.join(path, f), mmap_mode="r")
                for f in files]
    if path.endswith(".npz"):
        with np.load(path) as z:
            return [z[k] for k in sorted(z.files)]
    if path.endswith(".npy"):
        return [np.load(path, mmap_mode="r")]
    raise SystemExit(f"unsupported input {path!r} (.npy dir, .npz, or .npy)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="rusty_compression_tpu_torch",
        description="Compress a stream of dense operator blocks to "
                    "low-rank factors on the local accelerator.")
    ap.add_argument("input", help=".npy directory, .npz bundle, or one .npy")
    ap.add_argument("-o", "--output", required=True,
                    help="checkpoint directory (gets manifest.jsonl)")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--rank", type=int, help="fixed target rank")
    mode.add_argument("--tol", type=float,
                      help="adaptive relative tolerance (rank per block)")
    ap.add_argument("--method", default="rsvd",
                    choices=["rsvd", "nystrom", "column_id", "row_id",
                             "sketched_two_sided_id",
                             "two_sided_id"],
                    help="fixed-rank factorization (ignored with --tol)")
    ap.add_argument("--power-iters", type=int, default=1)
    ap.add_argument("--oversample", type=int, default=8)
    ap.add_argument("--sample-size", type=int, default=16,
                    help="adaptive probe block size (with --tol)")
    ap.add_argument("--highacc", action="store_true",
                    help="with --tol: route blocks through the f64 / c128 "
                         "pipeline (needed for tol <= ~1e-7, below the "
                         "f32 path's floor)")
    ap.add_argument("--round-rank", type=int, default=128,
                    help="per-round capture rank of the highacc pipeline")
    ap.add_argument("--mesh", action="store_true",
                    help="shard block batches over every process of the "
                         "group, one card each (start N processes with "
                         "torchrun --nproc-per-node N)")
    ap.add_argument("--bucket-floor", type=int, default=128)
    ap.add_argument("--chunk-bytes", type=int, default=1 << 30,
                    help="host-memory budget per packed input stack; each "
                         "bucket is executed in chunks under this bound "
                         "(<=0 disables chunking)")
    ap.add_argument("--window", type=int, default=2,
                    help="chunks kept in flight (pipeline depth)")
    ap.add_argument("--precision", default=None,
                    choices=["highest", "high", "default"],
                    help="f32 matmul precision (default: policy)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics", default=None,
                    help="append per-block JSONL metrics to this file")
    ap.add_argument("--resume", action="store_true",
                    help="skip blocks already present in the checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="torch device to compress on (default: cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.highacc and args.tol is None:
        raise SystemExit("--highacc requires --tol")

    import torch
    import torch.distributed as dist

    device = torch.device(args.device)
    made_group = args.mesh and not dist.is_initialized()
    try:
        mesh = None
        if args.mesh:
            from .parallel import initialize, make_mesh

            initialize(device_type=device.type)
            mesh = make_mesh(device_type=device.type)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return _run(args, device, mesh)
    finally:
        if made_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device, mesh) -> int:
    import torch
    import torch.distributed as dist

    if os.environ.get("RC_CHUNK_LOG"):
        import logging

        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        lg = logging.getLogger("rusty_compression_tpu_torch.scheduler")
        lg.addHandler(h)
        lg.setLevel(logging.INFO)

    from . import io as rcio
    from .parallel.scheduler import (compress_heterogeneous,
                                     compress_heterogeneous_refined)
    from .utils.precision import matmul_precision

    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    if mesh is not None:
        say(f"mesh: {dist.get_world_size()} ranks over 'blocks'")
    blocks = _load_blocks(args.input)
    n_total = len(blocks)
    indices = list(range(n_total))
    if args.resume:
        pending = rcio.pending_blocks(args.output, n_total)
        if mesh is not None:  # every rank has read the manifest
            dist.barrier()
        if not pending:
            say(f"all {n_total} blocks already done in {args.output}")
            return 0
        indices = pending
        blocks = [blocks[i] for i in indices]
        say(f"resuming: {len(indices)}/{n_total} blocks pending")

    # Incremental checkpoint: every block is saved as its chunk is
    # collected, so a crash loses at most the chunks in flight and
    # --resume re-submits only the missing blocks.
    state = {"append": args.resume and os.path.exists(
        os.path.join(args.output, "manifest.jsonl"))}

    def on_result(r):
        if not lead:
            return
        if indices != list(range(len(indices))):
            r = dataclasses.replace(r, index=indices[r.index])
        rcio.save_block_results(args.output, [r], append=state["append"])
        state["append"] = True

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.highacc:
        results = compress_heterogeneous_refined(
            blocks, generator, rel_tol=args.tol, round_rank=args.round_rank,
            bucket_floor=args.bucket_floor, chunk_bytes=args.chunk_bytes,
            window=args.window, on_result=on_result, mesh=mesh)
        return _finish(args, results, indices, lead)

    kwargs: dict = dict(bucket_floor=args.bucket_floor,
                        chunk_bytes=args.chunk_bytes, window=args.window,
                        mesh=mesh)
    if args.tol is not None:
        kwargs.update(rel_tol=args.tol, sample_size=args.sample_size)
    else:
        kwargs.update(rank=args.rank, method=args.method)
        if args.method == "rsvd":
            # the sampling knobs exist on the sketch-based pipelines only;
            # the ID methods go through the pivoted QR
            kwargs.update(power_iters=args.power_iters,
                          oversample=args.oversample)
        elif args.method == "nystrom":
            kwargs.update(oversample=args.oversample)
    with matmul_precision(args.precision):
        results = compress_heterogeneous(blocks, generator,
                                         on_result=on_result, **kwargs)
    return _finish(args, results, indices, lead)


def _finish(args, results, indices, lead: bool) -> int:
    from .utils.logging import MetricsLogger

    if not lead:  # rank 0 writes and prints for the group
        return 0

    # the original submission indices of a resumed sub-list (factors and
    # manifest rows were already written by on_result)
    if indices != list(range(len(indices))):
        results = [dataclasses.replace(r, index=indices[i])
                   for i, r in enumerate(results)]

    if args.metrics:
        with open(args.metrics, "a") as f:
            log = MetricsLogger(f)
            for r in results:
                log.write(r.record())

    errs = [r.rel_residual for r in results]
    ranks = [r.rank for r in results]
    failed = [r for r in results if not r.ok]
    print(f"compressed {len(results)} blocks -> {args.output}")
    print(f"ranks: min {min(ranks)} / max {max(ranks)}; "
          f"rel residual: max {max(errs):.3e}")
    if failed:
        # contained per-block failures: the stream completed, the failed
        # blocks are recorded in the manifest with `error`
        print(f"WARNING: {len(failed)} block(s) failed their gate "
              f"(first: block {failed[0].index}: {failed[0].error})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
