"""Checkpoints of factor containers (port of ``rusty_compression_tpu.io``).

The same ``.npz`` format, container tag and manifest as the JAX package,
so that a checkpoint written by either package loads in the other:

* ``save_factors`` / ``load_factors``: one container (or a batched one)
  to / from one ``.npz`` with a ``__container__`` tag naming its class;
* ``save_block_results`` / ``load_block_results``: a block stream's results
  to / from a directory, one ``block_<index>.npz`` per block and a
  ``manifest.jsonl`` of the per-block metrics records;
* ``pending_blocks``: the blocks a resumed run still has to compress.

The loaders return the port's containers of tensors on ``device`` (the
card unless the caller names another). ``load_block_results`` keeps the
last manifest row of each block, the row that ``pending_blocks`` and a
``--resume`` run rely on; the JAX package's loader returns every row, so a
resumed checkpoint there lists a re-run block twice.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch

from .models.interp_decomp import ColumnID, RowID, TwoSidedID
from .models.qr import LQ, QR
from .models.svd import SVD

__all__ = [
    "save_factors",
    "load_factors",
    "save_block_results",
    "load_block_results",
    "pending_blocks",
]

_REGISTRY = {c.__name__: c for c in (QR, LQ, SVD, ColumnID, RowID,
                                     TwoSidedID)}


def _leaf_names(cls) -> list[str]:
    return [f.name for f in dataclasses.fields(cls)]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def save_factors(path: str, factors) -> None:
    """Save a factor container (one or batched; tensors or numpy leaves)
    to ``.npz``."""
    name = type(factors).__name__
    if name not in _REGISTRY:
        raise TypeError(f"not a factorization container: {type(factors)!r}")
    arrays = {leaf: _host(getattr(factors, leaf))
              for leaf in _leaf_names(_REGISTRY[name])}
    np.savez(path, __container__=np.str_(name), **arrays)


def load_factors(path: str, device="cuda"):
    """Load a container saved by either package's ``save_factors`` as the
    port's container on ``device`` (index vectors as int64)."""
    with np.load(path, allow_pickle=False) as data:
        if "__container__" not in data:
            raise ValueError(
                f"{path} is not a factor checkpoint (no container tag)")
        name = str(data["__container__"])
        cls = _REGISTRY.get(name)
        if cls is None:
            raise ValueError(f"unknown container type {name!r} in {path}")
        leaves = {}
        for leaf in _leaf_names(cls):
            arr = data[leaf]
            if np.issubdtype(arr.dtype, np.integer):
                arr = arr.astype(np.int64)
            leaves[leaf] = torch.from_numpy(arr).to(device)
        return cls(**leaves)


def save_block_results(directory: str, results: Sequence,
                       append: bool = False) -> None:
    """Persist ``parallel.scheduler.BlockResult``s: one factor ``.npz`` per
    block and ``manifest.jsonl``. Rows are in write order (submission order
    for a fresh run, completion order when appending re-run blocks:
    readers key on the ``block`` field)."""
    os.makedirs(directory, exist_ok=True)
    manifest_path = os.path.join(directory, "manifest.jsonl")
    with open(manifest_path, "a" if append else "w") as mf:
        for r in results:
            fname = f"block_{r.index:08d}.npz"
            save_factors(os.path.join(directory, fname), r.factors)
            rec = dict(r.record(), file=fname,
                       container=type(r.factors).__name__)
            mf.write(json.dumps(rec) + "\n")


def _manifest_rows(directory: str) -> list[dict]:
    manifest = os.path.join(directory, "manifest.jsonl")
    if not os.path.exists(manifest):
        return []
    with open(manifest) as mf:
        return [json.loads(line) for line in mf if line.strip()]


def load_block_results(directory: str, device="cuda") -> list[dict]:
    """Load a block-stream checkpoint: the manifest records in submission
    order, one per block (the last row written for it), with its factors
    attached under ``"factors"`` as a port container on ``device``."""
    last: dict[int, dict] = {}
    for row in _manifest_rows(directory):
        last[row["block"]] = row
    out = []
    for block in sorted(last):
        rec = dict(last[block])
        rec["factors"] = load_factors(os.path.join(directory, rec["file"]),
                                      device=device)
        out.append(rec)
    return out


def pending_blocks(directory: str, n_blocks: int) -> list[int]:
    """Submission indices not yet in a checkpoint directory: the blocks a
    resumed run re-submits.

    A block whose row records an ``environment:`` error (a transient
    failure that the JAX package's stream contained) counts as pending, so
    that this reads the JAX package's checkpoints too; a genuine per-block
    failure (an unreachable tolerance) stays recorded."""
    done = set()
    for row in _manifest_rows(directory):
        err = row.get("error")
        if err and str(err).startswith("environment:"):
            continue
        done.add(row["block"])
    return [i for i in range(n_blocks) if i not in done]
