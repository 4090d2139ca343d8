"""Structured metrics logging (port of ``rusty_compression_tpu.utils.logging``).

Per-block records (block id, dims, achieved rank, relative residual, wall
time, process and device identity) as JSON lines: greppable, streamable and
mergeable across processes (each process logs its own shard; the records
carry ``process`` for the merge).
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO

import torch

__all__ = ["MetricsLogger"]


def _process_index() -> int:
    """This process's rank in the initialised process group, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


class MetricsLogger:
    """Append-only JSONL metrics writer.

    >>> log = MetricsLogger(open("metrics.jsonl", "a"))
    >>> for r in results:                      # BlockResults
    ...     log.write(r.record())
    """

    def __init__(self, stream: IO[str] | None = None):
        self.stream = stream if stream is not None else sys.stderr
        self._base = {
            "process": _process_index(),
            "n_devices": torch.cuda.device_count(),
        }

    def write(self, record: dict) -> None:
        rec = {"ts": time.time(), **self._base, **record}
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()
