"""ctypes bridge to the C++ host planner ``native/rc_native.cpp`` (port of
``rusty_compression_tpu.native``).

The block stream's host bookkeeping (shape buckets, chunk batches, the
submission-order gather) has a C++ twin of the Python planner in
``parallel.scheduler``; both give the same plans. This module compiles the
repository's ``native/rc_native.cpp`` as it is, with the flags of
``native/Makefile`` (``g++ -O3 -std=c++17 -fPIC -shared``), into this
package's ``_build/`` (``ops.kernels.library.compile_sources``), and loads
it. It never writes into ``native/``: that directory holds the JAX
package's own build. Without a compiler or without the source (an
installed package) ``available()`` is False, ``plan`` and ``chunk_batch``
return None, and the caller takes the Python planner.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from .ops.kernels import library

__all__ = ["available", "plan", "chunk_batch", "NativePlan"]

_SOURCE = Path(__file__).resolve().parents[1] / "native" / "rc_native.cpp"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib = None
_load_failed = False
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source lives (built or not)."""
    return library.library_path(_SOURCE, _FLAGS)


def _load():
    """The loaded library (built if needed), or None if it cannot be had."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
        try:
            built = library.compile_sources([_SOURCE], cxx, _FLAGS)
            lib = ctypes.CDLL(str(built[_SOURCE][0]))
            i64 = ctypes.c_int64
            p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.rc_bucket_dim.restype = i64
            lib.rc_bucket_dim.argtypes = [i64, i64]
            lib.rc_plan.restype = i64
            lib.rc_plan.argtypes = [i64, p64, p64, i64, i64, p64, p64, p64,
                                    p64, p64]
            lib.rc_gather_plan.restype = None
            lib.rc_gather_plan.argtypes = [i64, p64, p64, i64, i64, p64]
            lib.rc_plan_bytes.restype = i64
            lib.rc_plan_bytes.argtypes = [i64, p64, p64, p64, p64, p64, i64]
            lib.rc_chunk_batch.restype = i64
            lib.rc_chunk_batch.argtypes = [i64] * 6
            _lib = lib
        except (OSError, library.BuildError):
            _load_failed = True
        return _lib


def available() -> bool:
    """True if the C++ planner is loadable (building it if needed)."""
    return _load() is not None


class NativePlan:
    """A planned heterogeneous block stream (see ``rc_plan``)."""

    def __init__(self, shapes: Sequence[tuple[int, int]], bucket_m, bucket_n,
                 order, group_off, group_batch, n_groups: int):
        self.shapes = list(shapes)
        self.bucket_m = bucket_m
        self.bucket_n = bucket_n
        self.order = order
        self.group_off = group_off[:n_groups + 1]
        self.group_batch = group_batch[:n_groups]
        self.n_groups = n_groups

    def groups(self) -> dict[tuple[int, int], list[int]]:
        """The plan as ``{(bucket_m, bucket_n): [submission indices]}``,
        the structure of ``parallel.scheduler.plan_buckets``."""
        out: dict[tuple[int, int], list[int]] = {}
        for gi in range(self.n_groups):
            lo, hi = self.group_off[gi], self.group_off[gi + 1]
            rep = int(self.order[lo])
            key = (int(self.bucket_m[rep]), int(self.bucket_n[rep]))
            out[key] = [int(i) for i in self.order[lo:hi]]
        return out

    def padded_bytes(self, elem_size: int = 4) -> int:
        """Total bytes of the padded stacks this plan materializes."""
        return int(_load().rc_plan_bytes(
            self.n_groups, self.group_off, self.order, self.bucket_m,
            self.bucket_n, self.group_batch, elem_size))

    def gather_slots(self) -> np.ndarray:
        """``slots[i] = group * max_batch + slot`` for the submission-order
        scatter of per-group factor stacks."""
        n = len(self.shapes)
        max_batch = int(self.group_batch.max()) if self.n_groups else 0
        slots = np.zeros(n, dtype=np.int64)
        _load().rc_gather_plan(n, self.order, self.group_off, self.n_groups,
                               max_batch, slots)
        return slots


def chunk_batch(count: int, granule: int, bm: int, bn: int,
                elem_size: int, budget_bytes: int) -> int | None:
    """Fixed per-bucket chunk batch under a byte budget (``rc_chunk_batch``);
    None if the C++ planner is unavailable (the caller takes the Python
    mirror, ``parallel.scheduler._chunk_batch``)."""
    lib = _load()
    if lib is None:
        return None
    out = int(lib.rc_chunk_batch(count, granule, bm, bn, elem_size,
                                 budget_bytes))
    if out < 0:
        raise ValueError("invalid chunk_batch inputs")
    return out


def plan(shapes: Sequence[tuple[int, int]], floor: int = 128,
         granule: int = 1) -> NativePlan | None:
    """Plan a block stream with the C++ planner; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(shapes)
    ms = np.ascontiguousarray([s[0] for s in shapes], dtype=np.int64)
    ns = np.ascontiguousarray([s[1] for s in shapes], dtype=np.int64)
    bucket_m = np.zeros(n, dtype=np.int64)
    bucket_n = np.zeros(n, dtype=np.int64)
    order = np.zeros(n, dtype=np.int64)
    group_off = np.zeros(n + 1, dtype=np.int64)
    group_batch = np.zeros(max(n, 1), dtype=np.int64)
    n_groups = int(lib.rc_plan(n, ms, ns, floor, granule, bucket_m,
                               bucket_n, order, group_off, group_batch))
    if n_groups < 0:
        raise ValueError(f"invalid plan inputs (shapes={list(shapes)[:3]}..., "
                         f"floor={floor}, granule={granule})")
    return NativePlan(shapes, bucket_m, bucket_n, order, group_off,
                      group_batch, n_groups)
