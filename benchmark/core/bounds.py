"""The least time the card could take for a pivoted-QR panel call of the
port's kernels K1-K4: a frozen copy of ``chip_smoke.py::panel_bound``'s
arithmetic (``benchmark/tests/test_bench_bounds.py`` holds the two equal
on the benchmark's shapes).

Bytes: the panel (and the ``used`` mask) read once, q, r and piv written
once, over the memory rate. Operations: the R row and the rank-1 downdate
over the panel (4 m n a step) and the reorthogonalization of step i
against Q (4 m i, 2 m k^2 in all), four times as many in a complex type,
over the card's peak for the type (f32 outside the tensor cores for K1 and
K2; f64 on the tensor cores for K3 and K4). Every one of the k steps runs
whatever the data. The larger of the two is the bound.
"""

from __future__ import annotations

import math

import torch

from . import peaks

#: The types of K3 and K4.
WIDE_DTYPES = (torch.float64, torch.complex128)


def panel_bound(shape, k: int, dtype: torch.dtype, masked: bool) -> dict:
    """``{"bound_ms", "bound_by"}`` of one wrapper call over ``shape``
    ``(m, n)`` or ``(panels, m, n)`` at ``k`` steps."""
    *batch, m, n = shape
    count = math.prod(batch)
    itemsize = dtype.itemsize
    nbytes = count * (itemsize * (m * n + m * k + k * n) + 4 * k
                      + (4 * n if masked else 0))
    ops = count * (4 if dtype.is_complex else 1) * (
        4 * m * n * k + 2 * m * k * k)
    by_bytes = nbytes / peaks.HBM_BYTES_PER_S * 1e3
    by_ops = ops / (peaks.F64_FLOP_PER_S if dtype in WIDE_DTYPES
                    else peaks.F32_FLOP_PER_S) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def roofline_share(rec, shapes: str, launches: str, kernel,
                   dtype) -> float | None:
    """A kernel's share of its roofline over a traced window, in percent:
    the sum of ``panel_bound`` over the wrapper calls that the probe
    ``shapes`` recorded in each call (the wrapper's ``launched_shapes``,
    emptied before each call), over the summed device time of the kernels
    whose name ``kernel`` matches. None where nothing was launched, or where
    a call recorded more shapes than the probe ``launches`` counted
    launches. Two calls of one wrapper at one shape within a call leave one
    shape, so the share can only read low, never high."""
    if rec is None:
        return None
    bound_ms = 0.0
    for counts in rec.counters:
        keys = counts[shapes]
        if len(keys) > counts[launches]:
            return None
        for key in keys:
            shape, k, masked = key[0], key[1], key[2]
            bound_ms += panel_bound(shape, k, dtype, masked)["bound_ms"]
    seconds = rec.device_seconds(kernel)
    if not bound_ms or not seconds:
        return None
    return 100.0 * bound_ms / 1e3 / seconds
