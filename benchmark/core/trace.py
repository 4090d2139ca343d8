"""The traced run: ``torch.profiler`` over the window, and the reduction of
its raw events to the records that the per-layer metrics read.

The window is the benchmark's own span ``bench_window`` (and each call
``bench_call``). Device time is the union of the intervals of the device's
kernels, copies and sets inside the window, so that overlapping operations
are counted once; the idle share is 1 - busy / window. The raw events are
read straight from the profiler's results (no event tree is built).
"""

from __future__ import annotations

import bisect
import dataclasses

WINDOW_SPAN = "bench_window"
CALL_SPAN = "bench_call"
WARM_SPAN = "bench_warm"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def start():
    """A running profiler of the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def span(name: str):
    from torch.profiler import record_function

    return record_function(name)


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str          # "kernel", "gpu_memcpy" or "gpu_memset"
    start: int         # ns
    end: int           # ns
    correlation: int


@dataclasses.dataclass
class Records:
    """What a traced window recorded; every time in ns on the trace's
    clock unless named otherwise."""

    window: tuple              # (start, end) of the bench_window span
    ops: list                  # DeviceOp inside the window, by start
    runtime: dict              # correlation id -> (name, start, end, tid)
    host_ops: list             # (start, end, name, tid) of host ops
    calls: int
    counters: list             # per call: probe name -> delta or shapes

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self) -> list:
        return [op for op in self.ops if op.kind == "kernel"]

    def device_seconds(self, match) -> float:
        """Summed device time of the kernels whose name ``match``es."""
        return sum(op.end - op.start for op in self.kernels()
                   if match(op.name)) / 1e9


SPANS = (WINDOW_SPAN, CALL_SPAN, WARM_SPAN)


def _activity(event) -> str:
    """The event's kind: ``kernel``, ``gpu_memcpy``, ``gpu_memset``,
    ``cuda_runtime``, ``user_annotation``, ``cpu_op`` or another the
    profiler names. Where the profiler's events do not carry it, it is
    told from the device and the name."""
    try:
        return event.activity_type()
    except AttributeError:
        pass
    from torch.autograd import DeviceType

    name = event.name()
    if event.device_type() == DeviceType.CUDA:
        if name in SPANS:
            return "gpu_user_annotation"
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    if name in SPANS:
        return "user_annotation"
    if name.startswith("cuda") and event.correlation_id():
        return "cuda_runtime"
    return "cpu_op"


def reduce(prof, calls: int, counters: list) -> Records:
    """Records of the stopped profiler ``prof``."""
    from torch.autograd import DeviceType

    window = None
    ops, runtime, host_ops, kinds = [], {}, [], set()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        kind = _activity(e)
        kinds.add(kind)
        start = e.start_ns()
        end = start + e.duration_ns()
        if kind in DEVICE_KINDS:
            ops.append(DeviceOp(name, kind, start, end, e.correlation_id()))
        elif name == WINDOW_SPAN and e.device_type() == DeviceType.CPU:
            window = (start, end)
        elif kind in ("cuda_runtime", "cuda_driver"):
            runtime[e.correlation_id()] = (name, start, end,
                                           e.start_thread_id())
        elif kind == "cpu_op":
            host_ops.append((start, end, name, e.start_thread_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span on the "
                           f"host (kinds seen: {sorted(kinds)})")
    w0, w1 = window
    ops = sorted((op for op in ops if op.end > w0 and op.start < w1),
                 key=lambda op: op.start)
    host_ops.sort()
    return Records(window, ops, runtime, host_ops, calls, counters)


def busy_intervals(ops, lo: int, hi: int) -> list:
    """The union of the ops' intervals clipped to [lo, hi], as sorted
    disjoint (start, end) pairs."""
    merged = []
    for s, e in sorted((max(op.start, lo), min(op.end, hi)) for op in ops):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(x) for x in merged]


def busy_seconds(rec: Records) -> float:
    lo, hi = rec.window
    return sum(e - s for s, e in busy_intervals(rec.ops, lo, hi)) / 1e9


def _host_op_at(rec: Records, t: int, tid) -> str | None:
    """The innermost host op of thread ``tid`` running at ``t``."""
    i = bisect.bisect_right(rec.host_ops, (t, float("inf")))
    for start, end, name, thread in reversed(rec.host_ops[max(0, i - 256):i]):
        if thread == tid and start <= t <= end:
            return name
    return None


def _gap_label(rec: Records, op) -> str:
    """What the host was doing in the idle gap that ends where ``op``
    starts: the host op and the runtime call that issued ``op``."""
    call = rec.runtime.get(op.correlation)
    if call is None:
        return f"? -> {op.name}"[:120]
    host = _host_op_at(rec, call[1], call[3]) or "host code"
    return f"{host} / {call[0]} -> {op.name}"[:120]


def breakdown(rec: Records, top: int = 10, labelled: int = 5000) -> dict:
    """The device operations that took the most time, and the idle gaps
    summed by what the host was doing, each in seconds: the ``labelled``
    longest gaps are told apart, the rest summed as one entry."""
    by_name: dict = {}
    for op in rec.ops:
        by_name[op.name] = by_name.get(op.name, 0) + (op.end - op.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = rec.window
    edges = [(lo, lo)] + busy_intervals(rec.ops, lo, hi) + [(hi, hi)]
    gaps = sorted(((g1 - g0, g1) for (_, g0), (g1, _) in zip(edges, edges[1:])
                   if g1 > g0), reverse=True)
    starts = [op.start for op in rec.ops]
    sums: dict = {}
    for length, g1 in gaps[:labelled]:
        i = bisect.bisect_left(starts, g1)
        label = (_gap_label(rec, rec.ops[i]) if i < len(rec.ops)
                 and rec.ops[i].start == g1 else "end of the window")
        sums[label] = sums.get(label, 0) + length
    rest = sum(length for length, _ in gaps[labelled:])
    if rest:
        sums[f"the {len(gaps) - labelled} shortest gaps"] = rest
    idle = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:120], ns / 1e9] for name, ns in device_ops],
            "idle_gaps": [[label, ns / 1e9] for label, ns in idle]}
