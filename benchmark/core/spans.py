"""The program's stage spans read against the device trace.

The port marks its stages with ``utils.profiling.span`` (``rc.capture``,
``rc.capture.round``, ``rc.range_finder``, ``rc.finish``,
``rc.host_svd``, ``rc.core_pivot``, ``rc.row_id``, ``rc.project_svd``):
host ops of ``torch.profiler`` on the clock of the runtime calls and the
device's operations, so ``Records.host_ops`` holds them beside the other
host ops (``program_spans`` picks them out).

A device operation belongs to the innermost span, on the thread whose
runtime call launched it, that was open when that call started (found
through ``Records.runtime`` by correlation id). A span's extent runs from
its host start to the later of its host end and the end of the last
operation launched inside it, at any depth: the card may still be working
on a stage after the host has left it. A name's time is the union of its
spans' extents: a span nested in one of the same name counts once, and two
sibling spans whose device work overlaps are not counted twice.

A window whose program has no such span (an older program) gives these
readers nothing to read: they return ``None``.
"""

from __future__ import annotations

#: the prefix of the program's span names
PREFIX = "rc."

#: the stage of work launched outside every ``rc.`` span, and of the idle
#: time after the window's last operation
OUTSIDE = "outside rc. spans"


def program_spans(rec) -> list:
    """(start, end, name, tid) of the program's spans among the host ops,
    by start."""
    return [op for op in rec.host_ops if op[2].startswith(PREFIX)]


def _threads(spans) -> dict:
    """Thread id -> indices of ``spans`` on it, outer before inner."""
    threads: dict = {}
    for i, (_, _, _, tid) in enumerate(spans):
        threads.setdefault(tid, []).append(i)
    for idx in threads.values():
        idx.sort(key=lambda i: (spans[i][0], -spans[i][1]))
    return threads


def parents(spans) -> list:
    """For each span, the index of the innermost span of its thread that
    contains it, or None."""
    out = [None] * len(spans)
    for idx in _threads(spans).values():
        stack: list = []
        for i in idx:
            start = spans[i][0]
            while stack and spans[stack[-1]][1] <= start:
                stack.pop()
            out[i] = stack[-1] if stack else None
            stack.append(i)
    return out


def owners(rec, spans) -> list:
    """For each op of ``rec.ops``, the index in ``spans`` of the innermost
    span open on the launching thread when the op's runtime call started,
    or None (launched outside every span, or no runtime call recorded)."""
    launches: dict = {}
    for j, op in enumerate(rec.ops):
        call = rec.runtime.get(op.correlation)
        if call is not None:
            launches.setdefault(call[3], []).append((call[1], j))
    out = [None] * len(rec.ops)
    threads = _threads(spans)
    for tid, calls in launches.items():
        idx, k, stack = threads.get(tid, []), 0, []
        for t, j in sorted(calls):
            while k < len(idx) and spans[idx[k]][0] <= t:
                start = spans[idx[k]][0]
                while stack and spans[stack[-1]][1] <= start:
                    stack.pop()
                stack.append(idx[k])
                k += 1
            while stack and spans[stack[-1]][1] < t:
                stack.pop()
            out[j] = stack[-1] if stack else None
    return out


def _union_ns(intervals) -> int:
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def _named(rec, spans, name: str) -> list:
    """Indices of the spans named ``name`` that start inside the window."""
    lo, hi = rec.window
    return [i for i, (start, _, n, _) in enumerate(spans)
            if n == name and lo <= start < hi]


def extents(rec, spans, name: str) -> list:
    """(start, end) of each span named ``name`` in the window: its host
    start to the later of its host end and the end of the last operation
    launched inside it. A span nested in one of the same name lies inside
    that one's extent, so a union counts it once."""
    picked = _named(rec, spans, name)
    if not picked:
        return []
    up = parents(spans)
    last: dict = {}
    for j, i in enumerate(owners(rec, spans)):
        end = rec.ops[j].end
        while i is not None and last.get(i, -1) < end:
            last[i] = end
            i = up[i]
    return [(spans[i][0], max(spans[i][1], last.get(i, 0))) for i in picked]


def extent_ms_per_call(rec, name: str) -> float | None:
    """The union of the extents of the spans named ``name`` over the
    window's calls, in ms; None without such a span."""
    if rec is None or not rec.calls:
        return None
    found = extents(rec, program_spans(rec), name)
    return _union_ns(found) / 1e6 / rec.calls if found else None


def host_ms_per_call(rec, name: str) -> float | None:
    """The union of the host intervals of the spans named ``name`` over the
    window's calls, in ms: the host's own time in the stage; None without
    such a span."""
    if rec is None or not rec.calls:
        return None
    spans = program_spans(rec)
    picked = _named(rec, spans, name)
    if not picked:
        return None
    return _union_ns(spans[i][:2] for i in picked) / 1e6 / rec.calls


def stages(rec) -> dict:
    """Per innermost span name, and ``OUTSIDE``, a call's ``device_ms``,
    ``idle_ms`` and ``launches`` in the window.

    Each operation (by start) is credited with the busy time it adds to the
    union of the device's intervals, so that the stages' device time sums
    to the window's busy time; each idle gap goes to the stage of the
    operation that ends it, and the gap after the last one to ``OUTSIDE``,
    so that device and idle time sum to the window. ``launches`` counts
    kernels, as ``launches_per_call`` does. The run's result line does not
    carry it (``cli.run`` writes ``trace.breakdown`` alone); a script that
    holds a traced window's records reads it here."""
    lo, hi = rec.window
    spans = program_spans(rec)
    owner = owners(rec, spans)
    sums: dict = {}

    def add(stage: str, device=0, idle=0, launch=0):
        entry = sums.setdefault(stage, [0, 0, 0])
        entry[0] += device
        entry[1] += idle
        entry[2] += launch

    reach = lo
    for op, i in zip(rec.ops, owner):
        stage = OUTSIDE if i is None else spans[i][2]
        start, end = max(op.start, lo), min(op.end, hi)
        add(stage, device=max(0, end - max(start, reach)),
            idle=max(0, start - reach), launch=op.kind == "kernel")
        reach = max(reach, end)
    if hi > reach:
        add(OUTSIDE, idle=hi - reach)
    calls = max(rec.calls, 1)
    ordered = sorted(sums.items(), key=lambda kv: -(kv[1][0] + kv[1][1]))
    return {stage: {"device_ms": d / 1e6 / calls, "idle_ms": g / 1e6 / calls,
                    "launches": n / calls}
            for stage, (d, g, n) in ordered}
