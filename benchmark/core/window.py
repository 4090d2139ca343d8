"""The measured window: a closed loop with one caller.

The caller issues a call, waits for ``torch.cuda.synchronize()``, and
issues the next, for ``--seconds`` seconds: a caller that needs each
block's factors before it moves on. Each call is timed on the host clock
from its start to the end of its synchronize. The window's time runs from
the start of its first call to the end of its last, and every rate is
taken over all the calls and all of that time; the tail is taken over all
the calls.

Outputs to check are drawn from ``--seed`` by reservoir sampling, so that
every call of the window is as likely to be checked and only the sampled
outputs are held.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import random
import statistics
import sys
import time
import traceback

from .trace import CALL_SPAN

PORT = "rusty_compression_tpu_torch"


def p95(values: list[float]) -> float:
    """The 95th percentile of all ``values`` (linear interpolation between
    order statistics, ``statistics.quantiles`` with the inclusive
    method)."""
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def rate(units: float, seconds: float) -> float:
    """``units`` per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return units / seconds


class Reservoir:
    """Keeps ``size`` items drawn uniformly from a stream (algorithm R),
    the draws from a ``random.Random`` seeded with ``seed``."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.seen = int(size), random.Random(seed), 0
        self.items: list = []

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


class Probe:
    """A counter of the program, by its dotted path inside the port: an
    int (read before and after each call: the call's delta) or a set
    (emptied before each call and copied after: what the call added)."""

    def __init__(self, path: str):
        if path.split(".")[0] != PORT:
            raise ValueError(f"probe {path!r} is not in {PORT}")
        parts = path.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            try:
                owner = importlib.import_module(".".join(parts[:cut]))
            except ImportError:
                continue
            for attr in parts[cut:-1]:
                owner = getattr(owner, attr)
            self.owner, self.attr = owner, parts[-1]
            break
        else:
            raise ValueError(f"probe {path!r}: no such module")
        self.is_set = isinstance(self.value(), set)

    def value(self):
        return getattr(self.owner, self.attr)

    def before(self):
        if self.is_set:
            self.value().clear()
            return None
        return self.value()

    def after(self, start):
        if self.is_set:
            return sorted(self.value(), key=repr)
        return self.value() - start


@dataclasses.dataclass
class Window:
    """What a window recorded."""

    start: float
    end: float
    call_ms: list
    failed: int
    samples: list
    counters: list = dataclasses.field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def calls(self) -> int:
        return len(self.call_ms)


def run_window(call, seconds: float, sync, sample: Reservoir,
               probes: dict | None = None, span=None) -> Window:
    """Runs ``call`` in a closed loop for ``seconds``. ``sync`` waits for
    the device; ``sample`` takes the outputs; ``probes`` (name -> Probe)
    are read around each call; ``span(name)`` (a context manager, the
    profiler's ``record_function`` in a traced run) wraps each call."""
    span = span or (lambda name: contextlib.nullcontext())
    probes = probes or {}
    call_ms, counters, failed = [], [], 0
    start = time.perf_counter()
    end = start
    while end - start < seconds:
        marks = {name: p.before() for name, p in probes.items()}
        t0 = time.perf_counter()
        out = None
        try:
            with span(CALL_SPAN):
                out = call()
                sync()
        except Exception:  # a failed call counts; the window goes on
            if not failed:
                traceback.print_exc(file=sys.stderr)
            failed += 1
        end = time.perf_counter()
        call_ms.append((end - t0) * 1e3)
        if probes:
            counters.append({name: p.after(marks[name])
                             for name, p in probes.items()})
        if out is not None:
            sample.offer(out)
        del out
    return Window(start, end, call_ms, failed, sample.items, counters)
