"""One run of one cell: set-up, the window, the check, the result line.

Set-up makes the data on the card from ``--seed``, builds the call and
warms up the cell's own shapes (the first run in a checkout also builds
the port's kernels into ``rusty_compression_tpu_torch/_build/``). The
window runs ``--seconds``. Once it has closed and the peak memory has been
read, the check judges a sample of the window's outputs (drawn from the
seed) against the block itself, with the plain references of
``benchmark/reference``; the numbers it compares are printed beside their
limits as the last lines of standard error and under ``checks``, the last
key of the result line.

A run with no card, or with fewer cards than the cell asks for, fails and
prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time

from . import data as data_mod
from . import entry, guard, registry, trace
from .window import Probe, Reservoir, run_window

EXIT_NO_CARD, EXIT_JAX, EXIT_NAME = 3, 4, 2
#: calls made before the window, in set-up: the first builds and tunes
#: what the cell's shapes need, the second finds it all built
WARMUP_CALLS = 2


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


@dataclasses.dataclass
class Context:
    """What a metric's ``read`` gets."""

    window: object
    setup_s: float
    peak_bytes: int
    block_bytes: int
    records: object = None


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def judge(check, data, samples, params, limits: dict, gen) -> tuple:
    """``(ok, compared)``: each number that ``limits`` names, the worst
    over the sampled outputs; ok when every one is within its limit."""
    numbers: dict = {}
    for out in samples:
        for name, value in check.measure(data, out, params, gen).items():
            numbers[name] = max(numbers.get(name, -math.inf), value)
    compared = {name: numbers.get(name, math.inf) for name in limits}
    ok = bool(samples) and all(
        math.isfinite(v) and v <= limits[name] for name, v in compared.items())
    return ok, compared


def _card(torch, chips: int):
    if not torch.cuda.is_available():
        raise SystemExit((EXIT_NO_CARD, "no CUDA device "
                          "(torch.cuda.is_available() is false)"))
    if torch.cuda.device_count() < chips:
        raise SystemExit((EXIT_NO_CARD, f"the cell asks for {chips} cards, "
                          f"the machine has {torch.cuda.device_count()}"))
    return torch.device("cuda", 0)


def run(argv, t0: float, device=None, scale: dict | None = None) -> dict:
    """One run; returns the result line's object. ``device`` and ``scale``
    (keys of the configuration replaced) are for the CPU tests, which skip
    the look for a card; a run from the command line always looks."""
    args = parse(argv)
    bench = registry.load_benchmark()
    cell = registry.find_cell(bench, args.workload)
    config = {**registry.load_config(bench, cell["config"]), **(scale or {})}
    traffic = registry.load_traffic(cell["traffic"])
    cell_file = registry.load_cell(args.workload)
    names = registry.metric_names(bench, args.workload, bool(args.trace))
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {name: registry.load_metric(name) for name in names}
    check = registry.load_check(traffic["output"])

    import torch

    torch.set_num_threads(1)
    if device is None:
        device = _card(torch, int(cell["chips"]))
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    data = data_mod.make_data(config, args.seed, device)
    call = entry.make_call(traffic, data, args.seed)
    for _ in range(WARMUP_CALLS):
        call()
        sync()
    guard.require_no_jax("after set-up")
    probes, prof, span = {}, None, None
    if args.trace:
        for module in metrics.values():
            for name, path in getattr(module, "PROBES", {}).items():
                probes[name] = Probe(path)
        prof = trace.start()
        span = trace.span
        with span(trace.WARM_SPAN):  # the tracer's first call, outside
            call()
            sync()
    setup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    sample = Reservoir(int(traffic.get("checked_calls", 1)), args.seed)
    with (span(trace.WINDOW_SPAN) if span else contextlib.nullcontext()):
        window = run_window(call, args.seconds, sync, sample, probes, span)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    records = None
    if prof is not None:
        t = time.perf_counter()
        prof.stop()
        stopped = time.perf_counter()
        records = trace.reduce(prof, window.calls, window.counters)
        del prof
        say(f"trace: stopping {stopped - t:.1f} s, reading "
            f"{time.perf_counter() - stopped:.1f} s, {len(records.ops)} "
            f"device operations")
    guard.require_no_jax("after the window")
    del call

    ctx = Context(window, setup_s, peak, data_mod.block_bytes(config),
                  records)
    values = {}
    for name, module in metrics.items():
        value = module.read(ctx)
        if value is not None:
            values[name] = {"value": value, "unit": units[name]}
    say(f"calls in the window: {window.calls} ({window.failed} failed) "
        f"over {window.seconds:.6f} s")

    gen = torch.Generator(device=device).manual_seed(
        entry.program_seed(args.seed) + 1)
    ok, compared = judge(check, data, window.samples,
                         traffic.get("check_params", {}),
                         cell_file["limits"], gen)
    correct = ok and window.failed == 0
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    result = {
        "correct": correct, "attempted": window.calls,
        "failed": window.failed, "metrics": values,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": name,
                   "count": int(cell["chips"]) if on_card else 1,
                   "memory_peak_bytes": int(peak)},
    }
    if records is not None:
        t = time.perf_counter()
        result["device"].update(busy_s=trace.busy_seconds(records),
                                window_s=records.window_s)
        result["breakdown"] = trace.breakdown(records)
        say(f"trace: breakdown {time.perf_counter() - t:.1f} s")
    checks = {name: {"value": v, "limit": cell_file["limits"][name]}
              for name, v in compared.items()}
    result["checks"] = checks
    say(f"outputs checked: {len(window.samples)} of {window.calls} calls")
    for name, c in checks.items():
        say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    guard.require_no_jax("at exit")
    return result


def main(argv, t0: float) -> int:
    try:
        result = run(argv, t0)
    except SystemExit as e:
        if isinstance(e.code, tuple):
            say(f"benchmark: {e.code[1]}")
            return e.code[0]
        raise
    except registry.UnknownName as e:
        say(f"benchmark: {e}")
        return EXIT_NAME
    except guard.JaxLoaded as e:
        say(f"benchmark: {e}")
        return EXIT_JAX
    print(json.dumps(result), flush=True)
    return 0
