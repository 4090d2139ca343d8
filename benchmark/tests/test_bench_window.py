"""The window's arithmetic on hand-made records: the rate over all the work
and all the time, the tail of all calls, the idle share as a union of
intervals, and the breakdown."""

import statistics

import pytest

from benchmark.core import trace
from benchmark.core.cli import Context
from benchmark.core.registry import load_metric
from benchmark.core.window import Reservoir, Window, p95, rate, run_window


def test_p95_is_over_all_calls():
    calls = [10.0] * 95 + [100.0] * 5
    assert p95(calls) == pytest.approx(
        statistics.quantiles(calls, n=20, method="inclusive")[18])
    assert p95(calls) > 10.0         # a chunked median would miss the tail
    assert p95([3.0]) == 3.0
    assert p95(list(range(1, 101))) == pytest.approx(95.05)


def test_rate_is_all_work_over_all_time():
    w = Window(start=0.0, end=2.0, call_ms=[500.0, 1000.0, 500.0],
               failed=1, samples=[])
    ctx = Context(w, 1.0, 0, 10 ** 9)
    # two completed calls of 1 GB over the window's 2 s
    assert load_metric("GB_per_s").read(ctx) == pytest.approx(1.0)
    assert rate(6.0, 3.0) == 2.0
    with pytest.raises(ValueError):
        rate(1.0, 0.0)


def test_reservoir_is_uniform_and_seeded():
    picks = []
    for seed in range(2000):
        r = Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        picks += r.items
        assert len(set(r.items)) == 2
    counts = [picks.count(i) for i in range(10)]
    assert min(counts) > 300 and max(counts) < 500   # 400 expected each
    a, b = Reservoir(1, 7), Reservoir(1, 7)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


def test_run_window_times_every_call_and_counts_failures():
    n = {"calls": 0}

    def call():
        n["calls"] += 1
        if n["calls"] == 2:
            raise RuntimeError("planted")
        return n["calls"]

    w = run_window(call, 0.05, lambda: None, Reservoir(1, 0))
    assert w.calls == n["calls"] >= 2 and w.failed == 1
    assert len(w.call_ms) == w.calls and w.seconds >= 0.05
    assert w.samples and w.samples[0] != 2


def _op(name, start, end, kind="kernel", corr=0):
    return trace.DeviceOp(name, kind, start, end, corr)


def _records(ops, window=(0, 100), calls=2, counters=None):
    return trace.Records(window, sorted(ops, key=lambda o: o.start), {
        1: ("cudaLaunchKernel", 30, 31, 9), 2: ("cudaMemcpyAsync", 5, 6, 9)},
        [(29, 40, "aten::mm", 9)], calls, counters or [{}] * calls)


def test_idle_share_is_a_union_of_intervals():
    # two kernels overlapping a copy: busy is [10, 40] and [60, 70], not
    # the 60 ns that the durations sum to
    ops = [_op("k1", 10, 30), _op("copy", 20, 40, "gpu_memcpy"),
           _op("k2", 25, 35), _op("k3", 60, 70, corr=1),
           _op("late", 95, 130)]
    rec = _records(ops)
    assert trace.busy_intervals(rec.ops, 0, 100) == [(10, 40), (60, 70),
                                                     (95, 100)]
    assert trace.busy_seconds(rec) == pytest.approx(45e-9)
    ctx = Context(None, 0.0, 0, 0, rec)
    assert load_metric("device_idle_share").read(ctx) == pytest.approx(
        1 - 45 / 100)
    assert load_metric("launches_per_call").read(ctx) == 2.0  # 4 kernels


def test_breakdown_names_ops_and_the_hosts_gaps():
    ops = [_op("k1", 10, 30), _op("k3", 60, 70, corr=1)]
    b = trace.breakdown(_records(ops))
    assert b["device_ops"] == [["k1", 20e-9], ["k3", 10e-9]]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::mm / cudaLaunchKernel -> k3"] == pytest.approx(30e-9)
    assert gaps["end of the window"] == pytest.approx(30e-9)
    assert sum(gaps.values()) == pytest.approx(70e-9)


def test_readers_find_nothing_to_read_and_say_so():
    rec = _records([], calls=2, counters=[{"host_reads": 0}] * 2)
    ctx = Context(None, 0.0, 0, 0, rec)
    for name in ("launches_per_call", "host_reads_per_call",
                 "gemm_ms_per_call", "householder_qr_ms_per_call"):
        assert load_metric(name).read(ctx) is None, name
    assert load_metric("device_idle_share").read(
        Context(None, 0.0, 0, 0, None)) is None


def test_roofline_share_from_shapes_and_kernel_time():
    shape = ((1, 256, 8192), 256, False, "recompute")
    counters = [{"k3_shapes": [shape], "k3_launches": 1}] * 2
    ops = [_op("void rc_qrcp::qrcp_panel_kernel<double, 1, 1>(double)",
               0, 4_000_000),
           _op("void rc_qrcp::qrcp_panel_kernel<double2, 1, 1>(x)",
               0, 9_000_000)]
    rec = _records(ops, window=(0, 10 ** 7), counters=counters)
    from benchmark.core.bounds import panel_bound
    import torch

    bound = panel_bound((1, 256, 8192), 256, torch.float64, False)
    share = load_metric("K3_roofline").read(Context(None, 0, 0, 0, rec))
    assert share == pytest.approx(100 * 2 * bound["bound_ms"] / 4.0)
    assert 0 < share < 100
    rec.counters = [{"k3_shapes": [], "k3_launches": 0}] * 2
    assert load_metric("K3_roofline").read(Context(None, 0, 0, 0, rec)) is None


def test_a_probe_reads_the_ports_counters():
    from rusty_compression_tpu_torch import highacc
    from rusty_compression_tpu_torch.ops.kernels import qrcp
    from benchmark.core.window import Probe

    reads = Probe("rusty_compression_tpu_torch.highacc._read.count")
    start = reads.before()
    highacc._read.count += 3
    assert reads.after(start) == 3
    shapes = Probe("rusty_compression_tpu_torch.ops.kernels.qrcp"
                   ".qrcp_panel_f64.launched_shapes")
    qrcp.qrcp_panel_f64.launched_shapes.add(("old",))
    shapes.before()
    qrcp.qrcp_panel_f64.launched_shapes.add(("new",))
    assert shapes.after(None) == [("new",)]
    with pytest.raises(ValueError):
        Probe("jax.numpy.zeros")
