"""The program's stage spans (``core/spans.py``) on hand-made records: the
innermost span of the launching thread, the extent to the last launched
operation, nested and sibling spans, the stages' sums, the readers without
their spans, the spans through ``trace.reduce``'s fallback typing, and a
traced CPU run of the ID cell."""

import pytest

from benchmark.core import spans, trace
from benchmark.core.cli import Context
from benchmark.core.registry import load_metric


def _op(name, start, end, kind="kernel", corr=0):
    return trace.DeviceOp(name, kind, start, end, corr)


# A capture of two rounds (the first with a range finder, which holds one of
# the same name), a finish with the host SVD, and a span of another thread
# open over the finish's launches.
SPANS = [(10, 100, "rc.capture", 9), (12, 50, "rc.capture.round", 9),
         (14, 40, "rc.range_finder", 9), (16, 30, "rc.range_finder", 9),
         (52, 90, "rc.capture.round", 9), (110, 200, "rc.finish", 9),
         (130, 180, "rc.host_svd", 9), (100, 300, "rc.row_id", 7)]
#: correlation id -> (runtime call, its start, end, thread)
LAUNCHES = {1: ("cudaLaunchKernel", 20, 21, 9),
            2: ("cudaLaunchKernel", 60, 61, 9),
            3: ("cudaLaunchKernel", 95, 96, 9),
            4: ("cudaLaunchKernel", 175, 176, 9),
            5: ("cudaLaunchKernel", 190, 191, 9),
            6: ("cudaLaunchKernel", 205, 206, 9),
            7: ("cudaMemcpyAsync", 176, 177, 9)}
STAGED_OPS = [_op("a", 30, 60, corr=1), _op("b", 60, 95, corr=2),
              _op("c", 95, 130, corr=3), _op("d", 185, 190, corr=4),
              _op("copy", 186, 188, "gpu_memcpy", corr=7),
              _op("e", 190, 195, corr=5), _op("f", 210, 220, corr=6)]

READERS = {"capture_ms_per_call": "rc.capture",
           "finish_ms_per_call": "rc.finish",
           "host_svd_ms_per_call": "rc.host_svd",
           "range_finder_ms_per_call": "rc.range_finder"}


def _staged(program=SPANS):
    """Records whose host ops are one ``aten::copy_`` and the spans."""
    return trace.Records((0, 1000), list(STAGED_OPS), dict(LAUNCHES),
                         sorted([(175, 177, "aten::copy_", 9)] + program),
                         2, [{}] * 2)


def _read(name, rec):
    return load_metric(name).read(Context(None, 0.0, 0, 0, rec))


def test_an_op_goes_to_the_innermost_span_on_its_launching_thread():
    rec = _staged()
    found = spans.program_spans(rec)
    assert found == sorted(SPANS)      # the aten op is not a span
    names = [None if i is None else found[i][2]
             for i in spans.owners(rec, found)]
    # f is launched while rc.row_id is open, but on another thread
    assert names == ["rc.range_finder", "rc.capture.round", "rc.capture",
                     "rc.host_svd", "rc.host_svd", "rc.finish", None]
    inner = found.index((16, 30, "rc.range_finder", 9))
    assert spans.owners(rec, found)[0] == inner
    # a span that starts where another ends is its sibling, not its child
    touching = spans.program_spans(_staged(
        [(0, 20, "rc.capture.round", 9), (20, 40, "rc.capture.round", 9)]))
    assert spans.parents(touching) == [None, None]
    # op a, launched at 20, belongs to the span that opens there
    assert spans.owners(rec, touching)[:2] == [1, None]


def test_a_span_runs_to_the_end_of_its_last_launched_op():
    rec = _staged()
    found = spans.program_spans(rec)
    # the capture's host span ends at 100, its last op (c) at 130
    assert spans.extents(rec, found, "rc.capture") == [(10, 130)]
    # the finish's ops end before its host span does
    assert spans.extents(rec, found, "rc.finish") == [(110, 200)]
    assert _read("capture_ms_per_call", rec) == pytest.approx(120 / 2 / 1e6)
    assert _read("finish_ms_per_call", rec) == pytest.approx(90 / 2 / 1e6)
    assert _read("host_svd_ms_per_call", rec) == pytest.approx(50 / 2 / 1e6)


def test_nested_spans_of_one_name_count_once_and_siblings_as_a_union():
    rec = _staged()
    found = spans.program_spans(rec)
    # the inner rc.range_finder lies in the outer one, and both run to the
    # end of op a
    assert spans.extents(rec, found, "rc.range_finder") == [(14, 60),
                                                            (16, 60)]
    assert _read("range_finder_ms_per_call", rec) == pytest.approx(
        46 / 2 / 1e6)
    # the two rounds' extents overlap (op a runs on past round 2's start)
    assert spans.extents(rec, found, "rc.capture.round") == [(12, 60),
                                                             (52, 95)]
    assert spans.extent_ms_per_call(rec, "rc.capture.round") == (
        pytest.approx(83 / 2 / 1e6))


def test_stages_sum_to_the_windows_device_and_idle_time():
    rec = _staged()
    got = spans.stages(rec)
    per_call = {k: (v["device_ms"] * 2e6, v["idle_ms"] * 2e6,
                    v["launches"] * 2) for k, v in got.items()}
    assert per_call == {
        spans.OUTSIDE: pytest.approx((10, 15 + 780, 1)),
        "rc.range_finder": pytest.approx((30, 30, 1)),
        "rc.host_svd": pytest.approx((5, 55, 1)),   # the copy adds nothing
        "rc.capture.round": pytest.approx((35, 0, 1)),
        "rc.capture": pytest.approx((35, 0, 1)),
        "rc.finish": pytest.approx((5, 0, 1))}
    assert sum(v[0] for v in per_call.values()) == pytest.approx(
        trace.busy_seconds(rec) * 1e9)
    assert sum(v[0] + v[1] for v in per_call.values()) == pytest.approx(
        1000)
    assert sum(v[2] for v in per_call.values()) == len(rec.kernels())
    assert list(got)[0] == spans.OUTSIDE    # the largest first
    # a program without spans: every op is launched outside them
    assert list(spans.stages(_staged([]))) == [spans.OUTSIDE]


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_span_reader_without_its_span_reads_nothing(name):
    assert _read(name, None) is None
    assert _read(name, _staged([])) is None
    others = [s for s in SPANS if s[2] != READERS[name]]
    assert _read(name, _staged(others)) is None
    assert _read(name, _staged()) > 0


class _Event:
    """A raw profiler event without ``activity_type``: ``reduce`` then tells
    its kind from its device and name."""

    def __init__(self, name, start, end, cuda=False, corr=0, tid=9):
        self._name, self._start, self._end = name, start, end
        self._cuda, self._corr, self._tid = cuda, corr, tid

    def name(self):
        return self._name

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid


def _profile(events):
    import types

    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_spans_reach_the_readers_and_leave_the_device_ops_as_they_were():
    """The program's spans are host ops with no copy on the card's
    timeline: ``reduce`` keeps them among the host ops, the device ops and
    the idle gaps of launches made inside aten ops stay as they were."""
    base = [_Event(trace.WINDOW_SPAN, 0, 1000),
            _Event("aten::mm", 15, 40), _Event("aten::copy_", 170, 180),
            _Event("cudaLaunchKernel", 20, 21, corr=1),
            _Event("cudaMemcpyAsync", 175, 176, corr=4)]
    device = [_Event("gemm", 30, 60, cuda=True, corr=1),
              _Event("Memcpy HtoD (Pageable -> Device)", 185, 190,
                     cuda=True, corr=4)]
    program = [_Event("rc.capture", 10, 100), _Event("rc.host_svd", 130, 180)]
    plain = trace.reduce(_profile(base + device), 2, [{}] * 2)
    spanned = trace.reduce(_profile(base + program + device), 2, [{}] * 2)
    assert spans.program_spans(plain) == []
    assert spans.program_spans(spanned) == [(10, 100, "rc.capture", 9),
                                            (130, 180, "rc.host_svd", 9)]
    assert spanned.ops == plain.ops and len(plain.ops) == 2
    assert trace.breakdown(spanned) == trace.breakdown(plain)
    gaps = dict(trace.breakdown(plain)["idle_gaps"])
    assert "aten::copy_ / cudaMemcpyAsync -> Memcpy HtoD (Pageable -> " \
           "Device)" in gaps
    assert _read("capture_ms_per_call", spanned) == pytest.approx(
        90 / 2 / 1e6)
    assert _read("capture_ms_per_call", plain) is None


def test_a_traced_run_of_the_id_cell_reads_its_spans():
    import time

    import torch

    from benchmark.core import cli

    from conftest import SMALL

    cell = "bem_block_8k_f64.two_sided_id_tol1e-8"
    result = cli.run(["--workload", cell, "--seed", "4100000011",
                      "--seconds", "0.2", "--trace", "1"],
                     time.perf_counter(), device=torch.device("cpu"),
                     scale=SMALL["bem_block_8k_f64"])
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert {"capture_ms_per_call", "finish_ms_per_call"} <= set(metrics)
    assert "host_svd_ms_per_call" not in metrics
    assert metrics["capture_ms_per_call"]["value"] > 0
    assert metrics["finish_ms_per_call"]["unit"] == "ms"
