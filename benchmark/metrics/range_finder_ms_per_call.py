"""``range_finder_ms_per_call``: the HMT range finder (the program's
``rc.range_finder`` spans: the sketch GEMM, the power iterations and the
orthonormalization) per call of the traced window, in ms, each span to the
end of the last device operation launched inside it (``core/spans.py``)."""

from benchmark.core.spans import extent_ms_per_call


def read(ctx):
    return extent_ms_per_call(ctx.records, "rc.range_finder")
