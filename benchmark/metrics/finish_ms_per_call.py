"""``finish_ms_per_call``: the tol <= 1e-8 pipelines' finish (the
program's ``rc.finish`` spans: the core's pivots or SVD, the cut and its
read, the coefficients, the lift or the skeleton gather; two spans a call
in the two-sided ID, summed) per call of the traced window, in ms, each
span to the end of the last device operation launched inside it
(``core/spans.py``)."""

from benchmark.core.spans import extent_ms_per_call


def read(ctx):
    return extent_ms_per_call(ctx.records, "rc.finish")
