"""``host_svd_ms_per_call``: the host's own time in the core's SVD (the
program's ``rc.host_svd`` spans: LAPACK's SVD of the (L, L) factor and the
three copies back to the card, after the blocking copy of the factor to
the host has returned) per call of the traced window, in ms, on the host's
side of the trace (``core/spans.py``)."""

from benchmark.core.spans import host_ms_per_call


def read(ctx):
    return host_ms_per_call(ctx.records, "rc.host_svd")
