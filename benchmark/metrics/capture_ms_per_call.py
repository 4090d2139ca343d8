"""``capture_ms_per_call``: the tol <= 1e-8 pipelines' capture (the
program's ``rc.capture`` spans: the growth or fixed rounds, the basis's
final QR and ``B = Q^H A``) per call of the traced window, in ms. Each span
counts from its host start to the later of its host end and the end of the
last device operation launched inside it (``core/spans.py``)."""

from benchmark.core.spans import extent_ms_per_call


def read(ctx):
    return extent_ms_per_call(ctx.records, "rc.capture")
