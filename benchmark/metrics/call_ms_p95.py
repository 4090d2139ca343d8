"""``call_ms_p95``: the 95th percentile over all the window's calls of a
call's time, from its start to the end of its ``torch.cuda.synchronize()``
(host clock)."""

from benchmark.core.window import p95


def read(ctx):
    return p95(ctx.window.call_ms)
