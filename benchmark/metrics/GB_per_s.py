"""``GB_per_s``: the block bytes of every call the window completed, over
the window's whole time (host clock), in GB (1e9 bytes) per second: the
north star's "GB/s of matrix data compressed per chip"."""

from benchmark.core.window import rate


def read(ctx):
    completed = ctx.window.calls - ctx.window.failed
    return rate(completed * ctx.block_bytes, ctx.window.seconds) / 1e9
