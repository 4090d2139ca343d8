"""``device_idle_share``: 1 - (the union of the device's kernel, copy and
set intervals inside the traced window) / the window's length."""

from benchmark.core.trace import busy_seconds


def read(ctx):
    rec = ctx.records
    if rec is None or not rec.ops:
        return None
    return 1.0 - busy_seconds(rec) / rec.window_s
