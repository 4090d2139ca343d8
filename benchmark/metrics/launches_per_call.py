"""``launches_per_call``: the device kernels of the traced window (copies
and sets not counted) over its calls."""


def read(ctx):
    rec = ctx.records
    if rec is None or not rec.calls:
        return None
    kernels = len(rec.kernels())
    return kernels / rec.calls if kernels else None
