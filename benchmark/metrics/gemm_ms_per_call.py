"""``gemm_ms_per_call``: device time of the library's matrix products
(cuBLAS and CUTLASS GEMM and GEMV kernels through torch) in the traced
window, per call, in ms."""

import re

PATTERN = re.compile(r"gemm|gemv|xmma|cutlass", re.IGNORECASE)


def read(ctx):
    rec = ctx.records
    if rec is None or not rec.calls:
        return None
    seconds = rec.device_seconds(PATTERN.search)
    return seconds * 1e3 / rec.calls if seconds else None
