"""``tsqr_ms_per_call``: device time of K5, the port's tall-skinny QR
kernel (``rusty_compression_tpu_torch/csrc/tsqr.cu``: its factor kernel
and its Q kernel), in the traced window, per call, in ms; nothing where no
K5 kernel ran."""

import re

PATTERN = re.compile(r"tsqr_(factor|q)_kernel")


def read(ctx):
    rec = ctx.records
    if rec is None or not rec.calls:
        return None
    seconds = rec.device_seconds(PATTERN.search)
    return seconds * 1e3 / rec.calls if seconds else None
