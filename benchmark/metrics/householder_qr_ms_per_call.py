"""``householder_qr_ms_per_call``: device time of the library's
Householder QR kernels (cuSOLVER through ``torch.linalg.qr``: the panel
factorization ``geqr2``/``geqrf``, the block reflectors ``larft``/``larfb``,
forming or applying Q ``orgqr``/``ormqr``/``org2r``/``orm2r`` and their
complex twins) in the traced window, per call, in ms."""

import re

PATTERN = re.compile(r"geqr|larf|org2r|orgqr|orm2r|ormqr|ung2r|ungqr|unm2r"
                     r"|unmqr", re.IGNORECASE)


def read(ctx):
    rec = ctx.records
    if rec is None or not rec.calls:
        return None
    seconds = rec.device_seconds(PATTERN.search)
    return seconds * 1e3 / rec.calls if seconds else None
