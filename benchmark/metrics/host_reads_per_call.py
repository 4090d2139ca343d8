"""``host_reads_per_call``: the reads of device values by the host that
steer the tol <= 1e-8 pipelines (the port's ``highacc._read.count``), over
the traced window's calls. Nothing to read in a call of another pipeline:
a window whose calls made no such read reports nothing."""

PROBES = {"host_reads": "rusty_compression_tpu_torch.highacc._read.count"}


def read(ctx):
    rec = ctx.records
    if rec is None or not rec.calls:
        return None
    reads = sum(c["host_reads"] for c in rec.counters)
    return reads / rec.calls if reads else None
