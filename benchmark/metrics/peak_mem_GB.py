"""``peak_mem_GB``: ``torch.cuda.max_memory_allocated()`` over the window,
the peak statistics reset at its start, inputs included, in GB (1e9
bytes)."""


def read(ctx):
    return ctx.peak_bytes / 1e9
