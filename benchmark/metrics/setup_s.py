"""``setup_s``: host seconds from the start of the process to the start of
the window: importing, making the data, building the port's kernels where
the checkout has none yet, and warming up the cell's shapes."""


def read(ctx):
    return ctx.setup_s
