"""The kernels' least time by the roofline model over their profiled time (the DM search)."""

from portbench import readers


def read(ctx):
    return readers.kernel_roofline_share(ctx)
