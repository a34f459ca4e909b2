"""The host-to-device copies' profiled time a drained segment (the closed loop through Pipeline)."""

from portbench import readers


def read(ctx):
    return readers.device_ms_per_segment(ctx, "h2d_s")
