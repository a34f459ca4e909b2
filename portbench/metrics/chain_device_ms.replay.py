"""The card's busy time a drained segment, in the device capture of a traced run (the closed loop through Pipeline)."""

from portbench import readers


def read(ctx):
    return readers.device_ms_per_segment(ctx, "busy_s")
