"""The card's idle share in the untraced phase of a traced run, from the device capture's busy time a segment (the closed loop through Pipeline)."""

from portbench import readers


def read(ctx):
    return readers.untraced_idle_share(ctx)
