"""The share of the device capture's window in which no kernel, copy or set ran on the card (the closed loop through Pipeline)."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
