"""The engine's own dispatch and fetch seconds (stats.extras stage_s) a segment, in the untraced part of a traced run."""

from portbench import readers


def read(ctx):
    return readers.stage_ms_per_segment(ctx, ("dispatch", "fetch"))
