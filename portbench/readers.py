"""What the per-layer metrics read, from the run's context.

``ctx`` holds ``trace`` (a :class:`portbench.trace.TraceSummary` of the
traced window), ``segments`` (the segments drained in the device
capture), ``stage_s`` (the engine's own host seconds by stage over the
untraced run, where the engine keeps them), ``run_segments`` and
``rest_s`` (the segments that run drained, and its seconds).  A reader
that finds nothing to read returns None.
"""

from __future__ import annotations


def idle_share(ctx):
    t = ctx.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def untraced_idle_share(ctx):
    """The idle share of a traced run's untraced phase: its segments a
    second times the device capture's busy time a segment (the device's
    times do not move under the profiler; the host's do), against 1."""
    t = ctx.get("trace")
    n = ctx.get("segments") or 0
    m = ctx.get("run_segments") or 0
    rest = ctx.get("rest_s") or 0.0
    if t is None or n <= 0 or m <= 0 or rest <= 0:
        return None
    return 100.0 * (1.0 - (t.busy_s / n) * m / rest)


def kernel_roofline_share(ctx):
    t = ctx.get("trace")
    if t is None or t.kernel_s <= 0 or t.bound_s <= 0:
        return None
    return 100.0 * t.bound_s / t.kernel_s


def device_ms_per_segment(ctx, what: str):
    t = ctx.get("trace")
    n = ctx.get("segments") or 0
    if t is None or n <= 0:
        return None
    return 1e3 * getattr(t, what) / n


def stage_ms_per_segment(ctx, stages):
    st = ctx.get("stage_s")
    n = ctx.get("run_segments") or 0
    if not st or n <= 0:
        return None
    return 1e3 * sum(st.get(s, 0.0) for s in stages) / n
