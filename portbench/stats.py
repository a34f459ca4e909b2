"""The window's arithmetic: a closed loop's rate, from the times the
benchmark itself recorded."""

from __future__ import annotations

import bisect


def completed(done_times, start: float, t: float) -> float:
    """The work a loop that began at ``start`` had completed by ``t``: the
    items done by then, and of the item in progress the share of its
    wait (from the last completion, or the start, to its own) that had
    passed.  So a window's rate counts all its time and all the work in
    it, and does not move by a whole item with the phase at which the
    window closes."""
    if t <= start:
        return 0.0
    xs = sorted(x for x in done_times if x >= start)
    k = bisect.bisect_right(xs, t)
    if k == len(xs):
        return float(k)
    prev = xs[k - 1] if k else start
    return k + (t - prev) / (xs[k] - prev) if xs[k] > prev else float(k)


def window_rate(done_times, t0: float, seconds: float, per_item: float,
                start: float | None = None) -> float:
    """``per_item`` units for the work completed inside ``[t0, t0 +
    seconds]`` (:func:`completed`, the loop begun at ``start``, by
    default ``t0``), over ``seconds``: a closed loop's work a second."""
    s = t0 if start is None else start
    return ((completed(done_times, s, t0 + seconds)
             - completed(done_times, s, t0)) * per_item / seconds)
