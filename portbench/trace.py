"""The traced window: torch.profiler around the window, reduced to what
the per-layer metrics and the breakdown read.

Two captures, because recording the host's operators and their shapes
costs the host several milliseconds a segment, and a closed loop then
drains about half its untraced rate:

- :class:`DeviceCapture` records the device's activity alone, so the host
  runs as it does untraced; :func:`reduce_device` gives the idle share's
  ``busy_s`` and ``window_s`` (the block's length on the host's clock),
  the device time, the copies and the kernels by name;
- :class:`Capture` records the host's operators with their shapes too;
  :func:`reduce_events` adds the roofline's times and the idle gaps' host
  ranges (:func:`merge` takes those from it and the rest from the first).

The reductions read the profiler's raw events (no chrome trace is written
or parsed): the device's kernels, copies and sets inside the window
(marked by the ``portbench:window`` range in the full capture), the
operators that launched them, and the host's ranges.  From them:

- ``busy_s``: the length of the union of the device's activity;
- ``window_s``: the window's length;
- ``kernel_s``: the summed duration of the kernels, and ``bound_s`` the
  summed least time of the calls the roofline model knows
  (``portbench/roofline``); ``unmodeled_s`` the kernel time it does not;
- ``h2d_s``: the summed duration of the host-to-device copies;
- ``device_ops``: kernel time by name; ``idle_gaps``: the device's idle
  time by the innermost host range running at the middle of each gap.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from dataclasses import dataclass, field

from portbench import roofline

WINDOW_RANGE = "portbench:window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: float = 0.0
    bound_s: float = 0.0
    unmodeled_s: float = 0.0
    h2d_s: float = 0.0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    reduce_s: float = 0.0

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops[:10],
                "idle_gaps": self.idle_gaps[:10]}


class Capture:
    """torch.profiler over a block, the block marked as the window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA],
                                record_shapes=True)
            self.prof.__enter__()
            self._range = torch.profiler.record_function(WINDOW_RANGE)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import torch
            self._range.__exit__(*exc)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        return False

    def events(self) -> list:
        return list(self.prof.profiler.kineto_results.events())


class DeviceCapture:
    """torch.profiler over a block with the device's activity alone (no
    host operators, no shapes); the window is the block's length on
    ``clock``, from the profiler's start to the device's last work."""

    def __init__(self, enabled: bool, clock=time.perf_counter):
        self.enabled = enabled
        self.clock = clock
        self.prof = None
        self.window_s = 0.0

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self._t0 = self.clock()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import torch
            torch.cuda.synchronize()
            self.window_s = self.clock() - self._t0
            self.prof.__exit__(*exc)
        return False

    def events(self) -> list:
        return list(self.prof.profiler.kineto_results.events())


def reduce_device(events, window_s: float) -> TraceSummary:
    """The device-only capture's summary: every kernel, copy and set it
    holds ran inside the block (the engine was idle when it began)."""
    t_start = time.perf_counter()
    s = TraceSummary(window_s=window_s)
    busy = []
    by_name = defaultdict(float)
    for ev in events:
        if not str(ev.device_type()).endswith("CUDA"):
            continue
        kind = _kind(ev, set())
        if kind not in DEVICE_KINDS:
            continue
        start, end = ev.start_ns(), ev.end_ns()
        if end <= start:
            continue
        dur = (end - start) / 1e9
        busy.append((start, end))
        name = ev.name()
        if kind == "gpu_memcpy" and "HtoD" in name:
            s.h2d_s += dur
        if kind == "kernel":
            s.kernel_s += dur
            by_name[name] += dur
    s.busy_s = sum(e - b for b, e in _union(busy)) / 1e9
    s.device_ops = sorted(([n, t] for n, t in by_name.items()),
                          key=lambda x: -x[1])
    s.reduce_s = time.perf_counter() - t_start
    return s


def merge(device: TraceSummary, full: TraceSummary) -> TraceSummary:
    """The device capture's summary with the full capture's roofline times
    and idle gaps (the host ranges exist only there)."""
    return dataclasses.replace(
        device, kernel_s=full.kernel_s, bound_s=full.bound_s,
        unmodeled_s=full.unmodeled_s, idle_gaps=full.idle_gaps,
        reduce_s=device.reduce_s + full.reduce_s)


def _kind(ev, annotations: set) -> str:
    """The event's kineto activity type; where the profiler does not give
    it, worked out: a device event named as a host range is that range's
    device-side shadow, ``Memcpy``/``Memset`` names are copies and sets,
    any other device event a kernel."""
    try:
        kind = ev.activity_type()
        if kind:
            return kind
    except AttributeError:
        pass
    if not str(ev.device_type()).endswith("CUDA"):
        return "user_annotation" if _is_annotation(ev) else "cpu_op"
    name = ev.name()
    if name in annotations or _is_annotation(ev):
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _is_annotation(ev) -> bool:
    try:
        return bool(ev.is_user_annotation())
    except AttributeError:
        return False


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events, geo: dict) -> TraceSummary:
    """The window's summary from the profiler's raw events (``geo``: the
    segment's shapes for the program's own kernels, see
    ``roofline.port_kernel_cost``)."""
    t_start = time.perf_counter()
    win = None
    ops = {}
    ranges = []
    device = []
    host = [ev for ev in events
            if not str(ev.device_type()).endswith("CUDA")]
    # a device event named as a host event is a host range's shadow on the
    # device timeline (a kernel is never named as a host event)
    annotations = {ev.name() for ev in host}
    annotations.add(WINDOW_RANGE)
    for ev in events:
        if not str(ev.device_type()).endswith("CUDA"):
            continue
        kind = _kind(ev, annotations)
        if kind in DEVICE_KINDS:
            device.append((ev.start_ns(), ev.end_ns(), ev.name(), kind,
                           ev.linked_correlation_id()))
    linked = {d[4] for d in device}
    for ev in host:
        kind = _kind(ev, annotations)
        name = ev.name()
        if name == WINDOW_RANGE:
            win = (ev.start_ns(), ev.end_ns())
            continue
        if kind in ("cpu_op", "user_annotation", "cuda_runtime",
                    "cuda_driver"):
            ranges.append((ev.start_ns(), ev.end_ns(), name))
            corr = ev.correlation_id()
            if corr not in linked:
                continue
            shapes = ev.shapes()
            # an operator with its shapes wins a correlation id over an
            # event without (a runtime call's)
            if shapes or corr not in ops:
                ops[corr] = (name, shapes, ev.dtypes())
    if win is None:
        raise RuntimeError("the trace has no window range")
    w0, w1 = win
    s = TraceSummary(window_s=(w1 - w0) / 1e9)
    busy = []
    by_name = defaultdict(float)
    per_op_time = defaultdict(float)
    per_op_kernels = {}
    for start, end, name, kind, link in device:
        start, end = max(start, w0), min(end, w1)
        if end <= start:
            continue
        dur = (end - start) / 1e9
        busy.append((start, end))
        if kind == "gpu_memcpy" and "HtoD" in name:
            s.h2d_s += dur
        if kind != "kernel":
            continue
        s.kernel_s += dur
        by_name[name] += dur
        cost = roofline.port_kernel_cost(name, geo)
        if cost is not None:
            s.bound_s += roofline.bound_s(*cost,
                                          roofline.PEAK["float32_flops"])
            continue
        op = ops.get(link)
        if op is None:
            s.unmodeled_s += dur
            continue
        per_op_time[link] += dur
        per_op_kernels[link] = op
    for link, (name, shapes, dtypes) in per_op_kernels.items():
        cost = roofline.op_cost(name, shapes, dtypes)
        if cost is None:
            s.unmodeled_s += per_op_time[link]
            continue
        double = any(d in ("double", "c10::complex<double>")
                     for d in dtypes or [])
        peak = roofline.PEAK["float64_flops" if double else "float32_flops"]
        s.bound_s += roofline.bound_s(*cost, peak)
    merged = _union(busy)
    s.busy_s = sum(e - b for b, e in merged) / 1e9
    s.device_ops = sorted(([n, t] for n, t in by_name.items()),
                          key=lambda x: -x[1])
    s.idle_gaps = _label_gaps(merged, w0, w1, ranges)
    s.reduce_s = time.perf_counter() - t_start
    return s


def _label_gaps(merged: list, w0: int, w1: int, ranges: list) -> list:
    """Idle time by the innermost host range (latest started, still open)
    at each gap's middle; "host (no range)" where none is open."""
    gaps = []
    prev = w0
    for b, e in merged:
        if b > prev:
            gaps.append((prev, b))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    total = defaultdict(float)
    for b, e in gaps:
        mid = (b + e) // 2
        i = bisect.bisect_right(starts, mid)
        label = "host (no range)"
        # the latest-started range that covers the middle; ranges are few
        # deep, so a short walk back finds it
        for j in range(i - 1, max(-1, i - 4000), -1):
            r0, r1, name = ranges[j]
            if r1 >= mid:
                label = name
                break
        total[label] += (e - b) / 1e9
    return sorted(([n, t] for n, t in total.items()), key=lambda x: -x[1])
