"""Profiling and tracing hooks (port of ``srtb_tpu/utils/tracing.py``).

- :class:`StageTimer`: wall clock per named host stage, as the
  reference's (the pipeline feeds every timing to the
  ``stage_seconds{stage=...}`` histograms);
- :func:`trace_annotation`: ``torch.profiler.record_function``, so a
  profile shows the host stages (``srtb:ingest``, ``srtb:dispatch``, ...)
  by the names the span journal uses;
- :func:`device_trace` and :class:`ProfileCapture`: ``torch.profiler``
  with the CPU activity and, on the card, the CUDA one, written as a
  Chrome trace (``trace.json``, readable in Perfetto or
  ``chrome://tracing``) under ``profile_capture_dir``; the capture's
  sidecar ``capture.json`` records the ``trace_id`` s and segments it
  covered, as the reference's does.

``torch`` is imported inside the functions that need it, so the pure
host modules that import this one (the journal's readers) stay light.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from srtb_tpu_torch.utils.logging import log

# the Chrome trace a capture writes, under its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_annotation(name: str):
    """``torch.profiler.record_function(name)``: a labelled range on a
    profile's host timeline (a no-op cost when no profiler runs)."""
    import torch

    with torch.profiler.record_function(name):
        yield


def _profiler():
    """A ``torch.profiler.profile`` over the CPU, and the CUDA card when
    there is one, recording every thread (the sink thread's stage too)
    where this torch can."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        extra = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):  # an older torch: its thread only
        extra = None
    return torch.profiler.profile(activities=acts,
                                  experimental_config=extra)


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """Profile the block into ``<trace_dir>/trace.json`` (a Chrome
    trace).  A profiler that cannot start logs and the block runs
    unprofiled."""
    prof = _profiler()
    try:
        os.makedirs(trace_dir, exist_ok=True)
        prof.start()
        log.info(f"[tracing] torch profiler trace -> {trace_dir}")
    except Exception as e:  # noqa: BLE001 - best-effort observability
        log.warning(f"[tracing] profiler unavailable: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


class ProfileCapture:
    """``torch.profiler`` capture of the first N drained segments of a
    run (``Config.profile_capture_segments``) into
    ``Config.profile_capture_dir``: the Chrome trace ``trace.json`` and
    the sidecar ``capture.json`` with the first and last ``trace_id``
    and segment covered (the journal's spans carry the same
    ``trace_id`` s).

    Lifecycle, as the reference's: :meth:`start` at run begin (a
    profiler that cannot start logs and the run goes on unprofiled),
    :meth:`note_segment` per drained segment until N, then auto-stop;
    :meth:`stop` is idempotent and also runs at the engine's end, so a
    short or failed run still writes a valid trace.

    torch's profiler must stop on the thread that started it (the
    engine's): a segment drained on the sink thread marks the capture
    due, and the engine's next :meth:`poll` stops it."""

    def __init__(self, out_dir: str, n_segments: int):
        self.out_dir = out_dir
        self.n_segments = int(n_segments)
        self.active = False
        self.first_trace_id = 0
        self.last_trace_id = 0
        self.first_segment = -1
        self.last_segment = -1
        self._seen = 0
        self._t0 = 0.0
        self._prof = None
        self._owner = None
        self._due = False

    @classmethod
    def from_config(cls, cfg) -> "ProfileCapture | None":
        n = int(cfg.profile_capture_segments or 0)
        if n <= 0:
            return None
        return cls(cfg.profile_capture_dir or "artifacts/profile", n)

    @property
    def trace_path(self) -> str:
        return os.path.join(self.out_dir, TRACE_FILE)

    def start(self) -> bool:
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            prof = _profiler()
            prof.start()
        except Exception as e:  # noqa: BLE001 - profiler busy / absent
            log.warning(f"[tracing] profile capture unavailable: {e}")
            return False
        self._prof = prof
        self._owner = threading.get_ident()
        self._due = False
        self.active = True
        self._t0 = time.time()
        log.info(f"[tracing] profiling first {self.n_segments} "
                 f"segment(s) -> {self.out_dir}")
        return True

    def note_segment(self, segment: int, trace_id: int = 0) -> None:
        """One drained segment; stops the capture once N are in."""
        if not self.active:
            return
        if self._seen == 0:
            self.first_segment = int(segment)
            self.first_trace_id = int(trace_id)
        self.last_segment = int(segment)
        self.last_trace_id = int(trace_id)
        self._seen += 1
        if self._seen >= self.n_segments:
            self._due = True
            self.poll()

    def poll(self) -> None:
        """Stop a due capture when called on the starting thread."""
        if self._due:
            self.stop()

    def stop(self) -> None:
        """End the capture, on the thread that started it (elsewhere it
        only marks the capture due)."""
        if not self.active:
            return
        if threading.get_ident() != self._owner:
            self._due = True
            return
        self.active = False
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            prof.export_chrome_trace(self.trace_path)
        except Exception as e:  # noqa: BLE001 - best-effort
            log.warning(f"[tracing] profiler stop failed: {e}")
            return
        # the trace_id join key between the trace and the journal's
        # spans; written last, so a capture.json implies a whole capture
        sidecar = {
            "type": "profile_capture",
            "dir": self.out_dir,
            "segments": self._seen,
            "first_segment": self.first_segment,
            "last_segment": self.last_segment,
            "first_trace_id": self.first_trace_id,
            "last_trace_id": self.last_trace_id,
            "wall_start": self._t0,
            "wall_end": time.time(),
        }
        try:
            with open(os.path.join(self.out_dir, "capture.json"),
                      "w") as f:
                json.dump(sidecar, f, indent=1, sort_keys=True)
                f.write("\n")
        except OSError as e:
            log.warning(f"[tracing] capture sidecar failed: {e}")
        from srtb_tpu_torch.utils.metrics import metrics
        metrics.add("profile_captures")
        log.info(f"[tracing] profile capture complete: {self._seen} "
                 f"segment(s), trace_ids {self.first_trace_id}.."
                 f"{self.last_trace_id} -> {self.out_dir}")


class StageTimer:
    """Accumulates wall clock per named stage (the reference's).

    ``last`` holds the most recent duration per stage so the caller can
    assemble a per-segment span, and ``on_stage(name, seconds)`` (when
    set) feeds every completed timing to the metrics histograms.
    Thread-safe: the engine thread and the sink thread both record.
    """

    def __init__(self, on_stage=None):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.last: dict[str, float] = {}
        self.on_stage = on_stage
        self._lock = threading.Lock()

    def record(self, name: str, dt: float) -> None:
        """Record one externally timed stage duration."""
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.last[name] = dt
        if self.on_stage is not None:
            self.on_stage(name, dt)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def summary(self) -> dict:
        with self._lock:
            return {name: {"total_s": round(t, 6),
                           "count": self.counts[name],
                           "mean_ms": round(1e3 * t / self.counts[name],
                                            3)}
                    for name, t in sorted(self.totals.items())}
