"""Streaming runtime: reader -> device segment processor -> sinks (port of
``srtb_tpu/pipeline/runtime.py``: ``PipelineStats``, ``has_signal`` and
``Pipeline`` with its in-flight segment engine).

The engine, as the reference's:

- a window of ``Config.inflight_segments`` segments is dispatched before
  the oldest is drained, so segment k+1's read and upload run while the
  card computes segment k.  A dispatch uploads from the reader's pinned
  buffer on the processor's copy stream and enqueues the chain on the
  engine thread's current stream, the one compute stream, so that two
  segments' intermediates never coexist; it ends with the detection
  results' copies to pinned host memory and a CUDA event (``done``), and
  reads nothing on the host;
- the drain is in order and non-blocking where it can be: a segment whose
  event has completed goes to the sink side at once; the engine blocks
  on the oldest only when the window is full or the source is done;
- the sink side (the detection gate, the candidate writers with their
  lazy waterfall copy, the buffer releases) runs on its own thread, the
  ``sink_drain`` pipe, whose copies run on a stream of their own after
  the segment's event; a segment holds its window slot from dispatch
  until its sink has finished, so at most W waterfalls live on the card;
- with the ingest ring, a dispatch whose segment is the stream-adjacent
  successor of the last one is warm (the stride's bytes only, assembled
  on the copy stream behind the device-resident carry); the first
  segment, and any after a break, is cold.

``inflight_segments = 1`` is the fully serial leg: read, dispatch,
blocking fetch and sink, one segment at a time, on one thread.

The reference's resilience layers (retry, watchdog, healer, degradation,
supervisor: ROADMAP A7), its telemetry (A9), its manifest and checkpoint
(A6) and micro-batching (A3) are later slices: their settings keep their
defaults here, and a setting that would change what a run writes raises
``NotImplementedError`` (:func:`check_runtime`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io.file_input import make_file_source
from srtb_tpu_torch.io.native_writer import AsyncWriterPool
from srtb_tpu_torch.io.writers import (WriteAllSink, WriteSignalSink,
                                       recover_orphan_temps, to_host)
from srtb_tpu_torch.pipeline import framework as fw
from srtb_tpu_torch.pipeline.segment import SegmentProcessor
from srtb_tpu_torch.pipeline.work import SegmentResultWork
from srtb_tpu_torch.quality.stats import QualityMonitor
from srtb_tpu_torch.utils import termination
from srtb_tpu_torch.utils.bufferpool import BufferPool
from srtb_tpu_torch.utils.logging import log


@dataclass
class PipelineStats:
    segments: int = 0
    samples: int = 0
    signals: int = 0
    elapsed_s: float = 0.0
    extras: dict = field(default_factory=dict)

    @property
    def msamples_per_sec(self) -> float:
        return self.samples / self.elapsed_s / 1e6 if self.elapsed_s else 0.0


def has_signal(cfg: Config, detect_result, stream: int | None = None,
               frequency_bin_count: int | None = None) -> bool:
    """The reference's gate, per stream: negative when too many channels
    are zapped (ref: signal_detect_pipe.hpp:343-345), else positive when
    any boxcar fired.  ``stream`` asks for one stream's verdict; without
    it the segment is positive when any stream is.
    ``frequency_bin_count`` is the row count of the waterfall the
    detection ran on (falls back to the configured channel count)."""
    zero_count = to_host(detect_result.zero_count)
    counts = to_host(detect_result.signal_counts)
    if zero_count.ndim == 0:
        zero_count = zero_count[None]
        counts = counts[None]
    freq_bins = (frequency_bin_count if frequency_bin_count is not None
                 else cfg.spectrum_channel_count)
    ok = zero_count < cfg.signal_detect_channel_threshold * freq_bins
    per_stream = ok & (counts.sum(axis=-1) > 0)
    if stream is not None:
        return bool(per_stream[stream])
    return bool(per_stream.any())


# settings of later slices that would change what a run reads or writes:
# (field, ROADMAP item); each raises when set away from its default
UNPORTED_RUNTIME = (
    ("checkpoint_path", "ROADMAP A6: the checkpoint"),
    ("run_manifest_path", "ROADMAP A6: the run manifest"),
    ("fault_plan", "ROADMAP A7: fault injection"),
    ("segment_deadline_s", "ROADMAP A7: segment deadlines and the "
                           "watchdog"),
    ("canary_every_segments", "ROADMAP A9: the canary, whose results "
                              "go to detection health, the SLO and "
                              "incident bundles"),
    ("telemetry_journal_path", "ROADMAP A9: the span journal"),
    ("events_dump_path", "ROADMAP A9: the flight recorder"),
    ("incident_dir", "ROADMAP A9: incident bundles"),
    ("perf_ledger_path", "ROADMAP A9: the perf ledger"),
    ("profile_capture_segments", "ROADMAP A9: profile capture"),
)


def check_runtime(cfg: Config) -> None:
    """Raise for runtime settings the port does not implement yet."""
    for name, item in UNPORTED_RUNTIME:
        if getattr(cfg, name):
            raise NotImplementedError(
                f"{name} is not ported yet ({item})")


class InFlight(NamedTuple):
    """One dispatched segment: its results (the detection already on its
    way to pinned host memory), the event after its last copy (None on
    the CPU, where a dispatch completes before it returns), and the
    dispatch's own numbers."""
    seg: Any
    wf: torch.Tensor
    det: Any
    done: torch.cuda.Event | None
    t_dispatched: float
    dispatch_s: float
    h2d_bytes: int


class Fetched(NamedTuple):
    """A drained segment on its way to the sinks."""
    seg: Any
    wf: torch.Tensor
    det: Any
    done: torch.cuda.Event | None


class Pipeline:
    """A segment source to the sinks, through the in-flight engine: the
    given ``source`` (a UDP source, ``io/udp.py``), or else the
    configured input file.  The source hands out its segments in buffers
    of its ``pool``, pinned on the card (the file reader the pipeline
    builds is).  The pipeline owns its writer pool
    (``writer_thread_count`` threads; none at 0, when every write is
    synchronous), as the reference's builds it."""

    def __init__(self, cfg: Config, source=None, device=None):
        check_runtime(cfg)
        self.cfg = cfg
        self.processor = SegmentProcessor(cfg, device=device)
        on_card = self.processor.device.type == "cuda"
        if source is None:
            if not cfg.input_file_path:
                raise ValueError("no input_file_path and no source given")
            source = make_file_source(
                cfg, buffer_pool=BufferPool("segments", pinned=on_card))
        self.source = source
        # a run that died between a temp write and its rename left
        # orphans: sweep them before the sinks open the prefix
        if cfg.baseband_output_file_prefix:
            recover_orphan_temps(cfg.baseband_output_file_prefix)
        self._owned_writer_pool = None
        if cfg.baseband_write_all:
            self.sinks = [WriteAllSink(cfg, self.processor.reserved_bytes)]
        else:
            if cfg.writer_thread_count > 0:
                self._owned_writer_pool = AsyncWriterPool(
                    cfg.writer_thread_count)
            self.sinks = [WriteSignalSink(
                cfg, writer_pool=self._owned_writer_pool,
                host_pool=BufferPool("npy", pinned=on_card))]
        self.stats = PipelineStats()
        # the quality vectors' consumer (None unless quality_stats)
        self.quality = QualityMonitor.from_config(cfg)
        # drain-order indices of the segments the gate called positive
        self.positive_segments: list[int] = []
        # the ring's device-resident carry (None = cold) and the seq of
        # the segment it came from: warm only for its adjacent successor
        self._ring_carry = None
        self._ring_prev = None
        self._sink_copy_stream = None
        # set when the bounded shutdown gave up on a wedged sink: close()
        # then abandons the writer pool instead of draining it
        self._sink_wedged = False

    @property
    def sink(self):
        """The candidate writer (or the write-all sink)."""
        return self.sinks[0]

    # ------------------------------------------------------ the ring

    def _ring_invalidate(self) -> None:
        """Drop the carry: the next dispatch is cold."""
        self._ring_carry = None
        self._ring_prev = None

    def _ring_adjacent(self, seg) -> bool:
        """Whether ``seg`` is the stream-adjacent successor of the last
        dispatched segment, so that its overlap head IS the carry.
        Unstamped segments (seq < 0) are never warm."""
        prev = self._ring_prev
        return (prev is not None and seg.seq >= 0
                and seg.seq == prev[1] + 1
                and getattr(seg, "data_stream_id", 0) == prev[0])

    def _dispatch_ring(self, seg):
        proc = self.processor
        carry, self._ring_carry = self._ring_carry, None
        if not self._ring_adjacent(seg):
            carry = None  # cold: a full upload
        out, self._ring_carry = proc.run_device_ring(
            proc.stage_input(seg.data, carry=carry))
        self._ring_prev = ((getattr(seg, "data_stream_id", 0), seg.seq)
                           if seg.seq >= 0 else None)
        return out

    # ------------------------------------------- dispatch and fetch

    def _dispatch_segment(self, seg) -> InFlight:
        """Upload one segment and enqueue its chain, then the detection
        results' copies to pinned host memory and the ``done`` event.
        Reads nothing on the host: it returns before the card is done."""
        proc = self.processor
        t0 = time.perf_counter()
        h2d0 = proc.h2d_bytes
        if proc.ring:
            wf, det = self._dispatch_ring(seg)
        else:
            wf, det = proc.run_device(proc.stage_input(seg.data))
        done = None
        if proc.device.type == "cuda":
            det = det._replace(**{
                name: value.to("cpu", non_blocking=True)
                for name, value in det._asdict().items()
                if isinstance(value, torch.Tensor)})
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(proc.device))
        t1 = time.perf_counter()
        return InFlight(seg, wf, det, done, t1, t1 - t0,
                        proc.h2d_bytes - h2d0)

    @staticmethod
    def _ready(item: InFlight) -> bool:
        """The non-blocking probe: has the segment's event completed?"""
        return item.done is None or item.done.query()

    def _fetch_inflight(self, item: InFlight) -> Fetched:
        """Wait for one dispatched segment (its detection results are on
        the host then) and record its numbers: ``overlap`` is the host
        time between its dispatch returning and this fetch starting, the
        time the engine hid under the card's work; its device seconds run
        from dispatch start to fetch end (exact in the serial leg, an
        upper bound in a window).  A quality vector goes to the monitor
        here, in drain order."""
        extras = self.stats.extras
        t0 = time.perf_counter()
        hidden = max(0.0, t0 - item.t_dispatched)
        if item.done is not None:
            item.done.synchronize()
        fetch_s = time.perf_counter() - t0
        stage_s = extras["stage_s"]
        stage_s["dispatch"] += item.dispatch_s
        stage_s["overlap"] += hidden
        stage_s["fetch"] += fetch_s
        if self.quality is not None and item.det.quality is not None:
            self.quality.observe(item.det.quality.numpy(),
                                 segment=len(extras["device_s_per_segment"]))
        extras["device_s_per_segment"].append(
            item.dispatch_s + hidden + fetch_s)
        extras["overlap_hidden_s_per_segment"].append(hidden)
        extras["h2d_bytes_per_segment"].append(item.h2d_bytes)
        return Fetched(item.seg, item.wf, item.det, item.done)

    # ------------------------------------------------ the sink side

    @contextlib.contextmanager
    def _sink_stream(self, done):
        """The sink side's copies run on a stream of their own, after the
        segment's ``done`` event (the current stream is per thread, so
        the sink thread's default would be the compute stream, behind
        the next segment's chain)."""
        if done is None:
            yield
            return
        if self._sink_copy_stream is None:
            self._sink_copy_stream = torch.cuda.Stream(
                self.processor.device)
        with torch.cuda.stream(self._sink_copy_stream):
            self._sink_copy_stream.wait_event(done)
            yield

    def _drain_body(self, item: Fetched, drained: list) -> None:
        """The sink half of one segment: the detection gate, the sink
        pushes, then the segment's buffer back to the source's pool (its
        upload finished before its event).  On the sink thread with a
        window, inline in the serial leg."""
        cfg = self.cfg
        positive = has_signal(cfg, item.det,
                              frequency_bin_count=item.wf.shape[-2])
        if positive:
            self.stats.signals += 1
            self.positive_segments.append(drained[0])
            log.info(f"[pipeline] signal detected in segment {drained[0]}")
        t0 = time.perf_counter()
        with self._sink_stream(item.done):
            for sink in self.sinks:
                sink.push(SegmentResultWork(segment=item.seg,
                                            waterfall=item.wf,
                                            detect=item.det), positive)
        self.stats.extras["stage_s"]["sink"] += time.perf_counter() - t0
        # no sink keeps the segment past its push: the write-signal sink's
        # piggyback queue holds a real-time negative only until the
        # re-check in the same push pops it (ref: write_signal_pipe.hpp
        # 122-140), so the queue is empty between pushes
        self.source.pool.release(item.seg.data)
        drained[0] += 1

    def _drain_sinks(self) -> None:
        for sink in self.sinks:
            drain = getattr(sink, "drain", None)  # a tap may have none
            if drain is not None:
                drain()  # the writer pool: wait for the disk

    # --------------------------------------------------- the engine

    def run(self, max_segments: int | None = None) -> PipelineStats:
        """Process the source to its end (or ``max_segments``).  Wall
        seconds by stage land in ``stats.extras["stage_s"]`` (``read``,
        ``dispatch``, ``overlap``, ``fetch``, ``sink``: the sink side's
        pushes, summed on whichever thread ran them, and ``drain``: the
        writer pool's final flush); per segment, in drain order,
        ``device_s_per_segment`` (the first carries one-time set-up),
        ``overlap_hidden_s_per_segment`` and ``h2d_bytes_per_segment``;
        with ``quality_stats``, ``quality``: the monitor's timeline, one
        dict a segment in drain order (the last ``TIMELINE_SPANS``)."""
        cfg = self.cfg
        window = max(1, int(cfg.inflight_segments or 1))
        stats = self.stats
        stats.extras.update(
            stage_s=dict.fromkeys(("read", "dispatch", "overlap", "fetch",
                                   "sink", "drain"), 0.0),
            device_s_per_segment=[], overlap_hidden_s_per_segment=[],
            h2d_bytes_per_segment=[], inflight_segments=window)
        stage_s = stats.extras["stage_s"]
        start = time.perf_counter()
        self._ring_invalidate()

        # a segment is live from dispatch until its sink completes; the
        # window bounds that count, so at most W waterfalls are on the
        # card (fetched but unsunk items still hold theirs)
        live_lock = threading.Lock()
        live = [0]

        def live_count() -> int:
            with live_lock:
                return live[0]

        def live_add(n: int) -> None:
            with live_lock:
                live[0] += n

        drained = [0]

        def sink_f(_stop, item):
            try:
                self._drain_body(item, drained)
            finally:
                live_add(-1)

        stop = fw.StopToken()
        q_sink = fw.WorkQueue(capacity=window)
        sink_pipe = (fw.start_pipe(sink_f, q_sink, None, stop, "sink_drain")
                     if window > 1 else None)

        def sink_alive() -> bool:
            return sink_pipe is None or sink_pipe.exception is None

        def emit(fetched) -> bool:
            if sink_pipe is None:
                sink_f(stop, fetched)
                return True
            # bounded push: blocks while the queue is full (the engine's
            # backpressure), bails out if the sink thread died
            while not q_sink.push_lossy(fetched):
                if not sink_alive():
                    return False
                time.sleep(0.002)
            return True

        pending: deque[InFlight] = deque()
        it = iter(self.source)
        exhausted = [False]

        def want_more() -> bool:
            return not exhausted[0] and (max_segments is None
                                         or stats.segments < max_segments)

        def fill_window() -> None:
            while live_count() < window and want_more() and sink_alive():
                t0 = time.perf_counter()
                seg = next(it, None)
                stage_s["read"] += time.perf_counter() - t0
                if seg is None:
                    exhausted[0] = True
                    return
                pending.append(self._dispatch_segment(seg))
                live_add(1)
                stats.segments += 1
                stats.samples += cfg.baseband_input_count

        def drain_oldest() -> bool:
            return emit(self._fetch_inflight(pending.popleft()))

        try:
            while sink_alive():
                fill_window()
                if not pending:
                    if want_more() and live_count() > 0:
                        # the whole window waits in the sink's backlog
                        time.sleep(0.002)
                        continue
                    break
                # everything already complete goes to the sinks, in order
                while pending and sink_alive() and self._ready(pending[0]):
                    if not drain_oldest():
                        break
                if not pending:
                    continue
                # window full (or source done): block on the oldest
                if live_count() >= window or not want_more():
                    if not drain_oldest():
                        break
            while pending and sink_alive():
                if not drain_oldest():
                    break
        finally:
            if sink_pipe is not None:
                self._stop_sink(sink_pipe, q_sink, sink_alive)
                stop.request_stop()
            self._ring_invalidate()
        if sink_pipe is not None and sink_pipe.exception is not None:
            raise sink_pipe.exception
        if self._sink_wedged:
            log.error("[pipeline] skipping the sink drain: the sink pipe "
                      "is wedged (queued writes were NOT flushed)")
        else:
            t0 = time.perf_counter()
            self._drain_sinks()
            stage_s["drain"] += time.perf_counter() - t0
        stats.elapsed_s = time.perf_counter() - start
        if self.quality is not None:
            stats.extras["quality"] = self.quality.timeline()
        # a UDP source's loss counters (ref: metrics packets_total and
        # packets_lost)
        for name in ("packets_total", "packets_lost"):
            if hasattr(self.source, name):
                stats.extras[name] = getattr(self.source, name)
        log.info(f"[pipeline] {stats.segments} segments, "
                 f"{stats.msamples_per_sec:.1f} Msamples/s")
        return stats

    def _stop_sink(self, sink_pipe, q_sink, sink_alive) -> None:
        """End the sink pipe: the sentinel after every queued item, then
        a join bounded by ``shutdown_join_timeout_s`` (0: wait for it).
        A sink still alive then is reported with its stack, and
        ``close()`` will not wait on its writes."""
        join_s = float(self.cfg.shutdown_join_timeout_s or 0)
        t0 = time.perf_counter()
        while not q_sink.push_lossy(fw.SENTINEL):
            if not sink_alive() or (
                    join_s > 0 and time.perf_counter() - t0 > join_s):
                break
            time.sleep(0.002)
        if not sink_pipe.join(join_s if join_s > 0 else None):
            self._sink_wedged = True
            termination.report_wedged(
                [sink_pipe.thread],
                f"pipeline shutdown ({join_s:g}s join timeout)")

    def close(self) -> None:
        """Release the run's resources: the source, the writer pool the
        pipeline owns (abandoned, not drained, after a wedged sink), the
        write-all file and the pinned segment buffers."""
        self.source.close()
        if self._owned_writer_pool is not None:
            self._owned_writer_pool.close(drain=not self._sink_wedged)
            self._owned_writer_pool = None
        for sink in self.sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()
            host_pool = getattr(sink, "host_pool", None)
            if host_pool is not None:
                host_pool.free_all()
        self.source.pool.free_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
