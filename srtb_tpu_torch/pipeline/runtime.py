"""Streaming runtime: reader -> device segment processor -> sinks (port of
``srtb_tpu/pipeline/runtime.py``: ``PipelineStats``, ``has_signal``,
``Pipeline`` with its in-flight segment engine, and ``DMSearchPipeline``,
the DM-trial search of ``dm_list``).  ``Pipeline`` builds the processor
of the configured search mode (``pipeline/registry.py``).

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

Micro-batch (``micro_batch_segments`` = B > 1, the fused plans): the
engine's unit is B segments.  A batch is admitted only when all B fit
the window; its B reads are uploaded and run in one dispatch
(``SegmentProcessor.stage_batch`` / ``run_batch``), warm with the ring
only when the whole batch is stream-adjacent (its first segment
continues the carry, each member its predecessor), else cold; its
segments drain as separate items that share the batch's ``done`` event,
each with its own source offset (so a checkpoint after a partly drained
batch resumes at the first undrained segment) and an even share of the
batch's host time.  A tail shorter than B runs as single dispatches.

Durability (``checkpoint_path``, ``run_manifest_path``, each armed by
itself or both): the manifest opens first and runs its recovery (with
the checkpoint file's count as the floor hint), before the checkpoint
loads, the file reader starts at the checkpoint's offset, the sinks open
the output prefix and the orphan-temp sweep runs; the sinks log their
artifacts under the key ``(data_stream_id, drain index)``, the drain
index continuing across resumes, and a push whose group the manifest
holds as committed is skipped (``replayed_skips``); after each drained
segment the sinks are drained and the checkpoint updated (the manifest's
``ckpt`` record sealed first).  ``fault_plan`` steers the crash windows
at the reference's six sites (``ingest``, ``h2d``, ``dispatch``,
``fetch``, ``sink_write``, ``checkpoint``: :meth:`Pipeline._op`), with
the actions ``stall`` and ``fatal`` (``resilience/faults.py``).

The reference's other resilience layers (retry, watchdog, healer,
degradation, supervisor: ROADMAP A7) and its telemetry (A9) are later
slices: their settings keep their defaults here, and a setting that
would change what a run writes raises ``NotImplementedError``
(:func:`check_runtime`).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io.file_input import (BasebandFileReader,
                                          make_file_source)
from srtb_tpu_torch.io.manifest import RunManifest
from srtb_tpu_torch.io.native_writer import AsyncWriterPool
from srtb_tpu_torch.io.writers import (WriteAllSink, WriteSignalSink,
                                       recover_orphan_temps, to_host)
from srtb_tpu_torch.parallel.segment_dist import DistSegmentProcessor
from srtb_tpu_torch.pipeline import framework as fw
from srtb_tpu_torch.pipeline import registry
from srtb_tpu_torch.pipeline.checkpoint import StreamCheckpoint
from srtb_tpu_torch.pipeline.segment import BATCH_NEEDS_FUSED
from srtb_tpu_torch.pipeline.work import SegmentResultWork
from srtb_tpu_torch.quality.stats import QualityMonitor
from srtb_tpu_torch.resilience.faults import FaultInjector
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
    any boxcar fired, or the result's own ``positive_gate`` (a registered
    mode's rule, ``pipeline/registry.py``) says so.  ``stream`` asks for
    one stream's verdict; without it the segment is positive when any
    stream is.
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
    fired = counts.sum(axis=-1) > 0
    # a registered mode's own positive rule (the periodicity mode's
    # trials-corrected candidate gate) extends the verdict, per stream
    gate = getattr(detect_result, "positive_gate", None)
    if gate is not None:
        fired = fired | np.asarray(gate(cfg)).reshape(fired.shape)
    per_stream = ok & fired
    if stream is not None:
        return bool(per_stream[stream])
    return bool(per_stream.any())


# settings of later slices that would change what a run reads or writes:
# (field, ROADMAP item); each raises when set away from its default
# (a fault_plan's actions are checked by resilience/faults.py)
UNPORTED_RUNTIME = (
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
    the CPU, where a dispatch completes before it returns; a batch's
    segments share one), the dispatch's own numbers, the source's offset
    after this segment's read (the checkpoint's resume point) and its
    index in dispatch order (the fault sites' index)."""
    seg: Any
    wf: torch.Tensor
    det: Any
    done: torch.cuda.Event | None
    t_dispatched: float
    dispatch_s: float
    h2d_bytes: int
    offset_after: int = 0
    index: int = 0


class Fetched(NamedTuple):
    """A drained segment on its way to the sinks."""
    seg: Any
    wf: torch.Tensor
    det: Any
    done: torch.cuda.Event | None
    offset_after: int = 0
    index: int = 0


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
        # the fault plan (None: off); raises for what is not ported
        self.faults = FaultInjector.from_plan(
            cfg.fault_plan, stream=cfg.stream_name,
            retry_max_attempts=cfg.retry_max_attempts)
        # the processor of the configured search mode (the registry)
        self.processor = registry.build_processor(cfg, device=device)
        on_card = self.processor.device.type == "cuda"
        # the run manifest opens first and runs its recovery (torn tail
        # cut, uncommitted groups rolled back, the done-set rebuilt),
        # before the checkpoint loads and the sinks open the prefix; the
        # checkpoint FILE's count is its floor hint, so a WAL that lost
        # its ckpt records rolls back nothing the resume will not redo
        self.manifest = None
        if cfg.run_manifest_path:
            hint = 0
            if cfg.checkpoint_path:
                state = (StreamCheckpoint._load(cfg.checkpoint_path)
                         or StreamCheckpoint._load(
                             cfg.checkpoint_path + ".bak") or {})
                hint = int(state.get("segments_done", 0))
            self.manifest = RunManifest.open(
                cfg.run_manifest_path, fsync=bool(cfg.manifest_fsync),
                hash_content=bool(cfg.manifest_hash),
                checkpoint_floor_hint=hint)
        self.checkpoint = None
        if cfg.checkpoint_path:
            self.checkpoint = StreamCheckpoint(cfg.checkpoint_path,
                                               manifest=self.manifest)
        if source is None:
            if not cfg.input_file_path:
                raise ValueError("no input_file_path and no source given")
            start = None
            if self.checkpoint is not None and self.checkpoint.segments_done:
                start = self.checkpoint.file_offset_bytes
            source = make_file_source(
                cfg, buffer_pool=BufferPool("segments", pinned=on_card),
                start_offset_bytes=start)
        self.source = source
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
        if self.manifest is not None:
            for sink in self.sinks:
                bind = getattr(sink, "bind_manifest", None)
                if bind is not None:
                    bind(self.manifest)
        # a run that died between a temp write and its rename left
        # orphans: sweep them (after the manifest's recovery removed the
        # temps its WAL names) before the sinks write to the prefix
        if cfg.baseband_output_file_prefix:
            recover_orphan_temps(cfg.baseband_output_file_prefix)
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

    def _op(self, site: str, index: int, fn):
        """One guarded operation: the fault plan's hook at (site, index)
        fires first (a stall, or a fatal raise), then ``fn``.  With no
        plan this is a plain call."""
        faults = self.faults
        if faults is not None and faults.armed(site):
            faults.fire(site, index)
        return fn()

    def _to_host(self, dets: list):
        """Start the detection results' copies to pinned host memory and
        record the event after them (None on the CPU)."""
        proc = self.processor
        if proc.device.type != "cuda":
            return dets, None
        dets = [det._replace(**{
            name: value.to("cpu", non_blocking=True)
            for name, value in det._asdict().items()
            if isinstance(value, torch.Tensor)}) for det in dets]
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(proc.device))
        return dets, done

    # ------------------------------------------- dispatch and fetch

    def _dispatch_segment(self, seg, offset_after: int = 0,
                          index: int = 0) -> InFlight:
        """Upload one segment (the ``h2d`` site) and enqueue its chain
        (the ``dispatch`` site), then the detection results' copies to
        pinned host memory and the ``done`` event.  Reads nothing on the
        host: it returns before the card is done."""
        proc = self.processor
        t0 = time.perf_counter()
        h2d0 = proc.h2d_bytes
        if proc.ring:
            carry, self._ring_carry = self._ring_carry, None
            if not self._ring_adjacent(seg):
                carry = None  # cold: a full upload
            staged = self._op("h2d", index,
                              lambda: proc.stage_input(seg.data, carry=carry))
            (wf, det), self._ring_carry = self._op(
                "dispatch", index, lambda: proc.run_device_ring(staged))
            self._ring_prev = ((getattr(seg, "data_stream_id", 0), seg.seq)
                               if seg.seq >= 0 else None)
        else:
            staged = self._op("h2d", index,
                              lambda: proc.stage_input(seg.data))
            wf, det = self._op("dispatch", index,
                               lambda: proc.run_device(staged))
        (det,), done = self._to_host([det])
        t1 = time.perf_counter()
        return InFlight(seg, wf, det, done, t1, t1 - t0,
                        proc.h2d_bytes - h2d0, offset_after, index)

    def _dispatch_batch(self, segs: list, offsets: list,
                        first_index: int) -> list[InFlight]:
        """B segments in one dispatch, under the first segment's
        ``dispatch`` site (one dispatch, one failure domain): their
        uploads into one device tensor, the chain a lane at a time, the
        results' copies and one ``done`` event.  With the ring the batch
        is warm only when it is stream-adjacent as a whole.  Returns one
        item a segment, each with its own offset and an even share of the
        host time and of the uploaded bytes."""
        proc = self.processor
        t0 = time.perf_counter()
        h2d0 = proc.h2d_bytes
        datas = [seg.data for seg in segs]
        if proc.ring:
            chain_ok = self._ring_adjacent(segs[0]) and all(
                b.seq == a.seq + 1
                and getattr(b, "data_stream_id", 0)
                == getattr(a, "data_stream_id", 0)
                for a, b in zip(segs, segs[1:]))
            carry, self._ring_carry = self._ring_carry, None
            if not chain_ok:
                carry = None

            def run():
                staged = proc.stage_batch(datas, carry=carry)
                if carry is None:
                    return proc.run_batch_cold(staged)
                return proc.run_batch_ring(staged)

            lanes, self._ring_carry = self._op("dispatch", first_index, run)
            last = segs[-1]
            self._ring_prev = ((getattr(last, "data_stream_id", 0), last.seq)
                               if last.seq >= 0 else None)
        else:
            lanes = self._op("dispatch", first_index,
                             lambda: proc.run_batch(proc.stage_batch(datas)))
        dets, done = self._to_host([det for _wf, det in lanes])
        t1 = time.perf_counter()
        b = len(segs)
        per_seg = (t1 - t0) / b
        h2d_each = (proc.h2d_bytes - h2d0) // b
        return [InFlight(seg, wf, det, done, t1, per_seg, h2d_each, off,
                         first_index + i)
                for i, (seg, (wf, _d), det, off)
                in enumerate(zip(segs, lanes, dets, offsets))]

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
        done = item.done
        self._op("fetch", item.index,
                 lambda: done.synchronize() if done is not None else None)
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
        return Fetched(item.seg, item.wf, item.det, item.done,
                       item.offset_after, item.index)

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

    def _push_sinks(self, item: Fetched, positive: bool,
                    seg_key: tuple | None) -> None:
        """Push one segment to every sink.  ``seg_key`` is the manifest's
        ``(data_stream_id, drain index)`` (None without a manifest): a
        sink whose group the manifest holds as committed (the crash came
        between its commit and the covering checkpoint) is skipped,
        counted as a replayed skip; every other sink logs its artifacts
        under ``(stream, index, "<position>:<class>")`` and, when it
        wrote one, seals a ``done`` record."""
        work = SegmentResultWork(segment=item.seg, waterfall=item.wf,
                                 detect=item.det)
        m = self.manifest
        for i, sink in enumerate(self.sinks):
            key = None
            if m is not None and seg_key is not None:
                key = (seg_key[0], seg_key[1], f"{i}:{type(sink).__name__}")
                if m.is_done(key):
                    m.replayed_skips += 1
                    log.info(f"[manifest] segment {seg_key[1]} sink "
                             f"{key[2]}: already committed, skipping "
                             "replay")
                    continue
                set_key = getattr(sink, "set_manifest_key", None)
                if set_key is not None:
                    set_key(key)
            sink.push(work, positive)
            # an empty push seals nothing: a replayed negative segment
            # writes nothing again
            if key is not None and getattr(sink, "last_push_wrote", True):
                m.sink_done(key)

    def _drain_body(self, item: Fetched, drained: list) -> None:
        """The sink half of one segment: the detection gate, the sink
        pushes (the ``sink_write`` site), the segment's buffer back to the
        source's pool (its upload finished before its event; a batch's
        before the batch's event), then with a checkpoint the sinks'
        drain and the checkpoint's update (the ``checkpoint`` site).  On
        the sink thread with a window, inline in the serial leg."""
        cfg = self.cfg
        extras = self.stats.extras
        positive = has_signal(cfg, item.det,
                              frequency_bin_count=item.wf.shape[-2])
        if positive:
            self.stats.signals += 1
            self.positive_segments.append(drained[0])
            log.info(f"[pipeline] signal detected in segment {drained[0]}")
        # the manifest's key: the drain index, which continues across
        # resumes, so a replayed segment lands on its first life's key
        seg_key = None if self.manifest is None else (
            getattr(item.seg, "data_stream_id", 0), drained[0])
        t0 = time.perf_counter()
        with self._sink_stream(item.done):
            self._op("sink_write", item.index,
                     lambda: self._push_sinks(item, positive, seg_key))
        extras["stage_s"]["sink"] += time.perf_counter() - t0
        # no sink keeps the segment past its push: the write-signal sink's
        # piggyback queue holds a real-time negative only until the
        # re-check in the same push pops it (ref: write_signal_pipe.hpp
        # 122-140), so the queue is empty between pushes
        self.source.pool.release(item.seg.data)
        drained[0] += 1
        if self.checkpoint is not None:
            # a checkpointed segment is durable: the queued writes land
            # before the update records it
            t0 = time.perf_counter()
            self._op("checkpoint", item.index,
                     lambda: (self._drain_sinks(),
                              self.checkpoint.update(drained[0],
                                                     item.offset_after)))
            dt = time.perf_counter() - t0
            extras["stage_s"]["checkpoint"] += dt
            extras["checkpoint_s_per_segment"].append(dt)

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
        writer pool's final flush, and ``checkpoint``: the drains and
        updates after each segment); per segment, in drain order,
        ``device_s_per_segment`` (the first carries one-time set-up),
        ``overlap_hidden_s_per_segment``, ``h2d_bytes_per_segment`` and,
        with a checkpoint, ``checkpoint_s_per_segment``; ``dispatches``
        (a batch is one); with a manifest, ``manifest``: its recovery and
        replay counts; with ``quality_stats``, ``quality``: the monitor's
        timeline, one dict a segment in drain order (the last
        ``TIMELINE_SPANS``).

        ``micro_batch_segments`` above the window, or above 1 on the
        staged plan, raises ``ValueError`` before any read."""
        cfg = self.cfg
        window = max(1, int(cfg.inflight_segments or 1))
        batch = max(1, int(cfg.micro_batch_segments or 1))
        if batch > window:
            raise ValueError(
                f"micro_batch_segments={batch} exceeds "
                f"inflight_segments={window}: a batch dispatch must fit "
                "the in-flight window")
        if batch > 1 and self.processor.staged:
            raise ValueError(BATCH_NEEDS_FUSED)
        stats = self.stats
        stats.extras.update(
            stage_s=dict.fromkeys(("read", "dispatch", "overlap", "fetch",
                                   "sink", "drain", "checkpoint"), 0.0),
            device_s_per_segment=[], overlap_hidden_s_per_segment=[],
            h2d_bytes_per_segment=[], checkpoint_s_per_segment=[],
            inflight_segments=window, micro_batch_segments=batch,
            dispatches=0)
        stage_s = stats.extras["stage_s"]
        n_samples = cfg.baseband_input_count
        start = time.perf_counter()
        # a resumed run is a fresh process: its carry starts cold
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

        # the drain index continues the checkpoint's count
        drained = [self.checkpoint.segments_done
                   if self.checkpoint is not None else 0]

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

        def ingest_one(index: int):
            """One read (the ``ingest`` site): the segment and the
            source's offset after it, or None at the source's end."""
            t0 = time.perf_counter()
            seg = self._op("ingest", index, lambda: next(it, None))
            stage_s["read"] += time.perf_counter() - t0
            if seg is None:
                exhausted[0] = True
                return None
            return seg, getattr(self.source, "logical_offset", 0)

        def fill_window() -> None:
            # the unit is the batch: admitted only when all of it fits
            while live_count() + batch <= window and want_more() \
                    and sink_alive():
                first = stats.segments
                budget = batch if max_segments is None else \
                    min(batch, max_segments - first)
                got = []
                while len(got) < budget:
                    one = ingest_one(first + len(got))
                    if one is None:
                        break
                    got.append(one)
                if not got:
                    return
                if batch > 1 and len(got) == batch:
                    segs, offsets = map(list, zip(*got))
                    items = self._dispatch_batch(segs, offsets, first)
                    stats.extras["dispatches"] += 1
                else:  # one segment, or a tail shorter than the batch
                    items = [self._dispatch_segment(seg, off, first + i)
                             for i, (seg, off) in enumerate(got)]
                    stats.extras["dispatches"] += len(items)
                pending.extend(items)
                live_add(len(items))
                stats.segments += len(items)
                stats.samples += n_samples * len(items)

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
                # no room for the next unit (or source done): block on
                # the oldest
                if live_count() + batch > window or not want_more():
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
        if self.manifest is not None:
            stats.extras["manifest"] = self.manifest.counters()
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
        run manifest, the write-all file and the pinned segment
        buffers."""
        self.source.close()
        if self._owned_writer_pool is not None:
            self._owned_writer_pool.close(drain=not self._sink_wedged)
            self._owned_writer_pool = None
        if self.manifest is not None:
            self.manifest.close()
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


class DMSearchPipeline:
    """The streaming DM search (the reference's ``DMSearchPipeline``):
    every segment runs the DM-trial step (``parallel/segment_dist.py``)
    over the trial list ``cfg.dm_list``; each segment's per-trial
    summaries are appended to ``<prefix>dm_trials.jsonl`` as the
    reference's record (the same keys in the same order), and the best
    trial of a positive segment is logged.  The segments come from
    ``source`` (any source ``tools/main.make_source`` gives) or the
    configured input file.  One segment at a time: its bytes uploaded
    (pinned, on the copy stream, on the card), every trial enqueued, then
    one fetch of the summaries."""

    def __init__(self, cfg: Config, source=None, mesh=None, device=None):
        self.cfg = cfg
        self.dm_list = list(cfg.dm_list) or [cfg.dm]
        self.processor = DistSegmentProcessor(cfg, mesh, self.dm_list,
                                              device=device)
        if source is None:
            if not cfg.input_file_path:
                raise ValueError("no input_file_path and no source given")
            # the wall-clock reader, as the reference's DM search reads
            source = BasebandFileReader(cfg, buffer_pool=BufferPool(
                "segments", pinned=self.processor.device.type == "cuda"))
        self.source = source
        self.trials_path = cfg.baseband_output_file_prefix + \
            "dm_trials.jsonl"
        self.stats = PipelineStats()

    def run(self, max_segments: int | None = None) -> PipelineStats:
        cfg = self.cfg
        sp = self.processor.processor
        n_dm = len(self.dm_list)
        start = time.perf_counter()
        with open(self.trials_path, "a") as trials_file:
            for i, seg in enumerate(self.source):
                try:
                    if max_segments is not None and i >= max_segments:
                        break
                    res = self.processor.run_device(sp.stage_input(seg.data))
                    # one fetch a segment, after the last trial
                    peaks, counts, zero = (to_host(x) for x in (
                        res.snr_peaks, res.signal_counts, res.zero_count))
                finally:
                    self.source.pool.release(seg.data)
                # reduce over (stream, boxcar) to per-trial quantities
                peaks = peaks.reshape(n_dm, -1)
                counts = counts.reshape(n_dm, -1)
                zero = zero.reshape(n_dm, -1).max(axis=-1)
                ok = zero < (cfg.signal_detect_channel_threshold
                             * cfg.spectrum_channel_count)
                fired = counts.sum(axis=-1) > 0
                # rank trials by raw peak SNR: a matched trial concentrates
                # the pulse and may trip the SK zap gate, which only means
                # "be cautious", not "not the best DM"
                best = int(np.argmax(peaks.max(axis=-1)))
                record = {
                    "segment": i,
                    "timestamp": seg.timestamp,
                    "best_dm": self.dm_list[best],
                    "best_snr": float(peaks[best].max()),
                    "dm_list": self.dm_list,
                    "peak_snr": peaks.max(axis=-1).tolist(),
                    "signal_counts": counts.sum(axis=-1).tolist(),
                    "zero_counts": zero.tolist(),
                }
                trials_file.write(json.dumps(record) + "\n")
                trials_file.flush()
                if bool((ok & fired).any()):
                    self.stats.signals += 1
                    log.info(f"[dm_search] segment {i}: best dm "
                             f"{record['best_dm']} "
                             f"snr {record['best_snr']:.1f}")
                self.stats.segments += 1
                self.stats.samples += cfg.baseband_input_count
        self.stats.elapsed_s = time.perf_counter() - start
        return self.stats

    def close(self) -> None:
        """Close the source and free its segment buffers."""
        self.source.close()
        self.source.pool.free_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
