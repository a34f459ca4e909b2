"""Streaming runtime: reader -> device segment processor -> sinks (port of
``srtb_tpu/pipeline/runtime.py``: ``PipelineStats``, ``has_signal``,
``Pipeline`` with its in-flight segment engine and its resilience layers,
and ``DMSearchPipeline``, the DM-trial search of ``dm_list``).
``Pipeline`` builds the processor of the configured search mode
(``pipeline/registry.py``).

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
only when the whole batch is stream-adjacent, else cold; its segments
drain as separate items that share the batch's ``done`` event, each with
its own source offset and an even share of the batch's host time.  A
tail shorter than B runs as single dispatches.

Durability (``checkpoint_path``, ``run_manifest_path``): the manifest
opens first and runs its recovery, the checkpoint loads, the file reader
starts at its offset, the sinks log their artifacts under ``(data
stream, drain index)`` and skip what the manifest holds as committed;
after each drained segment the sinks are drained and the checkpoint
updated.

Resilience (``resilience/``), armed by the reference's defaults:

- every operation at the six sites (``ingest``, ``h2d``, ``dispatch``,
  ``fetch``, ``sink_write``, ``checkpoint``) runs the fault plan's hook,
  then the retry policy (:meth:`Pipeline._op`);
- a device fault at a dispatch or fetch (an out-of-memory, a kernel
  build or launch fault, a dead context: ``resilience/errors.py``) walks
  the plan-demotion ladder or reinitializes the processor
  (``resilience/demote.py``) and re-dispatches the segment cold from its
  pinned host buffer, which stays with the segment until its sink ends; a
  failed micro-batch finishes as single cold dispatches and the engine's
  unit follows the healer;
- the segment watchdog (``segment_deadline_s`` with
  ``segment_watchdog_requeues``) re-dispatches a drain head that is not
  ready within the deadline, on the same compute stream: it cannot cancel
  a kernel, so it helps with host-side stalls, and a true device hang
  ends in ``WatchdogEscalation``; with the deadline alone, a blocking
  fetch past it aborts the process;
- on a real-time source (no ``input_file_path``) the degradation ladder
  (``resilience/degrade.py``) withholds the waterfall dumps at level 1
  and skips the sheddable writers at level 2, each shed counted once
  under replay; a wedged sink sheds segments as accounted loss;
- the ``sink_drain`` pipe is supervised (``supervisor_max_restarts``): a
  crash that is not fatal restarts it, its item replayed inline first
  (exactly once with the manifest).

Observability (``utils/``), wired where the reference wires it:

- every host stage (``ingest``, ``dispatch``, ``overlap``, ``fetch``,
  ``sink``) lands in the ``stage_seconds{stage=...}`` histogram and runs
  under ``torch.profiler.record_function("srtb:<stage>")``;
- each drained segment bumps ``segments``, ``samples`` and ``signals``
  with their windows, stamps ``/healthz``'s liveness, feeds the SLO
  tracker, observes its device seconds (the engine's own per-segment
  measurement, read at drain: no device value is read at dispatch) and
  sets the live roofline gauges from the plan's ``hbm_passes`` floor,
  and, with ``telemetry_journal_path``, writes one schema-11 span;
- a segment's ``trace_id`` is stamped at ingest, and the flight recorder
  (``events_enable``) takes its stage edges and every resilience
  decision; ``events_dump_path`` receives the dump when the pipeline
  closes, also after a run that raised;
- ``profile_capture_segments`` records the first N segments with
  ``torch.profiler``.

The resilience counters live in the registry (``utils/metrics.py``) and
are copied into ``stats.extras`` at the end of a run, also when it
raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
import traceback
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
from srtb_tpu_torch.resilience.degrade import DegradationLadder
from srtb_tpu_torch.resilience.demote import ComputeHealer
from srtb_tpu_torch.resilience.errors import (DEVICE_HALT, LadderExhausted,
                                              ReinitBudgetExceeded,
                                              WatchdogEscalation,
                                              kernel_fault)
from srtb_tpu_torch.resilience.faults import FaultInjector
from srtb_tpu_torch.resilience.retry import RetryPolicy, retry_call
from srtb_tpu_torch.resilience.supervisor import Supervisor
from srtb_tpu_torch.utils import events, slo, telemetry, termination
from srtb_tpu_torch.utils.bufferpool import BufferPool
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics
from srtb_tpu_torch.utils.tracing import (ProfileCapture, StageTimer,
                                          trace_annotation)


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


def _abort_on_deadline(deadline_s: float) -> None:  # pragma: no cover
    log.error(
        f"[pipeline] device sync exceeded segment_deadline_s={deadline_s}: "
        "the card is wedged; aborting")
    os.kill(os.getpid(), signal.SIGABRT)


def sync_with_deadline(deadline_s: float, fn):
    """Run a blocking device sync under a fail-fast deadline (seconds,
    <= 0 disables): on expiry the process aborts (a loud stack through
    the termination handler, not a silent hang)."""
    if not deadline_s or deadline_s <= 0:
        return fn()
    timer = threading.Timer(deadline_s,
                            lambda: _abort_on_deadline(deadline_s))
    timer.daemon = True
    timer.start()
    try:
        return fn()
    finally:
        timer.cancel()


# settings of later slices that would change what a run reads or writes:
# (field, ROADMAP item); each raises when set away from its default
UNPORTED_RUNTIME = (
    ("canary_every_segments", "ROADMAP A9b: the canary, whose results "
                              "go to detection health, the SLO and "
                              "incident bundles"),
    ("incident_dir", "ROADMAP A9b: incident bundles"),
    ("perf_ledger_path", "ROADMAP A9c: the perf ledger"),
    ("sanitize", "ROADMAP A9d: the runtime sanitizer"),
)
# more than one process joins a process group in the reference
UNPORTED_PROCESSES = "ROADMAP A8: parallel/* on torch.distributed"

# the resilience counters a run copies into ``stats.extras`` (with the
# ``retries_<site>`` and ``worker_restarts_<name>`` families)
EXTRAS_COUNTERS = (
    "plan_demotions", "plan_promotions", "device_reinits",
    "plan_ladder_level", "retries_total", "data_loss_total",
    "watchdog_requeues", "segments_dropped", "shed_waterfalls",
    "shed_baseband", "degrade_level", "degrade_steps",
    "degrade_recoveries", "faults_injected", "worker_restarts")
EXTRAS_PREFIXES = ("retries_", "worker_restarts_")


def check_processes(cfg: Config) -> None:
    """Raise for ``distributed_num_processes > 1``."""
    if int(cfg.distributed_num_processes or 1) > 1:
        raise NotImplementedError(
            f"distributed_num_processes={cfg.distributed_num_processes} "
            f"is not ported yet ({UNPORTED_PROCESSES})")


def check_runtime(cfg: Config) -> None:
    """Raise for runtime settings the port does not implement yet."""
    for name, item in UNPORTED_RUNTIME:
        if getattr(cfg, name):
            raise NotImplementedError(
                f"{name} is not ported yet ({item})")
    check_processes(cfg)


def counters_snapshot() -> dict:
    """The resilience counters the registry holds now, by name."""
    snap = metrics.snapshot()
    return {k: v for k, v in snap.items()
            if k in EXTRAS_COUNTERS or k.startswith(EXTRAS_PREFIXES)}


class InFlight(NamedTuple):
    """One dispatched segment: its results (the detection already on its
    way to pinned host memory), the event after its last copy (None on
    the CPU, where a dispatch completes before it returns; a batch's
    segments share one), the dispatch's own numbers, the source's offset
    after this segment's read (the checkpoint's resume point), its
    index in dispatch order (the fault sites' index) and its read's
    seconds (the span's ``ingest``)."""
    seg: Any
    wf: torch.Tensor
    det: Any
    done: torch.cuda.Event | None
    t_dispatched: float
    dispatch_s: float
    h2d_bytes: int
    offset_after: int = 0
    index: int = 0
    ingest_s: float = 0.0


class Fetched(NamedTuple):
    """A drained segment on its way to the sinks, with the degradation
    level observed when it was emitted and its done-set: the sinks that
    already took it and the ``"stats"`` and ``"wf"`` markers, so a retried
    or replayed drain counts and pushes exactly once.  Its telemetry
    rides along: the span's host stages so far, the seconds the engine
    hid under the card's work, its device seconds, the window's depths
    when it was drained and its quality dict (None when off)."""
    seg: Any
    wf: torch.Tensor
    det: Any
    done: torch.cuda.Event | None
    offset_after: int = 0
    index: int = 0
    degrade_level: int = 0
    sinks_done: set | None = None
    span: dict | None = None
    hidden_s: float = 0.0
    device_s: float | None = None
    queue_depth: int = 0
    inflight_depth: int = 0
    quality: dict | None = None


class Pipeline:
    """A segment source to the sinks, through the in-flight engine: the
    given ``source`` (a UDP source, ``io/udp.py``), or else the
    configured input file.  The source hands out its segments in buffers
    of its ``pool``, pinned on the card (the file reader the pipeline
    builds is).  The pipeline owns its writer pool
    (``writer_thread_count`` threads; none at 0, when every write is
    synchronous), as the reference's builds it.  ``sinks`` and
    ``processor`` replace the configured ones (the tests' capture sinks
    and stub processors)."""

    def __init__(self, cfg: Config, source=None, device=None, sinks=None,
                 processor=None):
        check_runtime(cfg)
        self.cfg = cfg
        # the stream's name labels its series (unnamed: flat series only)
        self.stream = str(cfg.stream_name or "")
        self._stream_labels = ({"stream": self.stream}
                               if self.stream else None)
        # the flight recorder and the SLO tracker are process-global:
        # this config arms or disarms them
        events.configure(enabled=bool(cfg.events_enable),
                         ring_size=int(cfg.events_ring_size or 0)
                         or events.DEFAULT_RING_SIZE)
        self._events_enabled = bool(cfg.events_enable)
        self._slo_armed = slo.configure(cfg) is not None
        # the fault plan (None: off) and the retry policy (None: off)
        self.faults = FaultInjector.from_plan(cfg.fault_plan,
                                              stream=self.stream)
        self.retry = RetryPolicy.from_config(cfg)
        # the processor of the configured search mode (the registry)
        if processor is None:
            processor = registry.build_processor(cfg, device=device)
        self.processor = processor
        on_card = self.processor.device.type == "cuda"
        # the plan-demotion ladder and the device reinit (None: both off)
        self.healer = ComputeHealer.from_config(cfg, self._plan_factory)
        if self.healer is not None:
            self.healer.bind_base(getattr(self.processor, "staged", None))
        self.active_plan = self._plan_of(self.processor)
        self._ladder = (DegradationLadder.from_config(cfg)
                        if cfg.degrade_enable else None)
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
        if sinks is None:
            if cfg.baseband_write_all:
                sinks = [WriteAllSink(cfg, self.processor.reserved_bytes)]
            else:
                if cfg.writer_thread_count > 0:
                    self._owned_writer_pool = AsyncWriterPool(
                        cfg.writer_thread_count)
                sinks = [WriteSignalSink(
                    cfg, writer_pool=self._owned_writer_pool,
                    host_pool=BufferPool("npy", pinned=on_card))]
        self.sinks = sinks
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
        # every host stage's timing also lands in a histogram, so
        # /metrics carries live p50/p95/p99 per stage
        self.stage_timer = StageTimer(
            on_stage=lambda name, dt: metrics.histogram(
                "stage_seconds", labels={"stage": name}).observe(dt))
        # the compile families exist from the first scrape (zero so far)
        for fam in ("compile_seconds", "plan_compiles", "aot_cache_hits",
                    "aot_cache_misses"):
            metrics.add(fam, 0.0)
            if self._stream_labels is not None:
                metrics.add(fam, 0.0, labels=self._stream_labels)
        # the first N segments under torch.profiler (None: off)
        self.profile_capture = ProfileCapture.from_config(cfg)
        self.journal = None
        if cfg.telemetry_journal_path:
            self.journal = telemetry.SpanJournal(
                cfg.telemetry_journal_path,
                max_bytes=int(cfg.telemetry_journal_max_bytes),
                compress=bool(cfg.telemetry_journal_compress))
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
        # bumped after every completed sink push: the wedge detectors'
        # progress signal
        self._sink_heartbeat = 0
        # serializes the accounted/abandoned handoff between a wedged sink
        # worker and the bounded shutdown
        self._handoff_lock = threading.Lock()
        # (step, plan name) of each processor the healer installed
        self.plan_history: list[tuple[str, str]] = []
        # what a halt's healing drops, kept until the run ends (None: no
        # halt seen): after a sticky CUDA error torch aborts the process
        # from a tensor's destructor when it frees memory an event guards
        # (a staged buffer recorded on the compute stream), so nothing is
        # freed before the run escalates
        self._halted = None

    @property
    def sink(self):
        """The candidate writer (or the write-all sink)."""
        return self.sinks[0]

    # ------------------------------------------------------ the ring

    @property
    def events(self):
        """The live process-global flight recorder, or None when this
        pipeline's config disarmed it (read each time: a later pipeline
        may rearm the hub at another ring size)."""
        return events.hub if self._events_enabled else None

    @property
    def slo(self):
        """The live process-global SLO tracker, or None when disarmed."""
        return slo.tracker if self._slo_armed else None

    @contextlib.contextmanager
    def _stage(self, name: str):
        """One named host stage: the stage timer (and its histogram) and
        a ``srtb:<name>`` range on a profile's timeline."""
        with trace_annotation(f"srtb:{name}"), \
                self.stage_timer.stage(name):
            yield

    def _ring_invalidate(self) -> None:
        """Drop the carry: the next dispatch is cold."""
        if self._ring_carry is not None and self.events is not None:
            # a live carry is dropped: the warm chain breaks here
            self.events.emit("ring.invalidate", trace=events.current()[0],
                             stream=self.stream)
        self._keep_if_halted(self._ring_carry)
        self._ring_carry = None
        self._ring_prev = None

    def _keep_if_halted(self, *objs) -> None:
        """After a halt, hold ``objs`` until the run ends (``_halted``)."""
        if self._halted is not None:
            self._halted.extend(o for o in objs if o is not None)

    def _keep_if_dead(self, item) -> None:
        """Hold a drained item (``_halted``) when its card's context died
        before the engine thread saw the halt: its event's query raises,
        and freeing its pinned results would abort the process from a
        destructor.  The sink thread asks before it drops each item."""
        if self._halted is None and item.done is not None:
            try:
                item.done.query()
            except RuntimeError:  # torch.AcceleratorError: a dead context
                if self._halted is None:
                    self._halted = []
        self._keep_if_halted(item)

    def _ring_adjacent(self, seg) -> bool:
        """Whether ``seg`` is the stream-adjacent successor of the last
        dispatched segment, so that its overlap head IS the carry.
        Unstamped segments (seq < 0) are never warm."""
        prev = self._ring_prev
        return (prev is not None and getattr(seg, "seq", -1) >= 0
                and seg.seq == prev[1] + 1
                and getattr(seg, "data_stream_id", 0) == prev[0])

    def _op(self, site: str, index: int, fn):
        """One guarded operation: the fault plan's hook at (site, index)
        fires first, then ``fn`` under the retry policy.  With no plan
        and no retries this is a plain call.  A retried operation is
        idempotent at its site: an upload re-copies the pinned bytes, a
        dispatch re-enqueues the chain on the same staged tensor (a warm
        one on the same carry, which the staging copied and did not
        consume), a fetch re-synchronizes the same event, and a sink push
        skips the sinks that already took the segment."""
        faults = self.faults
        if faults is not None and faults.armed(site):
            inner = fn

            def fn():
                faults.fire(site, index)
                return inner()
        if self.retry is None:
            return fn()
        return retry_call(fn, self.retry, site)

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

    # -------------------------------------------- the healer's hooks

    @staticmethod
    def _plan_of(proc) -> str:
        return str(getattr(proc, "plan_name", type(proc).__name__))

    def _plan_factory(self, cfg, staged):
        """A replacement processor for the healer (a demotion rung, the
        promotion probe or a reinit), through the registry (the
        ``search_mode`` rung changes the processor class), on the current
        processor's device.  The current processor is retired and the
        allocator's cache emptied first: after an out-of-memory the new
        rung must not meet the old rung's tables and cached blocks, or it
        fails again and the ladder burns rungs for nothing.  A card's
        pending work is waited for first: on a context a sticky fault
        killed that wait raises, and nothing is built on it."""
        old = self.processor
        device = old.device
        if device.type == "cuda":
            # a context a sticky fault killed fails here, before anything
            # is freed or built on it (the heal counts it as one more halt)
            torch.cuda.synchronize(device)
        self._ring_invalidate()
        retire = getattr(old, "retire", None)
        if retire is not None:
            retire()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return registry.build_processor(cfg, device=device, staged=staged)

    def _swap_processor(self, newp) -> None:
        """Install a replacement processor (the factory retired the old
        one): the ring's carry belongs to the old plan, so the next
        dispatch is cold."""
        old, self.processor = self.processor, newp
        self._ring_invalidate()
        retire = getattr(old, "retire", None)
        if retire is not None and old is not newp \
                and not getattr(old, "_retired", False):
            retire()
        h = self.healer
        step = h.active_step if h is not None else "full"
        plan = self._plan_of(newp)
        self.plan_history.append((step, plan))
        self.active_plan = plan

    # ------------------------------------------- dispatch and fetch

    def _dispatch_segment(self, seg, offset_after: int = 0,
                          index: int = 0, requeue: bool = False
                          ) -> InFlight:
        """Upload one segment (the ``h2d`` site) and enqueue its chain
        (the ``dispatch`` site), then the detection results' copies to
        pinned host memory and the ``done`` event.  Reads nothing on the
        host: it returns before the card is done.  ``requeue`` (a watchdog
        requeue, a healed re-dispatch) isolates the dispatch from the
        ring: it is cold, and its carry is adopted only when the ring was
        down on entry (the requeued segment is then the stream's
        frontier).  The ``dispatch`` stage and its event time the
        whole."""
        proc = self.processor
        tid = getattr(seg, "trace_id", 0)
        ev = self.events
        if ev is not None:
            events.set_current(tid, self.stream)
        t0 = time.perf_counter()
        h2d0 = proc.h2d_bytes
        if proc.ring:
            ring_down = self._ring_prev is None and self._ring_carry is None
            carry = None if requeue or not self._ring_adjacent(seg) \
                else self._ring_carry
            if carry is not None:
                self._ring_carry = None
            elif ev is not None:
                ev.emit("ring.cold", trace=tid, stream=self.stream,
                        seg=index, info="requeue" if requeue else "")
            with trace_annotation("srtb:dispatch"):
                staged = self._op("h2d", index, lambda: proc.stage_input(
                    seg.data, carry=carry))
                (wf, det), next_carry = self._op(
                    "dispatch", index, lambda: proc.run_device_ring(
                        staged, warm=carry is not None))
            if not requeue or ring_down:
                self._ring_carry = next_carry
                self._ring_prev = ((getattr(seg, "data_stream_id", 0),
                                    seg.seq) if seg.seq >= 0 else None)
        else:
            with trace_annotation("srtb:dispatch"):
                staged = self._op("h2d", index,
                                  lambda: proc.stage_input(seg.data))
                wf, det = self._op("dispatch", index,
                                   lambda: proc.run_device(staged))
        (det,), done = self._to_host([det])
        t1 = time.perf_counter()
        self.stage_timer.record("dispatch", t1 - t0)
        if ev is not None:
            ev.emit("stage.dispatch", trace=tid, stream=self.stream,
                    seg=index, dur=t1 - t0,
                    info="requeue" if requeue else "")
        return InFlight(seg, wf, det, done, t1, t1 - t0,
                        proc.h2d_bytes - h2d0, offset_after, index)

    def _dispatch_batch(self, segs: list, offsets: list, first_index: int,
                        ingests: list | None = None) -> list[InFlight]:
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
        ev = self.events
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

            with trace_annotation("srtb:dispatch"):
                lanes, self._ring_carry = self._op("dispatch", first_index,
                                                   run)
            last = segs[-1]
            self._ring_prev = ((getattr(last, "data_stream_id", 0), last.seq)
                               if last.seq >= 0 else None)
        else:
            with trace_annotation("srtb:dispatch"):
                lanes = self._op("dispatch", first_index, lambda:
                                 proc.run_batch(proc.stage_batch(datas)))
        dets, done = self._to_host([det for _wf, det in lanes])
        t1 = time.perf_counter()
        b = len(segs)
        per_seg = (t1 - t0) / b
        h2d_each = (proc.h2d_bytes - h2d0) // b
        for i, seg in enumerate(segs):
            self.stage_timer.record("dispatch", per_seg)
            if ev is not None:
                ev.emit("stage.dispatch", trace=getattr(seg, "trace_id", 0),
                        stream=self.stream, seg=first_index + i,
                        dur=per_seg, info=f"batch={b}")
        return [InFlight(seg, wf, det, done, t1, per_seg, h2d_each, off,
                         first_index + i, ing)
                for i, (seg, (wf, _d), det, off, ing)
                in enumerate(zip(segs, lanes, dets, offsets,
                                 ingests or [0.0] * b))]

    @staticmethod
    def _ready(item: InFlight) -> bool:
        """The non-blocking probe: has the segment's event completed?"""
        return item.done is None or item.done.query()

    def _fetch_inflight(self, item: InFlight, queue_depth: int = 0,
                        inflight_depth: int = 0) -> Fetched:
        """Wait for one dispatched segment (its detection results are on
        the host then; the ``fetch`` site, under ``segment_deadline_s``)
        and record its numbers: ``overlap`` is the host time between its
        dispatch returning and this fetch starting, the time the engine
        hid under the card's work; its device seconds run from dispatch
        start to fetch end (exact in the serial leg, an upper bound in a
        window).  A quality vector goes to the monitor here, in drain
        order.  ``queue_depth`` and ``inflight_depth`` are the window's
        depths at this drain, for the journal."""
        extras = self.stats.extras
        tid = getattr(item.seg, "trace_id", 0)
        ev = self.events
        if ev is not None:
            events.set_current(tid, self.stream)
        t0 = time.perf_counter()
        hidden = max(0.0, t0 - item.t_dispatched)
        self.stage_timer.record("overlap", hidden)
        done = item.done
        deadline_s = float(self.cfg.segment_deadline_s or 0.0)
        with self._stage("fetch"):
            self._op("fetch", item.index, lambda: sync_with_deadline(
                deadline_s,
                lambda: done.synchronize() if done is not None else None))
        fetch_s = self.stage_timer.last["fetch"]
        if ev is not None:
            ev.emit("stage.fetch", trace=tid, stream=self.stream,
                    seg=item.index, dur=fetch_s)
        stage_s = extras["stage_s"]
        stage_s["dispatch"] += item.dispatch_s
        stage_s["overlap"] += hidden
        stage_s["fetch"] += fetch_s
        quality = None
        if self.quality is not None and item.det.quality is not None:
            quality = self.quality.observe(
                item.det.quality.numpy(),
                segment=len(extras["device_s_per_segment"]))
        device_s = item.dispatch_s + hidden + fetch_s
        extras["device_s_per_segment"].append(device_s)
        extras["overlap_hidden_s_per_segment"].append(hidden)
        extras["h2d_bytes_per_segment"].append(item.h2d_bytes)
        span = {"ingest": item.ingest_s, "dispatch": item.dispatch_s,
                "fetch": fetch_s}
        return Fetched(item.seg, item.wf, item.det, item.done,
                       item.offset_after, item.index, span=span,
                       hidden_s=hidden, device_s=device_s,
                       queue_depth=queue_depth,
                       inflight_depth=inflight_depth, quality=quality)

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
        """Push one segment to every sink.  At degradation level 1 the
        waterfall is withheld from every sink, at level 2 the
        ``sheddable`` sinks are skipped, each shed counted
        (``shed_waterfalls``, ``shed_baseband``).  ``item.sinks_done``
        holds the sinks that already took the segment (skipped when a
        retry or a replay re-enters) and the ``"wf"`` marker that keeps
        the waterfall shed's count exactly once.  ``seg_key`` is the
        manifest's ``(data_stream_id, drain index)`` (None without a
        manifest): a sink whose group the manifest holds as committed is
        skipped, counted as a replayed skip; every other sink logs its
        artifacts under ``(stream, index, "<position>:<class>")`` and,
        when it wrote one, seals a ``done`` record."""
        done = item.sinks_done
        wf = item.wf
        if item.degrade_level >= 1 and wf is not None:
            wf = None
            if done is None or "wf" not in done:
                self._count("shed_waterfalls")
                if done is not None:
                    done.add("wf")
        work = SegmentResultWork(segment=item.seg, waterfall=wf,
                                 detect=item.det)
        m = self.manifest
        for i, sink in enumerate(self.sinks):
            if done is not None and i in done:
                continue
            key = None
            if m is not None and seg_key is not None:
                key = (seg_key[0], seg_key[1], f"{i}:{type(sink).__name__}")
                if m.is_done(key):
                    m.replayed_skips += 1
                    metrics.add("replayed_skips")
                    log.info(f"[manifest] segment {seg_key[1]} sink "
                             f"{key[2]}: already committed, skipping "
                             "replay")
                    if done is not None:
                        done.add(i)
                    continue
            if item.degrade_level >= 2 and getattr(sink, "sheddable", False):
                self._count("shed_baseband")
                if done is not None:
                    done.add(i)
                continue
            if key is not None:
                set_key = getattr(sink, "set_manifest_key", None)
                if set_key is not None:
                    set_key(key)
            sink.push(work, positive)
            # an empty push seals nothing: a replayed negative segment
            # writes nothing again
            if key is not None and getattr(sink, "last_push_wrote", True):
                m.sink_done(key)
            self._sink_heartbeat += 1
            if done is not None:
                done.add(i)

    def _count(self, name: str, n: float = 1) -> None:
        """Add to a flat counter and to its stream-labeled twin."""
        metrics.add(name, n)
        if self._stream_labels is not None:
            metrics.add(name, n, labels=self._stream_labels)

    def _release(self, seg) -> None:
        """The segment's buffer back to the source's pool (no sink keeps
        a segment past its push)."""
        pool = getattr(self.source, "pool", None)
        if pool is not None:
            pool.release(seg.data)

    def _drain_body(self, item: Fetched, drained: list) -> None:
        """The sink half of one segment: the detection gate, the sink
        pushes (the ``sink_write`` site), the segment's buffer back to the
        source's pool (its upload finished before its event; a batch's
        before the batch's event), then with a checkpoint the sinks'
        drain and the checkpoint's update (the ``checkpoint`` site).  On
        the sink thread with a window, inline in the serial leg.  The
        item's done-set keeps the signal count and the pushes exactly
        once when a crashed drain is replayed."""
        cfg = self.cfg
        extras = self.stats.extras
        done = item.sinks_done
        ev = self.events
        tid = getattr(item.seg, "trace_id", 0)
        if ev is not None:
            # the sink thread's context: the manifest's records and the
            # sink-side retries below attribute to this segment
            events.set_current(tid, self.stream)
        positive = has_signal(cfg, item.det,
                              frequency_bin_count=item.wf.shape[-2])
        if positive and (done is None or "stats" not in done):
            if done is not None:
                done.add("stats")
            self.stats.signals += 1
            self.positive_segments.append(drained[0])
            log.info(f"[pipeline] signal detected in segment {drained[0]}")
        # the manifest's key: the drain index, which continues across
        # resumes, so a replayed segment lands on its first life's key
        seg_key = None if self.manifest is None else (
            getattr(item.seg, "data_stream_id", 0), drained[0])
        with self._sink_stream(item.done), self._stage("sink"):
            self._op("sink_write", item.index,
                     lambda: self._push_sinks(item, positive, seg_key))
        sink_s = self.stage_timer.last["sink"]
        extras["stage_s"]["sink"] += sink_s
        if ev is not None:
            ev.emit("stage.sink", trace=tid, stream=self.stream,
                    seg=item.index, dur=sink_s,
                    info="dump" if positive else "")
        # no sink keeps the segment past its push: the write-signal sink's
        # piggyback queue holds a real-time negative only until the
        # re-check in the same push pops it (ref: write_signal_pipe.hpp
        # 122-140), so the queue is empty between pushes
        self._release(item.seg)
        with self._handoff_lock:
            if done is not None and "abandoned" in done:
                # the bounded shutdown counted this segment as dropped
                # while this thread was wedged mid-push
                return
            drained[0] += 1
        self._record_segment(drained[0] - 1, item, positive,
                             dict(item.span or {}, sink=sink_s))
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

    def _account_dropped(self, n: int = 1, trace: int | None = None
                         ) -> None:
        """``n`` whole shed segments: the counter and the loss window
        (the degradation ladder's level-3 signal), the SLO's loss and a
        ``shed.segment`` event on the shed segment's trace (``trace``;
        None: the thread's current one)."""
        self._count("segments_dropped", n)
        metrics.window("segments_dropped").add(n)
        if self.slo is not None:
            self.slo.note_dropped(self.stream, n)
        ev = self.events
        if ev is not None:
            ev.emit("shed.segment",
                    trace=trace if trace is not None
                    else events.current()[0],
                    stream=self.stream, info=f"n={n}")

    # ----------------------------------------------------- telemetry

    def _device_time_account(self, device_s: float, n_samples: int
                             ) -> tuple:
        """One drained segment's device seconds: the ``device_seconds``
        histogram and the live roofline gauges, achieved Msamples/s and
        modelled GB/s over those seconds and their fraction of
        ``hbm_peak_gbps``.  The traffic model is the plan's
        ``hbm_passes`` floor, and the device seconds an upper bound on
        the card's busy time, so the gauges are lower bounds.  Returns
        (achieved_msamps, roofline_frac) for the span, (None, None)
        for a processor without the plan model."""
        metrics.histogram("device_seconds").observe(device_s)
        if self._stream_labels is not None:
            metrics.histogram("device_seconds",
                              labels=self._stream_labels).observe(device_s)
        proc = self.processor
        passes = getattr(proc, "hbm_passes", None)
        n_spec = getattr(proc, "n_spectrum", None)
        if passes is None or n_spec is None or device_s <= 0:
            return None, None
        seg_bytes = getattr(proc, "_segment_bytes", self.cfg.segment_bytes(1))
        gbps = (seg_bytes + 8.0 * n_spec * passes) / device_s / 1e9
        msamps = n_samples / device_s / 1e6
        frac = gbps / float(self.cfg.hbm_peak_gbps or 819.0)
        for name, val in (("achieved_msamps", msamps),
                          ("achieved_gbps", gbps),
                          ("roofline_frac", frac)):
            metrics.set(name, val)
            if self._stream_labels is not None:
                metrics.set(name, val, labels=self._stream_labels)
        return msamps, frac

    def _record_segment(self, index: int, item: Fetched, positive: bool,
                        span: dict) -> None:
        """One drained segment's telemetry (drain index ``index``): the
        lifetime counters and their windows, the liveness stamp, the
        device-time and roofline accounting, the profile capture's
        count, the SLO and, with the journal, one span."""
        n_samples = self.cfg.baseband_input_count
        seg = item.seg
        metrics.add("segments")
        metrics.add("samples", n_samples)
        if positive:
            metrics.add("signals")
        metrics.window("segments").add(1)
        metrics.window("samples").add(n_samples)
        if self._stream_labels is not None:
            metrics.add("segments", labels=self._stream_labels)
            metrics.add("samples", n_samples, labels=self._stream_labels)
        telemetry.mark_segment(self.stream or None)
        msamps = frac = None
        if item.device_s is not None:
            msamps, frac = self._device_time_account(item.device_s,
                                                     n_samples)
        tid = getattr(seg, "trace_id", 0)
        if self.profile_capture is not None:
            self.profile_capture.note_segment(index, tid)
        if self.slo is not None:
            # the latency objective scores the host stages' sum
            self.slo.note_segment(self.stream, sum(span.values()))
        if self.journal is None:
            return
        # a registered mode's own payload (the periodicity candidates)
        # and the quality dict ride in the span's extra sections
        span_extra = getattr(item.det, "span_extra", None)
        extra = span_extra() if span_extra is not None else None
        if item.quality is not None:
            extra = dict(extra or {}, quality=item.quality)
        self.journal.write(telemetry.segment_span(
            index, span, item.queue_depth,
            int(to_host(item.det.signal_counts).sum()), positive, n_samples,
            timestamp_ns=getattr(seg, "timestamp", 0), extra=extra,
            overlap_hidden_s=item.hidden_s,
            inflight_depth=item.inflight_depth,
            active_plan=self._plan_of(self.processor),
            stream=self.stream or None, trace_id=tid or None,
            device_s=item.device_s, achieved_msamps=msamps,
            roofline_frac=frac))

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
        ``TIMELINE_SPANS``); and the resilience counters of the metrics
        registry (``EXTRAS_COUNTERS``; ``active_plan`` too with the
        healer), also when the run raises.

        ``micro_batch_segments`` above the window, or above 1 on the
        staged plan, raises ``ValueError`` before any read."""
        try:
            stats = self._run_engine(max_segments)
        finally:
            self.stats.extras.update(counters_snapshot())
            if self.healer is not None:
                self.stats.extras["active_plan"] = self.active_plan
        # the run outlived its halts: the context lives, free what they held
        self._halted = None
        return stats

    def _run_engine(self, max_segments: int | None) -> PipelineStats:
        cfg = self.cfg
        window = max(1, int(cfg.inflight_segments or 1))
        batch = max(1, int(cfg.micro_batch_segments or 1))
        if batch > window:
            raise ValueError(
                f"micro_batch_segments={batch} exceeds "
                f"inflight_segments={window}: a batch dispatch must fit "
                "the in-flight window")
        if batch > 1 and getattr(self.processor, "staged", False):
            raise ValueError(BATCH_NEEDS_FUSED)
        stats = self.stats
        stats.extras.update(
            stage_s=dict.fromkeys(("read", "dispatch", "overlap", "fetch",
                                   "sink", "drain", "checkpoint"), 0.0),
            device_s_per_segment=[], overlap_hidden_s_per_segment=[],
            h2d_bytes_per_segment=[], checkpoint_s_per_segment=[],
            inflight_segments=window, micro_batch_segments=batch,
            dispatches=0, degrade_levels=[])
        stage_s = stats.extras["stage_s"]
        n_samples = cfg.baseband_input_count
        start = time.perf_counter()
        if self.profile_capture is not None:
            # armed before the first dispatch: the capture covers the
            # kernels' builds and the first N segments
            self.profile_capture.start()
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
                metrics.set("inflight_depth", live[0])
                if self._stream_labels is not None:
                    metrics.set("inflight_depth", live[0],
                                labels=self._stream_labels)

        # the drain index continues the checkpoint's count
        drained = [self.checkpoint.segments_done
                   if self.checkpoint is not None else 0]

        # the sink pipe's supervisor: a crash that is not fatal restarts
        # it, its item replayed inline first (journal order kept)
        use_sink_pipe = window > 1
        supervisor = None
        if use_sink_pipe and int(cfg.supervisor_max_restarts or 0) > 0:
            supervisor = Supervisor(
                "sink_drain", max_restarts=cfg.supervisor_max_restarts,
                window_s=cfg.supervisor_window_s)
        current = [None]   # the item the sink worker is processing
        progress = [0]     # drained[0] when that item started

        def sink_f(_stop, item):
            current[0] = item
            progress[0] = drained[0]
            try:
                self._drain_body(item, drained)
            finally:
                # an item abandoned by the bounded shutdown had its live
                # slot released there
                if "abandoned" not in item.sinks_done:
                    live_add(-1)
                self._keep_if_dead(item)
            current[0] = None

        stop = fw.StopToken()
        q_sink = fw.WorkQueue(capacity=window)
        sink_pipe = (fw.start_pipe(sink_f, q_sink, None, stop, "sink_drain")
                     if use_sink_pipe else None)

        # set while the engine unwinds from a failure: the shutdown then
        # restarts and replays nothing (the run is ending, and after a
        # sticky fault a replay would fail again in its place)
        unwinding = [False]

        def sink_halt(exc) -> bool:
            """Whether ``exc``, met on the sink side, is a device halt:
            the sink's copies run on the card, so a sticky fault can
            reach the sink before the engine sees it."""
            h = self.healer
            return h is not None and h.classify(exc) == DEVICE_HALT

        def drain_inline(item) -> None:
            """The sink half on the engine's thread (the serial leg, a
            crashed pipe's replay).  A device halt there is healed as the
            engine's own and the segment drained again: on a context that
            a sticky fault killed every reinit fails, and the run ends
            ``ReinitBudgetExceeded`` once the budget is spent."""
            while True:
                try:
                    self._drain_body(item, drained)
                    return
                except BaseException as e:  # noqa: BLE001 - classified
                    if not sink_halt(e):
                        raise
                    err = e
                heal(err)

        def sink_alive() -> bool:
            """True while the sink side can make progress; restarts a
            supervised crashed pipe as a side effect (a device halt that
            crashed it is healed first)."""
            nonlocal sink_pipe
            if sink_pipe is None or sink_pipe.exception is None:
                return True
            if supervisor is None or unwinding[0] or \
                    not supervisor.should_restart(sink_pipe.exception):
                return False
            if sink_halt(sink_pipe.exception):
                heal(sink_pipe.exception)
            failed, current[0] = current[0], None
            if failed is not None and failed is not fw.SENTINEL:
                if drained[0] == progress[0]:
                    # the crash came before the item was accounted: replay
                    # it inline before the new pipe pops (its live slot
                    # was released by sink_f's finally; the done-set and
                    # the manifest keep its pushes exactly once); a second
                    # failure here propagates, a halt once healed
                    drain_inline(failed)
                else:
                    log.warning(
                        "[supervisor] sink_drain crashed after its "
                        "segment was accounted; skipping replay (the "
                        "next checkpoint covers it)")
            sink_pipe = fw.start_pipe(sink_f, q_sink, None, stop,
                                      "sink_drain")
            return True

        watchdog_max = int(cfg.segment_watchdog_requeues or 0)
        deadline_s = float(cfg.segment_deadline_s or 0.0)
        watchdog = watchdog_max > 0 and deadline_s > 0
        # the degradation ladder's pressure flag: the engine waited on
        # the sink since the last emit
        sink_wait = [False]
        # shedding is for liveness: a real-time source only (a file run
        # throttles its reader losslessly)
        real_time = not cfg.input_file_path

        def shed_segment(seg, in_flight: bool) -> None:
            """Account one shed segment as loss, break the ring's chain,
            free its window slot (``in_flight``) and its buffer."""
            self._account_dropped(trace=getattr(seg, "trace_id", 0))
            self._ring_invalidate()
            if in_flight:
                live_add(-1)
            self._release(seg)

        def push_sink(item) -> bool:
            """Bounded push to the sink pipe: blocks while the queue is
            full (the engine's backpressure), bails out if the sink died;
            with the watchdog on a real-time source, a sink wedged (no
            push completed) past the deadline sheds this segment as
            accounted loss."""
            t0 = time.perf_counter()
            progress0 = (drained[0], self._sink_heartbeat)
            while not q_sink.push_lossy(item):
                sink_wait[0] = True
                if not sink_alive() or stop.stop_requested:
                    return False
                if watchdog and real_time and item is not fw.SENTINEL:
                    cur = (drained[0], self._sink_heartbeat)
                    if cur != progress0:
                        t0, progress0 = time.perf_counter(), cur
                    elif time.perf_counter() - t0 > deadline_s:
                        log.error(
                            "[watchdog] sink pipe wedged past "
                            f"{deadline_s:g}s with no drain progress: "
                            "shedding segment as accounted loss")
                        shed_segment(item.seg, in_flight=True)
                        return True
                time.sleep(0.002)
            return True

        def emit(fetched: Fetched) -> bool:
            # one degradation-ladder observation an emitted segment, on
            # the engine's side: did the engine wait on the sink since the
            # last emit (a full queue at push, or the window parked in the
            # sink's backlog), and is accounted loss happening?  The level
            # rides with the item
            level = 0
            if self._ladder is not None:
                if not real_time:
                    occupancy = 0.0
                elif sink_wait[0]:
                    occupancy = 1.0
                else:
                    occupancy = (q_sink.qsize() / window
                                 if sink_pipe is not None else 0.0)
                sink_wait[0] = False
                level = self._ladder.observe(
                    occupancy,
                    metrics.window("segments_dropped").sum() > 0)
                stats.extras["degrade_levels"].append(level)
            fetched = fetched._replace(degrade_level=level,
                                       sinks_done=set())
            if sink_pipe is None:
                try:
                    drain_inline(fetched)
                finally:
                    live_add(-1)
                return True
            return push_sink(fetched)

        pending: deque[InFlight] = deque()
        it = iter(self.source)
        dispatched = [0]
        exhausted = [False]

        def want_more() -> bool:
            return not exhausted[0] and (max_segments is None
                                         or dispatched[0] < max_segments)

        def ingest_one(index: int):
            """One read (the ``ingest`` site): the segment, the source's
            offset after it and the read's seconds, or None at the
            source's end (that last read is not an ``ingest`` stage).
            The segment's trace id is stamped here."""
            t0 = time.perf_counter()
            with trace_annotation("srtb:ingest"):
                seg = self._op("ingest", index, lambda: next(it, None))
            dt = time.perf_counter() - t0
            stage_s["read"] += dt
            if seg is None:
                exhausted[0] = True
                return None
            self.stage_timer.record("ingest", dt)
            ev = self.events
            if ev is not None:
                tid = getattr(seg, "trace_id", 0)
                if not tid:
                    tid = events.next_trace_id()
                    try:
                        seg.trace_id = tid
                    except AttributeError:  # a read-only stub segment
                        pass
                events.set_current(tid, self.stream)
                ev.emit("stage.ingest", trace=tid, stream=self.stream,
                        seg=index, dur=dt)
            return seg, getattr(self.source, "logical_offset", 0), dt

        # the dispatch unit follows the healer: the micro_batch rung
        # drops it to 1, a promotion restores it
        def cur_unit() -> int:
            if self.healer is not None:
                return min(window, self.healer.micro_batch)
            return batch

        # ---- the healer's handlers, reached only from exceptions

        def reinit_and_redispatch(exc) -> bool:
            """A halt: a processor rebuilt at the current rung, and every
            in-flight segment re-dispatched cold from its pinned buffer,
            in dispatch order."""
            newp = self.healer.reinit(exc)
            if newp is None:
                return False
            self._swap_processor(newp)
            for i in range(len(pending)):
                old = pending[i]
                self._keep_if_halted(old)
                pending[i] = dispatch_one(old.seg, old.offset_after,
                                          old.index, requeue=True,
                                          ingest_s=old.ingest_s)
            return True

        def heal(exc) -> bool:
            """True when a device fault was recovered (the processor may
            have been swapped); False propagates the original failure (not
            a device fault, or healing off); a spent budget raises the
            typed FATAL escalation."""
            h = self.healer
            if h is None:
                return False
            kind = h.classify(exc)
            if kind is None:
                return False

            def settle(e, kind) -> None:
                events.emit("fault.device",
                            info=f"{kind}:{type(e).__name__}")
                # no rung stands in for a kernel of the port that fails
                own = kernel_fault(e)
                if own is not None:
                    raise own from e
                # an out-of-memory's or a build fault's failed chain: free
                # what its frames hold before a new rung allocates (the
                # traceback stays printable); a halt's: hold it (the
                # context may be dead, see _halted)
                if kind == DEVICE_HALT:
                    if self._halted is None:
                        self._halted = []
                    self._halted.append(e)
                else:
                    traceback.clear_frames(e.__traceback__)
            settle(exc, kind)
            while True:
                # a rebuild (or a re-dispatch) that fails the same way is
                # one more reinit or demotion: on a dead CUDA context the
                # reinit budget runs out, and the run escalates
                try:
                    if kind == DEVICE_HALT:
                        if reinit_and_redispatch(exc):
                            return True
                        raise ReinitBudgetExceeded(
                            "device halt beyond reinit recovery "
                            "(device_reinit_max budget spent or "
                            f"disabled): {exc}") from exc
                    newp = h.demote(exc, kind)
                    if newp is None:
                        raise LadderExhausted(
                            "device fault survived every demotion rung: "
                            f"{exc}") from exc
                    self._swap_processor(newp)
                    return True
                except (ReinitBudgetExceeded, LadderExhausted):
                    raise
                except BaseException as e:  # noqa: BLE001 - classified
                    again = h.classify(e)
                    if again is None:
                        raise
                    settle(e, again)
                    exc, kind = e, again

        def guarded(fn):
            """``fn()``, or the failure it raised (the caller heals it
            after leaving the ``except`` block, so the failed chain's
            frames are gone before a new rung allocates)."""
            try:
                return fn(), None
            except BaseException as e:  # noqa: BLE001 - classified
                return None, e

        def dispatch_one(seg, offset_after, index, requeue=False,
                         ingest_s=0.0):
            """One dispatch with self-healing: a device fault demotes or
            reinitializes and re-dispatches the same segment cold."""
            while True:
                item, err = guarded(lambda: self._dispatch_segment(
                    seg, offset_after, index, requeue=requeue))
                if err is None:
                    return item._replace(ingest_s=ingest_s)
                if not heal(err):
                    raise err
                err = None
                requeue = True

        def maybe_promote() -> None:
            h = self.healer
            if h is not None and h.promote_due():
                newp = h.promote()
                if newp is not None:
                    self._swap_processor(newp)

        def fill_window() -> None:
            if self.profile_capture is not None:
                # a capture the sink thread completed stops here
                self.profile_capture.poll()
            # the unit is the batch: admitted only when all of it fits
            while live_count() + cur_unit() <= window and want_more() \
                    and sink_alive():
                maybe_promote()
                b = cur_unit()
                if live_count() + b > window:
                    return  # a promotion restored a unit that no longer fits
                first = dispatched[0]
                budget = b if max_segments is None else \
                    min(b, max_segments - first)
                got = []
                while len(got) < budget:
                    one = ingest_one(first + len(got))
                    if one is None:
                        break
                    got.append(one)
                if not got:
                    return
                if b > 1 and len(got) == b:
                    segs, offsets, ingests = map(list, zip(*got))
                    items, err = guarded(lambda: self._dispatch_batch(
                        segs, offsets, first, ingests))
                    if err is not None:
                        if not heal(err):
                            raise err
                        err = None
                        # the healed plan may not batch: these segments
                        # finish as single cold dispatches
                        items = [dispatch_one(seg, off, first + i,
                                              requeue=True, ingest_s=ing)
                                 for i, (seg, off, ing) in enumerate(got)]
                        stats.extras["dispatches"] += len(items)
                    else:
                        stats.extras["dispatches"] += 1
                else:  # one segment, or a tail shorter than the batch
                    items = [dispatch_one(seg, off, first + i,
                                          ingest_s=ing)
                             for i, (seg, off, ing) in enumerate(got)]
                    stats.extras["dispatches"] += len(items)
                pending.extend(items)
                live_add(len(items))
                dispatched[0] += len(items)
                stats.segments += len(items)
                stats.samples += n_samples * len(items)

        requeue_counts: dict[int, int] = {}

        def watchdog_wait() -> bool:
            """The segment watchdog: poll the drain head's readiness up
            to the deadline, counted from when the engine starts waiting
            on it; on expiry re-dispatch it cold from its pinned buffer
            (the card cannot cancel the enqueued chain, so the requeue
            runs behind it), up to ``segment_watchdog_requeues`` times,
            then escalate.  False when the sink died while waiting."""
            item = pending[0]
            waited_since = time.perf_counter()
            while not self._ready(item):
                if not sink_alive() or stop.stop_requested:
                    return False
                if time.perf_counter() - waited_since >= deadline_s:
                    index = item.index
                    used = requeue_counts.get(index, 0)
                    tid = getattr(item.seg, "trace_id", 0)
                    if used >= watchdog_max:
                        events.emit("watchdog.escalate", trace=tid,
                                    stream=self.stream, seg=index,
                                    info=f"requeues={used}")
                        raise WatchdogEscalation(
                            f"segment {index} fetch still not ready "
                            f"after {deadline_s:g}s at the drain head "
                            f"and {used} requeue(s): device wedged")
                    requeue_counts[index] = used + 1
                    metrics.add("watchdog_requeues")
                    events.emit("watchdog.requeue", trace=tid,
                                stream=self.stream, seg=index,
                                info=f"attempt={used + 1}")
                    log.warning(
                        f"[watchdog] segment {index} in-flight past "
                        f"{deadline_s:g}s (fetch never ready): "
                        f"re-dispatching ({used + 1}/{watchdog_max})")
                    self._ring_invalidate()
                    pending[0] = None
                    item = dispatch_one(item.seg, item.offset_after, index,
                                        requeue=True, ingest_s=item.ingest_s)
                    pending[0] = item
                    waited_since = time.perf_counter()
                else:
                    time.sleep(min(0.005, deadline_s / 20))
            return True

        def drain_oldest() -> bool:
            if watchdog and not watchdog_wait():
                return False
            # the depths at this drain, this item included: dispatched
            # and not fetched, and dispatched and not through its sink
            depth, live_now = len(pending), live_count()
            item = pending.popleft()
            while True:
                fetched, err = guarded(lambda: self._fetch_inflight(
                    item, depth, live_now))
                if err is None:
                    break
                if not heal(err):
                    raise err
                err = None
                # the faulted segment's results died with the fault: re-
                # dispatch it cold under the (demoted or rebuilt) plan
                seg, off, idx = item.seg, item.offset_after, item.index
                ing = item.ingest_s
                item = None
                item = dispatch_one(seg, off, idx, requeue=True, ingest_s=ing)
            h = self.healer
            if h is not None:
                h.note_healthy()
            return emit(fetched)

        # the watchdog's state for a fully parked window: [since, progress]
        parked = [None, (drained[0], self._sink_heartbeat)]

        def shed_ingest() -> bool:
            """A wedged sink with the whole window parked: keep draining
            the source, each undispatched segment accounted as loss (it
            still takes its dispatch index).  False: the source is
            done."""
            one = ingest_one(dispatched[0])
            if one is None:
                return False
            dispatched[0] += 1
            log.error("[watchdog] sink wedged with a full in-flight "
                      "window: shedding ingested segment as accounted "
                      "loss")
            events.emit("shed.ingest", trace=getattr(one[0], "trace_id", 0),
                        stream=self.stream, seg=dispatched[0] - 1)
            shed_segment(one[0], in_flight=False)
            return True

        sink_wedged = False
        try:
            while sink_alive():
                fill_window()
                if not pending:
                    if not want_more():
                        break
                    if live_count() == 0:
                        # the sink freed the whole window after
                        # fill_window looked (the reference ends its run
                        # here, segments unread): fill it again
                        continue
                    if sink_alive():
                        # the whole window waits in the sink's backlog
                        sink_wait[0] = True
                        if watchdog and real_time:
                            now = time.perf_counter()
                            cur = (drained[0], self._sink_heartbeat)
                            if parked[0] is None or cur != parked[1]:
                                parked[0], parked[1] = now, cur
                            elif now - parked[0] > deadline_s:
                                if not shed_ingest():
                                    break
                                continue
                        time.sleep(0.002)
                    continue
                parked[0] = None
                # everything already complete goes to the sinks, in order
                while pending and sink_alive() and self._ready(pending[0]):
                    if not drain_oldest():
                        break
                if not pending:
                    continue
                # no room for the next unit (or source done): block on
                # the oldest
                if live_count() + cur_unit() > window or not want_more():
                    if not drain_oldest():
                        break
            while pending and sink_alive():
                if not drain_oldest():
                    break
        except BaseException:
            unwinding[0] = True
            raise
        finally:
            if sink_pipe is not None:
                sink_wedged = self._stop_sink(
                    sink_pipe, q_sink, sink_alive, stop, current, progress,
                    drained, shed_segment, live_add)
                stop.request_stop()
            metrics.set("inflight_depth", 0)
            self._ring_invalidate()
            if self.profile_capture is not None:
                # a run shorter than N segments, or one that raised,
                # still writes a valid trace
                self.profile_capture.stop()
        if sink_pipe is not None and sink_pipe.exception is not None:
            raise sink_pipe.exception
        if sink_wedged:
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

    def _stop_sink(self, sink_pipe, q_sink, sink_alive, stop, current,
                   progress, drained, shed_segment, live_add) -> bool:
        """End the sink pipe: the sentinel after every queued item, then
        a join bounded by ``shutdown_join_timeout_s`` (0: wait for it).
        A sink still alive then is reported with its stack, its queued
        items and the item it holds (if not yet accounted) are counted
        as dropped, ``close()`` will not wait on its writes, and True is
        returned."""
        join_s = float(self.cfg.shutdown_join_timeout_s or 0)
        t0 = time.perf_counter()
        while not q_sink.push_lossy(fw.SENTINEL):
            if not sink_alive() or stop.stop_requested or (
                    join_s > 0 and time.perf_counter() - t0 > join_s):
                break
            time.sleep(0.002)
        if sink_pipe.join(join_s if join_s > 0 else None):
            return False
        self._sink_wedged = True
        termination.report_wedged(
            [sink_pipe.thread],
            f"pipeline shutdown ({join_s:g}s join timeout)")
        while True:
            leftover = q_sink.try_pop()
            if leftover is None:
                break
            if leftover is not fw.SENTINEL:
                shed_segment(leftover.seg, in_flight=True)
        held = current[0]
        if held is not None and held is not fw.SENTINEL:
            with self._handoff_lock:
                if drained[0] == progress[0]:
                    held.sinks_done.add("abandoned")
                    self._account_dropped(
                        trace=getattr(held.seg, "trace_id", 0))
                    live_add(-1)
        log.error("[pipeline] wedged sink: still-queued segments "
                  "accounted as segments_dropped")
        return True

    def close(self) -> None:
        """Release the run's resources: the source, the writer pool the
        pipeline owns (abandoned, not drained, after a wedged sink), the
        run manifest, the write-all file and the pinned segment buffers;
        close the journal and write the flight recorder's dump
        (``events_dump_path``: the last ``events_ring_size`` events a
        thread), also after a run that raised."""
        if self.profile_capture is not None:
            self.profile_capture.stop()
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
        pool = getattr(self.source, "pool", None)
        if pool is not None:
            pool.free_all()
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        dump_path = self.cfg.events_dump_path
        if dump_path and self.events is not None:
            try:
                n = self.events.dump_jsonl(dump_path)
                log.info(f"[events] {n} flight-recorder events -> "
                         f"{dump_path}")
            except OSError as e:
                log.warning(f"[events] dump to {dump_path} failed: {e}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DMSearchPipeline:
    """The streaming DM search (the reference's ``DMSearchPipeline``):
    every segment runs the DM-trial step (``parallel/segment_dist.py``)
    over the trial list ``cfg.dm_list``; each segment's per-trial
    summaries are appended to ``<prefix>dm_trials.jsonl`` as the
    reference's record (the same keys in the same order), the best
    trial of a positive segment is logged, and the segment counts in the
    metrics registry and stamps ``/healthz``'s liveness.  The segments
    come from ``source`` (any source ``tools/main.make_source`` gives) or
    the configured input file.  One segment at a time: its bytes uploaded
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
                metrics.add("segments")
                metrics.add("samples", cfg.baseband_input_count)
                metrics.window("segments").add(1)
                metrics.window("samples").add(cfg.baseband_input_count)
                telemetry.mark_segment()  # /healthz liveness
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
