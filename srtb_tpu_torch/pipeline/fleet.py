"""Multi-tenant stream fleet: N concurrent streams on a device pool (port
of ``srtb_tpu/pipeline/fleet.py``).

One engine serves many concurrent beams and replay jobs from one card (a
multibeam receiver's beams, a survey's archive replayed beside a live
beam):

- **Round-robin scheduler**: one scheduler thread multiplexes every
  admitted stream's in-flight window onto the card's one compute stream
  (the scheduler thread's current stream, as the engine's).  Each
  :class:`_StreamLane` is a cooperative state machine (``step()``) over
  the engine's own building blocks (the window refill's ``_next_unit``
  and ``_dispatch_unit``, ``Pipeline._dispatch_healed``,
  ``_fetch_healed``, ``_drain_body``, ``_keep_if_dead``, ``_heal``), so a
  lane's outputs are a solo run's, byte for byte, and C8's rules (the
  items' ``hold``, the deferred frees, the halt holder) are the engine's
  own code.
- **Shared plan cache** (:class:`SharedPlanCache`): streams whose
  trace-relevant config projects identically
  (``SegmentProcessor.plan_cache_key``) share ONE ``SegmentProcessor``;
  the second stream of a family builds nothing.  Shared processors are
  ``mark_shared()``-ed, so a lane's demotion never retires what its
  neighbors dispatch through.
- **Cross-stream batching** (:class:`_BatchFormer`,
  ``Config.fleet_batch_max >= 2`` on the fleet's config): ready segments
  of lanes that share a plan family go to the card as ONE dispatch
  (``SegmentProcessor.stack_batch`` + ``process_batch`` /
  ``process_batch_cold``), each member's results scattered back to its
  lane's window.  A partial batch flushes after
  ``fleet_batch_linger_ms`` or when the scheduler goes idle; fill is
  priority-ordered; a ragged tail of one rides the lane's solo dispatch.
  The port's batch runs the chain a lane at a time, so a batched lane's
  bits are a solo dispatch's (the reference's vmap reassociates floats,
  within its documented tolerance).
- **Per-stream bulkheads**: every lane owns its own ``Pipeline`` (healer
  position, degradation ladder, retry policy, stream-scoped fault plan,
  sink supervisor, ring carry, checkpoint, journal, manifest, pinned
  ``BufferPool`` and writers); a fault on stream A demotes, sheds or
  rolls back A only.
- **Admission and priority shedding**: ``resilience/admission.py`` gates
  stream starts (``fleet_max_streams`` / ``fleet_queue_limit``, priority
  order), and under fleet-wide sink pressure
  ``resilience/degrade.FleetShedPolicy`` force-sheds the lowest-priority
  real-time stream first.
- **Device pool and live migration** (``fleet_devices``,
  ``pipeline/pool.py``, ``pipeline/placement.py``): a halted member
  drains its lanes onto survivors and only ITS plan cache is retired;
  ``migrate_on_burn`` rebalances a burning-SLO stream; ``rolling_restart``
  drains members one at a time.  On one card the pool has one member
  (``fleet_devices`` is capped at the card count), so migration runs on
  the CPU's virtual pool.

A device halt with no peer is the fleet's one shared failure domain: one
budgeted reinit, every lane's window re-dispatched cold.  That serves the
tagged, injected ``DeviceHalt`` and the pool's virtual halts.  A REAL
sticky CUDA fault cannot be reinitialized in process: the fleet finds the
context dead, the faulting lane escalates as the solo engine does
(``ReinitBudgetExceeded`` with one incident bundle) and ``run()`` raises
it, so the other lanes are never restarted on a dead context; the next
process resumes from each stream's checkpoint.

Limits (the reference's, enforced loudly): real-time lanes dispatch one
segment at a time (``micro_batch_segments > 1`` is refused there; file
lanes may micro-batch); ``Config.sanitize`` is refused inside a fleet.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.pipeline import framework as fw
from srtb_tpu_torch.pipeline import placement
from srtb_tpu_torch.pipeline.pool import (STATE_DRAINING, STATE_HALTED,
                                          STATE_OK, DevicePool, PoolDevice)
from srtb_tpu_torch.pipeline.runtime import (InFlight, Pipeline,
                                             PipelineStats,
                                             counters_snapshot)
from srtb_tpu_torch.resilience.admission import (ADMIT, QUEUE,
                                                 AdmissionController)
from srtb_tpu_torch.resilience.degrade import FleetShedPolicy
from srtb_tpu_torch.resilience.errors import DEVICE_HALT
from srtb_tpu_torch.resilience.supervisor import Supervisor
from srtb_tpu_torch.utils import events, telemetry
from srtb_tpu_torch.utils.device import resolve_device
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics
from srtb_tpu_torch.utils.tracing import trace_annotation


@dataclass
class StreamSpec:
    """One stream handed to the fleet.  ``cfg`` is the stream's own
    config: its paths (output prefix, checkpoint, manifest, journal) are
    its bulkhead namespace; trace-relevant fields equal to another
    stream's share that stream's processor."""
    name: str
    cfg: Config
    source: Any = None
    sinks: Any = None
    keep_waterfall: bool = True
    max_segments: int | None = None
    # explicit pool placement (None = the placement policy decides),
    # checked before any pipeline state is built
    pin_device: int | None = None

    @property
    def priority(self) -> int:
        return int(getattr(self.cfg, "stream_priority", 0) or 0)


@dataclass
class StreamResult:
    """One stream's outcome of a fleet run."""
    name: str
    status: str                  # done | failed | rejected
    stats: PipelineStats | None = None
    error: BaseException | None = None
    drained: int = 0
    dropped: int = 0
    extras: dict = field(default_factory=dict)


class SharedPlanCache:
    """One processor a plan family, shared by every stream whose
    trace-relevant config projects identically.  ``compiles`` counts
    processor builds (one a family), ``hits`` streams served an existing
    one.  Each pool member owns one cache (``device`` labels its metric
    twins, ``torch_device`` is where its processors run), so a scoped
    halt retires exactly one cache."""

    def __init__(self, device: str | None = None,
                 torch_device: torch.device | None = None):
        self._by_key: dict[str, Any] = {}
        self.compiles = 0
        self.hits = 0
        self.device = device
        self.torch_device = torch_device

    def get(self, cfg: Config):
        from srtb_tpu_torch.pipeline import registry
        key = registry.plan_cache_key(cfg)
        lbl = ({"stream": cfg.stream_name}
               if getattr(cfg, "stream_name", "") else None)
        proc = self._by_key.get(key)
        if proc is None:
            proc = registry.build_processor(
                cfg, device=self.torch_device).mark_shared()
            self._by_key[key] = proc
            self.compiles += 1
            counter = "fleet_plan_compiles"
            log.info(f"[fleet] plan cache MISS: built shared plan "
                     f"{proc.plan_name} ({self.compiles} families"
                     + (f" on {self.device}" if self.device else "")
                     + ")")
        else:
            self.hits += 1
            counter = "fleet_plan_cache_hits"
        metrics.add(counter)
        if lbl is not None:
            metrics.add(counter, labels=lbl)
        if self.device is not None:
            metrics.add(counter, labels={"device": self.device})
        return proc

    def invalidate(self) -> None:
        """Retire every shared processor (forced past the shared guard)
        and forget it: the next ``get`` rebuilds."""
        for proc in self._by_key.values():
            proc.retire(force=True)
        self._by_key.clear()


class _BatchSlot:
    """One lane's reservation in a forming cross-stream batch.  It sits
    in the lane's ``pending`` deque at its dispatch-order position,
    holding the read segment host-side until the former dispatches it,
    then the :class:`InFlight` item (``item``), so drain order,
    checkpoint offsets and journal order are a solo dispatch's.  A
    dispatch failure lands on ``error`` and raises inside the OWNING
    lane's step (the bulkhead)."""

    __slots__ = ("lane", "seg", "ingest_s", "offset_after", "index",
                 "t_offer", "item", "error", "cancelled")

    def __init__(self, lane: "_StreamLane", seg, ingest_s: float,
                 offset_after: int, index: int):
        self.lane = lane
        self.seg = seg
        self.ingest_s = ingest_s
        self.offset_after = offset_after
        self.index = index
        self.t_offer = time.perf_counter()
        self.item: InFlight | None = None
        self.error: BaseException | None = None
        # withdrawn by its lane (a fleet reinit, a teardown): skipped
        self.cancelled = False


class _BatchFormer:
    """Cross-stream batching: collect ready segments of lanes that share
    a plan family (the same shared processor, grouped by identity) and
    dispatch them as ONE call, each member's results back to its lane.

    A family flushes the moment it holds ``fleet_batch_max`` live offers;
    a partial family when its oldest offer has lingered past
    ``fleet_batch_linger_ms`` or when the scheduler goes idle.  Fill is
    priority-ordered (``stream_priority`` desc, offer age asc).  A batch
    spans at least TWO lanes: a ragged tail of one, or a chunk drawn from
    one lane's own window, goes through that lane's solo dispatch (its
    ring carry stays warm).  Eligibility is checked against the lane's
    CURRENT processor and member state, so a demoted or migrated lane
    leaves its group by construction."""

    def __init__(self, fleet: "StreamFleet", batch_max: int,
                 linger_s: float):
        self.fleet = fleet
        self.batch_max = max(2, int(batch_max))
        self.linger_s = max(0.0, float(linger_s))
        # id(shared processor) -> (processor, offers); the processor rides
        # along so an id is never recycled under a live group
        self._groups: dict[int, tuple] = {}

    # ------------------------------------------------------ membership

    def eligible(self, lane: "_StreamLane") -> bool:
        """May this lane's next segment join a batch?  Its processor must
        be a shared one (a demotion swaps in an unshared one), not staged
        (the staged plan refuses batches), the lane's unit 1, and its
        member healthy."""
        proc = lane.pipe.processor
        return (getattr(proc, "_fleet_shared", False)
                and not getattr(proc, "staged", False)
                and lane._unit() == 1
                and lane.device.state == STATE_OK)

    def offer(self, lane: "_StreamLane", one: tuple,
              index: int) -> _BatchSlot:
        """Park one read segment ``(seg, offset_after, ingest_s)`` in its
        family's forming batch; returns the slot the lane appends to
        ``pending``.  Reaching ``batch_max`` flushes the family now."""
        seg, offset_after, ingest_s = one
        slot = _BatchSlot(lane, seg, ingest_s, offset_after, index)
        proc = lane.pipe.processor
        key = id(proc)
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = (proc, [])
        group[1].append(slot)
        if sum(1 for s in group[1] if not s.cancelled) >= self.batch_max:
            self._flush(key)
        return slot

    def pump(self) -> bool:
        """The linger check, paced by the scheduler: flush every family
        whose oldest live offer waited past the deadline.  True when
        anything dispatched."""
        now = time.perf_counter()
        flushed = False
        for key in list(self._groups):
            slots = [s for s in self._groups[key][1] if not s.cancelled]
            if not slots:
                del self._groups[key]
                continue
            if now - min(s.t_offer for s in slots) >= self.linger_s:
                self._flush(key)
                flushed = True
        return flushed

    def flush_all(self) -> bool:
        """Idle-scheduler flush: nothing else can progress, so every
        pending offer dispatches now."""
        flushed = False
        for key in list(self._groups):
            if any(not s.cancelled for s in self._groups[key][1]):
                self._flush(key)
                flushed = True
            else:
                del self._groups[key]
        return flushed

    def flush_lane(self, lane: "_StreamLane") -> None:
        """Flush the family holding this lane's offers (a blocking drain
        granted to a lane whose head still sits in the former)."""
        for key, (_proc, slots) in list(self._groups.items()):
            if any(s.lane is lane and not s.cancelled for s in slots):
                self._flush(key)

    def drop_lane(self, lane: "_StreamLane") -> None:
        """Withdraw a failing lane's offers (its teardown accounts them)."""
        for key in list(self._groups):
            _proc, slots = self._groups[key]
            for s in slots:
                if s.lane is lane:
                    s.cancelled = True
            if all(s.cancelled for s in slots):
                del self._groups[key]

    def reset(self) -> None:
        """Fleet-wide reinit: every offer was re-dispatched cold (and
        cancelled) by its lane, so the forming state is forgotten."""
        self._groups.clear()

    # -------------------------------------------------------- dispatch

    def _flush(self, key: int) -> None:
        proc, slots = self._groups.pop(key)
        live = [s for s in slots if not s.cancelled]
        live.sort(key=lambda s: (-s.lane.priority, s.t_offer, s.lane.name))
        while live:
            take, live = live[:self.batch_max], live[self.batch_max:]
            if len({id(s.lane) for s in take}) >= 2:
                self._dispatch_shared(proc, take)
            else:
                # cross-stream batches only: one lane's chunk goes solo
                for s in take:
                    if not s.cancelled and s.item is None \
                            and s.error is None:
                        self._single_fallback(s)

    @staticmethod
    def _single_fallback(slot: _BatchSlot, requeue: bool = False) -> None:
        """Dispatch one member through its lane's solo path (the whole
        fault, retry and heal machinery); a failure after healing lands
        on the slot for the owning lane's step to raise."""
        try:
            slot.item = slot.lane._dispatch(
                slot.seg, slot.ingest_s, slot.offset_after, slot.index,
                requeue=requeue)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 - member-contained
            slot.error = e

    def _member_fault(self, slot: _BatchSlot, exc: BaseException) -> None:
        """A member's own scheduled dispatch fault fired during formation:
        heal with the lane's blast-radius rules (a device fault demotes
        THIS lane, whose swap drops it from the group), then dispatch its
        segment solo; a transient or data-loss fault's solo dispatch is
        its retry (the one-shot fault is consumed)."""
        try:
            healed = slot.lane._heal(exc)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e2:  # noqa: BLE001 - member-contained
            slot.error = e2
            return
        if slot.cancelled:
            # the heal went through the fleet-wide reinit, which already
            # re-dispatched this slot's segment cold
            return
        if healed:
            self._single_fallback(slot, requeue=True)
            return
        from srtb_tpu_torch.resilience.errors import (DATA_LOSS, TRANSIENT,
                                                      classify)
        if slot.lane.pipe.retry is not None and \
                classify(exc) in (TRANSIENT, DATA_LOSS):
            self._single_fallback(slot)
        else:
            slot.error = exc

    def _dispatch_shared(self, proc, slots: list) -> None:
        """One dispatch for B members of (possibly) B lanes: their bytes
        uploaded into one ``[B, bytes]`` tensor, the chain a member at a
        time on the compute stream, the results' copies to pinned host
        memory and one ``done`` event, each member's results its own
        :class:`InFlight` in its lane's window (the cross-stream twin of
        ``Pipeline._dispatch_batch``).  A ring carry belongs to ONE
        lane's chain, which a cross-stream batch never is: with any
        member's ring live every member's carry is dropped and the cold
        batch plan runs."""
        t0 = time.perf_counter()
        live = []
        for slot in slots:
            lane = slot.lane
            lane.pipe._canary_prepare(slot.seg, slot.index)
            faults = lane.pipe.faults
            if faults is not None and faults.armed("dispatch"):
                # the member's scheduled dispatch fault fires against ITS
                # index before the shared call, its consequences its own
                try:
                    faults.fire("dispatch", slot.index)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as e:  # noqa: BLE001 - classified
                    self._member_fault(slot, e)
                    continue
            live.append(slot)
        untouched = [s for s in live if not s.cancelled and s.item is None
                     and s.error is None]
        # a member whose lane migrated or healed since its offer, or whose
        # member left the OK state, never rides this family's dispatch
        stale = [s for s in untouched
                 if s.lane.pipe.processor is not proc
                 or s.lane.device.state != STATE_OK]
        live = [s for s in untouched if s not in stale]
        for s in stale:
            metrics.add("fleet_batch_device_guard")
            log.warning(f"[fleet:{s.lane.name}] batch offer left behind "
                        "by a migration/heal: dispatching solo")
            self._single_fallback(s, requeue=True)
        if not live:
            return
        if len({id(s.lane) for s in live}) < 2:
            for s in live:
                self._single_fallback(s)
            return
        # one formed batch is one dispatch on the family's member (no
        # virtual halt fires inside it: halts fire at solo boundaries)
        live[0].lane.device.note_dispatch(check=False)
        pipe0 = live[0].lane.pipe
        h2d0 = proc.h2d_bytes
        try:
            with trace_annotation("srtb:dispatch"):
                stacked = proc.stack_batch([s.seg.data for s in live])
                for i, s in enumerate(live):
                    s.lane.pipe._canary_inject(s.seg, stacked[i])
                if any(s.lane.pipe._ring_carry is not None for s in live):
                    for s in live:
                        s.lane.pipe._ring_invalidate()
                    lanes, _carry = proc.process_batch_cold(stacked)
                else:
                    lanes = proc.process_batch(stacked)
            dets, done = pipe0._to_host([det for _wf, det in lanes])
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 - classified per lane
            # whole-batch failure: every member falls back to its solo
            # path, where its own healer classifies the fault
            log.warning(f"[fleet] batched dispatch of {len(live)} "
                        f"segments failed ({type(e).__name__}); falling "
                        f"back to solo dispatches: {e!r}")
            for s in live:
                if not s.cancelled and s.item is None:
                    self._single_fallback(s, requeue=True)
            return
        t1 = time.perf_counter()
        b = len(live)
        per_seg = (t1 - t0) / b
        h2d_each = (proc.h2d_bytes - h2d0) // b
        metrics.add("batched_dispatches")
        metrics.histogram("batch_size",
                          buckets=(1.0, 2.0, 4.0, 8.0, 16.0)).observe(b)
        for slot, (wf, _det), det in zip(live, lanes, dets):
            lane = slot.lane
            seg = slot.seg
            lane.pipe._last_done = done
            lane.pipe.stage_timer.record("dispatch", per_seg)
            lane.pipe.stats.extras["dispatches"] += 1
            metrics.add("batched_segments")
            metrics.add("batched_segments", labels={"stream": lane.name})
            try:
                # journaled by _record_segment (span v10); never on a
                # solo dispatch
                seg.batch_size = b
                seg.batch_wait_s = max(0.0, t0 - slot.t_offer)
            except AttributeError:  # a read-only stub segment
                pass
            if lane.pipe.events is not None:
                lane.pipe.events.emit(
                    "stage.dispatch", trace=getattr(seg, "trace_id", 0),
                    stream=lane.name, seg=slot.index, dur=per_seg,
                    info=f"fleet_batch={b}")
            slot.item = InFlight(seg, wf, det, done, t1, per_seg, h2d_each,
                                 slot.offset_after, slot.index,
                                 slot.ingest_s, (stacked,))


class _StreamLane:
    """One admitted stream's cooperative engine: a step()-driven in-flight
    window over the lane's own Pipeline, with its sink work on a pipe
    thread of its own (a wedged or crashed sink stalls or sheds THIS lane
    only)."""

    def __init__(self, fleet: "StreamFleet", spec: StreamSpec):
        cfg = spec.cfg
        real_time = not cfg.input_file_path
        mb = int(getattr(cfg, "micro_batch_segments", 1) or 1)
        if mb > 1 and real_time:
            raise ValueError(
                f"stream {spec.name!r}: micro_batch_segments > 1 is "
                "only supported on file-mode (non-real-time) fleet "
                "lanes (use the solo engine for a batched live stream)")
        if getattr(cfg, "sanitize", False):
            raise ValueError(
                f"stream {spec.name!r}: Config.sanitize is incompatible "
                "with fleet scheduling (single-engine thread-ownership "
                "guards)")
        # every check that can fail on the config alone comes before the
        # Pipeline is built, so a refused lane leaks no opened file,
        # checkpoint, manifest or journal
        self.window = max(1, int(getattr(cfg, "inflight_segments", 2) or 1))
        self.micro_batch = mb
        if mb > self.window:
            raise ValueError(
                f"stream {spec.name!r}: micro_batch_segments={mb} exceeds "
                f"inflight_segments={self.window}: a batch dispatch must "
                "fit the lane's in-flight window")
        if mb > 1:
            from srtb_tpu_torch.pipeline.segment import staged_resolves
            if staged_resolves(cfg):
                raise ValueError(
                    f"stream {spec.name!r}: micro_batch_segments > 1 "
                    "requires the fused plan (staged segments are already "
                    "dispatch-amortized)")
        self.fleet = fleet
        self.spec = spec
        self.name = spec.name
        self.priority = spec.priority
        # placement before the Pipeline (a bad pin fails on the config),
        # and the shared plan from THAT member's cache
        self.device: PoolDevice = fleet._place(spec)
        self.migrations = 0
        self._migrated_t = 0.0
        # False between a migration and the lane's first dispatch on its
        # new member: the rolling restart waits for every migrant
        self._resumed = True
        self.pipe = Pipeline(cfg, source=spec.source, sinks=spec.sinks,
                             keep_waterfall=spec.keep_waterfall,
                             processor=self.device.plans.get(cfg))
        self.pipe.device_label = self.device.label
        self.real_time = real_time
        self.max_segments = spec.max_segments
        self.deadline_s = float(cfg.segment_deadline_s or 0.0)
        self.join_s = float(getattr(cfg, "shutdown_join_timeout_s", 0) or 0)
        self.pending: collections.deque = collections.deque()
        self._it = iter(self.pipe.source)
        self.dispatched = 0
        self.exhausted = False
        self.drained = self.pipe._begin_run(self.window, mb)
        self._drained0 = self.drained[0]
        self.done = False
        self.status = "running"
        self.error: BaseException | None = None
        self.forced_shed = False
        # waited on its sink since the fleet's last fairness observation
        self.sink_wait = False
        self._emitted_since_obs = 0
        # a fetched item awaiting sink-queue space
        self._staged_emit = None
        self._wedge_t0 = None
        self._wedge_mark = None
        self._park_t0 = None
        self._park_mark = None
        # lane-local loss recency (the engine's 10 s loss window, scoped
        # to this stream's labeled counter)
        self._loss_seen = 0.0
        self._loss_t = None
        self._sentinel_t0 = None
        self._t_start = time.perf_counter()
        self._t_close = None
        # dispatched-through-sink count, written by the scheduler thread
        # and the lane's sink thread
        self._live_lock = threading.Lock()
        self._live = 0
        self._stop = fw.StopToken()
        self._q_sink = fw.WorkQueue(capacity=self.window)
        self._current = [None]
        self._progress = [self.drained[0]]
        self._supervisor = None
        if int(getattr(cfg, "supervisor_max_restarts", 0)) > 0:
            self._supervisor = Supervisor(
                f"sink_drain_{self.name}",
                max_restarts=cfg.supervisor_max_restarts,
                window_s=getattr(cfg, "supervisor_window_s", 60.0))
        self._sink_pipe = fw.start_pipe(
            self._sink_f, self._q_sink, None, self._stop,
            f"sink_drain:{self.name}", on_done=fleet._notify)
        telemetry.register_stream(self.name)

    # ------------------------------------------------------ accounting

    def _live_add(self, n: int) -> None:
        with self._live_lock:
            self._live += n
            metrics.set("inflight_depth", self._live,
                        labels={"stream": self.name})

    def _live_count(self) -> int:
        with self._live_lock:
            return self._live

    # ------------------------------------------------------- sink side

    def _sink_f(self, _stop, item):
        self._current[0] = item
        self._progress[0] = self.drained[0]
        try:
            self.pipe._drain_body(item, self.drained)
        finally:
            if "abandoned" not in item.sinks_done:
                self._live_add(-1)
            # as the engine's sink worker does before it drops one
            self.pipe._keep_if_dead(item)
            # the drain freed window space the scheduler may wait on
            self.fleet._notify()
        self._current[0] = None

    def _sink_alive(self) -> bool:
        """True while this lane's sink side can make progress; restarts a
        supervised crashed pipe, its unaccounted item replayed inline
        first (journal order kept, as the engine's)."""
        if self._sink_pipe.exception is None:
            return True
        exc = self._sink_pipe.exception
        if self._supervisor is None or \
                not self._supervisor.should_restart(exc):
            return False
        h = self.pipe.healer
        if h is not None and h.classify(exc) == DEVICE_HALT:
            # the sink's copies run on the card: a halt can reach the sink
            # first, and is healed as the engine's own
            self._heal(exc)
        failed, self._current[0] = self._current[0], None
        if failed is not None and failed is not fw.SENTINEL:
            if self.drained[0] == self._progress[0]:
                self.pipe._drain_body(failed, self.drained)
                self.pipe._keep_if_dead(failed)
            else:
                log.warning(f"[fleet:{self.name}] sink crashed after its "
                            "segment was accounted; skipping replay")
        self._sink_pipe = fw.start_pipe(
            self._sink_f, self._q_sink, None, self._stop,
            f"sink_drain:{self.name}", on_done=self.fleet._notify)
        return True

    # ------------------------------------------------------ heal hooks

    def _heal(self, exc: BaseException) -> bool:
        """Device-fault recovery with the fleet's blast-radius rules: an
        OOM or a tagged compile fault demotes THIS lane's plan only (the
        shared processor swapped for an unshared rung, never retired
        under the neighbors); a halt is shared by the lanes of ONE pool
        member (:meth:`StreamFleet._device_halt`)."""
        return self.pipe._heal(
            exc, lambda e: self.fleet._device_halt(e, lane=self))

    def _note_dispatch(self) -> None:
        # the pool's dispatch clock: counts this member's work and fires a
        # scheduled virtual halt here, where the healer takes it (a
        # migrated lane goes through its NEW member's clock)
        self.device.note_dispatch()
        self._resumed = True

    def _dispatch(self, seg, ingest_s, offset_after, index, requeue=False):
        self.pipe.stats.extras["dispatches"] += 1
        return self._redispatch(seg, offset_after, index, requeue=requeue,
                                ingest_s=ingest_s)

    def _redispatch(self, seg, offset_after, index, requeue=True,
                    ingest_s=0.0):
        """One healed dispatch through the pool's clock (the fetch heal's
        cold re-dispatch, ``Pipeline._fetch_healed``, takes it as is)."""
        return self.pipe._dispatch_healed(
            seg, offset_after, index, self._heal, requeue=requeue,
            ingest_s=ingest_s, before=self._note_dispatch)

    def _unit(self) -> int:
        """The lane's dispatch unit, the engine's rule
        (``Pipeline._unit``)."""
        return self.pipe._unit(self.window, self.micro_batch)

    def _shared_factory(self):
        """This lane's processor from its CURRENT member's plan cache."""
        return self.device.plans.get(self.pipe.cfg)

    def _redispatch_pending_cold(self) -> None:
        """Re-dispatch every in-flight segment cold from its pinned host
        buffer, in dispatch order (journal order and checkpoint offsets
        unchanged, the engine's reinit proof); offers still parked in the
        former are withdrawn first."""
        pipe = self.pipe
        for i in range(len(self.pending)):
            old = self.pending[i]
            if isinstance(old, _BatchSlot):
                if old.item is None:
                    old.cancelled = True
                    self.pending[i] = pipe._dispatch_segment(
                        old.seg, old.offset_after, old.index,
                        requeue=True)._replace(ingest_s=old.ingest_s)
                    continue
                old = old.item
            pipe._keep_if_halted(old)
            self.pending[i] = pipe._dispatch_segment(
                old.seg, old.offset_after, old.index,
                requeue=True)._replace(ingest_s=old.ingest_s)

    def reinit_cold(self) -> None:
        """Fleet-wide reinit, this lane's share: a fresh processor at the
        lane's current rung, and its window re-dispatched cold."""
        h = self.pipe.healer
        newp = h.rebuild() if h is not None else self._shared_factory()
        self.pipe._swap_processor(newp)
        self._redispatch_pending_cold()

    def migrate_to(self, device: PoolDevice, trusted: bool,
                   deadline_s: float = 0.0) -> None:
        """LIVE migration onto another member: drain the in-flight window
        (trusted sources only: a halted member's results died with it),
        sync the manifest, re-admit on the target's plan cache, re-arm the
        ring cold and resume.  Output equals an unmigrated run's: drained
        segments were accounted exactly once, and the rest re-dispatch
        cold from their pinned host buffers on the target."""
        src = self.device
        if trusted:
            # fewer cold re-dispatches on the target; breaking early is
            # always safe (the cold path is lossless)
            deadline = time.monotonic() + max(0.0, deadline_s)
            try:
                while self.pending:
                    if self._staged_emit is not None \
                            and not self._try_emit():
                        break
                    if time.monotonic() > deadline:
                        log.warning(
                            f"[fleet:{self.name}] migration drain deadline "
                            f"({deadline_s:g}s) hit; moving the remaining "
                            "window cold")
                        break
                    if not self._drain_head(block=True):
                        break
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 - cold path covers
                log.warning(f"[fleet:{self.name}] migration drain failed "
                            f"({e!r}); the remaining window moves cold")
        man = self.pipe.manifest
        if man is not None:
            try:
                man.sync()
            except Exception as e:  # noqa: BLE001 - advisory
                log.warning(f"[fleet:{self.name}] manifest sync at the "
                            f"migration consistency point: {e!r}")
        self.device = device
        h = self.pipe.healer
        newp = (h.rebuild(shared=self._shared_factory)
                if h is not None else self._shared_factory())
        self.pipe._swap_processor(newp)
        self.pipe.device_label = device.label
        self._redispatch_pending_cold()
        # a re-dispatched window already resumed on the target
        self._resumed = bool(self.pending)
        self.migrations += 1
        self._migrated_t = time.monotonic()
        self.fleet.admission.note_migration(self.name, src.label,
                                            device.label)
        metrics.add("migrations")
        metrics.add("migrations", labels={"stream": self.name})
        metrics.add("migrations", labels={"device": device.label})
        events.emit("fleet.migrate", trace=0, stream=self.name,
                    info=f"{src.label}->{device.label}")
        log.warning(f"[fleet:{self.name}] migrated {src.label} -> "
                    f"{device.label} ({len(self.pending)} segment(s) "
                    "re-dispatched cold)")
        self.fleet._publish_lanes()

    # ----------------------------------------------------- engine step

    def _want_more(self) -> bool:
        return (not self.exhausted
                and (self.max_segments is None
                     or self.dispatched < self.max_segments))

    def _may_read(self) -> bool:
        # a force-shed lane reads only to account its loss
        return self._want_more() and not self.forced_shed

    def _ingest_one(self, index: int):
        one = self.pipe._ingest_healed(self._it, index, self._heal)
        if one is None:
            self.exhausted = True
        return one

    def _observe_level(self) -> int:
        """The lane's degradation observation at emit: occupancy 1.0 when
        it waited on its sink since the last emit, and its OWN recent
        accounted loss (a neighbor's drops never degrade it)."""
        ladder = self.pipe._ladder
        if ladder is None:
            return 0
        if not self.real_time:
            occupancy = 0.0
        elif self.sink_wait:
            occupancy = 1.0
        else:
            occupancy = self._q_sink.qsize() / self.window
        cur = metrics.get("segments_dropped", labels={"stream": self.name})
        if cur > self._loss_seen:
            self._loss_seen = cur
            self._loss_t = time.perf_counter()
        loss = (self._loss_t is not None
                and time.perf_counter() - self._loss_t < 10.0)
        level = ladder.observe(occupancy, loss)
        self.pipe.stats.extras["degrade_levels"].append(level)
        return level

    def _shed_seg(self, seg, in_flight: bool) -> None:
        """Account one segment as this stream's loss (the engine's
        ``shed_segment``): the counter, the ring's chain broken, its
        window slot (``in_flight``) and its buffer freed."""
        self.pipe._account_dropped(trace=getattr(seg, "trace_id", 0))
        self.pipe._ring_invalidate()
        if in_flight:
            self._live_add(-1)
        self.pipe._release(seg)

    def _try_emit(self) -> bool:
        """Push the staged fetched item to this lane's sink pipe.  A full
        queue is lane-local backpressure; a real-time lane's sink wedged
        past the deadline with no push progress sheds the item as
        accounted loss (a file lane throttles losslessly)."""
        item = self._staged_emit
        if self._q_sink.push_lossy(item):
            self._staged_emit = None
            self._wedge_t0 = None
            self._emitted_since_obs += 1
            return True
        self.sink_wait = True
        if self.deadline_s > 0 and self.real_time:
            cur = (self.drained[0], self.pipe._sink_heartbeat)
            if self._wedge_t0 is None or cur != self._wedge_mark:
                self._wedge_t0 = time.perf_counter()
                self._wedge_mark = cur
            elif time.perf_counter() - self._wedge_t0 > self.deadline_s:
                log.error(f"[fleet:{self.name}] sink wedged past "
                          f"{self.deadline_s:g}s with no drain progress: "
                          "shedding segment as accounted loss")
                self._shed_seg(item.seg, in_flight=True)
                self._staged_emit = None
                self._wedge_t0 = None
                return True
        return False

    def _drain_head(self, block: bool) -> bool:
        """Fetch the oldest in-flight segment (healed) and stage it for
        emit; without ``block`` only a ready head is fetched."""
        head = self.pending[0]
        if isinstance(head, _BatchSlot):
            if head.error is not None:
                # a batched dispatch failed for THIS member: raise in the
                # owning lane's step (``_fail`` accounts the slot)
                raise head.error
            if head.item is None:
                if not block:
                    return False
                former = self.fleet._former
                if former is not None:
                    former.flush_lane(self)
                if head.error is not None:
                    raise head.error
                if head.item is None:
                    return False
            self.pending[0] = head.item
        if not block and not Pipeline._ready(self.pending[0]):
            return False
        depth = len(self.pending)
        live_now = self._live_count()
        fetched = self.pipe._fetch_healed(self.pending.popleft(), depth,
                                          live_now, self._heal,
                                          self._redispatch)
        h = self.pipe.healer
        if h is not None:
            h.note_healthy()
        level = self._observe_level()
        self.sink_wait = False
        self._staged_emit = fetched._replace(degrade_level=level,
                                             sinks_done=set())
        self._try_emit()
        return True

    def step(self, allow_block: bool = False) -> bool:
        """One cooperative scheduler slice; True when the lane made
        progress.  A failure is contained to this lane (the bulkhead):
        the lane fails and accounts its in-flight segments as its own
        loss."""
        if self.done:
            return False
        try:
            return self._step_inner(allow_block)
        except (KeyboardInterrupt, SystemExit):
            # an operator interrupt is not a lane fault
            raise
        except BaseException as e:  # noqa: BLE001 - bulkhead boundary
            self._fail(e)
            return True

    def _shed_ingest(self) -> bool:
        """Read one segment and account it as this stream's loss (a
        force-shed lane, or a window parked behind a wedged sink)."""
        one = self._ingest_one(self.dispatched)
        if one is None:
            return False
        self.dispatched += 1
        self._shed_seg(one[0], in_flight=False)
        return True

    def _step_inner(self, allow_block: bool) -> bool:
        if self.status == "closing":
            return self._step_close()
        if not self._sink_alive():
            raise self._sink_pipe.exception
        # 0) a fetched item waiting for sink-queue space blocks the drain
        if self._staged_emit is not None and not self._try_emit():
            return False
        # 1) fleet fairness force-shed: keep reading, account every
        #    undispatched segment as this tenant's loss
        if self.forced_shed and self._want_more() and self._shed_ingest():
            log.warning(f"[fleet:{self.name}] force-shed: dropped a read "
                        "segment (accounted)")
            return True
        # 2) drain whatever is ready, in order
        if self.pending and self._drain_head(block=False):
            return True
        # 3) read and dispatch the next unit while the window has room
        first = self.dispatched
        b, got = self.pipe._next_unit(self.window, self._live_count,
                                      self._unit, self._may_read,
                                      self._ingest_one, first,
                                      self.max_segments)
        if got:
            former = self.fleet._former
            if former is not None and len(got) == 1 \
                    and former.eligible(self):
                # park the segment in the fleet's batch former (a window
                # reservation in dispatch order)
                self.pending.append(former.offer(self, got[0], first))
            else:
                items, n = self.pipe._dispatch_unit(
                    got, first, b, self._heal, self._redispatch,
                    before=self._note_dispatch)
                self.pipe.stats.extras["dispatches"] += n
                self.pending.extend(items)
            self._live_add(len(got))
            self.dispatched += len(got)
            self.pipe.stats.segments += len(got)
            self.pipe.stats.samples += \
                self.pipe.cfg.baseband_input_count * len(got)
            self._park_t0 = None
            return True
        # 3b) the whole window parked behind the sink: a real-time lane
        #     past the deadline with no push progress reads on and
        #     accounts each undispatched segment as its loss
        if self.real_time and self.deadline_s > 0 and self._want_more() \
                and not self.pending and self._staged_emit is None \
                and self._live_count() >= self.window:
            self.sink_wait = True
            cur = (self.drained[0], self.pipe._sink_heartbeat)
            if self._park_t0 is None or cur != self._park_mark:
                self._park_t0 = time.perf_counter()
                self._park_mark = cur
            elif time.perf_counter() - self._park_t0 > self.deadline_s:
                log.error(f"[fleet:{self.name}] sink wedged with a full "
                          "window: shedding read segment as accounted loss")
                if self._shed_ingest():
                    return True
            return False
        # 4) window full (or source done) with an unready head: a blocking
        #    fetch, which the fleet grants to one lane an idle round
        if self.pending and allow_block:
            return self._drain_head(block=True)
        # 5) complete: close the lane (sentinel, then a bounded join)
        if not self.pending and self._staged_emit is None \
                and not self._want_more():
            if self._q_sink.push_lossy(fw.SENTINEL):
                self.status = "closing"
                self._t_close = time.perf_counter()
                self._sentinel_t0 = None
                return True
            if self._sentinel_t0 is None:
                self._sentinel_t0 = time.perf_counter()
            elif self.join_s > 0 and \
                    time.perf_counter() - self._sentinel_t0 > self.join_s:
                self._wedge_teardown()
                return True
        return False

    def _step_close(self) -> bool:
        """Closing: wait for the sink pipe to drain and exit, bounded by
        ``shutdown_join_timeout_s`` (0 = as long as it takes, but never
        blocking the scheduler more than a poll)."""
        if self._sink_pipe.exception is not None:
            if not self._sink_alive():
                raise self._sink_pipe.exception
            # a supervised restart mid-close: repost the sentinel (a
            # duplicate is harmless)
            self._q_sink.push_lossy(fw.SENTINEL)
            return True
        if self._sink_pipe.join(0.002):
            self._finish()
            return True
        if self.join_s > 0 and \
                time.perf_counter() - self._t_close > self.join_s:
            self._wedge_teardown()
            return True
        return False

    def _drop_queued(self) -> None:
        """Account the sink queue's items as this stream's loss."""
        while True:
            leftover = self._q_sink.try_pop()
            if leftover is None:
                break
            if leftover is not fw.SENTINEL:
                self._shed_seg(leftover.seg, in_flight=True)

    def _wedge_teardown(self) -> None:
        """The bounded shutdown gives up on a wedged sink: the thread
        reported, still-queued segments accounted as this stream's loss,
        the writer pool abandoned (never drained)."""
        from srtb_tpu_torch.utils import termination
        self.pipe._sink_wedged = True
        self.pipe._incident(
            "sink_wedge_shutdown",
            reason=f"fleet lane {self.name}: sink pipe still alive after "
                   f"the {self.join_s:g}s join budget")
        termination.report_wedged(
            [self._sink_pipe.thread],
            f"fleet lane {self.name} shutdown ({self.join_s:g}s join "
            "timeout)")
        self._drop_queued()
        held = self._current[0]
        if held is not None and held is not fw.SENTINEL:
            with self.pipe._handoff_lock:
                if self.drained[0] == self._progress[0]:
                    held.sinks_done.add("abandoned")
                    self.pipe._account_dropped(
                        trace=getattr(held.seg, "trace_id", 0))
                    self._live_add(-1)
        self._stop.request_stop()
        log.error(f"[fleet:{self.name}] wedged sink: queued segments "
                  "accounted as segments_dropped")
        self._finish()

    def _end(self) -> None:
        """The lane's run ends (finished or failed): the carry dropped,
        the profile capture stopped, the halt holds released, the
        counters copied, the stream unregistered."""
        pipe = self.pipe
        pipe._ring_invalidate()
        if pipe.profile_capture is not None:
            pipe.profile_capture.stop()
        pipe.stats.elapsed_s = time.perf_counter() - self._t_start
        pipe.stats.extras.update(counters_snapshot())
        if pipe.healer is not None:
            pipe.stats.extras["active_plan"] = pipe.active_plan
        self.done = True
        metrics.set("inflight_depth", 0, labels={"stream": self.name})
        telemetry.release_stream(self.name)

    def _finish(self) -> None:
        pipe = self.pipe
        if not pipe._sink_wedged:
            t0 = time.perf_counter()
            pipe._drain_sinks()
            pipe.stats.extras["stage_s"]["drain"] += time.perf_counter() - t0
        pipe.stats.extras["stages"] = pipe.stage_timer.summary()
        pipe._finish_extras()
        pipe._perf_ledger_record()
        self.status = "done"
        self._end()
        pipe._end_holds()
        log.info(f"[fleet:{self.name}] done: {pipe.stats.segments} "
                 f"segments, {self.drained[0] - self._drained0} drained")

    def _fail(self, exc: BaseException) -> None:
        """Bulkhead containment of a lane failure: every in-flight or
        queued segment becomes this stream's accounted loss, its
        resources released, its neighbors never see the exception (a real
        sticky fault is the fleet's to raise, ``StreamFleet.run``)."""
        self.error = exc
        self.status = "failed"
        events.emit("fleet.lane_failed", trace=0, stream=self.name,
                    info=type(exc).__name__)
        if self.fleet._dead is None:
            self.pipe._incident("lane_failed",
                                reason=f"contained lane failure: {exc!r}")
        log.error(f"[fleet:{self.name}] stream failed (contained): "
                  f"{exc!r}")
        self._stop.request_stop()
        self._drop_queued()
        if self._staged_emit is not None:
            self._shed_seg(self._staged_emit.seg, in_flight=True)
            self._staged_emit = None
        if self.fleet._former is not None:
            self.fleet._former.drop_lane(self)
        while self.pending:
            item = self.pending.popleft()
            if isinstance(item, _BatchSlot):
                item.cancelled = True
                if item.item is None:
                    # never dispatched: the parked segment is host-side
                    self.pipe._account_dropped(
                        trace=getattr(item.seg, "trace_id", 0))
                    self._live_add(-1)
                    continue
                item = item.item
            self.pipe._keep_if_halted(item)
            self._shed_seg(item.seg, in_flight=True)
        self._q_sink.push_lossy(fw.SENTINEL)
        self._sink_pipe.join(1.0)
        self._end()

    def close(self) -> None:
        self.pipe.close()


class StreamFleet:
    """Serve N streams from one card (see the module docstring).

    ``run()`` drives every admitted lane round-robin to completion and
    returns ``{name: StreamResult}``, rejected streams (status
    "rejected") and contained failures (status "failed" with the error)
    included.  It raises only what ends the process: a real sticky CUDA
    fault (the lane's ``ReinitBudgetExceeded``) or an operator interrupt.
    The lanes run on the card unless ``device="cpu"``."""

    def __init__(self, specs: list[StreamSpec],
                 fleet_cfg: Config | None = None, device=None):
        if not specs:
            raise ValueError("StreamFleet needs at least one stream")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stream names: {names}")
        for s in specs:
            # the lane label reaches the lane's telemetry and faults
            if getattr(s.cfg, "stream_name", "") not in ("", s.name):
                raise ValueError(
                    f"stream {s.name!r}: cfg.stream_name "
                    f"{s.cfg.stream_name!r} disagrees with the spec")
            s.cfg.stream_name = s.name
        self.specs = {s.name: s for s in specs}
        cfg0 = fleet_cfg if fleet_cfg is not None else specs[0].cfg
        if getattr(cfg0, "tsan", False):
            raise NotImplementedError(
                "Config.tsan arms the reference's runtime concurrency "
                "checker (analysis/tsan.py), not ported yet (ROADMAP A8c)")
        self.device = resolve_device(device)
        self.pool = DevicePool.from_config(cfg0, self.device)
        # the member-0 cache (the one-member pool's only one)
        self.plans = self.pool.devices[0].plans
        self._migrate_on_burn = bool(getattr(cfg0, "migrate_on_burn",
                                             False))
        self._drain_deadline = float(
            getattr(cfg0, "drain_deadline_s", 5.0) or 0.0)
        # rolling-restart queue of member indices (deque append/popleft
        # are atomic: rolling_restart may run on another thread)
        self._rolling: collections.deque = collections.deque()
        self._rebalance_t = 0.0
        self.admission = AdmissionController.from_config(cfg0)
        self.fairness = FleetShedPolicy.from_config(cfg0)
        batch_max = int(getattr(cfg0, "fleet_batch_max", 0) or 0)
        self._former = None
        if batch_max >= 2:
            self._former = _BatchFormer(
                self, batch_max,
                max(0.0, float(getattr(cfg0, "fleet_batch_linger_ms", 2.0)
                               or 0.0)) / 1e3)
        # sink threads wake an idle scheduler through this condition; the
        # sequence number closes the race between its progress check and
        # its wait
        self._wake = threading.Condition()
        self._wake_seq = 0
        # the SHARED reinit budget of a halt with no peer
        self._reinit_sup = None
        reinit_max = int(getattr(cfg0, "device_reinit_max", 0) or 0)
        if reinit_max > 0:
            self._reinit_sup = Supervisor(
                "fleet_device_reinit", max_restarts=reinit_max,
                window_s=float(getattr(cfg0, "device_reinit_window_s",
                                       300.0)),
                counter=None)
        # a real sticky fault's error (the context is dead: run() raises)
        self._dead: BaseException | None = None
        self.lanes: dict[str, _StreamLane] = {}
        self.results: dict[str, StreamResult] = {}
        self._waitlist: dict[str, StreamSpec] = {}

    # ------------------------------------------------------- placement

    def _loads(self) -> dict[int, int]:
        """Live lane count per member index."""
        loads = {d.index: 0 for d in self.pool.devices}
        for ln in self.lanes.values():
            if not ln.done:
                loads[ln.device.index] = loads.get(ln.device.index, 0) + 1
        return loads

    def _tenants_by_device(self) -> dict[int, set]:
        out: dict[int, set] = {}
        for ln in self.lanes.values():
            if not ln.done:
                out.setdefault(ln.device.index, set()).add(
                    placement.tenant_of(ln.name))
        return out

    def _place(self, spec: StreamSpec) -> PoolDevice:
        dev = placement.choose_initial(
            spec, self.pool.healthy(), self._loads(),
            self._tenants_by_device())
        if dev is None:
            raise RuntimeError(f"stream {spec.name!r}: no healthy pool "
                               "device to place on")
        return dev

    def _publish_lanes(self) -> None:
        loads = self._loads()
        for d in self.pool.devices:
            metrics.set("fleet_device_lanes", loads.get(d.index, 0),
                        labels={"device": d.label})

    # ---------------------------------------------------- lane control

    def _notify(self) -> None:
        """Wake an idle scheduler (from the lanes' sink threads)."""
        with self._wake:
            self._wake_seq += 1
            self._wake.notify_all()

    def _start(self, name: str) -> bool:
        spec = self.specs[name]
        try:
            self.lanes[name] = _StreamLane(self, spec)
            self._publish_lanes()
            return True
        except (KeyboardInterrupt, SystemExit):
            self.admission.release(name)
            raise
        except BaseException as e:  # noqa: BLE001 - contained
            log.error(f"[fleet] stream {name!r} failed to start: {e!r}")
            self.admission.release(name)
            self.results[name] = StreamResult(name, "failed", error=e)
            return False

    def _start_queued(self) -> None:
        """Start queued streams into freed capacity, past start failures
        (a failed start released its slot for the next one)."""
        while True:
            nxt = self.admission.pop_ready()
            if nxt is None:
                return
            if self._waitlist.pop(nxt, None) is None:
                self.admission.release(nxt)
                continue
            self._start(nxt)

    def _context_dead(self, dev: PoolDevice) -> BaseException | None:
        """The error of a card whose context a sticky fault killed (a
        wait raises), or None: an injected halt leaves it alive."""
        if dev.device.type != "cuda":
            return None
        try:
            torch.cuda.synchronize(dev.device)
        except RuntimeError as e:  # torch.AcceleratorError: dead context
            return e
        return None

    def _device_halt(self, exc: BaseException,
                     lane: "_StreamLane") -> bool:
        """The scoped HALT domain: with a healthy peer the faulted member
        is marked halted, ONLY its plan cache retired, and its lanes
        migrate onto survivors (no reinit budget spent); with no peer,
        the budgeted fleet-wide reinit.  A dead context is neither: the
        halt escalates (False), and ``run()`` raises it."""
        dev = lane.device
        dead = self._context_dead(dev)
        if dead is not None:
            self._dead = exc
            log.error(f"[fleet] device halt on {dev.label} (stream "
                      f"{lane.name!r}): the CUDA context is dead "
                      f"({dead!r}); escalating, no lane is restarted")
            return False
        survivors = [d for d in self.pool.healthy() if d is not dev]
        if not survivors:
            return self._reinit_all(exc, faulting=lane.name)
        dev.set_state(STATE_HALTED)
        dev.plans.invalidate()
        metrics.add("device_drains")
        metrics.add("device_drains", labels={"device": dev.label})
        events.emit("fleet.device_halt", trace=0, stream=lane.name,
                    info=dev.label)
        log.warning(f"[fleet] device halt on {dev.label} (stream "
                    f"{lane.name!r}): draining its lanes onto "
                    f"{len(survivors)} survivor(s) ({exc!r})")
        for ln in [x for x in self.lanes.values()
                   if not x.done and x.device is dev]:
            target = placement.choose_target(
                ln.name, dev.index, self.pool.healthy(), self._loads(),
                self._tenants_by_device())
            ln.migrate_to(target, trusted=False)
        return True

    def _reinit_all(self, exc: BaseException, faulting: str) -> bool:
        """The no-peer domain: one budgeted decision, then every member's
        shared plans retired, every lane's processor rebuilt at its own
        rung and its window re-dispatched cold."""
        if self._reinit_sup is None or \
                not self._reinit_sup.should_restart(exc):
            return False
        metrics.add("device_reinits")
        metrics.add("device_reinits", labels={"stream": faulting})
        events.emit("fleet.reinit", trace=0, stream=faulting,
                    info=type(exc).__name__)
        log.warning(f"[fleet] device halt (stream {faulting!r}): shared "
                    f"reinit, rebuilding every lane's plan ({exc!r})")
        self.pool.invalidate_all()
        for lane in self.lanes.values():
            if not lane.done:
                lane.reinit_cold()
        if self._former is not None:
            self._former.reset()
        return True

    def _on_lane_done(self, lane: _StreamLane) -> None:
        self.admission.release(lane.name)
        dropped = int(metrics.get("segments_dropped",
                                  labels={"stream": lane.name}))
        self.results[lane.name] = StreamResult(
            lane.name,
            lane.status if lane.status in ("done", "failed") else "failed",
            stats=lane.pipe.stats, error=lane.error,
            drained=lane.drained[0] - lane._drained0, dropped=dropped,
            extras={"plan": getattr(lane.pipe.processor, "plan_name",
                                    None),
                    "device": lane.device.label,
                    "migrations": lane.migrations})
        self._publish_lanes()
        self._start_queued()

    def _observe_fairness(self) -> None:
        """One fleet-wide fairness observation, paced on emits: pressure
        is the fraction of running lanes that waited on their sink since
        the last one."""
        running = [ln for ln in self.lanes.values() if not ln.done]
        emits = sum(ln._emitted_since_obs for ln in running)
        waits = sum(1 for ln in running if ln.sink_wait)
        if not running or (emits == 0 and waits == 0):
            return
        loss = metrics.window("segments_dropped").sum() > 0
        shed = self.fairness.observe(
            waits / len(running), loss,
            [(ln.name, ln.priority, ln.real_time,
              self._former is not None and self._former.eligible(ln),
              ln.device.label)
             for ln in running])
        for ln in running:
            ln.forced_shed = ln.name in shed
            ln._emitted_since_obs = 0

    # ------------------------------------------- migration triggers b, c

    def _maybe_rebalance(self) -> None:
        """``migrate_on_burn``: a stream whose SLO verdict is not ok moves
        onto a STRICTLY less-loaded healthy peer (4 Hz, with a 5 s cooldown
        a lane)."""
        if not self._migrate_on_burn:
            return
        now = time.monotonic()
        if now - self._rebalance_t < 0.25:
            return
        self._rebalance_t = now
        healthy = self.pool.healthy()
        if len(healthy) < 2:
            return
        from srtb_tpu_torch.utils import slo
        tr = slo.tracker
        if tr is None:
            return
        try:
            per = tr.evaluate()
        except Exception as e:  # noqa: BLE001 - advisory telemetry
            log.debug(f"[fleet] slo evaluate failed: {e!r}")
            return
        for ln in list(self.lanes.values()):
            if ln.done or ln.status != "running":
                continue
            verdict = per.get(ln.name)
            if verdict is None or verdict.get("ok", True):
                continue
            if now - ln._migrated_t < 5.0:
                continue
            loads = self._loads()
            target = placement.choose_target(
                ln.name, ln.device.index, healthy, loads,
                self._tenants_by_device())
            if target is None or loads.get(target.index, 0) \
                    >= loads.get(ln.device.index, 0):
                continue
            log.warning(f"[fleet] SLO burn on {ln.name!r}: rebalancing "
                        f"{ln.device.label} -> {target.label}")
            ln.migrate_to(target, trusted=True,
                          deadline_s=self._drain_deadline)

    def rolling_restart(self) -> None:
        """Queue every member for a drain (callable from any thread; the
        scheduler drains ONE member a round)."""
        self._rolling.extend(d.index for d in self.pool.devices)
        self._notify()

    def _pump_rolling(self) -> bool:
        """Drain at most one queued member, after the previous drain's
        migrants resumed; a member without a healthy peer is skipped."""
        if not self._rolling:
            return False
        if any(not ln.done and not ln._resumed
               for ln in self.lanes.values()):
            return False
        dev = self.pool.devices[self._rolling.popleft()]
        if dev.state != STATE_OK:
            return False
        if len(self.pool.healthy()) < 2:
            log.warning(f"[fleet] rolling restart: {dev.label} has no "
                        "healthy peer to drain onto; skipping")
            return False
        dev.set_state(STATE_DRAINING)
        metrics.add("device_drains")
        metrics.add("device_drains", labels={"device": dev.label})
        events.emit("fleet.device_drain", trace=0, stream=None,
                    info=dev.label)
        log.info(f"[fleet] rolling restart: draining {dev.label}")
        for ln in [x for x in self.lanes.values()
                   if not x.done and x.device is dev]:
            target = placement.choose_target(
                ln.name, dev.index, self.pool.healthy(), self._loads(),
                self._tenants_by_device())
            ln.migrate_to(target, trusted=True,
                          deadline_s=self._drain_deadline)
        dev.plans.invalidate()
        dev.set_state(STATE_OK)
        log.info(f"[fleet] rolling restart: {dev.label} drained and "
                 "re-armed")
        return True

    # ------------------------------------------------------------ run

    @staticmethod
    def _plan_key(spec: StreamSpec) -> str | None:
        """The spec's plan-family key for batch-aware admission (None when
        the config projects none)."""
        try:
            from srtb_tpu_torch.pipeline import registry
            return registry.plan_cache_key(spec.cfg)
        except Exception as e:  # noqa: BLE001 - admission never fails
            log.debug(f"[fleet] no plan key for {spec.name}: {e!r}")
            return None

    def _reject_evicted(self) -> None:
        """Queue evictions the controller recorded surface as rejected."""
        for name in self.admission.rejected:
            if name in self._waitlist or name not in self.results:
                self._waitlist.pop(name, None)
                self.results.setdefault(name, StreamResult(name,
                                                           "rejected"))

    def _step_lane(self, lane: _StreamLane, allow_block: bool) -> bool:
        progressed = lane.step(allow_block=allow_block)
        if lane.done:
            self._on_lane_done(lane)
        if self._dead is not None:
            # a real sticky fault: the process ends, nothing restarts
            raise lane.error if lane.error is not None else self._dead
        return progressed

    def run(self) -> dict[str, StreamResult]:
        metrics.set("fleet_streams_total", len(self.specs))
        # the lanes dispatch from this thread onto the card's current
        # stream, the one compute stream
        for spec in self.specs.values():
            decision = self.admission.request(
                spec.name, spec.priority, plan_key=self._plan_key(spec))
            if decision == ADMIT:
                self._start(spec.name)
            elif decision == QUEUE:
                self._waitlist[spec.name] = spec
        self._reject_evicted()
        self._start_queued()
        try:
            while True:
                active = [ln for ln in self.lanes.values() if not ln.done]
                if not active and not self._waitlist:
                    break
                if not active:
                    # every lane is gone but streams wait: start them, or
                    # fail them loudly when none can start
                    self._start_queued()
                    if not any(not ln.done for ln in self.lanes.values()):
                        for name in list(self._waitlist):
                            del self._waitlist[name]
                            self.results.setdefault(name, StreamResult(
                                name, "failed", error=RuntimeError(
                                    "queued stream never became "
                                    "startable")))
                        break
                    continue
                wake_seq = self._wake_seq
                progressed = False
                for lane in active:
                    if self._step_lane(lane, False):
                        progressed = True
                if self._former is not None and self._former.pump():
                    progressed = True
                if self._pump_rolling():
                    progressed = True
                self._maybe_rebalance()
                self._observe_fairness()
                self._reject_evicted()
                if progressed:
                    continue
                if self._former is not None and self._former.flush_all():
                    continue
                blocker = next((ln for ln in self.lanes.values()
                                if not ln.done and ln.pending), None)
                if blocker is not None:
                    self._step_lane(blocker, True)
                    continue
                # every lane waits on its sink side: wait for a sink
                # thread's notify (the timeout bounds a lost wakeup)
                metrics.add("fleet_idle_waits")
                deadline = time.monotonic() + 0.05
                with self._wake:
                    while self._wake_seq == wake_seq:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._wake.wait(left)
        finally:
            metrics.set("fleet_running", 0)
        return self.results

    def close(self) -> None:
        for lane in self.lanes.values():
            lane.close()
        self.pool.invalidate_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
