"""Admission control for the multi-tenant stream fleet (port of
``srtb_tpu/resilience/admission.py``).

A device serving N concurrent streams (pipeline/fleet.py) has a hard
capacity: every admitted stream holds an in-flight window of device
buffers, and admitting one more tenant past that point degrades every
existing one (the noisy-neighbor failure the bulkheads exist to
prevent).  The admission gate makes that boundary explicit and FAIR:

- up to ``Config.fleet_max_streams`` streams run concurrently
  (0 = no limit — a dev box running two replay jobs needs no gate);
- past capacity, new streams are **queued** (up to
  ``Config.fleet_queue_limit`` slots) in priority order
  (``Config.stream_priority``, higher first; FIFO within a priority)
  and started as running streams finish;
- past the queue, the LOWEST-priority request loses: a new request
  that outranks the worst queued entry evicts it (the evictee is
  rejected), otherwise the new request itself is rejected.

Every decision is a counter with a ``stream`` label — an operator
must be able to answer "who was turned away, and why" from /metrics
alone.  Rejection is an ANSWER, not an error: the fleet reports
rejected streams in its result instead of raising, so a submitting
service can retry, re-prioritize, or route to another device.
"""

from __future__ import annotations

import itertools

from srtb_tpu_torch.utils import events
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

ADMIT = "admit"
QUEUE = "queue"
REJECT = "reject"


class AdmissionController:
    """Capacity gate + priority wait queue over stream names.

    Not thread-safe by itself: the fleet scheduler (single-threaded)
    is the only caller.
    """

    def __init__(self, max_streams: int = 0, queue_limit: int = 0):
        self.max_streams = max(0, int(max_streams))
        self.queue_limit = max(0, int(queue_limit))
        self.running: set[str] = set()
        # sort key: (-priority, arrival seq) — higher priority first,
        # FIFO within a priority band
        self._seq = itertools.count()
        self._queue: list[tuple[int, int, str]] = []
        self.rejected: list[str] = []
        # batch-aware admission (cross-tenant continuous batching):
        # each stream's plan-family key, when the caller knows it.
        # Eviction prefers streams with no co-tenant family — kicking
        # a batch-group member also costs its neighbors the formed
        # batch density, kicking a loner costs one tenant.
        self._plan_keys: dict[str, str] = {}

    @classmethod
    def from_config(cls, cfg) -> "AdmissionController":
        return cls(
            max_streams=int(getattr(cfg, "fleet_max_streams", 0) or 0),
            queue_limit=int(getattr(cfg, "fleet_queue_limit", 0) or 0))

    # ------------------------------------------------------- decisions

    _COUNTERS = {ADMIT: "fleet_admitted", QUEUE: "fleet_queued",
                 REJECT: "fleet_rejected"}

    def _mark(self, decision: str, name: str) -> None:
        counter = self._COUNTERS[decision]
        metrics.add(counter)
        metrics.add(counter, labels={"stream": name})
        metrics.set("fleet_running", len(self.running))
        metrics.set("fleet_queued_depth", len(self._queue))
        events.emit("admission", trace=0, stream=name, info=decision)

    def request(self, name: str, priority: int = 0,
                plan_key: str | None = None) -> str:
        """One stream asking to run; returns ADMIT / QUEUE / REJECT.
        A queued stream surfaces later via :meth:`pop_ready` once
        capacity frees up (the fleet starts its lane then).
        ``plan_key`` (optional) is the stream's plan-family key; the
        eviction tie-break prefers keeping families with co-tenants
        together (batch-aware admission)."""
        if plan_key is not None:
            self._plan_keys[name] = plan_key
        if self.max_streams <= 0 or len(self.running) < self.max_streams:
            self.running.add(name)
            self._mark("admit", name)
            return ADMIT
        entry = (-int(priority), next(self._seq), name)
        if len(self._queue) < self.queue_limit:
            self._queue.append(entry)
            self._queue.sort()
            self._mark("queue", name)
            log.info(f"[admission] fleet at capacity "
                     f"({self.max_streams}): queued stream {name!r} "
                     f"(priority {priority})")
            return QUEUE
        if self._queue and entry[:1] < self._queue[-1][:1]:
            # the new request outranks the worst queued entry: the
            # queue keeps the highest-priority waiters, the evictee
            # is rejected in the newcomer's place
            evicted = self._queue.pop(self._evict_index())[-1]
            self._plan_keys.pop(evicted, None)
            self.rejected.append(evicted)
            self._mark("reject", evicted)
            log.warning(f"[admission] queued stream {evicted!r} "
                        f"evicted by higher-priority {name!r}")
            self._queue.append(entry)
            self._queue.sort()
            self._mark("queue", name)
            return QUEUE
        self._plan_keys.pop(name, None)
        self.rejected.append(name)
        self._mark("reject", name)
        log.warning(f"[admission] fleet over capacity: rejected "
                    f"stream {name!r} (priority {priority})")
        return REJECT

    def _evict_index(self) -> int:
        """Which queue entry an outranking request displaces: within
        the lowest-priority band (the only candidates — priority
        order is never violated), a stream whose plan family has NO
        co-tenant among running or queued streams goes first, newest
        arrival first; with no loner, the newest arrival of the band
        (the pre-batching behavior).  Streams without a known plan
        key count as loners."""
        band = self._queue[-1][0]
        idxs = [i for i, e in enumerate(self._queue) if e[0] == band]
        counts: dict[str, int] = {}
        for n in list(self.running) + [e[-1] for e in self._queue]:
            k = self._plan_keys.get(n)
            if k is not None:
                counts[k] = counts.get(k, 0) + 1
        for i in reversed(idxs):
            k = self._plan_keys.get(self._queue[i][-1])
            if k is None or counts.get(k, 0) <= 1:
                return i
        return idxs[-1]

    def pop_ready(self) -> str | None:
        """Highest-priority queued stream if capacity allows, else
        None; the returned stream is immediately counted as running."""
        if not self._queue or (self.max_streams > 0
                               and len(self.running)
                               >= self.max_streams):
            return None
        name = self._queue.pop(0)[-1]
        self.running.add(name)
        self._mark("admit", name)
        return name

    def note_migration(self, name: str, src: str, dst: str) -> None:
        """A running stream was LIVE-migrated between pool devices:
        its admission slot is unchanged (the stream never stopped
        running), but the re-admission on the target must be
        attributable — who moved, from where, to where — from
        /metrics and the event trace alone, like every other
        admission decision."""
        if name not in self.running and self.max_streams > 0:
            log.warning(f"[admission] migration noted for "
                        f"{name!r}, which holds no admission slot")
        metrics.add("fleet_readmitted")
        metrics.add("fleet_readmitted", labels={"stream": name})
        metrics.add("fleet_readmitted", labels={"device": dst})
        events.emit("admission", trace=0, stream=name,
                    info=f"migrate:{src}->{dst}")

    def release(self, name: str) -> None:
        """A running stream finished (or failed): frees its slot."""
        self.running.discard(name)
        self._plan_keys.pop(name, None)
        metrics.set("fleet_running", len(self.running))

    @property
    def queued(self) -> list[str]:
        return [name for _, _, name in self._queue]
