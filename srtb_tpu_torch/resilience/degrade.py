"""The graceful-degradation ladder: shed work before shedding data (port
of ``DegradationLadder`` of ``srtb_tpu/resilience/degrade.py``).

- level 0 ``full``            everything runs;
- level 1 ``shed_waterfall``  the waterfall dumps are withheld from the
  sinks;
- level 2 ``shed_baseband``   sinks marked ``sheddable`` (the candidate
  writers) are skipped;
- level 3 ``shed_segments``   whole segments are being dropped (the
  accounted loss of ``io/backpressure.py``), and the ladder names it.

The engine observes it once an emitted segment: sink pressure (it had to
wait on the sink, read as occupancy 1.0; else the sink queue's fraction)
on a real-time source only (a file run throttles its reader losslessly),
and whether accounted segment loss happened in the recent window.
Hysteresis (``hold`` observations above ``high`` / below ``low``) keeps
one slow flush from thrashing it.  Counted in the metrics registry:
``degrade_level`` (with its ``stream``-labeled twin for a named stream),
``degrade_steps``, ``degrade_recoveries``, each step a ``degrade`` event;
the engine counts the sheds (``shed_waterfalls``, ``shed_baseband``).

``FleetShedPolicy`` (the reference's) is the fleet's cross-stream shed
order under fleet-wide sink pressure (``pipeline/fleet.py``).
"""

from __future__ import annotations

from srtb_tpu_torch.utils import events
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

LEVELS = ("full", "shed_waterfall", "shed_baseband", "shed_segments")


class DegradationLadder:
    """Hysteretic escalation over ``LEVELS`` driven by one observation of
    sink backlog and loss a drained segment."""

    def __init__(self, high: float = 0.9, low: float = 0.25,
                 hold: int = 3, stream: str = ""):
        if not 0.0 <= low < high <= 1.0:
            raise ValueError(f"need 0 <= low < high <= 1, got "
                             f"low={low} high={high}")
        self.high = float(high)
        self.low = float(low)
        self.hold = max(1, int(hold))
        self.level = 0
        self._above = 0
        self._below = 0
        self._labels = {"stream": str(stream)} if stream else None
        self._set_gauge(0)

    @classmethod
    def from_config(cls, cfg) -> "DegradationLadder":
        return cls(high=float(getattr(cfg, "degrade_queue_high", 0.9)),
                   low=float(getattr(cfg, "degrade_queue_low", 0.25)),
                   hold=int(getattr(cfg, "degrade_hold_segments", 3)),
                   stream=str(getattr(cfg, "stream_name", "") or ""))

    def _set_gauge(self, level: int) -> None:
        metrics.set("degrade_level", level)
        if self._labels is not None:
            metrics.set("degrade_level", level, labels=self._labels)

    def observe(self, occupancy: float, loss_active: bool) -> int:
        """One observation; returns the (possibly updated) level."""
        pressure = occupancy >= self.high or loss_active
        relief = occupancy <= self.low and not loss_active
        if pressure:
            self._above += 1
            self._below = 0
        elif relief:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if self._above >= self.hold and self.level < len(LEVELS) - 1:
            self.level += 1
            self._above = 0
            metrics.add("degrade_steps")
            events.emit("degrade",
                        stream=(self._labels or {}).get("stream"),
                        info=f"{LEVELS[self.level - 1]}->"
                             f"{LEVELS[self.level]}")
            log.warning(
                f"[degrade] sustained pressure (occupancy "
                f"{occupancy:.2f}, loss={loss_active}): stepping up to "
                f"level {self.level} ({LEVELS[self.level]})")
        elif self._below >= self.hold and self.level > 0:
            self.level -= 1
            self._below = 0
            metrics.add("degrade_recoveries")
            events.emit("degrade",
                        stream=(self._labels or {}).get("stream"),
                        info=f"{LEVELS[self.level + 1]}->"
                             f"{LEVELS[self.level]}")
            log.info(f"[degrade] pressure cleared: recovering to level "
                     f"{self.level} ({LEVELS[self.level]})")
        self._set_gauge(self.level)
        return self.level


class FleetShedPolicy:
    """Cross-stream fairness under fleet-wide sink pressure
    (pipeline/fleet.py): when the FLEET as a whole is drowning — a
    sustained fraction of lanes reporting sink pressure or active
    accounted loss — shed the lowest-priority REAL-TIME stream first
    (force its ladder to ``shed_segments``), instead of letting every
    tenant degrade a little and the overload land arbitrarily.

    Same hysteresis discipline as the per-stream ladder: ``hold``
    consecutive pressured observations shed one more stream (lowest
    priority first, name as tie-break for determinism); ``hold``
    consecutive relieved observations restore one (highest priority
    first).  File-mode streams throttle losslessly by design and are
    never shed (the per-stream ladder's real_time rule, applied
    fleet-wide).  Every transition is a counter with a ``stream``
    label — fleet shedding that is not attributable per tenant is
    just noisy-neighbor loss with better marketing."""

    def __init__(self, high: float = 0.9, low: float = 0.25,
                 hold: int = 3):
        if not 0.0 <= low < high <= 1.0:
            raise ValueError(f"need 0 <= low < high <= 1, got "
                             f"low={low} high={high}")
        self.high = float(high)
        self.low = float(low)
        self.hold = max(1, int(hold))
        self._above = 0
        self._below = 0
        self.shed: set[str] = set()

    @classmethod
    def from_config(cls, cfg) -> "FleetShedPolicy":
        return cls(high=float(getattr(cfg, "degrade_queue_high", 0.9)),
                   low=float(getattr(cfg, "degrade_queue_low", 0.25)),
                   hold=int(getattr(cfg, "degrade_hold_segments", 3)))

    def observe(self, pressure: float, loss_active: bool,
                lanes: list[tuple]) -> set[str]:
        """One fleet-scheduler observation.  ``pressure`` is the
        fraction of running lanes that waited on their sink since the
        last observation; ``lanes`` is [(name, priority, real_time)]
        — or [(name, priority, real_time, batched)] when the fleet
        runs cross-stream batching, or [(..., batched, device)] when
        it runs on a device pool (the label attributes shed/restore
        decisions per pool member) — for every RUNNING lane.  Returns
        the set of stream names currently force-shed (their lanes
        drop whole segments as accounted per-stream loss until
        restored).

        Batch-aware shed: within a priority band, an UNBATCHED lane
        sheds first — shedding a batch-group member also degrades its
        whole family (the formed batches thin out for every
        co-tenant), while shedding a solo lane costs one tenant.
        Restore order mirrors it (batched members come back first)."""
        lanes5 = [(e[0], e[1], e[2],
                   bool(e[3]) if len(e) > 3 else False,
                   e[4] if len(e) > 4 else None)
                  for e in lanes]
        live = {name for name, _, _, _, _ in lanes5}
        self.shed &= live  # finished lanes leave the shed set
        device_of = {name: dev for name, _, _, _, dev in lanes5}
        sheddable = sorted(
            ((prio, batched, name)
             for name, prio, rt, batched, _dev in lanes5
             if rt and name not in self.shed))
        restorable = sorted(
            ((prio, batched, name)
             for name, prio, _, batched, _dev in lanes5
             if name in self.shed), reverse=True)
        if pressure >= self.high or loss_active:
            self._above += 1
            self._below = 0
        elif pressure <= self.low and not loss_active:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if self._above >= self.hold and sheddable:
            prio, _batched, name = sheddable[0]
            self.shed.add(name)
            self._above = 0
            metrics.add("fleet_sheds")
            metrics.add("fleet_sheds", labels={"stream": name})
            dev = device_of.get(name)
            events.emit("fleet.force_shed", trace=0, stream=name,
                        info=f"priority={prio}"
                        + (f" device={dev}" if dev else ""))
            log.warning(
                f"[fleet] sustained fleet pressure {pressure:.2f} "
                f"(loss={loss_active}): shedding lowest-priority "
                f"real-time stream {name!r} (priority {prio})")
        elif self._below >= self.hold and restorable:
            prio, _batched, name = restorable[0]
            self.shed.discard(name)
            self._below = 0
            metrics.add("fleet_restores")
            metrics.add("fleet_restores", labels={"stream": name})
            events.emit("fleet.restore", trace=0, stream=name,
                        info=f"priority={prio}")
            log.info(f"[fleet] pressure cleared: restoring stream "
                     f"{name!r} (priority {prio})")
        metrics.set("fleet_shed_streams", len(self.shed))
        return set(self.shed)
