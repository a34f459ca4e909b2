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

The reference's ``FleetShedPolicy`` serves its fleet only and comes with
ROADMAP A8.
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
