"""The resilience layers' counters (the reference keeps them in
``srtb_tpu/utils/metrics``, ROADMAP A9; until that lands the port keeps
them here, and ``Pipeline.run`` copies them into ``stats.extras``).

Names are the reference's: ``plan_demotions``, ``plan_promotions``,
``device_reinits``, ``plan_ladder_level``, ``active_plan``,
``retries_total``, ``retries_<site>``, ``data_loss_total``,
``watchdog_requeues``, ``segments_dropped``, ``shed_waterfalls``,
``shed_baseband`` (the reference's name of the sheddable-sink counter),
``degrade_level``, ``degrade_steps``, ``degrade_recoveries``,
``faults_injected``, ``sink_restarts``.
"""

from __future__ import annotations

import threading
import time
from collections import deque

# the reference's sliding window of recent loss (metrics.window default)
LOSS_WINDOW_S = 10.0


class Counters:
    """Thread-safe counters and gauges, plus one sliding window a name
    (the sum of the increments of the last ``LOSS_WINDOW_S`` seconds)."""

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._values: dict = {}
        self._windows: dict[str, deque] = {}
        self._clock = clock

    def add(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0) + n

    def set(self, name: str, value) -> None:
        with self._lock:
            self._values[name] = value

    def get(self, name: str, default=0):
        with self._lock:
            return self._values.get(name, default)

    def window_add(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._windows.setdefault(name, deque()).append(
                (self._clock(), n))

    def window_sum(self, name: str) -> float:
        with self._lock:
            events = self._windows.get(name)
            if not events:
                return 0.0
            cutoff = self._clock() - LOSS_WINDOW_S
            while events and events[0][0] < cutoff:
                events.popleft()
            return float(sum(n for _t, n in events))

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._values)
