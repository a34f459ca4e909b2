"""Bounded-restart supervision for crashed workers (port of
``srtb_tpu/resilience/supervisor.py``).

A :class:`Supervisor` gives a supervised component (the viewer's serve
thread) a restart budget: ``max_restarts`` within a sliding window of
``window_s`` seconds, then it escalates.  The reference also classifies
the crash (fatal crashes escalate at once unless ``restart_fatal``); that
taxonomy is ROADMAP A7's, so until it is ported only ``restart_fatal=True``
supervisors exist, and they restart whatever the error.  The reference's
restart counters and flight-recorder events wait for ROADMAP A9.
"""

from __future__ import annotations

import collections
import time

from srtb_tpu_torch.utils.logging import log


class Supervisor:
    """Restart-budget bookkeeping for one named component.

    ``should_restart(exc)`` is the whole protocol: the owner of the
    worker calls it when the worker dies; True means "spawn a
    replacement" (the restart is counted against the window), False
    means "escalate" (budget exhausted within ``window_s``)."""

    def __init__(self, name: str, max_restarts: int = 3,
                 window_s: float = 60.0, restart_fatal: bool = False,
                 clock=time.monotonic):
        if not restart_fatal:
            raise NotImplementedError(
                "a supervisor that classifies crashes (restart_fatal="
                "False) needs the error taxonomy, not ported yet (ROADMAP "
                "A7)")
        self.name = name
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self.restart_fatal = restart_fatal
        self._clock = clock
        self._restarts: collections.deque[float] = collections.deque()

    @property
    def restarts(self) -> int:
        return len(self._restarts)

    def _expire(self, now: float) -> None:
        while self._restarts and now - self._restarts[0] > self.window_s:
            self._restarts.popleft()

    def should_restart(self, exc: BaseException) -> bool:
        now = self._clock()
        self._expire(now)
        if len(self._restarts) >= self.max_restarts:
            log.error(
                f"[supervisor] {self.name}: {exc!r} — restart budget "
                f"exhausted ({self.max_restarts} in {self.window_s:g}s);"
                " escalating to clean shutdown")
            return False
        self._restarts.append(now)
        log.warning(
            f"[supervisor] {self.name}: crashed with {exc!r}; "
            f"restarting ({len(self._restarts)}/{self.max_restarts} "
            f"in window)")
        return True
