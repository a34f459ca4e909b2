"""Bounded-restart supervision for crashed workers (port of
``srtb_tpu/resilience/supervisor.py``).

A :class:`Supervisor` gives a supervised component (the engine's
``sink_drain`` pipe, the viewer's serve thread) a restart budget: crashes
classified transient, data-loss or device are restarted while the budget
inside the sliding window lasts; fatal crashes (unless ``restart_fatal``)
and spent budgets escalate to the clean shutdown.  The same budget bounds
the demotion ladder's device reinits (``resilience/demote.py``, which
counts nothing here).  Each approved restart adds one to ``counter``
(``worker_restarts`` by default, None: none) and ``<counter>_<name>`` in
the metrics registry, and emits a ``supervisor.restart`` event.
"""

from __future__ import annotations

import collections
import time

from srtb_tpu_torch.resilience.errors import FATAL, classify
from srtb_tpu_torch.utils import events
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics


class Supervisor:
    """Restart-budget bookkeeping for one named component.

    ``should_restart(exc)`` is the whole protocol: the owner of the
    worker calls it when the worker dies; True means "spawn a
    replacement" (the restart is counted against the window), False
    means "escalate" (a fatal crash, or the budget spent within
    ``window_s``).  ``restart_fatal=True`` restarts whatever the crash,
    for best-effort components such as the viewer."""

    def __init__(self, name: str, max_restarts: int = 3,
                 window_s: float = 60.0, restart_fatal: bool = False,
                 clock=time.monotonic,
                 counter: str | None = "worker_restarts"):
        self.name = name
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self.restart_fatal = restart_fatal
        self.counter = counter
        self._clock = clock
        self._restarts: collections.deque[float] = collections.deque()

    @property
    def restarts(self) -> int:
        return len(self._restarts)

    def remaining(self) -> int:
        """The restart budget left inside the current window (advisory;
        ``should_restart`` decides), after the window's old restarts
        expire."""
        self._expire(self._clock())
        return max(0, self.max_restarts - len(self._restarts))

    def _expire(self, now: float) -> None:
        while self._restarts and now - self._restarts[0] > self.window_s:
            self._restarts.popleft()

    def should_restart(self, exc: BaseException) -> bool:
        if not self.restart_fatal and classify(exc) == FATAL:
            log.error(f"[supervisor] {self.name}: fatal {exc!r}; "
                      "escalating (not restartable)")
            return False
        now = self._clock()
        self._expire(now)
        if len(self._restarts) >= self.max_restarts:
            log.error(
                f"[supervisor] {self.name}: {exc!r} — restart budget "
                f"exhausted ({self.max_restarts} in {self.window_s:g}s);"
                " escalating to clean shutdown")
            return False
        self._restarts.append(now)
        if self.counter:
            metrics.add(self.counter)
            metrics.add(f"{self.counter}_{self.name}")
        events.emit("supervisor.restart",
                    info=f"{self.name}:{len(self._restarts)}")
        log.warning(
            f"[supervisor] {self.name}: crashed with {exc!r}; "
            f"restarting ({len(self._restarts)}/{self.max_restarts} "
            f"in window)")
        return True
