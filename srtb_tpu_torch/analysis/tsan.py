"""Opt-in runtime concurrency checker (``Config.tsan``; port of
``srtb_tpu/analysis/tsan.py``) — the dynamic twin of the srtb-tsan lint
rules (rules/lock_order.py & friends).

The static rules see *spellings*; this module sees *behavior*, with
the sanitizer's zero-cost-off contract: the fleet holds ``None`` when
``Config.tsan`` is off, every hook site is an ``if ts is not None``,
and the locks themselves are plain ``threading`` objects — no wrapper
indirection on the hot path unless the knob is on.

When on:

- **lockdep order graph**: every instrumented acquisition records an
  edge ``held -> wanted`` in a global order graph; an acquisition that
  would close a cycle raises :class:`TsanError` BEFORE acquiring — the
  *potential* deadlock is trapped on whichever thread hits the
  inverted order first, without needing the fatal interleave itself.
  Re-acquiring a non-reentrant lock already held by this thread is the
  degenerate cycle and trapped the same way.
- **held-too-long stalls**: a lock held longer than ``stall_s`` is
  recorded (counter + warning, not an exception: a stall is a latency
  bug, not a correctness bug) with the hold site and duration.
- **ownership guards**: the sanitizer's claim-on-first-use
  ``assert_owner`` pattern, extended to fleet lane state and the batch
  former's group slots.
- **schedule perturbation**: an installed :class:`SchedulePerturber`
  injects deterministic yields/sleeps at every instrumented
  acquisition point, widening race windows reproducibly
  (tools/race_soak.py drives this; same seed => same schedule).
"""

from __future__ import annotations

import threading
import time
import zlib

from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics


class TsanError(AssertionError):
    """A concurrency tripwire fired: lock-order cycle, non-reentrant
    re-acquire, condvar misuse, or thread-ownership violation."""


# ------------------------------------------------------------------
# seeded schedule perturbation
# ------------------------------------------------------------------

class SchedulePerturber:
    """Deterministic yield/sleep injection at lock acquisition points.

    The decision for occurrence ``k`` of site ``site`` is a pure hash
    of ``(seed, site, k)`` — no RNG state, no wall clock — so the same
    seed yields the same perturbation schedule for any interleaving of
    threads hitting the sites, and a recorded (site, k) journal can be
    replayed exactly (tests/test_torch_tsan.py pins this, and holds the
    journal to the reference's).
    """

    def __init__(self, seed: int, rate: float = 0.25,
                 sleep_s: float = 0.002):
        self.seed = int(seed)
        self.rate = float(rate)
        self.sleep_s = float(sleep_s)
        self._mu = threading.Lock()
        self._counts: dict[str, int] = {}
        self.journal: list[tuple[str, int]] = []

    def decide(self, site: str, k: int) -> bool:
        """Pure: perturb occurrence ``k`` of ``site``?"""
        h = zlib.crc32(f"{self.seed}:{site}:{k}".encode())
        return (h % 10_000) < self.rate * 10_000

    def perturb(self, site: str) -> None:
        """Called at an instrumented acquisition point: maybe sleep."""
        with self._mu:
            k = self._counts.get(site, 0)
            self._counts[site] = k + 1
            hit = self.decide(site, k)
            if hit:
                self.journal.append((site, k))
        if hit:
            metrics.add("tsan_perturbs")
            # a real sleep (not just a GIL yield): wide enough to let
            # any thread runnable at this instant overtake us
            time.sleep(self.sleep_s)


_perturber: SchedulePerturber | None = None
_perturber_mu = threading.Lock()


def install_perturber(p: SchedulePerturber) -> None:
    """Arm ``p`` process-wide so fleets the caller did not construct
    (e.g. inside fleet_soak) still get perturbed acquisitions."""
    global _perturber
    with _perturber_mu:
        _perturber = p


def uninstall_perturber() -> None:
    global _perturber
    with _perturber_mu:
        _perturber = None


def current_perturber() -> SchedulePerturber | None:
    return _perturber


# ------------------------------------------------------------------
# instrumented primitives
# ------------------------------------------------------------------

class InstrumentedLock:
    """``threading.Lock`` with lockdep bookkeeping around acquire and
    release.  The inner lock is real — instrumentation adds checks, it
    never changes blocking semantics (except to raise instead of
    deadlocking on a detected cycle)."""

    def __init__(self, tsan: "Tsan", name: str):
        self._tsan = tsan
        self.name = name
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._tsan._before_acquire(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._tsan._after_acquire(self.name)
        return got

    def release(self) -> None:
        self._tsan._before_release(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class InstrumentedCondition:
    """``threading.Condition`` wrapper with the same bookkeeping.

    Deliberately NOT ``threading.Condition(lock=InstrumentedLock)``:
    ``Condition._is_owned`` probes with ``acquire(0)`` on the lock it
    already holds, which the lockdep self-edge trap would (correctly,
    for a user lock) flag.  Instead a plain Condition is wrapped and
    the tsan bookkeeping brackets acquire/release/wait — ``wait``
    releases the lock, so the held-stack entry is popped for the
    sleep and re-pushed on wakeup.
    """

    def __init__(self, tsan: "Tsan", name: str):
        self._tsan = tsan
        self.name = name
        self._inner = threading.Condition()

    def __enter__(self):
        self._tsan._before_acquire(self.name)
        self._inner.__enter__()
        self._tsan._after_acquire(self.name)
        return self

    def __exit__(self, *exc) -> None:
        self._tsan._before_release(self.name)
        self._inner.__exit__(*exc)

    def _assert_held(self, op: str) -> None:
        if not self._tsan._holds(self.name):
            raise TsanError(
                f"[tsan] {op} on condition '{self.name}' without "
                "holding its lock — the waiter can check its "
                "predicate, miss this notify, and sleep forever "
                "(srtb-lint: condvar-misuse)")

    def wait(self, timeout: float | None = None):
        self._assert_held("wait")
        self._tsan._before_release(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            self._tsan._after_acquire(self.name)

    def wait_for(self, predicate, timeout: float | None = None):
        self._assert_held("wait_for")
        self._tsan._before_release(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._tsan._after_acquire(self.name)

    def notify(self, n: int = 1) -> None:
        self._assert_held("notify")
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._assert_held("notify_all")
        self._inner.notify_all()


# ------------------------------------------------------------------
# the checker
# ------------------------------------------------------------------

class Tsan:
    """One fleet run's concurrency-checker state: the global
    acquisition-order graph, per-thread held stacks, stall log, and
    claim-on-first-use owners (the sanitizer pattern, extended to
    fleet lane state and batch-former group slots)."""

    def __init__(self, stall_s: float = 0.5):
        self.stall_s = float(stall_s)
        self._mu = threading.Lock()
        # a -> {b: "thread that first took b under a"}
        self._order: dict[str, dict[str, str]] = {}
        self._tls = threading.local()
        self._owners: dict[str, tuple[int, str]] = {}
        self.stalls: list[tuple[str, float, str]] = []

    def lock(self, name: str) -> InstrumentedLock:
        return InstrumentedLock(self, name)

    def condition(self, name: str) -> InstrumentedCondition:
        return InstrumentedCondition(self, name)

    # -- held bookkeeping

    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def _holds(self, name: str) -> bool:
        return any(n == name for n, _t in self._held())

    def _path(self, src: str, dst: str) -> bool:
        """Is there a path src -> ... -> dst in the order graph?
        (called with self._mu held)"""
        seen = set()
        stack = [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._order.get(n, ()))
        return False

    def _before_acquire(self, name: str) -> None:
        p = current_perturber()
        if p is not None:
            p.perturb(name)
        held = self._held()
        if self._holds(name):
            raise TsanError(
                f"[tsan] re-acquire of non-reentrant lock '{name}' "
                f"on thread '{threading.current_thread().name}' "
                "(already held) — self-deadlock (srtb-lint: "
                "lock-order-inversion)")
        if not held:
            return
        tname = threading.current_thread().name
        with self._mu:
            for h, _t in held:
                # adding h -> name: a cycle exists iff name already
                # reaches h.  Trap BEFORE acquiring — the potential
                # deadlock is the finding, no fatal interleave needed.
                if self._path(name, h):
                    first = self._order.get(name, {})
                    via = next((f"'{name}' -> '{k}' (first taken on "
                                f"thread '{first[k]}')"
                                for k in first if self._path(k, h)
                                or k == h), f"'{name}' -> ... -> '{h}'")
                    raise TsanError(
                        f"[tsan] lock-order inversion: thread "
                        f"'{tname}' holds '{h}' and wants '{name}', "
                        f"but the order {via} is already on record — "
                        "two threads interleaving these paths "
                        "deadlock; pick one global order (srtb-lint: "
                        "lock-order-inversion)")
                self._order.setdefault(h, {}).setdefault(name, tname)

    def _after_acquire(self, name: str) -> None:
        self._held().append((name, time.monotonic()))

    def _before_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                _n, t0 = held.pop(i)
                dt = time.monotonic() - t0
                if dt > self.stall_s:
                    metrics.add("tsan_stalls")
                    tname = threading.current_thread().name
                    with self._mu:
                        self.stalls.append((name, dt, tname))
                    log.warning(
                        f"[tsan] lock '{name}' held {dt * 1e3:.0f} ms "
                        f"by thread '{tname}' (stall_s="
                        f"{self.stall_s}) — a blocking call under "
                        "the lock? (srtb-lint: blocking-under-lock)")
                return

    # -- thread ownership (sanitizer pattern)

    def assert_owner(self, name: str) -> None:
        """Claim-on-first-use: the first thread to touch state
        ``name`` owns it for the run; any other thread is a
        cross-thread mutation bug."""
        t = threading.current_thread()
        with self._mu:
            owner = self._owners.setdefault(name, (t.ident, t.name))
        if owner[0] != t.ident:
            raise TsanError(
                f"[tsan] thread-ownership violation on '{name}': "
                f"owned by thread '{owner[1]}' but touched from "
                f"'{t.name}' — lane step state is scheduler-owned and "
                "former group slots are single-writer by design "
                "(srtb-lint: unguarded-shared-state)")

    def release_owners(self, prefix: str | None = None) -> None:
        """Drop claims (all, or those under ``prefix``) — e.g. when a
        lane is torn down and its successor may run on a new thread."""
        with self._mu:
            if prefix is None:
                self._owners.clear()
            else:
                for k in [k for k in self._owners
                          if k.startswith(prefix)]:
                    del self._owners[k]

    # -- reporting

    def report(self) -> dict:
        with self._mu:
            edges = sum(len(v) for v in self._order.values())
            return {
                "order_edges": edges,
                "order_nodes": len(
                    set(self._order)
                    | {b for v in self._order.values() for b in v}),
                "stalls": list(self.stalls),
                "owners": dict(self._owners),
            }
