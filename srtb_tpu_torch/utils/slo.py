"""Per-stream SLO burn-rate evaluation (port of ``srtb_tpu/utils/slo.py``).

The /healthz staleness probe answers "is it alive"; the degrade and
demotion ladders answer "is it coping".  Neither answers the operator
question that decides whether to page: **are we spending error budget
faster than we can afford** — "degraded but within budget" and
"burning error budget" are different states, and conflating them
either pages on every transient or sleeps through a slow burn.

Three configurable objectives, each evaluated per stream (the flat
process-wide series doubles as the solo pipeline's stream):

- **latency**  (``slo_latency_ms`` > 0 arms): a segment is *bad* when
  its host wall clock (the span's summed stages) exceeds the target;
  the budget is ``slo_latency_budget`` (allowed bad fraction).
- **loss**     (``slo_loss_budget`` > 0 arms): bad fraction =
  dropped / (drained + dropped) — accounted whole-segment loss only,
  the same quantity ``segments_dropped`` counts.
- **staleness** (``slo_staleness_s`` > 0 arms): bad time = seconds the
  stream has gone beyond the allowed gap since its last segment; the
  budget is ``slo_staleness_budget`` (allowed stale fraction of the
  window).
- **sensitivity** (``slo_sensitivity_budget`` > 0 arms): a checked
  pulse-injection canary is *bad* when
  its recovered S/N falls below ``canary_min_ratio`` of the expected
  reference; the budget is the allowed bad fraction of checks.
  The canary is ROADMAP A9b: until it lands nothing calls
  :meth:`SloTracker.note_canary`, and the objective stays at ``ok``.

Each objective is evaluated over TWO windows — ``slo_fast_window_s``
(default 5 min) and ``slo_slow_window_s`` (default 1 h) — the standard
multi-window burn-rate recipe: **burn = bad_fraction / budget** (1.0 =
spending exactly the budget), and a stream is *burning* only when BOTH
windows exceed ``slo_burn_threshold`` — the fast window makes the
alert prompt, the slow window keeps a brief spike from paging.  States:

- ``ok``        no violations in the slow window;
- ``degraded``  violations present, burn below threshold (within
  budget — visible, not pageable);
- ``burning``   both windows above threshold.

Every evaluation lands in the metrics registry as labeled gauges —
``slo_burn_rate{objective=,window=[,stream=]}`` and
``slo_state{objective=[,stream=]}`` (0 ok / 1 degraded / 2 burning) —
so Prometheus alerting and /healthz (which embeds :func:`evaluate`'s
report) see the same numbers.  State transitions also emit ``slo``
events onto the flight recorder.

Like the metrics registry and the event hub, the tracker is
process-global: ``configure(cfg)`` arms it (``Pipeline.__init__`` calls
it; pipelines of one process share it and are told apart by stream).
"""

from __future__ import annotations

import threading
import time

from srtb_tpu_torch.utils import events
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

OBJECTIVES = ("latency", "loss", "staleness", "sensitivity")
STATE_OK = "ok"
STATE_DEGRADED = "degraded"
STATE_BURNING = "burning"
_STATE_CODE = {STATE_OK: 0, STATE_DEGRADED: 1, STATE_BURNING: 2}


class _Ratio:
    """bad/total over one trailing window, in FIXED time buckets.

    A deque-of-events window stores one tuple per observation for the
    whole window — at tens of segments/s over a 1-hour slow window
    that is ~10^5 retained tuples per series per stream, for a metric
    that only ever needs a ratio.  ``n_buckets`` counters (epoch-
    stamped, recycled in place) compute the same burn fractions in
    O(buckets) memory and O(1) per add, at a granularity of
    window/n_buckets (irrelevant against the burn thresholds).
    Not self-locking: the owning tracker serializes access."""

    __slots__ = ("bucket_s", "n", "tot", "bad", "stamp", "_clock")

    def __init__(self, window_s: float, clock, n_buckets: int = 60):
        self.n = int(n_buckets)
        self.bucket_s = float(window_s) / self.n
        self.tot = [0.0] * self.n
        self.bad = [0.0] * self.n
        self.stamp = [-1] * self.n   # epoch index currently held
        self._clock = clock

    def _slot(self) -> int:
        k = int(self._clock() // self.bucket_s)
        i = k % self.n
        if self.stamp[i] != k:  # recycle an expired bucket in place
            self.stamp[i] = k
            self.tot[i] = 0.0
            self.bad[i] = 0.0
        return i

    def add(self, n: float, bad: float) -> None:
        i = self._slot()
        self.tot[i] += n
        self.bad[i] += bad

    def total(self) -> float:
        kmin = int(self._clock() // self.bucket_s) - self.n + 1
        return sum(t for t, s in zip(self.tot, self.stamp)
                   if s >= kmin)

    def fraction(self) -> tuple[float, float]:
        kmin = int(self._clock() // self.bucket_s) - self.n + 1
        t = b = 0.0
        for i in range(self.n):
            if self.stamp[i] >= kmin:
                t += self.tot[i]
                b += self.bad[i]
        return (b / t if t > 0 else 0.0), b


class _StreamState:
    def __init__(self, fast_s: float, slow_s: float, clock):
        self.lat = (_Ratio(fast_s, clock), _Ratio(slow_s, clock))
        self.loss = (_Ratio(fast_s, clock), _Ratio(slow_s, clock))
        self.sens = (_Ratio(fast_s, clock), _Ratio(slow_s, clock))
        self.last_segment: float | None = None
        self.states: dict[str, str] = {}


class SloTracker:
    """Burn-rate state for every observed stream ("" = the solo /
    process-wide pipeline).  Thread-safe: segments feed from engine or
    sink threads, the scraper evaluates from the HTTP thread."""

    def __init__(self, latency_ms: float = 0.0,
                 latency_budget: float = 0.01,
                 loss_budget: float = 0.0,
                 staleness_s: float = 0.0,
                 staleness_budget: float = 0.05,
                 sensitivity_budget: float = 0.0,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 burn_threshold: float = 1.0,
                 clock=time.monotonic):
        self.latency_ms = float(latency_ms)
        self.latency_budget = max(1e-9, float(latency_budget))
        self.loss_budget = float(loss_budget)
        self.staleness_s = float(staleness_s)
        self.staleness_budget = max(1e-9, float(staleness_budget))
        self.sensitivity_budget = float(sensitivity_budget)
        self.fast_s = float(fast_window_s)
        self.slow_s = float(slow_window_s)
        self.threshold = float(burn_threshold)
        self._clock = clock
        self._lock = threading.Lock()
        self._streams: dict[str, _StreamState] = {}

    @property
    def objectives(self) -> tuple[str, ...]:
        out = []
        if self.latency_ms > 0:
            out.append("latency")
        if self.loss_budget > 0:
            out.append("loss")
        if self.staleness_s > 0:
            out.append("staleness")
        if self.sensitivity_budget > 0:
            out.append("sensitivity")
        return tuple(out)

    @classmethod
    def from_config(cls, cfg) -> "SloTracker | None":
        """None (zero-cost off) when no objective is armed."""
        t = cls(
            latency_ms=float(getattr(cfg, "slo_latency_ms", 0.0) or 0),
            latency_budget=float(getattr(cfg, "slo_latency_budget",
                                         0.01)),
            loss_budget=float(getattr(cfg, "slo_loss_budget", 0.0)
                              or 0),
            staleness_s=float(getattr(cfg, "slo_staleness_s", 0.0)
                              or 0),
            staleness_budget=float(getattr(cfg, "slo_staleness_budget",
                                           0.05)),
            sensitivity_budget=float(getattr(
                cfg, "slo_sensitivity_budget", 0.0) or 0),
            fast_window_s=float(getattr(cfg, "slo_fast_window_s",
                                        300.0)),
            slow_window_s=float(getattr(cfg, "slo_slow_window_s",
                                        3600.0)),
            burn_threshold=float(getattr(cfg, "slo_burn_threshold",
                                         1.0)))
        return t if t.objectives else None

    # ------------------------------------------------------- feeding

    def _state(self, stream: str) -> _StreamState:
        st = self._streams.get(stream)
        if st is None:
            with self._lock:
                st = self._streams.setdefault(
                    stream, _StreamState(self.fast_s, self.slow_s,
                                         self._clock))
        return st

    def note_segment(self, stream: str, latency_s: float) -> None:
        """One drained segment: feeds the latency ratio and the loss
        denominator, and refreshes the staleness stamp.  The bucket
        counters are not self-locking — the tracker lock serializes
        feeders (engine/sink threads) against the scraper."""
        st = self._state(stream or "")
        bad = 1.0 if (self.latency_ms > 0
                      and latency_s * 1e3 > self.latency_ms) else 0.0
        with self._lock:
            for r in st.lat:
                r.add(1.0, bad)
            for r in st.loss:
                r.add(1.0, 0.0)
            st.last_segment = self._clock()

    def note_dropped(self, stream: str, n: int = 1) -> None:
        """``n`` accounted whole-segment drops."""
        st = self._state(stream or "")
        with self._lock:
            for r in st.loss:
                r.add(float(n), float(n))

    def note_canary(self, stream: str, ok: bool) -> None:
        """One checked pulse-injection canary: bad when the recovered
        S/N failed the sensitivity gate."""
        st = self._state(stream or "")
        bad = 0.0 if ok else 1.0
        with self._lock:
            for r in st.sens:
                r.add(1.0, bad)

    # ---------------------------------------------------- evaluation

    def _burns(self, st: _StreamState, objective: str,
               now: float) -> tuple[float, float, float]:
        """(burn_fast, burn_slow, bad_slow) for one objective."""
        if objective == "latency":
            (ff, _), (fs, bs) = (st.lat[0].fraction(),
                                 st.lat[1].fraction())
            return (ff / self.latency_budget,
                    fs / self.latency_budget, bs)
        if objective == "loss":
            (ff, _), (fs, bs) = (st.loss[0].fraction(),
                                 st.loss[1].fraction())
            return ff / self.loss_budget, fs / self.loss_budget, bs
        if objective == "sensitivity":
            (ff, _), (fs, bs) = (st.sens[0].fraction(),
                                 st.sens[1].fraction())
            return (ff / self.sensitivity_budget,
                    fs / self.sensitivity_budget, bs)
        # staleness: time beyond the allowed gap, as a window fraction
        if st.last_segment is None:
            return 0.0, 0.0, 0.0  # startup: no budget spent yet
        over = max(0.0, (now - st.last_segment) - self.staleness_s)
        bf = (min(over, self.fast_s) / self.fast_s) \
            / self.staleness_budget
        bs = (min(over, self.slow_s) / self.slow_s) \
            / self.staleness_budget
        return bf, bs, over

    def evaluate(self) -> dict:
        """stream -> objective -> {burn_fast, burn_slow, state}; also
        refreshes the ``slo_burn_rate`` / ``slo_state`` gauges and
        emits an ``slo`` event on every state transition."""
        now = self._clock()
        with self._lock:
            streams = dict(self._streams)
        out = {}
        for stream, st in sorted(streams.items()):
            per = {}
            for obj in self.objectives:
                with self._lock:
                    bf, bs, bad = self._burns(st, obj, now)
                    if bf >= self.threshold and bs >= self.threshold:
                        state = STATE_BURNING
                    elif bad > 0:
                        state = STATE_DEGRADED
                    else:
                        state = STATE_OK
                    # claim the transition ATOMICALLY: /metrics and
                    # /healthz both evaluate from the threaded HTTP
                    # server, and two scrapes crossing a threshold at
                    # once must emit/log the transition exactly once.
                    # A never-evaluated objective baselines at "ok":
                    # a stream that is already burning at its FIRST
                    # scrape must emit the onset, not swallow it.
                    prev = st.states.get(obj, STATE_OK)
                    st.states[obj] = state
                changed = prev != state
                per[obj] = {"burn_fast": round(bf, 4),
                            "burn_slow": round(bs, 4),
                            "state": state}
                base = {"objective": obj}
                if stream:
                    base["stream"] = stream
                metrics.set("slo_burn_rate", bf,
                            labels=dict(base, window="fast"))
                metrics.set("slo_burn_rate", bs,
                            labels=dict(base, window="slow"))
                metrics.set("slo_state", _STATE_CODE[state],
                            labels=base)
                if changed:
                    events.emit("slo", trace=0, stream=stream,
                                info=f"{obj}:{prev}->{state}")
                    lvl = (log.warning if state == STATE_BURNING
                           else log.info)
                    lvl(f"[slo] {stream or 'pipeline'}/{obj}: "
                        f"{prev} -> {state} (burn fast {bf:.2f} / "
                        f"slow {bs:.2f})")
            per["ok"] = all(v["state"] != STATE_BURNING
                            for k, v in per.items() if k != "ok")
            out[stream or "_pipeline"] = per
        return out


# ---------------------------------------------------------------------
# process-global tracker (the /healthz + /metrics view)
# ---------------------------------------------------------------------

tracker: SloTracker | None = None


def configure(cfg) -> "SloTracker | None":
    """Arm the process-global tracker from ``cfg`` (None when no
    objective is configured — zero-cost off).  An armed tracker with
    identical parameters is KEPT (fleet lanes must not wipe each
    other's windows)."""
    global tracker
    new = SloTracker.from_config(cfg)
    if new is None:
        # deliberately NOT disarming a live tracker: in a fleet, a
        # lane without objectives must not blind its neighbors'
        cur = tracker
        return cur
    cur = tracker
    if cur is not None and (
            cur.latency_ms, cur.latency_budget, cur.loss_budget,
            cur.staleness_s, cur.staleness_budget,
            cur.sensitivity_budget, cur.fast_s,
            cur.slow_s, cur.threshold) == (
            new.latency_ms, new.latency_budget, new.loss_budget,
            new.staleness_s, new.staleness_budget,
            new.sensitivity_budget, new.fast_s,
            new.slow_s, new.threshold):
        return cur
    tracker = new
    return new


def reset() -> None:
    """Disarm (tests)."""
    global tracker
    tracker = None


def note_segment(stream: str, latency_s: float) -> None:
    t = tracker
    if t is not None:
        t.note_segment(stream, latency_s)


def note_dropped(stream: str, n: int = 1) -> None:
    t = tracker
    if t is not None:
        t.note_dropped(stream, n)


def note_canary(stream: str, ok: bool) -> None:
    t = tracker
    if t is not None:
        t.note_canary(stream, ok)


def evaluate() -> dict | None:
    """The /healthz + /metrics refresh hook: None when disarmed."""
    t = tracker
    return t.evaluate() if t is not None else None
