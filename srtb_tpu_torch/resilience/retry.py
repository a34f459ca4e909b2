"""Retry with exponential backoff, deterministic jitter and deadlines
(port of ``srtb_tpu/resilience/retry.py``).

Applied by the pipeline to its six fault sites (ingest, h2d, dispatch,
fetch, sink_write, checkpoint).  Only failures classified TRANSIENT or
DATA_LOSS (:func:`srtb_tpu_torch.resilience.errors.classify`) are
retried; FATAL failures and spent budgets propagate, and DEVICE failures
propagate un-retried to the plan-demotion ladder
(``resilience/demote.py``): the recovery of an out-of-memory is a cheaper
plan, not the same chain again.

The jitter is deterministic (``crc32("site:attempt")``), so a replayed
run backs off identically.  Every retry is counted (``retries_total`` and
``retries_<site>``).
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass

from srtb_tpu_torch.resilience.errors import DATA_LOSS, TRANSIENT, classify
from srtb_tpu_torch.utils import events
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics


@dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` includes the first try; ``deadline_s`` bounds the
    wall clock of one guarded operation with its backoff sleeps (0: no
    bound); ``jitter`` is a +/- fraction of each backoff."""

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.25
    deadline_s: float = 0.0

    @classmethod
    def from_config(cls, cfg) -> "RetryPolicy | None":
        """None when retries are off (``retry_max_attempts <= 1``): the
        pipeline then calls its operations directly."""
        attempts = int(getattr(cfg, "retry_max_attempts", 0) or 0)
        if attempts <= 1:
            return None
        return cls(
            max_attempts=attempts,
            backoff_base_s=float(getattr(cfg, "retry_backoff_base_s",
                                         0.05)),
            backoff_max_s=float(getattr(cfg, "retry_backoff_max_s", 2.0)),
            deadline_s=float(getattr(cfg, "retry_deadline_s", 0.0)))

    def backoff(self, site: str, attempt: int) -> float:
        """The backoff of (site, attempt): exponential, capped, with the
        deterministic jitter."""
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2 ** (attempt - 1)))
        h = zlib.crc32(f"{site}:{attempt}".encode()) / 0xFFFFFFFF
        return base * (1.0 + self.jitter * (2.0 * h - 1.0))


def retry_call(fn, policy: RetryPolicy, site: str, sleep=time.sleep):
    """Run ``fn`` under ``policy``, counting ``retries_total``,
    ``retries_<site>`` and ``data_loss_total`` (a ``retry`` event an
    attempt, on the thread's current trace).
    Raises the last failure when it is not TRANSIENT or DATA_LOSS, when
    the attempts are spent, or when the next backoff would cross the
    deadline.  The path without a failure is one try/except."""
    try:
        return fn()
    except BaseException as e:  # noqa: BLE001 - classified below
        exc = e
    t0 = time.monotonic()
    attempt = 1
    while True:
        cat = classify(exc)
        if cat not in (TRANSIENT, DATA_LOSS):
            # FATAL escalates; DEVICE goes to the demotion ladder
            raise exc
        if cat == DATA_LOSS:
            # the retry may succeed, but the loss itself happened
            metrics.add("data_loss_total")
        if attempt >= policy.max_attempts:
            log.error(f"[resilience] {site}: {exc!r} — retry budget "
                      f"({policy.max_attempts} attempts) exhausted")
            raise exc
        delay = policy.backoff(site, attempt)
        if policy.deadline_s > 0 and \
                time.monotonic() - t0 + delay > policy.deadline_s:
            log.error(f"[resilience] {site}: {exc!r} — retry deadline "
                      f"{policy.deadline_s}s would be exceeded")
            raise exc
        metrics.add("retries_total")
        metrics.add(f"retries_{site}")
        events.emit("retry", info=f"{site}:{cat}:{attempt}")
        log.warning(
            f"[resilience] {site}: {cat} {exc!r}; retrying "
            f"({attempt}/{policy.max_attempts - 1}) in "
            f"{delay * 1e3:.0f} ms")
        sleep(delay)
        attempt += 1
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001
            exc = e
