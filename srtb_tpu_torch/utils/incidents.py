"""Incident bundles: self-contained evidence dumps on escalation (port of
``srtb_tpu/utils/incidents.py``).

When a run escalates — :class:`LadderExhausted`,
:class:`ReinitBudgetExceeded`, :class:`WatchdogEscalation`, a wedged
sink, a wedged shutdown, manifest-recovery LOSS, a failed canary — the
counters say *that* it happened; the bundle says *what* happened: the
flight recorder's recent past, the offending segment's full causal
trace, the active plan, the config, a metrics snapshot and the last
journal spans, all in one directory an operator (or a bug report) can
carry away whole.

Layout (one directory per incident)::

    <incident_dir>/incident_NNN_<kind>/
        incident.json     kind, reason, wall time, trace_id, stream
        events.jsonl      flight-recorder tail (EventHub.dump format)
        trace.jsonl       events filtered to the offending trace_id
        plan.json         plan_name, ladder level (and plan_signature
                          for a processor that has one; the port's
                          processors have none)
        config.json       full Config snapshot
        metrics.json      metrics registry snapshot
        extra.json        caller-provided evidence (only when given —
                          e.g. canary verdict + quality timeline)
        spans_tail.jsonl  last spans of the telemetry journal

Bundles are published ATOMICALLY (the directory is assembled under
``.srtb_tmp`` and renamed into place; a crash mid-dump leaves a temp dir
the next recorder construction sweeps, never a half-bundle that looks
whole), **rate-limited** (``incident_min_interval_s`` between bundles of
one directory) and **bounded in count** (``incident_max_bundles``
directories kept; beyond that new incidents are counted as
``incidents_suppressed`` and only logged).

Dumping is best-effort: a failure to write a bundle logs and counts
(``incident_dump_failures``) but never masks or replaces the escalation
it was documenting.  It reads host state only — the registry, the
flight recorder, the config and the processor's plan name — so a dump
after a sticky CUDA fault touches nothing on the dead card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

from srtb_tpu_torch.utils import events
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

# matches io/writers.TMP_SUFFIX (not imported: the recorder stays
# importable without the sink stack)
TMP_SUFFIX = ".srtb_tmp"

BUNDLE_SCHEMA_VERSION = 1

# tail size of the journal snapshot: enough spans to cover the flight
# recorder's horizon without re-shipping a 64 MB journal per incident
SPANS_TAIL_LINES = 200


def _json_default(o):
    try:
        return list(o)
    except TypeError:
        return repr(o)


class IncidentRecorder:
    """Per-pipeline handle on the (filesystem-global) incident
    directory.  ``None`` from :meth:`from_config` when
    ``Config.incident_dir`` is empty."""

    # rate-limit state is keyed on the DIRECTORY, not the recorder
    # instance: several pipelines of one process pointing at the same
    # incident_dir share one clock, so a burst of escalations cannot
    # spend the bounded budget in one second
    _last_dump_by_dir: dict = {}
    _rate_lock = threading.Lock()

    def __init__(self, directory: str, max_bundles: int = 8,
                 min_interval_s: float = 30.0):
        self.directory = os.path.abspath(directory)
        self.max_bundles = max(1, int(max_bundles))
        self.min_interval_s = float(min_interval_s)
        os.makedirs(directory, exist_ok=True)
        # sweep half-assembled bundles from a previous life: anything
        # still under .srtb_tmp never became a bundle
        for name in os.listdir(directory):
            if name.endswith(TMP_SUFFIX):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    @classmethod
    def from_config(cls, cfg) -> "IncidentRecorder | None":
        d = str(cfg.incident_dir or "")
        if not d:
            return None
        return cls(d, max_bundles=int(cfg.incident_max_bundles or 8),
                   min_interval_s=float(cfg.incident_min_interval_s))

    # ------------------------------------------------------- dumping

    def _existing(self) -> list[str]:
        try:
            return sorted(n for n in os.listdir(self.directory)
                          if n.startswith("incident_")
                          and not n.endswith(TMP_SUFFIX))
        except OSError:
            return []

    def dump(self, kind: str, reason: str = "",
             trace: int | None = None, stream: str = "",
             cfg=None, processor=None,
             journal_path: str = "",
             extra=None) -> str | None:
        """Write one bundle; returns its directory, or None when
        rate-limited, bounded or failed.  Never raises.  ``extra`` is an
        optional JSON-able payload landing as ``extra.json`` — the
        escalation site's own evidence (e.g. the canary verdict plus the
        recent quality timeline)."""
        try:
            return self._dump(kind, reason, trace, stream, cfg,
                              processor, journal_path, extra)
        except Exception as e:  # noqa: BLE001 - best-effort contract
            metrics.add("incident_dump_failures")
            log.error(f"[incident] bundle dump failed ({kind}): {e!r}")
            return None

    def _claim_slot(self, kind: str) -> tuple[bool, float, float]:
        """Take the directory's rate slot: (granted, now, the previous
        dump's time)."""
        now = time.monotonic()
        with self._rate_lock:
            last = self._last_dump_by_dir.get(self.directory, 0.0)
            if last and now - last < self.min_interval_s:
                granted = False
            else:
                # claimed atomically: two pipelines failing in the same
                # instant must not both pass the check
                self._last_dump_by_dir[self.directory] = now
                granted = True
        if not granted:
            metrics.add("incidents_suppressed")
            log.warning(f"[incident] {kind}: rate-limited "
                        f"(< {self.min_interval_s:g}s since the last "
                        "bundle)")
        return granted, now, last

    def _dump(self, kind, reason, trace, stream, cfg, processor,
              journal_path, extra=None) -> str | None:
        granted, now, last = self._claim_slot(kind)
        if not granted:
            return None
        existing = self._existing()
        if len(existing) >= self.max_bundles:
            # give the claimed rate slot back: a count-suppressed attempt
            # must not also rate-limit a later incident into a directory
            # the operator has since cleared
            with self._rate_lock:
                if self._last_dump_by_dir.get(self.directory) == now:
                    self._last_dump_by_dir[self.directory] = last
            metrics.add("incidents_suppressed")
            log.warning(
                f"[incident] {kind}: {len(existing)} bundle(s) already "
                f"kept (incident_max_bundles={self.max_bundles}); "
                "suppressing — the earliest escalations hold the story")
            return None
        if trace is None:
            trace = events.current()[0]
        seq = 0
        for name in existing:
            try:
                seq = max(seq, int(name.split("_")[1]) + 1)
            except (IndexError, ValueError):
                continue
        safe_kind = "".join(c if c.isalnum() or c in "-_" else "_"
                            for c in str(kind)) or "incident"
        final = os.path.join(self.directory,
                             f"incident_{seq:03d}_{safe_kind}")
        tmp = final + TMP_SUFFIX
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)

        def put(name: str, obj) -> None:
            with open(os.path.join(tmp, name), "w") as f:
                json.dump(obj, f, sort_keys=True, indent=1,
                          default=_json_default)
                f.write("\n")

        put("incident.json", {
            "schema": BUNDLE_SCHEMA_VERSION,
            "kind": str(kind),
            "reason": str(reason),
            "ts": time.time(),
            "trace_id": int(trace or 0),
            "stream": str(stream or ""),
            "pid": os.getpid(),
        })
        hub = events.hub
        n_ev = n_tr = 0
        if hub is not None:
            n_ev = hub.dump_jsonl(os.path.join(tmp, "events.jsonl"))
            if trace:
                n_tr = hub.dump_jsonl(os.path.join(tmp, "trace.jsonl"),
                                      trace=int(trace))
        if processor is not None:
            put("plan.json", self._plan(processor, stream))
        if cfg is not None:
            try:
                snap = dataclasses.asdict(cfg)
            except TypeError:
                snap = {k: v for k, v in vars(cfg).items()
                        if not k.startswith("_")}
            put("config.json", snap)
        put("metrics.json", metrics.snapshot())
        if extra is not None:
            put("extra.json", extra)
        jp = journal_path or (cfg.telemetry_journal_path
                              if cfg is not None else "")
        if jp and os.path.exists(jp):
            self._spans_tail(jp, os.path.join(tmp, "spans_tail.jsonl"))
        os.replace(tmp, final)
        metrics.add("incident_bundles")
        if stream:
            metrics.add("incident_bundles", labels={"stream": stream})
        events.emit("incident", trace=int(trace or 0),
                    stream=str(stream or ""),
                    info=os.path.basename(final))
        log.error(f"[incident] {kind}: bundle written to {final} "
                  f"({n_ev} events, {n_tr} on the offending trace)")
        return final

    @staticmethod
    def _plan(processor, stream: str) -> dict:
        """``plan.json``: the plan's name (a host attribute, no device
        query), its signature where the processor has one, and the
        stream's ladder level (a named stream reads its labeled gauge:
        the flat one is last-writer-wins across streams)."""
        plan = {"plan_name": getattr(processor, "plan_name", None)}
        sig = getattr(processor, "plan_signature", None)
        if callable(sig):
            try:
                plan["plan_signature"] = sig()
            except Exception as e:  # noqa: BLE001 - the bundle still
                # names the plan
                plan["plan_signature"] = f"<unavailable: {e!r}>"
        plan["plan_ladder_level"] = int(metrics.get(
            "plan_ladder_level",
            labels={"stream": stream} if stream else None))
        return plan

    @staticmethod
    def _spans_tail(journal: str, out: str) -> None:
        """The journal's last ``SPANS_TAIL_LINES`` lines, from a bounded
        read of its end (the active journal can be tens of MB)."""
        try:
            with open(journal, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                budget = SPANS_TAIL_LINES * 4096
                f.seek(max(0, size - budget))
                chunk = f.read()
            lines = chunk.splitlines(keepends=True)
            if size > budget and lines:
                lines = lines[1:]  # drop the torn first line
            with open(out, "wb") as f:
                f.writelines(lines[-SPANS_TAIL_LINES:])
        except OSError as e:
            log.warning(f"[incident] journal tail unavailable: {e}")
