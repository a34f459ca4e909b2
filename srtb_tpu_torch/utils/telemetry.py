"""Segment-span telemetry: the rotating JSONL journal and pipeline health
(port of ``srtb_tpu/utils/telemetry.py``).

Every drained segment emits one structured JSONL record, as the
reference's does: segment id, per-stage host wall clock (from the
pipeline's ``StageTimer``), queue depth, the cumulative loss, recovery
and compile counters, detection count, the dump decision, the device
seconds and the live roofline fields, to a size-rotated journal file.
Host stages also run under ``torch.profiler.record_function``
(``utils/tracing.py``), so a profile capture and the journal correlate
by stage name.  ``health()`` feeds ``/healthz`` (``gui/server.py``)
with last-segment-age staleness.

The record is schema 11.  The port's single-card engine writes every
field of a solo reference run; like those, it leaves out ``batch_size``
and ``batch_wait_ms`` (the cross-stream batch former) and ``device``
(the device pool), which come with ROADMAP A8.
"""

from __future__ import annotations

import json
import os
import threading
import time

from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

# v2 (async overlap engine): adds ``overlap_hidden_ms`` (host/transfer
# time hidden under device compute for this segment) and
# ``inflight_depth`` (dispatched-not-yet-drained segments at drain
# time).
# v3 (resilience): adds the degradation state at drain
# (``degrade_level``) and the cumulative recovery counters
# ``retries`` / ``requeues`` / ``restarts`` / ``shed_waterfalls`` /
# ``shed_baseband`` (same cumulative convention as
# ``segments_dropped``: deltas between consecutive records localize a
# recovery burst to a segment).
# v4 (self-healing compute): adds the cumulative ``plan_demotions`` /
# ``plan_promotions`` / ``device_reinits`` counters, the demotion-
# ladder position at drain (``plan_ladder_level``, 0 = the configured
# plan) and — when the writer knows it — ``active_plan`` (the
# SegmentProcessor.plan_name active at drain time; consecutive-record
# changes give the plan timeline).
# v5 (durable outputs): adds the cumulative crash-recovery counters
# ``recovered_segments`` (committed segments the manifest rescued
# beyond the checkpoint at startup), ``replayed_skips`` (sink pushes
# skipped on replay because the manifest already holds their commit)
# and ``rolled_back_intents`` (uncommitted artifacts rolled back by
# manifest recovery) — all zero on a run that never crashed.
# v6 (multi-tenant fleet): adds ``stream`` (the Config.stream_name
# label of the stream this span belongs to — omitted on unnamed
# single-stream runs, never a fake placeholder) so a fleet journal
# (or N per-stream journals merged) attributes every span, loss
# burst, demotion and shed to its tenant.
# v7 (causal tracing): adds ``trace_id`` (the SegmentWork's causal id,
# utils/events.py — omitted when the engine never stamped one, e.g.
# events disabled) so a journal span and the flight recorder's events
# for the same segment correlate exactly; an incident bundle's
# spans_tail.jsonl joins its trace.jsonl on this field.
# v8 (performance observatory): adds per-segment DEVICE-time
# accounting and live roofline fields — ``device_ms`` (dispatch-return
# -> drain-head-ready wall clock: an upper bound on device busy time,
# exact in serial mode; omitted when the engine did not measure it),
# ``achieved_msamps`` / ``roofline_frac`` (this segment's throughput
# against its plan's audited hbm_passes traffic floor and the
# configured HBM peak — both LOWER bounds, since device_ms is an
# upper bound) — plus the cumulative compile/cache accounting
# ``compile_ms`` (first-dispatch trace+compile wall, plus AOT-miss
# compiles), ``plan_compiles``, ``aot_cache_hits`` /
# ``aot_cache_misses``.
# v9 (science observatory): adds two optional ``extra`` sections —
# ``quality`` (the per-segment data-quality dict QualityMonitor
# journals: zap_frac, bandpass mean/var, SK mean/max, dead/hot
# fractions, drift score/alert, and the coarse occupancy + bandpass
# maps) and ``canary`` (pulse-injection verdict: injected, segment,
# recovered/expected S/N, sensitivity ratio, ok — or just the
# injection flag on a replayed drain).  Both ride the existing
# ``extra`` envelope, so pre-v9 readers skip them.
# v10 (cross-tenant continuous batching): adds ``batch_size`` (how
# many segments — possibly from DIFFERENT streams — shared this
# segment's device dispatch; pipeline/fleet._BatchFormer) and
# ``batch_wait_ms`` (wall clock this segment waited in the former
# between becoming ready and the shared dispatch — the linger cost
# the fleet_batch_linger_ms deadline bounds).  Both OMITTED on solo
# dispatches (never a fake 1/0): a journal with no batching armed
# reads exactly as v9.
# v11 (elastic device pool): adds ``device`` — which pool member
# (pipeline/pool.py label, e.g. "dev0") this segment was dispatched
# through at drain time; after a live migration a lane's spans switch
# labels at the migration boundary, which is how the migration soak
# proves victims resumed on the survivor.  OMITTED outside a fleet
# (no pool, no label): a solo run's journal reads exactly as v10.
# Readers must tolerate mixed v1-v11 journals: rotation can leave an
# older-schema tail in the previous generation after an upgrade.
SPAN_SCHEMA_VERSION = 11

# gauge names shared between the pipeline (writer) and health() (reader)
LAST_SEGMENT_MONOTONIC = "last_segment_monotonic"
LAST_SEGMENT_UNIX = "last_segment_unix"


class SpanJournal:
    """Append-only JSONL with single-generation size rotation: when
    the active file would exceed ``max_bytes`` the previous generation
    is replaced and a fresh file starts — an always-on journal on a
    long observation can never fill the disk, and the last
    ~2 x max_bytes of spans are always on hand.  With ``compress``
    (the default) the rotated generation is gzipped to ``<path>.1.gz``
    (level 1 — ~10x smaller JSONL for one cheap pass, off the
    dispatch path since rotation happens at most once per max_bytes of
    spans); ``compress=False`` keeps the legacy plaintext ``<path>.1``.
    Readers take both (:func:`rotated_generation`)."""

    def __init__(self, path: str, max_bytes: int = 64 << 20,
                 compress: bool = True):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        self.path = path
        self.max_bytes = int(max_bytes)
        self.compress = bool(compress)
        self._lock = threading.Lock()
        # serializes gzip passes: a journal whose max_bytes fills
        # faster than one generation compresses must queue the second
        # pass, not interleave two writers into one temp file
        self._compress_lock = threading.Lock()
        self._rot_seq = 0
        self._published_seq = 0  # newest generation already in .1.gz
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # finish a rotation a previous life died in the middle of:
        # an orphaned .rotN plaintext generation becomes the legacy
        # .1 (newest wins, older orphans dropped — single-generation
        # semantics)
        base = os.path.basename(path)
        try:
            orphans = sorted(
                (os.path.join(d or ".", n)
                 for n in os.listdir(d or ".")
                 if n.startswith(base + ".rot")),
                key=lambda p: os.path.getmtime(p))
        except OSError:
            orphans = []
        for p in orphans[:-1]:
            try:
                os.unlink(p)
            except OSError:
                pass
        if orphans:
            try:
                os.replace(orphans[-1], path + ".1")
            except OSError:
                pass
        self._file = open(path, "a")
        self._size = self._file.tell()

    def write(self, record: dict) -> None:
        """Best-effort append: an I/O failure (disk full, rotation
        rename error) logs once and disables the journal — telemetry
        must never abort the observation it is describing."""
        line = json.dumps(record, sort_keys=True) + "\n"
        rotated = None
        with self._lock:
            if self._file is None:
                return
            try:
                if self._size and self._size + len(line) > self.max_bytes:
                    rotated = self._rotate()
                self._file.write(line)
                self._file.flush()
                self._size += len(line)
            except OSError as e:
                log.warning(f"[telemetry] journal {self.path} failed "
                            f"({e!r}); disabling span journal")
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
        if rotated:
            # gzip OUTSIDE the lock: concurrent writers keep
            # appending to the fresh file while the one writer that
            # tripped rotation pays the (single, per-max_bytes)
            # compress pass
            self._compress(*rotated)

    def _rotate(self) -> str | None:
        """Swap in a fresh active file (cheap: close + rename + open,
        under the lock).  Returns the renamed-out generation's path
        for :meth:`_compress` when compression is on.  The rename
        target is UNIQUE per rotation (``<path>.rotN``): a second
        rotation completing while the previous generation is still
        gzipping must not clobber the file being read, and the
        in-flight compress must not unlink a newer generation that
        reused its name."""
        self._file.close()
        if self.compress:
            self._rot_seq += 1
            plain = f"{self.path}.rot{self._rot_seq}"
        else:
            plain = self.path + ".1"
        os.replace(self.path, plain)
        self._file = open(self.path, "a")
        self._size = 0
        return (plain, self._rot_seq) if self.compress else None

    def _compress(self, plain: str, seq: int) -> None:
        """Gzip one rotated generation to ``<path>.1.gz`` (atomic via
        a per-generation temp + rename; on failure the generation is
        renamed to the legacy plaintext ``.1`` — never lost, just
        uncompressed).  Serialized by ``_compress_lock`` AND ordered
        by ``seq``: a lock alone doesn't order contenders, so a
        slower/preempted pass for an OLDER generation that loses the
        race is dropped instead of overwriting the newer ``.1.gz`` —
        single-generation semantics keep the newest."""
        import gzip
        import shutil
        with self._compress_lock:
            if seq < self._published_seq:
                # a newer generation already published while this one
                # waited: keeping ours would resurrect older data
                try:
                    os.unlink(plain)
                except OSError:
                    pass
                return
            gz = self.path + ".1.gz"
            tmp = plain + ".gz.srtb_tmp"  # unique per generation
            try:
                with open(plain, "rb") as src, \
                        gzip.open(tmp, "wb", compresslevel=1) as dst:
                    shutil.copyfileobj(src, dst)
                os.replace(tmp, gz)  # a crash mid-compress leaves
                # only the temp + the .rotN plain (swept at next
                # open), never a torn .gz
                self._published_seq = seq
                os.unlink(plain)
                # a plaintext generation from a pre-compression run
                # (or a past failed compress) must not linger as a
                # phantom second history
                try:
                    os.unlink(self.path + ".1")
                except FileNotFoundError:
                    pass
            except OSError as e:
                log.warning(f"[telemetry] journal rotation gzip "
                            f"failed ({e!r}); keeping the plaintext "
                            "generation")
                for cleanup in (tmp,):
                    try:
                        os.unlink(cleanup)
                    except OSError:
                        pass
                try:
                    os.replace(plain, self.path + ".1")
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def segment_span(segment: int, stages_s: dict, queue_depth: int,
                 detections: int, dump: bool, samples: int,
                 timestamp_ns: int = 0, extra: dict | None = None,
                 overlap_hidden_s: float | None = None,
                 inflight_depth: int | None = None,
                 active_plan: str | None = None,
                 stream: str | None = None,
                 trace_id: int | None = None,
                 device_s: float | None = None,
                 achieved_msamps: float | None = None,
                 roofline_frac: float | None = None) -> dict:
    """One journal record.  ``stages_s`` maps stage name -> seconds for
    THIS segment; loss/drop counters are the cumulative registry values
    at drain time (deltas between consecutive records localize a loss
    burst to a segment).

    v2 fields: ``overlap_hidden_ms`` is the wall clock between this
    segment's dispatch returning and its fetch starting — host work
    (ingest/dispatch of later segments, sink of earlier ones) that ran
    while the device computed this segment, i.e. latency the async
    engine hid.  It is an UPPER bound on hidden device time: the host
    gap also covers time after the device already finished, so on a
    source- or sink-bound pipeline (device mostly idle) it reads high
    — interpret it together with the ingest/sink stage shares.  It is
    NOT part of ``stages_ms`` (concurrent with, not additional to, the
    staged wall clock).  Both v2 fields are OMITTED when the caller did
    not measure them (``None``) — a pipeline that overlaps but does not
    measure (ThreadedPipeline) must not journal a fake 0, which would
    read as "measured, nothing hidden".  ``inflight_depth`` counts
    dispatched-but-not-fully-drained segments (through sink completion,
    matching the ``srtb_inflight_depth`` gauge) at this segment's
    drain."""
    rec = {
        "type": "segment_span",
        "v": SPAN_SCHEMA_VERSION,
        "ts": time.time(),
        "segment": int(segment),
        "timestamp_ns": int(timestamp_ns),
        "stages_ms": {k: round(v * 1e3, 3) for k, v in stages_s.items()},
        "queue_depth": int(queue_depth),
        "detections": int(detections),
        "dump": bool(dump),
        "samples": int(samples),
        "packets_total": metrics.get("packets_total"),
        "packets_lost": metrics.get("packets_lost"),
        "segments_dropped": metrics.get("segments_dropped"),
        # v3 resilience fields (cumulative registry values at drain)
        "degrade_level": int(metrics.get("degrade_level")),
        "retries": int(metrics.get("retries_total")),
        "requeues": int(metrics.get("watchdog_requeues")),
        "restarts": int(metrics.get("worker_restarts")),
        "shed_waterfalls": int(metrics.get("shed_waterfalls")),
        "shed_baseband": int(metrics.get("shed_baseband")),
        # ingest-ring H2D accounting (cumulative at drain; deltas
        # between consecutive records give per-segment upload bytes —
        # stride_bytes warm, segment_bytes cold)
        "h2d_bytes": int(metrics.get("h2d_bytes")),
        "ring_cold_dispatches": int(metrics.get("ring_cold_dispatches")),
        # v4 self-healing compute fields (cumulative counters + the
        # ladder position gauge at drain)
        "plan_demotions": int(metrics.get("plan_demotions")),
        "plan_promotions": int(metrics.get("plan_promotions")),
        "device_reinits": int(metrics.get("device_reinits")),
        "plan_ladder_level": int(metrics.get("plan_ladder_level")),
        # v5 durable-output fields (cumulative at drain)
        "recovered_segments": int(metrics.get("recovered_segments")),
        "replayed_skips": int(metrics.get("replayed_skips")),
        "rolled_back_intents": int(metrics.get("rolled_back_intents")),
        # v8 compile/plan-cache accounting (cumulative at drain):
        # compile_ms is first-dispatch trace+compile wall (an upper
        # bound: it includes the first dispatch itself) plus exact
        # AOT-miss compile time; the cache counters localize a
        # mid-run recompile burst to a segment via deltas, like every
        # other cumulative field
        "compile_ms": round(metrics.get("compile_seconds") * 1e3, 1),
        "plan_compiles": int(metrics.get("plan_compiles")),
        "aot_cache_hits": int(metrics.get("aot_cache_hits")),
        "aot_cache_misses": int(metrics.get("aot_cache_misses")),
    }
    if overlap_hidden_s is not None:
        rec["overlap_hidden_ms"] = round(
            max(overlap_hidden_s, 0.0) * 1e3, 3)
    if inflight_depth is not None:
        rec["inflight_depth"] = int(inflight_depth)
    if device_s is not None:
        # v8: dispatch->drain-head-ready wall for THIS segment.  NOT
        # part of stages_ms (concurrent with, not additional to, the
        # host stages); omitted when unmeasured (ThreadedPipeline) —
        # never a fake 0, same rule as overlap_hidden_ms.
        rec["device_ms"] = round(max(device_s, 0.0) * 1e3, 3)
    if achieved_msamps is not None:
        rec["achieved_msamps"] = round(achieved_msamps, 2)
    if roofline_frac is not None:
        rec["roofline_frac"] = round(roofline_frac, 4)
    if active_plan is not None:
        # the plan ACTIVE AT DRAIN TIME (like every cumulative field
        # above; in overlapped mode a demotion between this segment's
        # dispatch and its drain stamps the newer plan).  Omitted when
        # the writer has no plan-aware processor (duck-typed stubs) —
        # never a fake placeholder.
        rec["active_plan"] = str(active_plan)
    if stream:
        # v6: which tenant this span belongs to (Config.stream_name;
        # the fleet stamps every lane's).  Omitted when unnamed — a
        # solo run's journal reads exactly as before.  In a NAMED
        # span the per-stream-attributable cumulative fields are the
        # stream's OWN labeled series, not the process-wide totals: a
        # healthy lane's journal must not inherit its noisy
        # neighbor's demotions/loss (retries/requeues/restarts stay
        # process-wide — their sites are not stream-labeled).
        rec["stream"] = str(stream)
        lbl = {"stream": str(stream)}
        for key in ("segments_dropped", "degrade_level",
                    "shed_waterfalls", "shed_baseband",
                    "plan_demotions", "plan_promotions",
                    "device_reinits", "plan_ladder_level",
                    # v8: compile/cache accounting is per-processor
                    # and the processor knows its stream, so a named
                    # span's books are the tenant's own
                    "plan_compiles", "aot_cache_hits",
                    "aot_cache_misses"):
            rec[key] = type(rec[key])(metrics.get(key, labels=lbl))
        rec["compile_ms"] = round(
            metrics.get("compile_seconds", labels=lbl) * 1e3, 1)
    if trace_id:
        # v7: joins this span to its flight-recorder events (omitted
        # when tracing is off — never a fake 0)
        rec["trace_id"] = int(trace_id)
    if extra:
        rec.update(extra)
    return rec


def rotated_generation(path: str) -> str | None:
    """The journal's previous on-disk generation — ``<path>.1.gz``,
    or the legacy plaintext ``<path>.1`` — or None when the journal
    has never rotated.  When BOTH exist (a failed compress left a
    newer plaintext generation next to an older .gz) the NEWER one is
    the previous generation (single-generation semantics).  Shared by
    every journal reader, so generation-pick policy lives in one place.  The
    mtime read races with a live journal's rotation (compress unlinks
    the .1 it just gzipped): a vanished candidate sorts oldest and
    drops out."""
    cands = [p for p in (path + ".1.gz", path + ".1")
             if os.path.exists(p)]
    if not cands:
        return None
    if len(cands) == 1:
        return cands[0]

    def _mtime(p: str) -> float:
        try:
            return os.path.getmtime(p)
        except OSError:
            return -1.0

    return max(cands, key=_mtime)


# admitted fleet streams whose liveness /healthz must track: name ->
# registration time.  Registered by StreamFleet when a lane starts,
# released when it finishes/fails — a finished stream is legitimately
# quiet and must not read as stale.
_ADMITTED_STREAMS: dict[str, float] = {}
_STREAMS_LOCK = threading.Lock()


def register_stream(name: str) -> None:
    """Admit ``name`` to per-stream staleness tracking: health() goes
    unhealthy if ANY registered stream's last segment goes stale."""
    with _STREAMS_LOCK:
        _ADMITTED_STREAMS[name] = time.monotonic()


def release_stream(name: str) -> None:
    with _STREAMS_LOCK:
        _ADMITTED_STREAMS.pop(name, None)


def admitted_streams() -> list[str]:
    with _STREAMS_LOCK:
        return sorted(_ADMITTED_STREAMS)


def mark_segment(stream: str | None = None) -> None:
    """Stamp the registry with "a segment just finished" — the signal
    health() ages against.  With ``stream`` set, also stamps that
    stream's labeled gauge so /healthz can age each admitted tenant
    independently."""
    now = time.monotonic()
    metrics.set(LAST_SEGMENT_MONOTONIC, now)
    metrics.set(LAST_SEGMENT_UNIX, time.time())
    if stream:
        metrics.set(LAST_SEGMENT_MONOTONIC, now,
                    labels={"stream": str(stream)})


def health(stale_after_s: float = 30.0) -> dict:
    """Pipeline liveness from the shared registry: ``ok`` before any
    segment (startup / idle server is healthy), ``ok`` while the last
    segment is younger than ``stale_after_s``, ``stale`` otherwise — a
    wedged accelerator or dead source flips /healthz to 503 without any
    in-process cooperation from the stuck thread.

    Multi-tenant fleet: every ADMITTED stream (register_stream) is aged
    independently against its own labeled last-segment stamp; the
    report carries a per-stream breakdown and ``ok`` is False when ANY
    admitted stream is stale — one wedged tenant must flip /healthz
    even while its neighbors keep the global stamp fresh."""
    last = metrics.get(LAST_SEGMENT_MONOTONIC)
    now = time.monotonic()
    out = {
        "segments": metrics.get("segments"),
        "signals": metrics.get("signals"),
        "stale_after_s": float(stale_after_s),
    }
    streams = admitted_streams()
    if streams:
        per = {}
        stale_streams = []
        for s in streams:
            st_last = metrics.get(LAST_SEGMENT_MONOTONIC,
                                  labels={"stream": s})
            if not st_last:
                # no segment yet: startup is healthy, exactly like
                # the solo contract — a lane still inside its first
                # cold plan compile must not flip a liveness probe
                # to 503 (and so restart the pod) at every start
                per[s] = {"last_segment_age_s": None, "ok": True}
                continue
            age = now - st_last
            per[s] = {"last_segment_age_s": round(age, 3),
                      "ok": age <= stale_after_s}
            if age > stale_after_s:
                stale_streams.append(s)
        out["streams"] = per
        if stale_streams:
            out["stale_streams"] = stale_streams
    else:
        stale_streams = []
    if not last and not streams:
        out.update(status="idle", ok=True, last_segment_age_s=None)
        return out
    age = now - last if last else None
    if age is not None:
        out["last_segment_age_s"] = round(age, 3)
    globally_stale = age is not None and age > stale_after_s
    if globally_stale or stale_streams:
        out.update(status="stale", ok=False)
    else:
        out.update(status="ok", ok=True)
    # SLO burn-rate evaluation (utils/slo.py): "degraded but within
    # budget" and "burning error budget" as distinct, scrapeable
    # states, per stream.  Deliberately NOT folded into ``ok`` — this
    # endpoint's 503 is a LIVENESS contract (restart the pod); a
    # burning SLO is an alerting concern, answered by the payload and
    # the slo_burn_rate / slo_state gauges, not by killing the
    # process that is still making (too slow / too lossy) progress.
    from srtb_tpu_torch.utils import slo as _slo
    slo_report = _slo.evaluate()
    if slo_report is not None:
        out["slo"] = slo_report
        out["slo_ok"] = all(v.get("ok", True)
                            for v in slo_report.values())
    # detection health (quality/canary.py): present only once a
    # pulse-injection canary has been CHECKED this process — a canary-off
    # run (or one whose first canary hasn't drained) reports no detection
    # section rather than a fake "ok".  NOT folded into liveness ``ok``:
    # a sensitivity regression is an alerting concern (the incident
    # bundle and the detection_health_state gauge), and restarting a
    # pipeline that still drains segments would not fix the RFI
    # environment or the broken subband that caused it.
    if metrics.get("canary_checked"):
        state = int(metrics.get("detection_health_state"))
        out["detection"] = {
            "state": "ok" if state == 0 else "degraded",
            "canary_checked": int(metrics.get("canary_checked")),
            "canary_failed": int(metrics.get("canary_failed")),
            "last_snr": round(metrics.get("canary_last_snr"), 3),
            "expected_snr": round(metrics.get("canary_expected_snr"), 3),
            "sensitivity_ratio": round(
                metrics.get("canary_sensitivity_ratio"), 4),
        }
    return out
