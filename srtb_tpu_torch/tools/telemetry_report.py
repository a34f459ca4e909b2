"""Summarize a segment-span telemetry journal (port of
``srtb_tpu/tools/telemetry_report.py``; the journal is
``utils/telemetry.py``'s).

It reads the JSONL span journal the pipeline writes (one record per
segment) and reports

- a per-stage wall-clock table with exact p50/p95/p99 (computed from
  the raw per-segment samples, unlike the bounded-bucket /metrics
  histograms, so it doubles as their ground truth);
- a throughput timeline (segments/s, Msamples/s, detections, loss
  deltas per time bin);
- overlap efficiency of the async engine (schema-v2 spans): how much
  host/transfer time hid under device compute vs how much device wait
  blocked the drain loop, plus in-flight depth statistics;
- resilience activity (schema-v3 spans): cumulative retry / watchdog-
  requeue / worker-restart counts, shed dumps and the degradation-
  level profile;
- compute health (schema-v4 spans): plan demotions / promotions /
  device reinits, the ladder-level profile and the active-plan
  timeline;
- durability (schema-v5 spans): manifest crash-recovery activity —
  segments recovered beyond the checkpoint, sink pushes skipped on
  replay, uncommitted intents rolled back;
- fleet (schema-v6 spans): per-stream breakdown grouped by the
  ``stream`` field (a named stream's cumulative fields are its own
  labeled series); feed it one stream's journal or several merged;
- device (schema-v8 spans): per-segment dispatch->ready wall
  percentiles, device-time-derived Msamples/s and roofline_frac (lower
  bounds), and the cumulative compile / plan-cache totals;
- science observatory (schema-v9 spans): the per-segment ``quality``
  and ``canary`` extras are summarized by tools/quality_report.py;
  this report treats them like any other extra payload;
- fleet devices (schema-v11 spans): per-device breakdown grouped by the
  ``device`` label.  The fleet sections read span fields only, and drop
  out of a single-card journal, whose spans carry neither field.

Mixed v1-v11 journals (rotation can leave an older-schema tail after an
upgrade) are summarized tolerantly: records simply lack the newer
fields and drop out of the sections that need them.

Usage: python -m srtb_tpu_torch.tools.telemetry_report JOURNAL.jsonl
           [--bin SECONDS] [--format json|md]

Reads the rotated generation (``<path>.1.gz`` or ``<path>.1``) first
when present, so the report covers everything still on disk.  Output:
markdown tables (md, default) or one JSON document (json).  Exit 0 with
a note when the journal holds no span records yet.
"""

from __future__ import annotations

import argparse
import json


def _open_journal(path: str):
    """Plaintext or gzip (rotation compresses generations to
    ``.jsonl.gz``) — readers must not care which."""
    if path.endswith(".gz"):
        import gzip
        return gzip.open(path, "rt")
    return open(path)


def load(path: str, include_rotated: bool = True) -> list[dict]:
    """Parse span records, oldest first, tolerating partial lines (a
    journal being written concurrently ends mid-record).  The rotated
    generation (``<path>.1.gz``, or legacy plaintext ``<path>.1``) is
    read first when present; a torn gzip tail (crash mid-rotation)
    yields its readable prefix."""
    from srtb_tpu_torch.utils.telemetry import rotated_generation
    records = []
    paths = []
    if include_rotated:
        gen = rotated_generation(path)
        if gen:
            paths.append(gen)
    paths.append(path)
    import zlib
    for p in paths:
        try:
            with _open_journal(p) as f:
                for line in f:
                    line = line.strip()
                    if not line.startswith("{"):
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("type") == "segment_span":
                        records.append(rec)
        except (OSError, EOFError, zlib.error):
            # includes BadGzipFile, a truncated compressed tail AND a
            # corrupt deflate stream (zlib.error — e.g. zero-filled
            # blocks after power loss): keep whatever already parsed —
            # the report must not crash on the journal it was asked
            # to diagnose
            continue
    return records


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Exact linear-interpolation percentile (numpy 'linear' method)."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def stage_stats(records: list[dict]) -> dict:
    """stage -> {count, mean_ms, p50_ms, p95_ms, p99_ms, max_ms,
    total_s}, plus a synthetic 'segment' stage (sum over stages of each
    record: the per-segment host wall clock) and — for v2 records — an
    'overlap' pseudo-stage from ``overlap_hidden_ms``.  Overlap is
    concurrent with the staged wall clock, so it is *excluded* from the
    'segment' sum.  Fields are read tolerantly: a mixed v1/v2 journal
    (rotation can leave a v1 tail after an upgrade) must summarize, not
    KeyError."""
    samples: dict[str, list[float]] = {}
    for rec in records:
        stages = rec.get("stages_ms") or {}
        for name, ms in stages.items():
            samples.setdefault(name, []).append(float(ms))
        if stages:
            samples.setdefault("segment", []).append(
                float(sum(stages.values())))
        hidden = rec.get("overlap_hidden_ms")
        if hidden is not None:
            samples.setdefault("overlap", []).append(float(hidden))
    out = {}
    for name, vals in sorted(samples.items()):
        vals.sort()
        out[name] = {
            "count": len(vals),
            "mean_ms": round(sum(vals) / len(vals), 3),
            "p50_ms": round(_percentile(vals, 0.50), 3),
            "p95_ms": round(_percentile(vals, 0.95), 3),
            "p99_ms": round(_percentile(vals, 0.99), 3),
            "max_ms": round(vals[-1], 3),
            "total_s": round(sum(vals) / 1e3, 3),
        }
    return out


def timeline(records: list[dict], bin_s: float = 10.0) -> list[dict]:
    """Throughput per time bin: segments/s, Msamples/s, detections,
    dumps, and packet-loss deltas (the journal stores cumulative
    counters; consecutive-record differences localize a burst)."""
    recs = [r for r in records if "ts" in r]
    if not recs:
        return []
    recs.sort(key=lambda r: r["ts"])
    t0 = recs[0]["ts"]
    bins: dict[int, dict] = {}
    prev_lost = prev_total = None
    for r in recs:
        b = int((r["ts"] - t0) // bin_s)
        cur = bins.setdefault(b, {
            "t_start_s": round(b * bin_s, 3), "segments": 0,
            "samples": 0, "detections": 0, "dumps": 0,
            "packets_lost_delta": 0, "packets_total_delta": 0})
        cur["segments"] += 1
        cur["samples"] += int(r.get("samples", 0))
        cur["detections"] += int(r.get("detections", 0))
        cur["dumps"] += 1 if r.get("dump") else 0
        lost, total = r.get("packets_lost"), r.get("packets_total")
        if lost is not None and prev_lost is not None:
            cur["packets_lost_delta"] += max(0, lost - prev_lost)
            cur["packets_total_delta"] += max(0, total - prev_total)
        prev_lost, prev_total = lost, total
    out = []
    last_b = max(bins)
    span = recs[-1]["ts"] - t0
    # each record stands for ~one inter-arrival interval, so the mean
    # gap is the floor for the final bin's covered time: a tail record
    # landing just past a bin boundary then reports ~the true rate
    # instead of an n/epsilon spike
    mean_gap = span / (len(recs) - 1) if len(recs) > 1 else bin_s
    for b in range(last_b + 1):
        if b not in bins:
            # a stalled pipeline writes no records: the stall must show
            # as explicit 0-seg/s rows, not as silently missing bins
            out.append({"t_start_s": round(b * bin_s, 3), "segments": 0,
                        "samples": 0, "detections": 0, "dumps": 0,
                        "packets_lost_delta": 0,
                        "packets_total_delta": 0,
                        "segments_per_sec": 0.0,
                        "msamples_per_sec": 0.0})
            continue
        cur = bins[b]
        # the final bin is usually partial: divide by the time actually
        # covered, not the full width, or a steady pipeline shows a
        # phantom end-of-run slowdown
        width = bin_s if b != last_b else \
            min(bin_s, max(span - b * bin_s, mean_gap, 1e-3))
        cur["segments_per_sec"] = round(cur["segments"] / width, 3)
        cur["msamples_per_sec"] = round(cur["samples"] / width / 1e6, 3)
        out.append(cur)
    return out


def overlap_stats(records: list[dict]) -> dict:
    """Overlap efficiency of the async engine from v2 spans:
    ``overlap_hidden_ms`` is host/transfer time that ran under device
    compute, the blocking ``fetch`` stage is device wait that was NOT
    hidden — ``efficiency = hidden / (hidden + blocked fetch)`` (1.0 =
    the engine hid every device wait).  Caveat: hidden time is an
    upper bound (it includes host gap after the device finished), so
    on a source/sink-bound pipeline efficiency reads ~1.0 while the
    device idles — check the ingest/sink stage shares alongside it.
    v1 records (no overlap fields) are skipped; empty dict when none
    qualify."""
    hidden, fetch, depths = [], [], []
    for r in records:
        h = r.get("overlap_hidden_ms")
        if h is None:
            continue
        hidden.append(float(h))
        fetch.append(float((r.get("stages_ms") or {}).get("fetch", 0.0)))
        d = r.get("inflight_depth")
        if d is not None:
            depths.append(int(d))
    if not hidden:
        return {}
    tot_h, tot_f = sum(hidden), sum(fetch)
    out = {
        "records": len(hidden),
        "hidden_total_s": round(tot_h / 1e3, 3),
        "hidden_mean_ms": round(tot_h / len(hidden), 3),
        "blocked_fetch_total_s": round(tot_f / 1e3, 3),
        "efficiency": (round(tot_h / (tot_h + tot_f), 4)
                       if tot_h + tot_f > 0 else 0.0),
    }
    if depths:
        out["inflight_depth_mean"] = round(sum(depths) / len(depths), 2)
        out["inflight_depth_max"] = max(depths)
    return out


def resilience_stats(records: list[dict]) -> dict:
    """Resilience activity from v3 spans.  The counters are cumulative
    registry values (like ``segments_dropped``), so the LAST record
    carries the run totals; the per-record degradation level gives the
    time-at-degraded profile.  v1/v2 records (no resilience fields)
    are skipped; empty dict when none qualify."""
    v3 = [r for r in records if "degrade_level" in r or "retries" in r]
    if not v3:
        return {}
    last = v3[-1]
    levels = [int(r.get("degrade_level", 0)) for r in v3]
    return {
        "records": len(v3),
        "retries": int(last.get("retries", 0)),
        "requeues": int(last.get("requeues", 0)),
        "restarts": int(last.get("restarts", 0)),
        "shed_waterfalls": int(last.get("shed_waterfalls", 0)),
        "shed_baseband": int(last.get("shed_baseband", 0)),
        "degrade_level_max": max(levels),
        "segments_degraded": sum(1 for lv in levels if lv > 0),
    }


def compute_stats(records: list[dict]) -> dict:
    """Compute health from v4 spans (the self-healing ladder).  The
    counters are cumulative, so the LAST record carries run totals;
    the per-record ladder level gives time-at-demoted, and the
    ``active_plan`` change points give the plan timeline (which plan
    family each stretch of the run computed on).  v1–v3 records (no
    compute fields) are skipped; empty dict when none qualify."""
    v4 = [r for r in records if "plan_demotions" in r
          or "device_reinits" in r]
    if not v4:
        return {}
    last = v4[-1]
    levels = [int(r.get("plan_ladder_level", 0)) for r in v4]
    timeline_plans: list[dict] = []
    prev = None
    for r in v4:
        plan = r.get("active_plan")
        if plan is not None and plan != prev:
            timeline_plans.append({"segment": int(r.get("segment", -1)),
                                   "plan": plan})
            prev = plan
    return {
        "records": len(v4),
        "plan_demotions": int(last.get("plan_demotions", 0)),
        "plan_promotions": int(last.get("plan_promotions", 0)),
        "device_reinits": int(last.get("device_reinits", 0)),
        "ladder_level_max": max(levels),
        "ladder_level_last": levels[-1],
        "segments_demoted": sum(1 for lv in levels if lv > 0),
        "plan_timeline": timeline_plans,
    }


def durability_stats(records: list[dict]) -> dict:
    """Crash-recovery activity from v5 spans (the run manifest,
    io/manifest.py).  Unlike the other cumulative sections, a
    crash-recovered run spans SEVERAL processes and the counters
    reset with each one — the very runs this section describes —
    so totals are summed per process generation (a counter DECREASE
    between consecutive records marks a restart boundary).  v1-v4
    records (no durability fields) are skipped; empty dict when none
    qualify."""
    v5 = [r for r in records if "replayed_skips" in r
          or "rolled_back_intents" in r]
    if not v5:
        return {}

    def total(field: str) -> int:
        out = 0
        prev = 0
        for r in v5:
            cur = int(r.get(field, 0))
            if cur < prev:  # process restart: bank the finished life
                out += prev
            prev = cur
        return out + prev

    return {
        "records": len(v5),
        "recovered_segments": total("recovered_segments"),
        "replayed_skips": total("replayed_skips"),
        "rolled_back_intents": total("rolled_back_intents"),
    }


def fleet_stats(records: list[dict]) -> dict:
    """Per-stream breakdown from v6 spans (the multi-tenant fleet).
    Records without a ``stream`` field (v1-v5, or unnamed solo runs)
    are skipped; empty dict when none qualify.  Cumulative fields in
    a named span are the stream's OWN series (telemetry.segment_span
    v6), so the last record per stream carries that tenant's totals."""
    by_stream: dict[str, list[dict]] = {}
    for r in records:
        s = r.get("stream")
        if s is not None:
            by_stream.setdefault(str(s), []).append(r)
    if not by_stream:
        return {}
    out = {}
    for s, recs in sorted(by_stream.items()):
        last = recs[-1]
        levels = [int(r.get("degrade_level", 0)) for r in recs]
        out[s] = {
            "records": len(recs),
            "detections": sum(int(r.get("detections", 0))
                              for r in recs),
            "dumps": sum(1 for r in recs if r.get("dump")),
            "segments_dropped": int(last.get("segments_dropped", 0)),
            "shed_waterfalls": int(last.get("shed_waterfalls", 0)),
            "shed_baseband": int(last.get("shed_baseband", 0)),
            "plan_demotions": int(last.get("plan_demotions", 0)),
            "device_reinits": int(last.get("device_reinits", 0)),
            "degrade_level_max": max(levels),
            "plan_ladder_level_last":
                int(last.get("plan_ladder_level", 0)),
        }
    return out


def fleet_device_stats(records: list[dict]) -> dict:
    """Per-POOL-MEMBER breakdown from v11 spans (the elastic device
    fleet): spans executed, streams hosted, detections, loss deltas
    attributed to the device that drained them, and migrations IN
    (device-label change points per stream).  Records without a
    ``device`` label (v1-v10, or a solo run) are skipped; empty dict
    when none qualify.  Feed it one lane's journal or several lanes'
    merged — the per-stream change-point walk is order-tolerant
    because each stream's records are tracked independently."""
    by_dev: dict[str, dict] = {}
    last_dev: dict[str, str] = {}      # stream -> previous device
    last_dropped: dict[str, int] = {}  # stream -> previous cumulative
    any_v11 = False
    for r in records:
        dev = r.get("device")
        if not dev:
            continue
        any_v11 = True
        dev = str(dev)
        stream = str(r.get("stream") or "")
        cur = by_dev.setdefault(dev, {
            "spans": 0, "streams": set(), "detections": 0,
            "segments_dropped": 0, "migrations_in": 0})
        cur["spans"] += 1
        cur["streams"].add(stream)
        cur["detections"] += int(r.get("detections", 0))
        # loss is a cumulative per-stream counter (named spans carry
        # the stream's OWN series): the delta since the stream's
        # previous record belongs to the device draining NOW
        dropped = r.get("segments_dropped")
        if dropped is not None:
            prev = last_dropped.get(stream)
            if prev is not None:
                cur["segments_dropped"] += max(0, int(dropped) - prev)
            last_dropped[stream] = int(dropped)
        prev_dev = last_dev.get(stream)
        if prev_dev is not None and prev_dev != dev:
            cur["migrations_in"] += 1
        last_dev[stream] = dev
    if not any_v11:
        return {}
    return {dev: {**st, "streams": len(st["streams"])}
            for dev, st in sorted(by_dev.items())}


def device_stats(records: list[dict]) -> dict:
    """Device-time accounting from v8 spans (performance
    observatory).  ``device_ms`` is per-segment (an upper bound on
    device busy time — dispatch->drain-head-ready wall), the
    roofline/throughput fields are per-segment lower bounds, and the
    compile/cache counters are cumulative (last record = run totals).
    Older records (no device fields) are skipped; empty dict when
    none qualify."""
    v8 = [r for r in records if "device_ms" in r
          or "compile_ms" in r]
    if not v8:
        return {}
    dev = sorted(float(r["device_ms"]) for r in v8
                 if "device_ms" in r)
    fracs = [float(r["roofline_frac"]) for r in v8
             if "roofline_frac" in r]
    msamps = [float(r["achieved_msamps"]) for r in v8
              if "achieved_msamps" in r]
    last = v8[-1]
    out = {"records": len(v8)}
    if dev:
        out.update(
            device_p50_ms=round(_percentile(dev, 0.50), 3),
            device_p95_ms=round(_percentile(dev, 0.95), 3),
            device_max_ms=round(dev[-1], 3),
            device_total_s=round(sum(dev) / 1e3, 3))
    if msamps:
        out["achieved_msamps_median"] = round(
            _percentile(sorted(msamps), 0.50), 2)
    if fracs:
        out["roofline_frac_median"] = round(
            _percentile(sorted(fracs), 0.50), 4)
        out["roofline_frac_max"] = round(max(fracs), 4)
    out.update(
        compile_ms=float(last.get("compile_ms", 0.0)),
        plan_compiles=int(last.get("plan_compiles", 0)),
        aot_cache_hits=int(last.get("aot_cache_hits", 0)),
        aot_cache_misses=int(last.get("aot_cache_misses", 0)))
    return out


def report(path: str, bin_s: float = 10.0) -> dict:
    records = load(path)
    return {
        "journal": path,
        "records": len(records),
        "stages": stage_stats(records),
        "overlap": overlap_stats(records),
        "resilience": resilience_stats(records),
        "compute": compute_stats(records),
        "durability": durability_stats(records),
        "fleet": fleet_stats(records),
        "fleet_devices": fleet_device_stats(records),
        "device": device_stats(records),
        "timeline": timeline(records, bin_s),
    }


def _md(rep: dict) -> str:
    lines = [f"# Telemetry report — {rep['journal']}",
             "", f"{rep['records']} segment spans.", "",
             "## Per-stage wall clock (ms)", "",
             "| stage | count | mean | p50 | p95 | p99 | max | "
             "total s |", "|---|---|---|---|---|---|---|---|"]
    for name, s in rep["stages"].items():
        lines.append(
            f"| {name} | {s['count']} | {s['mean_ms']} | {s['p50_ms']} |"
            f" {s['p95_ms']} | {s['p99_ms']} | {s['max_ms']} |"
            f" {s['total_s']} |")
    ov = rep.get("overlap") or {}
    if ov:
        lines += ["", "## Overlap (async engine)", "",
                  f"hidden under device compute: {ov['hidden_total_s']} s"
                  f" total ({ov['hidden_mean_ms']} ms/segment mean), "
                  f"blocked fetch: {ov['blocked_fetch_total_s']} s, "
                  f"efficiency: {ov['efficiency']}"]
        if "inflight_depth_mean" in ov:
            lines.append(
                f"in-flight depth: mean {ov['inflight_depth_mean']}, "
                f"max {ov['inflight_depth_max']}")
    rs = rep.get("resilience") or {}
    if rs:
        lines += ["", "## Resilience", "",
                  f"retries: {rs['retries']}, watchdog requeues: "
                  f"{rs['requeues']}, worker restarts: "
                  f"{rs['restarts']}, shed waterfalls: "
                  f"{rs['shed_waterfalls']}, shed baseband dumps: "
                  f"{rs['shed_baseband']}",
                  f"degradation: max level {rs['degrade_level_max']}, "
                  f"{rs['segments_degraded']}/{rs['records']} segments "
                  "drained at a degraded level"]
    cs = rep.get("compute") or {}
    if cs:
        lines += ["", "## Compute health (self-healing ladder)", "",
                  f"plan demotions: {cs['plan_demotions']}, "
                  f"promotions: {cs['plan_promotions']}, "
                  f"device reinits: {cs['device_reinits']}",
                  f"ladder: max level {cs['ladder_level_max']}, final "
                  f"level {cs['ladder_level_last']}, "
                  f"{cs['segments_demoted']}/{cs['records']} segments "
                  "drained on a demoted plan"]
        if cs["plan_timeline"]:
            lines += ["", "active-plan timeline:"]
            for step in cs["plan_timeline"]:
                lines.append(f"- segment {step['segment']}: "
                             f"{step['plan']}")
    ds = rep.get("durability") or {}
    if ds:
        lines += ["", "## Durability (run manifest)", "",
                  f"recovered segments: {ds['recovered_segments']}, "
                  f"replayed skips: {ds['replayed_skips']}, "
                  f"rolled-back intents: {ds['rolled_back_intents']}"]
    fl = rep.get("fleet") or {}
    if fl:
        lines += ["", "## Fleet (per-stream)", "",
                  "| stream | spans | detections | dumps | dropped | "
                  "demotions | reinits | degrade max | ladder |",
                  "|---|---|---|---|---|---|---|---|---|"]
        for s, st in fl.items():
            lines.append(
                f"| {s} | {st['records']} | {st['detections']} | "
                f"{st['dumps']} | {st['segments_dropped']} | "
                f"{st['plan_demotions']} | {st['device_reinits']} | "
                f"{st['degrade_level_max']} | "
                f"{st['plan_ladder_level_last']} |")
    fd = rep.get("fleet_devices") or {}
    if fd:
        lines += ["", "## Fleet devices (per pool member)", "",
                  "| device | spans | streams | detections | loss | "
                  "migrations in |", "|---|---|---|---|---|---|"]
        for dev, st in fd.items():
            lines.append(
                f"| {dev} | {st['spans']} | {st['streams']} | "
                f"{st['detections']} | {st['segments_dropped']} | "
                f"{st['migrations_in']} |")
    dv = rep.get("device") or {}
    if dv:
        lines += ["", "## Device time (performance observatory)", ""]
        if "device_p50_ms" in dv:
            lines.append(
                f"dispatch->ready wall: p50 {dv['device_p50_ms']} ms, "
                f"p95 {dv['device_p95_ms']} ms, max "
                f"{dv['device_max_ms']} ms "
                f"(total {dv['device_total_s']} s; upper bound)")
        if "roofline_frac_median" in dv:
            lines.append(
                f"roofline_frac: median {dv['roofline_frac_median']}, "
                f"max {dv['roofline_frac_max']} (lower bound vs the "
                "plan's audited hbm_passes floor)"
                + (f"; achieved {dv['achieved_msamps_median']} "
                   "Msamples/s median"
                   if "achieved_msamps_median" in dv else ""))
        lines.append(
            f"compile: {dv['compile_ms']} ms cumulative over "
            f"{dv['plan_compiles']} first-dispatch compile(s); AOT "
            f"cache {dv['aot_cache_hits']} hit(s) / "
            f"{dv['aot_cache_misses']} miss(es)")
    lines += ["", "## Throughput timeline", "",
              "| t (s) | segments | seg/s | Msamples/s | detections | "
              "dumps | pkts lost |", "|---|---|---|---|---|---|---|"]
    for b in rep["timeline"]:
        lines.append(
            f"| {b['t_start_s']} | {b['segments']} | "
            f"{b['segments_per_sec']} | {b['msamples_per_sec']} | "
            f"{b['detections']} | {b['dumps']} | "
            f"{b['packets_lost_delta']} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("journal")
    p.add_argument("--bin", type=float, default=10.0)
    p.add_argument("--format", choices=("md", "json"), default="md")
    args = p.parse_args(argv)
    rep = report(args.journal, args.bin)
    if not rep["records"]:
        # empty or freshly rotated journal: a clear note, not a
        # failure — dashboards scrape just-started runs
        note = {"note": f"no segment spans in {args.journal} yet",
                "records": 0}
        print(json.dumps(note) if args.format == "json"
              else f"# Telemetry report\n\n{note['note']}\n")
        return 0
    if args.format == "json":
        print(json.dumps(rep, sort_keys=True))
    else:
        print(_md(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
