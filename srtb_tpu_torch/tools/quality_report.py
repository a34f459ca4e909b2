"""Render the science observatory from a span journal (port of
``srtb_tpu/tools/quality_report.py``).

``telemetry_report`` summarizes *how fast* the pipeline ran; this tool
summarizes *how good the data was* and *whether the instrument could
still see*.  It reads the same JSONL span journal (utils/telemetry.py,
through ``telemetry_report.load``) and reports, per stream:

- **data quality** (the ``quality`` extra of each span,
  ``quality/stats.py``): zapped-channel fraction, bandpass
  mean/variance, spectral-kurtosis summary, dead/hot channel fractions,
  and the EWMA bandpass-drift score, each as min/mean/max over the run
  plus the drift-alert count;
- **RFI occupancy map**: the coarse per-bin zero-fraction averaged over
  the run, rendered as a text heat strip (worst bins called out
  numerically);
- **canary verdicts** (the ``canary`` extra, ``quality/canary.py``):
  every checked injection with recovered vs expected S/N and the
  sensitivity ratio, plus the failure count.

Pre-v9 records (no ``quality``/``canary`` fields) drop out of the
sections tolerantly, like every other telemetry_report section.

Usage: python -m srtb_tpu_torch.tools.quality_report JOURNAL.jsonl
           [--format json|md]

Exit 0 with a note when the journal holds no quality/canary records
yet (quality_stats off, canary off, or a just-started run).
"""

from __future__ import annotations

import argparse
import json

from srtb_tpu_torch.tools.telemetry_report import load

# text heat strip glyphs, cold to hot (occupancy 0 -> 1)
_RAMP = " .:-=+*#%@"

QUALITY_FIELDS = ("zap_frac", "bandpass_mean", "bandpass_var",
                  "sk_mean", "sk_max", "dead_frac", "hot_frac",
                  "drift_score")


def _agg(vals: list[float]) -> dict:
    return {"min": round(min(vals), 5), "mean": round(
        sum(vals) / len(vals), 5), "max": round(max(vals), 5)}


def quality_stats(records: list[dict]) -> dict:
    """stream -> field -> {min, mean, max} over the run, plus the
    drift-alert count and the segment count carrying quality data."""
    by_stream: dict[str, list[dict]] = {}
    for r in records:
        q = r.get("quality")
        if isinstance(q, dict):
            by_stream.setdefault(str(r.get("stream", "")), []).append(q)
    out = {}
    for s, qs in sorted(by_stream.items()):
        st = {"records": len(qs),
              "drift_alerts": sum(1 for q in qs if q.get("drift_alert"))}
        for f in QUALITY_FIELDS:
            vals = [float(q[f]) for q in qs if f in q]
            if vals:
                st[f] = _agg(vals)
        out[s] = st
    return out


def occupancy_map(records: list[dict]) -> dict:
    """stream -> run-mean occupancy per coarse bin (+ the worst bins).
    Bin counts can change across a reconfigure; the map keeps the most
    common length and averages the records that match it."""
    by_stream: dict[str, list[list[float]]] = {}
    for r in records:
        q = r.get("quality")
        if isinstance(q, dict) and q.get("occupancy"):
            by_stream.setdefault(str(r.get("stream", "")),
                                 []).append(q["occupancy"])
    out = {}
    for s, occs in sorted(by_stream.items()):
        lengths: dict[int, int] = {}
        for o in occs:
            lengths[len(o)] = lengths.get(len(o), 0) + 1
        n = max(lengths, key=lambda k: lengths[k])
        kept = [o for o in occs if len(o) == n]
        mean = [round(sum(o[i] for o in kept) / len(kept), 4)
                for i in range(n)]
        worst = sorted(range(n), key=lambda i: -mean[i])[:4]
        out[s] = {"bins": n, "mean": mean,
                  "worst": [{"bin": i, "occupancy": mean[i]}
                            for i in worst if mean[i] > 0]}
    return out


def canary_stats(records: list[dict]) -> dict:
    """stream -> every checked canary verdict (injection-only marks —
    a replayed canary skipping its exactly-once check — are counted
    but not tabulated) plus the pass/fail totals."""
    by_stream: dict[str, dict] = {}
    for r in records:
        c = r.get("canary")
        if not isinstance(c, dict):
            continue
        st = by_stream.setdefault(str(r.get("stream", "")), {
            "injected": 0, "checked": 0, "failed": 0, "verdicts": []})
        st["injected"] += 1
        if "ratio" not in c:
            continue  # injection mark without a verdict (replay)
        st["checked"] += 1
        if not c.get("ok", True):
            st["failed"] += 1
        st["verdicts"].append({
            "segment": int(c.get("segment", -1)),
            "snr": float(c.get("snr", 0.0)),
            "expected": float(c.get("expected", 0.0)),
            "ratio": float(c.get("ratio", 0.0)),
            "ok": bool(c.get("ok", True)),
            "calibrated": bool(c.get("calibrated", False)),
        })
    return by_stream


def report(path: str) -> dict:
    records = load(path)
    return {
        "journal": path,
        "records": len(records),
        "quality": quality_stats(records),
        "occupancy": occupancy_map(records),
        "canary": canary_stats(records),
    }


def _strip(mean: list[float]) -> str:
    return "".join(
        _RAMP[min(len(_RAMP) - 1, int(max(0.0, min(1.0, v))
                                      * (len(_RAMP) - 1) + 0.5))]
        for v in mean)


def _md(rep: dict) -> str:
    lines = [f"# Quality report — {rep['journal']}", "",
             f"{rep['records']} segment spans."]
    for s, st in rep["quality"].items():
        title = f"stream {s!r}" if s else "run"
        lines += ["", f"## Data quality ({title})", "",
                  f"{st['records']} quality spans, "
                  f"{st['drift_alerts']} bandpass drift alert(s).", "",
                  "| stat | min | mean | max |", "|---|---|---|---|"]
        for f in QUALITY_FIELDS:
            if f in st:
                a = st[f]
                lines.append(f"| {f} | {a['min']} | {a['mean']} | "
                             f"{a['max']} |")
        occ = rep["occupancy"].get(s)
        if occ:
            lines += ["", f"RFI occupancy ({occ['bins']} coarse bins, "
                      "run mean, low->high frequency):", "",
                      f"    [{_strip(occ['mean'])}]"]
            for w in occ["worst"]:
                lines.append(f"- bin {w['bin']}: "
                             f"{w['occupancy']:.1%} zapped")
    for s, st in sorted(rep["canary"].items()):
        title = f"stream {s!r}" if s else "run"
        lines += ["", f"## Canary ({title})", "",
                  f"{st['injected']} injected, {st['checked']} checked, "
                  f"{st['failed']} failed.", ""]
        if st["verdicts"]:
            lines += ["| segment | S/N | expected | ratio | verdict |",
                      "|---|---|---|---|---|"]
            for v in st["verdicts"]:
                verdict = ("calibrated" if v["calibrated"]
                           else "ok" if v["ok"] else "FAILED")
                lines.append(
                    f"| {v['segment']} | {v['snr']:.2f} | "
                    f"{v['expected']:.2f} | {v['ratio']:.3f} | "
                    f"{verdict} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("journal")
    p.add_argument("--format", choices=("md", "json"), default="md")
    args = p.parse_args(argv)
    rep = report(args.journal)
    if not (rep["quality"] or rep["canary"]):
        # no science-observatory data (yet): a clear note, not a
        # failure — quality_stats/canary may simply be off
        note = {"note": "no quality/canary spans in "
                        f"{args.journal} yet", "records": rep["records"]}
        print(json.dumps(note) if args.format == "json"
              else f"# Quality report\n\n{note['note']}\n")
        return 0
    if args.format == "json":
        print(json.dumps(rep, sort_keys=True))
    else:
        print(_md(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
