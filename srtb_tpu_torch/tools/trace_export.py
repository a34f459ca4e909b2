"""Render a flight-recorder dump as Chrome-trace / Perfetto JSON (port of
``srtb_tpu/tools/trace_export.py``).

Feed it an events JSONL (``Config.events_dump_path``, or an incident
bundle's ``events.jsonl``) and open the output in ``chrome://tracing`` or
https://ui.perfetto.dev —

- **one track per stream per thread**: each stream (or the solo
  pipeline) is a trace *process*, each of its threads a *track*, so the
  engine's main/sink split is visible;
- **stage slices**: ``stage.ingest`` / ``stage.dispatch`` /
  ``stage.fetch`` / ``stage.sink`` render as duration ("X") slices;
- **flow arrows follow ``trace_id``**: every segment's journey is an
  arrow chain ingest -> dispatch -> fetch -> sink, crossing the
  engine-thread/sink-thread boundary;
- **decisions as instants**: retries, fault classifications,
  heal/demote/promote/reinit, degrade/shed, watchdog, supervisor
  restarts, ring transitions, manifest records, canary regressions and
  incident markers render as instant events on the thread where they
  happened.

Usage::

    python -m srtb_tpu_torch.tools.trace_export EVENTS.jsonl [--out OUT.json]
    python -m srtb_tpu_torch.tools.trace_export BUNDLE_DIR   [--out OUT.json]

``--validate`` only schema-checks the input/output: exit 0 when the
rendered document is structurally valid Chrome-trace JSON with matched
flow bindings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# event types rendered as duration slices (everything else = instant)
STAGE_TYPES = ("stage.ingest", "stage.dispatch", "stage.fetch",
               "stage.sink")


def load_events(path: str) -> list[dict]:
    """Read a flight-recorder dump (EventHub.dump_jsonl format); a
    directory is treated as an incident bundle (its events.jsonl)."""
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "type" in rec and "t" in rec:
                out.append(rec)
    out.sort(key=lambda e: e["t"])
    return out


def render(events: list[dict]) -> dict:
    """Events -> Chrome-trace document (JSON-object format)."""
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(e["t"] for e in events)

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    # pid per stream ("" = the solo pipeline), tid per (pid, thread)
    pids: dict[str, int] = {}
    tids: dict[tuple, int] = {}
    out: list[dict] = []

    def pid_of(stream: str) -> int:
        if stream not in pids:
            pids[stream] = len(pids) + 1
            out.append({"name": "process_name", "ph": "M",
                        "pid": pids[stream], "tid": 0,
                        "args": {"name": (f"stream:{stream}"
                                          if stream else "pipeline")}})
        return pids[stream]

    def tid_of(pid: int, thread: str) -> int:
        key = (pid, thread)
        if key not in tids:
            tids[key] = sum(1 for (p, _t) in tids if p == pid) + 1
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tids[key], "args": {"name": thread}})
        return tids[key]

    # slices + instants
    located: dict[int, list[tuple[float, int, int, str]]] = {}
    for e in events:
        stream = str(e.get("stream") or "")
        thread = str(e.get("thread") or "?")
        pid = pid_of(stream)
        tid = tid_of(pid, thread)
        etype = e["type"]
        trace = int(e.get("trace") or 0)
        args = {"trace_id": trace, "segment": e.get("seg", -1)}
        if e.get("info"):
            args["info"] = e["info"]
        if etype in STAGE_TYPES:
            dur_us = max(float(e.get("dur_ms") or 0.0) * 1e3, 0.001)
            start = us(e["t"]) - dur_us  # emitted at stage END
            out.append({"name": etype.split(".", 1)[1], "cat": "stage",
                        "ph": "X", "ts": round(start, 3),
                        "dur": round(dur_us, 3), "pid": pid,
                        "tid": tid, "args": args})
            if trace > 0:
                located.setdefault(trace, []).append(
                    (us(e["t"]) - dur_us / 2, pid, tid, etype))
        else:
            # heal/degrade/retry/manifest/... as thread-scoped instants
            out.append({"name": etype, "cat": "event", "ph": "i",
                        "s": "t", "ts": us(e["t"]), "pid": pid,
                        "tid": tid, "args": args})

    # flow arrows: one chain per trace_id across its stage slices —
    # the ingest -> dispatch -> fetch -> sink causal story, crossing
    # thread (and in a fleet, lane) boundaries
    for trace, points in sorted(located.items()):
        if len(points) < 2:
            continue
        points.sort()
        for i, (ts, pid, tid, _etype) in enumerate(points):
            ph = "s" if i == 0 else ("f" if i == len(points) - 1
                                     else "t")
            ev = {"name": "segment", "cat": "flow", "ph": ph,
                  "id": trace, "ts": round(ts, 3), "pid": pid,
                  "tid": tid}
            if ph == "f":
                ev["bp"] = "e"
            out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"source": "srtb_tpu_torch flight recorder",
                          "streams": sorted(pids)}}


def validate(doc: dict) -> list[str]:
    """Structural Chrome-trace schema check (the CI gate).  Returns a
    list of problems (empty = valid): traceEvents is a list; every
    event carries ph/ts(or metadata)/pid/tid; X events have numeric
    dur >= 0; flow chains are well-formed (every id has exactly one
    "s" and one "f", "f" carries bp="e")."""
    problems = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    flows: dict[int, list[str]] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "M", "s", "t", "f"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if not isinstance(e.get("pid"), int) \
                or not isinstance(e.get("tid"), int):
            problems.append(f"event {i}: missing pid/tid")
        if ph != "M" and not isinstance(e.get("ts"), (int, float)):
            problems.append(f"event {i}: missing ts")
        if ph == "X":
            d = e.get("dur")
            if not isinstance(d, (int, float)) or d < 0:
                problems.append(f"event {i}: X without valid dur")
        if ph in ("s", "t", "f"):
            flows.setdefault(int(e.get("id", -1)), []).append(ph)
            if ph == "f" and e.get("bp") != "e":
                problems.append(f"event {i}: flow finish without "
                                "bp='e'")
    for fid, phs in flows.items():
        if phs.count("s") != 1 or phs.count("f") != 1:
            problems.append(
                f"flow {fid}: needs exactly one start + one finish "
                f"(got {phs})")
    return problems


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("events", help="events JSONL (or incident bundle "
                                  "directory)")
    p.add_argument("--out", default="",
                   help="output path (default: <events>.trace.json)")
    p.add_argument("--validate", action="store_true",
                   help="schema-check only; exit 1 on problems")
    args = p.parse_args(argv)
    events = load_events(args.events)
    if not events:
        print(json.dumps({"error": f"no events in {args.events}"}),
              file=sys.stderr)
        return 1
    doc = render(events)
    problems = validate(doc)
    if problems:
        for msg in problems:
            print(f"INVALID: {msg}", file=sys.stderr)
        return 1
    if args.validate:
        n_flow = sum(1 for e in doc["traceEvents"]
                     if e.get("cat") == "flow")
        print(f"valid Chrome-trace JSON: "
              f"{len(doc['traceEvents'])} events "
              f"({n_flow} flow bindings, "
              f"{len(doc['otherData']['streams'])} stream lane(s))")
        return 0
    out = args.out or (args.events.rstrip("/") + ".trace.json")
    with open(out, "w") as f:
        json.dump(doc, f)
    print(f"wrote {out}: {len(doc['traceEvents'])} trace events "
          f"from {len(events)} recorder events "
          f"(open in chrome://tracing or ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
