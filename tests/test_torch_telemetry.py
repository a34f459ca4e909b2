"""The port's span journal, pipeline health, SLO tracker and profile
capture (``srtb_tpu_torch/utils/telemetry.py``, ``slo.py``,
``tracing.py``) against the JAX package's (the reference runs in its own
interpreter, ``tests/test_torch_ref.py``):

- ``segment_span`` for the same arguments and registry: equal records;
- ``SpanJournal``'s size rotation, gzip and plaintext generations, the
  orphaned rotation a previous life left, and ``rotated_generation``;
- ``health()``'s staleness, per admitted stream, on a fake clock;
- the ``SloTracker``'s states, gauges and events under a scripted clock;
- a whole run: ``srtb-torch-main --device cpu`` and ``srtb-main`` on
  ``test_torch_pipeline.py``'s three-segment file (the pulse in segment
  1) with the journal and the events dump armed, in the serial leg and at
  the default window, with and without ``--fault_plan dispatch:oom@1``:
  the journal's fields that are not times, each trace's ``(type, seg)``
  sequence of events, and the deterministic counters of
  ``/metrics.json``;
- ``profile_capture_segments``: a torch.profiler trace whose user
  annotations hold the stage names, and its sidecar."""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from collections import defaultdict

import pytest

from srtb_tpu_torch.gui.server import WaterfallHTTPServer
from srtb_tpu_torch.tools import main as M
from srtb_tpu_torch.utils import events as E
from srtb_tpu_torch.utils import slo as S
from srtb_tpu_torch.utils import telemetry as T
from srtb_tpu_torch.utils.metrics import metrics
from test_torch_pipeline import make_case
from test_torch_ref import (health_script, journal_script, run_reference,
                            slo_script, span_record)

# segment_span cases: (registry values (name, value, labels), kwargs)
COUNTERS = [("packets_total", 1000.0, None), ("packets_lost", 3.0, None),
            ("segments_dropped", 2.0, None), ("degrade_level", 1.0, None),
            ("retries_total", 4.0, None), ("watchdog_requeues", 1.0, None),
            ("worker_restarts", 1.0, None), ("h2d_bytes", 123456.0, None),
            ("ring_cold_dispatches", 2.0, None),
            ("plan_demotions", 1.0, None), ("plan_ladder_level", 1.0, None),
            ("compile_seconds", 1.23456, None), ("plan_compiles", 3.0, None),
            ("recovered_segments", 2.0, None),
            ("plan_demotions", 5.0, {"stream": "beam1"}),
            ("compile_seconds", 0.5, {"stream": "beam1"}),
            ("segments_dropped", 7.0, {"stream": "beam1"})]
SPANS = {
    "minimal": {"segment": 0, "stages_s": {"ingest": 0.001},
                "queue_depth": 1, "detections": 0, "dump": False,
                "samples": 65536},
    "engine": {"segment": 4, "stages_s": {"ingest": 0.0012345,
                                          "dispatch": 0.0101, "fetch": 0.2,
                                          "sink": 0.03},
               "queue_depth": 2, "detections": 13, "dump": True,
               "samples": 1 << 30, "timestamp_ns": 1700000000000015152,
               "extra": {"quality": {"zap_frac": 0.25}},
               "overlap_hidden_s": -0.5, "inflight_depth": 2,
               "active_plan": "staged:four_step+ring", "trace_id": 17,
               "device_s": 0.321, "achieved_msamps": 3345.678901,
               "roofline_frac": 0.123456789},
    "named_stream": {"segment": 1, "stages_s": {"sink": 0.5},
                     "queue_depth": 0, "detections": 2, "dump": False,
                     "samples": 4096, "stream": "beam1", "trace_id": 0},
}
# journal cases: (max_bytes, compress, number of records, orphans)
JOURNALS = {
    "gzip": (400, True, 12, []),
    "plain": (400, False, 12, []),
    "no_rotation": (1 << 20, True, 5, []),
    "orphans": (10_000, True, 3, [("spans.jsonl.rot1", "old\n"),
                                  ("spans.jsonl.rot7", "newer\n")]),
}
HEALTH = {
    "solo": [("health", 5.0), ("mark", None), ("tick", 3.0),
             ("health", 5.0), ("tick", 3.0), ("health", 5.0),
             ("mark", None), ("health", 5.0)],
    "streams": [("register", "a"), ("register", "b"), ("health", 5.0),
                ("mark", "a"), ("tick", 2.0), ("mark", "b"), ("tick", 4.0),
                ("health", 5.0), ("mark", "a"), ("health", 5.0),
                ("release", "b"), ("health", 5.0)],
}
SLO = {
    "latency_loss": (
        {"latency_ms": 100.0, "latency_budget": 0.1, "loss_budget": 0.05,
         "fast_window_s": 60.0, "slow_window_s": 600.0},
        [("eval",), ("seg", "", 0.05), ("tick", 1.0), ("eval",),
         ("seg", "", 0.5), ("seg", "", 0.2), ("drop", "", 1), ("eval",),
         ("tick", 120.0), ("seg", "", 0.01), ("eval",), ("tick", 900.0),
         ("eval",)]),
    "staleness_streams": (
        {"staleness_s": 5.0, "staleness_budget": 0.1,
         "fast_window_s": 30.0, "slow_window_s": 300.0,
         "burn_threshold": 2.0},
        [("seg", "a", 0.1), ("seg", "b", 0.1), ("eval",), ("tick", 10.0),
         ("seg", "b", 0.1), ("eval",), ("tick", 40.0), ("eval",),
         ("tick", 400.0), ("eval",)]),
    "sensitivity": (
        {"sensitivity_budget": 0.25, "fast_window_s": 60.0,
         "slow_window_s": 120.0},
        [("canary", "", True), ("canary", "", False), ("eval",),
         ("canary", "", False), ("canary", "", False), ("eval",),
         ("tick", 200.0), ("eval",)]),
}
SLO_CFG = {"slo_latency_ms": 250.0, "slo_staleness_s": 30.0}

# the whole runs: extra srtb-main arguments of each
RUNS = {
    "serial": ["--inflight_segments", "1"],
    "window": [],
    "oom_serial": ["--inflight_segments", "1", "--fault_plan",
                   "dispatch:oom@1"],
    "oom_window": ["--fault_plan", "dispatch:oom@1"],
}
# the span's cumulative registry fields
CUMULATIVE = ("packets_total", "packets_lost", "segments_dropped",
              "degrade_level", "retries", "requeues", "restarts",
              "shed_waterfalls", "shed_baseband", "h2d_bytes",
              "ring_cold_dispatches", "plan_demotions", "plan_promotions",
              "device_reinits", "plan_ladder_level", "recovered_segments",
              "replayed_skips", "rolled_back_intents", "plan_compiles",
              "aot_cache_hits", "aot_cache_misses")
# the span's fields that are times or depend on the threads' timing
TIMED = ("ts", "stages_ms", "compile_ms", "overlap_hidden_ms", "device_ms",
         "achieved_msamps", "roofline_frac", "queue_depth",
         "inflight_depth", "trace_id")


def _run_paths(d, name):
    return (str(d / f"{name}_journal.jsonl"), str(d / f"{name}_events.jsonl"),
            d / name)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("telemetry")
    argv, _ = make_case(tmp)
    return tmp, argv


def _run_argv(argv, journal, events_path, out_dir, extra):
    return argv + extra + ["--telemetry_journal_path", journal,
                           "--events_dump_path", events_path,
                           "--baseband_output_file_prefix",
                           f"{out_dir}/out_"]


@pytest.fixture(scope="module")
def ref(case, tmp_path_factory):
    tmp, argv = case
    jobs = [{"key": f"span/{name}", "fn": "test_torch_ref:span_record",
             "args": ["srtb_tpu", COUNTERS, kwargs]}
            for name, kwargs in SPANS.items()]
    jobs += [{"key": f"journal/{name}", "fn": "test_torch_ref:journal_script",
              "args": ["srtb_tpu", str(tmp / "ref_journal" / name), mb, gz,
                       [{"segment": i, "pad": "x" * 40} for i in range(n)],
                       orphans]}
             for name, (mb, gz, n, orphans) in JOURNALS.items()]
    jobs += [{"key": f"health/{name}", "fn": "test_torch_ref:health_script",
              "args": ["srtb_tpu", script]}
             for name, script in HEALTH.items()]
    jobs += [{"key": f"slo/{name}", "fn": "test_torch_ref:slo_script",
              "args": ["srtb_tpu", params, script, SLO_CFG]}
             for name, (params, script) in SLO.items()]
    d = tmp / "ref_runs"
    for name, extra in RUNS.items():
        journal, events_path, out_dir = _run_paths(d, name)
        out_dir.mkdir(parents=True)
        jobs.append({"key": f"run/{name}",
                     "fn": "test_torch_ref:observed_main",
                     "args": [_run_argv(argv, journal, events_path, out_dir,
                                        extra), journal, events_path]})
    return run_reference(jobs, tmp_path_factory.mktemp("ref_telemetry"))


@pytest.fixture
def fresh():
    """A fresh registry, flight recorder and SLO tracker around a test (a
    pipeline arms a new recorder over a disarmed one)."""
    saved = E.hub
    metrics.reset()
    S.reset()
    E.configure(False)
    yield
    metrics.reset()
    S.reset()
    E.hub = saved


# ------------------------------------------------------ the span record

@pytest.mark.parametrize("name", sorted(SPANS))
def test_segment_span_equals_reference(ref, fresh, name):
    """The same record (less its wall clock) for the same arguments and
    registry values; a named span reads the stream's own series."""
    got = span_record("srtb_tpu_torch", COUNTERS, SPANS[name])["record"]
    assert got == str(ref[f"span/{name}/record"])
    rec = json.loads(got)
    assert rec["v"] == T.SPAN_SCHEMA_VERSION == 11
    assert not {"batch_size", "batch_wait_ms", "device"} & set(rec)


# ----------------------------------------------------------- the journal

@pytest.mark.parametrize("name", sorted(JOURNALS))
def test_span_journal_rotation_equals_reference(ref, tmp_path, name):
    """Single-generation size rotation, gzipped or plain, the orphaned
    ``.rotN`` of a previous life adopted as ``.1``: the same files, the
    same active and rotated text, the same ``rotated_generation``."""
    mb, gz, n, orphans = JOURNALS[name]
    got = journal_script("srtb_tpu_torch", str(tmp_path / name), mb, gz,
                         [{"segment": i, "pad": "x" * 40} for i in range(n)],
                         orphans)
    assert got["files"].tolist() == ref[f"journal/{name}/files"].tolist()
    for key in ("active", "rotated", "generation"):
        assert got[key] == str(ref[f"journal/{name}/{key}"]), key
    if name == "gzip":
        assert got["generation"] == "spans.jsonl.1.gz" and got["rotated"]


def test_span_journal_disables_itself_on_io_failure(tmp_path):
    """An I/O failure logs once and drops the journal; the run goes on."""
    class Full:
        def write(self, _line):
            raise OSError(28, "No space left on device")

        def close(self):
            pass
    j = T.SpanJournal(str(tmp_path / "j.jsonl"))
    j._file.close()
    j._file = Full()
    j.write({"segment": 0})
    assert j._file is None
    j.write({"segment": 1})
    j.close()
    with pytest.raises(ValueError):
        T.SpanJournal(str(tmp_path / "k.jsonl"), max_bytes=0)


# -------------------------------------------------------- health and SLO

@pytest.mark.parametrize("name", sorted(HEALTH))
def test_health_staleness_equals_reference(ref, fresh, name):
    """Idle before the first segment, stale past the limit, each admitted
    stream aged on its own: the reference's reports."""
    got = health_script("srtb_tpu_torch", HEALTH[name])["reports"]
    assert got.tolist() == ref[f"health/{name}/reports"].tolist()


@pytest.mark.parametrize("name", sorted(SLO))
def test_slo_states_equal_reference(ref, fresh, name):
    """The burn rates, states, gauges and transition events of the same
    scripted feed, and the objectives a config arms."""
    params, script = SLO[name]
    got = slo_script("srtb_tpu_torch", params, script, SLO_CFG)
    for key in ("reports", "events", "objectives"):
        assert got[key].tolist() == ref[f"slo/{name}/{key}"].tolist(), key
    for g in ("slo_burn_rate", "slo_state"):
        assert got["gauges"][g] == str(ref[f"slo/{name}/gauges/{g}"]), g


def test_slo_configure_keeps_an_identical_tracker(fresh):
    """No objective armed: None, zero cost; the same parameters keep the
    live tracker (and its windows); the module hooks feed it."""
    from srtb_tpu_torch.config import Config
    assert S.configure(Config()) is None and S.evaluate() is None
    t = S.configure(Config(slo_loss_budget=0.1))
    assert S.configure(Config(slo_loss_budget=0.1)) is t
    S.note_dropped("", 2)
    assert S.evaluate()["_pipeline"]["loss"]["state"] == "burning"


# ------------------------------------------------------------ whole runs

def _by_trace(lines) -> list:
    """Each trace's ``(type, seg)`` sequence, the traces in id order."""
    seqs = defaultdict(list)
    for line in lines:
        e = json.loads(line)
        seqs[e["trace"]].append((e["type"], e["seg"]))
    return [seqs[k] for k in sorted(seqs)]


def _scrape(directory, path):
    server = WaterfallHTTPServer(str(directory)).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read())
    finally:
        server.stop()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_whole_run_journal_events_and_counters_equal_reference(
        ref, case, fresh, name):
    """The journal's records in every field that is not a time (in the
    serial leg every cumulative counter at every segment; at the window,
    whose sink thread records while the engine dispatches, at the last
    segment), each trace's sequence of events, and the deterministic
    counters of ``/metrics.json``; with the injected out-of-memory, the
    demotion's counters and events too."""
    tmp, argv = case
    journal, events_path, out_dir = _run_paths(tmp / "port_runs", name)
    out_dir.mkdir(parents=True)
    stats, pipe = M.run(_run_argv(argv, journal, events_path, out_dir,
                                  RUNS[name]) + ["--device", "cpu"])
    assert stats.segments == 3 and pipe.positive_segments == [1]
    assert int(ref[f"run/{name}/rc"]) == 0
    with open(journal) as f:
        spans = [json.loads(line) for line in f]
    ref_spans = [json.loads(x) for x in ref[f"run/{name}/journal"]]
    assert len(spans) == len(ref_spans) == 3
    serial = name.endswith("serial")
    for i, (got, want) in enumerate(zip(spans, ref_spans)):
        assert set(got) == set(want), i
        assert got["v"] == 11 and set(got["stages_ms"]) == set(
            want["stages_ms"]) == {"ingest", "dispatch", "fetch", "sink"}
        for key in set(want) - set(TIMED) - (
                set() if serial or i == 2 else set(CUMULATIVE)):
            assert got[key] == want[key], (i, key)
    with open(events_path) as f:
        got_ev = _by_trace(f.read().splitlines())
    assert got_ev == _by_trace(ref[f"run/{name}/events"])
    status, snap = _scrape(out_dir, "/metrics.json")
    want = json.loads(str(ref[f"run/{name}/snapshot"]))
    assert status == 200
    keys = ["segments", "samples", "signals", "file_bytes_read",
            "plan_demotions", "plan_ladder_level", "faults_injected"]
    for key in keys:
        assert snap.get(key, 0.0) == want.get(key, 0.0), key
    assert snap["segments"] == 3 and snap["signals"] == 1
    flat = [t for seq in got_ev for t, _seg in seq]
    if name.startswith("oom"):
        assert snap["plan_demotions"] == 1 == flat.count("heal.demote")
        assert flat.count("fault.injected") == 1
        assert spans[-1]["active_plan"] == pipe.plan_history[-1][1]
    else:
        assert "heal.demote" not in flat


def test_profile_capture_writes_a_trace_with_the_stages(case, fresh,
                                                        tmp_path):
    """``profile_capture_segments = 1``: a Chrome trace whose user
    annotations hold the host stages' names, and the sidecar naming the
    segment and trace id it covered, counted once."""
    _tmp, argv = case
    prof = tmp_path / "profile"
    stats, _pipe = M.run(argv + [
        "--device", "cpu", "--inflight_segments", "1",
        "--profile_capture_segments", "1", "--profile_capture_dir",
        str(prof), "--baseband_output_file_prefix", f"{tmp_path}/out_"])
    assert stats.segments == 3
    with open(prof / "trace.json") as f:
        evs = json.load(f)["traceEvents"]
    names = {e["name"] for e in evs if e.get("cat") == "user_annotation"}
    assert {"srtb:ingest", "srtb:dispatch", "srtb:fetch",
            "srtb:sink"} <= names
    with open(prof / "capture.json") as f:
        side = json.load(f)
    assert side["segments"] == 1 and side["first_segment"] == 0
    assert side["first_trace_id"] >= 1
    assert metrics.get("profile_captures") == 1


def test_healthz_goes_stale_and_fleet_stays_unported(fresh, tmp_path):
    """``/healthz`` answers 200 before the first segment and while they
    come, 503 past ``health_stale_after_s``; ``/fleet`` stays 501."""
    server = WaterfallHTTPServer(str(tmp_path),
                                 health_stale_after_s=0.05).start()
    try:
        def get(path):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{server.port}{path}",
                        timeout=10) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()
        status, body = get("/healthz")
        assert status == 200 and json.loads(body)["status"] == "idle"
        T.mark_segment()
        status, body = get("/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        time.sleep(0.1)
        status, body = get("/healthz")
        assert status == 503 and json.loads(body)["status"] == "stale"
        status, body = get("/fleet")
        assert status == 501 and "ROADMAP A8" in body
        status, body = get("/metrics")
        assert status == 200 and "srtb_last_segment_monotonic" in body
    finally:
        server.stop()
