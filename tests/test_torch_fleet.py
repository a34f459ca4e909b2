"""The port's stream fleet (ROADMAP A8b) against the JAX package's
(``srtb_tpu/pipeline/fleet.py`` and its tests ``tests/test_fleet.py``,
``test_fleet_batch.py``): the same streams, made from seeds with numpy,
through both packages' ``StreamFleet`` (the reference's in the runner's
subprocess, the port's on the CPU), each scenario's statuses, drained and
dropped counts, counters and journal fields equal to the reference's,
every stream's detection decisions (signal counts, zapped channels,
positives) equal to the reference's exactly, and the port's fleet lanes
equal to the port's own solo runs bit for bit, time series included (the
reference's vmap tolerance, rtol 1e-5 and atol 1e-4·max(|golden|, 1), is
the batched lanes' contract; the port's batch is a solo dispatch a member,
so it holds with room).  Scenarios whose results follow the scheduler's
timing (the batch former's flushes, a rolling restart's order) are held
to the reference's invariants in both packages.  Then ``fleet_soak``
(solo, ``--batch``, ``--selftest``, ``--migrate``) against the reference's
reports, ``trace_join`` on a virtual 2-member pool's journals, and the
card's twins of the fleet legs (``cuda``-marked)."""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io.synth import make_dispersed_baseband_host
from srtb_tpu_torch.pipeline.fleet import (SharedPlanCache, StreamFleet,
                                           StreamSpec)
from srtb_tpu_torch.pipeline.segment import SegmentProcessor
from srtb_tpu_torch.pipeline.work import SegmentWork
from srtb_tpu_torch.tools import fleet_soak as FS
from srtb_tpu_torch.utils.metrics import metrics
from test_torch_ref import (DecisionCap, _flatten, fleet_resume, fleet_run,
                            fleet_units, run_reference)

N = 1 << 13
SEGMENTS = 4
PORT = "srtb_tpu_torch"
# the reference's documented vmap tolerance (tools/fleet_soak.py)
VMAP_RTOL = 1e-5
VMAP_ATOL_FRAC = 1e-4


def make_bb(d, tag: str, seed: int) -> str:
    path = os.path.join(str(d), f"bb_{tag}.bin")
    make_dispersed_baseband_host(
        N * SEGMENTS, 1405.0, 64.0, 0.05,
        pulse_positions=[N // 2 + j * N for j in range(SEGMENTS)],
        pulse_amp=30.0, nbits=8, seed=seed).tofile(path)
    return path


def mkfields(d, tag: str, infile: str, **kw) -> dict:
    """The reference's fleet tests' config (``tests/test_fleet.py``)."""
    base = dict(
        baseband_input_count=N, baseband_input_bits=8,
        baseband_freq_low=1405.0, baseband_bandwidth=64.0,
        baseband_sample_rate=128e6, dm=0.05, input_file_path=infile,
        baseband_output_file_prefix=os.path.join(str(d), tag + "_"),
        spectrum_channel_count=64,
        mitigate_rfi_average_method_threshold=100.0,
        mitigate_rfi_spectral_kurtosis_threshold=2.0,
        baseband_reserve_sample=True, writer_thread_count=0,
        fft_strategy="four_step", inflight_segments=2,
        retry_backoff_base_s=0.001)
    base.update(kw)
    return base


SEEDS = {"s0": 0, "s1": 1, "s2": 2, "v": 0, "h": 1, "h0": 1, "h1": 2,
         "a": 0, "b": 0, "c": 0, "bad": 0, "good": 1, "a0": 0, "a1": 1,
         "lone": 2, "solo1": 0, "broken": 0, "queued": 0, "s": 0,
         "beam0": 0, "mig": 5}


def scenarios(d) -> dict:
    """name -> fleet_run's keyword arguments, every path under ``d`` (the
    reference's and the port's runs each get a directory of their own)."""
    files = {t: os.path.join(str(d), "..", "inputs", f"bb_{t}.bin")
             for t in SEEDS}

    def s(tag, **kw):
        return mkfields(d, tag, files[tag], **kw)

    def j(tag):
        return os.path.join(str(d), f"j_{tag}.jsonl")

    man = {t: os.path.join(str(d), f"man_{t}.jsonl") for t in ("v", "h")}
    return {
        "matches_solo": dict(streams={t: s(t) for t in ("s0", "s1")},
                             solo=True),
        "victim_oom": dict(streams={t: s(t, fault_plan="s1:dispatch:oom@1",
                                         telemetry_journal_path=j(t))
                                    for t in ("s0", "s1", "s2")},
                           solo=True),
        "halt_reinit": dict(streams={
            t: s(t, fault_plan="s1:dispatch:device_halt@2",
                 device_reinit_max=1) for t in ("s0", "s1")}, solo=True),
        "manifest_rollback": dict(
            streams={t: s(t, run_manifest_path=man[t]) for t in ("v", "h")},
            debris={"v": (man["v"], os.path.join(str(d), "v_debris.npy"))}),
        "admission": dict(streams={
            t: s(t, stream_priority=p, fleet_max_streams=1,
                 fleet_queue_limit=1)
            for t, p in (("a", 0), ("b", 5), ("c", 9))}),
        "start_failure": dict(streams={
            "broken": s("broken", sanitize=True, fleet_max_streams=1,
                        fleet_queue_limit=1),
            "queued": s("queued")}),
        "sanitize": dict(streams={"s": s("s", sanitize=True)}),
        "rt_micro": dict(streams={"s": s("s", micro_batch_segments=2,
                                         input_file_path="")}),
        "file_micro": dict(streams={"s": s("s", micro_batch_segments=2,
                                           inflight_segments=4)}),
        "micro_exceeds": dict(streams={"s": s("s", micro_batch_segments=4,
                                              inflight_segments=2)}),
        "lane_failure": dict(streams={
            "bad": s("bad", fault_plan="bad:dispatch:fatal@1"),
            "good": s("good")}, solo=True),
        "pool_halt": dict(streams={
            t: s(t, fleet_devices=2, device_reinit_max=1,
                 fault_plan="s1:dispatch:device_halt@2",
                 telemetry_journal_path=j(t)) for t in ("s0", "s1")},
            solo=True),
        "rebalance": dict(streams={
            t: s(t, fleet_devices=2, migrate_on_burn=True)
            for t in ("s0", "s1", "s2")}, burn=["s2"], solo=True),
        "rolling": dict(streams={t: s(t, fleet_devices=2)
                                 for t in ("s0", "s1")},
                        rolling=True, solo=True),
        "prom_labels": dict(streams={"beam0": s("beam0")},
                            prom=['srtb_inflight_depth{stream="beam0"}',
                                  'srtb_segments{stream="beam0"}']),
        # the batch former (tests/test_fleet_batch.py)
        "batched": dict(streams={t: s(t, fleet_batch_max=2,
                                      telemetry_journal_path=j(t))
                                 for t in ("s0", "s1", "s2")}, solo=True),
        "grouping": dict(streams={
            t: s(t, fleet_batch_max=4, telemetry_journal_path=j(t),
                 **({"spectrum_channel_count": 32} if t == "lone" else {}))
            for t in ("a0", "a1", "lone")}),
        "lone_linger": dict(streams={"solo1": s(
            "solo1", fleet_batch_max=4,
            fleet_batch_linger_ms=3_600_000.0)}),
        "victim_batched": dict(streams={
            t: s(t, fleet_batch_max=3, fault_plan="v:dispatch:oom@1",
                 telemetry_journal_path=j(t)) for t in ("v", "h0", "h1")},
            solo=True),
    }


# the scenarios whose counts and journals follow the scheduler's timing
# (the batch former's flushes, a rolling restart's order, whether a failed
# lane's sink thread took its last fetched segment before the teardown):
# held to the reference's invariants, not to its exact numbers
TIMED = {"batched", "grouping", "victim_batched", "rolling", "rebalance",
         "lane_failure"}


def resume_fields(d) -> tuple:
    infile = os.path.join(str(d), "..", "inputs", "bb_mig.bin")

    def f(tag, run_dir, **kw):
        os.makedirs(run_dir, exist_ok=True)
        return mkfields(
            d, tag, infile,
            baseband_output_file_prefix=os.path.join(run_dir, "out_"),
            checkpoint_path=os.path.join(run_dir, "ck.json"),
            run_manifest_path=os.path.join(run_dir, "manifest.jsonl"),
            deterministic_timestamps=True,
            mitigate_rfi_average_method_threshold=1000.0,
            mitigate_rfi_spectral_kurtosis_threshold=50.0,
            signal_detect_signal_noise_threshold=2.0,
            signal_detect_max_boxcar_length=8, inflight_segments=1, **kw)
    run_dir = os.path.join(str(d), "mig_run")
    return (f("golden", os.path.join(str(d), "golden_run")),
            f("p1", run_dir, fleet_devices=2,
              fault_plan="checkpoint:fatal@1"),
            f("p2", run_dir, fleet_devices=2))


SOAKS = {
    "soak": dict(fn="run_soak", kw=dict(streams=3, segments=4, log2n=12)),
    # the victim's faults without its demotion (a demoted victim leaves
    # the group, and the 2x amortization bound then hangs on one batch's
    # size, which follows the host's load in both packages), and a
    # partial batch waiting for its family rather than a 2 ms linger
    "soak_batch": dict(fn="run_soak", kw=dict(
        streams=4, segments=5, log2n=12, batch=4,
        plan="stream0:sink_write:raise@2,stream0:fetch:stall=0.05@3",
        extra_cfg={"fleet_batch_linger_ms": 60_000.0})),
    "soak_scoped": dict(fn="run_soak", kw=dict(
        streams=2, segments=3, log2n=11, plan="stream0:dispatch:oom@1")),
    "migrate": dict(fn="run_migrate", kw=dict(streams=3, segments=6,
                                              log2n=12)),
    "migrate_rolling": dict(fn="run_migrate", kw=dict(
        streams=3, segments=6, log2n=12, rolling=True)),
}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    inputs = root / "inputs"
    inputs.mkdir()
    for tag, seed in SEEDS.items():
        make_bb(inputs, tag, seed)
    return root


@pytest.fixture(scope="module")
def ref(tmp_path_factory, work):
    """The reference's runs, under ``<work>/ref``, in three interpreters
    at once."""
    base = work / "ref"
    base.mkdir()
    parts: tuple = ([], [], [])
    parts[0].append({"key": "units", "fn": "test_torch_ref:fleet_units",
                     "args": ["srtb_tpu"]})
    for i, (name, kw) in enumerate(scenarios(base).items()):
        parts[i % 2].append({"key": name, "fn": "test_torch_ref:fleet_run",
                             "args": ["srtb_tpu"], "kwargs": kw})
    parts[0].append({"key": "resume", "fn": "test_torch_ref:fleet_resume",
                     "args": ["srtb_tpu", *resume_fields(base)]})
    for name, job in SOAKS.items():
        d = base / name
        d.mkdir()
        parts[2].append({"key": name,
                         "fn": f"srtb_tpu.tools.fleet_soak:{job['fn']}",
                         "kwargs": dict(job["kw"], tmpdir=str(d))})
    parts[2].append({"key": "selftest",
                     "fn": "srtb_tpu.tools.fleet_soak:selftest",
                     "kwargs": {"log2n": 11}})
    dirs = [tmp_path_factory.mktemp("ref_fleet") for _ in parts]
    with ThreadPoolExecutor(len(parts)) as pool:
        outs = list(pool.map(
            lambda part: run_reference(*part, compile_cache=True),
            zip(parts, dirs)))
    return {k: v for out in outs for k, v in out.items()}


@pytest.fixture(scope="module")
def port(work):
    """The port's runs, under ``<work>/port``, flattened as the
    reference's."""
    base = work / "port"
    base.mkdir()
    out: dict = {}
    _flatten("units", fleet_units(PORT), out)
    for name, kw in scenarios(base).items():
        _flatten(name, fleet_run(PORT, **kw), out)
    _flatten("resume", fleet_resume(PORT, *resume_fields(base)), out)
    for name, job in SOAKS.items():
        d = base / name
        d.mkdir()
        _flatten(name, getattr(FS, job["fn"])(
            device="cpu", tmpdir=str(d), **job["kw"]), out)
    _flatten("selftest", FS.selftest(log2n=11, device="cpu"), out)
    return out


def _keys(d: dict, prefix: str) -> set:
    return {k for k in d if k.startswith(prefix)}


def _val(d: dict, key: str):
    """A flattened value, a list flattened by index put back together."""
    if key not in d:
        i, out = 0, []
        while f"{key}/{i}" in d:
            out.append(_val(d, f"{key}/{i}"))
            i += 1
        return out
    v = d[key]
    return v.tolist() if isinstance(v, np.ndarray) else v


# --------------------------------------------------------- pure parts


def test_units_equal_the_references(ref, port):
    """Admission (capacity, queue, priority eviction, the loner-family
    tie-break, migration re-admission), the shed policy (priority order,
    hysteresis, batch-aware order, the loss trigger, its refusal),
    placement (tenants, least-loaded, anti-affinity, pins, targets), the
    pool (one member, distinct caches, the virtual halt once, skipped in
    a formed batch, the state gauges, the re-arm), the batch former on
    stub lanes (priority fill, the ragged tail, the linger, grouping by
    processor) and the span's v10/v11 fields: every value the
    reference's."""
    keys = _keys(ref, "units/")
    assert keys == _keys(port, "units/")
    for k in sorted(keys):
        assert _val(port, k) == _val(ref, k), k


def test_units_hold_the_references_assertions(port):
    """The reference's own asserted values (``tests/test_fleet.py``,
    ``test_fleet_batch.py``, ``test_pool.py``)."""
    p = lambda k: _val(port, "units/" + k)  # noqa: E731
    assert p("adm") == ["admit", "admit", "queue", "reject", "queue"]
    assert p("adm_rejected") == ["d", "c"] and p("adm_queued") == ["e"]
    assert p("adm_pop") == ["e", "None"]
    assert p("adm_loner_rejected") == ["lone"]
    assert p("adm_loner_queued") == ["vip", "mate"]
    assert p("adm_nokey_rejected") == ["q1"]
    assert p("shed_batched") == [["solo"], ["bat", "solo"], ["solo"]]
    assert p("shed_3tuple") == ["a"]
    assert p("halt_fired") == [0, 0, 1, 0, 0]
    assert p("halt_type") == "DeviceHalt"
    assert p("former_shared")[0] == ["high", "mid", "low"]
    assert p("former_solo") == ["high"]
    assert p("former_pump") == [0, 1, 0]
    assert p("rearmed") == ["ok", "ok"]
    assert p("span_solo") == []


def test_shared_plan_cache_key_ignores_tenancy(work):
    infile = str(work / "inputs" / "bb_s0.bin")
    a = Config(**mkfields(work, "a", infile, stream_name="a",
                          stream_priority=1,
                          checkpoint_path=str(work / "a.ck")))
    b = Config(**mkfields(work, "b", infile, stream_name="b"))
    assert SegmentProcessor.plan_cache_key(a) == \
        SegmentProcessor.plan_cache_key(b)
    c = Config(**mkfields(work, "c", infile, spectrum_channel_count=128))
    assert SegmentProcessor.plan_cache_key(a) != \
        SegmentProcessor.plan_cache_key(c)


def test_shared_plan_cache_compiles_once(work):
    infile = str(work / "inputs" / "bb_s0.bin")
    metrics.reset()
    cache = SharedPlanCache(torch_device=torch.device("cpu"))
    p1 = cache.get(Config(**mkfields(work, "a", infile)))
    p2 = cache.get(Config(**mkfields(work, "b", infile)))
    assert p1 is p2 and cache.compiles == 1 and cache.hits == 1
    assert p1._fleet_shared
    # an unforced retire is refused on a shared processor (a lane's
    # demotion must not disarm its neighbors)
    p1.retire()
    assert not p1._retired
    p1._check_live()
    p3 = cache.get(Config(**mkfields(work, "c", infile,
                                     spectrum_channel_count=128)))
    assert p3 is not p1 and cache.compiles == 2
    cache.invalidate()
    with pytest.raises(RuntimeError, match="retired"):
        p1.stage_input(np.zeros(p1._segment_bytes, np.uint8))
    metrics.reset()


# ------------------------------------------------------- fleet e2e


SCENARIO_NAMES = list(scenarios("x"))


def _results(d: dict, name: str) -> dict:
    out = {}
    for k in _keys(d, f"{name}/results/"):
        stream, field = k.split("/")[2:4]
        out.setdefault(stream, {})[field] = _val(d, k)
    return out


@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_statuses_and_books_equal_the_references(ref, port, name):
    """Each stream's status, error type, drained and dropped counts,
    device and plan name (a demoted lane's too) are the reference's; in
    the untimed scenarios so are its migrations."""
    want, got = _results(ref, name), _results(port, name)
    assert set(got) == set(want)
    for stream in want:
        for field in ("status", "error", "device"):
            assert got[stream][field] == want[stream][field], \
                (stream, field)
        assert got[stream]["drained"] + got[stream]["dropped"] == \
            want[stream]["drained"] + want[stream]["dropped"], stream
        if name not in TIMED:
            for field in ("drained", "dropped", "migrations"):
                assert got[stream][field] == want[stream][field], \
                    (stream, field)
        # the port's plan names are the reference's (rung names too)
        assert got[stream]["plan"] == want[stream]["plan"], stream


@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_decisions_equal_the_references(ref, port, name):
    """Every stream's drained decisions equal the reference's exactly (in
    a timed scenario, those both drained)."""
    for stream in _results(ref, name):
        pre = f"{name}/decisions/{stream}/"
        n = int(ref[pre + "n"])
        if name not in TIMED:
            assert int(port[pre + "n"]) == n
        n = min(n, int(port[pre + "n"]))
        if n:
            for key in ("signal_counts", "zero_count", "positive"):
                assert np.array_equal(port[pre + key][:n],
                                      ref[pre + key][:n]), key


@pytest.mark.parametrize("name", [n for n, kw in scenarios("x").items()
                                  if kw.get("solo")])
def test_fleet_lanes_equal_their_solo_runs(ref, port, name):
    """In both packages every finished lane drains its solo run's
    segments.  The port's lanes equal its own solo runs bit for bit, time
    series included, batched ones too; a demoted or reinitialized lane
    keeps its decisions (the reference's contract)."""
    for d, exact in ((port, True), (ref, False)):
        for stream, r in _results(d, name).items():
            if r["status"] != "done":
                continue
            pre, solo = (f"{name}/decisions/{stream}/",
                         f"{name}/solo/{stream}/")
            assert int(d[pre + "n"]) == int(d[solo + "segments"])
            for key in ("signal_counts", "zero_count", "positive"):
                assert np.array_equal(d[pre + key], d[solo + key]), key
            if exact:
                np.testing.assert_array_equal(d[pre + "time_series"],
                                              d[solo + "time_series"])
            else:
                b = d[solo + "time_series"]
                np.testing.assert_allclose(
                    d[pre + "time_series"], b, rtol=VMAP_RTOL,
                    atol=VMAP_ATOL_FRAC * max(float(np.abs(b).max()), 1.0))


COUNTED = ("plan_demotions", "device_reinits", "device_drains",
           "migrations", "fleet_admitted", "fleet_queued",
           "fleet_rejected", "fleet_readmitted", "fleet_plan_compiles",
           "fleet_plan_cache_hits", "rolled_back_intents",
           "segments_dropped")


@pytest.mark.parametrize("name", sorted(set(SCENARIO_NAMES) - TIMED))
def test_counters_and_journals_equal_the_references(ref, port, name):
    """The counters (demotions, reinits, drains, migrations, admission's
    decisions, the plan cache's compiles and hits, rollbacks, loss), the
    stream-labeled twins, the pool's compiles and states, the journals'
    v11 fields (stream, segment, no batch fields on a solo dispatch; the
    first and last device and the last record's demotions: a record takes
    the lane's label and counters when the sink thread writes it, which
    a migration or a demotion on the scheduler thread may precede) and
    the debris and scrape checks: the reference's."""
    for k in COUNTED:
        key = f"{name}/counters/{k}"
        assert float(port[key]) == float(ref[key]), k
    assert _keys(port, f"{name}/by_label/") == _keys(ref, f"{name}/by_label/")
    for k in _keys(ref, f"{name}/by_label/"):
        assert float(port[k]) == float(ref[k]), k
    for k in ("pool_compiles", "pool_size", "compiles", "hits",
              "pool_states", "debris_left", "prom"):
        if f"{name}/{k}" in ref:
            assert _val(port, f"{name}/{k}") == _val(ref, f"{name}/{k}"), k
    jkeys = _keys(ref, f"{name}/journals/")
    assert jkeys == _keys(port, f"{name}/journals/")
    for k in jkeys:
        got, want = _val(port, k), _val(ref, k)
        if k.endswith(("/device", "/plan_demotions")):
            assert len(got) == len(want), k
            assert got[-1] == want[-1], k
            if k.endswith("/device"):
                assert got[0] == want[0] or name == "pool_halt", k
                assert set(got) == set(want), k
        else:
            assert got == want, k


def test_victim_oom_stays_the_victims(port):
    """The reference's bulkhead assertions on the port: the demotion is
    the victim's only, its plan differs from its neighbors', every
    journal is v11 and stream-stamped with its own demotions."""
    r = _results(port, "victim_oom")
    assert all(x["status"] == "done" for x in r.values())
    assert float(port["victim_oom/by_label/plan_demotions/s1"]) == 1.0
    assert "victim_oom/by_label/plan_demotions/s0" not in port
    assert r["s1"]["plan"] != r["s0"]["plan"]
    for t in ("s0", "s1", "s2"):
        pre = f"victim_oom/journals/{t}/"
        assert set(_val(port, pre + "v")) == {11}
        assert set(_val(port, pre + "stream")) == {t}
        assert _val(port, pre + "plan_demotions")[-1] == (t == "s1")


def test_pool_scoped_halt_drains_the_victim_only(port):
    """With two members a halt drains the faulted member (its cache
    alone retired, its lane migrated to the survivor) and spends no
    reinit; the migrant rejoins the survivor's family (one compile a
    member) and every stream equals its solo run."""
    c = lambda k: float(port[f"pool_halt/counters/{k}"])  # noqa: E731
    assert c("device_reinits") == 0 and c("device_drains") == 1
    assert c("plan_demotions") == 0
    assert float(port["pool_halt/by_label/migrations/s1"]) == 1.0
    r = _results(port, "pool_halt")
    assert r["s0"]["device"] == "dev0" and r["s1"]["device"] == "dev0"
    assert r["s1"]["migrations"] == 1
    assert int(port["pool_halt/pool_compiles"]) == 2
    assert _val(port, "pool_halt/pool_states") == ["ok", "halted"]
    devices = _val(port, "pool_halt/journals/s1/device")
    assert set(devices) == {"dev0", "dev1"} and devices[-1] == "dev0"
    assert set(_val(port, "pool_halt/journals/s0/device")) == {"dev0"}


def test_rebalance_and_rolling_restart_hold_the_references_invariants(
        ref, port):
    """Driver (b): the burning stream migrates once onto the strictly
    less-loaded member, nothing reinits, demotes or drops.  Driver (c):
    a rolling restart drains both members once, lanes migrate, both
    members re-arm, no loss.  In both packages."""
    for d in (ref, port):
        r = _results(d, "rebalance")
        assert all(x["status"] == "done" and x["dropped"] == 0
                   for x in r.values())
        assert r["s2"]["device"] == "dev1" and r["s2"]["migrations"] == 1
        assert float(d["rebalance/by_label/migrations/s2"]) == 1.0
        assert float(d["rebalance/counters/device_reinits"]) == 0
        assert float(d["rebalance/counters/plan_demotions"]) == 0
        r = _results(d, "rolling")
        assert all(x["status"] == "done" and x["dropped"] == 0
                   for x in r.values())
        assert float(d["rolling/counters/device_drains"]) == 2
        assert float(d["rolling/counters/migrations"]) >= 2
        assert float(d["rolling/counters/device_reinits"]) == 0
        assert _val(d, "rolling/pool_states") == ["ok", "ok"]


def test_killed_stream_resumes_on_the_other_member(ref, port):
    """A stream killed on member 0 after a segment committed resumes
    pinned to member 1: its output set equals an uninterrupted golden
    run's and fsck is clean, as the reference's."""
    for d in (ref, port):
        assert int(d["resume/golden_files"]) > 0
        assert _val(d, "resume/p1/status") == "failed"
        assert _val(d, "resume/p1/device") == "dev0"
        assert _val(d, "resume/p2/status") == "done"
        assert _val(d, "resume/p2/device") == "dev1"
        assert int(d["resume/p2/dropped"]) == 0
        assert int(d["resume/equal"]) == 1
        assert int(d["resume/fsck_clean"]) == 1
    assert int(port["resume/golden_files"]) == int(ref["resume/golden_files"])


def test_guardrails_refuse_as_the_reference(port):
    """``sanitize`` and a real-time lane's micro-batch are refused
    (ValueError, "file-mode"), a file lane micro-batches, a batch above
    the window is refused ("exceeds"); a failed start hands its slot to
    the queued stream; duplicate names are refused, and ``tsan`` arms the
    runtime concurrency checker, as the reference's does."""
    r = _results(port, "sanitize")["s"]
    assert r["status"] == "failed" and r["error"] == "ValueError"
    r = _results(port, "rt_micro")["s"]
    assert r["status"] == "failed" and "file-mode" in r["message"]
    r = _results(port, "file_micro")["s"]
    assert r["status"] == "done" and r["drained"] > 0
    assert "exceeds" in _results(port, "micro_exceeds")["s"]["message"]
    r = _results(port, "start_failure")
    assert r["broken"]["status"] == "failed"
    assert r["queued"]["status"] == "done" and r["queued"]["drained"] > 0
    r = _results(port, "admission")
    assert (r["a"]["status"], r["b"]["status"], r["c"]["status"]) == (
        "done", "rejected", "done")
    assert int(port["admission/compiles"]) == 1
    infile = "unused.bin"
    with pytest.raises(ValueError, match="duplicate"):
        StreamFleet([StreamSpec(name="s", cfg=Config(**mkfields(
            ".", "s1", infile))), StreamSpec(name="s", cfg=Config(
                **mkfields(".", "s2", infile)))], device="cpu")
    from srtb_tpu_torch.analysis.tsan import InstrumentedCondition, Tsan
    fleet = StreamFleet([StreamSpec(name="s", cfg=Config(**mkfields(
        ".", "s", infile, tsan=True)))], device="cpu")
    assert isinstance(fleet._tsan, Tsan)
    assert isinstance(fleet._wake, InstrumentedCondition)
    fleet.close()


def test_lane_failure_is_contained(port):
    r = _results(port, "lane_failure")
    assert r["bad"]["status"] == "failed" and r["good"]["status"] == "done"
    assert r["bad"]["drained"] + r["bad"]["dropped"] == r["bad"]["segments"]


# ------------------------------------------------------ batch former


@pytest.mark.parametrize("d_name", ("ref", "port"))
def test_batched_scenarios_hold_the_references_invariants(ref, port,
                                                          d_name):
    """``fleet_batch_max`` = 2 over three streams: batched and ragged
    solo dispatches both happen, one compile, every record of a batched
    segment carries ``batch_size`` 2 and a wait, solo ones neither; a
    foreign family (32 channels) never batches; a lone tenant never
    waits out an hour's linger; a demoted victim leaves the group from
    its faulted segment on while its neighbors batch."""
    d = {"ref": ref, "port": port}[d_name]
    r = _results(d, "batched")
    assert all(x["status"] == "done" and x["dropped"] == 0
               for x in r.values())
    assert int(d["batched/compiles"]) == 1 and int(d["batched/hits"]) == 2
    bd = float(d["batched/counters/batched_dispatches"])
    bs = float(d["batched/counters/batched_segments"])
    assert bd >= 1 and bs == 2 * bd
    sizes = []
    for t in ("s0", "s1", "s2"):
        pre = f"batched/journals/{t}/"
        for b, w in zip(_val(d, pre + "batch_size"),
                        _val(d, pre + "has_wait")):
            assert b in (0, 2) and w == (b > 0)
            sizes += [b] if b else []
    assert len(sizes) == bs
    assert all(b == 0 for b in _val(d, "grouping/journals/lone/batch_size"))
    assert float(d["grouping/counters/batched_dispatches"]) >= 1
    assert not any(k.endswith("/lone")
                   for k in _keys(d, "grouping/by_label/batched_segments"))
    r = _results(d, "lone_linger")["solo1"]
    assert r["status"] == "done" and r["drained"] > 0
    assert float(d["lone_linger/counters/batched_dispatches"]) == 0
    assert float(d["victim_batched/by_label/plan_demotions/v"]) == 1.0
    segs = _val(d, "victim_batched/journals/v/segment")
    sizes = _val(d, "victim_batched/journals/v/batch_size")
    assert all(b == 0 for s, b in zip(segs, sizes) if s >= 1)
    assert any(k.endswith(("/h0", "/h1")) for k in _keys(
        d, "victim_batched/by_label/batched_segments"))


def test_event_driven_scheduler_no_busy_wait(tmp_path, work):
    """A slow sink parks the fleet: the idle scheduler waits on the sink
    threads' notify in 50 ms slices, not a 2 ms poll (the reference's
    bound)."""
    class SlowCap(DecisionCap):
        def push(self, work_, positive):
            time.sleep(0.25)
            super().push(work_, positive)
    metrics.reset()
    cap = SlowCap()
    t0 = time.perf_counter()
    fleet = StreamFleet([StreamSpec(name="slow", cfg=Config(**mkfields(
        tmp_path, "slow", str(work / "inputs" / "bb_s0.bin"))),
        sinks=[cap])], device="cpu")
    res = fleet.run()
    fleet.close()
    elapsed = time.perf_counter() - t0
    assert res["slow"].status == "done" and cap.out
    waits = int(metrics.get("fleet_idle_waits"))
    assert waits <= max(40, int(elapsed / 0.05 * 4)), (waits, elapsed)
    metrics.reset()


def test_sink_wedge_sheds_the_victim_only(tmp_path, work):
    """A real-time victim whose sink wedges sheds its segments as its own
    accounted loss within the deadline; the healthy stream is untouched
    and equals its solo run (the reference's bulkhead test)."""
    from srtb_tpu_torch.pipeline.runtime import Pipeline
    bb = str(work / "inputs" / "bb_h.bin")
    metrics.reset()
    solo = DecisionCap()
    with Pipeline(Config(**mkfields(tmp_path, "hsolo", bb)), sinks=[solo],
                  device="cpu") as pipe:
        solo_stats = pipe.run()

    class WedgeSink:
        def __init__(self):
            self.n = 0

        def push(self, work_, positive):
            self.n += 1
            if self.n == 2:
                time.sleep(60)

    raw = np.fromfile(bb, dtype=np.uint8)
    segs = [SegmentWork(data=raw[i * N:(i + 1) * N].copy(), timestamp=i,
                        seq=i) for i in range(SEGMENTS)]
    metrics.reset()
    hcap = DecisionCap()
    fleet = StreamFleet([
        StreamSpec(name="victim", cfg=Config(**mkfields(
            tmp_path, "victim", "", segment_deadline_s=0.2,
            baseband_reserve_sample=False, shutdown_join_timeout_s=0.5)),
            source=iter(segs), sinks=[WedgeSink()]),
        StreamSpec(name="h", cfg=Config(**mkfields(tmp_path, "h", bb)),
                   sinks=[hcap])], device="cpu")
    t0 = time.time()
    res = fleet.run()
    assert time.time() - t0 < 30
    assert res["h"].status == "done" and res["h"].dropped == 0
    assert res["h"].drained == solo_stats.segments
    for a, b in zip(hcap.out, solo.out):
        for x, y in zip(a[:3], b[:3]):
            assert np.array_equal(x, y)
    v = res["victim"]
    assert v.dropped >= 1 and v.drained + v.dropped == SEGMENTS
    assert metrics.get("segments_dropped",
                       labels={"stream": "victim"}) == v.dropped
    assert metrics.get("segments_dropped", labels={"stream": "h"}) == 0
    metrics.reset()


# ------------------------------------------------------- fleet_soak


def test_fleet_soak_reports_equal_the_references(ref, port):
    """``fleet_soak``: the gate passes in both packages with the same
    drained and dropped counts, victims, one compile and N - 1 hits; the
    batched soak (B = 4) amortizes at least 2x with ``batch_size`` on its
    records; the migration soak kills member 1 (one drain, stream1
    migrated, one extra cold dispatch, one compile a member) as the
    reference's; the rolling soak drains both members; the selftest is
    sharp in both."""
    for name in ("soak", "soak_batch", "soak_scoped", "migrate",
                 "migrate_rolling"):
        assert bool(port[f"{name}/ok"]) and bool(ref[f"{name}/ok"]), name
    for name in ("soak", "soak_scoped", "migrate"):
        for k in _keys(ref, f"{name}/drained/") | _keys(
                ref, f"{name}/dropped/"):
            assert int(port[k]) == int(ref[k]), k
    for k in ("plan_compiles", "plan_cache_hits", "victims",
              "journaled_segments", "device_dispatches_est"):
        assert _val(port, f"soak/{k}") == _val(ref, f"soak/{k}"), k
    for k in ("migrations", "device_drains", "ring_cold_dispatches",
              "pool_compiles"):
        assert _val(port, f"migrate/{k}") == _val(ref, f"migrate/{k}"), k
    for k in _keys(ref, "migrate/per_lane_migrations/"):
        assert int(port[k]) == int(ref[k]), k
    for d in (ref, port):
        assert int(d["soak_batch/batched_dispatches"]) >= 1
        assert 2 * int(d["soak_batch/device_dispatches_est"]) <= int(
            d["soak_batch/journaled_segments"])
        assert int(d["migrate_rolling/device_drains"]) == 2
        assert int(d["migrate_rolling/ring_cold_dispatches"]) == \
            3 + int(d["migrate_rolling/migrations"])
        assert "selftest" not in d or d["selftest"].size == 0
    assert int(port["soak_batch/journaled_segments"]) == int(
        ref["soak_batch/journaled_segments"])


def test_trace_join_draws_a_track_per_device(tmp_path, work):
    """The fleet stamps ``device`` on its lanes' records: ``trace_join``
    of a virtual 2-member pool's journals and events puts the migrated
    stream on both devices' tracks, its lane arrows crossing them."""
    from srtb_tpu_torch.obs import trace_join as TJ
    from srtb_tpu_torch.tools.trace_export import validate
    from srtb_tpu_torch.utils import events
    events.configure(False)
    metrics.reset()
    ev = str(tmp_path / "events.jsonl")
    specs, jps = [], []
    for t in ("s0", "s1"):
        jps.append(str(tmp_path / f"j_{t}.jsonl"))
        specs.append(StreamSpec(name=t, cfg=Config(**mkfields(
            tmp_path, t, str(work / "inputs" / f"bb_{t}.bin"),
            fleet_devices=2, device_reinit_max=1, events_enable=True,
            fault_plan="s1:dispatch:device_halt@2",
            telemetry_journal_path=jps[-1])), sinks=[DecisionCap()]))
    fleet = StreamFleet(specs, device="cpu")
    res = fleet.run()
    fleet.close()
    assert all(r.status == "done" for r in res.values())
    events.hub.dump_jsonl(ev)
    doc = TJ.join([ev], jps)
    assert validate(doc) == []
    other = doc["otherData"]
    assert other["devices"] == ["dev0", "dev1"]
    s1 = other["stream_devices"]["s1"]
    assert set(s1) == {"dev0", "dev1"} and s1[-1] == "dev0"
    assert other["stream_devices"]["s0"] == ["dev0"]
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    assert {"device:dev0", "device:dev1"} <= names
    lane = [e for e in doc["traceEvents"]
            if e.get("cat") == "flow" and e["name"] == "lane:s1"]
    assert len({e["pid"] for e in lane}) == 2
    events.configure(False)
    metrics.reset()


# --------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("batch", (0, 3))
def test_fleet_legs_on_the_card(tmp_path, work, batch):
    """The fleet legs on the card: three streams solo and through the
    fleet (the batch former off and at B = 3), each lane's decisions and
    time series the solo run's, one compile, batched dispatches with the
    former armed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from srtb_tpu_torch.pipeline.runtime import Pipeline
    tags = ("s0", "s1", "s2")
    solo = {}
    for t in tags:
        metrics.reset()
        cap = DecisionCap()
        with Pipeline(Config(**mkfields(
                tmp_path, t + "solo", str(work / "inputs" / f"bb_{t}.bin"))),
                sinks=[cap]) as pipe:
            pipe.run()
        solo[t] = cap.out
    metrics.reset()
    caps = {t: DecisionCap() for t in tags}
    fleet = StreamFleet([StreamSpec(name=t, cfg=Config(**mkfields(
        tmp_path, t, str(work / "inputs" / f"bb_{t}.bin"),
        fleet_batch_max=batch)), sinks=[caps[t]]) for t in tags])
    res = fleet.run()
    fleet.close()
    assert fleet.plans.compiles == 1 and fleet.plans.hits == 2
    for t in tags:
        assert res[t].status == "done" and res[t].dropped == 0
        assert len(caps[t].out) == len(solo[t])
        for a, b in zip(caps[t].out, solo[t]):
            for x, y in zip(a[:3], b[:3]):
                assert np.array_equal(x, y)
            assert a[3] == b[3]
    assert (metrics.get("batched_dispatches") > 0) == (batch > 0)
    metrics.reset()


@pytest.mark.cuda
def test_fleet_soak_on_the_card(tmp_path):
    """``fleet_soak`` on the card at a small size: the gate passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rep = FS.run_soak(streams=3, segments=3, log2n=16,
                      plan="stream0:dispatch:oom@1", tmpdir=str(tmp_path))
    assert rep["ok"] and rep["plan_compiles"] == 1
    assert rep["device"].startswith("cuda")
