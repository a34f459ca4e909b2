"""The port's pulse-injection canary (``srtb_tpu_torch/quality/canary.py``
and its wiring in ``pipeline/runtime.py``) against the JAX package's
(ROADMAP A9b; the reference runs in its own interpreter,
``tests/test_torch_ref.py``):

- ``_build_delta`` at 2^14 and 2^16 samples, with and without reserved
  samples, at DM 0 and at the example cfg's DM: equal int16, and at 2^20
  samples the example cfg's DM disperses the default burst below half a
  count everywhere, in both packages (an all-zero delta);
- ``prepare``'s bytes, marks and size gate, ``from_config``'s gating over
  bits and formats, and ``check`` over a sequence of S/N peaks,
  auto-calibrated and pinned: verdicts, gauges (flat and
  ``stream``-labeled), the SLO's sensitivity state and ``health()``'s
  detection section;
- a 4-segment 2^14 8-bit ``Pipeline`` run with the canary every second
  segment (the ingest ring on): the span verdicts (S/N at the pipeline
  tests' peak tolerance), the manifest's canary records, ``signals``,
  the quarantined candidate writer, the bytes each chain read (the
  reference's ``prepare`` output, exactly), and the write-all bytes of
  runs with the canary on and off (equal, and equal to the
  reference's); the same across a checkpoint resume in the middle, and
  with an out-of-memory injected at the canary segment's dispatch
  (injected and scored once); and the degraded leg: most of the band
  zapped, the expectation pinned: a failed verdict, a degraded
  detection state and one ``canary_sensitivity`` bundle a failure."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import manifest as MF
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.quality import canary as C
from srtb_tpu_torch.tools import fsck
from test_torch_ref import (HEALTH_COUNTERS, canary_check_script,
                            canary_delta, canary_gating,
                            canary_prepare_script, detection_health_script,
                            health_run, run_reference)

N = 1 << 14
SEGMENTS = 4
# the delta's cases: (samples, reserved, band and DM); "shipped" is the
# example cfg's band and DM (ROADMAP C5: at 2^20 its delta is all zero)
BANDS = {"dm0": dict(baseband_freq_low=1405.0, baseband_bandwidth=64.0,
                     dm=0.0),
         "shipped": dict(baseband_freq_low=1437.0,
                         baseband_bandwidth=-64.0, dm=-478.8)}
DELTAS = [(n, r, band) for n in (1 << 14, 1 << 16) for r in (0, 1500)
          for band in BANDS] + [(1 << 20, 0, "shipped")]
# (bits, format) of the gating cases
GATING = [(8, "simple"), (8, ""), (2, "simple"), (4, "simple"),
          (-8, "simple"), (8, "interleaved_samples_2"),
          (8, "gznupsr_a1")]
# S/N peak arrays (boxcars) fed to check in turn
PEAKS = [[3.0, 9.5, 7.25], [8.0, 4.0, 1.0], [2.0, 3.5, 4.5],
         [9.75, 9.0, 8.5], [1.0, 1.5, 0.5]]
PEAK_TOL = dict(rtol=2e-4, atol=2e-3)
# the degraded leg's pinned expectation (about the clean run's S/N)
PINNED_SNR = 9.0


def base_fields(tmp, tag: str, **overrides) -> dict:
    """The runs' config: 2^14 8-bit samples, 64 channels, the ci stage's
    RFI thresholds, DM 0.05 (a reserved tail of 2304 samples, so the
    ingest ring runs), the canary every second segment with the quality
    epilogue, the journal, manifest and events dump under
    ``tmp/tag``."""
    d = os.path.join(str(tmp), tag)
    os.makedirs(d, exist_ok=True)
    fields = dataclasses.asdict(Config(
        baseband_input_count=N, baseband_input_bits=8,
        baseband_format_type="simple", baseband_freq_low=1405.0,
        baseband_bandwidth=64.0, baseband_sample_rate=128e6, dm=0.05,
        spectrum_channel_count=64, baseband_reserve_sample=True,
        mitigate_rfi_average_method_threshold=100.0,
        mitigate_rfi_spectral_kurtosis_threshold=2.0,
        input_file_path=os.path.join(str(tmp), "noise.bin"),
        baseband_output_file_prefix=os.path.join(d, "out_"),
        writer_thread_count=0, deterministic_timestamps=True,
        retry_backoff_base_s=0.001, quality_stats=True,
        canary_every_segments=2,
        telemetry_journal_path=os.path.join(d, "spans.jsonl"),
        run_manifest_path=os.path.join(d, "manifest.jsonl"),
        checkpoint_path=os.path.join(d, "ck.json"),
        events_dump_path=os.path.join(d, "events.jsonl")))
    fields.update(overrides)
    return fields


def stride() -> int:
    """Bytes between consecutive segments' starts (8-bit: samples)."""
    cfg = Config(baseband_input_count=N, baseband_freq_low=1405.0,
                 baseband_bandwidth=64.0, baseband_sample_rate=128e6,
                 dm=0.05, spectrum_channel_count=64,
                 baseband_reserve_sample=True)
    return N - dd.nsamps_reserved(cfg)


# the runs: (overrides, max_segments of a first life or None); "resume"
# runs twice, the second life from the first's checkpoint
RUNS = {
    "clean": (dict(), None),
    "wa_on": (dict(baseband_write_all=True), None),
    "wa_off": (dict(baseband_write_all=True, canary_every_segments=0),
               None),
    "resume": (dict(), 2),
    "fault": (dict(fault_plan="dispatch:oom@1"), None),
    "degraded": (dict(mitigate_rfi_freq_list="1405-1466",
                      canary_expected_snr=PINNED_SNR,
                      incident_min_interval_s=0.0), None),
}


def run_fields(tmp, name: str, pkg: str) -> dict:
    overrides, _first = RUNS[name]
    tag = f"{pkg}_{name}"
    fields = base_fields(tmp, tag, **overrides)
    if name == "degraded":
        fields["incident_dir"] = os.path.join(str(tmp), tag, "incidents")
    return fields


def write_noise(tmp) -> None:
    """``tmp/noise.bin``: normal(128, 8) bytes, clipped, one byte short of
    four segments (the reader emits exactly four)."""
    rng = np.random.default_rng(7)
    size = N + (SEGMENTS - 1) * stride() - 1
    rng.normal(128, 8, size).clip(0, 255).astype(np.uint8).tofile(
        os.path.join(str(tmp), "noise.bin"))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("canary")
    write_noise(tmp)
    return tmp


def _delta_fields(band: str) -> dict:
    return dict(BANDS[band], baseband_input_bits=8, canary_every_segments=2)


def _prepare_steps():
    rng = np.random.default_rng(3)
    data = [rng.integers(0, 256, 1 << 12, dtype=np.uint8)
            for _ in range(4)]
    # a partial segment: the size gate
    data.append(rng.integers(0, 256, (1 << 12) - 8, dtype=np.uint8))
    # bytes at the rails: the clip
    data.append(np.where(rng.random(1 << 12) < 0.5, 0, 255).astype(
        np.uint8))
    return [(0, data[0]), (1, data[1]), (2, data[2]), (3, data[3]),
            (5, data[4]), (7, data[5])]


def _check_fields(pinned: float, stream: str) -> dict:
    return dict(baseband_input_bits=8, canary_every_segments=2,
                canary_expected_snr=pinned, canary_min_ratio=0.6,
                stream_name=stream)


SLO = dict(slo_sensitivity_budget=0.25)
# health()'s steps: before any segment, a segment, checks ok and failed
DETECTION = [("check", True), ("mark",), ("check", True),
             ("check", False), ("mark",), ("check", True)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory, work):
    tmp = tmp_path_factory.mktemp("ref_canary")
    jobs = [{"key": f"delta/{n}_{r}_{b}", "fn": "test_torch_ref:canary_delta",
             "args": ["srtb_tpu", _delta_fields(b), n, r]}
            for n, r, b in DELTAS]
    jobs.append({"key": "prepare", "fn":
                 "test_torch_ref:canary_prepare_script",
                 "args": ["srtb_tpu", _delta_fields("dm0"), 1 << 12, 100,
                          _prepare_steps()]})
    jobs.append({"key": "gating", "fn": "test_torch_ref:canary_gating",
                 "args": ["srtb_tpu", [dict(canary_every_segments=3,
                                            baseband_input_bits=b,
                                            baseband_format_type=f)
                                       for b, f in GATING]]})
    for pinned in (0.0, 9.0):
        for stream in ("", "beam1"):
            jobs.append({"key": f"check/{pinned}_{stream or 'solo'}",
                         "fn": "test_torch_ref:canary_check_script",
                         "args": ["srtb_tpu", _check_fields(pinned, stream),
                                  PEAKS, SLO]})
    for name, (_o, first) in RUNS.items():
        fields = run_fields(work, name, "ref")
        jobs.append({"key": f"run/{name}", "fn": "test_torch_ref:health_run",
                     "args": ["srtb_tpu", fields, first]})
        if first is not None:
            jobs.append({"key": f"run/{name}_b",
                         "fn": "test_torch_ref:health_run",
                         "args": ["srtb_tpu", fields]})
    jobs.append({"key": "detection",
                 "fn": "test_torch_ref:detection_health_script",
                 "args": ["srtb_tpu", DETECTION]})
    jobs.append({"key": "prepare_file",
                 "fn": "test_torch_ref:ref_canary_prepare_of_file",
                 "args": [base_fields(work, "probe"),
                          os.path.join(str(work), "noise.bin"), stride(),
                          SEGMENTS]})
    return run_reference(jobs, tmp, compile_cache=True)


@pytest.fixture(scope="module")
def port(work):
    out, chains = {}, {}
    for name, (_o, first) in RUNS.items():
        fields = run_fields(work, name, "port")
        chains[name] = []
        out[name] = health_run("srtb_tpu_torch", fields, first,
                               chain_log=chains[name])
        if first is not None:
            chains[f"{name}_b"] = []
            out[f"{name}_b"] = health_run("srtb_tpu_torch", fields,
                                          chain_log=chains[f"{name}_b"])
    return out, chains


def _ref_run(ref, name: str) -> dict:
    pre = f"run/{name}/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _spans(arr) -> list:
    return [json.loads(s) for s in arr if s]


def _held_spans(got, want) -> None:
    """Span fields equal, the canary's S/N numbers at the peak
    tolerance."""
    got, want = _spans(got), _spans(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gc, wc = g.pop("canary"), w.pop("canary")
        assert g == w
        assert (gc is None) == (wc is None)
        if gc is None:
            continue
        for k in ("snr", "expected", "ratio"):
            assert (k in gc) == (k in wc)
            if k in gc:
                np.testing.assert_allclose(gc.pop(k), wc.pop(k), **PEAK_TOL)
        assert gc == wc


# ------------------------------------------------------------ the delta

@pytest.mark.parametrize("n,reserved,band", DELTAS)
def test_delta_equals_reference(ref, n, reserved, band):
    """The port's delta, built in float64 with torch.fft and the
    complex64 chirp in blocks, equals the reference's numpy build."""
    got = canary_delta("srtb_tpu_torch", _delta_fields(band), n, reserved)
    key = f"delta/{n}_{reserved}_{band}"
    np.testing.assert_array_equal(got["delta"], ref[f"{key}/delta"])
    assert got["t0"] == int(ref[f"{key}/t0"])
    if reserved:
        assert not got["delta"][:reserved].any()
        assert not got["delta"][-reserved:].any()
    if n == 1 << 20:
        # the example cfg's DM disperses the default 25-count burst over
        # millions of samples: every sample rounds to 0 (ROADMAP C5)
        assert not got["delta"].any()
    else:
        assert got["delta"].any()


def test_prepare_equals_reference(ref):
    """``prepare``: non-canary segments pass through as the same object,
    a canary segment gets a clipped copy, a partial one is skipped."""
    got = canary_prepare_script("srtb_tpu_torch", _delta_fields("dm0"),
                                1 << 12, 100, _prepare_steps())
    for k in ("bytes", "same", "marks", "injected"):
        np.testing.assert_array_equal(got[k], ref[f"prepare/{k}"])
    assert list(got["same"]) == [True, False, True, False, True, False]
    assert list(got["injected"]) == [0, 1, 1, 2, 2, 3]


def test_from_config_gating(ref):
    got = canary_gating("srtb_tpu_torch", [dict(
        canary_every_segments=3, baseband_input_bits=b,
        baseband_format_type=f) for b, f in GATING])
    np.testing.assert_array_equal(got["armed"], ref["gating/armed"])
    assert list(got["armed"]) == [True, True] + [False] * 5
    assert C.CanaryController.from_config(Config(
        baseband_input_bits=8, canary_every_segments=0)) is None


@pytest.mark.parametrize("pinned", [0.0, 9.0])
@pytest.mark.parametrize("stream", ["", "beam1"])
def test_check_equals_reference(ref, pinned, stream):
    """``check`` auto-calibrated (the first check sets the expectation)
    and pinned: the verdicts, the gauges after each check, the SLO's
    state and the detection section."""
    got = canary_check_script("srtb_tpu_torch",
                              _check_fields(pinned, stream), PEAKS, SLO)
    key = f"check/{pinned}_{stream or 'solo'}"
    for k in ("verdicts", "slo", "detection", "ok"):
        np.testing.assert_array_equal(got[k], ref[f"{key}/{k}"])
    np.testing.assert_array_equal(got["gauges"], ref[f"{key}/gauges"])
    verdicts = [json.loads(v) for v in got["verdicts"]]
    assert verdicts[0].get("calibrated", False) == (pinned == 0.0)
    assert any(not v["ok"] for v in verdicts)
    # the last check failed: degraded detection, liveness untouched
    assert json.loads(got["detection"])["state"] == "degraded"
    assert bool(got["ok"])


def test_health_detection_section(ref):
    """``health()``'s ``detection`` section: absent before a checked
    canary, then its state, counts and S/N, never folded into liveness
    ``ok`` (a failed check leaves the status ``ok``)."""
    got = detection_health_script("srtb_tpu_torch", DETECTION)
    np.testing.assert_array_equal(got["reports"], ref["detection/reports"])
    reports = [json.loads(r) for r in got["reports"]]
    assert "detection" not in reports[0]  # idle: before any segment
    assert [r["detection"]["state"] for r in reports[1:]] == [
        "ok", "ok", "degraded", "degraded", "ok"]
    assert all(r["ok"] for r in reports)


# ------------------------------------------------------- pipeline runs

@pytest.mark.parametrize("name", sorted(RUNS) + ["resume_b"])
def test_run_equals_reference(ref, port, name):
    """Each run through both packages: the error, counts, span verdicts,
    manifest canary records, files, health counters and detection
    section."""
    got, want = port[0][name], _ref_run(ref, name)
    assert got["error"] == str(want["error"]) == ""
    assert got["segments"] == int(want["segments"])
    assert got["signals"] == int(want["signals"]) == 0
    _held_spans(got["spans"], want["spans"])
    np.testing.assert_array_equal(got["manifest"], want["manifest"])
    np.testing.assert_array_equal(got["files"], want["files"])
    assert got["write_all"] == str(want["write_all"])
    np.testing.assert_allclose(got["counters"], want["counters"],
                               **PEAK_TOL)
    gd, wd = json.loads(got["detection"]), json.loads(str(want["detection"]))
    assert (gd is None) == (wd is None)
    if gd is not None:
        assert gd["state"] == wd["state"]
        assert gd["canary_failed"] == wd["canary_failed"]


def _counter(run: dict, name: str) -> float:
    return float(run["counters"][HEALTH_COUNTERS.index(name)])


def test_clean_run_quarantines_its_canaries(port):
    """Segments 1 and 3 are injected, scored and forced negative: the
    pulse fires the detection (the span's detections), yet no candidate
    file is written and ``signals`` stays 0; the first verdict is the
    calibration, the manifest holds both."""
    run = port[0]["clean"]
    spans = _spans(run["spans"])
    assert [s["canary"] is not None for s in spans] == [False, True,
                                                        False, True]
    assert spans[1]["canary"]["calibrated"] and spans[3]["canary"]["ok"]
    assert all(not s["dump"] for s in spans)
    assert spans[1]["detections"] > 0
    assert _counter(run, "canary_injected") == 2
    assert _counter(run, "canary_checked") == 2
    assert _counter(run, "canary_failed") == 0
    assert [json.loads(r)["abs"] for r in run["manifest"]] == [1, 3]
    assert all(not f.endswith((".npy", ".bin", ".tim"))
               for f in run["files"] if f)


def test_chain_reads_the_reference_prepare_bytes(ref, port, work):
    """The bytes each chain read (with the ring: the carry and the
    stride, injected on the device) are the reference's ``prepare``
    output of that segment, bit for bit, in the clean, the resumed and
    the faulted runs."""
    want = ref["prepare_file/bytes"]
    chains = port[1]
    assert len(chains["clean"]) == SEGMENTS
    for i, got in enumerate(chains["clean"]):
        np.testing.assert_array_equal(got, want[i])
    resumed = chains["resume"] + chains["resume_b"]
    assert len(resumed) == SEGMENTS
    for i, got in enumerate(resumed):
        np.testing.assert_array_equal(got, want[i])
    # the faulted run: segment 1's dispatch ran out of memory before its
    # chain, the healed re-dispatch read the same injected bytes
    assert len(chains["fault"]) == SEGMENTS
    for i, got in enumerate(chains["fault"]):
        np.testing.assert_array_equal(got, want[i])
    # the pristine bytes: the non-canary segments' chains read them
    raw = np.fromfile(os.path.join(str(work), "noise.bin"), dtype=np.uint8)
    for i in range(SEGMENTS):
        seg = raw[i * stride():i * stride() + N]
        seg = np.concatenate([seg, np.zeros(N - len(seg), np.uint8)])
        assert np.array_equal(seg, chains["clean"][i]) == (i % 2 == 0)


def test_write_all_bytes_do_not_see_the_canary(ref, port):
    """The write-all sink is canary-exempt and appends the pristine
    bytes: its file with the canary on equals the file with it off, and
    the reference's."""
    on, off = port[0]["wa_on"], port[0]["wa_off"]
    assert on["write_all"] and on["write_all"] == off["write_all"]
    assert on["write_all"] == str(_ref_run(ref, "wa_off")["write_all"])
    assert _counter(on, "canary_injected") == 2
    assert _counter(off, "canary_injected") == 0


def test_resume_continues_the_schedule(port):
    """A run stopped after two segments and resumed from its checkpoint
    injects segment 1 in its first life and segment 3 in its second."""
    a, b = port[0]["resume"], port[0]["resume_b"]
    assert [json.loads(r)["abs"] for r in a["manifest"] if r] == [1]
    assert [json.loads(r)["abs"] for r in b["manifest"] if r] == [1, 3]
    assert [s["segment"] for s in _spans(b["spans"])] == [0, 1, 2, 3]
    assert _counter(b, "canary_injected") == 1
    assert _counter(b, "canary_checked") == 1


def test_fault_on_the_canary_segment_scores_once(port):
    """An out-of-memory at the canary segment's dispatch demotes the plan
    and re-dispatches it: injected once, scored once."""
    run = port[0]["fault"]
    assert _counter(run, "plan_demotions") == 1
    assert _counter(run, "canary_injected") == 2
    assert _counter(run, "canary_checked") == 2
    assert sum(s["canary"] is not None for s in _spans(run["spans"])) == 2


def test_degraded_run_fails_and_bundles(ref, port):
    """With 61 of 64 channels zapped and the expectation pinned, every
    check fails: ``detection_health_state`` 1, the detection section
    degraded, one ``canary_sensitivity`` bundle a failure with the
    reference's file list, kind and reason, whose ``extra.json`` holds
    the mark and the failed verdict and a non-empty quality timeline."""
    run, want = port[0]["degraded"], _ref_run(ref, "degraded")
    assert _counter(run, "canary_failed") == 2
    assert _counter(run, "detection_health_state") == 1
    assert json.loads(run["detection"])["state"] == "degraded"
    got_b, want_b = json.loads(run["bundles"]), json.loads(
        str(want["bundles"]))
    assert sorted(got_b) == sorted(want_b) == [
        "incident_000_canary_sensitivity",
        "incident_001_canary_sensitivity"]
    for name, g in got_b.items():
        w = want_b[name]
        assert g["files"] == w["files"] == [
            "config.json", "events.jsonl", "extra.json", "incident.json",
            "metrics.json", "plan.json", "spans_tail.jsonl", "trace.jsonl"]
        gi, wi = g["incident.json"], w["incident.json"]
        assert gi.pop("reason").split(":")[0] == \
            wi.pop("reason").split(":")[0]
        assert gi == wi
        assert gi["kind"] == "canary_sensitivity" and gi["trace_id"]
        ge, we = g["extra.json"], w["extra.json"]
        assert ge["canary"]["ok"] is False and ge["quality_timeline"]
        assert len(ge["quality_timeline"]) == len(we["quality_timeline"])
        gc, wc = dict(ge["canary"]), dict(we["canary"])
        for k in ("snr", "expected", "ratio"):
            np.testing.assert_allclose(gc.pop(k), wc.pop(k), **PEAK_TOL)
        assert gc == wc


def test_manifest_canary_records_are_skipped_by_recovery(port, work):
    """The scanner and ``fsck`` skip the ``canary`` records: the clean
    run's directory scans with no group for them and checks clean."""
    d = os.path.join(str(work), "port_clean")
    scan = MF.scan_manifest(os.path.join(d, "manifest.jsonl"))
    assert scan.bad_line is None and scan.records > 2
    assert all(k[2] != "canary" for k in scan.groups)
    rep = fsck.fsck(os.path.join(d, "manifest.jsonl"),
                    os.path.join(d, "ck.json"))
    assert rep["clean"], rep
