"""The port's live tools and float64 oracle (ROADMAP A9d), case for case
with the JAX package's ``tests/test_tools.py`` (the e2e harness's smoke
and overload runs) and its udp_soak and production-oracle tools:

- ``tools/e2e_live.py``: loopback sender -> ``UdpReceiverSource`` ->
  ``ThreadedPipeline`` -> candidates, ``/metrics`` over HTTP, one JSON
  line with both throughput denominators; under overload the excess is
  accounted loss, not a stall (bounded retries, each on fresh ports);
- ``tools/udp_soak.py``: its fields, and the retries and packet
  accounting under a fault plan on the receive loop;
- the JSON lines of both hold every field of the reference's (run in
  ``tests/test_torch_ref.py``'s runner);
- ``tools/oracle64.py`` equals ``tests/oracle_utils.py`` on the same bytes
  to rtol 1e-12, and ``tools/production_oracle.py`` at 2^16 reports
  ``ok``.

Rate gates (zero loss at twice the real-time rate) belong on the card's
host (``chip_smoke.py``'s ``a9d`` phase), not here."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.tools import e2e_live, production_oracle, udp_soak
from srtb_tpu_torch.tools import oracle64 as O
from test_torch_ref import run_reference

# the oracle's comparison: each format's bytes at its sample width
FORMATS = {"simple": 2, "interleaved_samples_2": 2, "naocpsr_snap1": -8,
           "gznupsr_a1_v1": -8, "gznupsr_a1": -8}
ORACLE_N = 1 << 12


def _oracle_inputs():
    rng = np.random.default_rng(2024)
    raws = {name: rng.integers(0, 256, size=1 << 10, dtype=np.uint8)
            for name in FORMATS}
    fields = dataclasses.asdict(Config(
        baseband_input_count=ORACLE_N, baseband_input_bits=2,
        baseband_freq_low=1437.0, baseband_bandwidth=-64.0,
        baseband_sample_rate=128e6, dm=-478.8, spectrum_channel_count=32,
        mitigate_rfi_average_method_threshold=3.0,
        mitigate_rfi_spectral_kurtosis_threshold=1.2,
        baseband_reserve_sample=False))
    samples = rng.standard_normal(ORACLE_N)
    samples[ORACLE_N // 3] += 40.0
    return raws, fields, samples


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    raws, fields, samples = _oracle_inputs()
    jobs = [{"key": "oracle", "fn": "test_torch_ref:oracle_outputs",
             "args": [raws, FORMATS,
                      {"samples": samples, "fields": fields}]},
            {"key": "tools", "fn": "test_torch_ref:tool_keys",
             "args": [1024]}]
    return run_reference(jobs, tmp_path_factory.mktemp("ref_live_tools"))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * max(np.abs(want).max(), 1.0))


def test_oracle64_equals_oracle_utils(ref):
    raws, fields, samples = _oracle_inputs()
    for name, raw in raws.items():
        bits = FORMATS[name]
        if name == "simple":
            _close(O.oracle_unpack(raw, bits), ref[f"oracle/unpack/{bits}"])
        streams = O.oracle_deinterleave(raw, name, bits)
        for s, x in enumerate(streams):
            _close(x, ref[f"oracle/deinterleave/{name}/{s}"])
        assert f"oracle/deinterleave/{name}/{len(streams)}" not in ref
    wf, ts, nzap = O.oracle_stream_chain(samples, Config(**fields))
    _close(wf, ref["oracle/chain/wf"])
    _close(ts, ref["oracle/chain/ts"])
    assert nzap == int(ref["oracle/chain/nzap"])


def test_production_oracle_ok_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "oracle.json"
    rc = production_oracle.main(["--log2n", "16", "--log2chan", "6",
                                 "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rc == 0 and rec["ok"]
    assert rec["staged"] and rec["plan"].startswith("staged")
    for key, gate in rec["gates"].items():
        err = rec[{"wf": "wf_max_rel_err", "ts_sum": "ts_sum_rel_err",
                   "ts_prop": "ts_prop_rel_err"}[key]]
        assert 0 <= err <= gate, key
    assert json.loads(capsys.readouterr().out.strip()) == rec


def test_udp_soak_fields_and_fault_accounting():
    """Two injected receive faults are retried (and counted), every
    packet slot of the soak is accounted received or lost, and the
    requirement is J1644-4559's 0.256 Gbps."""
    rec = udp_soak.run_soak(4096, "python", port=0,
                            fault_plan="ingest:raise@3,ingest:raise@7")
    assert rec["retries"] == 2
    assert rec["required_gbps"] == 0.256
    assert rec["margin"] == round(rec["gbps"] / udp_soak.REQUIRED_GBPS, 1)
    assert rec["payload_bytes"] == 4096
    # every slot of the blocks received is a packet received or lost
    blocks = 4096 // 64 - 1
    assert rec["received"] + rec["lost"] == blocks * 64
    assert rec["received"] > 0 and rec["lost"] >= 0
    assert rec["loss_rate"] == round(
        rec["lost"] / max(rec["received"] + rec["lost"], 1), 5)


def test_live_tools_print_the_references_fields(ref, tmp_path, capsys):
    """udp_soak's line has the reference's fields, e2e_live's every one
    of the reference's (and the port's card fields)."""
    soak = udp_soak.run_soak(1024, "python", port=0)
    assert sorted(soak) == json.loads(str(ref["tools/soak_keys"]))
    assert soak["required_gbps"] == float(ref["tools/soak_required_gbps"])
    rc = e2e_live.main(["--seconds", "1", "--rate_x", "0.05", "--log2n",
                        "14", "--log2chan", "5", "--port", "0",
                        "--prefix", f"{tmp_path}/out_", "--max_segments",
                        "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 == int(ref["tools/e2e_rc"])
    assert set(json.loads(str(ref["tools/e2e_keys"]))) - {"platform"} \
        <= set(line)
    assert {"device", "plan", "launches", "positive_segments",
            "keep_waterfall"} <= set(line)


def test_e2e_live_harness_smoke(tmp_path):
    """The live UDP -> device -> candidates harness runs end to end on
    loopback: paced sender, segment assembly, the threaded pipeline, live
    /metrics over HTTP, one JSON line."""
    out = tmp_path / "e2e.jsonl"
    rc = e2e_live.main([
        "--seconds", "1.5", "--rate_x", "0.05", "--log2n", "18",
        "--log2chan", "7", "--port", "0", "--deadline_s", "60",
        "--gui", "--gui_min_interval_s", "0.2", "--device", "cpu",
        "--prefix", str(tmp_path) + "/out_", "--out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["segments"] >= 1
    assert rec["packets_total"] > 0
    assert rec["metrics_http"]["segments"] == rec["segments"]
    # the server lists the tap's rendered frames
    assert rec["gui_frames"] >= 1
    assert rec["gui_frames_served"] >= 1
    # both throughput denominators, labeled
    assert rec["msamples_per_s_window"] > 0
    assert rec["lifetime_seconds"] >= rec["seconds"]
    # the deadline armed (60 s >> a segment): the line is the evidence
    assert rec["deadline_s"] == 60
    assert rec["platform"] == "cpu"


@pytest.mark.parametrize("keep", [False, True])
def test_e2e_live_keep_waterfall_reaches_the_pipeline(tmp_path, capsys,
                                                      monkeypatch, keep):
    """``--keep_waterfall`` hands the waterfall to every sink (the
    candidate writer dumps each positive's, as ``srtb-torch-main``);
    without it the pipeline keeps the reference's ``keep_waterfall=
    False``.  The line says which."""
    from srtb_tpu_torch.pipeline import runtime as R
    made = []

    class Recording(R.ThreadedPipeline):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self.keep_waterfall)

    monkeypatch.setattr(R, "ThreadedPipeline", Recording)
    rc = e2e_live.main(["--seconds", "1", "--rate_x", "0.05", "--log2n",
                        "14", "--log2chan", "5", "--port", "0",
                        "--prefix", f"{tmp_path}/out_", "--max_segments",
                        "1", "--device", "cpu"]
                       + (["--keep_waterfall"] if keep else []))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and made == [keep]
    assert line["keep_waterfall"] is keep and line["segments"] == 1


def test_e2e_live_overload_degrades_gracefully(tmp_path):
    """Offered load far above the CPU's compute rate: the pipeline keeps
    draining segments, excess packets fall off the socket buffer as
    accounted counter-gap loss, and the run ends cleanly.  An attempt in
    which the scheduler starved the sender and no overload built up is
    retried on fresh ports (bounded)."""
    for attempt in range(3):
        out = tmp_path / f"e2e_overload_{attempt}.jsonl"
        rc = e2e_live.main([
            "--seconds", "120", "--rate_x", "2.0", "--log2n", "18",
            "--log2chan", "7", "--port", "0", "--deadline_s", "120",
            "--max_segments", "6", "--rcvbuf_bytes", str(1 << 15),
            "--device", "cpu", "--prefix", str(tmp_path)
            + f"/out{attempt}_", "--out", str(out)])
        assert rc == 0
        rec = json.loads(out.read_text().splitlines()[-1])
        assert rec["segments"] == 6
        assert rec["vs_realtime_window"] < rec["rate_x"]
        dropped = rec["metrics_http"].get("segments_dropped", 0)
        if rec["packets_lost"] > 0 or dropped > 0:
            break
    else:
        raise AssertionError(
            f"no accounted loss in {attempt + 1} overload runs: {rec}")
    if rec["packets_lost"]:
        assert 0 < rec["loss_rate"] < 1
        assert rec["packets_total"] > rec["packets_lost"]
