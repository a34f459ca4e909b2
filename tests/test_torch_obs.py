"""The port's rollup store and its readers (``srtb_tpu_torch/obs/``:
``digest``, ``store``, ``rollup``, ``trace_join``, ``regression``) against
the JAX package's (ROADMAP A9e; the reference runs in its own
interpreter, ``tests/test_torch_ref.py``).  The scenarios are the
reference's own (``tests/test_obs.py``), scripted once in the runner and
run by both packages on the same seeded inputs:

- ``QuantileDigest``: quantiles of seeded lognormal values, a three-way
  merge against the whole, the JSON round trip, the guards;
- ``RollupStore``: last-wins, byte-identical compaction, retention;
- ``Aggregator``: rollup rows and digests, resume by offset over a torn
  tail, a torn then whole rotated ``.gz``, the active arm's rotation, an
  event dump read twice;
- ``trace_join``: the document, its validation and the CLI;
- ``RegressionWatch``: trips once and latches; too few samples;
- ``fleet_status`` and the console (ROADMAP A8c): the status and its
  rendered frame on one metric state and rollup store, the viewer's
  ``/fleet`` and ``console --url`` against it.

Each comparison is exact: the port's copy computes what the reference
computes.  The properties the reference's tests assert hold on the
port's results too."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from test_torch_ref import (console_url_script, obs_aggregator_script,
                            obs_digest_script, obs_regression_script,
                            obs_store_script, obs_trace_join_script,
                            run_reference, status_console_script)

PORT = "srtb_tpu_torch"


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs")
    out = {}
    for side in ("ref", "port"):
        for name in ("store", "aggregator", "trace_join", "regression",
                     "status", "console"):
            d = root / side / name
            d.mkdir(parents=True)
            out[side, name] = str(d)
    (root / "runner").mkdir()
    out["runner"] = root / "runner"
    return out


@pytest.fixture(scope="module")
def ref(dirs):
    jobs = [{"key": "digest", "fn": "test_torch_ref:obs_digest_script"}]
    jobs += [{"key": name, "fn": f"test_torch_ref:obs_{name}_script",
              "args": [dirs["ref", name]]}
             for name in ("store", "aggregator", "trace_join", "regression")]
    jobs += [{"key": "status", "fn": "test_torch_ref:status_console_script",
              "args": ["srtb_tpu", dirs["ref", "status"] + "/store"]},
             {"key": "console", "fn": "test_torch_ref:console_url_script",
              "args": ["srtb_tpu", dirs["ref", "console"]]}]
    return run_reference(jobs, dirs["runner"])


def _same(got: dict, ref: dict, key: str) -> None:
    for name, value in got.items():
        want = ref[f"{key}/{name}"]
        if isinstance(value, np.ndarray) and value.dtype.kind == "f":
            np.testing.assert_array_equal(value, want, err_msg=name)
        elif isinstance(value, np.ndarray):
            assert value.tolist() == want.tolist(), name
        else:
            assert np.asarray(value).tolist() == want.tolist(), name


def test_digest_equals_reference(ref):
    got = obs_digest_script(PORT)
    _same(got, ref, "digest")
    # the reference's properties: any quantile within alpha of the
    # exact order statistic (one of slack), q 0 and 1 exact
    rng = np.random.default_rng(42)
    s = np.sort(rng.lognormal(mean=0.0, sigma=1.0, size=20000))
    qs = (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0)
    for q, est in zip(qs, got["lognormal_q"]):
        rank = max(1, math.ceil(q * len(s)))
        near = s[max(0, rank - 2):rank + 1]
        assert min(abs(est - x) / x for x in near) <= 0.01 + 1e-9, q
    assert got["lognormal_q"][0] == s[0] and got["lognormal_q"][-1] == s[-1]
    assert got["merged"] == got["whole"]
    assert got["errors"].tolist() == ["ValueError"] * 4
    assert got["empty_is_nan"]


def test_store_equals_reference(ref, dirs):
    got = obs_store_script(dirs["port", "store"], PORT)
    _same(got, ref, "store")
    r1, r2, retention = json.loads(got["compact"])
    assert got["latest"] == got["after"] == 5
    assert r1["rows"] == r2["rows"] == 3 and retention["dropped"] == 2
    _b1, same2, same3 = json.loads(got["bytes"])
    assert same2 and same3
    assert got["unkeyed"] == "ValueError"
    assert json.loads(got["retained"]) == ["d:meta", "m:100", "m:90"]


def test_aggregator_equals_reference(ref, dirs):
    got = obs_aggregator_script(dirs["port", "aggregator"], PORT)
    _same(got, ref, "aggregator")
    # counters: 5 spans; resume 4, then 1 (the torn tail left), the
    # completed record, nothing twice; the torn .gz's prefix plus the
    # active span, then the rest, then nothing; rotation 3 then 2; the
    # event dump's one fleet event, once
    polls = got["polls"].tolist()
    assert polls[:5] == [5, 4, 1, 1, 0]
    assert 1 <= polls[5] < 21 and polls[5] + polls[6] == 21
    assert polls[7:] == [0, 3, 2, 1, 0]
    rows = json.loads(got["counters_rows"])
    row = rows["m:1:s0:dev0:p1"]
    assert row["segments"] == 5 and row["loss_delta"] == 1
    assert row["device_ms_sum"] == pytest.approx(10.0)
    assert row["batch_segments"] == 10
    assert rows["d:stage:dispatch"]["digest"]["count"] == 5
    plans, seconds, _median = json.loads(got["counters_plans"])
    assert plans == ["p1"] and seconds == pytest.approx([3.5e-3] * 5)
    events = [r for r in json.loads(got["events_rows"]).values()
              if r["type"] == "fleet_event"]
    assert len(events) == 1 and events[0]["info"] == "dev0->dev1"


def test_trace_join_equals_reference(ref, dirs):
    got = obs_trace_join_script(dirs["port", "trace_join"], PORT)
    _same(got, ref, "trace_join")
    doc = json.loads(got["doc"])
    assert json.loads(got["problems"]) == []
    assert doc["otherData"]["devices"] == ["dev0", "dev1"]
    assert doc["otherData"]["stream_devices"]["s0"] == ["dev0", "dev1"]
    lane = [e for e in doc["traceEvents"] if e.get("cat") == "flow"
            and e["id"] >= got["lane_base"]]
    assert lane and len({e["pid"] for e in lane}) == 2
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert names == {"device:dev0", "device:dev1"}
    rc, n_events, rc_empty = got["cli"].tolist()
    assert rc == 0 and n_events == len(doc["traceEvents"]) and rc_empty == 1


def test_regression_watch_equals_reference(ref, dirs):
    got = obs_regression_script(dirs["port", "regression"], PORT)
    _same(got, ref, "regression")
    slow, again, clean, thin, no_ledger = json.loads(got["verdicts"])
    assert slow["checked"] and slow["regression"] and slow["escalated"]
    assert again["regression"] and again["escalated"] is False
    assert clean["checked"] and not clean["regression"]
    assert got["bundles"].tolist() == [1, 1, 0]
    assert thin["checked"] is False and "3 live samples" in thin["reason"]
    assert no_ledger["checked"] is False and "ledger" in no_ledger["reason"]


def test_regression_selftest_on_the_cpu(capsys, monkeypatch):
    """``obs.regression --selftest --device cpu`` through the real path
    (mini pipeline, journal, aggregator, ledger, watch): the stall
    escalates one bundle and latches, the clean side none; without a
    card and ``--device`` it refuses."""
    from srtb_tpu_torch.obs import regression as RW
    from srtb_tpu_torch.tools import perf_gate as PG
    # four legs a side, for time
    monkeypatch.setattr(PG, "SIDE_CAPTURES", 4)
    rc = RW.main(["--selftest", "--device", "cpu", "--segments", "3",
                  "--warmup", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["selftest"] == "ok", line
    assert line["bundles_stalled_leg"] == 1 and line["bundles_clean_leg"] == 0
    assert [len(line["sides"][k]["samples_ms"])
            for k in ("base", "clean", "stalled")] == [4, 4, 4]
    import torch
    if not torch.cuda.is_available():
        assert RW.main(["--selftest"]) == 2
        assert "no CUDA device" in capsys.readouterr().out


def test_rollup_main_resumes(tmp_path, capsys):
    """``rollup.main``: one pass into a store, a second pass ingesting
    nothing (the cursor), ``--compact``."""
    from srtb_tpu_torch.obs import rollup as RU
    jp = tmp_path / "j.jsonl"
    jp.write_text("".join(json.dumps(
        {"type": "segment_span", "ts": 60.0 + i, "segment": i,
         "stream": "s0", "active_plan": "p1",
         "stages_ms": {"dispatch": 2.0}}) + "\n" for i in range(3)))
    store = str(tmp_path / "store")
    assert RU.main([str(jp), "--store", store]) == 0
    first = json.loads(capsys.readouterr().out)
    assert RU.main([str(jp), "--store", store, "--compact"]) == 0
    second = json.loads(capsys.readouterr().out)
    assert first["spans"] == 3 and first["plans"] == ["p1"]
    assert second["spans"] == 0 and second["compact"]["rows"] == 3


# --------------------------------------- status, console, /fleet (A8c)


def test_fleet_status_and_console_render(ref, dirs):
    """``fleet_status`` (with the store, without, and over a missing
    store), ``console.render`` of it and of an empty status, ``_bar``, and
    the tail lengths on the reference's metric state and rollup store:
    the reference's, exactly; and the reference's own assertions."""
    got = status_console_script(PORT, dirs["port", "status"] + "/store")
    keys = {k[len("status/"):] for k in ref if k.startswith("status/")}
    assert keys == set(got)
    for k in sorted(keys):
        have = got[k]
        have = have.tolist() if hasattr(have, "tolist") else have
        assert have == ref[f"status/{k}"].tolist(), k
    status = json.loads(got["status"])
    assert status["devices"]["dev0"]["state"] == "ok"
    assert status["devices"]["dev1"]["state"] == "halted"
    assert status["devices"]["dev2"]["state"] == "code7"
    assert status["devices"]["dev0"]["lanes"] == 3
    assert status["pool"]["migrations"] == 2
    assert status["batch"]["occupancy"] == 2.5
    assert status["streams"]["s0"]["roofline_frac"] == 0.1235
    assert status["store"]["timeline"][0]["kind"] == "fleet.migrate"
    assert status["store"]["digests"]["stage:dispatch"]["n"] == 4
    assert "store" not in json.loads(got["bare"])
    text = got["frame"]
    assert "POOL" in text and "dev1" in text and "halted" in text
    assert "fleet.migrate" in text and "dev0->dev1" in text
    assert "occupancy=2.50" in text


def test_console_url_mode_against_server(ref, dirs):
    """The viewer's ``/fleet`` answers 200 with ``fleet_status()``'s
    payload (JSON, keys sorted), and ``console --url`` renders it and
    prints it with ``--json``: return codes, frames, the JSON line and the
    body the reference's; against a closed port the console exits 1."""
    got = console_url_script(PORT, dirs["port", "console"])
    for k in sorted(got):
        have = got[k]
        assert have == ref[f"console/{k}"].tolist(), k
    assert got["fleet_status"] == 200
    assert got["fleet_type"] == "application/json"
    doc = json.loads(got["json"])
    assert doc["devices"]["dev0"]["state"] == "ok"
    assert json.loads(got["fleet_body"]) == doc
    assert "POOL" in got["text"] and "dev0" in got["text"]
    assert (got["text_rc"], got["json_rc"], got["closed_rc"]) == (0, 0, 1)
