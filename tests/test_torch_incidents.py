"""The port's incident bundles (``srtb_tpu_torch/utils/incidents.py`` and
its wiring in ``pipeline/runtime.py``) against the JAX package's (ROADMAP
A9b; the reference runs in its own interpreter, ``tests/test_torch_ref.py``):

- the recorder alone on a fake clock: the rate limit keyed on the
  directory, the count bound (a suppressed attempt gives its rate slot
  back), the sweep of a half-assembled bundle, a failed dump (counted,
  never raised): the same results, counters, listings and events;
- one bundle per escalation kind, each by an injected fault through both
  packages' ``Pipeline`` on the canary tests' 8-bit input:
  ``ladder_exhausted`` (an out-of-memory at two sites, one rung),
  ``reinit_budget_exceeded`` (a halt with no reinit budget),
  ``watchdog_escalation`` (a chain that never completes),
  ``sink_wedge`` and ``sink_wedge_shutdown`` (a live source's sink that
  stops answering) and ``manifest_loss`` (a committed artifact gone below
  the checkpoint): the same error, kinds, file lists, ``incident.json``
  and ``plan.json``;
- a bundle dumped after a halt reads host state only, and a dump with
  ``incident_dir`` off writes nothing."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.pipeline.runtime import Pipeline
from srtb_tpu_torch.utils import incidents as I
from srtb_tpu_torch.utils.metrics import metrics
from test_torch_canary import base_fields, write_noise
from test_torch_ref import (health_run, incident_recorder_script,
                            manifest_loss_run, run_reference)

# the recorder script: max 2 bundles, 10 s apart
RECORDER_STEPS = [("dump", "first", "a"), ("tick", 1.0),
                  ("dump", "too_soon", "b"), ("tick", 10.0),
                  ("dump", "second", "c"), ("tick", 11.0),
                  ("dump", "over_count", "d"), ("clear",), ("tick", 3.0),
                  ("dump", "after_clear", "e"), ("tick", 20.0),
                  ("dump", "weird kind/..", "f"), ("tick", 20.0),
                  ("break",), ("dump", "broken", "g")]

LIVE = dict(segment_deadline_s=0.12, segment_watchdog_requeues=1,
            shutdown_join_timeout_s=0.25, inflight_segments=2)
# (overrides, the live source's stand-in, wedge, the kinds expected)
ESCALATIONS = {
    "ladder_exhausted": (dict(fault_plan="dispatch:oom@1,fetch:oom@2",
                              plan_ladder="staged", device_reinit_max=0,
                              inflight_segments=1), False, "",
                         ["ladder_exhausted"]),
    "reinit_budget_exceeded": (dict(fault_plan="dispatch:device_halt@1",
                                    device_reinit_max=0), False, "",
                               ["reinit_budget_exceeded"]),
    "watchdog_escalation": (dict(segment_deadline_s=0.05,
                                 segment_watchdog_requeues=1,
                                 inflight_segments=2), False, "chain",
                            ["watchdog_escalation"]),
    "sink_wedge": (LIVE, True, "sink",
                   ["sink_wedge", "sink_wedge_shutdown"]),
    "manifest_loss": (dict(checkpoint_path=""), False, "",
                      ["manifest_loss"]),
}
ERRORS = {"ladder_exhausted": "LadderExhausted",
          "reinit_budget_exceeded": "ReinitBudgetExceeded",
          "watchdog_escalation": "WatchdogEscalation",
          "sink_wedge": "", "manifest_loss": ""}


def escalation_fields(tmp, name: str, pkg: str) -> tuple:
    """``(fields, source_fields)`` of one escalation run: the canary
    tests' config with the canary off, the incident directory under the
    run's own, no rate limit; a live run reads no input file (its source
    is a file reader of ``source_fields``)."""
    overrides, live, _wedge, _kinds = ESCALATIONS[name]
    tag = f"{pkg}_{name}"
    fields = base_fields(tmp, tag, canary_every_segments=0,
                         incident_min_interval_s=0.0, **overrides)
    fields["incident_dir"] = os.path.join(str(tmp), tag, "incidents")
    source = None
    if live:
        source = dict(fields)
        fields["input_file_path"] = ""
    return fields, source


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("incidents")
    write_noise(tmp)
    return tmp


@pytest.fixture(scope="module")
def ref(tmp_path_factory, work):
    tmp = tmp_path_factory.mktemp("ref_incidents")
    jobs = [{"key": "recorder",
             "fn": "test_torch_ref:incident_recorder_script",
             "args": ["srtb_tpu", str(tmp / "recorder"), 2, 10.0,
                      RECORDER_STEPS]}]
    for name, (_o, _live, wedge, _k) in ESCALATIONS.items():
        fields, source = escalation_fields(work, name, "ref")
        if name == "manifest_loss":
            jobs.append({"key": name,
                         "fn": "test_torch_ref:manifest_loss_run",
                         "args": ["srtb_tpu", fields]})
            continue
        jobs.append({"key": name, "fn": "test_torch_ref:health_run",
                     "args": ["srtb_tpu", fields],
                     "kwargs": {"source_fields": source, "wedge": wedge}})
    return run_reference(jobs, tmp, compile_cache=True)


@pytest.fixture(scope="module")
def port(work):
    out = {}
    for name, (_o, _live, wedge, _k) in ESCALATIONS.items():
        fields, source = escalation_fields(work, name, "port")
        if name == "manifest_loss":
            out[name] = manifest_loss_run("srtb_tpu_torch", fields)
        else:
            out[name] = health_run("srtb_tpu_torch", fields,
                                   source_fields=source, wedge=wedge)
    return out


def test_recorder_equals_reference(ref, tmp_path):
    """Rate limit, count bound with the slot given back, the temp sweep,
    a sanitized kind and a failed dump, as the reference's."""
    got = incident_recorder_script("srtb_tpu_torch", str(tmp_path / "rec"),
                                   2, 10.0, RECORDER_STEPS)
    for k in ("results", "counters", "swept", "listing", "events"):
        np.testing.assert_array_equal(got[k], ref[f"recorder/{k}"])
    assert list(got["results"]) == [
        "incident_000_first", "", "incident_001_second", "",
        "incident_000_after_clear", "incident_001_weird_kind___", ""]
    assert list(got["swept"]) == [""]  # the leftover temp dir is gone
    assert list(got["counters"][-1]) == [4, 2, 1]


@pytest.mark.parametrize("name", sorted(ESCALATIONS))
def test_escalation_bundle_equals_reference(ref, port, name):
    """Each escalation leaves the reference's bundles: the same kinds and
    file lists, ``incident.json`` (less its wall time and pid; the
    reason's text before its first colon) and ``plan.json``'s keys."""
    got, want = port[name], ref
    assert got["error"] == str(want[f"{name}/error"]) == ERRORS[name]
    gb = json.loads(got["bundles"])
    wb = json.loads(str(want[f"{name}/bundles"]))
    kinds = ESCALATIONS[name][3]
    assert sorted({b["incident.json"]["kind"] for b in gb.values()}) == \
        sorted({b["incident.json"]["kind"] for b in wb.values()}) == \
        sorted(kinds)
    by_kind = {}
    for b in wb.values():
        by_kind.setdefault(b["incident.json"]["kind"], b)
    for b in gb.values():
        inc = dict(b["incident.json"])
        w = by_kind[inc["kind"]]
        assert b["files"] == w["files"]
        winc = dict(w["incident.json"])
        assert inc.pop("reason").split(":")[0] == \
            winc.pop("reason").split(":")[0]
        assert inc == winc
        # the port's processors have no plan_signature (ROADMAP: a
        # difference by design until the compiled-kernel cache, A9d)
        wplan = dict(w["plan.json"])
        assert "plan_signature" in wplan
        wplan.pop("plan_signature")
        assert b["plan.json"] == wplan
        for f in ("config.json", "events.jsonl", "metrics.json"):
            assert f in b["files"]
        # a journal exists by every escalation but the startup recovery's
        assert ("spans_tail.jsonl" in b["files"]) == (
            name != "manifest_loss")


def test_escalation_counters(port):
    """What each escalation counted: a bundle a kind (the wedged sink's
    sheds may bundle more than once), nothing suppressed or failed."""
    from test_torch_ref import HEALTH_COUNTERS
    for name, run in port.items():
        c = dict(zip(HEALTH_COUNTERS, run["counters"]))
        assert c["incident_bundles"] >= len(ESCALATIONS[name][3]), name
        assert c["incidents_suppressed"] == 0, name
        assert c["incident_dump_failures"] == 0, name


def test_a_dump_reads_no_device_state(tmp_path, monkeypatch):
    """A bundle after a halt: the dump reads the processor's plan name
    (and asks for the ``plan_signature`` it does not have) and nothing
    else of it, and no ``torch.cuda`` query runs (on a dead context every
    one would raise)."""
    import torch
    asked = []

    class Dead:
        plan_name = "staged:four_step+ring"

        def __getattr__(self, name):
            asked.append(name)
            raise AttributeError(name)

    def refuse(*_a, **_k):
        raise AssertionError("the dump queried the card")
    for name in ("synchronize", "memory_allocated", "current_device",
                 "is_available", "device_count"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    metrics.reset()
    rec = I.IncidentRecorder(str(tmp_path / "inc"), min_interval_s=0.0)
    got = rec.dump("reinit_budget_exceeded", reason="halt",
                   cfg=Config(), processor=Dead())
    assert got is not None
    with open(os.path.join(got, "plan.json")) as f:
        assert json.load(f) == {"plan_name": "staged:four_step+ring",
                                "plan_ladder_level": 0}
    assert asked == ["plan_signature"]
    assert metrics.get("incident_bundles") == 1
    metrics.reset()


def test_no_incident_dir_no_recorder(tmp_path):
    """``incident_dir`` empty: no recorder, and an escalation writes
    nothing."""
    assert I.IncidentRecorder.from_config(Config()) is None
    pipe = Pipeline.__new__(Pipeline)
    pipe.incidents = None
    pipe._incident("ladder_exhausted", reason="x")  # a no-op
