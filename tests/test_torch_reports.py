"""The port's journal and flight-recorder readers
(``srtb_tpu_torch/tools/telemetry_report.py``, ``quality_report.py`` and
``trace_export.py``) against the JAX package's (ROADMAP A9b/A9c; the
reference runs in its own interpreter, ``tests/test_torch_ref.py``).

Each package writes a journal (rotated once, its older generation
gzipped), an events dump and an incident bundle in a canary run on the
canary tests' 8-bit input, clean and degraded; then both packages' tools
read all of them, and of an empty journal: ``telemetry_report`` and
``quality_report`` print the same Markdown and JSON, ``trace_export``
validates each dump and bundle alike and writes the same Chrome-trace
document (less ``otherData.source``, which names the package)."""

from __future__ import annotations

import json
import os

import pytest

from srtb_tpu_torch.tools import quality_report as QR
from srtb_tpu_torch.tools import telemetry_report as TR
from srtb_tpu_torch.tools import trace_export as TE
from test_torch_canary import PINNED_SNR, base_fields, write_noise
from test_torch_ref import health_run, report_outputs, run_reference

BIN_S = 0.05
# (overrides): the degraded run bundles each failed canary
RUNS = {
    "clean": dict(telemetry_journal_max_bytes=5000),
    "degraded": dict(mitigate_rfi_freq_list="1405-1466",
                     canary_expected_snr=PINNED_SNR,
                     incident_min_interval_s=0.0),
}


def run_fields(tmp, name: str, pkg: str) -> dict:
    tag = f"{pkg}_{name}"
    fields = base_fields(tmp, tag, **RUNS[name])
    if name == "degraded":
        fields["incident_dir"] = os.path.join(str(tmp), tag, "incidents")
    return fields


def inputs(tmp) -> tuple[list, list]:
    """The journals (each package's two and an empty one) and the events
    dumps and bundles (each package's clean dump and first bundle)."""
    journals, dumps = [], []
    for pkg in ("port", "ref"):
        for name in RUNS:
            journals.append(run_fields(tmp, name, pkg)
                            ["telemetry_journal_path"])
        dumps.append(run_fields(tmp, "clean", pkg)["events_dump_path"])
        dumps.append(os.path.join(run_fields(tmp, "degraded", pkg)
                                  ["incident_dir"],
                                  "incident_000_canary_sensitivity"))
    journals.append(os.path.join(str(tmp), "empty.jsonl"))
    return journals, dumps


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reports")
    write_noise(tmp)
    open(os.path.join(str(tmp), "empty.jsonl"), "w").close()
    return tmp


@pytest.fixture(scope="module")
def port(work):
    """The port's runs first: the reference's job reads their files."""
    return {name: health_run("srtb_tpu_torch",
                             run_fields(work, name, "port"))
            for name in RUNS}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, work, port):
    tmp = tmp_path_factory.mktemp("ref_reports")
    jobs = [{"key": f"run/{name}", "fn": "test_torch_ref:health_run",
             "args": ["srtb_tpu", run_fields(work, name, "ref")]}
            for name in RUNS]
    journals, dumps = inputs(work)
    jobs.append({"key": "out", "fn": "test_torch_ref:report_outputs",
                 "args": ["srtb_tpu", journals, dumps, BIN_S]})
    return run_reference(jobs, tmp, compile_cache=True)


@pytest.fixture(scope="module")
def outputs(work, ref):
    journals, dumps = inputs(work)
    return report_outputs("srtb_tpu_torch", journals, dumps, BIN_S)


def _keys():
    journals, dumps = inputs("/nonexistent")
    keys = []
    for i in range(len(journals)):
        for tool in ("telemetry", "quality"):
            keys += [f"{tool}/{i}/md", f"{tool}/{i}/json"]
    for i in range(len(dumps)):
        keys += [f"trace/{i}/validate", f"trace/{i}/doc"]
    return keys


def test_runs_wrote_what_the_tools_read(work, port, ref):
    """Both packages' runs finished, each clean journal rotated once into
    a gzipped generation, and each degraded run bundled its failures."""
    for pkg in ("port", "ref"):
        jp = run_fields(work, "clean", pkg)["telemetry_journal_path"]
        assert os.path.exists(jp + ".1.gz"), pkg
        assert TR.load(jp, include_rotated=False) != TR.load(jp)
    assert port["clean"]["error"] == str(ref["run/clean/error"]) == ""
    journals, dumps = inputs(work)
    for d in dumps:
        assert os.path.exists(d), d


@pytest.mark.parametrize("key", _keys())
def test_output_equals_reference(outputs, ref, key):
    """Each tool's text and document on each input, equal to the
    reference tool's on the same input."""
    assert outputs[key] == str(ref[f"out/{key}"])


def test_markdown_sections(outputs, work):
    """The clean journals' Markdown carries the canary's section and the
    calibration; the degraded ones' a FAILED verdict; the empty journal
    is a note, not an error."""
    journals, _dumps = inputs(work)
    for i, j in enumerate(journals[:-1]):
        md = outputs[f"quality/{i}/md"]
        assert md.startswith("rc=0\n# Quality report")
        assert "## Canary (run)" in md
        assert ("calibrated" in md) == ("clean" in j)
        assert ("FAILED" in md) == ("degraded" in j)
        rep = json.loads(outputs[f"quality/{i}/json"].split("\n", 1)[1])
        assert rep["canary"][""]["checked"] == 2
        tele = outputs[f"telemetry/{i}/md"]
        assert "## Per-stage wall clock (ms)" in tele
        assert "## Fleet" not in tele  # no stream name: no fleet section
    last = len(journals) - 1
    assert "no segment spans" in outputs[f"telemetry/{last}/md"]
    assert "no quality/canary spans" in outputs[f"quality/{last}/md"]


def test_trace_export_of_a_bundle(work, tmp_path):
    """A bundle's directory renders as its ``events.jsonl``: stage
    slices, a flow a traced segment, the ``incident`` and
    ``canary.regression`` instants; the default output path sits beside
    the input."""
    _journals, dumps = inputs(work)
    bundle = dumps[1]
    doc = TE.render(TE.load_events(bundle))
    assert TE.validate(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"ingest", "dispatch", "fetch", "canary.regression"} <= names
    assert doc["otherData"]["source"] == "srtb_tpu_torch flight recorder"
    events = os.path.join(str(tmp_path), "events.jsonl")
    with open(events, "w") as f, \
            open(os.path.join(bundle, "events.jsonl")) as src:
        f.write(src.read())
    assert TE.main([events]) == 0
    assert os.path.exists(events + ".trace.json")
    # an events file with no event in it: an error, exit 1
    empty = os.path.join(str(tmp_path), "none.jsonl")
    open(empty, "w").close()
    assert TE.main([empty, "--validate"]) == 1


def test_quality_report_reads_through_telemetry_report(work):
    """``quality_report.load`` is ``telemetry_report.load``: the rotated
    generation first."""
    assert QR.load is TR.load
    jp = run_fields(work, "clean", "port")["telemetry_journal_path"]
    assert QR.report(jp)["records"] == 4
    assert [r["segment"] for r in TR.load(jp)] == [0, 1, 2, 3]
