"""The port's archive replay (``srtb_tpu_torch/pipeline/archive.py`` and
``tools/archive_replay.py``, ROADMAP A8c) against the JAX package's
(``srtb_tpu/pipeline/archive.py``, ``tools/archive_replay.py`` and their
tests ``tests/test_archive.py`` and ``test_fleet_batch.py``'s
``test_archive_replay_fleet_batch``).  Both packages replay the same
seeded files (numpy's generator, the reference's bytes) in the reference's
scenarios: the reference's runs in the runner's subprocesses
(``tests/test_torch_ref.py``), the port's on the CPU.  Each scenario's
``ArchiveReport.as_dict()`` counts, statuses and per-file dicts equal the
reference's, the artifact names equal the reference's, the raw ``.bin``
dumps equal the reference's by SHA-256, and the float artifacts (``.npy``
waterfalls, ``.tim`` series) are within the reference's vmap contract
(rtol 1e-5, atol 1e-4·max(|golden|, 1)); the port's own replays equal its
streamed goldens bit for bit.  The scenario whose batch counts follow the
scheduler's timing (the cross-file batch former) is held to the
reference's invariants in both packages.  Then the port's selftest (a
mid-run SIGTERM and a resume) and one archive on the card (``cuda``)."""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io.synth import make_dispersed_baseband_host
from srtb_tpu_torch.pipeline.archive import ArchiveReplay
from srtb_tpu_torch.tools import archive_replay as AR
from srtb_tpu_torch.tools.fleet_soak import artifacts_close
from test_torch_ref import _flatten, _resolve, run_reference

N = 1 << 12
PORT = "srtb_tpu_torch"
# tests/test_fleet_batch.py's geometry for its archive leg
BATCH_N = 1 << 13
BATCH_SEGMENTS = 4
# the selftest's defaults (tools/archive_replay.py)
SELFTEST_N = 1 << 13
SELFTEST_SEGMENTS = 4


def _batch_fields(infile: str) -> dict:
    """``tests/test_fleet_batch.py``'s ``_mkcfg`` (its output prefix is the
    archive's to replace)."""
    return dict(
        baseband_input_count=BATCH_N, baseband_input_bits=8,
        baseband_freq_low=1405.0, baseband_bandwidth=64.0,
        baseband_sample_rate=128e6, dm=0.05, input_file_path=infile,
        baseband_output_file_prefix="arch_",
        spectrum_channel_count=64,
        mitigate_rfi_average_method_threshold=100.0,
        mitigate_rfi_spectral_kurtosis_threshold=2.0,
        baseband_reserve_sample=True, writer_thread_count=0,
        fft_strategy="four_step", inflight_segments=2,
        retry_backoff_base_s=0.001)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The inputs, made once in this process: ``three/bb0..1`` (3
    segments, the reference's ``_files``), ``two/bb0..2`` (2 segments),
    ``bad.bin`` (100 zero bytes), ``stamps.bin`` (2 noise segments),
    ``pulse.bin`` (2 segments, a pulse in each), ``batch/bb_f0..2``
    (``test_fleet_batch.py``'s ``_make_bb``) and ``selftest/bb0..1``."""
    root = tmp_path_factory.mktemp("archive")
    inp = root / "inputs"
    files = {}
    for tag, count, segs, n in (("three", 2, 3, N), ("two", 3, 2, N),
                                ("selftest", 2, SELFTEST_SEGMENTS,
                                 SELFTEST_N)):
        d = inp / tag
        d.mkdir(parents=True)
        files[tag] = [AR._make_archive_file(str(d), f"bb{i}", n, segs,
                                            seed=i) for i in range(count)]
    bad = inp / "bad.bin"
    bad.write_bytes(b"\x00" * 100)
    files["bad"] = str(bad)
    path = inp / "stamps.bin"
    make_dispersed_baseband_host(N * 2, 1405.0, 64.0, 0.0,
                                 pulse_positions=[], nbits=8).tofile(path)
    files["stamps"] = str(path)
    path = inp / "pulse.bin"
    make_dispersed_baseband_host(N * 2, 1405.0, 64.0, 0.05,
                                 pulse_positions=[N // 2, N + N // 2],
                                 pulse_amp=40.0, nbits=8).tofile(path)
    files["pulse"] = str(path)
    d = inp / "batch"
    d.mkdir()
    files["batch"] = []
    for i in range(3):
        path = d / f"bb_f{i}.bin"
        make_dispersed_baseband_host(
            BATCH_N * BATCH_SEGMENTS, 1405.0, 64.0, 0.05,
            pulse_positions=[BATCH_N // 2 + j * BATCH_N
                             for j in range(BATCH_SEGMENTS)],
            pulse_amp=30.0, nbits=8, seed=i).tofile(path)
        files["batch"].append(str(path))
    return {"root": root, "files": files}


def scenarios(work) -> dict:
    """name -> (base config fields, files, passes) of ``archive_passes``."""
    f = work["files"]
    sci = AR._science_cfg(N)
    one = dict(lanes=2, micro_batch=1, inflight=4)
    return {
        "replay": (sci, f["three"], [one]),
        "micro": (sci, f["three"], [dict(lanes=2, micro_batch=2,
                                         inflight=4)]),
        "resume": (sci, f["three"], [dict(one, max_segments_per_file=2),
                                     one, one]),
        "fan": (sci, f["two"], [dict(lanes=1, micro_batch=2, inflight=4)]),
        "corrupt": (sci, f["three"] + [f["bad"]], [one]),
        "period": (dict(sci, search_mode="periodicity"), f["two"][:1],
                   [dict(lanes=1, micro_batch=2, inflight=4)]),
        "fleet_batch": (_batch_fields(f["batch"][0]), f["batch"],
                        [dict(lanes=3, micro_batch=1, inflight=2,
                              fleet_batch=3, manifest=False)]),
    }


def jobs(work, side: str, pkg: str) -> list:
    """Every scenario's job for one package, its outputs under
    ``<root>/<side>``."""
    f = work["files"]
    base = work["root"] / side
    out = [{"key": "golden", "fn": "test_torch_ref:archive_goldens",
            "args": [pkg, N, f["three"], str(base / "golden")]},
           {"key": "selftest_golden", "fn": "test_torch_ref:archive_goldens",
            "args": [pkg, SELFTEST_N, f["selftest"],
                     str(base / "selftest_golden")],
            "kwargs": {"micro_batch_segments": 1}},
           {"key": "stamps", "fn": "test_torch_ref:archive_stamps",
            "args": [pkg, N, f["stamps"]]},
           {"key": "twice", "fn": "test_torch_ref:archive_pipeline_twice",
            "args": [pkg, N, f["pulse"], str(base / "twice")]},
           {"key": "guards", "fn": "test_torch_ref:archive_guards",
            "args": [pkg, N, str(work["root"] / "guards")]},
           {"key": "cli", "fn": "test_torch_ref:archive_cli",
            "args": [pkg, N, f["two"][0], str(base / "cli")]}]
    for name, (fields, files, passes) in scenarios(work).items():
        out.append({"key": name, "fn": "test_torch_ref:archive_passes",
                    "args": [pkg, fields, files, str(base / name), passes]})
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory, work):
    """The reference's runs, in three interpreters at once."""
    (work["root"] / "ref").mkdir()
    (work["root"] / "guards").mkdir()
    parts: tuple = ([], [], [])
    for i, job in enumerate(jobs(work, "ref", "srtb_tpu")):
        parts[i % 3].append(job)
    dirs = [tmp_path_factory.mktemp("ref_archive") for _ in parts]
    with ThreadPoolExecutor(len(parts)) as pool:
        outs = list(pool.map(
            lambda part: run_reference(*part, compile_cache=True),
            zip(parts, dirs)))
    return {k: v for out in outs for k, v in out.items()}


@pytest.fixture(scope="module")
def port(ref, work):
    """The port's runs, under ``<root>/port``, flattened as the
    reference's (after the reference's, so both never share the CPU)."""
    (work["root"] / "port").mkdir()
    out: dict = {}
    for job in jobs(work, "port", PORT):
        _flatten(job["key"], _resolve(job["fn"])(
            *job["args"], **job.get("kwargs", {})), out)
    return out


def _str(d: dict, key: str) -> str:
    return str(d[key])


def _report(d: dict, key: str) -> dict:
    return json.loads(_str(d, f"{key}/report"))


def _sha(d: dict, key: str) -> dict:
    return json.loads(_str(d, key))


def _same_reports(ref: dict, port: dict, name: str) -> None:
    i = 0
    while f"{name}/{i}/report" in ref:
        assert _report(port, f"{name}/{i}") == _report(ref, f"{name}/{i}"), \
            (name, i)
        i += 1
    assert i and f"{name}/{i}/report" not in port


def _held_to_reference(work, name: str, ref_map: dict, port_map: dict,
                       sub: str | None = None) -> None:
    """The port's artifacts of ``name`` against the reference's: the same
    names, ``.bin`` bitwise, floats within the vmap contract."""
    sub = sub or name
    why = artifacts_close(str(work["root"] / "ref" / sub),
                          str(work["root"] / "port" / sub), ref_map,
                          port_map)
    assert why is None, f"{name}: {why}"


# ------------------------------------------------ deterministic reader


def test_deterministic_reader_stamps_from_offset(ref, port):
    """The reader's stamps are the reference's: the same from two reads,
    the epoch first, advancing by the overlap-save stride; the wall-clock
    reader stays the default."""
    assert port["stamps/stamps"].tolist() == ref["stamps/stamps"].tolist()
    s1, s2 = port["stamps/stamps"].tolist()
    assert s1 == s2 and s1[0] == int(port["stamps/epoch"]) \
        == int(ref["stamps/epoch"])
    assert all(b > a for a, b in zip(s1, s1[1:]))
    assert _str(port, "stamps/cls") == "DeterministicTimestampReader"
    assert not bool(port["stamps/off_is_deterministic"])


def test_pipeline_honors_deterministic_timestamps(ref, port, work):
    """Two full runs of one file write the same names and bytes, and
    those are the reference's names, its ``.bin`` bytes and its floats
    within the contract."""
    a, b = _sha(port, "twice/a"), _sha(port, "twice/b")
    assert a == b and a
    _held_to_reference(work, "twice", _sha(ref, "twice/a"), a,
                       sub="twice/a")


# ---------------------------------------------------------- the engine


def test_replay_bit_identical_to_streamed_goldens(ref, port, work):
    """Two files on two lanes, micro-batch 1: the reference's report, one
    plan compile, and the output set the port's streamed goldens' by
    SHA-256 (the goldens the reference's by name, ``.bin`` and floats)."""
    _same_reports(ref, port, "replay")
    rep = _report(port, "replay/0")
    assert rep["failed"] == 0 and rep["drained"] == rep["segments"] > 0
    assert rep["plan_compiles"] == 1
    golden = _sha(port, "golden/sha")
    assert _sha(port, "replay/0/sha") == golden
    assert port["golden/segments"].tolist() == \
        ref["golden/segments"].tolist()
    assert port["golden/signals"].tolist() == ref["golden/signals"].tolist()
    _held_to_reference(work, "golden", _sha(ref, "golden/sha"), golden)
    _held_to_reference(work, "replay", _sha(ref, "replay/0/sha"),
                       _sha(port, "replay/0/sha"))


def test_replay_micro_batch_decisions_identical(ref, port, work):
    """Micro-batch 2: the reference's report; the golden artifact set
    (identical decisions) and ``.bin`` dumps bitwise, as the reference
    asserts; the port's batch is a solo dispatch a member, so every file
    is the golden's bit for bit."""
    _same_reports(ref, port, "micro")
    assert _report(port, "micro/0")["failed"] == 0
    batch, golden = _sha(port, "micro/0/sha"), _sha(port, "golden/sha")
    assert set(batch) == set(golden)
    for name in golden:
        if name.endswith(".bin"):
            assert batch[name] == golden[name], name
    assert batch == golden
    _held_to_reference(work, "micro", _sha(ref, "micro/0/sha"), batch)


def test_replay_resumes_deterministically(ref, port, work):
    """A capped first pass, an uncapped second and a third: each pass's
    report the reference's; the partial set a proper subset of the
    goldens, then exactly the goldens, and the third pass drains
    nothing."""
    _same_reports(ref, port, "resume")
    golden = _sha(port, "golden/sha")
    assert _report(port, "resume/0")["drained"] > 0
    assert set(_sha(port, "resume/0/sha")) < set(golden)
    rep2 = _report(port, "resume/1")
    assert rep2["failed"] == 0 and rep2["drained"] > 0
    assert _sha(port, "resume/1/sha") == golden
    assert _report(port, "resume/2")["drained"] == 0
    assert _sha(port, "resume/2/sha") == golden
    for i in range(3):
        assert set(_sha(port, f"resume/{i}/sha")) == \
            set(_sha(ref, f"resume/{i}/sha")), i
    _held_to_reference(work, "resume", _sha(ref, "resume/2/sha"),
                       _sha(port, "resume/2/sha"))


def test_more_files_than_lanes_queue_behind_admission(ref, port, work):
    """Three files on one lane: the reference's report, every file done,
    one shared plan."""
    _same_reports(ref, port, "fan")
    rep = _report(port, "fan/0")
    assert rep["failed"] == 0
    assert all(f["status"] == "done" for f in rep["files"].values())
    assert rep["plan_compiles"] == 1
    _held_to_reference(work, "fan", _sha(ref, "fan/0/sha"),
                       _sha(port, "fan/0/sha"))


def test_corrupt_file_contained_to_its_lane(ref, port, work):
    """A 100-byte file beside two real ones: the reference's statuses and
    counts for all three; the real files done."""
    _same_reports(ref, port, "corrupt")
    files = _report(port, "corrupt/0")["files"]
    assert files["bb0"]["status"] == "done"
    assert files["bb1"]["status"] == "done"
    _held_to_reference(work, "corrupt", _sha(ref, "corrupt/0/sha"),
                       _sha(port, "corrupt/0/sha"))


def test_engine_validates_inputs(ref, port):
    """No files, and a missing one: the reference's exceptions, with its
    messages; the defaults are the reference's."""
    assert port["guards/errors"].tolist() == ref["guards/errors"].tolist()
    assert port["guards/errors"][0].startswith(
        "ValueError: archive replay needs at least one")
    assert port["guards/errors"][1].startswith("FileNotFoundError")
    assert port["guards/defaults"].tolist() == \
        ref["guards/defaults"].tolist() == [2, 4, 8]
    with pytest.raises(ValueError, match="at least one"):
        ArchiveReplay(Config(**AR._science_cfg(N)), [], ".", device="cpu")


def test_stream_name_dedup(ref, port):
    """``stream_name_for`` names as the reference's, dedup included."""
    assert port["guards/names"].tolist() == ref["guards/names"].tolist()
    assert port["guards/names"].tolist()[:3] == ["obs", "obs.1",
                                                 "weird_name_"]


def test_periodicity_replay_mode(ref, port, work):
    """``search_mode = periodicity`` rides the base config into the lane:
    the reference's report, drained, its artifacts within the contract."""
    _same_reports(ref, port, "period")
    rep = _report(port, "period/0")
    assert rep["failed"] == 0 and rep["drained"] > 0
    _held_to_reference(work, "period", _sha(ref, "period/0/sha"),
                       _sha(port, "period/0/sha"))


def test_archive_selftest_gate(ref, port, tmp_path):
    """The port's gate on the CPU at its defaults (a mid-run SIGTERM into
    bb0's sink-write stall, the resume, fsck, no orphan temp, the output
    set the streamed goldens' by SHA-256, the micro-batched leg): its
    goldens are the reference's streamed goldens of the same files by
    segment count, artifact names and ``.bin`` bytes."""
    report = AR.run_selftest(segments=SELFTEST_SEGMENTS,
                             log2n=SELFTEST_N.bit_length() - 1,
                             tmpdir=str(tmp_path), device="cpu")
    assert report["ok"] and report["killed_mid_run"]
    assert report["bb0_segments_at_kill"] < SELFTEST_SEGMENTS
    assert report["batch_bitwise"] == report["artifacts"]
    assert report["segments"] == sum(ref["selftest_golden/segments"])
    golden = AR._sha_map(str(tmp_path / "golden"))
    want = _sha(ref, "selftest_golden/sha")
    assert set(golden) == set(want) and len(want) == report["artifacts"]
    assert golden == _sha(port, "selftest_golden/sha")
    for name in want:
        if name.endswith(".bin"):
            assert golden[name] == want[name], name


def test_cli_report_shape(ref, port):
    """``archive_replay.main`` on one file: rc 0, the report's keys and
    counts the reference's."""
    assert int(port["cli/rc"]) == int(ref["cli/rc"]) == 0
    assert port["cli/keys"].tolist() == ref["cli/keys"].tolist()
    assert "segments_per_sec" in port["cli/keys"].tolist()
    rep = json.loads(_str(port, "cli/report"))
    assert rep == json.loads(_str(ref, "cli/report"))
    assert rep["ok"] and rep["drained"] > 0


@pytest.mark.parametrize("d_name", ("ref", "port"))
def test_archive_replay_fleet_batch(ref, port, work, d_name):
    """Many small files, micro-batch 1, the batch former at 3
    (``test_fleet_batch.py``'s archive leg): no failure, cross-file
    batched dispatches, at least two segments a batch, in both packages;
    the drained counts and the statuses equal, the port's artifacts the
    reference's within the vmap contract."""
    d = {"ref": ref, "port": port}[d_name]
    rep = _report(d, "fleet_batch/0")
    assert rep["failed"] == 0
    assert rep["batched_dispatches"] >= 1
    assert rep["batched_segments"] >= 2 * rep["batched_dispatches"]
    want = _report(ref, "fleet_batch/0")
    for k in ("segments", "drained", "failed", "plan_compiles"):
        assert rep[k] == want[k], k
    assert {n: (f["status"], f["drained"], f["dropped"])
            for n, f in rep["files"].items()} == \
        {n: (f["status"], f["drained"], f["dropped"])
         for n, f in want["files"].items()}
    _held_to_reference(work, "fleet_batch", _sha(ref, "fleet_batch/0/sha"),
                       _sha(port, "fleet_batch/0/sha"))


# ------------------------------------------------------------- the card


@pytest.mark.cuda
def test_archive_on_the_card(tmp_path):
    """An archive of two files at 2^16 samples a segment on the card,
    micro-batch 2: one compile, every file done, its raw dumps (and every
    other artifact) its streamed solo runs' by SHA-256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 1 << 16
    files = [AR._make_archive_file(str(tmp_path), f"bb{i}", n, 3, seed=i)
             for i in range(2)]
    from srtb_tpu_torch.pipeline.runtime import Pipeline
    os.makedirs(tmp_path / "golden")
    for i, f in enumerate(files):
        cfg = Config(**AR._science_cfg(n)).replace(
            input_file_path=f, baseband_output_file_prefix=str(
                tmp_path / "golden" / f"bb{i}_"),
            deterministic_timestamps=True, inflight_segments=2)
        with Pipeline(cfg) as pipe:
            pipe.run()
    rep = ArchiveReplay(Config(**AR._science_cfg(n)), files,
                        str(tmp_path / "replay"), lanes=2, micro_batch=2,
                        inflight=4).run()
    assert rep.failed == 0 and rep.plan_compiles == 1
    got = AR._sha_map(str(tmp_path / "replay"))
    want = AR._sha_map(str(tmp_path / "golden"))
    assert any(k.endswith(".bin") for k in want)
    assert got == want
