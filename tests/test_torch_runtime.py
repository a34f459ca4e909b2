"""The port's in-flight engine, sink thread, writer pool and ingest ring.

``srtb-torch-main --device cpu`` against the JAX package's ``srtb-main``
on ``test_torch_pipeline.py``'s synthetic file (three overlapping 2^16
segments, the pulse in the middle one), at each setting of the engine:
``inflight_segments`` 1 and 2, ``writer_thread_count`` 0 and 2,
``ingest_ring`` off and auto, and ``baseband_write_all 1``.  Artifact
names, decisions and ``.bin`` bytes must be the same exactly; ``.npy`` and
``.tim`` within ``test_torch_pipeline.py``'s gates.  Then the port's ring
(warm against cold, bit-identical), and unit cases of the buffer pool,
the pipe framework and the writer pool (native and Python).  Then the
multi-stream formats: two-stream files (``interleaved_samples_2``
2-bit and ``gznupsr_a1`` int8 words, the pulse in stream 0 only) through
both mains at the serial leg, the defaults and write-all, the per-stream
gate, and the ring's warm steps at every format."""

import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from srtb_tpu_torch.io import native_writer as NW
from srtb_tpu_torch.io.writers import TMP_SUFFIX, recover_orphan_temps
from srtb_tpu_torch.pipeline import framework as fw
from srtb_tpu_torch.pipeline import runtime as R
from srtb_tpu_torch.pipeline.segment import SegmentProcessor
from srtb_tpu_torch.tools import main as M
from srtb_tpu_torch.utils import events, slo, termination
from srtb_tpu_torch.utils.bufferpool import BufferPool
from srtb_tpu_torch.utils.metrics import metrics
from test_torch_pipeline import (check_candidate_contents, make_case,
                                 reference_arrays)
from test_torch_ref import run_reference
from test_torch_segment import CASES, MULTI_FORMATS

# (inflight_segments, writer_thread_count, ingest_ring[, write-all])
SETTINGS = {
    "serial": ("1", "0", "off"),
    "serial_ring": ("1", "0", "auto"),
    "serial_pool_ring": ("1", "2", "auto"),
    "window_sync": ("2", "0", "off"),
    "window_pool": ("2", "2", "off"),
    "default": ("2", "2", "auto"),
    "write_all": ("2", "2", "auto", "1"),
}


def _setting_argv(setting) -> list:
    window, writers, ring, *write_all = SETTINGS[setting]
    argv = ["--inflight_segments", window, "--writer_thread_count",
            writers, "--ingest_ring", ring]
    if write_all:
        argv += ["--baseband_write_all", write_all[0]]
    return argv


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runtime")
    argv, nres = make_case(tmp)
    dirs, jobs = {}, []
    for setting in SETTINGS:
        for who in ("port", "ref"):
            dirs[setting, who] = tmp / setting / who
            dirs[setting, who].mkdir(parents=True)
        jobs.append({"key": setting, "fn": "test_torch_ref:pipeline_main",
                     "args": [argv + _setting_argv(setting) + [
                         "--baseband_output_file_prefix",
                         f"{dirs[setting, 'ref']}/out_"],
                         str(dirs[setting, "ref"])]})
    ref = run_reference(jobs, tmp)
    port = {}
    for setting in SETTINGS:
        port[setting] = M.run(argv + _setting_argv(setting) + [
            "--baseband_output_file_prefix",
            f"{dirs[setting, 'port']}/out_", "--device", "cpu"])
    return {"ref": ref, "port": port, "dirs": dirs, "nres": nres}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_same_artifacts_as_reference(runs, setting):
    """The same artifact names as ``srtb-main`` at this setting, the
    pulse segment the only positive one, ``.bin`` bytes identical, the
    waterfall and time series within the pipeline test's gates."""
    ref, dirs = runs["ref"], runs["dirs"]
    stats, pipe = runs["port"][setting]
    assert int(ref[f"{setting}/rc"]) == 0
    names = sorted(os.listdir(dirs[setting, "port"]))
    assert names == ref[f"{setting}/files"].tolist()
    assert stats.segments == 3 and stats.signals == 1
    assert pipe.positive_segments == [1]
    for name in names:
        if name.endswith(".bin"):
            got = (dirs[setting, "port"] / name).read_bytes()
            assert got == (dirs[setting, "ref"] / name).read_bytes(), name
    if setting == "write_all":
        assert names == ["out_stream0.bin"]
        return
    (files,) = pipe.sink.written
    check_candidate_contents(files, reference_arrays(ref, setting, "npy"),
                             reference_arrays(ref, setting, "tim"),
                             runs["nres"])


def test_every_setting_writes_the_same_bytes(runs):
    """The candidate files are byte-identical across the engine's
    settings: the window, the writer pool and the ring change how a
    segment travels, not what it computes (warm ring dispatches assemble
    the segment's own bytes)."""
    dirs = runs["dirs"]
    want = None
    for setting in SETTINGS:
        if setting == "write_all":
            continue
        d = dirs[setting, "port"]
        got = {name: (d / name).read_bytes() for name in os.listdir(d)}
        if want is None:
            want = got
        assert got == want, setting


def test_engine_records_and_ring_uploads(runs):
    """Per segment: overlap-hidden seconds, device seconds and H2D bytes;
    with the ring the first dispatch uploads the whole segment and the
    next ones only its stride, without it every dispatch the whole
    segment."""
    for setting, (stats, pipe) in runs["port"].items():
        extras = stats.extras
        proc = pipe.processor
        assert extras["inflight_segments"] == int(SETTINGS[setting][0])
        assert len(extras["overlap_hidden_s_per_segment"]) == 3
        stage_s = extras["stage_s"]
        assert sum(extras["device_s_per_segment"]) == pytest.approx(
            stage_s["dispatch"] + stage_s["overlap"] + stage_s["fetch"])
        seg = proc.stride_bytes + proc.reserved_bytes
        if SETTINGS[setting][2] == "auto":
            assert proc.plan_name.endswith("+ring")
            assert extras["h2d_bytes_per_segment"] == [
                seg, proc.stride_bytes, proc.stride_bytes]
            assert (proc.ring_cold_dispatches,
                    proc.ring_warm_dispatches) == (1, 2)
        else:
            assert not proc.ring
            assert extras["h2d_bytes_per_segment"] == [seg] * 3
        # every segment buffer went back to the reader's pool
        assert pipe.source.pool.stats()["in_use"] == 0


def _ring_case():
    cfg, _raw, window, _staged, _env = CASES["n16_ch32"]
    sp = SegmentProcessor(cfg, window_name=window, device="cpu")
    rng = np.random.default_rng(3)
    stream = rng.integers(0, 256, sp.stride_bytes * 2 + sp.reserved_bytes,
                          dtype=np.uint8)
    segs = [stream[i * sp.stride_bytes:][:sp.stride_bytes
                                         + sp.reserved_bytes]
            for i in range(2)]
    return sp, segs


def test_ring_warm_equals_cold():
    """A warm step (the carry plus the stride's bytes) gives the cold
    step's waterfall, detection and next carry bit for bit."""
    sp, (s0, s1) = _ring_case()
    assert sp.ring
    _out0, carry = sp.run_device_ring(sp.stage_input(s0))
    np.testing.assert_array_equal(carry.numpy(), s0[sp.stride_bytes:])
    (wf_w, det_w), carry_w = sp.run_device_ring(
        sp.stage_input(s1, carry=carry))
    (wf_c, det_c), carry_c = sp.run_device_ring(sp.stage_input(s1))
    assert torch.equal(wf_w, wf_c) and torch.equal(carry_w, carry_c)
    for a, b in zip(det_w, det_c):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    wf_p, det_p = sp.process(s1)
    assert torch.equal(wf_p, wf_c)
    assert sp.h2d_bytes == 2 * s0.nbytes + sp.stride_bytes


def test_stage_input_takes_only_contiguous_segment_bytes():
    """``stage_input`` uploads the reader's buffers as they are: strided,
    wider or short input is refused, and a carry needs the ring."""
    sp, (s0, _s1) = _ring_case()
    np.testing.assert_array_equal(sp.stage_input(s0).numpy(), s0)
    strided = np.repeat(s0, 2)[::2]
    assert not strided.flags["C_CONTIGUOUS"]
    for bad in (strided, s0.astype(np.int16), s0[:-1],
                torch.from_numpy(s0)):
        with pytest.raises(ValueError, match="contiguous uint8"):
            sp.stage_input(bad)
    off = SegmentProcessor(CASES["n16_ch32"][0].replace(ingest_ring="off"),
                           window_name=CASES["n16_ch32"][2], device="cpu")
    with pytest.raises(ValueError, match="ingest ring"):
        off.stage_input(s0, carry=torch.from_numpy(s0[:sp.reserved_bytes]))


# two-stream files through both mains: (format, bits) by name, and the
# settings they run at (the window 1 and 2, the ring off and auto)
STREAM_FILES = {"is2_2bit": ("interleaved_samples_2", 2),
                "gznupsr": ("gznupsr_a1", -8)}
STREAM_SETTINGS = ("serial", "default", "write_all")


@pytest.fixture(scope="module")
def stream_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("streams")
    dirs, jobs, argvs = {}, [], {}
    for name, (fmt, bits) in STREAM_FILES.items():
        (tmp / name).mkdir()
        argvs[name] = make_case(tmp / name, fmt, bits)
        for setting in STREAM_SETTINGS:
            for who in ("port", "ref"):
                dirs[name, setting, who] = tmp / name / setting / who
                dirs[name, setting, who].mkdir(parents=True)
            jobs.append({
                "key": f"{name}/{setting}",
                "fn": "test_torch_ref:pipeline_main",
                "args": [argvs[name][0] + _setting_argv(setting) + [
                    "--baseband_output_file_prefix",
                    f"{dirs[name, setting, 'ref']}/out_"],
                    str(dirs[name, setting, "ref"])]})
    ref = run_reference(jobs, tmp)
    port = {(name, setting): M.run(argvs[name][0] + _setting_argv(setting) + [
        "--baseband_output_file_prefix",
        f"{dirs[name, setting, 'port']}/out_", "--device", "cpu"])
        for name in STREAM_FILES for setting in STREAM_SETTINGS}
    return {"ref": ref, "port": port, "dirs": dirs, "argvs": argvs}


@pytest.mark.parametrize("name", sorted(STREAM_FILES))
@pytest.mark.parametrize("setting", STREAM_SETTINGS)
def test_two_stream_files_write_the_references_artifacts(stream_runs, name,
                                                         setting):
    """``srtb-torch-main`` on a two-stream file writes ``srtb-main``'s
    artifact names: the pulse segment's ``.bin`` (byte-identical), one
    ``.npy`` a stream and ``.s0.`` boxcar series only (the pulse is in
    stream 0), or write-all's ``stream0.bin`` (byte-identical); the
    waterfalls and series within the pipeline test's gates, and the same
    bytes at every setting."""
    ref, dirs = stream_runs["ref"], stream_runs["dirs"]
    stats, pipe = stream_runs["port"][name, setting]
    key = f"{name}/{setting}"
    assert int(ref[f"{key}/rc"]) == 0
    d = dirs[name, setting, "port"]
    names = sorted(os.listdir(d))
    assert names == ref[f"{key}/files"].tolist()
    assert stats.segments == 3 and stats.signals == 1
    assert pipe.positive_segments == [1]
    assert pipe.processor.streams == 2
    for f in names:
        if f.endswith(".bin"):
            assert (d / f).read_bytes() == \
                (dirs[name, setting, "ref"] / f).read_bytes(), f
    if setting == "write_all":
        assert names == ["out_stream0.bin"]
        return
    assert sum(f.endswith(".npy") for f in names) == 2
    tims = [f for f in names if f.endswith(".tim")]
    assert tims and all(".s0." in f for f in tims)
    (files,) = pipe.sink.written
    proc = pipe.processor
    check_candidate_contents(files, reference_arrays(ref, key, "npy"),
                             reference_arrays(ref, key, "tim"),
                             proc.nsamps_reserved,
                             proc.stride_bytes + proc.reserved_bytes)
    serial = dirs[name, "serial", "port"]
    assert {f: (d / f).read_bytes() for f in names} == {
        f: (serial / f).read_bytes() for f in os.listdir(serial)}


def test_has_signal_per_stream_matches_reference(tmp_path):
    """The gate's per-stream verdict (``stream=``) and the segment's
    (any stream) on hand-made results: a stream with too many zapped
    channels is negative whatever fired, a stream fires only with a
    count."""
    from srtb_tpu_torch.ops.detect import DetectResult
    zero_count = np.array([0, 5, 30, 2], dtype=np.int32)
    counts = np.array([[0, 0], [1, 0], [3, 2], [0, 0]], dtype=np.int32)
    cfg = CASES["n16_ch32"][0]
    jobs = [{"key": "gate", "fn": "test_torch_ref:gate_verdicts",
             "args": [zero_count, counts, 32, [None, 0, 1, 2, 3]]}]
    ref = run_reference(jobs, tmp_path)
    res = DetectResult(torch.from_numpy(zero_count), None, (1, 2),
                       torch.from_numpy(counts), None, None)
    got = [R.has_signal(cfg, res, stream=s, frequency_bin_count=32)
           for s in (None, 0, 1, 2, 3)]
    assert got == ref["gate"].tolist() == [True, False, True, False, False]


@pytest.mark.parametrize("fmt", sorted(MULTI_FORMATS))
def test_ring_warm_equals_cold_every_format(fmt):
    """At every multi-stream format the reserved tail is a whole number of
    the format's interleave groups (2 bytes for "1212" at 8 bits, 4 for
    "1122", 8 and 16 for the gznupsr words), so a warm step's carry
    starts at a group boundary, and warm and cold steps give the same
    waterfall, detection and carry bit for bit."""
    cfg = CASES[f"{fmt}_monolithic"][0]
    sp = SegmentProcessor(cfg, device="cpu")
    group = {"interleaved_samples_2": 2, "naocpsr_snap1": 4,
             "gznupsr_a1_v2_1": 8, "gznupsr_a1": 16}[sp.fmt.unpack_variant]
    assert sp.ring and sp.reserved_bytes % group == 0
    assert sp.stride_bytes % group == 0
    rng = np.random.default_rng(11)
    stream = rng.integers(0, 256, sp.stride_bytes * 2 + sp.reserved_bytes,
                          dtype=np.uint8)
    s0 = stream[:sp.stride_bytes + sp.reserved_bytes]
    s1 = stream[sp.stride_bytes:]
    _out, carry = sp.run_device_ring(sp.stage_input(s0))
    (wf_w, det_w), carry_w = sp.run_device_ring(sp.stage_input(s1,
                                                               carry=carry))
    (wf_c, det_c), carry_c = sp.run_device_ring(sp.stage_input(s1))
    assert wf_w.shape[0] == sp.streams
    assert torch.equal(wf_w, wf_c) and torch.equal(carry_w, carry_c)
    for a, b in zip(det_w, det_c):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


# the settings still refused: (field, value, the ROADMAP item named)
UNPORTED_SETTINGS = {
    "canary_every_segments": ("canary_every_segments", "4", "A9b"),
    "incident_dir": ("incident_dir", "incidents", "A9b"),
    "perf_ledger_path": ("perf_ledger_path", "ledger.jsonl", "A9c"),
    "sanitize": ("sanitize", "1", "A9d"),
    "distributed_num_processes": ("distributed_num_processes", "2", "A8"),
}
# the settings that raised before the micro-batch (A3), durability (A6b),
# resilience (A7) and observability (A9a) slices, and now run: a device
# fault the ladder recovers, a stall under the default retries, the
# segment deadline, the span journal, the events dump and a profile
# capture ("{tmp}" is the test's directory)
NOW_PORTED = {
    "checkpoint_path": ["--checkpoint_path", "{tmp}/ck.json"],
    "run_manifest_path": ["--run_manifest_path", "{tmp}/manifest.jsonl"],
    "micro_batch_segments": ["--micro_batch_segments", "2"],
    "fault_plan": ["--fault_plan", "dispatch:oom@1"],
    "fault_plan_with_retries": ["--fault_plan", "checkpoint:stall=0.01@0"],
    "segment_deadline_s": ["--segment_deadline_s", "30"],
    "telemetry_journal_path": ["--telemetry_journal_path",
                               "{tmp}/spans.jsonl",
                               "--telemetry_journal_max_bytes", "100000"],
    "events_dump_path": ["--events_dump_path", "{tmp}/events.jsonl",
                         "--events_ring_size", "64"],
    "profile_capture_segments": ["--profile_capture_segments", "1",
                                 "--profile_capture_dir", "{tmp}/profile"],
}


@pytest.fixture
def fresh_metrics():
    """The process-global registry, flight recorder and SLO tracker
    fresh around a run (``stats.extras`` copies the registry's
    counters)."""
    saved = events.hub
    metrics.reset()
    slo.reset()
    events.configure(False)
    yield
    metrics.reset()
    events.hub = saved


@pytest.mark.parametrize("case", sorted(UNPORTED_SETTINGS)
                         + sorted(NOW_PORTED))
def test_unported_runtime_settings_raise(tmp_path, fresh_metrics, case):
    """What is still unported raises ``NotImplementedError`` naming its
    ROADMAP item, before any input is read; the checkpoint, the run
    manifest, the micro-batch, a fault plan (an injected out-of-memory
    demotes once), the segment deadline, the span journal (one schema-11
    span a segment), the events dump (each segment's stage edges) and a
    profile capture (a torch.profiler trace whose user annotations hold
    the stage names) run and find the pulse."""
    argv, _nres = make_case(tmp_path)
    out = ["--device", "cpu", "--baseband_output_file_prefix",
           f"{tmp_path}/out_"]
    if case in UNPORTED_SETTINGS:
        key, value, item = UNPORTED_SETTINGS[case]
        reads = []
        opened = R.make_file_source

        def recording(*args, **kwargs):
            reads.append(args)
            return opened(*args, **kwargs)
        R.make_file_source = recording
        try:
            with pytest.raises(NotImplementedError,
                               match=f"ROADMAP {item}\\b"):
                M.run(argv + [f"--{key}", value] + out)
        finally:
            R.make_file_source = opened
        assert reads == []
        return
    flags = [a.replace("{tmp}", str(tmp_path)) for a in NOW_PORTED[case]]
    stats, pipe = M.run(argv + flags + out)
    assert stats.segments == 3 and pipe.positive_segments == [1]
    if case in ("checkpoint_path", "run_manifest_path"):
        assert os.path.exists(flags[1])
    assert stats.extras.get("plan_demotions", 0) == (case == "fault_plan")
    if case == "telemetry_journal_path":
        with open(flags[1]) as f:
            spans = [json.loads(line) for line in f]
        assert [s["segment"] for s in spans] == [0, 1, 2]
        assert [s["dump"] for s in spans] == [False, True, False]
        assert all(s["v"] == 11 for s in spans)
    if case == "events_dump_path":
        with open(flags[1]) as f:
            types = [json.loads(line)["type"] for line in f]
        for t in ("stage.ingest", "stage.dispatch", "stage.fetch",
                  "stage.sink"):
            assert types.count(t) == 3, t
    if case == "profile_capture_segments":
        with open(os.path.join(flags[3], "trace.json")) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "user_annotation"}
        assert {"srtb:ingest", "srtb:dispatch", "srtb:fetch",
                "srtb:sink"} <= names


# ------------------------------------------------------------ unit cases

def test_buffer_pool_reuse_and_release():
    pool = BufferPool("test")
    a = pool.acquire(1000)
    assert a.nbytes == 1000 and not a.any()
    a[:] = 7
    pool.release(a)
    # exact-or-larger reuse within 2x: a view of the same block, zeroed
    b = pool.acquire(600)
    assert b.nbytes == 600 and not b.any()
    assert b.__array_interface__["data"] == a.__array_interface__["data"]
    pool.release(b)
    # more than 2x larger than asked: a new block
    c = pool.acquire(400)
    assert c.__array_interface__["data"][0] != \
        a.__array_interface__["data"][0]
    assert pool.stats() == {"cached_blocks": 1, "cached_bytes": 1000,
                            "in_use": 1}
    pool.release(c)
    pool.release(c)  # the second release only warns
    assert pool.stats()["in_use"] == 0
    d = pool.acquire(1000, zero=False)
    assert pool.free_all() == 1
    pool.release(d)
    assert pool.stats() == {"cached_blocks": 1, "cached_bytes": 1000,
                            "in_use": 0}


def test_work_queue_and_pipe_stop():
    stop = fw.StopToken()
    q_in, q_out = fw.WorkQueue(), fw.WorkQueue(capacity=8)
    pipe = fw.start_pipe(lambda _s, x: x * 2, q_in, q_out, stop, "double")
    for i in range(5):
        assert q_in.push(i, stop)
    q_in.push(fw.SENTINEL, stop)
    assert pipe.join(5) and pipe.exception is None
    out = []
    while (item := q_out.pop(stop)) is not fw.SENTINEL:
        out.append(item)
    assert out == [0, 2, 4, 6, 8]
    # a full queue's push returns False once stop is requested
    full = fw.WorkQueue(capacity=1)
    assert full.push_lossy(1) and not full.push_lossy(2)
    stop.request_stop()
    assert full.push(2, stop) is False
    assert fw.WorkQueue().pop(stop) is None
    # a crashing functor ends its pipe and keeps the exception; on_exit
    # joins what is left
    stop2 = fw.StopToken()
    q = fw.WorkQueue()

    def boom(_s, x):
        raise RuntimeError(f"boom {x}")

    crashed = fw.start_pipe(boom, q, None, stop2)
    q.push(1, stop2)
    assert crashed.join(5) and "boom 1" in str(crashed.exception)
    idle = fw.start_pipe(lambda _s, x: x, fw.WorkQueue(), None, stop2)
    assert fw.on_exit(stop2, [crashed, idle], timeout=2.0) == []
    assert not idle.thread.is_alive()
    assert fw.composite(lambda _s, x: x + 1, lambda _s, x: x * 3)(
        stop2, 1) == 6


@pytest.mark.parametrize("native", [True, False])
def test_async_writer_pool(tmp_path, native):
    """submit copies its payload, drain waits, a payload larger than the
    byte cap still goes through, failed writes surface at
    raise_new_errors, and one thread writes in submission order."""
    pool = NW.AsyncWriterPool(2, prefer_native=native, max_queued_bytes=64)
    assert pool.is_native == native
    payload = np.arange(200, dtype=np.uint8)
    pool.submit(str(tmp_path / "a.bin"), payload, fsync=True)
    payload[:] = 0  # the pool copied it at submit
    pool.submit(str(tmp_path / "b.bin"), b"xyz")
    pool.drain()
    assert (tmp_path / "a.bin").read_bytes() == bytes(range(200))
    assert (tmp_path / "b.bin").read_bytes() == b"xyz"
    assert not list(tmp_path.glob("*" + TMP_SUFFIX))
    stats = pool.stats()
    assert stats["jobs_done"] == 2 and stats["bytes_written"] == 203
    pool.submit(str(tmp_path / "missing" / "d.bin"), b"1")
    pool.drain()
    with pytest.raises(RuntimeError, match="1 async write"):
        pool.raise_new_errors("test")
    pool.raise_new_errors("test")  # counted once
    pool.close()
    with NW.AsyncWriterPool(1, prefer_native=native) as one:
        for i in range(20):
            one.submit(str(tmp_path / "last.bin"), bytes([i]) * (i + 1))
    assert (tmp_path / "last.bin").read_bytes() == bytes([19]) * 20


def test_native_writer_builds_from_the_ports_own_source():
    lib = Path(NW.native_library()._name)
    assert lib.parent.name == "srtb_tpu_torch"
    assert lib.name.startswith("libfile_writer_")


def test_recover_orphan_temps(tmp_path):
    prefix = str(tmp_path / "out_")
    old = tmp_path / ("out_1.bin" + TMP_SUFFIX)
    fresh = tmp_path / ("out_2.bin" + TMP_SUFFIX)
    for p in (old, fresh):
        p.write_bytes(b"torn")
    past = time.time() - 3600
    os.utime(old, (past, past))
    assert recover_orphan_temps(prefix) == [str(old)]
    assert fresh.exists() and not old.exists()


def test_sink_failure_ends_the_run(tmp_path, monkeypatch):
    """A sink that raises on the sink thread ends the windowed run with
    its exception; a run, failed or not, leaves no thread behind."""
    argv, _nres = make_case(tmp_path)
    argv += ["--device", "cpu", "--baseband_output_file_prefix",
             f"{tmp_path}/out_"]
    before = termination.thread_snapshot()
    stats, _pipe = M.run(argv)
    assert stats.segments == 3
    assert termination.leaked_threads(before) == []

    def broken(self, work, has_signal):
        raise OSError("disk gone")

    monkeypatch.setattr(R.WriteSignalSink, "push", broken)
    with pytest.raises(OSError, match="disk gone"):
        M.run(argv + ["--writer_thread_count", "0"])
    assert termination.leaked_threads(before) == []


def test_write_all_sink_appends_in_order(tmp_path):
    """The write-all sink appends each segment minus its reserved tail,
    in push order, to one file that a second sink on the same prefix
    extends."""
    from srtb_tpu_torch.io.writers import WriteAllSink
    from srtb_tpu_torch.pipeline.work import (SegmentResultWork,
                                              SegmentWork)
    cfg = CASES["n16_ch32"][0].replace(
        baseband_output_file_prefix=f"{tmp_path}/out_")
    for first in (0, 5):
        sink = WriteAllSink(cfg, 4)
        for i in range(first, first + 5):
            data = np.full(10, i, dtype=np.uint8)
            sink.push(SegmentResultWork(segment=SegmentWork(data=data)))
        sink.drain()
        sink.close()
    got = (tmp_path / "out_stream0.bin").read_bytes()
    assert got == b"".join(bytes([i]) * 6 for i in range(10))


def test_blocked_cumsum_matches_a_float64_scan():
    """The card's prefix sum (``detect.blocked_cumsum``), run here on the
    CPU, within float32's rounding of a sequential scan: 2 t eps sum|x|
    (the bound ``test_torch_pipeline.py`` gives the boxcar series)."""
    from srtb_tpu_torch.ops import detect as D
    rng = np.random.default_rng(5)
    for t in (5, D.SCAN_BLOCK, 3 * D.SCAN_BLOCK + 17, 1 << 18):
        x = torch.from_numpy(rng.standard_normal((1, t)).astype(np.float32))
        got = D.blocked_cumsum(x)
        want = np.cumsum(x.numpy().astype(np.float64), axis=-1)
        assert got.shape == x.shape and got.dtype == torch.float32
        gate = 2 * t * 2.0 ** -24 * float(np.abs(x.numpy()).sum())
        assert np.abs(got.numpy() - want).max() <= gate


@pytest.mark.cuda
def test_cuda_detector_prefix_sum_is_deterministic():
    """On the card the detector's prefix sum gives the same bits on every
    call (a single-row torch.cumsum may not) and agrees with the CPU's
    blocked scan within float32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from srtb_tpu_torch.ops import detect as D
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 1 << 18)).astype(np.float32))
    xc = x.cuda()
    first = D.cumsum_last(xc)
    for _ in range(20):
        assert torch.equal(D.cumsum_last(xc), first)
    want = np.cumsum(x.numpy().astype(np.float64), axis=-1)
    gate = 2 * x.shape[-1] * 2.0 ** -24 * float(x.abs().sum())
    assert np.abs(first.cpu().numpy() - want).max() <= gate


def test_pipe_holds_no_finished_item():
    """Once the functor is done with an item, the pipe thread keeps no
    reference to it while it waits for the next one (a sink item owns a
    segment's waterfall: a stale reference would keep W + 1 on the
    card)."""
    import gc
    import weakref

    class Item:
        pass

    stop = fw.StopToken()
    q = fw.WorkQueue()
    done = threading.Event()
    pipe = fw.start_pipe(lambda _s, x: done.set(), q, None, stop)
    item = Item()
    ref = weakref.ref(item)
    q.push(item, stop)
    del item
    assert done.wait(5)
    deadline = time.monotonic() + 5
    while ref() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.01)
    assert ref() is None
    q.push(fw.SENTINEL, stop)
    assert pipe.join(5)


def test_window_under_thread_switching_matches_serial(tmp_path):
    """A window of 3 with the writer pool, run with the interpreter
    switching threads every few microseconds, writes what the serial leg
    writes, gives every segment buffer back and leaves no thread behind
    (the engine and the sink thread share the live count, the buffer
    pools, the staging registry and the statistics)."""
    import sys
    argv, _nres = make_case(tmp_path)
    data = Path(argv[argv.index("--input_file_path") + 1])
    long = tmp_path / "long.bin"
    long.write_bytes(data.read_bytes() * 4)
    argv[argv.index("--input_file_path") + 1] = str(long)
    out = {}
    before = termination.thread_snapshot()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for name, setting in (("serial", ("1", "0", "off")),
                              ("window", ("3", "2", "auto"))):
            d = tmp_path / name
            d.mkdir()
            stats, pipe = M.run(argv + [
                "--inflight_segments", setting[0], "--writer_thread_count",
                setting[1], "--ingest_ring", setting[2],
                "--baseband_output_file_prefix", f"{d}/out_",
                "--device", "cpu"])
            assert pipe.source.pool.stats()["in_use"] == 0
            out[name] = (stats.segments, stats.signals,
                         pipe.positive_segments,
                         {p.name: p.read_bytes() for p in d.iterdir()})
    finally:
        sys.setswitchinterval(switch)
    assert out["serial"][0] >= 10 and out["serial"][1] >= 1
    assert out["window"] == out["serial"]
    assert termination.leaked_threads(before) == []
