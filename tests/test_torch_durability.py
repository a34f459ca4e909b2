"""Durable exactly-once outputs in the port: the run manifest, the
checkpoint, recovery, ``fsck`` and the crash windows, against the JAX
package.

Format parity both ways: the record CRC and encoding, the WAL a run
writes and its checkpoint file, and each package's ``fsck`` on the
other's run directory.  Recovery: seven hand-built crash states (a torn
tail, a forged CRC mid-WAL, an uncommitted intent, a torn append, an
append gap, a missing group below the checkpoint, the checkpoint floor
hint), each recovered by both packages on copies of one directory: the
same report and the same files left.  Then the crash windows of the
reference's tests/test_durability.py in process, through the port's
``fault_plan`` and the writers' pre-rename hook (one inside a
micro-batch), each resumed to the golden output set; and the SIGKILL
soak (``tools/crash_soak.py``) at 2^12 with two kills, at B = 1 and
inside a batch at B = 2."""

import json
import os
import shutil
import zlib

import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import manifest as MF
from srtb_tpu_torch.io import native_writer as NW
from srtb_tpu_torch.io import writers
from srtb_tpu_torch.io.synth import make_dispersed_baseband
from srtb_tpu_torch.pipeline.checkpoint import StreamCheckpoint
from srtb_tpu_torch.pipeline.runtime import Pipeline
from srtb_tpu_torch.resilience import errors as E
from srtb_tpu_torch.resilience.faults import (FaultInjector, InjectedFatal,
                                              parse_plan)
from srtb_tpu_torch.tools import crash_soak as CS
from srtb_tpu_torch.tools import fsck as FS
from srtb_tpu_torch.tools import main as M
from test_torch_pipeline import make_case
from test_torch_ref import run_reference

RECORDS = [
    {"t": "run", "ts": 1792249650.5, "resume": False},
    {"t": "intent", "path": "out_1.bin", "mode": "atomic", "stream": 0,
     "seg": 0, "sink": "0:WriteSignalSink"},
    {"t": "commit", "path": "out_1.bin", "len": 4096, "crc32": 123456789,
     "stream": 0, "seg": 0, "sink": "0:WriteSignalSink"},
    {"t": "intent", "path": "out_stream0.bin", "mode": "append",
     "off": 8192, "stream": 1, "seg": 7, "sink": "0:WriteAllSink"},
    {"t": "done", "stream": 0, "seg": 0, "sink": "0:WriteSignalSink"},
    {"t": "ckpt", "segments_done": 3, "offset": 46688},
    {"t": "commit", "path": "ü/ñ.npy", "len": 0, "stream": 2, "seg": 1,
     "sink": "0:X"},
]


# ------------------------------------------------------- recovery states

def _write(path, payload):
    with open(path, "wb") as f:
        f.write(payload)
    return payload


def _commit(m, key, path, payload):
    m.intent(key, path)
    _write(path, payload)
    m.commit(key, path, len(payload), zlib.crc32(payload))


def _base_run(d):
    """Two committed, checkpointed segments with two artifacts each; the
    manifest and the checkpoint path."""
    mpath = os.path.join(d, "manifest.jsonl")
    m = MF.RunManifest.open(mpath)
    ck = StreamCheckpoint(os.path.join(d, "ck.json"), manifest=m)
    for seg in (0, 1):
        key = (0, seg, "0:WriteSignalSink")
        for ext in (".bin", ".0.npy"):
            _commit(m, key, os.path.join(d, f"out_{seg}{ext}"),
                    bytes([seg + 1]) * (64 + seg))
        m.sink_done(key)
        ck.update(seg + 1, 1000 * (seg + 1))
    return m, mpath


def state_torn_tail(d):
    m, mpath = _base_run(d)
    m.close()
    _write_append(mpath, b'{"t":"done","half-writ')
    return 0


def _write_append(path, payload):
    with open(path, "ab") as f:
        f.write(payload)


def state_forged_crc(d):
    m, mpath = _base_run(d)
    key = (0, 2, "0:WriteSignalSink")
    _commit(m, key, os.path.join(d, "out_2.bin"), b"late" * 20)
    m.sink_done(key)
    m.close()
    with open(mpath, "rb+") as f:
        data = f.read()
        i = data.index(b'"commit"')  # segment 0's first commit
        f.seek(i)
        f.write(b'"cOmmit"')
    return 0


def state_uncommitted_intent(d):
    m, _mpath = _base_run(d)
    key = (0, 2, "0:WriteSignalSink")
    path = os.path.join(d, "out_2.bin")
    m.intent(key, path)
    _write(path + MF.TMP_SUFFIX, b"half")
    _commit(m, key, os.path.join(d, "out_2.0.npy"), b"npy" * 10)
    _write(os.path.join(d, "out_3.bin"), b"renamed, not committed")
    m.intent((0, 3, "0:WriteSignalSink"), os.path.join(d, "out_3.bin"))
    m.close()
    return 0


def _append_run(d):
    mpath = os.path.join(d, "manifest.jsonl")
    m = MF.RunManifest.open(mpath)
    ck = StreamCheckpoint(os.path.join(d, "ck.json"), manifest=m)
    path = os.path.join(d, "out_stream0.bin")
    off = 0
    for seg in (0, 1):
        key = (0, seg, "0:WriteAllSink")
        chunk = bytes([seg + 7]) * 100
        m.intent(key, path, mode="append", offset=off)
        _write_append(path, chunk)
        m.commit(key, path, len(chunk), zlib.crc32(chunk), offset=off)
        m.sink_done(key)
        ck.update(seg + 1, 1000 * (seg + 1))
        off += len(chunk)
    return m, path, off


def state_torn_append(d):
    m, path, off = _append_run(d)
    m.intent((0, 2, "0:WriteAllSink"), path, mode="append", offset=off)
    _write_append(path, b"torn" * 9)
    m.close()
    return 0


def state_append_gap(d):
    m, path, off = _append_run(d)
    m.close()
    with open(path, "rb+") as f:
        f.truncate(off - 30)  # the file lost part of segment 1's bytes
    return 0


def state_missing_below_checkpoint(d):
    m, _mpath = _base_run(d)
    m.close()
    os.unlink(os.path.join(d, "out_0.0.npy"))
    return 0


def state_floor_hint(d):
    """A WAL that lost segment 1's records and the second ckpt record to
    corruption, then logged a fresh intent for segment 1: the checkpoint
    file's count (the hint, 2) keeps recovery from rolling segment 1's
    published artifacts back; it flags them instead."""
    m, mpath = _base_run(d)
    m.close()
    with open(mpath, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    with open(mpath, "wb") as f:
        f.write(b"".join(ln for ln in lines if b'"seg":1' not in ln
                         and b'"segments_done":2' not in ln))
    m = MF.RunManifest(mpath)
    m.intent((0, 1, "0:WriteSignalSink"), os.path.join(d, "out_1.bin"))
    m.close()
    return 2


RECOVERY_STATES = {name[len("state_"):]: fn for name, fn in globals().items()
                   if name.startswith("state_")}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's side of every comparison, in one subprocess: the
    record encodings, the recovery of each state's copy, the WAL and
    checkpoint of a run of ``srtb-main`` (and its fsck of the port's run
    of the same), with and without content hashes."""
    tmp = tmp_path_factory.mktemp("durability_ref")
    jobs = [{"key": "records", "fn": "test_torch_ref:manifest_records",
             "args": [RECORDS]}]
    states = {}
    for name, make in RECOVERY_STATES.items():
        d = tmp / "states" / name
        d.mkdir(parents=True)
        hint = make(str(d))
        states[name] = (d, hint)
        ref_d = tmp / "states_ref" / name
        shutil.copytree(d, ref_d)
        jobs.append({"key": f"recover/{name}",
                     "fn": "test_torch_ref:recover_dir",
                     "args": [str(ref_d / "manifest.jsonl"), hint]})
    argv, _nres = make_case(tmp)
    runs = {}
    for hashed in ("0", "1"):
        for who in ("port", "ref"):
            d = tmp / f"run_{who}_{hashed}"
            d.mkdir()
            runs[who, hashed] = d
        extra = ["--writer_thread_count", "0", "--manifest_hash", hashed]
        jobs.append({"key": f"run/{hashed}",
                     "fn": "test_torch_ref:pipeline_main",
                     "args": [argv + extra + _durable(runs["ref", hashed]),
                              str(runs["ref", hashed])]})
        M.run(argv + extra + _durable(runs["port", hashed])
              + ["--device", "cpu"])
        jobs.append({"key": f"fsck_port/{hashed}",
                     "fn": "test_torch_ref:fsck_dir",
                     "args": [str(runs["port", hashed] / "manifest.jsonl"),
                              str(runs["port", hashed] / "ck.json")]})
    out = run_reference(jobs, tmp)
    return {"ref": out, "states": states, "runs": runs}


def _durable(d):
    return ["--baseband_output_file_prefix", f"{d}/out_",
            "--checkpoint_path", str(d / "ck.json"),
            "--run_manifest_path", str(d / "manifest.jsonl")]


def test_record_crc_and_encoding_match_reference(ref):
    """The canonical JSON and its CRC32, byte for byte."""
    r = ref["ref"]
    assert [MF.record_crc(rec) for rec in RECORDS] == \
        r["records/crc"].tolist()
    assert [MF.encode_record(rec).decode() for rec in RECORDS] == \
        r["records/encoded"].tolist()
    for line in r["records/encoded"].tolist():
        rec = MF.decode_record(line.encode())
        assert rec is not None and MF.encode_record(rec).decode() == line


@pytest.mark.parametrize("name", sorted(RECOVERY_STATES))
def test_recovery_matches_reference(ref, name):
    """Each crash state recovered by both packages on copies of one
    directory: the same report (done set, last checkpoint, truncated
    bytes, rollbacks, loss flags, recovered segments) and the same files
    left, byte for byte."""
    d, hint = ref["states"][name]
    rep = MF.recover(str(d / "manifest.jsonl"), apply=True,
                     checkpoint_floor_hint=hint)
    got = {"done": sorted(list(k) for k in rep.done),
           "last_checkpoint": rep.last_checkpoint,
           "truncated_bytes": rep.truncated_bytes,
           "rolled_back": [a.replace(str(d) + os.sep, "")
                           for a in rep.rolled_back],
           "rolled_back_intents": rep.rolled_back_intents,
           "missing": [m.replace(str(d) + os.sep, "") for m in rep.missing],
           "recovered_segments": rep.recovered_segments}
    want = json.loads(str(ref["ref"][f"recover/{name}/report"]))
    assert json.loads(json.dumps(got)) == want
    files = {n: (d / n).read_bytes().hex() for n in sorted(os.listdir(d))}
    assert files == json.loads(str(ref["ref"][f"recover/{name}/files"]))
    # each state exercises its rule
    expect = {"torn_tail": rep.truncated_bytes > 0,
              "forged_crc": rep.truncated_bytes > 0 and not rep.done,
              "uncommitted_intent": rep.rolled_back_intents >= 2,
              "torn_append": any("truncate" in a for a in rep.rolled_back),
              "append_gap": bool(rep.missing),
              "missing_below_checkpoint": bool(rep.missing),
              "floor_hint": bool(rep.missing)
              and os.path.exists(d / "out_1.bin")}
    assert expect[name], rep


def _records(d):
    out = []
    for line in (d / "manifest.jsonl").read_bytes().splitlines():
        rec = MF.decode_record(line)
        assert rec is not None
        if rec["t"] == "run":
            rec.pop("ts")
        out.append(rec)
    return out


def test_wal_and_checkpoint_match_reference(ref):
    """A run of ``srtb-torch-main`` and of ``srtb-main`` on the same
    arguments at ``writer_thread_count = 0`` (a fixed record order) write
    the same WAL records but the run record's ``ts`` (without content
    hashes: the waterfall's float bits differ between the packages) and
    the same checkpoint file, byte for byte; with hashes, the ``.bin``
    commits' CRCs are the same and every CRC is its file's."""
    runs = ref["runs"]
    assert _records(runs["port", "0"]) == _records(runs["ref", "0"])
    for hashed in ("0", "1"):
        assert (runs["port", hashed] / "ck.json").read_bytes() == \
            (runs["ref", hashed] / "ck.json").read_bytes()
    port, refr = _records(runs["port", "1"]), _records(runs["ref", "1"])
    assert [r["t"] for r in port] == [r["t"] for r in refr]
    for d, recs in ((runs["port", "1"], port), (runs["ref", "1"], refr)):
        for rec in recs:
            if rec["t"] == "commit":
                payload = (d / rec["path"]).read_bytes()
                assert rec["crc32"] == zlib.crc32(payload)
    bins = [(p["path"], p["crc32"], q["crc32"]) for p, q in zip(port, refr)
            if p["t"] == "commit" and p["path"].endswith(".bin")]
    assert bins and all(a == b for _p, a, b in bins)


@pytest.mark.parametrize("hashed", ["0", "1"])
def test_each_fsck_passes_the_others_run(ref, hashed):
    """The reference's fsck reports the port's run directory clean, and
    the port's fsck the reference's."""
    runs = ref["runs"]
    rep = json.loads(str(ref["ref"][f"fsck_port/{hashed}/report"]))
    assert rep["clean"] and rep["records"] > 3, rep
    d = runs["ref", hashed]
    rep = FS.fsck(str(d / "manifest.jsonl"), str(d / "ck.json"))
    assert rep["clean"] and rep["complete_groups"] >= 1, rep
    assert FS.main([str(d / "manifest.jsonl"), "--checkpoint",
                    str(d / "ck.json")]) == FS.EXIT_CLEAN


# ----------------------------------------------------- the crash windows

N = 1 << 12
SEGMENTS = 4


def _cfg(tmp, tag, **kw):
    run_dir = tmp / tag
    run_dir.mkdir(exist_ok=True)
    fields = dict(
        baseband_input_count=N, baseband_input_bits=8,
        baseband_freq_low=1405.0, baseband_bandwidth=64.0,
        baseband_sample_rate=128e6, dm=0.05,
        input_file_path=str(tmp / "bb.bin"),
        baseband_output_file_prefix=str(run_dir / "out_"),
        spectrum_channel_count=1 << 4,
        mitigate_rfi_average_method_threshold=1000.0,
        mitigate_rfi_spectral_kurtosis_threshold=50.0,
        # below the noise floor: every segment writes
        signal_detect_signal_noise_threshold=2.0,
        signal_detect_max_boxcar_length=8,
        baseband_reserve_sample=False, writer_thread_count=0,
        inflight_segments=1, retry_max_attempts=1,
        deterministic_timestamps=True,
        checkpoint_path=str(run_dir / "ck.json"),
        run_manifest_path=str(run_dir / "manifest.jsonl"))
    fields.update(kw)
    return Config(**fields)


def _complete(cfg):
    with Pipeline(cfg, device="cpu") as pipe:
        stats = pipe.run()
    return stats, stats.extras["manifest"]


def _dies(cfg, expect=InjectedFatal):
    with pytest.raises(expect):
        with Pipeline(cfg, device="cpu") as pipe:
            pipe.run()


def _outputs(cfg):
    return CS.snapshot_outputs(os.path.dirname(
        cfg.baseband_output_file_prefix))


@pytest.fixture(scope="module")
def crash_env(tmp_path_factory):
    """The input (a pulse in every segment) and the golden output set of
    one uninterrupted run."""
    tmp = tmp_path_factory.mktemp("crash")
    make_dispersed_baseband(
        N * SEGMENTS, 1405.0, 64.0, 0.05,
        [N // 2 + i * N for i in range(SEGMENTS)], nbits=8, pulse_amp=30.0,
        generator=torch.Generator().manual_seed(0)).numpy().tofile(
            tmp / "bb.bin")
    cfg = _cfg(tmp, "golden")
    stats, _counts = _complete(cfg)
    golden = _outputs(cfg)
    assert stats.signals == SEGMENTS and len(golden) > SEGMENTS
    golden_all = _outputs(_complete_cfg(tmp, "golden_all",
                                        baseband_write_all=True))
    assert any(k.startswith("out_stream") for k in golden_all)
    return tmp, golden, golden_all


def _complete_cfg(tmp, tag, **kw):
    cfg = _cfg(tmp, tag, **kw)
    _complete(cfg)
    return cfg


def test_crash_between_sink_commit_and_checkpoint(crash_env):
    """The duplicate window: segment 1's artifacts committed, its
    checkpoint not.  The resume skips the committed push and the output
    set is the golden one."""
    tmp, golden, _ = crash_env
    cfg = _cfg(tmp, "crash_a", fault_plan="checkpoint:fatal@1")
    _dies(cfg)
    _stats, counts = _complete(cfg.replace(fault_plan=""))
    assert counts["replayed_skips"] >= 1
    assert counts["recovered_segments"] >= 1
    assert _outputs(cfg) == golden


def test_crash_during_checkpoint_flush(crash_env):
    """The manifest's ckpt record lands, then the run dies in the state
    file's flush (a torn temp, no rename): the resume repeats one segment,
    idempotently."""
    tmp, golden, _ = crash_env
    cfg = _cfg(tmp, "crash_b")

    class Boom(RuntimeError):
        pass

    with pytest.raises(Boom):
        with Pipeline(cfg, device="cpu") as pipe:
            real_update = pipe.checkpoint.update
            calls = [0]

            def dying_update(segments_done, offset):
                calls[0] += 1
                if calls[0] == 2:
                    pipe.checkpoint.manifest.checkpoint(segments_done,
                                                        offset)
                    with open(pipe.checkpoint.path + ".tmp", "w") as f:
                        f.write('{"segments_done":')
                    raise Boom("death inside the checkpoint's flush")
                return real_update(segments_done, offset)

            pipe.checkpoint.update = dying_update
            pipe.run()
    _stats, counts = _complete(cfg)
    assert counts["replayed_skips"] >= 1
    assert _outputs(cfg) == golden


def test_crash_mid_sink_write_rolls_back(crash_env):
    """Death between a temp write and its rename (the pre-rename hook):
    recovery removes the orphan and the uncommitted intent, the resume
    writes the artifact once."""
    tmp, golden, _ = crash_env
    cfg = _cfg(tmp, "crash_c")

    class Dead(BaseException):
        """Not an Exception: nothing may handle the simulated kill."""

    count = [0]

    def hook(path):
        count[0] += 1
        if count[0] == 3:
            raise Dead(path)

    writers._PRE_RENAME_HOOK = hook
    try:
        _dies(cfg, Dead)
    finally:
        writers._PRE_RENAME_HOOK = None
    _stats, counts = _complete(cfg)
    assert counts["rolled_back_intents"] >= 1
    assert _outputs(cfg) == golden


@pytest.mark.parametrize("site,seg", [("checkpoint", 2), ("sink_write", 0),
                                      ("dispatch", 3), ("fetch", 1)])
def test_crash_replay_any_prefix(crash_env, site, seg):
    """A crash at any site and segment (the reference's seeded property,
    its four sites each once), resumed: the golden output set."""
    tmp, golden, _ = crash_env
    cfg = _cfg(tmp, f"prop_{site}", fault_plan=f"{site}:fatal@{seg}")
    _dies(cfg)
    _complete(cfg.replace(fault_plan=""))
    assert _outputs(cfg) == golden


def test_write_all_exactly_once_across_crash(crash_env):
    """The in-place appender: a crash between an append's commit and the
    checkpoint does not append twice on resume."""
    tmp, _golden, golden_all = crash_env
    cfg = _cfg(tmp, "crash_w", baseband_write_all=True,
               fault_plan="checkpoint:fatal@2")
    _dies(cfg)
    _stats, counts = _complete(cfg.replace(fault_plan=""))
    assert counts["replayed_skips"] >= 1
    assert _outputs(cfg) == golden_all


@pytest.mark.parametrize("window", [2, 4])
def test_crash_inside_a_micro_batch(crash_env, window):
    """B = 2: the run dies at segment 2's checkpoint, segment 3 dispatched
    in the same batch but not drained; the resume starts at segment 2 (its
    push skipped) and ends with the golden output set."""
    tmp, golden, _ = crash_env
    cfg = _cfg(tmp, f"crash_batch_{window}", micro_batch_segments=2,
               inflight_segments=window, fault_plan="checkpoint:fatal@2")
    _dies(cfg)
    with open(cfg.checkpoint_path) as f:
        assert json.load(f)["segments_done"] == 2
    stats, counts = _complete(cfg.replace(fault_plan=""))
    assert stats.segments == 2 and counts["replayed_skips"] == 1
    assert _outputs(cfg) == golden


def test_fsck_clean_run_and_corruptions(crash_env, tmp_path):
    """fsck on a finished run: clean; a deleted committed artifact and a
    checkpoint ahead of the manifest fail it, ``--repair`` heals the
    latter; a missing manifest is unverifiable.  Its selftest is sharp."""
    tmp, _golden, _ = crash_env
    cfg = _complete_cfg(tmp, "fsck_run")
    mpath, ckpath = cfg.run_manifest_path, cfg.checkpoint_path
    assert FS.fsck(mpath, ckpath)["clean"]
    assert FS.main([mpath, "--checkpoint", ckpath]) == FS.EXIT_CLEAN
    run_dir = os.path.dirname(mpath)
    victim = next(os.path.join(run_dir, f) for f in sorted(os.listdir(
        run_dir)) if f.endswith(".bin"))
    os.rename(victim, victim + ".hidden")
    assert FS.main([mpath, "--checkpoint", ckpath]) == FS.EXIT_ERRORS
    os.rename(victim + ".hidden", victim)
    StreamCheckpoint(ckpath).update(10 ** 6, 10 ** 9)
    assert FS.main([mpath, "--checkpoint", ckpath]) == FS.EXIT_ERRORS
    assert FS.main([mpath, "--checkpoint", ckpath, "--repair"]) \
        == FS.EXIT_CLEAN
    assert FS.main([mpath, "--checkpoint", ckpath]) == FS.EXIT_CLEAN
    assert FS.main([str(tmp_path / "nope.jsonl")]) == FS.EXIT_UNVERIFIABLE
    assert FS.selftest() == []
    assert FS.main(["--selftest"]) == FS.EXIT_CLEAN


def test_fsck_repair_truncates_torn_wal(crash_env):
    tmp, _golden, _ = crash_env
    cfg = _complete_cfg(tmp, "fsck_torn")
    mpath = cfg.run_manifest_path
    good = os.path.getsize(mpath)
    with open(mpath, "ab") as f:
        f.write(b'{"t":"commit","pa')
    assert FS.main([mpath]) == FS.EXIT_ERRORS
    assert FS.main([mpath, "--repair"]) == FS.EXIT_CLEAN
    assert os.path.getsize(mpath) == good


def test_checkpoint_generations_and_legacy_form(tmp_path):
    """A corrupt primary falls back to ``.bak``; both dead restart from
    0; an orphan ``.tmp`` is swept; a file without a CRC (the legacy
    form) loads."""
    path = str(tmp_path / "ck.json")
    ck = StreamCheckpoint(path)
    ck.update(1, 100)
    ck.update(2, 200)
    with open(path, "w") as f:
        f.write('{"segments_done": 9, "file_offset_bytes": 9, "crc": 1}')
    _write(path + ".tmp", b"{")
    ck = StreamCheckpoint(path)
    assert (ck.segments_done, ck.file_offset_bytes) == (1, 100)
    assert not os.path.exists(path + ".tmp")
    _write(path + ".bak", b"garbage")
    assert StreamCheckpoint(path).segments_done == 0
    with open(path, "w") as f:
        json.dump({"segments_done": 5, "file_offset_bytes": 50}, f)
    assert StreamCheckpoint(path).file_offset_bytes == 50


def test_native_pool_commits_only_written_jobs(tmp_path):
    """The native pool fires a job's commit only once its bytes reached
    the filesystem: a failed job's never, a later clean one's normally;
    the publish barrier runs at submit."""
    pool = NW.AsyncWriterPool(2)
    assert pool.is_native
    fired = []
    pool.submit(str(tmp_path / "good.bin"), b"payload!",
                on_done=lambda: fired.append("good"))
    pool.submit(str(tmp_path / "no_dir" / "bad.bin"), b"payload!",
                on_done=lambda: fired.append("bad"))
    pool.drain()
    assert fired == ["good"]
    with pytest.raises(RuntimeError):
        pool.raise_new_errors("test")
    pool.submit(str(tmp_path / "good2.bin"), b"x",
                on_done=lambda: fired.append("good2"),
                pre_publish=lambda: fired.append("barrier"))
    pool.drain()
    assert fired == ["good", "barrier", "good2"]
    assert (tmp_path / "good.bin").read_bytes() == b"payload!"
    pool.close()


@pytest.mark.parametrize("plan,allowed", [
    ("checkpoint:stall=0.01@0,sink_write:fatal@3", True),
    ("dispatch:oom@1", False), ("ingest:raise@0", False),
    ("fetch:corrupt@2", False), ("h2d:compile_fail@0", False),
    ("dispatch:device_halt@0", False)])
def test_fault_plan_actions(plan, allowed):
    """Every action is injected (the plan no longer depends on
    ``retry_max_attempts``): stall and fatal (``allowed``: the actions the
    durability tests steer their crash windows with) stall or end the
    run; the others raise what the retry layer (transient, data loss) or
    the demotion ladder (device) recovers."""
    inj = FaultInjector.from_plan(plan)
    if allowed:
        assert inj.armed("checkpoint") and inj.armed("sink_write")
        inj.fire("checkpoint", 0)
        with pytest.raises(InjectedFatal):
            inj.fire("sink_write", 3)
        assert inj.unfired() == []
    else:
        spec = parse_plan(plan)[0]
        with pytest.raises(Exception) as info:
            inj.fire(spec.site, spec.index)
        assert inj.unfired() == []
        assert E.classify(info.value) == {
            "raise": E.TRANSIENT, "corrupt": E.DATA_LOSS}.get(
                spec.action, E.DEVICE)
    with pytest.raises(ValueError):
        FaultInjector.from_plan("nowhere:fatal@1")


# ------------------------------------------------------- the SIGKILL soak

@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    """A SIGKILL soak at 2^12 (six segments' worth of input, every
    segment positive) with the kill plan ``ckpt_stall@1,rename@1`` at
    B = 1, then ``ckpt_stall@2`` at B = 2 on the same input against the
    same golden run."""
    tmp = tmp_path_factory.mktemp("soak")
    one = CS.run_soak(segments=6, log2n=12, kill_plan="ckpt_stall@1,"
                      "rename@1", device="cpu", tmpdir=str(tmp / "b1"))
    two = CS.run_soak(log2n=12, kill_plan="ckpt_stall@2", micro_batch=2,
                      device="cpu", tmpdir=str(tmp / "b2"),
                      input_path=str(tmp / "b1" / "bb.bin"),
                      golden=one["golden"])
    return one, two


@pytest.mark.parametrize("which", [0, 1])
def test_sigkill_soak(soak, which):
    """Every planned kill landed, the resumes end fsck-clean with the
    golden output set (the soak's gate), and the windows did their work:
    a replayed skip after the checkpoint kill, a rollback after the
    rename kill."""
    rep = soak[which]
    assert rep["ok"] and rep["sigkills"] == len(rep["plan"])
    assert rep["artifacts"] > 6
    assert rep["replayed_skips"] >= 1
    if which == 0:
        assert rep["rolled_back_intents"] >= 1
    assert [c["killed"] for c in rep["children"] if c["kind"] != "golden"] \
        == [True] * rep["sigkills"] + [False]


def _wal(path, records) -> str:
    with open(path, "wb") as f:
        for rec in records:
            f.write(MF.encode_record(rec))
    return str(path)


def test_soak_expects_a_replay_only_of_a_group_a_resume_finds_sealed(
        tmp_path):
    """The soak's gate demands a replayed skip after a kill only for a
    group at or past the checkpoint floor that the resume finds complete:
    its done marker, every intent committed and every file on disk.  A
    first life commits ``a`` of a segment's ``a`` and ``b`` and is killed;
    the next life rolls the group back (``a`` unlinked), writes both
    again, commits ``b`` and is killed before ``a``'s rename: the merged
    scan reads the group complete, the resume does not."""
    def art(t, path):
        rec = {"t": t, "stream": 0, "seg": 1, "sink": "0:W", "path": path}
        return dict(rec, len=1) if t == "commit" else rec
    done = {"t": "done", "stream": 0, "seg": 1, "sink": "0:W"}
    wal = [{"t": "run"}, art("intent", "a"), art("intent", "b"),
           art("commit", "a"), done, {"t": "run"}, art("intent", "a"),
           art("intent", "b"), done, art("commit", "b")]
    path = _wal(tmp_path / "m.jsonl", wal)
    (tmp_path / "b").write_bytes(b"b")
    assert MF.group_complete(MF.scan_manifest(path).groups[0, 1, "0:W"])
    assert not CS._sealed_beyond_floor(path)
    (tmp_path / "a").write_bytes(b"a")
    assert CS._sealed_beyond_floor(path)
    below = _wal(tmp_path / "f.jsonl", wal + [{"t": "ckpt",
                                               "segments_done": 2}])
    assert not CS._sealed_beyond_floor(below)
    assert not CS._sealed_beyond_floor(str(tmp_path / "none.jsonl"))


def test_sigkill_soak_with_the_writer_pool(tmp_path):
    """The checkpoint kill and the rename kill at B = 1 with a writer pool
    of two threads (the card's durability cfg): every kill lands, the
    resume ends fsck-clean with the golden output set, and the rename
    kill's intents are rolled back."""
    rep = CS.run_soak(segments=4, log2n=12, kill_plan="ckpt_stall@1,"
                      "rename@1", writer_threads=2, device="cpu",
                      tmpdir=str(tmp_path))
    assert rep["ok"] and rep["sigkills"] == 2
    assert rep["rolled_back_intents"] >= 1
