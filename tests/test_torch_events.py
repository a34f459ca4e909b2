"""The port's flight recorder (``srtb_tpu_torch/utils/events.py``)
against the JAX package's: the same scripted emits on named threads,
on a fake clock, through both hubs.  Each thread's shard wraps at the
ring size, the shards merge in time order, and the dump, a trace's own
dump and the ``dump_jsonl`` records must be equal; so must the
module-level hub's ambient context, ``configure`` keeping a live hub and
disarming.  Then the recorder's own contract: preallocated slots, no
growth per event, the shard bound, and thread safety."""

from __future__ import annotations

import json
import threading

import pytest

from srtb_tpu_torch.utils import events as E
from test_torch_ref import events_script, run_reference


def _ev(dt, etype, trace=0, stream="", seg=-1, dur=0.0, info=""):
    return (dt, etype, trace, stream, seg, dur, info)


# (ring size, groups of (thread name, events), the trace to filter)
SCRIPTS = {
    # one engine thread wrapping its ring, a sink thread between
    "wrap": (4, [
        ("MainThread", [_ev(0.01, "stage.ingest", 1, "", 0, 0.002),
                        _ev(0.01, "ring.cold", 1, "", 0),
                        _ev(0.01, "stage.dispatch", 1, "", 0, 0.004),
                        _ev(0.01, "stage.ingest", 2, "", 1, 0.002),
                        _ev(0.01, "stage.dispatch", 2, "", 1, 0.003),
                        _ev(0.01, "stage.fetch", 1, "", 0, 0.0005)]),
        ("sink_drain", [_ev(0.02, "stage.sink", 1, "", 0, 0.01, "dump"),
                        _ev(0.01, "manifest.intent", 1, "", 0, 0,
                            "0:WriteSignalSink:a.bin")]),
        ("MainThread", [_ev(0.01, "stage.fetch", 2, "", 1, 0.0007),
                        _ev(0.01, "ring.invalidate", 2)]),
    ], 1),
    # two streams' events interleaved in time across three threads
    "interleave": (16, [
        ("rx0", [_ev(0.5, "retry", 3, "beam0", -1, 0, "ingest:transient:1")]),
        ("rx1", [_ev(0.1, "fault.injected", 4, "beam1", 2, 0,
                     "dispatch:oom@2")]),
        ("rx0", [_ev(0.1, "heal.demote", 4, "beam1", -1, 0,
                     "fused_tail@1 (oom)"),
                 _ev(0.0, "degrade", 0, "beam0", -1, 0,
                     "full->shed_waterfall")]),
    ], 4),
    "empty": (2, [], 9),
}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jobs = [{"key": name, "fn": "test_torch_ref:events_script",
             "args": ["srtb_tpu", size, groups, trace]}
            for name, (size, groups, trace) in SCRIPTS.items()]
    return run_reference(jobs, tmp_path_factory.mktemp("ref_events"))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_flight_recorder_equals_reference(ref, name):
    """The merged dump, the trace filter and the JSONL file hold the
    reference's records (the fake clock makes ``t`` and ``ts`` equal
    too); the module's hub keeps, attributes and disarms alike."""
    size, groups, trace = SCRIPTS[name]
    got = events_script("srtb_tpu_torch", size, groups, trace)
    for key in ("dump", "trace", "jsonl", "current", "module"):
        assert got[key].tolist() == ref[f"{name}/{key}"].tolist(), key
    for key in ("jsonl_count", "kept", "disarmed"):
        assert got[key] == ref[f"{name}/{key}"].item(), key


def test_ring_wraps_per_thread_and_merges_in_time_order():
    """A thread keeps its last ``ring_size`` events whatever the others
    emit, and the dump is oldest first across threads."""
    got = events_script("srtb_tpu_torch", *SCRIPTS["wrap"])
    recs = [json.loads(line) for line in got["dump"]]
    by_thread = {}
    for r in recs:
        by_thread.setdefault(r["thread"], []).append(r["type"])
    # the first MainThread shard kept the last 4 of its 6 events
    assert [r["t"] for r in recs] == sorted(r["t"] for r in recs)
    assert sum(r["thread"] == "MainThread" for r in recs) == 6
    assert "stage.ingest" not in [r["type"] for r in recs
                                  if r["trace"] == 1]
    assert [r["type"] for r in recs if r["trace"] == 1] == [
        "stage.dispatch", "stage.fetch", "stage.sink", "manifest.intent"]
    assert by_thread["sink_drain"] == ["stage.sink", "manifest.intent"]


def test_slots_are_preallocated_and_shards_bounded():
    """An emit overwrites a preallocated slot (the shard never grows), and
    dead threads' shards are evicted past ``MAX_SHARDS``."""
    hub = E.EventHub(ring_size=3)
    for i in range(10):
        hub.emit("retry", trace=i)
    (shard,) = hub._shards
    assert len(shard.slots) == 3 and shard.i == 10
    assert [e["trace"] for e in hub.dump()] == [7, 8, 9]
    for _ in range(E.MAX_SHARDS + 5):
        t = threading.Thread(target=lambda: hub.emit("stage.sink"))
        t.start()
        t.join()
    assert len(hub._shards) <= E.MAX_SHARDS
    with pytest.raises(ValueError):
        E.EventHub(ring_size=0)


def test_concurrent_emitters_lose_nothing_within_their_rings():
    """Eight threads emitting at once each keep their own ring whole."""
    hub = E.EventHub(ring_size=64)
    barrier = threading.Barrier(8)

    def work(k):
        barrier.wait()
        for i in range(50):
            hub.emit("stage.fetch", trace=k, seg=i)
    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dump = hub.dump()
    assert len(dump) == 8 * 50
    for k in range(8):
        assert [e["seg"] for e in hub.dump(trace=k)] == list(range(50))


def test_trace_ids_are_unique_and_the_off_path_is_one_check():
    """``next_trace_id`` never repeats; with the recorder disarmed,
    ``emit`` returns at once."""
    ids = {E.next_trace_id() for _ in range(100)}
    assert len(ids) == 100
    saved = E.hub
    try:
        E.configure(False)
        E.emit("retry")
        assert E.hub is None
        E.configure(True, ring_size=5)
        assert E.hub.ring_size == 5
    finally:
        E.hub = saved
