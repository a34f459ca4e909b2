"""The port's self-healing engine against the JAX package's (ROADMAP A7):
the same input and fault plan through both packages' ``Pipeline`` — the
plan-demotion ladder, the device reinit and its budget, the promotion
probe, the micro-batch rung, the retries at the six sites, the supervised
sink, a checkpoint resume after a demotion, both ladders at once — with
the same artifacts, exact decisions, counters equal to the reference's,
the same rung sequence, and each segment's time series within the gates
of ``tests/test_torch_segment.py``.  Then the port's own properties: a
clean run with the ladder armed is bit-identical to one with it off, the
watchdog requeues a wedged segment (and a requeue that faults demotes),
a retired processor refuses a stray dispatch, and the chaos soak's gate
passes and is sharp."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io.file_input import make_file_source
from srtb_tpu_torch.kernels.build import KernelBuildError, KernelLaunchError
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.pipeline.runtime import Fetched, Pipeline
from srtb_tpu_torch.resilience import errors as E
from srtb_tpu_torch.tools import chaos_soak as CS
from srtb_tpu_torch.utils.metrics import metrics
from test_torch_ref import CaptureSink, resilience_run, run_reference
from test_torch_resilience import engine_fields, write_pulsed_input

SIX = ("ingest", "h2d", "dispatch", "fetch", "sink_write", "checkpoint")
# (overrides, capture, max_segments); every run at a window of 2
SCENARIOS = {
    "clean_off": (dict(plan_ladder="off", device_reinit_max=0), True, None),
    "clean_armed": (dict(promote_after_segments=2), True, None),
    "oom_dispatch": (dict(fault_plan="dispatch:oom@1"), True, None),
    "compile_fetch": (dict(fault_plan="fetch:compile_fail@2"), True, None),
    "halt_dispatch": (dict(fault_plan="dispatch:device_halt@2"), True,
                      None),
    "reinit_budget": (dict(fault_plan="dispatch:device_halt@1,"
                           "fetch:device_halt@2", device_reinit_max=1),
                      True, None),
    "ladder_exhausted": (dict(plan_ladder="monolithic",
                              fault_plan="dispatch:oom@1,dispatch:oom@2"),
                         True, None),
    "healing_off": (dict(plan_ladder="off", device_reinit_max=0,
                         fault_plan="dispatch:oom@1"), True, None),
    "promotion": (dict(fault_plan="dispatch:oom@1",
                       promote_after_segments=1), True, None),
    "micro_batch": (dict(micro_batch_segments=2,
                         fault_plan="dispatch:oom@2"), True, None),
    "micro_batch_promote": (dict(micro_batch_segments=2,
                                 promote_after_segments=1,
                                 fault_plan="dispatch:oom@0"), True, None),
    "raise_sites": (dict(checkpoint_path="ck.json", fault_plan=",".join(
        f"{s}:raise@{i + 1}" for i, s in enumerate(SIX))), True, None),
    "corrupt_sites": (dict(checkpoint_path="ck.json", fault_plan=",".join(
        f"{s}:corrupt@{i}" for i, s in enumerate(SIX))), True, None),
    "ckpt_clean": (dict(checkpoint_path="ck.json"), True, 2),
    "ckpt_demoted": (dict(checkpoint_path="ck.json",
                          fault_plan="dispatch:oom@1"), True, 2),
    "ckpt_resumed": (dict(checkpoint_path="../ckpt_demoted/ck.json"), True,
                     None),
    "sink_clean": (dict(run_manifest_path="manifest.jsonl",
                        checkpoint_path="ck.json"), False, None),
    "sink_restart": (dict(run_manifest_path="manifest.jsonl",
                          checkpoint_path="ck.json", retry_max_attempts=1,
                          fault_plan="sink_write:raise@1"), False, None),
}
# the typed escalations the runs end with ("" = completed); the run with
# healing off ends with the card's own error, whose type differs
ERRORS = {"reinit_budget": "ReinitBudgetExceeded",
          "ladder_exhausted": "LadderExhausted"}
# both ladders at once on a live run: every sink push stalled, the
# second dispatch out of memory
BOTH_LADDERS = dict(retry_max_attempts=1, degrade_hold_segments=2,
                    fault_plan="dispatch:oom@2," + ",".join(
                        f"sink_write:stall=0.2@{i}" for i in range(8)))


def _fields(tmp, name: str) -> dict:
    overrides = dict(SCENARIOS[name][0])
    for key in ("checkpoint_path", "run_manifest_path"):
        if key in overrides:
            overrides[key] = os.path.normpath(
                os.path.join(str(tmp), name, overrides[key]))
    if name == "ckpt_resumed":
        # the resumed run continues the demoted run's outputs
        return engine_fields(tmp, "ckpt_demoted", **overrides)
    return engine_fields(tmp, name, inflight_segments=2, **overrides)


def _both_fields(tmp, tag: str, live: bool) -> dict:
    fields = engine_fields(tmp, tag, inflight_segments=2, **BOTH_LADDERS)
    if live:
        fields["input_file_path"] = ""
    return fields


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("selfheal")
    write_pulsed_input(tmp)
    return tmp


@pytest.fixture(scope="module")
def ref(tmp_path_factory, work):
    """The reference's runs, under ``<work>/ref``, in two interpreters at
    once (a reference run costs seconds of tracing; the checkpoint runs,
    which continue one another, stay in one)."""
    base = work / "ref"
    os.makedirs(base, exist_ok=True)
    os.symlink(work / "bb.bin", base / "bb.bin")  # the live run's input
    halves = ([], [])
    for i, (name, (_o, capture, max_segments)) in enumerate(
            SCENARIOS.items()):
        fields = _fields(base, name)
        fields["input_file_path"] = str(work / "bb.bin")
        half = halves[1] if name.startswith("ckpt") else halves[i % 2]
        half.append({"key": name, "fn": "test_torch_ref:ref_resilience_run",
                     "args": [fields],
                     "kwargs": {"capture": capture,
                                "max_segments": max_segments}})
    halves[0].append({"key": "both",
                      "fn": "test_torch_ref:ref_resilience_run",
                      "args": [_both_fields(base, "both", True)],
                      "kwargs": {"capture": False, "source_fields":
                                 _both_fields(base, "both", False)}})
    # the chaos soak's pool-scoped halt (its fourth phase, a one-stream
    # fleet on a two-member pool)
    os.makedirs(base / "chaos_pool", exist_ok=True)
    halves[1].append({"key": "chaos_pool",
                      "fn": "srtb_tpu.tools.chaos_soak:run_soak",
                      "kwargs": {"segments": 3, "log2n": 12,
                                 "plan": "device:halt@2",
                                 "tmpdir": str(base / "chaos_pool")}})
    dirs = [tmp_path_factory.mktemp("ref_selfheal") for _ in halves]
    with ThreadPoolExecutor(2) as pool:
        outs = list(pool.map(
            lambda half: run_reference(*half, compile_cache=True),
            zip(halves, dirs)))
    return {**outs[0], **outs[1]}


@pytest.fixture(scope="module")
def port(work):
    """The port's runs, under ``<work>/port``, in the reference's order
    (the resumed run continues the demoted one)."""
    base = work / "port"
    os.makedirs(base, exist_ok=True)
    os.symlink(work / "bb.bin", base / "bb.bin")  # the live run's input
    out = {}
    for name, (_o, capture, max_segments) in SCENARIOS.items():
        fields = _fields(base, name)
        fields["input_file_path"] = str(work / "bb.bin")
        metrics.reset()  # each run's counters from zero, as the reference's
        out[name] = resilience_run(
            Pipeline, Config(**fields), lambda pipe, k: metrics.get(k),
            capture, max_segments=max_segments, device="cpu")
    source = make_file_source(Config(**_both_fields(base, "both", False)))
    metrics.reset()
    out["both"] = resilience_run(
        Pipeline, Config(**_both_fields(base, "both", True)),
        lambda pipe, k: metrics.get(k), False, source=source,
        device="cpu")
    metrics.reset()
    return out


def _strip(a) -> list:
    return [x for x in np.asarray(a).tolist() if x != ""]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(ref, port, name):
    """The run ends as the reference's does, with the same counters, the
    same rung sequence, the same artifacts and the same decisions."""
    got = port[name]
    want_error = str(ref[f"{name}/error"])
    if name == "healing_off":
        assert got["error"] == "OutOfMemoryError" and want_error
    else:
        assert got["error"] == want_error == ERRORS.get(name, "")
    for k, v in got["counters"].items():
        assert v == float(ref[f"{name}/counters/{k}"]), k
    assert _strip(got["plans"]) == _strip(ref[f"{name}/plans"])
    assert _strip(got["files"]) == _strip(ref[f"{name}/files"])
    assert got["levels"].tolist() == ref[f"{name}/levels"].tolist()
    assert got["unfired"] == int(ref[f"{name}/unfired"])
    assert got["unfired"] == 0 or name in ERRORS
    assert got["segments"] == int(ref[f"{name}/segments"])
    if got["segments"]:
        for key in ("signal_counts", "zero_count", "positive"):
            assert np.array_equal(got[key], ref[f"{name}/{key}"]), key


@pytest.mark.parametrize("name", [
    n for n, s in SCENARIOS.items()
    if s[1] and n not in ERRORS and n != "healing_off"])
def test_time_series_within_the_segment_gates(ref, port, name):
    """Each segment's waterfall within 2e-5 of its largest value and its
    time series within ``time_series_error_gates`` of the reference's,
    on the same rung (``test_torch_segment.test_waterfall_and_time_series``
    holds every plan to these gates)."""
    got = port[name]
    assert got["segments"] > 0
    want_wf = ref[f"{name}/waterfall"]
    assert got["waterfall"].shape == want_wf.shape
    for s in range(got["segments"]):
        for st in range(want_wf.shape[1]):
            w = want_wf[s, st]
            wf_err = float(np.abs(got["waterfall"][s, st] - w).max())
            assert wf_err <= 2e-5 * np.abs(w).max()
            t = got["time_series"].shape[-1]
            p = np.abs(w[:, :t].astype(np.complex128)) ** 2
            gates = det.time_series_error_gates(
                w.shape[0], t, float(p.sum(0).max()), wf_err)
            err = np.abs(got["time_series"][s, st]
                         - ref[f"{name}/time_series"][s, st]).max()
            assert err <= sum(gates)


def test_every_completed_capture_run_drained_segments(port):
    assert all(port[n]["segments"] > 0 for n, s in SCENARIOS.items()
               if s[1] and not port[n]["error"])


@pytest.mark.parametrize("name", ["clean_armed", "oom_dispatch",
                                  "compile_fetch", "halt_dispatch",
                                  "promotion", "raise_sites",
                                  "corrupt_sites"])
def test_recovered_run_equals_clean_run(port, name):
    """Arming the ladder on a clean run is bit-identical to the ladder
    off; a recovered run (the ring rung, a reinit, retries) gives the
    clean run's bits too."""
    got, clean = port[name], port["clean_off"]
    assert got["segments"] == clean["segments"]
    for key in ("signal_counts", "zero_count", "time_series", "waterfall",
                "positive"):
        assert np.array_equal(got[key], clean[key]), key


def test_rung_sequences(port):
    """The ring rung first (its bits are the clean run's), a reinit at
    the same rung, the micro-batch rung dropping the batch."""
    assert _strip(port["oom_dispatch"]["plans"]) == ["fused:monolithic"]
    assert _strip(port["halt_dispatch"]["plans"]) == ["fused:monolithic+ring"]
    assert _strip(port["micro_batch"]["plans"]) == ["fused:monolithic+ring"]
    assert port["promotion"]["counters"]["plan_promotions"] >= 1
    assert port["micro_batch_promote"]["counters"]["plan_promotions"] >= 1
    assert port["sink_restart"]["counters"]["worker_restarts"] == 1


def test_checkpoint_offsets_unchanged_by_demotion(ref, port):
    """A run that demoted checkpoints the offsets of one that did not,
    as the reference's does, and its resume completes the stream with
    the clean run's decisions."""
    clean = port["ckpt_clean"]["checkpoint"]
    assert port["ckpt_demoted"]["checkpoint"] == clean
    assert clean["segments_done"] == 2
    for key in clean:
        assert clean[key] == int(ref[f"ckpt_clean/checkpoint/{key}"])
        assert clean[key] == int(ref[f"ckpt_demoted/checkpoint/{key}"])
    resumed, whole = port["ckpt_resumed"], port["clean_off"]
    assert port["ckpt_demoted"]["segments"] + resumed["segments"] \
        == whole["segments"]
    for key in ("signal_counts", "zero_count", "positive"):
        both = np.concatenate([port["ckpt_demoted"][key], resumed[key]])
        assert np.array_equal(both, whole[key]), key


def test_sink_restart_is_exactly_once(port):
    """A crashed sink restarts, its item replayed inline first: the run
    writes the clean run's artifacts, no more, no fewer."""
    assert _strip(port["sink_restart"]["files"]) == \
        _strip(port["sink_clean"]["files"])
    assert port["sink_restart"]["error"] == ""


def test_both_ladders_at_once(ref, port):
    """A live run under sink pressure demotes its plan on an out-of-memory
    while the degradation ladder climbs, in both packages: independent
    state machines.  (How far the degradation climbs depends on how long
    the rebuild holds the engine, so its sheds are not compared.)"""
    got = port["both"]
    assert got["error"] == str(ref["both/error"]) == ""
    for k in ("plan_demotions", "faults_injected", "device_reinits"):
        assert got["counters"][k] == float(ref[f"both/counters/{k}"]), k
    assert got["counters"]["plan_demotions"] == 1
    assert _strip(got["plans"]) == _strip(ref["both/plans"])
    assert got["counters"]["degrade_steps"] >= 1
    assert float(ref["both/counters/degrade_steps"]) >= 1


# ---------------------------------------------- the port's own engine

class _NeverReady:
    """A ``done`` event that never completes (a wedged chain)."""

    def query(self) -> bool:
        return False

    def synchronize(self) -> None:
        raise AssertionError("a cancelled segment's results were read")


def test_watchdog_requeues_then_demotes(work, tmp_path, monkeypatch):
    """Segment 0's first dispatch never completes: the watchdog
    re-dispatches it; the requeue runs out of memory and demotes; every
    segment drains once, with the clean run's decisions (the reference's
    ``test_demotion_of_watchdog_requeued_segment``)."""
    cfg = Config(**engine_fields(work, "wd", inflight_segments=2,
                                 segment_deadline_s=0.2,
                                 segment_watchdog_requeues=2))
    sink = CaptureSink()
    metrics.reset()
    pipe = Pipeline(cfg, sinks=[sink], device="cpu")
    seg0 = {"dispatches": 0}
    to_host = pipe._to_host
    dispatch = pipe._dispatch_segment

    def wedged_to_host(dets):
        dets, _done = to_host(dets)
        return dets, (_NeverReady() if seg0.pop("wedge", False) else None)

    def counting_dispatch(seg, offset_after=0, index=0, requeue=False):
        if index == 0:
            seg0["dispatches"] += 1
            if seg0["dispatches"] == 1:  # the first: never completes
                seg0["wedge"] = True
            elif seg0["dispatches"] == 2:  # the watchdog's requeue
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return dispatch(seg, offset_after, index, requeue)
    monkeypatch.setattr(pipe, "_to_host", wedged_to_host)
    monkeypatch.setattr(pipe, "_dispatch_segment", counting_dispatch)
    with pipe:
        stats = pipe.run()
    assert metrics.get("watchdog_requeues") == 1
    assert metrics.get("plan_demotions") == 1
    assert metrics.get("segments_dropped") == 0
    assert stats.segments == len(sink.out) == _segments_of_input(work)


def _segments_of_input(work) -> int:
    """The segment count of the pulsed input at the engine geometry."""
    cfg = Config(**engine_fields(work, "count"))
    reader = make_file_source(cfg)
    n = sum(1 for _ in reader)
    reader.close()
    return n


def test_watchdog_escalates_after_its_requeues(work, monkeypatch):
    """A segment that stays wedged through every requeue escalates."""
    cfg = Config(**engine_fields(work, "wd_esc", inflight_segments=2,
                                 segment_deadline_s=0.05,
                                 segment_watchdog_requeues=1))
    metrics.reset()
    pipe = Pipeline(cfg, sinks=[CaptureSink()], device="cpu")
    to_host = pipe._to_host
    monkeypatch.setattr(pipe, "_to_host",
                        lambda dets: (to_host(dets)[0], _NeverReady()))
    with pipe, pytest.raises(E.WatchdogEscalation):
        pipe.run()
    assert metrics.get("watchdog_requeues") == 1


class _InstantSink:
    def __init__(self):
        self.pushed = 0

    def push(self, work, positive):
        self.pushed += 1


def test_the_window_refills_when_the_sink_frees_it(work):
    """When the sink thread drains the whole window between the engine's
    two looks at it, the engine fills it again and reads on (the JAX
    package's engine ends the run there, segments unread): 30 runs at a
    window of 2 with an instant sink and a thread switch interval of 1 us
    all drain every segment (the early exit hit 6 of 60 such runs)."""
    import sys
    want = _segments_of_input(work)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(30):
            sink = _InstantSink()
            cfg = Config(**engine_fields(work, "refill", inflight_segments=2))
            with Pipeline(cfg, sinks=[sink], device="cpu") as pipe:
                stats = pipe.run()
            assert stats.segments == sink.pushed == want
    finally:
        sys.setswitchinterval(interval)


def test_retired_processor_refuses_a_dispatch(work):
    """After a reinit the old processor is retired: a stray dispatch on
    it raises, and its device tables are dropped."""
    cfg = Config(**engine_fields(work, "retire",
                                 fault_plan="dispatch:device_halt@1"))
    metrics.reset()
    with Pipeline(cfg, sinks=[CaptureSink()], device="cpu") as pipe:
        old = pipe.processor
        pipe.run()
        assert pipe.processor is not old
    assert metrics.get("device_reinits") == 1
    with pytest.raises(RuntimeError, match="retired"):
        old.run_device(torch.zeros(old._segment_bytes, dtype=torch.uint8))
    assert old.window is None and old.watfft_dewindow is None


def test_a_drained_item_is_held_when_its_context_died(work):
    """The sink thread holds an item whose event's query raises (the
    card's context died before the engine saw the halt: freeing its
    pinned results would abort the process), and lets a healthy one go;
    after a halt every item is held."""
    class Event:
        def __init__(self, dead):
            self.dead = dead

        def query(self):
            if self.dead:
                raise torch.AcceleratorError(
                    "CUDA error: device-side assert triggered")
            return True

    cfg = Config(**engine_fields(work, "held"))
    with Pipeline(cfg, sinks=[CaptureSink()], device="cpu") as pipe:
        alive = Fetched(None, None, None, Event(False))
        pipe._keep_if_dead(alive)
        assert pipe._halted is None
        dead = Fetched(None, None, None, Event(True))
        pipe._keep_if_dead(dead)
        # the healthy item's results, deferred one drain, are held too
        assert pipe._halted == [(alive.det, alive.hold), dead]
        pipe._keep_if_dead(alive)
        assert pipe._halted == [(alive.det, alive.hold), dead, alive]


class _Event:
    """A ``done`` event; ``dead``: its query raises, as on a context a
    sticky fault killed."""

    def __init__(self, dead: bool = False):
        self.dead = dead

    def query(self):
        if self.dead:
            raise torch.AcceleratorError(
                "CUDA error: device-side assert triggered")
        return True


def test_a_drained_items_results_are_freed_one_drain_later(work):
    """The drain's query and its free are two calls: a context that dies
    between them must not see the free.  So a drained item's results
    (its pinned copies and held buffers) are freed only after the next
    drain's query found the context alive; when that query raises, they
    are held with the dead item (ROADMAP C8)."""
    import gc
    import weakref

    def item(dead=False):
        buf = torch.zeros(4)
        return Fetched(None, None, None, _Event(dead), hold=(buf,)), \
            weakref.ref(buf)

    cfg = Config(**engine_fields(work, "deferred"))
    with Pipeline(cfg, sinks=[CaptureSink()], device="cpu") as pipe:
        a, ref_a = item()
        pipe._keep_if_dead(a)
        del a
        gc.collect()
        assert ref_a() is not None  # deferred: no later query yet
        b, ref_b = item()
        pipe._keep_if_dead(b)
        del b
        gc.collect()
        assert ref_a() is None and ref_b() is not None
        # the context dies after b's query: its free is not made
        c, ref_c = item(dead=True)
        pipe._keep_if_dead(c)
        del c
        gc.collect()
        assert ref_b() is not None and ref_c() is not None
        assert len(pipe._halted) == 2


def test_the_ring_carry_is_held_when_its_context_died(work):
    """``_ring_invalidate`` outside a halt asks the last dispatch's event
    before it drops the carry (a view of a staged buffer, whose free
    records an event): alive, it is dropped; dead, the halt starts and
    the carry is held (ROADMAP C8)."""
    cfg = Config(**engine_fields(work, "carry"))
    with Pipeline(cfg, sinks=[CaptureSink()], device="cpu") as pipe:
        carry = torch.zeros(4)
        pipe._ring_carry, pipe._last_done = carry, _Event()
        pipe._ring_invalidate()
        assert pipe._ring_carry is None and pipe._halted is None
        pipe._ring_carry, pipe._last_done = carry, _Event(dead=True)
        pipe._ring_invalidate()
        assert pipe._ring_carry is None
        assert len(pipe._halted) == 1 and pipe._halted[0] is carry


def test_a_read_that_meets_a_dead_context_escalates(work, monkeypatch):
    """A read that must pin a new buffer after the context died raises
    the context's error from ``BufferPool._new_block``: the healer takes
    it as a halt, as at a dispatch, so every reinit's read fails the
    same way and the run ends ``ReinitBudgetExceeded``, not in a bare
    ``AcceleratorError`` (ROADMAP C8)."""
    from srtb_tpu_torch.utils.bufferpool import BufferPool
    acquire, reads = BufferPool.acquire, [0]

    def dying(self, nbytes, zero=True):
        reads[0] += 1
        if reads[0] > 2:
            # the third read finds no cached block, and its pin meets a
            # dead context
            self._free.clear()
            self._new_block = _dead_pin
        return acquire(self, nbytes, zero)

    def _dead_pin(nbytes):
        raise torch.AcceleratorError(
            "CUDA error: device-side assert triggered")
    monkeypatch.setattr(BufferPool, "acquire", dying)
    cfg = Config(**engine_fields(work, "dead_read", inflight_segments=2,
                                 retry_max_attempts=1))
    metrics.reset()
    with Pipeline(cfg, sinks=[CaptureSink()], device="cpu") as pipe, \
            pytest.raises(E.ReinitBudgetExceeded) as info:
        pipe.run()
    assert isinstance(info.value.__cause__, torch.AcceleratorError)
    assert metrics.get("device_reinits") == cfg.device_reinit_max


@pytest.mark.parametrize("ring", ["on", "off"])
def test_a_dispatch_holds_what_its_chain_reads(work, ring):
    """A dispatched item holds the bytes its chain reads until it is
    drained: the staged segment, and the ring's carry the dispatch took
    (a view of the previous segment's staged bytes).  On the card their
    free records an event, which aborts the process on a context a sticky
    fault killed (ROADMAP C8); the fetch hands the hold on to the sinks'
    item."""
    cfg = Config(**engine_fields(work, f"hold_{ring}", ingest_ring=ring))
    with Pipeline(cfg, sinks=[CaptureSink()], device="cpu") as pipe:
        drain, seen = pipe._drain_body, []

        def recording(item, drained):
            seen.append((np.array_equal(item.hold[0].numpy(),
                                        item.seg.data),
                         [h is not None for h in item.hold[1:]]))
            return drain(item, drained)
        pipe._drain_body = recording
        stats = pipe.run()
        ring_on = pipe.processor.ring
    assert ring_on == (ring == "on")
    assert len(seen) == stats.segments > 1
    assert all(same for same, _rest in seen)
    if ring_on:
        # the first dispatch found no carry; each later one took one
        assert [rest for _same, rest in seen] == \
            [[False]] + [[True]] * (len(seen) - 1)
    else:
        assert all(rest == [] for _same, rest in seen)


def test_a_dead_context_met_by_the_readiness_probe_escalates(work):
    """The engine's readiness probe on a context a sticky fault killed:
    the event's query raises.  It reads as ready, so that the fetch meets
    the error where the healer takes it: every reinit's re-dispatch dies
    the same way and the run ends ``ReinitBudgetExceeded``, as on the
    card, instead of the probe raising a bare error past the healer."""
    class DeadEvent:
        def query(self):
            raise torch.AcceleratorError(
                "CUDA error: device-side assert triggered")
        synchronize = query

    cfg = Config(**engine_fields(work, "dead_probe", inflight_segments=2,
                                 retry_max_attempts=1))
    metrics.reset()
    with Pipeline(cfg, sinks=[CaptureSink()], device="cpu") as pipe, \
            pytest.raises(E.ReinitBudgetExceeded) as info:
        dispatch = pipe._dispatch_segment

        def dying(seg, offset_after=0, index=0, requeue=False):
            item = dispatch(seg, offset_after, index, requeue=requeue)
            # segment 1 on: its chain asserted, the context is dead
            return item._replace(done=DeadEvent()) if index >= 1 else item
        pipe._dispatch_segment = dying
        pipe.run()
    assert isinstance(info.value.__cause__, torch.AcceleratorError)
    assert metrics.get("device_reinits") == cfg.device_reinit_max


@pytest.mark.parametrize("inflight", [1, 2])
def test_a_halt_met_first_by_the_sink_escalates(work, inflight):
    """A sticky halt that the sink side meets before the engine (its
    copies run on the card) is the healer's, as the engine's own: every
    reinit fails the same way, and the run ends ``ReinitBudgetExceeded``
    once the budget is spent, in the serial leg and behind the sink pipe
    (whose supervisor restarts it and replays the segment first)."""
    class DeadSink(CaptureSink):
        def push(self, work, positive):
            if self.out:
                raise torch.AcceleratorError(
                    "CUDA error: device-side assert triggered")
            super().push(work, positive)

    cfg = Config(**engine_fields(work, f"sink_halt_{inflight}",
                                 inflight_segments=inflight,
                                 retry_max_attempts=1))
    metrics.reset()
    sink = DeadSink()
    with Pipeline(cfg, sinks=[sink], device="cpu") as pipe, \
            pytest.raises(E.ReinitBudgetExceeded) as info:
        pipe.run()
    assert isinstance(info.value.__cause__, torch.AcceleratorError)
    assert len(sink.out) == 1
    assert metrics.get("device_reinits") == cfg.device_reinit_max
    assert metrics.get("worker_restarts") == (inflight > 1)


@pytest.mark.parametrize("site,exc", [
    ("dispatch", KernelLaunchError("srtb_fft_rows", 98,
                                   "cudaErrorInvalidDeviceFunction")),
    ("dispatch", KernelLaunchError("srtb_sk_stats", 2,
                                   "cudaErrorMemoryAllocation")),
    ("fetch", KernelBuildError("nvcc failed:\nfft_rows.cu(1): error")),
])
def test_a_real_kernel_fault_escalates_without_demoting(work, monkeypatch,
                                                        site, exc):
    """A kernel of the port that does not build or launch ends the run
    with ``KernelFault`` naming it, at a dispatch or at a fetch: no rung
    may do its work in plain PyTorch in its place (an injected
    ``compile_fail`` demotes, see the scenarios above)."""
    cfg = Config(**engine_fields(work, f"kf_{site}", inflight_segments=2))
    metrics.reset()
    pipe = Pipeline(cfg, sinks=[CaptureSink()], device="cpu")
    target = "_dispatch_segment" if site == "dispatch" else "_fetch_inflight"
    real = getattr(pipe, target)
    calls = {"n": 0}

    def failing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise exc
        return real(*a, **k)
    monkeypatch.setattr(pipe, target, failing)
    with pipe, pytest.raises(E.KernelFault) as info:
        pipe.run()
    assert info.value.__cause__ is exc
    name = getattr(exc, "kernel", "kernel library")
    assert name in str(info.value)
    for key in ("plan_demotions", "device_reinits", "retries_total"):
        assert metrics.get(key) == 0


def test_chaos_soak_gate_passes_on_a_seeded_plan(tmp_path):
    rep = CS.run_soak(seed=11, segments=3, faults=3, log2n=12,
                      tmpdir=str(tmp_path), device="cpu")
    assert rep["ok"]
    assert rep["drained"] + rep["dropped"] == rep["segments"]
    assert CS.generate_plan(11, 3, 3, 4, 3) == rep["plan"]


def test_chaos_soak_selftest_is_sharp():
    assert CS.selftest(device="cpu") == []


def test_chaos_soak_refuses_pool_halts(tmp_path, ref):
    """A pool-scoped ``device:halt@2`` runs as the soak's fourth phase (a
    one-stream fleet on a two-member pool, the halted member drained onto
    the survivor) and gives the reference's report: the same segments,
    drains, migrations, no reinit, no demotion, no loss."""
    rep = CS.run_soak(segments=3, log2n=12, plan="device:halt@2",
                      tmpdir=str(tmp_path), device="cpu")
    assert rep["ok"] and bool(ref["chaos_pool/ok"])
    assert rep["pool_halts"] == ref["chaos_pool/pool_halts"].tolist() == [2]
    for key in ("segments", "drained", "dropped", "plan_demotions",
                "device_reinits"):
        assert rep[key] == int(ref[f"chaos_pool/{key}"]), key
    for key in ("device_drains", "migrations", "device_reinits",
                "segments_dropped", "plan_demotions"):
        assert rep["pool_counters"][key] == \
            int(ref[f"chaos_pool/pool_counters/{key}"]), key
    assert rep["pool_counters"]["device_drains"] == 1
