"""The port's runtime concurrency checker (``srtb_tpu_torch/analysis/
tsan.py``) and race soak (``tools/race_soak.py``, ROADMAP A8c) against the
JAX package's (``srtb_tpu/analysis/tsan.py``, ``tools/race_soak.py`` and
the runtime half of their tests, ``tests/test_tsan.py``): the live lockdep
cycle trap, the condition wrapper's misuse traps, held-too-long stalls,
claim-on-first-use ownership on a fleet lane, the fleet armed by
``Config.tsan`` and its zero-cost-off contract, and the seeded schedule
perturber.  One scripted run (``tests/test_torch_ref.py``'s
``tsan_script``) drives both packages: for the same seeds, rates and site
sequences the port's perturber journals and decisions are the
reference's exactly, and so are each trap's message, the order graph's
report and the race soak's selftest.  Then the race soak on the CPU (its
migration phase on the CPU's virtual pool) and on the card (``cuda``)."""

from __future__ import annotations

import os
import threading
import time

import pytest
import torch

from srtb_tpu_torch.analysis.tsan import (InstrumentedCondition,
                                          InstrumentedLock,
                                          SchedulePerturber, Tsan,
                                          TsanError, install_perturber,
                                          uninstall_perturber)
from test_torch_ref import run_reference, tsan_script

PORT = "srtb_tpu_torch"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference([{"key": "tsan", "fn": "test_torch_ref:tsan_script",
                           "args": ["srtb_tpu"]}],
                         tmp_path_factory.mktemp("ref_tsan"))


def test_the_scripted_checker_equals_the_references(ref):
    """Every journal, decision vector, trap message, the order graph's
    report, the claimed owners and the race soak's selftest: the
    reference's, exactly."""
    got = tsan_script(PORT)
    keys = {k[len("tsan/"):] for k in ref if k.startswith("tsan/")}
    assert keys == set(got)
    for k in sorted(keys):
        want = ref[f"tsan/{k}"]
        have = got[k]
        have = have.tolist() if hasattr(have, "tolist") else have
        assert have == want.tolist(), k
    assert got["selftest"].tolist() == [""]


# --------------------------------------------------- runtime: lockdep


class TestLockdepRuntime:
    def test_cycle_trap(self):
        ts = Tsan()
        a, b = ts.lock("A"), ts.lock("B")
        with a:
            with b:
                pass
        with pytest.raises(TsanError, match="inversion"):
            with b:
                with a:
                    pass

    def test_consistent_order_quiet(self):
        ts = Tsan()
        a, b, c = ts.lock("A"), ts.lock("B"), ts.lock("C")
        for _ in range(3):
            with a:
                with b:
                    with c:
                        pass
        assert ts.report()["order_edges"] >= 2

    def test_reacquire_trap(self):
        ts = Tsan()
        a = ts.lock("A")
        with pytest.raises(TsanError, match="re-acquire"):
            with a:
                with a:
                    pass

    def test_transitive_cycle_trap(self):
        # A->B and B->C on record; taking A under C closes the cycle
        # through the path, not a direct edge
        ts = Tsan()
        a, b, c = ts.lock("A"), ts.lock("B"), ts.lock("C")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with pytest.raises(TsanError, match="inversion"):
            with c:
                with a:
                    pass

    def test_stall_recorded_not_raised(self):
        ts = Tsan(stall_s=0.01)
        a = ts.lock("slow")
        with a:
            time.sleep(0.05)
        assert ts.stalls and ts.stalls[0][0] == "slow"
        assert ts.stalls[0][1] >= 0.01

    def test_condition_wait_notify_roundtrip(self):
        ts = Tsan()
        cv = ts.condition("cv")
        state = {"ready": False}

        def waker():
            time.sleep(0.02)
            with cv:
                state["ready"] = True
                cv.notify_all()

        t = threading.Thread(target=waker)
        t.start()
        with cv:
            while not state["ready"]:
                assert cv.wait(1.0)
        t.join()
        assert state["ready"]

    def test_condition_misuse_traps(self):
        ts = Tsan()
        cv = ts.condition("cv")
        with pytest.raises(TsanError, match="notify"):
            cv.notify_all()
        with pytest.raises(TsanError, match="wait"):
            cv.wait(0.01)


# ------------------------------------------------- runtime: ownership


class TestOwnership:
    def test_claim_on_first_use_trap(self):
        ts = Tsan()
        ts.assert_owner("lane.s0.step")  # this thread claims
        err = []

        def intruder():
            try:
                ts.assert_owner("lane.s0.step")
            except TsanError as e:
                err.append(e)

        t = threading.Thread(target=intruder, name="intruder")
        t.start()
        t.join()
        assert err and "ownership" in str(err[0])

    def test_release_prefix_allows_reclaim(self):
        ts = Tsan()
        ts.assert_owner("lane.s0.sink")
        ts.assert_owner("former.groups")
        ts.release_owners("lane.s0.sink")
        ok = []

        def successor():
            ts.assert_owner("lane.s0.sink")  # re-claim after restart
            try:
                ts.assert_owner("former.groups")
            except TsanError:
                ok.append(True)

        t = threading.Thread(target=successor)
        t.start()
        t.join()
        assert ok, "unreleased claim must still trap"


# ----------------------------------------- fleet integration + 0-cost


def _tiny_fleet(tmp_path, **cfg_kw):
    """The reference's two-stream fleet of ``tests/test_tsan.py``, its
    files made by numpy's generator (the reference's bytes), on the
    CPU."""
    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.io.synth import make_dispersed_baseband_host
    from srtb_tpu_torch.pipeline.fleet import StreamFleet, StreamSpec
    n = 1 << 12
    specs = []
    for i, name in enumerate(("s0", "s1")):
        bb = os.path.join(str(tmp_path), f"bb_{name}.bin")
        make_dispersed_baseband_host(
            n * 2, 1405.0, 64.0, 0.05, pulse_positions=[n // 2],
            pulse_amp=30.0, nbits=8, seed=i).tofile(bb)
        cfg = dict(
            baseband_input_count=n, baseband_input_bits=8,
            baseband_freq_low=1405.0, baseband_bandwidth=64.0,
            baseband_sample_rate=128e6, dm=0.05,
            input_file_path=bb,
            baseband_output_file_prefix=os.path.join(
                str(tmp_path), f"out_{name}_"),
            spectrum_channel_count=64,
            mitigate_rfi_average_method_threshold=100.0,
            mitigate_rfi_spectral_kurtosis_threshold=2.0,
            baseband_reserve_sample=True, writer_thread_count=0,
            fft_strategy="four_step", inflight_segments=2,
            retry_backoff_base_s=0.001)
        cfg.update(cfg_kw)
        specs.append(StreamSpec(name=name, cfg=Config(**cfg)))
    return StreamFleet(specs, device="cpu")


def test_fleet_tsan_on_runs_clean(tmp_path):
    fleet = _tiny_fleet(tmp_path, tsan=True)
    assert fleet._tsan is not None
    assert isinstance(fleet._wake, InstrumentedCondition)
    res = fleet.run()
    try:
        assert all(r.status == "done" for r in res.values())
        for lane in fleet.lanes.values():
            assert isinstance(lane._live_lock, InstrumentedLock)
        rep = fleet._tsan.report()
        # claims were released at run() exit (per-run ownership); the
        # order graph persists across the run
        assert rep["owners"] == {}
        assert "stalls" in rep and "order_edges" in rep
    finally:
        fleet.close()


def test_fleet_tsan_off_is_zero_cost(tmp_path):
    fleet = _tiny_fleet(tmp_path)  # tsan defaults off
    assert fleet._tsan is None
    assert isinstance(fleet._wake, threading.Condition)
    res = fleet.run()
    try:
        assert all(r.status == "done" for r in res.values())
        # lane locks are plain threading primitives: no wrapper
        # indirection anywhere on the hot path when the knob is off
        for lane in fleet.lanes.values():
            assert not isinstance(lane._live_lock, InstrumentedLock)
            assert type(lane._live_lock) is type(threading.Lock())
    finally:
        fleet.close()


# --------------------------------------- seeded schedule perturbation


class TestSchedulePerturber:
    def test_same_seed_same_schedule_same_journal(self):
        # driven with an identical (deterministic, single-threaded)
        # acquisition sequence, two perturbers with the same seed perturb
        # the same occurrences => identical journals
        seq = (["fleet._wake"] * 40 + ["lane.s0._live_lock"] * 40
               + ["fleet._wake", "lane.s1._live_lock"] * 20)
        p1 = SchedulePerturber(42, rate=0.3, sleep_s=0.0)
        p2 = SchedulePerturber(42, rate=0.3, sleep_s=0.0)
        for site in seq:
            p1.perturb(site)
        for site in seq:
            p2.perturb(site)
        assert p1.journal and p1.journal == p2.journal

    def test_different_seed_different_schedule(self):
        sites = [("s", k) for k in range(256)]
        p1 = SchedulePerturber(1, rate=0.3)
        p2 = SchedulePerturber(2, rate=0.3)
        assert [p1.decide(s, k) for s, k in sites] \
            != [p2.decide(s, k) for s, k in sites]

    def test_decide_is_pure(self):
        p = SchedulePerturber(9, rate=0.5)
        before = [p.decide("x", k) for k in range(64)]
        p.perturb("x")  # mutating the counter must not move decide()
        assert [p.decide("x", k) for k in range(64)] == before

    def test_install_uninstall(self):
        from srtb_tpu_torch.analysis.tsan import current_perturber
        p = SchedulePerturber(0, rate=1.0, sleep_s=0.0)
        install_perturber(p)
        try:
            assert current_perturber() is p
            ts = Tsan()
            with ts.lock("L"):
                pass
            assert p.journal == [("L", 0)]
        finally:
            uninstall_perturber()
        assert current_perturber() is None


def test_race_soak_selftest_is_sharp():
    from srtb_tpu_torch.tools.race_soak import main, selftest
    assert selftest() == []
    assert main(["--selftest"]) == 0


def test_race_soak_on_the_cpus_virtual_pool(tmp_path):
    """The perturbed soak on the CPU at the reference's smoke size: the
    fleet_soak gates hold, the perturber fired on the fleet's instrumented
    sites, the journal replays, the migration phase ran on the virtual
    pool and says so."""
    from srtb_tpu_torch.tools.race_soak import run_race_soak
    report = run_race_soak(streams=2, segments=3, log2n=12, seed=1,
                           batch=2, device="cpu")
    assert report["ok"] and report["perturbs"] > 0
    assert {"fleet._wake", "lane.stream0._live_lock"} <= set(
        report["perturb_sites"])
    assert report["migrate_device"] == "cpu (virtual pool)"
    assert report["migrations"] >= 1


@pytest.mark.slow
def test_race_soak_smoke(tmp_path):
    from srtb_tpu_torch.tools.race_soak import run_race_soak
    report = run_race_soak(streams=2, segments=3, log2n=12, seed=1,
                           batch=2, device="cpu")
    assert report["ok"] and report["perturbs"] > 0


@pytest.mark.cuda
def test_race_soak_on_the_card():
    """The perturbed soak on the card (its migration phase on the CPU's
    virtual pool, asked for); without that, the card's one-member pool
    fails the phase: it is never skipped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from srtb_tpu_torch.tools import race_soak as RS
    report = RS.run_race_soak(streams=2, segments=3, log2n=16, seed=1,
                              batch=2, migrate_device="cpu")
    assert report["ok"] and report["perturbs"] > 0
    assert report["device"].startswith("cuda")
    assert report["migrate_device"] == "cpu (virtual pool)"
    if torch.cuda.device_count() < 2:
        assert RS.main(["--streams", "2", "--segments", "3", "--log2n",
                        "12"]) == 1
