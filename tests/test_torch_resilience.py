"""The port's resilience layers against the JAX package's (ROADMAP A7):
the error taxonomy on torch's CUDA errors, the retry policy, the fault
plan, the classifying supervisor, the degradation ladder, the drop-oldest
buffer and the demotion ladder's rungs, and the degradation ladder on a
live run through both packages' engines.  The reference runs in its own
interpreter (``tests/test_torch_ref.py``); the port on the CPU runs its
kernels' plain versions."""

from __future__ import annotations

import dataclasses
import errno
import os

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io.backpressure import DropOldestSegmentBuffer
from srtb_tpu_torch.io.file_input import make_file_source
from srtb_tpu_torch.io.synth import make_dispersed_baseband_host
from srtb_tpu_torch.kernels import fft_rows as KF
from srtb_tpu_torch.kernels.build import KernelBuildError, KernelLaunchError
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import fft as F
from srtb_tpu_torch.pipeline import segment as seg
from srtb_tpu_torch.pipeline.runtime import Pipeline
from srtb_tpu_torch.resilience import errors as E
from srtb_tpu_torch.resilience.degrade import DegradationLadder
from srtb_tpu_torch.resilience.demote import ladder_rungs, parse_ladder
from srtb_tpu_torch.resilience.faults import (FaultInjector, device_fault,
                                              parse_plan)
from srtb_tpu_torch.resilience.retry import RetryPolicy, retry_call
from srtb_tpu_torch.resilience.supervisor import Supervisor
from srtb_tpu_torch.utils import events
from srtb_tpu_torch.utils.metrics import metrics
from test_torch_ref import (RESILIENCE_LAYERS, classifying_supervisor_script,
                            degrade_script, drop_oldest_script, environ,
                            resilience_registry_script, resilience_run,
                            run_reference)
from test_torch_segment import slice_config

PLANS = ["ingest:raise@1, fetch:stall=0.25@2,sink_write:corrupt@3",
         "dispatch:oom@1,fetch:compile_fail@2,h2d:device_halt@3",
         "stream0:dispatch:oom@3,checkpoint:fatal@0",
         "ingest:oom@1", "nowhere:raise@1", "ingest:stall@1",
         "ingest:stall=-1@1", "ingest:raise@x", "dispatch:warp@1"]
SITES = ["ingest", "h2d", "dispatch", "fetch", "sink_write", "checkpoint"]
SUPERVISOR_KINDS = ["transient", "data_loss", "device", "fatal", "plain",
                    "transient", "transient", "transient"]
SUPERVISOR_TIMES = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 70.0]
DEGRADE = {
    "climb_and_recover": (0.9, 0.25, 2, [(1.0, 0)] * 8 + [(0.0, 0)] * 8),
    "loss_escalates": (0.9, 0.25, 1, [(0.0, 1)] * 4 + [(0.5, 0)] * 3
                       + [(0.1, 0)] * 4),
    "between_holds": (0.8, 0.2, 3, [(1.0, 0), (1.0, 0), (0.5, 0),
                                    (1.0, 0), (1.0, 0), (1.0, 0),
                                    (0.3, 0), (0.0, 0)] * 2),
}

# ---- the ladder's rungs: one config a step (and the base plan's staged
# flag), the small ones built as processors too.  (fields, env, staged)
_SMALL = dict(baseband_input_count=1 << 16, baseband_input_bits=2,
              baseband_freq_low=1405.0, baseband_bandwidth=64.0,
              baseband_sample_rate=128e6, dm=0.1, spectrum_channel_count=8,
              mitigate_rfi_average_method_threshold=25.0,
              mitigate_rfi_spectral_kurtosis_threshold=1.05,
              signal_detect_max_boxcar_length=8)
_PALLAS2 = {"SRTB_STAGED_ROWS_IMPL": "pallas2"}
_BIG = dict(baseband_input_count=1 << 30, baseband_input_bits=2,
            baseband_freq_low=1405.0, baseband_bandwidth=64.0,
            baseband_sample_rate=128e6, dm=-478.8,
            spectrum_channel_count=1 << 11, use_pallas=True,
            use_pallas_sk=True, baseband_reserve_sample=True)
RUNGS = {
    "featured": (dict(_SMALL, fft_strategy="four_step", fused_tail="on",
                      use_pallas=True, use_pallas_sk=True,
                      micro_batch_segments=2, baseband_reserve_sample=True),
                 None, None),
    "quality_period": (dict(_SMALL, quality_stats=True,
                            search_mode="periodicity",
                            fft_strategy="pallas", use_pallas=True),
                       None, None),
    "minimal": (dict(_SMALL, baseband_input_count=1 << 12,
                     baseband_reserve_sample=False), None, None),
    "minimal_staged": (dict(_SMALL, baseband_input_count=1 << 12,
                            baseband_reserve_sample=False), None, True),
    "pallas2_batch": (dict(_SMALL, baseband_input_count=1 << 17,
                           fft_strategy="pallas2", use_pallas=True,
                           use_pallas_sk=True, micro_batch_segments=4,
                           baseband_reserve_sample=True), None, None),
    "fused_2^27": (dict(_BIG, baseband_input_count=1 << 27,
                        fft_strategy="pallas", micro_batch_segments=2),
                   None, None),
    "ffuse_2^30": (dict(_BIG, fused_tail="on", front_fuse="on"),
                   _PALLAS2, None),
    "staged_pallas2_2^30": (dict(_BIG, fused_tail="on"), _PALLAS2, None),
    "shipped_2^30": (dict(_BIG, use_pallas=False, use_pallas_sk=False,
                          baseband_reserve_sample=False), None, None),
    "subset": (dict(_SMALL, fft_strategy="four_step", use_pallas=True,
                    micro_batch_segments=2, baseband_reserve_sample=True),
               None, None),
}
RUNG_LADDER = {"subset": "staged,monolithic"}
SMALL_RUNGS = [k for k, v in RUNGS.items()
               if v[0]["baseband_input_count"] <= 1 << 17]

# ---- the engine runs: 2^14-sample 2-bit segments of the segment tests'
# geometry, a dispersed pulse in the searched span of each of SEGMENTS
# overlapping segments (segments 0, 2, 3 and 4 come out positive)
N = 1 << 14
SEGMENTS = 7


def engine_fields(tmp, tag: str, **overrides) -> dict:
    """The engine tests' config: the pulsed input under ``tmp``, the
    outputs under ``tmp/tag``, synchronous writes, deterministic
    timestamps and fast retries."""
    os.makedirs(os.path.join(str(tmp), tag), exist_ok=True)
    fields = dataclasses.asdict(slice_config(N, 32, -0.1).replace(
        input_file_path=os.path.join(str(tmp), "bb.bin"),
        baseband_output_file_prefix=os.path.join(str(tmp), tag, "out_"),
        writer_thread_count=0, deterministic_timestamps=True,
        retry_backoff_base_s=0.001))
    fields.update(overrides)
    return fields


def write_pulsed_input(tmp) -> None:
    cfg = slice_config(N, 32, -0.1)
    nres = dd.nsamps_reserved(cfg)
    stride = N - nres
    make_dispersed_baseband_host(
        N + (SEGMENTS - 1) * stride, cfg.baseband_freq_low,
        cfg.baseband_bandwidth, cfg.dm,
        pulse_positions=[k * stride + (N - 2 * nres) // 2
                         for k in range(SEGMENTS)],
        pulse_amp=4.0, nbits=2, seed=5).tofile(os.path.join(str(tmp),
                                                            "bb.bin"))


# ---- the live degradation run: a stand-in live source (a file reader
# handed to a pipeline whose config has no input file), every segment's
# sink push stalled, so the engine waits on the sink
LIVE_STALL_S = 0.2


def _live_fields(tmp, tag: str, live: bool) -> dict:
    fields = engine_fields(
        tmp, tag, inflight_segments=2, retry_max_attempts=1,
        degrade_hold_segments=2,
        fault_plan=",".join(f"sink_write:stall={LIVE_STALL_S}@{i}"
                            for i in range(SEGMENTS)))
    if live:
        fields["input_file_path"] = ""
    return fields


@pytest.fixture(scope="module")
def live_input(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("live")
    write_pulsed_input(tmp)
    return tmp


@pytest.fixture(scope="module")
def ref(tmp_path_factory, live_input):
    tmp = tmp_path_factory.mktemp("ref_resilience")
    jobs = [{"key": "plans", "fn": "test_torch_ref:ref_parse_plans",
             "args": [PLANS]},
            {"key": "backoff", "fn": "test_torch_ref:ref_backoffs",
             "args": [SITES, 6, 0.05, 2.0]},
            {"key": "supervisor",
             "fn": "test_torch_ref:ref_classifying_supervisor",
             "args": [SUPERVISOR_KINDS, 3, SUPERVISOR_TIMES]},
            {"key": "drop", "fn": "test_torch_ref:ref_drop_oldest_script",
             "args": [10, 3]}]
    for name, (high, low, hold, obs) in DEGRADE.items():
        jobs.append({"key": f"degrade/{name}",
                     "fn": "test_torch_ref:ref_degrade_script",
                     "args": [high, low, hold, obs]})
    for name, (fields, env, staged) in RUNGS.items():
        jobs.append({"key": f"rungs/{name}",
                     "fn": "test_torch_ref:ladder_plan_names",
                     "args": [fields, env, staged,
                              RUNG_LADDER.get(name, "auto")]})
    jobs += [{"key": f"registry/{layer}",
              "fn": "test_torch_ref:resilience_registry_script",
              "args": ["srtb_tpu", layer]} for layer in RESILIENCE_LAYERS]
    jobs.append({"key": "live", "fn": "test_torch_ref:ref_resilience_run",
                 "args": [_live_fields(live_input, "ref", True)],
                 "kwargs": {"capture": False, "source_fields":
                            _live_fields(live_input, "ref", False)}})
    return run_reference(jobs, tmp)


# ------------------------------------------------------ the taxonomy

def _cases():
    return [
        (torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB"), E.DEVICE_OOM),
        (torch.AcceleratorError(
            "CUDA error: an illegal memory access was encountered"),
         E.DEVICE_HALT),
        (torch.AcceleratorError("CUDA error: device-side assert triggered"),
         E.DEVICE_HALT),
        (RuntimeError("CUDA error: unspecified launch failure"),
         E.DEVICE_HALT),
        (RuntimeError("CUDA error: no kernel image is available for "
                      "execution on the device"), E.DEVICE_COMPILE),
        (KernelBuildError("nvcc failed: x.cu(1): error"), E.DEVICE_COMPILE),
        (KernelLaunchError("k", 98, "cudaErrorInvalidDeviceFunction"),
         E.DEVICE_COMPILE),
        (KernelLaunchError("k", 701, "cudaErrorLaunchOutOfResources"),
         E.DEVICE_COMPILE),
        (KernelLaunchError("k", 2, "cudaErrorMemoryAllocation"),
         E.DEVICE_OOM),
        (KernelLaunchError("k", 700, "cudaErrorIllegalAddress"),
         E.DEVICE_HALT),
        (KernelLaunchError("k", 1, "cudaErrorInvalidValue"), None),
        (ValueError("CUDA out of memory"), None),
        (RuntimeError("shape mismatch"), None),
        (E.DeviceOOM("x"), E.DEVICE_OOM),
        (E.FatalError("CUDA out of memory"), None),
    ]


@pytest.mark.parametrize("i", range(len(_cases())))
def test_classify_device_on_torch_errors(i):
    """torch's own CUDA error types and the kernel library's errors are
    classified by type and message; a ValueError or a typed error that
    mentions "out of memory" is not a device fault."""
    exc, kind = _cases()[i]
    assert E.classify_device(exc) == kind
    if kind is not None:
        assert E.classify(exc) == E.DEVICE
    elif not isinstance(exc, E.PipelineError):
        assert E.classify(exc) == E.FATAL


@pytest.mark.parametrize("exc,escalates", [
    (KernelBuildError("nvcc failed: x.cu(1): error"), True),
    (KernelLaunchError("srtb_unpack", 98, "cudaErrorInvalidDeviceFunction"),
     True),
    (KernelLaunchError("srtb_unpack", 2, "cudaErrorMemoryAllocation"), True),
    (KernelLaunchError("srtb_unpack", 700, "cudaErrorIllegalAddress"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), False),
    (RuntimeError("CUDA error: no kernel image is available"), False),
])
def test_kernel_fault_of_the_ports_own_kernels(exc, escalates):
    """A real build or launch fault of the port's kernels is a FATAL
    ``KernelFault`` naming the kernel; a halt code, an allocator OOM and
    torch's own errors are left to the ladder."""
    out = E.kernel_fault(exc)
    assert (out is not None) == escalates
    if escalates:
        assert isinstance(out, E.KernelFault)
        assert E.classify(out) == E.FATAL
        assert getattr(exc, "kernel", "did not build") in str(out)


@pytest.mark.parametrize("action", ["oom", "compile_fail", "device_halt"])
def test_injected_device_faults_are_not_kernel_faults(action):
    """The fault plan's tagged device faults keep the reference's
    demotion and reinit (the ladder stays testable)."""
    exc = device_fault(action, "dispatch:x@0")
    assert E.classify_device(exc) is not None
    assert E.kernel_fault(exc) is None


@pytest.mark.parametrize("exc,category", [
    (TimeoutError(), E.TRANSIENT), (ConnectionResetError(), E.TRANSIENT),
    (OSError(errno.EAGAIN, "again"), E.TRANSIENT),
    (OSError(errno.ENOENT, "gone"), E.FATAL),
    (E.DataLossError("x"), E.DATA_LOSS),
    (E.LadderExhausted("x"), E.FATAL),
    (E.ReinitBudgetExceeded("x"), E.FATAL),
    (E.WatchdogEscalation("x"), E.FATAL),
    (E.SegmentTimeout("x"), E.TRANSIENT)])
def test_classify_categories(exc, category):
    assert E.classify(exc) == category


# ------------------------------------------------ retry, faults, supervisor

def test_backoff_equals_reference(ref):
    """The deterministic jitter: the same backoff for every (site,
    attempt)."""
    p = RetryPolicy(max_attempts=7, backoff_base_s=0.05, backoff_max_s=2.0)
    got = np.array([[p.backoff(s, a) for a in range(1, 7)] for s in SITES])
    np.testing.assert_allclose(got, ref["backoff/backoff"], rtol=1e-15)
    assert RetryPolicy.from_config(Config(retry_max_attempts=1)) is None
    assert RetryPolicy.from_config(Config()).max_attempts == 3


@pytest.fixture
def registry():
    """The process-global metrics registry, fresh, and a fresh flight
    recorder."""
    saved = events.hub
    metrics.reset()
    events.hub = events.EventHub()
    yield metrics
    metrics.reset()
    events.hub = saved


def test_retry_call_counts_and_never_retries_device(registry):
    """Transient and data-loss failures retry (data loss counted in the
    registry, a ``retry`` event an attempt), a device fault or a fatal
    one propagates at once."""
    c = registry
    p = RetryPolicy(max_attempts=3, backoff_base_s=0.0)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise E.DataLossError("torn")
        return 7
    assert retry_call(flaky, p, "fetch", sleep=lambda s: None) == 7
    assert (c.get("retries_total"), c.get("retries_fetch"),
            c.get("data_loss_total")) == (2, 2, 2)
    for exc in (torch.cuda.OutOfMemoryError("CUDA out of memory"),
                E.FatalError("no")):
        calls.clear()

        def fail(exc=exc):
            calls.append(1)
            raise exc
        with pytest.raises(type(exc)):
            retry_call(fail, p, "dispatch", sleep=lambda s: None)
        assert len(calls) == 1
    with pytest.raises(E.TransientError):
        retry_call(lambda: (_ for _ in ()).throw(E.TransientError("x")),
                   p, "ingest", sleep=lambda s: None)
    assert c.get("retries_ingest") == 2
    assert [e["info"] for e in events.hub.dump()] == [
        "fetch:data_loss:1", "fetch:data_loss:2", "ingest:transient:1",
        "ingest:transient:2"]


def test_parse_plan_equals_reference(ref):
    """Every action parses as the reference parses it; malformed entries
    raise ``ValueError`` in both."""
    for text, want in zip(PLANS, ref["plans/specs"].tolist()):
        try:
            got = ",".join(str(s) for s in parse_plan(text))
        except ValueError as e:
            got = type(e).__name__
        assert got == want, text


def test_fault_actions_fire_once_and_count(registry):
    """Each armed fault fires once and is counted in the registry, with a
    ``fault.injected`` event; the stream selector keeps another stream's
    entries out."""
    c = registry
    inj = FaultInjector.from_plan(
        "ingest:raise@0,fetch:stall=0.01@1,other:dispatch:oom@0")
    assert not inj.armed("dispatch")
    with pytest.raises(E.TransientError):
        inj.fire("ingest", 0)
    inj.fire("ingest", 0)
    inj.fire("fetch", 1)
    assert c.get("faults_injected") == 2 and inj.unfired() == []
    assert [(e["type"], e["seg"]) for e in events.hub.dump()] == [
        ("fault.injected", 0), ("fault.injected", 1)]
    assert FaultInjector.from_plan("other:dispatch:oom@0") is None


def test_classifying_supervisor_equals_reference(ref, registry):
    """A fatal crash escalates at once; transient, data-loss and device
    crashes restart within the budget; the window expires old restarts:
    the reference's decisions on the same clock."""
    make = {"transient": E.TransientError, "fatal": E.FatalError,
            "data_loss": E.DataLossError, "device": E.DeviceOOM,
            "plain": RuntimeError}
    got = classifying_supervisor_script(
        Supervisor, [make[k]("crash") for k in SUPERVISOR_KINDS], 3,
        SUPERVISOR_TIMES)
    assert np.array_equal(got["decisions"], ref["supervisor/decisions"])
    assert got["restarts"] == int(ref["supervisor/restarts"])
    metrics.reset()
    sup = Supervisor("sink_drain")
    assert sup.should_restart(E.TransientError("x"))
    assert registry.get("worker_restarts_sink_drain") == 1
    assert registry.get("worker_restarts") == 1 and sup.restarts == 1


@pytest.mark.parametrize("name", sorted(DEGRADE))
def test_degradation_ladder_equals_reference(ref, name):
    """The same level sequence for the same observations."""
    high, low, hold, obs = DEGRADE[name]
    got = degrade_script(DegradationLadder, high, low, hold, obs)["levels"]
    assert np.array_equal(got, ref[f"degrade/{name}/levels"])
    with pytest.raises(ValueError):
        DegradationLadder(high=0.2, low=0.5)


def test_drop_oldest_buffer_equals_reference(ref):
    """A full buffer drops its oldest segment, counted by origin, and
    yields the freshest: the reference's accounting."""
    got = drop_oldest_script(DropOldestSegmentBuffer, 10, 3)
    assert np.array_equal(got["yielded"], ref["drop/yielded"])
    assert got["dropped"] == int(ref["drop/dropped"]) == 7
    assert np.array_equal(got["by_stream"], ref["drop/by_stream"])


def test_drop_oldest_loss_feeds_the_pipeline_counters(registry):
    """The buffer's drops land in the registry's ``segments_dropped`` and
    its loss window, which the degradation ladder reads, and in the
    twin labeled by the originating stream."""
    got = drop_oldest_script(DropOldestSegmentBuffer, 10, 3)
    assert got["dropped"] == 7
    assert registry.get("segments_dropped") == 7.0
    assert registry.window("segments_dropped").sum() == 7.0
    assert registry.by_label("segments_dropped") == dict(
        (k, float(v)) for k, v in got["by_stream"].tolist())


@pytest.mark.parametrize("layer", RESILIENCE_LAYERS)
def test_resilience_registry_and_events_equal_reference(ref, registry,
                                                        layer):
    """Each layer's counters and gauges (with their stream-labeled twins)
    and its flight-recorder events, for the same script: the
    reference's."""
    got = resilience_registry_script("srtb_tpu_torch", layer)
    assert got["snapshot"] == str(ref[f"registry/{layer}/snapshot"])
    assert got["events"].tolist() == ref[f"registry/{layer}/events"].tolist()


# ------------------------------------------------------ the ladder rungs

def composed_plan_name(cfg: Config, staged: bool | None = None) -> str:
    """The plan name the port's processor takes for ``cfg``, composed
    from its resolvers without building one (a 2^30 rung costs nothing);
    the small configs below hold it to the built processors' names."""
    n = int(cfg.baseband_input_count)
    staged = seg.staged_resolves(cfg, staged)
    tail = seg.fused_tail_resolves(cfg, staged)
    name = ("staged" if staged else "fused") + ":" + F.resolve_strategy(
        n, cfg.fft_strategy)
    if tail:
        name += "+ftail"
    if seg.front_fuse_resolves(cfg, staged):
        name += "+ffuse"
    channels = min(cfg.spectrum_channel_count, n // 2)
    if (tail and cfg.use_pallas and cfg.use_pallas_sk
            and KF.supported(n // 2 // channels, channels)):
        name += "+skzap"
    if str(cfg.ingest_ring).lower() != "off" and seg.ring_usable(cfg):
        name += "+ring"
    if str(cfg.search_mode).lower() == "periodicity":
        name += "+period"
    return name


@pytest.mark.parametrize("name", sorted(RUNGS))
def test_ladder_rungs_equal_reference(ref, name):
    """Each rung's step, staged argument and plan name equal the
    reference's in full, and ``check_plan`` takes every rung (the small
    configs also build each rung's processor and name it the same)."""
    fields, env, staged = RUNGS[name]
    cfg = Config(**fields)
    with environ(env):
        rungs = ladder_rungs(cfg, staged,
                             parse_ladder(RUNG_LADDER.get(name, "auto")))
        plans = [composed_plan_name(r.cfg, r.staged) for r in rungs]
        for r in rungs:
            seg.check_plan(r.cfg)
        if name in SMALL_RUNGS:
            from srtb_tpu_torch.pipeline import registry
            for r, plan in zip(rungs, plans):
                proc = registry.build_processor(r.cfg, device="cpu",
                                                staged=r.staged)
                assert proc.plan_name == plan
    assert [r.step for r in rungs] == [
        s for s in ref[f"rungs/{name}/steps"].tolist() if s]
    assert [str(r.staged) for r in rungs] == [
        s for s in ref[f"rungs/{name}/staged"].tolist() if s]
    assert plans == [s for s in ref[f"rungs/{name}/plans"].tolist() if s]


def test_every_ladder_step_is_covered():
    """The rung configs above reach every registered step."""
    steps = set()
    for name, (fields, env, staged) in RUNGS.items():
        with environ(env):
            steps |= {r.step for r in ladder_rungs(
                Config(**fields), staged,
                parse_ladder(RUNG_LADDER.get(name, "auto")))}
    assert steps == set(parse_ladder("auto")) == {
        "quality", "search_mode", "micro_batch", "front_fuse", "ring",
        "skzap", "fused_tail", "staged", "monolithic"}
    assert parse_ladder("off") == ()
    with pytest.raises(ValueError, match="plan_ladder step"):
        parse_ladder("ring,warp_drive")


# ------------------------------------------- degradation on a live run

def test_live_degradation_matches_reference(ref, registry, live_input):
    """A real-time run (no input file; a file reader stands in for the
    live source) whose every sink push stalls: the engine waits on the
    sink, and both packages' degradation ladders climb alike — the same
    level sequence, the same sheds (waterfall dumps withheld at level 1,
    the candidate writer skipped at level 2) and the same artifact set."""
    cfg = Config(**_live_fields(live_input, "port", True))
    source = make_file_source(Config(**_live_fields(live_input, "port",
                                                    False)))
    got = resilience_run(Pipeline, cfg,
                         lambda pipe, k: metrics.get(k),
                         capture=False, source=source, device="cpu")
    assert got["error"] == "" and str(ref["live/error"]) == ""
    assert got["levels"].tolist() == ref["live/levels"].tolist()
    assert got["levels"].tolist()[:7] == [0, 0, 0, 1, 1, 2, 2]
    for k in ("shed_waterfalls", "shed_baseband", "degrade_level",
              "degrade_steps", "segments_dropped"):
        assert got["counters"][k] == float(ref[f"live/counters/{k}"]), k
    assert got["files"].tolist() == ref["live/files"].tolist()
    # the positive segment 2 (level 0) dumps its waterfall, the positive
    # segments 3 and 4 (level 1) only their baseband and time series
    assert sum(f.endswith(".npy") for f in got["files"]) == 1
    assert sum(f.endswith(".bin") for f in got["files"]) == 3
    assert got["counters"]["shed_waterfalls"] == len(got["levels"]) - 3
    assert got["counters"]["shed_baseband"] == len(got["levels"]) - 5
