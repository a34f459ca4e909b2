"""The port's runtime sanitizer (``srtb_tpu_torch/analysis/sanitizer.py``
and ``Config.sanitize``; ROADMAP A9d), case for case with the JAX
package's ``tests/test_sanitizer.py``: a sanitized pipeline run passes on
clean input (serial and overlapped), while seeded violations — a NaN, an
implicit device-to-host read, a wrong-thread touch, a leaked thread — are
each trapped with the reference's messages (held to the reference's own
check functions through ``tests/test_torch_ref.py``'s runner).  Plus the
zero-cost-off contract: without ``sanitize`` the pipeline holds no
sanitizer and ``torch.Tensor`` stays unpatched.  The reference's two
use-after-donate cases have no counterpart (the port never donates an
input); a test holds that instead."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from srtb_tpu_torch.analysis import sanitizer as S
from srtb_tpu_torch.analysis.sanitizer import Sanitizer, SanitizerError
from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io.synth import make_dispersed_baseband_host
from srtb_tpu_torch.pipeline.runtime import Pipeline, ThreadedPipeline
from srtb_tpu_torch.pipeline.segment import SegmentProcessor
from test_torch_ref import run_reference

# ------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def synth_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sanitize")
    n = 1 << 14
    data = make_dispersed_baseband_host(n * 3, 1405.0, 64.0, 0.0,
                                        pulse_positions=n, nbits=8)
    path = str(tmp / "bb.bin")
    data.tofile(path)
    return path, n


def _cfg(path, n, tmp_path, tag, **extra):
    return Config(
        baseband_input_count=n,
        baseband_input_bits=8,
        baseband_freq_low=1405.0,
        baseband_bandwidth=64.0,
        baseband_sample_rate=128e6,
        input_file_path=path,
        baseband_output_file_prefix=str(tmp_path / f"{tag}_"),
        spectrum_channel_count=1 << 7,
        mitigate_rfi_average_method_threshold=100.0,
        mitigate_rfi_spectral_kurtosis_threshold=2.0,
        baseband_reserve_sample=False,
        writer_thread_count=0,
        sanitize=True,
        **extra)


class _NaNProcessor(SegmentProcessor):
    """The chain with a NaN in each segment's time series."""

    def _chain(self, raw):
        wf, res = super()._chain(raw)
        ts = res.time_series.clone()
        ts[..., 3] = float("nan")
        return wf, res._replace(time_series=ts)


# ------------------------------------------------- acceptance: clean


@pytest.mark.parametrize("window", [1, 3])
def test_sanitized_pipeline_passes_on_clean_input(
        synth_file, tmp_path, window):
    path, n = synth_file
    cfg = _cfg(path, n, tmp_path, f"ok{window}", inflight_segments=window)
    with Pipeline(cfg, device="cpu") as pipe:
        stats = pipe.run()
    assert stats.segments == 3
    # the tripwire uninstalled: torch.Tensor is pristine again
    assert not S.patched()


def test_sanitize_off_is_zero_cost(synth_file, tmp_path):
    path, n = synth_file
    cfg = _cfg(path, n, tmp_path, "off").replace(sanitize=False)
    pipe = Pipeline(cfg, sinks=[], device="cpu")
    assert pipe.sanitizer is None
    assert not pipe.processor._sanitize
    with pipe:
        assert pipe.run().segments == 3
    assert not S.patched()


# ------------------------------------------------------ NaN tripwire


def test_seeded_nan_is_trapped(synth_file, tmp_path):
    path, n = synth_file
    cfg = _cfg(path, n, tmp_path, "nan", inflight_segments=1)
    pipe = Pipeline(cfg, sinks=[],
                    processor=_NaNProcessor(cfg, device="cpu"))
    with pytest.raises(SanitizerError, match="non-finite.*detect"):
        pipe.run()
    pipe.close()
    assert not S.patched()


def test_seeded_nan_trapped_through_sink_pipe(synth_file, tmp_path):
    # overlapped: the tripwire fires on the sink thread and must still
    # fail the run loudly
    path, n = synth_file
    cfg = _cfg(path, n, tmp_path, "nan2", inflight_segments=2)
    pipe = Pipeline(cfg, sinks=[],
                    processor=_NaNProcessor(cfg, device="cpu"))
    with pytest.raises(SanitizerError, match="non-finite"):
        pipe.run()
    pipe.close()


# the units' cases, run through the reference's check functions too
FINITE_CASES = [("finite", "stage_x", [1.0, float("inf")]),
                ("finite", "ok", [0.0, 1.0, 2.0, 3.0])]
CONTRACT_CASES = [
    ("contract", "wf", (2, 1, 4, 4), "float32",
     {"ndim": 4, "lead": 2, "dtype": "float32"}),
    ("contract", "wf", (1, 4, 4), "float32", {"lead": 2}),
    ("contract", "wf", (1, 4, 4), "float32", {"ndim": 4}),
    ("contract", "wf", (2, 1, 4, 4), "int32", {"dtype": "float32"})]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jobs = [{"key": "messages", "fn": "test_torch_ref:sanitizer_messages",
             "args": [FINITE_CASES + CONTRACT_CASES]}]
    return run_reference(jobs, tmp_path_factory.mktemp("ref_sanitize"))


def _port_message(case) -> str:
    try:
        if case[0] == "finite":
            S.check_finite(case[1], torch.tensor(case[2]))
        else:
            _kind, tag, shape, dtype, kwargs = case
            kwargs = dict(kwargs)
            if "dtype" in kwargs:
                kwargs["dtype"] = getattr(torch, kwargs["dtype"])
            S.check_contract(tag, torch.zeros(shape,
                                              dtype=getattr(torch, dtype)),
                             **kwargs)
        return ""
    except SanitizerError as e:
        return str(e)


def test_check_finite_device_and_contract_units(ref):
    """The reference's unit cases, each tripping (or not) as the
    reference's check does, with the message the reference's test
    matches."""
    with pytest.raises(SanitizerError, match="stage_x"):
        S.check_finite("stage_x", torch.tensor([1.0, float("inf")]))
    S.check_finite("ok", torch.arange(4.0))            # clean
    S.check_finite("ints", torch.arange(4))            # non-float leaf
    S.check_finite("host ints", np.arange(4))
    with pytest.raises(SanitizerError, match="non-finite"):
        S.check_finite("complex", torch.tensor([1 + 1j, complex("nan")]))
    wf = torch.zeros(2, 1, 4, 4)
    S.check_contract("wf", wf, ndim=4, lead=2, dtype=torch.float32)
    with pytest.raises(SanitizerError, match="leading axis 2"):
        S.check_contract("wf", wf[0], lead=2)
    with pytest.raises(SanitizerError, match="expected ndim 4"):
        S.check_contract("wf", wf[0], ndim=4)
    with pytest.raises(SanitizerError, match="dtype drift"):
        S.check_contract("wf", wf.to(torch.int32), dtype=torch.float32)
    for i, case in enumerate(FINITE_CASES + CONTRACT_CASES):
        got, want = _port_message(case), str(ref[f"messages/{i}"])
        assert bool(got) == bool(want), case
        # the same sentence up to the boundary's representation (the
        # reference stacks (re, im), the port carries streams)
        assert got.split(" (")[0] == want.split(" (")[0], case


# ----------------------------------------- implicit-transfer tripwire


def test_implicit_transfer_trapped_direct():
    san = Sanitizer()
    x = torch.arange(8.0)
    with san.run_scope("cpu"):
        with pytest.raises(SanitizerError, match="implicit.*transfer"):
            np.asarray(x)
        with pytest.raises(SanitizerError, match="implicit"):
            np.array(x)
        for read in (x.numpy, x[3].item, x.tolist):
            with pytest.raises(SanitizerError, match="implicit"):
                read()
        # the sanctioned explicit spelling stays allowed
        from srtb_tpu_torch.io.writers import to_host
        assert to_host(x)[3] == 3.0
        # within the device, no transfer
        assert x.cpu() is x and x.to(torch.float64).dtype == torch.float64
        # host data is unaffected
        assert np.asarray([1, 2]).sum() == 3
    # restored after the scope
    assert np.asarray(x)[1] == 1.0


def test_implicit_transfer_in_sink_trapped(synth_file, tmp_path):
    path, n = synth_file

    class BadSink:
        def push(self, work, positive):
            np.asarray(work.waterfall)  # an implicit read of the waterfall

    cfg = _cfg(path, n, tmp_path, "bad", inflight_segments=2)
    pipe = Pipeline(cfg, sinks=[BadSink()], device="cpu")
    with pytest.raises(SanitizerError, match="to_host"):
        pipe.run()
    pipe.close()
    assert not S.patched()


def test_nested_scopes_refcount():
    a, b = Sanitizer(), Sanitizer()
    x = torch.arange(4.0)
    with a.run_scope("cpu"):
        with b.run_scope("cpu"):
            with pytest.raises(SanitizerError):
                np.asarray(x)
        # still armed: the outer scope is alive
        with pytest.raises(SanitizerError):
            np.asarray(x)
    assert np.asarray(x)[0] == 0.0


# ---------------------------------------------- the chain's boundaries


def _small_cfg(tmp_path, **extra):
    return Config(baseband_input_count=1 << 12,
                  baseband_input_bits=8,
                  baseband_freq_low=1405.0, baseband_bandwidth=64.0,
                  baseband_sample_rate=128e6,
                  spectrum_channel_count=1 << 6,
                  baseband_reserve_sample=False,
                  baseband_output_file_prefix=str(tmp_path / "d_"),
                  **extra)


def test_staged_boundary_checks_run(tmp_path, monkeypatch):
    cfg = _small_cfg(tmp_path, sanitize=True)
    proc = SegmentProcessor(cfg, staged=True, device="cpu")
    raw = proc.stage_input(
        np.random.default_rng(1).integers(
            0, 255, cfg.baseband_input_count, dtype=np.uint8))
    seen = []
    boundary = SegmentProcessor._boundary
    monkeypatch.setattr(SegmentProcessor, "_boundary",
                        lambda self, tag, spec: (seen.append(tag),
                                                 boundary(self, tag, spec)))
    wf, _det = proc.run_device(raw)   # contracts + finite per boundary
    assert wf.shape[0] == 1
    assert seen == ["stage_a boundary", "stage_b boundary"]
    spectrum = SegmentProcessor._spectrum

    def nan_spectrum(self, raw):
        spec = spectrum(self, raw)
        spec[0, 7] = float("nan")
        return spec
    monkeypatch.setattr(SegmentProcessor, "_spectrum", nan_spectrum)
    with pytest.raises(SanitizerError, match="stage_a boundary"):
        proc.run_device(raw)


def test_processor_has_no_donation(tmp_path):
    """The reference expires a donated input under the sanitizer; the port
    donates nothing: a staged input stays readable and unchanged after a
    sanitized dispatch, and the plan signature names the port, not the
    JAX package's donation flag."""
    cfg = _small_cfg(tmp_path, sanitize=True)
    proc = SegmentProcessor(cfg, staged=True, device="cpu")
    raw = proc.stage_input(np.random.default_rng(0).integers(
        0, 255, cfg.baseband_input_count, dtype=np.uint8))
    before = raw.clone()
    proc.run_device(raw)
    assert torch.equal(raw, before)
    sig = proc.plan_signature()
    assert "donate" not in sig and '"port": "torch-v1"' in sig


# ------------------------------------------------- thread ownership


def test_thread_ownership_guard():
    san = Sanitizer()
    san.assert_owner("inflight_window")      # main claims
    san.assert_owner("inflight_window")      # same thread: fine
    err = []

    def intruder():
        try:
            san.assert_owner("inflight_window")
        except SanitizerError as e:
            err.append(e)

    t = threading.Thread(target=intruder)
    t.start()
    t.join()
    assert err and "thread-ownership violation" in str(err[0])
    san.release_owners()
    # after release the state is claimable again
    san.assert_owner("inflight_window")


def test_threaded_engine_owners_are_its_pipes(synth_file, tmp_path,
                                              monkeypatch):
    """A sanitized threaded run passes on clean input, and its owner
    checks run on its own pipes: the dispatch window on the device pipe,
    the sink side on the drain pipe, each on one thread only."""
    seen = {}
    claim = Sanitizer.assert_owner

    def recording(self, name):
        seen.setdefault(name, set()).add(threading.current_thread().name)
        claim(self, name)

    monkeypatch.setattr(Sanitizer, "assert_owner", recording)
    path, n = synth_file
    cfg = _cfg(path, n, tmp_path, "threaded")
    with ThreadedPipeline(cfg, device="cpu") as pipe:
        assert pipe.run().segments == 3
    assert not S.patched()
    assert set(seen) == {"inflight_window", "sink_drain"}
    (device,), (drain,) = seen["inflight_window"], seen["sink_drain"]
    assert "device" in device and "drain" in drain


# ------------------------------------------------ leaked-thread check


def test_leaked_thread_trapped():
    san = Sanitizer()
    stop = threading.Event()
    leaker = threading.Thread(target=stop.wait, name="leaky_sink",
                              daemon=True)
    try:
        with pytest.raises(SanitizerError, match="leaky_sink"):
            with san.run_scope("cpu"):
                leaker.start()
    finally:
        stop.set()
        leaker.join()


def test_joined_thread_is_clean():
    san = Sanitizer()
    with san.run_scope("cpu"):
        t = threading.Thread(target=lambda: time.sleep(0.01))
        t.start()
        t.join()


def test_leaked_threads_helper_allows_pools():
    from srtb_tpu_torch.utils import termination
    snap = termination.thread_snapshot()
    done = threading.Event()
    t = threading.Thread(target=done.wait,
                         name="ThreadPoolExecutor-9_0", daemon=True)
    t.start()
    try:
        assert termination.leaked_threads(snap, grace_s=0.0) == []
    finally:
        done.set()
        t.join()


# ------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_sanitized_run_on_the_card(synth_file, tmp_path):
    """On the card: a clean sanitized run passes (its dispatch under
    ``set_sync_debug_mode("error")``), a sink's ``.cpu()`` of the device
    waterfall trips, and nothing stays patched or armed."""
    path, n = synth_file
    cfg = _cfg(path, n, tmp_path, "card", inflight_segments=2)
    with Pipeline(cfg) as pipe:
        assert pipe.run().segments == 3

    class CpuSink:
        def push(self, work, positive):
            work.waterfall.cpu()

    pipe = Pipeline(cfg, sinks=[CpuSink()])
    with pytest.raises(SanitizerError, match="implicit"):
        pipe.run()
    pipe.close()
    assert not S.patched() and torch.cuda.get_sync_debug_mode() == 0
