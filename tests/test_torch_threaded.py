"""The port's ``ThreadedPipeline`` (``srtb_tpu_torch/pipeline/runtime.py``,
ROADMAP A9d) against the JAX package's: the same input and settings
through both packages' threaded engine and the port's in-flight
``Pipeline`` — a clean run (the same decisions, artifact names, counters,
and each segment's time series within the gates of
``tests/test_torch_segment.py``), an out-of-memory at a dispatch (one
demotion, the retained segment re-dispatched, decisions equal to the
clean run's), the promotion probe paced by the drain, a device halt
(escalated: this engine has no window to re-dispatch from) and the span
journal (no ``device_ms``: the dispatch and the fetch run on two
threads).  Then the port's own properties: the completion wait outlasts
``shutdown_join_timeout_s``, a wedged drain does not hang the run, and a
long threaded UDP run keeps its buffer pool's block count bounded."""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import formats
from srtb_tpu_torch.io.udp import UdpReceiverSource
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.pipeline import runtime as R
from srtb_tpu_torch.utils.metrics import metrics
from test_torch_ref import resilience_run, run_reference
from test_torch_resilience import SEGMENTS, engine_fields, write_pulsed_input

# (overrides, capture): every run at the reference's defaults otherwise
SCENARIOS = {
    "clean": (dict(), True),
    "oom_dispatch": (dict(fault_plan="dispatch:oom@1"), True),
    "promotion": (dict(fault_plan="dispatch:oom@1",
                       promote_after_segments=1), True),
    "halt_dispatch": (dict(fault_plan="dispatch:device_halt@2"), True),
    "journal": (dict(telemetry_journal_path="spans.jsonl"), True),
}


def _fields(tmp, name: str) -> dict:
    overrides = dict(SCENARIOS[name][0])
    if "telemetry_journal_path" in overrides:
        overrides["telemetry_journal_path"] = os.path.join(
            str(tmp), name, overrides["telemetry_journal_path"])
    return engine_fields(tmp, name, **overrides)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("threaded")
    write_pulsed_input(tmp)
    return tmp


@pytest.fixture(scope="module")
def ref(tmp_path_factory, work):
    base = work / "ref"
    os.makedirs(base, exist_ok=True)
    jobs = []
    for name, (_o, capture) in SCENARIOS.items():
        fields = _fields(base, name)
        fields["input_file_path"] = str(work / "bb.bin")
        jobs.append({"key": name, "fn": "test_torch_ref:ref_threaded_run",
                     "args": [fields],
                     "kwargs": {"capture": capture,
                                "journal": name == "journal"}})
    return run_reference(jobs, tmp_path_factory.mktemp("ref_threaded"),
                         compile_cache=True)


def _port_run(base, name: str, cls, capture: bool = True) -> dict:
    fields = _fields(base, name)
    metrics.reset()
    try:
        return resilience_run(cls, Config(**fields),
                              lambda pipe, k: metrics.get(k), capture,
                              device="cpu")
    finally:
        metrics.reset()


@pytest.fixture(scope="module")
def port(work):
    """The port's threaded runs, and its in-flight engine's clean run."""
    base = work / "port"
    os.makedirs(base, exist_ok=True)
    os.symlink(work / "bb.bin", base / "bb.bin")
    out = {name: _port_run(base, name, R.ThreadedPipeline, capture)
           for name, (_o, capture) in SCENARIOS.items()}
    async_base = work / "async"
    os.makedirs(async_base, exist_ok=True)
    os.symlink(work / "bb.bin", async_base / "bb.bin")
    out["async"] = _port_run(async_base, "clean", R.Pipeline)
    return out


def _strip(a) -> list:
    return [x for x in np.asarray(a).tolist() if x != ""]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_threaded_matches_reference(ref, port, name):
    """The run ends as the reference's threaded engine's does (a halt
    escalates with the card's own error), with the same counters, rungs,
    artifacts and decisions."""
    got = port[name]
    want_error = str(ref[f"{name}/error"])
    if name == "halt_dispatch":
        assert got["error"] and want_error
    else:
        assert got["error"] == want_error == ""
    for k, v in got["counters"].items():
        assert v == float(ref[f"{name}/counters/{k}"]), k
    assert _strip(got["plans"]) == _strip(ref[f"{name}/plans"])
    assert _strip(got["files"]) == _strip(ref[f"{name}/files"])
    assert got["segments"] == int(ref[f"{name}/segments"])
    for key in ("signal_counts", "zero_count", "positive"):
        assert np.array_equal(got[key], ref[f"{name}/{key}"]), key


@pytest.mark.parametrize("name", ["clean", "oom_dispatch", "promotion"])
def test_threaded_time_series_within_the_segment_gates(ref, port, name):
    """Each segment's waterfall within 2e-5 of its largest value and its
    time series within ``time_series_error_gates`` of the reference's."""
    got = port[name]
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


def test_threaded_equals_the_in_flight_engine(port):
    """The threaded engine's clean run is the in-flight engine's, bit for
    bit, with the same artifacts."""
    got, want = port["clean"], port["async"]
    assert got["segments"] == want["segments"] >= SEGMENTS
    for key in ("signal_counts", "zero_count", "time_series", "waterfall",
                "positive"):
        assert np.array_equal(got[key], want[key]), key
    assert _strip(got["files"]) == _strip(want["files"])


def test_threaded_demotion_keeps_the_clean_decisions(port):
    """``dispatch:oom@1`` demotes once and re-dispatches the retained
    segment: the decisions and series are the clean run's, exactly; the
    promotion probe steps back up."""
    clean = port["clean"]
    for name in ("oom_dispatch", "promotion"):
        got = port[name]
        assert got["counters"]["plan_demotions"] == 1
        assert got["segments"] == clean["segments"]
        for key in ("signal_counts", "zero_count", "time_series",
                    "positive"):
            assert np.array_equal(got[key], clean[key]), key
    assert _strip(port["oom_dispatch"]["plans"]) == ["fused:monolithic"]
    assert port["promotion"]["counters"]["plan_promotions"] >= 1
    assert port["halt_dispatch"]["counters"]["device_reinits"] == 0


def test_threaded_spans_omit_device_time(ref, port, work):
    """The threaded engine measures no dispatch-to-ready time: its spans
    omit ``device_ms`` and ``roofline_frac`` (never a fake 0), as the
    reference's do, and carry the compile books and every key of the
    reference's spans."""
    import json
    path = os.path.join(str(work), "port", "journal", "spans.jsonl")
    with open(path) as f:
        spans = [json.loads(line) for line in f]
    assert len(spans) == port["journal"]["segments"] >= SEGMENTS
    for s in spans:
        assert s["v"] == 11
        assert "device_ms" not in s and "roofline_frac" not in s
        assert "compile_ms" in s and "plan_compiles" in s
    want = json.loads(str(ref["journal/span_keys"]))
    assert len(want) == len(spans)
    for keys, s in zip(want, spans):
        assert "device_ms" not in keys and set(keys) <= set(s)


# ------------------------------------------------ the port's own properties

def _small_cfg(tmp, tag: str, **overrides) -> Config:
    return Config(**engine_fields(tmp, tag, **overrides))


class _SlowSink:
    def __init__(self, delay: float):
        self.delay = delay
        self.pushed = 0

    def push(self, work, positive):
        time.sleep(self.delay)
        self.pushed += 1


def test_threaded_completion_join_not_truncated_by_budget(work):
    """The completion wait lasts the whole run: a healthy run longer than
    ``shutdown_join_timeout_s`` is not cut short; the budget bounds only
    a drain wedged on one item.  Each push takes a fifth of the budget,
    the run as a whole longer than it."""
    metrics.reset()
    sink = _SlowSink(0.4)
    cfg = _small_cfg(work, "complete", shutdown_join_timeout_s=2.0)
    with R.ThreadedPipeline(cfg, sinks=[sink], device="cpu") as pipe:
        stats = pipe.run()
    assert stats.elapsed_s > cfg.shutdown_join_timeout_s
    assert stats.segments == sink.pushed >= SEGMENTS
    assert metrics.get("segments_dropped") == 0
    assert not pipe._sink_wedged
    metrics.reset()


def test_threaded_shutdown_join_is_bounded_on_wedged_sink(work):
    """A drain wedged inside one sink push does not hang ``run()``; the
    final sink drain is skipped."""

    class _WedgedSink:
        def __init__(self):
            self.release = threading.Event()
            self.entered = threading.Event()

        def push(self, work, positive):
            self.entered.set()
            self.release.wait(60.0)

    metrics.reset()
    sink = _WedgedSink()
    cfg = _small_cfg(work, "wedge", shutdown_join_timeout_s=0.25)
    t0 = time.monotonic()
    pipe = R.ThreadedPipeline(cfg, sinks=[sink], device="cpu")
    try:
        pipe.run(max_segments=3)
        assert time.monotonic() - t0 < 20.0
        assert sink.entered.is_set() and pipe._sink_wedged
    finally:
        sink.release.set()
        pipe.close()
    metrics.reset()


def _udp_cfg(tmp, port: int = 0) -> Config:
    """A small 8-bit fastmb_roach2 stream: 2 packets a segment (port 0:
    the receiver binds the one the OS gives)."""
    return Config(baseband_input_count=1 << 13, baseband_input_bits=8,
                  baseband_format_type="fastmb_roach2",
                  baseband_freq_low=1405.0, baseband_bandwidth=64.0,
                  baseband_sample_rate=128e6, dm=0.0,
                  spectrum_channel_count=1 << 5,
                  baseband_reserve_sample=False,
                  udp_receiver_address=["127.0.0.1"],
                  udp_receiver_port=[port], udp_packet_provider="recvfrom",
                  baseband_output_file_prefix=os.path.join(str(tmp),
                                                           "udp", "out_"),
                  writer_thread_count=0, gui_enable=False)


def test_threaded_udp_pool_stays_bounded(work):
    """A long threaded run on a UDP source allocates its pool's buffers
    once (the graph's ``HELD_SEGMENTS``) and releases every segment's
    buffer back to it: 40 segments later the pool holds as many blocks
    as it started with."""
    os.makedirs(os.path.join(str(work), "udp"), exist_ok=True)
    cfg = _udp_cfg(work)
    fmt = formats.resolve(cfg.baseband_format_type)
    segments = 40
    src = UdpReceiverSource(cfg)
    port = src.port
    assert port != 0
    pipe = R.ThreadedPipeline(cfg, source=src, device="cpu")
    blocks = [src.pool.stats()]
    assert blocks[0]["cached_blocks"] == R.ThreadedPipeline.HELD_SEGMENTS
    stop = threading.Event()

    def send():
        # counter-sequential packets until the run ends: a lost packet
        # only zeroes its slot, and a later one always closes the block
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            payload = bytes(fmt.payload_bytes)
            c = 0
            while not stop.is_set():
                tx.sendto(struct.pack("<Q", c) + payload,
                          ("127.0.0.1", port))
                c += 1
                if c % 16 == 0:
                    time.sleep(0.002)
    sender = threading.Thread(target=send, daemon=True)
    sender.start()
    try:
        stats = pipe.run(max_segments=segments)
        blocks.append(src.pool.stats())
    finally:
        stop.set()
        sender.join(30)
        src.close()
        pipe.close()
    assert stats.segments == segments
    end = blocks[-1]
    assert end["in_use"] == 0
    assert end["cached_blocks"] == R.ThreadedPipeline.HELD_SEGMENTS


# ------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_threaded_on_the_card_equals_the_in_flight_engine(tmp_path):
    """On the card the threaded engine's decisions, series and artifact
    names are the in-flight engine's, and its device thread launched the
    plan's kernels."""
    from srtb_tpu_torch import kernels as K
    write_pulsed_input(tmp_path)
    out = {}
    for name, cls in (("threaded", R.ThreadedPipeline),
                      ("async", R.Pipeline)):
        os.makedirs(tmp_path / name, exist_ok=True)
        fields = engine_fields(tmp_path, name, use_pallas=True,
                               use_pallas_sk=True)
        metrics.reset()
        K.reset_launch_counts()
        out[name] = resilience_run(cls, Config(**fields),
                                   lambda pipe, k: metrics.get(k), True,
                                   device="cuda")
        out[name]["launches"] = sum(K.launch_counts().values())
    got, want = out["threaded"], out["async"]
    assert got["error"] == want["error"] == ""
    assert got["segments"] == want["segments"] >= SEGMENTS
    assert got["launches"] == want["launches"] > 0
    for key in ("signal_counts", "zero_count", "positive"):
        assert np.array_equal(got[key], want[key]), key
    assert np.allclose(got["time_series"], want["time_series"], rtol=1e-5,
                       atol=1e-5 * np.abs(want["time_series"]).max())
