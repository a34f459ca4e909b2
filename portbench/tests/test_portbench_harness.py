"""The harness's own arithmetic and files, on the CPU: the manifest's
names, the paced source's schedule, the window's rates, the
roofline counts and the trace reduction, and that a cell, a traffic mix
and a metric are added by files alone."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from portbench import manifest as M
from portbench import roofline, stats
from portbench.sources import PacedSource, ReplaySource
from portbench.trace import merge, reduce_device, reduce_events

ROOT = Path(__file__).resolve().parents[2]


def test_manifest_names_and_units():
    man = M.load_manifest(ROOT)
    assert M.check_names(man) == []
    for m in man["end_to_end"] + man["per_layer"]:
        assert M.UNIT_RE.match(m["unit"]), m
        assert len(m["unit"]) <= 16
    assert M.UNIT_RE.match("Msamples/s") and M.UNIT_RE.match("%")
    assert not M.UNIT_RE.match("samples per second")
    assert not M.NAME_RE.match("a b") and not M.NAME_RE.match("a/b")


def test_every_named_file_is_found():
    man = M.load_manifest(ROOT)
    for w in man["workloads"]:
        assert M.config(w["config"], ROOT)["cfg"]
        assert M.traffic(w["traffic"], ROOT)["loop"] in ("closed", "open")
        assert M.limits(w["name"], ROOT)
        for kind in ("end_to_end", "per_layer"):
            assert M.cell_metrics(man, w["name"], kind)
    for m in man["per_layer"]:
        assert callable(M.metric_reader(m["name"], ROOT))
    for c in man["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_a_cell_is_added_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    man = M.load_manifest(ROOT)
    man["workloads"].append({"name": "j1644.dummy", "config": "j1644_2bit",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "a test cell"})
    man["per_layer"].append({"name": "dummy_metric", "unit": "ms",
                             "better": "lower", "source": "host_clock",
                             "layer": "engine", "moves": "throughput_msps",
                             "workloads": ["j1644.dummy"]})
    man["end_to_end"][0]["workloads"].append("j1644.dummy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    mix = dict(M.traffic("replay_dumps", ROOT), warmup_segments=2)
    (tmp_path / "portbench" / "traffic" / "dummy_mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "portbench" / "limits" / "j1644.dummy.json").write_text(
        json.dumps(M.limits("j1644.replay", ROOT)))
    (tmp_path / "portbench" / "metrics" / "dummy_metric.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    man2 = M.load_manifest(tmp_path)
    assert M.check_names(man2) == []
    names = [m["name"] for m in M.cell_metrics(man2, "j1644.dummy",
                                                "per_layer")]
    assert names == ["dummy_metric"]
    assert M.metric_reader("dummy_metric", tmp_path)({}) == 1.5
    assert M.traffic("dummy_mix", tmp_path)["warmup_segments"] == 2


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def test_paced_source_schedule_and_due_times():
    clock = FakeClock()
    bank = _TinyBank()
    period = 1.048576
    srcs = [PacedSource(bank, i, period, i * period / 4, 100.0, 100.0 + 5.5,
                        clock=clock, sleep=clock.sleep) for i in range(4)]
    # segment k of beam i is due at t_start + i P / 4 + (k + 1) P
    assert srcs[2].due_time(0) == pytest.approx(100.0 + 0.5 * period
                                                + period)
    got = [next(srcs[0]) for _ in range(3)]
    assert [w.bench_key for w in got] == [(0, 0), (0, 1), (0, 2)]
    # a request before the due time waits for it, never hands out early
    for k in range(3):
        assert srcs[0].taken[k] == pytest.approx(srcs[0].due[k])
    # a late request gets its segment at once: the schedule does not slow
    clock.t += 3 * period
    w = next(srcs[0])
    assert srcs[0].taken[3] > srcs[0].due[3] + 2 * period
    assert w.bench_key == (0, 3)
    # it ends with the last segment due by the end of the window
    with pytest.raises(StopIteration):
        for _ in range(10):
            next(srcs[0])
    assert max(srcs[0].due.values()) <= 105.5


def test_replay_source_completions_and_deadline():
    clock = FakeClock()
    src = ReplaySource(_TinyBank(), clock=clock)
    src.arm(0, deadline=100.8)
    for _ in range(3):
        next(src)
        clock.t += 0.3
    with pytest.raises(StopIteration):
        next(src)
    done = src.completions()
    assert sorted(done) == [0, 1, 2]
    # each segment is done when the engine asks for the next
    assert done[0] == pytest.approx(100.3) and done[2] == pytest.approx(
        100.9)


def test_rates_over_a_window_with_a_stall():
    # 10 items done at 0.1 s, then a 2 s stall, then 10 more
    done = [0.1 * i for i in range(1, 11)] + [3.0 + 0.1 * i
                                              for i in range(10)]
    assert stats.window_rate(done, 0.0, 4.0, 1e6) == pytest.approx(
        20 * 1e6 / 4.0)
    # the item in progress at the close counts for the share of its wait
    # inside the window (1.0 to 3.0, closed at 2.0), work after it not
    assert stats.window_rate(done, 0.0, 2.0, 1.0) == pytest.approx(10.5 / 2)
    assert stats.window_rate(done, 1.0, 1.0, 1.0, start=0.0) == \
        pytest.approx(0.5)
    # a serial loop, one item every 0.283 s from the start: the rate is
    # the loop's whatever the phase at which the window closes
    for seconds in (29.9, 30.0, 30.1, 30.2):
        ts = [0.283 * (k + 1) for k in range(120)]
        assert stats.window_rate(ts, 0.0, seconds, 1.0) == pytest.approx(
            1 / 0.283)


def test_roofline_counts():
    # a float32 R2C of 2^27 reads 512 MiB and writes (2^26 + 1) complex64
    n = 1 << 27
    b, f = roofline.op_cost("aten::_fft_r2c", [[n]], ["float"])
    assert b == 4 * n + 8 * (n // 2 + 1)
    assert f == pytest.approx(2.5 * n * 27)
    b, f = roofline.op_cost("aten::_fft_c2c", [[2048, 32768]],
                            ["c10::complex<float>"])
    assert b == 2 * 8 * 2048 * 32768
    assert f == pytest.approx(5 * 32768 * 15 * 2048)
    # elementwise: inputs read, one output written at the widest size
    b, _ = roofline.op_cost("aten::mul", [[1000], []], ["float", "Scalar"])
    assert b == 8000
    b, _ = roofline.op_cost("aten::gt", [[1000], [1]], ["float", "float"])
    assert b == 4000 + 4 + 1000
    b, _ = roofline.op_cost("aten::sum", [[1000]], ["float"])
    assert b == 4000
    b, _ = roofline.op_cost("aten::fill_", [[1000], []], ["float", "Scalar"])
    assert b == 4000
    assert roofline.op_cost("aten::empty", [[]], ["ScalarList"]) is None
    geo = {"n": n, "m": n // 2, "nbits": 2, "masked": True}
    b, _ = roofline.port_kernel_cost("void unpack_subbyte_window_kernel<2>"
                                     "(unsigned char const*)", geo)
    assert b == n // 4 + 4 * n
    b, _ = roofline.port_kernel_cost("rfi_s1_dedisperse_kernel", geo)
    assert b == 16 * (n // 2) + n // 2
    assert roofline.port_kernel_cost("some_other_kernel", geo) is None
    # the time bound: the larger of the two
    assert roofline.bound_s(3.35e12, 0, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12, 67e12) == pytest.approx(1.0)


class _Ev:
    def __init__(self, name, kind, start, end, corr=0, link=0, shapes=(),
                 dtypes=()):
        self._v = (name, kind, start, end, corr, link, list(shapes),
                   list(dtypes))

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def device_type(self):
        on_device = self._v[1] in ("kernel", "gpu_memcpy",
                                   "gpu_user_annotation")
        return "DeviceType.CUDA" if on_device else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._v[1] in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def shapes(self):
        return self._v[6]

    def dtypes(self):
        return self._v[7]


class _OldEv(_Ev):
    """A profiler without ``activity_type``: the kinds are worked out."""

    def activity_type(self):
        raise AttributeError("activity_type")


@pytest.mark.parametrize("event", [_Ev, _OldEv])
def test_trace_reduction(event):
    _Ev = event  # noqa: N806 - the event class under test
    ms = 1_000_000
    n = 1 << 20
    evs = [
        _Ev("portbench:window", "user_annotation", 0, 100 * ms),
        _Ev("srtb:dispatch", "user_annotation", 0, 40 * ms, corr=1),
        _Ev("aten::mul", "cpu_op", 1 * ms, 2 * ms, corr=2,
            shapes=[[n], []], dtypes=["float", "Scalar"]),
        _Ev("srtb:sink", "user_annotation", 60 * ms, 90 * ms, corr=3),
        # a kernel of the mul, one of the port's own, a copy, and a
        # kernel nobody launched in the model; one starts before the window
        _Ev("vectorized_elementwise_kernel", "kernel", 10 * ms, 20 * ms,
            link=2),
        _Ev("rfi_s1_dedisperse_kernel", "kernel", 15 * ms, 30 * ms, link=1),
        _Ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 50 * ms,
            55 * ms),
        _Ev("mystery", "kernel", -5 * ms, 5 * ms),
        _Ev("srtb:dispatch", "gpu_user_annotation", 0, 100 * ms),
    ]
    geo = {"n": n, "m": n // 2, "nbits": 2, "masked": False}
    s = reduce_events(evs, geo)
    assert s.window_s == pytest.approx(0.1)
    # busy: [0, 5] + [10, 30] + [50, 55] ms
    assert s.busy_s == pytest.approx(0.030)
    assert s.kernel_s == pytest.approx(0.005 + 0.010 + 0.015)
    assert s.h2d_s == pytest.approx(0.005)
    assert s.unmodeled_s == pytest.approx(0.005)
    bound = (8 * n + 16 * (n // 2)) / roofline.PEAK["hbm_bytes_per_s"]
    assert s.bound_s == pytest.approx(bound)
    assert s.bound_s < s.kernel_s
    gaps = dict(s.idle_gaps)
    # [5, 10] and [30, 50] under the dispatch range... [30, 50] has its
    # middle (40) at the dispatch range's end; [55, 100] under the sink's
    assert gaps["srtb:dispatch"] == pytest.approx(0.025)
    assert gaps["srtb:sink"] == pytest.approx(0.045)
    assert s.device_ops[0][0] == "rfi_s1_dedisperse_kernel"


@pytest.mark.parametrize("event", [_Ev, _OldEv])
def test_device_capture_reduction(event):
    _Ev = event  # noqa: N806 - the event class under test
    ms = 1_000_000
    evs = [
        # the device capture holds the host's runtime calls at most
        _Ev("cudaLaunchKernel", "cuda_runtime", 0, 1 * ms, corr=1),
        _Ev("vectorized_elementwise_kernel", "kernel", 2 * ms, 10 * ms,
            link=1),
        _Ev("rfi_s1_dedisperse_kernel", "kernel", 8 * ms, 20 * ms),
        _Ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 30 * ms,
            34 * ms),
        _Ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 40 * ms,
            41 * ms),
    ]
    s = reduce_device(evs, 0.1)
    assert s.window_s == pytest.approx(0.1)
    # busy: [2, 20] + [30, 34] + [40, 41] ms
    assert s.busy_s == pytest.approx(0.023)
    assert s.kernel_s == pytest.approx(0.008 + 0.012)
    assert s.h2d_s == pytest.approx(0.004)
    assert [n for n, _ in s.device_ops] == ["rfi_s1_dedisperse_kernel",
                                           "vectorized_elementwise_kernel"]
    assert s.bound_s == 0.0 and s.idle_gaps == []
    # the full capture gives the roofline's times and the idle gaps only
    from portbench.trace import TraceSummary
    full = TraceSummary(window_s=0.05, busy_s=0.04, kernel_s=0.03,
                        bound_s=0.015, unmodeled_s=0.001,
                        idle_gaps=[["srtb:dispatch", 0.01]])
    m = merge(s, full)
    assert (m.window_s, m.busy_s, m.h2d_s) == (s.window_s, s.busy_s,
                                                s.h2d_s)
    assert (m.kernel_s, m.bound_s, m.idle_gaps) == (0.03, 0.015,
                                                    [["srtb:dispatch", 0.01]])
    assert m.device_ops == s.device_ops


def test_untraced_idle_share():
    from portbench import readers
    from portbench.trace import TraceSummary
    # 5 ms busy a segment in the device capture; the untraced phase
    # drained 150 segments in 1 s, so the card was busy 0.75 s of it
    ctx = {"trace": TraceSummary(window_s=1.0, busy_s=0.5), "segments": 100,
           "run_segments": 150, "rest_s": 1.0}
    assert readers.untraced_idle_share(ctx) == pytest.approx(25.0)
    assert readers.idle_share(ctx) == pytest.approx(50.0)
    # nothing to read, nothing returned
    assert readers.untraced_idle_share(dict(ctx, run_segments=0)) is None
    assert readers.untraced_idle_share(dict(ctx, trace=None)) is None


class _TinyBank:
    nbytes = 16

    def __init__(self):
        import numpy as np
        self.seg = np.zeros(16, dtype=np.uint8)

    def bytes_of(self, stream, index):
        return self.seg

    def segment_ns(self):
        return 1_000_000
