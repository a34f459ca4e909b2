"""The port's measuring tools on the CPU (ROADMAP A9c):
``srtb-torch-trace-summary`` (``tools/trace_summary.py``) on a synthetic
Chrome trace (exact buckets, the port's kernels in the reference's
``pallas_fft`` bucket, cuFFT's in ``fft``) and on a real CPU
``torch.profiler`` trace of a 2^16 run (buckets summing to the total);
``srtb-torch-kernel-bench``, ``srtb-torch-fft-bench`` and
``srtb-torch-bench`` with ``--device cpu`` at 2^16 (their JSON keys; the
bench's roofline model the JAX package's ``bench.py``'s, run in the
reference's interpreter), each failing without a card when the CPU is not
asked for; the bench's knobs of later slices refused.  The ``cuda``-marked
tests run the tools on the card."""

from __future__ import annotations

import json
import tomllib

import pytest
import torch

from srtb_tpu_torch.tools import bench as B
from srtb_tpu_torch.tools import fft_bench as FB
from srtb_tpu_torch.tools import kernel_bench as KB
from srtb_tpu_torch.tools import main as M
from srtb_tpu_torch.tools import trace_summary as TS
from srtb_tpu_torch.utils import perf_ledger as PL
from srtb_tpu_torch.utils.metrics import metrics
from test_torch_pipeline import make_case
from test_torch_ref import REPO, run_reference

SMALL_BENCH = {"SRTB_BENCH_LOG2N": "16", "SRTB_BENCH_LOG2CHAN": "5",
               "SRTB_BENCH_DM": "-1", "SRTB_BENCH_REPS": "3"}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "platform", "device",
              "card", "log2n", "segment_time_s", "compile_s", "compile_ms",
              "plan_compiles", "aot_cache_hits", "aot_cache_misses",
              "rep_seconds", "model_gflops",
              "achieved_gflops_s", "model_hbm_gb", "achieved_gbps", "overlap",
              "plan", "hbm_passes", "fused_tail", "front_fuse", "ring",
              "search_mode", "reps", "launches", "pass"}
# (n, channels, nbits, hbm_passes) for the roofline model
ROOFLINE = ((1 << 27, 1 << 11, 2, 4), (1 << 30, 1 << 11, 2, 7),
            (1 << 16, 32, 8, 2))


def _ev(name, ts, dur, cat="kernel", pid=0, tid=7, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": pid, "tid": tid, "args": args}


# a synthetic trace: (event, its expected bucket or None for no plane)
SYNTHETIC = [
    (_ev("void srtb::row_fft_kernel<14>(srtb::RowArgs)", 0, 100,
         device=0), "pallas_fft"),
    (_ev("void srtb::cluster_fft_kernel<16, 4>(srtb::RowArgs)", 100, 40,
         device=0), "pallas_fft"),
    (_ev("void srtb::column_kernel<13, srtb::TmaLoad>(...)", 140, 30,
         device=0), "pallas_fft"),
    (_ev("void srtb::stats_kernel<15, 1>(srtb::StatsArgs)", 170, 8,
         device=0), "pallas_fft"),
    (_ev("void regular_fft<512u, EPT<8u>, 64u, 8u>(...)", 180, 50,
         device=0), "fft"),
    (_ev("void vector_fft<32768u, EPT<16u>>(...)", 230, 25, device=0),
     "fft"),
    (_ev("unpack_subbyte_window_kernel", 255, 10, device=0), "unpack+pack"),
    (_ev("rfi_s1_dedisperse_kernel", 265, 20, device=0), "rfi+chirp"),
    (_ev("dedisperse_kernel", 285, 5, device=0), "rfi+chirp"),
    (_ev("sk_stats_kernel", 290, 7, device=0), "waterfall+sk"),
    (_ev("sk_apply_kernel", 297, 9, device=0), "waterfall+sk"),
    # on another stream, inside the first kernel's interval: busy < total
    (_ev("Memcpy HtoD (Pinned -> Device)", 10, 30, cat="gpu_memcpy",
         tid=9, device=0), "transpose/copy"),
    (_ev("Memset (Device)", 20, 2, cat="gpu_memset", tid=9, device=0),
     "transpose/copy"),
    (_ev("void at::native::reduce_kernel<512, 1>(...)", 306, 3, device=0),
     "other"),
    (_ev("void at::native::cumsum_kernel(...)", 309, 4, device=0),
     "detect"),
    # a second card
    (_ev("void srtb::skzap_kernel<15, 1>(srtb::SkZapArgs)", 0, 11, pid=1,
         device=1), "pallas_fft"),
    # host operators: the outer ones count, the nested one does not
    (_ev("aten::_fft_c2c", 0, 60, cat="cpu_op", pid=99, tid=1), "fft"),
    (_ev("aten::empty", 5, 2, cat="cpu_op", pid=99, tid=1), None),
    (_ev("aten::copy_", 70, 12, cat="cpu_op", pid=99, tid=1),
     "transpose/copy"),
    (_ev("aten::mul", 0, 6, cat="cpu_op", pid=99, tid=2), "other"),
    # not complete events, or no duration: ignored
    ({"ph": "i", "name": "marker", "ts": 1, "cat": "kernel", "pid": 0},
     None),
    ({"ph": "X", "name": "no_dur", "ts": 1, "cat": "kernel", "pid": 0},
     None),
]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_bench")
    jobs = [{"key": f"roofline/{i}", "fn": "bench:roofline_model",
             "args": args[:3], "kwargs": {"hbm_passes": args[3]}}
            for i, args in enumerate(ROOFLINE)]
    return run_reference(jobs, tmp)


@pytest.fixture
def fresh_metrics():
    metrics.reset()
    yield
    metrics.reset()


def _lines(capsys) -> list:
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


# ---------------------------------------------------------------- trace_summary

def test_trace_summary_buckets_a_synthetic_trace(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [e for e, _b in SYNTHETIC]}))
    want: dict = {}
    for e, b in SYNTHETIC:
        if b is None:
            continue
        plane = ("/host:CPU" if e["cat"] == "cpu_op"
                 else f"/device:GPU:{e['args']['device']}")
        stages = want.setdefault(plane, {})
        stages[b] = stages.get(b, 0.0) + e["dur"] / 1e3
    assert TS.main([str(tmp_path), "--top", "3"]) == 0
    got = {s["plane"]: s for s in _lines(capsys)}
    assert list(got) == ["/device:GPU:0", "/device:GPU:1", "/host:CPU"]
    for plane, stages in want.items():
        assert got[plane]["stages_ms"] == pytest.approx(stages, abs=1e-9)
        assert got[plane]["total_ms"] == pytest.approx(
            sum(stages.values()), abs=1e-9)
        assert len(got[plane]["top_ops"]) <= 3
        assert got[plane]["file"] == str(path)
    # device 0's copies ran under its first kernel: busy is the union
    assert got["/device:GPU:0"]["busy_ms"] == pytest.approx(0.311)
    assert got["/device:GPU:0"]["events"] == 15
    assert "busy_ms" not in got["/host:CPU"]
    assert got["/host:CPU"]["top_ops"][0] == {
        "op": "aten::_fft_c2c", "ms": 0.06, "pct": 76.9}


def test_trace_summary_of_a_cpu_profile(tmp_path, capsys, fresh_metrics):
    """A real torch.profiler trace of a 2^16 run on the CPU (the
    capture's ``trace.json``): one host plane, its buckets summing to its
    total; the run's FFTs land in ``fft``."""
    argv, _nres = make_case(tmp_path)
    (tmp_path / "out").mkdir()
    prof = tmp_path / "profile"
    _stats, pipe = M.run(argv + [
        "--device", "cpu", "--baseband_output_file_prefix",
        f"{tmp_path}/out/o_", "--profile_capture_segments", "2",
        "--profile_capture_dir", str(prof)])
    assert pipe.positive_segments == [1]
    capsys.readouterr()
    assert TS.main([str(prof)]) == 0
    (host,) = _lines(capsys)
    assert host["plane"] == "/host:CPU" and host["events"] > 0
    assert sum(host["stages_ms"].values()) == pytest.approx(
        host["total_ms"], abs=1e-3 * len(host["stages_ms"]))
    assert host["stages_ms"].get("fft", 0) > 0


def test_trace_summary_without_a_trace(tmp_path, capsys):
    assert TS.main([str(tmp_path)]) == 1
    assert "error" in _lines(capsys)[0]
    assert TS.main([]) == 2


# ---------------------------------------------------------------- kernel_bench, fft_bench

def test_kernel_bench_on_the_cpu(capsys):
    assert KB.main(["--device", "cpu", "--log2n", "16", "--reps", "1"]) == 0
    lines = _lines(capsys)
    assert [x["case"] for x in lines] == list(KB.CASE_IDS)
    ran = [x for x in lines if "skipped" not in x]
    assert {x["case"] for x in ran} >= {"render_matmuls", "b13", "b3", "k2",
                                        "tail_torch_k2", "detect"}
    for x in ran:
        assert set(x) == {"case", "kernel", "shape", "ms", "gsamples_per_s",
                          "launches", "platform"}
        assert x["platform"] == "cpu" and x["ms"] > 0
        assert x["launches"] == {}  # the CPU runs the plain versions
    for x in lines:
        if "skipped" in x:
            assert x["skipped"]


def test_kernel_bench_only_and_unknown_cases(capsys):
    assert KB.main(["--device", "cpu", "--log2n", "16", "--reps", "1",
                    "--only", "k2,b3"]) == 0
    assert [x["case"] for x in _lines(capsys)] == ["b3", "k2"]
    assert KB.main(["--device", "cpu", "--only", "nope"]) == 2


def test_fft_bench_on_the_cpu(capsys):
    assert FB.main(["16", "17", "--device", "cpu", "--reps", "1"]) == 0
    lines = _lines(capsys)
    assert [(x["log2n"], x["strategy"]) for x in lines] == [
        (k, s) for k in (16, 17) for s in FB.STRATEGIES]
    for x in lines:
        assert set(x) == {"n", "log2n", "strategy", "ms", "gsamples_per_s",
                          "launches", "platform"}
        assert x["n"] == 1 << x["log2n"] and x["ms"] > 0


def test_fft_bench_reports_a_failed_case(capsys):
    assert FB.main(["16", "16", "monolithic,bogus", "--device", "cpu",
                    "--reps", "1"]) == 1
    lines = _lines(capsys)
    assert "ms" in lines[0] and "unknown fft strategy" in lines[1]["error"]


@pytest.mark.parametrize("tool", ("kernel_bench", "fft_bench", "bench"))
def test_tools_fail_without_a_card(tool, capsys, monkeypatch):
    """The card is the default device: without one (and without
    ``--device cpu``) each tool prints an error line and exits
    non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"kernel_bench": KB.main, "fft_bench": FB.main,
            "bench": B.main}[tool]
    assert main([]) != 0
    (line,) = _lines(capsys)
    assert "no CUDA device" in line["error"]


# ---------------------------------------------------------------- bench

def test_bench_on_the_cpu(tmp_path, capsys, monkeypatch, fresh_metrics):
    """One JSON line with the reference's keys and the port's (device,
    card, launches), no roofline_frac off the card; ``--ledger`` appends
    one "bench" record."""
    for k, v in SMALL_BENCH.items():
        monkeypatch.setenv(k, v)
    ledger = tmp_path / "ledger.jsonl"
    assert B.main(["--device", "cpu", "--ledger", str(ledger)]) == 0
    (line,) = _lines(capsys)
    assert set(line) == BENCH_KEYS
    assert line["platform"] == line["device"] == "cpu"
    assert line["card"] is None and line["pass"] is False
    assert line["log2n"] == 16 and line["plan"] == "fused:monolithic"
    assert line["unit"] == "Msamples/s/card" and line["reps"] == 3
    assert len(line["rep_seconds"]) == 3 and line["value"] > 0
    (rec,) = PL.load(str(ledger))
    assert rec["source"] == "bench" and rec["platform"] == "cpu"
    assert rec["shape"] == {"log2n": 16, "channels": 32, "nbits": 2}
    assert len(rec["samples_s"]) == 3 and rec["plan_signature_sha"]


@pytest.mark.parametrize("ring", ("on", "off"))
def test_bench_ring_legs_on_the_cpu(ring, capsys, monkeypatch,
                                    fresh_metrics):
    for k, v in SMALL_BENCH.items():
        monkeypatch.setenv(k, v)
    assert B.main(["--device", "cpu", "--ring", ring]) == 0
    (line,) = _lines(capsys)
    assert {"h2d_gb", "h2d_hidden_ms", "reserved_frac"} <= set(line)
    assert line["plan"].endswith("+ring") == (ring == "on")


@pytest.mark.parametrize("knob,item", (
    (("--fleet-batch", "on"), "A8"),
    ({"SRTB_BENCH_AUDIT": "1"}, "A9e")))
def test_bench_refuses_later_slices(knob, item, capsys, monkeypatch,
                                    fresh_metrics, tmp_path):
    """``SRTB_BENCH_AUDIT`` stays refused (no counterpart in the port).
    ``--fleet-batch on`` (A8b) runs the fleet leg: one line with the
    batching counters, the reference's accounting at full width (N
    streams of S segments in S device dispatches of N), and its streams'
    files removed after it."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--device", "cpu"]
    if isinstance(knob, dict):
        for k, v in knob.items():
            monkeypatch.setenv(k, v)
    else:
        argv += list(knob)
        for k, v in {"SRTB_BENCH_CPU_LOG2N": "13", "SRTB_BENCH_LOG2CHAN":
                     "5", "SRTB_BENCH_REPS": "1",
                     "SRTB_BENCH_FLEET_SEGMENTS": "3"}.items():
            monkeypatch.setenv(k, v)
        assert B.main(argv) == 0
        (line,) = _lines(capsys)
        assert line["metric"] == "fleet_batched_throughput"
        assert line["device"] == "cpu" and line["fleet_batch"] == "on"
        assert (line["streams"], line["fleet_batch_max"]) == (4, 4)
        assert line["drained"] == 12 and line["batched_segments"] == 12
        assert line["batched_dispatches"] == 3
        assert line["batch_size_mean"] == 4.0
        assert line["device_dispatches"] == 3
        assert not list(tmp_path.glob("srtb_fleet_bench_*"))
        return
    assert B.main(argv) == 1
    (line,) = _lines(capsys)
    assert f"ROADMAP {item}" in line["error"]
    assert "NotImplementedError" in line["error"]


def test_bench_aot_leg_on_the_cpu(capsys, monkeypatch, fresh_metrics,
                                  tmp_path):
    """``SRTB_BENCH_AOT_DIR`` is the AOT leg (no longer refused): the
    cache is off on the CPU, so the line says ``aot_active`` false with
    no hit or miss, and nothing is written there."""
    for k, v in SMALL_BENCH.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("SRTB_BENCH_AOT_DIR", str(tmp_path / "aot"))
    assert B.main(["--device", "cpu"]) == 0
    (line,) = _lines(capsys)
    assert line["aot_active"] is False
    assert line["aot_cache_hits"] == line["aot_cache_misses"] == 0
    assert not (tmp_path / "aot").exists()


@pytest.mark.parametrize("i", range(len(ROOFLINE)))
def test_bench_roofline_model_is_the_references(ref, i):
    n, channels, nbits, passes = ROOFLINE[i]
    got = B.roofline_model(n, channels, nbits, hbm_passes=passes)
    want = ref[f"roofline/{i}"]
    assert list(got) == [float(x) for x in want]


def test_bench_divides_by_the_cards_hbm_peak():
    """The roofline's roof is the H100's HBM3, 3350 GB/s, never
    ``Config.hbm_peak_gbps``'s default of another device."""
    from srtb_tpu_torch.config import Config
    assert B.H100_HBM_PEAK_GBPS == 3350.0
    assert Config().hbm_peak_gbps != B.H100_HBM_PEAK_GBPS


def test_console_scripts_name_the_tools():
    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    for name, module in (("kernel-bench", "kernel_bench"),
                         ("fft-bench", "fft_bench"),
                         ("trace-summary", "trace_summary"),
                         ("bench", "bench")):
        assert scripts[f"srtb-torch-{name}"] == \
            f"srtb_tpu_torch.tools.{module}:main"


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_bench_launches_every_case(cuda, capsys):
    """Every case at 2^25 on the card, none skipped, each launching its
    kernels (the tool fails a case that does not)."""
    assert KB.main(["--log2n", "25", "--reps", "2"]) == 0
    lines = _lines(capsys)
    assert [x["case"] for x in lines] == list(KB.CASE_IDS)
    assert all("ms" in x and x["platform"] == "cuda" for x in lines)
    launched = set()
    for x in lines:
        launched |= set(x["launches"])
    from srtb_tpu_torch import kernels as K
    assert launched == {name for name, *_ in K.KERNELS}


@pytest.mark.cuda
def test_cuda_bench_line(cuda, capsys, monkeypatch, fresh_metrics):
    """The bench on the card at 2^24 on the pallas knobs: its plan's
    kernels, the card's name and power limit, a roofline_frac against
    3350 GB/s."""
    for k, v in {"SRTB_BENCH_LOG2N": "24", "SRTB_BENCH_FFT_STRATEGY":
                 "pallas", "SRTB_BENCH_USE_PALLAS": "1",
                 "SRTB_BENCH_USE_PALLAS_SK": "1",
                 "SRTB_BENCH_REPS": "3"}.items():
        monkeypatch.setenv(k, v)
    assert B.main([]) == 0
    (line,) = _lines(capsys)
    assert line["platform"] == "cuda" and line["card"]
    assert line["hbm_peak_gbps"] == 3350.0
    assert line["roofline_frac"] == pytest.approx(
        line["achieved_gbps"] / 3350.0, abs=1e-3)
    assert line["launches"]["fft_rows_skzap"] == 3


@pytest.mark.cuda
def test_cuda_fft_bench(cuda, capsys):
    assert FB.main(["25", "25", "--reps", "2"]) == 0
    lines = {x["strategy"]: x for x in _lines(capsys)}
    assert lines["pallas2"]["launches"] == {"fft2_pass1": 1, "fft2_pass2": 1}
    assert lines["monolithic"]["launches"] == {}
