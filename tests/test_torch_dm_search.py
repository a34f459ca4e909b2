"""The DM-trial search of the port against the JAX package's: the DM grid
(``parallel/dm_grid.py``), the segment step (``parallel/segment_dist.py``)
at the reference's one-device mesh, ``DMSearchPipeline`` and its
``dm_trials.jsonl`` records (one stream and two, the reserve on and off),
``srtb-torch-main --dm_list`` and the refusals.

Geometry: the reference's tests/test_parallel.py (2^14 8-bit samples, 64
channels, trials 0 ... 70, the pulse at DM 30), and the pipeline tests'
2^16 2-bit file of three overlapping segments (tests/test_torch_pipeline.py,
the pulse at DM -0.1) for the reserve.  Gates, the reference's own
(tests/test_parallel.py): counts and zero counts exact; peak SNRs
``rtol=2e-4, atol=1e-3``; time series ``rtol=2e-3, atol=1e-2`` (its
dist-vs-single gate).  The records' ``timestamp`` is the wall clock in
both packages' DM search and is left out."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io.synth import (interleave_streams,
                                     make_dispersed_baseband_host)
from srtb_tpu_torch.parallel import dm_grid
from srtb_tpu_torch.parallel.segment_dist import (DistSegmentProcessor,
                                                  mesh_axes)
from srtb_tpu_torch.pipeline import registry
from srtb_tpu_torch.pipeline.runtime import DMSearchPipeline, Pipeline
from srtb_tpu_torch.pipeline.segment import SegmentProcessor
from srtb_tpu_torch.tools import main as M
from test_torch_pipeline import make_case
from test_torch_ref import run_reference

N = 1 << 14
DM_LIST = [0.0, 10.0, 20.0, 30.0, 40.0, 50.0, 60.0, 70.0]
PEAK_TOL = dict(rtol=2e-4, atol=1e-3)
SERIES_TOL = dict(rtol=2e-3, atol=1e-2)
# the pipeline tests' file: trials around its DM of -0.1
DM_LIST_RESERVED = [-0.3, -0.2, -0.1, 0.0]


def parallel_cfg(**kw) -> Config:
    """The reference's tests/test_parallel.py configuration."""
    base = dict(
        baseband_input_count=N, baseband_input_bits=8,
        baseband_format_type="simple", baseband_freq_low=1405.0,
        baseband_bandwidth=64.0, baseband_sample_rate=128e6, dm=30.0,
        spectrum_channel_count=1 << 6,
        signal_detect_signal_noise_threshold=6.0,
        signal_detect_max_boxcar_length=32,
        mitigate_rfi_average_method_threshold=100.0,
        mitigate_rfi_spectral_kurtosis_threshold=2.0,
        baseband_reserve_sample=False)
    base.update(kw)
    return Config(**base)


RAW = make_dispersed_baseband_host(N, 1405.0, 64.0, 30.0,
                                   pulse_positions=N // 2, pulse_amp=25.0)
# two streams of 2-pol byte-interleaved 8-bit samples, the pulse in
# stream 0
RAW2 = interleave_streams(torch.from_numpy(np.stack([
    RAW, make_dispersed_baseband_host(N, 1405.0, 64.0, 30.0, [], seed=8)])),
    "interleaved_samples_2").numpy()
# the segment step's cases: (cfg overrides, raw, trials, window)
DIST = {"grid": ({}, RAW, DM_LIST, "rectangle"),
        "matched_and_zero": ({}, RAW, [30.0, 0.0], "rectangle"),
        "hamming": ({}, RAW, [30.0, 0.0], "hamming"),
        "k3k4": ({"use_pallas_sk": True}, RAW, [30.0, 0.0], "rectangle"),
        "two_streams": ({"baseband_format_type": "interleaved_samples_2"},
                        RAW2, [0.0, 10.0, 30.0], "rectangle")}


def _pipeline_case(tmp, name: str):
    """(Config, trials path) of a DMSearchPipeline case: the reference's
    geometry on a file of two segments (noise, then the pulse) without
    the reserve, or the pipeline tests' three overlapping segments with
    it, at one stream or two."""
    d = tmp / name
    d.mkdir()
    fmt = ("interleaved_samples_2" if name.startswith("two")
           else "simple")
    if name.endswith("_reserve"):
        argv, _nres = make_case(d, fmt=fmt)
        cfg = Config.from_args(argv + ["--dm_list", " -0.3, -0.2, -0.1, 0"])
    else:
        noise = make_dispersed_baseband_host(N, 1405.0, 64.0, 30.0, [],
                                             seed=11)
        segs = [noise, RAW] if fmt == "simple" else [
            interleave_streams(torch.from_numpy(np.stack([a, b])), fmt)
            .numpy() for a, b in ((noise, noise[::-1].copy()),
                                  (RAW, noise))]
        data = d / "dm.bin"
        np.concatenate(segs).tofile(data)
        cfg = parallel_cfg(baseband_format_type=fmt, dm_list=DM_LIST,
                           signal_detect_signal_noise_threshold=7.0,
                           input_file_path=str(data))
    return cfg.replace(baseband_output_file_prefix=f"{d}/dm_")


PIPELINE_CASES = ("one_stream", "one_stream_reserve", "two_streams",
                  "two_streams_reserve")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dm_ref")
    jobs = [{"key": "grid", "fn": "test_torch_ref:dm_grid_search",
             "args": [dataclasses.asdict(parallel_cfg()), RAW, DM_LIST]}]
    for name, (over, raw, dms, window) in DIST.items():
        jobs.append({"key": f"dist/{name}", "fn": "test_torch_ref:dist_segment",
                     "args": [dataclasses.asdict(parallel_cfg(**over)), raw,
                              dms, window]})
    cases = {}
    for name in PIPELINE_CASES:
        cfg = cases[name] = _pipeline_case(tmp, name)
        ref_cfg = cfg.replace(baseband_output_file_prefix=(
            cfg.baseband_output_file_prefix + "ref_"))
        jobs.append({"key": f"pipe/{name}",
                     "fn": "test_torch_ref:dm_search_pipeline",
                     "args": [dataclasses.asdict(ref_cfg)]})
    bad = dataclasses.asdict(parallel_cfg(spectrum_channel_count=48))
    jobs.append({"key": "refusals", "fn": "test_torch_ref:refusals",
                 "args": [[("dist", bad, DM_LIST),
                           ("mode", dataclasses.asdict(parallel_cfg(
                               search_mode="acceleration")))]]})
    return {"out": run_reference(jobs, tmp), "cases": cases}


def _result(out: dict, key: str) -> dict:
    return {f: out[f"{key}/{f}"] for f in (
        "zero_count", "signal_counts", "snr_peaks", "time_series")}


def _held(got, want: dict) -> None:
    """A trial result against the reference's at its gates."""
    np.testing.assert_array_equal(got.signal_counts.numpy(),
                                  want["signal_counts"])
    np.testing.assert_array_equal(got.zero_count.numpy(), want["zero_count"])
    np.testing.assert_allclose(got.snr_peaks.numpy(), want["snr_peaks"],
                               **PEAK_TOL)
    np.testing.assert_allclose(got.time_series.numpy(), want["time_series"],
                               **SERIES_TOL)


# ------------------------------------------------------------ the grid

def test_chirp_bank_is_the_references(ref):
    cfg = parallel_cfg()
    n = N // 2
    f_min, f_c = cfg.baseband_freq_low, 1469.0
    bank = dm_grid.build_chirp_bank(DM_LIST, n, f_min, 64.0 / n, f_c)
    assert bank.dtype == np.float32 and bank.shape == (8, 2, n)
    np.testing.assert_array_equal(bank, ref["out"]["grid/bank"])


def test_dm_grid_matches_reference(ref):
    """``dm_trial_search`` on the reference's cleaned spectrum (B3 a trial
    here; the reference's bank there): every trial at the gates, and
    ``best_trial`` the matched DM."""
    out = ref["out"]
    ri = out["grid/spectrum_ri"]
    spec = torch.complex(torch.from_numpy(ri[0]), torch.from_numpy(ri[1]))
    cfg = parallel_cfg()
    proc = SegmentProcessor(cfg, device="cpu")
    res = dm_grid.dm_trial_search(
        spec, DM_LIST, f_min=proc.f_min, df=proc.df, f_c=proc.f_c,
        channel_count=proc.channel_count,
        time_reserved_count=proc.time_reserved_count,
        snr_threshold=cfg.signal_detect_signal_noise_threshold,
        max_boxcar_length=cfg.signal_detect_max_boxcar_length,
        sk_threshold=cfg.mitigate_rfi_spectral_kurtosis_threshold)
    _held(res, _result(out, "grid/result"))
    idx, snr = dm_grid.best_trial(res)
    assert idx == int(out["grid/best"][0]) == DM_LIST.index(30.0)
    np.testing.assert_allclose(snr, float(out["grid/best_snr"][0]),
                               **PEAK_TOL)
    assert list(res.dm_list) == DM_LIST


def test_front_matches_reference_spectrum(ref):
    """The segment step's front (unpack, R2C, stage 1 once, no chirp)
    against the reference's cleaned spectrum: the same zapped bins, the
    rest within 1e-5 of the largest value (two float32 R2Cs)."""
    dist = DistSegmentProcessor(parallel_cfg(), dm_list=DM_LIST,
                                device="cpu")
    got = dist.front(torch.from_numpy(RAW))[0].numpy()
    ri = ref["out"]["grid/spectrum_ri"]
    want = ri[0] + 1j * ri[1]
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------- the segment step

@pytest.fixture(scope="module")
def dist_runs():
    out = {}
    for name, (over, raw, dms, window) in DIST.items():
        dist = DistSegmentProcessor(parallel_cfg(**over), dm_list=dms,
                                    window_name=window, device="cpu")
        out[name] = (dist, dist.process(raw))
    return out


@pytest.mark.parametrize("name", sorted(DIST))
def test_dist_segment_matches_reference(ref, dist_runs, name):
    """``DistSegmentProcessor`` against the reference's on a (dm 1, seq 1)
    mesh: [n_dm, S, ...] results at the gates."""
    dist, res = dist_runs[name]
    streams = 2 if name == "two_streams" else 1
    assert res.signal_counts.shape[:2] == (len(DIST[name][2]), streams)
    assert res.time_series.shape[:2] == (len(DIST[name][2]), streams)
    _held(res, _result(ref["out"], f"dist/{name}/result"))


@pytest.mark.parametrize("name", sorted(DIST))
def test_matched_trial_is_the_single_dm_processor(dist_runs, name):
    """The trial at a DM equals the port's single-DM processor at that DM
    on the same segment: counts and zero count exact, the time series
    within the series gate (the reference's dist-vs-single test)."""
    dist, res = dist_runs[name]
    over, raw, dms, window = DIST[name]
    dm = dms[-1] if name == "two_streams" else 30.0
    i = dms.index(dm)
    single = SegmentProcessor(parallel_cfg(**over).replace(dm=dm),
                              window_name=window, device="cpu")
    _wf, want = single.process(raw)
    np.testing.assert_array_equal(res.signal_counts[i].numpy(),
                                  want.signal_counts.numpy())
    np.testing.assert_array_equal(res.zero_count[i].numpy(),
                                  want.zero_count.numpy())
    np.testing.assert_allclose(res.time_series[i].numpy(),
                               want.time_series.numpy(), **SERIES_TOL)
    if name == "grid":
        peaks = res.snr_peaks.numpy().max(axis=(-1, -2))
        assert int(np.argmax(peaks)) == DM_LIST.index(30.0)
        assert res.signal_counts[i].sum() > 0


def test_trial_loop_reuses_one_buffer(monkeypatch):
    """Every trial's B3 writes into the same buffer, and each call of the
    waterfall tail sees it: the loop allocates no spectrum a trial."""
    dist = DistSegmentProcessor(parallel_cfg(), dm_list=DM_LIST,
                                device="cpu")
    seen = []
    tail = dist.processor._waterfall_detect

    def recording(spec):
        seen.append(spec.data_ptr())
        return tail(spec)
    monkeypatch.setattr(dist.processor, "_waterfall_detect", recording)
    dist.process(RAW)
    assert len(seen) == len(DM_LIST) and len(set(seen)) == 1


# ---------------------------------------------------- the pipeline

@pytest.fixture(scope="module")
def pipe_runs(ref):
    out = {}
    for name, cfg in ref["cases"].items():
        with DMSearchPipeline(cfg, device="cpu") as pipe:
            stats = pipe.run()
        with open(pipe.trials_path) as f:
            records = [json.loads(line) for line in f if line.strip()]
        out[name] = (cfg, stats, records)
    return out


@pytest.mark.parametrize("name", PIPELINE_CASES)
def test_records_match_reference(ref, pipe_runs, name):
    """The records key by key (the same keys in the same order):
    ``segment``, ``best_dm``, ``dm_list``, ``signal_counts`` and
    ``zero_counts`` exact, ``best_snr`` and ``peak_snr`` at the peak gate;
    the same ``stats.signals``."""
    cfg, stats, records = pipe_runs[name]
    out = ref["out"]
    want = [json.loads(line) for line in
            out[f"pipe/{name}/records"].tolist()]
    assert stats.segments == int(out[f"pipe/{name}/segments"]) == \
        len(records) == len(want)
    assert stats.signals == int(out[f"pipe/{name}/signals"])
    for got, exp in zip(records, want):
        assert list(got) == list(exp) == [
            "segment", "timestamp", "best_dm", "best_snr", "dm_list",
            "peak_snr", "signal_counts", "zero_counts"]
        for key in ("segment", "best_dm", "dm_list", "signal_counts",
                    "zero_counts"):
            assert got[key] == exp[key], key
        np.testing.assert_allclose(got["peak_snr"], exp["peak_snr"],
                                   **PEAK_TOL)
        np.testing.assert_allclose(got["best_snr"], exp["best_snr"],
                                   **PEAK_TOL)
    # the pulse segment is found at its DM (without the reserve the
    # matched trial also trips the SK zap gate, in both packages, so only
    # the reserved file's pulse counts as a signal)
    assert records[-2 if name.endswith("_reserve") else -1]["best_dm"] == \
        cfg.dm
    assert stats.signals == (1 if name.endswith("_reserve") else 0)


class _Recorder:
    def __init__(self):
        self.dets = []

    def push(self, work, has_signal):
        self.dets.append(work.detect)


@pytest.mark.parametrize("name", PIPELINE_CASES)
def test_trial_at_cfg_dm_is_the_single_dm_pipeline(pipe_runs, name,
                                                   tmp_path):
    """Per segment, the record's trial at ``cfg.dm``: its count and zero
    count those of the port's single-DM ``Pipeline`` on the same file."""
    cfg, _stats, records = pipe_runs[name]
    single = cfg.replace(dm_list=[], writer_thread_count=0,
                         baseband_output_file_prefix=f"{tmp_path}/s_")
    rec = _Recorder()
    with Pipeline(single, device="cpu") as pipe:
        pipe.sinks.append(rec)
        pipe.run()
    i = cfg.dm_list.index(cfg.dm)
    assert len(rec.dets) == len(records)
    for det, record in zip(rec.dets, records):
        assert record["signal_counts"][i] == int(det.signal_counts.sum())
        assert record["zero_counts"][i] == int(det.zero_count.max())


def test_cli_dm_list_writes_the_records(ref, pipe_runs, tmp_path):
    """``srtb-torch-main --dm_list`` runs the DM search (no
    ``NotImplementedError``) and writes the same records as the
    pipeline."""
    cfg, _stats, records = pipe_runs["one_stream_reserve"]
    argv, _nres = make_case(tmp_path)
    stats, search = M.run(argv + [
        "--dm_list", " -0.3, -0.2, -0.1, 0", "--device", "cpu",
        "--baseband_output_file_prefix", f"{tmp_path}/cli_"])
    assert isinstance(search, DMSearchPipeline)
    assert search.trials_path == f"{tmp_path}/cli_dm_trials.jsonl"
    with open(search.trials_path) as f:
        got = [json.loads(line) for line in f if line.strip()]
    assert stats.segments == len(got) == len(records) == 3
    for a, b in zip(got, records):
        a.pop("timestamp")
        b = dict(b)
        b.pop("timestamp")
        assert a == b


def test_refusals_match_reference(ref):
    """A non-dividing channel count in DM mode and an unknown search mode
    raise as the reference's do; a mesh or process group above one device
    raises naming ROADMAP A8."""
    msgs = ref["out"]["refusals/messages"].tolist()
    with pytest.raises(ValueError) as e:
        DistSegmentProcessor(parallel_cfg(spectrum_channel_count=48),
                             dm_list=DM_LIST, device="cpu")
    assert f"ValueError: {e.value}" == msgs[0]
    with pytest.raises(ValueError) as e:
        registry.resolve_mode(parallel_cfg(search_mode="acceleration"))
    assert f"ValueError: {e.value}" == msgs[1]
    for mesh in ({"dm": 2, "seq": 1}, {"dm": 1, "seq": 4}):
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            DistSegmentProcessor(parallel_cfg(), mesh=mesh, device="cpu")
    assert mesh_axes(None) == (1, 1)
    assert mesh_axes({"dm": 1, "seq": 1}) == (1, 1)
    # one device takes any trial count (the dm axis is 1)
    assert len(DistSegmentProcessor(parallel_cfg(), mesh={"dm": 1},
                                    dm_list=[1.0, 2.0, 3.0],
                                    device="cpu").dm_list) == 3
