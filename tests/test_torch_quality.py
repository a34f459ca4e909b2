"""The port's quality statistics against the JAX package's: the device
vector (``quality/stats.quality_stats_device``) against the reference's
and the float64 oracle, the host monitor over a drift script, the
segment processor's epilogue on each plan family that
``test_torch_segment.py`` resolves, and the runtime's timeline.

Gates: against the float64 oracle of the same spectrum and waterfall, the
zero and channel counts behind ``zap_frac``, the occupancy row,
``dead_frac`` and ``hot_frac`` exactly, every other slot within 1e-5
relative; against the reference's vector, the reference's own gate to its
oracle (rtol 1e-4, atol 1e-4 of the vector's largest value), since the
JAX package sums in float32."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.pipeline import segment as seg
from srtb_tpu_torch.pipeline.segment import SegmentProcessor
from srtb_tpu_torch.quality import stats as Q
from srtb_tpu_torch.tools import main as M
from test_torch_pipeline import make_case
from test_torch_ref import environ, run_reference
from test_torch_segment import SHAPES, _case

# (streams, n_spec, F, T, coarse bins, subsample, channel scales): the
# direct cases; "bins_not_tiling" leaves a remainder of the spectrum
# outside every coarse bin, "median_even" makes torch.median's lower
# middle value give another dead count than the average of the two
DIRECT = {
    "sub1": (1, 4096, 16, 256, 64, 1, None),
    "sub3_two_streams": (2, 4096, 16, 256, 64, 3, None),
    "sub8": (1, 8192, 32, 256, 64, 8, None),
    "bins_not_tiling": (2, 1000, 10, 100, 64, 3, None),
    "odd_channels": (1, 2048, 15, 128, 16, 1, None),
    "median_even": (1, 1024, 4, 256, 8, 1, (0.5, 1.0, 50.0, 50.0)),
}
DEAD, HOT = 0.1, 10.0
# the plan families (test_torch_segment.py's shapes): monolithic, the
# fused tail with skzap, without the fused tail, the fused tail without
# skzap, the chirp bank's plan without use_pallas, staged with B3 (the
# pre-chirp spectrum), staged with pallas2 rows, front-fused, two streams
FAMILIES = ("n16_ch32", "n16_ch4_skzap", "n16_ch4_unfused",
            "n17_ch8_no_pallas_sk", "n16_ch4_no_pallas",
            "n16_ch32_staged_no_pallas", "n16_ch32_staged_rows_pallas2",
            "n16_ch4_ffuse_2bit", "is2_2bit_staged", "is2_8bit_pallas")
EXACT = [Q.IDX_ZAP_FRAC, Q.IDX_DEAD_FRAC, Q.IDX_HOT_FRAC]


def direct_inputs(name: str):
    """Spectra with zapped bins (a band and a scatter of zeros) and
    waterfalls with zero channels, from a seed."""
    s, n_spec, f, t, _b, _k, scales = DIRECT[name]
    rng = np.random.default_rng(list(DIRECT).index(name))
    spec = (rng.standard_normal((s, n_spec))
            + 1j * rng.standard_normal((s, n_spec))).astype(np.complex64)
    spec[:, n_spec // 5:n_spec // 4] = 0
    spec[rng.random((s, n_spec)) < 0.2] = 0
    wf = (rng.standard_normal((s, f, t))
          + 1j * rng.standard_normal((s, f, t))).astype(np.complex64)
    if scales is not None:
        wf *= np.sqrt(np.asarray(scales, dtype=np.float32))[:, None]
    else:
        wf[:, 1] = 0
        wf[:, 2] *= 0.05   # dead
        wf[:, -1] *= 5.0   # hot
    return spec, wf


def assert_oracle_parity(got: np.ndarray, want: np.ndarray,
                         what: str) -> None:
    """The oracle gate: exact counts, 1e-5 relative elsewhere."""
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    b = (got.shape[-1] - Q.N_SCALARS) // 2
    exact = EXACT + list(range(Q.N_SCALARS, Q.N_SCALARS + b))
    assert np.array_equal(got[:, exact], want[:, exact]), \
        f"{what}: {got[:, exact]} vs {want[:, exact]}"
    rest = [i for i in range(got.shape[-1]) if i not in exact]
    np.testing.assert_allclose(got[:, rest], want[:, rest], rtol=1e-5,
                               atol=0, err_msg=what)


def assert_reference_parity(got: np.ndarray, want: np.ndarray,
                            what: str) -> None:
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=what)


def drift_vectors() -> list:
    """A drift script: 12 steady segments of noise, then a bandpass ramp,
    two streams each."""
    rng = np.random.default_rng(17)
    out = []
    for i in range(24):
        v = rng.normal(1.0, 0.01, size=(2, Q.vector_length(8)))
        v[:, Q.IDX_BANDPASS_MEAN] += 0.0 if i < 12 else 0.05 * (i - 11)
        out.append(v.astype(np.float32))
    return out


def family_case(name: str):
    cfg, raw, window, staged, env = _case(name)
    return cfg.replace(quality_stats=True), raw, window, staged, env


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jobs = []
    for name, (_s, _n, _f, _t, bins, k, _sc) in DIRECT.items():
        spec, wf = direct_inputs(name)
        jobs.append({"key": f"direct/{name}",
                     "fn": "srtb_tpu.quality.stats:quality_stats_device",
                     "args": [spec, wf, bins, DEAD, HOT],
                     "kwargs": {"subsample": k}})
    fields = dataclasses.asdict(Config(quality_stats=True,
                                       stream_name="beam0"))
    jobs.append({"key": "monitor", "fn": "test_torch_ref:"
                 "quality_monitor_script", "args": [fields,
                                                    drift_vectors()]})
    for name in FAMILIES:
        cfg, raw, window, staged, env = family_case(name)
        jobs.append({"key": f"family/{name}",
                     "fn": "test_torch_ref:segment_process",
                     "args": [dataclasses.asdict(cfg), raw, window, staged,
                              env]})
    return run_reference(jobs, tmp_path_factory.mktemp("ref_quality"))


@pytest.mark.parametrize("name", DIRECT)
def test_quality_stats_device(ref, name):
    _s, _n, _f, _t, bins, k, _sc = DIRECT[name]
    spec, wf = direct_inputs(name)
    got = Q.quality_stats_device(torch.from_numpy(spec),
                                 torch.from_numpy(wf), bins, DEAD, HOT,
                                 subsample=k).numpy()
    want = Q.quality_stats_oracle(spec, wf, bins, DEAD, HOT, subsample=k)
    assert_oracle_parity(got, want, name)
    assert_reference_parity(got, ref[f"direct/{name}"], name)
    # the halves and the one call agree
    halves = Q.pack_stats(
        Q.spectrum_stats(torch.from_numpy(spec), bins, k),
        Q.waterfall_stats(torch.from_numpy(wf), DEAD, HOT, k)).numpy()
    assert np.array_equal(halves, got)
    u = Q.unpack_stats(got)
    if name == "median_even":
        # channel powers ~ (1, 2, 100, 100): the median is ~51, so the two
        # quiet channels are dead; the lower middle value (~2) would make
        # neither dead
        assert u["dead_frac"].tolist() == [0.5]
        assert float(ref[f"direct/{name}"][0, Q.IDX_DEAD_FRAC]) == 0.5
    else:
        assert (u["dead_frac"] > 0).all() and (u["hot_frac"] > 0).all()
        assert (u["zap_frac"] > 0.2).all()


def test_median_averages_the_middle_pair():
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [5.0, 1.0, 9.0, 7.0]],
                     dtype=torch.float64)
    assert Q._median(x).tolist() == [[2.5], [6.0]]
    assert Q._median(x[:, :3]).tolist() == [[3.0], [5.0]]


def test_monitor_drift_script(ref):
    mon = Q.QualityMonitor.from_config(Config(quality_stats=True,
                                              stream_name="beam0"))
    outs = [mon.observe(v, segment=i)
            for i, v in enumerate(drift_vectors())]
    assert outs == json.loads(str(ref["monitor/json"]))
    assert mon.timeline() == json.loads(str(ref["monitor/timeline"]))
    assert any(o["drift_alert"] for o in outs[12:])
    assert not any(o["drift_alert"] for o in outs[:12])
    assert Q.QualityMonitor.from_config(Config()) is None


@pytest.mark.parametrize("name", FAMILIES)
def test_epilogue_on_each_plan(ref, name, monkeypatch):
    """The processor's quality vector: against the oracle of the spectrum
    and waterfall this very run computed it from, and against the
    reference's ``segment_process`` with ``quality_stats``."""
    _cfg, raw, window, staged, env = family_case(name)
    fields = json.loads(str(ref[f"family/{name}/fields"]))
    cfg = Config.from_reference_fields(fields)
    assert cfg.quality_stats
    seen = []
    spectrum_stats = Q.spectrum_stats

    def recording(spec, *args):
        seen.append(spec.clone())
        return spectrum_stats(spec, *args)
    monkeypatch.setattr(seg.Q, "spectrum_stats", recording)
    with environ(env):
        sp = SegmentProcessor(cfg, window_name=window, device="cpu",
                              staged=staged)
        wf, res = sp.process(raw)
    assert sp.plan_name == SHAPES[name][-1]
    assert len(seen) == 1 and res.quality is not None
    got = res.quality.numpy()
    streams = wf.shape[0]
    assert got.shape == (streams, Q.vector_length(cfg.quality_coarse_bins))
    want = Q.quality_stats_oracle(
        seen[0].numpy(), wf.numpy(), cfg.quality_coarse_bins,
        cfg.quality_dead_threshold, cfg.quality_hot_threshold,
        subsample=cfg.quality_subsample)
    assert_oracle_parity(got, want, name)
    assert_reference_parity(got, ref[f"family/{name}/detect/quality"], name)
    # the other results are those of a run without the epilogue
    with environ(env):
        wf_off, res_off = SegmentProcessor(
            cfg.replace(quality_stats=False), window_name=window,
            device="cpu", staged=staged).process(raw)
    assert res_off.quality is None
    assert torch.equal(wf_off, wf)
    assert torch.equal(res_off.signal_counts, res.signal_counts)


def test_runtime_timeline(tmp_path):
    """``srtb-torch-main`` with ``quality_stats``: one dict a segment in
    drain order in ``stats.extras["quality"]``, each the monitor's dict of
    that segment's vector."""
    argv, _nres = make_case(tmp_path)
    stats, pipe = M.run(argv + [
        "--quality_stats", "1", "--writer_thread_count", "0",
        "--baseband_output_file_prefix", f"{tmp_path}/out_",
        "--device", "cpu"])
    timeline = stats.extras["quality"]
    assert stats.segments == 3 and len(timeline) == 3
    assert [d["segment"] for d in timeline] == [0, 1, 2]
    for d in timeline:
        assert 0.0 < d["zap_frac"] < 1.0 and len(d["occupancy"]) == 64
        assert np.isfinite(d["sk_mean"]) and not d["drift_alert"]
    assert pipe.positive_segments == [1]
