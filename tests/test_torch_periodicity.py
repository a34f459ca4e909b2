"""The periodicity search mode of the port against the JAX package's:
the ops (``ops/periodicity.py``) on seeded series, the processor
(``pipeline/periodicity.py``, built through ``pipeline/registry.py``) on
the reference tests' 2^14 geometry for the fused, staged and
micro-batch plans, its positive gate, and ``srtb-torch-main --search_mode
periodicity`` against ``srtb-main`` on a two-segment file with the run
manifest armed.

Gates (the reference's float32 results against the port's): bins and
harmonic counts equal; SNR within ``rtol=1e-5, atol=1e-5``; folded
profiles within ``rtol=1e-5, atol=1e-6``; the power spectra and harmonic
sums within 1e-5 of their largest value; ``.cand.json`` parsed, bins and
harmonics equal and SNR within 1e-3 (the file rounds to 4 decimals).
The processor's candidates come from its own time series, which differs
from the reference's within the segment tests' time-series gate: its
bins, harmonics and SNR are held to the reference processor's at the
gates above, its profiles to the reference's within that series
difference plus the profile gate (``assert_profiles_follow_series``;
ROADMAP C), and all of them at the gates above to the numpy oracle run
on the port's own series."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io.synth import make_dispersed_baseband_host
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.ops import periodicity as P
from srtb_tpu_torch.pipeline import registry
from srtb_tpu_torch.pipeline.periodicity import (PeriodicityResult,
                                                 PeriodicitySegmentProcessor)
from srtb_tpu_torch.pipeline.runtime import has_signal
from srtb_tpu_torch.pipeline.segment import SegmentProcessor
from srtb_tpu_torch.tools import fsck as FS
from srtb_tpu_torch.tools import main as M
from test_torch_ref import REPO, run_reference

N = 1 << 14
CHANNELS = 64
N_BINS = 64
SNR_TOL = dict(rtol=1e-5, atol=1e-5)
PROFILE_TOL = dict(rtol=1e-5, atol=1e-6)


def _series(t: int, seed: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    i = np.arange(t)
    if kind == "sine":
        ts = rng.standard_normal(t) + 3.0 * np.sin(2 * np.pi * 17 * i / t)
    elif kind == "weak_harmonics":
        ts = rng.standard_normal(t)
        for h in (1, 2, 4, 8):
            ts += 0.17 * np.sin(2 * np.pi * 20 * h * i / t + 0.3 * h)
    elif kind == "train":
        ts = 0.1 * rng.standard_normal(t)
        ts[::64] += 10.0
    else:  # "zeros": every searched bin ties at score 0
        ts = np.zeros(t)
    ts = ts.astype(np.float32)
    return ts - ts.mean()


# T = 2^10, 2^12 and a non-power-of-two T under the fold's guard; the
# planted ties: an all-zero series (every bin scores 0, so the top K is
# the lowest searched bins in order)
SERIES = {"t1024_sine": (1024, 0, "sine"),
          "t4096_weak_harmonics": (4096, 5, "weak_harmonics"),
          "t3000_sine": (3000, 1, "sine"),
          "t1024_train": (1024, 2, "train"),
          "t1024_zeros_ties": (1024, 0, "zeros")}
HARMONICS = (1, 8, 16)
TOP_K = (1, 4)
MIN_BIN = 2
# the fold's guard: non-power-of-two lengths below and above T (T // 2)
# = 2^32, a power of two, and the reserved 2^30 segment of the example
# cfg (T = 2^18 - nsamps_reserved / 2^11, which both refuse)
_EXAMPLE = Config()
_EXAMPLE.load_file(str(REPO / "examples" / "srtb_config_1644-4559.cfg"))
T_RESERVED_2_30 = (1 << 18) - dd.nsamps_reserved(
    _EXAMPLE.replace(baseband_reserve_sample=True)) // (1 << 11)
GUARD_LENGTHS = (3 << 14, 3 << 15, 1 << 18, T_RESERVED_2_30)


def cfg_fields(**kw) -> dict:
    """The reference tests' geometry (tests/test_periodicity.py), as
    Config fields."""
    base = dict(
        baseband_input_count=N, baseband_input_bits=8,
        baseband_freq_low=1405.0, baseband_bandwidth=64.0,
        baseband_sample_rate=128e6, dm=0.0,
        spectrum_channel_count=CHANNELS,
        mitigate_rfi_average_method_threshold=1000.0,
        mitigate_rfi_spectral_kurtosis_threshold=50.0,
        signal_detect_signal_noise_threshold=6.0,
        signal_detect_max_boxcar_length=8,
        baseband_reserve_sample=False, fft_strategy="four_step",
        search_mode="periodicity")
    base.update(kw)
    return dataclasses.asdict(Config(**base))


def _segments() -> dict:
    """The pulse-train segment of the reference's end-to-end test (a
    pulse every 1024 samples), a noise segment and a two-pulse segment."""
    period = 1024
    train = make_dispersed_baseband_host(
        N, 1405.0, 64.0, 0.0,
        pulse_positions=list(range(period // 2, N - 64, period)),
        pulse_amp=60.0, pulse_width=16, nbits=8, seed=3)
    noise = make_dispersed_baseband_host(N, 1405.0, 64.0, 0.0, [], nbits=8,
                                         seed=4)
    # two pulses the boxcar finds (at this T of 128 neither the train nor
    # a pair clears the trials-corrected periodicity gate)
    pulses = make_dispersed_baseband_host(N, 1405.0, 64.0, 0.0,
                                          [N // 4, 3 * N // 4], nbits=8,
                                          pulse_amp=30.0, seed=5)
    return {"train": train, "noise": noise, "pulses": pulses}


SEGMENTS = _segments()
# the plans: (Config overrides, the processor's staged argument, micro-
# batch); the plan names both packages resolve
PLANS = {"fused": ({}, None, False),
         "staged": ({}, True, False),
         "batch2": ({"micro_batch_segments": 2}, None, True)}
PLAN_NAMES = {"fused": "fused:four_step+ftail+period",
              "staged": "staged:four_step+ftail+period",
              "batch2": "fused:four_step+ftail+period"}
# positive_gate cases of the reference's tests: (scores, trials,
# periodicity_snr_threshold)
GATE_CASES = [([[7.0, 1.0]], (1, 1), 6.0), ([[3.0, 1.0]], (1, 1), 6.0),
              ([[7.0, 1.0]], (100, 4), 6.0), ([[13.0, 1.0]], (100, 4), 6.0),
              ([[6.69, 6.7]], (1, 1), 6.0), ([[9.0]], (1000, 8), 0.0)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("periodicity_ref")
    series = [_series(*SERIES[name]) for name in sorted(SERIES)]
    jobs = [{"key": f"ops/h{h}/k{k}", "fn": "test_torch_ref:periodicity_ops",
             "args": [series, h, k, N_BINS, MIN_BIN]}
            for h in HARMONICS for k in TOP_K]
    jobs.append({"key": "guard", "fn": "test_torch_ref:fold_guard",
                 "args": [list(GUARD_LENGTHS), N_BINS]})
    raws = [SEGMENTS["train"], SEGMENTS["noise"]]
    for plan, (over, staged, batch) in PLANS.items():
        jobs.append({"key": f"proc/{plan}",
                     "fn": "test_torch_ref:periodicity_processor",
                     "args": [cfg_fields(**over), raws, staged, batch]})
    jobs.append({"key": "gates", "fn": "test_torch_ref:periodicity_gate_cases",
                 "args": [GATE_CASES]})
    return {"out": run_reference(jobs, tmp), "series": series, "tmp": tmp}


@pytest.fixture(scope="module")
def port_runs():
    """The port's processor on both segments at each plan (batch2: one
    ``process_batch`` of both)."""
    out = {}
    for plan, (over, staged, batch) in PLANS.items():
        cfg = Config.from_reference_fields(cfg_fields(**over))
        sp = registry.build_processor(cfg, device="cpu", staged=staged)
        raws = [SEGMENTS["train"], SEGMENTS["noise"]]
        lanes = sp.process_batch(np.stack(raws)) if batch else \
            [sp.process(raw) for raw in raws]
        out[plan] = (sp, lanes)
    return out


# ------------------------------------------------------------------ ops

def test_harmonic_levels(ref):
    for h in HARMONICS:
        assert P.harmonic_levels(h) == tuple(
            ref["out"][f"ops/h{h}/k1/levels"].tolist())
    assert P.harmonic_levels(6) == (1, 2, 4)


def _close_to_max(got, want, frac=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= frac * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("k", TOP_K)
@pytest.mark.parametrize("h", HARMONICS)
@pytest.mark.parametrize("name", sorted(SERIES))
def test_ops_match_reference(ref, name, h, k):
    """Each op on the series against the reference's: the power spectrum
    and harmonic sums within 1e-5 of their largest value, the candidates
    (bins, harmonics equal; SNR), the folds at the reference's bins and
    the whole search (profiles)."""
    i = sorted(SERIES).index(name)
    want = {key[len(f"ops/h{h}/k{k}/{i}/"):]: v
            for key, v in ref["out"].items()
            if key.startswith(f"ops/h{h}/k{k}/{i}/")}
    ts = torch.from_numpy(ref["series"][i])
    levels = P.harmonic_levels(h)
    _close_to_max(P.power_spectrum(ts).numpy(), want["power"])
    _close_to_max(P.harmonic_sum(P.power_spectrum(ts), levels).numpy(),
                  want["sums"])
    bins, snr, harm = P.candidate_search(ts, levels, k, min_bin=MIN_BIN)
    np.testing.assert_array_equal(bins.numpy(), want["bins"])
    np.testing.assert_array_equal(harm.numpy(), want["harmonics"])
    np.testing.assert_allclose(snr.numpy(), want["snr"], **SNR_TOL)
    folds = P.fold(ts, torch.from_numpy(want["bins"]), N_BINS)
    np.testing.assert_allclose(folds.numpy(), want["folds"], **PROFILE_TOL)
    got = P.periodicity_search(ts, h, k, N_BINS, min_bin=MIN_BIN)
    for field in ("bins", "harmonics"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      want[f"search/{field}"])
    np.testing.assert_allclose(got.snr.numpy(), want["search/snr"],
                               **SNR_TOL)
    np.testing.assert_allclose(got.profiles.numpy(),
                               want["search/profiles"], **PROFILE_TOL)
    if name.endswith("_ties"):
        # every searched bin ties: the lowest bins, in order
        assert bins.tolist() == list(range(MIN_BIN, MIN_BIN + k))


def test_numpy_oracle_matches_the_port(ref):
    """The port's copy of the reference's numpy oracle agrees with the
    port's search (and so with the reference's) on every series."""
    for i, name in enumerate(sorted(SERIES)):
        ts = ref["series"][i]
        o_bins, o_snr, o_harm, o_prof = P.periodicity_oracle(ts, 8, 4,
                                                             N_BINS)
        got = P.periodicity_search(torch.from_numpy(ts), 8, 4, N_BINS)
        np.testing.assert_array_equal(got.bins.numpy(), o_bins, err_msg=name)
        np.testing.assert_array_equal(got.harmonics.numpy(), o_harm)
        np.testing.assert_allclose(got.snr.numpy(), o_snr, rtol=2e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.profiles.numpy(), o_prof,
                                   **PROFILE_TOL)


def test_batched_search_is_each_series(ref):
    """Streams on a leading axis: the same results as one series at a
    time, bit for bit."""
    ts = torch.from_numpy(np.stack(ref["series"][:2]))
    got = P.periodicity_search(ts, 8, 4, N_BINS)
    for s in range(2):
        one = P.periodicity_search(ts[s], 8, 4, N_BINS)
        for a, b in zip(got, one):
            assert torch.equal(a[s], b)


def test_fold_guard_matches_reference(ref):
    """The uint32 phase guard refuses the same lengths with the same
    message, the reserved 2^30 segment of the example cfg among them."""
    msgs = ref["out"]["guard/messages"].tolist()
    assert msgs[1] and msgs[3] and not msgs[0] and not msgs[2]
    for t, msg in zip(GUARD_LENGTHS, msgs):
        if msg:
            with pytest.raises(ValueError) as e:
                P.fold(torch.zeros(t), torch.tensor([1]), N_BINS)
            assert str(e.value) == msg
        else:
            assert P.fold(torch.zeros(t), torch.tensor([1]),
                          N_BINS).shape == (1, N_BINS)


def test_fold_phase_index_wraps_as_uint32():
    """The phase index wraps each product to 32 bits as the reference's
    uint32 arithmetic does: at T = 2^20 and bin 2^19 + 1 the products
    pass 2^32, and the power-of-two T keeps the wrapped index exact."""
    t = 1 << 20
    k = (1 << 19) + 1
    idx = P.phase_index(t, torch.tensor([k]), N_BINS)[0]
    i = np.arange(t, dtype=np.uint64)
    want = (((i * np.uint64(k)) & np.uint64(0xFFFFFFFF)) % np.uint64(t)
            * np.uint64(N_BINS)) // np.uint64(t)
    np.testing.assert_array_equal(idx.numpy(), want.astype(np.int64))


def test_fold_adds_in_a_fixed_order():
    """Two folds of the same series give the same bits, and each bin is
    the mean of its samples (float64 sums, rounded once)."""
    rng = np.random.default_rng(9)
    ts = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    bins = torch.tensor([7, 64, 1000], dtype=torch.int32)
    a, b = P.fold(ts, bins, N_BINS), P.fold(ts, bins, N_BINS)
    assert torch.equal(a, b)
    idx = P.phase_index(4096, bins, N_BINS).numpy()
    x = ts.numpy().astype(np.float64)
    for r in range(3):
        sums = np.bincount(idx[r], weights=x, minlength=N_BINS)
        counts = np.bincount(idx[r], minlength=N_BINS)
        want = (sums.astype(np.float32)
                / np.maximum(counts, 1).astype(np.float32))
        np.testing.assert_allclose(a[r].numpy(), want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ processor

@pytest.mark.parametrize("plan", sorted(PLANS))
def test_processor_plan_and_single_pulse_fields(ref, port_runs, plan):
    """The plan name in full; the single-pulse half at the segment tests'
    gates: counts and zero count exact, the waterfall within 2e-5 of its
    largest value, the time series within ``time_series_error_gates``."""
    out = ref["out"]
    sp, lanes = port_runs[plan]
    assert isinstance(sp, PeriodicitySegmentProcessor)
    assert sp.plan_name == str(out[f"proc/{plan}/plan"]) == PLAN_NAMES[plan]
    t = det.trimmed_length(sp.watfft_len, sp.time_reserved_count)
    for i, (wf, res) in enumerate(lanes):
        assert isinstance(res, PeriodicityResult)
        if plan == "batch2":
            want = {f: out[f"proc/{plan}/batch/{f}"][i]
                    for f in ("signal_counts", "zero_count", "time_series")}
            want_wf = None
        else:
            key = f"proc/{plan}/{i}"
            want = {f: out[f"{key}/detect/{f}"]
                    for f in ("signal_counts", "zero_count", "time_series")}
            ri = out[f"{key}/wf_ri"]
            want_wf = ri[0] + 1j * ri[1]
        np.testing.assert_array_equal(res.signal_counts.numpy(),
                                      want["signal_counts"])
        np.testing.assert_array_equal(res.zero_count.numpy(),
                                      want["zero_count"])
        if want_wf is None:
            wf_err = 2e-5 * float(np.abs(wf.numpy()).max())
            p = np.abs(wf.numpy()[0, :, :t].astype(np.complex128)) ** 2
        else:
            wf_err = float(np.abs(wf.numpy() - want_wf).max())
            assert wf_err <= 2e-5 * np.abs(want_wf).max()
            p = np.abs(want_wf[0, :, :t].astype(np.complex128)) ** 2
        gate = sum(det.time_series_error_gates(
            sp.channel_count, t, float(p.sum(0).max()), wf_err))
        assert np.abs(res.time_series.numpy()
                      - want["time_series"]).max() <= gate


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_processor_candidates(ref, port_runs, plan):
    """The candidates: bins and harmonic counts equal to the reference
    processor's, SNR at the ops' gate, profiles as
    :func:`assert_profiles_follow_series`; at the ops' gates against the
    numpy oracle on the port's own time series; the pulse train's
    candidates on the comb of its fundamental, the noise's not."""
    out = ref["out"]
    sp, lanes = port_runs[plan]
    cfg = sp.cfg
    checks = []
    for i, (_wf, res) in enumerate(lanes):
        pre = f"proc/{plan}/batch" if plan == "batch2" else \
            f"proc/{plan}/{i}/detect"
        lane = (lambda a: a[i]) if plan == "batch2" else (lambda a: a)
        for field in ("candidate_bins", "candidate_harmonics"):
            np.testing.assert_array_equal(getattr(res, field).numpy(),
                                          lane(out[f"{pre}/{field}"]))
        np.testing.assert_allclose(res.candidate_snr.numpy(),
                                   lane(out[f"{pre}/candidate_snr"]),
                                   **SNR_TOL)
        assert_profiles_follow_series(
            res.folded_profiles.numpy(), lane(out[f"{pre}/folded_profiles"]),
            np.abs(res.time_series.numpy()
                   - lane(out[f"{pre}/time_series"])).max())
        assert res.candidate_trials == (
            res.time_series.shape[-1] // 2 + 1 - cfg.periodicity_min_bin, 4)
        checks.append(res)
    # the ops' gates on the port's own series (the reference's ops there)
    train, noise = checks
    ts = train.time_series[0].numpy()
    o_bins, o_snr, o_harm, o_prof = P.periodicity_oracle(
        ts, cfg.periodicity_harmonics, cfg.periodicity_candidates, N_BINS,
        min_bin=cfg.periodicity_min_bin)
    np.testing.assert_array_equal(train.candidate_bins[0].numpy(), o_bins)
    np.testing.assert_allclose(train.candidate_snr[0].numpy(), o_snr,
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(train.folded_profiles[0].numpy(), o_prof,
                               **PROFILE_TOL)
    t_len = ts.shape[-1]
    fundamental = t_len // (1024 // (N // t_len))
    bins = train.candidate_bins[0].tolist()
    assert all(b % fundamental == 0 for b in bins), bins
    assert bins[0] in (fundamental, 2 * fundamental)
    assert any(b % fundamental for b in noise.candidate_bins[0].tolist())
    prof = train.folded_profiles[0, 0].numpy()
    assert prof.max() > 3 * np.median(np.abs(prof))


def test_micro_batch_lanes_are_single_dispatches(port_runs):
    """Each lane of the B = 2 dispatch, bit for bit the fused plan's single
    dispatch of the same segment."""
    _sp, lanes = port_runs["batch2"]
    _sp1, singles = port_runs["fused"]
    for (wf_b, res_b), (wf_1, res_1) in zip(lanes, singles):
        assert torch.equal(wf_b, wf_1)
        for a, b in zip(res_b, res_1):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
            else:
                assert a == b


@pytest.mark.parametrize("plan", ["fused", "staged"])
def test_hooks_match_reference(ref, port_runs, plan):
    """The gate's verdicts (the segment's, each stream's and the hook's
    own), the journal payload and the extra artifacts: the ``.fold.npy``
    within the profile gate of the reference's (the same header bytes),
    the ``.cand.json`` parsed (bins and harmonics equal, SNR within 1e-3)
    and its bytes the port's own computation's."""
    out = ref["out"]
    sp, lanes = port_runs[plan]
    for i, (wf, res) in enumerate(lanes):
        key = f"proc/{plan}/{i}"
        assert has_signal(sp.cfg, res, frequency_bin_count=wf.shape[-2]) \
            == bool(out[f"{key}/has_signal"])
        assert [has_signal(sp.cfg, res, stream=0,
                           frequency_bin_count=wf.shape[-2])] == \
            out[f"{key}/by_stream"].tolist()
        assert res.positive_gate(sp.cfg).tolist() == \
            out[f"{key}/gate"].tolist()
        span, want_span = res.span_extra(), json.loads(str(out[f"{key}/span"]))
        assert list(span) == ["periodicity"]
        got_p, want_p = span["periodicity"], want_span["periodicity"]
        assert got_p["bins"] == want_p["bins"]
        assert got_p["harmonics"] == want_p["harmonics"]
        np.testing.assert_allclose(got_p["snr"], want_p["snr"], atol=2e-3)
        want_arts = {k: bytes.fromhex(v) for k, v in json.loads(
            str(out[f"{key}/artifacts"])).items()}
        arts = dict(res.extra_artifacts("BASE"))
        assert sorted(arts) == sorted(want_arts) == \
            ["BASE.cand.json", "BASE.fold.npy"]
        import io
        prof = np.load(io.BytesIO(want_arts["BASE.fold.npy"]))
        assert arts["BASE.fold.npy"].dtype == np.float32
        assert_profiles_follow_series(
            arts["BASE.fold.npy"], prof,
            np.abs(res.time_series.numpy()
                   - out[f"{key}/detect/time_series"]).max())
        check_cand_json(bytes(arts["BASE.cand.json"]),
                        want_arts["BASE.cand.json"])


def assert_profiles_follow_series(got, want, series_diff: float) -> None:
    """End-to-end folded profiles against the reference's.  A profile
    bin is the mean of its series' samples, so two profiles differ by at
    most their series' largest difference ``series_diff``, plus the
    profile gate: the fold is held to the gate alone on one series
    (:func:`test_ops_match_reference`), and the two packages' series
    differ within the segment tests' time-series gate, by more than the
    profile gate allows (1.2e-5 relative here; ROADMAP C)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bound = (series_diff + PROFILE_TOL["atol"]
             + PROFILE_TOL["rtol"] * np.abs(want))
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


def check_cand_json(got: bytes, want: bytes) -> None:
    """A ``.cand.json`` against the reference's: the same keys in the same
    order, bins and harmonics equal, SNR within 1e-3."""
    g, w = json.loads(got), json.loads(want)
    assert list(g) == list(w) == ["bins", "harmonics", "snr"]
    assert g["bins"] == w["bins"] and g["harmonics"] == w["harmonics"]
    np.testing.assert_allclose(g["snr"], w["snr"], rtol=0, atol=1e-3)
    assert got.endswith(b"\n")


def _host_result(snr, trials=(1, 1)):
    snr = np.asarray(snr, np.float32)
    k = snr.shape[-1]
    return PeriodicityResult(
        zero_count=np.zeros(1, np.int32),
        time_series=np.zeros((1, 8), np.float32), boxcar_lengths=(1,),
        signal_counts=np.zeros((1, 3), np.int32),
        boxcar_series=np.zeros((1, 1, 8), np.float32),
        snr_peaks=np.zeros((1, 3), np.float32),
        candidate_bins=np.zeros((1, k), np.int32), candidate_snr=snr,
        candidate_harmonics=np.ones((1, k), np.int32),
        folded_profiles=np.zeros((1, k, 4), np.float32),
        candidate_trials=trials)


def test_positive_gate_matches_reference(ref):
    """``has_signal`` through the result's own gate on the reference
    tests' host-built results: the same verdicts, trials-corrected."""
    want = ref["out"]["gates/verdicts"].tolist()
    got = [has_signal(Config(search_mode="periodicity",
                             periodicity_snr_threshold=thr),
                      _host_result(snr, trials))
           for snr, trials, thr in GATE_CASES]
    assert got == want == [True, False, False, True, True, True]
    # tensors as the engine hands them over after the fetch
    res = _host_result([[13.0, 1.0]], (100, 4))._replace(
        candidate_snr=torch.tensor([[13.0, 1.0]]),
        zero_count=torch.zeros(1, dtype=torch.int32),
        signal_counts=torch.zeros(1, 3, dtype=torch.int32))
    assert has_signal(Config(periodicity_snr_threshold=6.0), res) is True


def test_span_extra_and_artifacts_of_two_streams():
    """Two streams: one ``.sN.`` file pair a stream, the journal's table
    one row a stream."""
    res = _host_result([[7.0, 1.5], [3.25, 2.0]])._replace(
        candidate_bins=np.array([[3, 6], [5, 9]], np.int32),
        candidate_harmonics=np.array([[1, 2], [4, 1]], np.int32),
        folded_profiles=np.arange(16, dtype=np.float32).reshape(2, 2, 4))
    assert res.span_extra() == {"periodicity": {
        "bins": [[3, 6], [5, 9]], "snr": [[7.0, 1.5], [3.25, 2.0]],
        "harmonics": [[1, 2], [4, 1]]}}
    arts = res.extra_artifacts("out_7")
    assert [p for p, _ in arts] == ["out_7.s0.fold.npy", "out_7.s0.cand.json",
                                    "out_7.s1.fold.npy", "out_7.s1.cand.json"]
    np.testing.assert_array_equal(arts[2][1], np.arange(8, 16).reshape(2, 4))
    assert bytes(arts[3][1]) == \
        b'{"bins": [5, 9], "harmonics": [4, 1], "snr": [3.25, 2.0]}\n'


def test_registry(ref):
    """The two built-in modes, in the reference's order; an unknown mode
    raises; ``build_processor`` passes its arguments through."""
    assert [m.name for m in registry.search_modes()] == \
        ["single_pulse", "periodicity"]
    assert registry.resolve_mode(Config()).resolve() is SegmentProcessor
    assert registry.resolve_mode(Config(search_mode="PERIODICITY")) \
        .resolve() is PeriodicitySegmentProcessor
    with pytest.raises(ValueError, match="unknown search_mode 'fold'"):
        registry.resolve_mode(Config(search_mode="fold"))
    with pytest.raises(ValueError, match="already registered"):
        registry.register_mode(registry.search_modes()[0])
    sp = registry.build_processor(Config.from_reference_fields(
        cfg_fields()), device="cpu", staged=True)
    assert sp.staged and sp.plan_name.endswith("+period")


# ------------------------------------------------------------ the CLI

def _cli_case(tmp):
    """A two-segment file (noise, then two pulses; no reserve, so the
    segments do not overlap) and the arguments both packages take,
    with the run manifest and the checkpoint armed."""
    data = tmp / "periodic.bin"
    np.concatenate([SEGMENTS["noise"], SEGMENTS["pulses"]]).tofile(data)
    argv = ["--config_file_name", str(tmp / "none.cfg"),
            "--input_file_path", str(data), "--deterministic_timestamps",
            "1", "--gui_enable", "0", "--writer_thread_count", "0"]
    for key, value in cfg_fields().items():
        if key in ("baseband_input_count", "baseband_input_bits",
                   "baseband_freq_low", "baseband_bandwidth",
                   "baseband_sample_rate", "spectrum_channel_count",
                   "mitigate_rfi_average_method_threshold",
                   "mitigate_rfi_spectral_kurtosis_threshold",
                   "signal_detect_signal_noise_threshold",
                   "signal_detect_max_boxcar_length", "fft_strategy",
                   "search_mode"):
            argv += [f"--{key}", str(value)]
    return argv + ["--dm", "0", "--baseband_reserve_sample", "0"]


def _durable(d):
    return ["--baseband_output_file_prefix", f"{d}/out_",
            "--checkpoint_path", str(d / "ck.json"),
            "--run_manifest_path", str(d / "manifest.jsonl")]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("periodicity_cli")
    argv = _cli_case(tmp)
    dirs = {who: tmp / who for who in ("port", "ref")}
    for d in dirs.values():
        d.mkdir()
    stats, pipe = M.run(argv + _durable(dirs["port"]) + ["--device", "cpu"])
    out = run_reference([
        {"key": "main", "fn": "test_torch_ref:pipeline_main",
         "args": [argv + _durable(dirs["ref"]), str(dirs["ref"])]},
        {"key": "fsck_port", "fn": "test_torch_ref:fsck_dir",
         "args": [str(dirs["port"] / "manifest.jsonl"),
                  str(dirs["port"] / "ck.json")]}], tmp)
    return {"ref": out, "stats": stats, "pipe": pipe, "dirs": dirs}


def test_cli_same_positives_and_files(cli):
    """The pulse segment positive in both, the noise segment not;
    the same file names, ``.fold.npy`` and ``.cand.json`` included."""
    out, stats, pipe = cli["ref"], cli["stats"], cli["pipe"]
    assert int(out["main/rc"]) == 0
    assert pipe.processor.plan_name == "fused:four_step+ftail+period"
    assert stats.segments == 2 and pipe.positive_segments == [1]
    names = sorted(os.listdir(cli["dirs"]["port"]))
    assert names == out["main/files"].tolist()
    assert sum(n.endswith(".fold.npy") for n in names) == 1
    assert sum(n.endswith(".cand.json") for n in names) == 1
    files = pipe.sink.written[0]
    assert [os.path.basename(p) for p in files.fold_paths] == sorted(
        n for n in names if n.endswith((".fold.npy", ".cand.json")))[::-1]


def test_cli_fold_and_candidate_contents(cli):
    """``.fold.npy`` as :func:`assert_profiles_follow_series`, the series'
    difference bounded by the time-series gate of the two waterfall dumps,
    and ``.cand.json`` as :func:`check_cand_json`."""
    out, d = cli["ref"], cli["dirs"]["port"]
    fold = next(n for n in os.listdir(d) if n.endswith(".fold.npy"))
    got = np.load(d / fold)
    assert got.dtype == np.float32 and got.shape == (4, N_BINS)
    # the series' gate from the two waterfall dumps, as the pipeline
    # tests derive it
    npy = fold.replace(".fold.npy", ".0.npy")
    want_wf = out[f"main/npy/{npy}"]
    wf_err = float(np.abs(np.load(d / npy) - want_wf).max())
    p = np.abs(want_wf.astype(np.complex128)) ** 2
    ts_gate = sum(det.time_series_error_gates(
        CHANNELS, p.shape[-1], float(p.sum(0).max()), wf_err))
    assert_profiles_follow_series(got, out[f"main/npy/{fold}"], ts_gate)
    cand = fold.replace(".fold.npy", ".cand.json")
    check_cand_json((d / cand).read_bytes(),
                    out[f"main/json/{cand}"].tobytes())


def test_cli_each_fsck_passes_the_others_run(cli):
    """With the manifest armed, the fold and candidate files are
    manifest artifacts: the reference's fsck reports the port's run
    clean, and the port's fsck the reference's."""
    rep = json.loads(str(cli["ref"]["fsck_port/report"]))
    assert rep["clean"], rep
    for who in ("port", "ref"):
        d = cli["dirs"][who]
        rep = FS.fsck(str(d / "manifest.jsonl"), str(d / "ck.json"))
        assert rep["clean"] and rep["complete_groups"] >= 1, rep
    wal = (cli["dirs"]["port"] / "manifest.jsonl").read_bytes()
    assert b".fold.npy" in wal and b".cand.json" in wal
