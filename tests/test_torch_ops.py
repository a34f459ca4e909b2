"""The port's plain ops against the JAX package's, on the same inputs made
with numpy from a seed.  Each tolerance is stated beside its check."""

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import synth
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.ops import fft as F
from srtb_tpu_torch.ops import rfi
from srtb_tpu_torch.ops import unpack as U
from srtb_tpu_torch.ops import window as W
from test_torch_ref import run_reference

RNG = np.random.default_rng(20261016)
BYTES = RNG.integers(0, 256, 4096, dtype=np.uint8)
X = RNG.standard_normal(1 << 13).astype(np.float32)
SPEC = (RNG.standard_normal(1 << 12)
        + 1j * RNG.standard_normal(1 << 12)).astype(np.complex64)
SPEC[7] *= 30.0  # an RFI spike above the stage-1 threshold
WF = (RNG.standard_normal((16, 512))
      + 1j * RNG.standard_normal((16, 512))).astype(np.complex64)
WF[3, ::50] *= 40.0  # impulsive row: SK far above the band
WF[9] = np.exp(1j * RNG.uniform(0, 6, 512)).astype(np.complex64)  # SK ~ 1
TS = RNG.standard_normal((2, 700)).astype(np.float32) + 50.0
TS[0, 300:303] += 12.0  # a pulse
ZC = np.array([3, 5], dtype=np.int32)
SIG = RNG.standard_normal(1 << 12) * 3.0
SIG[100] = 40.0  # clipped by every bit width
# the J1644-4559 chirp geometry (example cfg), 2^20 channels
CHIRP = dict(n=1 << 20, f_min=1437.0, df=-64.0 / (1 << 20), f_c=1373.0,
             dm=-478.80)
WINDOWS = [("hann", 1), ("hann", 1000), ("hamming", 1000),
           ("rectangle", 64), ("hann", 4096)]
QUANT_BITS = (1, 2, 4, 8)
UNPACK = [(b, w) for b in (1, 2, 4, 8, -8) for w in (False, True)
          if not (w and b not in (1, 2, 4, 8))]
ZF = (RNG.standard_normal(1 << 12)
      + 1j * RNG.standard_normal(1 << 12)).astype(np.complex64)
SUBBYTE = [(b, w) for b in (1, 2, 4) for w in (False, True)]
# the sub-byte R2C's plane FFT by strategy, below the two-pass window
# (planes of 2^12 ... 2^14 bytes): "pallas2" takes the B6-leg route there
SUBBYTE_STRATEGIES = [(b, s) for b in (2, 4)
                      for s in ("pallas2_interpret", "mxu")]
# (length, inverse, rows_impl, len_cap): the four-step with rows outside
# the kernels' window, recursing past a small cap, and at 2^24, the
# shortest length whose legs (2^12) run the row kernel B6
FOUR_STEP = {"n13_xla": (1 << 13, False, "xla", None),
             "n13_inv_cap32": (1 << 13, True, "pallas", 32),
             "n24_b6_legs": (1 << 24, False, "pallas", None)}


def _four_step_input(n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


def _win(nbits):
    return W.window_coefficients("hann", BYTES.size * 8 // abs(nbits))


def _win_planes(nbits):
    return F.subbyte_window_planes(_win(nbits), nbits)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jobs = []
    for name, n in WINDOWS:
        jobs += [{"key": f"win/{name}/{n}",
                  "fn": "srtb_tpu.ops.window:window_coefficients",
                  "args": [name, n]},
                 {"key": f"dewin/{name}/{n}",
                  "fn": "srtb_tpu.ops.window:dewindow_coefficients",
                  "args": [name, n]}]
    for nbits, win in UNPACK:
        jobs.append({"key": f"unpack/{nbits}/{win}",
                     "fn": "srtb_tpu.ops.unpack:unpack",
                     "args": [BYTES, nbits, _win(nbits) if win else None]})
    jobs += [
        {"key": "rfft", "fn": "srtb_tpu.ops.fft:rfft_drop_nyquist",
         "args": [X]},
        {"key": "waterfall", "fn": "srtb_tpu.ops.fft:waterfall_c2c",
         "args": [SPEC, 16, W.dewindow_coefficients("hann", 256)]},
        {"key": "s1", "fn":
         "srtb_tpu.ops.rfi:mitigate_rfi_average_and_normalize",
         "args": [SPEC, 10.0, rfi.normalization_coefficient(4096, 16)]},
        {"key": "ranges", "fn": "srtb_tpu.ops.rfi:eval_rfi_ranges",
         "args": ["1418-1422, 1400 - 1401,bad"]},
        {"key": "mask", "fn": "srtb_tpu.ops.rfi:rfi_ranges_to_mask",
         "args": [[(1418.0, 1422.0), (1400.0, 1401.0)], 4096, 1437.0,
                  -64.0]},
        {"key": "manual", "fn": "srtb_tpu.ops.rfi:mitigate_rfi_manual",
         "args": [SPEC, np.arange(4096) % 7 == 0]},
        {"key": "sk_thr", "fn": "srtb_tpu.ops.rfi:sk_decision_thresholds",
         "args": [512, 1.3]},
        {"key": "sk", "fn":
         "srtb_tpu.ops.rfi:mitigate_rfi_spectral_kurtosis",
         "args": [WF, 1.3]},
        {"key": "chirp_host", "fn": "srtb_tpu.ops.dedisperse:"
         "chirp_factor_host", "args": [CHIRP["n"], CHIRP["f_min"],
                                       CHIRP["df"], CHIRP["f_c"],
                                       CHIRP["dm"]]},
        {"key": "detect_ts", "fn":
         "srtb_tpu.ops.detect:detect_from_time_series",
         "args": [TS, ZC, 6.0, 64]},
        {"key": "detect_wf", "fn": "srtb_tpu.ops.detect:detect",
         "args": [WF[None], 40, 6.0, 32]},
    ]
    for drop in (False, True):
        jobs.append({"key": f"hermitian/{drop}",
                     "fn": "srtb_tpu.ops.fft:hermitian_rfft_post",
                     "args": [ZF, drop]})
    for nbits, win in SUBBYTE:
        jobs.append({"key": f"rfft_subbyte/{nbits}/{win}",
                     "fn": "srtb_tpu.ops.fft:rfft_subbyte",
                     "args": [BYTES, nbits, "four_step",
                              _win_planes(nbits) if win else None]})
    for name, (n, inv, rows, cap) in FOUR_STEP.items():
        jobs.append({"key": f"four_step/{name}",
                     "fn": "srtb_tpu.ops.fft:four_step_fft",
                     "args": [_four_step_input(n), inv,
                              "pallas_interpret" if rows == "pallas"
                              else rows, cap]})
    for strategy in ("pallas_interpret", "pallas2_interpret", "mxu"):
        jobs.append({"key": f"segment_rfft/{strategy}",
                     "fn": "srtb_tpu.ops.fft:segment_rfft",
                     "args": [X, strategy]})
    for nbits, strategy in SUBBYTE_STRATEGIES:
        jobs.append({"key": f"rfft_subbyte_s/{nbits}/{strategy}",
                     "fn": "srtb_tpu.ops.fft:rfft_subbyte",
                     "args": [BYTES, nbits, strategy]})
    jobs += [
        {"key": "mean_packed", "fn": "srtb_tpu.ops.rfi:mean_power_packed",
         "args": [ZF]},
        {"key": "s1_given_mean",
         "fn": "srtb_tpu.ops.rfi:mitigate_rfi_s1_given_mean",
         "args": [SPEC, np.float32(2.5), 3.0,
                  rfi.normalization_coefficient(4096, 16)]},
    ]
    for nbits in QUANT_BITS:
        jobs.append({"key": f"quantize/{nbits}",
                     "fn": "srtb_tpu.io.synth:quantize",
                     "args": [SIG, nbits]})
    return run_reference(jobs, tmp_path_factory.mktemp("ref_ops"))


@pytest.mark.parametrize("name,n", WINDOWS)
def test_window_coefficients(ref, name, n):
    """Exact: the same float64 cosine sum rounded to float32."""
    for key, fn in (("win", W.window_coefficients),
                    ("dewin", W.dewindow_coefficients)):
        got = fn(name, n)
        want = ref.get(f"{key}/{name}/{n}")
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nbits,win", UNPACK)
def test_unpack(ref, nbits, win):
    """Exact: integer fields, one float32 multiply by the window."""
    w = torch.from_numpy(_win(nbits)) if win else None
    got = U.unpack(torch.from_numpy(BYTES), nbits, w).numpy()
    np.testing.assert_array_equal(got, ref[f"unpack/{nbits}/{win}"])


def test_unpack_rejects_unported_widths():
    """Every width of the reference's SUPPORTED_BITS unpacks
    (``test_torch_formats.py`` holds each to the reference); a width
    outside it raises ValueError, as in the reference."""
    assert U.SUPPORTED_BITS == (1, 2, 4, 8, -8, 16, -16, 32, 64)
    for nbits in (3, -4, 12, -32, -64):
        with pytest.raises(ValueError, match="unsupported"):
            U.unpack(torch.from_numpy(BYTES), nbits)


def test_rfft_drop_nyquist(ref):
    """float32 FFTs of two libraries: agreement to 1e-5 of the largest bin
    (rounding grows like eps * log2(n) per bin)."""
    got = F.rfft_drop_nyquist(torch.from_numpy(X)).numpy()
    want = ref["rfft"]
    assert got.shape == want.shape == (X.size // 2,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_waterfall_c2c_unnormalized_with_dewindow(ref):
    """Unnormalized backward C2C per row + de-window: 1e-5 of the largest
    value (float32 FFT rounding; torch.fft.ifft normalizes by default, the
    port asks for norm="forward")."""
    dewin = torch.from_numpy(W.dewindow_coefficients("hann", 256))
    got = F.waterfall_c2c(torch.from_numpy(SPEC), 16, dewin).numpy()
    want = ref["waterfall"]
    assert got.shape == want.shape == (16, 256)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("drop", [False, True])
def test_hermitian_rfft_post(ref, drop):
    """The R2C from the packed half-size C2C, m + 1 bins or drop-Nyquist:
    1e-6 of the largest (the port's twiddle is float64-built, the
    reference's a float32 factored phase)."""
    got = F.hermitian_rfft_post(torch.from_numpy(ZF), drop).numpy()
    want = ref[f"hermitian/{drop}"]
    assert got.shape == want.shape == (ZF.size + (0 if drop else 1),)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    x = np.fft.ifft(ZF.astype(np.complex128))
    real = np.empty(2 * ZF.size)
    real[0::2], real[1::2] = x.real, x.imag
    direct = np.fft.rfft(real)[:got.size]
    assert np.abs(got - direct).max() <= 1e-5 * np.abs(direct).max()


@pytest.mark.parametrize("nbits,win", SUBBYTE)
def test_rfft_subbyte(ref, nbits, win):
    """The blocked-plane sub-byte R2C (unpack to planes, pack plane pairs,
    plane FFTs, cross-plane twiddle and butterfly, Hermitian post) against
    the reference's, 1e-5 of the largest bin, and against the plain R2C
    of the sample-order samples."""
    data = torch.from_numpy(BYTES)
    planes = U.unpack_subbyte_planes(data, nbits)
    if win:
        planes = planes * torch.from_numpy(_win_planes(nbits))
    got = F.rfft_subbyte(F.subbyte_planes_to_packed(planes)).numpy()
    want = ref[f"rfft_subbyte/{nbits}/{win}"]
    assert got.shape == want.shape == (BYTES.size * 4 // nbits,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    w = torch.from_numpy(_win(nbits)) if win else None
    direct = F.rfft_drop_nyquist(U.unpack(data, nbits, w)).numpy()
    assert np.abs(got - direct).max() <= 1e-5 * np.abs(direct).max()


@pytest.mark.parametrize("name", sorted(FOUR_STEP))
def test_four_step_fft(ref, name):
    """The four-step C2C with its length window: rows in [2^12, 2^16] run
    the row kernel (its plain version here), longer rows recurse, shorter
    go to torch.fft; 1e-5 of the largest value against the reference's
    with its Pallas legs in interpret mode."""
    n, inverse, rows, cap = FOUR_STEP[name]
    x = torch.from_numpy(_four_step_input(n))
    got = F.four_step_fft(x, inverse, rows, cap).numpy()
    want = ref[f"four_step/{name}"]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_segment_rfft_strategies(ref):
    """"pallas" (packed half-size C2C by the four-step, Hermitian post),
    "pallas2" below its window (the same four-step on B6 legs, by the
    reference's size rule), "mxu" (one torch.fft C2C where the reference
    runs DFT-matrix matmuls) and "four_step" give the reference's spectrum
    to 1e-5; "monolithic" refuses an epilogue."""
    x = torch.from_numpy(X)
    for strategy in ("pallas", "pallas2", "mxu"):
        want = ref[f"segment_rfft/{strategy}"
                   + ("" if strategy == "mxu" else "_interpret")]
        got = F.segment_rfft(x, strategy).numpy()
        assert got.shape == want.shape == (X.size // 2,)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    want = ref["segment_rfft/pallas_interpret"]
    for strategy in ("four_step", "monolithic"):
        got = F.segment_rfft(x, strategy).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError):
        F.segment_rfft(x, "monolithic", epilogue=lambda zf, s: s)
    with pytest.raises(ValueError):
        F.segment_rfft(x, "bogus")


@pytest.mark.parametrize("nbits,strategy", SUBBYTE_STRATEGIES)
def test_rfft_subbyte_strategies(ref, nbits, strategy):
    """The sub-byte R2C with its plane FFT by "pallas2" (below the window:
    the four-step with B6 legs) and "mxu" (torch.fft) against the
    reference's with the same strategy: 1e-5 of the largest bin."""
    z = U.unpack_subbyte_planes(torch.from_numpy(BYTES), nbits)
    got = F.rfft_subbyte(F.subbyte_planes_to_packed(z),
                         strategy.replace("_interpret", "")).numpy()
    want = ref[f"rfft_subbyte_s/{nbits}/{strategy}"]
    assert got.shape == want.shape == (BYTES.size * 4 // nbits,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_mean_power_packed_and_s1_given_mean(ref):
    """The Parseval mean from the packed C2C output: 1e-6 relative to the
    reference's and to the mean over the assembled spectrum; stage 1 with a
    given mean: the same zapped set, survivors to 1e-6 of the largest."""
    zf = torch.from_numpy(ZF)
    got = rfi.mean_power_packed(zf)
    assert got.shape == (1,)
    np.testing.assert_allclose(got.numpy(), ref["mean_packed"], rtol=1e-6)
    spec = F.hermitian_rfft_post(zf.to(torch.complex128), True)
    np.testing.assert_allclose(got.numpy(),
                               rfi.power(spec).mean().numpy(), rtol=1e-6)
    out = rfi.mitigate_rfi_s1_given_mean(
        torch.from_numpy(SPEC), torch.tensor([2.5], dtype=torch.float32), 3.0,
        rfi.normalization_coefficient(4096, 16)).numpy()
    want = ref["s1_given_mean"]
    np.testing.assert_array_equal(out == 0, want == 0)
    assert 0 < (out == 0).sum() < out.size // 2
    assert np.abs(out - want).max() <= 1e-6 * np.abs(want).max()


def test_rfi_stage1(ref):
    """Same zapped set; survivors agree to float32 rounding of the scale
    (1e-6 of the largest) — the mean power is one float32 reduction in
    another summation order, and no bin lies within that of threshold."""
    norm = rfi.normalization_coefficient(4096, 16)
    got = rfi.mitigate_rfi_average_and_normalize(
        torch.from_numpy(SPEC), 10.0, norm).numpy()
    want = ref["s1"]
    np.testing.assert_array_equal(got == 0, want == 0)
    assert got[7] == 0
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_manual_mask_and_ranges(ref):
    """Exact: host-side parsing and bin arithmetic, and a select."""
    assert rfi.eval_rfi_ranges("1418-1422, 1400 - 1401,bad") == \
        [tuple(ref[f"ranges/{i}"].tolist()) for i in range(2)]
    mask = rfi.rfi_ranges_to_mask([(1418.0, 1422.0), (1400.0, 1401.0)],
                                  4096, 1437.0, -64.0)
    np.testing.assert_array_equal(mask, ref["mask"])
    zap = torch.from_numpy(np.arange(4096) % 7 == 0)
    got = rfi.mitigate_rfi_manual(torch.from_numpy(SPEC), zap).numpy()
    np.testing.assert_array_equal(got, ref["manual"])
    assert rfi.rfi_ranges_to_mask([], 16, 1.0, 1.0) is None


def test_normalization_and_sk_thresholds(ref):
    """Exact: the same float32 expressions."""
    assert rfi.sk_decision_thresholds(512, 1.3) == \
        tuple(ref["sk_thr"].tolist())
    assert rfi.normalization_coefficient(1 << 29, 2048) == \
        np.float32(np.power(np.float32(2 ** 29) ** 2 / np.float32(2048),
                            np.float32(-0.5)))


def test_spectral_kurtosis_zap(ref):
    """Same zapped rows (the planted impulsive and constant-modulus rows);
    kept rows are passed through unchanged."""
    got = rfi.mitigate_rfi_spectral_kurtosis(torch.from_numpy(WF),
                                             1.3).numpy()
    want = ref["sk"]
    np.testing.assert_array_equal(got, want)
    assert not got[3].any() and not got[9].any()


def test_chirp_against_float64_host_chirp(ref):
    """The port's float64 phase against the reference's float64 numpy
    chirp at the J1644-4559 geometry: 2e-5, the gate of
    tests/test_dedisperse.py:127 (the port's own error is float32 trig,
    ~1e-7)."""
    got = dd.chirp_factor(CHIRP["n"], CHIRP["f_min"], CHIRP["df"],
                          CHIRP["f_c"], CHIRP["dm"]).numpy()
    assert np.abs(got - ref["chirp_host"]).max() < 2e-5


def test_chirp_turns_modf_sign():
    """frac(k) takes the sign of k (modf), negative at negative DM."""
    turns = dd.chirp_turns(1 << 10, 1437.0, -64.0 / 1024, 1373.0, -478.8)
    assert (turns <= 0).all() and (turns > -1).all()
    assert dd.chirp_turns(4, 1437.0, -1.0, 1373.0, 478.8).min() >= 0


def test_nsamps_reserved_and_frequencies():
    """The example cfg's overlap and spectrum geometry (same integer
    arithmetic as the reference)."""
    cfg = Config(baseband_input_count=1 << 30, spectrum_channel_count=2048,
                 baseband_freq_low=1437.0, baseband_bandwidth=-64.0,
                 baseband_sample_rate=128e6, dm=-478.8)
    assert dd.nsamps_reserved(cfg) % (2 * 2048) == 0
    assert 2.3e7 < dd.nsamps_reserved(cfg) < 2.4e7
    assert dd.spectrum_frequencies(cfg, 1 << 29) == (1437.0, 1373.0,
                                                     -64.0 / (1 << 29))
    assert dd.nsamps_reserved(cfg.replace(baseband_reserve_sample=False)) \
        == 0


def _check_detect(got: det.DetectResult, key: str, ref, k_ch: int):
    """Counts and zero counts exact; the mean-subtracted series within
    the reference's float32 summation gate; peaks to 1e-5 relative."""
    np.testing.assert_array_equal(got.signal_counts.numpy(),
                                  ref[f"{key}/signal_counts"])
    np.testing.assert_array_equal(got.zero_count.numpy(),
                                  ref[f"{key}/zero_count"])
    assert got.boxcar_lengths == tuple(ref[f"{key}/boxcar_lengths"])
    want_ts = ref[f"{key}/time_series"]
    gate, _ = det.time_series_error_gates(k_ch, want_ts.shape[-1],
                                          float(np.abs(TS).max()), 0.0)
    assert np.abs(got.time_series.numpy() - want_ts).max() <= gate
    np.testing.assert_allclose(got.snr_peaks.numpy(),
                               ref[f"{key}/snr_peaks"], rtol=1e-5)


def test_detect_from_time_series(ref):
    got = det.detect_from_time_series(torch.from_numpy(TS),
                                      torch.from_numpy(ZC), 6.0, 64)
    _check_detect(got, "detect_ts", ref, 1)
    assert got.signal_counts[0, 0] > 0


def test_detect_from_waterfall(ref):
    got = det.detect(torch.from_numpy(WF[None]), 40, 6.0, 32)
    np.testing.assert_array_equal(got.signal_counts.numpy(),
                                  ref["detect_wf/signal_counts"])
    np.testing.assert_array_equal(got.zero_count.numpy(),
                                  ref["detect_wf/zero_count"])
    want = ref["detect_wf/time_series"]
    p = np.abs(WF.astype(np.complex128)) ** 2
    gate, _ = det.time_series_error_gates(16, 512, float(p.sum(0).max()),
                                          0.0)
    assert np.abs(got.time_series.numpy() - want).max() <= gate


@pytest.mark.parametrize("nbits", QUANT_BITS)
def test_synth_quantize_and_pack(ref, nbits):
    """Exact: the digitizer model (scale to ~3 sigma, round half to even,
    clip) and the MSB-first packing give the reference's bytes, and the
    port's unpack inverts the packing."""
    got = synth.quantize(torch.from_numpy(SIG), nbits)
    np.testing.assert_array_equal(got.numpy(), ref[f"quantize/{nbits}"])
    if nbits < 8:
        levels = U.unpack(got, nbits)
        assert levels.max() <= (1 << nbits) - 1 and levels.numel() == SIG.size
        np.testing.assert_array_equal(
            synth.pack_subbyte(levels.to(torch.uint8), nbits).numpy(),
            got.numpy())


def test_synth_dispersed_pulse_is_recovered_by_the_chirp():
    """make_dispersed_baseband disperses with the inverse chirp: the
    dedispersed 8-bit stream concentrates the pulse again."""
    n, f_min, bw, dm = 1 << 14, 1437.0, -64.0, -30.0
    gen = torch.Generator().manual_seed(3)
    raw = synth.make_dispersed_baseband(n, f_min, bw, dm, [n // 2], nbits=8,
                                        pulse_amp=30.0, generator=gen)
    x = raw.to(torch.float32) - raw.to(torch.float32).mean()
    spec = torch.fft.rfft(x)[:-1]
    spec = spec * dd.chirp_factor(n // 2, f_min, bw / (n // 2), f_min + bw,
                                  dm)
    y = torch.fft.irfft(torch.cat([spec, spec[:1] * 0]), n)
    peak = int(y.abs().argmax())
    assert abs(peak - n // 2) < 64
    assert float(y.abs().max()) > 5 * float(x.abs().max()) / 2
