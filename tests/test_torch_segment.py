"""The port's SegmentProcessor against the JAX package's, at small shapes
covering each plan the port takes: ``fused:monolithic`` with rows of 1024
outside the Pallas row-FFT window (K1, K2, K3 + K4), with rows of 2^13
inside it (B7 + K4) and without ``use_pallas`` (the reference's plain
chain and chirp bank against K1, K2, K3 + K4), ``fused:pallas+ftail+skzap``
(B13, B6, the K2 epilogue, B8), ``fused:pallas`` with ``fused_tail = off``
(B7 + K4), ``fused:pallas+ftail`` with ``use_pallas_sk = 0`` (B6 rows,
plain SK), ``fused:four_step`` with and without the fused tail (B13
and the sub-byte R2C on cuFFT rows), ``fused:pallas2`` with and without
the fused tail (below the two-pass window: B6 legs, as the reference's
size rule says), ``fused:mxu+ftail+skzap``, and the staged plan forced
at a small size without ``use_pallas`` (plain stage 1 + manual mask, B3,
then plain SK or K3 + K4).  Then the multi-stream formats
(``interleaved_samples_2`` at 2 and 8 bits, ``naocpsr_snap1`` at -8,
``gznupsr_a1`` and the 4-stream ``gznupsr_a1_v1``) on each plan family:
monolithic, pallas, pallas2, staged, staged without ``use_pallas`` (B3),
staged with the fused tail, and front-fused (2-pol 8-bit), the pulse in
stream 0 only.  Both packages run one configuration; the reference runs
its Pallas kernels in interpret mode."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import formats, synth
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.ops import fft as F
from srtb_tpu_torch.pipeline import segment as seg
from srtb_tpu_torch.pipeline.runtime import has_signal
from srtb_tpu_torch.pipeline.segment import SegmentProcessor
from test_torch_ref import REPO, environ, run_reference

EXAMPLE_CFG = REPO / "examples" / "srtb_config_1644-4559.cfg"


def slice_config(n: int, channels: int, dm: float) -> Config:
    return Config(
        baseband_input_count=n, baseband_input_bits=2,
        baseband_format_type="simple", baseband_freq_low=1437.0,
        baseband_bandwidth=-64.0, baseband_sample_rate=128e6, dm=dm,
        spectrum_channel_count=channels, baseband_reserve_sample=True,
        mitigate_rfi_freq_list="1418-1422",
        mitigate_rfi_average_method_threshold=1.5,
        mitigate_rfi_spectral_kurtosis_threshold=1.5,
        signal_detect_signal_noise_threshold=8.0,
        signal_detect_max_boxcar_length=64,
        fft_strategy="monolithic", use_pallas=True, use_pallas_sk=True)


def dispersed_bytes(cfg: Config, n_samples: int, pulse_at: int,
                    amp: float, seed: int) -> np.ndarray:
    """Baseband of the cfg's sample width: numpy noise plus a pulse
    dispersed by the inverse float64 chirp, quantized by the port's
    synth."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n_samples)
    pulse = np.zeros(n_samples)
    pulse[pulse_at:pulse_at + 32] = amp * rng.standard_normal(32)
    m = n_samples // 2
    spec = np.fft.rfft(pulse)
    f_low, bw = cfg.baseband_freq_low, cfg.baseband_bandwidth
    spec[:m] *= np.conj(dd.chirp_factor_host(m, f_low, bw / m, f_low + bw,
                                             cfg.dm))
    sig = torch.from_numpy(x + np.fft.irfft(spec, n_samples))
    return synth.quantize(sig, cfg.baseband_input_bits).numpy()


def stream_bytes(cfg: Config, n_samples: int, pulse_at: int, amp: float,
                 seed: int) -> np.ndarray:
    """The bytes of the cfg's format: stream 0 carries the dispersed
    pulse, every other stream noise of its own seed, each quantized apart
    (``dispersed_bytes``), then interleaved in the format's own layout."""
    fmt = formats.resolve(cfg.baseband_format_type)
    rows = [dispersed_bytes(cfg, n_samples, pulse_at, amp if s == 0 else 0.0,
                            seed + s) for s in range(fmt.data_stream_count)]
    return synth.interleave_streams(torch.from_numpy(np.stack(rows)),
                                    fmt.unpack_variant).numpy()


# (n, channels, dm, pulse amplitude, window, overrides, the plan both
# packages resolve, each with the ingest ring: every shape reserves a
# byte-aligned tail): the n18 shape's reserve trims a fifth of the
# waterfall's time axis; the hann shapes window the segment (the unpack's
# window multiply and the waterfall's de-window, whose near-zero edges
# trip every row's SK)
PALLAS = {"fft_strategy": "pallas"}
FOUR_STEP = {"fft_strategy": "four_step"}
PALLAS2 = {"fft_strategy": "pallas2"}
# the staged plan forced (the processor's ``staged`` argument) without
# use_pallas, as the example cfg runs it at 2^30; fused_tail off, since
# "auto" fuses the staged tail at small n
STAGED_PLAIN = {"staged": True, "fft_strategy": "four_step",
                "use_pallas": False, "fused_tail": "off"}
# the staged plan with the fused tail ("auto" fuses it at 2^16), under the
# reference's environment switches ("env", set around both processors)
STAGED = {"staged": True, "fft_strategy": "four_step"}
ROWS_PALLAS2 = {"SRTB_STAGED_ROWS_IMPL": "pallas2"}
FFUSE = dict(STAGED, front_fuse="on", use_pallas=False,
             use_pallas_sk=False, env=ROWS_PALLAS2)
SHAPES = {
    "n16_ch32": (1 << 16, 32, -0.1, 4.0, "rectangle", {},
                 "fused:monolithic+ring"),
    "n18_ch128": (1 << 18, 128, -0.5, 7.0, "rectangle", {},
                  "fused:monolithic+ring"),
    "n16_ch32_hann": (1 << 16, 32, -0.1, 4.0, "hann", {},
                      "fused:monolithic+ring"),
    "n17_ch8_rows_in_window": (1 << 17, 8, -0.2, 5.0, "rectangle", {},
                               "fused:monolithic+ring"),
    "n16_ch4_skzap": (1 << 16, 4, -0.1, 4.0, "rectangle", PALLAS,
                      "fused:pallas+ftail+skzap+ring"),
    "n17_ch8_skzap_hann": (1 << 17, 8, -0.2, 5.0, "hann", PALLAS,
                           "fused:pallas+ftail+skzap+ring"),
    "n16_ch4_unfused": (1 << 16, 4, -0.1, 4.0, "rectangle",
                        dict(PALLAS, fused_tail="off"), "fused:pallas+ring"),
    "n17_ch8_no_pallas_sk": (1 << 17, 8, -0.2, 5.0, "rectangle",
                             dict(PALLAS, use_pallas_sk=False),
                             "fused:pallas+ftail+ring"),
    "n16_ch32_four_step": (1 << 16, 32, -0.1, 4.0, "rectangle", FOUR_STEP,
                           "fused:four_step+ftail+ring"),
    "n17_ch8_four_step_unfused_hann": (
        1 << 17, 8, -0.2, 5.0, "hann", dict(FOUR_STEP, fused_tail="off"),
        "fused:four_step+ring"),
    "n16_ch4_no_pallas": (1 << 16, 4, -0.1, 4.0, "rectangle",
                          {"use_pallas": False}, "fused:monolithic+ring"),
    "n16_ch4_pallas2": (1 << 16, 4, -0.1, 4.0, "rectangle", PALLAS2,
                        "fused:pallas2+ftail+skzap+ring"),
    "n17_ch8_pallas2_unfused_hann": (
        1 << 17, 8, -0.2, 5.0, "hann", dict(PALLAS2, fused_tail="off"),
        "fused:pallas2+ring"),
    "n16_ch4_mxu": (1 << 16, 4, -0.1, 4.0, "rectangle",
                    {"fft_strategy": "mxu"}, "fused:mxu+ftail+skzap+ring"),
    "n16_ch32_staged_no_pallas": (
        1 << 16, 32, -0.1, 4.0, "rectangle",
        dict(STAGED_PLAIN, use_pallas_sk=False), "staged:four_step+ring"),
    "n17_ch8_staged_no_pallas_sk": (1 << 17, 8, -0.2, 5.0, "rectangle",
                                    STAGED_PLAIN, "staged:four_step+ring"),
    "n16_ch4_staged_rows_pallas": (
        1 << 16, 4, -0.1, 4.0, "rectangle",
        dict(STAGED, env={"SRTB_STAGED_ROWS_IMPL": "pallas"}),
        "staged:four_step+ftail+skzap+ring"),
    "n16_ch32_staged_rows_pallas2": (
        1 << 16, 32, -0.1, 4.0, "rectangle", dict(STAGED, env=ROWS_PALLAS2),
        "staged:four_step+ftail+ring"),
    "n16_ch4_staged_blocked": (
        1 << 16, 4, -0.1, 4.0, "rectangle",
        dict(STAGED, use_pallas=False, use_pallas_sk=False,
             env={"SRTB_STAGED_BLOCKED": "1"}), "staged:four_step+ftail+ring"),
    "n16_ch4_ffuse_1bit": (1 << 16, 4, -0.1, 6.0, "rectangle",
                           dict(FFUSE, baseband_input_bits=1),
                           "staged:four_step+ftail+ffuse+ring"),
    "n16_ch4_ffuse_2bit": (1 << 16, 4, -0.1, 4.0, "rectangle", FFUSE,
                           "staged:four_step+ftail+ffuse+ring"),
    "n16_ch4_ffuse_4bit": (1 << 16, 4, -0.1, 4.0, "rectangle",
                           dict(FFUSE, baseband_input_bits=4),
                           "staged:four_step+ftail+ffuse+ring"),
    "n16_ch4_ffuse_8bit": (1 << 16, 4, -0.1, 4.0, "rectangle",
                           dict(FFUSE, baseband_input_bits=8),
                           "staged:four_step+ftail+ffuse+ring"),
    "n16_ch4_ffuse_hann": (1 << 16, 4, -0.1, 4.0, "hann", FFUSE,
                           "staged:four_step+ftail+ffuse+ring"),
    "n16_ch4_ffuse_skzap": (
        1 << 16, 4, -0.1, 4.0, "rectangle",
        dict(FFUSE, use_pallas=True, use_pallas_sk=True),
        "staged:four_step+ftail+ffuse+skzap+ring"),
    "n16_ch4_ffuse_auto": (1 << 16, 4, -0.1, 4.0, "rectangle",
                           dict(FFUSE, front_fuse="auto"),
                           "staged:four_step+ftail+ring"),
    "n16_ch4_ffuse_auto_opt_in": (
        1 << 16, 4, -0.1, 4.0, "rectangle",
        dict(FFUSE, front_fuse="auto",
             env=dict(ROWS_PALLAS2, SRTB_PALLAS_FFUSE="1")),
        "staged:four_step+ftail+ffuse+ring"),
}
# the multi-stream formats (format, bits) on each plan family (channels,
# overrides, plan), at 2^16 samples a stream with the pulse in stream 0
MULTI_FORMATS = {
    "is2_2bit": ("interleaved_samples_2", 2),
    "is2_8bit": ("interleaved_samples_2", 8),
    "snap1": ("naocpsr_snap1", -8),
    "gznupsr": ("gznupsr_a1", -8),
    "gznupsr_v1": ("gznupsr_a1_v1", -8),
}
MULTI_FAMILIES = {
    # rows of 1024: K3 + K4 once a stream
    "monolithic": (32, {}, "fused:monolithic+ring"),
    "pallas": (4, PALLAS, "fused:pallas+ftail+skzap+ring"),
    "pallas2": (4, PALLAS2, "fused:pallas2+ftail+skzap+ring"),
    # rows of 2^13: B7 over every stream's rows, then K4 once a stream
    "staged": (4, dict(STAGED, fused_tail="off"), "staged:four_step+ring"),
    "staged_b3": (32, STAGED_PLAIN, "staged:four_step+ring"),
    "staged_ftail": (32, STAGED, "staged:four_step+ftail+ring"),
}
for _fmt, (_name, _bits) in MULTI_FORMATS.items():
    for _fam, (_ch, _over, _plan) in MULTI_FAMILIES.items():
        SHAPES[f"{_fmt}_{_fam}"] = (
            1 << 16, _ch, -0.1, 4.0, "rectangle",
            dict(_over, baseband_format_type=_name,
                 baseband_input_bits=_bits), _plan)
for _bits, _window in ((8, "rectangle"), (-8, "rectangle"), (8, "hann")):
    SHAPES[f"is2_{_bits}bit_ffuse_{_window}"] = (
        1 << 16, 4, -0.1, 4.0, _window,
        dict(FFUSE, baseband_format_type="interleaved_samples_2",
             baseband_input_bits=_bits), "staged:four_step+ftail+ffuse+ring")
# shapes whose dedispersed spectrum is compared too (the hann window zaps
# every waterfall row at this size, in both packages)
SPECTRUM = ("n16_ch4_ffuse_hann", "is2_2bit_staged", "snap1_staged_ftail")
# fused-tail shapes whose dedispersed spectrum is held to a float64
# computation of the same function, stream by stream
TRUTH = ("is2_8bit_ffuse_hann", "is2_-8bit_ffuse_rectangle",
         "snap1_staged_ftail", "gznupsr_v1_pallas", "is2_2bit_pallas2")


def _case(name):
    n, ch, dm, amp, window, over, _plan = SHAPES[name]
    over = dict(over)
    staged = over.pop("staged", None)
    env = over.pop("env", {})
    cfg = slice_config(n, ch, dm).replace(**over)
    nres = dd.nsamps_reserved(cfg)
    raw = stream_bytes(cfg, n, (n - 2 * nres) // 2, amp, seed=n)
    return cfg, raw, window, staged, env


CASES = {name: _case(name) for name in SHAPES}


# the lines every 2^30 path of the chip smoke but the shipped one adds,
# with the fused tail
PATH_2_30 = dict(use_pallas=True, use_pallas_sk=True,
                 baseband_reserve_sample=True, fused_tail="on")
# (n, fft_strategy, use_pallas, fused_tail): the plan flags at sizes too
# large to build here, the production 2^30 and 2^27 among them ("shipped":
# the example cfg as shipped, with gui_enable = 0)
RESOLVE = {
    "n30_shipped": None,
    "n27_pallas2": (1 << 27, "pallas2", True, "auto"),
    "n29_pallas2": (1 << 29, "pallas2", True, "auto"),
    "n30_auto": (1 << 30, "auto", True, "auto"),
    "n30_auto_no_pallas": (1 << 30, "auto", False, "auto"),
    "n30_tail_on": (1 << 30, "auto", True, "on"),
    "n27_pallas": (1 << 27, "pallas", True, "auto"),
    "n28_pallas": (1 << 28, "pallas", True, "auto"),
    "n29_pallas": (1 << 29, "pallas", True, "auto"),
    "n29_four_step_bank": (1 << 29, "four_step", False, "auto"),
    "n27_monolithic": (1 << 27, "monolithic", True, "auto"),
    "n27_monolithic_tail_on": (1 << 27, "monolithic", True, "on"),
    "n27_pallas_tail_off": (1 << 27, "pallas", True, "off"),
    # the example cfg with the lines of the chip smoke's 2^30 staged paths
    # (a dict: fields replaced in the shipped cfg), front-fused or not,
    # and the reference's ValueError cases of front_fuse = on (not staged,
    # other rows, no fused tail, an unpack variant B11 does not read, the
    # blocked pack); "auto" with and without the opt-in
    "n30_ffuse": dict(PATH_2_30, front_fuse="on"),
    "n30_staged_pallas2": dict(PATH_2_30, front_fuse="off"),
    "n30_ffuse_auto": dict(PATH_2_30, front_fuse="auto"),
    "n30_ffuse_auto_opt_in": dict(PATH_2_30, front_fuse="auto"),
    "n27_ffuse_not_staged": dict(PATH_2_30, front_fuse="on",
                                 baseband_input_count=1 << 27,
                                 fft_strategy="pallas2"),
    "n30_ffuse_rows_pallas": dict(PATH_2_30, front_fuse="on"),
    "n30_ffuse_tail_off": dict(PATH_2_30, front_fuse="on",
                               fused_tail="off"),
    "n30_ffuse_snap1": dict(PATH_2_30, front_fuse="on",
                            baseband_input_bits=-8,
                            baseband_format_type="naocpsr_snap1"),
    "n30_ffuse_blocked": dict(PATH_2_30, front_fuse="on"),
    # the example cfg as shipped with the fused tail and front fusion
    "n30_shipped_ffuse": dict(fused_tail="on", front_fuse="on"),
}
RESOLVE_ENV = {
    "n30_ffuse": ROWS_PALLAS2, "n30_staged_pallas2": ROWS_PALLAS2,
    "n30_ffuse_auto": ROWS_PALLAS2,
    "n30_ffuse_auto_opt_in": dict(ROWS_PALLAS2, SRTB_PALLAS_FFUSE="1"),
    "n27_ffuse_not_staged": ROWS_PALLAS2,
    "n30_ffuse_rows_pallas": {"SRTB_STAGED_ROWS_IMPL": "pallas"},
    "n30_ffuse_tail_off": ROWS_PALLAS2,
    "n30_ffuse_snap1": ROWS_PALLAS2,
    "n30_ffuse_blocked": dict(ROWS_PALLAS2, SRTB_STAGED_BLOCKED="1"),
    "n30_shipped_ffuse": ROWS_PALLAS2,
}


def _resolve_config(name: str) -> Config:
    if RESOLVE[name] is None or isinstance(RESOLVE[name], dict):
        cfg = Config()
        cfg.load_file(str(EXAMPLE_CFG))
        return cfg.replace(gui_enable=False, **(RESOLVE[name] or {}))
    n, strategy, use_pallas, tail = RESOLVE[name]
    return Config(baseband_input_count=n, fft_strategy=strategy,
                  use_pallas=use_pallas, use_pallas_sk=True, fused_tail=tail)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jobs = [{"key": name, "fn": "test_torch_ref:segment_process",
             "args": [dataclasses.asdict(cfg), raw, window, staged, env,
                      name in SPECTRUM]}
            for name, (cfg, raw, window, staged, env) in CASES.items()]
    jobs += [{"key": f"resolve/{name}", "fn": "test_torch_ref:plan_resolution",
              "args": [dataclasses.asdict(_resolve_config(name)),
                       RESOLVE_ENV.get(name)]}
             for name in RESOLVE]
    cfg = slice_config(1 << 12, 32, 0.0)
    for key, (over, staged, env) in A2_BUILDS.items():
        args = [dataclasses.asdict(cfg.replace(**over)), env, staged]
        jobs += [{"key": f"a2/{key}", "fn": "test_torch_ref:plan_name",
                  "args": args},
                 {"key": f"a2_composed/{key}",
                  "fn": "test_torch_ref:resolved_plan_name", "args": args}]
    return run_reference(jobs, tmp_path_factory.mktemp("ref_segment"))


@pytest.fixture(scope="module")
def port(ref):
    """The port's processor on the reference processor's own config
    fields (``Config.from_reference_fields``) under the same environment,
    so both run one configuration."""
    out = {}
    for name, (cfg, raw, window, staged, env) in CASES.items():
        fields = json.loads(str(ref[f"{name}/fields"]))
        port_cfg = Config.from_reference_fields(fields)
        assert port_cfg == cfg
        with environ(env):
            sp = SegmentProcessor(port_cfg, window_name=window, device="cpu",
                                  staged=staged)
        out[name] = (sp, *sp.process(raw))
    return out


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_and_constants_match(ref, port, name):
    """Both packages take the same plan, the one listed for the shape,
    and the processor's constants are the same: window, de-window, RFI
    mask, normalization, reserved samples, time trim."""
    sp = port[name][0]
    assert str(ref[f"{name}/plan"]) == sp.plan_name == SHAPES[name][6]
    for got, key in ((sp.window, "window"), (sp.watfft_dewindow,
                                             "dewindow")):
        if got is None:
            assert f"{name}/{key}" not in ref
        else:
            np.testing.assert_array_equal(got.numpy(), ref[f"{name}/{key}"])
    assert (sp.window is None) == (SHAPES[name][4] == "rectangle")
    if sp.front_fuse:
        # B12's keep mask, blocked (bin k2 n1 + k1 at [k1, k2])
        zap = ~sp._ffuse_keep.T.reshape(-1)
    else:
        zap = sp.rfi_zap if sp._plain_s1 else ~sp.rfi_keep
    np.testing.assert_array_equal(zap.numpy(), ref[f"{name}/rfi_mask"])
    assert sp.norm_coeff == float(ref[f"{name}/norm_coeff"])
    assert sp.nsamps_reserved == int(ref[f"{name}/nsamps_reserved"]) > 0
    assert sp.time_reserved_count == \
        int(ref[f"{name}/time_reserved_count"])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_decisions_bit_identical(ref, port, name):
    """signal_counts, zero_count and has_signal exactly; the pulse is
    found.  (With the hann window the de-window divides the waterfall's
    row edges by the window's near-zero tails, so every row's SK trips
    and both packages zap all rows: the decisions still match.)"""
    sp, wf, res = port[name]
    np.testing.assert_array_equal(res.signal_counts.numpy(),
                                  ref[f"{name}/detect/signal_counts"])
    np.testing.assert_array_equal(res.zero_count.numpy(),
                                  ref[f"{name}/detect/zero_count"])
    assert res.zero_count.shape == (sp.streams,)
    positive = has_signal(sp.cfg, res, frequency_bin_count=wf.shape[-2])
    assert positive == bool(ref[f"{name}/has_signal"])
    assert positive == (SHAPES[name][4] == "rectangle")
    # per stream: the pulse's stream 0 only
    streams = [has_signal(sp.cfg, res, stream=s,
                          frequency_bin_count=wf.shape[-2])
               for s in range(sp.streams)]
    assert streams == ref[f"{name}/has_signal_streams"].tolist()
    assert streams == [positive] + [False] * (sp.streams - 1)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_waterfall_and_time_series(ref, port, name):
    """Waterfall within 2e-5 of its largest value: the reference's df64
    chirp factor is gated at 2e-5 against the float64 chirp
    (tests/test_dedisperse.py:127), and a waterfall value sums one row's
    bins with unit-modulus weights, so the error stays within that
    fraction of the row's scale (float32 FFT rounding adds ~1e-7; 4e-7 is
    measured).  The time series within the reference's own
    ``time_series_error_gates`` for that waterfall error."""
    sp, wf, res = port[name]
    want_ri = ref[f"{name}/wf_ri"]
    want = want_ri[0] + 1j * want_ri[1]
    got = wf.numpy()
    assert got.shape == want.shape == (sp.streams, sp.channel_count,
                                       sp.watfft_len)
    t = det.trimmed_length(sp.watfft_len, sp.time_reserved_count)
    for s in range(sp.streams):
        wf_err = float(np.abs(got[s] - want[s]).max())
        assert wf_err <= 2e-5 * np.abs(want[s]).max()
        p = np.abs(want[s, :, :t].astype(np.complex128)) ** 2
        gates = det.time_series_error_gates(sp.channel_count, t,
                                            float(p.sum(0).max()), wf_err)
        ts_err = np.abs(res.time_series.numpy()[s]
                        - ref[f"{name}/detect/time_series"][s]).max()
        assert ts_err <= sum(gates)


@pytest.mark.parametrize("name", SPECTRUM)
def test_dedispersed_spectrum_matches_reference(ref, port, name):
    """The dedispersed spectrum (the front-fused plan's B11, Parseval
    mean, B12 and unblock; their plain versions here) against the
    reference's stage (b) output, within 2e-5 of its largest value, the
    waterfall's gate: the chirp dominates the error there as here.  The
    stage-1 zaps (exact zeros) are the same bins."""
    sp = port[name][0]
    got = sp._spectrum(sp._as_device_bytes(CASES[name][1])).numpy()
    want_ri = ref[f"{name}/spectrum"]
    want = want_ri[0] + 1j * want_ri[1]
    assert got.shape == want.shape == (sp.streams, sp.n_spectrum)
    np.testing.assert_array_equal(got == 0, want == 0)
    for s in range(sp.streams):
        assert np.abs(got[s] - want[s]).max() <= 2e-5 * np.abs(want[s]).max()


def float64_spectrum(sp, raw: np.ndarray) -> tuple:
    """The fused tail's dedispersed spectrum [S, n/2] in float64 numpy,
    independent of both packages' FFTs and chirps: every stream unpacked
    (exact), windowed, its R2C without the Nyquist bin, the stage-1 keep
    decision against threshold times its own mean power, the manual mask,
    normalization, and the exact chirp exp(-2 pi i frac(k)), k = D 1e6 dm
    (f - f_c)^2 / (f f_c^2).  Returns (spectrum, the power over the
    threshold, which places each bin against the zap decision, and each
    stream's largest normalized value before stage 1)."""
    from srtb_tpu_torch.pipeline.segment import unpack_streams
    cfg = sp.cfg
    x = unpack_streams(torch.from_numpy(raw), sp.fmt.unpack_variant,
                       cfg.baseband_input_bits, None).numpy()
    x = x.astype(np.float64)
    if sp.window is not None:
        x = x * sp.window.numpy()
    spec = np.fft.rfft(x)[:, :-1]
    m = spec.shape[-1]
    p = np.abs(spec) ** 2
    ratio = p / (cfg.mitigate_rfi_average_method_threshold
                 * p.mean(-1, keepdims=True))
    zap = ratio > 1
    rfi_zap = np.zeros(m, dtype=bool)
    if sp.front_fuse and sp._ffuse_keep is not None:
        rfi_zap = ~sp._ffuse_keep.T.reshape(-1).numpy()
    elif sp.rfi_keep is not None:
        rfi_zap = ~sp.rfi_keep.numpy()
    f_c = cfg.baseband_freq_low + cfg.baseband_bandwidth
    f = cfg.baseband_freq_low + cfg.baseband_bandwidth / m * np.arange(m)
    k = dd.D * 1e6 * cfg.dm * (f - f_c) ** 2 / (f * f_c ** 2)
    chirp = np.exp(-2j * np.pi * (k - np.trunc(k)))
    out = np.where(zap | rfi_zap, 0, spec * sp.norm_coeff) * chirp
    return out, ratio, sp.norm_coeff * np.abs(spec).max(-1)


@pytest.mark.parametrize("name", TRUTH)
def test_spectrum_matches_float64(port, name):
    """The port's dedispersed spectrum against :func:`float64_spectrum`,
    stream by stream: the zaps are the same bins (but for a bin within
    1e-5 relative of its threshold, where two float32 FFTs may round
    either way), the rest within 1e-6 of the stream's largest value
    before stage 1 (float32 rounding grows with the transform's largest
    values: an unsigned stream's DC, which stage 1 zaps, is ~200 times
    its largest kept bin; 2.2e-7 of that value is measured, and against
    the largest kept bin 2e-7 to 5.5e-7, 6.2e-6 for the hann 8-bit
    shape).  At these shapes the JAX
    package's front-fused spectrum lies up to 2.5e-5 of the largest value
    from the same float64 values (its interpret-mode small-leg passes, at
    bins k1 = 0 and n1 - 1 of the blocked order): the reason these shapes
    are held to float64 and not to it."""
    sp = port[name][0]
    got = sp._spectrum(sp._as_device_bytes(CASES[name][1])).numpy()
    want, ratio, scale = float64_spectrum(sp, CASES[name][1])
    assert got.shape == want.shape == (sp.streams, sp.n_spectrum)
    edge = np.abs(ratio - 1) <= 1e-5
    np.testing.assert_array_equal((got == 0)[~edge], (want == 0)[~edge])
    for s in range(sp.streams):
        diff = np.where(edge[s], 0, np.abs(got[s] - want[s]))
        assert diff.max() <= 1e-6 * scale[s]


def chip_path_config(label: str) -> tuple:
    """The config of a ``chip_smoke.py`` main path (the example cfg and
    the path's lines, as the script writes them) and its table row."""
    row = {r[0]: r for r in _chip_smoke().MAIN_PATHS}[label]
    cfg = Config()
    cfg.load_file(str(EXAMPLE_CFG))
    # the path's lines, parsed as the cfg file's own
    for line in row[2].splitlines():
        key, value = (part.strip() for part in line.split("=", 1))
        assert cfg.set_option(key, value), key
    return cfg.replace(gui_enable=False), row


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports only the
    standard library)."""
    import importlib
    import sys
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return importlib.import_module("chip_smoke")


def _chip_labels() -> list:
    return [r[0] for r in _chip_smoke().MAIN_PATHS]


@pytest.fixture(scope="module")
def chip_plans(tmp_path_factory):
    jobs = []
    for label in _chip_labels():
        cfg, row = chip_path_config(label)
        jobs.append({"key": label, "fn": "test_torch_ref:resolved_plan_name",
                     "args": [dataclasses.asdict(cfg), row[5]]})
    return run_reference(jobs, tmp_path_factory.mktemp("ref_chip_plans"))


@pytest.mark.parametrize("label", _chip_labels())
def test_chip_smoke_paths_take_the_references_plan(chip_plans, label):
    """Every main path of ``chip_smoke.py`` names the plan the reference
    resolves for its config and environment (the script fails on the
    card unless the port's processor takes that plan), the multi-stream
    paths with the reference's stream count, and the port resolves the
    same staged, fused-tail and front-fuse flags and ring."""
    cfg, row = chip_path_config(label)
    assert row[3] == str(chip_plans[f"{label}/plan"])
    assert formats.get_data_stream_count(cfg.baseband_format_type) == \
        int(chip_plans[f"{label}/streams"])
    staged = seg.staged_resolves(cfg)
    with environ(row[5]):
        flags = (("+ftail" in row[3]) == seg.fused_tail_resolves(cfg, staged),
                 ("+ffuse" in row[3]) == seg.front_fuse_resolves(cfg, staged))
    assert flags == (True, True)
    assert row[3].startswith("staged" if staged else "fused")
    assert ("+ring" in row[3]) == seg.ring_usable(cfg)


@pytest.mark.parametrize("name", sorted(RESOLVE))
def test_plan_resolution_matches_reference(ref, name):
    """staged_resolves, resolve_strategy, fused_tail_resolves and
    front_fuse_resolves give the reference's answers under the same
    environment (a ValueError where the reference raises one)."""
    cfg = _resolve_config(name)
    staged = seg.staged_resolves(cfg)
    assert staged == bool(ref[f"resolve/{name}/staged"])
    with environ(RESOLVE_ENV.get(name, {})):
        for key, resolve in (("fused_tail", seg.fused_tail_resolves),
                             ("front_fuse", seg.front_fuse_resolves)):
            try:
                got = str(resolve(cfg, staged))
            except ValueError:
                got = "ValueError"
            assert got == str(ref[f"resolve/{name}/{key}"]), key
    assert F.resolve_strategy(cfg.baseband_input_count, cfg.fft_strategy) \
        == str(ref[f"resolve/{name}/strategy"])


# the settings the port refused before the multi-stream formats (ROADMAP
# A2), now built and held to the reference's plan: (overrides, staged,
# environment)
A2_BUILDS = {
    "gznupsr": ({"baseband_format_type": "gznupsr_a1",
                 "baseband_input_bits": -8}, None, {}),
    "is2_ffuse": ({"baseband_format_type": "interleaved_samples_2",
                   "baseband_input_bits": 8, "front_fuse": "on"}, True,
                  ROWS_PALLAS2),
}


def test_unported_settings_raise(ref):
    cfg = slice_config(1 << 12, 32, 0.0)
    # the periodicity mode builds now (ROADMAP A5; tests/test_torch_
    # periodicity.py holds it to the reference), and an unregistered mode
    # raises as the reference's registry does
    assert SegmentProcessor(cfg.replace(search_mode="periodicity"),
                            device="cpu").plan_name == \
        SegmentProcessor(cfg, device="cpu").plan_name
    with pytest.raises(ValueError, match="unknown search_mode"):
        SegmentProcessor(cfg.replace(search_mode="acceleration"),
                         device="cpu")
    # the micro-batch builds now (ROADMAP A3; tests/test_torch_batch.py
    # holds its lanes to the reference's)
    sp = SegmentProcessor(cfg.replace(micro_batch_segments=2), device="cpu")
    assert sp.plan_name == SegmentProcessor(cfg, device="cpu").plan_name
    # the quality epilogue builds now, at the reference's defaults
    # (tests/test_torch_quality.py holds its vectors)
    assert SegmentProcessor(cfg.replace(quality_stats=True),
                            device="cpu").quality_params == (64, 0.1, 10.0, 8)
    # the ingest ring: "on" builds the ring plan, "off" leaves it out,
    # and "on" without a reserved tail raises as in the reference
    rcfg = CASES["n16_ch32"][0]
    ring = SegmentProcessor(rcfg.replace(ingest_ring="on"), device="cpu")
    assert ring.ring and ring.plan_name == "fused:monolithic+ring"
    assert ring.stride_bytes + ring.reserved_bytes == rcfg.segment_bytes()
    assert SegmentProcessor(rcfg.replace(ingest_ring="off"),
                            device="cpu").plan_name == "fused:monolithic"
    with pytest.raises(ValueError, match="ingest_ring=on"):
        SegmentProcessor(rcfg.replace(ingest_ring="on",
                                      baseband_reserve_sample=False),
                         device="cpu")
    # the multi-stream formats build (no NotImplementedError any more)
    # and resolve the reference's plan
    for key, (over, staged, env) in A2_BUILDS.items():
        with environ(env):
            sp = SegmentProcessor(cfg.replace(**over), device="cpu",
                                  staged=staged)
        assert sp.streams == 2
        assert sp.plan_name == str(ref[f"a2/{key}/plan"])
        # the composition the chip paths' test reads, against the
        # reference processor's own name
        assert str(ref[f"a2_composed/{key}/plan"]) == sp.plan_name
    with environ(ROWS_PALLAS2):
        # front_fuse = on off the staged plan raises, as in the reference
        with pytest.raises(ValueError, match="front_fuse=on"):
            SegmentProcessor(cfg.replace(front_fuse="on"), device="cpu")
    with pytest.raises(ValueError, match="unknown rows impl"):
        with environ({"SRTB_STAGED_ROWS_IMPL": "cufft"}):
            SegmentProcessor(cfg, device="cpu", staged=True)
    with pytest.raises(ValueError):
        SegmentProcessor(cfg.replace(fused_tail="on"), device="cpu")


def test_shipped_config_takes_the_b3_plan():
    """The example cfg as shipped (2^30, use_pallas = 0) passes the plan
    check and resolves to the staged plan whose stage 1 is the plain one
    followed by B3; every other plan keeps K2."""
    shipped = _resolve_config("n30_shipped")
    seg.check_plan(shipped)
    assert not shipped.use_pallas and not shipped.use_pallas_sk
    small = shipped.replace(baseband_input_count=1 << 16, fused_tail="off")
    sp = SegmentProcessor(small, device="cpu", staged=True)
    # fft_strategy "auto" names the staged plan by the size: four_step at
    # 2^30, monolithic at 2^16
    assert sp.plan_name == "staged:monolithic" and sp._plain_s1
    assert sp.rfi_zap is not None and sp.rfi_keep is None
    assert not SegmentProcessor(small.replace(use_pallas=True), device="cpu",
                                staged=True)._plain_s1
    assert not SegmentProcessor(small, device="cpu")._plain_s1


def test_device_defaults_to_cuda():
    """No device means the card; without one that raises instead of
    quietly running on the CPU."""
    cfg = slice_config(1 << 12, 32, 0.0)
    if torch.cuda.is_available():
        assert SegmentProcessor(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SegmentProcessor(cfg)
