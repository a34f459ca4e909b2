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
then plain SK or K3 + K4).  Both packages run one configuration; the
reference runs its Pallas kernels in interpret mode."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import synth
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
# shapes whose dedispersed spectrum is compared too (the hann window zaps
# every waterfall row at this size, in both packages)
SPECTRUM = ("n16_ch4_ffuse_hann",)


def _case(name):
    n, ch, dm, amp, window, over, _plan = SHAPES[name]
    over = dict(over)
    staged = over.pop("staged", None)
    env = over.pop("env", {})
    cfg = slice_config(n, ch, dm).replace(**over)
    nres = dd.nsamps_reserved(cfg)
    raw = dispersed_bytes(cfg, n, (n - 2 * nres) // 2, amp, seed=n)
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
    positive = has_signal(sp.cfg, res, frequency_bin_count=wf.shape[-2])
    assert positive == bool(ref[f"{name}/has_signal"])
    assert positive == (SHAPES[name][4] == "rectangle")


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
    assert got.shape == want.shape == (1, sp.channel_count, sp.watfft_len)
    wf_err = float(np.abs(got - want).max())
    assert wf_err <= 2e-5 * np.abs(want).max()
    t = det.trimmed_length(sp.watfft_len, sp.time_reserved_count)
    p = np.abs(want[0, :, :t].astype(np.complex128)) ** 2
    gates = det.time_series_error_gates(sp.channel_count, t,
                                        float(p.sum(0).max()), wf_err)
    ts_err = np.abs(res.time_series.numpy()
                    - ref[f"{name}/detect/time_series"]).max()
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
    want = want_ri[0, 0] + 1j * want_ri[1, 0]
    assert got.shape == want.shape == (sp.n_spectrum,)
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


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


def test_unported_settings_raise():
    cfg = slice_config(1 << 12, 32, 0.0)
    for change in ({"quality_stats": True}, {"search_mode": "periodicity"},
                   {"micro_batch_segments": 2}):
        with pytest.raises(NotImplementedError):
            SegmentProcessor(cfg.replace(**change), device="cpu")
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
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        SegmentProcessor(cfg.replace(baseband_format_type="gznupsr_a1"),
                         device="cpu")
    with environ(ROWS_PALLAS2):
        # B11 reads the 2-pol interleave; the processor is single-stream
        with pytest.raises(NotImplementedError, match="ROADMAP A2"):
            SegmentProcessor(cfg.replace(
                baseband_format_type="interleaved_samples_2",
                baseband_input_bits=8, front_fuse="on"), device="cpu",
                staged=True)
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
