"""The port's kernels.  On the CPU each wrapper runs its plain PyTorch
version, held here (K1-K4, B3), in ``test_torch_fft_rows.py`` (B6, B7, B8,
B13), in ``test_torch_fft2.py`` (B9, B10) and in
``test_torch_fft2_front.py`` (B11, B12) against the JAX package's Pallas
kernel in interpret mode on the same inputs; the tests marked
``cuda`` hold each CUDA kernel against its plain version on the card and
skip without one."""

import numpy as np
import pytest
import torch

from srtb_tpu_torch import kernels as K
from srtb_tpu_torch.kernels import dedisperse as KD
from srtb_tpu_torch.kernels import fft2 as K2
from srtb_tpu_torch.kernels import fft2_front as FF
from srtb_tpu_torch.kernels import fft_rows as KF
from srtb_tpu_torch.kernels import rfi_chirp as KR
from srtb_tpu_torch.kernels import sk as KS
from srtb_tpu_torch.kernels import unpack as KU
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.ops import rfi
from srtb_tpu_torch.ops import window as W
from test_torch_ref import run_reference

RNG = np.random.default_rng(1644)
BYTES = RNG.integers(0, 256, 1 << 14, dtype=np.uint8)
N_SPEC = 1 << 15
SPEC = (RNG.standard_normal(N_SPEC)
        + 1j * RNG.standard_normal(N_SPEC)).astype(np.complex64)
SPEC[::997] *= 4.0  # bins above the stage-1 threshold
ZAP_MASK = np.zeros(N_SPEC, dtype=bool)
ZAP_MASK[1000:1700] = True
# J1644-4559 geometry (example cfg) over 2^15 channels: |k| ~ 3e6 turns
CHIRP = dict(f_min=1437.0, df=-64.0 / N_SPEC, f_c=1373.0, dm=-478.80)
NORM = rfi.normalization_coefficient(N_SPEC, 32)
S1_THR = 3.0
SK_THR = 1.5
F_ROWS, T_LEN = 32, 1024


def _planted_waterfall() -> np.ndarray:
    """[32, 1024] noise with planted rows: NaN, Inf, zero first sample,
    impulsive (SK high), constant modulus (SK low)."""
    wf = (RNG.standard_normal((F_ROWS, T_LEN))
          + 1j * RNG.standard_normal((F_ROWS, T_LEN))).astype(np.complex64)
    wf[2, 100] = np.nan
    wf[4, 7] = np.inf
    wf[6, 0] = 0
    wf[8, ::64] *= 30.0
    wf[10] = np.exp(1j * RNG.uniform(0, 6, T_LEN)).astype(np.complex64)
    return wf


WF = _planted_waterfall()
ZAP_APPLY = np.zeros(F_ROWS, dtype=bool)
ZAP_APPLY[[2, 8, 10, 20]] = True  # includes the NaN row: select -> 0
UNPACK_CASES = [(b, w) for b in (1, 2, 4) for w in (False, True)]
RFI_CASES = [(m, e) for m in (False, True) for e in (False, True)]
# B3's inputs: (spectrum, chirp geometry, i0) — the J1644-4559 chirp over
# 2^15 channels; the reference's high-DM case (a unit spectrum, 2^12
# channels over the whole band, tests/test_pallas_kernels.py:51-66); and
# 2^12 channels at i0 = 2^26 + 1024 of a 2^27-channel spectrum, past
# float32's exact integers (tests/test_pallas_kernels.py:178-192)
B3_INPUTS = {
    "j1644": (SPEC, CHIRP, 0),
    "high_dm": (np.ones(1 << 12, np.complex64),
                dict(CHIRP, df=-64.0 / (1 << 12)), 0),
    "offset": (SPEC[: 1 << 12], dict(CHIRP, df=-64.0 / (1 << 27)),
               (1 << 26) + 1024),
}
B3_CASES = [(k, e) for k in B3_INPUTS for e in (False, True)]


def _ri(c: np.ndarray) -> np.ndarray:
    return np.stack([c.real, c.imag]).astype(np.float32)


def _window(nbits):
    return RNG.uniform(0.5, 1.5, BYTES.size * 8 // nbits).astype(np.float32)


WINDOWS = {b: _window(b) for b in (1, 2, 4)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pk = "srtb_tpu.ops.pallas_kernels:"
    jobs = [{"key": f"unpack/{b}/{w}", "fn": pk + "unpack_subbyte_window",
             "args": [BYTES, b, WINDOWS[b] if w else None],
             "kwargs": {"interpret": True}} for b, w in UNPACK_CASES]
    jobs += [{"key": f"rfi/{m}/{e}", "fn": pk + "rfi_s1_dedisperse_df64",
              "args": [_ri(SPEC), S1_THR, NORM, CHIRP["f_min"], CHIRP["df"],
                       CHIRP["f_c"], CHIRP["dm"]],
              "kwargs": {"mask": ZAP_MASK if m else None, "interpret": True,
                         "exact": e}} for m, e in RFI_CASES]
    jobs += [{"key": f"b3/{k}/{e}", "fn": pk + "dedisperse_df64",
              "args": [_ri(B3_INPUTS[k][0]), B3_INPUTS[k][1]["f_min"],
                       B3_INPUTS[k][1]["df"], B3_INPUTS[k][1]["f_c"],
                       B3_INPUTS[k][1]["dm"]],
              "kwargs": {"interpret": True, "i0": B3_INPUTS[k][2],
                         "exact": e}} for k, e in B3_CASES]
    jobs += [
        {"key": "skzap", "fn": pk + "sk_zap_timeseries",
         "args": [_ri(WF), SK_THR], "kwargs": {"interpret": True}},
        {"key": "skapply", "fn": pk + "sk_apply_timeseries",
         "args": [_ri(WF), ZAP_APPLY], "kwargs": {"interpret": True}},
    ]
    return run_reference(jobs, tmp_path_factory.mktemp("ref_kernels"))


@pytest.mark.parametrize("nbits,win", UNPACK_CASES)
def test_unpack_plain_matches_pallas(ref, nbits, win):
    """K1, exact: the same integer fields and one float32 multiply."""
    w = torch.from_numpy(WINDOWS[nbits]) if win else None
    got = KU.unpack_subbyte_window(torch.from_numpy(BYTES), nbits, w)
    np.testing.assert_array_equal(got.numpy(), ref[f"unpack/{nbits}/{win}"])


@pytest.mark.parametrize("masked,exact", RFI_CASES)
def test_rfi_chirp_plain_matches_pallas(ref, masked, exact):
    """K2: the same zapped bins exactly, and the chirped output to 5e-5 of
    the largest — the reference's own anchored-vs-exact gate
    (tests/test_dedisperse.py:149): its df64 phase is good to ~1e-5 turns
    at |k| ~ 3e6, the port's float64 phase to ~1e-9."""
    keep = torch.from_numpy(~ZAP_MASK) if masked else None
    spec = torch.from_numpy(SPEC)
    got = KR.rfi_s1_dedisperse(spec, KR.rfi_threshold(spec, S1_THR), NORM,
                               CHIRP["f_min"], CHIRP["df"], CHIRP["f_c"],
                               CHIRP["dm"], keep=keep).numpy()
    want_ri = ref[f"rfi/{masked}/{exact}"]
    want = want_ri[0] + 1j * want_ri[1]
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (got == 0).sum() > (1700 - 1000 if masked else 0)
    assert np.abs(got - want).max() <= 5e-5 * np.abs(want).max()


@pytest.mark.parametrize("case,exact", B3_CASES)
def test_dedisperse_plain_matches_pallas(ref, case, exact):
    """B3 against ``dedisperse_df64`` in both of the reference's phase
    modes (anchored-Taylor and exact df64): to 5e-5 of the largest, K2's
    chirp gate; the port's phase is exact float64 in both, and within
    1e-6 of the float64 numpy chirp of the same channels."""
    spec, geo, i0 = B3_INPUTS[case]
    got = KD.dedisperse(torch.from_numpy(spec), geo["f_min"], geo["df"],
                        geo["f_c"], geo["dm"], i0=i0).numpy()
    want_ri = ref[f"b3/{case}/{exact}"]
    want = want_ri[0] + 1j * want_ri[1]
    assert got.shape == want.shape == spec.shape
    assert np.abs(got - want).max() <= 5e-5 * np.abs(want).max()
    i = np.arange(i0, i0 + spec.size, dtype=np.float64)
    f = geo["f_min"] + geo["df"] * i
    k = (dd.D * 1e6) * geo["dm"] / f * ((f - geo["f_c"]) / geo["f_c"]) ** 2
    exact64 = spec * np.exp(-2j * np.pi * np.modf(k)[0])
    assert np.abs(got - exact64).max() <= 1e-6 * np.abs(exact64).max()


def _margins_ok(s2: torch.Tensor, s4: torch.Tensor) -> None:
    """No finite row's SK lies within 1e-5 relative of a threshold, so a
    differing verdict would be a bug, not rounding."""
    sk = (T_LEN * s4.double() / (s2.double() ** 2)).numpy()
    lo, hi = rfi.sk_decision_thresholds(T_LEN, SK_THR)
    fin = np.isfinite(sk)
    for thr in (lo, hi):
        assert (np.abs(sk[fin] - thr) > 1e-5 * thr).all()


def test_sk_zap_timeseries_plain_matches_pallas(ref):
    """K3 + verdict + K4: zapped rows and zero_count bit-identical; the
    zapped waterfall bit-identical (NaN/Inf rows pass through or become
    0 exactly as the reference's select does); the time series within
    the reference's float32 summation gate (the port sums in float64)."""
    wf = torch.from_numpy(WF)
    s2, s4, fs0 = KS.sk_stats(wf)
    _margins_ok(s2, s4)
    out, zero_count, ts = KS.sk_zap_timeseries(wf, SK_THR)
    want_out = ref["skzap/0"][0] + 1j * ref["skzap/0"][1]
    np.testing.assert_array_equal(out.numpy(), want_out)
    assert int(zero_count) == int(ref["skzap/1"])
    zapped = ~np.any(out.numpy() != 0, axis=1)
    assert zapped[8] and zapped[10] and not zapped[2] and not zapped[4]
    assert fs0[6] == 0 and int(zero_count) == zapped.sum() + 1
    _check_ts(ts.numpy(), ref["skzap/2"], out.numpy())


def test_sk_apply_plain_matches_pallas(ref):
    """K4 with a given verdict that zaps the NaN row: that row becomes 0
    (select, not multiply); the rest as above."""
    out, ts = KS.sk_apply_timeseries(torch.from_numpy(WF),
                                     torch.from_numpy(ZAP_APPLY))
    want_out = ref["skapply/0"][0] + 1j * ref["skapply/0"][1]
    np.testing.assert_array_equal(out.numpy(), want_out)
    assert not out[2].abs().max() and torch.isinf(out[4, 7].real)
    _check_ts(ts.numpy(), ref["skapply/1"], out.numpy())


def _check_ts(got, want, out):
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    p = np.abs(out.astype(np.complex128)) ** 2
    ts_max = float(np.nanmax(np.where(np.isfinite(p), p, 0).sum(0)))
    gate, _ = det.time_series_error_gates(F_ROWS, T_LEN, ts_max, 0.0)
    assert np.abs(got[fin] - want[fin]).max() <= gate


def test_kernel_registry_and_counters():
    """Every kernel is listed with its source and TPU origin; CPU calls
    run the plain versions and launch nothing."""
    K.reset_launch_counts()
    KU.unpack_subbyte_window(torch.from_numpy(BYTES), 2)
    KD.dedisperse(torch.from_numpy(SPEC), **CHIRP)
    assert set(K.launch_counts()) == {"unpack_subbyte_window",
                                      "rfi_s1_dedisperse", "sk_stats",
                                      "sk_apply_timeseries",
                                      "unpack_subbyte_planes_window",
                                      "fft_rows", "fft_rows_stats",
                                      "fft_rows_skzap", "dedisperse",
                                      "fft2_pass1", "fft2_pass2",
                                      "fft2_pass1_front",
                                      "fft2_pass2_spectrum"}
    assert not any(K.launch_counts().values())
    for _name, _wrapper, src, tpu in K.KERNELS:
        assert src.startswith("srtb_tpu_torch/csrc/") and src.endswith(".cu")
        assert tpu.startswith(("srtb_tpu/ops/pallas_kernels.py:",
                               "srtb_tpu/ops/pallas_fft.py:",
                               "srtb_tpu/ops/pallas_fft2.py:"))


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        KU.unpack_subbyte_window(torch.from_numpy(BYTES), 8)
    with pytest.raises(ValueError):
        KR.rfi_s1_dedisperse(torch.from_numpy(SPEC).real,
                             torch.ones(1), 1.0, 1.0, 1.0, 1.0, 0.0)
    with pytest.raises(ValueError):
        KR.rfi_s1_dedisperse(torch.from_numpy(SPEC), torch.ones(()), 1.0,
                             1.0, 1.0, 1.0, 0.0)
    with pytest.raises(ValueError):
        KS.sk_apply_timeseries(torch.from_numpy(WF),
                               torch.zeros(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        KD.dedisperse(torch.from_numpy(SPEC).reshape(2, -1), **CHIRP)
    with pytest.raises(ValueError):
        KD.dedisperse(torch.from_numpy(SPEC), **CHIRP, i0=-1)


def test_wrappers_write_into_out_and_check_it():
    """The per-stream wrappers write their result into ``out`` (a row of
    the caller's [S, ...] tensor) and return it, bit for bit the result
    without ``out``; an ``out`` of the wrong dtype or shape raises."""
    spec = torch.from_numpy(SPEC)
    rows = torch.empty(2, N_SPEC, dtype=torch.complex64)
    thr = KR.rfi_threshold(spec, S1_THR)
    args = (thr, NORM, CHIRP["f_min"], CHIRP["df"], CHIRP["f_c"],
            CHIRP["dm"])
    for call in (lambda out: KR.rfi_s1_dedisperse(spec, *args, out=out),
                 lambda out: KD.dedisperse(spec, **CHIRP, out=out)):
        got = call(rows[1])
        assert got.data_ptr() == rows[1].data_ptr()
        assert torch.equal(rows[1], call(None))
        for bad in (rows[1, 1:], rows[1].real.contiguous()):
            with pytest.raises(ValueError, match="out must be"):
                call(bad)
    data = torch.from_numpy(BYTES)
    samples = torch.empty(2, 4 * BYTES.size)
    KU.unpack_subbyte_window(data, 2, out=samples[0])
    assert torch.equal(samples[0], KU.unpack_subbyte_window(data, 2))
    with pytest.raises(ValueError, match="out must be"):
        KU.unpack_subbyte_window(data, 4, out=samples[0])
    wf = torch.from_numpy(WF)
    zap = torch.from_numpy(ZAP_APPLY)
    zapped = torch.empty(2, *WF.shape, dtype=torch.complex64)
    _, ts = KS.sk_apply_timeseries(wf, zap, out=zapped[1])
    want, want_ts = KS.sk_apply_timeseries(wf, zap)
    assert torch.equal(zapped[1], want) and torch.equal(ts, want_ts)
    with pytest.raises(ValueError, match="out must be"):
        KS.sk_apply_timeseries(wf, zap, out=zapped[1, 1:])


# ------------------------------------------------ on the card (CUDA only)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_cuda_unpack_matches_plain(cuda, nbits):
    data = torch.from_numpy(BYTES).to(cuda)
    win = torch.from_numpy(WINDOWS[nbits]).to(cuda)
    before = KU.unpack_subbyte_window.launches
    for w in (None, win):
        assert torch.equal(KU.unpack_subbyte_window(data, nbits, w),
                           KU.unpack_subbyte_window_plain(data, nbits, w))
    assert KU.unpack_subbyte_window.launches == before + 2


@pytest.mark.cuda
def test_cuda_rfi_chirp_matches_plain(cuda):
    spec = torch.from_numpy(SPEC).to(cuda)
    keep = torch.from_numpy(~ZAP_MASK).to(cuda)
    args = (NORM, CHIRP["f_min"], CHIRP["df"], CHIRP["f_c"], CHIRP["dm"])
    thr = KR.rfi_threshold(spec, S1_THR)
    got = KR.rfi_s1_dedisperse(spec, thr, *args, keep=keep)
    want = KR.rfi_s1_dedisperse_plain(spec, thr, *args, keep=keep)
    assert torch.equal(got == 0, want == 0)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.cuda
def test_cuda_sk_matches_plain(cuda):
    wf = torch.from_numpy(WF).to(cuda)
    zap = torch.from_numpy(ZAP_APPLY).to(cuda)
    for a, b in zip(KS.sk_stats(wf), KS.sk_stats_plain(wf)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0, equal_nan=True)
    for a, b in zip(KS.sk_apply_timeseries(wf, zap),
                    KS.sk_apply_timeseries_plain(wf, zap)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0, equal_nan=True)


# B13, B6, B7, B8 on the card, against the plain versions that
# test_torch_fft_rows.py holds against the reference
PLANE_BYTES = RNG.integers(0, 256, 1 << 13, dtype=np.uint8)
PLANE_WINDOWS = {b: RNG.uniform(0.5, 1.5, (8 // b, PLANE_BYTES.size))
                 .astype(np.float32) for b in (1, 2, 4)}


def _max_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    return float((a - b).abs().max()), float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("log2", [12, 13, 14, 15, 16])
def test_cuda_fft_rows_matches_plain(cuda, log2):
    """B6 at every row length (one CTA, clusters of 2, 4 and 8): 1e-5 of
    the largest value, both directions."""
    g = torch.Generator(device=cuda).manual_seed(log2)
    x = torch.randn(5, 1 << log2, dtype=torch.complex64, device=cuda,
                    generator=g)
    for inverse in (False, True):
        err, scale = _max_err(KF.fft_rows(x, inverse),
                              KF.fft_rows_plain(x, inverse))
        assert err <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 133, 1000])
@pytest.mark.parametrize("log2", [12, 13, 14, 15, 16])
def test_cuda_row_fft_core_batches(cuda, log2, batch):
    """B6's core at one row, a few rows and more rows (or clusters) than
    the card holds at once: 1e-5 of the largest value, both directions,
    one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(batch + log2)
    x = torch.randn(batch, 1 << log2, dtype=torch.complex64, device=cuda,
                    generator=g)
    before = KF.fft_rows.launches
    for inverse in (False, True):
        err, scale = _max_err(KF.fft_rows(x, inverse),
                              KF.fft_rows_plain(x, inverse))
        assert err <= 1e-5 * scale
    assert KF.fft_rows.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("log2", [12, 13, 14, 15, 16])
def test_cuda_row_fft_core_unaligned_view_is_copied(cuda, log2):
    """A view whose storage offset leaves it 8-byte aligned (TMA reads
    need 16) is copied by the wrapper, not refused; B6 and B10 alike."""
    n = 1 << log2
    g = torch.Generator(device=cuda).manual_seed(log2)
    base = torch.randn(4096 * n + 1, dtype=torch.complex64, device=cuda,
                       generator=g)
    rows = base[1:].reshape(4096, n)
    assert rows.data_ptr() % 16 == 8
    err, scale = _max_err(KF.fft_rows(rows[:3]),
                          KF.fft_rows_plain(rows[:3]))
    assert err <= 1e-5 * scale
    err, scale = _max_err(K2.fft2_pass2(rows[None], True),
                          K2.fft2_pass2_plain(rows[None], True))
    assert err <= 2e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("log2", [12, 13, 14, 15, 16])
def test_cuda_fft2_pass2_every_row_length(cuda, log2):
    """B10 on one [4096, 2^log2] block, both directions: 2e-5 of the
    largest |plain| (the reference's two-pass gate)."""
    g = torch.Generator(device=cuda).manual_seed(200 + log2)
    x = torch.randn(1, 4096, 1 << log2, dtype=torch.complex64, device=cuda,
                    generator=g)
    for inverse in (False, True):
        err, scale = _max_err(K2.fft2_pass2(x, inverse),
                              K2.fft2_pass2_plain(x, inverse))
        assert err <= 2e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("log2", [12, 13, 14, 15, 16])
def test_cuda_fft_rows_stats_and_skzap_match_plain(cuda, log2):
    """B7 with a hann de-window and B8 without, on noise rows with a
    planted impulsive row: values to 1e-5 of the largest; B7's sums to
    1e-5 relative (the de-window's near-zero edges amplify single values'
    rounding), B8's time series to 1e-6; verdicts identical."""
    n = 1 << log2
    g = torch.Generator(device=cuda).manual_seed(100 + log2)
    x = torch.randn(9, n, dtype=torch.complex64, device=cuda, generator=g)
    x[2] = torch.fft.fft(torch.where(torch.arange(n, device=cuda) % 64 == 0,
                                     30.0, 1.0) * torch.fft.ifft(x[2]))
    dw = torch.from_numpy(W.dewindow_coefficients("hann", n)).to(cuda)
    for a, b in zip(KF.fft_rows_stats(x, True, dw),
                    KF.fft_rows_stats_plain(x, True, dw)):
        torch.testing.assert_close(a, b, rtol=1e-5 if a.dim() == 1 else 0,
                                   atol=0 if a.dim() == 1
                                   else 1e-5 * float(b.abs().max()))
    got = KF.fft_rows_skzap(x, SK_THR)
    want = KF.fft_rows_skzap_plain(x, SK_THR)
    assert torch.equal(got[1], want[1]) and bool(got[1][2])
    err, scale = _max_err(got[0], want[0])
    assert err <= 1e-5 * scale
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("log2", [12, 13, 14, 15, 16])
def test_cuda_fft_rows_stats_unaligned_view_is_copied(cuda, log2):
    """A view whose storage offset leaves it 8-byte aligned (TMA reads
    need 16) is copied by B7's wrapper, not refused; held at the gates of
    test_cuda_fft_rows_stats_and_skzap_match_plain (values to 1e-5 of the
    largest, sums to 1e-5 relative with the hann de-window).  An all-zero
    row stays exactly 0, its sums too: the unfused plan's zero count reads
    B7's first output."""
    n = 1 << log2
    g = torch.Generator(device=cuda).manual_seed(300 + log2)
    base = torch.randn(5 * n + 1, dtype=torch.complex64, device=cuda,
                       generator=g)
    view = base[1:].reshape(5, n)
    view[3] = 0
    assert view.data_ptr() % 16 == 8
    dw = torch.from_numpy(W.dewindow_coefficients("hann", n)).to(cuda)
    for d in (None, dw):
        got = KF.fft_rows_stats(view, True, d)
        want = KF.fft_rows_stats_plain(view, True, d)
        err, scale = _max_err(got[0], want[0])
        assert err <= 1e-5 * scale
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
        assert not bool(got[0][3].any())
        assert float(got[1][3]) == 0.0 and float(got[2][3]) == 0.0


@pytest.mark.cuda
def test_cuda_fft_rows_stats_geometry(cuda):
    """B7's launch geometry: one row a CTA at 2^12 and 2^13, a cluster of
    2, 4, 8 CTAs of 2^13 values at 2^14 ... 2^16, 256 threads and two
    CTAs an SM, the card holding some of them at once, and the compiler's
    local (spilled) bytes reported."""
    for log2, ctas in zip(range(12, 17), (1, 1, 2, 4, 8)):
        geo = KF.stats_geometry(1 << log2, cuda)
        assert set(geo) == set(KF.GEOMETRY_FIELDS)
        assert geo["ctas_a_cluster"] == ctas
        assert geo["values_a_cta"] == min(1 << log2, 1 << 13)
        assert geo["threads"] == 256 and geo["ctas_an_sm"] == 2
        assert geo["resident"] > 0 and geo["local_bytes"] >= 0
        assert geo["registers"] <= 128


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_cuda_unpack_planes_matches_plain(cuda, nbits):
    data = torch.from_numpy(PLANE_BYTES).to(cuda)
    win = torch.from_numpy(PLANE_WINDOWS[nbits]).to(cuda)
    for w in (None, win):
        assert torch.equal(KU.unpack_subbyte_planes_window(data, nbits, w),
                           KU.unpack_subbyte_planes_window_plain(data, nbits,
                                                                 w))


@pytest.mark.cuda
def test_cuda_dedisperse_matches_plain(cuda):
    """B3 at i0 = 0 and past float32's exact integers: 1e-6 of the largest
    (sincospif against float64 trig of the same float32 argument), the
    same phase code as K2."""
    for spec, geo, i0 in B3_INPUTS.values():
        x = torch.from_numpy(spec).to(cuda)
        args = (geo["f_min"], geo["df"], geo["f_c"], geo["dm"])
        err, scale = _max_err(KD.dedisperse(x, *args, i0=i0),
                              KD.dedisperse_plain(x, *args, i0=i0))
        assert err <= 1e-6 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(4096, 4096), (4096, 1 << 15),
                                   (8192, 4096)])
def test_cuda_fft2_passes_match_plain(cuda, n1, n2):
    """B9 and B10 on two planes, both directions: 2e-5 of the largest
    |plain|, the reference's own gate (tests/test_pallas_fft2.py:48)."""
    g = torch.Generator(device=cuda).manual_seed(n1 + n2)
    x = torch.randn(2, n1, n2, dtype=torch.complex64, device=cuda,
                    generator=g)
    for inverse in (False, True):
        for kernel, plain in ((K2.fft2_pass1, K2.fft2_pass1_plain),
                              (K2.fft2_pass2, K2.fft2_pass2_plain)):
            err, scale = _max_err(kernel(x, inverse), plain(x, inverse))
            assert err <= 2e-5 * scale
    got = K2.fft2_c2c(x.reshape(2, -1))
    err, scale = _max_err(got, torch.fft.fft(x.reshape(2, -1)))
    assert err <= 2e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("planes,n1,n2", [(1, 8192, 1 << 16),
                                         (1, 4096, 4096), (1, 8192, 4096),
                                         (3, 4096, 1 << 13),
                                         (3, 8192, 4096)])
def test_cuda_fft2_pass1_column_body(cuda, planes, n1, n2):
    """B9's clustered column body (clusters of n1 / 1024 CTAs, 8 columns
    each) at the 2^30 segment's [8192, 65536], at n2 = 4096 (the fewest
    clusters) at both n1, and on three planes: both directions within 2e-5
    of the largest |plain| (tests/test_pallas_fft2.py:48), one launch a
    call."""
    g = torch.Generator(device=cuda).manual_seed(planes * n1 + n2)
    x = torch.randn(planes, n1, n2, dtype=torch.complex64, device=cuda,
                    generator=g)
    before = K2.fft2_pass1.launches
    for inverse in (False, True):
        err, scale = _max_err(K2.fft2_pass1(x, inverse),
                              K2.fft2_pass1_plain(x, inverse))
        assert err <= 2e-5 * scale
    assert K2.fft2_pass1.launches == before + 2
    K2.twiddle.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("n1", [4096, 8192])
def test_cuda_fft2_pass1_unaligned_view_is_copied(cuda, n1):
    """A view whose storage offset leaves it 8-byte aligned (B9's tensor
    map needs 16) is copied by the wrapper, not refused."""
    g = torch.Generator(device=cuda).manual_seed(n1)
    base = torch.randn(n1 * 4096 + 1, dtype=torch.complex64, device=cuda,
                       generator=g)
    x = base[1:].reshape(1, n1, 4096)
    assert x.data_ptr() % 16 == 8
    for inverse in (False, True):
        err, scale = _max_err(K2.fft2_pass1(x, inverse),
                              K2.fft2_pass1_plain(x, inverse))
        assert err <= 2e-5 * scale


def _front_sums(b: torch.Tensor) -> torch.Tensor:
    """B11's sums of an intermediate b [S, n1, n2] in float64: sum |b|^2,
    Re and Im of sum_j2 b[0, j2] (the plain version's spelling)."""
    b64 = torch.view_as_real(b).to(torch.float64)
    f0 = b64[:, 0].sum(1)
    return torch.stack([b64.square().sum((1, 2, 3)), f0[:, 0], f0[:, 1]], 1)


def _packed_sums(z: torch.Tensor) -> torch.Tensor:
    """Exact float64 values of B11's sums from its packed input z [S, n1,
    n2], independent of any FFT: Parseval's sum |B|^2 = n1 sum |z|^2, the
    DC sum_j2 B[0, j2] = sum z (the twiddle is 1 on row k1 = 0) as Re and
    Im, and sum |Re z|, sum |Im z|, the scale of the DC's rounding."""
    out = torch.zeros(z.shape[0], 5, dtype=torch.float64, device=z.device)
    for blk in torch.view_as_real(z).split(1024, dim=1):
        v = blk.to(torch.float64)
        out[:, 0] += v.square().sum((1, 2, 3))
        out[:, 1:3] += v.sum((1, 2))
        out[:, 3:5] += v.abs().sum((1, 2))
    out[:, 0] *= z.shape[1]
    return out


def _hold_front_sums(aux: torch.Tensor, b: torch.Tensor,
                     z: torch.Tensor) -> None:
    """B11's sums ``aux`` [S, 3]: within 1e-9 relative of the float64 sums
    of its own intermediate ``b`` (other orders); sum |B|^2 within 3e-7
    relative of Parseval's exact value from the packed values ``z`` (a
    float32 column FFT loses energy: B11 read 3e-8 to 1.18e-7 below it at
    2^24 and 2^30, cuFFT up to 1.27e-7); the DC Re and Im within 1e-8 of
    sum |Re z|, sum |Im z| of the exact sum z (each float32 column sum
    rounds by about 2^-24 of its n1 values' sum, which averages down over
    the n2 columns to about 1e-9 of sum |z|; one value of z in 2^24 is
    6e-8 of it)."""
    torch.testing.assert_close(aux, _front_sums(b), rtol=1e-9, atol=0)
    ref = _packed_sums(z)
    energy = float((aux[:, 0] / ref[:, 0] - 1).abs().max())
    assert energy <= 3e-7, f"sum |B|^2 off Parseval's by {energy:.3e}"
    dc = float(((aux[:, 1:] - ref[:, 1:3]).abs() / ref[:, 3:]).max())
    assert dc <= 1e-8, f"DC off sum z by {dc:.3e} of sum |z|"


@pytest.mark.cuda
@pytest.mark.parametrize("variant,nbits", [("simple", 1), ("simple", 2),
                                           ("simple", 4), ("simple", 8),
                                           ("simple", -8),
                                           ("interleaved_samples_2", 8)])
def test_cuda_fft2_pass1_front_matches_plain(cuda, variant, nbits):
    """B11 at m = 2^24 ((4096, 4096)), windowed and not, both directions:
    the intermediate within 2e-5 of the largest |plain|, the sums held by
    :func:`_hold_front_sums` to its intermediate's and to the exact values
    from the packed input, and the mean power from them to 1e-6 relative
    of the plain version's (the chip check's gate: the energy of two
    float32 column FFTs, each 3e-8 to 1.3e-7 below Parseval's, differs by
    up to 5e-8 relative); for the simple sub-byte widths bit-identical to
    K1 + pack + B9 on the same bytes (B9's body on the same values)."""
    m = 1 << 24
    g = torch.Generator(device=cuda).manual_seed(abs(nbits))
    raw = torch.randint(0, 256, (FF.front_streams(variant) * 2 * m
                                 * abs(nbits) // 8,), dtype=torch.uint8,
                        device=cuda, generator=g)
    weo = tuple(torch.rand(4096, 4096, device=cuda, generator=g)
                for _ in range(2))
    for w in (None, weo):
        for inverse in (False, True):
            b, aux = FF.fft2_pass1_front(raw, m, variant, nbits, w, inverse)
            pb, paux = FF.fft2_pass1_front_plain(raw, m, variant, nbits, w,
                                                 inverse)
            err, scale = _max_err(b, pb)
            assert err <= 2e-5 * scale
            _hold_front_sums(aux, b, FF.front_pack(raw, m, variant, nbits,
                                                   w))
            torch.testing.assert_close(FF.front_mean_power(aux, 4096, m),
                                       FF.front_mean_power(paux, 4096, m),
                                       rtol=1e-6, atol=0)
            if variant == "simple" and nbits in (1, 2, 4):
                win = None if w is None else torch.stack(
                    [w[0].reshape(-1), w[1].reshape(-1)], 1).reshape(-1)
                z = KU.unpack_subbyte_window(raw, nbits, win)
                b9 = K2.fft2_pass1(torch.view_as_complex(
                    z.reshape(1, 4096, 4096, 2)), inverse)
                assert torch.equal(torch.view_as_real(b),
                                   torch.view_as_real(b9))


@pytest.mark.cuda
def test_cuda_fft2_pass1_front_at_the_segment_shape(cuda):
    """B11 at the front-fused 2^30 path's shape (2^28 raw 2-bit bytes into
    [8192, 65536]), forward: bit-identical to K1 + pack + B9 on the same
    bytes, the sums held by :func:`_hold_front_sums`, the mean power
    within 1e-6 of the plain version's and the intermediate within 2e-5
    of the largest |plain|."""
    m = 1 << 29
    g = torch.Generator(device=cuda).manual_seed(29)
    raw = torch.randint(0, 256, (m // 2,), dtype=torch.uint8, device=cuda,
                        generator=g)
    b, aux = FF.fft2_pass1_front(raw, m, "simple", 2)
    z = torch.view_as_complex(KU.unpack_subbyte_window(raw, 2).reshape(
        1, 8192, 1 << 16, 2))
    b9 = K2.fft2_pass1(z)
    assert torch.equal(torch.view_as_real(b), torch.view_as_real(b9))
    del b9
    _hold_front_sums(aux, b, z)
    del z
    pb, paux = FF.fft2_pass1_front_plain(raw, m, "simple", 2)
    K2.twiddle.cache_clear()
    torch.testing.assert_close(FF.front_mean_power(aux, 1 << 16, m),
                               FF.front_mean_power(paux, 1 << 16, m),
                               rtol=1e-6, atol=0)
    err, scale = _max_err(b, pb)
    assert err <= 2e-5 * scale


def _check_spectrum(got: torch.Tensor, want: torch.Tensor, b: torch.Tensor,
                    thr: torch.Tensor, kw: dict) -> None:
    """B12 against its plain version: a zap decision may differ only on a
    bin whose plain power lies within float32 rounding (1e-5 relative) of
    the threshold; the other bins within 5e-5 of the largest |plain| with
    the chirp (K2's gate) and 2e-5 without; the self-paired rows 0 and
    n1/2 (each written by the first half of its cluster alone) finite and
    within the same gate."""
    same = (got == 0) == (want == 0)
    if not bool(same.all()):
        # the plain power of a flipped bin, before the scale
        x = FF.fft2_pass2_spectrum_plain(
            b, torch.tensor([float("inf")], device=b.device), 1.0,
            premul=kw.get("premul"))
        p = (x.real ** 2 + x.imag ** 2)[~same]
        assert bool(((p - thr).abs() <= 1e-5 * thr).all())
    gate = 5e-5 if "chirp" in kw else 2e-5
    diff = torch.where(same, (got - want).abs(), 0.0)
    scale = float(want.abs().max())
    assert float(diff.max()) <= gate * scale
    for r in (0, b.shape[0] // 2):
        assert bool(torch.isfinite(got[r]).all())
        assert float(diff[r].max()) <= gate * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(n1, 1 << k) for n1 in (4096, 8192)
                                   for k in range(12, 17)])
def test_cuda_fft2_pass2_spectrum_matches_plain(cuda, n1, n2):
    """B12 on a noise intermediate at every row length (the pair clusters
    of 2, 2, 4 and 8 CTAs of the row core, and of 8 CTAs of 2^14 values at
    2^16) and both column lengths: with the exact chirp, the premul pair
    and neither, each with and without the keep mask, at the gates of
    ``_check_spectrum``; forms in turn write different values into the
    reused output block, so a bin left unwritten fails."""
    from srtb_tpu_torch.ops import fft as F
    m = n1 * n2
    g = torch.Generator(device=cuda).manual_seed(n1 + n2)
    b = torch.randn(n1, n2, dtype=torch.complex64, device=cuda, generator=g)
    thr = torch.tensor([6.0 * n2], device=cuda)
    keep = torch.rand(n1, n2, device=cuda, generator=g) > 0.05
    c = torch.exp(2j * torch.pi * torch.rand(n1, n2, device=cuda,
                                             generator=g))
    premul = (c, c * c)
    chirp = (1437.0, -64.0 / m, 1373.0, -478.8)
    forms = [dict(keep=keep, chirp=chirp), dict(chirp=chirp),
             dict(keep=keep, premul=premul), dict(premul=premul),
             dict(keep=keep), dict()]
    before = FF.fft2_pass2_spectrum.launches
    for kw in forms:
        got = FF.fft2_pass2_spectrum(b, thr, 0.125, **kw)
        want = FF.fft2_pass2_spectrum_plain(b, thr, 0.125, **kw)
        _check_spectrum(got, want, b, thr, kw)
        del got, want
        # the plain version's Hermitian weights: 8 GiB at m = 2^29
        F._hermitian_weights.cache_clear()
        torch.cuda.empty_cache()
    assert FF.fft2_pass2_spectrum.launches == before + len(forms)


@pytest.mark.cuda
def test_cuda_fft2_pass2_spectrum_unaligned_view_is_copied(cuda):
    """Views whose storage offsets leave them 8-byte aligned (the row
    core's TMA reads need 16), the intermediate and the keep mask, are
    copied by B12's wrapper, not refused."""
    n1, n2 = 4096, 1 << 13
    g = torch.Generator(device=cuda).manual_seed(7)
    base = torch.randn(n1 * n2 + 1, dtype=torch.complex64, device=cuda,
                       generator=g)
    b = base[1:].reshape(n1, n2)
    assert b.data_ptr() % 16 == 8
    thr = torch.tensor([6.0 * n2], device=cuda)
    got = FF.fft2_pass2_spectrum(b, thr, 0.125)
    _check_spectrum(got, FF.fft2_pass2_spectrum_plain(b, thr, 0.125), b,
                    thr, {})
    keep_base = torch.rand(n1 * n2 + 8, device=cuda, generator=g) > 0.05
    keep = keep_base[8:].reshape(n1, n2)
    assert keep.data_ptr() % 16 == 8
    kw = dict(keep=keep)
    got = FF.fft2_pass2_spectrum(b, thr, 0.125, **kw)
    _check_spectrum(got, FF.fft2_pass2_spectrum_plain(b, thr, 0.125, **kw),
                    b, thr, kw)


def _skzap_rows(cuda, batch: int, n: int, seed: int,
                nan_row: bool) -> torch.Tensor:
    """Noise rows whose inverse transform has an impulsive row 1 (SK high),
    a constant-modulus row 2 (SK low) and an all-zero row 3 (zero first
    sample, kept); with ``nan_row`` row 0 holds a NaN (kept, NaN
    throughout, and the time series NaN)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    wf = torch.randn(batch, n, dtype=torch.complex64, device=cuda,
                     generator=g)
    wf[1, ::64] *= 30.0
    wf[2] = torch.exp(1j * torch.rand(n, device=cuda, generator=g) * 6.0)
    wf[3] = 0
    x = torch.fft.fft(wf) / n
    if nan_row:
        x[0, 5] = complex(float("nan"), 0.0)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["fewer", "uneven", "two_waves"])
@pytest.mark.parametrize("log2", [12, 13, 14, 15, 16])
def test_cuda_fft_rows_skzap_groups_and_planted_rows(cuda, log2, rows):
    """B8 on its persistent groups (as many as the card holds at once) at
    every row length: fewer rows than groups, a batch that is not a
    multiple of the group count, and more than two rows a group; planted
    rows zapped or kept as the plain version decides, the NaN row kept
    and NaN throughout (so the time series is NaN) in the first of two
    calls; values within 1e-5 of the largest, first-sample powers within
    1e-5 relative, the time series within the repo's
    ``time_series_error_gates`` for the measured waterfall error (as
    ``chip_smoke.py`` holds it: over four kept rows, two float32 FFTs'
    powers differ by up to 2e-6 relative); one launch a call."""
    n = 1 << log2
    groups = KF.skzap_geometry(n, cuda)["resident"]
    batch = {"fewer": min(7, groups - 1), "uneven": groups + 3,
             "two_waves": 2 * groups + 5}[rows]
    assert KF.skzap_groups(batch, groups) == min(batch, groups)
    before = KF.fft_rows_skzap.launches
    for nan_row in (True, False):
        x = _skzap_rows(cuda, batch, n, log2 + batch, nan_row)
        got = KF.fft_rows_skzap(x, SK_THR)
        want = KF.fft_rows_skzap_plain(x, SK_THR)
        assert torch.equal(got[1], want[1])
        assert bool(got[1][1]) and bool(got[1][2]) and not bool(got[1][3])
        assert float(got[2][3]) == 0.0
        nan = torch.isnan(want[0])
        assert torch.equal(torch.isnan(got[0]), nan)
        assert bool(nan[0].all()) == nan_row and not bool(nan[1:].any())
        err, scale = _max_err(got[0][~nan], want[0][~nan])
        assert err <= 1e-5 * scale
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0,
                                   equal_nan=True)
        assert bool(torch.isnan(got[3]).all()) == nan_row
        if not nan_row:
            _hold_time_series(got[3], want[3], batch, n, err)
    assert KF.fft_rows_skzap.launches == before + 2


def _hold_time_series(got: torch.Tensor, want: torch.Tensor, rows: int,
                      n: int, wf_err: float) -> None:
    """B8's time series against the plain one within
    ``time_series_error_gates``: float32 summation over the rows plus the
    waterfall error ``wf_err`` carried through |x|^2 and the row sum."""
    gates = det.time_series_error_gates(rows, n, float(want.max()), wf_err)
    assert float((got - want).abs().max()) <= sum(gates)


@pytest.mark.cuda
@pytest.mark.parametrize("log2", [12, 15])
def test_cuda_fft_rows_skzap_unaligned_view_is_copied(cuda, log2):
    """A view whose storage offset leaves it 8-byte aligned (TMA reads
    need 16) is copied by B8's wrapper, not refused."""
    n = 1 << log2
    x = _skzap_rows(cuda, 9, n, 3, False)
    base = torch.empty(9 * n + 1, dtype=torch.complex64, device=cuda)
    view = base[1:].reshape(9, n)
    view.copy_(x)
    assert view.data_ptr() % 16 == 8
    got = KF.fft_rows_skzap(view, SK_THR)
    want = KF.fft_rows_skzap_plain(x, SK_THR)
    assert torch.equal(got[1], want[1])
    err, scale = _max_err(got[0], want[0])
    assert err <= 1e-5 * scale
    _hold_time_series(got[3], want[3], 9, n, err)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [8, -8])
def test_cuda_pass1_front_two_streams_matches_plain(cuda, nbits):
    """B11 in its two-stream form ("1212"-interleaved 8-bit bytes) at
    m = 2^24 a stream, (n1, n2) = (4096, 4096): within 2e-5 of the
    largest |plain| of its plain version, bit-identical to B9 on the
    same packed values, and each stream's mean power within 1e-6 of the
    plain float64 sums'."""
    from srtb_tpu_torch.kernels import fft2 as K2
    from srtb_tpu_torch.kernels import fft2_front as FF
    m, variant = 1 << 24, "interleaved_samples_2"
    n2 = K2.ffuse_factor(m)[1]
    g = torch.Generator(device=cuda).manual_seed(31)
    raw = torch.randint(0, 256, (4 * m,), dtype=torch.uint8, device=cuda,
                        generator=g)
    before = FF.fft2_pass1_front.launches
    b, aux = FF.fft2_pass1_front(raw, m, variant, nbits)
    assert FF.fft2_pass1_front.launches == before + 1
    assert b.shape == (2, 4096, 4096)
    pb, paux = FF.fft2_pass1_front_plain(raw, m, variant, nbits)
    assert float((b - pb).abs().max()) <= 2e-5 * float(pb.abs().max())
    z = FF.front_pack(raw, m, variant, nbits)
    assert torch.equal(torch.view_as_real(b),
                       torch.view_as_real(K2.fft2_pass1(z)))
    mean = FF.front_mean_power(aux, n2, m)
    want = FF.front_mean_power(paux, n2, m)
    assert float(((mean - want).abs() / want).max()) <= 1e-6


@pytest.mark.cuda
def test_cuda_kernels_on_per_stream_views(cuda):
    """K2, K3 and K4 on the rows of a two-stream [S, ...] tensor, as the
    processor hands them (contiguous views, the output into the caller's
    rows), against their plain versions on the same views."""
    spec = torch.from_numpy(np.stack([SPEC, SPEC[::-1].copy()])).to(cuda)
    keep = torch.from_numpy(~ZAP_MASK).to(cuda)
    args = (NORM, CHIRP["f_min"], CHIRP["df"], CHIRP["f_c"], CHIRP["dm"])
    thr = KR.rfi_threshold(spec, S1_THR)
    assert thr.shape == (2, 1)
    out = torch.empty_like(spec)
    for s in range(2):
        got = KR.rfi_s1_dedisperse(spec[s], thr[s], *args, keep=keep,
                                   out=out[s])
        assert got.data_ptr() == out[s].data_ptr()
        want = KR.rfi_s1_dedisperse_plain(spec[s], thr[s], *args, keep=keep)
        assert torch.equal(got == 0, want == 0)
        assert float((got - want).abs().max()) <= \
            1e-6 * float(want.abs().max())
    wf = torch.from_numpy(np.stack([WF, np.roll(WF, 5, axis=0)])).to(cuda)
    zapped = torch.empty_like(wf)
    for s in range(2):
        for a, b in zip(KS.sk_stats(wf[s]), KS.sk_stats_plain(wf[s])):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0,
                                       equal_nan=True)
        zap = torch.from_numpy(np.roll(ZAP_APPLY, s)).to(cuda)
        got, ts = KS.sk_apply_timeseries(wf[s], zap, out=zapped[s])
        assert got.data_ptr() == zapped[s].data_ptr()
        for a, b in zip((zapped[s], ts),
                        KS.sk_apply_timeseries_plain(wf[s], zap)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0,
                                       equal_nan=True)
