"""B6, B7, B8 and B13.  On the CPU each wrapper runs its plain PyTorch
version, held here against the JAX package's Pallas kernel in interpret
mode on the same inputs (``fft_rows_ri``, ``fft_rows_stats_ri``,
``fft_rows_skzap_ri``, ``unpack_subbyte_planes_window``).  The CUDA
kernels are held against these plain versions on the card by the
``cuda``-marked tests of ``test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from srtb_tpu_torch import kernels as K
from srtb_tpu_torch.kernels import fft_rows as KF
from srtb_tpu_torch.kernels import unpack as KU
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.ops import fft as F
from srtb_tpu_torch.ops import window as W
from test_torch_ref import run_reference

RNG = np.random.default_rng(4559)
LENGTHS = (1 << 12, 1 << 13)
ROWS = 12
SK_THR = 1.5
FFT_CASES = [(n, inv) for n in LENGTHS for inv in (False, True)]
STATS_CASES = [(n, inv, dw) for n in LENGTHS for inv in (False, True)
               for dw in (False, True)]
SKZAP_CASES = [(n, dw) for n in LENGTHS for dw in (False, True)]
UNPACK_CASES = [(b, w) for b in (1, 2, 4) for w in (False, True)]
BYTES = RNG.integers(0, 256, 1 << 13, dtype=np.uint8)


def _noise(shape) -> np.ndarray:
    return (RNG.standard_normal(shape)
            + 1j * RNG.standard_normal(shape)).astype(np.complex64)


def _planted(length: int) -> np.ndarray:
    """Rows whose inverse transform (the waterfall) is planted: noise, an
    impulsive row (SK high), a constant-modulus row (SK low) and an
    all-zero row (zero first sample, SK NaN: kept); the kernels get the
    forward transform."""
    wf = _noise((ROWS, length))
    wf[3, ::64] *= 30.0
    wf[5] = np.exp(1j * RNG.uniform(0, 6, length)).astype(np.complex64)
    wf[7] = 0
    return (np.fft.fft(wf.astype(np.complex128), axis=-1)
            / length).astype(np.complex64)


ROWS_IN = {n: _noise((ROWS, n)) for n in LENGTHS}
PLANTED = {n: _planted(n) for n in LENGTHS}
DEWINDOW = {n: W.dewindow_coefficients("hann", n) for n in LENGTHS}
WINDOWS = {b: RNG.uniform(0.5, 1.5, (8 // b, BYTES.size)).astype(np.float32)
           for b in (1, 2, 4)}


def _ri(c: np.ndarray):
    return [np.ascontiguousarray(c.real), np.ascontiguousarray(c.imag)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pf = "srtb_tpu.ops.pallas_fft:"
    jobs = [{"key": f"rows/{n}/{inv}", "fn": pf + "fft_rows_ri",
             "args": _ri(ROWS_IN[n]) + [inv],
             "kwargs": {"interpret": True}} for n, inv in FFT_CASES]
    jobs += [{"key": f"stats/{n}/{inv}/{dw}", "fn": pf + "fft_rows_stats_ri",
              "args": _ri(ROWS_IN[n]) + [inv],
              "kwargs": {"dewindow": DEWINDOW[n] if dw else None,
                         "interpret": True}}
             for n, inv, dw in STATS_CASES]
    jobs += [{"key": f"skzap/{n}/{dw}", "fn": pf + "fft_rows_skzap_ri",
              "args": _ri(PLANTED[n]) + [SK_THR],
              "kwargs": {"dewindow": DEWINDOW[n] if dw else None,
                         "interpret": True}} for n, dw in SKZAP_CASES]
    jobs += [{"key": f"planes/{b}/{w}",
              "fn": "srtb_tpu.ops.pallas_kernels:unpack_subbyte_planes_window",
              "args": [BYTES, b, WINDOWS[b] if w else None],
              "kwargs": {"interpret": True}} for b, w in UNPACK_CASES]
    return run_reference(jobs, tmp_path_factory.mktemp("ref_fft_rows"))


def _complex(ref, key: str) -> np.ndarray:
    return ref[f"{key}/0"] + 1j * ref[f"{key}/1"]


def _close(got: np.ndarray, want: np.ndarray, rel: float = 1e-5) -> None:
    """float32 FFTs of two algorithms (radix-16 Stockham in torch/cuFFT
    order against the reference's two DFT-matrix stages): rounding grows
    like eps log2(L) per value, so agreement to 1e-5 of the largest."""
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("length,inverse", FFT_CASES)
def test_fft_rows_plain_matches_pallas(ref, length, inverse):
    """B6: unnormalized both ways, leading dims batch."""
    x = torch.from_numpy(ROWS_IN[length]).reshape(3, ROWS // 3, length)
    got = KF.fft_rows(x, inverse).reshape(ROWS, length).numpy()
    _close(got, _complex(ref, f"rows/{length}/{inverse}"))


@pytest.mark.parametrize("length,inverse,dewin", STATS_CASES)
def test_fft_rows_stats_plain_matches_pallas(ref, length, inverse, dewin):
    """B7: the rows (de-windowed by the reciprocal multiply) as B6, and
    the per-row moments to 1e-5 relative — the reference sums 128-lane
    float32 partials, the port in float64."""
    dw = torch.from_numpy(DEWINDOW[length]) if dewin else None
    y, s2, s4 = KF.fft_rows_stats(torch.from_numpy(ROWS_IN[length]),
                                  inverse, dw)
    key = f"stats/{length}/{inverse}/{dewin}"
    _close(y.numpy(), _complex(ref, key))
    np.testing.assert_allclose(s2.numpy(), ref[f"{key}/2"].sum(-1),
                               rtol=1e-5)
    np.testing.assert_allclose(s4.numpy(), ref[f"{key}/3"].sum(-1),
                               rtol=1e-5)


@pytest.mark.parametrize("length,dewin", SKZAP_CASES)
def test_fft_rows_skzap_plain_matches_pallas(ref, length, dewin):
    """B8 on planted rows: the zap verdicts, the zero-channel flags and
    the zero count bit-identical (impulsive and constant-modulus rows
    zapped, the zero row kept — and with the hann de-window, whose
    near-zero edges trip the SK, every other row zapped); the zapped
    waterfall to 1e-5 of its largest value; the time series within the
    reference's float32 summation gate for that waterfall error."""
    dw = torch.from_numpy(DEWINDOW[length]) if dewin else None
    out, zap, fs0, ts = KF.fft_rows_skzap(torch.from_numpy(PLANTED[length]),
                                          SK_THR, dewindow=dw)
    key = f"skzap/{length}/{dewin}"
    want_zap = ref[f"{key}/2"][:, 0] != 0
    np.testing.assert_array_equal(zap.numpy(), want_zap)
    assert want_zap[3] and want_zap[5] and not want_zap[7]
    assert want_zap[:7].all() == dewin
    assert int(zap.sum()) < ROWS
    np.testing.assert_array_equal((fs0 == 0).numpy(),
                                  ref[f"{key}/3"][:, 0] == 0)
    zero = int((zap | (fs0 == 0)).sum())
    assert zero == int(((ref[f"{key}/2"][:, 0] != 0)
                        | (ref[f"{key}/3"][:, 0] == 0)).sum())
    assert int(fs0[7]) == 0
    want = _complex(ref, key)
    _close(out.numpy(), want)
    p = np.abs(want.astype(np.complex128)) ** 2
    wf_err = float(np.abs(out.numpy() - want).max())
    gates = det.time_series_error_gates(ROWS, length, float(p.sum(0).max()),
                                        wf_err)
    assert np.abs(ts.numpy() - ref[f"{key}/4"]).max() <= sum(gates)


@pytest.mark.parametrize("nbits,win", UNPACK_CASES)
def test_unpack_planes_plain_matches_pallas(ref, nbits, win):
    """B13, exact: the packed z [count/2, m] holds the reference's planes
    pairwise (re = plane 2k', im = plane 2k'+1)."""
    w = torch.from_numpy(WINDOWS[nbits]) if win else None
    z = KU.unpack_subbyte_planes_window(torch.from_numpy(BYTES), nbits, w)
    planes = ref[f"planes/{nbits}/{win}"]
    assert z.shape == (4 // nbits, BYTES.size)
    got = torch.view_as_real(z).numpy()
    np.testing.assert_array_equal(got[..., 0], planes[0::2])
    np.testing.assert_array_equal(got[..., 1], planes[1::2])


def test_supported_window_and_rejections():
    """The kernels' window is the reference's: powers of two in
    [2^12, 2^16]; other shapes and types raise on every device."""
    assert [n for n in range(10, 18) if KF.supported(1 << n, 1)] == \
        [12, 13, 14, 15, 16]
    assert not KF.supported(3 << 12, 1) and not KF.supported(1 << 12, 0)
    with pytest.raises(ValueError):
        KF.fft_rows(torch.zeros(2, 1 << 11, dtype=torch.complex64))
    with pytest.raises(ValueError):
        KF.fft_rows(torch.zeros(2, 1 << 12, dtype=torch.complex128))
    with pytest.raises(ValueError):
        KF.fft_rows_skzap(torch.zeros(2, 2, 1 << 12,
                                      dtype=torch.complex64), 1.5)
    with pytest.raises(ValueError):
        KF.fft_rows_stats(torch.zeros(2, 1 << 12, dtype=torch.complex64),
                          dewindow=torch.ones(7))
    with pytest.raises(ValueError):
        KU.unpack_subbyte_planes_window(torch.from_numpy(BYTES), 2,
                                        torch.ones(4, 3))


def test_registry_lists_the_slice_kernels():
    """The four kernels of the row-FFT slice follow K1-K4 in the registry,
    each with its source and the reference's pallas_call; CPU calls launch
    nothing."""
    K.reset_launch_counts()
    KF.fft_rows(torch.from_numpy(ROWS_IN[1 << 12]))
    KU.unpack_subbyte_planes_window(torch.from_numpy(BYTES), 2)
    names = [name for name, *_ in K.KERNELS]
    assert names[4:8] == ["unpack_subbyte_planes_window", "fft_rows",
                          "fft_rows_stats", "fft_rows_skzap"]
    assert not any(K.launch_counts().values())
    srcs = {name: (src, tpu) for name, _w, src, tpu in K.KERNELS}
    assert srcs["fft_rows_skzap"] == ("srtb_tpu_torch/csrc/fft_rows_skzap.cu",
                                      "srtb_tpu/ops/pallas_fft.py:278")


def test_skzap_groups_cover_every_row():
    """B8's persistent groups: as many as the card holds at once (the
    resident clusters or CTAs of its geometry query), never more than
    there are rows, at least one; row r goes to group r mod groups."""
    assert KF.skzap_groups(2048, 62) == 62
    assert KF.skzap_groups(2048, 264) == 264
    assert KF.skzap_groups(9, 62) == 9
    assert KF.skzap_groups(1, 30) == 1
    rows = {r % KF.skzap_groups(2049, 62) for r in range(2049)}
    assert rows == set(range(62))


def _csrc(name: str) -> str:
    from pathlib import Path
    return (Path(KF.__file__).resolve().parent.parent / "csrc"
            / name).read_text()


@pytest.mark.parametrize("query", ["srtb_fft_rows_geometry",
                                   "srtb_fft_rows_stats_geometry",
                                   "srtb_fft_rows_skzap_geometry",
                                   "srtb_fft2_pass2_spectrum_geometry"])
def test_row_core_wrapper_contract(query):
    """The row core's geometry queries (B6/B10's, and those of its
    epilogue kernels B7, B8 and B12) fill the record the wrappers read
    (``kGeometryFields`` in csrc/fft_rows_sm90.cuh, one query of rows of a
    length each), and rows that are not on a CUDA device never reach the
    library."""
    import re
    from srtb_tpu_torch.kernels import build
    n = int(re.search(r"kGeometryFields = (\d+);",
                      _csrc("fft_rows_sm90.cuh")).group(1))
    assert len(KF.GEOMETRY_FIELDS) == n
    assert build._SIGNATURES[query] == (build._I64, build._P)
    with pytest.raises(ValueError):
        KF.run_rows("srtb_fft_rows", torch.zeros(2, 1 << 12,
                                                 dtype=torch.complex64),
                    2, 1 << 12, False)


def test_library_signatures_match_the_sources():
    """Every entry point the wrappers call is exported by exactly one
    source, with as many parameters as its ctypes signature has (a
    mismatch would pass pointers into the wrong arguments on the card)."""
    import re
    from pathlib import Path
    from srtb_tpu_torch.kernels import build
    exported = {}
    for src in sorted(Path(build.CSRC_DIR).glob("*.cu")):
        for name, params in re.findall(
                r"SRTB_EXPORT int (\w+)\(([^)]*)\)", src.read_text()):
            assert name not in exported, name
            exported[name] = len([a for a in params.split(",") if a.strip()])
    assert set(exported) == set(build._SIGNATURES)
    for name, argtypes in build._SIGNATURES.items():
        assert exported[name] == len(argtypes), name


def test_aligned_copies_only_a_misaligned_view():
    """The TMA-fed kernels' wrappers pass 16-byte aligned rows: a view 8
    bytes off is copied, an aligned tensor is passed as it is."""
    base = torch.zeros(2 * 4096 + 1, dtype=torch.complex64)
    assert KF.aligned(base) is base
    view = base[1:]
    assert view.data_ptr() % 16 == 8
    copy = KF.aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


def test_ops_fft_minor_takes_the_kernel_window():
    """``fft_minor`` with "pallas" rows: rows in the window go to B6 (the
    plain version here), longer rows to the four-step, shorter ones to
    torch.fft — all the same transform."""
    x = torch.from_numpy(_noise((2, 1 << 11)))
    for rows in (x, torch.from_numpy(ROWS_IN[1 << 12])):
        _close(F.fft_minor(rows, False, "pallas").numpy(),
               np.fft.fft(rows.numpy().astype(np.complex128)))
    y = torch.from_numpy(_noise((1, 1 << 13)))
    _close(F.fft_minor(y, True, "pallas", len_cap=1 << 12).numpy(),
           np.fft.ifft(y.numpy().astype(np.complex128)) * (1 << 13))
