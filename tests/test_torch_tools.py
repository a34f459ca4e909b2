"""The port's ``srtb-torch-correlator`` and ``srtb-torch-plot-dm-curve``
against the JAX package's ``srtb-correlator`` and ``srtb-plot-dm-curve``.

The correlator at 2^16 samples on uint8 and int8 inputs: the second
input is the first delayed by a known lag plus independent noise.  Gate:
``rtol=1e-5, atol=1e-6 * max``; the peak at index (n - lag) / 2 (the
output's lags step by two samples, counted back from its end for a
delayed second input, and lag / 2 with the inputs swapped), +-1;
``corr.bin`` little-endian float32 of n / 2 values, the same length as
the reference's.  The DM-curve plot on a ``dm_trials.jsonl`` record:
with matplotlib the same PNG bytes as the reference's; without it the
printed curve (the reference raises ImportError there)."""

import json

import numpy as np
import pytest

from srtb_tpu_torch.tools import correlator as C
from srtb_tpu_torch.tools import plot_dm_curve as PD
from test_torch_ref import block_matplotlib, run_printing, run_reference

N = 1 << 16
LAG = 1000


def delayed_pair(kind: str, seed: int = 0):
    """Two 8-bit streams of N samples: the second is the first delayed by
    LAG samples, plus independent noise (uint8 offset binary, or int8)."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(N + LAG) * 30.0
    noise = rng.standard_normal(N) * 10.0
    if kind == "uint8":
        q = (lambda v: np.clip(np.round(v + 128), 0, 255).astype(np.uint8))
    else:
        q = (lambda v: np.clip(np.round(v), -128, 127).astype(np.int8))
    return q(s[LAG:]), q(s[:N] + noise)


RECORDS = [
    {"segment": 0, "timestamp": 1, "best_dm": -478.8, "best_snr": 12.5,
     "dm_list": [-380.0, -430.0, -465.0, -478.8, -495.0, -530.0],
     "peak_snr": [3.1, 4.5, 9.25, 12.5, 8.0, 3.0],
     "signal_counts": [0, 0, 3, 7, 2, 0], "zero_counts": [1, 1, 2, 5, 1, 1]},
    {"segment": 1, "timestamp": 2, "best_dm": -430.0, "best_snr": 4.0,
     "dm_list": [-380.0, -430.0, -465.0, -478.8, -495.0, -530.0],
     "peak_snr": [3.5, 4.0, 3.9, 3.7, 3.2, 3.8],
     "signal_counts": [0, 0, 0, 0, 0, 0], "zero_counts": [1, 1, 1, 1, 1, 1]}]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tools_ref")
    trials = tmp / "out_dm_trials.jsonl"
    trials.write_text("".join(json.dumps(r) + "\n" for r in RECORDS))
    jobs = [{"key": f"corr/{kind}", "fn": "test_torch_ref:correlate",
             "args": list(delayed_pair(kind))} for kind in ("uint8", "int8")]
    jobs += [{"key": f"plot/{m}", "fn": "test_torch_ref:ref_plot_dm_curve",
              "args": [[str(trials), str(tmp / f"ref_{m}.png")], m]}
             for m in (True, False)]
    return {"out": run_reference(jobs, tmp), "trials": trials, "tmp": tmp}


@pytest.mark.parametrize("kind", ["uint8", "int8"])
def test_correlate_matches_reference(ref, kind):
    x1, x2 = delayed_pair(kind)
    got = C.correlate(x1, x2, device="cpu")
    want = ref["out"][f"corr/{kind}/corr"]
    assert got.dtype == np.float32 and got.shape == want.shape == (N // 2,)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.max()))
    assert abs(int(np.argmax(got)) - (N - LAG) // 2) <= 1
    swapped = C.correlate(x2, x1, device="cpu")
    assert abs(int(np.argmax(swapped)) - LAG // 2) <= 1


def test_correlator_main_writes_corr_bin(ref, tmp_path):
    """The three positional arguments (and ``--device``): ``corr.bin`` is
    little-endian float32 of the reference's length, its values the
    port's ``correlate``; odd lengths normalize by the shorter file as
    the reference does."""
    x1, x2 = delayed_pair("uint8")
    a, b, out = (tmp_path / n for n in ("pol_1.bin", "pol_2.bin",
                                        "corr.bin"))
    x1.tofile(a)
    x2[:-1].tofile(b)  # one sample shorter: the reference's n - 1 norm
    assert C.main([str(a), str(b), str(out), "--device", "cpu"]) == 0
    got = np.fromfile(out, dtype="<f4")
    assert out.stat().st_size == 4 * ((N - 1) // 2)
    np.testing.assert_array_equal(got, C.correlate(x1, x2[:-1], "cpu"))
    ref_bin = ref["out"]["corr/uint8/corr_bin"]
    assert ref_bin.size == 4 * (N // 2)
    full = tmp_path / "full.bin"
    x2.tofile(b)
    assert C.main([str(a), str(b), str(full), "--device", "cpu"]) == 0
    np.testing.assert_allclose(np.fromfile(full, dtype="<f4"),
                               ref_bin.view("<f4"), rtol=1e-5,
                               atol=1e-6 * float(ref_bin.view("<f4").max()))


def test_correlator_default_inputs(tmp_path, monkeypatch):
    """No input arguments: ``pol_1.bin`` and ``pol_2.bin`` of the working
    directory, read as uint8, on the card unless ``--device`` says
    otherwise (the output given, so nothing lands in ``/dev/shm``)."""
    x1, x2 = delayed_pair("uint8", seed=1)
    monkeypatch.chdir(tmp_path)
    x1[:4096].tofile("pol_1.bin")
    x2[:4096].tofile("pol_2.bin")
    calls = []
    real = C.correlate

    def recording(a, b, device=None):
        calls.append((a.dtype, a.size, b.size, device))
        return real(a, b, "cpu")
    monkeypatch.setattr(C, "correlate", recording)
    out = tmp_path / "corr.bin"
    assert C.main(["pol_1.bin", "pol_2.bin", str(out)]) == 0
    assert calls == [(np.uint8, 4096, 4096, None)]
    assert out.stat().st_size == 4 * 2048


def test_plot_dm_curve_with_matplotlib(ref, tmp_path):
    """The reference's plot, byte for byte, and its printed path."""
    pytest.importorskip("matplotlib")
    out = tmp_path / "port.png"
    got = run_printing(PD.main, [str(ref["trials"]), str(out)],
                       matplotlib=True)
    assert got["rc"] == 0 and got["stdout"] == f"{out}\n"
    want = ref["out"]
    assert int(want["plot/True/rc"]) == 0
    ref_png = (ref["tmp"] / "ref_True.png").read_bytes()
    assert out.read_bytes() == ref_png


def test_plot_dm_curve_without_matplotlib(ref):
    """Without matplotlib the reference raises ImportError; the port
    prints each segment's curve, the best trial marked."""
    assert str(ref["out"]["plot/False/error"]) in ("ImportError",
                                                   "ModuleNotFoundError")
    got = run_printing(PD.main, [str(ref["trials"])], matplotlib=False)
    assert got["rc"] == 0
    lines = got["stdout"].splitlines()
    assert lines[0] == "segment 0: best dm -478.8 (S/N 12.5)"
    assert lines[7] == "segment 1: best dm -430.0 (S/N 4.0)"
    best = lines[4]
    assert best.startswith("  dm     -478.8 S/N    12.50 ") and \
        best.endswith("#" * PD.BAR_WIDTH + " <- best")
    assert sum("<- best" in line for line in lines) == 2
    with block_matplotlib(), pytest.raises(ImportError):
        PD.plot(str(ref["trials"]))


def test_plot_dm_curve_usage_and_empty(tmp_path, capsys):
    assert PD.main([]) == 2
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    with pytest.raises(SystemExit, match="no trial records"):
        PD.main([str(empty)])
