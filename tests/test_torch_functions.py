"""The port's remaining library functions against the JAX package's, on
the same inputs made with numpy from a seed (the reference runs in its
own interpreter, ``tests/test_torch_ref.py``; its Pallas rows in
interpret mode).  Each tolerance is stated beside its check:

- the sigproc filterbank header, equal by SHA-256;
- ``ops/fft``: ``c2c_forward``, the four-step's two halves,
  ``rfft_via_c2c`` and ``ifft_refft_waterfall``;
- ``ops/dedisperse.dedisperse``;
- ``Supervisor.remaining`` on an injected clock, ``Rung.name``,
  ``native_available`` and ``get_logger``;
- ``sync_with_deadline``'s ``on_deadline``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from srtb_tpu_torch.io import native_writer
from srtb_tpu_torch.kernels import fft_rows as KF
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import fft as F
from srtb_tpu_torch.ops import window as W
from test_torch_ref import filterbank_header, remaining_script, run_reference

# the reference's tests/test_tools.py:75-78 arguments, and a second set
# with 8 bits and two IFs
FILTERBANK = {
    "j1644": dict(fch1=1469.0, foff=-0.03125, nchans=2048, tsamp=3.2e-5,
                  source_name="J1644-4559", src_raj=(16, 44, 49.3),
                  src_dej=(-45, 59, 9.5)),
    "nbits8_nifs2": dict(telescope_id=21, machine_id=3, data_type=1,
                         fch1=1437.0, foff=-0.5, nchans=128, tsamp=1e-3,
                         nbits=8, nifs=2, tstart=60235.25,
                         src_raj=(5, 34, 31.94), src_dej=(22, 0, 52.2),
                         source_name="B0531+21"),
}
# the four-step halves: (log2 n, inverse, rows_impl); "pallas" rows run
# the reference's Pallas kernel in interpret mode and B6's plain twin
FOUR_STEP = {"n14_xla": (14, False, "xla"), "n16_inv_xla": (16, True, "xla"),
             "n14_pallas": (14, False, "pallas"),
             "n16_inv_pallas": (16, True, "pallas")}
# rfft_via_c2c: (log2 n, use_four_step, drop_nyquist)
RFFT = {f"n{b}_{'4s' if fs else 'c2c'}_{'drop' if d else 'full'}": (b, fs, d)
        for b in (14, 16) for fs in (False, True) for d in (False, True)}
# ifft_refft_waterfall: (log2 n, channels, reserved complex samples,
# window); the first is the reference's tests/test_fft.py:85-104 case
REFFT = {"n10": (10, 32, 64, None), "n16_hann": (16, 2048, 1000, "hann")}
# the reference's tolerances: tests/test_fft.py four-step and
# rfft_via_c2c (rtol 1e-3, atol 2e-2 sqrt(n)), ifft_refft_waterfall
# (rtol 1e-3, atol 0.5), c2c (rtol 1e-4, atol 1e-3 n)
FFT_RTOL = 1e-3
REFFT_ATOL = 0.5
C2C_RTOL = 1e-4
# the restart budget's script: 3 restarts in a 10 s window
SUPERVISOR_STEPS = [("remaining",), ("crash",), ("tick", 4.0), ("crash",),
                    ("remaining",), ("crash",), ("remaining",),
                    ("crash",), ("tick", 6.5), ("remaining",),
                    ("tick", 4.0), ("remaining",), ("tick", 100.0),
                    ("remaining",), ("crash",), ("remaining",)]


def _complex(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _real(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _stage2_input(log2n: int) -> np.ndarray:
    """A[n2, k1], the layout stage 1 returns."""
    n1 = 1 << (log2n // 2)
    return _complex(((1 << log2n) // n1, n1), 100 + log2n)


def _refft_args(name: str) -> tuple:
    log2n, channels, reserved, win = REFFT[name]
    window = None if win is None else W.window_coefficients(win, channels)
    return _complex(1 << log2n, 9 if log2n == 10 else 16), channels, \
        reserved, window


C2C_X = _complex((4, 1024), 3)
DD_SPEC = _complex(1 << 12, 5)
DD_CHIRP = dd.chirp_factor(1 << 12, 1437.0, -64.0 / (1 << 12), 1373.0,
                           -478.80).numpy()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jobs = [{"key": f"fb/{name}", "fn": "test_torch_ref:filterbank_header",
             "args": ["srtb_tpu", kw]} for name, kw in FILTERBANK.items()]
    jobs += [{"key": "c2c", "fn": "srtb_tpu.ops.fft:c2c_forward",
              "args": [C2C_X]},
             {"key": "dedisperse", "fn": "srtb_tpu.ops.dedisperse:dedisperse",
              "args": [DD_SPEC, DD_CHIRP]},
             {"key": "remaining", "fn": "test_torch_ref:remaining_script",
              "args": ["srtb_tpu", 3, 10.0, SUPERVISOR_STEPS]}]
    for name, (log2n, inverse, rows) in FOUR_STEP.items():
        impl = "pallas_interpret" if rows == "pallas" else rows
        jobs += [{"key": f"stage1/{name}",
                  "fn": "srtb_tpu.ops.fft:four_step_stage1",
                  "args": [_complex(1 << log2n, log2n), inverse, impl]},
                 {"key": f"stage2/{name}",
                  "fn": "srtb_tpu.ops.fft:four_step_stage2",
                  "args": [_stage2_input(log2n), inverse, impl]}]
    for name, (log2n, four_step, drop) in RFFT.items():
        jobs.append({"key": f"rfft/{name}",
                     "fn": "srtb_tpu.ops.fft:rfft_via_c2c",
                     "args": [_real(1 << log2n, log2n)],
                     "kwargs": {"use_four_step": four_step,
                                "drop_nyquist": drop}})
    for name in REFFT:
        jobs.append({"key": f"refft/{name}",
                     "fn": "srtb_tpu.ops.fft:ifft_refft_waterfall",
                     "args": list(_refft_args(name))})
    return run_reference(jobs, tmp_path_factory.mktemp("ref_functions"))


@pytest.mark.parametrize("name", sorted(FILTERBANK))
def test_filterbank_header_bytes(ref, name):
    """The header's bytes equal the reference's, by SHA-256."""
    got = filterbank_header("srtb_tpu_torch", FILTERBANK[name])
    assert got["sha256"] == str(ref[f"fb/{name}/sha256"])
    np.testing.assert_array_equal(got["bytes"], ref[f"fb/{name}/bytes"])


def test_c2c_forward(ref):
    """Unnormalized along the last axis; the reference's c2c tolerance
    (rtol 1e-4, atol 1e-3 n)."""
    got = F.c2c_forward(torch.from_numpy(C2C_X)).numpy()
    n = C2C_X.shape[-1]
    np.testing.assert_allclose(got, ref["c2c"], rtol=C2C_RTOL,
                               atol=1e-3 * n)


@pytest.mark.parametrize("name", sorted(FOUR_STEP))
def test_four_step_halves(ref, name):
    """Each half on the same input as the reference's; the reference's
    four-step tolerance (rtol 1e-3, atol 2e-2 sqrt(n)).  The halves
    compose to ``four_step_fft``."""
    log2n, inverse, rows = FOUR_STEP[name]
    n = 1 << log2n
    x = torch.from_numpy(_complex(n, log2n))
    a = F.four_step_stage1(x, inverse, rows)
    np.testing.assert_allclose(a.numpy(), ref[f"stage1/{name}"],
                               rtol=FFT_RTOL, atol=2e-2 * np.sqrt(n))
    got = F.four_step_stage2(torch.from_numpy(_stage2_input(log2n)),
                             inverse, rows).numpy()
    np.testing.assert_allclose(got, ref[f"stage2/{name}"], rtol=FFT_RTOL,
                               atol=2e-2 * np.sqrt(n))
    whole = F.four_step_stage2(a, inverse, rows)
    assert torch.equal(whole, F.four_step_fft(x, inverse, rows))


def test_four_step_halves_route_rows_to_b6(monkeypatch):
    """With rows_impl "pallas" each half hands rows in B6's window (here
    2^12 at n = 2^24) to ``fft_rows`` (its plain twin on the CPU), as
    ``fft_minor`` does; with "xla" neither does."""
    calls = []
    fft_rows = KF.fft_rows

    def counted(x, inverse=False):
        calls.append(tuple(x.shape))
        return fft_rows(x, inverse)
    monkeypatch.setattr(KF, "fft_rows", counted)
    x = torch.from_numpy(_complex(1 << 24, 24))
    a = F.four_step_stage1(x, rows_impl="pallas")
    F.four_step_stage2(a, rows_impl="pallas")
    assert calls == [(4096, 4096), (4096, 4096)]
    F.four_step_stage2(F.four_step_stage1(x), rows_impl="xla")
    assert len(calls) == 2


@pytest.mark.parametrize("name", sorted(RFFT))
def test_rfft_via_c2c(ref, name):
    """The packed half-size C2C and the Hermitian post, m + 1 or m bins;
    the reference's tolerance (rtol 1e-3, atol 2e-2 sqrt(n))."""
    log2n, four_step, drop = RFFT[name]
    n = 1 << log2n
    got = F.rfft_via_c2c(torch.from_numpy(_real(n, log2n)),
                         use_four_step=four_step, drop_nyquist=drop).numpy()
    assert got.shape == (n // 2 if drop else n // 2 + 1,)
    np.testing.assert_allclose(got, ref[f"rfft/{name}"], rtol=FFT_RTOL,
                               atol=2e-2 * np.sqrt(n))


@pytest.mark.parametrize("name", sorted(REFFT))
def test_ifft_refft_waterfall(ref, name):
    """Inverse C2C, the reserved tail trimmed, chunked forward C2C (with
    the window), time-major; the reference's tolerance (rtol 1e-3, atol
    0.5)."""
    spec, channels, reserved, window = _refft_args(name)
    got = F.ifft_refft_waterfall(
        torch.from_numpy(spec), channels, reserved,
        None if window is None else torch.from_numpy(window)).numpy()
    want = ref[f"refft/{name}"]
    assert got.shape == want.shape == ((spec.size - reserved) // channels,
                                       channels)
    np.testing.assert_allclose(got, want, rtol=FFT_RTOL, atol=REFFT_ATOL)


def test_dedisperse(ref):
    """One complex multiply a channel: within rtol 1e-6 and 1e-6 of the
    largest value of the reference's."""
    got = dd.dedisperse(torch.from_numpy(DD_SPEC),
                        torch.from_numpy(DD_CHIRP)).numpy()
    want = ref["dedisperse"]
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_supervisor_remaining(ref):
    """The budget left in the window, old restarts expired first, read
    for read the reference's."""
    got = remaining_script("srtb_tpu_torch", 3, 10.0, SUPERVISOR_STEPS)
    np.testing.assert_array_equal(got["reads"], ref["remaining/reads"])
    assert list(got["reads"]) == [3, 1, 1, 1, 1, 0, 0, 1, 3, 3, 1, 2]


def test_rung_name_native_available_and_logger():
    """``Rung.name`` is its step; ``native_available`` says whether the
    writer library builds here (a pool then runs on it, else refuses);
    ``get_logger`` is the process-wide logger."""
    from srtb_tpu_torch.resilience.demote import Rung
    from srtb_tpu_torch.utils import get_logger, log
    assert Rung("staged", None, True).name == "staged"
    assert get_logger() is log
    if native_writer.native_available():
        with native_writer.AsyncWriterPool(1) as pool:
            assert pool.is_native
    else:
        with pytest.raises((OSError, RuntimeError)):
            native_writer.AsyncWriterPool(1)


@pytest.mark.parametrize("late", [False, True])
def test_sync_with_deadline_on_deadline(late):
    """``on_deadline`` runs in the abort's place once the sync outlasts
    its deadline, and never when it returns in time."""
    import threading
    from srtb_tpu_torch.pipeline.runtime import sync_with_deadline
    fired = threading.Event()

    def fn():
        if late:
            assert fired.wait(10.0)
        return 7

    assert sync_with_deadline(0.05, fn, on_deadline=fired.set) == 7
    assert fired.wait(0.2) is late
