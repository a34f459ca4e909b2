"""B11 and B12, the two passes of the front-fused staged plan
(``front_fuse = on``).  On the CPU each wrapper runs its plain PyTorch
version, held here against the JAX package's ``pallas_fft2.pass1_front``,
``front_mean_power`` and ``pass2_spectrum`` in interpret mode on the same
inputs: the factorization, B11 at the small-leg splits of m = 2^15 and 2^16
for every unpack variant and width it reads, windowed and not, the
Parseval mean power, and B12 with the keep mask and the exact chirp, with
the premultiplied pair, and with neither.  The CUDA kernels are held
against these plain versions on the card by the ``cuda``-marked tests of
``test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from srtb_tpu_torch.kernels import fft2 as K2
from srtb_tpu_torch.kernels import fft2_front as FF
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import window as W
from test_torch_ref import run_reference

LOG2_FACTOR = range(6, 31)
MS = (1 << 15, 1 << 16)
VARIANTS = [("simple", b) for b in (1, 2, 4, 8, -8)] + [
    ("interleaved_samples_2", 8)]
# plus one case each at m = 2^24, the kernels' own (4096, 4096) split (the
# reference's interpret run takes about 12 s and 16 s there)
PASS1_CASES = [(m, v, b, w) for m in MS for v, b in VARIANTS
               for w in (False, True)] + [(1 << 24, "simple", 2, False)]
PASS2_FORMS = ("mask_chirp", "premul", "plain")
PASS2_CASES = [(m, f) for m in MS for f in PASS2_FORMS] + [
    (1 << 24, "mask_chirp")]
# the J1644-4559 band (example cfg) at a DM that winds the chirp over
# thousands of turns at these sizes
CHIRP = (1437.0, -64.0, 1373.0, -47.88)
NORM = 0.125


def _raw(m: int, variant: str, nbits: int) -> np.ndarray:
    size = FF.front_streams(variant) * 2 * m * abs(nbits) // 8
    seed = m + 10 * abs(nbits) + (nbits < 0) + 7 * len(variant)
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8)


def _window_eo(m: int) -> tuple[np.ndarray, np.ndarray]:
    n1, n2 = K2.ffuse_factor(m)
    w = W.window_coefficients("hamming", 2 * m)
    return tuple(np.ascontiguousarray(w[i::2].reshape(n1, n2))
                 for i in (0, 1))


def _intermediate(m: int) -> np.ndarray:
    n1, n2 = K2.ffuse_factor(m)
    rng = np.random.default_rng(m + 1)
    return (rng.standard_normal((n1, n2))
            + 1j * rng.standard_normal((n1, n2))).astype(np.complex64)


def _blocked(a: np.ndarray, m: int) -> np.ndarray:
    """natural [m] -> k1-major blocked [n1, n2] (bin k2 n1 + k1)."""
    n1, n2 = K2.ffuse_factor(m)
    return np.ascontiguousarray(a.reshape(n2, n1).T)


def _pass2_inputs(m: int, form: str) -> dict:
    """B12's optional inputs for a form, as numpy: the keep mask (5% of
    the bins zapped) with the chirp's constants, or the premul pair."""
    if form == "mask_chirp":
        keep = np.random.default_rng(m + 2).uniform(size=m) > 0.05
        f_min, bw, f_c, dm = CHIRP
        return {"keep": _blocked(keep, m),
                "chirp": (f_min, bw / m, f_c, dm)}
    if form == "premul":
        f_min, bw, f_c, dm = CHIRP
        c = dd.chirp_factor_host(m, f_min, bw / m, f_c, dm)
        w = np.exp(-1j * np.pi * np.arange(m) / m)
        return {"premul": (_blocked(c, m),
                           _blocked((c * w).astype(np.complex64), m))}
    return {}


def _threshold(m: int) -> float:
    """Three times the mean bin power of the spectrum of the noise
    intermediate (2 n2 a bin): about 5% of the bins zapped."""
    return 3.0 * 2.0 * K2.ffuse_factor(m)[1]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pf2 = "srtb_tpu.ops.pallas_fft2:"
    jobs = [{"key": f"factor/{e}", "fn": pf2 + "ffuse_factor",
             "args": [1 << e]} for e in LOG2_FACTOR]
    jobs += [{"key": "factor/odd", "fn": pf2 + "ffuse_factor",
              "args": [3 << 20]}]
    for m, variant, nbits, win in PASS1_CASES:
        jobs.append({"key": f"pass1/{m}/{variant}/{nbits}/{win}",
                     "fn": "test_torch_ref:pass1_front",
                     "args": [_raw(m, variant, nbits), m, variant, nbits,
                              _window_eo(m) if win else None]})
    for m, form in PASS2_CASES:
        b = _intermediate(m)
        inputs = _pass2_inputs(m, form)
        kwargs = {}
        if "keep" in inputs:
            kwargs["mask_blocked"] = inputs["keep"].astype(np.float32)
            f_min, df, f_c, dm = inputs["chirp"]
            kwargs["chirp"] = dict(f_min=f_min, df=df, f_c=f_c, dm=dm)
        if "premul" in inputs:
            kwargs["premul_blocked"] = tuple(
                np.ascontiguousarray(p.astype(np.complex64).view(
                    np.float32)[..., i::2]) for p in inputs["premul"]
                for i in (0, 1))
        jobs.append({"key": f"pass2/{m}/{form}",
                     "fn": "test_torch_ref:pass2_spectrum",
                     "args": [np.ascontiguousarray(b.real),
                              np.ascontiguousarray(b.imag), _threshold(m),
                              NORM], "kwargs": kwargs})
    return run_reference(jobs, tmp_path_factory.mktemp("ref_fft2_front"))


def _close(got: np.ndarray, want: np.ndarray, gate: float = 2e-5) -> None:
    """Within ``gate`` of the largest value: 2e-5 is the reference's own
    gate for the two-pass C2C (tests/test_pallas_fft2.py:48)."""
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= gate * np.abs(want).max()


def test_ffuse_factor_matches_reference(ref):
    """The same splits as the reference's ``ffuse_factor`` at every power
    of two 2^6 ... 2^30 and none for a length that is not one: the
    production window (4096 or 8192, n2) from 2^24, small legs (n1 <= 512,
    n2 >= 128) from 2^10, none below."""
    for e in LOG2_FACTOR:
        want = ref.get(f"factor/{e}")
        got = K2.ffuse_factor(1 << e)
        assert got == (None if want is None else tuple(want.tolist())), e
    assert "factor/odd" not in ref and K2.ffuse_factor(3 << 20) is None
    assert K2.ffuse_factor(1 << 15) == (128, 256)
    assert K2.ffuse_factor(1 << 29) == K2.factor(1 << 29) == (8192, 65536)


@pytest.mark.parametrize("m,variant,nbits,win", PASS1_CASES)
def test_pass1_front_plain_matches_pallas(ref, m, variant, nbits, win):
    """B11's plain version against ``pass1_front``: the intermediate of
    every stream within 2e-5 of the largest value, and
    :func:`front_mean_power` from the port's float64 sums within 1e-5
    relative of the reference's (its float32 accumulators)."""
    weo = None
    if win:
        weo = tuple(torch.from_numpy(w) for w in _window_eo(m))
    b, aux = FF.fft2_pass1_front(torch.from_numpy(_raw(m, variant, nbits)),
                                 m, variant, nbits, weo)
    key = f"pass1/{m}/{variant}/{nbits}/{win}"
    want = ref[f"{key}/br"] + 1j * ref[f"{key}/bi"]
    assert b.shape == (FF.front_streams(variant), *K2.ffuse_factor(m))
    _close(b.numpy(), want)
    mean = FF.front_mean_power(aux, K2.ffuse_factor(m)[1], m).numpy()
    want_mean = ref[f"{key}/mean"]
    assert mean.dtype == np.float32
    np.testing.assert_allclose(mean, want_mean, rtol=1e-5, atol=0)


@pytest.mark.parametrize("m,form", PASS2_CASES)
def test_pass2_spectrum_plain_matches_pallas(ref, m, form):
    """B12's plain version against ``pass2_spectrum`` on the same
    intermediate and threshold: the same zapped bins, except a bin whose
    power before the zap lies within float32 rounding (1e-5 relative) of
    the threshold, where the two row FFTs may round to either side (one
    bin of 2^24 here, none at the small splits); and the other bins
    within 5e-5 of the largest with the chirp (K2's gate: the reference's
    df64 phase against the port's float64 one) and 2e-5 with the premul
    pair or neither."""
    inputs = _pass2_inputs(m, form)
    kw = {}
    if "keep" in inputs:
        kw = {"keep": torch.from_numpy(inputs["keep"]),
              "chirp": inputs["chirp"]}
    if "premul" in inputs:
        kw = {"premul": tuple(torch.from_numpy(p) for p in inputs["premul"])}
    b = torch.from_numpy(_intermediate(m))
    thr = _threshold(m)
    got = FF.fft2_pass2_spectrum(
        b, torch.tensor([thr], dtype=torch.float32), NORM, **kw).numpy()
    want = ref[f"pass2/{m}/{form}/sr"] + 1j * ref[f"pass2/{m}/{form}/si"]
    flipped = (got == 0) != (want == 0)
    if flipped.any():
        x = FF.fft2_pass2_spectrum_plain(
            b, torch.tensor([np.inf], dtype=torch.float32), 1.0,
            premul=kw.get("premul")).numpy()[flipped]
        assert flipped.sum() <= 2
        assert np.all(np.abs(np.abs(x) ** 2 - thr) <= 1e-5 * thr)
    zapped = (got == 0).mean()
    assert 0.01 < zapped < (0.2 if "keep" in inputs else 0.1)
    _close(got[~flipped], want[~flipped], 5e-5 if "chirp" in kw else 2e-5)


def test_wrappers_check_their_inputs():
    """Variants and widths B11 does not read, lengths without a split, a
    raw segment of the wrong size, and premul with chirp raise; so does a
    CPU-sized split handed to the kernels' shape check."""
    raw = torch.zeros(1 << 13, dtype=torch.uint8)
    with pytest.raises(ValueError, match="variant"):
        FF.fft2_pass1_front(raw, 1 << 15, "interleaved_samples_2", 2)
    with pytest.raises(ValueError, match="variant"):
        FF.fft2_pass1_front(raw, 1 << 15, "naocpsr_snap1", -8)
    with pytest.raises(ValueError, match="length"):
        FF.fft2_pass1_front(raw, 3 << 12, "simple", 2)
    with pytest.raises(ValueError, match="raw must be"):
        FF.fft2_pass1_front(raw[1:], 1 << 15, "simple", 2)
    b = torch.zeros(128, 256, dtype=torch.complex64)
    thr = torch.ones(1)
    with pytest.raises(ValueError, match="not both"):
        FF.fft2_pass2_spectrum(b, thr, 1.0, premul=(b, b), chirp=CHIRP)
    with pytest.raises(ValueError, match="thr"):
        FF.fft2_pass2_spectrum(b, torch.ones(()), 1.0)
    with pytest.raises(ValueError, match="window"):
        FF._kernel_block(128, 256, "fft2_pass2_spectrum")
