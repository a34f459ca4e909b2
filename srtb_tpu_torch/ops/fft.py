"""FFT layer (port of ``srtb_tpu/ops/fft.py``).

Conventions from the reference, kept exactly:
- forward transforms are unnormalized (cuFFT style);
- "backward" C2C is the unnormalized inverse.  ``torch.fft.ifft`` scales
  by 1/n by default; the unnormalized form is ``norm="forward"``;
- the R2C output drops the Nyquist bin, so the spectrum has exactly n/2
  channels (ref: fft_pipe.hpp:75-77);
- the waterfall reshapes the n/2-channel spectrum to
  ``[channel_count, n / 2 / channel_count]`` (each row a contiguous coarse
  sub-band) and runs the backward C2C along rows (ref:
  fft_pipe.hpp:295-311): a frequency-major dynamic spectrum.

Who runs a batch of rows (``rows_impl``) follows the reference's
``_fft_minor``: ``"pallas"`` hands rows whose length lies in the row-FFT
kernels' window (2^12 ... 2^16) to B6 (``kernels/fft_rows.py``) and
decomposes longer rows with the four-step algorithm; ``"xla"`` rows, and
rows outside the window, go to ``torch.fft`` (cuFFT on the card), where
the reference hands them to XLA.  cuFFT plans any length directly, so the
reference's XLA length cap, a TPU limit, only shapes the ``"pallas"``
plans, where it decides which kernels run.  The ``"pallas2"`` strategy
hands a segment-sized C2C (2^24 ... 2^29 points) to the two-pass kernels
B9/B10 (``kernels/fft2.py``) and shorter ones to the ``"pallas"`` form,
by the reference's rule; ``"mxu"`` (DFT-matrix matmuls in the reference,
no Pallas kernel) is one ``torch.fft`` call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srtb_tpu_torch.kernels import fft2 as K2
from srtb_tpu_torch.kernels import fft_rows as KF
from srtb_tpu_torch.kernels.fft2 import twiddle

# Longest row the "pallas" plans hand to a row kernel before the four-step
# decomposition (the reference's _XLA_FFT_LEN_CAP; Config.fft_len_cap
# overrides it there and here).
FFT_LEN_CAP = 1 << 16

# Packed C2C length (n/2) above which "auto" resolves to four_step (the
# reference's LARGE_FFT_THRESHOLD).
LARGE_FFT_THRESHOLD = 1 << 28


def rfft_drop_nyquist(x: torch.Tensor) -> torch.Tensor:
    """R2C of the whole segment, highest bin dropped: n real samples ->
    n/2 complex channels (ref: fft_pipe.hpp:44-78).  The result is a
    contiguous view of the first n/2 bins."""
    return torch.fft.rfft(x)[..., :-1]


def c2c_backward(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unnormalized inverse C2C (cuFFT BACKWARD semantics)."""
    return torch.fft.ifft(x, dim=dim, norm="forward")


def waterfall_c2c(spectrum: torch.Tensor, channel_count: int,
                  dewindow: torch.Tensor | None = None) -> torch.Tensor:
    """Dedispersed spectrum [..., n/2] -> dynamic spectrum
    ``[..., channel_count, watfft_len]`` by a per-row unnormalized backward
    C2C (ref: fft_pipe.hpp:285-372), then the window divided back out
    (``dewindow`` from ``window.dewindow_coefficients``: zero hann edges
    already replaced by 1)."""
    wf = c2c_backward(waterfall_rows(spectrum, channel_count))
    if dewindow is not None:
        wf = wf / dewindow
    return wf


def waterfall_rows(spectrum: torch.Tensor, channel_count: int
                   ) -> torch.Tensor:
    """The spectrum's first channel_count * watfft_len bins as rows
    ``[..., channel_count, watfft_len]``."""
    watfft_len = spectrum.shape[-1] // channel_count
    x = spectrum[..., :channel_count * watfft_len]
    return x.reshape(*spectrum.shape[:-1], channel_count, watfft_len)


# ---------------------------------------------------------------- rows

def fft_minor(x: torch.Tensor, inverse: bool, rows_impl: str = "xla",
              len_cap: int | None = None) -> torch.Tensor:
    """Unnormalized C2C along the last axis (the reference's
    ``_fft_minor``).  ``rows_impl = "pallas"``: rows longer than
    ``len_cap`` (default 2^16) recurse into :func:`four_step_fft`, rows in
    the kernels' window run B6, shorter rows ``torch.fft``.
    ``rows_impl = "xla"``: ``torch.fft`` at any length."""
    if rows_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown rows impl {rows_impl!r}")
    length = x.shape[-1]
    if rows_impl == "pallas":
        if length > (len_cap or FFT_LEN_CAP):
            return four_step_fft(x, inverse, rows_impl, len_cap)
        if KF.supported(length, x.numel() // length):
            return KF.fft_rows(x.contiguous(), inverse)
    return KF.fft_rows_plain(x, inverse)


def _split_factor(n: int) -> int:
    """n1 ~ sqrt(n), a power of two (n a power of two)."""
    return 1 << ((n.bit_length() - 1) // 2)


def four_step_fft(x: torch.Tensor, inverse: bool = False,
                  rows_impl: str = "xla",
                  len_cap: int | None = None) -> torch.Tensor:
    """1-D C2C of power-of-two length n = n1 n2 (leading dims batch) by
    the four-step algorithm, as the reference spells it: view [n1, n2],
    transpose, FFT_n1 rows, twiddle, transpose, FFT_n2 rows, transpose.
    The rows go through :func:`fft_minor` (B6 legs under "pallas"); the
    transposes and the twiddle are plain torch."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError("four_step_fft requires power-of-two length")
    n1 = _split_factor(n)
    n2 = n // n1
    a = x.reshape(*x.shape[:-1], n1, n2).transpose(-1, -2).contiguous()
    a = fft_minor(a, inverse, rows_impl, len_cap)        # A[j2, k1]
    a = a * twiddle(n2, n1, inverse, a.device)
    a = a.transpose(-1, -2).contiguous()                 # [k1, j2]
    a = fft_minor(a, inverse, rows_impl, len_cap)        # C[k1, k2]
    return a.transpose(-1, -2).reshape(*x.shape[:-1], n)


# ------------------------------------------------- R2C via half-size C2C

def pack_even_odd(x: torch.Tensor) -> torch.Tensor:
    """2m reals -> m complex (even samples -> re, odd -> im), for the
    half-size C2C form of the R2C."""
    if x.shape[-1] % 2:
        raise ValueError("even length required")
    return torch.view_as_complex(
        x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2).contiguous())


@functools.lru_cache(maxsize=4)
def _hermitian_weights(m: int, device: torch.device):
    """(A, B) = ((1 - i w^k) / 2, (1 + i w^k) / 2), w = exp(-2 pi i / 2m),
    k <= m, float64-built: X[k] = A[k] F[k] + B[k] conj F[m-k]."""
    k = torch.arange(m + 1, dtype=torch.float64, device=device)
    iw = 1j * torch.polar(torch.ones_like(k), k * (-np.pi / m))
    return ((0.5 * (1 - iw)).to(torch.complex64),
            (0.5 * (1 + iw)).to(torch.complex64))


def hermitian_rfft_post(zf: torch.Tensor, drop_nyquist: bool = False,
                        epilogue=None) -> torch.Tensor:
    """Hermitian post-process of the packed half-size C2C F [..., m] ->
    the 2m-real R2C X (ref: fft/fft_1d_r2c_post_process.hpp:33-82):
    X[k] = (F[k] + conj F[m-k]) / 2 - i w^k (F[k] - conj F[m-k]) / 2, with
    w = exp(-2 pi i / 2m) and F[m] = F[0]; m + 1 bins, or the m-bin
    drop-Nyquist form.  Spelled X = A F + B conj F[m-k] with cached
    weights.

    ``epilogue``: optional ``f(zf, spec) -> spec`` applied to the assembled
    spectrum — the fused spectrum tail's hook (``zf`` is passed so it can
    take the stage-1 mean power by Parseval, ``rfi.mean_power_packed``)."""
    m = zf.shape[-1]
    bins = m if drop_nyquist else m + 1
    # G[k] = conj F[(m - k) mod m], k < bins
    g = torch.empty(*zf.shape[:-1], bins, dtype=zf.dtype, device=zf.device)
    torch.conj_physical(zf[..., :1], out=g[..., :1])
    torch.conj_physical(torch.flip(zf[..., 1:], (-1,)), out=g[..., 1:m])
    if not drop_nyquist:
        g[..., m:] = g[..., :1]
    f = zf if drop_nyquist else torch.cat([zf, zf[..., :1]], -1)
    a, b = _hermitian_weights(m, zf.device)
    # not addcmul_: PyTorch compiles its complex form at the first call on
    # a card (0.58 s on an H100), once per process
    out = torch.mul(f, a[:bins]).add_(g.mul_(b[:bins]))
    if epilogue is not None:
        out = epilogue(zf, out)
    return out


def subbyte_window_planes(window: np.ndarray, nbits: int) -> np.ndarray:
    """A sample-order window [n] as blocked field planes [8/nbits, n/(8/
    nbits)] matching ``unpack.unpack_subbyte_planes`` (host-side)."""
    count = 8 // nbits
    return np.ascontiguousarray(np.asarray(window).reshape(-1, count).T)


def subbyte_planes_to_packed(planes: torch.Tensor) -> torch.Tensor:
    """Blocked field planes [..., count, M] -> packed plane pairs
    z [..., count/2, M]: z[k'] = planes[2k'] + i planes[2k'+1], which is
    the half-size sequence x[2t] + i x[2t+1] held blocked."""
    return torch.complex(planes[..., 0::2, :], planes[..., 1::2, :])


def rfft_subbyte(z: torch.Tensor, strategy: str = "four_step",
                 drop_nyquist: bool = True, len_cap: int | None = None,
                 epilogue=None) -> torch.Tensor:
    """The sub-byte R2C from the packed plane pairs ``z [p, M]`` (B13's
    output, or ``subbyte_planes_to_packed`` of the unpacked planes): the
    M-point FFT of each plane by ``strategy`` (:func:`plane_fft`), then
    :func:`finish_rfft_subbyte`.  The blocked layout is the four-step's
    [j2, j1] layout after its first transpose, so the natural-order
    spectrum comes out without any interleave."""
    a = plane_fft(z, strategy, len_cap)
    return finish_rfft_subbyte(a, drop_nyquist, epilogue=epilogue)


def plane_fft(z: torch.Tensor, strategy: str,
              len_cap: int | None = None) -> torch.Tensor:
    """The forward C2C along the last axis of the packed planes, as the
    reference's ``rfft_subbyte`` runs it for each strategy: "pallas" the
    four-step with B6 legs (:func:`fft_minor`), "pallas2" the two-pass
    kernels B9/B10 (:func:`pallas2_or_fallback`), "four_step" and "mxu"
    one ``torch.fft`` call (the reference's XLA FFT and DFT-matrix
    matmuls; neither is a Pallas kernel)."""
    if strategy == "pallas":
        return fft_minor(z, inverse=False, rows_impl="pallas",
                         len_cap=len_cap)
    if strategy == "pallas2":
        return pallas2_or_fallback(z, len_cap)
    if strategy in ("four_step", "mxu"):
        return fft_minor(z, inverse=False)
    raise ValueError(f"unknown plane FFT strategy {strategy!r}")


def pallas2_or_fallback(z: torch.Tensor,
                        len_cap: int | None = None) -> torch.Tensor:
    """The reference's ``_pallas2_or_fallback``: the two-pass C2C
    (``kernels/fft2.fft2_c2c``, B9 + B10 + unblock) for lengths in its
    window 2^24 ... 2^29, else the four-step with B6 legs — its dispatch by
    size, not a fallback on failure."""
    if K2.supported(z.shape[-1]):
        return K2.fft2_c2c(z)
    return fft_minor(z, inverse=False, rows_impl="pallas", len_cap=len_cap)


def finish_rfft_subbyte(a: torch.Tensor, drop_nyquist: bool = True,
                        epilogue=None) -> torch.Tensor:
    """From the per-plane FFTs a [..., p, M]: the twiddle
    exp(-2 pi i j2 k1 / m), the p-point DFT across planes, the natural
    order flatten and the Hermitian post-process."""
    p, m_bytes = a.shape[-2], a.shape[-1]
    if p > 1:
        # the twiddle's row 0 is all ones: only planes 1 ... p-1 take it
        b = a[..., 1:, :] * twiddle(p, m_bytes, False, a.device, 1)
        wp = np.exp(-2j * np.pi * np.outer(np.arange(p), np.arange(p))
                    / p).astype(np.complex64)
        z = torch.empty_like(a)
        for k2 in range(p):
            torch.add(a[..., 0, :], b[..., 0, :], alpha=complex(wp[k2, 1]),
                      out=z[..., k2, :])
            for j in range(2, p):
                z[..., k2, :].add_(b[..., j - 1, :], alpha=complex(wp[k2, j]))
        a = z
    zf = a.reshape(*a.shape[:-2], p * m_bytes)
    return hermitian_rfft_post(zf, drop_nyquist, epilogue=epilogue)


# ------------------------------------------------------ segment strategy

def resolve_strategy(n: int, strategy: str) -> str:
    """"auto" -> the reference's choice for n samples: monolithic through
    n = 2^29, four_step above (its LARGE_FFT_THRESHOLD)."""
    if strategy == "auto":
        return "four_step" if n // 2 > LARGE_FFT_THRESHOLD else "monolithic"
    return strategy


def segment_rfft(x: torch.Tensor, strategy: str = "auto",
                 len_cap: int | None = None, epilogue=None) -> torch.Tensor:
    """The segment R2C with the drop-Nyquist convention, by strategy:
    "monolithic" one cuFFT R2C (cannot host an epilogue, as in the
    reference); otherwise the packed half-size C2C and the Hermitian
    post-process, the C2C by "four_step" and "mxu" one cuFFT call,
    "pallas" :func:`four_step_fft` on B6 legs, "pallas2"
    :func:`pallas2_or_fallback` (B9/B10 in their window)."""
    strategy = resolve_strategy(x.shape[-1], strategy)
    if strategy == "monolithic":
        if epilogue is not None:
            raise ValueError("the monolithic R2C cannot host a spectrum "
                             "epilogue")
        return rfft_drop_nyquist(x)
    z = pack_even_odd(x)
    if strategy == "pallas":
        zf = four_step_fft(z, rows_impl="pallas", len_cap=len_cap)
    elif strategy == "pallas2":
        zf = pallas2_or_fallback(z, len_cap)
    elif strategy in ("four_step", "mxu"):
        zf = fft_minor(z, inverse=False)
    else:
        raise ValueError(f"unknown fft strategy {strategy!r}")
    return hermitian_rfft_post(zf, drop_nyquist=True, epilogue=epilogue)
