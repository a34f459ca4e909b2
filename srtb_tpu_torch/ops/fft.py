"""FFT layer, main-path subset (port of ``srtb_tpu/ops/fft.py``).

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

All transforms run on ``torch.fft`` (cuFFT on the card).  The reference's
four-step decomposition worked around the TPU's FFT length limits; cuFFT
plans the production 2^30-point R2C and 2^18-point rows directly.
"""

from __future__ import annotations

import torch


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
    n = spectrum.shape[-1]
    watfft_len = n // channel_count
    x = spectrum[..., :channel_count * watfft_len]
    x = x.reshape(*spectrum.shape[:-1], channel_count, watfft_len)
    wf = c2c_backward(x)
    if dewindow is not None:
        wf = wf / dewindow
    return wf
