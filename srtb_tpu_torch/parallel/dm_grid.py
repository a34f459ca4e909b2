"""The DM-trial search on one card (port of ``srtb_tpu/parallel/dm_grid.py``).

Every trial applies a different chirp to the same cleaned spectrum, then
runs the waterfall C2C, the spectral-kurtosis zap and the detection.  The
reference shards the trials over the ``dm`` axis of a device mesh and
reads each trial's chirp from a bank ``[n_dm, 2, n_spectrum]``; on one
card the trials run one after the other into one reused buffer, and the
chirp is B3 (``kernels/dedisperse.dedisperse``), which makes the trial's
phase in the kernel, so no bank is built on the device
(``build_chirp_bank`` keeps the reference's host bank for the tests).
Only the small per-trial summaries and the time series are kept.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srtb_tpu_torch.kernels.dedisperse import dedisperse
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.ops import fft as F
from srtb_tpu_torch.ops import rfi


class DMTrialResult(NamedTuple):
    dm_list: np.ndarray           # [n_dm] host
    zero_count: torch.Tensor      # [n_dm]
    signal_counts: torch.Tensor   # [n_dm, n_boxcars]
    snr_peaks: torch.Tensor       # [n_dm, n_boxcars]
    time_series: torch.Tensor     # [n_dm, T] mean-subtracted boxcar-1 series


def build_chirp_bank(dm_list, n_spectrum: int, f_min: float, df: float,
                     f_c: float) -> np.ndarray:
    """The reference's host chirp bank: [n_dm, 2, n_spectrum] (re, im)
    float32, each trial's float64 chirp cast to float32."""
    bank = [dd.chirp_factor_host(n_spectrum, f_min, df, f_c, dm)
            for dm in np.asarray(dm_list, dtype=np.float64)]
    return np.stack([np.stack([c.real, c.imag]) for c in bank]) \
        .astype(np.float32)


def dm_trial_search(spectrum: torch.Tensor, dm_list, *, f_min: float,
                    df: float, f_c: float, channel_count: int,
                    time_reserved_count: int, snr_threshold: float,
                    max_boxcar_length: int, sk_threshold: float,
                    dewindow: torch.Tensor | None = None) -> DMTrialResult:
    """Run the DM grid on one segment's RFI-cleaned spectrum ``spectrum``
    (complex64 [n_spectrum]): per trial B3 at the trial's DM into one
    buffer, then the waterfall C2C with ``dewindow`` (the reference runs
    XLA there, so torch here), the SK zap and the detection."""
    buf = torch.empty_like(spectrum)
    zero, counts, peaks, series = [], [], [], []
    for dm in np.asarray(dm_list, dtype=np.float64):
        dedisperse(spectrum, f_min, df, f_c, float(dm), out=buf)
        wf = F.waterfall_c2c(buf, channel_count, dewindow)
        wf = rfi.mitigate_rfi_spectral_kurtosis(wf, sk_threshold)
        r = det.detect(wf, time_reserved_count, snr_threshold,
                       max_boxcar_length)
        del wf
        zero.append(r.zero_count)
        counts.append(r.signal_counts)
        peaks.append(r.snr_peaks)
        series.append(r.time_series)
    return DMTrialResult(dm_list=np.asarray(dm_list),
                         zero_count=torch.stack(zero),
                         signal_counts=torch.stack(counts),
                         snr_peaks=torch.stack(peaks),
                         time_series=torch.stack(series))


def best_trial(result: DMTrialResult) -> tuple[int, float]:
    """(index, peak SNR) of the strongest trial across all boxcars."""
    peaks = result.snr_peaks
    if isinstance(peaks, torch.Tensor):
        peaks = peaks.detach().cpu().numpy()
    peaks = np.asarray(peaks)
    idx = int(np.argmax(peaks.max(axis=-1)))
    return idx, float(peaks[idx].max())
