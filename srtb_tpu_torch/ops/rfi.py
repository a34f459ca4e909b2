"""RFI mitigation (port of ``srtb_tpu/ops/rfi.py``).

- stage 1: average-intensity threshold zap with the normalization fused in
  (ref: pipeline/rfi_mitigation_pipe.hpp:50-80);
- manual frequency-range zap from a "a-b, c-d" config string
  (ref: spectrum/rfi_mitigation.hpp:63-158);
- stage 2: spectral-kurtosis zap over the dynamic spectrum
  (ref: spectrum/rfi_mitigation.hpp:290-341).

On the main path stage 1, the manual mask and the chirp run fused in
kernel K2 (``kernels/rfi_chirp.py``) and stage 2 in K3/K4
(``kernels/sk.py``); the functions here are the plain forms.
"""

from __future__ import annotations

import numpy as np
import torch

from srtb_tpu_torch.utils.logging import log


def power(c: torch.Tensor) -> torch.Tensor:
    """|c|^2 like srtb::norm (ref: math.hpp:58-70), each product and the
    sum rounded separately (the kernels round the same way)."""
    return c.real * c.real + c.imag * c.imag


def mean_power(spectrum: torch.Tensor) -> torch.Tensor:
    """Mean |x|^2 over the last axis, keepdims, as one reduction with no
    spectrum-sized temporary (the squared norm of the re/im view)."""
    n = spectrum.shape[-1]
    norm = torch.linalg.vector_norm(torch.view_as_real(spectrum),
                                    dim=(-2, -1), keepdim=True)[..., 0]
    return norm * norm / n


def mitigate_rfi_average_and_normalize(
        spectrum: torch.Tensor, threshold: float,
        normalization_coefficient: float) -> torch.Tensor:
    """Zap channels whose power exceeds ``threshold * mean power``; scale
    the survivors by the normalization coefficient
    (ref: rfi_mitigation_pipe.hpp:50-80)."""
    return mitigate_rfi_s1_given_mean(spectrum, mean_power(spectrum),
                                      threshold, normalization_coefficient)


def mitigate_rfi_s1_given_mean(spectrum: torch.Tensor,
                               mean_power: torch.Tensor, threshold: float,
                               normalization_coefficient: float
                               ) -> torch.Tensor:
    """The elementwise half of stage 1 with the mean power supplied by the
    caller (the fused spectrum tail takes it from
    :func:`mean_power_packed`)."""
    zap = power(spectrum) > np.float32(threshold) * mean_power
    return torch.where(zap, torch.zeros((), dtype=spectrum.dtype,
                                        device=spectrum.device),
                       spectrum * np.float32(normalization_coefficient))


def mean_power_packed(zf: torch.Tensor) -> torch.Tensor:
    """Mean |X_k|^2 over the m drop-Nyquist R2C bins, from the packed
    half-size C2C output ``zf [..., m]`` without forming the spectrum
    (keepdims ``[..., 1]``).  Parseval and the Hermitian symmetry of the
    real input give sum_k |X_k|^2 = sum_k |F_k|^2 + 2 Re F_0 Im F_0."""
    m = zf.shape[-1]
    norm = torch.linalg.vector_norm(torch.view_as_real(zf), dim=(-2, -1),
                                    keepdim=True)[..., 0]
    f0 = zf[..., :1]
    return (norm * norm + 2.0 * f0.real * f0.imag) / m


def normalization_coefficient(n_channels: int,
                              spectrum_channel_count: int) -> float:
    """(N^2/spectrum_channel_count)^-0.5 in f32, matching the reference's
    float evaluation (ref: rfi_mitigation_pipe.hpp:61-65)."""
    n = np.float32(n_channels)
    return float(np.power(n * n / np.float32(spectrum_channel_count),
                          np.float32(-0.5)))


# ----------------------------------------------------------------
# manual frequency-range zap
# ----------------------------------------------------------------

def eval_rfi_ranges(mitigate_rfi_freq_list: str) -> list[tuple[float, float]]:
    """Parse "11-12, 15-90" into (low, high) MHz pairs
    (ref: spectrum/rfi_mitigation.hpp:63-88)."""
    ranges = []
    text = mitigate_rfi_freq_list.strip()
    if not text:
        return ranges
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        pieces = [p for p in part.split("-") if p.strip()]
        if len(pieces) != 2:
            log.warning(f"[eval_rfi_ranges] cannot parse {part!r}")
            continue
        ranges.append((float(pieces[0]), float(pieces[1])))
    return ranges


def rfi_ranges_to_mask(ranges, n_channels: int, baseband_freq_low: float,
                       baseband_bandwidth: float) -> np.ndarray | None:
    """Host-side boolean zap mask over bins, or None when nothing is
    zapped.  bin = round((f - f_low) / bw * (N-1)), inclusive on both
    ends, range order flipped for inverted bands
    (ref: spectrum/rfi_mitigation.hpp:102-143)."""
    if not ranges:
        return None
    mask = np.zeros(n_channels, dtype=bool)
    bw_sign = np.signbit(baseband_bandwidth)
    freq_high = baseband_freq_low + baseband_bandwidth
    any_zap = False
    for rfi_low, rfi_high in ranges:
        if np.signbit(rfi_high - rfi_low) != bw_sign:
            rfi_low, rfi_high = rfi_high, rfi_low
        lo = int(round((rfi_low - baseband_freq_low) / baseband_bandwidth
                       * (n_channels - 1)))
        hi = int(round((rfi_high - baseband_freq_low) / baseband_bandwidth
                       * (n_channels - 1)))
        if 0 <= lo <= hi < n_channels:
            mask[lo:hi + 1] = True
            any_zap = True
        else:
            log.warning(
                f"[mitigate_rfi_manual] RFI range {rfi_low} - {rfi_high} MHz "
                f"out of baseband range {baseband_freq_low} - {freq_high} MHz")
    return mask if any_zap else None


def mitigate_rfi_manual(spectrum: torch.Tensor,
                        zap_mask: torch.Tensor | None) -> torch.Tensor:
    """Apply a zap mask (ref: rfi_mitigation.hpp:97-158)."""
    if zap_mask is None:
        return spectrum
    return torch.where(zap_mask, torch.zeros((), dtype=spectrum.dtype,
                                             device=spectrum.device),
                       spectrum)


# ----------------------------------------------------------------
# spectral kurtosis (stage 2)
# ----------------------------------------------------------------

def sk_decision_thresholds(m: int, sk_threshold: float):
    """(low, high) acceptance bounds for the SK estimator over M samples:
    the threshold symmetrized around 2, rescaled by (M-1)/(M+1)
    (ref: spectrum/rfi_mitigation.hpp:290-341)."""
    thr_high = max(sk_threshold, 2.0 - sk_threshold)
    thr_low = min(sk_threshold, 2.0 - sk_threshold)
    scale = (m - 1.0) / (m + 1.0)
    return (np.float32(thr_low * scale + 1.0),
            np.float32(thr_high * scale + 1.0))


def sk_zap_decision(s2: torch.Tensor, s4: torch.Tensor, m: int,
                    sk_threshold: float) -> torch.Tensor:
    """Per-row zap verdict from the power moments s2 = sum |x|^2 and
    s4 = sum |x|^4 over M samples."""
    thr_low, thr_high = sk_decision_thresholds(m, sk_threshold)
    sk = m * s4 / (s2 * s2)
    return (sk > float(thr_high)) | (sk < float(thr_low))


def mitigate_rfi_spectral_kurtosis(waterfall: torch.Tensor,
                                   sk_threshold: float) -> torch.Tensor:
    """Zap frequency rows of the dynamic spectrum ``[..., freq, time]``
    whose spectral kurtosis lies outside the decision bounds."""
    p = power(waterfall)
    zap = sk_zap_decision(p.sum(-1), (p * p).sum(-1), waterfall.shape[-1],
                          sk_threshold)
    return torch.where(zap[..., None],
                       torch.zeros((), dtype=waterfall.dtype,
                                   device=waterfall.device), waterfall)
