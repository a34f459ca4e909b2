"""Single-pulse signal detection (port of ``srtb_tpu/ops/detect.py``).

Mirrors signal_detect_pipe_2 (ref: pipeline/signal_detect_pipe.hpp:244-443)
and count_signal (ref: signal_detect.hpp:32-72) with static shapes: a
``[n_boxcars]`` vector of detection counts plus the candidate time
series, and the host decides what to write out.

Per segment, waterfall ``[freq, time]``:
1. zapped-channel count (time-0 sample exactly zero);
2. trim the reserved tail: T = time - nsamps_reserved / freq_bins;
3. time series = sum over frequency of |x|^2;
4. subtract the mean;
5. sigma-threshold count at boxcar length 1;
6. boxcar matched filtering by prefix-sum differences for lengths
   2, 4, ..., max_boxcar_length, each counted again.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def tree_sum_freq(power: torch.Tensor) -> torch.Tensor:
    """Sum ``power [..., K, T]`` over axis -2 by a pairwise tree
    K -> K/2 -> ... -> 1 (odd levels carry their last row), the same
    order as the reference, so the rounding bound is deterministic:
    |err| <= (ceil(log2 K) + 1) * eps * sum for nonnegative summands."""
    k = power.shape[-2]
    t = power.shape[-1]
    lead = power.shape[:-2]
    carry = None
    while k > 1:
        if k % 2:
            last = power[..., -1:, :]
            carry = last if carry is None else carry + last
            power = power[..., :-1, :]
            k -= 1
        power = power.reshape(*lead, k // 2, 2, t)
        power = power[..., 0, :] + power[..., 1, :]
        k //= 2
    out = power[..., 0, :]
    if carry is not None:
        out = out + carry[..., 0, :]
    return out


class DetectResult(NamedTuple):
    """Static-shape detection result, batched over data streams [S]."""
    zero_count: torch.Tensor         # [S] int: zapped frequency channels
    time_series: torch.Tensor        # [S, T] f32, mean-subtracted
    boxcar_lengths: tuple            # (1, 2, 4, ..., max)
    signal_counts: torch.Tensor      # [S, n_boxcars] int32
    boxcar_series: torch.Tensor      # [S, n_boxcars, T] f32, zero tail
    snr_peaks: torch.Tensor          # [S, n_boxcars] f32
    # the quality vector [S, 7 + 2B] f32 when Config.quality_stats is on
    # (quality/stats.py), else None
    quality: torch.Tensor | None = None


def time_series_error_gates(k_ch: int, t_len: int, ts_raw_max: float,
                            wf_err_abs: float) -> tuple:
    """Absolute error bounds for the detection time series, by cause:
    ``(ts_sum_gate, ts_prop_gate)`` — the float32 summation error of the
    pairwise frequency sum and mean, and the waterfall's own error
    ``wf_err_abs`` propagated through |.|^2 and the channel sum (see the
    reference's derivation in srtb_tpu/ops/detect.py)."""
    eps = 2.0 ** -24
    levels = (int(np.ceil(np.log2(max(k_ch, 2))))
              + int(np.ceil(np.log2(max(t_len, 2)))) + 5)
    ts_sum_gate = 2.0 * levels * eps * ts_raw_max
    ts_prop_gate = 2.0 * (
        2.0 * wf_err_abs * float(np.sqrt(k_ch * ts_raw_max))
        + k_ch * wf_err_abs ** 2)
    return ts_sum_gate, ts_prop_gate


def tree_mean(ts: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis via the pairwise tree, shape [..., 1]."""
    return tree_sum_freq(ts[..., :, None]) / ts.shape[-1]


def boxcar_lengths(max_boxcar_length: int, time_series_count: int) -> tuple:
    """1, then 2, 4, ... while <= max and < T
    (ref: signal_detect_pipe.hpp:387-389)."""
    lengths = [1]
    b = 2
    while b <= max_boxcar_length and b < time_series_count:
        lengths.append(b)
        b *= 2
    return tuple(lengths)


def count_signal(x: torch.Tensor, snr_threshold: float):
    """Count samples with x > threshold * sqrt(mean(x^2)), mean(x) = 0
    assumed (ref: signal_detect.hpp:32-72).  Returns (count, peak_snr)."""
    sigma = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True))
    thr = np.float32(snr_threshold) * sigma
    count = torch.sum((x > thr).to(torch.int32), dim=-1, dtype=torch.int32)
    peak = (torch.amax(x, dim=-1, keepdim=True)
            / torch.clamp(sigma, min=1e-30))[..., 0]
    return count, peak


def trimmed_length(time_samples: int, time_reserved_count: int) -> int:
    """Usable time samples after dropping the reserved tail; everything
    when the segment is too short (ref: signal_detect_pipe.hpp:291-296)."""
    if time_samples <= time_reserved_count:
        return time_samples
    return time_samples - time_reserved_count


def detect(waterfall: torch.Tensor, time_reserved_count: int,
           snr_threshold: float, max_boxcar_length: int) -> DetectResult:
    """Full detection chain on a frequency-major dynamic spectrum
    ``[S, F, T]``."""
    t = trimmed_length(waterfall.shape[-1], time_reserved_count)
    p0 = waterfall[..., 0]
    zero_count = torch.sum((p0.real * p0.real + p0.imag * p0.imag == 0)
                           .to(torch.int32), dim=-1, dtype=torch.int32)
    w = waterfall[..., :t]
    ts = tree_sum_freq(w.real * w.real + w.imag * w.imag)
    return detect_from_time_series(ts, zero_count, snr_threshold,
                                   max_boxcar_length)


# block length of :func:`cumsum_last`'s two-level scan on the card
SCAN_BLOCK = 1024


def _row_scan(rows: torch.Tensor) -> torch.Tensor:
    """cumsum along the last axis of ``rows [r, b]`` by PyTorch's row scan
    kernel, which adds in a fixed order; a zero row is appended so that
    even one row never takes the single-array scan."""
    two = torch.cat([rows, torch.zeros_like(rows[:1])])
    return torch.cumsum(two, dim=-1)[:rows.shape[0]]


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """cumsum over the last axis of a tensor that is one row: the row in
    blocks of ``SCAN_BLOCK`` by the row scan kernel, then the blocks'
    totals, scanned the same way, added to the blocks after the first.
    Every sum runs in an order fixed by the shape."""
    t = x.shape[-1]
    nblocks = -(-t // SCAN_BLOCK)
    flat = torch.nn.functional.pad(x.reshape(-1),
                                   (0, nblocks * SCAN_BLOCK - t))
    within = _row_scan(flat.view(nblocks, SCAN_BLOCK))
    totals = _row_scan(within[None, :, -1])[0]
    offsets = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]])
    return (within + offsets[:, None]).reshape(-1)[:t].reshape(x.shape)


def cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, -1)`` in an order fixed by the shape.  On the
    card a scan of a tensor that is one row goes to CUB's decoupled
    look-back scan, whose float rounding depends on which tiles finish
    first, so two runs of one segment could write different boxcar
    series: there it is :func:`blocked_cumsum`."""
    if x.device.type == "cuda" and x.numel() == x.shape[-1]:
        return blocked_cumsum(x)
    return torch.cumsum(x, dim=-1)


def detect_from_time_series(ts: torch.Tensor, zero_count: torch.Tensor,
                            snr_threshold: float,
                            max_boxcar_length: int) -> DetectResult:
    """Boxcar ladder from a (not yet mean-subtracted) power time series
    ``ts [..., t]`` — the tail of :func:`detect`, used by the SK kernel
    pair that already produced the time series."""
    t = ts.shape[-1]
    ts = ts - tree_mean(ts)
    lengths = boxcar_lengths(max_boxcar_length, t)
    acc = cumsum_last(ts)
    counts, peaks, rows = [], [], []
    for b in lengths:
        series = ts if b == 1 else acc[..., b:] - acc[..., :-b]
        c, p = count_signal(series, snr_threshold)
        counts.append(c)
        peaks.append(p)
        pad = t - series.shape[-1]
        if pad:
            series = torch.nn.functional.pad(series, (0, pad))
        rows.append(series)
    return DetectResult(
        zero_count=zero_count,
        time_series=ts,
        boxcar_lengths=lengths,
        signal_counts=torch.stack(counts, dim=-1),
        boxcar_series=torch.stack(rows, dim=-2),
        snr_peaks=torch.stack(peaks, dim=-1),
    )
