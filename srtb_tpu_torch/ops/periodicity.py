"""Periodicity search: harmonic-summed power spectrum + phase folding
(port of ``srtb_tpu/ops/periodicity.py``).

After dedispersion a pulsar's pulse train concentrates its power at the
spin frequency and its harmonics of the time-series power spectrum.  The
search, per data stream:

1. **power spectrum** of the (mean-subtracted) dedispersed time series:
   one rFFT of ``T`` samples, the DC bin zeroed;
2. **incoherent harmonic summing**: for each fundamental bin ``k`` the
   power at ``j*k`` summed for ``j = 1..h`` over the ladder ``h = 1, 2,
   4, ...``;
3. **candidate selection**: each level normalized to unit variance over
   the searched bins, the best level per bin, the top K bins;
4. **phase folding** of the time series at each candidate's period into
   ``n_bins`` phase bins.

Every function takes the streams (and candidates) on leading axes, so
one call covers ``[S, T]``.  Two choices keep the results the
reference's, bit for bit where it is integer, on the card too:

- the top K comes from a stable descending sort, so among equal scores
  the lower bin comes first, as ``jax.lax.top_k`` returns them
  (``torch.topk`` promises no order for ties on CUDA);
- the fold adds in an order fixed by the shape: a stable sort of the
  phase index, a float64 row scan of the sorted series
  (``detect._row_scan``) and differences at the bins' edges, where the
  reference's scatter-add (``index_add_`` or ``bincount`` on the card)
  would add in an order that changes from run to run.

The phase index follows the reference's uint32 arithmetic exactly (each
product wrapped to 32 bits), and the same ``ValueError`` refuses a
non-power-of-two series long enough for the wrap to corrupt it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srtb_tpu_torch.ops.detect import _row_scan

U32 = (1 << 32) - 1


class PeriodicityCandidates(NamedTuple):
    """Static-shape periodicity result, batched over leading axes."""
    bins: torch.Tensor        # [..., K] int32: fundamental bin per candidate
    snr: torch.Tensor         # [..., K] f32: harmonic-summed, normalized SNR
    harmonics: torch.Tensor   # [..., K] int32: harmonic count that maximized
    profiles: torch.Tensor    # [..., K, n_bins] f32: folded pulse profiles


def harmonic_levels(max_harmonics: int) -> tuple:
    """Static harmonic-count ladder 1, 2, 4, ... <= max (>= (1,))."""
    levels = [1]
    h = 2
    while h <= int(max_harmonics):
        levels.append(h)
        h *= 2
    return tuple(levels)


def power_spectrum(ts: torch.Tensor) -> torch.Tensor:
    """Time series [..., T] (already mean-subtracted) -> power [..., M],
    the one-sided rFFT power with the DC bin zeroed."""
    spec = torch.fft.rfft(ts.to(torch.float32))
    power = spec.real * spec.real + spec.imag * spec.imag
    power[..., 0] = 0.0
    return power


def harmonic_sum(power: torch.Tensor, levels: tuple) -> torch.Tensor:
    """Incoherent harmonic sums ``[n_levels, ..., M]``: row ``i`` holds
    ``sum_{j=1..levels[i]} power[min(j*k, M-1)]`` per fundamental bin
    ``k``, added in the reference's order."""
    m = power.shape[-1]
    k = torch.arange(m, device=power.device)
    rows = []
    acc = power
    j = 1
    for h in levels:
        while j < h:
            j += 1
            acc = acc + power[..., torch.clamp(k * j, max=m - 1)]
        rows.append(acc)
    return torch.stack(rows)


def candidate_search(ts: torch.Tensor, levels: tuple, top_k: int,
                     min_bin: int = 2):
    """Harmonic-summed candidate selection over the time series [..., T].
    Returns ``(bins [..., K] i32, snr [..., K] f32, harm [..., K] i32)``
    ranked by normalized SNR; bins below ``min_bin`` are excluded.
    ``levels`` is a ladder of :func:`harmonic_levels` (1, 2, 4, ...)."""
    if tuple(levels) != tuple(1 << i for i in range(len(levels))):
        raise ValueError(f"levels must be 1, 2, 4, ..., got {levels}")
    power = power_spectrum(ts)
    m = power.shape[-1]
    sums = harmonic_sum(power, levels)                 # [L, ..., M]
    valid = (torch.arange(m, device=ts.device) >= min_bin).to(torch.float32)
    n_valid = torch.clamp(valid.sum(), min=1.0)
    mean = (sums * valid).sum(dim=-1, keepdim=True) / n_valid
    var = (((sums - mean) * valid) ** 2).sum(dim=-1, keepdim=True) / n_valid
    snr_l = (sums - mean) / torch.sqrt(torch.clamp(var, min=1e-30))
    snr_l = torch.where(valid > 0, snr_l,
                        torch.full((), -torch.inf, device=ts.device))
    best, best_level = torch.max(snr_l, dim=0)         # [..., M]
    k = min(int(top_k), m)
    snr, bins = torch.sort(best, dim=-1, descending=True, stable=True)
    snr, bins = snr[..., :k], bins[..., :k]
    # the ladder is 1, 2, 4, ...: level i counts 2^i harmonics
    harm = 2 ** torch.gather(best_level, -1, bins)
    return bins.to(torch.int32), snr.to(torch.float32), harm.to(torch.int32)


def check_fold_length(t: int) -> None:
    """The reference's refusal: a non-power-of-two series long enough that
    its uint32 phase products ``i * k`` wrap."""
    if (t & (t - 1)) and t * (t // 2) >= (1 << 32):
        raise ValueError(
            f"fold: time series length {t} is non-power-of-two and "
            "long enough that uint32 phase products wrap — reduce "
            "the series (spectrum_channel_count) below 2^16 samples "
            "or make it a power of two")


def phase_index(t: int, bin_k: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The phase bin ``(((i * k) mod T) * n_bins) // T`` of every sample
    i of a series of ``t`` for each bin in ``bin_k [...]``, as int64
    [..., T], each product wrapped to 32 bits as the reference's uint32
    arithmetic wraps it."""
    i = torch.arange(t, dtype=torch.int64, device=bin_k.device)
    k = bin_k.to(torch.int64)[..., None] & U32
    r = ((i * k) & U32) % t
    return ((r * n_bins) & U32) // t


def fold(ts: torch.Tensor, bin_k: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Phase-fold the time series ``ts [..., T]`` at the period of
    power-spectrum bin ``bin_k [..., K]`` (cycles per ``T`` samples; the
    leading axes of both agree): ``[..., K, n_bins]`` f32 profiles, each
    bin the mean of its samples (bins no sample lands in read 0).  The
    sums run in an order fixed by the shape (module docstring)."""
    t = ts.shape[-1]
    check_fold_length(t)
    idx = phase_index(t, bin_k, n_bins)                  # [..., K, T]
    order = torch.sort(idx, dim=-1, stable=True)
    vals = torch.gather(ts[..., None, :].to(torch.float64).expand(
        idx.shape), -1, order.indices)
    lead = vals.shape[:-1]
    rows = vals.reshape(-1, t)
    csum = torch.cat([torch.zeros_like(rows[:, :1]), _row_scan(rows)],
                     dim=-1).reshape(*lead, t + 1)
    edges = torch.arange(n_bins + 1, dtype=torch.int64, device=ts.device)
    ends = torch.searchsorted(order.values.contiguous(),
                              edges.expand(*lead, n_bins + 1).contiguous())
    sums = (torch.gather(csum, -1, ends[..., 1:])
            - torch.gather(csum, -1, ends[..., :-1])).to(torch.float32)
    counts = (ends[..., 1:] - ends[..., :-1]).to(torch.float32)
    return sums / torch.clamp(counts, min=1.0)


def periodicity_search(ts: torch.Tensor, max_harmonics: int, top_k: int,
                       n_bins: int,
                       min_bin: int = 2) -> PeriodicityCandidates:
    """The whole periodicity module on ``ts [..., T]``: harmonic-summed
    candidate selection and a folded profile per candidate."""
    levels = harmonic_levels(max_harmonics)
    bins, snr, harm = candidate_search(ts, levels, top_k, min_bin=min_bin)
    return PeriodicityCandidates(bins=bins, snr=snr, harmonics=harm,
                                 profiles=fold(ts, bins, n_bins))


# ----------------------------------------------------------------
# numpy golden model (for tests)
# ----------------------------------------------------------------

def periodicity_oracle(ts: np.ndarray, max_harmonics: int, top_k: int,
                       n_bins: int, min_bin: int = 2):
    """Reference-faithful numpy recomputation of the search above on one
    series ``ts [T]``."""
    spec = np.fft.rfft(ts.astype(np.float32))
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    power[0] = 0.0
    m = power.shape[-1]
    levels = harmonic_levels(max_harmonics)
    k = np.arange(m)
    rows, acc, j = [], power.copy(), 1
    for h in levels:
        while j < h:
            j += 1
            acc = acc + power[np.minimum(k * j, m - 1)]
        rows.append(acc.copy())
    sums = np.stack(rows)
    valid = k >= min_bin
    mean = sums[:, valid].mean(axis=-1, keepdims=True)
    sig = np.maximum(sums[:, valid].std(axis=-1, keepdims=True), 1e-15)
    snr_l = (sums - mean) / sig
    snr_l[:, ~valid] = -np.inf
    best = snr_l.max(axis=0)
    order = np.argsort(-best, kind="stable")[:top_k]
    t = ts.shape[-1]
    profiles = []
    for b in order:
        idx = (((np.arange(t) * int(b)) % t) * n_bins) // t
        sums_b = np.zeros(n_bins, np.float32)
        counts = np.zeros(n_bins, np.float32)
        np.add.at(sums_b, idx, ts)
        np.add.at(counts, idx, 1.0)
        profiles.append(sums_b / np.maximum(counts, 1.0))
    harm = np.asarray(levels)[snr_l.argmax(axis=0)[order]]
    return (order.astype(np.int32), best[order].astype(np.float32),
            harm.astype(np.int32), np.stack(profiles))
