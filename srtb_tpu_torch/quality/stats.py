"""Per-segment data-quality statistics on the device (port of
``srtb_tpu/quality/stats.py``).

One small ``[S, N_SCALARS + 2*B]`` float32 vector a segment says how the
signal looked: which bins the RFI stages zapped, how the bandpass is
shaped, whether channels died or went hot, how non-Gaussian each channel
is.  The segment processor computes it from buffers its chain already
holds, in two halves so that no spectrum outlives its chain
(``pipeline/segment.py``): :func:`spectrum_stats` reads the spectrum after
RFI stage 1 and the manual mask, :func:`waterfall_stats` the waterfall
after the SK zap, and :func:`pack_stats` joins them.
:func:`quality_stats_device` is the two in one call, the reference's
function.

Packed layout per stream (``B = quality_coarse_bins``)::

    [0]            zap_frac        fraction of spectrum bins zeroed
    [1]            bandpass_mean   mean of the coarse bandpass vector
    [2]            bandpass_var    population variance of the same
    [3]            sk_mean         mean spectral-kurtosis estimate
                                   over waterfall channels (M = T)
    [4]            sk_max          max SK estimate over channels
    [5]            dead_frac       channels with mean power below
                                   quality_dead_threshold x median
    [6]            hot_frac        channels with mean power above
                                   quality_hot_threshold x median
    [7 : 7+B]      occupancy map   zero-fraction per coarse spectrum bin
    [7+B : 7+2B]   bandpass        mean |spec|^2 per coarse bin

Powers are formed in float32 as the reference's (``re*re + im*im``); the
reductions accumulate in float64 and the vector is cast to float32 last,
so the device vector follows the float64 golden model
:func:`quality_stats_oracle`: the zero counts behind ``zap_frac`` and the
occupancy row, and the channel counts behind ``dead_frac`` and
``hot_frac``, are exact.  :class:`QualityMonitor` is the host side: the
``quality_*`` gauges, the EWMA bandpass-drift detector
(``quality_drift_score``, ``quality_drift_alerts``), the per-segment
dict (the journal's ``quality`` section) and a bounded timeline.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from srtb_tpu_torch.utils.metrics import metrics

# scalar slots ahead of the two coarse maps (see module docstring)
IDX_ZAP_FRAC = 0
IDX_BANDPASS_MEAN = 1
IDX_BANDPASS_VAR = 2
IDX_SK_MEAN = 3
IDX_SK_MAX = 4
IDX_DEAD_FRAC = 5
IDX_HOT_FRAC = 6
N_SCALARS = 7
# the scalar fields' gauges (the reference's names)
SCALAR_GAUGES = (
    ("quality_zap_fraction", IDX_ZAP_FRAC),
    ("quality_bandpass_mean", IDX_BANDPASS_MEAN),
    ("quality_bandpass_var", IDX_BANDPASS_VAR),
    ("quality_sk_mean", IDX_SK_MEAN),
    ("quality_sk_max", IDX_SK_MAX),
    ("quality_dead_frac", IDX_DEAD_FRAC),
    ("quality_hot_frac", IDX_HOT_FRAC),
)

DEFAULT_COARSE_BINS = 64


def vector_length(coarse_bins: int) -> int:
    return N_SCALARS + 2 * int(coarse_bins)


def _coarse_split(n_spec: int, coarse_bins: int) -> tuple[int, int]:
    """(B, bins_per_coarse): clamp B to the spectrum length and round the
    spectrum down to an exact tiling (the truncated remainder, at most B-1
    bins, is outside every statistic, zap_frac included)."""
    b = max(1, min(coarse_bins, n_spec))
    return b, n_spec // b


def _power(x: torch.Tensor) -> torch.Tensor:
    """float32 |x|^2 of a complex view, each product and the sum rounded
    apart."""
    return x.real * x.real + x.imag * x.imag


def spectrum_stats(spec: torch.Tensor, coarse_bins: int,
                   subsample: int = 1) -> torch.Tensor:
    """The spectrum half of the vector from ``spec [S, n_spec]`` complex
    (after RFI stage 1 and the manual mask; zapped bins exactly zero):
    float64 ``[S, 3 + 2B]`` = (zap_frac, bandpass_mean, bandpass_var,
    occupancy[B], bandpass[B]).  ``subsample = k`` reads every k-th bin
    of each coarse bin."""
    n_streams, n_spec = spec.shape[0], spec.shape[-1]
    b, per = _coarse_split(n_spec, coarse_bins)
    k = max(1, int(subsample))
    p = _power(spec[..., :b * per].reshape(n_streams, b, per)[..., ::k])
    m = p.shape[-1]
    zeros = torch.sum(p == 0, dim=-1, dtype=torch.int64)        # [S, B]
    occupancy = zeros.to(torch.float64) / m
    zap_frac = zeros.sum(dim=-1).to(torch.float64) / (b * m)     # [S]
    bandpass = torch.sum(p, dim=-1, dtype=torch.float64) / m     # [S, B]
    del p
    bp_mean = bandpass.mean(dim=-1)
    bp_var = ((bandpass - bp_mean[:, None]) ** 2).mean(dim=-1)
    return torch.cat([torch.stack([zap_frac, bp_mean, bp_var], dim=-1),
                      occupancy, bandpass], dim=-1)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, keepdims, the two middle values averaged
    when the count is even (``jnp.median``; ``torch.median`` returns the
    lower one)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return ((s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5)[..., None]


def waterfall_stats(wf: torch.Tensor, dead_threshold: float,
                    hot_threshold: float,
                    subsample: int = 1) -> torch.Tensor:
    """The waterfall half of the vector from ``wf [S, F, T]`` complex
    (after the SK zap; zapped channels are zero rows): float64 ``[S, 4]``
    = (sk_mean, sk_max, dead_frac, hot_frac).  ``subsample = k`` reads
    every k-th time sample of each channel."""
    k = max(1, int(subsample))
    wf_s = wf[..., ::k]
    m = wf_s.shape[-1]
    p = _power(wf_s)
    mean_p = torch.sum(p, dim=-1, dtype=torch.float64) / m          # [S, F]
    mean_p2 = torch.sum(p * p, dim=-1, dtype=torch.float64) / m
    del p
    # spectral kurtosis per channel over M sampled accumulations; a
    # zapped (zero) channel reads 0 by convention, not NaN
    live = mean_p > 0
    denom = torch.where(live, mean_p * mean_p, torch.ones_like(mean_p))
    sk = torch.where(live,
                     ((m + 1.0) / max(m - 1.0, 1.0)) * (mean_p2 / denom - 1.0),
                     torch.zeros_like(mean_p))
    med = _median(mean_p)
    dead = (mean_p < dead_threshold * med).to(torch.float64).mean(dim=-1)
    hot = (mean_p > hot_threshold * med).to(torch.float64).mean(dim=-1)
    return torch.stack([sk.mean(dim=-1), sk.max(dim=-1).values, dead, hot],
                       dim=-1)


def pack_stats(spec_half: torch.Tensor,
               wf_half: torch.Tensor) -> torch.Tensor:
    """The two halves -> the packed float32 ``[S, 7 + 2B]`` vector."""
    b = (spec_half.shape[-1] - 3) // 2
    return torch.cat([spec_half[:, :3], wf_half, spec_half[:, 3:3 + b],
                      spec_half[:, 3 + b:]], dim=-1).to(torch.float32)


def quality_stats_device(spec: torch.Tensor, wf: torch.Tensor,
                         coarse_bins: int, dead_threshold: float,
                         hot_threshold: float,
                         subsample: int = 1) -> torch.Tensor:
    """Pack the per-stream quality vector on the tensors' device.

    ``spec [S, n_spec]`` complex: the dedispersed spectrum after RFI stage
    1 and the manual mask (zapped bins are exactly zero; the chirp is
    unit-modulus and keeps them).  ``wf [S, F, T]`` complex: the waterfall
    after the SK zap.  Returns ``[S, N_SCALARS + 2*B]`` float32.
    ``subsample = k`` reads every k-th bin within each coarse bin and
    every k-th time sample of each channel (exact at k = 1)."""
    return pack_stats(spectrum_stats(spec, coarse_bins, subsample),
                      waterfall_stats(wf, dead_threshold, hot_threshold,
                                      subsample))


def quality_stats_oracle(spec: np.ndarray, wf: np.ndarray,
                         coarse_bins: int, dead_threshold: float,
                         hot_threshold: float,
                         subsample: int = 1) -> np.ndarray:
    """Float64 NumPy golden model of :func:`quality_stats_device`
    (``subsample`` must match the device call's)."""
    spec = np.asarray(spec)
    wf = np.asarray(wf)
    n_streams, n_spec = spec.shape[0], spec.shape[-1]
    b, per = _coarse_split(n_spec, coarse_bins)
    k = max(1, int(subsample))

    spec_s = spec[..., :b * per].reshape(n_streams, b, per)[..., ::k]
    p_spec = np.abs(spec_s.astype(np.complex128)) ** 2
    zero = (p_spec == 0).astype(np.float64)
    bandpass = p_spec.mean(axis=-1)
    occupancy = zero.mean(axis=-1)
    zap_frac = occupancy.mean(axis=-1)
    bp_mean = bandpass.mean(axis=-1)
    bp_var = ((bandpass - bp_mean[:, None]) ** 2).mean(axis=-1)

    wf_s = wf[..., ::k]
    p_wf = np.abs(wf_s.astype(np.complex128)) ** 2
    m = wf_s.shape[-1]
    mean_p = p_wf.mean(axis=-1)
    mean_p2 = (p_wf * p_wf).mean(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        sk = np.where(
            mean_p > 0,
            ((m + 1.0) / max(m - 1.0, 1.0))
            * (mean_p2 / np.where(mean_p > 0, mean_p ** 2, 1.0) - 1.0),
            0.0)
    sk_mean = sk.mean(axis=-1)
    sk_max = sk.max(axis=-1)
    med = np.median(mean_p, axis=-1, keepdims=True)
    dead_frac = (mean_p < dead_threshold * med).mean(axis=-1)
    hot_frac = (mean_p > hot_threshold * med).mean(axis=-1)

    scalars = np.stack([zap_frac, bp_mean, bp_var, sk_mean, sk_max,
                        dead_frac, hot_frac], axis=-1)
    return np.concatenate([scalars, occupancy, bandpass],
                          axis=-1).astype(np.float32)


def unpack_stats(vec: np.ndarray) -> dict:
    """Packed vector (``[S, 7+2B]`` or ``[7+2B]``) -> named arrays.  B is
    recovered from the length (the layout is self-describing given
    N_SCALARS)."""
    v = np.asarray(vec)
    if v.ndim == 1:
        v = v[None, :]
    b = (v.shape[-1] - N_SCALARS) // 2
    return {
        "zap_frac": v[:, IDX_ZAP_FRAC],
        "bandpass_mean": v[:, IDX_BANDPASS_MEAN],
        "bandpass_var": v[:, IDX_BANDPASS_VAR],
        "sk_mean": v[:, IDX_SK_MEAN],
        "sk_max": v[:, IDX_SK_MAX],
        "dead_frac": v[:, IDX_DEAD_FRAC],
        "hot_frac": v[:, IDX_HOT_FRAC],
        "occupancy": v[:, N_SCALARS:N_SCALARS + b],
        "bandpass": v[:, N_SCALARS + b:N_SCALARS + 2 * b],
    }


class EWMADrift:
    """Exponentially-weighted drift detector on one scalar series.

    Tracks an EWMA mean and an EWM variance; an observation scoring more
    than ``threshold`` sigmas from the running mean is a drift alert.  The
    first ``warmup`` observations only train the estimates (score 0).  The
    estimates keep updating through an alert, so a persistent level shift
    is absorbed after ~1/alpha segments: the alert marks the transition."""

    def __init__(self, alpha: float = 0.05, threshold: float = 4.0,
                 warmup: int = 8):
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.warmup = int(warmup)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def observe(self, x: float) -> tuple[float, bool]:
        """(drift score in sigmas, alert?) — then fold ``x`` in."""
        x = float(x)
        if self.n == 0:
            # seed the mean at the first observation, so the series' DC
            # level never enters the variance
            self.mean = x
        if self.n < self.warmup:
            score, alert = 0.0, False
        else:
            # sigma floor: a perfectly constant warmup must not make the
            # first real fluctuation infinite
            sigma = max(math.sqrt(max(self.var, 0.0)),
                        1e-12 + 1e-6 * abs(self.mean))
            score = abs(x - self.mean) / sigma
            alert = score > self.threshold
        d = x - self.mean
        self.mean += self.alpha * d
        self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1
        return score, alert


TIMELINE_SPANS = 64


class QualityMonitor:
    """Host-side consumer of the packed quality vector: the gauges (with
    their ``stream``-labeled twins for a named stream), the bandpass
    drift detector, the per-segment dict (the reference's journal dict)
    and a bounded timeline.  ``None`` when ``Config.quality_stats`` is
    off."""

    def __init__(self, drift_alpha: float = 0.05,
                 drift_threshold: float = 4.0, stream: str = ""):
        self.drift = EWMADrift(alpha=drift_alpha,
                               threshold=drift_threshold)
        self.stream = str(stream or "")
        self._timeline: collections.deque = collections.deque(
            maxlen=TIMELINE_SPANS)

    @classmethod
    def from_config(cls, cfg) -> "QualityMonitor | None":
        if not cfg.quality_stats:
            return None
        return cls(drift_alpha=float(cfg.quality_drift_alpha),
                   drift_threshold=float(cfg.quality_drift_threshold),
                   stream=str(cfg.stream_name or ""))

    def observe(self, qvec, segment: int = -1) -> dict:
        """One drained segment's vector -> its dict.  Multi-stream
        segments are averaged across S (the packed vector keeps each
        stream's)."""
        v = np.asarray(qvec, dtype=np.float64)
        if v.ndim == 1:
            v = v[None, :]
        mean = v.mean(axis=0)
        score, alert = self.drift.observe(mean[IDX_BANDPASS_MEAN])
        lbl = {"stream": self.stream} if self.stream else None
        for gname, idx in SCALAR_GAUGES:
            metrics.set(gname, float(mean[idx]))
            if lbl:
                metrics.set(gname, float(mean[idx]), labels=lbl)
        metrics.set("quality_drift_score", score)
        if lbl:
            metrics.set("quality_drift_score", score, labels=lbl)
        if alert:
            metrics.add("quality_drift_alerts")
            if lbl:
                metrics.add("quality_drift_alerts", labels=lbl)
        b = (mean.shape[0] - N_SCALARS) // 2
        out = {
            "zap_frac": round(float(mean[IDX_ZAP_FRAC]), 5),
            "bandpass_mean": round(float(mean[IDX_BANDPASS_MEAN]), 5),
            "bandpass_var": round(float(mean[IDX_BANDPASS_VAR]), 5),
            "sk_mean": round(float(mean[IDX_SK_MEAN]), 5),
            "sk_max": round(float(mean[IDX_SK_MAX]), 5),
            "dead_frac": round(float(mean[IDX_DEAD_FRAC]), 5),
            "hot_frac": round(float(mean[IDX_HOT_FRAC]), 5),
            "drift_score": round(score, 3),
            "drift_alert": bool(alert),
            "occupancy": np.round(
                mean[N_SCALARS:N_SCALARS + b], 4).tolist(),
            "bandpass": np.round(
                mean[N_SCALARS + b:N_SCALARS + 2 * b], 5).tolist(),
        }
        self._timeline.append(dict(out, segment=int(segment)))
        return out

    def timeline(self) -> list[dict]:
        """Recent per-segment quality dicts, oldest first (bounded)."""
        return list(self._timeline)
