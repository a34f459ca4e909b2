"""The plain reference of one segment's search, in PyTorch.

A straightforward statement of what the backend computes for a segment
of raw baseband (the upstream srtb's chain, as the J1644-4559
configuration runs it), written from the semantics and not from the
program: it imports nothing of ``srtb_tpu_torch`` nor of the JAX package,
and takes from the benchmark only the segment's bytes and the
configuration's numbers.

1. unpack: 1/2/4-bit unsigned fields MSB-first, as floats (no window:
   the configuration's window is the rectangle);
2. R2C of the whole segment, the Nyquist bin dropped;
3. RFI stage 1: bins whose power exceeds ``threshold`` times the mean
   power are zeroed, the rest scaled by (N^2 / channels)^-1/2; then the
   manual frequency mask;
4. coherent dedispersion: each bin times exp(-2 pi i frac(k)), k = D 1e6
   dm (f - f_c)^2 / (f f_c^2);
5. the waterfall: the spectrum's bins as [channels, time] rows, each row
   an unnormalized backward C2C;
6. RFI stage 2: rows whose spectral kurtosis M s4 / s2^2 lies outside the
   bounds (the threshold symmetrized around 2, scaled by (M - 1) / (M +
   1), plus 1) are zeroed; a row within ``SK_BAND`` of a bound may be
   decided the way the judged side decided it (rounding decides it);
7. detection: zapped channels (time sample 0 exactly zero), the power
   time series summed over channels, its mean removed, and for boxcars
   1, 2, 4, ... up to the maximum, the count of samples above ``snr``
   times the series' RMS and the peak over that RMS.

``precision`` is "float64" (the reference) or "bfloat16" (the control:
every intermediate array stored in bfloat16, the arithmetic in float32,
the FFTs in float32 on the rounded values, since the FFT library has no
bfloat16 transform).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

D = 4.148808e3


@dataclass(frozen=True)
class Geometry:
    """The numbers of the configuration the chain reads."""
    n: int
    nbits: int
    channels: int
    freq_low: float
    bandwidth: float
    dm: float
    s1_threshold: float
    sk_threshold: float
    snr_threshold: float
    max_boxcar: int
    channel_threshold: float
    mask: tuple

    @classmethod
    def from_cfg(cls, cfg) -> "Geometry":
        return cls(
            n=int(cfg.baseband_input_count),
            nbits=int(cfg.baseband_input_bits),
            channels=int(cfg.spectrum_channel_count),
            freq_low=float(cfg.baseband_freq_low),
            bandwidth=float(cfg.baseband_bandwidth),
            dm=float(cfg.dm),
            s1_threshold=float(cfg.mitigate_rfi_average_method_threshold),
            sk_threshold=float(cfg.mitigate_rfi_spectral_kurtosis_threshold),
            snr_threshold=float(cfg.signal_detect_signal_noise_threshold),
            max_boxcar=int(cfg.signal_detect_max_boxcar_length),
            channel_threshold=float(cfg.signal_detect_channel_threshold),
            mask=tuple(parse_ranges(cfg.mitigate_rfi_freq_list)))


def parse_ranges(text: str) -> list:
    """"a-b, c-d" as [(a, b), (c, d)] in MHz."""
    out = []
    for part in str(text or "").split(","):
        bits = [p for p in part.strip().split("-") if p.strip()]
        if len(bits) == 2:
            out.append((float(bits[0]), float(bits[1])))
    return out


class Precision:
    """Where the chain rounds: nowhere past float64 for the reference,
    every stored array to bfloat16 for the control."""

    def __init__(self, name: str):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.real = torch.float64 if name == "float64" else torch.float32
        self.complex = (torch.complex128 if name == "float64"
                        else torch.complex64)

    def store(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float64":
            return x
        if x.is_complex():
            r = torch.view_as_real(x).to(torch.bfloat16).to(torch.float32)
            return torch.view_as_complex(r.contiguous())
        return x.to(torch.bfloat16).to(torch.float32)


def unpack(raw: torch.Tensor, nbits: int, dtype) -> torch.Tensor:
    per = 8 // nbits
    shifts = torch.arange(per - 1, -1, -1, device=raw.device) * nbits
    fields = (raw.to(torch.int32)[:, None] >> shifts) & ((1 << nbits) - 1)
    return fields.reshape(-1).to(dtype)


def mask_bins(geo: Geometry, m: int) -> np.ndarray | None:
    """The manual mask over the m bins: bin = round((f - f_low) / bw (m -
    1)), both ends in, the range's ends swapped for an inverted band."""
    if not geo.mask:
        return None
    keep = np.ones(m, dtype=bool)
    any_zap = False
    for lo_f, hi_f in geo.mask:
        if np.signbit(hi_f - lo_f) != np.signbit(geo.bandwidth):
            lo_f, hi_f = hi_f, lo_f
        lo = int(round((lo_f - geo.freq_low) / geo.bandwidth * (m - 1)))
        hi = int(round((hi_f - geo.freq_low) / geo.bandwidth * (m - 1)))
        if 0 <= lo <= hi < m:
            keep[lo:hi + 1] = False
            any_zap = True
    return keep if any_zap else None


def chirp_phase_turns(m: int, geo: Geometry, dm: float, device
                      ) -> torch.Tensor:
    """-frac(k) per bin, float64."""
    i = torch.arange(m, dtype=torch.float64, device=device)
    f_c = geo.freq_low + geo.bandwidth
    f = geo.freq_low + (geo.bandwidth / m) * i
    d = f - f_c
    k = (D * 1e6 * dm / (f_c * f_c)) * (d * d) / f
    return -(k - torch.trunc(k))


def spectrum(raw: torch.Tensor, geo: Geometry, prec: Precision
             ) -> torch.Tensor:
    """Steps 1-3: the cleaned spectrum [m], before the chirp."""
    m = geo.n // 2
    x = unpack(raw, geo.nbits, prec.real)
    spec = prec.store(torch.fft.rfft(x)[:m])
    del x
    power = spec.real * spec.real + spec.imag * spec.imag
    mean = power.sum() / m
    norm = (float(m) * float(m) / geo.channels) ** -0.5
    zap = power > geo.s1_threshold * mean
    del power
    spec = torch.where(zap, torch.zeros((), dtype=spec.dtype,
                                        device=spec.device), spec * norm)
    keep = mask_bins(geo, m)
    if keep is not None:
        spec = spec * torch.from_numpy(keep).to(spec.device)
    return prec.store(spec)


def dedisperse(spec: torch.Tensor, geo: Geometry, dm: float,
               prec: Precision) -> torch.Tensor:
    """Step 4."""
    turns = chirp_phase_turns(spec.shape[-1], geo, dm, spec.device)
    ang = (2.0 * math.pi) * turns
    chirp = torch.polar(torch.ones_like(ang), ang).to(prec.complex)
    del turns, ang
    return prec.store(spec * prec.store(chirp))


def pre_waterfall(spec: torch.Tensor, geo: Geometry, prec: Precision
                  ) -> torch.Tensor:
    """Step 5: the waterfall [channels, time], before the SK zap."""
    f = geo.channels
    t = spec.shape[-1] // f
    rows = spec[:f * t].reshape(f, t)
    return prec.store(torch.fft.ifft(rows, dim=-1, norm="forward"))


def sk_decide(wf: torch.Tensor, geo: Geometry
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 6's decision: the rows to zap, and each row's margin, the
    relative distance of its spectral kurtosis to the nearer bound."""
    t = wf.shape[-1]
    p = wf.real * wf.real + wf.imag * wf.imag
    s2 = p.sum(-1)
    s4 = (p * p).sum(-1)
    del p
    scale = (t - 1.0) / (t + 1.0)
    hi = max(geo.sk_threshold, 2.0 - geo.sk_threshold) * scale + 1.0
    lo = min(geo.sk_threshold, 2.0 - geo.sk_threshold) * scale + 1.0
    sk = t * s4 / (s2 * s2)
    zap = (sk > hi) | (sk < lo)
    margin = torch.minimum((sk - hi).abs() / hi, (sk - lo).abs() / lo)
    return zap, margin


def explain_zaps(zap: torch.Tensor, margin: torch.Tensor, zero: torch.Tensor,
                 target: int, band: float) -> torch.Tensor:
    """The reference's decision moved towards ``target`` zero rows (a
    side's own count of rows whose first sample is zero: the zapped ones
    and those already zero, ``zero``) by flipping the rows nearest a
    bound, as long as each lies within ``band`` of it: such a row's
    verdict is rounding's to decide, any other difference is the side's
    own.  Returns the zap set to judge that side against."""
    d = int(target) - int((zap | zero).sum())
    if d == 0:
        return zap
    pool = (~zap & ~zero) if d > 0 else (zap & ~zero)
    cand = torch.nonzero(pool).reshape(-1)
    order = cand[torch.argsort(margin[cand])][:abs(d)]
    order = order[margin[order] < band]
    out = zap.clone()
    out[order] = d > 0
    return out


def waterfall(spec: torch.Tensor, geo: Geometry, prec: Precision,
              zero_hint: int | None = None) -> torch.Tensor:
    """Steps 5-6: the SK-zapped waterfall [channels, time]; with
    ``zero_hint`` (the count of zapped rows a side reported), the rows
    within ``SK_BAND`` of a bound decided its way (:func:`explain_zaps`)."""
    wf = pre_waterfall(spec, geo, prec)
    zap, margin = sk_decide(wf, geo)
    if zero_hint is not None:
        p0 = wf[:, 0]
        zero = (p0.real * p0.real + p0.imag * p0.imag) == 0
        zap = explain_zaps(zap, margin, zero, zero_hint, SK_BAND)
    return prec.store(torch.where(zap[:, None], torch.zeros(
        (), dtype=wf.dtype, device=wf.device), wf))


# rows whose spectral kurtosis lies within this relative distance of a
# bound may go either way under rounding; samples of a boxcar series
# within COUNT_BAND of the detection threshold likewise
SK_BAND = 1e-4
COUNT_BAND = 1e-4


def boxcars(max_len: int, t: int) -> list:
    out, b = [1], 2
    while b <= max_len and b < t:
        out.append(b)
        b *= 2
    return out


@dataclass
class Detection:
    zero_count: int
    time_series: np.ndarray    # float64 [t], mean removed
    boxcars: list
    signal_counts: np.ndarray  # [n_boxcars]
    snr_peaks: np.ndarray      # [n_boxcars]
    # samples within COUNT_BAND of the threshold, a boxcar: a count may
    # differ from the reference's by as many
    ambiguous: np.ndarray | None = None

    def positive(self, geo: Geometry) -> bool:
        ok = self.zero_count < geo.channel_threshold * geo.channels
        return bool(ok and self.signal_counts.sum() > 0)


def detect(wf: torch.Tensor, geo: Geometry, prec: Precision) -> Detection:
    """Step 7 (the segment reserves no samples, so nothing is trimmed)."""
    p0 = wf[:, 0]
    zero_count = int(((p0.real * p0.real + p0.imag * p0.imag) == 0).sum())
    ts = prec.store((wf.real * wf.real + wf.imag * wf.imag).sum(0))
    ts = ts - ts.mean()
    t = ts.shape[-1]
    lengths = boxcars(geo.max_boxcar, t)
    acc = torch.cumsum(ts, 0)
    counts, peaks, amb = [], [], []
    for b in lengths:
        s = ts if b == 1 else acc[b:] - acc[:-b]
        s = prec.store(s)
        sigma = torch.sqrt(torch.mean(s * s))
        thr = geo.snr_threshold * sigma
        counts.append(int((s > thr).sum()))
        amb.append(int(((s - thr).abs() < COUNT_BAND * thr).sum()))
        peaks.append(float(s.max() / torch.clamp(sigma, min=1e-30)))
    return Detection(zero_count, ts.double().cpu().numpy(), lengths,
                     np.asarray(counts), np.asarray(peaks), np.asarray(amb))


def run_segment(raw: torch.Tensor, geo: Geometry, precision: str,
                keep_waterfall: bool = False, zero_hint: int | None = None):
    """One segment's detection (and its waterfall, complex64 on the host,
    when asked) from its raw bytes on the device; ``zero_hint`` as in
    :func:`waterfall`."""
    prec = Precision(precision)
    wf = waterfall(dedisperse(spectrum(raw, geo, prec), geo, geo.dm, prec),
                   geo, prec, zero_hint)
    det = detect(wf, geo, prec)
    host = wf.to(torch.complex64).cpu().numpy() if keep_waterfall else None
    return det, host


def run_dm_trials(raw: torch.Tensor, geo: Geometry, dm_list,
                  precision: str, zero_hints=None) -> list:
    """The DM search of one segment: the cleaned spectrum once, then per
    trial the chirp at its DM, the waterfall and the detection."""
    prec = Precision(precision)
    spec = spectrum(raw, geo, prec)
    out = []
    for i, dm in enumerate(dm_list):
        hint = None if zero_hints is None else int(zero_hints[i])
        wf = waterfall(dedisperse(spec, geo, float(dm), prec), geo, prec,
                       hint)
        out.append(detect(wf, geo, prec))
        del wf
    return out
