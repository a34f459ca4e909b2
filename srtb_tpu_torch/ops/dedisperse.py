"""Coherent dedispersion: the frequency-domain chirp (port of
``srtb_tpu/ops/dedisperse.py``).

Physics as in the reference (ref: coherent_dedispersion.hpp):
``D = 4.148808e3`` MHz^2 pc^-1 cm^3 s, per-channel phase in turns

    k = D * 1e6 * dm / f * ((f - f_c) / f_c)^2        (phase_factor_v3)
    factor = exp(-2*pi*i * frac(k))

with ``frac`` taken before the trig because k reaches ~1e6 turns and more.
The TPU has no FP64, so the reference rebuilt k from two-float (df64)
arithmetic.  The H100 has native FP64, so the port computes k and
frac(k) in float64 directly and only then goes to float32 for the
cos/sin, as the reference's kernel does with its float32 phase.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# dispersion constant, MHz^2 pc^-1 cm^3 s (ref: coherent_dedispersion.hpp:67)
D = 4.148808e3


def dispersion_delay_time(f, f_c, dm):
    """Delay relative to f_c, seconds
    (ref: coherent_dedispersion.hpp:75-78)."""
    return -D * dm * (1.0 / (f * f) - 1.0 / (f_c * f_c))


def max_delay_time(freq_low: float, bandwidth: float, dm: float) -> float:
    """Max dispersion delay across the band
    (ref: coherent_dedispersion.hpp:81-85)."""
    return dispersion_delay_time(freq_low + bandwidth, freq_low, dm)


def nsamps_reserved(cfg) -> int:
    """Real samples overlapped between consecutive segments to mask the
    dedispersion edge (ref: coherent_dedispersion.hpp:103-128); the
    non-reserved part is a multiple of 2 * spectrum_channel_count."""
    if not cfg.baseband_reserve_sample:
        return 0
    minimal = 2 * round(
        max_delay_time(cfg.baseband_freq_low, cfg.baseband_bandwidth, cfg.dm)
        * cfg.baseband_sample_rate)
    per_bin = cfg.spectrum_channel_count * 2
    n = cfg.baseband_input_count
    refft_total = (n - minimal) // per_bin * per_bin
    if refft_total > 0:
        return n - refft_total
    return 0


def spectrum_frequencies(cfg, n: int):
    """(f_min, f_c, df) for the n-channel spectrum of one segment
    (ref: pipeline/dedisperse_pipe.hpp:31-47)."""
    f_min = cfg.baseband_freq_low
    f_c = f_min + cfg.baseband_bandwidth
    df = cfg.baseband_bandwidth / n
    return f_min, f_c, df


def chirp_factor_host(n: int, f_min: float, df: float, f_c: float,
                      dm: float) -> np.ndarray:
    """Chirp factors for n channels at f = f_min + df*i, in float64 numpy,
    returned as complex64 (ref: coherent_dedispersion.hpp:134-150)."""
    i = np.arange(n, dtype=np.float64)
    f = f_min + df * i
    delta_f = f - f_c
    k = (D * 1e6) * dm / f * ((delta_f / f_c) * (delta_f / f_c))
    k_frac = np.modf(k)[0]
    delta_phi = -2.0 * np.pi * k_frac
    return (np.cos(delta_phi) + 1j * np.sin(delta_phi)).astype(np.complex64)


def chirp_dm_coefficient(f_c: float, dm: float) -> float:
    """c_dm = D * 1e6 * dm / f_c^2, so that k = c_dm * (f - f_c)^2 / f —
    the reference formula with one division per channel instead of two."""
    return D * 1e6 * dm / (f_c * f_c)


def chirp_turns(n: int, f_min: float, df: float, f_c: float, dm: float,
                device=None, i0: int = 0) -> torch.Tensor:
    """frac(k) in float64 for channels i = i0 .. i0+n-1, with modf
    semantics (the sign of k); ``i0`` is the global index of the first
    channel (the reference's shard offset).  The channel index goes to
    float64 from an integer: a float32 index is exact only below 2^24, and
    the production spectrum has 2^29 channels.  Kernels K2 and B3
    evaluate exactly these operations (``csrc/common.cuh``)."""
    i = torch.arange(i0, i0 + n, dtype=torch.int64,
                     device=device).to(torch.float64)
    f = f_min + df * i
    d = f - f_c
    k = chirp_dm_coefficient(f_c, dm) * (d * d) / f
    return k - torch.trunc(k)


def chirp_cos_sin(n: int, f_min: float, df: float, f_c: float, dm: float,
                  device=None, i0: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 (cos, sin) of -2*pi*frac(k) for channels i0 .. i0+n-1: the
    phase in turns is rounded to float32 once, as -2*frac(k), and the trig
    of pi times that value is evaluated in float64 and rounded (kernels K2
    and B3 call sincospif on the same float32 argument)."""
    x = (-2.0 * chirp_turns(n, f_min, df, f_c, dm, device, i0)
         ).to(torch.float32)
    ang = x.to(torch.float64) * math.pi
    return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)


def chirp_factor(n: int, f_min: float, df: float, f_c: float, dm: float,
                 device=None) -> torch.Tensor:
    """The chirp as complex64 [n] (float64 phase, float32 factor)."""
    c, s = chirp_cos_sin(n, f_min, df, f_c, dm, device)
    return torch.complex(c, s)
