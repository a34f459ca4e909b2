"""The float64 oracle: an independent numpy transliteration of the
reference device chain (the port's own copy of the reference's
``tests/oracle_utils.py``, whose helpers it re-derives from the same C++
sources; ``tools/production_oracle.py`` runs it beside the chain on the
card).

Only the three helpers the reference's oracle borrows from its own ops
come from the port's ops (``normalization_coefficient``,
``spectrum_frequencies``, ``sk_decision_thresholds``); everything else is
written out here, so that a sign, convention or interleave error in the
chain fails the comparison instead of cancelling out.
"""

from __future__ import annotations

import numpy as np

from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import rfi

D = 4.148808e3  # MHz^2 pc^-1 cm^3 s (ref: coherent_dedispersion.hpp:67)


def oracle_unpack(raw_bytes: np.ndarray, nbits: int) -> np.ndarray:
    """Single-stream unpack in float64 (ref: unpack.hpp:43-140):
    1/2/4-bit unsigned fields MSB-first within each byte; 8 unsigned,
    -8 signed int8."""
    b = np.asarray(raw_bytes, dtype=np.uint8)
    if nbits in (1, 2, 4):
        count = 8 // nbits
        mask = (1 << nbits) - 1
        fields = [(b.astype(np.uint16) >> ((count - 1 - i) * nbits)) & mask
                  for i in range(count)]
        return np.stack(fields, axis=-1).reshape(-1).astype(np.float64)
    if nbits == 8:
        return b.astype(np.float64)
    if nbits == -8:
        return b.view(np.int8).astype(np.float64)
    raise ValueError(f"oracle_unpack: unsupported nbits {nbits}")


def oracle_deinterleave(raw_bytes: np.ndarray, fmt_name: str,
                        nbits: int) -> list[np.ndarray]:
    """De-interleave a raw byte segment into per-stream float64 samples,
    transliterated from the reference unpack kernels:

    - ``simple``                 1 stream, plain unpack
    - ``interleaved_samples_2``  "1212" byte-interleave
      (ref: unpack.hpp:214-244)
    - ``naocpsr_snap1``          "1122" pair-interleave, int8
      (ref: unpack.hpp:253-283)
    - ``gznupsr_a1_v1``          4-way word-interleave (4 samples per
      stream per 16-byte group), uint8 XOR 0x80 -> int8
      (ref: unpack.hpp:291-328)
    - ``gznupsr_a1``             2-way word-interleave, int8, no XOR
      (ref: unpack.hpp:336-369)
    """
    b = np.asarray(raw_bytes, dtype=np.uint8)
    if fmt_name == "simple":
        return [oracle_unpack(b, nbits)]
    if fmt_name == "interleaved_samples_2":
        x = b.reshape(-1, 2)
        return [oracle_unpack(x[:, i].copy(), nbits) for i in range(2)]
    if fmt_name == "naocpsr_snap1":
        x = b.reshape(-1, 4)
        return [oracle_unpack(x[:, 0:2].reshape(-1), -8),
                oracle_unpack(x[:, 2:4].reshape(-1), -8)]
    if fmt_name == "gznupsr_a1_v1":
        x = (b.reshape(-1, 4, 4) ^ np.uint8(0x80)).view(np.int8)
        return [x[:, i, :].reshape(-1).astype(np.float64) for i in range(4)]
    if fmt_name == "gznupsr_a1":
        x = b.reshape(-1, 2, 4).view(np.int8)
        return [x[:, i, :].reshape(-1).astype(np.float64) for i in range(2)]
    raise ValueError(f"oracle_deinterleave: unknown format {fmt_name}")


def oracle_stream_chain(x: np.ndarray, cfg):
    """float64 transliteration of the reference device chain over one
    stream of already-unpacked samples.  Returns (waterfall, time series,
    SK-zapped row count)."""
    n = x.size
    n_spec = n // 2

    # R2C, Nyquist dropped (ref: fft_pipe.hpp:44-78)
    spec = np.fft.rfft(x)[:-1]

    # RFI stage 1: zap > threshold*mean power, normalize survivors by
    # (N^2/channels)^-0.5 evaluated in f32 (ref: rfi_mitigation_pipe.hpp:50-80)
    power = spec.real**2 + spec.imag**2
    zap1 = power > cfg.mitigate_rfi_average_method_threshold * power.mean()
    coeff = rfi.normalization_coefficient(n_spec, cfg.spectrum_channel_count)
    spec = np.where(zap1, 0.0, spec * coeff)

    # coherent dedispersion chirp (ref: coherent_dedispersion.hpp:133-150,
    # Jiang 2022): k = D*1e6*dm/f*((f-f_c)/f_c)^2, phase = -2*pi*frac(k)
    f_min, f_c, df = dd.spectrum_frequencies(cfg, n_spec)
    f = f_min + df * np.arange(n_spec, dtype=np.float64)
    k = D * 1e6 * cfg.dm / f * ((f - f_c) / f_c) ** 2
    chirp = np.exp(-2j * np.pi * np.modf(k)[0])
    spec = spec * chirp

    # waterfall: [channels, wlen] rows, unnormalized backward C2C
    # (ref: fft_pipe.hpp:285-344)
    ch = min(cfg.spectrum_channel_count, n_spec)
    wlen = n_spec // ch
    wf = np.fft.ifft(spec.reshape(ch, wlen), axis=-1) * wlen

    # SK stage 2 (ref: rfi_mitigation.hpp:290-341), thresholds in f32 as
    # the implementation computes them
    lo, hi = rfi.sk_decision_thresholds(
        wlen, cfg.mitigate_rfi_spectral_kurtosis_threshold)
    p = wf.real**2 + wf.imag**2
    s2, s4 = p.sum(axis=-1), (p * p).sum(axis=-1)
    sk = wlen * s4 / (s2 * s2)
    zap2 = (sk > hi) | (sk < lo)
    wf = np.where(zap2[:, None], 0.0, wf)

    # detect: power time series over the untrimmed window, mean-subtracted
    # (ref: signal_detect_pipe.hpp:305-334; reserve disabled in this cfg)
    ts = (wf.real**2 + wf.imag**2).sum(axis=0)
    ts = ts - ts.mean()
    return wf, ts, int(zap2.sum())
