"""Synthetic baseband generation (port of ``srtb_tpu/io/synth.py``).

Gaussian noise plus impulses dispersed by the inverse of the
dedispersion chirp, quantized to the digitizer's bit width.  Two makers:

- :func:`make_dispersed_baseband` runs in PyTorch on the given device with
  an explicit ``torch.Generator``, so a 2^30-sample segment is made on
  the card in a second instead of the minutes a host FFT of that length
  takes (``chip_smoke.py``'s inputs);
- :func:`make_dispersed_baseband_host` is the reference's own generator,
  numpy float64 with ``default_rng(seed)``: the same arguments give the
  same bytes as ``srtb-make-baseband`` (``tools/make_baseband.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from srtb_tpu_torch.ops import dedisperse as dd


def pack_subbyte(values: torch.Tensor, nbits: int) -> torch.Tensor:
    """Pack small unsigned ints MSB-first into bytes — the inverse of the
    unpack for nbits in {1, 2, 4} (ref bit order: unpack.hpp:43-140)."""
    per_byte = 8 // nbits
    v = values.to(torch.uint8).reshape(-1, per_byte)
    mask = (1 << nbits) - 1
    out = torch.zeros(v.shape[0], dtype=torch.uint8, device=v.device)
    for j in range(per_byte):
        out |= (v[:, j] & mask) << (8 - nbits * (j + 1))
    return out


def quantize(sig: torch.Tensor, nbits: int) -> torch.Tensor:
    """Quantize a zero-mean float signal to the byte stream of an
    ``nbits``-per-sample baseband (scale to ~3 sigma full range, offset to
    mid-scale, clip); -8 is signed int8, the same scale without the
    offset, as bytes."""
    levels = 1 << abs(nbits)
    if nbits == 1:
        return pack_subbyte((sig > 0).to(torch.uint8), 1)
    if nbits not in (2, 4, 8, -8):
        raise ValueError(f"unsupported nbits {nbits}")
    mid = levels / 2
    scale = (levels / 2 - 0.5) / 3.0
    if nbits == -8:
        return torch.clamp(torch.round(sig / sig.std(correction=0) * scale),
                           -mid, mid - 1).to(torch.int8).view(torch.uint8)
    q = torch.clamp(torch.round(sig / sig.std(correction=0) * scale + mid),
                    0, levels - 1).to(torch.uint8)
    return q if nbits == 8 else pack_subbyte(q, nbits)


def interleave_streams(rows: torch.Tensor, variant: str) -> torch.Tensor:
    """The segment bytes of ``variant`` from each stream's bytes ``rows
    [S, m]`` (uint8): the inverse of its de-interleave
    (``ops.unpack``): "simple" the one row, "interleaved_samples_2" byte
    by byte ("1212"), "naocpsr_snap1" two bytes at a time ("1122"),
    "gznupsr_a1_v2_1" and "gznupsr_a1" four at a time, the latter with
    each byte XOR 0x80 (its unpack's int8 trick)."""
    group = {"simple": None, "interleaved_samples_2": 1, "naocpsr_snap1": 2,
             "gznupsr_a1_v2_1": 4, "gznupsr_a1": 4}
    if variant not in group:
        raise ValueError(f"unknown unpack variant {variant!r}")
    if group[variant] is None:
        return rows.reshape(-1)
    streams = rows.shape[0]
    out = rows.reshape(streams, -1, group[variant]).transpose(0, 1)
    out = out.reshape(-1)
    return torch.bitwise_xor(out, 0x80) if variant == "gznupsr_a1" else out


def make_dispersed_baseband(n: int, f_min: float, bandwidth: float,
                            dm: float, pulse_positions, nbits: int = 8,
                            pulse_amp: float = 40.0, pulse_width: int = 32,
                            device=None,
                            generator: torch.Generator | None = None
                            ) -> torch.Tensor:
    """``n`` samples of unit noise plus impulses at ``pulse_positions``
    dispersed at ``dm``, quantized to ``nbits``: the packed uint8 byte
    stream on ``device``.  Float32 throughout."""
    kw = {"device": device, "generator": generator}
    x = torch.randn(n, dtype=torch.float32, **kw)
    if isinstance(pulse_positions, int):
        pulse_positions = [pulse_positions]
    if len(pulse_positions):
        pulse = torch.zeros(n, dtype=torch.float32, device=x.device)
        for pos in pulse_positions:
            pos = int(pos)
            w = min(pulse_width, n - pos)
            pulse[pos:pos + w] += pulse_amp * torch.randn(
                w, dtype=torch.float32, **kw)
        n_spec = n // 2
        f_c = f_min + bandwidth
        df = bandwidth / n_spec
        spec = torch.fft.rfft(pulse)
        del pulse
        # disperse: the medium applies the inverse chirp
        spec[:n_spec] *= torch.conj(dd.chirp_factor(n_spec, f_min, df, f_c,
                                                    dm, x.device))
        x += torch.fft.irfft(spec, n)
        del spec
    return quantize(x, nbits)


# ---------------------------------------------------------------- host
# The reference's numpy generator, for byte-identical files.

def pack_subbyte_host(values: np.ndarray, nbits: int) -> np.ndarray:
    """Pack small unsigned ints MSB-first into bytes (numpy), the inverse
    of the unpack for nbits in {1, 2, 4}."""
    per_byte = 8 // nbits
    v = np.asarray(values, dtype=np.uint8).reshape(-1, per_byte)
    out = np.zeros(v.shape[0], dtype=np.uint16)
    for j in range(per_byte):
        out |= (v[:, j].astype(np.uint16) & ((1 << nbits) - 1)) \
            << (8 - nbits * (j + 1))
    return out.astype(np.uint8)


def quantize_host(sig: np.ndarray, nbits: int) -> np.ndarray:
    """The byte stream of an ``nbits``-per-sample unsigned baseband from a
    zero-mean float signal (numpy; scale to ~3 sigma, offset to
    mid-scale, clip), 1, 2, 4, 8 or 16 bits."""
    levels = 1 << abs(nbits)
    if nbits == 1:
        return pack_subbyte_host((sig > 0).astype(np.uint8), 1)
    mid = levels / 2
    scale = (levels / 2 - 0.5) / 3.0
    q = np.clip(np.round(sig / sig.std() * scale + mid), 0, levels - 1)
    q = q.astype(np.uint8 if abs(nbits) <= 8 else np.uint16)
    if nbits in (2, 4):
        return pack_subbyte_host(q, nbits)
    if nbits == 8:
        return q.astype(np.uint8)
    if nbits == 16:
        return q.astype("<u2").view(np.uint8)
    raise ValueError(f"unsupported nbits {nbits}")


def make_dispersed_baseband_host(n: int, f_min: float, bandwidth: float,
                                 dm: float, pulse_positions, nbits: int = 8,
                                 pulse_amp: float = 40.0,
                                 pulse_width: int = 32,
                                 seed: int = 0) -> np.ndarray:
    """Real-valued baseband of ``n`` samples: unit noise + dispersed
    impulses at ``pulse_positions``, quantized to ``nbits``, in numpy
    float64 from ``default_rng(seed)``; the packed uint8 byte stream."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    pulse = np.zeros(n)
    if np.isscalar(pulse_positions):
        pulse_positions = [pulse_positions]
    for pos in pulse_positions:
        pos = int(pos)
        pulse[pos:pos + pulse_width] += \
            pulse_amp * rng.standard_normal(min(pulse_width, n - pos))
    n_spec = n // 2
    f_c = f_min + bandwidth
    df = bandwidth / n_spec
    chirp = dd.chirp_factor_host(n_spec, f_min, df, f_c, dm)
    spec = np.fft.rfft(pulse)
    spec[:n_spec] *= np.conj(chirp)  # disperse (medium = inverse chirp)
    sig = x + np.fft.irfft(spec, n)
    return quantize_host(sig, nbits)
