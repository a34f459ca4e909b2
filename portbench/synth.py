"""The benchmark's frozen baseband generator.

A copy of the port's ``io/synth.py`` ``make_dispersed_baseband`` and what
it calls, kept here so that a change to the program cannot change the
inputs the benchmark measures it on: unit Gaussian noise plus impulses
dispersed by the inverse of the coherent-dedispersion chirp, quantized to
the digitizer's bit width, made on the given device from an explicit
``torch.Generator``.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

# dispersion constant, MHz^2 pc^-1 cm^3 s
D = 4.148808e3


def pack_subbyte(values: torch.Tensor, nbits: int) -> torch.Tensor:
    """Pack small unsigned ints MSB-first into bytes (the inverse of the
    1/2/4-bit unpack)."""
    per_byte = 8 // nbits
    v = values.to(torch.uint8).reshape(-1, per_byte)
    mask = (1 << nbits) - 1
    out = torch.zeros(v.shape[0], dtype=torch.uint8, device=v.device)
    for j in range(per_byte):
        out |= (v[:, j] & mask) << (8 - nbits * (j + 1))
    return out


def quantize(sig: torch.Tensor, nbits: int) -> torch.Tensor:
    """The byte stream of an unsigned ``nbits``-per-sample baseband from a
    zero-mean float signal: scaled to about 3 sigma full range, offset to
    mid-scale and clipped."""
    if nbits not in (2, 4, 8):
        raise ValueError(f"unsupported nbits {nbits}")
    levels = 1 << nbits
    mid = levels / 2
    scale = (levels / 2 - 0.5) / 3.0
    q = torch.clamp(torch.round(sig / sig.std(correction=0) * scale + mid),
                    0, levels - 1).to(torch.uint8)
    return q if nbits == 8 else pack_subbyte(q, nbits)


def chirp_factor(n: int, f_min: float, df: float, f_c: float, dm: float,
                 device=None) -> torch.Tensor:
    """The dedispersion chirp for channels f = f_min + df i, complex64:
    the phase -2 pi frac(k) in float64, k = D 1e6 dm (f - f_c)^2 / (f
    f_c^2), rounded to float32 turns before the trigonometry."""
    i = torch.arange(n, dtype=torch.int64, device=device).to(torch.float64)
    f = f_min + df * i
    d = f - f_c
    k = (D * 1e6 * dm / (f_c * f_c)) * (d * d) / f
    x = (-2.0 * (k - torch.trunc(k))).to(torch.float32)
    ang = x.to(torch.float64) * math.pi
    return torch.complex(torch.cos(ang).to(torch.float32),
                         torch.sin(ang).to(torch.float32))


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
        spec[:n_spec] *= torch.conj(chirp_factor(n_spec, f_min, df, f_c, dm,
                                                 x.device))
        x += torch.fft.irfft(spec, n)
        del spec
    return quantize(x, nbits)


def make_noise_bytes(nbytes: int, nbits: int, device=None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """``nbytes`` of quantized unit noise: the same quantizer as
    :func:`make_dispersed_baseband` over one long signal, made in one
    call."""
    n = nbytes * (8 // nbits)
    return quantize(torch.randn(n, dtype=torch.float32, device=device,
                                generator=generator), nbits)
