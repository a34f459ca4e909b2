"""Unpack raw baseband bytes to float32 samples (port of
``srtb_tpu/ops/unpack.py``).

Bit-width semantics follow the reference (ref: config.hpp:92-97 and
unpack_pipe.hpp:46-136): positive = unsigned, negative = signed; 1/2/4-bit
fields are MSB-first within each byte (ref: unpack.hpp:43-140); 32 and 64
are IEEE floats, 64 decoded to float32 as the reference decodes it
(:func:`_decode_float64`).  The 1/2/4-bit windowed form is the plain
version of kernel K1 (``kernels/unpack.py``); every other width is a
plain conversion on every device, as the reference leaves it to XLA.

The de-interleave variants of the multi-stream packet formats (the
reference runs them in XLA too, so they are torch on every device):

- :func:`unpack_interleaved_2pol`   "1212" bytes (ref: unpack.hpp:214-244)
- :func:`unpack_naocpsr_snap1`      "1122" byte pairs (ref: unpack.hpp:253-283)
- :func:`unpack_gznupsr_a1`         4-way word interleave, XOR 0x80 to int8
  (ref: unpack.hpp:291-328)
- :func:`unpack_gznupsr_a1_v2_1`    2-way word interleave, int8
  (ref: unpack.hpp:336-369)
"""

from __future__ import annotations

import torch

SUPPORTED_BITS = (1, 2, 4, 8, -8, 16, -16, 32, 64)


def _unpack_subbyte(data: torch.Tensor, nbits: int) -> torch.Tensor:
    """1/2/4-bit unsigned fields, MSB-first: in[x] -> out[(8/nbits)x ...]."""
    count = 8 // nbits
    mask = (1 << nbits) - 1
    shifts = torch.arange(count - 1, -1, -1, dtype=torch.int32,
                          device=data.device) * nbits
    fields = (data.to(torch.int32)[:, None] >> shifts[None, :]) & mask
    return fields.reshape(-1).to(torch.float32)


def unpack_subbyte_planes(data: torch.Tensor, nbits: int) -> torch.Tensor:
    """1/2/4-bit fields as blocked planes ``[8/nbits, m]`` float32: plane k
    holds field k (MSB-first) of every byte, i.e. sample (8/nbits) b + k
    lands at ``[k, b]`` (the reference's sub-byte R2C consumes this layout
    and folds the blocked-to-natural order into its FFT)."""
    count = 8 // nbits
    mask = (1 << nbits) - 1
    shifts = torch.arange(count - 1, -1, -1, dtype=torch.int32,
                          device=data.device) * nbits
    return ((data.to(torch.int32)[None, :] >> shifts[:, None]) & mask).to(
        torch.float32)


def _unsigned32(words: torch.Tensor) -> torch.Tensor:
    """int32 words as their unsigned values, int64."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _decode_float64(data: torch.Tensor) -> torch.Tensor:
    """Little-endian float64 bytes -> float32, step for step as the
    reference rebuilds each double from its uint32 halves in float32
    arithmetic (a plain cast rounds once and differs in the last bit on
    some values): the low word rounded to float32, the fraction
    hi20 * 2^-20 + lo * 2^-52 rounded once, (1 + frac) rounded again, the
    power of two from the float32 exponent field with the biased exponent
    clamped to [0, 255] (doubles beyond float32's range go to 0 or inf),
    float64 subnormals to 0, NaN kept (a positive quiet NaN)."""
    u = data.view(torch.int32)
    lo = _unsigned32(u[0::2]).to(torch.float32)
    hi = _unsigned32(u[1::2])
    sign = torch.where((hi >> 31) != 0, -1.0, 1.0).to(torch.float32)
    exp = (hi >> 20) & 0x7FF
    frac = ((hi & 0xFFFFF).to(torch.float32) * (2.0 ** -20)
            + lo * (2.0 ** -52))
    pw = (torch.clamp(exp - 1023 + 127, 0, 255) << 23).to(
        torch.int32).view(torch.float32)
    mag = torch.where(exp == 0, torch.zeros((), dtype=torch.float32,
                                            device=data.device),
                      (1.0 + frac) * pw)
    out = sign * mag
    return torch.where((exp == 0x7FF) & (frac > 0),
                       torch.full((), float("nan"), dtype=torch.float32,
                                  device=data.device), out)


def unpack(data: torch.Tensor, nbits: int,
           window: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 [m] -> float32 samples, times ``window`` when given (the
    reference fuses the FFT window into the unpack,
    ref: unpack_pipe.hpp:72-127)."""
    if nbits not in SUPPORTED_BITS:
        raise ValueError(f"unsupported baseband_input_bits {nbits}")
    if data.dtype != torch.uint8:
        raise TypeError(f"unpack needs uint8 bytes, got {data.dtype}")
    # the wider widths view the bytes as words: an aligned copy of its own
    if nbits not in (1, 2, 4, 8, -8):
        data = data.contiguous()
        if data.data_ptr() % 8:
            data = data.clone()
    if nbits in (1, 2, 4):
        out = _unpack_subbyte(data, nbits)
    elif nbits == 8:
        out = data.to(torch.float32)
    elif nbits == -8:
        out = data.view(torch.int8).to(torch.float32)
    elif nbits == 16:
        out = (data.view(torch.int16).to(torch.int32) & 0xFFFF).to(
            torch.float32)
    elif nbits == -16:
        out = data.view(torch.int16).to(torch.float32)
    elif nbits == 32:
        out = data.view(torch.float32).clone()
    else:
        out = _decode_float64(data)
    if window is not None:
        out = out * window
    return out


def samples_per_byte(nbits: int) -> float:
    return 8.0 / abs(nbits)


# ---------------------------------------------------------------------
# de-interleave variants (multi-stream packet formats)
# ---------------------------------------------------------------------

def deinterleave_bytes(data: torch.Tensor, variant: str) -> torch.Tensor:
    """The byte-interleaved variants' raw bytes -> one contiguous row of
    bytes a stream, ``[S, m / S]`` uint8: "interleaved_samples_2" ("1212",
    byte b of stream s at 2 b + s) and "naocpsr_snap1" ("1122", bytes
    2 b, 2 b + 1 of stream s in group b at 4 b + 2 s)."""
    if variant == "interleaved_samples_2":
        return data.reshape(-1, 2).T.contiguous()
    if variant == "naocpsr_snap1":
        return data.reshape(-1, 2, 2).transpose(0, 1).reshape(2, -1)
    raise ValueError(f"{variant!r} is not a byte-interleaved variant")


def unpack_interleaved_2pol(data: torch.Tensor, nbits: int,
                            window: torch.Tensor | None = None):
    """"1212" byte-interleaved 2 polarizations -> 2 streams (ref:
    unpack.hpp:214-244): each stream's bytes unpacked at ``nbits``;
    returns (out1, out2) float32."""
    return tuple(unpack(row, nbits, window)
                 for row in deinterleave_bytes(data, "interleaved_samples_2"))


def unpack_naocpsr_snap1(data: torch.Tensor, nbits: int = -8,
                         window: torch.Tensor | None = None):
    """"1122" pair-interleaved 2 polarizations -> 2 streams (ref:
    unpack.hpp:253-283)."""
    return tuple(unpack(row, nbits, window)
                 for row in deinterleave_bytes(data, "naocpsr_snap1"))


def _word_streams(x: torch.Tensor, window: torch.Tensor | None):
    """int8 ``[word, stream, 4]`` -> one float32 row a stream."""
    outs = []
    for i in range(x.shape[1]):
        out = x[:, i, :].reshape(-1).to(torch.float32)
        if window is not None:
            out = out * window
        outs.append(out)
    return tuple(outs)


def unpack_gznupsr_a1(data: torch.Tensor,
                      window: torch.Tensor | None = None):
    """4-way word-interleaved (4 samples a stream in each 16-byte group),
    uint8 made int8 by XOR 0x80 (ref: unpack.hpp:291-328)."""
    x = torch.bitwise_xor(data.reshape(-1, 4, 4), 0x80).view(torch.int8)
    return _word_streams(x, window)


def unpack_gznupsr_a1_v2_1(data: torch.Tensor,
                           window: torch.Tensor | None = None):
    """2-way word-interleaved variant, int8 without the XOR (ref:
    unpack.hpp:336-369)."""
    return _word_streams(data.reshape(-1, 2, 4).view(torch.int8), window)
