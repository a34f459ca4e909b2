"""Unpack raw baseband bytes to float32 samples (port of
``srtb_tpu/ops/unpack.py`` for the ``simple`` format).

Bit-width semantics follow the reference (ref: config.hpp:92-97):
positive = unsigned, negative = signed; 1/2/4-bit fields are MSB-first
within each byte (ref: unpack.hpp:43-140).  The 1/2/4-bit windowed form
is the plain version of kernel K1 (``kernels/unpack.py``); 8/-8 bits are
a plain conversion on every device.
"""

from __future__ import annotations

import torch

SUPPORTED_BITS = (1, 2, 4, 8, -8)


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


def unpack(data: torch.Tensor, nbits: int,
           window: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 [m] -> float32 samples, times ``window`` when given (the
    reference fuses the FFT window into the unpack,
    ref: unpack_pipe.hpp:72-127)."""
    if nbits not in SUPPORTED_BITS:
        raise NotImplementedError(
            f"baseband_input_bits {nbits} is not ported yet "
            "(ROADMAP A2: 16/-16/32/64 bits)")
    if data.dtype != torch.uint8:
        raise TypeError(f"unpack needs uint8 bytes, got {data.dtype}")
    if nbits in (1, 2, 4):
        out = _unpack_subbyte(data, nbits)
    elif nbits == 8:
        out = data.to(torch.float32)
    else:
        out = data.view(torch.int8).to(torch.float32)
    if window is not None:
        out = out * window
    return out
