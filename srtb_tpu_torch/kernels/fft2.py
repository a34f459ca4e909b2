"""B9 and B10: the two passes of the four-step C2C of a segment-sized
transform, m = n1 n2 = 2^24 ... 2^29 (``csrc/fft2.cu`` and
``csrc/fft_rows.cu``; replace ``srtb_tpu/ops/pallas_fft2.py``
``pass1_2d`` and ``pass2_2d``), with the factorizations (the front-fused
plan's :func:`ffuse_factor` too) and the composed transform
:func:`fft2_c2c`.

The transform of ``x [..., m]`` views each plane as ``[n1, n2]`` row-major
(x[j1, j2] = x[j1 n2 + j2]).  Pass 1 (B9) runs the n1-point C2C down every
column and multiplies by the four-step twiddle exp(s 2 pi i k1 j2 / m);
pass 2 (B10) runs the n2-point C2C along every row.  The result
C[k1, k2] is X[k2 n1 + k1]: k1-major blocked, and :func:`unblock`, a
transpose, restores natural order.  Unnormalized in both directions.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from srtb_tpu_torch.kernels import build
from srtb_tpu_torch.kernels import fft_rows as KF

# the reference's window (pallas_fft2._factor): n1 the column length, n2
# the row length of the row-FFT kernels
N1_CHOICES = (1 << 12, 1 << 13)
N2_MIN, N2_MAX = 1 << 12, 1 << 16


def factor(m: int) -> tuple[int, int] | None:
    """m = n1 n2 with n1 in {4096, 8192} (the first that leaves n2 in
    [4096, 65536]), or None outside the window m = 2^24 ... 2^29 or for m
    not a power of two (the reference's ``_factor`` with its
    ``SRTB_PALLAS2_N1`` pin unset)."""
    if m <= 0 or m & (m - 1):
        return None
    for n1 in N1_CHOICES:
        if m % n1 == 0 and N2_MIN <= m // n1 <= N2_MAX:
            return n1, m // n1
    return None


def supported(m: int) -> bool:
    """Whether the two-pass kernels take a transform of length m."""
    return factor(m) is not None


# Longest leg the reference's front-fused kernels run as one DFT matrix
# below the production window (``pallas_fft2._SMALL_LEG_MAX``).
_SMALL_LEG_MAX = 512

# The unpack variants the front-fused pass 1 (B11) reads, and the sample
# widths of each (positive unsigned, -8 signed int8).
FFUSE_VARIANT_BITS = {
    "simple": (1, 2, 4, 8, -8),
    "interleaved_samples_2": (8, -8),
}


def leg_supported(length: int) -> bool:
    """A leg length the reference's front-fused kernels take: the row-FFT
    window 2^12 ... 2^16, or a power of two in [8, 512]."""
    if length <= 0 or length & (length - 1):
        return False
    return N2_MIN <= length <= N2_MAX or 8 <= length <= _SMALL_LEG_MAX


def ffuse_factor(m: int) -> tuple[int, int] | None:
    """[n1, n2] of the front-fused plan (the reference's
    ``ffuse_factor``): :func:`factor` in the production window, below it a
    small-leg split (n1 <= 512, n2 >= 128) so that the plan runs at test
    sizes, where only the plain versions take it; None when m has no such
    split."""
    fac = factor(m)
    if fac is not None:
        return fac
    if m <= 0 or m & (m - 1) or m < (1 << 10):
        return None

    def ok(n1: int) -> bool:
        if not 8 <= n1 <= _SMALL_LEG_MAX or m % n1:
            return False
        return leg_supported(m // n1) and m // n1 >= 128

    n1 = min(1 << ((m.bit_length() - 1) // 2), _SMALL_LEG_MAX)
    for cand in (n1, m // 4096, m // 128):
        if ok(cand):
            return cand, m // cand
    return None


@functools.lru_cache(maxsize=8)
def twiddle(n1: int, n2: int, inverse: bool, device: torch.device,
            first_row: int = 0) -> torch.Tensor:
    """w[j1, j2] = exp(+-2 pi i (j1 j2 mod n) / n), n = n1 n2, for
    first_row <= j1 < n1, built in float64 from the exact integer residue
    and rounded to complex64 (cached per shape and device: the four-step,
    the sub-byte R2C and B9's plain version use the same few tables every
    segment)."""
    n = n1 * n2
    j1 = torch.arange(first_row, n1, dtype=torch.int64,
                      device=device)[:, None]
    j2 = torch.arange(n2, dtype=torch.int64, device=device)[None, :]
    r = ((j1 * j2) % n).to(torch.float64)
    sign = 1.0 if inverse else -1.0
    return torch.polar(torch.ones_like(r), r * (sign * 2.0 * np.pi / n)
                       ).to(torch.complex64)


def _blocks(x: torch.Tensor, name: str) -> tuple[int, int, int]:
    """(batch, n1, n2) of ``x [..., n1, n2]``; raises unless the kernels
    take the shape (on every device, as the CUDA wrappers' shapes)."""
    if x.dtype != torch.complex64 or x.dim() < 2:
        raise ValueError(f"{name}: x must be a complex64 tensor [..., n1, n2]")
    n1, n2 = x.shape[-2], x.shape[-1]
    if n1 not in N1_CHOICES or n2 & (n2 - 1) or not N2_MIN <= n2 <= N2_MAX:
        raise ValueError(f"{name}: unsupported block {tuple(x.shape)} (n1 in "
                         f"{N1_CHOICES}, n2 a power of two in [2^12, 2^16])")
    return x.numel() // (n1 * n2), n1, n2


# the fields of ``srtb_fft2_pass1_geometry`` (csrc/fft2.cu)
PASS1_GEOMETRY_FIELDS = ("ctas_a_cluster", "columns_a_cluster",
                         "rows_a_cta", "threads", "ctas_an_sm",
                         "resident_clusters", "registers", "local_bytes",
                         "smem_bytes")


def pass1_geometry(n1: int, device: torch.device,
                   front: bool = False) -> dict:
    """The launch geometry of the column body at n1 on ``device``'s card,
    B9's kernel or (``front``) B11's: CTAs a cluster, columns a cluster,
    rows a CTA, threads, CTAs an SM, the clusters the occupancy query says
    the card holds at once, and the compiler's registers and local
    (spilled) bytes a thread, shared bytes a CTA."""
    return dict(zip(PASS1_GEOMETRY_FIELDS,
                    _pass1_geometry(n1, device, front)))


@functools.lru_cache(maxsize=8)
def _pass1_geometry(n1: int, device: torch.device,
                    front: bool) -> tuple[int, ...]:
    entry = ("srtb_fft2_pass1_front_geometry" if front
             else "srtb_fft2_pass1_geometry")
    geo = (ctypes.c_int * len(PASS1_GEOMETRY_FIELDS))()
    with torch.cuda.device(device):
        rc = getattr(build.library(), entry)(n1, ctypes.addressof(geo))
    build.check(rc, entry)
    return tuple(geo)


def column_ctas(n1: int, n2: int, device: torch.device) -> int:
    """CTAs of B11's column body a plane (one partial each), from the
    launch geometry the library reports (csrc/fft2.cuh ``Geometry``)."""
    geo = pass1_geometry(n1, device, front=True)
    return n2 // geo["columns_a_cluster"] * geo["ctas_a_cluster"]


def fft2_pass1_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version of B9 (any [..., n1, n2]): the C2C down
    each column times the float64-built four-step twiddle."""
    n1, n2 = x.shape[-2], x.shape[-1]
    y = (torch.fft.ifft(x, dim=-2, norm="forward") if inverse
         else torch.fft.fft(x, dim=-2))
    return y * twiddle(n1, n2, inverse, x.device)


def fft2_pass1(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Pass 1 on complex64 ``x [..., n1, n2]``: B[k1, j2] = exp(s 2 pi i
    k1 j2 / m) sum_j1 x[j1, j2] exp(s 2 pi i j1 k1 / n1), s = -1 forward,
    +1 inverse.  A CPU tensor takes the plain version; a CUDA tensor
    launches B9 (a view not 16-byte aligned is copied first: TMA reads
    it)."""
    batch, n1, n2 = _blocks(x, "fft2_pass1")
    if x.device.type == "cpu":
        return fft2_pass1_plain(x, inverse)
    name = "fft2_pass1"
    x = x.contiguous()
    build.require_cuda_contiguous(name, x=x)
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty_like(x)
    tw = KF.twiddle_table(n1, x.device)
    with torch.cuda.device(x.device):
        rc = build.library().srtb_fft2_pass1(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), batch, n1, n2,
            int(inverse), build.stream_of(x))
    build.check(rc, name)
    fft2_pass1.launches += 1
    return out


fft2_pass1.launches = 0


def fft2_pass2_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version of B10 (any [..., n1, n2]): the C2C along
    each row."""
    return KF.fft_rows_plain(x, inverse)


def fft2_pass2(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Pass 2 on pass 1's ``[..., n1, n2]``: the n2-point C2C along every
    row, C[k1, k2] in the same k1-major layout.  A CPU tensor takes the
    plain version; a CUDA tensor launches B10 (B6's kernel under its own
    entry point and counter; a view not 16-byte aligned is copied
    first)."""
    batch, n1, n2 = _blocks(x, "fft2_pass2")
    if x.device.type == "cpu":
        return fft2_pass2_plain(x, inverse)
    out = KF.run_rows("srtb_fft2_pass2", x.contiguous().reshape(-1, n2),
                      batch * n1, n2, inverse)
    fft2_pass2.launches += 1
    return out.reshape(x.shape)


fft2_pass2.launches = 0


def unblock(c: torch.Tensor) -> torch.Tensor:
    """k1-major blocked ``[..., n1, n2]`` -> natural order ``[..., m]``
    (X[k2 n1 + k1] = C[k1, k2]): a transpose, as the reference leaves it
    to XLA."""
    return c.transpose(-1, -2).reshape(*c.shape[:-2], -1)


def fft2_c2c(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Unnormalized C2C along the last axis of complex64 ``x [..., m]``
    (leading dims batch, all planes in one launch of each pass): B9, B10
    and :func:`unblock`."""
    m = x.shape[-1]
    fac = factor(m)
    if fac is None:
        raise ValueError(f"fft2_c2c: unsupported length {m} (2^24 ... 2^29)")
    return unblock(fft2_pass2(
        fft2_pass1(x.reshape(*x.shape[:-1], *fac), inverse), inverse))
