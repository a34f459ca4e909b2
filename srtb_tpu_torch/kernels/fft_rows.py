"""B6, B7 and B8: batched row FFTs of length 2^12 ... 2^16 held on chip,
plain and with the waterfall tail's epilogues (``csrc/fft_rows*.cu``;
replace ``srtb_tpu/ops/pallas_fft.py`` ``fft_rows_ri``,
``fft_rows_stats_ri`` and ``fft_rows_skzap_ri``).

All three run on the TMA-fed row-FFT core (``csrc/fft_rows_sm90.cuh``),
B7 and B8 as its epilogue kernels.  Complex data is ``complex64``
``[..., L]`` (leading dims batch); every transform is unnormalized in
both directions.  The de-window is given as
the ``[L]`` coefficients to divide out and is applied, as the reference's
kernels apply it, as a multiply by their float32 reciprocal.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from srtb_tpu_torch.kernels import build
from srtb_tpu_torch.ops import rfi

MIN_LOG2, MAX_LOG2 = 12, 16


def supported(length: int, batch: int) -> bool:
    """Whether the row-FFT kernels take ``[batch, length]``: a power of two
    in [2^12, 2^16] (the reference's window, ``pallas_fft.supported``)."""
    return (length & (length - 1) == 0
            and (1 << MIN_LOG2) <= length <= (1 << MAX_LOG2) and batch >= 1)


def _rows(x: torch.Tensor, name: str) -> tuple[torch.Tensor, int, int]:
    if x.dtype != torch.complex64 or x.dim() < 1:
        raise ValueError(f"{name}: x must be a complex64 tensor [..., L]")
    length = x.shape[-1]
    batch = x.numel() // length if length else 0
    if not supported(length, batch):
        raise ValueError(f"{name}: unsupported row FFT shape "
                         f"{tuple(x.shape)} (rows of 2^12 ... 2^16)")
    return x.reshape(batch, length), batch, length


def _reciprocal(dewindow: torch.Tensor | None, length: int,
                device: torch.device) -> torch.Tensor | None:
    if dewindow is None:
        return None
    if tuple(dewindow.shape) != (length,) or dewindow.device != device:
        raise ValueError(f"dewindow must be [{length}] on {device}")
    return 1.0 / dewindow.to(torch.float32)


@functools.lru_cache(maxsize=None)
def twiddle_table(length: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i m / length), m < length, built in float64 and rounded to
    complex64: the twiddle table of B9's and B11's column body
    (conjugated for the inverse)."""
    m = torch.arange(length, dtype=torch.float64, device=device)
    return torch.polar(torch.ones_like(m), m * (-2.0 * torch.pi / length)
                       ).to(torch.complex64)


def fft_rows_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version of B6."""
    if inverse:
        return torch.fft.ifft(x, norm="forward")
    return torch.fft.fft(x)


def _dewindowed(y: torch.Tensor, dw: torch.Tensor | None) -> torch.Tensor:
    if dw is None:
        return y
    return torch.complex(y.real * dw, y.imag * dw)


def _moments(p: torch.Tensor):
    """Per-row sum p and sum p^2, accumulated in float64 and rounded to
    float32 (as K3 and the kernels accumulate them)."""
    p64 = p.to(torch.float64)
    return (p64.sum(-1).to(torch.float32),
            (p64 * p64).sum(-1).to(torch.float32))


# the fields of ``srtb_fft_rows_geometry`` (csrc/fft_rows.cu), and of the
# geometry queries of the core's epilogue kernels, B7, B8 and B12
GEOMETRY_FIELDS = ("ctas_a_cluster", "values_a_cta", "threads", "ctas_an_sm",
                   "resident", "registers", "local_bytes", "smem_bytes")


def query_geometry(entry: str, length: int, device: torch.device) -> dict:
    """The launch geometry the library's query ``entry`` reports for rows
    of ``length`` on ``device``'s card."""
    geo = (ctypes.c_int * len(GEOMETRY_FIELDS))()
    with torch.cuda.device(device):
        rc = getattr(build.library(), entry)(length, ctypes.addressof(geo))
    build.check(rc, entry)
    return dict(zip(GEOMETRY_FIELDS, geo))


def geometry(length: int, device: torch.device) -> dict:
    """The launch geometry of the B6/B10 row-FFT core for rows of
    ``length`` on ``device``'s card (one row a CTA or a cluster): CTAs a
    cluster, values a CTA, threads, CTAs an SM, the CTAs (or clusters)
    the card holds at once (the occupancy query), and the compiler's
    registers and local (spilled) bytes a thread."""
    return query_geometry("srtb_fft_rows_geometry", length, device)


def stats_geometry(length: int, device: torch.device) -> dict:
    """B7's launch geometry on the same core (one row a CTA or a
    cluster, as B6's)."""
    return query_geometry("srtb_fft_rows_stats_geometry", length, device)


def skzap_geometry(length: int, device: torch.device) -> dict:
    """B8's launch geometry on the same core: its ``resident`` CTAs (rows
    of one CTA) or clusters are the groups it launches."""
    return query_geometry("srtb_fft_rows_skzap_geometry", length, device)


@functools.lru_cache(maxsize=None)
def _skzap_resident(length: int, device: torch.device) -> int:
    return skzap_geometry(length, device)["resident"]


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, or a copy when its data is not 16-byte aligned (TMA
    reads need 16; a view whose storage offset leaves it 8-byte aligned is
    copied)."""
    return x.clone() if x.data_ptr() % 16 else x


def run_rows(entry: str, x2: torch.Tensor, batch: int, length: int,
             inverse: bool) -> torch.Tensor:
    """Launch the row-FFT core through the library's ``entry`` (B6's or
    B10's) on CUDA rows ``x2 [batch, length]``.  TMA reads need 16-byte
    aligned rows: a view whose storage offset leaves it 8-byte aligned is
    copied first."""
    build.require_cuda_contiguous(entry, x=x2)
    x2 = aligned(x2)
    out = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        rc = getattr(build.library(), entry)(
            x2.data_ptr(), out.data_ptr(), batch, length, int(inverse),
            build.stream_of(x2))
    build.check(rc, entry)
    return out


def fft_rows(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """C2C FFT along the last axis of complex64 ``x [..., L]``, L a power
    of two in [2^12, 2^16].  A CPU tensor takes the plain version; a CUDA
    tensor launches B6 (a view not 16-byte aligned is copied first)."""
    x2, batch, length = _rows(x, "fft_rows")
    if x.device.type == "cpu":
        return fft_rows_plain(x, inverse)
    out = run_rows("srtb_fft_rows", x2.contiguous(), batch, length, inverse)
    fft_rows.launches += 1
    return out.reshape(x.shape)


fft_rows.launches = 0


def fft_rows_stats_plain(x: torch.Tensor, inverse: bool = True,
                         dewindow: torch.Tensor | None = None):
    """The plain PyTorch version of B7."""
    y = _dewindowed(fft_rows_plain(x, inverse),
                    _reciprocal(dewindow, x.shape[-1], x.device))
    s2, s4 = _moments(rfi.power(y))
    return y, s2, s4


def fft_rows_stats(x: torch.Tensor, inverse: bool = True,
                   dewindow: torch.Tensor | None = None):
    """B6 plus the de-window and the per-row power moments: complex64
    ``x [..., L]`` -> ``(y [..., L], s2 [...], s4 [...])`` with s2 = sum
    |y|^2 and s4 = sum |y|^4 per row (float32).  A CPU tensor takes the
    plain version; a CUDA tensor launches B7 (a view not 16-byte aligned
    is copied first)."""
    x2, batch, length = _rows(x, "fft_rows_stats")
    dw = _reciprocal(dewindow, length, x.device)
    if x.device.type == "cpu":
        return fft_rows_stats_plain(x, inverse, dewindow)
    name = "fft_rows_stats"
    x2 = x2.contiguous()
    build.require_cuda_contiguous(name, x=x2, dw=dw)
    x2 = aligned(x2)
    out = torch.empty_like(x2)
    s2, s4 = (torch.empty(batch, dtype=torch.float32, device=x.device)
              for _ in range(2))
    with torch.cuda.device(x.device):
        rc = build.library().srtb_fft_rows_stats(
            x2.data_ptr(), out.data_ptr(),
            None if dw is None else dw.data_ptr(), s2.data_ptr(),
            s4.data_ptr(), batch, length, int(inverse), build.stream_of(x2))
    build.check(rc, name)
    fft_rows_stats.launches += 1
    lead = x.shape[:-1]
    return out.reshape(x.shape), s2.reshape(lead), s4.reshape(lead)


fft_rows_stats.launches = 0


def skzap_groups(f_len: int, resident: int) -> int:
    """The persistent clusters (groups) of B8 over ``f_len`` rows: row r
    goes to group r mod groups.  As many as the card holds at once
    (``resident``, from :func:`skzap_geometry`), so that one wave covers
    every row, and never more than there are rows."""
    return max(1, min(f_len, resident))


def fft_rows_skzap_plain(x: torch.Tensor, sk_threshold: float,
                         inverse: bool = True,
                         dewindow: torch.Tensor | None = None):
    """The plain PyTorch version of B8."""
    y = _dewindowed(fft_rows_plain(x, inverse),
                    _reciprocal(dewindow, x.shape[-1], x.device))
    p = rfi.power(y)
    s2, s4 = _moments(p)
    zap = rfi.sk_zap_decision(s2, s4, x.shape[-1], sk_threshold)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    out = torch.where(zap[:, None], torch.zeros((), dtype=y.dtype,
                                                device=x.device), y)
    ts = torch.where(zap[:, None], zero, p).to(torch.float64).sum(0)
    return out, zap, p[:, 0].clone(), ts.to(torch.float32)


def fft_rows_skzap(x: torch.Tensor, sk_threshold: float,
                   inverse: bool = True,
                   dewindow: torch.Tensor | None = None):
    """The whole waterfall tail on complex64 rows ``x [F, L]``: the row
    FFT, de-window, spectral-kurtosis verdict and zap (a select: NaN/Inf
    rows become 0), and the time series over kept rows.  Returns
    ``(zapped [F, L], zap bool [F], fs0 float32 [F], ts float32 [L])``
    with fs0 the first sample's power before the zap (finish the zero
    channel count with ``zap | (fs0 == 0)``) and ts not yet
    mean-subtracted.  A CPU tensor takes the plain version; a CUDA tensor
    launches B8 (a view not 16-byte aligned is copied first) on
    :func:`skzap_groups` persistent clusters."""
    if x.dim() != 2:
        raise ValueError("fft_rows_skzap: x must be [F, L] (one stream)")
    x2, f_len, length = _rows(x, "fft_rows_skzap")
    dw = _reciprocal(dewindow, length, x.device)
    if x.device.type == "cpu":
        return fft_rows_skzap_plain(x, sk_threshold, inverse, dewindow)
    name = "fft_rows_skzap"
    x2 = x2.contiguous()
    build.require_cuda_contiguous(name, x=x2, dw=dw)
    x2 = aligned(x2)
    thr_low, thr_high = rfi.sk_decision_thresholds(length, sk_threshold)
    dev = x.device
    groups = skzap_groups(f_len, _skzap_resident(length, dev))
    out = torch.empty_like(x2)
    zap = torch.empty(f_len, dtype=torch.bool, device=dev)
    fs0 = torch.empty(f_len, dtype=torch.float32, device=dev)
    ts_part = torch.empty(groups, length, dtype=torch.float32, device=dev)
    ts = torch.empty(length, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().srtb_fft_rows_skzap(
            x2.data_ptr(), out.data_ptr(),
            None if dw is None else dw.data_ptr(), zap.data_ptr(),
            fs0.data_ptr(), ts_part.data_ptr(), ts.data_ptr(), f_len, length,
            int(inverse), groups, float(thr_low), float(thr_high),
            build.stream_of(x2))
    build.check(rc, name)
    fft_rows_skzap.launches += 1
    return out, zap, fs0, ts


fft_rows_skzap.launches = 0
