"""B11 and B12: the two passes of the front-fused staged plan
(``csrc/fft2_front.cu`` and ``csrc/fft2_spectrum.cu``; replace
``srtb_tpu/ops/pallas_fft2.py`` ``pass1_front`` and ``pass2_spectrum``),
with :func:`front_mean_power` between them.

Pass 1 (B11) takes the raw bytes of a segment: unpack, window, the
even/odd pack of the R2C's half-size sequence z (m = n/2 values a stream),
and B9's column FFT and four-step twiddle of z viewed ``[n1, n2]`` (n1, n2
from :func:`fft2.ffuse_factor`), plus the Parseval pieces of the RFI
stage-1 mean power.  Pass 2 (B12) takes one stream's intermediate: B10's
row FFT, the Hermitian R2C post-process from the mirror bin, RFI stage 1,
the manual keep mask and the chirp (exact, or the premultiplied pair) in
one pass, and returns the dedispersed drop-Nyquist spectrum k1-major
blocked (bin k = k2 n1 + k1 at ``[k1, k2]``); :func:`fft2.unblock`
restores natural order.  B12 runs on the row-FFT core of
``csrc/fft_rows_sm90.cuh`` (B10's), one row pair {w, n1 - w} a cluster.

The kernels take the production window n1 in {4096, 8192}, n2 in [2^12,
2^16]; the small-leg splits that ``ffuse_factor`` gives below it occur
only at test sizes, where a CPU tensor takes the plain versions.  A CUDA
tensor outside the window raises.
"""

from __future__ import annotations

import numpy as np
import torch

from srtb_tpu_torch.kernels import build
from srtb_tpu_torch.kernels import fft2 as K2
from srtb_tpu_torch.kernels import fft_rows as KF
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import fft as F
from srtb_tpu_torch.ops import rfi
from srtb_tpu_torch.ops import unpack as U


def _kernel_block(n1: int, n2: int, name: str) -> None:
    if n1 not in K2.N1_CHOICES or not K2.N2_MIN <= n2 <= K2.N2_MAX:
        raise ValueError(f"{name}: block [{n1}, {n2}] outside the kernel's "
                         f"window (n1 in {K2.N1_CHOICES}, n2 in [2^12, "
                         "2^16]); smaller splits run only on the CPU")


def front_streams(variant: str) -> int:
    """Streams a segment of the variant holds."""
    return 2 if variant == "interleaved_samples_2" else 1


def front_unpack(raw: torch.Tensor, variant: str, nbits: int):
    """The raw bytes of a segment -> per-stream (even, odd) float32
    samples [m] (the reference's ``_front_unpack`` over the whole
    segment): "simple" x[0::2], x[1::2]; "interleaved_samples_2" ("1212"
    bytes) z_s = x[4j + s] + i x[4j + 2 + s]."""
    vals = U.unpack(raw, nbits)
    if variant == "interleaved_samples_2":
        return [(vals[s::4], vals[2 + s::4]) for s in range(2)]
    return [(vals[0::2], vals[1::2])]


def front_pack(raw: torch.Tensor, m: int, variant: str, nbits: int,
               window_eo=None) -> torch.Tensor:
    """B11's input stage in plain PyTorch: :func:`front_unpack`, the
    window and the even/odd pack, complex64 [S, n1, n2] (what B9 would
    read)."""
    n1, n2 = K2.ffuse_factor(m)
    zs = []
    for re, im in front_unpack(raw, variant, nbits):
        re, im = re.reshape(n1, n2), im.reshape(n1, n2)
        if window_eo is not None:
            re, im = re * window_eo[0], im * window_eo[1]
        zs.append(torch.complex(re, im))
    return torch.stack(zs)


def fft2_pass1_front_plain(raw: torch.Tensor, m: int, variant: str,
                           nbits: int, window_eo=None,
                           inverse: bool = False):
    """The plain PyTorch version of B11: :func:`front_pack`, B9's plain
    version on the ``[n1, n2]`` view, and the sums in float64."""
    b = K2.fft2_pass1_plain(front_pack(raw, m, variant, nbits, window_eo),
                            inverse)
    b64 = torch.view_as_real(b).to(torch.float64)
    f0 = b64[:, 0].sum(1)
    aux = torch.stack([b64.square().sum((1, 2, 3)), f0[:, 0], f0[:, 1]], 1)
    return b, aux


def fft2_pass1_front(raw: torch.Tensor, m: int, variant: str, nbits: int,
                     window_eo=None, inverse: bool = False):
    """Pass 1 of the front-fused plan on the segment's raw uint8 bytes:
    ``(b complex64 [S, n1, n2], aux float64 [S, 3])`` with ``b`` B9's
    intermediate of each stream's packed sequence and ``aux`` its sum
    |b|^2, Re and Im of sum_j2 b[0, j2] (for :func:`front_mean_power`).
    ``window_eo``: the sample window's even and odd halves, float32 [n1,
    n2] each.  A CPU tensor takes the plain version; a CUDA tensor launches
    B11."""
    if nbits not in K2.FFUSE_VARIANT_BITS.get(variant, ()):
        raise ValueError(f"front fuse unsupported for variant {variant!r} "
                         f"at {nbits}-bit")
    fac = K2.ffuse_factor(m)
    if fac is None:
        raise ValueError(f"front fuse unsupported length {m}")
    n1, n2 = fac
    streams = front_streams(variant)
    size = streams * 2 * m * abs(nbits) // 8
    if raw.dtype != torch.uint8 or tuple(raw.shape) != (size,):
        raise ValueError(f"raw must be uint8 [{size}], got {raw.dtype} "
                         f"{tuple(raw.shape)}")
    w_e = w_o = None
    if window_eo is not None:
        w_e, w_o = window_eo
        for w in (w_e, w_o):
            if w.dtype != torch.float32 or tuple(w.shape) != (n1, n2) \
                    or w.device != raw.device:
                raise ValueError(f"window_eo must be float32 [{n1}, {n2}] "
                                 f"on {raw.device}")
    if raw.device.type == "cpu":
        return fft2_pass1_front_plain(raw, m, variant, nbits, window_eo,
                                      inverse)
    name = "fft2_pass1_front"
    _kernel_block(n1, n2, name)
    build.require_cuda_contiguous(name, raw=raw, w_e=w_e, w_o=w_o)
    if raw.data_ptr() % 4:  # 8-bit groups are read as one word
        raw = raw.clone()
    dev = raw.device
    out = torch.empty(streams, n1, n2, dtype=torch.complex64, device=dev)
    ctas = K2.column_ctas(n1, n2, dev)  # one partial a CTA
    part = torch.empty(streams * ctas, 3, dtype=torch.float64, device=dev)
    tw = KF.twiddle_table(n1, dev)
    with torch.cuda.device(dev):
        rc = build.library().srtb_fft2_pass1_front(
            raw.data_ptr(), None if w_e is None else w_e.data_ptr(),
            None if w_o is None else w_o.data_ptr(), out.data_ptr(),
            tw.data_ptr(), part.data_ptr(), streams, n1, n2, nbits,
            int(inverse), build.stream_of(raw))
    build.check(rc, name)
    fft2_pass1_front.launches += 1
    # the CTAs' partials, added in float64 in a fixed order on the device
    return out, part.view(streams, ctas, 3).sum(1)


fft2_pass1_front.launches = 0


def front_mean_power(aux: torch.Tensor, n2: int, m: int) -> torch.Tensor:
    """Per-stream mean |X_k|^2 over the m drop-Nyquist R2C bins (float32
    [S]) from pass 1's sums: Parseval along the row transform gives
    sum |F|^2 = n2 sum |B|^2, and F_0 = sum_j2 B[0, j2], so that this is
    ``rfi.mean_power_packed`` one FFT level earlier."""
    return ((n2 * aux[:, 0] + 2.0 * aux[:, 1] * aux[:, 2]) / m).to(
        torch.float32)


def fft2_pass2_spectrum_plain(b: torch.Tensor, thr: torch.Tensor,
                              norm: float, keep=None, premul=None,
                              chirp=None) -> torch.Tensor:
    """The plain PyTorch version of B12: the row FFT, unblock, the
    Hermitian post-process (or the premul pair's X = c E + cw O), stage 1
    given ``thr`` and normalize, the keep mask, the exact chirp, and
    reblock."""
    n1, n2 = b.shape
    m = n1 * n2
    zf = K2.unblock(KF.fft_rows_plain(b))  # F[k], natural order
    if premul is None:
        x = F.hermitian_rfft_post(zf, drop_nyquist=True)
    else:
        g = torch.conj(torch.roll(torch.flip(zf, (-1,)), 1, -1))
        x = K2.unblock(premul[0]) * (0.5 * (zf + g)) \
            + K2.unblock(premul[1]) * (-0.5j * (zf - g))
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    scale = torch.where(rfi.power(x) <= thr, torch.full(
        (), norm, dtype=torch.float32, device=b.device), zero)
    if keep is not None:
        scale = torch.where(K2.unblock(keep), scale, zero)
    re, im = x.real * scale, x.imag * scale
    if chirp is not None:
        c, s = dd.chirp_cos_sin(m, *chirp, device=b.device)
        re, im = re * c - im * s, re * s + im * c
    return torch.complex(re, im).reshape(n2, n1).T.contiguous()


def fft2_pass2_spectrum(b: torch.Tensor, thr: torch.Tensor, norm: float,
                        keep: torch.Tensor | None = None, premul=None,
                        chirp=None,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Pass 2 of the front-fused plan on one stream's intermediate
    ``b complex64 [n1, n2]``: the dedispersed spectrum [n1, n2], k1-major
    blocked.  ``thr``: float32 [1], threshold times the mean power;
    ``keep``: bool [n1, n2] blocked (False = zap); ``premul``: the blocked
    complex64 pair (c, cw) of chirp and chirp times Hermitian twiddle, or
    ``chirp`` = (f_min, df, f_c, dm) for the exact chirp (neither: no
    chirp).  ``out``: where to write the result (a stream's block of the
    caller's [S, n1, n2]), 16-byte aligned.  A CPU tensor takes the plain
    version; a CUDA tensor launches B12 (a view of ``b`` or ``keep`` that
    is not 16-byte aligned is copied first)."""
    if b.dtype != torch.complex64 or b.dim() != 2:
        raise ValueError("fft2_pass2_spectrum: b must be complex64 [n1, n2]")
    n1, n2 = b.shape
    if thr.dtype != torch.float32 or tuple(thr.shape) != (1,) \
            or thr.device != b.device:
        raise ValueError(f"thr must be float32 [1] on {b.device}")
    if keep is not None and (keep.dtype != torch.bool
                             or keep.shape != b.shape
                             or keep.device != b.device):
        raise ValueError(f"keep must be bool [{n1}, {n2}] on {b.device}")
    if premul is not None:
        if chirp is not None:
            raise ValueError("give premul or chirp, not both")
        for p in premul:
            if p.dtype != torch.complex64 or p.shape != b.shape \
                    or p.device != b.device:
                raise ValueError(f"premul must be complex64 [{n1}, {n2}] "
                                 f"on {b.device}")
    build.check_out(out, torch.complex64, b.shape, b.device)
    if b.device.type == "cpu":
        res = fft2_pass2_spectrum_plain(b, thr, norm, keep, premul, chirp)
        return res if out is None else out.copy_(res)
    name = "fft2_pass2_spectrum"
    _kernel_block(n1, n2, name)
    pm_c, pm_cw = premul if premul is not None else (None, None)
    build.require_cuda_contiguous(name, b=b, thr=thr, keep=keep, pm_c=pm_c,
                                  pm_cw=pm_cw, out=out)
    if out is not None and out.data_ptr() % 16:
        raise ValueError(f"{name}: out must be 16-byte aligned")
    f_min, df, f_c, dm = chirp if chirp is not None else (0.0, 0.0, 1.0, 0.0)
    b = KF.aligned(b)
    keep = None if keep is None else KF.aligned(keep)
    if out is None:
        out = torch.empty_like(b)
    with torch.cuda.device(b.device):
        rc = build.library().srtb_fft2_pass2_spectrum(
            b.data_ptr(), out.data_ptr(), thr.data_ptr(),
            None if keep is None else keep.data_ptr(),
            None if pm_c is None else pm_c.data_ptr(),
            None if pm_cw is None else pm_cw.data_ptr(), n1, n2,
            float(np.float32(norm)), int(chirp is not None), float(f_min),
            float(df), float(f_c), dd.chirp_dm_coefficient(f_c, dm),
            build.stream_of(b))
    build.check(rc, name)
    fft2_pass2_spectrum.launches += 1
    return out


fft2_pass2_spectrum.launches = 0


def pass2_spectrum_geometry(n2: int, device: torch.device) -> dict:
    """B12's launch geometry at rows of ``n2`` on ``device``'s card (the
    fields of :data:`fft_rows.GEOMETRY_FIELDS`): CTAs a pair cluster (two
    rows of the row-FFT core), values a CTA, threads, CTAs an SM, the pair
    clusters the card holds at once, registers and local bytes a thread,
    shared bytes a CTA."""
    return KF.query_geometry("srtb_fft2_pass2_spectrum_geometry", n2, device)
