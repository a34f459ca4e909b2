"""K1: MSB-first sub-byte unpack fused with the FFT window, and B13, the
same unpack into blocked planes, packed as the R2C's half-size complex
sequence (``csrc/unpack.cu``; replace ``srtb_tpu/ops/pallas_kernels.py``
``unpack_subbyte_window`` and ``unpack_subbyte_planes_window``)."""

from __future__ import annotations

import torch

from srtb_tpu_torch.kernels import build
from srtb_tpu_torch.ops import unpack as U


def unpack_subbyte_window_plain(data: torch.Tensor, nbits: int,
                                window: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """The plain PyTorch version of K1."""
    return U.unpack(data, nbits, window)


def unpack_subbyte_window(data: torch.Tensor, nbits: int,
                          window: torch.Tensor | None = None,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 [m] -> float32 [(8/nbits) m] for nbits in {1, 2, 4}: MSB-first
    fields, times ``window`` when given, into ``out`` when given (a
    stream's row of the caller's [S, n] samples).  A CPU tensor takes the
    plain version; a CUDA tensor launches K1."""
    if nbits not in (1, 2, 4):
        raise ValueError(f"sub-byte unpack needs nbits in 1/2/4, got {nbits}")
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError("data must be a 1-D uint8 tensor")
    m = data.numel()
    per = 8 // nbits
    if window is not None and (window.dtype != torch.float32
                               or tuple(window.shape) != (per * m,)
                               or window.device != data.device):
        raise ValueError(f"window must be float32 [{per * m}] on "
                         f"{data.device}")
    build.check_out(out, torch.float32, (per * m,), data.device)
    if data.device.type == "cpu":
        res = unpack_subbyte_window_plain(data, nbits, window)
        return res if out is None else out.copy_(res)
    name = "unpack_subbyte_window"
    build.require_cuda_contiguous(name, data=data, window=window, out=out)
    for arg, t in (("window", window), ("out", out)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    if out is None:
        out = torch.empty(per * m, dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        rc = build.library().srtb_unpack_subbyte_window(
            data.data_ptr(), None if window is None else window.data_ptr(),
            out.data_ptr(), m, nbits, build.stream_of(data))
    build.check(rc, name)
    unpack_subbyte_window.launches += 1
    return out


unpack_subbyte_window.launches = 0


def unpack_subbyte_planes_window_plain(data: torch.Tensor, nbits: int,
                                       window_planes: torch.Tensor | None
                                       = None) -> torch.Tensor:
    """The plain PyTorch version of B13."""
    planes = U.unpack_subbyte_planes(data, nbits)
    if window_planes is not None:
        planes = planes * window_planes
    return torch.complex(planes[0::2], planes[1::2])


def unpack_subbyte_planes_window(data: torch.Tensor, nbits: int,
                                 window_planes: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """uint8 [m] -> the packed plane pairs z complex64 [4/nbits, m] of
    ``ops.fft.subbyte_planes_to_packed``: plane k holds field k (MSB-first)
    of every byte, times ``window_planes [8/nbits, m]`` when given, and
    z[k'] = plane[2k'] + i plane[2k'+1].  A CPU tensor takes the plain
    version; a CUDA tensor launches B13."""
    if nbits not in (1, 2, 4):
        raise ValueError(f"sub-byte unpack needs nbits in 1/2/4, got {nbits}")
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError("data must be a 1-D uint8 tensor")
    m = data.numel()
    count = 8 // nbits
    if window_planes is not None and (
            window_planes.dtype != torch.float32
            or tuple(window_planes.shape) != (count, m)
            or window_planes.device != data.device):
        raise ValueError(f"window_planes must be float32 [{count}, {m}] on "
                         f"{data.device}")
    if data.device.type == "cpu":
        return unpack_subbyte_planes_window_plain(data, nbits, window_planes)
    name = "unpack_subbyte_planes_window"
    build.require_cuda_contiguous(name, data=data, window=window_planes)
    out = torch.empty(count // 2, m, dtype=torch.complex64,
                      device=data.device)
    with torch.cuda.device(data.device):
        rc = build.library().srtb_unpack_subbyte_planes_window(
            data.data_ptr(),
            None if window_planes is None else window_planes.data_ptr(),
            out.data_ptr(), m, nbits, build.stream_of(data))
    build.check(rc, name)
    unpack_subbyte_planes_window.launches += 1
    return out


unpack_subbyte_planes_window.launches = 0
