"""K2: RFI stage 1 + normalize + manual keep mask + coherent-dedispersion
chirp in one pass (``csrc/rfi_chirp.cu``; replaces
``srtb_tpu/ops/pallas_kernels.py`` ``rfi_s1_dedisperse_df64``)."""

from __future__ import annotations

import numpy as np
import torch

from srtb_tpu_torch.kernels import build
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import rfi


def rfi_threshold(spec: torch.Tensor, threshold: float) -> torch.Tensor:
    """threshold * mean |x|^2 over the last axis of ``spec [..., n]``,
    float32 [..., 1] on ``spec``'s device ([1] for one stream, [S, 1] for
    S): the reduction that runs before K2 (as in the reference's wrapper),
    whose result the kernel reads on the device without a host sync."""
    return np.float32(threshold) * rfi.mean_power(spec)


def rfi_s1_dedisperse_plain(spec: torch.Tensor, thr: torch.Tensor,
                            norm: float, f_min: float, df: float,
                            f_c: float, dm: float,
                            keep: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of K2, given the threshold ``thr``."""
    p = rfi.power(spec)
    zero = torch.zeros((), dtype=torch.float32, device=spec.device)
    scale = torch.where(p <= thr, torch.full((), norm, dtype=torch.float32,
                                             device=spec.device), zero)
    if keep is not None:
        scale = torch.where(keep, scale, zero)
    re = spec.real * scale
    im = spec.imag * scale
    c, s = dd.chirp_cos_sin(spec.shape[-1], f_min, df, f_c, dm, spec.device)
    return torch.complex(re * c - im * s, re * s + im * c)


def rfi_s1_dedisperse(spec: torch.Tensor, thr: torch.Tensor, norm: float,
                      f_min: float, df: float, f_c: float, dm: float,
                      keep: torch.Tensor | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """complex64 spectrum [n] -> zapped (|x|^2 > ``thr``, the float32 [1]
    tensor from :func:`rfi_threshold`), normalized, manually masked
    (``keep`` bool [n], False = zap) and dedispersed [n], into ``out``
    when given (a stream's row of the caller's [S, n] spectrum).  A CPU
    tensor takes the plain version; a CUDA tensor launches K2."""
    if spec.dtype != torch.complex64 or spec.dim() != 1:
        raise ValueError("spec must be a 1-D complex64 tensor")
    n = spec.shape[0]
    if keep is not None and (keep.dtype != torch.bool
                             or tuple(keep.shape) != (n,)
                             or keep.device != spec.device):
        raise ValueError(f"keep must be bool [{n}] on {spec.device}")
    if thr.dtype != torch.float32 or tuple(thr.shape) != (1,) \
            or thr.device != spec.device:
        raise ValueError(f"thr must be float32 [1] on {spec.device}")
    build.check_out(out, torch.complex64, spec.shape, spec.device)
    if spec.device.type == "cpu":
        res = rfi_s1_dedisperse_plain(spec, thr, norm, f_min, df, f_c, dm,
                                      keep)
        return res if out is None else out.copy_(res)
    name = "rfi_s1_dedisperse"
    build.require_cuda_contiguous(name, spec=spec, keep=keep, thr=thr,
                                  out=out)
    if out is None:
        out = torch.empty_like(spec)
    with torch.cuda.device(spec.device):
        rc = build.library().srtb_rfi_s1_dedisperse(
            spec.data_ptr(), None if keep is None else keep.data_ptr(),
            thr.data_ptr(), out.data_ptr(), n, float(np.float32(norm)),
            float(f_min), float(df), float(f_c),
            dd.chirp_dm_coefficient(f_c, dm), build.stream_of(spec))
    build.check(rc, name)
    rfi_s1_dedisperse.launches += 1
    return out


rfi_s1_dedisperse.launches = 0
