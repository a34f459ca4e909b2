"""B3: the coherent-dedispersion chirp multiply with the phase made in the
kernel (``csrc/dedisperse.cu``; replaces ``srtb_tpu/ops/pallas_kernels.py``
``dedisperse_df64``).  The staged plan without ``use_pallas`` runs it
after the plain RFI stage 1 and manual mask."""

from __future__ import annotations

import torch

from srtb_tpu_torch.kernels import build
from srtb_tpu_torch.ops import dedisperse as dd


def dedisperse_plain(spec: torch.Tensor, f_min: float, df: float, f_c: float,
                     dm: float, i0: int = 0) -> torch.Tensor:
    """The plain PyTorch version of B3: ``spec * (c + i s)`` with the chirp
    of channels i0 .. i0+n-1 from ``dd.chirp_cos_sin``."""
    c, s = dd.chirp_cos_sin(spec.shape[-1], f_min, df, f_c, dm, spec.device,
                            i0)
    re, im = spec.real, spec.imag
    return torch.complex(re * c - im * s, re * s + im * c)


def dedisperse(spec: torch.Tensor, f_min: float, df: float, f_c: float,
               dm: float, i0: int = 0,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """complex64 spectrum [n] -> dedispersed [n] (into ``out`` when given):
    bin i times exp(-2 pi i frac(k)) with k the chirp phase of channel
    ``i0 + i`` at f = f_min + df (i0 + i).  A CPU tensor takes the plain
    version; a CUDA tensor launches B3."""
    if spec.dtype != torch.complex64 or spec.dim() != 1:
        raise ValueError("spec must be a 1-D complex64 tensor")
    if i0 < 0:
        raise ValueError(f"i0 must be >= 0, got {i0}")
    build.check_out(out, torch.complex64, spec.shape, spec.device)
    if spec.device.type == "cpu":
        res = dedisperse_plain(spec, f_min, df, f_c, dm, i0)
        return res if out is None else out.copy_(res)
    name = "dedisperse"
    build.require_cuda_contiguous(name, spec=spec, out=out)
    if out is None:
        out = torch.empty_like(spec)
    with torch.cuda.device(spec.device):
        rc = build.library().srtb_dedisperse(
            spec.data_ptr(), out.data_ptr(), spec.shape[0], int(i0),
            float(f_min), float(df), float(f_c),
            dd.chirp_dm_coefficient(f_c, dm), build.stream_of(spec))
    build.check(rc, name)
    dedisperse.launches += 1
    return out


dedisperse.launches = 0
