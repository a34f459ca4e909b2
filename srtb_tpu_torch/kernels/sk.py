"""K3 and K4: spectral-kurtosis statistics, then the zap and the power
time series in one more read (``csrc/sk.cu``; replace the two passes of
``srtb_tpu/ops/pallas_kernels.py`` ``sk_zap_timeseries``)."""

from __future__ import annotations

import torch

from srtb_tpu_torch.kernels import build
from srtb_tpu_torch.ops import rfi


def _check_waterfall(wf: torch.Tensor) -> None:
    if wf.dtype != torch.complex64 or wf.dim() != 2:
        raise ValueError("waterfall must be a 2-D complex64 tensor [F, T]")


def sk_stats_plain(wf: torch.Tensor):
    """The plain PyTorch version of K3: per-row sum |x|^2 and sum |x|^4
    (accumulated in float64, rounded to float32, as the kernel does) and
    the first-sample power."""
    p = rfi.power(wf)
    p64 = p.to(torch.float64)
    return (p64.sum(-1).to(torch.float32),
            (p64 * p64).sum(-1).to(torch.float32), p[:, 0].clone())


def sk_stats(wf: torch.Tensor):
    """complex64 waterfall [F, T] -> (s2, s4, fs0), each float32 [F].
    A CPU tensor takes the plain version; a CUDA tensor launches K3."""
    _check_waterfall(wf)
    if wf.device.type == "cpu":
        return sk_stats_plain(wf)
    name = "sk_stats"
    build.require_cuda_contiguous(name, wf=wf)
    f_len, t_len = wf.shape
    s2, s4, fs0 = (torch.empty(f_len, dtype=torch.float32, device=wf.device)
                   for _ in range(3))
    with torch.cuda.device(wf.device):
        rc = build.library().srtb_sk_stats(
            wf.data_ptr(), s2.data_ptr(), s4.data_ptr(), fs0.data_ptr(),
            f_len, t_len, build.stream_of(wf))
    build.check(rc, name)
    sk_stats.launches += 1
    return s2, s4, fs0


sk_stats.launches = 0


def sk_apply_timeseries_plain(wf: torch.Tensor, zap: torch.Tensor):
    """The plain PyTorch version of K4: zapped rows selected to 0 (so NaN
    or Inf there becomes 0), and the frequency sum of |x|^2 per time
    sample, accumulated in float64 and rounded to float32."""
    out = torch.where(zap[:, None],
                      torch.zeros((), dtype=wf.dtype, device=wf.device), wf)
    ts = rfi.power(out).to(torch.float64).sum(0).to(torch.float32)
    return out, ts


def sk_apply_timeseries(wf: torch.Tensor, zap: torch.Tensor,
                        out: torch.Tensor | None = None):
    """complex64 waterfall [F, T] and bool zap verdict [F] ->
    (zapped waterfall [F, T], into ``out`` when given, time series float32
    [T]).  A CPU tensor takes the plain version; a CUDA tensor launches
    K4."""
    _check_waterfall(wf)
    f_len, t_len = wf.shape
    if zap.dtype != torch.bool or tuple(zap.shape) != (f_len,) \
            or zap.device != wf.device:
        raise ValueError(f"zap must be bool [{f_len}] on {wf.device}")
    build.check_out(out, torch.complex64, wf.shape, wf.device)
    if wf.device.type == "cpu":
        res, ts = sk_apply_timeseries_plain(wf, zap)
        return (res if out is None else out.copy_(res)), ts
    name = "sk_apply_timeseries"
    build.require_cuda_contiguous(name, wf=wf, zap=zap, out=out)
    if out is None:
        out = torch.empty_like(wf)
    ts = torch.empty(t_len, dtype=torch.float32, device=wf.device)
    with torch.cuda.device(wf.device):
        rc = build.library().srtb_sk_apply_timeseries(
            wf.data_ptr(), zap.data_ptr(), out.data_ptr(), ts.data_ptr(),
            f_len, t_len, build.stream_of(wf))
    build.check(rc, name)
    sk_apply_timeseries.launches += 1
    return out, ts


sk_apply_timeseries.launches = 0


def sk_zap_timeseries(wf: torch.Tensor, sk_threshold: float,
                      out: torch.Tensor | None = None):
    """The fused waterfall tail, as the reference's ``sk_zap_timeseries``:
    K3 statistics, the per-row SK verdict, then K4 (into ``out`` when
    given).  Returns ``(zapped waterfall [F, T], zero_count [], ts [T])``:
    zero_count counts rows zapped or with a zero first sample; ts is not
    yet mean-subtracted."""
    s2, s4, fs0 = sk_stats(wf)
    zap = rfi.sk_zap_decision(s2, s4, wf.shape[-1], sk_threshold)
    zero_count = torch.sum((zap | (fs0 == 0)).to(torch.int32),
                           dtype=torch.int32)
    out, ts = sk_apply_timeseries(wf, zap, out)
    return out, zero_count, ts
