"""The DM-trial segment step on one card (port of
``srtb_tpu/parallel/segment_dist.py`` at a mesh of (dm 1, seq 1)).

The reference runs one ``shard_map`` program over a ("dm", "seq") mesh:
the segment's samples sharded over ``seq``, the DM trials over ``dm``.
On one card that program is, per segment:

1. unpack and window (the segment processor's ``_unpack``: K1 for the
   1/2/4-bit formats it takes);
2. the R2C FFT with the Nyquist bin dropped (torch, as the reference's
   XLA);
3. RFI stage 1 once: the average-threshold zap and normalize, then the
   manual mask (torch, the reference's order, no chirp);
4. per trial, B3 at the trial's DM into one reused buffer, then the
   processor's own waterfall tail (``SegmentProcessor._waterfall_detect``:
   K3 + K4, B8 or torch, by the plan's branch rule; the reference proves
   its tail equal to the single-device one).

Only the per-trial summaries and the [n_dm, S, t] time series are kept,
so the peak device memory does not grow with the number of trials, and
nothing in the trial loop reads the card from the host.  A mesh or a
process group of more than one device is ROADMAP A8.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.kernels.dedisperse import dedisperse
from srtb_tpu_torch.ops import fft as F
from srtb_tpu_torch.ops import rfi
from srtb_tpu_torch.ops import window as W
from srtb_tpu_torch.pipeline.segment import SegmentProcessor


class DistSegmentResult(NamedTuple):
    zero_count: torch.Tensor      # [n_dm, S]
    signal_counts: torch.Tensor   # [n_dm, S, n_boxcars]
    snr_peaks: torch.Tensor       # [n_dm, S, n_boxcars]
    time_series: torch.Tensor     # [n_dm, S, T]


def mesh_axes(mesh) -> tuple[int, int]:
    """``(dm, seq)`` sizes of ``mesh``: a mapping or an object with a
    ``shape`` mapping (as a device mesh has), None for one device."""
    if mesh is None:
        return 1, 1
    shape = getattr(mesh, "shape", mesh)
    return int(shape.get("dm", 1)), int(shape.get("seq", 1))


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DistSegmentProcessor:
    """The DM-trial step for one baseband segment and a DM trial list, on
    one card (module docstring)."""

    def __init__(self, cfg: Config, mesh=None, dm_list=None,
                 window_name: str = W.DEFAULT_WINDOW, device=None):
        n_dm_dev, n_seq = mesh_axes(mesh)
        if n_dm_dev * n_seq > 1 or _world_size() > 1:
            raise NotImplementedError(
                f"a DM search over more than one device (mesh dm={n_dm_dev}"
                f", seq={n_seq}, world size {_world_size()}) is not ported "
                "yet (ROADMAP A8: parallel/*)")
        if dm_list is None:
            dm_list = cfg.dm_list or [cfg.dm]
        if len(dm_list) % n_dm_dev:
            raise ValueError("len(dm_list) must divide by dm-axis size")
        self.dm_list = np.asarray(dm_list, dtype=np.float64)
        n = cfg.baseband_input_count
        n_spectrum = n // 2
        channel_count = min(cfg.spectrum_channel_count, n_spectrum)
        if channel_count % n_seq:
            raise ValueError("spectrum_channel_count must divide by seq axis")
        if n_spectrum % channel_count:
            raise ValueError(
                f"spectrum_channel_count {channel_count} must divide "
                f"the {n_spectrum}-channel spectrum for the "
                "distributed plan (power-of-two counts always do); the "
                "single-chip pipeline handles non-dividing counts by "
                "truncation")
        self.cfg = cfg
        self.processor = sp = SegmentProcessor(cfg, window_name=window_name,
                                               device=device)
        self.device = sp.device
        zap = rfi.rfi_ranges_to_mask(
            rfi.eval_rfi_ranges(cfg.mitigate_rfi_freq_list), n_spectrum,
            cfg.baseband_freq_low, cfg.baseband_bandwidth)
        self.rfi_zap = None if zap is None else \
            torch.from_numpy(zap).to(self.device)

    def front(self, raw: torch.Tensor) -> torch.Tensor:
        """Device bytes -> the stage-1 cleaned spectrum [S, n/2] (steps 1-3
        of the module docstring), once a segment."""
        sp, cfg = self.processor, self.cfg
        spec = F.rfft_drop_nyquist(sp._unpack(raw))
        return rfi.mitigate_rfi_manual(
            rfi.mitigate_rfi_average_and_normalize(
                spec, cfg.mitigate_rfi_average_method_threshold,
                sp.norm_coeff), self.rfi_zap)

    def chirp(self, spec: torch.Tensor, dm: float,
              out: torch.Tensor) -> torch.Tensor:
        """B3 once a stream: ``spec`` dedispersed at ``dm`` into ``out``."""
        sp = self.processor
        for s in range(spec.shape[0]):
            dedisperse(spec[s], sp.f_min, sp.df, sp.f_c, float(dm),
                       out=out[s])
        return out

    def run_device(self, raw: torch.Tensor) -> DistSegmentResult:
        """Every trial on one segment's device bytes, enqueued on the
        current stream; reads nothing on the host."""
        spec = self.front(raw)
        buf = torch.empty_like(spec)
        zero, counts, peaks, series = [], [], [], []
        for dm in self.dm_list:
            _wf, det = self.processor._waterfall_detect(
                self.chirp(spec, dm, buf))
            del _wf
            zero.append(det.zero_count)
            counts.append(det.signal_counts)
            peaks.append(det.snr_peaks)
            series.append(det.time_series)
        return DistSegmentResult(torch.stack(zero), torch.stack(counts),
                                 torch.stack(peaks), torch.stack(series))

    def process(self, raw) -> DistSegmentResult:
        """One segment's uint8 bytes (numpy or torch), serially."""
        return self.run_device(self.processor._as_device_bytes(raw))
