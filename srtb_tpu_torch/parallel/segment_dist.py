"""The DM-trial segment step over a ("dm", "seq") mesh (port of
``srtb_tpu/parallel/segment_dist.py``).

The reference runs one ``shard_map`` program over the mesh: the
segment's samples sharded over ``seq``, the DM trials over ``dm``.  The
port runs the same program in every rank of the mesh (one process a
device, ``parallel/mesh.py``), each rank holding ``segment_bytes /
n_seq`` contiguous bytes.  Per segment:

1. unpack and window the shard with its slice of the window (K1 for the
   formats it takes, as ``SegmentProcessor._unpack``);
2. the distributed R2C per stream, Nyquist bin dropped
   (``parallel/dist_fft.py``: 3 all-to-all and 2 point-to-point
   exchanges over ``seq`` a stream; its legs by ``SRTB_DIST_ROWS_IMPL``,
   B6 under ``pallas``);
3. RFI stage 1: the mean power summed over ``seq`` (one all-reduce for
   every stream), the zap and normalize, the mask's shard;
4. per local trial (this ``dm`` rank's block of the trials): B3 at the
   trial's DM from the shard's first channel ``i0 = seq_rank n_spectrum /
   n_seq`` (no chirp bank: B3 makes the exact phase, which both of the
   reference's chirp modes approximate), the backward row C2C of the
   shard's whole channels with the de-window, and the SK zap with the
   partial time series (K3 + K4);
5. the local trials' zapped-channel counts and partial series stacked,
   each summed over ``seq`` in one all-reduce, then the mean subtraction
   and the boxcar cascade;
6. the per-trial summaries replicated over ``dm`` (scatter into zeros,
   then an all-reduce each: 3); the time series stays ``dm``-sharded.

That is the reference's collective inventory a segment (its
``test_parallel.py`` pins it): 3 all-to-all and 2 point-to-point over
``seq`` a stream, 3 sums over ``seq``, 3 over ``dm``.

At a mesh of (dm 1, seq 1) with the ``xla`` legs the step is the one
card's (``SegmentProcessor``'s front once: K1, the cuFFT R2C, stage 1 and
the mask; then per trial B3 into one reused buffer and the processor's
own waterfall tail, ``_waterfall_detect``).  Only the per-trial
summaries and the time series are kept either way, so the peak device
memory does not grow with the number of trials, and nothing in the trial
loop reads the card from the host.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.kernels.dedisperse import dedisperse
from srtb_tpu_torch.kernels.sk import sk_zap_timeseries
from srtb_tpu_torch.kernels.unpack import unpack_subbyte_window
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.ops import fft as F
from srtb_tpu_torch.ops import rfi
from srtb_tpu_torch.ops import unpack as U
from srtb_tpu_torch.ops import window as W
from srtb_tpu_torch.parallel import dist_fft as DF
from srtb_tpu_torch.parallel import mesh as M
from srtb_tpu_torch.pipeline.segment import (K1_VARIANTS, SegmentProcessor,
                                             unpack_streams)


class DistSegmentResult(NamedTuple):
    zero_count: torch.Tensor      # [n_dm, S]            (replicated)
    signal_counts: torch.Tensor   # [n_dm, S, n_boxcars] (replicated)
    snr_peaks: torch.Tensor       # [n_dm, S, n_boxcars] (replicated)
    time_series: torch.Tensor     # [n_dm / dm ranks, S, T] (dm-sharded)


def mesh_axes(mesh) -> tuple[int, int]:
    """``(dm, seq)`` sizes of ``mesh``: a mapping or an object with a
    ``shape`` mapping (as a device mesh has), None for one device."""
    if mesh is None:
        return 1, 1
    shape = getattr(mesh, "shape", mesh)
    return int(shape.get("dm", 1)), int(shape.get("seq", 1))


def _as_mesh(mesh) -> M.Mesh:
    """A mesh of the port (``parallel/mesh.Mesh``) for ``mesh``: itself,
    or for None or a shape mapping, the first dm x seq ranks of the
    default group (the degenerate (1, 1) mesh without one)."""
    if isinstance(mesh, M.Mesh):
        return mesh
    n_dm, n_seq = mesh_axes(mesh)
    if not M.initialized():
        if n_dm * n_seq > 1:
            raise ValueError(f"a mesh of dm={n_dm} x seq={n_seq} needs a "
                             "process group (distributed.initialize)")
        return M.Mesh(np.zeros((1, 1), dtype=np.int64))
    return M.Mesh(np.arange(n_dm * n_seq).reshape(n_dm, n_seq))


class DistSegmentProcessor:
    """The DM-trial step for one baseband segment and a DM trial list
    (module docstring).  ``mesh``: a ``parallel/mesh.Mesh`` with axes
    ("dm", "seq"), or a shape mapping, or None (one device)."""

    def __init__(self, cfg: Config, mesh=None, dm_list=None,
                 window_name: str = W.DEFAULT_WINDOW, device=None):
        self.mesh = _as_mesh(mesh)
        n_dm_dev, n_seq = mesh_axes(self.mesh)
        self.n_dm_devices, self.n_seq = n_dm_dev, n_seq
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
        # who runs the distributed FFT's legs (the reference's knob)
        self.rows_impl = DF.resolve_rows_impl(
            os.environ.get("SRTB_DIST_ROWS_IMPL", "xla"), self.device)
        # the one card's step (module docstring), or the sharded one
        self.sharded = n_dm_dev * n_seq > 1 or self.rows_impl != "xla"
        zap = rfi.rfi_ranges_to_mask(
            rfi.eval_rfi_ranges(cfg.mitigate_rfi_freq_list), n_spectrum,
            cfg.baseband_freq_low, cfg.baseband_bandwidth)
        self.rfi_zap = None if zap is None else \
            torch.from_numpy(zap).to(self.device)
        if self.sharded:
            self._init_sharded(n, n_spectrum, channel_count, zap)

    def _init_sharded(self, n: int, n_spectrum: int, channel_count: int,
                      zap) -> None:
        mesh, sp, n_seq = self.mesh, self.processor, self.n_seq
        self.m = n_spectrum
        self.n1, self.n2 = DF.split(n_spectrum, n_seq)
        if sp._segment_bytes % n_seq or n % n_seq:
            raise ValueError(f"a segment of {sp._segment_bytes} bytes does "
                             f"not split into {n_seq} shards")
        self.shard_bytes = sp._segment_bytes // n_seq
        self.ch_local = channel_count // n_seq
        self.t = det.trimmed_length(sp.watfft_len, sp.time_reserved_count)
        self.trials_local = len(self.dm_list) // self.n_dm_devices
        if mesh.coords is None:
            return  # a rank outside the mesh takes no part
        seq, dm = mesh.index("seq"), mesh.index("dm")
        n_local, m_local = n // n_seq, n_spectrum // n_seq
        self.i0 = seq * m_local
        self.local_dms = self.dm_list[dm * self.trials_local:
                                      (dm + 1) * self.trials_local]
        self.window_block = None if sp.window is None else \
            sp.window[seq * n_local:(seq + 1) * n_local]
        self.mask_block = None if zap is None else \
            self.rfi_zap[seq * m_local:(seq + 1) * m_local]

    # ------------------------------------------------ the one card's step

    def front(self, raw: torch.Tensor) -> torch.Tensor:
        """Device bytes -> the stage-1 cleaned spectrum [S, n/2], once a
        segment (the one card's step)."""
        sp, cfg = self.processor, self.cfg
        spec = F.rfft_drop_nyquist(sp._unpack(raw))
        return rfi.mitigate_rfi_manual(
            rfi.mitigate_rfi_average_and_normalize(
                spec, cfg.mitigate_rfi_average_method_threshold,
                sp.norm_coeff), self.rfi_zap)

    def chirp(self, spec: torch.Tensor, dm: float, out: torch.Tensor,
              i0: int = 0) -> torch.Tensor:
        """B3 once a stream: ``spec`` (channels from ``i0``) dedispersed
        at ``dm`` into ``out``."""
        sp = self.processor
        for s in range(spec.shape[0]):
            dedisperse(spec[s], sp.f_min, sp.df, sp.f_c, float(dm), i0=i0,
                       out=out[s])
        return out

    def _run_one_card(self, raw: torch.Tensor) -> DistSegmentResult:
        spec = self.front(raw)
        buf = torch.empty_like(spec)
        zero, counts, peaks, series = [], [], [], []
        for dm in self.dm_list:
            _wf, res = self.processor._waterfall_detect(
                self.chirp(spec, dm, buf))
            del _wf
            zero.append(res.zero_count)
            counts.append(res.signal_counts)
            peaks.append(res.snr_peaks)
            series.append(res.time_series)
        return DistSegmentResult(torch.stack(zero), torch.stack(counts),
                                 torch.stack(peaks), torch.stack(series))

    # --------------------------------------------------- the sharded step

    def _unpack_shard(self, raw: torch.Tensor) -> torch.Tensor:
        """The shard's bytes -> windowed float32 samples [S, n / n_seq]:
        K1 a stream for 1/2/4 bits of ``K1_VARIANTS``, else the plain
        unpack of the variant."""
        sp = self.processor
        bits, variant = self.cfg.baseband_input_bits, sp.fmt.unpack_variant
        if bits not in (1, 2, 4) or variant not in K1_VARIANTS:
            return unpack_streams(raw, variant, bits, self.window_block)
        rows = raw[None] if variant == "simple" else \
            U.deinterleave_bytes(raw, variant)
        out = torch.empty(sp.streams, sp.n // self.n_seq,
                          dtype=torch.float32, device=raw.device)
        for s in range(sp.streams):
            unpack_subbyte_window(rows[s], bits, self.window_block,
                                  out=out[s])
        return out

    def _spectrum_shard(self, raw: torch.Tensor) -> torch.Tensor:
        """Steps 1-3: this rank's shard of the cleaned spectrum
        [S, n_spectrum / n_seq]."""
        mesh, cfg, sp = self.mesh, self.cfg, self.processor
        xs = self._unpack_shard(raw)
        spec = torch.empty(xs.shape[0], self.m // self.n_seq,
                           dtype=torch.complex64, device=xs.device)
        for s in range(xs.shape[0]):
            zf = DF._dist_fft_block(
                F.pack_even_odd(xs[s]), mesh=mesh, axis_name="seq",
                n1=self.n1, n2=self.n2, n_dev=self.n_seq, inverse=False,
                rows_impl=self.rows_impl, len_cap=cfg.fft_len_cap or None)
            spec[s] = DF._dist_rfft_post_block(
                zf, mesh=mesh, axis_name="seq", m=self.m, n_dev=self.n_seq)
            del zf
        del xs
        # the global mean power: the shards' sums of |x|^2, one sum over
        # seq for every stream
        norm = torch.linalg.vector_norm(torch.view_as_real(spec),
                                        dim=(-2, -1))
        mean = mesh.psum(norm * norm, "seq")[:, None] / self.m
        spec = rfi.mitigate_rfi_s1_given_mean(
            spec, mean, cfg.mitigate_rfi_average_method_threshold,
            sp.norm_coeff)
        return rfi.mitigate_rfi_manual(spec, self.mask_block)

    def _run_sharded(self, raw: torch.Tensor) -> DistSegmentResult:
        mesh, cfg, sp = self.mesh, self.cfg, self.processor
        spec = self._spectrum_shard(raw)
        streams = spec.shape[0]
        buf = torch.empty_like(spec)
        wf_out = torch.empty(streams, self.ch_local, sp.watfft_len,
                             dtype=torch.complex64, device=spec.device)
        sk_thr = cfg.mitigate_rfi_spectral_kurtosis_threshold
        zero = torch.empty(len(self.local_dms), streams, dtype=torch.int32,
                           device=spec.device)
        series = torch.empty(len(self.local_dms), streams, self.t,
                             dtype=torch.float32, device=spec.device)
        for j, dm in enumerate(self.local_dms):
            # the shard's channels are whole sub-bands: the row C2C, the
            # de-window and the SK zap need no other shard
            wf = F.waterfall_c2c(self.chirp(spec, dm, buf, self.i0),
                                 self.ch_local, sp.watfft_dewindow)
            for s in range(streams):
                _, zero[j, s], ts = sk_zap_timeseries(wf[s], sk_thr,
                                                      out=wf_out[s])
                series[j, s] = ts[:self.t]
            del wf
        del spec, buf, wf_out
        series, zero = mesh.psum(series, "seq"), mesh.psum(zero, "seq")
        # the cascade a trial, on the one card's [S, t] shapes (so its
        # sums run in the same order there)
        dets = [det.detect_from_time_series(
            series[j], zero[j], cfg.signal_detect_signal_noise_threshold,
            cfg.signal_detect_max_boxcar_length)
            for j in range(len(self.local_dms))]
        res = det.DetectResult(*(
            torch.stack([getattr(d, f) for d in dets])
            if isinstance(getattr(dets[0], f), torch.Tensor)
            else getattr(dets[0], f) for f in det.DetectResult._fields))
        dm_idx, local = mesh.index("dm"), len(self.local_dms)

        def replicate(x: torch.Tensor) -> torch.Tensor:
            full = torch.zeros((local * self.n_dm_devices,) + x.shape[1:],
                               dtype=x.dtype, device=x.device)
            full[dm_idx * local:(dm_idx + 1) * local] = x
            return mesh.psum(full, "dm")

        return DistSegmentResult(replicate(res.zero_count),
                                 replicate(res.signal_counts),
                                 replicate(res.snr_peaks), res.time_series)

    # ------------------------------------------------------------ entry

    def shard(self, raw) -> torch.Tensor:
        """This rank's bytes of one segment's uint8 bytes (numpy or torch,
        the whole segment) on the device: the whole segment on the one
        card's step, a contiguous ``1 / n_seq`` of it sharded."""
        if not self.sharded:
            return self.processor._as_device_bytes(raw)
        if isinstance(raw, np.ndarray):
            raw = torch.from_numpy(np.ascontiguousarray(raw, dtype=np.uint8))
        if raw.dtype != torch.uint8 or tuple(raw.shape) != (
                self.processor._segment_bytes,):
            raise ValueError(
                f"segment must be uint8 [{self.processor._segment_bytes}], "
                f"got {raw.dtype} {tuple(raw.shape)}")
        lo = self.mesh.index("seq") * self.shard_bytes
        return raw[lo:lo + self.shard_bytes].to(self.device,
                                                non_blocking=True)

    def run_device(self, raw: torch.Tensor) -> DistSegmentResult:
        """Every trial on this rank's device bytes (:meth:`shard`),
        enqueued on the current stream; reads nothing on the host."""
        if not self.sharded:
            return self._run_one_card(raw)
        if self.mesh.coords is None:
            raise ValueError(f"rank {M.rank()} is outside the mesh "
                             f"{self.mesh.devices.tolist()}")
        return self._run_sharded(raw)

    def process(self, raw) -> DistSegmentResult:
        """One segment's uint8 bytes (numpy or torch), serially."""
        return self.run_device(self.shard(raw))
