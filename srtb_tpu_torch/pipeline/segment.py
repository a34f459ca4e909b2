"""The segment processor (port of ``srtb_tpu/pipeline/segment.py``, one
plan).

Device chain, per segment of raw bytes (ref call stack: SURVEY.md §3.2):

  K1 unpack (+window) -> R2C FFT, Nyquist bin dropped -> mean power
  (the stage-1 threshold) -> K2 RFI stage 1 + normalize + manual mask +
  chirp -> waterfall backward C2C (+de-window) -> K3 spectral-kurtosis
  statistics -> SK verdict -> K4 zap + time series -> boxcar detection

K1..K4 are the hand-written kernels of ``srtb_tpu_torch/kernels``; the
FFTs are ``torch.fft`` (cuFFT on the card).  This is the plan the JAX
package runs with ``use_pallas = 1`` and ``use_pallas_sk = 1``, the
example J1644-4559 configuration's options.  The reference's other plans
(its XLA-only chain, four-step, staged and fused-tail forms) compute the
same function in other kernel arrangements, so ``use_pallas``,
``use_pallas_sk``, ``fft_strategy`` in {auto, monolithic, four_step} and
the "auto" fusion knobs all run this plan.  Settings that ask for
something this plan does not do raise instead of being ignored.

Complex data stays ``complex64`` (interleaved), as ``torch.fft`` produces
it; the JAX package's stacked ``[2, ...]`` (re, im) form is built only by
the tests that compare the two.
"""

from __future__ import annotations

import numpy as np
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import formats
from srtb_tpu_torch.kernels.rfi_chirp import (rfi_s1_dedisperse,
                                                rfi_threshold)
from srtb_tpu_torch.kernels.sk import sk_zap_timeseries
from srtb_tpu_torch.kernels.unpack import unpack_subbyte_window
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.ops import detect as det
from srtb_tpu_torch.ops import fft as F
from srtb_tpu_torch.ops import rfi
from srtb_tpu_torch.ops import unpack as U
from srtb_tpu_torch.ops import window as W
from srtb_tpu_torch.utils.device import resolve_device
from srtb_tpu_torch.utils.logging import log


def check_plan(cfg: Config) -> None:
    """Raise for settings the port's one plan does not implement."""
    def no(what: str, item: str) -> None:
        raise NotImplementedError(f"{what} is not ported yet ({item})")

    if str(cfg.fused_tail).lower() == "on":
        no("fused_tail = on", "ROADMAP B8/B12: fused-tail kernels")
    if str(cfg.front_fuse).lower() == "on":
        no("front_fuse = on", "ROADMAP B11/B12: front-fused staged kernels")
    if str(cfg.ingest_ring).lower() == "on":
        no("ingest_ring = on", "ROADMAP A4: the ingest ring")
    if cfg.quality_stats:
        no("quality_stats", "ROADMAP A7: quality statistics")
    if cfg.search_mode != "single_pulse":
        no(f"search_mode = {cfg.search_mode}",
           "ROADMAP A6: periodicity search")
    if cfg.micro_batch_segments > 1:
        no("micro_batch_segments > 1", "ROADMAP A6: micro-batching")
    if cfg.fft_strategy not in ("auto", "monolithic", "four_step"):
        no(f"fft_strategy = {cfg.fft_strategy}",
           "ROADMAP B6-B12: row-FFT and four-step Pallas kernels")


class SegmentProcessor:
    """Owns the per-segment constants (window, de-window, RFI keep mask,
    normalization coefficient, reserved-sample count) on ``device`` and
    runs the device chain on one segment at a time."""

    def __init__(self, cfg: Config, window_name: str = W.DEFAULT_WINDOW,
                 device=None):
        check_plan(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fmt = formats.resolve(cfg.baseband_format_type)
        n = cfg.baseband_input_count
        if n & (n - 1):
            raise ValueError("baseband_input_count must be a power of 2")
        self.n = n
        self.n_spectrum = n // 2  # after R2C + drop-Nyquist
        self.channel_count = min(cfg.spectrum_channel_count, self.n_spectrum)
        self.watfft_len = self.n_spectrum // self.channel_count

        win = W.window_coefficients(window_name, n)
        self.window = None if win is None else \
            torch.from_numpy(win).to(self.device)
        # the window divided out of the waterfall after the backward C2C
        # (ref: fft_pipe.hpp:346-359), zero edges already sanitized to 1
        wat_win = W.dewindow_coefficients(window_name, self.watfft_len)
        self.watfft_dewindow = None if wat_win is None else \
            torch.from_numpy(wat_win).to(self.device)

        self.f_min, self.f_c, self.df = dd.spectrum_frequencies(
            cfg, self.n_spectrum)
        zap = rfi.rfi_ranges_to_mask(
            rfi.eval_rfi_ranges(cfg.mitigate_rfi_freq_list), self.n_spectrum,
            cfg.baseband_freq_low, cfg.baseband_bandwidth)
        # K2 takes the KEEP mask (True = keep), on the device once
        self.rfi_keep = None if zap is None else \
            torch.from_numpy(~zap).to(self.device)
        self.norm_coeff = rfi.normalization_coefficient(
            self.n_spectrum, self.channel_count)
        self.nsamps_reserved = dd.nsamps_reserved(cfg)
        # trim of the waterfall time axis (ref: signal_detect_pipe.hpp:289-299)
        self.time_reserved_count = self.nsamps_reserved // self.channel_count
        self._segment_bytes = cfg.segment_bytes(self.fmt.data_stream_count)
        log.debug(f"[segment] n={n} spectrum={self.n_spectrum} "
                  f"channels={self.channel_count} watfft={self.watfft_len} "
                  f"reserved={self.nsamps_reserved} device={self.device}")

    def _as_device_bytes(self, raw) -> torch.Tensor:
        if isinstance(raw, np.ndarray):
            raw = torch.from_numpy(np.ascontiguousarray(raw, dtype=np.uint8))
        if raw.dtype != torch.uint8 or tuple(raw.shape) != (
                self._segment_bytes,):
            raise ValueError(f"segment must be uint8 [{self._segment_bytes}]"
                             f", got {raw.dtype} {tuple(raw.shape)}")
        return raw.to(self.device)

    def _unpack(self, raw: torch.Tensor) -> torch.Tensor:
        """raw bytes -> windowed float32 samples [n] (K1 for 1/2/4 bits)."""
        bits = self.cfg.baseband_input_bits
        if bits in (1, 2, 4):
            return unpack_subbyte_window(raw, bits, self.window)
        return U.unpack(raw, bits, self.window)

    def process(self, raw) -> tuple[torch.Tensor, det.DetectResult]:
        """Run one segment.  ``raw`` is the segment's uint8 bytes (numpy or
        torch).  Returns ``(waterfall complex64 [S, F, T], DetectResult)``
        with every result tensor on the processor's device."""
        cfg = self.cfg
        x = self._unpack(self._as_device_bytes(raw))
        spec = F.rfft_drop_nyquist(x)                      # [n/2]
        del x
        thr = rfi_threshold(spec, cfg.mitigate_rfi_average_method_threshold)
        spec = rfi_s1_dedisperse(spec, thr, self.norm_coeff, self.f_min,
                                 self.df, self.f_c, cfg.dm,
                                 keep=self.rfi_keep)
        wf = F.waterfall_c2c(spec, self.channel_count,
                             self.watfft_dewindow)         # [F, T]
        del spec
        wf, zero_count, ts = sk_zap_timeseries(
            wf, cfg.mitigate_rfi_spectral_kurtosis_threshold)
        t = det.trimmed_length(wf.shape[-1], self.time_reserved_count)
        result = det.detect_from_time_series(
            ts[None, :t], zero_count[None],
            cfg.signal_detect_signal_noise_threshold,
            cfg.signal_detect_max_boxcar_length)
        return wf[None], result
