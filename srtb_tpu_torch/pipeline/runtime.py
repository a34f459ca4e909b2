"""Streaming runtime, serial form (port of ``srtb_tpu/pipeline/runtime.py``:
``PipelineStats``, ``has_signal`` and a one-segment-at-a-time
``Pipeline.run``).

Per segment: read (overlap-save file reader) -> device chain
(``SegmentProcessor``) -> detection gate -> candidate writer.  The
reference's in-flight window, ingest ring, fleet and resilience layers
are later slices (ROADMAP A4, A8-A10).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io.file_input import make_file_source
from srtb_tpu_torch.io.writers import WriteSignalSink, to_host
from srtb_tpu_torch.pipeline.segment import SegmentProcessor
from srtb_tpu_torch.pipeline.work import SegmentResultWork
from srtb_tpu_torch.utils.logging import log


@dataclass
class PipelineStats:
    segments: int = 0
    samples: int = 0
    signals: int = 0
    elapsed_s: float = 0.0
    extras: dict = field(default_factory=dict)

    @property
    def msamples_per_sec(self) -> float:
        return self.samples / self.elapsed_s / 1e6 if self.elapsed_s else 0.0


def has_signal(cfg: Config, detect_result,
               frequency_bin_count: int | None = None) -> bool:
    """The reference's gate: negative when too many channels are zapped
    (ref: signal_detect_pipe.hpp:343-345), else positive when any boxcar
    fired.  ``frequency_bin_count`` is the row count of the waterfall the
    detection ran on (falls back to the configured channel count)."""
    zero_count = to_host(detect_result.zero_count)
    counts = to_host(detect_result.signal_counts)
    if zero_count.ndim == 0:
        zero_count = zero_count[None]
        counts = counts[None]
    freq_bins = (frequency_bin_count if frequency_bin_count is not None
                 else cfg.spectrum_channel_count)
    ok = zero_count < cfg.signal_detect_channel_threshold * freq_bins
    return bool(np.any(ok & (counts.sum(axis=-1) > 0)))


class Pipeline:
    """The configured input file to the candidate writer, one segment at
    a time."""

    def __init__(self, cfg: Config, device=None):
        if cfg.baseband_write_all:
            raise NotImplementedError(
                "baseband_write_all is not ported yet (ROADMAP A4: "
                "WriteAllSink)")
        if not cfg.input_file_path:
            raise ValueError("no input_file_path")
        self.cfg = cfg
        self.processor = SegmentProcessor(cfg, device=device)
        self.source = make_file_source(cfg)
        self.sink = WriteSignalSink(cfg)
        self.stats = PipelineStats()
        # drain-order indices of the segments the gate called positive
        self.positive_segments: list[int] = []

    def run(self) -> PipelineStats:
        """Process the source to its end.  Wall seconds per stage land in
        ``stats.extras["stage_s"]``: ``read`` (the file reader), ``device``
        (upload, device chain and the detection gate, whose host read
        waits for the device) and ``sink`` (candidate writing); the device
        seconds of each segment in ``stats.extras["device_s_per_segment"]``
        (the first carries one-time set-up: tables, library initialization)."""
        cfg = self.cfg
        stage_s = {"read": 0.0, "device": 0.0, "sink": 0.0}
        self.stats.extras["stage_s"] = stage_s
        device_s = self.stats.extras["device_s_per_segment"] = []
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            seg = next(self.source, None)
            t1 = time.perf_counter()
            stage_s["read"] += t1 - t0
            if seg is None:
                break
            wf, det_res = self.processor.process(seg.data)
            positive = has_signal(cfg, det_res,
                                  frequency_bin_count=wf.shape[-2])
            t2 = time.perf_counter()
            stage_s["device"] += t2 - t1
            device_s.append(t2 - t1)
            if positive:
                self.stats.signals += 1
                self.positive_segments.append(self.stats.segments)
                log.info("[pipeline] signal detected in segment "
                         f"{self.stats.segments}")
            self.sink.push(SegmentResultWork(segment=seg, waterfall=wf,
                                             detect=det_res), positive)
            stage_s["sink"] += time.perf_counter() - t2
            self.stats.segments += 1
            self.stats.samples += cfg.baseband_input_count
        self.stats.elapsed_s = time.perf_counter() - start
        log.info(f"[pipeline] {self.stats.segments} segments, "
                 f"{self.stats.msamples_per_sec:.1f} Msamples/s")
        return self.stats

    def close(self) -> None:
        self.source.close()
