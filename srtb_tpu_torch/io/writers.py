"""Candidate writer (port of ``srtb_tpu/io/writers.py`` WriteSignalSink,
without the run manifest and the writer pool).

Files are byte-compatible with the reference's:
- ``<prefix><counter>.bin``      raw baseband bytes of the segment
  (ref: write_signal_pipe.hpp:159-206);
- ``<prefix><counter>.<i>.npy``  complex64 waterfall [freq_bins, time]
  (ref: write_signal_pipe.hpp:209-246);
- ``<prefix><counter>.<boxcar>.tim``  float32 boxcar time series
  (ref: write_signal_pipe.hpp:249-280);
- the "piggybank" policy keeps recent negatives and writes them when they
  lie within 0.45 segment of a recent positive (real-time input only,
  ref: write_signal_pipe.hpp:77-140).

Every file is written to ``<path>.srtb_tmp`` and renamed into place, so a
reader never sees a torn candidate.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.pipeline.work import (NO_UDP_PACKET_COUNTER,
                                          SegmentResultWork)
from srtb_tpu_torch.utils.logging import log

TMP_SUFFIX = ".srtb_tmp"


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def atomic_write(path: str, write, *, fsync: bool = False) -> None:
    """Crash-consistent write: ``write(f)`` into the temp file, flush
    (+ fdatasync), atomic rename; a failed write drops its temp."""
    tmp = path + TMP_SUFFIX
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            if fsync:
                os.fdatasync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # never created
        raise


@dataclass
class CandidateFiles:
    """Paths written for one positive segment."""
    bin_path: str
    npy_paths: list
    tim_paths: list


class WriteSignalSink:
    """Candidate writer with the reference's piggybank capture policy
    (synchronous writes; the raw ``.bin`` is fdatasync'd)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.recent_positive_timestamps: deque[int] = deque()
        self.recent_negative_works: deque[SegmentResultWork] = deque()
        self.written: list[CandidateFiles] = []
        # check directory writability up front
        # (ref: write_signal_pipe.hpp:62-75)
        check_path = cfg.baseband_output_file_prefix + ".check"
        with open(check_path, "wb"):
            pass
        os.unlink(check_path)

    def _overlap_window_ns(self) -> float:
        # 0.45 of a segment duration, in ns (ref: write_signal_pipe.hpp:84-86)
        return (0.45 * 1e9 * self.cfg.baseband_input_count
                / self.cfg.baseband_sample_rate)

    def _overlaps_recent_positive(self, timestamp: int) -> bool:
        w = self._overlap_window_ns()
        return any(abs(timestamp - t) < w
                   for t in self.recent_positive_timestamps)

    def push(self, work: SegmentResultWork, has_signal: bool) -> None:
        """Feed one processed segment; writes to disk when warranted."""
        real_time = self.cfg.input_file_path == ""
        w = self._overlap_window_ns()
        ts = work.segment.timestamp
        # clean outdated positives (ref: write_signal_pipe.hpp:88-94)
        while (real_time and self.recent_positive_timestamps
               and ts - self.recent_positive_timestamps[0] > 5 * w):
            self.recent_positive_timestamps.popleft()
        to_write = None
        if has_signal:
            self.recent_positive_timestamps.append(ts)
            to_write = work
        elif real_time and self._overlaps_recent_positive(ts):
            # other-polarization piggyback (ref: write_signal_pipe.hpp:102-115)
            to_write = work
        elif real_time:
            self.recent_negative_works.append(work)
        # re-check old negatives against new positives (ref: 122-140)
        if real_time and to_write is None and self.recent_negative_works:
            work_2 = self.recent_negative_works.popleft()
            if self._overlaps_recent_positive(work_2.segment.timestamp):
                to_write = work_2
        if to_write is not None:
            self._write(to_write)
        # bound the negative queue to one overlap window's worth
        while len(self.recent_negative_works) > 16:
            self.recent_negative_works.popleft()

    def _write(self, work: SegmentResultWork) -> None:
        counter = work.segment.udp_packet_counter
        if counter == NO_UDP_PACKET_COUNTER:
            counter = work.segment.timestamp
        base = self.cfg.baseband_output_file_prefix + str(counter)
        log.info(f"[write_signal] begin writing, file_counter = {counter}")
        bin_path = base + ".bin"
        data = np.ascontiguousarray(work.segment.data)
        atomic_write(bin_path, lambda f: f.write(data), fsync=True)

        npy_paths = []
        if work.waterfall is not None:
            wf = to_host(work.waterfall)
            if wf.ndim == 2:
                wf = wf[None]
            for i in range(wf.shape[0]):
                # first non-existing index (ref: 230-235)
                j = i
                while os.path.exists(f"{base}.{j}.npy"):
                    j += 1
                path = f"{base}.{j}.npy"
                row = np.ascontiguousarray(wf[i], dtype=np.complex64)
                atomic_write(path, lambda f, a=row: np.save(f, a))
                npy_paths.append(path)

        tim_paths = []
        if work.detect is not None:
            counts = to_host(work.detect.signal_counts)
            series = to_host(work.detect.boxcar_series)
            if counts.ndim == 1:
                counts = counts[None]
                series = series[None]
            multi = counts.shape[0] > 1
            for s in range(counts.shape[0]):
                for bi, b in enumerate(work.detect.boxcar_lengths):
                    if counts[s, bi] > 0:
                        path = (f"{base}.s{s}.{b}.tim" if multi
                                else f"{base}.{b}.tim")
                        valid = series.shape[-1] - (b if b > 1 else 0)
                        payload = series[s, bi, :valid].astype("<f4")
                        atomic_write(path, lambda f, a=payload: f.write(a))
                        tim_paths.append(path)
        self.written.append(CandidateFiles(bin_path, npy_paths, tim_paths))
        log.info(f"[write_signal] finished writing, file_counter = {counter}")
