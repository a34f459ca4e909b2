"""Baseband file reader with overlap-save (port of
``srtb_tpu/io/file_input.py``).

Mirrors read_file_pipe (ref: pipeline/read_file_pipe.hpp:31-127):
- skip ``input_file_offset_bytes`` first;
- each segment is ``baseband_input_count * |bits|/8 * data_stream_count``
  bytes in a zero-filled buffer (a short final read stays zero-padded);
- consecutive segments overlap by the ``nsamps_reserved`` samples' bytes
  (the overlap-save tail), tracked by a logical byte counter.

With ``Config.ingest_ring`` != "off" the reserved tail of the last segment
is kept in host memory and the next read takes only the stride's new
bytes (``io/overlap.py``); "off" seeks back and re-reads instead.  The
emitted bytes are identical either way.

Each segment's buffer comes from the reader's ``pool``
(``utils/bufferpool.py``; pinned on the card, so the upload reads it
directly); whoever consumes a segment returns its buffer there when done
with it.  The retained tail is a copy, so no handed-out buffer is held
by the reader.

Each read counts ``file_bytes_read`` (and its window) and sets the
pool's ``segment_pool_*`` gauges in the metrics registry.
"""

from __future__ import annotations

import time

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import formats
from srtb_tpu_torch.io.overlap import OverlapTailCarry
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.pipeline.work import SegmentWork
from srtb_tpu_torch.utils.bufferpool import BufferPool
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics


class BasebandFileReader:
    """Iterates SegmentWork items from a raw baseband file."""

    def __init__(self, cfg: Config, buffer_pool: BufferPool | None = None,
                 start_offset_bytes: int | None = None):
        self.cfg = cfg
        self.pool = buffer_pool if buffer_pool is not None \
            else BufferPool("segments")
        self.fmt = formats.resolve(cfg.baseband_format_type)
        self.segment_bytes = cfg.segment_bytes(self.fmt.data_stream_count)
        nsamps = dd.nsamps_reserved(cfg)
        self.reserved_bytes = int(nsamps * abs(cfg.baseband_input_bits)
                                  // 8 * self.fmt.data_stream_count)
        self._file = open(cfg.input_file_path, "rb")
        start = (start_offset_bytes if start_offset_bytes is not None
                 else cfg.input_file_offset_bytes)
        self._file.seek(start)
        # where the next segment starts, even past EOF zero-padding
        # (ref: read_file_pipe.hpp:47-55)
        self.logical_offset = start
        self._exhausted = False
        self._skip_read = (
            str(getattr(cfg, "ingest_ring", "auto")).lower() != "off"
            and 0 < self.reserved_bytes < self.segment_bytes)
        self._carry = OverlapTailCarry(self.reserved_bytes)

    def __iter__(self):
        return self

    def __next__(self) -> SegmentWork:
        if self._exhausted:
            raise StopIteration
        buf = self.pool.acquire(self.segment_bytes, zero=False)
        warm = self._skip_read and self._carry.warm
        reserved = self.reserved_bytes if warm else 0
        try:
            got = self._file.readinto(memoryview(buf)[reserved:])
        except BaseException:
            self.pool.release(buf)
            raise
        if got == 0 and not warm:
            self.pool.release(buf)
            log.info(f"[read_file] {self.cfg.input_file_path} has been read")
            self._exhausted = True
            raise StopIteration
        if warm:
            # head = retained tail; with 0 new bytes this still emits the
            # tail + zeros final segment the seek-back path produces
            self._carry.head_into(buf)
        # a short final read stays zero-padded (ref: read_file_pipe.hpp:76)
        buf[reserved + got:] = 0
        # ingest telemetry: read throughput and the pool's occupancy
        metrics.add("file_bytes_read", got)
        metrics.window("file_bytes_read").add(got)
        pool_stats = self.pool.stats()
        metrics.set("segment_pool_cached_blocks",
                    pool_stats["cached_blocks"])
        metrics.set("segment_pool_cached_bytes", pool_stats["cached_bytes"])
        metrics.set("segment_pool_in_use", pool_stats["in_use"])
        self.logical_offset += self.segment_bytes
        if got < self.segment_bytes - reserved:
            # final partial segment: emit zero-padded, then stop
            # (ref: read_file_pipe.hpp:76-77)
            self._exhausted = True
        elif 0 < self.reserved_bytes < self.segment_bytes:
            # overlap-save: the next segment reprocesses the tail
            # (ref: read_file_pipe.hpp:86-99)
            self.logical_offset -= self.reserved_bytes
            if self._skip_read:
                self._carry.retain(buf)
            else:
                self._file.seek(-self.reserved_bytes, 1)
        return SegmentWork(data=buf, timestamp=time.time_ns(),
                           seq=self._carry.next_seq())

    def close(self):
        self._file.close()


# fixed epoch the deterministic stamps count from: stable across
# processes, so the wall clock plays no part
DETERMINISTIC_EPOCH_NS = 1_700_000_000_000_000_000


class DeterministicTimestampReader(BasebandFileReader):
    """File reader stamping ``timestamp`` from the segment's stream
    offset instead of the wall clock, so file-mode artifact names
    (timestamp-derived when no UDP counter exists) reproduce across runs
    (``Config.deterministic_timestamps``)."""

    def __next__(self) -> SegmentWork:
        offset = self.logical_offset
        work = super().__next__()
        work.timestamp = DETERMINISTIC_EPOCH_NS + offset
        return work


def make_file_source(cfg: Config, buffer_pool: BufferPool | None = None,
                     start_offset_bytes: int | None = None
                     ) -> BasebandFileReader:
    """The config-selected file source."""
    cls = (DeterministicTimestampReader
           if getattr(cfg, "deterministic_timestamps", False)
           else BasebandFileReader)
    return cls(cfg, buffer_pool=buffer_pool,
               start_offset_bytes=start_offset_bytes)
