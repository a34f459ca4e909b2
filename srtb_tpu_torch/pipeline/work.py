"""Work types flowing through the streaming runtime (port of
``srtb_tpu/pipeline/work.py``).

The reference threads ownership of device buffers through typed POD work
structs over lock-free queues (ref: work.hpp:79-285).  Here only two
host-side work types remain: the raw input segment and the processed
result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

# sentinel matching work.hpp's no_udp_packet_counter (max uint64)
NO_UDP_PACKET_COUNTER = 2 ** 64 - 1


@dataclass
class SegmentWork:
    """One input segment: raw bytes plus metadata
    (ref: work.hpp copy_to_device_work:162-190)."""
    data: np.ndarray            # uint8 [segment_bytes]
    timestamp: int = 0          # nanoseconds since epoch
    udp_packet_counter: int = NO_UDP_PACKET_COUNTER
    # which receiver of a multi-port source the segment came from
    data_stream_id: int = 0
    # per-source emission sequence (-1 = unstamped), stamped by the file
    # reader and the UDP source (io/overlap.py); the engine's ring is warm
    # only for the (data_stream_id, seq + 1) successor of its last segment
    seq: int = -1


@dataclass
class SegmentResultWork:
    """Everything the host needs after one segment's device processing
    (ref: write_signal_work + draw_spectrum_work_2, work.hpp:232-284)."""
    segment: SegmentWork
    # [streams, freq_bins, time_samples] complex64 dynamic spectrum
    waterfall: Any = None
    # detection outputs (srtb_tpu_torch.ops.detect.DetectResult, batched)
    detect: Any = None
