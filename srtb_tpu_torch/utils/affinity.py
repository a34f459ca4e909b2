"""CPU affinity for ingest threads (port of ``srtb_tpu/utils/affinity.py``;
ref: util/thread_affinity.hpp:34-122, used by udp_receiver_pipe.hpp:88-98
to pin receivers near the NIC's NUMA node), by os.sched_setaffinity
(Linux).  The reference falls back to its native library's
sched_setaffinity, the same syscall, so the port has no fallback."""

from __future__ import annotations

import os

from srtb_tpu_torch.utils.logging import log


def set_thread_affinity(cpu: int) -> bool:
    """Pin the calling thread to one CPU.  Returns True on success."""
    try:
        os.sched_setaffinity(0, {cpu})
        return True
    except (AttributeError, OSError) as e:
        log.warning(f"[thread_affinity] sched_setaffinity failed: {e}")
        return False
