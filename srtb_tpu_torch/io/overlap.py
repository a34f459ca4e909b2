"""Overlap-save tail carry of the file reader (port of
``srtb_tpu/io/overlap.py``).

Consecutive segments overlap by ``reserved_bytes`` (the overlap-save
tail).  This helper owns two invariants in one place:

- **tail retention**: the reserved tail of the last emitted segment is
  kept in ONE persistent host buffer (``np.copyto``, never a fresh
  allocation per segment) and copied into the next segment's head;
- **seq stamping**: a per-source monotonically increasing emission
  counter (``SegmentWork.seq``).
"""

from __future__ import annotations

import numpy as np


class OverlapTailCarry:
    """Retained reserved-tail + emission-seq bookkeeping for one
    segment source (one instance per receiver/reader)."""

    def __init__(self, reserved_bytes: int):
        self.reserved_bytes = int(reserved_bytes)
        self._tail: np.ndarray | None = None
        self._seq = 0

    @property
    def warm(self) -> bool:
        """Whether a retained tail exists to head the next segment."""
        return self._tail is not None

    def head_into(self, buf: np.ndarray) -> int:
        """Copy the retained tail into ``buf[:reserved_bytes]`` when
        warm; returns the number of head bytes filled (0 when cold —
        the caller must produce the full segment itself)."""
        if self._tail is None:
            return 0
        buf[:self.reserved_bytes] = self._tail
        return self.reserved_bytes

    def retain(self, buf: np.ndarray) -> None:
        """Retain ``buf``'s reserved tail for the next segment's head
        (persistent buffer; no per-segment allocation)."""
        if self._tail is None:
            self._tail = np.empty(self.reserved_bytes, np.uint8)
        np.copyto(self._tail, buf[buf.shape[0] - self.reserved_bytes:])

    def next_seq(self) -> int:
        """The emitted segment's ``SegmentWork.seq``: 0, 1, 2, ..."""
        self._seq += 1
        return self._seq - 1
