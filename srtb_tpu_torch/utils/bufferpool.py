"""Host buffer pool (port of ``srtb_tpu/utils/bufferpool.py``).

The reference caches large host allocations because raw (pinned)
allocation costs 0.5-5 s/GB (ref: memory/cached_allocator.hpp:38-235).
Same policy here: exact-or-larger reuse with a 0.5 threshold (a cached
block at least the requested size but no more than 2x is reused,
cached_allocator.hpp:75-121), explicit ``free_all``, and double-release
diagnostics.

A pool made with ``pinned=True`` (the caller decides: the runtime does so
when its processor runs on the card) allocates page-locked blocks,
``torch.empty(..., pin_memory=True)``, and hands them out as numpy views,
so the reader can ``readinto`` memory that an asynchronous host-to-device
copy reads directly.  Blocks are plain numpy memory otherwise.  A handed-
out buffer is known by the address of its first byte, which is the
address of its block.
"""

from __future__ import annotations

import threading

import numpy as np

from srtb_tpu_torch.utils.logging import log


def _address(buf: np.ndarray) -> int:
    return buf.__array_interface__["data"][0]


class BufferPool:
    def __init__(self, name: str = "host", pinned: bool = False):
        self.name = name
        self.pinned = pinned
        self._free: dict[int, list[np.ndarray]] = {}
        self._out: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()

    def _new_block(self, nbytes: int) -> np.ndarray:
        if not self.pinned:
            return np.empty(nbytes, dtype=np.uint8)
        import torch
        # on a context a sticky fault killed this raises the context's
        # error; the engine reads under its healer (``Pipeline``'s
        # ``ingest_one``), which takes it as a halt.  The numpy view keeps
        # the pinned tensor alive (its ``base``)
        return torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=True).numpy()

    def acquire(self, nbytes: int, zero: bool = True) -> np.ndarray:
        """A uint8 buffer of exactly ``nbytes`` (a view of a possibly
        larger cached block)."""
        with self._lock:
            best_size = None
            for size in self._free:
                if nbytes <= size <= 2 * nbytes:  # the 0.5 reuse threshold
                    if best_size is None or size < best_size:
                        best_size = size
            if best_size is not None:
                block = self._free[best_size].pop()
                if not self._free[best_size]:
                    del self._free[best_size]
            else:
                block = None
        if block is None:
            log.debug(f"[buffer_pool {self.name}] new "
                      f"{'pinned ' if self.pinned else ''}block "
                      f"{nbytes} bytes")
            block = self._new_block(nbytes)
        with self._lock:
            self._out[_address(block)] = block
        if zero:
            block[:nbytes] = 0
        return block[:nbytes] if block.nbytes != nbytes else block

    def release(self, buf: np.ndarray) -> None:
        with self._lock:
            block = self._out.pop(_address(buf), None)
            if block is None:
                log.warning(f"[buffer_pool {self.name}] releasing unknown "
                            "or already-freed buffer")
                return
            self._free.setdefault(block.nbytes, []).append(block)

    def stats(self) -> dict:
        """Occupancy: cached block count and bytes, buffers out."""
        with self._lock:
            cached = sum(len(v) for v in self._free.values())
            cached_bytes = sum(size * len(v)
                               for size, v in self._free.items())
            return {"cached_blocks": cached, "cached_bytes": cached_bytes,
                    "in_use": len(self._out)}

    def free_all(self) -> int:
        """Drop all cached blocks (ref: deallocate_all_free_ptrs); returns
        the count of buffers still in use (leak diagnostic,
        ref: cached_allocator.hpp:230-233)."""
        with self._lock:
            self._free.clear()
            in_use = len(self._out)
        if in_use:
            log.warning(f"[buffer_pool {self.name}] {in_use} buffers still "
                        "in use")
        return in_use
