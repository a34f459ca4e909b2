"""Accounted-loss backpressure between a real-time source and the engine
(port of ``srtb_tpu/io/backpressure.py``).

When compute cannot keep up with a real-time source, the source must keep
running and the excess must surface as accounted loss, never as silent
latency or a stalled receiver.  :class:`DropOldestSegmentBuffer` pulls the
wrapped source on its own thread into a bounded deque; when the consumer
falls behind and the deque is full, the oldest buffered segment is
dropped and counted in the metrics registry (``segments_dropped``, its
loss window, the signal of the degradation ladder's level 3, and its
twin labeled with the originating stream), keeping the freshest data.
``<name>_depth`` gauges the buffer's fill.
"""

from __future__ import annotations

import collections
import threading

from srtb_tpu_torch.utils import termination
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics


class DropOldestSegmentBuffer:
    """Bounded segment buffer with drop-oldest overflow accounting.

    Iterating yields segments in production order minus the accounted
    drops; iteration ends when the wrapped source is exhausted and the
    buffer has drained.  A source exception is raised to the consumer at
    the failed ``__next__``.  Not for checkpointed file replays: the pump
    reads ahead, so a resume offset cannot be exact.
    """

    def __init__(self, source, capacity: int = 4,
                 name: str = "segment_buffer", stream: str = ""):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.source = source
        self.capacity = int(capacity)
        self.name = name
        self.stream = stream
        self.dropped = 0
        # drops by origin (the stream label, else the victim's
        # data_stream_id)
        self.dropped_by_stream: dict[str, int] = {}
        self._buf: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._done = False
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._pump, name=name,
                                        daemon=True)
        termination.tag_thread(self._thread)
        self._thread.start()

    def _pump(self) -> None:
        try:
            for seg in self.source:
                with self._cv:
                    if self._done:
                        break
                    if len(self._buf) >= self.capacity:
                        victim = self._buf.popleft()
                        self.dropped += 1
                        metrics.add("segments_dropped")
                        metrics.window("segments_dropped").add(1)
                        origin = self.stream or str(
                            getattr(victim, "data_stream_id", 0))
                        self.dropped_by_stream[origin] = \
                            self.dropped_by_stream.get(origin, 0) + 1
                        metrics.add("segments_dropped",
                                    labels={"stream": origin})
                        # a pooled source's buffer goes back to its pool:
                        # the pipeline releases only what it drains
                        pool = getattr(self.source, "pool", None)
                        if pool is not None:
                            pool.release(victim.data)
                        log.warning(
                            f"[{self.name}] consumer behind: dropped "
                            f"oldest segment ({self.dropped} total)")
                    self._buf.append(seg)
                    metrics.set(f"{self.name}_depth", len(self._buf))
                    self._cv.notify()
        except BaseException as e:  # noqa: BLE001 - to the consumer
            with self._cv:
                if not self._done:  # an unblock by close is no error
                    self._error = e
        finally:
            with self._cv:
                self._done = True
                self._cv.notify_all()

    @property
    def pool(self):
        """The wrapped source's buffer pool, which the pipeline's drain
        releases into."""
        return getattr(self.source, "pool", None)

    @property
    def logical_offset(self):
        return getattr(self.source, "logical_offset", 0)

    def __iter__(self):
        return self

    def __next__(self):
        with self._cv:
            while not self._buf:
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                if self._done:
                    raise StopIteration
                self._cv.wait()
            seg = self._buf.popleft()
            metrics.set(f"{self.name}_depth", len(self._buf))
            return seg

    def close(self) -> None:
        with self._cv:
            self._done = True
            self._cv.notify_all()
        # the wrapped source first: a pump blocked in a receive wakes only
        # when its socket goes away
        close = getattr(self.source, "close", None)
        if close is not None:
            close()
        self._thread.join(timeout=5)
