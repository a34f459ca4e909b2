"""Host-side pipeline framework: threads, bounded queues and stop tokens
(port of ``srtb_tpu/pipeline/framework.py``).

The host stages around the device chain keep the reference's
thread-per-stage structure (ref: pipeline/framework/pipe.hpp:108-175,
pipe_io.hpp:27-152):

- ``WorkQueue``: bounded queue, capacity 2 by default
  (ref: work.hpp:30-72 + config.hpp:40-43), blocking push/pop with a stop
  token, and a lossy push (ref: loose_queue_out_functor,
  pipe_io.hpp:79-94);
- ``Pipe``/``start_pipe``: a worker thread running in -> functor -> out
  until stopped (the thread is named after the functor);
- ``on_exit``: request stop and join all (ref: framework/exit_handler.hpp).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

from srtb_tpu_torch.utils import termination
from srtb_tpu_torch.utils.logging import log

WORK_QUEUE_CAPACITY = 2  # ref: config.hpp:40


class StopToken:
    def __init__(self):
        self._evt = threading.Event()

    def request_stop(self):
        self._evt.set()

    @property
    def stop_requested(self) -> bool:
        return self._evt.is_set()


class WorkQueue:
    """Bounded blocking queue with stop-token-aware operations."""

    def __init__(self, capacity: int = WORK_QUEUE_CAPACITY):
        self._q = queue.Queue(maxsize=capacity)

    def push(self, item, stop_token: StopToken | None = None) -> bool:
        while True:
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                if stop_token is not None and stop_token.stop_requested:
                    return False

    def push_lossy(self, item) -> bool:
        """Drop-if-full push (ref: pipe_io.hpp:79-94)."""
        try:
            self._q.put_nowait(item)
            return True
        except queue.Full:
            return False

    def pop(self, stop_token: StopToken | None = None):
        """Blocking pop; None once stopped and drained."""
        while True:
            try:
                return self._q.get(timeout=0.05)
            except queue.Empty:
                if stop_token is not None and stop_token.stop_requested:
                    return None

    def try_pop(self):
        """Non-blocking pop; None when empty."""
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def qsize(self) -> int:
        return self._q.qsize()


# end-of-stream marker: a producer that is not a Pipe (the engine feeding
# its sink pipe) pushes it to end the consumer; Pipe._run forwards it
SENTINEL = object()


class Pipe:
    """One worker thread: pop from in_queue, apply functor, push to
    out_queue.  A functor returning None drops the work item; raising
    StopIteration ends the pipe (and forwards the sentinel downstream).
    An exception ends the pipe too and is kept in ``exception``."""

    def __init__(self, functor: Callable, in_queue: WorkQueue | None,
                 out_queue: WorkQueue | None, stop_token: StopToken,
                 name: str | None = None):
        self.functor = functor
        self.in_queue = in_queue
        self.out_queue = out_queue
        self.stop_token = stop_token
        self.name = name or getattr(functor, "__name__",
                                    type(functor).__name__)
        self.thread = threading.Thread(target=self._run, name=self.name,
                                       daemon=True)
        termination.tag_thread(self.thread)
        self.exception: BaseException | None = None

    def _run(self):
        log.debug(f"[pipe {self.name}] started")
        try:
            while not self.stop_token.stop_requested:
                if self.in_queue is not None:
                    work = self.in_queue.pop(self.stop_token)
                    if work is None or work is SENTINEL:
                        break
                else:
                    work = None
                try:
                    out = self.functor(self.stop_token, work)
                except StopIteration:
                    break
                if out is not None and self.out_queue is not None:
                    if not self.out_queue.push(out, self.stop_token):
                        break
                # hold nothing while waiting for the next item: a work
                # item may own device memory (a segment's waterfall)
                work = out = None
        except BaseException as e:  # noqa: BLE001 - kept for the owner
            self.exception = e
            log.error(f"[pipe {self.name}] crashed: {e!r}")
        finally:
            if self.out_queue is not None:
                # blocking push: a lossy sentinel could be dropped on a
                # full queue and deadlock the consumer
                self.out_queue.push(SENTINEL, self.stop_token)
            log.debug(f"[pipe {self.name}] exiting")

    def start(self):
        self.thread.start()
        return self

    def join(self, timeout=None) -> bool:
        """Join the worker thread; True when it stopped."""
        self.thread.join(timeout)
        return not self.thread.is_alive()


def start_pipe(functor: Callable, in_queue: WorkQueue | None,
               out_queue: WorkQueue | None, stop_token: StopToken,
               name: str | None = None) -> Pipe:
    """Spawn a pipe thread (ref: start_pipe, framework/pipe.hpp:148-175)."""
    return Pipe(functor, in_queue, out_queue, stop_token, name).start()


def on_exit(stop_token: StopToken, pipes: list[Pipe],
            timeout: float = 5.0) -> list[Pipe]:
    """Orderly shutdown: request stop, then join every pipe within one
    shared ``timeout`` budget (each pipe at least an equal share, so the
    worst case stays under 2x ``timeout``; ref:
    framework/exit_handler.hpp:28-39).  Pipes still alive are reported
    with their stacks and returned."""
    stop_token.request_stop()
    deadline = time.monotonic() + timeout
    share = timeout / max(1, len(pipes))
    wedged = [p for p in pipes
              if not p.join(max(share, deadline - time.monotonic()))]
    # grace re-sweep: a pipe starved of budget by a slow neighbour may
    # need only an instant to see the stop token
    wedged = [p for p in wedged if not p.join(0.1)]
    if wedged:
        termination.report_wedged([p.thread for p in wedged],
                                  f"on_exit ({timeout:g}s timeout)")
    return wedged


def composite(*functors: Callable) -> Callable:
    """Sequential fusion of pipe functors into one thread
    (ref: framework/composite_pipe.hpp:28-51)."""

    def fused(stop_token, work):
        for f in functors:
            work = f(stop_token, work)
            if work is None:
                return None
        return work

    fused.__name__ = "+".join(
        getattr(f, "__name__", type(f).__name__) for f in functors)
    return fused
