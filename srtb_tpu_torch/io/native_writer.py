"""Asynchronous writer pool (port of ``srtb_tpu/io/native_writer.py``).

The reference writes candidates asynchronously from two
boost::asio::thread_pools so the pipeline never blocks on disk: baseband
``.bin`` blobs are fdatasync'd, spectrum ``.npy``/``.tim`` files are not
(ref: pipeline/write_signal_pipe.hpp:159-280).  ``AsyncWriterPool`` is
the port's equivalent: submission copies the payload, so the caller may
reuse its buffer at once, and ``drain()`` blocks until everything queued
has reached the filesystem.  A one-thread pool also appends in
submission order (``append=True``), the baseband recorder's stream.

The run manifest's hooks (``io/manifest.py``): ``pre_publish``, the
publish barrier, runs at submit on the native pool (its rename happens
in C++) and between the temp write and the rename on the Python pool;
``on_done``, the commit, fires only once that job's bytes reached the
filesystem at their verified length.  The native pool reports each
job's completion (its id, written or failed) into a queue that
:meth:`AsyncWriterPool.poll` reads on the caller's thread (each submit
and each drain poll it), so no callback runs on a C++ writer thread; a
failed job's commit never fires, and its artifact is rolled back and
regenerated on resume.

The pool runs the port's own C++ (``srtb_tpu_torch/native/
file_writer.cpp``), built with the host compiler at first use
(``kernels/build.build_host_library``); a failed build raises.  The
Python daemon-thread pool with the same (path, bytes, fsync, append)
semantics runs only when the caller asks for it
(``prefer_native=False``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import queue
import threading
import weakref
from concurrent.futures import Future

import numpy as np

from srtb_tpu_torch.utils import termination
from srtb_tpu_torch.utils.logging import log


@functools.cache
def native_library() -> ctypes.CDLL:
    """The native writer library, built on first use."""
    from srtb_tpu_torch.kernels import build
    lib = ctypes.CDLL(str(build.build_host_library("file_writer")))
    lib.srtb_writer_create.restype = ctypes.c_void_p
    lib.srtb_writer_create.argtypes = [ctypes.c_int32, ctypes.c_uint64]
    lib.srtb_writer_submit.restype = ctypes.c_int32
    lib.srtb_writer_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.srtb_writer_poll.restype = ctypes.c_int32
    lib.srtb_writer_poll.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.srtb_writer_drain.restype = None
    lib.srtb_writer_drain.argtypes = [ctypes.c_void_p]
    for name in ("srtb_writer_jobs_done", "srtb_writer_bytes_written",
                 "srtb_writer_errors"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    lib.srtb_writer_destroy.restype = None
    lib.srtb_writer_destroy.argtypes = [ctypes.c_void_p]
    return lib


class _DaemonWriterPool:
    """Minimal Future-based thread pool with DAEMON workers, spawned at
    the first submit.  ``concurrent.futures`` executors use non-daemon
    threads, which interpreter exit joins no matter what, so a wedged
    write abandoned by ``close(drain=False)`` would hang process exit;
    daemon workers die with the process, and ``AsyncWriterPool``'s
    ``weakref.finalize`` keeps the flush-at-exit behaviour."""

    def __init__(self, n_threads: int, name_prefix: str = "srtb-writer"):
        self.n_threads = n_threads
        self.name_prefix = name_prefix
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._threads: list[threading.Thread] = []

    def _work(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fut, fn, args = job
            if not fut.set_running_or_notify_cancel():
                continue  # cancelled while still queued
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 - via result()
                fut.set_exception(e)

    def submit(self, fn, *args) -> Future:
        if not self._threads:  # lazy spawn; callers serialize submits
            self._threads = [
                threading.Thread(target=self._work, daemon=True,
                                 name=f"{self.name_prefix}_{i}")
                for i in range(self.n_threads)]
            for t in self._threads:
                termination.tag_thread(t)
                t.start()
        fut = Future()
        self._jobs.put((fut, fn, args))
        return fut

    def shutdown(self, wait: bool = True,
                 cancel_futures: bool = False) -> None:
        if cancel_futures:
            while True:
                try:
                    job = self._jobs.get_nowait()
                except queue.Empty:
                    break
                if job is not None:
                    job[0].cancel()
        for _ in self._threads:
            self._jobs.put(None)
        if wait:
            for t in self._threads:
                t.join()


class AsyncWriterPool:
    """Thread-pool writer for (path, bytes, fsync, append) jobs: each
    written to a temp file and renamed into place, or appended to the
    file in place."""

    DEFAULT_MAX_QUEUED_BYTES = 1 << 30  # 1 GiB of queued payload copies

    def __init__(self, n_threads: int = 2, prefer_native: bool = True,
                 max_queued_bytes: int | None = None):
        self.n_threads = max(1, n_threads)
        if max_queued_bytes is None:
            max_queued_bytes = self.DEFAULT_MAX_QUEUED_BYTES
        self.max_queued_bytes = max_queued_bytes
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._queued_bytes = 0
        self._errors_raised = 0
        self._py_errors = 0
        self._py_jobs = 0
        self._py_bytes = 0
        # the native pool's jobs whose commit waits for the poll: id ->
        # on_done
        self._pending_done: dict[int, object] = {}
        if prefer_native:
            self._lib = native_library()
            self._h = self._lib.srtb_writer_create(self.n_threads,
                                                   max_queued_bytes)
            self._pool = None
            if not self._h:
                raise MemoryError("srtb_writer_create failed")
            # drain and destroy the native pool even if close() is never
            # called (srtb_writer_destroy joins the C++ threads)
            self._finalizer = weakref.finalize(
                self, self._lib.srtb_writer_destroy, self._h)
        else:
            self._lib = None
            self._h = None
            self._pool = _DaemonWriterPool(self.n_threads)
            self._futures = []
            # flush at exit or GC for pools never close()d, like the
            # native pool's drain+destroy finalizer
            self._finalizer = weakref.finalize(self, self._pool.shutdown)

    @property
    def is_native(self) -> bool:
        return self._h is not None

    def submit(self, path: str, data, *, fsync: bool = False,
               append: bool = False, on_done=None,
               pre_publish=None) -> None:
        """Queue one write.  ``data`` is bytes or a numpy array; it is
        copied at submission, so the caller may reuse its buffer.  With
        ``max_queued_bytes`` > 0 a submit waits while the queued copies
        would exceed the cap; a payload larger than the cap waits for an
        empty queue and is then taken whole.  ``append`` needs a
        one-thread pool: with more workers the appends' order would not
        be the submissions'.  ``on_done`` (the manifest's commit) fires
        once the job's bytes are on disk; ``pre_publish`` (its publish
        barrier) runs before the job can publish (module docstring)."""
        if append and self.n_threads > 1:
            raise ValueError(
                "append=True needs n_threads=1 (ordered appends)")
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1) \
            if isinstance(data, np.ndarray) else \
            np.frombuffer(bytes(data), dtype=np.uint8)
        if self._h is not None:
            if pre_publish is not None:
                pre_publish()
            ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            job = ctypes.c_uint64(0)
            rc = self._lib.srtb_writer_submit(
                self._h, path.encode(), ptr, buf.size, 1 if fsync else 0,
                1 if append else 0, ctypes.byref(job))
            if rc != 0:
                raise RuntimeError(f"srtb_writer_submit failed for {path}")
            if on_done is not None:
                self._pending_done[job.value] = on_done
            self.poll()
            return
        payload = buf.tobytes()  # copy at submit, like the native pool
        with self._space:
            if self.max_queued_bytes > 0:
                self._space.wait_for(
                    lambda: (self._queued_bytes + len(payload)
                             <= self.max_queued_bytes)
                    or self._queued_bytes == 0)
            self._queued_bytes += len(payload)
            # keep failed futures for drain() to surface
            self._futures = [f for f in self._futures
                             if not f.done() or f.exception() is not None]
            self._futures.append(self._pool.submit(
                self._py_write, path, payload, fsync, append, on_done,
                pre_publish))

    def _py_write(self, path: str, payload: bytes, fsync: bool,
                  append: bool, on_done=None, pre_publish=None) -> None:
        # the accounting runs for any exception, or the backpressure
        # window would shrink for good and later submits block forever
        ok = False
        try:
            if append:
                with open(path, "ab") as f:
                    f.write(payload)
                    f.flush()
                    if fsync:
                        os.fdatasync(f.fileno())
            else:
                from srtb_tpu_torch.io.writers import atomic_write
                atomic_write(path, payload, fsync=fsync,
                             pre_rename=pre_publish)
            # the commit, once the bytes landed; a failing commit leaves
            # the artifact uncommitted (rolled back on resume)
            if on_done is not None:
                on_done()
            ok = True
        except OSError:
            pass  # counted below; surfaced by raise_new_errors()
        finally:
            with self._space:
                self._py_jobs += 1
                if ok:
                    self._py_bytes += len(payload)
                else:
                    self._py_errors += 1
                self._queued_bytes -= len(payload)
                self._space.notify_all()

    def poll(self) -> int:
        """Fire the commits of the native pool's finished jobs that were
        written (a failed job's commit is dropped); returns how many
        finished jobs were read.  Runs on the caller's thread."""
        if self._h is None:
            return 0
        n_max = 64
        ids = (ctypes.c_uint64 * n_max)()
        oks = (ctypes.c_int32 * n_max)()
        total = 0
        while True:
            n = self._lib.srtb_writer_poll(self._h, ids, oks, n_max)
            for i in range(n):
                on_done = self._pending_done.pop(ids[i], None)
                if on_done is not None and oks[i]:
                    on_done()
            total += n
            if n < n_max:
                return total

    def drain(self) -> None:
        """Block until every submitted job has been written (or failed),
        and fire the written jobs' commits."""
        if self._h is not None:
            self._lib.srtb_writer_drain(self._h)
            self.poll()
            return
        with self._lock:
            futures, self._futures = self._futures, []
        for fut in futures:
            fut.result()

    def raise_new_errors(self, context: str) -> None:
        """Raise if writes failed since the last call (the count is
        pool-wide)."""
        errors = self.stats()["errors"]
        new_errors = errors - self._errors_raised
        self._errors_raised = errors
        if new_errors:
            raise RuntimeError(
                f"{new_errors} async write(s) failed ({context})")

    def stats(self) -> dict:
        if self._h is not None:
            return {
                "jobs_done": self._lib.srtb_writer_jobs_done(self._h),
                "bytes_written": self._lib.srtb_writer_bytes_written(
                    self._h),
                "errors": self._lib.srtb_writer_errors(self._h),
            }
        with self._lock:
            return {"jobs_done": self._py_jobs,
                    "bytes_written": self._py_bytes,
                    "errors": self._py_errors}

    def close(self, drain: bool = True) -> None:
        """``drain=False`` abandons queued or stuck writes instead of
        waiting for them (a bounded shutdown that found the sink wedged):
        the native pool is then leaked (its destroy joins the stuck
        threads), the Python pool's daemon workers die with the
        process."""
        if self._h is not None:
            if drain:
                if self._pending_done:
                    self.drain()  # the deferred commits
                self._finalizer()  # idempotent drain + destroy
            else:
                self._finalizer.detach()
                log.warning("[writer_pool] abandoning native pool "
                            "without drain (wedged writes)")
            self._h = None
        elif self._pool is not None:
            if drain:
                self.drain()
                self._finalizer()  # idempotent sentinel + join
            else:
                self._finalizer.detach()
                self._pool.shutdown(wait=False, cancel_futures=True)
                log.warning("[writer_pool] abandoning queued writes "
                            "without drain (wedged writes)")
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
