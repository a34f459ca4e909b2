"""Fault handling: signal handlers with stack traces, and the thread
audit of bounded shutdowns (port of ``srtb_tpu/utils/termination.py``).

Mirrors the reference's termination handler (ref: util/termination_handler.
hpp:38-113: std::terminate + SIGTERM/SEGV/INT/ILL/ABRT/FPE handlers
printing a stack trace, then chaining to the original handlers).
Python's ``faulthandler`` covers the hard faults; ``sys.excepthook`` and
signal handlers cover the rest.

Threads the runtime spawns, and where each is joined:
- the sink pipe ("sink_drain"): joined at the end of ``Pipeline.run``;
- the writer pool's workers (``io/native_writer.py``): joined by the
  pool's ``close()`` (``Pipeline.close`` closes the pool it owns).
"""

from __future__ import annotations

import faulthandler
import signal
import sys
import threading
import time
import traceback

from srtb_tpu_torch.utils.logging import log

_installed = False

# pools that outlive one pipeline run (owned by objects with their own
# close()): the Python writer pool spawns its workers at the first
# submit and joins them at close, after run() returns; executor and
# asyncio workers and a debugger's threads, as the reference allows
LEAK_ALLOW_PREFIXES = ("ThreadPoolExecutor", "srtb-writer", "pydevd",
                       "asyncio_")


def tag_thread(thread: threading.Thread) -> None:
    """Stamp ``thread`` with the file:line that constructed it: the first
    frame outside the calling module (the wrapper, e.g.
    ``Pipe.__init__``, is not the interesting site), or the immediate
    caller when the whole stack is in one file."""
    f = sys._getframe(1)
    wrapper_file = f.f_code.co_filename
    g = f
    while g is not None and g.f_code.co_filename == wrapper_file:
        g = g.f_back
    f = g or f
    thread._srtb_created_at = f"{f.f_code.co_filename}:{f.f_lineno}"


def created_at(thread: threading.Thread) -> str | None:
    """The creation site stamped by :func:`tag_thread`, if any."""
    return getattr(thread, "_srtb_created_at", None)


def describe_threads(threads) -> str:
    """The threads by name, each with its creation site when known (the
    leaked-thread report's attribution)."""
    parts = []
    for t in threads:
        site = created_at(t)
        parts.append(f"'{t.name}'"
                     + (f" (created at {site})" if site else ""))
    return ", ".join(parts)


def thread_snapshot() -> set[int]:
    """Idents of the threads alive now (the leak check's baseline)."""
    return {t.ident for t in threading.enumerate()}


def leaked_threads(snapshot: set[int], grace_s: float = 1.0,
                   allow_prefixes=LEAK_ALLOW_PREFIXES) -> list:
    """Threads alive now that were not in ``snapshot``, after giving
    stragglers ``grace_s`` to finish joining."""
    deadline = time.monotonic() + max(0.0, grace_s)
    while True:
        leaked = [
            t for t in threading.enumerate()
            if t.ident not in snapshot and t.is_alive()
            and t is not threading.current_thread()
            and not any(t.name.startswith(p) for p in allow_prefixes)]
        if not leaked or time.monotonic() >= deadline:
            return leaked
        time.sleep(0.02)


def format_thread_stacks(threads) -> str:
    """The current stack of each given thread."""
    frames = sys._current_frames()
    parts = []
    for t in threads:
        site = created_at(t)
        header = (f"--- thread {t.name!r} (ident {t.ident}, "
                  f"daemon={t.daemon}"
                  + (f", created at {site}" if site else "") + ") ---")
        frame = frames.get(t.ident)
        if frame is None:
            parts.append(header + "\n  <no frame: already exiting>")
        else:
            parts.append(header + "\n"
                         + "".join(traceback.format_stack(frame)))
    return "\n".join(parts)


def report_wedged(threads, context: str) -> None:
    """One loud log block naming each thread still alive after a bounded
    join, with its creation site and current stack."""
    threads = [t for t in threads if t.is_alive()]
    if not threads:
        return
    log.error(f"[termination] {len(threads)} thread(s) still alive "
              f"after {context}:")
    for line in format_thread_stacks(threads).splitlines():
        log.error(line)


def install_termination_handler() -> None:
    """Dump stacks on hard faults, log uncaught exceptions, and log
    SIGTERM/SIGINT with the interrupted stack before the default action.
    Idempotent; call from the main thread of an entry point."""
    global _installed
    if _installed:
        return
    _installed = True
    faulthandler.enable(all_threads=True)

    def _excepthook(exc_type, exc, tb):
        log.error("[termination_handler] uncaught exception:")
        for line in traceback.format_exception(exc_type, exc, tb):
            log.error(line.rstrip())
        sys.__excepthook__(exc_type, exc, tb)

    sys.excepthook = _excepthook

    def _signal_handler(signum, frame):
        log.error(f"[termination_handler] received signal {signum}")
        traceback.print_stack(frame)
        # chain to the default behaviour, as the reference chains to the
        # original handlers
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _signal_handler)
        except (ValueError, OSError):
            pass  # not the main thread, or unsupported here
