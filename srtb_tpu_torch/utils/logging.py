"""Leveled colored logging with seconds-since-start prefix.

Mirrors the behavior of the reference logger (ref: log/log.hpp:23-128):
levels NONE/ERROR/WARNING/INFO/DEBUG, runtime level from the
``SRTB_LOG_LEVEL`` environment variable or the ``log_level`` config option,
and a ``[+seconds]`` relative-timestamp prefix on every line.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_START_TIME = time.monotonic()

LEVEL_NONE = 0
LEVEL_ERROR = 1
LEVEL_WARNING = 2
LEVEL_INFO = 3
LEVEL_DEBUG = 4

_LEVEL_NAMES = {
    LEVEL_ERROR: ("E", "\033[31m"),  # red
    LEVEL_WARNING: ("W", "\033[33m"),  # yellow
    LEVEL_INFO: ("I", "\033[32m"),  # green
    LEVEL_DEBUG: ("D", "\033[36m"),  # cyan
}
_RESET = "\033[0m"

_lock = threading.Lock()


def _default_level() -> int:
    env = os.environ.get("SRTB_LOG_LEVEL", "")
    try:
        return int(env)
    except ValueError:
        return LEVEL_INFO


class Logger:
    """Process-wide leveled logger; thread-safe line output."""

    def __init__(self, name: str = "srtb", level: int | None = None,
                 stream=None):
        self.name = name
        self.level = _default_level() if level is None else level
        self.stream = stream if stream is not None else sys.stderr

    def _log(self, level: int, *args) -> None:
        if level > self.level:
            return
        tag, color = _LEVEL_NAMES[level]
        elapsed = time.monotonic() - _START_TIME
        use_color = hasattr(self.stream, "isatty") and self.stream.isatty()
        prefix = f"[{tag} +{elapsed:.6f}s]"
        if use_color:
            prefix = f"{color}{prefix}{_RESET}"
        msg = " ".join(str(a) for a in args)
        with _lock:
            print(f"{prefix} {msg}", file=self.stream, flush=True)

    def error(self, *args) -> None:
        self._log(LEVEL_ERROR, *args)

    def warning(self, *args) -> None:
        self._log(LEVEL_WARNING, *args)

    def info(self, *args) -> None:
        self._log(LEVEL_INFO, *args)

    def debug(self, *args) -> None:
        self._log(LEVEL_DEBUG, *args)


log = Logger()
