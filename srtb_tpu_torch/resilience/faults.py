"""Deterministic fault injection, ``Config.fault_plan`` (port of
``srtb_tpu/resilience/faults.py``).

Plan syntax (comma-separated entries)::

    [stream:]site:action@index

- ``stream``  optional selector: the entry fires only in the pipeline
              whose ``Config.stream_name`` matches; any prefix that is not
              a site name is read as one;
- ``site``    one of ``ingest``, ``h2d``, ``dispatch``, ``fetch``,
              ``sink_write``, ``checkpoint``, the hook points of
              ``pipeline/runtime.py`` (``Pipeline._op``);
- ``action``  ``raise`` (:class:`InjectedFault`, transient: retried),
              ``fatal`` (:class:`InjectedFatal`, ends the run),
              ``corrupt`` (:class:`InjectedCorruption`, data loss:
              retried and counted), ``stall=SECONDS`` (sleeps), or a
              device fault at a device site (``h2d``, ``dispatch``,
              ``fetch``): ``oom``, ``compile_fail`` or ``device_halt``;
- ``index``   the segment the fault fires on, in dispatch order within
              the run, 0-based, the same space at every site (a resumed
              run counts from its own first segment).

The device actions raise what the card raises, tagged ``[injected fault
at ...]``: ``torch.cuda.OutOfMemoryError``, the kernel library's
``KernelBuildError``, and ``torch.AcceleratorError`` with torch's message
for a device-side assert.  They travel the recognition path of a real
fault (``resilience/errors.classify_device`` reads the type and the
message), as the reference's renamed ``XlaRuntimeError`` stand-in does.
The tag is what lets an injected ``compile_fail`` demote: a real build or
launch fault of the port's own kernels escalates instead
(``errors.kernel_fault``).

Each armed fault fires once; ``faults_injected`` counts the fires.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from srtb_tpu_torch.resilience.errors import (INJECTED_TAG, DataLossError,
                                              FatalError, TransientError)
from srtb_tpu_torch.utils import events
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

SITES = ("ingest", "h2d", "dispatch", "fetch", "sink_write",
         "checkpoint")
DEVICE_ACTIONS = ("oom", "compile_fail", "device_halt")
ACTIONS = ("raise", "fatal", "corrupt", "stall") + DEVICE_ACTIONS
DEVICE_SITES = ("h2d", "dispatch", "fetch")


class InjectedFault(TransientError):
    """A scheduled transient fault."""


class InjectedFatal(FatalError):
    """A scheduled fatal fault."""


class InjectedCorruption(DataLossError):
    """A scheduled data-loss fault."""


def device_fault(action: str, spec) -> BaseException:
    """The exception the card raises for a device action, tagged with
    the plan entry: an allocation that does not fit, a kernel library
    that does not build, a device-side assert (sticky on a real card)."""
    import torch
    from srtb_tpu_torch.kernels.build import KernelBuildError
    tag = f"{INJECTED_TAG}{spec}]"
    if action == "oom":
        return torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 64.00 GiB. " + tag)
    if action == "compile_fail":
        return KernelBuildError(f"nvcc failed: {tag}")
    return torch.AcceleratorError(
        "CUDA error: device-side assert triggered\nCUDA kernel errors "
        "might be asynchronously reported at some other API call. " + tag)


@dataclass
class FaultSpec:
    site: str
    action: str
    index: int
    arg: float = 0.0     # stall duration
    stream: str | None = None   # None = every pipeline
    fired: bool = field(default=False, compare=False)

    def __str__(self) -> str:
        a = (f"{self.action}={self.arg:g}" if self.action == "stall"
             else self.action)
        pre = f"{self.stream}:" if self.stream else ""
        return f"{pre}{self.site}:{a}@{self.index}"


def parse_plan(text: str) -> list[FaultSpec]:
    """Parse the plan syntax above; ``ValueError`` names the malformed
    entry (a plan with a typo fails the run at start-up)."""
    specs = []
    for entry in (e.strip() for e in text.split(",")):
        if not entry:
            continue
        try:
            site, rest = entry.split(":", 1)
            stream = None
            if site.strip() not in SITES and ":" in rest:
                stream, site, rest = site, *rest.split(":", 1)
                stream = stream.strip()
            action, idx = rest.rsplit("@", 1)
            arg = 0.0
            if "=" in action:
                action, arg_s = action.split("=", 1)
                arg = float(arg_s)
            site, action = site.strip(), action.strip()
            index = int(idx)
        except ValueError as e:
            raise ValueError(
                f"fault_plan entry {entry!r}: expected "
                "'[stream:]site:action@index' with action raise|fatal|"
                f"corrupt|stall=SECONDS ({e})") from e
        if site not in SITES:
            raise ValueError(f"fault_plan entry {entry!r}: unknown site "
                             f"{site!r} (sites: {', '.join(SITES)})")
        if action not in ACTIONS:
            raise ValueError(
                f"fault_plan entry {entry!r}: unknown action {action!r} "
                f"(actions: {', '.join(ACTIONS)})")
        if action == "stall" and arg <= 0:
            raise ValueError(f"fault_plan entry {entry!r}: stall needs "
                             "a positive duration (stall=SECONDS)")
        if action in DEVICE_ACTIONS and site not in DEVICE_SITES:
            raise ValueError(
                f"fault_plan entry {entry!r}: device-fault action "
                f"{action!r} only fires at a device site "
                f"({', '.join(DEVICE_SITES)})")
        specs.append(FaultSpec(site, action, index, arg, stream))
    return specs


class FaultInjector:
    """Armed fault sites; ``fire`` is the hook the pipeline calls with
    the current segment index."""

    def __init__(self, specs: list[FaultSpec]):
        self._by_site: dict[str, dict[int, FaultSpec]] = {}
        for s in specs:
            site = self._by_site.setdefault(s.site, {})
            if s.index in site:
                raise ValueError(
                    f"fault_plan: duplicate entry for {s.site}@"
                    f"{s.index} ({site[s.index]} vs {s})")
            site[s.index] = s

    @classmethod
    def from_plan(cls, text: str, stream: str = ""
                  ) -> "FaultInjector | None":
        """None for an empty plan, or when every entry is scoped to
        another stream."""
        if not text or not text.strip():
            return None
        specs = [s for s in parse_plan(text)
                 if s.stream is None or s.stream == stream]
        if not specs:
            return None
        return cls(specs)

    def armed(self, site: str) -> bool:
        return site in self._by_site

    def fire(self, site: str, index: int) -> None:
        """Raise or stall if a fault is scheduled at (site, index) and
        has not fired yet.  Counted per fire (``faults_injected``, a
        ``fault.injected`` event)."""
        spec = self._by_site.get(site, {}).get(index)
        if spec is None or spec.fired:
            return
        spec.fired = True
        metrics.add("faults_injected")
        events.emit("fault.injected", seg=index, info=str(spec))
        log.warning(f"[faults] firing {spec}")
        if spec.action == "stall":
            time.sleep(spec.arg)
            return
        if spec.action == "fatal":
            raise InjectedFatal(f"injected fatal fault at {spec}")
        if spec.action == "corrupt":
            raise InjectedCorruption(f"injected corruption at {spec}")
        if spec.action in DEVICE_ACTIONS:
            raise device_fault(spec.action, spec)
        raise InjectedFault(f"injected transient fault at {spec}")

    def unfired(self) -> list[FaultSpec]:
        """Specs that never fired."""
        return [s for site in self._by_site.values()
                for s in site.values() if not s.fired]
