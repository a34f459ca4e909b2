"""Deterministic fault injection, ``Config.fault_plan`` (port of
``srtb_tpu/resilience/faults.py``, the part the durability tests steer
their crash windows with).

Plan syntax (comma-separated entries)::

    [stream:]site:action@index

- ``stream``  optional selector: the entry fires only in the pipeline
              whose ``Config.stream_name`` matches; any prefix that is not
              a site name is read as one;
- ``site``    one of ``ingest``, ``h2d``, ``dispatch``, ``fetch``,
              ``sink_write``, ``checkpoint``, the hook points of
              ``pipeline/runtime.py`` (``Pipeline._op``);
- ``action``  ``stall=SECONDS`` (sleeps) or ``fatal``
              (:class:`InjectedFatal`, ends the run);
- ``index``   the segment the fault fires on, in dispatch order within
              the run, 0-based, the same space at every site (a resumed
              run counts from its own first segment).

Each armed fault fires once.  The reference's other actions (``raise``,
``corrupt``, and the device faults ``oom``, ``compile_fail`` and
``device_halt``) are recovered by its retry layer and its demotion
ladder, which the port does not have yet: a plan naming one raises
``NotImplementedError`` (ROADMAP A7), as does any plan with
``retry_max_attempts > 1``, since a retry the port does not perform
would change what the plan's run does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from srtb_tpu_torch.utils.logging import log

SITES = ("ingest", "h2d", "dispatch", "fetch", "sink_write",
         "checkpoint")
DEVICE_ACTIONS = ("oom", "compile_fail", "device_halt")
ACTIONS = ("raise", "fatal", "corrupt", "stall") + DEVICE_ACTIONS
DEVICE_SITES = ("h2d", "dispatch", "fetch")
# the actions whose outcome does not depend on a retry layer
PORTED_ACTIONS = ("fatal", "stall")


class InjectedFatal(RuntimeError):
    """A scheduled fatal fault."""


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
    def from_plan(cls, text: str, stream: str = "",
                  retry_max_attempts: int = 1) -> "FaultInjector | None":
        """None for an empty plan, or when every entry is scoped to
        another stream.  Raises ``NotImplementedError`` for an action the
        port does not inject and for a plan run with retries (ROADMAP
        A7)."""
        if not text or not text.strip():
            return None
        specs = [s for s in parse_plan(text)
                 if s.stream is None or s.stream == stream]
        if not specs:
            return None
        for s in specs:
            if s.action not in PORTED_ACTIONS:
                raise NotImplementedError(
                    f"fault_plan action {s.action!r} ({s}) is not ported "
                    "yet (ROADMAP A7: its recovery is the retry layer "
                    "and the demotion ladder)")
        if int(retry_max_attempts or 1) > 1:
            raise NotImplementedError(
                "a fault_plan with retry_max_attempts > 1 is not ported "
                "yet (ROADMAP A7: the retry layer); set "
                "retry_max_attempts = 1")
        return cls(specs)

    def armed(self, site: str) -> bool:
        return site in self._by_site

    def fire(self, site: str, index: int) -> None:
        """Stall or raise if a fault is scheduled at (site, index) and
        has not fired yet."""
        spec = self._by_site.get(site, {}).get(index)
        if spec is None or spec.fired:
            return
        spec.fired = True
        log.warning(f"[faults] firing {spec}")
        if spec.action == "stall":
            time.sleep(spec.arg)
            return
        raise InjectedFatal(f"injected fatal fault at {spec}")

    def unfired(self) -> list[FaultSpec]:
        """Specs that never fired."""
        return [s for site in self._by_site.values()
                for s in site.values() if not s.fired]
