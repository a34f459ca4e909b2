"""The plan-demotion ladder and the device reinit (port of
``srtb_tpu/resilience/demote.py``).

**Plan demotion** (``oom`` / ``compile`` faults).  The ladder is an
ordered list of progressively cheaper plans derived from the active
config by the registry's steps (``pipeline/registry.py``)::

    quality -> search_mode -> micro_batch -> front_fuse -> ring ->
    skzap -> fused_tail -> staged -> monolithic

Each rung is cumulative and rungs that would not change the resolved plan
are skipped.  On a device fault at a dispatch or fetch site the engine
demotes one rung, rebuilds the processor from the rung's config (the old
one retired and the allocator's cache emptied first, so the new rung does
not meet the old rung's memory), and re-dispatches the faulted segment
cold from its pinned host buffer.  The lower rungs do some kernels'
work in plain PyTorch or a library call (``monolithic`` runs ``torch.fft``
where B9/B10 or B6 ran), so the engine demotes only an out-of-memory and
the fault plan's injected faults: a real build or launch fault of the
port's own kernels escalates (``errors.KernelFault``).

**Device reinit** (``halt`` faults).  The processor is rebuilt at the
current rung and every in-flight segment is re-dispatched cold, in
dispatch order, under the ``device_reinit_max`` / ``device_reinit_window_s``
budget.  On a card a halt (an illegal address, a device-side assert) kills
the CUDA context for the life of the process: the rebuilt processor's
first launch fails again, the budget is spent and the run escalates with
``ReinitBudgetExceeded``.  The recovery from a sticky fault is a new
process resuming from the checkpoint (``checkpoint_path``,
``run_manifest_path``), not the reinit.

**Promotion probe.**  With ``promote_after_segments = N > 0``, N healthy
drained segments on a demoted plan promote one rung back up.

Counted in the metrics registry: ``plan_demotions``, ``plan_promotions``,
``device_reinits`` and the ``plan_ladder_level`` gauge (each with its
``stream``-labeled twin for a named stream), each transition a
``heal.demote``, ``heal.promote`` or ``heal.reinit`` event.
"""

from __future__ import annotations

from dataclasses import dataclass

from srtb_tpu_torch.pipeline import registry
from srtb_tpu_torch.resilience.errors import classify_device
from srtb_tpu_torch.resilience.supervisor import Supervisor
from srtb_tpu_torch.utils import events
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

# the canonical rung order, read from the registry
LADDER_ORDER = registry.ladder_order()


@dataclass(frozen=True)
class Rung:
    """One demotion target: the step that produced it, the demoted config
    and the explicit ``staged`` argument (None: resolved from the
    size)."""

    step: str
    cfg: object
    staged: bool | None

    @property
    def name(self) -> str:
        return self.step


def parse_ladder(text: str) -> tuple[str, ...]:
    """``Config.plan_ladder`` -> the ordered steps: "auto" is the whole
    order, "off" none, a comma list a subset in its order; an unknown
    step raises."""
    text = (text or "auto").strip().lower()
    if text in ("auto", ""):
        return LADDER_ORDER
    if text == "off":
        return ()
    steps = tuple(s.strip() for s in text.split(",") if s.strip())
    for s in steps:
        if s not in LADDER_ORDER:
            raise ValueError(
                f"plan_ladder step {s!r} unknown "
                f"(steps: {', '.join(LADDER_ORDER)}, or auto/off)")
    return steps


def ladder_rungs(cfg, base_staged: bool | None = None,
                 steps: tuple[str, ...] = LADDER_ORDER) -> list[Rung]:
    """The rungs reachable from ``cfg``: cumulative configs in ladder
    order, no-op steps skipped.  ``base_staged`` is the current
    processor's resolved staged flag."""
    rungs: list[Rung] = []
    cur, staged = cfg, base_staged
    for step in steps:
        out = registry.ladder_step(step).apply(cur, staged)
        if out is None:
            continue
        cur, staged = out
        rungs.append(Rung(step, cur, staged))
    return rungs


class ComputeHealer:
    """The per-run state machine: the ladder position, the promotion
    counter and the reinit budget.  ``factory(cfg, staged)`` builds a
    replacement processor (the pipeline's hook).  The engine calls it only
    from its exception handlers and once a drained segment."""

    def __init__(self, cfg, factory, steps: tuple[str, ...] = None,
                 base_staged: bool | None = None, promote_after: int = 0,
                 reinit_max: int = 0, reinit_window_s: float = 300.0):
        if steps is None:
            steps = parse_ladder(getattr(cfg, "plan_ladder", "auto"))
        self._cfg = cfg
        self._factory = factory
        self._steps = steps
        self._rungs = ladder_rungs(cfg, base_staged, steps)
        self._base_staged = base_staged
        self._level = 0
        self._healthy = 0
        self.promote_after = int(promote_after)
        self._reinit = None
        if int(reinit_max) > 0:
            self._reinit = Supervisor(
                "device_reinit", max_restarts=int(reinit_max),
                window_s=float(reinit_window_s), counter=None)
        stream = str(getattr(cfg, "stream_name", "") or "")
        self._labels = {"stream": stream} if stream else None
        self._mark(None)

    @classmethod
    def from_config(cls, cfg, factory) -> "ComputeHealer | None":
        """None when both mechanisms are off: ``plan_ladder = off`` and
        ``device_reinit_max = 0``."""
        steps = parse_ladder(getattr(cfg, "plan_ladder", "auto"))
        reinit_max = int(getattr(cfg, "device_reinit_max", 0) or 0)
        if not steps and reinit_max <= 0:
            return None
        return cls(
            cfg, factory, steps=steps,
            promote_after=int(getattr(cfg, "promote_after_segments", 0)
                              or 0),
            reinit_max=reinit_max,
            reinit_window_s=float(getattr(cfg, "device_reinit_window_s",
                                          300.0)))

    def _mark(self, counter: str | None) -> None:
        """Count ``counter`` (None: none) and set the ladder gauge."""
        if counter is not None:
            metrics.add(counter)
        metrics.set("plan_ladder_level", self._level)
        if self._labels is not None:
            if counter is not None:
                metrics.add(counter, labels=self._labels)
            metrics.set("plan_ladder_level", self._level,
                        labels=self._labels)

    @property
    def _stream(self) -> str | None:
        return (self._labels or {}).get("stream")

    # ------------------------------------------------------- state

    @property
    def level(self) -> int:
        """The ladder position (0: the base plan)."""
        return self._level

    @property
    def rungs(self) -> list[Rung]:
        return list(self._rungs)

    @property
    def active_cfg(self):
        """The config of the active rung (the base config at level 0)."""
        if self._level == 0:
            return self._cfg
        return self._rungs[self._level - 1].cfg

    @property
    def active_step(self) -> str:
        return "full" if self._level == 0 \
            else self._rungs[self._level - 1].step

    @property
    def micro_batch(self) -> int:
        """The active plan's micro-batch: the engine's unit follows it."""
        return max(1, int(getattr(self.active_cfg, "micro_batch_segments",
                                  1) or 1))

    def bind_base(self, base_staged: bool | None) -> None:
        """Bind the resolved staged flag of the pipeline's processor and
        rebuild the rungs."""
        if base_staged != self._base_staged:
            self._base_staged = base_staged
            self._rungs = ladder_rungs(self._cfg, base_staged, self._steps)

    # -------------------------------------------------- transitions

    def classify(self, exc: BaseException) -> str | None:
        """The device-fault kind of ``exc`` (None: not a device fault),
        whatever budget is left, so the engine can raise the typed
        escalation."""
        return classify_device(exc)

    def _build(self, rung_level: int):
        if rung_level == 0:
            return self._factory(self._cfg, self._base_staged)
        rung = self._rungs[rung_level - 1]
        return self._factory(rung.cfg, rung.staged)

    def demote(self, exc: BaseException, kind: str):
        """One rung down: the replacement processor, or None when the
        ladder is spent."""
        if self._level >= len(self._rungs):
            return None
        self._level += 1
        self._healthy = 0
        rung = self._rungs[self._level - 1]
        self._mark("plan_demotions")
        events.emit("heal.demote", stream=self._stream,
                    info=f"{rung.step}@{self._level} ({kind})")
        log.warning(
            f"[selfheal] device fault ({kind}) — demoting to ladder "
            f"rung {self._level}/{len(self._rungs)} ({rung.step}): "
            f"{exc!r}")
        return self._build(self._level)

    def reinit(self, exc: BaseException):
        """A rebuild at the current rung: the fresh processor, or None
        when the reinit budget is spent within the window."""
        if self._reinit is None or not self._reinit.should_restart(exc):
            return None
        metrics.add("device_reinits")
        if self._labels is not None:
            metrics.add("device_reinits", labels=self._labels)
        events.emit("heal.reinit", stream=self._stream,
                    info=f"{self.active_step}@{self._level}")
        log.warning(
            f"[selfheal] device halt — reinitializing at ladder rung "
            f"{self._level} ({self.active_step}): {exc!r}")
        return self._build(self._level)

    def rebuild(self, shared=None):
        """A fresh processor at the CURRENT rung, with no budget check and
        no counters: the fleet's shared reinit makes one budgeted decision
        for the whole device and then rebuilds every lane (charging each
        lane's own budget would let one flapping neighbor bankrupt the
        fleet).  ``shared`` (a zero-argument factory) serves the fleet's
        live migration: a lane at rung 0 re-admits through its target
        member's shared plan cache; a demoted lane stays on its unshared
        rung."""
        if shared is not None and self._level == 0:
            return shared()
        return self._build(self._level)

    # --------------------------------------------- promotion probe

    def note_healthy(self) -> None:
        """One fetched segment on a demoted plan."""
        if self._level > 0 and self.promote_after > 0:
            self._healthy += 1

    def promote_due(self) -> bool:
        return (self._level > 0 and self.promote_after > 0
                and self._healthy >= self.promote_after)

    def promote(self):
        """One rung back up: the richer processor (the next dispatch
        probes it; a recurring fault demotes again)."""
        if self._level <= 0:
            return None
        self._level -= 1
        self._healthy = 0
        self._mark("plan_promotions")
        events.emit("heal.promote", stream=self._stream,
                    info=f"{self.active_step}@{self._level}")
        log.info(
            f"[selfheal] {self.promote_after} healthy segments — "
            f"promotion probe back to rung {self._level} "
            f"({self.active_step})")
        return self._build(self._level)
