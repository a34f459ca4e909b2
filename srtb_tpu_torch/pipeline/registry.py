"""The search-mode registry and the demotion-ladder steps (port of those
parts of ``srtb_tpu/pipeline/registry.py``).

A :class:`SearchMode` names one search capability, the Config value that
selects it (``Config.search_mode``) and the processor class that
implements it.  ``Pipeline`` builds its processor through
:func:`build_processor`, so a registered mode reaches the engine without
a branch there.  The classes resolve lazily (``module:Class`` paths):
importing the table imports no processor module, and the processor
modules may import this one.

A :class:`LadderStep` is one step of the plan-demotion ladder
(``resilience/demote.py``): its apply rule maps ``(cfg, staged)`` to a
cheaper ``(cfg, staged)``, or to None when the step would not change the
resolved plan.  The rules call the processor's own resolvers
(``pipeline/segment.py``), so a rung never demotes onto the plan it left.
The steps keep the reference's names, order and configs.  Under the
port's plan rule (K1, B13 and K2 run whatever ``use_pallas`` says, and
every kernel lives in one library), the ``fused_tail`` rung turns
``use_pallas`` off as the reference's does, but it cannot escape a real
kernel build fault: that ladder ends in ``LadderExhausted``.

The reference's registry also holds the plan families (for its HLO
auditor, which reads XLA's compiled programs and has no counterpart in
the port).  :func:`plan_cache_key` is the fleet's shared-plan key
(``pipeline/fleet.SharedPlanCache``).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class SearchMode:
    """One registered search capability (``Config.search_mode``)."""

    name: str
    desc: str
    # lazy "module:Class" path of the SegmentProcessor (sub)class that
    # implements the mode, resolved on first build
    cls_path: str

    def resolve(self):
        mod, _, cls = self.cls_path.partition(":")
        return getattr(importlib.import_module(mod), cls)


_MODES: dict[str, SearchMode] = {}


def register_mode(mode: SearchMode) -> SearchMode:
    if mode.name in _MODES:
        raise ValueError(f"search mode {mode.name!r} already registered")
    _MODES[mode.name] = mode
    return mode


def search_modes() -> tuple[SearchMode, ...]:
    return tuple(_MODES.values())


def resolve_mode(cfg) -> SearchMode:
    """The registered mode selected by ``cfg.search_mode`` (a missing
    attribute is the default single-pulse mode).  An unknown name raises:
    a typo must not silently run the wrong search."""
    name = str(getattr(cfg, "search_mode", "single_pulse")
               or "single_pulse").lower()
    mode = _MODES.get(name)
    if mode is None:
        raise ValueError(
            f"unknown search_mode {name!r} "
            f"(registered: {', '.join(sorted(_MODES))})")
    return mode


def build_processor(cfg, **kwargs):
    """The segment processor of ``cfg``'s mode; ``kwargs`` pass through to
    its constructor (window_name, device, staged)."""
    return resolve_mode(cfg).resolve()(cfg, **kwargs)


def plan_cache_key(cfg, **kwargs) -> str:
    """Mode-dispatched shared-plan cache key
    (``SegmentProcessor.plan_cache_key``): each mode's class projects its
    own trace-relevant config, so two configs share a processor only
    when mode AND projection agree."""
    return resolve_mode(cfg).resolve().plan_cache_key(cfg, **kwargs)


register_mode(SearchMode(
    "single_pulse",
    "single-pulse search: boxcar cascade over the dedispersed "
    "time series (the reference pipeline's mode)",
    "srtb_tpu_torch.pipeline.segment:SegmentProcessor"))

register_mode(SearchMode(
    "periodicity",
    "periodicity search: harmonic-summed power spectrum over the "
    "dedispersed time series + phase folding at detected candidates "
    "(the FPGA pulsar-search paper's module set), on top of the "
    "single-pulse chain",
    "srtb_tpu_torch.pipeline.periodicity:PeriodicitySegmentProcessor"))


# ------------------------------------------------------------------
# demotion-ladder steps


@dataclass(frozen=True)
class LadderStep:
    """One demotion step: its name and its apply rule, ``(cfg, staged) ->
    (cheaper_cfg, staged) | None`` (None: the step would not change the
    resolved plan, a skipped rung).  ``staged`` is the processor's
    explicit constructor argument (None: resolved from the size)."""

    name: str
    desc: str
    apply: object


_STEPS: dict[str, LadderStep] = {}


def register_step(step: LadderStep) -> LadderStep:
    if step.name in _STEPS:
        raise ValueError(f"ladder step {step.name!r} already registered")
    _STEPS[step.name] = step
    return step


def ladder_steps() -> tuple[LadderStep, ...]:
    return tuple(_STEPS.values())


def ladder_order() -> tuple[str, ...]:
    return tuple(_STEPS)


def ladder_step(name: str) -> LadderStep:
    step = _STEPS.get(name)
    if step is None:
        raise ValueError(f"unknown ladder step {name!r} "
                         f"(steps: {', '.join(_STEPS)})")
    return step


# the apply rules import the processor's resolvers lazily: the segment
# module imports this one


def _resolved_staged(cfg, staged):
    from srtb_tpu_torch.pipeline.segment import staged_resolves
    return staged_resolves(cfg, staged)


def _apply_quality(cfg, staged):
    if not getattr(cfg, "quality_stats", False):
        return None
    return cfg.replace(quality_stats=False), staged


def _apply_search_mode(cfg, staged):
    if str(getattr(cfg, "search_mode", "single_pulse")
           or "single_pulse").lower() == "single_pulse":
        return None
    return cfg.replace(search_mode="single_pulse"), staged


def _apply_micro_batch(cfg, staged):
    if int(getattr(cfg, "micro_batch_segments", 1) or 1) <= 1:
        return None
    return cfg.replace(micro_batch_segments=1), staged


def _apply_front_fuse(cfg, staged):
    from srtb_tpu_torch.pipeline.segment import (_front_fuse_structural,
                                                 front_fuse_resolves)
    resolved = _resolved_staged(cfg, staged)
    # the structural check first: a forced "on" where the fusion is
    # impossible reads as nothing to drop, not as the knob's ValueError
    if not _front_fuse_structural(cfg, resolved):
        return None
    if not front_fuse_resolves(cfg, resolved):
        return None
    return cfg.replace(front_fuse="off"), staged


def _drop_forced_front_fuse(cfg):
    """A rung that breaks a front-fuse prerequisite also clears a forced
    ``front_fuse = "on"``, so its config builds."""
    if str(getattr(cfg, "front_fuse", "auto")).lower() == "on":
        return cfg.replace(front_fuse="off")
    return cfg


def _apply_ring(cfg, staged):
    if str(getattr(cfg, "ingest_ring", "auto")).lower() == "off":
        return None
    from srtb_tpu_torch.pipeline.segment import ring_usable
    if not ring_usable(cfg):
        return None
    return cfg.replace(ingest_ring="off"), staged


def _apply_skzap(cfg, staged):
    if not (getattr(cfg, "use_pallas_sk", False)
            and getattr(cfg, "use_pallas", False)):
        return None
    return cfg.replace(use_pallas_sk=False), staged


def _apply_fused_tail(cfg, staged):
    from srtb_tpu_torch.pipeline.segment import fused_tail_resolves
    if not (fused_tail_resolves(cfg, _resolved_staged(cfg, staged))
            or getattr(cfg, "use_pallas", False)):
        return None
    cfg = _drop_forced_front_fuse(cfg)
    return cfg.replace(fused_tail="off", use_pallas=False), staged


def _apply_staged(cfg, staged):
    if _resolved_staged(cfg, staged):
        return None
    # the staged plan refuses a micro-batch, even when an explicit
    # plan_ladder subset skipped the micro_batch rung
    if int(getattr(cfg, "micro_batch_segments", 1) or 1) > 1:
        cfg = cfg.replace(micro_batch_segments=1)
    return cfg, True


def _apply_monolithic(cfg, staged):
    from srtb_tpu_torch.ops import fft as F
    n = int(getattr(cfg, "baseband_input_count", 0) or 0)
    already = (not _resolved_staged(cfg, staged) and n > 0
               and F.resolve_strategy(
                   n, getattr(cfg, "fft_strategy", "auto"))
               == "monolithic")
    if already:
        return None
    return _drop_forced_front_fuse(cfg).replace(
        fft_strategy="monolithic"), False


register_step(LadderStep(
    "quality", "drop the data-quality epilogue (telemetry, not science)",
    _apply_quality))
register_step(LadderStep(
    "search_mode", "drop the extra search mode back to single-pulse",
    _apply_search_mode))
register_step(LadderStep(
    "micro_batch", "drop micro-batching (B x the chain's footprint)",
    _apply_micro_batch))
register_step(LadderStep(
    "front_fuse", "drop the front-fused B11/B12 plan back to the staged "
    "front (K1, B9, B10, K2)", _apply_front_fuse))
register_step(LadderStep(
    "ring", "drop the ingest ring's device-resident carry", _apply_ring))
register_step(LadderStep(
    "skzap", "drop the one-kernel waterfall tail (B8)", _apply_skzap))
register_step(LadderStep(
    "fused_tail", "drop the fused spectrum epilogue and use_pallas",
    _apply_fused_tail))
register_step(LadderStep(
    "staged", "the staged plan instead of the fused one", _apply_staged))
register_step(LadderStep(
    "monolithic", "the minimal floor: the monolithic R2C, no fused tail",
    _apply_monolithic))
