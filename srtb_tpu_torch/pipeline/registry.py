"""The search-mode registry (port of the search-mode part of
``srtb_tpu/pipeline/registry.py``).

A :class:`SearchMode` names one search capability, the Config value that
selects it (``Config.search_mode``) and the processor class that
implements it.  ``Pipeline`` builds its processor through
:func:`build_processor`, so a registered mode reaches the engine without
a branch there.  The classes resolve lazily (``module:Class`` paths):
importing the table imports no processor module, and the processor
modules may import this one.

The reference's registry also holds the plan families (for its HLO
auditor, ROADMAP A9), the demotion-ladder steps (A7) and the fleet's
``plan_cache_key`` (A8); they come with those items.
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
