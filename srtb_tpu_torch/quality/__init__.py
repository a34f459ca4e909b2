"""Data quality: the per-segment statistics on the card and the
pulse-injection canary (port of the JAX package's ``quality``).

- :mod:`srtb_tpu_torch.quality.stats` — the statistics as an epilogue of
  the segment plans, the EWMA bandpass-drift detector and the
  ``QualityMonitor`` that turns the packed vector into gauges and
  journal fields;
- :mod:`srtb_tpu_torch.quality.canary` — a synthetic dispersed pulse
  injected every ``Config.canary_every_segments`` segments and its
  recovered S/N.
"""

from srtb_tpu_torch.quality.canary import CanaryController
from srtb_tpu_torch.quality.stats import (EWMADrift, QualityMonitor,
                                          quality_stats_device,
                                          quality_stats_oracle,
                                          unpack_stats)

__all__ = [
    "CanaryController",
    "EWMADrift",
    "QualityMonitor",
    "quality_stats_device",
    "quality_stats_oracle",
    "unpack_stats",
]
