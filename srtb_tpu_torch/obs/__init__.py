"""The rollup store and its readers (port of ``srtb_tpu/obs/``): the
monitoring plane over the per-process surfaces (span journals, event
dumps, ``/metrics``, the perf ledger).

- :mod:`~srtb_tpu_torch.obs.digest` — mergeable quantile digests
  (DDSketch-style relative-accuracy buckets);
- :mod:`~srtb_tpu_torch.obs.store` — the long-horizon rollup store:
  append-only JSONL segments with retention + idempotent compaction;
- :mod:`~srtb_tpu_torch.obs.rollup` — the aggregator that tails journals
  (plaintext + rotated .gz) and event dumps, resumable by offset;
- :mod:`~srtb_tpu_torch.obs.trace_join` — the cross-device Perfetto
  export, one process track per device;
- :mod:`~srtb_tpu_torch.obs.regression` — the mid-run regression watch
  (rollup medians against the perf ledger's history).

The reference's ``obs/status.py`` (the ``/fleet`` payload and the
console's data) reads the fleet (``pipeline/fleet.py``, A8b) and its pool
and comes in ROADMAP A8c.
"""

from __future__ import annotations

__all__ = ["digest", "store", "rollup", "trace_join", "regression"]
