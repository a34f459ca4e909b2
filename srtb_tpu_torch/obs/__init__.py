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
  (rollup medians against the perf ledger's history);
- :mod:`~srtb_tpu_torch.obs.status` — the fleet's status snapshot (pool
  members, streams, SLO burn, batch occupancy, the store's tail): the
  viewer's ``/fleet`` payload and ``tools/console.py``'s data.
"""

from __future__ import annotations

__all__ = ["digest", "store", "rollup", "trace_join", "regression",
           "status"]
