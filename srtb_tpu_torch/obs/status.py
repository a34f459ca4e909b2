"""Fleet status: one structured snapshot for the operator console (port of
``srtb_tpu/obs/status.py``).

:func:`fleet_status` assembles everything an operator scans during a
run — pool member states, per-stream SLO burn, roofline gauges, batch
occupancy, the migration timeline, drift alerts — into ONE dict, from
two sources:

- the live metrics registry + SLO tracker (in-process state: gauges
  the fleet publishes as it runs);
- optionally a rollup store directory (obs/store.py): recent
  per-minute rollups, the fleet event timeline, and the stage/device
  quantile digests the aggregator persisted — this is what makes the
  console work OUT of process (``tools/console.py --store DIR``
  against a store another host's aggregator wrote).

Consumers: ``gui/server.py``'s ``/fleet`` endpoint (JSON over HTTP)
and ``tools/console.py`` (rendered text).  Everything here is
read-only and allocation-light — safe to call from a request handler
mid-run.
"""

from __future__ import annotations

RECENT_MINUTES = 16      # rollup minutes surfaced to the console
RECENT_EVENTS = 32       # migration-timeline tail length


def _device_states() -> dict:
    """label -> decoded pool state from the fleet_device_state gauge
    (the pool publishes codes; decode them here so every consumer
    doesn't)."""
    from srtb_tpu_torch.pipeline.pool import _STATE_CODE
    from srtb_tpu_torch.utils.metrics import metrics
    code_name = {v: k for k, v in _STATE_CODE.items()}
    return {dev: code_name.get(int(code), f"code{int(code)}")
            for dev, code in
            metrics.by_label("fleet_device_state",
                             label="device").items()}


def fleet_status(store_dir: str = "") -> dict:
    """The control-tower snapshot (see module docstring)."""
    from srtb_tpu_torch.utils import slo
    from srtb_tpu_torch.utils.metrics import metrics

    states = _device_states()
    lanes = metrics.by_label("fleet_device_lanes", label="device")
    drains = metrics.by_label("device_drains", label="device")
    dev_migrations = metrics.by_label("migrations", label="device")
    devices = {}
    for dev in sorted(set(states) | set(lanes)):
        devices[dev] = {
            "state": states.get(dev, "unknown"),
            "lanes": int(lanes.get(dev, 0)),
            "drains": int(drains.get(dev, 0)),
            "migrations": int(dev_migrations.get(dev, 0)),
        }

    streams = {}
    per_stream = {
        "roofline_frac": metrics.by_label("roofline_frac"),
        "achieved_msamps": metrics.by_label("achieved_msamps"),
        "achieved_gbps": metrics.by_label("achieved_gbps"),
        "segments": metrics.by_label("segments"),
        "dropped": metrics.by_label("segments_dropped"),
        "signals": metrics.by_label("signals"),
        "migrations": metrics.by_label("migrations"),
        "drift_score": metrics.by_label("quality_drift_score"),
    }
    for key, by in per_stream.items():
        for stream, val in by.items():
            streams.setdefault(stream, {})[key] = (
                round(float(val), 4) if key.startswith(
                    ("roofline", "achieved", "drift"))
                else int(val))

    dispatches = metrics.get("batched_dispatches")
    segments = metrics.get("batched_segments")
    out = {
        "devices": devices,
        "pool": {
            "members": len(devices),
            "migrations": int(metrics.get("migrations")),
            "device_drains": int(metrics.get("device_drains")),
            "device_reinits": int(metrics.get("device_reinits")),
        },
        "streams": streams,
        "slo": slo.evaluate() or {},
        "roofline": {
            "frac": round(metrics.get("roofline_frac"), 4),
            "msamps": round(metrics.get("achieved_msamps"), 2),
            "gbps": round(metrics.get("achieved_gbps"), 3),
        },
        "batch": {
            "dispatches": int(dispatches),
            "segments": int(segments),
            # mean segments per device dispatch — THE continuous-
            # batching health number (1.0 = batching idle)
            "occupancy": round(segments / dispatches, 3)
            if dispatches else 0.0,
        },
        "drift": {
            "score": round(metrics.get("quality_drift_score"), 4),
            "alerts": int(metrics.get("quality_drift_alerts")),
        },
    }
    if store_dir:
        out["store"] = _store_section(store_dir)
    return out


def _store_section(store_dir: str) -> dict:
    """Rollup-store tail: recent minutes, the fleet event timeline,
    digest percentiles.  Tolerates a missing/empty store (the console
    may start before the aggregator's first flush)."""
    from srtb_tpu_torch.obs.digest import QuantileDigest
    from srtb_tpu_torch.obs.store import RollupStore
    try:
        state = RollupStore(store_dir).latest()
    except OSError:
        return {"error": f"unreadable store {store_dir}"}
    minutes, events, digests = [], [], {}
    for row in state.values():
        t = row.get("type")
        if t == "rollup_minute":
            minutes.append(row)
        elif t == "fleet_event":
            events.append(row)
        elif t == "rollup_digest":
            try:
                dig = QuantileDigest.from_dict(row.get("digest") or {})
            except (TypeError, ValueError):
                continue
            pcts = {k: round(v, 4)
                    for k, v in dig.percentiles().items()
                    if v == v}  # drop NaN (empty digest)
            pcts["n"] = dig.count
            digests[f"{row.get('kind')}:{row.get('label')}"] = pcts
    minutes.sort(key=lambda r: (r.get("minute", 0), r.get("k", "")))
    events.sort(key=lambda r: r.get("ts", 0.0))
    return {
        "rows": len(state),
        "minutes": minutes[-RECENT_MINUTES:],
        "timeline": events[-RECENT_EVENTS:],
        "digests": dict(sorted(digests.items())),
    }
