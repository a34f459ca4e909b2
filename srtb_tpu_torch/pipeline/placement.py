"""Placement policy for the elastic fleet device pool (port of
``srtb_tpu/pipeline/placement.py``).

Pure functions — the fleet passes in the candidate
:class:`~srtb_tpu_torch.pipeline.pool.PoolDevice` members and the current
per-device lane loads, and gets back a choice.  Keeping the policy
side-effect free makes it unit-testable without a fleet and keeps the
scheduler thread the only thing that mutates placement state.

Two decisions live here:

- :func:`choose_initial` — where a newly admitted stream lands.
  Honors an explicit ``StreamSpec.pin_device``, otherwise picks the
  least-loaded healthy member with soft same-tenant anti-affinity.
- :func:`choose_target` — where a migrating lane goes (device drain,
  SLO rebalance, rolling restart).  Least-loaded healthy member that
  is not the lane's current device, same soft anti-affinity.

Tenant convention: the stream-name prefix before the first ``.`` is
the tenant (``radioA.band0`` and ``radioA.band1`` are the same tenant
``radioA``).  A name with no dot is its own tenant, so anti-affinity
is a no-op for flat names.  Anti-affinity is SOFT: it breaks ties and
biases spread, but never leaves a stream unplaced — with more
same-tenant lanes than devices, co-location is accepted.

Priority (``StreamSpec.priority``) is handled upstream by admission
ordering — by the time placement runs, higher-priority streams were
admitted first and therefore grabbed the emptier devices; the policy
itself is priority-agnostic, which keeps rebalance decisions stable.
"""

from __future__ import annotations


def tenant_of(name: str) -> str:
    """Tenant key for a stream name: prefix before the first ``.``."""
    return name.split(".", 1)[0]


def _load_of(dev, loads: dict) -> int:
    return int(loads.get(dev.index, 0))


def _pick_least_loaded(candidates, loads, tenant, tenants_by_device):
    """Least-loaded candidate; soft anti-affinity = among the minimum
    load tier, prefer a device with no same-tenant lane.  Index order
    breaks the final tie for determinism."""
    if not candidates:
        return None
    lo = min(_load_of(d, loads) for d in candidates)
    tier = [d for d in candidates if _load_of(d, loads) == lo]
    clean = [d for d in tier
             if tenant not in tenants_by_device.get(d.index, ())]
    pool = clean or tier
    return min(pool, key=lambda d: d.index)


def choose_initial(spec, devices, loads, tenants_by_device=None):
    """Pick the device a newly admitted ``spec`` starts on.

    ``devices`` — healthy pool members (the fleet pre-filters).
    ``loads`` — ``{device_index: live lane count}``.
    ``tenants_by_device`` — ``{device_index: set of tenant keys}``.

    Raises ``ValueError`` for an out-of-range or unhealthy
    ``pin_device`` so the lane fails validation BEFORE any pipeline
    state is built (same contract as the fleet's other pure-config
    checks).
    """
    tenants_by_device = tenants_by_device or {}
    pin = getattr(spec, "pin_device", None)
    if pin is not None:
        by_index = {d.index: d for d in devices}
        if pin not in by_index:
            raise ValueError(
                f"stream {spec.name!r}: pin_device={pin} is not a "
                f"healthy pool member (have {sorted(by_index)})")
        return by_index[pin]
    return _pick_least_loaded(devices, loads, tenant_of(spec.name),
                              tenants_by_device)


def choose_target(lane_name, current_index, devices, loads,
                  tenants_by_device=None):
    """Pick the migration target for a lane currently on
    ``current_index``.  Candidates exclude the current device; returns
    ``None`` when no peer exists (caller falls back to fleet-wide
    reinit — today's behavior, now the last resort)."""
    tenants_by_device = tenants_by_device or {}
    candidates = [d for d in devices if d.index != current_index]
    return _pick_least_loaded(candidates, loads, tenant_of(lane_name),
                              tenants_by_device)
