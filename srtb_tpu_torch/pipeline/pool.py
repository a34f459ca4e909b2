"""Elastic device pool: the fleet's placement substrate (port of
``srtb_tpu/pipeline/pool.py``).

A :class:`DevicePool` holds one :class:`PoolDevice` per member.  Each
member owns:

- its OWN :class:`~srtb_tpu_torch.pipeline.fleet.SharedPlanCache`: plan
  families are shared within a device, never across devices, so a
  member's processors die with the member and a halt force-retires ITS
  cache only (the per-device HALT domain);
- its health state (``ok`` / ``draining`` / ``halted``) published as the
  ``fleet_device_state`` gauge with a ``device`` label;
- a dispatch counter, which is also the deterministic fault injection
  point: :meth:`PoolDevice.schedule_halt` arms a virtual halt that raises
  :class:`~srtb_tpu_torch.resilience.errors.DeviceHalt` on the first
  dispatch past the scheduled count (no wall clock, no RNG).

On the card a member holds a ``torch.device("cuda", i)``: ``fleet_devices
>= 2`` binds real cards, capped at ``torch.cuda.device_count()`` with the
reference's warning (one member on a one-card host).  On the CPU the pool
is VIRTUAL: N logical members share the one CPU device but keep distinct
plan caches, batch-former families and halt domains, so the control plane
(placement, migration, drain, scoped invalidation) is the reference's,
which is what the migration soak gates.  ``fleet_devices <= 1`` builds a
one-member pool: every fleet path goes through the pool.
"""

from __future__ import annotations

import torch

from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

# fleet_device_state gauge codes (per-device label)
STATE_OK = "ok"
STATE_DRAINING = "draining"
STATE_HALTED = "halted"
_STATE_CODE = {STATE_OK: 0, STATE_DRAINING: 1, STATE_HALTED: 2}


class PoolDevice:
    """One pool member: identity, its own plan cache, health state and
    the deterministic dispatch counter.  ``device`` is the
    ``torch.device`` its lanes' processors run on."""

    def __init__(self, index: int, device: torch.device | None = None,
                 label: str | None = None):
        from srtb_tpu_torch.pipeline.fleet import SharedPlanCache
        self.index = int(index)
        self.label = label or f"dev{index}"
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        # the per-device plan-family cache (the per-device HALT domain:
        # invalidating THIS cache never touches a neighbor's)
        self.plans = SharedPlanCache(device=self.label,
                                     torch_device=self.device)
        self.state = STATE_OK
        self.dispatches = 0
        self._halt_at: int | None = None
        self._halt_fired = False
        self._publish()

    # ----------------------------------------------------- health state

    def set_state(self, state: str) -> None:
        if state not in _STATE_CODE:
            raise ValueError(f"unknown device state {state!r}")
        self.state = state
        self._publish()

    def _publish(self) -> None:
        metrics.set("fleet_device_state", _STATE_CODE[self.state],
                    labels={"device": self.label})

    # ------------------------------------------ deterministic injection

    def schedule_halt(self, after_dispatches: int) -> None:
        """Arm a VIRTUAL halt: the first :meth:`note_dispatch` past
        ``after_dispatches`` total dispatches on this member raises
        :class:`DeviceHalt`, the pool-scoped twin of the fault plan's
        ``device_halt`` action."""
        self._halt_at = max(0, int(after_dispatches))
        self._halt_fired = False

    def note_dispatch(self, check: bool = True) -> None:
        """Count one device dispatch; fires the scheduled virtual halt
        exactly once.  The fleet calls it on every lane solo dispatch and
        once a formed batch (``check=False`` there: scheduled halts fire
        at SOLO dispatch boundaries, where the lane's healer classifies
        them)."""
        self.dispatches += 1
        if (check and self._halt_at is not None and not self._halt_fired
                and self.state == STATE_OK
                and self.dispatches > self._halt_at):
            self._halt_fired = True
            from srtb_tpu_torch.resilience.errors import DeviceHalt
            raise DeviceHalt(
                f"virtual pool device {self.label} halted "
                f"(scheduled at dispatch {self._halt_at})")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PoolDevice({self.label}, {self.device}, "
                f"state={self.state}, dispatches={self.dispatches})")


class DevicePool:
    """The fleet's device membership: real cards on the card's host, a
    deterministic virtual pool on the CPU.  ``devices`` are the torch
    devices of the members (one repeated for a virtual pool)."""

    def __init__(self, count: int = 1, devices=None):
        count = max(1, int(count))
        devs = list(devices or [])
        self.devices = [
            PoolDevice(i, device=devs[i] if i < len(devs)
                       else (devs[-1] if devs else None))
            for i in range(count)]
        metrics.set("fleet_pool_size", len(self.devices))

    @classmethod
    def from_config(cls, cfg, device: torch.device) -> "DevicePool":
        """The pool of ``Config.fleet_devices`` on ``device``'s kind.
        0/1 = a one-member pool.  >= 2 on the card binds real cards
        (``cuda:0`` …), capped at ``torch.cuda.device_count()`` with a
        warning; on the CPU the pool is virtual (N logical members, one
        physical device, distinct plan caches)."""
        want = int(getattr(cfg, "fleet_devices", 0) or 0)
        if want <= 1:
            return cls(1, devices=[device])
        if device.type == "cuda":
            have = torch.cuda.device_count()
            if want > have:
                log.warning(
                    f"[pool] fleet_devices={want} exceeds the "
                    f"{have} visible devices; capping")
                want = have
            return cls(want, devices=[torch.device("cuda", i)
                                      for i in range(want)])
        log.info(f"[pool] virtual {want}-device pool (CPU): distinct "
                 "plan caches / halt domains on one physical device")
        return cls(want, devices=[device])

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def healthy(self) -> list[PoolDevice]:
        """Members accepting placements (not draining, not halted)."""
        return [d for d in self.devices if d.state == STATE_OK]

    @property
    def total_dispatches(self) -> int:
        return sum(d.dispatches for d in self.devices)

    @property
    def compiles(self) -> int:
        """Pool-wide plan-family compiles (sum of member caches)."""
        return sum(d.plans.compiles for d in self.devices)

    @property
    def hits(self) -> int:
        return sum(d.plans.hits for d in self.devices)

    def schedule_halt(self, index: int, after_dispatches: int) -> None:
        self.devices[index].schedule_halt(after_dispatches)

    def invalidate_all(self) -> None:
        """Fleet-wide reinit (the no-peer last resort): every member's
        cache force-retired and every member re-armed."""
        for d in self.devices:
            d.plans.invalidate()
            if d.state != STATE_OK:
                d.set_state(STATE_OK)
