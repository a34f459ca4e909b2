"""The port's device pool and placement (``pipeline/pool.py``,
``pipeline/placement.py``, ROADMAP A8b) beside the reference's
``tests/test_pool.py``: the pool built from ``fleet_devices`` (a virtual
pool on the CPU, real cards capped at the card count with the reference's
warning), the members' own plan caches and halt domains, the deterministic
virtual halt, and the placement policy's choices.  The reference's own
results for the same scripts are held in ``tests/test_torch_fleet.py``
(``fleet_units``)."""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.pipeline import placement as PL
from srtb_tpu_torch.pipeline.pool import (STATE_DRAINING, STATE_HALTED,
                                          STATE_OK, DevicePool)
from srtb_tpu_torch.resilience.errors import DeviceHalt
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_metrics():
    metrics.reset()
    yield
    metrics.reset()


def _cfg(**kw) -> Config:
    base = dict(baseband_input_count=1 << 12, baseband_input_bits=8,
                baseband_freq_low=1405.0, baseband_bandwidth=64.0,
                baseband_sample_rate=128e6, dm=0.05,
                spectrum_channel_count=16, fft_strategy="four_step",
                baseband_reserve_sample=True)
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("want,members", ((0, 1), (1, 1), (2, 2), (3, 3)))
def test_pool_from_config_on_the_cpu(want, members):
    """``fleet_devices`` <= 1 is one member; more is a virtual pool on
    the CPU, every member on the one CPU device with its own cache."""
    pool = DevicePool.from_config(_cfg(fleet_devices=want), CPU)
    assert len(pool) == members
    assert [d.label for d in pool] == [f"dev{i}" for i in range(members)]
    assert all(d.device == CPU for d in pool)
    assert len({id(d.plans) for d in pool}) == members
    assert metrics.get("fleet_pool_size") == members


def test_pool_on_the_card_is_capped_at_the_card_count(monkeypatch):
    """On the card ``fleet_devices`` binds real cards, capped at
    ``torch.cuda.device_count()`` with the reference's warning: one
    member on a one-card host (nothing is built, so no card is needed)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    buf = io.StringIO()
    monkeypatch.setattr(log, "stream", buf)
    pool = DevicePool.from_config(_cfg(fleet_devices=2),
                                  torch.device("cuda"))
    assert len(pool) == 1 and pool.devices[0].device == torch.device(
        "cuda", 0)
    assert "fleet_devices=2 exceeds the 1 visible devices; capping" \
        in buf.getvalue()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    pool = DevicePool.from_config(_cfg(fleet_devices=2),
                                  torch.device("cuda"))
    assert [d.device.index for d in pool] == [0, 1]


def test_member_caches_compile_apart_and_invalidate_alone():
    """A member's cache builds its own processor on its own device; the
    pool sums compiles and hits; invalidating one member force-retires
    its processors only; ``invalidate_all`` re-arms every member."""
    pool = DevicePool(2, devices=[CPU])
    a = pool.devices[0].plans.get(_cfg(stream_name="a"))
    b = pool.devices[0].plans.get(_cfg(stream_name="b"))
    c = pool.devices[1].plans.get(_cfg(stream_name="c"))
    assert a is b and a is not c
    assert (pool.compiles, pool.hits) == (2, 1)
    assert metrics.get("fleet_plan_compiles", labels={"device": "dev1"}) \
        == 1
    pool.devices[1].plans.invalidate()
    assert c._retired and not a._retired
    pool.devices[1].set_state(STATE_HALTED)
    pool.devices[0].set_state(STATE_DRAINING)
    assert pool.healthy() == []
    pool.invalidate_all()
    assert a._retired
    assert [d.state for d in pool] == [STATE_OK, STATE_OK]
    with pytest.raises(RuntimeError, match="retired"):
        a.stage_input(np.zeros(a._segment_bytes, np.uint8))


def test_scheduled_halt_fires_once_at_a_solo_boundary():
    pool = DevicePool(2)
    pool.schedule_halt(1, after_dispatches=1)
    dev = pool.devices[1]
    dev.note_dispatch()
    dev.note_dispatch(check=False)   # a formed batch: never fires
    with pytest.raises(DeviceHalt, match="virtual pool device dev1"):
        dev.note_dispatch()
    dev.note_dispatch()              # once only
    assert pool.total_dispatches == 4
    # a draining member's scheduled halt does not fire
    pool.schedule_halt(0, after_dispatches=0)
    pool.devices[0].set_state(STATE_DRAINING)
    pool.devices[0].note_dispatch()
    with pytest.raises(ValueError, match="unknown device state"):
        pool.devices[0].set_state("gone")


class _Spec:
    def __init__(self, name, pin=None):
        self.name = name
        self.pin_device = pin


@pytest.mark.parametrize("name,loads,tenants,want", (
    ("x", {0: 1, 1: 0, 2: 0}, None, 1),        # least loaded, then index
    ("x", {}, None, 0),
    ("r.b1", {0: 0, 1: 0, 2: 0}, {0: {"r"}}, 1),  # soft anti-affinity
    ("r.b2", {0: 0, 1: 0, 2: 0}, {0: {"r"}, 1: {"r"}, 2: {"r"}}, 0),
    ("r.b3", {0: 1, 1: 0, 2: 0}, {1: {"r"}}, 2),
))
def test_initial_placement(name, loads, tenants, want):
    devs = DevicePool(3).devices
    assert PL.choose_initial(_Spec(name), devs, loads, tenants).index == want


def test_pins_and_targets():
    devs = DevicePool(3).devices
    assert PL.choose_initial(_Spec("p", pin=2), devs, {2: 5}).index == 2
    with pytest.raises(ValueError, match="pin_device=7"):
        PL.choose_initial(_Spec("p", pin=7), devs, {})
    with pytest.raises(ValueError, match="not a healthy pool member"):
        PL.choose_initial(_Spec("p", pin=1), [devs[0], devs[2]], {})
    assert PL.choose_target("s", 0, devs, {1: 2, 2: 1}).index == 2
    assert PL.choose_target("s", 0, devs[:1], {}) is None
    assert PL.tenant_of("radioA.band0") == "radioA"
    assert PL.tenant_of("flat") == "flat"
