"""Chaos soak: seeded device-fault runs with an accounted-loss-only gate
(port of ``srtb_tpu/tools/chaos_soak.py``).

It generates a fault plan from a seed (site x action x segment, the
device faults ``oom``, ``compile_fail`` and ``device_halt`` among them)
and runs the whole pipeline three times:

1. clean, with the ladder off: the reference output;
2. clean, with the ladder armed: must be bit-identical to (1);
3. chaos: the plan injected, healing armed.

The gate: every planned fault fired; loss is accounted only (every
segment drained or counted in ``segments_dropped``); each drained
segment's decisions (signal counts, zapped-channel counts, positives)
equal the clean run's exactly and its time series within 1e-3 of the
clean run's largest value (the demoted plans' tolerance); and the
counters balance against the plan: ``plan_demotions`` = the injected
oom and compile faults, ``device_reinits`` = the injected halts,
``faults_injected`` = the plan's entries, ``retries_total`` >= the
injected raise and corrupt faults.

``--selftest`` proves the gate sharp: an injected fatal fault, and an
out-of-memory with healing off, must fail the soak; one out-of-memory
with healing armed must pass.

Pool-scoped halts: a plan entry ``device:halt@K`` is not a fault-injector
spec: it schedules the device pool's deterministic virtual halt
(``pipeline/pool.py``) on one member after K of ITS dispatches.  Such
entries are taken out of the pipeline's plan and run as a fourth phase:
one stream through a ``StreamFleet`` on a ``len(entries) + 1``-member pool,
entry i armed on member i, so every halt has a survivor to drain onto.
The gate: no loss, decisions and time series equal the clean run's bit
for bit (migration stays at rung 0), ``device_drains`` the scheduled
halts, every halt a live migration, no fleet-wide reinit, no demotion.
A pool of several members needs several devices: the CPU's virtual pool
(``--device cpu``), or that many cards.

Usage::

    python -m srtb_tpu_torch.tools.chaos_soak [--seed N] [--segments N]
        [--faults N] [--plan PLAN] [--log2n N] [--promote-after N]
        [--device cpu|cuda] [--selftest]

Without ``--device`` the runs use the card.  Exit 0 on a passing soak (or
a sharp selftest), 1 on any gate failure.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile

import numpy as np

_ACTIONS = ("oom", "compile_fail", "device_halt", "raise", "corrupt",
            "stall")
_WEIGHTS = (3, 3, 2, 2, 1, 1)
_DEVICE = ("oom", "compile_fail", "device_halt")
_DEVICE_SITES = ("h2d", "dispatch", "fetch")
_HOST_SITES = ("ingest", "h2d", "dispatch", "fetch", "sink_write",
               "checkpoint")
_COUNTERS = ("plan_demotions", "plan_promotions", "device_reinits",
             "retries_total", "segments_dropped", "data_loss_total",
             "faults_injected")


class SoakFailure(AssertionError):
    """One broken soak invariant (the gate)."""


def _base_cfg(tmp: str, n: int, tag: str, **extra):
    from srtb_tpu_torch.config import Config
    return Config(
        baseband_input_count=n, baseband_input_bits=8,
        baseband_freq_low=1405.0, baseband_bandwidth=64.0,
        baseband_sample_rate=128e6, dm=0.05,
        input_file_path=os.path.join(tmp, "bb.bin"),
        baseband_output_file_prefix=os.path.join(tmp, tag + "_"),
        spectrum_channel_count=64,
        mitigate_rfi_average_method_threshold=100.0,
        mitigate_rfi_spectral_kurtosis_threshold=2.0,
        baseband_reserve_sample=True,  # overlap-save: the ring rung is live
        writer_thread_count=0,
        fft_strategy="four_step",
        inflight_segments=2,
        retry_backoff_base_s=0.001,
        **extra)


def generate_plan(seed: int, segments: int, faults: int,
                  max_demotions: int, max_halts: int) -> str:
    """A seeded fault plan: distinct (site, index) pairs, device actions
    at device sites only, the demotions and halts capped so the ladder and
    the reinit budget absorb the whole plan (the gate's exact counts need
    every fault recoverable)."""
    rng = random.Random(seed)
    entries, used = [], set()
    demotions = halts = 0
    attempts = 0
    while len(entries) < faults and attempts < 200:
        attempts += 1
        action = rng.choices(_ACTIONS, weights=_WEIGHTS)[0]
        if action in ("oom", "compile_fail") \
                and demotions >= max_demotions:
            continue
        if action == "device_halt" and halts >= max_halts:
            continue
        site = rng.choice(_DEVICE_SITES if action in _DEVICE
                          else _HOST_SITES)
        # index >= 1 keeps the first segment (the ring's cold dispatch)
        # clean; < segments so every fault fires
        index = rng.randrange(1, segments)
        if (site, index) in used:
            continue
        used.add((site, index))
        if action in ("oom", "compile_fail"):
            demotions += 1
        elif action == "device_halt":
            halts += 1
        arg = "=0.05" if action == "stall" else ""
        entries.append(f"{site}:{action}{arg}@{index}")
    return ",".join(entries)


def _split_pool_plan(plan: str) -> tuple[list[int], str]:
    """Split the pool-scoped ``device:halt@K`` entries out of a fault
    plan: (the halts' dispatch counts, the pipeline's plan)."""
    halts, rest = [], []
    for ent in plan.split(","):
        ent = ent.strip()
        if not ent:
            continue
        if ent.startswith("device:halt@"):
            halts.append(int(ent.rsplit("@", 1)[1]))
        else:
            rest.append(ent)
    return halts, ",".join(rest)


class _CaptureSink:
    def __init__(self):
        self.out = []

    def push(self, work, positive):
        from srtb_tpu_torch.io.writers import to_host
        det = work.detect
        self.out.append((to_host(det.signal_counts).copy(),
                         to_host(det.zero_count).copy(),
                         to_host(det.time_series).copy(),
                         bool(positive)))


def _run(cfg, device):
    """One run from a fresh metrics registry: its stats, captures,
    counters, unfired specs and installed plans."""
    from srtb_tpu_torch.pipeline.runtime import Pipeline
    from srtb_tpu_torch.utils.metrics import metrics
    metrics.reset()
    sink = _CaptureSink()
    with Pipeline(cfg, sinks=[sink], device=device) as pipe:
        stats = pipe.run()
        unfired = pipe.faults.unfired() if pipe.faults else []
        counters = {k: metrics.get(k) for k in _COUNTERS}
        plans = [plan for _step, plan in pipe.plan_history]
    metrics.reset()
    return stats, sink, counters, unfired, plans


def _run_pool_phase(tmp: str, n: int, pool_halts: list[int],
                    device) -> tuple:
    """The ``device:halt@K`` phase: one stream on a pool of one member a
    scheduled halt plus a survivor; entry i arms member i's halt after
    K_i of its dispatches.  Returns (result, sink, counters)."""
    from srtb_tpu_torch.pipeline.fleet import StreamFleet, StreamSpec
    from srtb_tpu_torch.utils.metrics import metrics
    metrics.reset()
    cfg = _base_cfg(tmp, n, "pool", fleet_devices=len(pool_halts) + 1)
    sink = _CaptureSink()
    fleet = StreamFleet([StreamSpec(name="chaos", cfg=cfg, sinks=[sink])],
                        device=device)
    for i, k in enumerate(pool_halts):
        fleet.pool.schedule_halt(i, after_dispatches=k)
    results = fleet.run()
    fleet.close()
    counters = {k: int(metrics.get(k)) for k in (
        "device_drains", "migrations", "device_reinits",
        "segments_dropped", "plan_demotions")}
    metrics.reset()
    return results["chaos"], sink, counters


def _make_input(tmp: str, n: int, segments: int, seed: int) -> None:
    from srtb_tpu_torch.io.synth import make_dispersed_baseband_host
    make_dispersed_baseband_host(
        n * segments, 1405.0, 64.0, 0.05,
        pulse_positions=[n // 2 + i * n for i in range(segments)],
        pulse_amp=30.0, nbits=8, seed=seed,
    ).tofile(os.path.join(tmp, "bb.bin"))


def run_soak(seed: int = 0, segments: int = 6, faults: int = 4,
             log2n: int = 14, plan: str | None = None,
             promote_after: int = 0, tmpdir: str | None = None,
             device=None) -> dict:
    """One soak (three runs and the gate).  Returns the report; raises
    :class:`SoakFailure` on a broken invariant."""
    from srtb_tpu_torch.resilience.demote import ladder_rungs
    from srtb_tpu_torch.resilience.faults import parse_plan

    tmp = tmpdir or tempfile.mkdtemp(prefix="srtb_chaos_")
    os.makedirs(tmp, exist_ok=True)
    n = 1 << log2n
    _make_input(tmp, n, segments, seed)
    rungs = ladder_rungs(_base_cfg(tmp, n, "probe"))
    if plan is None:
        plan = generate_plan(seed, segments, faults,
                             max_demotions=len(rungs), max_halts=3)
    # device:halt@K entries are pool-scoped: taken out here, run as the
    # fourth phase
    pool_halts, pipe_plan = _split_pool_plan(plan)
    specs = parse_plan(pipe_plan) if pipe_plan else []
    n_demote = sum(1 for s in specs if s.action in ("oom", "compile_fail"))
    n_halt = sum(1 for s in specs if s.action == "device_halt")
    n_transient = sum(1 for s in specs if s.action in ("raise", "corrupt"))
    if n_demote > len(rungs):
        raise SoakFailure(
            f"plan demotes {n_demote}x but only {len(rungs)} rungs "
            "exist: an unabsorbable plan cannot gate exact counters")

    off, sink_off, _, _, _ = _run(_base_cfg(
        tmp, n, "off", plan_ladder="off", device_reinit_max=0), device)
    on, sink_on, c_on, _, _ = _run(_base_cfg(tmp, n, "on"), device)
    chaos_cfg = _base_cfg(
        tmp, n, "chaos", fault_plan=pipe_plan,
        promote_after_segments=promote_after,
        device_reinit_max=max(1, n_halt),
        checkpoint_path=os.path.join(tmp, "chaos_ck.json"))
    stats, sink, counters, unfired, plans = _run(chaos_cfg, device)

    def check(cond, msg):
        if not cond:
            raise SoakFailure(msg)

    # arming the ladder on a clean run is bit-identical
    check(on.segments == off.segments,
          f"ladder-armed clean run segment count {on.segments} != "
          f"ladder-off {off.segments}")
    for i, (a, b) in enumerate(zip(sink_on.out, sink_off.out)):
        for x, y in zip(a[:3], b[:3]):
            check(np.array_equal(x, y),
                  f"ladder-armed clean run differs at segment {i}: "
                  "arming self-healing must be bit-identical")
        check(a[3] == b[3], f"clean-run positive flag differs at {i}")
    check(c_on["plan_demotions"] == 0 and c_on["device_reinits"] == 0,
          "clean run recorded demotions or reinits")

    check(unfired == [], f"planned faults never fired: {unfired}")
    drained = len(sink.out)
    dropped = int(counters["segments_dropped"])
    check(drained + dropped == off.segments,
          f"loss not accounted: {drained} drained + {dropped} dropped "
          f"!= {off.segments} source segments")
    for i, (a, b) in enumerate(zip(sink.out, sink_off.out)):
        check(np.array_equal(a[0], b[0]),
              f"segment {i}: signal_counts differ after recovery")
        check(np.array_equal(a[1], b[1]),
              f"segment {i}: zero_count differs after recovery")
        check(a[3] == b[3], f"segment {i}: positive flag differs")
        scale = float(np.abs(b[2]).max()) or 1.0
        if not np.allclose(a[2], b[2], rtol=0, atol=1e-3 * scale):
            raise SoakFailure(
                f"segment {i}: time series out of tolerance after "
                f"recovery (max delta {float(np.abs(a[2] - b[2]).max()):.3g}"
                f" vs atol {1e-3 * scale:.3g})")

    check(int(counters["plan_demotions"]) == n_demote,
          f"plan_demotions {int(counters['plan_demotions'])} != "
          f"{n_demote} injected oom/compile faults")
    check(int(counters["device_reinits"]) == n_halt,
          f"device_reinits {int(counters['device_reinits'])} != "
          f"{n_halt} injected halts")
    check(int(counters["faults_injected"]) == len(specs),
          f"faults_injected {int(counters['faults_injected'])} != "
          f"{len(specs)} planned")
    check(int(counters["retries_total"]) >= n_transient,
          f"retries_total {int(counters['retries_total'])} < "
          f"{n_transient} injected transient faults")

    # phase 4: every scheduled pool halt drains its member onto a
    # survivor by live migration, without loss and bit for bit
    pool_counters: dict = {}
    if pool_halts:
        pres, psink, pool_counters = _run_pool_phase(tmp, n, pool_halts,
                                                     device)
        check(pres.status == "done", f"pool phase did not finish: "
              f"{pres.status} ({pres.error!r})")
        check(len(psink.out) + pool_counters["segments_dropped"]
              == off.segments,
              f"pool phase loss not accounted: {len(psink.out)} drained + "
              f"{pool_counters['segments_dropped']} dropped != "
              f"{off.segments} source segments")
        check(pool_counters["segments_dropped"] == 0,
              f"pool phase dropped {pool_counters['segments_dropped']} "
              "segment(s): a scoped halt migrates, it must not shed")
        for i, (a, b) in enumerate(zip(psink.out, sink_off.out)):
            check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                  and np.array_equal(a[2], b[2]) and a[3] == b[3],
                  f"pool phase segment {i}: output differs from the clean "
                  "reference: migration must be bit-identical")
        check(pool_counters["device_drains"] == len(pool_halts),
              f"device_drains {pool_counters['device_drains']} != "
              f"{len(pool_halts)} scheduled pool halts")
        check(pool_counters["migrations"] >= len(pool_halts),
              f"migrations {pool_counters['migrations']} < "
              f"{len(pool_halts)} scheduled halts: a halt failed to drain "
              "its lane onto the survivor")
        check(pool_counters["device_reinits"] == 0,
              "a pool-scoped halt escalated to a fleet-wide reinit despite "
              "a healthy survivor")
        check(pool_counters["plan_demotions"] == 0,
              "the pool phase demoted a plan: migration must rejoin the "
              "survivor's family at rung 0")
    return {
        "seed": seed, "segments": int(off.segments), "plan": plan,
        "pool_halts": pool_halts, "pool_counters": pool_counters,
        "rungs": [r.step for r in rungs], "plans": plans,
        "drained": drained, "dropped": dropped,
        "plan_demotions": int(counters["plan_demotions"]),
        "plan_promotions": int(counters["plan_promotions"]),
        "device_reinits": int(counters["device_reinits"]),
        "retries": int(counters["retries_total"]),
        "ok": True,
    }


def selftest(log2n: int = 12, device=None) -> list[str]:
    """Prove the gate catches what it exists to catch; returns failure
    strings (empty: the gate is sharp)."""
    failures = []
    # (a) an injected fatal fault: nothing recovers it
    try:
        run_soak(seed=1, segments=3, log2n=log2n, plan="dispatch:fatal@1",
                 device=device)
        failures.append("gate passed a run with an injected FATAL fault")
    except Exception:  # noqa: BLE001 - caught, as required
        pass
    # (b) one out-of-memory with healing armed recovers
    try:
        run_soak(seed=2, segments=3, log2n=log2n, plan="dispatch:oom@1",
                 device=device)
    except Exception as e:  # noqa: BLE001 - reported
        failures.append(f"single-oom probe did not recover with healing "
                        f"armed: {e!r}")
    # (c) a device fault with healing off escalates
    tmp = tempfile.mkdtemp(prefix="srtb_chaos_self_")
    n = 1 << log2n
    _make_input(tmp, n, 3, seed=3)
    try:
        _run(_base_cfg(tmp, n, "nh", plan_ladder="off",
                       device_reinit_max=0, fault_plan="dispatch:oom@1"),
             device)
        failures.append("an injected oom with healing off did not end the "
                        "run: device faults are swallowed somewhere")
    except Exception:  # noqa: BLE001 - escalated, as required
        pass
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="srtb-torch-chaos-soak",
        description="seeded device-fault soak (see "
                    "srtb_tpu_torch/tools/chaos_soak.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--segments", type=int, default=6)
    ap.add_argument("--faults", type=int, default=4,
                    help="fault count of the generated plan")
    ap.add_argument("--plan", default=None,
                    help="explicit fault plan (overrides the generator)")
    ap.add_argument("--log2n", type=int, default=14)
    ap.add_argument("--promote-after", type=int, default=0,
                    help="promotion probe after N healthy segments")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--selftest", action="store_true",
                    help="prove the gate catches unhandled fault classes")
    args = ap.parse_args(argv)

    if args.selftest:
        fails = selftest(device=args.device)
        for f in fails:
            print(f"chaos-soak selftest: {f}", file=sys.stderr)
        print("chaos-soak selftest: "
              + ("FAILED" if fails else
                 "OK — unhandled fault classes fail the gate"))
        return 1 if fails else 0
    try:
        report = run_soak(seed=args.seed, segments=args.segments,
                          faults=args.faults, log2n=args.log2n,
                          plan=args.plan, promote_after=args.promote_after,
                          device=args.device)
    except SoakFailure as e:
        print(json.dumps({"ok": False, "failure": str(e)}))
        print(f"chaos-soak: GATE FAILED — {e}", file=sys.stderr)
        return 1
    print(json.dumps(report, sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
