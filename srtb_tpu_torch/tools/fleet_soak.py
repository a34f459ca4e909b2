"""Fleet chaos soak: the cross-stream blast-radius gate (port of
``srtb_tpu/tools/fleet_soak.py``).

N seeded streams (their own baseband, one shared plan family) run (1) each
SOLO through the single-stream ``Pipeline``, the golden, and (2) together
through a ``StreamFleet`` with a fault plan scoped to ONE victim stream
(``stream0:dispatch:oom@1`` ...).  The gate:

- **(a) healthy isolation**: every healthy stream's output set (relative
  names and SHA-256) equals its solo golden run's;
- **(b) victim accounting**: the victim's loss is accounted only (drained
  + dropped == its solo segments), its detection DECISIONS are its solo
  run's, and its demotions are in its own journal (healthy journals
  carry zero);
- **(c) shared plan economy**: ONE compile for the shared family
  (``hits == N - 1``).

``--batch B`` arms cross-stream batching (``fleet_batch_max=B``): the
healthy gate is then the reference's vmap contract (``.bin`` bitwise,
``.npy`` / ``.tim`` within rtol 1e-5 and atol 1e-4·max(|golden|, 1),
decisions exact; the port's batch is a solo dispatch a member, so its
bits are equal) plus the batching economy: records carry ``batch_size``,
and the journal-implied device dispatches are at most half the drained
segments.  ``--selftest`` proves the gate sharp (an UNSCOPED fault must
fail the attribution check, a scoped one pass).  ``--ab`` is the
single-stream A/B (the fleet with N = 1 against ``Pipeline``).
``--migrate`` is the device-pool soak on a 2-member pool: a scoped
mid-run kill (``--kill-device``, ``--kill-at``) or a rolling restart
(``--rolling``), every stream's output equal to its solo golden, no loss,
exactly one extra cold ring dispatch a migration, one compile a member,
v11 journals device-stamped.  A pool of two needs two devices: the CPU's
virtual pool (``--device cpu``), or two cards.

Usage::

    python -m srtb_tpu_torch.tools.fleet_soak [--streams N] [--segments N]
        [--log2n N] [--plan PLAN] [--batch B] [--selftest]
        [--ab [--reps R]] [--migrate [--kill-device I] [--kill-at K]
        [--rolling]] [--device cpu|cuda]

Without ``--device`` the runs use the card.  Exit 0 on a passing gate (or
a sharp selftest), 1 on any failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


class SoakFailure(AssertionError):
    """One broken fleet invariant (the gate)."""


def _stream_names(n: int) -> list[str]:
    # stream0 is always the victim (matching the default --plan)
    return [f"stream{i}" for i in range(n)]


def _cfg(tmp: str, name: str, run_dir: str, n: int, **extra):
    from srtb_tpu_torch.config import Config
    base = dict(
        baseband_input_count=n, baseband_input_bits=8,
        baseband_freq_low=1405.0, baseband_bandwidth=64.0,
        baseband_sample_rate=128e6, dm=0.05,
        input_file_path=os.path.join(tmp, f"bb_{name}.bin"),
        baseband_output_file_prefix=os.path.join(run_dir, "out_"),
        spectrum_channel_count=64,
        # every segment writes artifacts, so the equality gate is real
        mitigate_rfi_average_method_threshold=1000.0,
        mitigate_rfi_spectral_kurtosis_threshold=50.0,
        signal_detect_signal_noise_threshold=1.5,
        signal_detect_max_boxcar_length=8,
        baseband_reserve_sample=True,
        writer_thread_count=0,
        fft_strategy="four_step",
        inflight_segments=2,
        retry_backoff_base_s=0.001,
        # artifact names from the stream offset: solo and fleet agree
        deterministic_timestamps=True,
        checkpoint_path=os.path.join(run_dir, "ck.json"),
        run_manifest_path=os.path.join(run_dir, "manifest.jsonl"),
    )
    base.update(extra)
    return Config(**base)


def _synthesize(tmp: str, names: list[str], n: int, segments: int,
                seed: int, device=None) -> None:
    """Each stream's file: unit noise and a dispersed pulse in every
    segment, 8-bit, from seed ``seed * 1000 + i``.  On the CPU the
    reference's float64 numpy generator (its bytes); on a card the same
    recipe in float32 with torch's generator there, which makes a 2^27
    soak's inputs in well under a second."""
    import torch
    from srtb_tpu_torch.io.synth import (make_dispersed_baseband,
                                         make_dispersed_baseband_host)
    from srtb_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    for i, name in enumerate(names):
        path = os.path.join(tmp, f"bb_{name}.bin")
        at = [n // 2 + j * n for j in range(segments)]
        if dev.type == "cuda":
            gen = torch.Generator(device=dev).manual_seed(seed * 1000 + i)
            make_dispersed_baseband(
                n * segments, 1405.0, 64.0, 0.05, at, nbits=8,
                pulse_amp=30.0, device=dev, generator=gen,
            ).cpu().numpy().tofile(path)
        else:
            make_dispersed_baseband_host(
                n * segments, 1405.0, 64.0, 0.05, pulse_positions=at,
                pulse_amp=30.0, nbits=8, seed=seed * 1000 + i,
            ).tofile(path)


class _DecisionTap:
    """Pass-through sink recording detection decisions (beside the real
    writer, so artifacts still land on disk)."""

    wants_waterfall = False

    def __init__(self):
        self.out = []

    def push(self, work, positive):
        from srtb_tpu_torch.io.writers import to_host
        det = work.detect
        self.out.append((to_host(det.signal_counts).copy(),
                         to_host(det.zero_count).copy(), bool(positive)))


# the reference's documented vmap tolerance (its archive micro-batch
# precedent): decisions and .bin bytes exact, float artifacts close with
# an amplitude-relative absolute term
VMAP_RTOL = 1e-5
VMAP_ATOL_FRAC = 1e-4


def _load_float(path: str):
    """A float artifact for the vmap-tolerance comparison (None for the
    kinds that have no float representation)."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".tim"):
        return np.fromfile(path, dtype=np.float32)
    return None


def artifacts_close(solo_dir: str, fleet_dir: str, solo_map: dict,
                    fleet_map: dict) -> str | None:
    """The batched comparison: equal name sets, ``.bin`` bitwise, float
    artifacts within the vmap tolerance.  A failure's description, or
    None when the gate holds."""
    if set(fleet_map) != set(solo_map):
        return (f"output name sets differ (fleet {sorted(fleet_map)} vs "
                f"solo {sorted(solo_map)})")
    for rel in sorted(solo_map):
        if fleet_map[rel] == solo_map[rel]:
            continue
        if rel.endswith(".bin"):
            return (f"{rel}: baseband .bin bytes differ (batching must not "
                    "touch raw capture)")
        a = _load_float(os.path.join(fleet_dir, rel))
        b = _load_float(os.path.join(solo_dir, rel))
        if a is None or b is None:
            return f"{rel}: differs and is not a float artifact"
        atol = VMAP_ATOL_FRAC * max(float(np.abs(b).max()), 1.0)
        if a.shape != b.shape or not np.allclose(a, b, rtol=VMAP_RTOL,
                                                 atol=atol):
            return (f"{rel}: float artifact outside the vmap tolerance "
                    f"(rtol={VMAP_RTOL}, atol={atol:g})")
    return None


def _solo_run(cfg, device) -> tuple:
    """One golden single-stream run: (stats, decisions)."""
    from srtb_tpu_torch.io.writers import WriteSignalSink
    from srtb_tpu_torch.pipeline.runtime import Pipeline
    from srtb_tpu_torch.utils.metrics import metrics
    metrics.reset()
    tap = _DecisionTap()
    with Pipeline(cfg, sinks=[WriteSignalSink(cfg), tap],
                  device=device) as pipe:
        stats = pipe.run()
    return stats, tap.out


def _goldens(tmp: str, names: list, n: int, device, **extra) -> tuple:
    """Every stream's solo golden: output sets, decisions, segments."""
    from srtb_tpu_torch.tools.crash_soak import snapshot_outputs
    out, dec, segs = {}, {}, {}
    for name in names:
        run_dir = os.path.join(tmp, f"solo_{name}")
        os.makedirs(run_dir, exist_ok=True)
        stats, dec[name] = _solo_run(_cfg(tmp, name, run_dir, n, **extra),
                                     device)
        out[name] = snapshot_outputs(run_dir)
        # overlap-save re-reads the reserved tails, so a stream yields
        # more segments than were synthesized: the solo run says how many
        segs[name] = int(stats.segments)
        if not out[name]:
            raise SoakFailure(f"solo run of {name} wrote NO artifacts: the "
                              "equality gate would be vacuous")
    return out, dec, segs


def _fleet_specs(tmp: str, names: list, n: int, **extra) -> tuple:
    from srtb_tpu_torch.io.writers import WriteSignalSink
    from srtb_tpu_torch.pipeline.fleet import StreamSpec
    specs, taps, jpaths = [], {}, {}
    for name in names:
        run_dir = os.path.join(tmp, f"fleet_{name}")
        os.makedirs(run_dir, exist_ok=True)
        jpaths[name] = os.path.join(tmp, f"journal_{name}.jsonl")
        cfg = _cfg(tmp, name, run_dir, n,
                   telemetry_journal_path=jpaths[name], **extra)
        taps[name] = _DecisionTap()
        specs.append(StreamSpec(name=name, cfg=cfg,
                                sinks=[WriteSignalSink(cfg), taps[name]]))
    return specs, taps, jpaths


def _journal(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f
                if line.strip().startswith("{")]


def _check(cond, msg):
    if not cond:
        raise SoakFailure(msg)


def _same_decisions(a, b) -> bool:
    return (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            and a[2] == b[2])


def run_soak(streams: int = 3, segments: int = 5, log2n: int = 13,
             plan: str | None = None, seed: int = 0,
             tmpdir: str | None = None, batch: int = 0,
             extra_cfg: dict | None = None, device=None) -> dict:
    """One soak (solo goldens, the fleet run, the gate).  Returns the
    report; raises :class:`SoakFailure` on a broken invariant.
    ``extra_cfg`` lands on the FLEET lanes only."""
    from srtb_tpu_torch.pipeline.fleet import StreamFleet
    from srtb_tpu_torch.resilience.faults import parse_plan
    from srtb_tpu_torch.tools.crash_soak import snapshot_outputs
    from srtb_tpu_torch.utils.metrics import metrics

    tmp = tmpdir or tempfile.mkdtemp(prefix="srtb_fleet_")
    os.makedirs(tmp, exist_ok=True)
    n = 1 << log2n
    batch = max(0, int(batch))
    names = _stream_names(streams)
    victim = names[0]
    if plan is None:
        plan = (f"{victim}:dispatch:oom@1,{victim}:sink_write:raise@2,"
                f"{victim}:fetch:stall=0.05@3")
    specs_parsed = parse_plan(plan)
    victims = {s.stream for s in specs_parsed if s.stream is not None}
    n_demote = sum(1 for s in specs_parsed
                   if s.action in ("oom", "compile_fail"))
    _synthesize(tmp, names, n, segments, seed, device)
    solo_out, solo_dec, solo_segs = _goldens(tmp, names, n, device)

    metrics.reset()
    specs, taps, jpaths = _fleet_specs(tmp, names, n, fault_plan=plan,
                                       fleet_batch_max=batch,
                                       **(extra_cfg or {}))
    fleet = StreamFleet(specs, device=device)
    results = fleet.run()
    fleet.close()
    compiles, hits = fleet.plans.compiles, fleet.plans.hits
    dropped_by = metrics.by_label("segments_dropped")

    for name in names:
        _check(results[name].status == "done",
               f"stream {name} did not finish: {results[name].status} "
               f"({results[name].error!r})")

    # (a) healthy streams: equal to solo (bitwise unbatched, the vmap
    # contract batched)
    for name in names:
        if name in victims:
            continue
        fleet_dir = os.path.join(tmp, f"fleet_{name}")
        fleet_set = snapshot_outputs(fleet_dir)
        if batch >= 2:
            why = artifacts_close(os.path.join(tmp, f"solo_{name}"),
                                  fleet_dir, solo_out[name], fleet_set)
            _check(why is None, f"healthy stream {name} (batched): {why}")
        else:
            _check(fleet_set == solo_out[name],
                   f"healthy stream {name}: fleet output set differs from "
                   f"its solo golden run (fleet {sorted(fleet_set)} vs "
                   f"solo {sorted(solo_out[name])})")
        for i, (a, b) in enumerate(zip(taps[name].out, solo_dec[name])):
            _check(_same_decisions(a, b),
                   f"healthy stream {name}: decision differs at segment {i}")

    # (b) victim: accounted-only loss, decisions exact, attribution
    for name in victims:
        vdropped = int(dropped_by.get(name, 0))
        _check(results[name].drained + vdropped == solo_segs[name],
               f"victim {name}: loss not accounted: "
               f"{results[name].drained} drained + {vdropped} dropped != "
               f"{solo_segs[name]} source segments")
        for i, (a, b) in enumerate(zip(taps[name].out, solo_dec[name])):
            _check(_same_decisions(a, b),
                   f"victim {name}: detection decision differs at segment "
                   f"{i} (recovery changed the science)")
    recs_by: dict[str, list] = {}
    for name in names:
        recs = recs_by[name] = _journal(jpaths[name])
        _check(recs and all(r.get("stream") == name and r["v"] == 11
                            for r in recs),
               f"stream {name}: journal records not stream-stamped")
        total_demote = int(recs[-1].get("plan_demotions", 0))
        if name in victims:
            _check(total_demote == n_demote,
                   f"victim {name}: journal plan_demotions {total_demote} "
                   f"!= {n_demote} injected")
        else:
            _check(total_demote == 0,
                   f"healthy stream {name}: journal attributes "
                   f"{total_demote} demotions: the victim's fault leaked "
                   "into a neighbor's books")

    # (d) batching economy: each record is 1/batch_size of a dispatch
    batched_dispatches = int(metrics.get("batched_dispatches"))
    batched_segments = int(metrics.get("batched_segments"))
    dispatch_est = 0.0
    total_recs = 0
    for name in names:
        for r in recs_by[name]:
            total_recs += 1
            b = int(r.get("batch_size", 1) or 1)
            _check(b >= 1, f"stream {name}: journal batch_size {b}")
            dispatch_est += 1.0 / b
    dispatch_est = round(dispatch_est)
    if batch >= 2:
        _check(batched_dispatches >= 1, "batched soak recorded no "
               "batched_dispatches: the batch former never fired")
        _check(batched_segments >= 2 * batched_dispatches,
               f"batched_segments {batched_segments} < 2x "
               f"batched_dispatches {batched_dispatches}")
        _check(dispatch_est * 2 <= total_recs,
               f"journal-implied device dispatches {dispatch_est} > half "
               f"of {total_recs} drained segments: batching amortized too "
               "little")
    else:
        _check(batched_dispatches == 0 and all(
            "batch_size" not in r for name in names
            for r in recs_by[name]),
            "unbatched soak journaled batch_size fields")

    # (c) shared plan cache: one compile a family
    _check(compiles == 1, f"plan cache recorded {compiles} compiles for "
           "one shared plan family (expected exactly 1)")
    _check(hits == streams - 1,
           f"plan cache hits {hits} != {streams - 1} (every non-first "
           "stream must reuse the shared plan)")
    return {
        "streams": streams, "segments": segments, "plan": plan,
        "victims": sorted(victims),
        "drained": {k: results[k].drained for k in names},
        "dropped": {k: int(dropped_by.get(k, 0)) for k in names},
        "plan_compiles": compiles, "plan_cache_hits": hits,
        "fleet_batch_max": batch,
        "batched_dispatches": batched_dispatches,
        "batched_segments": batched_segments,
        "device_dispatches_est": dispatch_est,
        "journaled_segments": total_recs,
        "device": str(fleet.device),
        "ok": True,
    }


def selftest(log2n: int = 12, device=None) -> list[str]:
    """Prove the gate sharp: (a) an UNSCOPED oom arms in every lane, so
    healthy lanes demote too and the attribution check must fail; (b) the
    scoped plan must pass."""
    failures = []
    try:
        run_soak(streams=2, segments=3, log2n=log2n,
                 plan="dispatch:oom@1", device=device)
        failures.append("gate passed an UNSCOPED fault plan: cross-stream "
                        "fault leakage went unnoticed")
    except SoakFailure:
        pass  # caught, as required
    try:
        run_soak(streams=2, segments=3, log2n=log2n,
                 plan="stream0:dispatch:oom@1", device=device)
    except Exception as e:  # noqa: BLE001 - reported, not raised
        failures.append(f"scoped single-oom soak did not pass: {e!r}")
    return failures


def run_migrate(streams: int = 3, segments: int = 6, log2n: int = 13,
                seed: int = 0, kill_device: int = 1, kill_at: int = 2,
                rolling: bool = False, tmpdir: str | None = None,
                extra_cfg: dict | None = None, device=None) -> dict:
    """The device-pool soak: solo goldens, then the same streams on a
    2-member pool with a scoped mid-run kill (the pool's deterministic
    ``schedule_halt``) or a rolling restart.  The lanes run at
    ``inflight_segments=1`` so the cold-dispatch arithmetic is exact."""
    import threading
    import time as _time

    from srtb_tpu_torch.pipeline.fleet import StreamFleet
    from srtb_tpu_torch.tools.crash_soak import snapshot_outputs
    from srtb_tpu_torch.utils import termination
    from srtb_tpu_torch.utils.metrics import metrics

    tmp = tmpdir or tempfile.mkdtemp(prefix="srtb_migrate_")
    os.makedirs(tmp, exist_ok=True)
    n = 1 << log2n
    names = _stream_names(streams)
    _synthesize(tmp, names, n, segments, seed, device)
    solo_out, solo_dec, solo_segs = _goldens(tmp, names, n, device,
                                             inflight_segments=1)

    metrics.reset()
    specs, taps, jpaths = _fleet_specs(tmp, names, n, fleet_devices=2,
                                       inflight_segments=1,
                                       **(extra_cfg or {}))
    fleet = StreamFleet(specs, device=device)
    pool_size = len(fleet.pool)
    if pool_size != 2:
        raise SoakFailure(
            f"fleet built a {pool_size}-member pool (fleet_devices=2 "
            "requested): the migration soak needs a 2-device pool")
    trigger = None
    fired = threading.Event()
    if rolling:
        # the operator's path: a side thread waits for a few dispatches,
        # then queues the restart; the scheduler thread drains
        def _roll_trigger():
            while not fired.is_set():
                if fleet.pool.total_dispatches >= max(1, kill_at):
                    fleet.rolling_restart()
                    fired.set()
                    return
                _time.sleep(0.001)
        trigger = threading.Thread(target=_roll_trigger,
                                   name="migrate-soak-roll", daemon=True)
        termination.tag_thread(trigger)
        trigger.start()
    else:
        fleet.pool.schedule_halt(kill_device,
                                 after_dispatches=max(1, kill_at))
    results = fleet.run()
    pool_compiles = fleet.pool.compiles
    if trigger is not None:
        fired.set()
        trigger.join(timeout=10)
    fleet.close()
    dropped_by = metrics.by_label("segments_dropped")
    migs = int(metrics.get("migrations"))
    drains = int(metrics.get("device_drains"))
    ring_cold = int(metrics.get("ring_cold_dispatches"))

    for name in names:
        _check(results[name].status == "done",
               f"stream {name} did not finish: {results[name].status} "
               f"({results[name].error!r})")
    # (a) lossless resume
    for name in names:
        vdropped = int(dropped_by.get(name, 0))
        _check(vdropped == 0, f"stream {name}: {vdropped} segment(s) "
               "dropped: migration must be lossless")
        _check(results[name].drained == solo_segs[name],
               f"stream {name}: drained {results[name].drained} != "
               f"{solo_segs[name]} solo source segments")
    # (b) equality for EVERY stream, victims included
    for name in names:
        fleet_set = snapshot_outputs(os.path.join(tmp, f"fleet_{name}"))
        _check(fleet_set == solo_out[name],
               f"stream {name}: fleet output set differs from its solo "
               f"golden (fleet {sorted(fleet_set)} vs solo "
               f"{sorted(solo_out[name])})")
        _check(len(taps[name].out) == len(solo_dec[name]),
               f"stream {name}: {len(taps[name].out)} decisions vs "
               f"{len(solo_dec[name])} solo")
        for i, (a, b) in enumerate(zip(taps[name].out, solo_dec[name])):
            _check(_same_decisions(a, b),
                   f"stream {name}: decision differs at segment {i} "
                   "(migration changed the science)")
    # (c) migration accounting
    per_lane_migs = {name: int(results[name].extras.get("migrations", 0))
                     for name in names}
    _check(migs >= 1, "no migration happened: the kill/rolling trigger "
           "never fired")
    _check(migs == sum(per_lane_migs.values()),
           f"migrations counter {migs} != per-lane sum "
           f"{sum(per_lane_migs.values())}")
    _check(ring_cold == streams + migs,
           f"ring_cold_dispatches {ring_cold} != {streams} lane starts + "
           f"{migs} migrations: a migration must cost EXACTLY one cold "
           "re-arm")
    killed = None if rolling else fleet.pool.devices[kill_device].label
    if rolling:
        _check(fired.is_set(), "rolling trigger thread never fired")
        _check(drains == pool_size,
               f"device_drains {drains} != {pool_size} pool members "
               "(a rolling restart drains each member once)")
    else:
        _check(drains == 1, f"device_drains {drains} != 1 (one scoped "
               "kill)")
        victims = [x for x in names if per_lane_migs[x] > 0]
        _check(victims, f"scoped kill produced no victim lanes: nothing "
               f"was placed on {killed}?")
        for name in victims:
            _check(results[name].extras.get("device") != killed,
                   f"victim {name} finished on {killed}: it never resumed "
                   "on the survivor")
        _check(pool_compiles == pool_size,
               f"pool recorded {pool_compiles} compiles for {pool_size} "
               "members: a scoped halt must not recompile the survivor's "
               "plans")
    _check(int(metrics.get("device_reinits")) == 0,
           "a scoped device halt escalated to a fleet-wide reinit")
    _check(int(metrics.get("plan_demotions")) == 0,
           "migration demoted a lane's plan: resume must rejoin the "
           "target's shared family at rung 0")
    # (d) journal: v11, every record device-stamped, victims ending on a
    # survivor
    for name in names:
        recs = _journal(jpaths[name])
        _check(recs and all(r["v"] == 11 and r.get("device") for r in recs),
               f"stream {name}: journal records missing v11 device stamps")
        _check(len(recs) == solo_segs[name],
               f"stream {name}: {len(recs)} journal records != "
               f"{solo_segs[name]} drained segments")
        if killed is not None and per_lane_migs[name] > 0:
            _check(recs[-1]["device"] != killed,
                   f"victim {name}: journal ends on the KILLED member "
                   f"{killed}")
            _check(len({r["device"] for r in recs}) >= 2,
                   f"victim {name}: journal never switched device labels "
                   "across the migration boundary")
    return {
        "streams": streams, "segments": segments,
        "mode": "rolling" if rolling else "kill",
        "kill_device": None if rolling else kill_device,
        "kill_at": kill_at, "migrations": migs,
        "per_lane_migrations": per_lane_migs,
        "device_drains": drains, "ring_cold_dispatches": ring_cold,
        "pool_compiles": pool_compiles,
        "drained": {k: results[k].drained for k in names},
        "device": str(fleet.device),
        "ok": True,
    }


def run_ab(segments: int = 20, log2n: int = 13, reps: int = 3,
           device=None) -> dict:
    """The steady single-stream A/B: the fleet with N = 1 against the solo
    Pipeline, same config and data, the median of ``reps`` seg/s each."""
    import time

    from srtb_tpu_torch.io.writers import WriteSignalSink
    from srtb_tpu_torch.pipeline.fleet import StreamFleet, StreamSpec
    from srtb_tpu_torch.pipeline.runtime import Pipeline
    from srtb_tpu_torch.utils.metrics import metrics

    tmp = tempfile.mkdtemp(prefix="srtb_fleet_ab_")
    n = 1 << log2n
    _synthesize(tmp, ["ab"], n, segments, seed=0, device=device)

    def one(fleet_mode: bool) -> float:
        run_dir = tempfile.mkdtemp(dir=tmp)
        cfg = _cfg(tmp, "ab", run_dir, n, checkpoint_path="",
                   run_manifest_path="")
        metrics.reset()
        t0 = time.perf_counter()
        if fleet_mode:
            fleet = StreamFleet([StreamSpec(
                name="ab", cfg=cfg, sinks=[WriteSignalSink(cfg)])],
                device=device)
            done = fleet.run()["ab"].drained
            fleet.close()
        else:
            with Pipeline(cfg, sinks=[WriteSignalSink(cfg)],
                          device=device) as pipe:
                done = pipe.run().segments
        return done / (time.perf_counter() - t0)

    solo = sorted(one(False) for _ in range(reps))[reps // 2]
    fleet = sorted(one(True) for _ in range(reps))[reps // 2]
    return {"solo_seg_per_s": round(solo, 2),
            "fleet_n1_seg_per_s": round(fleet, 2),
            "delta_pct": round((fleet - solo) / solo * 100, 2),
            "segments": segments, "log2n": log2n, "reps": reps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fleet-soak",
        description="multi-tenant fleet blast-radius gate "
                    "(srtb_tpu_torch/tools/fleet_soak.py)")
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--segments", type=int, default=5)
    ap.add_argument("--log2n", type=int, default=13)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", default=None,
                    help="explicit fault plan (stream-selector scoped; the "
                         "default faults stream0)")
    ap.add_argument("--batch", type=int, default=0,
                    help="fleet_batch_max (>= 2 arms cross-stream batching "
                         "and the vmap-tolerance gate)")
    ap.add_argument("--selftest", action="store_true",
                    help="prove the gate catches cross-stream leakage")
    ap.add_argument("--ab", action="store_true",
                    help="single-stream A/B: fleet N=1 vs Pipeline")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--migrate", action="store_true",
                    help="device-pool migration soak on a 2-member pool")
    ap.add_argument("--kill-device", type=int, default=1)
    ap.add_argument("--kill-at", type=int, default=2)
    ap.add_argument("--rolling", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    if args.selftest:
        fails = selftest(device=args.device)
        for f in fails:
            print(f"fleet-soak selftest: {f}", file=sys.stderr)
        print("fleet-soak selftest: " + (
            "FAILED" if fails else "OK — cross-stream leakage fails the "
                                   "gate"))
        return 1 if fails else 0
    if args.ab:
        print(json.dumps(run_ab(segments=args.segments * 4,
                                log2n=args.log2n, reps=args.reps,
                                device=args.device), sort_keys=True))
        return 0
    try:
        if args.migrate:
            report = run_migrate(
                streams=args.streams, segments=args.segments,
                log2n=args.log2n, seed=args.seed,
                kill_device=args.kill_device, kill_at=args.kill_at,
                rolling=args.rolling, device=args.device)
        else:
            report = run_soak(streams=args.streams,
                              segments=args.segments, log2n=args.log2n,
                              plan=args.plan, seed=args.seed,
                              batch=args.batch, device=args.device)
    except SoakFailure as e:
        print(json.dumps({"ok": False, "failure": str(e)}))
        print(f"fleet-soak: GATE FAILED — {e}", file=sys.stderr)
        return 1
    print(json.dumps(report, sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
