"""Seeded schedule-perturbation race soak for the fleet (port of
``srtb_tpu/tools/race_soak.py``).

A race that survives fleet_soak's chaos runs may simply never have seen
the losing interleave: the scheduler thread and the per-lane sink threads
are fast, so the windows between a check and its act are nanoseconds
wide.  This harness arms the runtime concurrency checker (``Config.tsan``,
``analysis/tsan.py``) and installs a
:class:`~srtb_tpu_torch.analysis.tsan.SchedulePerturber` that injects
deterministic sleeps at instrumented lock acquisition points: the windows
widen by ~3 orders of magnitude, reproducibly: the decision for
occurrence ``k`` of site ``s`` is a pure hash of ``(seed, s, k)``, so the
same seed yields the same perturbation schedule.

Under that perturbation it runs the multi-stream fleet + batch-former +
chaos soak (``tools/fleet_soak.py``, unchanged gates) with a deadline,
then a second perturbed phase: the pool's rolling-restart migration soak
(``fleet_soak.run_migrate``), whose scheduler-thread drains, tagged
trigger thread (``termination.tag_thread``) and sink-pipe threads
interleave with the perturbation sleeps.  Checks:

- every fleet_soak invariant still holds (bit-identical healthy outputs /
  the vmap tolerance when batched, accounted-only victim loss, journal
  attribution, plan-cache economy): perturbation may reorder thread
  interleavings, never results;
- **no deadlock within the deadline**: on expiry every live thread's
  stack (with its creation site) is dumped and the soak fails;
- the lockdep layer stayed quiet: an order cycle or ownership violation
  raises :class:`TsanError` out of the run;
- **schedule determinism**: the recorded perturbation journal replays
  exactly against a fresh perturber with the same seed.

The migration phase needs a pool of two members.  On the CPU
(``--device cpu``) that is the virtual pool; a card's pool has one member
a card, so on one card the phase runs only where the caller asks for the
CPU's virtual pool (``--migrate-device cpu``), and its report says
``cpu (virtual pool)``.  Without that, one card fails the phase.

``--selftest`` proves the checker is sharp: a deliberately inverted
acquisition order through the instrumented locks must raise
:class:`TsanError`, and the same pairs taken in a consistent global order
must not.

Usage::

    python -m srtb_tpu_torch.tools.race_soak [--streams N] [--segments N]
        [--log2n N] [--seed N] [--batch B] [--plan PLAN]
        [--deadline S] [--device cpu|cuda] [--migrate-device cpu]
        [--selftest]

Without ``--device`` the soak runs on the card.  Exit 0 on a passing gate
(or sharp selftest), 1 on any failure.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading

from srtb_tpu_torch.analysis.tsan import (SchedulePerturber, Tsan,
                                          TsanError, install_perturber,
                                          uninstall_perturber)


class RaceSoakFailure(AssertionError):
    """One broken race-soak invariant (deadline, determinism, or a
    propagated fleet_soak gate failure)."""


def _pool_label(device) -> str:
    """The migrate phase's device as its report line gives it."""
    from srtb_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    return f"{dev} (virtual pool)" if dev.type == "cpu" else str(dev)


def run_race_soak(streams: int = 2, segments: int = 4,
                  log2n: int = 12, seed: int = 0, batch: int = 2,
                  plan: str | None = None,
                  deadline_s: float = 300.0,
                  rate: float = 0.25, device=None,
                  migrate_device=None) -> dict:
    """One perturbed soak.  Returns the report dict; raises
    :class:`RaceSoakFailure` (deadline/determinism) or propagates
    :class:`TsanError` / fleet_soak's ``SoakFailure``.  ``device`` is the
    fleet soak's (``None``: the card); ``migrate_device`` the migration
    phase's (``None``: ``device``)."""
    from srtb_tpu_torch.tools.fleet_soak import run_migrate, run_soak
    from srtb_tpu_torch.utils import termination

    if migrate_device is None:
        migrate_device = device
    if plan is None:
        # one injected stall on the victim's fetch: long enough to push
        # its sink idle and exercise the event-driven wakeup under
        # perturbation, no demotions (a stall is not a device fault), so
        # the journal gate expects plan_demotions == 0
        plan = "stream0:fetch:stall=0.05@1"
    perturber = SchedulePerturber(seed, rate=rate)
    out: dict = {}
    err: list = []

    def _worker():
        try:
            out["report"] = run_soak(
                streams=streams, segments=segments, log2n=log2n,
                plan=plan, seed=seed, batch=batch,
                extra_cfg={"tsan": True,
                           # generous linger + wide lane windows so
                           # 2-stream batches keep forming even when
                           # perturbation sleeps stagger the lanes (the
                           # batching-economy gate stays armed)
                           "fleet_batch_linger_ms": 50.0,
                           "inflight_segments": 4},
                device=device)
        except BaseException as e:  # noqa: BLE001 — reported below
            err.append(e)

    def _mig_worker():
        # phase 2: live migration under perturbation, a rolling restart
        # of a 2-member pool, its trigger thread tagged for the deadline
        # gate's stack dumps.  The unchanged run_migrate gates
        # (bit-identical resume, exact cold-dispatch arithmetic, v11
        # device-stamped journals) must hold under every widened
        # interleave.
        try:
            out["migrate"] = run_migrate(
                streams=streams, segments=max(segments, 5),
                log2n=log2n, seed=seed, rolling=True, kill_at=3,
                extra_cfg={"tsan": True}, device=migrate_device)
        except BaseException as e:  # noqa: BLE001 — reported below
            err.append(e)

    install_perturber(perturber)
    try:
        for tname, target in (("race-soak-run", _worker),
                              ("race-soak-migrate", _mig_worker)):
            t = threading.Thread(target=target, name=tname, daemon=True)
            termination.tag_thread(t)
            t.start()
            t.join(deadline_s)
            if t.is_alive():
                # the deadlock gate: dump every live thread with its
                # creation site, then fail loudly
                stacks = termination.format_thread_stacks(
                    threading.enumerate())
                raise RaceSoakFailure(
                    f"race soak ({tname}) did not finish within "
                    f"{deadline_s:.0f}s — deadlock or livelock under "
                    f"perturbation; live threads:\n{stacks}")
            if err:
                break
    finally:
        uninstall_perturber()
    if err:
        raise err[0]

    # schedule determinism: the recorded journal must replay exactly
    # against a fresh perturber with the same seed (decide() is a pure
    # hash: this pins that no wall-clock or RNG state leaked in)
    replay = SchedulePerturber(seed, rate=rate)
    for site, k in perturber.journal:
        if not replay.decide(site, k):
            raise RaceSoakFailure(
                f"perturbation journal does not replay: site "
                f"{site!r} occurrence {k} was perturbed live but a "
                f"fresh perturber with seed {seed} declines it")
    report = dict(out["report"])
    mig = out.get("migrate", {})
    report.update({
        "seed": seed, "perturb_rate": rate,
        "perturbs": len(perturber.journal),
        "perturb_sites": sorted({s for s, _k in perturber.journal}),
        "migrations": mig.get("migrations"),
        "migrate_ring_cold": mig.get("ring_cold_dispatches"),
        "migrate_device_drains": mig.get("device_drains"),
        "migrate_device": _pool_label(migrate_device),
    })
    if not perturber.journal:
        raise RaceSoakFailure(
            "perturber never fired — the fleet ran with no "
            "instrumented acquisitions (Config.tsan not armed?)")
    return report


def selftest() -> list[str]:
    """Prove the checker is sharp.  (a) a deliberate lock-order inversion
    through the instrumented locks must raise TsanError; (b) the same
    locks taken in one consistent global order must not (the trap is not
    simply firing on every nesting); (c) the perturber's schedule is
    seed-deterministic."""
    failures = []

    # (a) inversion: A->B on record, then B->A must trap BEFORE acquiring
    # (no actual deadlock needed: a single-threaded proof)
    ts = Tsan()
    a, b = ts.lock("selftest.A"), ts.lock("selftest.B")
    with a:
        with b:
            pass
    try:
        with b:
            with a:
                pass
        failures.append(
            "lockdep passed a deliberate lock-order inversion "
            "(A->B then B->A) — the cycle trap is not firing")
    except TsanError:
        pass  # caught, as required

    # (b) consistent order: same pairs, one global order, no trap
    ts2 = Tsan()
    a2, b2 = ts2.lock("selftest.A"), ts2.lock("selftest.B")
    try:
        for _ in range(3):
            with a2:
                with b2:
                    pass
    except TsanError as e:
        failures.append(
            f"lockdep trapped a CONSISTENT acquisition order: {e}")

    # (c) determinism: two perturbers, same seed, same decisions
    p1 = SchedulePerturber(7, rate=0.5)
    p2 = SchedulePerturber(7, rate=0.5)
    sites = [("x", k) for k in range(64)] + [("y", k) for k in range(64)]
    if [p1.decide(s, k) for s, k in sites] \
            != [p2.decide(s, k) for s, k in sites]:
        failures.append("perturber schedule differs across two "
                        "instances with the same seed")
    if all(not p1.decide(s, k) for s, k in sites):
        failures.append("perturber at rate=0.5 never fires")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="race-soak",
        description="seeded schedule-perturbation fleet soak "
                    "(see srtb_tpu_torch/tools/race_soak.py)")
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--log2n", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2,
                    help="fleet_batch_max (>= 2 arms the batch former; 0 "
                         "disables)")
    ap.add_argument("--plan", default=None,
                    help="fault plan (default: one injected stall on "
                         "stream0's fetch)")
    ap.add_argument("--deadline", type=float, default=300.0,
                    help="deadlock deadline for the whole soak (s)")
    ap.add_argument("--rate", type=float, default=0.25,
                    help="perturbation probability per acquisition")
    ap.add_argument("--device", default=None,
                    help="where the soak runs (default: the card)")
    ap.add_argument("--migrate-device", default=None,
                    help="where the migration phase's 2-member pool runs "
                         "(default: --device; 'cpu' is the virtual pool)")
    ap.add_argument("--selftest", action="store_true",
                    help="prove lockdep catches an injected lock-order "
                         "inversion")
    args = ap.parse_args(argv)

    if args.selftest:
        fails = selftest()
        for f in fails:
            print(f"race-soak selftest: {f}", file=sys.stderr)
        print("race-soak selftest: "
              + ("FAILED" if fails else
                 "OK — injected inversion trips the checker"))
        return 1 if fails else 0
    try:
        report = run_race_soak(
            streams=args.streams, segments=args.segments,
            log2n=args.log2n, seed=args.seed, batch=args.batch,
            plan=args.plan, deadline_s=args.deadline, rate=args.rate,
            device=args.device, migrate_device=args.migrate_device)
    except (RaceSoakFailure, TsanError) as e:
        print(json.dumps({"ok": False, "failure": str(e)}))
        print(f"race-soak: GATE FAILED — {e}", file=sys.stderr)
        return 1
    except AssertionError as e:  # fleet_soak.SoakFailure
        print(json.dumps({"ok": False, "failure": str(e)}))
        print(f"race-soak: FLEET GATE FAILED under perturbation — "
              f"{e}", file=sys.stderr)
        return 1
    print(json.dumps(report, sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
