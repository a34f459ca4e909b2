"""SIGKILL crash soak: durable exactly-once outputs under process death
(port of ``srtb_tpu/tools/crash_soak.py``).

It runs the file-mode pipeline as a SUBPROCESS and ``SIGKILL``s it in
the crash windows a kill plan steers it into:

- ``ckpt_stall@i``  — ``Config.fault_plan`` ``checkpoint:stall`` parks
  the child between segment *i*'s sink pushes and its checkpoint update
  (the duplicate-on-resume window); the parent kills it in the stall;
- ``sink_stall@i``  — ``sink_write:stall`` parks it after the fetch,
  before any artifact write (the clean-loss window);
- ``rename@N``      — the child arms ``io/writers._PRE_RENAME_HOOK`` to
  park its *N*-th artifact write between the temp write and the rename
  (an orphan temp and an uncommitted intent); the parent kills it there.
  Such a child writes through the Python writer pool, whose rename the
  hook can park (the native pool renames in C++).

After each kill the child is started again: ``Pipeline.__init__``
recovers the run manifest, rolls back uncommitted artifacts, resumes at
the checkpoint, and the manifest's done-set makes replayed sink pushes
idempotent.  When a child runs to completion the gate asserts:

- ``fsck`` (tools/fsck.py) is clean;
- the run directory's final output set (paths and SHA-256) equals an
  uninterrupted golden run's: no duplicate, no loss;
- every planned SIGKILL landed, and no ``.srtb_tmp`` orphan is left;
- a kill that left a committed group beyond the checkpoint is replayed
  as a skip, and a mid-rename kill rolls back an intent.

The children stamp timestamps from the stream offset
(``deterministic_timestamps``), so artifact names reproduce across the
golden run, the kills and the resumes.

Usage::

    python -m srtb_tpu_torch.tools.crash_soak [--seed N] [--segments N]
        [--kills N] [--log2n N] [--kill-plan "ckpt_stall@1,rename@2"]
        [--writer-threads N] [--micro-batch B] [--device cpu|cuda]

Without ``--device`` the children run on the card.  Exit 0 on a passing
soak, 1 on any gate failure.  :func:`run_soak` also takes a whole
configuration and an input file (``base_cfg``, ``input_path``), as the
card's smoke test runs it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time

STALL_S = 30.0          # long enough that the parent's kill always lands
CHILD_TIMEOUT_S = 300.0
_FIRING_MARK = "[faults] firing"
_RENAME_MARK = "SOAK_RENAME_STALL"
_STATS_MARK = "SOAK_STATS "
_RECOVERY_MARK = "SOAK_RECOVERY "
_SKIP_MARK = "skipping replay"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the run directory's bookkeeping, outside the compared output set
_BOOKKEEPING = {"manifest.jsonl", "ck.json", "ck.json.bak", "ck.json.tmp",
                "cfg.json"}


class SoakFailure(AssertionError):
    """One broken exactly-once invariant (the gate)."""


# ----------------------------------------------------------------
# child side
# ----------------------------------------------------------------

def _child_main(cfg_path: str, device: str | None, stall_rename_at: int,
                stall_s: float) -> int:
    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.io import writers
    from srtb_tpu_torch.pipeline import runtime

    with open(cfg_path) as f:
        cfg = Config(**json.load(f))
    if stall_rename_at > 0:
        if cfg.writer_thread_count > 0:
            # the Python pool renames in Python, where the hook parks it
            pool_cls = runtime.AsyncWriterPool
            runtime.AsyncWriterPool = (
                lambda n: pool_cls(n, prefer_native=False))
        count = [0]

        def hook(path):
            count[0] += 1
            if count[0] == stall_rename_at:
                print(f"{_RENAME_MARK} {os.path.basename(path)}",
                      flush=True)
                time.sleep(stall_s)

        writers._PRE_RENAME_HOOK = hook
    with runtime.Pipeline(cfg, device=device) as pipe:
        # the recovery ran in the constructor: report it before the run,
        # so the parent sees it even from a child it kills
        counters = pipe.manifest.counters()
        print(_RECOVERY_MARK + json.dumps(counters), flush=True)
        stats = pipe.run()
        counters = pipe.manifest.counters()
    print(_STATS_MARK + json.dumps({
        "segments": stats.segments, "signals": stats.signals,
        "elapsed_s": stats.elapsed_s,
        "checkpoint_s": stats.extras["checkpoint_s_per_segment"],
        "recovered": {k: stats.extras.get(k, 0) for k in (
            "plan_demotions", "device_reinits", "retries_total",
            "watchdog_requeues")},
        **counters}), flush=True)
    return 0


# ----------------------------------------------------------------
# parent side
# ----------------------------------------------------------------

def _soak_fields(n: int) -> dict:
    """The CPU soak's configuration: 8-bit samples, every segment
    positive (a pulse a stride, the detection threshold under the noise
    floor), so every kill window has writes to land in."""
    return dict(
        baseband_input_count=n, baseband_input_bits=8,
        baseband_freq_low=1405.0, baseband_bandwidth=64.0,
        baseband_sample_rate=128e6, dm=0.05,
        spectrum_channel_count=64,
        mitigate_rfi_average_method_threshold=1000.0,
        mitigate_rfi_spectral_kurtosis_threshold=50.0,
        signal_detect_signal_noise_threshold=1.5,
        signal_detect_max_boxcar_length=8,
        baseband_reserve_sample=True,
        fft_strategy="four_step",
        inflight_segments=2)


def _child_cfg(base: dict, input_path: str, run_dir: str,
               fault_plan: str = "", writer_threads: int | None = None,
               micro_batch: int = 1) -> dict:
    """``base`` (Config fields) for one child: its input, its run
    directory's outputs, checkpoint and manifest, deterministic
    timestamps, the fault plan and the micro-batch (the window widened to
    hold it)."""
    cfg = dict(base)
    cfg.update(
        input_file_path=input_path,
        baseband_output_file_prefix=os.path.join(run_dir, "out_"),
        checkpoint_path=os.path.join(run_dir, "ck.json"),
        run_manifest_path=os.path.join(run_dir, "manifest.jsonl"),
        deterministic_timestamps=True, fault_plan=fault_plan,
        micro_batch_segments=micro_batch,
        inflight_segments=max(int(cfg.get("inflight_segments", 2) or 1),
                              micro_batch),
        gui_enable=False)
    if writer_threads is not None:
        cfg["writer_thread_count"] = writer_threads
    return cfg


def _run_child(run_dir: str, cfg: dict, device: str | None,
               kill_on: str | None = None, stall_rename_at: int = 0,
               timeout_s: float = CHILD_TIMEOUT_S) -> dict:
    """Spawn one pipeline child; with ``kill_on``, SIGKILL it as soon as
    that marker appears on its merged output.  Returns {rc, killed,
    stats, recovery, replayed_skips, wall_s, lines}."""
    cfg_path = os.path.join(run_dir, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    cmd = [sys.executable, "-m", "srtb_tpu_torch.tools.crash_soak",
           "--child", cfg_path]
    if device:
        cmd += ["--device", device]
    if stall_rename_at > 0:
        cmd += ["--stall-rename-at", str(stall_rename_at),
                "--stall-s", f"{STALL_S:g}"]
    # the child imports this checkout's package, wherever it runs from
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_CHECKOUT, env.get("PYTHONPATH", "")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            bufsize=1, env=env)
    # a hard backstop, so a wedged child cannot hang the soak
    backstop = threading.Timer(timeout_s, proc.kill)
    backstop.daemon = True
    backstop.start()
    killed = False
    stats = recovery = None
    lines: list[str] = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith(_STATS_MARK):
                stats = json.loads(line[len(_STATS_MARK):])
            elif line.startswith(_RECOVERY_MARK):
                recovery = json.loads(line[len(_RECOVERY_MARK):])
            if kill_on is not None and not killed and kill_on in line:
                time.sleep(0.25)  # land the kill inside the stall
                proc.kill()       # SIGKILL: no clean-up runs
                killed = True
        rc = proc.wait()
    finally:
        backstop.cancel()
        proc.stdout.close()
    return {"rc": rc, "killed": killed, "stats": stats,
            "recovery": recovery,
            "replayed_skips": sum(_SKIP_MARK in ln for ln in lines),
            "wall_s": time.perf_counter() - t0, "lines": lines}


def _read_ck_done(run_dir: str) -> int:
    for name in ("ck.json", "ck.json.bak"):
        try:
            with open(os.path.join(run_dir, name)) as f:
                return int(json.load(f).get("segments_done", 0))
        except (OSError, ValueError):
            continue
    return 0


def snapshot_outputs(run_dir: str) -> dict:
    """relative name -> SHA-256 of every artifact in a run directory (its
    bookkeeping excluded)."""
    out = {}
    for name in sorted(os.listdir(run_dir)):
        p = os.path.join(run_dir, name)
        if name in _BOOKKEEPING or not os.path.isfile(p):
            continue
        h = hashlib.sha256()
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 22), b""):
                h.update(chunk)
        out[name] = h.hexdigest()
    return out


def parse_kill_plan(text: str) -> list[tuple[str, int]]:
    """"kind@arg,..." with kinds ckpt_stall|sink_stall (arg = the run's
    segment index) and rename (arg = the run's Nth artifact write)."""
    plan = []
    for entry in (e.strip() for e in text.split(",")):
        if not entry:
            continue
        try:
            kind, arg = entry.split("@", 1)
            kind = kind.strip()
            arg_i = int(arg)
        except ValueError as e:
            raise ValueError(f"kill-plan entry {entry!r}: expected "
                             "'kind@int'") from e
        if kind not in ("ckpt_stall", "sink_stall", "rename"):
            raise ValueError(f"kill-plan entry {entry!r}: unknown kind "
                             f"{kind!r}")
        plan.append((kind, arg_i))
    return plan


def generate_kill_plan(seed: int, kills: int) -> list[tuple[str, int]]:
    """Seeded kill points: the first two cover the two named windows
    (mid-checkpoint, mid-rename), the rest draw from all three kinds.
    Stall indices count within each resumed run (clamped to its
    remaining segments at launch, so every planned kill lands)."""
    rng = random.Random(seed)
    plan: list[tuple[str, int]] = []
    for i in range(kills):
        if i == 0:
            kind = "ckpt_stall"
        elif i == 1:
            kind = "rename"
        else:
            kind = rng.choice(("ckpt_stall", "sink_stall", "rename"))
        arg = (rng.randrange(1, 3) if kind == "rename"
               else rng.randrange(0, 3))
        plan.append((kind, arg))
    return plan


def make_soak_input(path: str, n: int, segments: int, seed: int) -> None:
    """The CPU soak's input: ``segments`` segments' worth of 8-bit noise
    with one dispersed pulse in every overlap-save stride, so every
    segment the reader emits is positive."""
    import torch

    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.io.synth import make_dispersed_baseband
    from srtb_tpu_torch.ops import dedisperse as dd
    reserved = int(dd.nsamps_reserved(Config(**_soak_fields(n))))
    stride = max(1, n - reserved)
    total = n * segments
    pulses = [reserved + i * stride + stride // 2
              for i in range((total - reserved) // stride + 1)
              if reserved + i * stride + stride // 2 < total]
    gen = torch.Generator().manual_seed(seed)
    make_dispersed_baseband(total, 1405.0, 64.0, 0.05, pulses, nbits=8,
                            pulse_amp=40.0, generator=gen
                            ).numpy().tofile(path)


def run_soak(seed: int = 0, segments: int = 10, kills: int = 5,
             log2n: int = 13, kill_plan: str | None = None,
             writer_threads: int | None = 0, micro_batch: int = 1,
             device: str | None = "cpu", tmpdir: str | None = None,
             base_cfg: dict | None = None, input_path: str | None = None,
             golden: dict | None = None) -> dict:
    """One soak: the golden run (or ``golden``, a report's ``golden`` of
    an earlier soak on the same input), the kill loop, the recovery to
    completion, the gate.  ``base_cfg`` (Config fields) and
    ``input_path`` replace the CPU soak's configuration and synthetic
    input.  Returns the report; raises :class:`SoakFailure` on a broken
    invariant."""
    from srtb_tpu_torch.io.manifest import group_complete, scan_manifest
    from srtb_tpu_torch.tools.fsck import fsck

    tmp = tmpdir or tempfile.mkdtemp(prefix="srtb_crash_")
    os.makedirs(tmp, exist_ok=True)
    if base_cfg is None:
        base_cfg = _soak_fields(1 << log2n)
    if input_path is None:
        input_path = os.path.join(tmp, "bb.bin")
        make_soak_input(input_path, int(base_cfg["baseband_input_count"]),
                        segments, seed)

    def child_cfg(run_dir, fault_plan=""):
        return _child_cfg(base_cfg, input_path, run_dir, fault_plan,
                          writer_threads, micro_batch)

    def check(cond, msg):
        if not cond:
            raise SoakFailure(msg)

    children: list[dict] = []
    if golden is None:
        golden_dir = os.path.join(tmp, "golden")
        os.makedirs(golden_dir, exist_ok=True)
        res = _run_child(golden_dir, child_cfg(golden_dir), device)
        check(res["rc"] == 0, f"golden run failed rc={res['rc']}:\n"
              + "\n".join(res["lines"][-20:]))
        children.append({"kind": "golden", "rc": 0, "killed": False,
                         "wall_s": res["wall_s"]})
        golden = {"outputs": snapshot_outputs(golden_dir),
                  "segments": int(res["stats"]["segments"]),
                  "signals": int(res["stats"]["signals"])}
    check(golden["signals"] > 0 and golden["outputs"],
          "the golden run wrote no artifacts: the soak would gate nothing")
    total_segments = golden["segments"]

    plan = (parse_kill_plan(kill_plan) if kill_plan
            else generate_kill_plan(seed, kills))
    soak_dir = os.path.join(tmp, "soak")
    os.makedirs(soak_dir, exist_ok=True)
    kills_done = 0
    all_res: list[dict] = []
    finished = False
    expect_replay = expect_rollback = False
    for kind, arg in plan:
        remaining = max(1, total_segments - _read_ck_done(soak_dir))
        if kind == "rename":
            res = _run_child(soak_dir, child_cfg(soak_dir), device,
                             kill_on=_RENAME_MARK,
                             stall_rename_at=max(1, arg))
        else:
            site = "checkpoint" if kind == "ckpt_stall" else "sink_write"
            index = min(arg, remaining - 1)
            res = _run_child(
                soak_dir, child_cfg(
                    soak_dir, f"{site}:stall={STALL_S:g}@{index}"),
                device, kill_on=_FIRING_MARK)
        all_res.append(res)
        children.append({"kind": f"{kind}@{arg}", "rc": res["rc"],
                         "killed": res["killed"], "wall_s": res["wall_s"],
                         "recovery": res["recovery"]})
        if res["killed"]:
            kills_done += 1
            scan = scan_manifest(os.path.join(soak_dir, "manifest.jsonl"))
            floor = scan.checkpoint_floor()
            if any(k[1] >= floor and group_complete(g)
                   for k, g in scan.groups.items()):
                expect_replay = True
            if kind == "rename":
                expect_rollback = True
        elif res["rc"] == 0:
            finished = True  # ran out of segments before the steering
            break
        else:
            raise SoakFailure(
                f"steered child died rc={res['rc']} without being "
                f"killed ({kind}@{arg}):\n" + "\n".join(res["lines"][-20:]))

    if not finished:
        res = _run_child(soak_dir, child_cfg(soak_dir), device)
        check(res["rc"] == 0, f"final recovery run failed rc={res['rc']}:"
              "\n" + "\n".join(res["lines"][-20:]))
        all_res.append(res)
        children.append({"kind": "final", "rc": 0, "killed": False,
                         "wall_s": res["wall_s"],
                         "recovery": res["recovery"],
                         "stats": res["stats"]})

    check(kills_done == len(plan),
          f"only {kills_done}/{len(plan)} planned SIGKILLs landed (the run "
          "completed early: more segments, or a tighter plan)")
    rep = fsck(os.path.join(soak_dir, "manifest.jsonl"),
               os.path.join(soak_dir, "ck.json"))
    check(rep["clean"], f"fsck NOT clean after recovery: "
          f"errors={rep['errors']} loss={rep['loss']}")
    orphans = [f for f in os.listdir(soak_dir) if f.endswith(".srtb_tmp")]
    check(not orphans, f"orphan temp files survive: {orphans}")
    soak_map = snapshot_outputs(soak_dir)
    golden_map = golden["outputs"]
    missing = sorted(set(golden_map) - set(soak_map))
    extra = sorted(set(soak_map) - set(golden_map))
    check(not missing, f"artifacts LOST across crashes: {missing}")
    check(not extra, f"duplicate or unknown artifacts after crashes: "
          f"{extra}")
    differing = sorted(k for k in golden_map
                       if golden_map[k] != soak_map[k])
    check(not differing,
          f"artifact bytes differ from the golden run: {differing}")
    replayed = sum(int(r["replayed_skips"]) for r in all_res)
    recovered = sum(int(r["recovery"]["recovered_segments"])
                    for r in all_res if r["recovery"])
    rolled = sum(int(r["recovery"]["rolled_back_intents"])
                 for r in all_res if r["recovery"])
    if expect_replay:
        check(replayed >= 1,
              "a kill left a committed segment beyond the checkpoint but "
              "no resumed child replay-skipped it")
    if expect_rollback:
        check(rolled >= 1,
              "a mid-rename kill landed but recovery rolled back no "
              "uncommitted intent")
    return {
        "seed": seed, "segments": total_segments,
        "artifacts": len(golden_map), "micro_batch": micro_batch,
        "plan": [f"{k}@{a}" for k, a in plan],
        "sigkills": kills_done, "resumes": len(all_res),
        "replayed_skips": replayed, "recovered_segments": recovered,
        "rolled_back_intents": rolled, "fsck_records": rep["records"],
        "children": children, "golden": golden, "ok": True,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="crash-soak",
        description="SIGKILL crash soak of durable exactly-once outputs "
                    "(see srtb_tpu_torch/tools/crash_soak.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--segments", type=int, default=10)
    ap.add_argument("--kills", type=int, default=5)
    ap.add_argument("--log2n", type=int, default=13)
    ap.add_argument("--kill-plan", default=None,
                    help="explicit plan 'kind@arg,...' (kinds "
                         "ckpt_stall|sink_stall|rename); overrides "
                         "--kills")
    ap.add_argument("--writer-threads", type=int, default=0,
                    help="candidate-writer pool size in the children "
                         "(0 = synchronous writes)")
    ap.add_argument("--micro-batch", type=int, default=1,
                    help="micro_batch_segments of the children")
    ap.add_argument("--device", default=None,
                    help="the children's device (default: the card)")
    # child-process plumbing (not for interactive use)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--stall-rename-at", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--stall-s", type=float, default=STALL_S,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        return _child_main(args.child, args.device, args.stall_rename_at,
                           args.stall_s)
    try:
        report = run_soak(seed=args.seed, segments=args.segments,
                          kills=args.kills, log2n=args.log2n,
                          kill_plan=args.kill_plan,
                          writer_threads=args.writer_threads,
                          micro_batch=args.micro_batch, device=args.device)
    except SoakFailure as e:
        print(json.dumps({"ok": False, "failure": str(e)}))
        print(f"crash-soak: GATE FAILED — {e}", file=sys.stderr)
        return 1
    report.pop("golden")
    print(json.dumps(report, sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
