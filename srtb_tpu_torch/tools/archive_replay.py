"""The command line of the archive replay engine (``pipeline/archive.py``; port
of ``srtb_tpu/tools/archive_replay.py``).

Replay recorded baseband files at full device occupancy (no pacing, deep
micro-batch, files fanned across fleet lanes) with exactly-once
manifest-backed outputs and deterministic resume: re-running the same
command after a crash resumes every file from its checkpoint and the
final output set is bit-identical to an uninterrupted run.

Usage::

    python -m srtb_tpu_torch.tools.archive_replay \\
        --files "obs1.bin,obs2.bin" --out-dir replay_out \\
        [--config srtb_config.cfg] [--set key=value ...] \\
        [--lanes 2] [--micro-batch 4] [--fleet-batch B] \\
        [--inflight 8] [--max-segments N] [--no-waterfall] \\
        [--device cpu|cuda]

``--set`` applies config options on top of ``--config`` (same syntax as
the config file, e.g. ``--set search_mode=periodicity``).  Without
``--device`` the replay runs on the card.

``--selftest`` runs the gate: two synthetic files, a mid-run SIGTERM
steered into a sink-write window of one lane, a resumed replay to
completion, and the union of outputs compared path+SHA-256 bit-identical
against per-file streamed golden runs (plus fsck-clean manifests and a
no-orphan-temps sweep), then a micro-batched replay held to the same
goldens.  Exit 0 on pass.
"""

from __future__ import annotations

import argparse
import glob as globlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

_FIRING_MARK = "[faults] firing"
CHILD_TIMEOUT_S = 300.0
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ReplayFailure(AssertionError):
    """One broken archive-replay invariant (the selftest gate)."""


def _expand_files(arg: str) -> list[str]:
    files: list[str] = []
    for part in (p.strip() for p in arg.split(",")):
        if not part:
            continue
        matches = sorted(globlib.glob(part))
        files.extend(matches if matches else [part])
    return files


def _base_cfg(args):
    from srtb_tpu_torch.config import Config
    cfg = Config()
    if args.config:
        cfg.load_file(args.config)
    for kv in args.set or []:
        if "=" not in kv:
            raise SystemExit(f"--set expects key=value, got {kv!r}")
        key, value = kv.split("=", 1)
        if not cfg.set_option(key, value):
            raise SystemExit(f"--set: unknown config option {key!r}")
    if args.fault_plan:
        cfg.fault_plan = args.fault_plan
    return cfg


def run_replay(args) -> int:
    from srtb_tpu_torch.pipeline.archive import ArchiveReplay

    files = _expand_files(args.files)
    if not files:
        raise SystemExit("no input files (--files)")
    engine = ArchiveReplay(
        _base_cfg(args), files, args.out_dir,
        lanes=args.lanes, micro_batch=args.micro_batch,
        inflight=args.inflight,
        keep_waterfall=not args.no_waterfall,
        max_segments_per_file=args.max_segments or None,
        fleet_batch=args.fleet_batch, device=args.device)
    report = engine.run().as_dict()
    print(json.dumps(report, sort_keys=True), flush=True)
    return 0 if report["ok"] else 1


# ----------------------------------------------------------------
# selftest: the archive-replay gate
# ----------------------------------------------------------------

def _sha_map(dirpath: str, bookkeeping_suffixes=(".ck.json",
                                                 ".ck.json.bak",
                                                 ".manifest.jsonl",
                                                 ".journal.jsonl")) -> dict:
    """relative artifact name -> sha256 (bookkeeping excluded)."""
    out = {}
    for name in sorted(os.listdir(dirpath)):
        p = os.path.join(dirpath, name)
        if not os.path.isfile(p) or \
                any(name.endswith(s) for s in bookkeeping_suffixes):
            continue
        h = hashlib.sha256()
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        out[name] = h.hexdigest()
    return out


def _science_cfg(n: int) -> dict:
    """The selftest's science config (the crash-soak recipe: every segment
    positive and writing artifacts, so every kill window has writes to
    land in and every segment joins the equality union)."""
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
        writer_thread_count=0,
        fft_strategy="four_step")


def _make_archive_file(tmp: str, tag: str, n: int, segments: int,
                       seed: int) -> str:
    """One synthetic archive file: a dispersed pulse in the middle of every
    stride, 8-bit, from numpy's generator ``seed`` (the reference's bytes)."""
    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.io.synth import make_dispersed_baseband_host
    from srtb_tpu_torch.ops import dedisperse as dd

    probe = Config(**_science_cfg(n))
    reserved = int(dd.nsamps_reserved(probe))
    stride = max(1, n - reserved)
    total = n * segments
    pulses = [reserved + i * stride + stride // 2
              for i in range((total - reserved) // stride + 1)
              if reserved + i * stride + stride // 2 < total]
    path = os.path.join(tmp, f"{tag}.bin")
    make_dispersed_baseband_host(total, 1405.0, 64.0, 0.05,
                                 pulse_positions=pulses, pulse_amp=40.0,
                                 nbits=8, seed=seed).tofile(path)
    return path


def _spawn_replay(files: list[str], out_dir: str, n: int,
                  fault_plan: str = "", kill_on: str | None = None,
                  micro_batch: int = 2, inflight: int = 4,
                  timeout_s: float = CHILD_TIMEOUT_S,
                  device: str | None = None) -> dict:
    """One archive_replay subprocess; with ``kill_on`` set, SIGTERM it as
    soon as that marker appears on its merged output (the archive analog
    of the crash soak's steered SIGKILL: SIGTERM's default disposition
    kills the process with no cleanup, mid-stall)."""
    cmd = [sys.executable, "-m", "srtb_tpu_torch.tools.archive_replay",
           "--files", ",".join(files), "--out-dir", out_dir,
           "--micro-batch", str(micro_batch),
           "--inflight", str(inflight), "--lanes", "2"]
    for k, v in sorted(_science_cfg(n).items()):
        # bools ride the config-file syntax (0/1), like load_file
        cmd += ["--set", f"{k}={int(v) if isinstance(v, bool) else v}"]
    if fault_plan:
        cmd += ["--fault-plan", fault_plan]
    if device:
        cmd += ["--device", device]
    # the child imports this checkout's package, wherever it runs from
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_CHECKOUT, env.get("PYTHONPATH", "")) if p)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            bufsize=1, env=env)
    backstop = threading.Timer(timeout_s, proc.kill)
    backstop.daemon = True
    backstop.start()
    killed = False
    report = None
    lines: list[str] = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("{"):
                try:
                    report = json.loads(line)
                except ValueError:
                    pass
            if kill_on is not None and not killed and kill_on in line:
                time.sleep(0.25)   # land the signal INSIDE the stall
                proc.terminate()   # SIGTERM: dies mid-write, no cleanup
                killed = True
        rc = proc.wait()
    finally:
        backstop.cancel()
        proc.stdout.close()
    return {"rc": rc, "killed": killed, "report": report,
            "lines": lines}


def run_selftest(segments: int = 4, log2n: int = 13,
                 tmpdir: str | None = None, device=None) -> dict:
    """The archive-replay gate, two legs:

    1. **exactly-once leg** (micro_batch=1): a 2-file fleet-fanned replay
       killed mid-run by a steered SIGTERM, then resumed to completion:
       final output set (paths + SHA-256) BIT-IDENTICAL to per-file
       streamed goldens, fsck-clean manifests, no orphan temps.
    2. **micro-batch leg** (micro_batch=2): the reference's contract for
       its vmapped batch plan: same artifact SET (identical decisions),
       raw .bin dumps bit-identical, float artifacts (.tim/.npy) allclose
       within the documented tolerance.  The port's batch runs the chain
       a member at a time, so its floats are the goldens' bits.

    ``device`` is where the goldens, the children and the batch leg run
    (``None``: the card)."""
    import numpy as np

    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.pipeline.archive import ArchiveReplay
    from srtb_tpu_torch.pipeline.runtime import Pipeline
    from srtb_tpu_torch.tools.fsck import fsck
    from srtb_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    tmp = tmpdir or tempfile.mkdtemp(prefix="srtb_archive_")
    n = 1 << log2n

    def check(cond, msg):
        if not cond:
            raise ReplayFailure(msg)

    files = [_make_archive_file(tmp, f"bb{i}", n, segments, seed=i)
             for i in range(2)]

    # ---- per-file STREAMED goldens: the solo serial engine, no batching,
    # no fleet: the outputs the replay must hit byte for byte.
    # Deterministic timestamps give both sides the same artifact names.
    golden_dir = os.path.join(tmp, "golden")
    os.makedirs(golden_dir, exist_ok=True)
    golden_segments = 0
    for i, f in enumerate(files):
        cfg = Config(**_science_cfg(n)).replace(
            input_file_path=f,
            baseband_output_file_prefix=os.path.join(
                golden_dir, f"bb{i}_"),
            deterministic_timestamps=True,
            micro_batch_segments=1, inflight_segments=2)
        with Pipeline(cfg, device=dev) as pipe:
            stats = pipe.run()
        golden_segments += stats.segments
        check(stats.signals > 0, f"golden run of {f} detected "
              "nothing — the gate would compare empty output sets")
    golden_map = _sha_map(golden_dir)
    check(golden_map, "golden runs produced no artifacts")

    # ---- leg 1: replay killed mid-run.  A stream-scoped sink_write stall
    # parks lane bb0's sink thread between fetch and artifact write;
    # SIGTERM lands inside the stall (no cleanup, the manifest holds
    # uncommitted state).  micro_batch=1: these lanes dispatch what the
    # goldens dispatched, so the equality below is bitwise.
    replay_dir = os.path.join(tmp, "replay")
    os.makedirs(replay_dir, exist_ok=True)
    res = _spawn_replay(files, replay_dir, n,
                        fault_plan="bb0:sink_write:stall=30@1",
                        kill_on=_FIRING_MARK,
                        micro_batch=1, inflight=4, device=str(dev))
    check(res["killed"], "the steered SIGTERM never fired (fault "
          "marker not seen):\n" + "\n".join(res["lines"][-15:]))
    check(res["rc"] != 0, "child exited 0 despite the mid-run kill")

    # the kill must land mid-file: a resume that has nothing to do would
    # gate nothing
    ck_path = os.path.join(replay_dir, "bb0.ck.json")
    done = 0
    if os.path.exists(ck_path):
        with open(ck_path) as f:
            done = int(json.load(f).get("segments_done", 0))
    check(done < segments, "kill landed after bb0 completed — "
          "nothing left to resume (tighten the fault index)")

    # ---- resumed replay to completion: checkpoints resume each file,
    # manifest recovery rolls back uncommitted artifacts
    res2 = _spawn_replay(files, replay_dir, n, micro_batch=1,
                         inflight=4, device=str(dev))
    check(res2["rc"] == 0, "resumed replay failed:\n"
          + "\n".join(res2["lines"][-15:]))
    report = res2["report"]
    check(report is not None and report["ok"],
          f"resumed replay report not ok: {report}")

    # ---- gates ----
    for i in range(2):
        man = os.path.join(replay_dir, f"bb{i}.manifest.jsonl")
        check(os.path.exists(man), f"missing manifest {man}")
        rep = fsck(man, os.path.join(replay_dir, f"bb{i}.ck.json"))
        check(rep["clean"], f"fsck NOT clean for bb{i}: "
              f"errors={rep['errors']} loss={rep['loss']}")
    orphans = [f for f in os.listdir(replay_dir)
               if f.endswith(".srtb_tmp")]
    check(not orphans, f"orphan temps survive the resume: {orphans}")

    replay_map = _sha_map(replay_dir)
    missing = sorted(set(golden_map) - set(replay_map))
    extra = sorted(set(replay_map) - set(golden_map))
    check(not missing, f"artifacts LOST vs streamed golden: {missing}")
    check(not extra, f"duplicate/unknown artifacts vs golden: {extra}")
    differing = sorted(k for k in golden_map
                       if golden_map[k] != replay_map[k])
    check(not differing, "artifact bytes differ from the streamed "
          f"golden: {differing}")

    # ---- leg 2: the micro-batched throughput mode (in-process: nothing
    # crashes here).  Decisions must be IDENTICAL (same artifact set, raw
    # .bin dumps bitwise equal); float artifacts within the reference's
    # documented tolerance.
    batch_dir = os.path.join(tmp, "batch")
    batch_rep = ArchiveReplay(Config(**_science_cfg(n)), files,
                              batch_dir, lanes=2, micro_batch=2,
                              inflight=4, device=dev).run()
    check(batch_rep.failed == 0,
          f"micro-batched replay leg failed: {batch_rep.as_dict()}")
    batch_map = _sha_map(batch_dir)
    check(set(batch_map) == set(golden_map),
          "micro-batched replay wrote a different artifact set "
          "(decisions drifted): only-batch="
          f"{sorted(set(batch_map) - set(golden_map))} only-golden="
          f"{sorted(set(golden_map) - set(batch_map))}")
    for name in sorted(golden_map):
        gp = os.path.join(golden_dir, name)
        bp = os.path.join(batch_dir, name)
        if name.endswith(".npy"):
            a, b = np.load(gp), np.load(bp)
            np.testing.assert_allclose(
                b, a, rtol=1e-5, atol=1e-3 * np.abs(a).max(),
                err_msg=f"micro-batched {name} beyond tolerance")
        elif name.endswith(".tim"):
            a = np.fromfile(gp, dtype=np.float32)
            b = np.fromfile(bp, dtype=np.float32)
            np.testing.assert_allclose(
                b, a, rtol=1e-5, atol=1e-4 * np.abs(a).max(),
                err_msg=f"micro-batched {name} beyond tolerance")
        else:  # raw baseband dumps are input bytes: bitwise
            check(golden_map[name] == batch_map[name],
                  f"micro-batched raw dump {name} differs bitwise")

    return {
        "ok": True, "files": 2, "segments": golden_segments,
        "artifacts": len(golden_map), "killed_mid_run": True,
        "bb0_segments_at_kill": done,
        "replay_seg_s": report.get("segments_per_sec"),
        "batch_bitwise": sum(golden_map[k] == batch_map[k]
                             for k in golden_map),
        "device": str(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="archive-replay",
        description="full-throughput archive replay of recorded "
                    "baseband files (see srtb_tpu_torch/pipeline/archive.py)")
    ap.add_argument("--files", default="",
                    help="comma-separated file paths / globs")
    ap.add_argument("--out-dir", default="archive_out")
    ap.add_argument("--config", default="",
                    help="config file applied before --set overrides")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override (repeatable)")
    ap.add_argument("--lanes", type=int, default=2,
                    help="files replayed concurrently (fleet lanes)")
    ap.add_argument("--micro-batch", type=int, default=4)
    ap.add_argument("--fleet-batch", type=int, default=0,
                    help="cross-tenant batch width: fold ready segments "
                         "from DIFFERENT files into one dispatch (needs "
                         "--micro-batch 1; 0 = off)")
    ap.add_argument("--inflight", type=int, default=8)
    ap.add_argument("--max-segments", type=int, default=0,
                    help="cap segments per file (0 = whole file)")
    ap.add_argument("--no-waterfall", action="store_true",
                    help="drop waterfalls before the sinks (detect-only "
                         "replay)")
    ap.add_argument("--device", default=None,
                    help="where the lanes run (default: the card)")
    ap.add_argument("--fault-plan", default="",
                    help=argparse.SUPPRESS)  # selftest steering
    ap.add_argument("--selftest", action="store_true",
                    help="run the gate (synthetic 2-file replay + SIGTERM "
                         "resume, bit-identical to goldens)")
    ap.add_argument("--segments", type=int, default=4,
                    help="selftest: segments per synthetic file")
    ap.add_argument("--log2n", type=int, default=13,
                    help="selftest: segment size exponent")
    args = ap.parse_args(argv)

    if args.selftest:
        try:
            report = run_selftest(segments=args.segments,
                                  log2n=args.log2n, device=args.device)
        except ReplayFailure as e:
            print(json.dumps({"ok": False, "failure": str(e)}))
            print(f"archive-replay: GATE FAILED — {e}",
                  file=sys.stderr)
            return 1
        print(json.dumps(report, sort_keys=True))
        return 0

    return run_replay(args)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
