"""Offline verifier and repairer of a run's durable outputs (port of
``srtb_tpu/tools/fsck.py``; it reads the reference's run directories as
well as the port's, the formats being the same).

The run manifest (io/manifest.py) is the WAL that makes sink outputs
exactly-once across process death; this tool is its filesystem checker
— run it after a crash, before archiving an observation, or in CI:

- **WAL integrity**: every record's CRC32 verifies; a torn tail (the
  record being appended when the process died) is reported and, with
  ``--repair``, truncated — exactly what startup recovery would do;
- **artifact integrity**: every committed artifact exists with the
  committed size AND content CRC32 (the whole file is read — fsck is
  the deep check, startup recovery only stats);
- **rollback debt**: uncommitted intents whose temp or renamed file is
  still on disk, and append files longer than their committed prefix
  (torn appends); ``--repair`` rolls both back;
- **checkpoint agreement**: the checkpoint file parses, its CRC
  verifies, and its ``segments_done`` never EXCEEDS the manifest's
  last consistency-point record — ``StreamCheckpoint.update`` seals
  the manifest first, so "checkpoint ahead of manifest" is always
  corruption (``--repair`` rewrites the checkpoint from the
  manifest's record);
- **loss**: committed-but-missing artifacts below the checkpoint are
  unrecoverable (the resume will never re-drain them) — reported,
  never "repaired" away.

Usage::

    python -m srtb_tpu_torch.tools.fsck MANIFEST [--checkpoint CKPT]
        [--repair] [--format json|text]
    python -m srtb_tpu_torch.tools.fsck --selftest

Exit codes: 0 = clean (or everything repaired), 1 = inconsistencies
found (unrepaired, or unrepairable loss), 2 = cannot verify at all
(missing/unreadable manifest, usage error).

``--selftest`` proves the verifier is sharp on a synthetic run dir: a
forged WAL CRC, a deleted committed artifact and a checkpoint ahead of
the manifest must each fail the check, and the untouched dir must
pass.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import zlib

from srtb_tpu_torch.io import manifest as M
from srtb_tpu_torch.pipeline.checkpoint import StreamCheckpoint

EXIT_CLEAN = 0
EXIT_ERRORS = 1
EXIT_UNVERIFIABLE = 2

_CHUNK = 1 << 22


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc


def _load_checkpoint(path: str) -> tuple[dict | None, list[str]]:
    """(state, errors): parse + CRC-verify the checkpoint file without
    the StreamCheckpoint fallbacks — fsck reports what IS on disk."""
    errors = []
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return None, errors
    except (json.JSONDecodeError, OSError, ValueError) as e:
        return None, [f"checkpoint {path} unreadable: {e}"]
    if not isinstance(data, dict):
        return None, [f"checkpoint {path} malformed: not an object"]
    crc = data.pop("crc", None)
    if crc is not None and M.record_crc(data) != crc:
        return None, [f"checkpoint {path} CRC mismatch: corrupt state"]
    return data, errors


def fsck(manifest_path: str, checkpoint_path: str | None = None,
         repair: bool = False) -> dict:
    """One verification pass.  Returns the report dict (``errors`` is
    what is wrong NOW, ``repaired`` what --repair fixed, ``loss`` what
    nothing can fix); raises ``FileNotFoundError`` when the manifest
    itself is absent."""
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(manifest_path)
    errors: list[str] = []
    repaired: list[str] = []
    loss: list[str] = []

    # the checkpoint file loads FIRST (read-only): its segments_done
    # is the floor hint that keeps --repair exactly as conservative as
    # the runtime's own startup recovery in the corrupted-WAL gap
    ck_state = None
    ck_errors: list[str] = []
    if checkpoint_path:
        ck_state, ck_errors = _load_checkpoint(checkpoint_path)
        if ck_state is None:
            # the designed fallback: a crash between update()'s two
            # renames leaves only the previous generation as .bak
            bak_state, _bak_errors = _load_checkpoint(
                checkpoint_path + ".bak")
            if bak_state is not None:
                ck_state, ck_errors = bak_state, []
    ck_hint = int(ck_state.get("segments_done", 0)) if ck_state else 0

    scan = M.scan_manifest(manifest_path)
    if scan.torn:
        msg = (f"torn WAL tail: {scan.total_bytes - scan.valid_bytes} "
               f"byte(s) from line {scan.bad_line} fail CRC/parse")
        if repair:
            with open(manifest_path, "rb+") as f:
                f.truncate(scan.valid_bytes)
            repaired.append(msg + " -> truncated")
            scan = M.scan_manifest(manifest_path)
        else:
            errors.append(msg)
    # effective floor: same max(WAL, checkpoint file) rule as startup
    # recovery, so fsck's below/above-floor classification predicts
    # exactly what recovery would do (the raw disagreement itself is
    # still reported by the checkpoint-ahead check below)
    floor = max(scan.checkpoint_floor(), ck_hint)

    complete: set = set()
    for key, grp in sorted(scan.groups.items()):
        if M.group_complete(grp):
            ok = True
            for art in grp.artifacts.values():
                if not art.committed:
                    continue
                prefix = (f"segment {key[1]} sink {key[2]}: "
                          f"{os.path.basename(art.path)}")
                if art.mode == "append":
                    continue  # verified via the committed prefix below
                try:
                    size = os.path.getsize(art.path)
                except OSError:
                    ok = False
                    (loss if key[1] < floor else errors).append(
                        f"{prefix} committed but missing")
                    continue
                if art.length is not None and size != art.length:
                    ok = False
                    errors.append(f"{prefix} size {size} != committed "
                                  f"{art.length}")
                elif art.crc32 is not None \
                        and _file_crc32(art.path) != art.crc32:
                    ok = False
                    errors.append(f"{prefix} content CRC mismatch")
            if ok:
                complete.add(key)
        else:
            msg = (f"segment {key[1]} sink {key[2]}: uncommitted "
                   "intent(s)" if not grp.done else
                   f"segment {key[1]} sink {key[2]}: group incomplete")
            if key[1] < floor:
                loss.append(msg + " under the checkpoint (ordering "
                            "contract violated upstream)")
            elif repair:
                repaired.append(msg + " -> rolled back")
            else:
                errors.append(msg + " (startup recovery or --repair "
                              "rolls this back)")

    # orphan files of rollback-due groups (only meaningful pre-repair)
    for key, grp in scan.groups.items():
        if key in complete or key[1] < floor:
            continue
        for art in grp.artifacts.values():
            if art.mode == "append":
                continue
            for p in (art.path + M.TMP_SUFFIX, art.path):
                if os.path.exists(p) and not repair and not art.committed:
                    errors.append(
                        f"orphan from uncommitted intent on disk: "
                        f"{os.path.basename(p)}")

    # append files vs their committed prefix (complete groups only)
    for p, target in M.append_committed_lengths(
            scan, complete_keys=complete).items():
        try:
            size = os.path.getsize(p)
        except OSError:
            size = 0
        if size > target:
            msg = (f"append file {os.path.basename(p)}: {size - target} "
                   f"byte(s) beyond the committed prefix {target}")
            if repair:
                with open(p, "rb+") as f:
                    f.truncate(target)
                repaired.append(msg + " -> truncated")
            else:
                errors.append(msg)
        elif size < target:
            loss.append(f"append file {os.path.basename(p)}: {size} < "
                        f"committed prefix {target} (bytes lost)")

    if repair:
        # apply the rollbacks fsck promised above (same engine, same
        # checkpoint-floor guard, as the pipeline runs at startup)
        rep = M.recover(manifest_path, apply=True,
                        checkpoint_floor_hint=ck_hint)
        for act in rep.rolled_back:
            repaired.append(f"recovery: {act}")
        for msg in rep.missing:
            loss.append(f"recovery: {msg}")

    # checkpoint <-> manifest agreement
    if checkpoint_path:
        errors.extend(ck_errors)
        last = scan.last_checkpoint
        manifest_done = int(last["segments_done"]) if last else 0
        if ck_state is not None:
            file_done = int(ck_state.get("segments_done", 0))
            if file_done > manifest_done:
                msg = (f"checkpoint ahead of manifest: file claims "
                       f"{file_done} segment(s) done, manifest sealed "
                       f"{manifest_done}")
                if repair and last is not None:
                    ck = StreamCheckpoint(checkpoint_path)
                    ck.update(manifest_done, int(last["offset"]))
                    repaired.append(msg + " -> rewrote checkpoint from "
                                    "the manifest record")
                else:
                    errors.append(msg)
        elif ck_state is None and not ck_errors and manifest_done > 0:
            # the manifest sealed progress but the checkpoint file (and
            # its .bak) is simply gone: a fresh process would restart
            # from segment 0 — the manifest done-set keeps that
            # idempotent, but a deleted checkpoint is worth flagging
            errors.append(
                f"checkpoint {checkpoint_path} missing while the "
                f"manifest sealed {manifest_done} segment(s)")

    report = {
        "manifest": manifest_path,
        "records": scan.records,
        "groups": len(scan.groups),
        "complete_groups": len(complete),
        "checkpoint_floor": floor,
        "errors": errors,
        "loss": loss,
        "repaired": repaired,
        "clean": not errors and not loss,
    }
    return report


# ----------------------------------------------------------------
# selftest
# ----------------------------------------------------------------

def _build_run_dir(tmp: str) -> tuple[str, str]:
    """Synthetic committed run: two artifacts + one append + sealed
    checkpoint.  Returns (manifest_path, checkpoint_path)."""
    mpath = os.path.join(tmp, "manifest.jsonl")
    ckpath = os.path.join(tmp, "ck.json")
    m = M.RunManifest.open(mpath)
    payloads = {
        os.path.join(tmp, "out_100.bin"): b"baseband-bytes" * 32,
        os.path.join(tmp, "out_100.0.npy"): b"npy-bytes" * 16,
    }
    key = (0, 0, "0:WriteSignalSink")
    for p, payload in payloads.items():
        m.intent(key, p)
        with open(p, "wb") as f:
            f.write(payload)
        m.commit(key, p, len(payload), zlib.crc32(payload))
    m.sink_done(key)
    akey = (0, 1, "1:WriteAllSink")
    apath = os.path.join(tmp, "out_stream0.bin")
    chunk = b"append-chunk" * 8
    m.intent(akey, apath, mode="append", offset=0)
    with open(apath, "wb") as f:
        f.write(chunk)
    m.commit(akey, apath, len(chunk), zlib.crc32(chunk), offset=0)
    m.sink_done(akey)
    ck = StreamCheckpoint(ckpath, manifest=m)
    ck.update(2, 8192)
    m.close()
    return mpath, ckpath


def selftest() -> list[str]:
    """Prove fsck catches what it exists to catch.  Returns failure
    strings (empty = the verifier is sharp)."""
    failures = []
    base = tempfile.mkdtemp(prefix="srtb_fsck_self_")

    def fresh(tag: str) -> tuple[str, str, str]:
        d = os.path.join(base, tag)
        os.makedirs(d)
        mpath, ckpath = _build_run_dir(d)
        return d, mpath, ckpath

    # (0) the untouched dir must pass — the gate is not just failing
    # everything
    d, mpath, ckpath = fresh("clean")
    rep = fsck(mpath, ckpath)
    if not rep["clean"]:
        failures.append(f"clean synthetic run did not verify: {rep}")

    # (a) forged WAL CRC: flip one byte inside a record body
    d, mpath, ckpath = fresh("forge")
    with open(mpath, "rb+") as f:
        data = f.read()
        i = data.index(b'"commit"')
        f.seek(i)
        f.write(b'"cOmmit"')
    rep = fsck(mpath, ckpath)
    if rep["clean"]:
        failures.append("forged WAL CRC went unnoticed")

    # (b) a committed artifact deleted out from under the manifest
    d, mpath, ckpath = fresh("missing")
    os.unlink(os.path.join(d, "out_100.bin"))
    rep = fsck(mpath, ckpath)
    if rep["clean"]:
        failures.append("deleted committed artifact went unnoticed")

    # (c) checkpoint ahead of the manifest: rewrite the checkpoint
    # file claiming more progress than the manifest ever sealed
    d, mpath, ckpath = fresh("ahead")
    StreamCheckpoint(ckpath).update(99, 1 << 20)
    rep = fsck(mpath, ckpath)
    if rep["clean"]:
        failures.append("checkpoint ahead of the manifest went "
                        "unnoticed")

    # (d) content corruption at unchanged size (the deep CRC check)
    d, mpath, ckpath = fresh("bitrot")
    p = os.path.join(d, "out_100.bin")
    with open(p, "rb+") as f:
        f.seek(3)
        b = f.read(1)
        f.seek(3)
        f.write(bytes([b[0] ^ 0xFF]))
    rep = fsck(mpath, ckpath)
    if rep["clean"]:
        failures.append("flipped artifact byte (same size) went "
                        "unnoticed")

    shutil.rmtree(base, ignore_errors=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fsck",
        description="verify/repair a run's durable-output invariants "
                    "(see srtb_tpu_torch/tools/fsck.py)")
    ap.add_argument("manifest", nargs="?",
                    help="run-manifest WAL path (Config.run_manifest_path)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint state file to cross-check "
                         "(Config.checkpoint_path)")
    ap.add_argument("--repair", action="store_true",
                    help="truncate the torn WAL tail, roll back "
                         "uncommitted intents/appends, rewrite a "
                         "checkpoint that ran ahead of the manifest")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    ap.add_argument("--selftest", action="store_true",
                    help="prove the verifier catches a forged CRC, a "
                         "deleted committed artifact and a checkpoint "
                         "ahead of the manifest")
    args = ap.parse_args(argv)

    if args.selftest:
        fails = selftest()
        for f in fails:
            print(f"fsck selftest: {f}", file=sys.stderr)
        print("fsck selftest: "
              + ("FAILED" if fails else
                 "OK — forged CRC, deleted artifact, bit rot and a "
                 "checkpoint ahead of the manifest all fail the check"))
        return EXIT_ERRORS if fails else EXIT_CLEAN

    if not args.manifest:
        ap.print_usage(sys.stderr)
        return EXIT_UNVERIFIABLE
    try:
        rep = fsck(args.manifest, args.checkpoint, repair=args.repair)
    except FileNotFoundError:
        print(f"fsck: manifest {args.manifest} does not exist",
              file=sys.stderr)
        return EXIT_UNVERIFIABLE
    if args.format == "json":
        print(json.dumps(rep, sort_keys=True))
    else:
        state = "clean" if rep["clean"] else "NOT CLEAN"
        print(f"fsck {rep['manifest']}: {state} — {rep['records']} "
              f"record(s), {rep['complete_groups']}/{rep['groups']} "
              f"group(s) complete, checkpoint floor "
              f"{rep['checkpoint_floor']}")
        for e in rep["errors"]:
            print(f"  error: {e}")
        for e in rep["loss"]:
            print(f"  LOSS: {e}")
        for r in rep["repaired"]:
            print(f"  repaired: {r}")
    return EXIT_CLEAN if rep["clean"] else EXIT_ERRORS


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
