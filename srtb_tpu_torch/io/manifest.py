"""Durable exactly-once outputs: the run-manifest commit log (port of
``srtb_tpu/io/manifest.py``; the records, their CRC and the recovery
rules are the reference's, byte for byte, so either package's ``fsck``
verifies the other's run directory).

The manifest guards against process death (``kill -9``, node
preemption, power loss) between a sink write and the checkpoint update.

The manifest is an append-only, fsync'd JSONL write-ahead log living
next to the run's outputs (``Config.run_manifest_path``).  Every
record carries a CRC32 of its own canonical JSON, so a torn tail (the
record being appended when the process died) is detected and truncated
on recovery instead of being half-parsed.  Artifacts are keyed by
``(data_stream_id, segment index, sink name)`` — the *resume-continuous
drain index*, the same numbering the checkpoint counts — and follow an
intent→commit protocol:

- ``intent``     logged (and fsync'd) BEFORE a sink starts the temp
  write, so no artifact can reach its final name without the WAL
  knowing about it;
- ``commit``     logged after the atomic rename (or ordered append)
  published the artifact, with its length and content CRC32;
- ``done``       logged when a sink finished its whole push for one
  segment — the replay-skip marker;
- ``ckpt``       the checkpoint's consistency point: written by
  ``StreamCheckpoint.update`` BEFORE the checkpoint file itself, so
  the checkpoint can never claim progress the manifest hasn't sealed
  ("checkpoint ahead of manifest" is therefore always corruption, and
  ``tools/fsck.py`` flags it).

Recovery (:func:`recover`, run by ``Pipeline.__init__`` when the
manifest is armed) reconciles WAL vs filesystem:

- truncate the torn WAL tail at the first bad CRC;
- a ``(stream, seg, sink)`` group is **complete** when its ``done``
  marker exists, every intent has a commit, and every committed
  artifact still exists with the committed size — complete groups form
  the durable done-set, and a resumed run SKIPS their sink pushes
  (``replayed_skips``) instead of duplicating them under fresh names;
- any other group at/after the last checkpoint is **rolled back
  whole** (temp files unlinked, renamed-but-uncommitted finals
  unlinked, torn appends truncated to the committed prefix —
  ``rolled_back_intents``): the resumed run re-drains that segment and
  regenerates the group from scratch, exactly once;
- an incomplete or missing group BELOW the checkpoint cannot be
  regenerated (the resume will never re-drain it) — that is real data
  loss and is flagged loudly, never silently repaired.

``recovered_segments`` counts distinct segments whose complete groups
lie at/after the checkpoint — the segments rescued from the
duplicate-on-resume window.  It is counted, with
``rolled_back_intents``, ``manifest_loss_flags`` and the pipeline's
``replayed_skips``, in the metrics registry, as the reference counts
them; the :class:`RunManifest` and the :class:`RecoveryReport` keep the
same counts, and the pipeline copies them into ``PipelineStats.extras``.
Every WAL record also lands on the flight recorder (``manifest.intent``,
``commit``, ``done``, ``ckpt``; ``manifest.loss`` for each loss flag), on
the thread's current trace.

Trust ends at the first bad CRC.  A record forged or bit-rotted in the
MIDDLE of the WAL truncates everything after it: later commits are
forgotten, their segments re-drain on resume (the checkpoint records
after the corruption truncate with them), and artifacts those
forgotten commits had published become UNTRACKED files — detected by
fsck's torn-WAL error and the crash-soak union gate, but not deleted
(recovery only ever removes files the valid WAL prefix names).  That
is the deliberate boundary: crashes are healed automatically,
mid-file corruption is detected loudly and left to the operator.

The WAL grows across resumes of one run (recovery re-reads it whole);
it belongs to ONE logical run in ONE output directory — start fresh
runs with a fresh manifest path.  Compaction is future work.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from dataclasses import dataclass, field

from srtb_tpu_torch.utils import events
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

# same temp suffix as io/writers.atomic_write: an uncommitted intent's
# in-flight temp is <path> + TMP_SUFFIX
TMP_SUFFIX = ".srtb_tmp"


# ----------------------------------------------------------------
# record encoding: one JSON object per line, "c" = CRC32 of the
# canonical JSON (sorted keys, compact separators) of the record
# WITHOUT "c"
# ----------------------------------------------------------------

def record_crc(rec: dict) -> int:
    """CRC32 of a record's canonical JSON form (shared with the
    checkpoint file's integrity field, pipeline/checkpoint.py)."""
    body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(body.encode())


def encode_record(rec: dict) -> bytes:
    out = dict(rec)
    out["c"] = record_crc(rec)
    return (json.dumps(out, sort_keys=True, separators=(",", ":"))
            + "\n").encode()


def decode_record(line: bytes) -> dict | None:
    """Parse + CRC-verify one WAL line; None = torn/forged."""
    try:
        rec = json.loads(line)
    except ValueError:
        return None
    if not isinstance(rec, dict):
        return None
    crc = rec.pop("c", None)
    if crc is None or record_crc(rec) != crc:
        return None
    return rec


# ----------------------------------------------------------------
# scan: pure read of a WAL into structured state
# ----------------------------------------------------------------

@dataclass
class Artifact:
    """Latest intent/commit state of one path within one group."""
    path: str                   # absolute
    mode: str = "atomic"        # "atomic" | "append"
    committed: bool = False
    length: int | None = None
    crc32: int | None = None
    offset: int | None = None   # append: file length before the append


@dataclass
class Group:
    """One (stream, seg, sink) artifact group."""
    artifacts: dict = field(default_factory=dict)  # path -> Artifact
    done: bool = False


@dataclass
class ManifestScan:
    path: str
    groups: dict = field(default_factory=dict)   # key tuple -> Group
    checkpoints: list = field(default_factory=list)  # ckpt records in order
    records: int = 0
    valid_bytes: int = 0
    total_bytes: int = 0
    bad_line: int | None = None     # 1-based line of the first bad record

    @property
    def torn(self) -> bool:
        return self.valid_bytes < self.total_bytes

    @property
    def last_checkpoint(self) -> dict | None:
        return self.checkpoints[-1] if self.checkpoints else None

    def checkpoint_floor(self) -> int:
        """segments_done of the last ckpt record (0 when none): every
        group below this index is sealed — complete by contract."""
        last = self.last_checkpoint
        return int(last["segments_done"]) if last else 0


def _abs_path(manifest_path: str, p: str) -> str:
    if os.path.isabs(p):
        return p
    return os.path.join(os.path.dirname(os.path.abspath(manifest_path)), p)


def _rel_path_from(base: str, p: str) -> str:
    """Store paths relative to the manifest's directory when possible,
    so a relocated run directory stays verifiable.  ``base`` is the
    pre-computed ``dirname(abspath(manifest))`` — this runs per record
    on the sink path, so the fast prefix check comes first."""
    if p.startswith(base + os.sep) and ".." not in p and "//" not in p:
        return p[len(base) + 1:]
    ap = os.path.abspath(p)
    if os.path.commonpath([base, ap]) == base:
        return os.path.relpath(ap, base)
    return ap


def scan_manifest(path: str) -> ManifestScan:
    """Read a WAL into per-group state, stopping at the first record
    whose CRC fails (everything after an invalid record is untrusted —
    the torn-tail truncation point)."""
    scan = ManifestScan(path=path)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return scan
    scan.total_bytes = len(data)
    offset = 0
    lineno = 0
    for raw in data.split(b"\n"):
        if not raw:
            offset += 1  # the newline itself (or trailing empty slice)
            continue
        lineno += 1
        rec = decode_record(raw)
        if rec is None:
            scan.bad_line = lineno
            break
        offset += len(raw) + 1
        scan.valid_bytes = min(offset, scan.total_bytes)
        scan.records += 1
        t = rec.get("t")
        if t in ("intent", "commit"):
            key = (int(rec["stream"]), int(rec["seg"]), str(rec["sink"]))
            grp = scan.groups.setdefault(key, Group())
            p = _abs_path(path, rec["path"])
            art = grp.artifacts.get(p)
            if art is None:
                art = grp.artifacts[p] = Artifact(path=p)
            art.mode = rec.get("mode", art.mode)
            if rec.get("off") is not None:
                art.offset = int(rec["off"])
            if t == "commit":
                art.committed = True
                art.length = int(rec["len"])
                art.crc32 = (int(rec["crc32"])
                             if rec.get("crc32") is not None else None)
            else:
                # a fresh intent for an already-committed path is a
                # retry re-entry; the earlier commit stands
                if not art.committed and rec.get("len") is not None:
                    art.length = int(rec["len"])
        elif t == "done":
            key = (int(rec["stream"]), int(rec["seg"]), str(rec["sink"]))
            scan.groups.setdefault(key, Group()).done = True
        elif t == "ckpt":
            scan.checkpoints.append(rec)
        # "run" records (run/resume stamps) and "canary" flags carry no
        # recovery state
    return scan


def append_committed_lengths(scan: ManifestScan,
                             complete_keys=None) -> dict:
    """path -> durable committed length for append-mode artifacts.
    With ``complete_keys`` given, only appends belonging to those
    groups count (an incomplete group's committed append is rolled
    back with the rest of its group)."""
    out: dict[str, int] = {}
    for key, grp in scan.groups.items():
        if complete_keys is not None and key not in complete_keys:
            continue
        for art in grp.artifacts.values():
            if art.mode == "append" and art.committed:
                end = int(art.offset or 0) + int(art.length or 0)
                out[art.path] = max(out.get(art.path, 0), end)
    for key, grp in scan.groups.items():
        for art in grp.artifacts.values():
            if art.mode == "append":
                out.setdefault(art.path, 0)
    return out


def group_complete(grp: Group) -> bool:
    """done marker present AND every intent committed (artifact
    existence is checked separately — it needs the filesystem)."""
    return grp.done and all(a.committed for a in grp.artifacts.values())


# ----------------------------------------------------------------
# recovery
# ----------------------------------------------------------------

@dataclass
class RecoveryReport:
    done: set = field(default_factory=set)  # complete (stream,seg,sink)
    last_checkpoint: dict | None = None
    truncated_bytes: int = 0
    rolled_back: list = field(default_factory=list)   # action strings
    rolled_back_intents: int = 0
    missing: list = field(default_factory=list)       # loss, flagged
    recovered_segments: int = 0


def _artifact_on_disk(art: Artifact) -> bool:
    try:
        st = os.stat(art.path)
    except OSError:
        return False
    return art.length is None or st.st_size == art.length


def recover(manifest_path: str, apply: bool = True,
            checkpoint_floor_hint: int = 0) -> RecoveryReport:
    """Reconcile WAL vs filesystem (module docstring has the rules).
    ``apply=False`` reports without touching the filesystem (fsck has
    its own report-oriented pass on the same shared scan/group
    helpers; this flag serves tests and dry runs).

    ``checkpoint_floor_hint`` is the checkpoint FILE's
    ``segments_done`` (the resume authority).  Normally it can never
    exceed the manifest's own floor (update() seals the WAL first) —
    but a truncated/corrupted WAL can FORGET ckpt records, and
    rolling back 'incomplete' groups in that gap would destroy
    published artifacts the resume will never re-drain.  The
    effective floor is the max of both, so the gap is flagged as
    possible loss instead of deleted."""
    report = RecoveryReport()
    scan = scan_manifest(manifest_path)
    report.last_checkpoint = scan.last_checkpoint
    floor = scan.checkpoint_floor()
    if checkpoint_floor_hint > floor:
        if scan.records:
            log.error(
                f"[manifest] checkpoint file claims "
                f"{checkpoint_floor_hint} segment(s) done but the WAL "
                f"only seals {floor}: treating the gap as sealed — "
                "artifacts there are flagged, never rolled back "
                "(corrupt/truncated WAL, or a checkpoint from another "
                "run)")
        floor = checkpoint_floor_hint

    if scan.torn:
        report.truncated_bytes = scan.total_bytes - scan.valid_bytes
        if apply:
            with open(manifest_path, "rb+") as f:
                f.truncate(scan.valid_bytes)
            log.warning(
                f"[manifest] truncated torn WAL tail: "
                f"{report.truncated_bytes} byte(s) after record "
                f"{scan.records} failed CRC/parse")

    # pass 1: classify groups (existence check included — a committed
    # artifact that vanished invalidates its group so the resume can
    # regenerate it where the checkpoint allows)
    complete: set = set()
    for key, grp in scan.groups.items():
        if not group_complete(grp):
            continue
        atomic_ok = all(_artifact_on_disk(a)
                        for a in grp.artifacts.values()
                        if a.mode == "atomic")
        if atomic_ok:
            complete.add(key)
        elif key[1] < floor:
            # below the checkpoint the segment will never re-drain:
            # this is unrecoverable loss, flagged, files untouched
            gone = [a.path for a in grp.artifacts.values()
                    if a.mode == "atomic" and not _artifact_on_disk(a)]
            report.missing.append(
                f"committed artifact(s) missing under checkpoint "
                f"(segment {key[1]}, sink {key[2]}): "
                f"{[os.path.basename(p) for p in gone]}")

    # append files: the durable prefix is what COMPLETE groups committed
    append_targets = append_committed_lengths(scan, complete_keys=complete)

    # pass 2: roll back every group that is not complete and sits
    # at/after the checkpoint (the resume re-drains those segments)
    for key, grp in scan.groups.items():
        if key in complete:
            continue
        if key[1] < floor:
            if key not in complete and not group_complete(grp):
                report.missing.append(
                    f"incomplete artifact group under checkpoint "
                    f"(segment {key[1]}, sink {key[2]}): the manifest "
                    "ordering contract was violated upstream")
            continue
        for art in grp.artifacts.values():
            if art.mode == "append":
                continue  # handled via append_targets truncation below
            # counted per artifact actually on disk: the WAL keeps the
            # stale intent records forever, and recovery must not
            # re-report a rollback it already performed last startup
            rolled_this = False
            for p in (art.path + TMP_SUFFIX, art.path):
                if os.path.exists(p):
                    rolled_this = True
                    report.rolled_back.append(f"unlink {p}")
                    if apply:
                        try:
                            os.unlink(p)
                        except OSError as e:
                            log.warning(
                                f"[manifest] rollback cannot remove "
                                f"{p}: {e}")
            if rolled_this:
                report.rolled_back_intents += 1

    # pass 3: truncate append files to their committed prefix (rolls
    # back both torn appends and committed appends of incomplete
    # groups); a file SHORTER than the committed prefix is loss —
    # drop the groups it invalidates so a resume can regenerate the
    # ones the checkpoint still re-drains.
    #
    # Append paths with an incomplete group BELOW the effective floor
    # (a WAL that forgot commit records under a checkpoint — the hint
    # gap) are exempt from truncation entirely: bytes beyond the
    # surviving committed prefix may well BE that forgotten sealed
    # data, and the resume would never re-append it — flag, never cut.
    gap_paths = {
        art.path
        for key, grp in scan.groups.items()
        if key[1] < floor and key not in complete
        for art in grp.artifacts.values() if art.mode == "append"}
    for p, target in append_targets.items():
        try:
            size = os.path.getsize(p)
        except OSError:
            size = 0
        if size > target and p in gap_paths:
            report.missing.append(
                f"append file {os.path.basename(p)}: {size - target} "
                f"byte(s) beyond the surviving committed prefix belong "
                "to segment(s) sealed under the checkpoint but "
                "forgotten by the WAL — left untouched")
            continue
        if size > target:
            report.rolled_back.append(f"truncate {p} to {target}")
            report.rolled_back_intents += 1
            if apply:
                try:
                    with open(p, "rb+") as f:
                        f.truncate(target)
                except OSError as e:
                    log.warning(f"[manifest] rollback cannot truncate "
                                f"{p}: {e}")
        elif size < target:
            for key in sorted(complete):
                grp = scan.groups[key]
                bad = any(a.mode == "append" and a.path == p
                          and int(a.offset or 0) + int(a.length or 0)
                          > size
                          for a in grp.artifacts.values())
                if bad:
                    complete.discard(key)
                    msg = (f"append file {os.path.basename(p)} shorter "
                           f"than its committed prefix ({size} < "
                           f"{target}): segment {key[1]} sink {key[2]} "
                           "lost")
                    if key[1] < floor:
                        report.missing.append(msg)
                    else:
                        report.rolled_back.append(
                            f"drop {key} from done-set ({msg})")

    report.done = complete
    report.recovered_segments = len(
        {seg for (_s, seg, _k) in complete if seg >= floor})
    if report.rolled_back:
        log.warning(
            f"[manifest] rolled back {report.rolled_back_intents} "
            f"uncommitted intent(s) from an interrupted run: "
            f"{report.rolled_back}")
    if report.missing:
        metrics.add("manifest_loss_flags", len(report.missing))
    for msg in report.missing:
        events.emit("manifest.loss", trace=0, info=msg[:200])
        log.error(f"[manifest] DATA LOSS: {msg}")
    return report


# ----------------------------------------------------------------
# writer
# ----------------------------------------------------------------

class RunManifest:
    """Append-side of the WAL.  Thread-safe: sinks append from the
    sink-drain thread, commit callbacks fire from async writer-pool
    threads.

    Durability is BATCHED at the two points that actually need it
    (``fsync=True``): :meth:`sync` — the publish barrier a writer
    calls between its temp write and the atomic rename, making every
    pending intent durable before any artifact can reach its final
    name — and the ``ckpt`` record, which seals everything before it.
    Ordinary commits/done records are appended without their own
    fdatasync: losing them on power loss only means the artifact group
    reads uncommitted and is rolled back + regenerated on resume —
    never a duplicate, never silent loss.  (Append-mode artifacts need
    no barrier at all: bytes beyond the committed prefix are truncated
    by recovery whatever the WAL remembers.)  ``fsync=False`` drops
    even the two required syncs — process-death durability stays
    intact (the page cache survives a SIGKILL), only power loss can
    then leak an untracked renamed artifact.

    A manifest append failure RAISES: unlike the telemetry journal,
    the WAL is a correctness structure — continuing without it would
    silently forfeit exactly-once."""

    def __init__(self, path: str, fsync: bool = True,
                 hash_content: bool = True):
        self.path = path
        self.fsync = fsync
        # whether sinks should record artifact content CRC32s (the
        # deep fsck check; ~1 ms per dumped MB) — consulted by
        # io/writers.manifest_stage, not by the WAL itself
        self.hash_content = hash_content
        self._lock = threading.Lock()
        self._dirty = False
        self._base = os.path.dirname(os.path.abspath(path))
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "ab")
        # a crash can leave a final record whose bytes are complete
        # except the trailing newline (scan accepts it); appending
        # directly would concatenate the next record onto it and tear
        # BOTH — terminate the line first
        if self._f.tell() > 0:
            with open(path, "rb") as rf:
                rf.seek(-1, os.SEEK_END)
                if rf.read(1) != b"\n":
                    self._f.write(b"\n")
                    self._f.flush()
        self._done: set = set()
        # the recovery's counts (set by open) and the replayed pushes the
        # pipeline skipped against the done-set
        self.recovery = RecoveryReport()
        self.recovered_segments = 0
        self.rolled_back_intents = 0
        self.manifest_loss_flags = 0
        self.replayed_skips = 0

    def counters(self) -> dict:
        """The recovery and replay counts, as the pipeline reports them."""
        return {"recovered_segments": self.recovered_segments,
                "rolled_back_intents": self.rolled_back_intents,
                "manifest_loss_flags": self.manifest_loss_flags,
                "replayed_skips": self.replayed_skips}

    # -- open-with-recovery ----------------------------------------

    @classmethod
    def open(cls, path: str, fsync: bool = True,
             hash_content: bool = True,
             checkpoint_floor_hint: int = 0) -> "RunManifest":
        """Recover (truncate torn tail, roll back uncommitted groups,
        rebuild the done-set), then open for appending and stamp a
        run record.  The recovery's counts stay on the manifest:
        ``recovered_segments``, ``rolled_back_intents`` and
        ``manifest_loss_flags`` (the report is ``recovery``).
        ``checkpoint_floor_hint`` guards rollback against a WAL that
        forgot its ckpt records — see :func:`recover`."""
        existed = os.path.exists(path)
        report = recover(path, apply=True,
                         checkpoint_floor_hint=checkpoint_floor_hint) \
            if existed else RecoveryReport()
        m = cls(path, fsync=fsync, hash_content=hash_content)
        m._done = set(report.done)
        m.recovery = report
        m.recovered_segments = report.recovered_segments
        m.rolled_back_intents = report.rolled_back_intents
        m.manifest_loss_flags = len(report.missing)
        if report.rolled_back_intents:
            metrics.add("rolled_back_intents", report.rolled_back_intents)
        if report.recovered_segments:
            metrics.add("recovered_segments", report.recovered_segments)
            log.warning(
                f"[manifest] recovered {report.recovered_segments} "
                "committed segment(s) beyond the checkpoint; their "
                "sink pushes will be skipped on replay")
        m._append({"t": "run", "ts": time.time(),
                   "resume": bool(existed and report.done
                                  or (existed and report.last_checkpoint
                                      is not None))})
        return m

    # -- record appends --------------------------------------------

    def _append(self, rec: dict, durable: bool = False) -> None:
        line = encode_record(rec)
        with self._lock:
            if self._f is None:
                raise RuntimeError(
                    f"run manifest {self.path} is closed")
            self._f.write(line)
            self._f.flush()
            if durable and self.fsync:
                os.fdatasync(self._f.fileno())
                self._dirty = False
            else:
                self._dirty = True

    def sync(self) -> None:
        """The publish barrier: make every appended record durable.
        Writers call this between an artifact's temp write and its
        atomic rename — no artifact reaches its final name before the
        WAL durably knows the intent.  No-op when nothing is pending
        (consecutive renames batch their records into one fdatasync)
        or when ``fsync=False``."""
        if not self.fsync:
            return
        with self._lock:
            if self._f is None or not self._dirty:
                return
            os.fdatasync(self._f.fileno())
            self._dirty = False

    def _key_fields(self, key) -> dict:
        stream, seg, sink = key
        return {"stream": int(stream), "seg": int(seg),
                "sink": str(sink)}

    def intent(self, key, path: str, mode: str = "atomic",
               offset: int | None = None) -> None:
        rec = {"t": "intent", "path": _rel_path_from(self._base, path),
               "mode": mode, **self._key_fields(key)}
        if offset is not None:
            rec["off"] = int(offset)
        self._append(rec)
        events.emit("manifest.intent", seg=int(key[1]),
                    info=f"{key[2]}:{os.path.basename(path)}")

    def commit(self, key, path: str, length: int,
               crc32: int | None = None,
               offset: int | None = None) -> None:
        rec = {"t": "commit", "path": _rel_path_from(self._base, path),
               "len": int(length), **self._key_fields(key)}
        if crc32 is not None:
            rec["crc32"] = int(crc32)
        if offset is not None:
            rec["off"] = int(offset)
        self._append(rec)
        events.emit("manifest.commit", seg=int(key[1]),
                    info=f"{key[2]}:{os.path.basename(path)}")

    def sink_done(self, key) -> None:
        self._append({"t": "done", **self._key_fields(key)})
        with self._lock:
            self._done.add(tuple(key))
        events.emit("manifest.done", seg=int(key[1]), info=str(key[2]))

    def canary(self, stream: int, seg: int, abs_index: int,
               ok: bool = True) -> None:
        """Flag a pulse-injection canary segment (quality/canary.py):
        offline consumers can prove the quarantine — which drain indices
        carried a synthetic pulse, and whether each passed the
        sensitivity gate.  Carries no recovery state; the scanner (and
        fsck) skip it like the "run" stamp."""
        self._append({"t": "canary", "stream": int(stream),
                      "seg": int(seg), "abs": int(abs_index),
                      "ok": bool(ok)})
        events.emit("manifest.canary", seg=int(seg),
                    info=f"abs={int(abs_index)} ok={bool(ok)}")

    def checkpoint(self, segments_done: int,
                   file_offset_bytes: int) -> None:
        # the consistency point is always durable: it seals every
        # record before it, and the checkpoint file rename follows it
        self._append({"t": "ckpt", "segments_done": int(segments_done),
                      "offset": int(file_offset_bytes)}, durable=True)
        events.emit("manifest.ckpt", seg=int(segments_done),
                    info=f"offset={int(file_offset_bytes)}")

    # -- replay-skip query -----------------------------------------

    def is_done(self, key) -> bool:
        return tuple(key) in self._done

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                if self.fsync and self._dirty:
                    os.fdatasync(self._f.fileno())
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
