"""Output writers: candidate capture (.bin/.npy/.tim) and write-all mode
(port of ``srtb_tpu/io/writers.py``).

Files are byte-compatible with the reference's:
- ``<prefix><counter>.bin``      raw baseband bytes of the segment
  (ref: write_signal_pipe.hpp:159-206);
- ``<prefix><counter>.<i>.npy``  complex64 waterfall [freq_bins, time]
  of stream i (ref: write_signal_pipe.hpp:209-246);
- ``<prefix><counter>.<boxcar>.tim``  float32 boxcar time series, and
  ``<prefix><counter>.s<stream>.<boxcar>.tim`` when a segment holds more
  than one stream (ref: write_signal_pipe.hpp:249-280);
- the extra artifacts a search mode's result names (``extra_artifacts``:
  the periodicity mode's ``<prefix><counter>[.s<stream>].fold.npy`` and
  ``.cand.json``), after the series, in the same transaction;
- the "piggybank" policy writes a negative segment that lies within 0.45
  segment of a recent positive (real-time input only, an empty
  ``input_file_path``: the other polarization's receiver, ref:
  write_signal_pipe.hpp:77-140);
- ``<prefix>stream0.bin``      every segment's baseband (all its
  interleaved streams) minus the reserved tail, appended
  (``WriteAllSink``, ref: write_file_pipe.hpp:41-94).

Every candidate file is written to ``<path>.srtb_tmp`` and renamed into
place, so a reader never sees a torn candidate; a run that died between
the two leaves an orphan temp, which :func:`recover_orphan_temps` sweeps
at the next start.

With a run manifest bound (``bind_manifest``, ``io/manifest.py``) every
artifact logs its intent before its temp write and its commit (length,
content CRC32) once it is published, under the ``(stream, segment,
sink)`` key the pipeline sets per push (``set_manifest_key``).  A
synchronous candidate writer publishes one segment's artifacts together
behind one publish barrier (``manifest.sync``); the writer pool runs the
barrier at submit and the commit once the job's bytes are on disk.
``WriteAllSink`` logs each append with the file's length before it, so
recovery can cut a torn append back to the committed prefix.
"""

from __future__ import annotations

import io
import os
import time
import zlib
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.pipeline.work import (NO_UDP_PACKET_COUNTER,
                                          SegmentResultWork)
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

TMP_SUFFIX = ".srtb_tmp"


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array.  A CUDA
    tensor is copied on the calling thread's current stream."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def recover_orphan_temps(prefix: str,
                         min_age_s: float = 60.0) -> list[str]:
    """Start-up sweep: remove ``<prefix>*.srtb_tmp`` orphans left by a run
    that died between a temp write and its rename; returns the removed
    paths.  Only temps older than ``min_age_s`` go: a fresh one may
    belong to a live writer sharing the prefix."""
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    removed = []
    try:
        names = os.listdir(d)
    except OSError:
        return removed
    now = time.time()
    for name in names:
        if name.startswith(base) and name.endswith(TMP_SUFFIX):
            p = os.path.join(d, name)
            try:
                if now - os.path.getmtime(p) < min_age_s:
                    log.warning(f"[recover] leaving fresh temp {p} "
                                "(possibly a live writer's)")
                    continue
                os.unlink(p)
                removed.append(p)
            except OSError as e:
                log.warning(f"[recover] cannot remove orphan {p}: {e}")
    if removed:
        metrics.add("orphan_temps_removed", len(removed))
        log.warning(f"[recover] removed {len(removed)} orphaned temp "
                    f"file(s) from an interrupted run: "
                    f"{[os.path.basename(p) for p in removed]}")
    return removed


def fsync_dir(path: str) -> None:
    """fsync the directory holding ``path``, so that a rename survives
    power loss.  Best effort: a filesystem that refuses directory fds
    keeps the rename-only guarantee."""
    d = os.path.dirname(path) or "."
    try:
        fd = os.open(d, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError as e:
        log.debug(f"[writers] cannot open dir {d} for fsync: {e}")
        return
    try:
        os.fsync(fd)
    except OSError as e:
        log.debug(f"[writers] dir fsync of {d} failed: {e}")
    finally:
        os.close(fd)


# crash-window steering hook of the durability harnesses
# (tools/crash_soak.py, the tests): when set, called with the
# destination path after the temp write and before the rename, so a kill
# landing inside it is a deterministic mid-rename crash.  None in
# production (one global read a write).
_PRE_RENAME_HOOK = None


def atomic_write(path: str, payload, *, fsync: bool = False,
                 pre_rename=None) -> None:
    """Crash-consistent write: temp + flush (+ fdatasync) + atomic rename
    (+ the directory's fsync, with the same ``fsync`` knob).  A failed
    write drops its temp.  ``pre_rename`` is the manifest's publish
    barrier (``RunManifest.sync``), run between the temp write and the
    rename.  The native pool (native/file_writer.cpp) runs the same
    sequence with the same suffix."""
    tmp = path + TMP_SUFFIX
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            if fsync:
                os.fdatasync(f.fileno())
        if pre_rename is not None:
            pre_rename()
        if _PRE_RENAME_HOOK is not None:
            _PRE_RENAME_HOOK(path)
        os.replace(tmp, path)
        if fsync:
            fsync_dir(path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # never created
        raise


def manifest_stage(manifest, key, path: str, data: np.ndarray):
    """Stage one atomic artifact write against the run manifest: log the
    intent now, before any byte reaches the temp file, and return the
    commit callback to fire once the rename has published the artifact
    (synchronously, or from the writer pool's completion poll).  The
    content CRC32 (the deep fsck check) is skipped with
    ``manifest_hash = 0``.  None when no manifest is bound."""
    if manifest is None or key is None:
        return None
    buf = np.ascontiguousarray(data)
    length = int(buf.nbytes)
    crc = zlib.crc32(buf) if manifest.hash_content else None
    manifest.intent(key, path)

    def commit():
        manifest.commit(key, path, length, crc)

    return commit


def stage_write(path: str, payload, *, fsync: bool = False) -> str:
    """The first half of :func:`atomic_write`: the temp (+ fdatasync),
    not published.  Returns the temp's path; the caller renames after
    its publish barrier, so one barrier covers a segment's artifacts
    (``WriteSignalSink._publish_staged``)."""
    tmp = path + TMP_SUFFIX
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            if fsync:
                os.fdatasync(f.fileno())
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # never created
        raise
    return tmp


def _npy_header(shape: tuple) -> bytes:
    """The .npy header np.save writes for a C-ordered complex64 array of
    ``shape`` (format 1.0, or 2.0 when the header outgrows 1.0's)."""
    d = {"descr": np.lib.format.dtype_to_descr(np.dtype(np.complex64)),
         "fortran_order": False, "shape": tuple(int(n) for n in shape)}
    bio = io.BytesIO()
    try:
        np.lib.format.write_array_header_1_0(bio, d)
    except ValueError:
        bio = io.BytesIO()
        np.lib.format.write_array_header_2_0(bio, d)
    return bio.getvalue()


def _npy_bytes(wf, pool=None) -> np.ndarray:
    """A complex64 waterfall (a tensor on any device, or an array) in .npy
    format as one uint8 buffer, byte for byte what np.save writes (the
    reference writes .npy via cnpy, write_signal_pipe.hpp:243-244).  The
    data is copied from the card straight into the buffer (on the calling
    thread's current stream); a writer pool then copies the buffer again
    at submit, a second host copy.  The buffer comes from ``pool`` (the
    caller releases it) or is a new array."""
    header = _npy_header(tuple(wf.shape))
    h, nbytes = len(header), 8 * int(np.prod(wf.shape))
    buf = (pool.acquire(h + nbytes, zero=False) if pool is not None
           else np.empty(h + nbytes, dtype=np.uint8))
    buf[:h] = np.frombuffer(header, dtype=np.uint8)
    if isinstance(wf, torch.Tensor):
        src = torch.view_as_real(wf.detach().to(torch.complex64)
                                 .contiguous()).reshape(-1).view(torch.uint8)
        torch.from_numpy(buf[h:]).copy_(src)
    else:
        buf[h:] = np.ascontiguousarray(wf, dtype=np.complex64).view(
            np.uint8).reshape(-1)
    return buf


def _npy_array_bytes(arr: np.ndarray) -> np.ndarray:
    """A host array in .npy format as one uint8 buffer, what ``np.save``
    writes (the reference's generic ``_npy_bytes``)."""
    bio = io.BytesIO()
    np.save(bio, arr)
    return np.frombuffer(bio.getvalue(), dtype=np.uint8)


@dataclass
class CandidateFiles:
    """Paths written for one positive segment."""
    bin_path: str
    npy_paths: list
    tim_paths: list
    # the periodicity mode only: <base>[.sN].fold.npy folded profiles and
    # <base>[.sN].cand.json candidate tables
    fold_paths: list = field(default_factory=list)


class WriteSignalSink:
    """Candidate writer with the reference's piggybank capture policy.

    With ``writer_pool`` (an :class:`~srtb_tpu_torch.io.native_writer.
    AsyncWriterPool`) the writes are queued to its threads and this sink
    never blocks on disk (the reference's thread pools,
    write_signal_pipe.hpp:159-206); call ``drain()`` before reading the
    files back.  Without one, every write is synchronous."""

    # the degradation ladder skips this sink at level 2
    # (resilience/degrade.py)
    sheddable = True

    def __init__(self, cfg: Config, writer_pool=None, host_pool=None):
        self.cfg = cfg
        self.pool = writer_pool
        # buffers for the .npy payloads (pinned on the card: the fast
        # copy from the device), back to the pool once written or queued
        self.host_pool = host_pool
        # paths queued to the pool but maybe not written yet
        self._assigned_paths: set[str] = set()
        self.recent_positive_timestamps: deque[int] = deque()
        self.recent_negative_works: deque[SegmentResultWork] = deque()
        self.written: list[CandidateFiles] = []
        # the run manifest (None: off) and the (stream, segment, sink) key
        # the pipeline sets before each push
        self.manifest = None
        self._manifest_key = None
        # the open segment transaction of a synchronous writer with a
        # manifest: (path, temp, fsync, commit) of each staged artifact,
        # published together behind one barrier; None when none is open
        self._tx_staged = None
        # whether the last push wrote an artifact (the pipeline seals a
        # manifest "done" record only then)
        self.last_push_wrote = False
        # check directory writability up front
        # (ref: write_signal_pipe.hpp:62-75)
        check_path = cfg.baseband_output_file_prefix + ".check"
        with open(check_path, "wb"):
            pass
        os.unlink(check_path)

    def bind_manifest(self, manifest) -> None:
        self.manifest = manifest

    def set_manifest_key(self, key) -> None:
        self._manifest_key = key

    def _overlap_window_ns(self) -> float:
        # 0.45 of a segment duration, in ns (ref: write_signal_pipe.hpp:84-86)
        return (0.45 * 1e9 * self.cfg.baseband_input_count
                / self.cfg.baseband_sample_rate)

    def _overlaps_recent_positive(self, timestamp: int) -> bool:
        w = self._overlap_window_ns()
        return any(abs(timestamp - t) < w
                   for t in self.recent_positive_timestamps)

    def push(self, work: SegmentResultWork, has_signal: bool) -> None:
        """Feed one processed segment; writes to disk when warranted."""
        self.last_push_wrote = False
        real_time = self.cfg.input_file_path == ""
        w = self._overlap_window_ns()
        ts = work.segment.timestamp
        # clean outdated positives (ref: write_signal_pipe.hpp:88-94)
        while (real_time and self.recent_positive_timestamps
               and ts - self.recent_positive_timestamps[0] > 5 * w):
            self.recent_positive_timestamps.popleft()
        to_write = None
        if has_signal:
            self.recent_positive_timestamps.append(ts)
            to_write = work
        elif real_time and self._overlaps_recent_positive(ts):
            # other-polarization piggyback (ref: write_signal_pipe.hpp:102-115)
            to_write = work
        elif real_time:
            self.recent_negative_works.append(work)
        # re-check old negatives against new positives (ref: 122-140)
        if real_time and to_write is None and self.recent_negative_works:
            work_2 = self.recent_negative_works.popleft()
            if self._overlaps_recent_positive(work_2.segment.timestamp):
                to_write = work_2
        if to_write is not None:
            self._write(to_write)
        # bound the negative queue to one overlap window's worth
        while len(self.recent_negative_works) > 16:
            self.recent_negative_works.popleft()

    def _write(self, work: SegmentResultWork) -> None:
        counter = work.segment.udp_packet_counter
        if counter == NO_UDP_PACKET_COUNTER:
            counter = work.segment.timestamp
        base = self.cfg.baseband_output_file_prefix + str(counter)
        self.last_push_wrote = True
        log.info(f"[write_signal] begin writing, file_counter = {counter}")
        # a synchronous writer with a manifest opens the segment's
        # transaction: temps first, then one barrier and the renames
        if self.manifest is not None and self._manifest_key is not None \
                and self.pool is None:
            self._tx_staged = []
        try:
            self._write_artifacts(work, base)
            self._publish_staged()
        except BaseException:
            self._tx_abort()
            raise
        log.info(f"[write_signal] finished writing, file_counter = {counter}")

    def _write_artifacts(self, work: SegmentResultWork, base: str) -> None:
        bin_path = base + ".bin"
        # the baseband is fdatasync'd, as the reference's is
        # (write_signal_pipe.hpp:187-197); the spectra are not
        self._write_bytes(bin_path, np.ascontiguousarray(work.segment.data),
                          fsync=True)

        npy_paths = []
        if work.waterfall is not None:
            wf = work.waterfall
            if wf.ndim == 2:
                wf = wf[None]
            for i in range(wf.shape[0]):
                # the first free index (ref: 230-235); with a pool, the
                # queued but maybe unwritten paths count as taken, and so
                # do the open transaction's staged ones
                staged = {p for p, *_ in self._tx_staged or ()}
                j = i
                while (os.path.exists(f"{base}.{j}.npy")
                       or f"{base}.{j}.npy" in self._assigned_paths
                       or f"{base}.{j}.npy" in staged):
                    j += 1
                path = f"{base}.{j}.npy"
                payload = _npy_bytes(wf[i], self.host_pool)
                try:
                    # written, or copied by the pool at submit
                    self._write_bytes(path, payload)
                finally:
                    if self.host_pool is not None:
                        self.host_pool.release(payload)
                npy_paths.append(path)

        tim_paths = []
        if work.detect is not None:
            counts = to_host(work.detect.signal_counts)
            series = to_host(work.detect.boxcar_series)
            if counts.ndim == 1:
                counts = counts[None]
                series = series[None]
            multi = counts.shape[0] > 1
            for s in range(counts.shape[0]):
                for bi, b in enumerate(work.detect.boxcar_lengths):
                    if counts[s, bi] > 0:
                        path = (f"{base}.s{s}.{b}.tim" if multi
                                else f"{base}.{b}.tim")
                        valid = series.shape[-1] - (b if b > 1 else 0)
                        self._write_bytes(
                            path, series[s, bi, :valid].astype("<f4"))
                        tim_paths.append(path)

        # a registered mode's own artifacts (the periodicity mode's folded
        # profiles and candidate table, pipeline/periodicity.py): (path,
        # array) pairs that ride the same temp + rename (+ manifest)
        # transaction as every other artifact
        fold_paths = []
        extra = (getattr(work.detect, "extra_artifacts", None)
                 if work.detect is not None else None)
        if extra is not None:
            for path, payload in extra(base):
                if path.endswith(".npy"):
                    payload = _npy_array_bytes(payload)
                self._write_bytes(path, payload)
                fold_paths.append(path)
        self.written.append(CandidateFiles(bin_path, npy_paths, tim_paths,
                                           fold_paths))

    def _publish_staged(self) -> None:
        """Close the segment's transaction: one publish barrier (every
        pending intent durable), then rename and commit each staged
        artifact.  A crash before the barrier leaves only temps, between
        it and a rename temps with durable intents (both rolled back),
        after a rename a committed or regenerable artifact: never an
        untracked final file."""
        staged, self._tx_staged = self._tx_staged, None
        if not staged:
            return
        self.manifest.sync()
        try:
            for path, tmp, fsync, commit in staged:
                if _PRE_RENAME_HOOK is not None:
                    _PRE_RENAME_HOOK(path)
                os.replace(tmp, path)
                if fsync:
                    fsync_dir(path)
                if commit is not None:
                    commit()
        except BaseException:
            for _path, tmp, _fsync, _commit in staged:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass  # already renamed
            raise

    def _tx_abort(self) -> None:
        staged, self._tx_staged = self._tx_staged, None
        for _path, tmp, _fsync, _commit in staged or ():
            try:
                os.unlink(tmp)
            except OSError:
                pass  # this artifact never reached its temp write

    def _write_bytes(self, path: str, data: np.ndarray, *,
                     fsync: bool = False) -> None:
        commit = manifest_stage(self.manifest, self._manifest_key, path,
                                data)
        barrier = self.manifest.sync if commit is not None else None
        if self._tx_staged is not None:
            tmp = stage_write(path, data, fsync=fsync)
            self._tx_staged.append((path, tmp, fsync, commit))
            return
        if self.pool is not None:
            if path in self._assigned_paths:
                # the same target queued again: flush first, so that the
                # later write wins instead of racing
                self.pool.drain()
                self._assigned_paths.clear()
            self._assigned_paths.add(path)
            self.pool.submit(path, data, fsync=fsync, on_done=commit,
                             pre_publish=barrier)
            return
        atomic_write(path, data, fsync=fsync, pre_rename=barrier)
        if commit is not None:
            commit()

    def drain(self) -> None:
        """Wait for queued writes to land (a no-op when synchronous);
        raises ``RuntimeError`` if any of them failed, as the synchronous
        path would have raised at the failing write."""
        if self.pool is not None:
            self.pool.drain()
            self._assigned_paths.clear()
            self.pool.raise_new_errors(
                f"candidate prefix {self.cfg.baseband_output_file_prefix}")


class WriteAllSink:
    """Unconditional append of each segment's baseband minus the reserved
    tail to one file (ref: pipeline/write_file_pipe.hpp:41-94, selected
    by ``baseband_write_all``).  Synchronous, as in the reference.  With a
    manifest each append logs its intent with the file's length before
    it, and its commit once written: the committed prefix."""

    sheddable = True  # the degradation ladder skips it at level 2

    # every push appends: the pipeline always seals its "done" record
    last_push_wrote = True

    def __init__(self, cfg: Config, reserved_bytes: int):
        self.reserved_bytes = reserved_bytes
        self.path = cfg.baseband_output_file_prefix + "stream0.bin"
        self._f = open(self.path, "ab")
        self.manifest = None
        self._manifest_key = None
        # the file's length after the appends made so far
        self._append_off = 0

    def bind_manifest(self, manifest) -> None:
        self.manifest = manifest
        # recovery already cut a torn tail: the size is the committed
        # prefix
        self._append_off = os.path.getsize(self.path)

    def set_manifest_key(self, key) -> None:
        self._manifest_key = key

    def push(self, work: SegmentResultWork, has_signal: bool = False) -> None:
        data = work.segment.data
        end = len(data) - self.reserved_bytes
        if end <= 0:
            end = len(data)
        chunk = np.ascontiguousarray(data[:end])
        m, key = self.manifest, self._manifest_key
        if m is not None and key is not None:
            off = self._append_off
            crc = zlib.crc32(chunk) if m.hash_content else None
            m.intent(key, self.path, mode="append", offset=off)
        self._f.write(chunk)
        self._f.flush()
        if m is not None and key is not None:
            m.commit(key, self.path, chunk.nbytes, crc, offset=off)
            self._append_off = off + chunk.nbytes

    def drain(self) -> None:
        """Nothing is queued: every append is written at its push."""

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
