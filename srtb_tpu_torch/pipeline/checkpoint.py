"""Streaming checkpoint and resume (port of
``srtb_tpu/pipeline/checkpoint.py``).

A small JSON state file holds the logical file offset and the count of
drained segments, so a crashed or restarted file-mode run continues
where it stopped (``Config.checkpoint_path``; the pipeline hands the
offset to the file reader).  The file is the reference's, byte for byte:

- it carries a CRC32 of its canonical JSON (the run manifest's encoding,
  ``io/manifest.record_crc``), so a torn or bit-rotted checkpoint is
  detected instead of parsed; a file without one (the form before the
  CRC) is accepted as legacy;
- every update keeps the previous generation as ``<path>.bak``; a
  corrupt, unreadable or missing primary falls back to it with a
  warning (at worst one segment is repeated, and the run manifest's
  done-set makes the repeat idempotent); only when both generations are
  dead does the run restart from segment 0, logged as an error;
- an orphan ``<path>.tmp`` of an interrupted update is removed when the
  checkpoint opens;
- with a run manifest bound, ``update`` seals the manifest's ``ckpt``
  record BEFORE the file's rename, so the checkpoint never claims
  progress the manifest has not sealed ("checkpoint ahead of manifest"
  is always corruption, and ``tools/fsck.py`` flags it);
- the renames are followed by a directory fsync
  (``io/writers.fsync_dir``), so a published checkpoint survives power
  loss, not only process death.
"""

from __future__ import annotations

import json
import os

from srtb_tpu_torch.io.manifest import record_crc
from srtb_tpu_torch.io.writers import fsync_dir
from srtb_tpu_torch.utils.logging import log


class StreamCheckpoint:
    def __init__(self, path: str, manifest=None):
        self.path = path
        self.manifest = manifest
        self.state = {"segments_done": 0, "file_offset_bytes": 0}
        # recovery sweep: a crash between the temp write and the
        # atomic rename in update() leaves a stale <path>.tmp; the
        # durable state is whatever the rename last published, so the
        # orphan is simply removed before resuming from it
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
                log.warning(f"[checkpoint] removed orphan temp {tmp} "
                            "from an interrupted update")
            except OSError as e:
                log.warning(f"[checkpoint] cannot remove {tmp}: {e}")
        loaded = self._load(path)
        if loaded is None and (os.path.exists(path)
                               or os.path.exists(path + ".bak")):
            loaded = self._load(path + ".bak")
            if loaded is not None:
                log.warning(
                    f"[checkpoint] primary {path} corrupt or missing: "
                    f"resuming from previous generation {path}.bak "
                    f"(at worst one segment of progress is repeated)")
            else:
                log.error(
                    f"[checkpoint] BOTH {path} and {path}.bak are "
                    "unreadable/corrupt: restarting from segment 0 — "
                    "expect the run manifest (if armed) to skip "
                    "already-committed artifacts")
        if loaded is not None:
            self.state.update(loaded)
            log.info(f"[checkpoint] resuming from {path}: "
                     f"{self.state}")

    @staticmethod
    def _load(path: str) -> dict | None:
        """Parse + CRC-verify one checkpoint generation; None when
        missing, unparseable, or failing its integrity check.
        Pre-CRC-era files (no ``crc`` key) are accepted as legacy."""
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError, ValueError) as e:
            log.warning(f"[checkpoint] unreadable {path}: {e}")
            return None
        if not isinstance(data, dict):
            log.warning(f"[checkpoint] malformed {path}: not an object")
            return None
        crc = data.pop("crc", None)
        if crc is not None:
            if record_crc(data) != crc:
                log.warning(f"[checkpoint] CRC mismatch in {path}: "
                            "corrupt state rejected")
                return None
        return data

    @property
    def segments_done(self) -> int:
        return self.state["segments_done"]

    @property
    def file_offset_bytes(self) -> int:
        return self.state["file_offset_bytes"]

    def update(self, segments_done: int, file_offset_bytes: int) -> None:
        self.state["segments_done"] = segments_done
        self.state["file_offset_bytes"] = file_offset_bytes
        if self.manifest is not None:
            # consistency point FIRST: a crash between here and the
            # file rename leaves the checkpoint file one generation
            # behind the manifest — safe (the resume re-drains one
            # segment and the manifest done-set skips its sinks).
            # The reverse order could leave a checkpoint claiming
            # progress the manifest never sealed.
            self.manifest.checkpoint(segments_done, file_offset_bytes)
        body = dict(self.state)
        body["crc"] = record_crc(self.state)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(body, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(self.path):
            # keep the previous generation: a crash between these two
            # renames leaves no primary but a valid .bak (the loader's
            # fallback) plus the fsync'd tmp — never zero generations
            os.replace(self.path, self.path + ".bak")
        os.replace(tmp, self.path)  # atomic, like the fdatasync'd writers
        fsync_dir(self.path)

    def clear(self) -> None:
        for p in (self.path, self.path + ".bak"):
            if os.path.exists(p):
                os.unlink(p)
