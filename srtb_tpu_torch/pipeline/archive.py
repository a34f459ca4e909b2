"""Archive replay engine: recorded baseband at full device occupancy
(port of ``srtb_tpu/pipeline/archive.py``).

Real-time serving (``Pipeline`` on a UDP source, or a fleet of live
beams) is paced by the antenna: the card idles whenever the link does.
Archive reprocessing is the opposite regime: a batch job should saturate
the card, not the wall clock.  This engine replays a SET of recorded
baseband files with every throughput mechanism the port has, composed:

- **no pacing**: file sources read as fast as the disk yields (the engine
  never sleeps on a source);
- **deep micro-batch**: each file's lane stacks B segments into one
  dispatch (``micro_batch_segments``: file-mode fleet lanes accept it;
  real-time lanes and the staged plan refuse it);
- **many files in parallel**: files fan out across
  :class:`~srtb_tpu_torch.pipeline.fleet.StreamFleet` lanes
  (``fleet_max_streams`` lanes live at once, the rest queued behind
  admission control), sharing ONE plan through the fleet's
  :class:`~srtb_tpu_torch.pipeline.fleet.SharedPlanCache`: N files, one
  processor built;
- **many SMALL files in one dispatch**: with ``fleet_batch`` set (and
  ``micro_batch=1``: per-lane micro-batch and cross-stream batching are
  exclusive per lane), the fleet's batch former folds ready segments of
  DIFFERENT files into one shared dispatch;
- **exactly-once outputs and deterministic resume**: every file gets its
  own checkpoint and run-manifest namespace under the output directory,
  and timestamps are stamped from stream offsets
  (``Config.deterministic_timestamps``), so artifact names reproduce
  across runs: re-running the SAME replay after a crash resumes each file
  from its checkpoint, manifest recovery rolls back uncommitted
  artifacts, and the final output set equals an uninterrupted run's by
  path and SHA-256.  ``tools/archive_replay.py --selftest`` gates exactly
  that, with a mid-run SIGTERM.

The per-file bulkheads are the fleet's: one corrupt file fails its own
lane (``StreamResult.status = "failed"``) and the other files complete
untouched.  The lanes run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

# archive lanes have no latency contract: a deeper default in-flight
# window + micro-batch than the real-time engine's 2/1
DEFAULT_LANES = 2
DEFAULT_MICRO_BATCH = 4
DEFAULT_INFLIGHT = 8


def stream_name_for(path: str, taken: set) -> str:
    """Stable, filesystem-safe lane name for one archive file (the basename
    without extension, deduplicated with a numeric suffix): it names the
    file's output/checkpoint/manifest namespace, so it must be
    deterministic across resumes of the same file list."""
    base = os.path.splitext(os.path.basename(path))[0]
    name = re.sub(r"[^A-Za-z0-9_.-]", "_", base) or "file"
    if name in taken:
        i = 1
        while f"{name}.{i}" in taken:
            i += 1
        name = f"{name}.{i}"
    taken.add(name)
    return name


@dataclass
class ArchiveReport:
    """Outcome of one replay run."""
    files: dict = field(default_factory=dict)  # name -> per-file dict
    segments: int = 0
    drained: int = 0
    elapsed_s: float = 0.0
    failed: int = 0
    plan_compiles: int = 0
    batched_dispatches: int = 0
    batched_segments: int = 0

    @property
    def segments_per_sec(self) -> float:
        return self.drained / self.elapsed_s if self.elapsed_s else 0.0

    def as_dict(self) -> dict:
        return {
            "files": self.files, "segments": self.segments,
            "drained": self.drained, "failed": self.failed,
            "elapsed_s": self.elapsed_s,
            "segments_per_sec": self.segments_per_sec,
            "plan_compiles": self.plan_compiles,
            "batched_dispatches": self.batched_dispatches,
            "batched_segments": self.batched_segments,
            "ok": self.failed == 0,
        }


class ArchiveReplay:
    """Replay ``files`` through a micro-batched file-lane fleet (see the
    module docstring).  ``base_cfg`` carries the science config (format,
    segment size, DM, thresholds, search_mode, ...); this engine derives
    each file's lane config (input path, per-file
    output/checkpoint/manifest namespace under ``out_dir``, deterministic
    timestamps, batch depth) and never mutates the base.  Re-running with
    the same arguments resumes: completed files' checkpoints make their
    lanes no-ops, partial files resume from their checkpoint with
    manifest-recovered exactly-once outputs.  ``device`` is the fleet's
    (``None``: the card)."""

    def __init__(self, base_cfg: Config, files: list[str],
                 out_dir: str, lanes: int = DEFAULT_LANES,
                 micro_batch: int = DEFAULT_MICRO_BATCH,
                 inflight: int = DEFAULT_INFLIGHT,
                 keep_waterfall: bool = True,
                 max_segments_per_file: int | None = None,
                 manifest: bool = True,
                 fleet_batch: int = 0, device=None):
        if not files:
            raise ValueError("archive replay needs at least one file")
        for f in files:
            if not os.path.isfile(f):
                raise FileNotFoundError(f"archive file not found: {f}")
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.device = device
        self.keep_waterfall = keep_waterfall
        self.max_segments_per_file = max_segments_per_file
        mb = max(1, int(micro_batch))
        window = max(int(inflight), mb, 1)
        taken: set = set()
        self.names: list[str] = []
        self.cfgs: dict[str, Config] = {}
        for path in files:
            name = stream_name_for(path, taken)
            self.names.append(name)
            prefix = os.path.join(out_dir, name + "_")
            self.cfgs[name] = base_cfg.replace(
                input_file_path=path,
                stream_name=name,
                baseband_output_file_prefix=prefix,
                checkpoint_path=os.path.join(out_dir, name + ".ck.json"),
                run_manifest_path=(os.path.join(
                    out_dir, name + ".manifest.jsonl") if manifest else ""),
                deterministic_timestamps=True,
                micro_batch_segments=mb,
                inflight_segments=window,
            )
        # the fleet-level config: lane capacity and a queue deep enough
        # that every file is admitted eventually, priorities equal (FIFO by
        # spec order).  fleet_batch arms the cross-stream batch former, the
        # many-small-files case where per-lane micro-batching has nothing
        # to stack (its eligibility rule keeps micro-batched lanes out, so
        # the two modes never fight over the same segment)
        fb = max(0, int(fleet_batch))
        if fb >= 2 and mb > 1:
            log.warning(
                f"[archive] fleet_batch={fb} with micro_batch={mb}: "
                "micro-batched lanes are ineligible for cross-stream "
                "batching; set --micro-batch 1 to use --fleet-batch")
        self.fleet_cfg = base_cfg.replace(
            fleet_max_streams=max(1, int(lanes)),
            fleet_queue_limit=len(files),
            fleet_batch_max=fb)

    def run(self) -> ArchiveReport:
        from srtb_tpu_torch.pipeline.fleet import StreamFleet, StreamSpec

        specs = [StreamSpec(name=n, cfg=self.cfgs[n],
                            keep_waterfall=self.keep_waterfall,
                            max_segments=self.max_segments_per_file)
                 for n in self.names]
        t0 = time.perf_counter()
        compiles0 = int(metrics.get("fleet_plan_compiles"))
        bdisp0 = int(metrics.get("batched_dispatches"))
        bsegs0 = int(metrics.get("batched_segments"))
        report = ArchiveReport()
        with StreamFleet(specs, fleet_cfg=self.fleet_cfg,
                         device=self.device) as fleet:
            results = fleet.run()
            report.plan_compiles = \
                int(metrics.get("fleet_plan_compiles")) - compiles0
            report.batched_dispatches = \
                int(metrics.get("batched_dispatches")) - bdisp0
            report.batched_segments = \
                int(metrics.get("batched_segments")) - bsegs0
        report.elapsed_s = time.perf_counter() - t0
        for name in self.names:
            res = results.get(name)
            if res is None:
                report.files[name] = {"status": "missing"}
                report.failed += 1
                continue
            stats = res.stats
            report.files[name] = {
                "status": res.status,
                "segments": stats.segments if stats else 0,
                "drained": res.drained,
                "dropped": res.dropped,
                "error": repr(res.error) if res.error else None,
            }
            report.segments += stats.segments if stats else 0
            report.drained += res.drained
            if res.status != "done":
                report.failed += 1
        log.info(
            f"[archive] {len(self.names)} file(s): {report.drained} "
            f"segment(s) drained in {report.elapsed_s:.1f}s "
            f"({report.segments_per_sec:.1f} seg/s, "
            f"{report.plan_compiles} plan compile(s), "
            f"{report.failed} failed)")
        return report
