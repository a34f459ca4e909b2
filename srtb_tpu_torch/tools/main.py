"""Main entry point of the port, ``srtb-torch-main`` (port of
``srtb_tpu/tools/main.py``).

Usage:
    srtb-torch-main --config_file_name srtb_config.cfg [--key value ...]
        [--device cpu]

Takes the same ``.cfg`` file and ``--key value`` options as ``srtb-main``
and runs on the CUDA card; ``--device cpu`` runs the plain PyTorch
versions of the kernels on the CPU instead.  Input selection follows the
reference (main.cpp:241-271): an ``input_file_path`` that exists is read;
one that does not ends the run with exit code 1; an empty one (the
default) receives UDP packets, on one ``udp_receiver_port`` through
``UdpReceiverSource`` and on several through ``MultiUdpSource``, until
the run is interrupted.  The run takes the
reference's defaults: an in-flight window of ``inflight_segments`` (2),
a writer pool of ``writer_thread_count`` threads (2) owned by the
pipeline, and ``ingest_ring = auto``; ``baseband_write_all`` appends
every segment's baseband instead of writing candidates.
``micro_batch_segments`` (B segments a dispatch, the fused plans),
``checkpoint_path`` and ``run_manifest_path`` (a resumable, exactly-once
run: start it again with the same arguments after a crash),
``manifest_fsync``, ``manifest_hash`` and ``fault_plan`` (the actions
``stall`` and ``fatal``) pass through as in ``srtb-main``, and so does
``search_mode = periodicity`` (the harmonic-summed search and folded
profiles, ``.fold.npy`` and ``.cand.json`` beside a positive's dumps).
The observability settings pass through as well:
``telemetry_journal_path`` (one span a segment), ``events_dump_path``
(the flight recorder's dump at the end), ``profile_capture_segments``
(a torch.profiler trace of the first segments) and the ``slo_*``
objectives, which ``gui_http_port``'s ``/metrics`` and ``/healthz``
report.  Ends with the same ``[main] done: N segments, M with signal, X
Msamples/s`` line.  A ``dm_list`` runs the DM-trial search instead
(``DMSearchPipeline``: one ``<prefix>dm_trials.jsonl`` record a
segment), ending with ``[main] dm search done: ...``.

``--distributed_coordinator H:P --distributed_num_processes N
--distributed_process_id i`` (one process a device; ``H:P`` a TCP
rendezvous, or a ``file://`` URL) joins a process group first
(``parallel/distributed.py``: NCCL on the card, gloo with ``--device
cpu``).  The DM search then shards its trials over the group's ranks and
rank 0 writes the records; the single-DM pipeline runs whole in every
process, as the reference's does.
"""

from __future__ import annotations

import os
import sys

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.parallel import distributed
from srtb_tpu_torch.pipeline.runtime import (DMSearchPipeline, Pipeline,
                                             PipelineStats)
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.termination import install_termination_handler


def _pop_device(argv: list[str]) -> str | None:
    """Remove ``--device X`` / ``--device=X`` from ``argv``; return X."""
    device = None
    out = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("missing value for --device")
            device = argv[i + 1]
            i += 2
            continue
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            out.append(arg)
        i += 1
    argv[:] = out
    return device


def make_source(cfg):
    """The reference's input selection: None for an input file that
    exists (the pipeline reads it), FileNotFoundError for one that does
    not, else a UDP source on the configured port(s)."""
    if cfg.input_file_path and os.path.exists(cfg.input_file_path):
        return None
    if cfg.input_file_path:
        raise FileNotFoundError(f"input file {cfg.input_file_path} not found")
    from srtb_tpu_torch.io import udp
    if len(cfg.udp_receiver_port) > 1:
        return udp.MultiUdpSource(cfg)
    return udp.UdpReceiverSource(cfg)


def make_waterfall_service(cfg, device=None):
    """The reference's waterfall service for ``cfg``: the engine's
    waterfall geometry, frames into the output prefix's directory."""
    from srtb_tpu_torch.gui.waterfall import WaterfallService
    n_spec = cfg.baseband_input_count // 2
    nchan = min(cfg.spectrum_channel_count, n_spec)
    out_dir = os.path.dirname(cfg.baseband_output_file_prefix) or "."
    return WaterfallService(cfg, in_freq=nchan, in_time=n_spec // nchan,
                            out_dir=out_dir, device=device)


class WaterfallTap:
    """The sink after the writers that feeds the waterfall service: every
    segment's waterfall is pushed and rendered at once, on whichever
    thread runs the sinks (the ``sink_drain`` thread with a window, its
    launches on the sink's copy stream after the segment's event)."""

    def __init__(self, service):
        self.service = service

    def push(self, work, has_signal):
        if work.waterfall is not None:
            self.service.push(work.waterfall, work.segment.data_stream_id)
            self.service.render_pending()


def run_dm_search(cfg, device=None
                  ) -> tuple[PipelineStats, DMSearchPipeline]:
    """The DM-trial search of ``cfg.dm_list`` on the selected input
    (the reference's ``dm_list`` branch): one record a segment in
    ``<prefix>dm_trials.jsonl``."""
    source = make_source(cfg)
    try:
        search = DMSearchPipeline(cfg, source=source, device=device)
    except BaseException:
        if source is not None:
            source.close()
        raise
    with search:
        stats = search.run()
    log.info(f"[main] dm search done: {stats.segments} segments, "
             f"{stats.signals} with signal; trials in "
             f"{search.trials_path}")
    return stats, search


def run(argv=None) -> tuple[PipelineStats, Pipeline]:
    """Parse the options, run the search on the selected input, and
    return the run's statistics and the finished pipeline (its sink lists
    what it wrote); with ``dm_list``, the DM search's statistics and
    its ``DMSearchPipeline`` (:func:`run_dm_search`)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _pop_device(argv)
    cfg = Config.from_args(argv)
    # the process group first, before any device work (NCCL on the card,
    # gloo with --device cpu); a group this call formed is left at the end
    if not distributed.maybe_initialize_from_config(cfg, device):
        return _run(cfg, device)
    try:
        return _run(cfg, device)
    finally:
        distributed.shutdown()


def _run(cfg, device) -> tuple[PipelineStats, Pipeline]:
    if cfg.dm_list:
        return run_dm_search(cfg, device)
    if cfg.gui_http_port and not cfg.gui_enable:
        # a live viewer port only makes sense with frames being rendered
        log.info("[main] gui_http_port set: enabling the waterfall service")
        cfg.gui_enable = True
    log.info(f"[main] nsamps_reserved = {dd.nsamps_reserved(cfg)}")
    if cfg.telemetry_journal_path:
        log.info("[main] segment-span journal -> "
                 f"{cfg.telemetry_journal_path}")
    source = make_source(cfg)
    gui_server = None
    try:
        pipe = Pipeline(cfg, source=source, device=device)
    except BaseException:
        if source is not None:
            source.close()
        raise
    try:
        if cfg.gui_enable:
            service = make_waterfall_service(cfg, pipe.processor.device)
            pipe.sinks.append(WaterfallTap(service))
        if cfg.gui_http_port:
            from srtb_tpu_torch.gui.server import WaterfallHTTPServer
            from srtb_tpu_torch.resilience.supervisor import Supervisor
            # the configured restart budget covers the viewer; it is
            # best-effort, so it restarts whatever the error
            gui_server = WaterfallHTTPServer(
                service.out_dir, port=cfg.gui_http_port,
                health_stale_after_s=cfg.health_stale_after_s,
                supervisor=Supervisor(
                    "gui_server", max_restarts=cfg.supervisor_max_restarts,
                    window_s=cfg.supervisor_window_s,
                    restart_fatal=True)).start()
        stats = pipe.run()
    finally:
        pipe.close()
        if gui_server is not None:
            gui_server.stop()
    log.info(f"[main] done: {stats.segments} segments, "
             f"{stats.signals} with signal, "
             f"{stats.msamples_per_sec:.1f} Msamples/s")
    return stats, pipe


def main(argv=None) -> int:
    install_termination_handler()
    try:
        run(argv)
    except FileNotFoundError as e:
        log.error(f"[main] {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
