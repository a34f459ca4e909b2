#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``srtb_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
result lines are printed:

1. card: the card's name and power limit, torch and CUDA versions;
2. build: the hand-written kernels, compiled from ``srtb_tpu_torch/csrc``;
3. bandwidth: a 4 GiB device-to-device copy, the card's own yardstick;
4. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it (K1-K4 and B3 at 2^30 2-bit samples
   and 2^11 channels; B13, B6, B7, B8, B9, B10 at 2^27 samples and 2^11
   channels, the row kernels also at every row length 2^12 ... 2^16, B9
   and B10 at both column lengths and every row length, B3 also past
   float32's exact channel indices; B11 and B12 at the front-fused 2^30
   path's (8192, 65536), B11 also at 2^24 for every unpack variant and
   width it reads, B12 at every row length and both column lengths), with
   the tolerance stated
   beside each check, and its time beside the plain version's, its bound
   and, where one PyTorch call computes the same function, that call's
   (B6 and B10 in turns with ``torch.fft`` at every shape a main path
   gives them: the 2^27 legs, the staged ``pallas`` rows front's legs at
   2^30, the waterfall rows, B10 at [2, 4096, 8192] and [8192, 65536];
   with the row-FFT core's launch geometry at every row length; B9 at
   [2, 4096, 8192] and [1, 8192, 65536] and B11 at [8192, 65536] in turns
   with cuFFT's column FFT, a reference point without the twiddle, with
   the column body's launch geometry at both column lengths; B7 and B8
   each in turns with B6 on the same [2^11, 2^15] rows and B12 at [8192,
   65536] in turns with B10 on the same input, all before B9's 2^30
   timing, with their launch geometry at every row length); and B11 in
   its two-stream 8-bit form at [2, 8192, 65536], held to B9, to its
   plain version and to the exact float64 sums, and timed;
5. main paths: 2-bit files of two segments with a dispersed pulse in the
   second, made on the card by the port's synth, searched by the port's
   ``srtb-torch-main`` at the example J1644-4559 configuration and the
   engine's defaults (an in-flight window of 2, a writer pool of 2
   threads, the ingest ring wherever the cfg reserves a tail): at 2^30
   samples per segment with ``use_pallas = 1`` (the reference's staged
   plan), at 2^27 with ``fft_strategy = pallas`` twice, with the fused
   tail (``auto``) and without (``off``), the example cfg as shipped
   (2^30, ``use_pallas = 0``: the staged plan with B3; and ``gui_enable =
   1``: one waterfall frame a segment rendered on the card, the pulse
   segment's held to a float64 render of its dumped waterfall on the
   card, the intensity within 1e-5 relative, the pixmap equal but at
   colour steps and edges, with the render's and the PNG's ms), the
   staged 2^30 plan again with ``quality_stats = 1`` (``quality_2^30``:
   each segment's quality vector held to the float64 oracle of the
   spectrum and waterfall of a dispatch on the card, its timeline
   complete, its decisions and candidate bytes staged_2^30's), at 2^27
   with ``fft_strategy = pallas2`` (B9/B10), and at 2^30 with the fused tail
   and ``SRTB_STAGED_ROWS_IMPL=pallas2`` twice, front-fused (B11/B12) and
   not (K1, B9, B10, K2); then the multi-stream formats: 2 × 2^30 2-bit
   ``interleaved_samples_2`` with ``use_pallas = 1`` (the de-interleave,
   K1, K2, K3, K4 once a stream), 2 × 2^30 8-bit front-fused (B11 over
   both streams, B12 once a stream), 2 × 2^30 2-bit on the staged
   pallas2 plan (K1 once a stream, B9 and B10 over both streams, K2, K3
   and K4 once a stream) and 2 × 2^27 ``gznupsr_a1`` int8
   words with ``fft_strategy = pallas`` (B6 over both streams, K2 and B8
   once a stream), the pulse in stream 0 only.  In each, the pulse
   segment must be positive, the noise segment negative, the candidate
   files must exist (one waterfall a stream, and only stream 0's boxcar
   series), the plan must be the reference's, and each kernel must have
   launched exactly as often per segment as that plan's table says; the
   peak memory at the window and Msamples/s (a stream's) are printed.
   Then both segments are dispatched again (cold, then warm with the
   ring) under ``torch.cuda.set_sync_debug_mode
   ("error")``, so that any call of the dispatch that synchronises with
   the card fails.  Paths of one geometry share one input file;
6. breakdown: the device time of one segment stage by stage, for the 2^30
   paths (the two-stream ones with the byte de-interleave as its own
   stage) and for the fused, unfused, pallas2 and gznupsr 2^27 paths, and
   the staged R2C front under each staged row implementation;
7. window: staged_2^30 on a file of 4 noise segments and fused_2^27 on
   one of 8 with the pulse in one segment, each at the serial leg
   (``inflight_segments = 1``, ``writer_thread_count = 0``,
   ``ingest_ring = off``), at the defaults and at the defaults without
   the ring (``ingest_ring = off``) in turns, with Msamples/s, wall
   seconds by stage, overlap-hidden seconds and H2D bytes per segment
   and peak memory; the candidate files of all runs must be identical in
   name and bytes;
8. batch: micro-batch (``micro_batch_segments``) on fused_2^27 on the
   window phase's 8-segment file at B = 2 (window 2) and B = 4 (window
   4), the ingest ring on and off: each run's candidate files identical
   in name and bytes to the window phase's first (B = 1, defaults) run's,
   the plan the reference's, the launches a segment the table's, the H2D
   bytes a segment the stride model (the first batch's segments whole,
   then strides), one dispatch a batch, and one batch dispatched again
   under ``set_sync_debug_mode("error")``; gznupsr_2^27 (two streams) at
   B = 2 against B = 1; Msamples/s beside B = 1's, the peaks and the wall
   seconds by stage; then ``torch.profiler`` over fused_2^27's 8 segments
   at B = 1 and B = 2: the device's busy and idle share of the traced
   window, its longest idle gaps with the host frames that held them, the
   top device operations and the host's labelled seconds by stage;
9. durability: the port's SIGKILL crash soak
   (``srtb_tpu_torch/tools/crash_soak.py``) with fused_2^27's cfg on a
   file of 4 segments (the pulse in segments 1 and 2), the checkpoint and
   the run manifest armed, each life of the run a child process on the
   card: the kill plan ``ckpt_stall@1,rename@1`` at B = 1 (the writer
   pool) and ``ckpt_stall@2`` at B = 2 (a kill inside a batch;
   synchronous writes, so its resume must skip a replayed push), each
   gated: every kill landed, ``fsck`` clean, the output set equal to the golden run's
   by SHA-256, no orphan temp; then fsck's selftest, a probe of
   ``fdatasync``, ``fsync`` of a file and a directory and ``os.replace``,
   and an allocation on the card after the kills;
10. live: the AF_PACKET ring receiver once on loopback (or the reason it
   cannot run: it needs CAP_NET_RAW), then ``srtb-torch-main``'s default
   input, UDP packets: a loopback sender process streams
   ``fastmb_roach2`` packets at the J1644-4559 rate (32 MB/s a port)
   from files of the overlap-save layout, while ``Pipeline(cfg,
   source=...)`` searches them at the engine's defaults: ``live_2^30``
   (staged_2^30's cfg, one ``UdpReceiverSource``, 3 segments, the pulse
   in the first) and
   ``live2rx_2^27`` (fused_2^27's cfg on two ports,
   ``MultiUdpSource``, 4 segments a port, the pulse on port 0 only).
   Each prints its provider (it must be the native recvmmsg one), packets
   sent, received and lost, Msamples/s over the offered window and the
   real-time factor, the granted SO_RCVBUF and ``net.core.rmem_max``,
   the ring's warm dispatches and the peak memory; every received slot
   must equal the file's (lost ones zero, their count the source's
   loss), the launches the table's, and with no packet lost each port's
   decisions and candidate bytes those of a file-mode run of its file,
   less what the degradation ladder (armed, as the reference arms it)
   shed: its level by segment, its transitions and ``shed_waterfalls``
   are printed, and the shed dumps listed;
11. resilience (between batch and durability): (a) fused_2^27 at B = 2
   on the window phase's 8 segments with an out-of-memory or a kernel
   build fault injected at the dispatch or the fetch of segments 0-5,
   which walks the demotion ladder to the monolithic floor (each rung's
   plan, chain ms, peak and launches, measured first; the walk's rungs
   the ladder's, six demotions, the decisions and the baseband bytes the
   clean run's, the pulse segment's waterfall and series on the floor
   the clean plan's within the segment tests' gates), the chaos soak from a fixed seed on the card and its
   selftest; (b) a real out-of-memory: staged_pallas2_2^30, serial, under
   ``torch.cuda.set_per_process_memory_fraction`` 1 GB under rung 0's
   peak, recovered by demotion to the first rung that fits (the peak
   under the cap, the bytes those of an uncapped run on that rung, the
   pulse segment's waterfall and series those of the main path's run on
   rung 0 within the same gates, the seconds from the fault to the first dispatch on the new rung); (c) a
   real sticky fault: a child process whose chain asserts on the card,
   and one whose sink thread meets the assert before the engine,
   each classified ``halt``, escalated with ``ReinitBudgetExceeded`` and a
   nonzero exit, leaving one ``reinit_budget_exceeded`` incident bundle
   (the metrics, events and config snapshots, the halt in its events,
   the dump's seconds), then resumed by a fresh process from its
   checkpoint to the output set of an uninterrupted run (SHA-256); (d) a
   kernel build
   fault at ffuse_2^30's first fetch, which takes the front_fuse rung
   (B11 and B12 before it, K1, B9, B10 and K2 after it), transient faults
   at four sites retried (``retries_total`` 4, the clean run's bytes), a
   chain wedged behind a spin on the compute stream requeued once by the
   watchdog (an injected fetch stall requeues nothing); and fused_2^27
   with every layer off and armed, ``ARMED_PAIRS`` pairs in turns.
   Every other run of the script must have needed no demotion, reinit,
   retry or requeue;
12. health (between observability and resilience): the canary's delta
   at 2^27 built on the card against the host's float64 build (a count
   may differ by one, at a half-count tie only; the ties counted), the
   2^30 delta's build seconds, peak and one injection's device ms; then
   canary_2^30, staged_2^30's cfg at 8 bits (``CANARY_AMP`` counts) on a
   file of 4 noise segments made on the card: (a) the canary every
   second segment with the quality epilogue, the write-all sink, the
   journal, the events dump, the run manifest and the incident
   directory: segments 1 and 3 injected, checked and passed (the first
   calibrating), nothing positive, both flagged in the spans and the
   manifest, ``/healthz``'s detection ``ok``, the launches the table's,
   the recovered S/N, and ``telemetry_report`` and ``quality_report`` in
   both formats on its journal; (b) the canary off: the write-all file
   equal to (a)'s by SHA-256 and segments 0 and 2's detection results
   bit-identical; Msamples/s of both;
   (c) two segments with 61 of the band's 64 MHz zapped and the expected
   S/N pinned to (a)'s: the check fails, detection degraded, one
   ``canary_sensitivity`` bundle holding the failed verdict and the
   quality timeline, the dump's seconds, ``trace_export --validate`` on
   it.  The phase prints its seconds and deletes its files;
13. perf (after batch): the port's perf tools on the card, their files
   under ``build/chip_smoke/perf/`` (deleted after): ``srtb-torch-bench``
   at 2^27 on the pallas knobs and at 2^30 on the staged ones, 3 reps
   each (plan, launches a segment, Msamples/s, real-time factor and
   ``roofline_frac`` against 3350 GB/s, the card's name and power limit
   in the line); ``srtb-torch-kernel-bench`` at its default ``--log2n
   28``, then its K2, K3 + K4 and B3 rows at 2^30 and B6 and B8 rows at
   2^27, each within 15% of the kernels phase's time of the same shape;
   ``srtb-torch-fft-bench`` from 2^20 to 2^27; ``perf_gate --selftest``
   (the injected dispatch stall flagged, the clean sides passing, every
   side pooled from short captures in turns and its samples printed, the
   selftest's seconds) and a ``--write-baseline`` / ``--baseline`` round
   trip (pooled short captures); fused_2^27 on the
   window phase's file with ``perf_ledger_path`` (its candidates the
   window phase's, one "steady" record) and ``perf_report`` of the
   ledger; ``srtb-torch-trace-summary`` of the batch phase's B = 1
   profile trace, its device total and busy time within 1% of that
   phase's ``profile`` line;
14. a9e (after a9d): ``python -m srtb_tpu_torch.tools.lint
   srtb_tpu_torch/`` with this machine's Python (0 new findings, none
   stale, the counts); the rollup ``Aggregator`` over the observability
   phase's staged_2^30 span journal and event dump (its segment counts
   the journal's, p50/p99 within ``QuantileDigest``'s error of the exact
   order statistics, a resumed poll ingesting nothing, ``rollup.main``);
   ``trace_join`` of the same files (one host track: a single card's
   journal names no device; mapped to the card, one ``device:cuda:0``
   track holding every stage event); ``obs.regression --selftest`` on
   the card, every side's samples printed.  The phase prints its seconds
   by part.

15. a8b (after a8a): the stream fleet (``pipeline/fleet.py``) at
   fused_2^27's cfg, four streams ``j1644.beam0`` ... ``beam3`` (one
   tenant) on files of 4 segments each from its own seed, the pulse in
   beam0's segment 2 only: ``fleet_2^27`` (solo lanes) with every
   stream's candidates equal to its own solo ``Pipeline`` run's by
   SHA-256, one plan compile and 3 hits, fused_2^27's plan, B13 1, B6 2,
   K2 1 and B8 1 launches a stream-segment, the decisions (beam0's
   segment 2 alone positive), Msamples/s over the lanes' span beside the
   solo runs back to back (each without its construction, and both with
   it), the peak beside its reckoning and the pool (``fleet_devices =
   2``, capped at the card count); ``fleet_batch_2^27`` (``fleet_batch_max = 4``): ``.bin``
   bitwise, ``.npy`` / ``.tim`` within the reference's vmap tolerance,
   decisions exact, ``batch_size`` on every record, device dispatches at
   most half the segments; each leg dispatched again under
   ``set_sync_debug_mode("error")``; then ``fleet_soak`` on the card at
   2^27 samples a segment (3 streams of ``A8B_SOAK_SEGMENTS``, inputs
   made on the card) with the victim's injected out-of-memory (gates a,
   b, c) and its selftest.  The phase fails past ``A8B_BUDGET_S``.
16. a8c (right after a8b, on a8b's four beam files and their solo
   goldens): ``archive_2^27``, ``pipeline/archive.ArchiveReplay`` over
   the four files at the archive's defaults (2 lanes, micro-batch 4, 8
   in flight) on the card: one plan compile, none failed, 16 of 16
   segments drained, B13 1, B6 2, K2 1 and B8 1 launches a segment, every
   artifact (the raw dumps, waterfalls and series) the solo runs' by
   name and SHA-256 (the port's micro-batch runs a member at a time),
   Msamples/s over the replay's ``elapsed_s`` beside the solo runs back
   to back, the peak beside its reckoning; ``fleet_status()`` right
   after it (the card's one member ``ok``, the four streams' segments),
   the viewer's ``/fleet`` answering 200 with the same payload and
   ``console --url`` rendering it; ``race_soak``'s selftest (sharp) and
   ``run_race_soak`` at 2^16 on the card under a deadline, its migrate
   phase on the CPU's virtual pool (asked for, and said so on its line);
   then the archive's selftest, ``archive_replay --selftest --device
   cuda`` through its ``main`` (the SIGTERM landed, the resume's outputs
   the streamed goldens' by SHA-256, its children on the card).  The
   phase fails past ``A8C_BUDGET_S``.

The last two lines are the kernels' JSON record and the result line.
Outputs go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"
CFG_EXAMPLE = ROOT / "examples" / "srtb_config_1644-4559.cfg"

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
# HBM3 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s; float64
# outside the tensor cores 34 TFLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12}

LOG2_N = 30            # samples per segment (the example cfg)
LOG2_CHANNELS = 11     # spectrum_channel_count (the example cfg)
LOG2_N_ROWS = 27       # samples per segment of the row-FFT plans

# the main paths: (label, log2 samples per segment, cfg lines added to the
# example cfg, the plan both packages resolve, kernel launches per segment,
# the environment set around the run: the reference's staged switches)
PALLAS_ON = "use_pallas = 1\nuse_pallas_sk = 1\nbaseband_reserve_sample = 1\n"
PALLAS_27 = "baseband_input_count = 2 ** 27\nfft_strategy = pallas\n" \
    + PALLAS_ON
PALLAS2_27 = "baseband_input_count = 2 ** 27\nfft_strategy = pallas2\n" \
    + PALLAS_ON
STAGED_TAIL = PALLAS_ON + "fused_tail = on\n"
ROWS_PALLAS2 = {"SRTB_STAGED_ROWS_IMPL": "pallas2"}
DUALPOL = "baseband_format_type = interleaved_samples_2\n"
MAIN_PATHS = (
    ("staged_2^30", LOG2_N, PALLAS_ON, "staged:four_step+ring",
     {"unpack_subbyte_window": 1, "rfi_s1_dedisperse": 1, "sk_stats": 1,
      "sk_apply_timeseries": 1}, {}),
    # staged_2^30 with the quality epilogue at its defaults (every 8th
    # bin and sample, 64 coarse bins)
    ("quality_2^30", LOG2_N, PALLAS_ON + "quality_stats = 1\n",
     "staged:four_step+ring",
     {"unpack_subbyte_window": 1, "rfi_s1_dedisperse": 1, "sk_stats": 1,
      "sk_apply_timeseries": 1}, {}),
    ("fused_2^27", LOG2_N_ROWS, PALLAS_27,
     "fused:pallas+ftail+skzap+ring",
     {"unpack_subbyte_planes_window": 1, "fft_rows": 2,
      "rfi_s1_dedisperse": 1, "fft_rows_skzap": 1}, {}),
    ("unfused_2^27", LOG2_N_ROWS, PALLAS_27 + "fused_tail = off\n",
     "fused:pallas+ring",
     {"unpack_subbyte_planes_window": 1, "fft_rows": 2,
      "rfi_s1_dedisperse": 1, "fft_rows_stats": 1,
      "sk_apply_timeseries": 1}, {}),
    # the example cfg as shipped: use_pallas = use_pallas_sk = 0, no
    # reserve, gui_enable = 1; the reference's stage (c) runs XLA stage 1
    # and B3, and the GUI tap renders one waterfall frame a segment
    ("shipped_2^30", LOG2_N, "", "staged:four_step",
     {"unpack_subbyte_window": 1, "dedisperse": 1}, {}),
    ("pallas2_2^27", LOG2_N_ROWS, PALLAS2_27,
     "fused:pallas2+ftail+skzap+ring",
     {"unpack_subbyte_planes_window": 1, "fft2_pass1": 1, "fft2_pass2": 1,
      "rfi_s1_dedisperse": 1, "fft_rows_skzap": 1}, {}),
    # the reference's staged_pallas2 and staged_ffuse plan families at the
    # cfg's own 2^30 x 2^11
    ("staged_pallas2_2^30", LOG2_N, STAGED_TAIL + "front_fuse = off\n",
     "staged:four_step+ftail+ring",
     {"unpack_subbyte_window": 1, "fft2_pass1": 1, "fft2_pass2": 1,
      "rfi_s1_dedisperse": 1, "sk_stats": 1, "sk_apply_timeseries": 1},
     ROWS_PALLAS2),
    ("ffuse_2^30", LOG2_N, STAGED_TAIL + "front_fuse = on\n",
     "staged:four_step+ftail+ffuse+ring",
     {"fft2_pass1_front": 1, "fft2_pass2_spectrum": 1, "sk_stats": 1,
      "sk_apply_timeseries": 1}, ROWS_PALLAS2),
    # the multi-stream formats: the example cfg's two byte-interleaved
    # polarizations on the card (the kernels a stream's work runs through
    # launch once a stream; B11 reads both streams in one launch), and
    # the gznupsr word-interleaved int8 format on the row-FFT plan (its
    # B6 legs carry both streams in their batch)
    ("dualpol_2^30", LOG2_N, DUALPOL + PALLAS_ON, "staged:four_step+ring",
     {"unpack_subbyte_window": 2, "rfi_s1_dedisperse": 2, "sk_stats": 2,
      "sk_apply_timeseries": 2}, {}),
    ("dualpol8_ffuse_2^30", LOG2_N,
     DUALPOL + "baseband_input_bits = 8\n" + STAGED_TAIL
     + "front_fuse = on\n", "staged:four_step+ftail+ffuse+ring",
     {"fft2_pass1_front": 1, "fft2_pass2_spectrum": 2, "sk_stats": 2,
      "sk_apply_timeseries": 2}, ROWS_PALLAS2),
    # the reference's staged_pallas2 plan at the cfg's two polarizations
    # (B9 and B10 take both streams in their batch; its peak: PERF.md §5)
    ("dualpol_pallas2_2^30", LOG2_N,
     DUALPOL + STAGED_TAIL + "front_fuse = off\n",
     "staged:four_step+ftail+ring",
     {"unpack_subbyte_window": 2, "fft2_pass1": 1, "fft2_pass2": 1,
      "rfi_s1_dedisperse": 2, "sk_stats": 2, "sk_apply_timeseries": 2},
     ROWS_PALLAS2),
    ("gznupsr_2^27", LOG2_N_ROWS,
     "baseband_format_type = gznupsr_a1\nbaseband_input_bits = -8\n"
     + PALLAS_27, "fused:pallas+ftail+skzap+ring",
     {"fft_rows": 2, "rfi_s1_dedisperse": 2, "fft_rows_skzap": 2}, {}),
)


# the paths that run the cfg's own gui_enable (every other path sets
# gui_enable = 0, so that its numbers stay comparable with earlier runs)
GUI_PATHS = ("shipped_2^30",)
# the paths whose candidate files are hashed, to compare their bytes
DIGEST_PATHS = ("staged_2^30", "quality_2^30")
# the same paths measured without the GUI and without the quality
# epilogue (PERF.md section 5; H100 80GB HBM3, 700 W), printed beside
# the numbers with them
SHIPPED_PEAK_GB_NO_GUI = 21.88
SHIPPED_MSAMPLES_NO_GUI = (551.4, 683.0)
STAGED_PEAK_GB = 18.25
# the display's gates: the float intensity within RENDER_RTOL of a float64
# render, the pixmap equal but within BOUNDARY of a truncation step or of
# the [0, 1] edges
RENDER_RTOL = 1e-5
BOUNDARY = 1e-5


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    # on standard error too, where the engine's log ends
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


@functools.lru_cache(maxsize=1)
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them (read
    once; every measurement line carries it)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# C9: the card's own state around each batch of the gate's round trip
CARD_STATE_FIELDS = ("clocks.sm", "clocks.mem", "temperature.gpu",
                     "power.draw", "clocks_event_reasons.active")
# older nvidia-smi releases' name of the last field
CARD_STATE_OLD = "clocks_throttle_reasons.active"


def card_state() -> dict:
    """The card's SM and memory clocks (MHz), temperature (C), power
    draw (W) and active clock-event (throttle) reasons, one
    ``nvidia-smi`` query (the older field name where nvidia-smi lacks
    the newer)."""
    for last in (CARD_STATE_FIELDS[-1], CARD_STATE_OLD):
        query = ",".join(CARD_STATE_FIELDS[:-1] + (last,))
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        if not out.returncode:
            break
    else:
        fail(f"nvidia-smi card state failed: {out.stderr.strip()}")
    vals = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    return dict(zip(("sm_mhz", "mem_mhz", "temp_c", "power_w", "reasons"),
                    vals))


def state_shift(states: list) -> bool:
    """Whether the SM clock, the memory clock or the active throttle
    reasons differ among a round trip's readings (before and after each
    of its two batches)."""
    return any(len({s[k] for s in states}) > 1
               for k in ("sm_mhz", "mem_mhz", "reasons"))


@contextlib.contextmanager
def path_env(env: dict):
    """``os.environ`` updated by ``env`` inside the block and restored
    after it (the processor reads the staged switches when it is
    built)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after one warm-up
    (CUDA events around the whole run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def free_card() -> str:
    """Drop the module caches of device tables (B9's plain twiddle, the
    Hermitian weights: 8 GiB at 2^29) and the allocator's free blocks, so
    that the next path starts from a card holding only what its own run
    holds; returns the memory still allocated and reserved, for the log."""
    import torch
    from srtb_tpu_torch.kernels import fft2 as K2
    from srtb_tpu_torch.ops import fft as F
    from srtb_tpu_torch.parallel import dist_fft as DF
    K2.twiddle.cache_clear()
    F._hermitian_weights.cache_clear()
    DF._twiddle_block.cache_clear()
    DF._post_weights.cache_clear()
    torch.cuda.empty_cache()
    return (f"allocated {torch.cuda.memory_allocated()} bytes, reserved "
            f"{torch.cuda.memory_reserved()} bytes")


def bound_ms(nbytes: float, ops: dict) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rates."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card() -> str:
    import torch
    line = card_line()
    say(f"card: {line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    return line


def phase_build() -> None:
    from srtb_tpu_torch.io import native_writer
    from srtb_tpu_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.library()
    say(f"build: {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    writer = Path(native_writer.native_library()._name)
    say(f"build: {writer.relative_to(ROOT)} (the writer pool, host "
        f"compiler) in {time.perf_counter() - t0:.2f} s")


def phase_bandwidth() -> float:
    import torch
    nbytes = 1 << 32
    a = torch.ones(nbytes // 4, dtype=torch.float32, device="cuda")
    b = torch.empty_like(a)
    ms = cuda_ms(lambda: b.copy_(a), 10)
    gbps = 2 * nbytes / ms / 1e6
    say(f"bandwidth: 4 GiB device copy {ms:.3f} ms = {gbps:.1f} GB/s "
        "(read + write)")
    del a, b
    torch.cuda.empty_cache()
    return gbps


def _record(name, kernel_ms, plain_ms, nbytes, ops, err, copy_gbps,
            library_ms=None):
    from srtb_tpu_torch import kernels as K
    src, tpu = {n: (s, t) for n, _w, s, t in K.KERNELS}[name]
    b_ms, b_by = bound_ms(nbytes, ops)
    rec = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
           "launches": None, "max_abs_err": err, "ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms, "bytes": nbytes,
           "bound_ms_at_copy_bandwidth": nbytes / copy_gbps / 1e6}
    lib = "" if library_ms is None else f", library_ms {library_ms:.4f}"
    say(f"kernel {name}: kernel_ms {kernel_ms:.4f}, plain_ms "
        f"{plain_ms:.4f}{lib}, bytes {nbytes}, bound_ms {b_ms:.4f} "
        f"({b_by}), bound_ms at copy bandwidth "
        f"{rec['bound_ms_at_copy_bandwidth']:.4f}, max_abs_err {err:.3e}")
    return rec


def check_unpack(copy_gbps: float) -> dict:
    """K1 at the production segment: 2^28 bytes of 2-bit samples, no
    window (the example cfg's rectangle window); plus a windowed check at
    2^24 bytes.  Tolerance: exact — both spell the same integer fields
    and one float32 multiply."""
    import torch
    from srtb_tpu_torch.kernels import unpack as KU
    g = torch.Generator(device="cuda").manual_seed(11)
    m = 1 << (LOG2_N - 2)
    data = torch.randint(0, 256, (m,), dtype=torch.uint8, device="cuda",
                         generator=g)
    out = KU.unpack_subbyte_window(data, 2)
    ref = KU.unpack_subbyte_window_plain(data, 2)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not torch.equal(out, ref):
        fail(f"unpack_subbyte_window differs from plain: {err}")
    del ref
    small = data[: 1 << 24]
    for nbits in (1, 2, 4):
        win = torch.rand(small.numel() * (8 // nbits), device="cuda",
                         generator=g)
        if not torch.equal(KU.unpack_subbyte_window(small, nbits, win),
                           KU.unpack_subbyte_window_plain(small, nbits,
                                                          win)):
            fail(f"windowed {nbits}-bit unpack differs from plain")
    say("check unpack_subbyte_window: bit-identical to plain at 2^28 bytes "
        "(2 bits) and with a window at 2^24 bytes (1/2/4 bits)")
    k_ms = cuda_ms(lambda: KU.unpack_subbyte_window(data, 2), 10)
    p_ms = cuda_ms(lambda: KU.unpack_subbyte_window_plain(data, 2), 2)
    nbytes = m + 4 * 4 * m
    # per output sample: one shift, one mask, one int-to-float convert
    rec = _record("unpack_subbyte_window", k_ms, p_ms, nbytes,
                  {"f32": 3 * 4 * m}, err, copy_gbps)
    del data, out
    torch.cuda.empty_cache()
    return rec


def check_rfi_chirp(copy_gbps: float) -> dict:
    """K2 at the production spectrum: 2^29 bins with the example cfg's
    RFI threshold, manual mask and DM.  Tolerance: 1e-6 of the largest
    output — the kernel's sincospif and the plain float64 trig of the same
    float32 argument differ by at most 1.5 ulp; the zapped bins must be
    the same set exactly (a flipped keep decision is a whole bin)."""
    import torch
    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.kernels import rfi_chirp as KR
    from srtb_tpu_torch.ops import dedisperse as dd
    from srtb_tpu_torch.ops import rfi
    cfg = Config()
    cfg.load_file(str(CFG_EXAMPLE))
    n = cfg.baseband_input_count // 2
    f_min, f_c, df = dd.spectrum_frequencies(cfg, n)
    norm = rfi.normalization_coefficient(n, cfg.spectrum_channel_count)
    zap = rfi.rfi_ranges_to_mask(rfi.eval_rfi_ranges(
        cfg.mitigate_rfi_freq_list), n, cfg.baseband_freq_low,
        cfg.baseband_bandwidth)
    keep = torch.from_numpy(~zap).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(12)
    spec = torch.randn(n, dtype=torch.complex64, device="cuda", generator=g)
    thr_rel = cfg.mitigate_rfi_average_method_threshold
    args = (norm, f_min, df, f_c, cfg.dm)
    thr = KR.rfi_threshold(spec, thr_rel)
    out = KR.rfi_s1_dedisperse(spec, thr, *args, keep=keep)
    ref = KR.rfi_s1_dedisperse_plain(spec, thr, *args, keep=keep)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not torch.equal(out == 0, ref == 0):
        fail("rfi_s1_dedisperse zaps other bins than plain: "
             f"{int(((out == 0) != (ref == 0)).sum())}")
    if not err <= 1e-6 * scale:
        fail(f"rfi_s1_dedisperse max_abs_err {err} > 1e-6 * {scale}")
    del ref
    torch.cuda.empty_cache()
    say(f"check rfi_s1_dedisperse: max_abs_err {err:.3e} <= 1e-6 x "
        f"{scale:.3e}; zapped set identical "
        f"({int((out == 0).sum())} of {n} bins)")
    k_ms = cuda_ms(lambda: KR.rfi_s1_dedisperse(spec, thr, *args,
                                                keep=keep), 10)
    p_ms = cuda_ms(lambda: KR.rfi_s1_dedisperse_plain(spec, thr, *args,
                                                      keep=keep), 2)
    nbytes = 8 * n + n + 4 + 8 * n
    # per bin: power/keep/scale/rotation ~12 float32 ops plus sincospif
    # (~20); the exact phase 10 float64 ops (one division counted as one)
    rec = _record("rfi_s1_dedisperse", k_ms, p_ms, nbytes,
                  {"f32": 32 * n, "f64": 10 * n}, err, copy_gbps)
    del spec, out, keep
    torch.cuda.empty_cache()
    return rec


def _planted_waterfall():
    """[2^11, 2^18] complex64 noise with planted rows: a NaN, an Inf, a
    zero first sample, an impulsive row (SK high) and a constant-modulus
    row (SK low)."""
    import torch
    f_len, t_len = 1 << LOG2_CHANNELS, 1 << (LOG2_N - 1 - LOG2_CHANNELS)
    g = torch.Generator(device="cuda").manual_seed(13)
    wf = torch.randn(f_len, t_len, dtype=torch.complex64, device="cuda",
                     generator=g)
    wf[5, 100] = complex(float("nan"), 0.0)
    wf[17, 200] = complex(float("inf"), 1.0)
    wf[33, 0] = 0
    wf[40, ::1000] *= 100
    wf[41] = torch.exp(1j * torch.rand(t_len, device="cuda", generator=g))
    return wf


def check_sk(copy_gbps: float) -> list:
    """K3 and K4 at the production waterfall [2^11, 2^18].  Tolerances:
    K3's sums to 1e-6 relative (both accumulate in float64 and round to
    float32; only the float64 summation order differs), NaN/Inf rows
    alike, first-sample powers and the zap verdicts identical; K4's zapped
    waterfall bit-identical (a select), its time series to 1e-6
    relative."""
    import torch
    from srtb_tpu_torch.kernels import sk as KS
    from srtb_tpu_torch.ops import rfi
    wf = _planted_waterfall()
    t_len = wf.shape[1]
    s2, s4, fs0 = KS.sk_stats(wf)
    r2, r4, rf0 = KS.sk_stats_plain(wf)
    torch.cuda.synchronize()

    def rel_err(a, b):
        both = torch.isfinite(a) & torch.isfinite(b)
        if not torch.equal(torch.isnan(a), torch.isnan(b)) or not \
                torch.equal(a[~both].nan_to_num(), b[~both].nan_to_num()):
            fail("sk: non-finite entries differ from plain")
        return float(((a - b).abs() / b.abs())[both].max())

    e2, e4 = rel_err(s2, r2), rel_err(s4, r4)
    if not (e2 <= 1e-6 and e4 <= 1e-6 and torch.equal(fs0, rf0)):
        fail(f"sk_stats differs from plain: s2 {e2}, s4 {e4}")
    sk_thr = 1.05  # the example cfg's spectral-kurtosis threshold
    zap = rfi.sk_zap_decision(s2, s4, t_len, sk_thr)
    if not torch.equal(zap, rfi.sk_zap_decision(r2, r4, t_len, sk_thr)):
        fail("sk zap verdicts differ between kernel and plain statistics")
    if not (zap[40] and zap[41]):
        fail("sk: planted impulsive / constant-modulus rows not zapped")
    zap[5] = True   # a zapped row holding a NaN must come out as zeros
    say(f"check sk_stats: rel err s2 {e2:.2e}, s4 {e4:.2e} <= 1e-6; fs0 "
        f"and zap verdicts identical ({int(zap.sum())} rows zapped)")
    err_k3 = max(float((s2 - r2).abs().nan_to_num().max()),
                 float((s4 - r4).abs().nan_to_num().max()))
    out, ts = KS.sk_apply_timeseries(wf, zap)
    ref_out, ref_ts = KS.sk_apply_timeseries_plain(wf, zap)
    torch.cuda.synchronize()
    if not torch.equal(torch.view_as_real(out).nan_to_num(),
                       torch.view_as_real(ref_out).nan_to_num()) \
            or bool(out[5].abs().max() != 0):
        fail("sk_apply_timeseries waterfall differs from plain")
    e_ts = rel_err(ts, ref_ts)
    if not e_ts <= 1e-6:
        fail(f"sk_apply_timeseries time series rel err {e_ts}")
    err_k4 = float((ts - ref_ts).abs().nan_to_num().max())
    say(f"check sk_apply_timeseries: waterfall bit-identical, time series "
        f"rel err {e_ts:.2e} <= 1e-6")
    del ref_out, out, ref_ts, r2, r4, rf0
    torch.cuda.empty_cache()
    f_len = wf.shape[0]
    n = wf.numel()
    recs = [
        _record("sk_stats", cuda_ms(lambda: KS.sk_stats(wf), 10),
                cuda_ms(lambda: KS.sk_stats_plain(wf), 2),
                8 * n + 12 * f_len,
                # per value: |x|^2 (3 f32), two float64 adds and a multiply
                {"f32": 3 * n, "f64": 3 * n}, err_k3, copy_gbps),
        _record("sk_apply_timeseries",
                cuda_ms(lambda: KS.sk_apply_timeseries(wf, zap), 10),
                cuda_ms(lambda: KS.sk_apply_timeseries_plain(wf, zap), 2),
                16 * n + f_len + 4 * t_len,
                # per value: the select, |x|^2 (3 f32), one float64 add
                {"f32": 4 * n, "f64": n}, err_k4, copy_gbps),
    ]
    del wf
    torch.cuda.empty_cache()
    return recs


def check_unpack_planes(copy_gbps: float) -> dict:
    """B13 at the 2^27-sample segment: 2^25 bytes of 2-bit samples into
    the packed plane pairs z [2, 2^25], no window (the example cfg's
    rectangle); plus a windowed check at 2^20 bytes for 1/2/4 bits.
    Tolerance: exact — both spell the same integer fields and one float32
    multiply."""
    import torch
    from srtb_tpu_torch.kernels import unpack as KU
    g = torch.Generator(device="cuda").manual_seed(21)
    m = 1 << (LOG2_N_ROWS - 2)
    data = torch.randint(0, 256, (m,), dtype=torch.uint8, device="cuda",
                         generator=g)
    out = KU.unpack_subbyte_planes_window(data, 2)
    ref = KU.unpack_subbyte_planes_window_plain(data, 2)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fail("unpack_subbyte_planes_window differs from plain: "
             f"{float((out - ref).abs().max())}")
    del ref
    small = data[: 1 << 20]
    for nbits in (1, 2, 4):
        win = torch.rand(8 // nbits, small.numel(), device="cuda",
                         generator=g)
        if not torch.equal(
                KU.unpack_subbyte_planes_window(small, nbits, win),
                KU.unpack_subbyte_planes_window_plain(small, nbits, win)):
            fail(f"windowed {nbits}-bit planes unpack differs from plain")
    say("check unpack_subbyte_planes_window: bit-identical to plain at 2^25 "
        "bytes (2 bits) and with window planes at 2^20 bytes (1/2/4 bits)")
    k_ms = cuda_ms(lambda: KU.unpack_subbyte_planes_window(data, 2), 10)
    p_ms = cuda_ms(lambda: KU.unpack_subbyte_planes_window_plain(data, 2),
                   3)
    # reads m bytes, writes 2 complex64 per byte; per output float one
    # shift, one mask, one int-to-float convert
    rec = _record("unpack_subbyte_planes_window", k_ms, p_ms, m + 16 * m,
                  {"f32": 3 * 4 * m}, 0.0, copy_gbps)
    del data, out
    torch.cuda.empty_cache()
    return rec


def _fft_err(got, want) -> tuple[float, float]:
    return float((got - want).abs().max()), float(want.abs().max())


def turns(kernel, library, reps: int = 10) -> tuple[float, float]:
    """Mean device times of ``kernel`` and ``library`` timed in turns
    (kernel, library, library, kernel) in the same call, so that both see
    the same card and clocks."""
    k1, l1, l2, k2 = (cuda_ms(kernel, reps), cuda_ms(library, reps),
                      cuda_ms(library, reps), cuda_ms(kernel, reps))
    return (k1 + k2) / 2, (l1 + l2) / 2


def row_length_geometry(label: str, query, var: str = "L") -> dict:
    """Print and return the launch geometry ``query(length, device)``
    reports at every row length 2^12 ... 2^16 (one of the row-FFT core's
    geometry queries: B6/B10's or an epilogue kernel's): CTAs a cluster
    (B12: a pair cluster), values a CTA, threads, CTAs an SM, the CTAs or
    clusters the occupancy query says the card holds at once (B8: the
    persistent groups it launches), registers and spilled bytes a thread,
    shared bytes a CTA."""
    import torch
    geo = {}
    for log2 in range(12, 17):
        geo[f"2^{log2}"] = query(1 << log2, torch.device("cuda"))
        say(f"{label} {var}=2^{log2}: " + json.dumps(geo[f"2^{log2}"]))
    return geo


def time_rows(label, shape, inverse, kernel, g, gate) -> dict:
    """One shape of B6 or B10: checked against ``torch.fft`` (the plain
    version) within ``gate`` of the largest, then timed in turns with it."""
    import torch
    x = torch.randn(*shape, dtype=torch.complex64, device="cuda",
                    generator=g)

    def library():
        if inverse:
            return torch.fft.ifft(x, norm="forward")
        return torch.fft.fft(x)
    err, scale = _fft_err(kernel(x, inverse), library())
    if not err <= gate * scale:
        fail(f"{label} {list(shape)} inverse={inverse}: {err} > {gate} x "
             f"{scale}")
    k_ms, l_ms = turns(lambda: kernel(x, inverse), library)
    b_ms = 16 * x.numel() / PEAK_BYTES_PER_S * 1e3
    say(f"{label} {list(shape)} inverse={inverse}: kernel {k_ms:.4f} ms, "
        f"torch.fft {l_ms:.4f} ms (in turns), bound {b_ms:.4f} ms "
        f"({100 * b_ms / k_ms:.1f}% of it), kernel / torch.fft "
        f"{k_ms / l_ms:.3f}, max_abs_err {err:.3e} <= {gate} x {scale:.3e}")
    del x
    torch.cuda.empty_cache()
    return {"shape": list(shape), "inverse": inverse, "ms": k_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "max_abs_err": err}


def column_geometry_lines() -> dict:
    """Print and return the launch geometry of B9's and B11's clustered
    column body at both column lengths: CTAs a cluster, columns a
    cluster, rows a CTA, threads, CTAs an SM, the clusters the occupancy
    query says the card holds at once, registers and spilled bytes a
    thread, shared bytes a CTA."""
    import torch
    from srtb_tpu_torch.kernels import fft2 as K2
    geo = {}
    for name, front in (("fft2_pass1", False), ("fft2_pass1_front", True)):
        for n1 in K2.N1_CHOICES:
            key = f"{name} n1={n1}"
            geo[key] = K2.pass1_geometry(n1, torch.device("cuda"), front)
            say(f"column body geometry {key}: " + json.dumps(geo[key]))
    return geo


def time_columns(label, kernel, x, nbytes, err) -> dict:
    """``kernel`` (B9 or B11, whose column FFT runs on ``x [..., n1, n2]``'s
    values) timed in turns with cuFFT's column FFT of ``x``
    (``torch.fft.fft`` along dim -2: no four-step twiddle, so a reference
    point and not the same function); the bound is the kernel's own
    ``nbytes`` over the card's memory rate."""
    import torch
    k_ms, c_ms = turns(kernel, lambda: torch.fft.fft(x, dim=-2))
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    say(f"{label} {list(x.shape)}: kernel {k_ms:.4f} ms, cuFFT column FFT "
        f"(torch.fft.fft dim=-2, no twiddle) {c_ms:.4f} ms (in turns), "
        f"bound {b_ms:.4f} ms ({100 * b_ms / k_ms:.1f}% of it), kernel "
        f"/ cuFFT column {k_ms / c_ms:.3f}, max_abs_err {err:.3e}")
    return {"shape": list(x.shape), "ms": k_ms, "cufft_column_ms": c_ms,
            "bound_ms": b_ms, "max_abs_err": err}


def check_fft_rows(copy_gbps: float) -> dict:
    """B6 at every row length 2^12 ... 2^16 in both directions (one CTA;
    clusters of 2, 4 and 8) on 8 rows, then timed at every shape a main
    path gives it: the two legs of the 2^27 segment FFT (forward rows
    [2 x 2^13, 2^12] and [2 x 2^12, 2^13]), the legs of the staged
    ``pallas`` rows front at 2^30 (one 2^29 plane as [2^15, 2^14] and
    [2^14, 2^15]) and the waterfall rows [2^11, 2^15], inverse.  Tolerance:
    1e-5 of the largest |plain| (float32 FFTs of two algorithms: errors
    grow like eps log2 L).  Each shape is timed in turns with the library
    call, torch.fft (cuFFT), which is also the plain version; the record's
    times are the mean of the two 2^27 legs, per launch."""
    import torch
    from srtb_tpu_torch.kernels import fft_rows as KF
    g = torch.Generator(device="cuda").manual_seed(22)
    worst = 0.0
    for log2 in range(12, 17):
        x = torch.randn(8, 1 << log2, dtype=torch.complex64, device="cuda",
                        generator=g)
        for inverse in (False, True):
            err, scale = _fft_err(KF.fft_rows(x, inverse),
                                  KF.fft_rows_plain(x, inverse))
            if not err <= 1e-5 * scale:
                fail(f"fft_rows L=2^{log2} inverse={inverse}: {err} > "
                     f"1e-5 x {scale}")
            worst = max(worst, err / scale)
    say(f"check fft_rows: every L in 2^12..2^16 both ways within 1e-5 of "
        f"the largest (worst {worst:.2e})")
    legs = [(2 << 13, 1 << 12), (2 << 12, 1 << 13)]
    by_shape = [time_rows("fft_rows leg", leg, False, KF.fft_rows, g, 1e-5)
                for leg in legs]
    plane = 1 << (LOG2_N - 1)
    for length in (1 << 14, 1 << 15):
        by_shape.append(time_rows("fft_rows staged pallas front leg",
                                  (plane // length, length), False,
                                  KF.fft_rows, g, 1e-5))
    wf = (1 << LOG2_CHANNELS, 1 << (LOG2_N_ROWS - 1 - LOG2_CHANNELS))
    by_shape.append(time_rows("fft_rows waterfall rows", wf, True,
                              KF.fft_rows, g, 1e-5))
    n = 1 << (LOG2_N_ROWS - 1)  # complex values per leg
    k_ms, l_ms = (sum(t[k] for t in by_shape[:2]) / 2
                  for k in ("ms", "library_ms"))
    err_legs = max(t["max_abs_err"] for t in by_shape[:2])
    # the plain version is torch.fft itself: its time is the library's
    # per leg: 8 B read + 8 B written per value; ~5 log2(L) flops per value
    rec = _record("fft_rows", k_ms, l_ms, 16 * n,
                  {"f32": 5 * n * 12.5}, err_legs, copy_gbps, l_ms)
    rec["by_shape"] = by_shape
    rec["geometry"] = row_length_geometry("row-FFT core geometry",
                                          KF.geometry)
    return rec


def _wf_rows(g):
    """The fused 2^27 path's waterfall shape: [2^11, 2^15] complex64."""
    import torch
    f_len = 1 << LOG2_CHANNELS
    t_len = 1 << (LOG2_N_ROWS - 1 - LOG2_CHANNELS)
    return torch.randn(f_len, t_len, dtype=torch.complex64, device="cuda",
                       generator=g)


def _sum_err(got, want) -> float:
    """Max relative error of per-row sums; a sum that overflows float32
    (|x|^4 past the hann de-window's near-zero edges) must overflow in
    both."""
    import torch
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(
            got[~fin], want[~fin]):
        fail("fft_rows_stats: non-finite sums differ from plain")
    rel = ((got - want).abs() / want.abs())[fin]
    return float(rel.max()) if rel.numel() else 0.0


def check_fft_rows_stats(copy_gbps: float) -> dict:
    """B7 (inverse, no de-window: the example cfg's rectangle) on the
    2^27 path's waterfall rows [2^11, 2^15], and with a hann de-window at
    every row length on 8 rows.  Tolerances: rows within 1e-5 of the
    largest; sums within 1e-6 relative (1e-5 with the hann de-window,
    whose near-zero edges amplify single values' rounding).  Timed in
    turns with B6, its row FFT alone, on the same rows, with B7's launch
    geometry at every row length."""
    import torch
    from srtb_tpu_torch.kernels import fft_rows as KF
    from srtb_tpu_torch.ops import window as W
    g = torch.Generator(device="cuda").manual_seed(23)
    for log2 in range(12, 17):
        x = torch.randn(8, 1 << log2, dtype=torch.complex64, device="cuda",
                        generator=g)
        dw = torch.from_numpy(W.dewindow_coefficients("hann", 1 << log2)
                              ).to("cuda")
        y, s2, s4 = KF.fft_rows_stats(x, True, dw)
        ry, r2, r4 = KF.fft_rows_stats_plain(x, True, dw)
        err, scale = _fft_err(y, ry)
        e2, e4 = _sum_err(s2, r2), _sum_err(s4, r4)
        if not (err <= 1e-5 * scale and e2 <= 1e-5 and e4 <= 1e-5):
            fail(f"fft_rows_stats L=2^{log2}: {err} vs {scale}, {e2}, {e4}")
    x = _wf_rows(g)
    y, s2, s4 = KF.fft_rows_stats(x)
    ry, r2, r4 = KF.fft_rows_stats_plain(x)
    err, scale = _fft_err(y, ry)
    e2, e4 = _sum_err(s2, r2), _sum_err(s4, r4)
    if not (err <= 1e-5 * scale and e2 <= 1e-6 and e4 <= 1e-6):
        fail(f"fft_rows_stats [2^11, 2^15]: {err} vs {scale}, {e2}, {e4}")
    say(f"check fft_rows_stats: rows max_abs_err {err:.3e} <= 1e-5 x "
        f"{scale:.3e}, sums rel err {e2:.2e} / {e4:.2e} <= 1e-6 at "
        "[2^11, 2^15]; every L with a hann de-window within 1e-5")
    del y, ry
    geo = row_length_geometry("fft_rows_stats geometry",
                              KF.stats_geometry)
    # in turns with B6, its row FFT alone, on the same rows (a reference
    # point: B6 does not compute B7's function)
    k_ms, b6_ms = turns(lambda: KF.fft_rows_stats(x),
                        lambda: KF.fft_rows(x, True))
    n, f_len = x.numel(), x.shape[0]
    nbytes = 16 * n + 8 * f_len
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    say(f"fft_rows_stats {list(x.shape)}: B7 {k_ms:.4f} ms, B6 (its "
        f"inverse row FFT alone) on the same rows {b6_ms:.4f} ms (in "
        f"turns), bound {b_ms:.4f} ms ({100 * b_ms / k_ms:.1f}% of it), "
        f"B7 / B6 {k_ms / b6_ms:.3f}")
    rec = _record("fft_rows_stats", k_ms,
                  cuda_ms(lambda: KF.fft_rows_stats_plain(x), 3), nbytes,
                  # the FFT, |x|^2 (3 f32), float64 sum, square, sum
                  {"f32": 5 * n * 15 + 3 * n, "f64": 3 * n}, err, copy_gbps)
    rec["b6_same_rows_ms"] = b6_ms
    rec["geometry"] = geo
    del x
    torch.cuda.empty_cache()
    return rec


def _sk_margin_ok(got, want, s2, s4, length, sk_thr) -> int:
    """Rows whose verdicts differ between kernel and plain must lie within
    1e-5 relative of an SK bound (float32 rounding of two FFTs can flip
    only those); returns how many differ."""
    import torch
    from srtb_tpu_torch.ops import rfi
    diff = got != want
    if bool(diff.any()):
        sk = (length * s4.double() / (s2.double() ** 2))[diff]
        lo, hi = rfi.sk_decision_thresholds(length, sk_thr)
        near = torch.minimum((sk - float(lo)).abs() / float(lo),
                             (sk - float(hi)).abs() / float(hi))
        if not bool((near <= 1e-5).all()):
            fail(f"fft_rows_skzap verdicts differ away from the bounds: "
                 f"rows {diff.nonzero().flatten().tolist()}")
    return int(diff.sum())


def check_fft_rows_skzap(copy_gbps: float) -> dict:
    """B8 (inverse, no de-window) on the 2^27 path's waterfall rows
    [2^11, 2^15] with planted rows — a NaN row (SK NaN: kept, its values
    NaN, and so the whole time series NaN), an impulsive row (SK high), a
    constant-modulus row (SK low) and an all-zero row (zero first sample)
    — and the same rows with the NaN row replaced by noise for the time
    series; also on 8 rows at every row length.  Tolerances: verdicts,
    zero-sample flags and NaN positions identical (a verdict may differ
    only for a row within 1e-5 of an SK bound, and such a row is left out
    of the waterfall check), the zapped waterfall and the first-sample
    powers within 1e-5 of the largest, the time series within the repo's
    ``time_series_error_gates`` of the plain series over the rows the
    kernel kept, for the measured
    waterfall error (float32 summation plus that error carried through
    |x|^2 and the sum over rows)."""
    import torch
    from srtb_tpu_torch.kernels import fft_rows as KF
    from srtb_tpu_torch.ops import detect as det
    from srtb_tpu_torch.ops import rfi
    sk_thr = 1.05  # the example cfg's spectral-kurtosis threshold
    g = torch.Generator(device="cuda").manual_seed(24)

    def compare(x, where):
        got = KF.fft_rows_skzap(x, sk_thr)
        want = KF.fft_rows_skzap_plain(x, sk_thr)
        y, s2, s4 = KF.fft_rows_stats_plain(x)
        flips = _sk_margin_ok(got[1], want[1], s2, s4, x.shape[1], sk_thr)
        # a row whose verdict flipped is left out of the waterfall check,
        # and the plain time series is taken over the rows the kernel kept
        same = (got[1] == want[1])[:, None]
        nan_g = torch.isnan(got[0])
        if not torch.equal(nan_g & same, torch.isnan(want[0]) & same):
            fail(f"fft_rows_skzap {where}: NaN positions differ")
        fin = ~nan_g & same
        err, scale = _fft_err(got[0][fin], want[0][fin])
        if not err <= 1e-5 * scale:
            fail(f"fft_rows_skzap {where}: {err} > 1e-5 x {scale}")
        if not torch.equal(got[2] == 0, want[2] == 0):
            fail(f"fft_rows_skzap {where}: zero-sample flags differ")
        fe, _scale = _fft_err(got[2].nan_to_num(), want[2].nan_to_num())
        if not fe <= 1e-5 * float(want[2].nan_to_num().max()):
            fail(f"fft_rows_skzap {where}: first-sample power err {fe}")
        ts_want = torch.where(got[1][:, None], 0.0, rfi.power(y)).to(
            torch.float64).sum(0).to(torch.float32)
        del y
        ts_ok = torch.isfinite(ts_want)
        if not torch.equal(ts_ok, torch.isfinite(got[3])):
            fail(f"fft_rows_skzap {where}: time series finiteness differs")
        if bool(ts_ok.any()):
            e_ts = float((got[3] - ts_want).abs()[ts_ok].max())
            gates = det.time_series_error_gates(
                x.shape[0], x.shape[1], float(ts_want[ts_ok].max()), err)
            if not e_ts <= sum(gates):
                fail(f"fft_rows_skzap {where}: time series err {e_ts} > "
                     f"{sum(gates)}")
        return got, want, flips, err

    flips = 0
    for log2 in range(12, 17):
        x = torch.randn(8, 1 << log2, dtype=torch.complex64, device="cuda",
                        generator=g)
        x[3] = torch.fft.fft(torch.fft.ifft(x[3]) * torch.where(
            torch.arange(1 << log2, device="cuda") % 64 == 0, 30.0, 1.0))
        flips += compare(x, f"L=2^{log2}")[2]
    wf = _wf_rows(g)
    wf[10, ::1000] *= 100
    wf[11] = torch.exp(1j * torch.rand(wf.shape[1], device="cuda",
                                       generator=g))
    wf[13] = 0
    length = wf.shape[1]
    x = torch.fft.fft(wf) / length  # rows whose inverse FFT is wf
    del wf
    got, want, f1, err = compare(x, "[2^11, 2^15]")
    flips += f1
    if not (bool(got[1][10]) and bool(got[1][11]) and not bool(got[1][13])
            and float(got[2][13]) == 0.0):
        fail("fft_rows_skzap: planted rows not zapped / flagged as planted")
    x_nan = x.clone()
    x_nan[5, 100] = complex(float("nan"), 0.0)
    got_n, _w, f2, _e = compare(x_nan, "[2^11, 2^15] with a NaN row")
    flips += f2
    if bool(got_n[1][5]) or not bool(torch.isnan(got_n[0][5]).all()) \
            or bool(torch.isfinite(got_n[3]).any()):
        fail("fft_rows_skzap: the NaN row must be kept, NaN throughout, "
             "and the time series NaN")
    del x_nan, got_n, _w
    say(f"check fft_rows_skzap: verdicts, zero flags and NaN positions "
        f"identical ({int(got[1].sum())} of {x.shape[0]} rows zapped; "
        f"{flips} verdicts within 1e-5 of a bound differ), waterfall "
        f"max_abs_err {err:.3e} within 1e-5 of the largest, time series "
        "within the time_series_error_gates; every L alike")
    geo = row_length_geometry("fft_rows_skzap geometry",
                              KF.skzap_geometry)
    del got, want
    # in turns with B6, its row FFT alone, on the same rows (a reference
    # point: B6 does not compute B8's function)
    k_ms, b6_ms = turns(lambda: KF.fft_rows_skzap(x, sk_thr),
                        lambda: KF.fft_rows(x, True))
    n, f_len = x.numel(), x.shape[0]
    nbytes = 16 * n + 5 * f_len + 4 * length
    say(f"fft_rows_skzap {list(x.shape)}: B8 {k_ms:.4f} ms, B6 (its inverse "
        f"row FFT alone) on the same rows {b6_ms:.4f} ms (in turns), bound "
        f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms "
        f"({100 * nbytes / PEAK_BYTES_PER_S * 1e3 / k_ms:.1f}% of it), "
        f"B8 / B6 {k_ms / b6_ms:.3f}")
    rec = _record("fft_rows_skzap", k_ms,
                  cuda_ms(lambda: KF.fft_rows_skzap_plain(x, sk_thr), 3),
                  nbytes,
                  # the FFT, |x|^2 (3 f32) and the time series add, select;
                  # float64 moments
                  {"f32": 5 * n * 15 + 5 * n, "f64": 3 * n}, err, copy_gbps)
    rec["b6_same_rows_ms"] = b6_ms
    rec["geometry"] = geo
    del x
    torch.cuda.empty_cache()
    return rec


def check_dedisperse(copy_gbps: float) -> dict:
    """B3 at the production spectrum: 2^29 bins with the example cfg's DM
    (i0 = 0), and 2^12 bins at i0 = 2^26 + 1024 of a 2^27-bin spectrum,
    past float32's exact integers.  Tolerance: 1e-6 of the largest output,
    as K2's check — the same phase code (srtb::chirp), sincospif against
    the plain float64 trig of the same float32 argument."""
    import torch
    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.kernels import dedisperse as KD
    from srtb_tpu_torch.ops import dedisperse as dd
    cfg = Config()
    cfg.load_file(str(CFG_EXAMPLE))
    n = cfg.baseband_input_count // 2
    f_min, f_c, df = dd.spectrum_frequencies(cfg, n)
    g = torch.Generator(device="cuda").manual_seed(14)
    cases = [(n, 0, df), (1 << 12, (1 << 26) + 1024,
                          cfg.baseband_bandwidth / (1 << 27))]
    worst = 0.0
    for bins, i0, d in cases:
        spec = torch.randn(bins, dtype=torch.complex64, device="cuda",
                           generator=g)
        out = KD.dedisperse(spec, f_min, d, f_c, cfg.dm, i0=i0)
        ref = KD.dedisperse_plain(spec, f_min, d, f_c, cfg.dm, i0=i0)
        torch.cuda.synchronize()
        err, scale = _fft_err(out, ref)
        if not err <= 1e-6 * scale:
            fail(f"dedisperse {bins} bins at i0 {i0}: max_abs_err {err} > "
                 f"1e-6 x {scale}")
        worst = max(worst, err)
        del out, ref
    say(f"check dedisperse: within 1e-6 of the largest at 2^29 bins (i0 0) "
        f"and 2^12 bins at i0 2^26 + 1024 (max_abs_err {worst:.3e})")
    spec = torch.randn(n, dtype=torch.complex64, device="cuda", generator=g)
    args = (f_min, df, f_c, cfg.dm)
    k_ms = cuda_ms(lambda: KD.dedisperse(spec, *args), 10)
    p_ms = cuda_ms(lambda: KD.dedisperse_plain(spec, *args), 2)
    # per bin: the float64 phase (~10 ops, one division counted as one);
    # sincospif (~20) and the rotation (6) in float32
    rec = _record("dedisperse", k_ms, p_ms, 16 * n,
                  {"f32": 26 * n, "f64": 10 * n}, worst, copy_gbps)
    del spec
    torch.cuda.empty_cache()
    return rec


def check_fft2(copy_gbps: float, b10_2_30_before: float) -> list:
    """B9 and B10 at the pallas2 path's shape — the two packed planes of
    the 2^27-sample segment, [2, 4096, 8192] — and on one block at
    (4096, 4096), (4096, 2^14), (4096, 2^15), (4096, 2^16) and (8192,
    2^16): both column lengths, every row length, rows of 2^15 and 2^16 on
    clusters; forward and inverse.  Then the composed ``fft2_c2c`` (B9,
    B10, unblock) against ``torch.fft.fft`` on the same [2, 2^25].
    Tolerance: 2e-5 of the largest |plain|, the reference's own gate for
    the two-pass C2C (tests/test_pallas_fft2.py:48).  Times at the path's
    shape; B10's library call is ``torch.fft.fft`` along the rows (cuFFT),
    timed in turns with B10 at the pallas2 path's shape (before and after
    B9's timing at 2^30) and at the staged
    pallas2 2^30 path's [8192, 65536]; B9 timed in turns with cuFFT's
    column FFT alone (``torch.fft.fft`` along the columns, no twiddle: a
    reference point, not a library call of the same function) at the same
    two shapes, its record's time at the first."""
    import torch
    from srtb_tpu_torch.kernels import fft2 as K2
    g = torch.Generator(device="cuda").manual_seed(25)
    worst = {"fft2_pass1": 0.0, "fft2_pass2": 0.0}
    b9_err = {}  # B9's error at the two main-path shapes
    shapes = [(2, 4096, 8192), (1, 4096, 4096), (1, 4096, 1 << 14),
              (1, 4096, 1 << 15), (1, 4096, 1 << 16), (1, 8192, 1 << 16)]
    for shape in shapes:
        x = torch.randn(*shape, dtype=torch.complex64, device="cuda",
                        generator=g)
        for inverse in (False, True):
            for name, kernel, plain in (
                    ("fft2_pass1", K2.fft2_pass1, K2.fft2_pass1_plain),
                    ("fft2_pass2", K2.fft2_pass2, K2.fft2_pass2_plain)):
                err, scale = _fft_err(kernel(x, inverse), plain(x, inverse))
                if not err <= 2e-5 * scale:
                    fail(f"{name} {shape} inverse={inverse}: {err} > 2e-5 x "
                         f"{scale}")
                if shape == shapes[0]:
                    worst[name] = max(worst[name], err)
                if name == "fft2_pass1" and shape in (shapes[0], shapes[-1]):
                    b9_err[shape] = max(b9_err.get(shape, 0.0), err)
        del x
        K2.twiddle.cache_clear()
        torch.cuda.empty_cache()
    x = torch.randn(2, 1 << 25, dtype=torch.complex64, device="cuda",
                    generator=g)
    err, scale = _fft_err(K2.fft2_c2c(x), torch.fft.fft(x))
    if not err <= 2e-5 * scale:
        fail(f"fft2_c2c [2, 2^25]: {err} > 2e-5 x {scale}")
    say(f"check fft2_pass1 / fft2_pass2: every shape both ways within 2e-5 "
        f"of the largest; fft2_c2c [2, 2^25] against torch.fft.fft "
        f"max_abs_err {err:.3e} <= 2e-5 x {scale:.3e}")
    c2c_ms = cuda_ms(lambda: K2.fft2_c2c(x), 10)
    c2c_lib = cuda_ms(lambda: torch.fft.fft(x), 10)
    b = x.reshape(2, *K2.factor(x.shape[-1]))
    p1 = K2.fft2_pass1(b)
    unblock_ms = cuda_ms(lambda: K2.unblock(p1), 10)
    say(f"fft2 {list(b.shape)}: unblock transpose {unblock_ms:.4f} ms; "
        f"fft2_c2c composed {c2c_ms:.4f} ms against one torch.fft.fft of "
        f"[2, 2^25] {c2c_lib:.4f} ms")
    n = b.numel()
    plain_ms = cuda_ms(lambda: K2.fft2_pass1_plain(b), 10)
    del x, b
    K2.twiddle.cache_clear()
    torch.cuda.empty_cache()
    # B10 at the pallas2 path's shape also before B9's timing at [1, 8192,
    # 65536] makes and frees its tensors, to set beside its time after it
    b10_first = time_rows("fft2_pass2 (before B9's 2^30 timing)",
                          (2, 4096, 8192), False, K2.fft2_pass2, g, 2e-5)
    # B9 in turns with cuFFT's column FFT at the pallas2 path's shape and
    # at the staged pallas2 2^30 path's [1, 8192, 65536]
    b9_shapes = []
    for shape in (shapes[0], shapes[-1]):
        x = torch.randn(*shape, dtype=torch.complex64, device="cuda",
                        generator=g)
        b9_shapes.append(time_columns("fft2_pass1", lambda: K2.fft2_pass1(x),
                                      x, 16 * x.numel(), b9_err[shape]))
        del x
        torch.cuda.empty_cache()
    # the column FFT ~5 log2(n1) flops a value; the four-step twiddle (four
    # sincospif a thread of 32 values, two products a value) ~12
    recs = [_record("fft2_pass1", b9_shapes[0]["ms"], plain_ms, 16 * n,
                    {"f32": 5 * n * 12 + 12 * n}, worst["fft2_pass1"],
                    copy_gbps)]
    recs[0]["by_shape"] = b9_shapes
    recs[0]["cufft_column_ms"] = b9_shapes[0]["cufft_column_ms"]
    recs[0]["geometry"] = column_geometry_lines()
    # B10 in turns with torch.fft.fft along the same rows: at the pallas2
    # path's [2, 4096, 8192] (pass 1's output) and at the staged pallas2
    # 2^30 path's [8192, 65536]
    by_shape = []
    for shape in ((2, 4096, 8192), (1, 8192, 1 << 16)):
        by_shape.append(time_rows("fft2_pass2", shape, False, K2.fft2_pass2,
                                  g, 2e-5))
    k_ms, l_ms = by_shape[0]["ms"], by_shape[0]["library_ms"]
    recs.append(_record("fft2_pass2", k_ms,
                        cuda_ms(lambda: K2.fft2_pass2_plain(p1), 10),
                        16 * n, {"f32": 5 * n * 13}, worst["fft2_pass2"],
                        copy_gbps, l_ms))
    recs[-1]["by_shape"] = by_shape
    recs[-1]["ms_before_b9_2^30"] = b10_first["ms"]
    recs[-1]["library_ms_before_b9_2^30"] = b10_first["library_ms"]
    # [8192, 65536] in turns with B12, before B9's 2^30 timing
    recs[-1]["ms_8192x65536_before_b9_2^30"] = b10_2_30_before
    say(f"fft2_pass2 [1, 8192, 65536]: {b10_2_30_before:.4f} ms before B9's "
        f"2^30 timing (in turns with B12), {by_shape[1]['ms']:.4f} ms after "
        "it (in turns with torch.fft)")
    del p1
    torch.cuda.empty_cache()
    return recs


def _packed_sums(z):
    """Exact float64 values of B11's sums from its packed input z [S, n1,
    n2], independent of any FFT: Parseval's sum |B|^2 = n1 sum |z|^2, the
    DC sum_j2 B[0, j2] = sum z (Re, Im), and sum |Re z|, sum |Im z|."""
    import torch
    out = torch.zeros(z.shape[0], 5, dtype=torch.float64, device=z.device)
    for blk in torch.view_as_real(z).split(1024, dim=1):
        v = blk.to(torch.float64)
        out[:, 0] += v.square().sum((1, 2, 3))
        out[:, 1:3] += v.sum((1, 2))
        out[:, 3:5] += v.abs().sum((1, 2))
    out[:, 0] *= z.shape[1]
    return out


def _sum_errors(aux, ref) -> tuple[float, float]:
    """(sum |B|^2 / Parseval's - 1 of the stream furthest from it, the
    largest DC error over sum |z|) of the sums ``aux`` against
    ``_packed_sums``."""
    e = aux[:, 0] / ref[:, 0] - 1
    energy = float(e[e.abs().argmax()])
    dc = float(((aux[:, 1:] - ref[:, 1:3]).abs() / ref[:, 3:]).max())
    return energy, dc


def _check_pass1_front(raw, m, variant, nbits, weo, inverse, z) -> tuple:
    """B11 against its plain version (2e-5 of the largest |plain|; the mean
    power from the sums within 1e-6 relative of the plain float64 sums'),
    against B9 on the packed values ``z`` (bit-identical), and its sums
    against their exact values from ``z`` (``_packed_sums``): sum |B|^2
    within 3e-7 relative of Parseval's, the DC within 1e-8 of sum |z|.
    Also returns the energy bias and DC error of B11's and the plain
    version's float32 column FFTs (``_sum_errors``)."""
    import torch
    from srtb_tpu_torch.kernels import fft2 as K2
    from srtb_tpu_torch.kernels import fft2_front as FF
    where = f"fft2_pass1_front m={m} {variant} {nbits} bits " \
        f"window={weo is not None} inverse={inverse}"
    n2 = K2.ffuse_factor(m)[1]
    b, aux = FF.fft2_pass1_front(raw, m, variant, nbits, weo, inverse)
    if not torch.equal(torch.view_as_real(b),
                       torch.view_as_real(K2.fft2_pass1(z, inverse))):
        fail(f"{where}: not bit-identical to B9 on the same packed values")
    pb, paux = FF.fft2_pass1_front_plain(raw, m, variant, nbits, weo,
                                         inverse)
    err, scale = _fft_err(b, pb)
    del pb
    if not err <= 2e-5 * scale:
        fail(f"{where}: {err} > 2e-5 x {scale}")
    mean = FF.front_mean_power(aux, n2, m)
    rel = float(((mean - FF.front_mean_power(paux, n2, m)).abs()
                 / mean.abs()).max())
    if not rel <= 1e-6:
        fail(f"{where}: mean power rel err {rel}")
    ref = _packed_sums(z)
    bias = (_sum_errors(aux, ref), _sum_errors(paux, ref))
    energy, dc = bias[0]
    if not (abs(energy) <= 3e-7 and dc <= 1e-8):
        fail(f"{where}: sum |B|^2 off Parseval's by {energy:.3e}, DC off "
             f"sum z by {dc:.3e} of sum |z|")
    return b, aux, err, scale, bias


def _check_pass2_spectrum(b, thr, norm, where, **kw) -> tuple:
    """B12 against its plain version: a zap decision may differ only on a
    bin whose power lies within 1e-5 relative of ``thr`` (float32 rounding
    of two FFTs), and those bins are left out of the value check; the
    rest within 5e-5 of the largest |plain| with the chirp (K2's chirp
    gate), 2e-5 without.  Returns (max_abs_err, flipped bins)."""
    import torch
    from srtb_tpu_torch.kernels import fft2_front as FF
    from srtb_tpu_torch.ops import rfi
    got = FF.fft2_pass2_spectrum(b, thr, norm, **kw)
    want = FF.fft2_pass2_spectrum_plain(b, thr, norm, **kw)
    same = (got == 0) == (want == 0)
    flips = int((~same).sum())
    if flips:
        # the plain spectrum's power before the zap, at the flipped bins
        x = FF.fft2_pass2_spectrum_plain(
            b, torch.full_like(thr, float("inf")), 1.0,
            premul=kw.get("premul"))
        p = rfi.power(x)[~same]
        del x
        if not bool(((p - thr).abs() <= 1e-5 * thr).all()):
            fail(f"fft2_pass2_spectrum {where}: {flips} zap decisions "
                 "differ away from the threshold")
    diff = torch.where(same, (got - want).abs(), 0.0)
    err = float(diff.max())
    scale = float(want.abs().max())
    gate = 5e-5 if kw.get("chirp") is not None else 2e-5
    if not err <= gate * scale:
        fail(f"fft2_pass2_spectrum {where}: {err} > {gate} x {scale}")
    # the rows that pair with themselves (0 and n1/2), each written by the
    # first half of its cluster alone
    for r in (0, b.shape[0] // 2):
        if not (bool(torch.isfinite(got[r]).all())
                and float(diff[r].max()) <= gate * scale):
            fail(f"fft2_pass2_spectrum {where}: self-paired row {r} off")
    return err, flips


def check_fft2_front(copy_gbps: float, k2_ms: float, b12: dict) -> list:
    """B11 and B12.  B11 at m = 2^24 (4096, 4096) for ``simple`` at 1, 2,
    4, 8 and -8 bits and ``interleaved_samples_2`` at 8 bits, windowed and
    not, both directions, then at the front-fused path's shape: 2^28 raw
    bytes of 2-bit samples, (n1, n2) = (8192, 65536), no window (the
    example cfg's rectangle).  Tolerances: the intermediate within 2e-5
    of the largest |plain| (the reference's gate,
    tests/test_pallas_fft2.py:48); bit-identical to B9 on the same packed
    values (K1 + pack at the path's shape, the plain unpack, window and
    pack at 2^24: one column body, the reference's own contract,
    tests/test_front_fuse.py:184-203); at the path's shape
    ``front_mean_power`` within 1e-5 relative of ``rfi.mean_power_packed``
    over the full C2C (tests/test_front_fuse.py:217).  B11 is timed in
    turns with cuFFT's column FFT of the same packed values.  B12 at the path's
    shape on B11's intermediate with the example cfg's keep mask and exact
    chirp (the path's form), and on noise at (4096, 2^12 ... 2^16) with
    and without the mask, with the exact chirp, the premul pair or
    neither, at the tolerances of :func:`_check_pass2_spectrum`.  Times at
    the path's shape, with B9 on the same [8192, 65536] beside B11 and K2
    at 2^29 bins beside B12."""
    import numpy as np
    import torch
    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.kernels import fft2 as K2
    from srtb_tpu_torch.kernels import fft2_front as FF
    from srtb_tpu_torch.kernels import unpack as KU
    from srtb_tpu_torch.ops import fft as F
    from srtb_tpu_torch.ops import rfi
    cfg = Config()
    cfg.load_file(str(CFG_EXAMPLE))
    g = torch.Generator(device="cuda").manual_seed(26)
    m = 1 << 24
    n1, n2 = K2.ffuse_factor(m)
    weo = tuple(torch.rand(n1, n2, device="cuda", generator=g)
                for _ in range(2))
    worst = 0.0
    biases = []
    for variant, nbits in (("simple", 1), ("simple", 2), ("simple", 4),
                           ("simple", 8), ("simple", -8),
                           ("interleaved_samples_2", 8)):
        size = FF.front_streams(variant) * 2 * m * abs(nbits) // 8
        raw = torch.randint(0, 256, (size,), dtype=torch.uint8,
                            device="cuda", generator=g)
        for w in (None, weo):
            z = FF.front_pack(raw, m, variant, nbits, w)
            for inverse in (False, True):
                _b, _aux, err, scale, bias = _check_pass1_front(
                    raw, m, variant, nbits, w, inverse, z)
                worst = max(worst, err / scale)
                biases.append(bias)
    say(f"check fft2_pass1_front at m = 2^24: every variant, width, "
        f"window and direction within 2e-5 of the largest (worst "
        f"{worst:.2e}), bit-identical to B9 on the same packed values, "
        "mean power within 1e-6 of the plain sums'; energy bias (sum "
        "|B|^2 / (n1 sum |z|^2) - 1) and DC error (over sum |z|) of B11 "
        "and of the plain version, by case: " + ", ".join(
            f"{k[0]:+.2e} {k[1]:.1e} / {p[0]:+.2e} {p[1]:.1e}"
            for k, p in biases))
    del raw, z, _b, weo
    K2.twiddle.cache_clear()

    # the front-fused 2^30 path's shape: K1 + pack is B9's input
    m = 1 << (LOG2_N - 1)
    n1, n2 = K2.ffuse_factor(m)
    raw = torch.randint(0, 256, (m // 2,), dtype=torch.uint8, device="cuda",
                        generator=g)
    z = F.pack_even_odd(KU.unpack_subbyte_window(raw, 2)).reshape(1, n1, n2)
    b, aux, err_b11, scale, bias = _check_pass1_front(raw, m, "simple", 2,
                                                      None, False, z)
    K2.twiddle.cache_clear()
    torch.cuda.empty_cache()
    mean = FF.front_mean_power(aux, n2, m)
    # over the float32 C2C, summed in float64: a float32 sum of 2^29
    # powers drifts by more than the gate
    want = rfi.mean_power_packed(torch.fft.fft(z.reshape(-1)).to(
        torch.complex128))
    rel = float(((mean - want).abs() / want).max())
    if not rel <= 1e-5:
        fail(f"front_mean_power rel err {rel} against mean_power_packed")
    say(f"check fft2_pass1_front at [{n1}, {n2}] (2-bit): max_abs_err "
        f"{err_b11:.3e} <= 2e-5 x {scale:.3e}, bit-identical to K1 + pack + "
        f"B9, front_mean_power within {rel:.2e} of mean_power_packed over "
        f"the full C2C; energy bias of B11 {bias[0][0]:+.2e}, of the plain "
        f"version {bias[1][0]:+.2e}; DC error over sum |z| of B11 "
        f"{bias[0][1]:.2e}, of the plain version {bias[1][1]:.2e}")
    torch.cuda.empty_cache()
    b11 = time_columns("fft2_pass1_front", lambda: FF.fft2_pass1_front(
        raw, m, "simple", 2), z, m // 2 + 8 * m, err_b11)
    p_ms = cuda_ms(lambda: FF.fft2_pass1_front_plain(raw, m, "simple", 2),
                   2)
    K2.twiddle.cache_clear()
    b9_ms = cuda_ms(lambda: K2.fft2_pass1(z), 10)
    say(f"fft2_pass1_front [{n1}, {n2}]: B11 {b11['ms']:.4f} ms beside B9 "
        f"on the same [{n1}, {n2}] (complex64 in, 16x the bytes read) "
        f"{b9_ms:.4f} ms")
    # reads the raw bytes once, writes the intermediate; the column FFT
    # ~5 log2(n1) flops a value, the four-step twiddle (~12), the unpack
    # (3 a sample); float64 |B|^2 sums (4 a value)
    recs = [_record("fft2_pass1_front", b11["ms"], p_ms, m // 2 + 8 * m,
                    {"f32": 5 * m * 13 + 12 * m + 6 * m, "f64": 4 * m},
                    err_b11, copy_gbps)]
    recs[0]["cufft_column_ms"] = b11["cufft_column_ms"]
    recs[0]["b9_same_shape_ms"] = b9_ms
    del z

    # B12 on B11's intermediate, the path's form
    keep, chirp, norm = _pass2_path_form(cfg, n1, n2)
    thr = np.float32(cfg.mitigate_rfi_average_method_threshold) \
        * FF.front_mean_power(aux, n2, m)
    b = b[0]
    err_b12, flips = _check_pass2_spectrum(b, thr, norm, f"[{n1}, {n2}]",
                                           keep=keep, chirp=chirp)
    F._hermitian_weights.cache_clear()
    torch.cuda.empty_cache()
    say(f"check fft2_pass2_spectrum at [{n1}, {n2}] with the example cfg's "
        f"keep mask and exact chirp: max_abs_err {err_b12:.3e} within 5e-5 "
        f"of the largest; {flips} zap decisions within 1e-5 of thr differ")
    k_ms = cuda_ms(lambda: FF.fft2_pass2_spectrum(b, thr, norm, keep=keep,
                                                  chirp=chirp), 10)
    p_ms = cuda_ms(lambda: FF.fft2_pass2_spectrum_plain(
        b, thr, norm, keep=keep, chirp=chirp), 2)
    F._hermitian_weights.cache_clear()
    say(f"fft2_pass2_spectrum [{n1}, {n2}] on B11's intermediate: B12 "
        f"{k_ms:.4f} ms after B9's 2^30 timing ({b12['ms']:.4f} ms before "
        f"it, in turns with B10's {b12['b10_same_input_ms']:.4f}), beside "
        f"K2 at 2^29 bins (its stage 1 and chirp alone) {k2_ms:.4f} ms")
    # reads the intermediate and the keep mask, writes the spectrum; the
    # row FFT ~5 log2(n2) flops a value, the Hermitian post, zap, scale,
    # twiddle and rotation ~40; the float64 chirp phase ~10
    recs.append(_record("fft2_pass2_spectrum", b12["ms"], p_ms, 17 * m,
                        {"f32": 5 * m * 16 + 40 * m, "f64": 10 * m},
                        err_b12, copy_gbps))
    recs[-1]["b10_same_input_ms"] = b12["b10_same_input_ms"]
    recs[-1]["ms_after_b9_2^30"] = k_ms
    recs[-1]["geometry"] = b12["geometry"]
    del b, aux, keep, raw
    torch.cuda.empty_cache()

    # B12 on noise at every row length and both column lengths, every form
    flips = 0
    for n1, n2 in [(n1, 1 << k) for n1 in K2.N1_CHOICES
                   for k in range(12, 17)]:
        m = n1 * n2
        x = torch.randn(n1, n2, dtype=torch.complex64, device="cuda",
                        generator=g)
        thr = torch.tensor([6.0 * n2], device="cuda")
        keep = torch.rand(n1, n2, device="cuda", generator=g) > 0.05
        c = torch.exp(2j * torch.pi * torch.rand(n1, n2, device="cuda",
                                                 generator=g))
        ch = (chirp[0], cfg.baseband_bandwidth / m, chirp[2], cfg.dm)
        for kw in (dict(keep=keep, chirp=ch), dict(chirp=ch), dict(keep=keep),
                   dict(), dict(premul=(c, c * c)),
                   dict(keep=keep, premul=(c, c * c))):
            flips += _check_pass2_spectrum(
                x, thr, 0.125, f"[{n1}, {n2}] {sorted(kw)}", **kw)[1]
        F._hermitian_weights.cache_clear()
    say(f"check fft2_pass2_spectrum at n1 = 4096, 8192 and n2 = 2^12 ... "
        f"2^16: with and without the mask, exact chirp, premul or neither, "
        f"within the gates, the self-paired rows 0 and n1/2 too; {flips} "
        "zap decisions within 1e-5 of thr differ")
    del x, keep, c
    torch.cuda.empty_cache()
    return recs


def check_fft2_front_two_streams(rec: dict) -> None:
    """B11 in its two-stream 8-bit form at the dualpol8_ffuse_2^30 path's
    shape: 2 GiB of "1212"-interleaved 8-bit bytes, (S, n1, n2) = (2,
    8192, 65536), no window.  Held bit-identical to B9 on the same packed
    values, to its plain version stream by stream (the plain column FFT
    of each stream's packed values, 2e-5 of the largest |plain|), and its
    sums to their exact float64 values from the packed values
    (``_packed_sums``: sum |B|^2 within 3e-7 relative of Parseval's, the
    DC within 1e-8 of sum |z|, each stream's mean power within 1e-6 of
    the exact one).  Then timed, beside the whole plain version (unpack,
    pack, column FFT, twiddle, float64 sums) on the same bytes; the
    numbers go into B11's record under ``two_stream_8bit``."""
    import torch
    from srtb_tpu_torch.kernels import fft2 as K2
    from srtb_tpu_torch.kernels import fft2_front as FF
    variant, nbits = "interleaved_samples_2", 8
    m = 1 << (LOG2_N - 1)
    n1, n2 = K2.ffuse_factor(m)
    g = torch.Generator(device="cuda").manual_seed(27)
    raw = torch.randint(0, 256, (FF.front_streams(variant) * 2 * m,),
                        dtype=torch.uint8, device="cuda", generator=g)
    z = FF.front_pack(raw, m, variant, nbits)
    b, aux = FF.fft2_pass1_front(raw, m, variant, nbits)
    where = f"fft2_pass1_front [2, {n1}, {n2}] {variant} {nbits} bits"
    if not torch.equal(torch.view_as_real(b),
                       torch.view_as_real(K2.fft2_pass1(z))):
        fail(f"{where}: not bit-identical to B9 on the same packed values")
    err = scale = 0.0
    for s in range(z.shape[0]):
        e, sc = _fft_err(b[s:s + 1], K2.fft2_pass1_plain(z[s:s + 1]))
        K2.twiddle.cache_clear()
        if not e <= 2e-5 * sc:
            fail(f"{where}: stream {s} {e} > 2e-5 x {sc}")
        err, scale = max(err, e), max(scale, sc)
    exact = _packed_sums(z)
    del z
    torch.cuda.empty_cache()
    energy, dc = _sum_errors(aux, exact)
    mean = FF.front_mean_power(aux, n2, m)
    want = FF.front_mean_power(exact[:, :3], n2, m)
    rel = float(((mean - want).abs() / want).max())
    if not (abs(energy) <= 3e-7 and dc <= 1e-8 and rel <= 1e-6):
        fail(f"{where}: sum |B|^2 off Parseval's by {energy:.3e}, DC off "
             f"sum z by {dc:.3e} of sum |z|, mean power rel err {rel:.3e}")
    del b
    torch.cuda.empty_cache()
    k_ms = cuda_ms(lambda: FF.fft2_pass1_front(raw, m, variant, nbits), 5)
    torch.cuda.empty_cache()
    p_ms = cuda_ms(lambda: FF.fft2_pass1_front_plain(raw, m, variant,
                                                     nbits), 1)
    K2.twiddle.cache_clear()
    torch.cuda.empty_cache()
    # reads the 2 GiB of raw bytes once and writes 2 x 4 GiB; the
    # operations as the one-stream record counts them, twice
    nbytes = 4 * m + 2 * 8 * m
    b_ms, b_by = bound_ms(nbytes, {"f32": 2 * (5 * m * 13 + 12 * m + 6 * m),
                                   "f64": 2 * 4 * m})
    rec["two_stream_8bit"] = {
        "shape": [2, n1, n2], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
        "max_abs_err": err, "energy_bias": energy, "dc_err": dc,
        "mean_power_rel_err": rel}
    say(f"check {where}: bit-identical to B9 on the same packed values, "
        f"max_abs_err {err:.3e} <= 2e-5 x {scale:.3e} (each stream against "
        f"its plain column FFT), sum |B|^2 off Parseval's by {energy:+.2e}, "
        f"DC off sum z by {dc:.2e}, mean power within {rel:.2e} of the "
        f"exact; B11 {k_ms:.4f} ms, plain version {p_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / k_ms:.1f}% of it); card "
        f"{card_line()}")
    del raw


def time_pass2_spectrum() -> dict:
    """B12 at the front-fused path's [8192, 65536] with the example cfg's
    keep mask and exact chirp (the path's form), on a noise intermediate,
    in turns with B10 (its row FFT alone, a reference point: B10 does not
    compute B12's function) on the same input; timed before B9's 2^30
    column timing (PERF.md §7)."""
    import torch
    from srtb_tpu_torch.kernels import fft2 as K2
    from srtb_tpu_torch.kernels import fft2_front as FF
    n1, n2 = 1 << 13, 1 << 16
    m = n1 * n2
    b, thr, keep, chirp, norm = _pass2_path_inputs(n1, n2)
    k_ms, b10_ms = turns(
        lambda: FF.fft2_pass2_spectrum(b, thr, norm, keep=keep, chirp=chirp),
        lambda: K2.fft2_pass2(b[None]))
    nbytes = 17 * m
    say(f"fft2_pass2_spectrum [{n1}, {n2}] (keep mask, exact chirp): B12 "
        f"{k_ms:.4f} ms, B10 (its row FFT alone) on the same input "
        f"{b10_ms:.4f} ms (in turns), bound "
        f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms "
        f"({100 * nbytes / PEAK_BYTES_PER_S * 1e3 / k_ms:.1f}% of it), "
        f"B12 / B10 {k_ms / b10_ms:.3f}")
    del b, keep
    torch.cuda.empty_cache()
    geo = row_length_geometry("fft2_pass2_spectrum geometry",
                              FF.pass2_spectrum_geometry, "n2")
    return {"ms": k_ms, "b10_same_input_ms": b10_ms, "geometry": geo}


def _pass2_path_form(cfg, n1: int, n2: int):
    """B12's form on the front-fused path at [n1, n2] for ``cfg``: its
    keep mask (blocked), exact chirp and normalization."""
    import torch
    from srtb_tpu_torch.ops import dedisperse as dd
    from srtb_tpu_torch.ops import rfi
    m = n1 * n2
    f_min, f_c, df = dd.spectrum_frequencies(cfg, m)
    zap = rfi.rfi_ranges_to_mask(rfi.eval_rfi_ranges(
        cfg.mitigate_rfi_freq_list), m, cfg.baseband_freq_low,
        cfg.baseband_bandwidth)
    keep = torch.from_numpy(~zap).to("cuda").reshape(n2, n1).T.contiguous()
    return (keep, (f_min, df, f_c, cfg.dm),
            rfi.normalization_coefficient(m, cfg.spectrum_channel_count))


def _pass2_path_inputs(n1: int, n2: int):
    """B12's inputs in the front-fused path's form on a noise
    intermediate [n1, n2] of unit power: the stage-1 threshold (the
    example cfg's threshold times the spectrum's mean power, n2), and
    :func:`_pass2_path_form`'s keep mask, chirp and normalization."""
    import torch
    from srtb_tpu_torch.config import Config
    cfg = Config()
    cfg.load_file(str(CFG_EXAMPLE))
    g = torch.Generator(device="cuda").manual_seed(27)
    b = torch.randn(n1, n2, dtype=torch.complex64, device="cuda",
                    generator=g)
    thr = torch.tensor([cfg.mitigate_rfi_average_method_threshold * n2],
                       dtype=torch.float32, device="cuda")
    return (b, thr, *_pass2_path_form(cfg, n1, n2))


def phase_kernels(copy_gbps: float) -> list:
    recs = [check_unpack(copy_gbps), check_rfi_chirp(copy_gbps)]
    recs += check_sk(copy_gbps)
    recs += [check_unpack_planes(copy_gbps), check_fft_rows(copy_gbps),
             check_fft_rows_stats(copy_gbps),
             check_fft_rows_skzap(copy_gbps), check_dedisperse(copy_gbps)]
    b12 = time_pass2_spectrum()
    recs += check_fft2(copy_gbps, b12["b10_same_input_ms"])
    recs += check_fft2_front(copy_gbps, recs[1]["ms"], b12)
    check_fft2_front_two_streams(
        {r["name"]: r for r in recs}["fft2_pass1_front"])
    return recs


def make_input_file(cfg, path: Path, segments: int = 2,
                    pulse_segment=1, seed: int = 100) -> dict:
    """``segments`` segments of the cfg's format and sample width made on
    the card, a dispersed pulse in stream 0 of segment ``pulse_segment``
    (a tuple: of each of those segments; None: nowhere) and noise
    elsewhere: each stream quantized apart from
    its own generator seed, then interleaved in the format's own layout.
    Segment k >= 1 is the tail of segment k - 1 and the first stride of
    block k; the last block is one byte short, so the overlap-save reader
    emits exactly ``segments`` segments (the last ends in one zero-padded
    byte, inside its reserved tail).  Segment i of stream s is quantized
    from generator seed ``seed + i + 1000 s``."""
    import torch
    from srtb_tpu_torch.io import formats, synth
    from srtb_tpu_torch.ops import dedisperse as dd
    n = cfg.baseband_input_count
    fmt = formats.resolve(cfg.baseband_format_type)
    streams = fmt.data_stream_count
    seg = cfg.segment_bytes(streams)
    nres = dd.nsamps_reserved(cfg)
    reserved = nres * abs(cfg.baseband_input_bits) // 8 * streams
    stride = seg - reserved
    # block k's sample j is segment k's sample nres + j; the search keeps
    # the first T - nres / channel_count waterfall columns of
    # 2 * channel_count samples each, i.e. the first n - 2 nres samples
    # (the reference's trim): aim at the middle of the searched span
    pulse_at = (n - 3 * nres) // 2
    pulses = (() if pulse_segment is None else (pulse_segment,)
              if isinstance(pulse_segment, int) else tuple(pulse_segment))
    with open(path, "wb") as f:
        for i in range(segments):
            rows = []
            for s in range(streams):
                gen = torch.Generator(device="cuda").manual_seed(
                    seed + i + 1000 * s)
                rows.append(synth.make_dispersed_baseband(
                    n, cfg.baseband_freq_low, cfg.baseband_bandwidth, cfg.dm,
                    [pulse_at] if i in pulses and s == 0 else [],
                    nbits=cfg.baseband_input_bits, pulse_amp=40.0,
                    pulse_width=32, device="cuda", generator=gen))
            block = synth.interleave_streams(
                torch.stack(rows), fmt.unpack_variant).cpu().numpy()
            del rows
            torch.cuda.empty_cache()
            if i == 0:
                f.write(block.tobytes())
            else:
                end = stride - 1 if i == segments - 1 else stride
                f.write(block[:end].tobytes())
    info = {"format": fmt.name, "streams": streams, "segment_bytes": seg,
            "reserved_bytes": reserved, "segments": segments,
            "pulse_segment": pulse_segment}
    for i in pulses:
        info[f"pulse_sample_in_segment_{i}"] = nres + pulse_at
    return info


def input_file(cfg, label: str, made: dict) -> Path:
    """The two-segment input file of the cfg's geometry (samples, bits,
    DM, reserve, band), made once and shared by every path of that
    geometry (``made`` maps the geometry to its file)."""
    from srtb_tpu_torch.ops import dedisperse as dd
    key = (cfg.baseband_format_type, cfg.baseband_input_count,
           cfg.baseband_input_bits, cfg.dm, dd.nsamps_reserved(cfg),
           cfg.baseband_freq_low, cfg.baseband_bandwidth)
    if key in made:
        say(f"main path {label}: input {made[key].relative_to(ROOT)} "
            "shared with an earlier path of the same geometry")
        return made[key]
    data = OUT_DIR / "inputs" / f"{label}.bin"
    data.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    info = make_input_file(cfg, data)
    say(f"main path {label}: input {data.relative_to(ROOT)} "
        f"({data.stat().st_size} bytes, {info}) made in "
        f"{time.perf_counter() - t0:.1f} s")
    made[key] = data
    return data


def path_cfg(out_dir: Path, extra: str, log2_n: int, label: str,
             gui: bool = False):
    """The example cfg with ``extra`` written to ``out_dir/smoke.cfg``
    (outputs to ``out_dir/out_*``, deterministic timestamps, ``gui_enable
    = 0`` unless ``gui``: then the cfg's own, and its frames
    ``out_dir/waterfall_s*``), its old outputs removed; returns the parsed
    config and the file's text."""
    from srtb_tpu_torch.config import Config
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in [*out_dir.glob("out_*"), *out_dir.glob("waterfall_s*")]:
        old.unlink()
    text = CFG_EXAMPLE.read_text()
    text += ("\n" + ("" if gui else "gui_enable = 0\n")
             + f"baseband_output_file_prefix = {out_dir}/out_\n"
             "deterministic_timestamps = 1\n" + extra)
    (out_dir / "smoke.cfg").write_text(text)
    cfg = Config()
    cfg.load_file(str(out_dir / "smoke.cfg"))
    if cfg.baseband_input_count != 1 << log2_n:
        fail(f"{label}: the cfg gives {cfg.baseband_input_count} samples")
    return cfg, text


def fresh_telemetry() -> None:
    """Empty the process-global metrics registry and disarm the flight
    recorder (the next pipeline arms a new one from its config)."""
    from srtb_tpu_torch.utils import events
    from srtb_tpu_torch.utils.metrics import metrics
    metrics.reset()
    events.configure(False)


def run_cli(out_dir: Path, text: str, data: Path, env: dict):
    """``srtb-torch-main`` on ``data`` with the cfg ``text``, after a
    synchronize, a reset of the peak memory and of the process-global
    metrics registry and flight recorder (each run counts and records
    from nothing, as its own process would); returns the run's
    statistics, the finished pipeline and the host wall seconds."""
    import torch
    from srtb_tpu_torch.tools import main as M
    cfg_path = out_dir / "smoke.cfg"
    cfg_path.write_text(text + f"input_file_path = {data}\n")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fresh_telemetry()
    t0 = time.perf_counter()
    with path_env(env):
        stats, pipe = M.run(["--config_file_name", str(cfg_path)])
    check_no_recovery(f"{out_dir.name} run", stats)
    return stats, pipe, time.perf_counter() - t0


def engine_numbers(stats) -> str:
    """The engine's records of a run, as JSON."""
    ex = stats.extras
    return json.dumps({k: ex[k] for k in (
        "inflight_segments", "stage_s", "device_s_per_segment",
        "overlap_hidden_s_per_segment", "h2d_bytes_per_segment")})


def phase_main_path(card: str, label: str, log2_n: int, extra: str,
                    plan: str, per_segment: dict, env: dict,
                    made: dict) -> dict:
    """One main path: the example cfg with ``extra`` at 2^log2_n samples
    per segment, on the synthetic two-segment file of its geometry,
    through ``srtb-torch-main`` at the engine's defaults (a window of 2,
    a writer pool of 2, the ingest ring where the cfg reserves a tail)
    under the environment ``env``; the launch counts are zeroed just
    before the run and read just after it.  Then the dispatch check
    (:func:`check_dispatch_syncs`)."""
    import torch
    from srtb_tpu_torch import kernels as K
    out_dir = OUT_DIR / label
    cfg, text = path_cfg(out_dir, extra, log2_n, label,
                         gui=label in GUI_PATHS)
    data = input_file(cfg, label, made)
    K.reset_launch_counts()
    stats, pipe, wall = run_cli(out_dir, text, data, env)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    positives = pipe.positive_segments
    streams = pipe.processor.streams
    say(f"main path {label}: plan {pipe.processor.plan_name}, "
        f"{pipe.processor.fmt.name} ({streams} stream(s), "
        f"{cfg.baseband_input_bits}-bit), "
        f"{stats.segments} segments, positive {positives}, "
        f"{stats.msamples_per_sec:.1f} Msamples/s (a stream) in the pipeline "
        f"({stats.elapsed_s:.2f} s), {wall:.2f} s with set-up; real-time "
        f"factor {stats.msamples_per_sec / 128.0:.3f} against 128 "
        f"Msamples/s; max_memory_allocated {peak} bytes; env {env}; "
        f"launches {counts}; card {card}")
    say(f"main path {label}: peak memory at window "
        f"{stats.extras['inflight_segments']}: {peak} bytes "
        f"({peak / 1e9:.2f} GB) of "
        f"{torch.cuda.get_device_properties(0).total_memory} bytes; "
        f"card {card}")
    if pipe.processor.plan_name != plan:
        fail(f"{label}: plan {pipe.processor.plan_name}, expected {plan}")
    if stats.segments != 2:
        fail(f"{label}: expected 2 segments, got {stats.segments}")
    if positives != [1]:
        fail(f"{label}: expected only segment 1 (the pulse) positive, got "
             f"{positives}")
    written = pipe.sink.written
    for files in written:
        for p in [files.bin_path, *files.npy_paths, *files.tim_paths]:
            if not os.path.exists(p) or os.path.getsize(p) == 0:
                fail(f"{label}: candidate file missing: {p}")
    if not written or not written[0].tim_paths:
        fail(f"{label}: no candidate files written for the pulse segment")
    # one waterfall a stream; the pulse, in stream 0 only, fires there only
    for files in written:
        tims = [os.path.basename(p) for p in files.tim_paths]
        if len(files.npy_paths) != streams:
            fail(f"{label}: {len(files.npy_paths)} waterfall dumps for "
                 f"{streams} streams")
        if streams > 1 and not (all(".s0." in t for t in tims)
                                and not any(".s1." in t for t in tims)):
            fail(f"{label}: the pulse is in stream 0 only, the series are "
                 f"{tims}")
    _check_launches(f"main path {label}", counts, per_segment,
                    stats.segments)
    names = [os.path.basename(p) for f in written
             for p in [f.bin_path, *f.npy_paths, *f.tim_paths]]
    say(f"main path {label}: candidates {names}")
    digests = _digests(pipe) if label in DIGEST_PATHS else None
    if label in GUI_PATHS:
        check_gui(card, label, pipe, stats, out_dir, peak)
    candidates = _candidate_files(pipe)
    if label != OOM_PATH:
        # the waterfall dumps, checked: free the disk (the real OOM's
        # check reads its path's)
        for files in written:
            for p in files.npy_paths:
                os.unlink(p)
    say(f"main path {label}: engine " + engine_numbers(stats))
    check_dispatch_syncs(pipe, label)
    return {"counts": counts, "stats": stats, "pipe": pipe, "data": data,
            "peak_bytes": peak, "digests": digests, "files": candidates}


def _digests(pipe) -> dict:
    """The SHA-256 of every candidate file of a run, by name."""
    import hashlib
    out = {}
    for name, path in _candidate_files(pipe).items():
        h = hashlib.sha256()
        with open(path, "rb") as f:
            while chunk := f.read(1 << 26):
                h.update(chunk)
        out[name] = h.hexdigest()
    return out


# ---------------------------------------------------------------- display

def pixmap64(x):
    """The colormap in float64 arithmetic (numpy int64 ARGB words)."""
    import numpy as np
    from srtb_tpu_torch.ops import spectrum as sp
    xc = np.clip(x, 0.0, 1.0)
    out = np.zeros(x.shape, dtype=np.int64)
    for shift in (24, 16, 8, 0):
        c0, c1 = (sp.COLOR_0 >> shift) & 0xFF, (sp.COLOR_1 >> shift) & 0xFF
        out |= ((1.0 - xc) * c0 + xc * c1).astype(np.int64) << shift
    return np.where((x >= 0) & (x <= 1), out, sp.COLOR_OVERFLOW)


def pixmap_mismatches(got, x64) -> dict:
    """``got`` (uint32 ARGB) against the float64 intensity ``x64`` under
    the boundary rule, channel by channel: a channel may differ only
    within BOUNDARY of one of its truncation steps or of the [0, 1]
    edges; the alpha channel, whose lerp is the constant 255 (a step at
    every intensity), may read 254 or 255 in range.  Returns the counts:
    pixels off the rule, pixels at a colour boundary, alpha-254 pixels."""
    import numpy as np
    want = pixmap64(x64)
    lo, hi = pixmap64(x64 - BOUNDARY), pixmap64(x64 + BOUNDARY)
    in_range = (x64 >= 0) & (x64 <= 1)
    edge = ((x64 - BOUNDARY >= 0) & (x64 - BOUNDARY <= 1)) != \
        ((x64 + BOUNDARY >= 0) & (x64 + BOUNDARY <= 1))
    off = np.zeros(x64.shape, dtype=bool)
    near_any = edge.copy()
    for shift in (16, 8, 0):
        near = edge | (((lo >> shift) & 0xFF) != ((hi >> shift) & 0xFF))
        near_any |= near
        off |= (((got >> shift) & 0xFF) != ((want >> shift) & 0xFF)) \
            & ~near
    alpha = got >> 24
    off |= ~edge & np.where(in_range, ~np.isin(alpha, (254, 255)),
                            alpha != 0xFF)
    return {"off_rule": int(off.sum()), "at_boundary": int(near_any.sum()),
            "alpha_254": int((in_range & (alpha == 254)).sum())}


def read_png(path):
    """The ARGB32 uint32 [h, w] pixmap of a PNG as ``write_png`` writes
    it (one IDAT, RGBA8, filter byte 0)."""
    import struct
    import zlib
    import numpy as np
    data = Path(path).read_bytes()
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        chunks[data[pos + 4:pos + 8]] = data[pos + 8:pos + 8 + length]
        pos += 12 + length
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]),
                         dtype=np.uint8).reshape(h, 1 + 4 * w)
    rgba = rows[:, 1:].reshape(h, w, 4).astype(np.uint32)
    return (rgba[..., 3] << 24) | (rgba[..., 0] << 16) | \
        (rgba[..., 1] << 8) | rgba[..., 2]


def render64(wf, out_h: int, out_w: int):
    """The float64 render of a complex64 waterfall [F, T] on its device:
    float64 power, float64 weights and products, the reference's
    normalization (skipped at a mean below float32's eps); numpy [out_h,
    out_w]."""
    import numpy as np
    import torch
    from srtb_tpu_torch.ops import spectrum as sp
    f_len, t_len = wf.shape
    ri = torch.view_as_real(wf)
    power = torch.empty(wf.shape, dtype=torch.float64, device=wf.device)
    for r in range(0, f_len, 256):
        p = ri[r:r + 256].to(torch.float64)
        torch.sum(p * p, dim=-1, out=power[r:r + 256])
        del p
    w_freq = torch.from_numpy(sp.freq_area_weights(
        f_len, out_h, dtype=np.float64)).to(wf.device)
    img = w_freq @ power
    del power
    w_time = torch.from_numpy(sp.time_interp_weights(
        t_len, out_w, dtype=np.float64)).to(wf.device)
    img = img @ w_time
    del w_time
    avg = float(img.mean())
    if avg > np.finfo(np.float32).eps:
        img = img / (2.0 * avg)
    return img.cpu().numpy()


def check_gui(card: str, label: str, pipe, stats, out_dir: Path,
              peak: int) -> None:
    """The cfg as shipped renders one frame a segment: exactly
    ``waterfall_s0_<n>.png`` for n < segments; the pulse segment's frame
    held to a float64 render on the card of the same waterfall (its
    ``.npy`` dump): the port's float intensity (the renderer's on that
    waterfall) within RENDER_RTOL of it, the PNG's pixmap equal to its
    colours under the boundary rule.  Then the render's device ms and the
    PNG's encode-and-write ms, the peak and the rate against those
    without the GUI."""
    import numpy as np
    import torch
    from srtb_tpu_torch.gui import waterfall as GW
    from srtb_tpu_torch.ops import spectrum as sp
    cfg = pipe.cfg
    frames = sorted(p.name for p in out_dir.glob("waterfall_*"))
    want = [f"waterfall_s0_{i:06d}.png" for i in range(stats.segments)]
    if frames != want:
        fail(f"{label}: frames {frames}, expected {want}")
    npy = pipe.sink.written[0].npy_paths[0]
    wf = torch.from_numpy(np.load(npy)).to("cuda")
    h, w = cfg.gui_pixmap_height, cfg.gui_pixmap_width
    service = next(s.service for s in pipe.sinks
                   if hasattr(s, "service"))
    renderer = service.renderer
    if tuple(renderer.w_time.shape) != (wf.shape[1], w) or \
            tuple(renderer.w_freq.shape) != (h, wf.shape[0]):
        fail(f"{label}: renderer geometry {tuple(renderer.w_freq.shape)} "
             f"x {tuple(renderer.w_time.shape)} for a waterfall "
             f"{tuple(wf.shape)}")
    got = read_png(out_dir / want[1])
    x32 = renderer.intensity(wf).cpu().numpy()
    rerender = sp.generate_pixmap(torch.from_numpy(x32))
    x64 = render64(wf, h, w)
    zero = x64 == 0
    rel = np.abs(x32.astype(np.float64) - x64) / np.where(zero, 1.0,
                                                          np.abs(x64))
    if (x32[zero] != 0).any() or float(rel.max()) > RENDER_RTOL:
        fail(f"{label}: intensity off the float64 render by "
             f"{float(rel.max()):.3e} relative (gate {RENDER_RTOL:g})")
    counts = pixmap_mismatches(got, x64)
    if counts["off_rule"]:
        fail(f"{label}: {counts['off_rule']} pixels of {want[1]} differ "
             "from the float64 render away from a boundary")
    say(f"main path {label}: GUI frames {frames}; {want[1]} (the pulse "
        f"segment) against a float64 render on the card: intensity max "
        f"relative error {float(rel.max()):.3e} (gate {RENDER_RTOL:g}), "
        f"{int(zero.sum())} exact zeros; pixmap equal but at boundaries: "
        f"{counts['at_boundary']} pixels within {BOUNDARY:g} of a colour "
        f"step or edge, {counts['alpha_254']} pixels of alpha 254 (the "
        f"float32 lerp of the constant 255), 0 off the rule; a re-render "
        f"of the dump differs from the frame at "
        f"{int((rerender != got).sum())} pixels")
    render_ms = cuda_ms(lambda: renderer.render(wf), 3)
    intensity_ms = cuda_ms(lambda: renderer.intensity(wf), 3)
    tmp = out_dir / "png_timing.png"
    t0 = time.perf_counter()
    for _ in range(3):
        GW.write_png(str(tmp), got)
    png_ms = (time.perf_counter() - t0) / 3 * 1e3
    tmp.unlink()
    del wf
    torch.cuda.empty_cache()
    msamples = stats.msamples_per_sec
    say(f"main path {label}: GUI render {render_ms:.3f} ms a segment "
        f"(CUDA events: power, the two float32 products, normalize, "
        f"colormap and the pixmap's copy to the host; the intensity alone "
        f"{intensity_ms:.3f} ms), PNG encode and write {png_ms:.3f} ms "
        f"(host, {h} x {w}); peak at window "
        f"{stats.extras['inflight_segments']} {peak / 1e9:.2f} GB against "
        f"{SHIPPED_PEAK_GB_NO_GUI} GB without the GUI; "
        f"{msamples:.1f} Msamples/s against {SHIPPED_MSAMPLES_NO_GUI[0]}-"
        f"{SHIPPED_MSAMPLES_NO_GUI[1]} without it; card {card}")


def phase_quality(run, card: str) -> dict:
    """quality_2^30: the timeline holds one dict a segment, and each
    segment's vector, from one dispatch on the card (the spectrum the
    epilogue read and the waterfall copied from it), is held to the float64
    oracle: the counts behind zap_frac, the occupancy row, dead_frac and
    hot_frac exactly, every other slot within 1e-5 relative.  Then the
    epilogue's device ms and the peak against staged_2^30's."""
    import numpy as np
    import torch
    from srtb_tpu_torch.io.file_input import make_file_source
    from srtb_tpu_torch.pipeline import segment as SEG
    from srtb_tpu_torch.quality import stats as Q
    from srtb_tpu_torch.utils.bufferpool import BufferPool
    pipe, stats = run["pipe"], run["stats"]
    cfg, sp = pipe.cfg, pipe.processor
    timeline = stats.extras.get("quality", [])
    if [d["segment"] for d in timeline] != list(range(stats.segments)):
        fail(f"quality_2^30: timeline segments "
             f"{[d['segment'] for d in timeline]}, {stats.segments} run")
    bins, dead, hot, k = sp.quality_params
    pool = BufferPool("quality check", pinned=True)
    src = make_file_source(cfg, buffer_pool=pool)
    spectrum_stats = Q.spectrum_stats
    errors, ms = [], {}
    for i, seg in enumerate(src):
        seen = []

        def recording(spec, *args):
            seen.append(spec.clone())
            return spectrum_stats(spec, *args)
        SEG.Q.spectrum_stats = recording
        try:
            wf, res = sp.process(seg.data)
        finally:
            SEG.Q.spectrum_stats = spectrum_stats
        pool.release(seg.data)
        got = res.quality.cpu().numpy()
        spec = seen[0]
        if i == 0:
            ms["spectrum half"] = cuda_ms(
                lambda: Q.spectrum_stats(spec, bins, k), 5)
            ms["waterfall half"] = cuda_ms(
                lambda: Q.waterfall_stats(wf, dead, hot, k), 5)
        want = Q.quality_stats_oracle(spec.cpu().numpy(), wf.cpu().numpy(),
                                      bins, dead, hot, subsample=k)
        del spec, wf, res, seen
        exact = [Q.IDX_ZAP_FRAC, Q.IDX_DEAD_FRAC, Q.IDX_HOT_FRAC,
                 *range(Q.N_SCALARS, Q.N_SCALARS + bins)]
        rest = [j for j in range(got.shape[-1]) if j not in exact]
        if not np.array_equal(got[:, exact], want[:, exact]):
            fail(f"quality_2^30: segment {i}: counts differ from the "
                 f"oracle: {got[:, exact]} vs {want[:, exact]}")
        rel = float((np.abs(got[:, rest].astype(np.float64) - want[:, rest])
                     / np.abs(want[:, rest]).clip(1e-30)).max())
        if rel > 1e-5:
            fail(f"quality_2^30: segment {i}: {rel:.3e} relative off the "
                 "oracle (gate 1e-5)")
        errors.append(rel)
        for key, idx in (("zap_frac", Q.IDX_ZAP_FRAC),
                         ("sk_mean", Q.IDX_SK_MEAN)):
            if timeline[i][key] != round(float(got[0, idx]), 5):
                fail(f"quality_2^30: segment {i}: the run's {key} "
                     f"{timeline[i][key]}, this dispatch's {got[0, idx]}")
        say(f"quality_2^30: segment {i}: vector against the float64 "
            f"oracle: counts exact, other slots {rel:.3e} relative (gate "
            f"1e-5); zap_frac {got[0, Q.IDX_ZAP_FRAC]:.6f}, bandpass mean "
            f"{got[0, Q.IDX_BANDPASS_MEAN]:.6f} var "
            f"{got[0, Q.IDX_BANDPASS_VAR]:.6e}, sk mean "
            f"{got[0, Q.IDX_SK_MEAN]:.6f} max {got[0, Q.IDX_SK_MAX]:.6f}, "
            f"dead {got[0, Q.IDX_DEAD_FRAC]}, hot {got[0, Q.IDX_HOT_FRAC]}")
    src.close()
    pool.free_all()
    torch.cuda.empty_cache()
    peak = run["peak_bytes"]
    say(f"quality_2^30: epilogue {ms['spectrum half']:.3f} + "
        f"{ms['waterfall half']:.3f} ms a segment (CUDA events; every "
        f"{k}th bin and sample, {bins} coarse bins); peak at window "
        f"{stats.extras['inflight_segments']} {peak / 1e9:.2f} GB against "
        f"staged_2^30's {STAGED_PEAK_GB} GB without the epilogue; "
        f"timeline "
        f"{len(timeline)} dicts; card {card}")
    return {"epilogue_ms": ms, "max_rel": max(errors)}


def check_dispatch_syncs(pipe, label: str) -> None:
    """Dispatch the path's two segments again, the first cold and the
    second warm where the plan has the ring, under
    ``torch.cuda.set_sync_debug_mode("error")``: a call in the upload,
    the chain or the result copies that synchronises with the card
    raises.  Then wait for them, and hold the gate's decisions to the
    run's (the pulse in segment 1 only)."""
    import torch
    from srtb_tpu_torch.io.file_input import make_file_source
    from srtb_tpu_torch.pipeline.runtime import has_signal
    from srtb_tpu_torch.utils.bufferpool import BufferPool
    proc = pipe.processor
    pool = BufferPool("dispatch check", pinned=True)
    src = make_file_source(pipe.cfg, buffer_pool=pool)
    segs = list(src)
    src.close()
    pipe._ring_invalidate()
    cold0, warm0 = proc.ring_cold_dispatches, proc.ring_warm_dispatches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        items = [pipe._dispatch_segment(seg) for seg in segs]
    except RuntimeError as e:
        fail(f"{label}: a dispatch synchronised with the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    decisions, by_stream = [], []
    for item in items:
        item.done.synchronize()
        decisions.append(has_signal(pipe.cfg, item.det,
                                    frequency_bin_count=item.wf.shape[-2]))
        by_stream.append([has_signal(pipe.cfg, item.det, stream=s,
                                     frequency_bin_count=item.wf.shape[-2])
                          for s in range(proc.streams)])
    pipe._ring_invalidate()
    del items
    for seg in segs:
        pool.release(seg.data)
    pool.free_all()
    if decisions != [False, True]:
        fail(f"{label}: decisions {decisions} of the checked dispatches")
    quiet = [False] * (proc.streams - 1)
    if by_stream != [[False] + quiet, [True] + quiet]:
        fail(f"{label}: per-stream decisions {by_stream}; the pulse is in "
             "stream 0 of segment 1 only")
    say(f"main path {label}: {len(segs)} dispatches (ring cold "
        f"{proc.ring_cold_dispatches - cold0}, warm "
        f"{proc.ring_warm_dispatches - warm0}) under "
        "set_sync_debug_mode('error'): no synchronising call; decisions "
        f"{decisions}, by stream {by_stream}")


# the window phase: (path, log2 samples, cfg lines, segments in the file,
# the pulse's segment or None), each run at the settings in the order of
# WINDOW_TURNS (a palindrome: the ring on and off each once on either
# side of the serial leg).  The 2^30 file holds noise only: a positive
# 2^30 segment dumps a 4 GiB waterfall, and writing and reading back one
# a turn took most of the phase's minute; the main paths dump one each
WINDOW_PATHS = (("staged_2^30", LOG2_N, PALLAS_ON, 4, None),
                ("fused_2^27", LOG2_N_ROWS, PALLAS_27, 8, 5))
WINDOW_SETTINGS = {
    "serial": "inflight_segments = 1\nwriter_thread_count = 0\n"
              "ingest_ring = off\n",
    "default": "",
    "ring_off": "ingest_ring = off\n"}
WINDOW_TURNS = ("default", "ring_off", "serial", "ring_off", "default")


def _candidate_files(pipe) -> dict:
    """Every candidate file of a run, by name."""
    return {os.path.basename(p): p for files in pipe.sink.written
            for p in [files.bin_path, *files.npy_paths, *files.tim_paths,
                      *files.fold_paths]}


def _same_bytes(a: str, b: str) -> bool:
    """Whether two files hold the same bytes (compared in 64 MiB chunks,
    from the page cache that the run's writes just filled)."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while chunk := fa.read(1 << 26):
            if chunk != fb.read(1 << 26):
                return False
    return True


def phase_window(card: str, keep: str = "fused_2^27") -> dict:
    """The in-flight engine against the serial leg, and the ring on
    against off at the window, on longer files: each path of
    ``WINDOW_PATHS`` runs at ``WINDOW_SETTINGS`` in the order of
    ``WINDOW_TURNS``, with its Msamples/s, wall seconds by stage,
    overlap-hidden seconds and H2D bytes per segment and peak memory; the
    candidate files of every run must be identical in name and bytes to
    the first run's, and the pulse segment (if any) the only positive
    one.  The input file and the first run's candidate files of path
    ``keep`` stay for the batch phase (``data``, ``first``)."""
    import shutil
    import torch
    out = {}
    for label, log2_n, extra, segments, pulse in WINDOW_PATHS:
        runs = {name: [] for name in WINDOW_SETTINGS}
        data = OUT_DIR / "inputs" / f"window_{label}.bin"
        first = None
        want = [] if pulse is None else [pulse]
        compare_s = 0.0
        for turn, setting in enumerate(WINDOW_TURNS):
            out_dir = OUT_DIR / f"window_{label}_{turn}"
            cfg, text = path_cfg(out_dir, extra + WINDOW_SETTINGS[setting],
                                 log2_n, label)
            if turn == 0:
                data.parent.mkdir(parents=True, exist_ok=True)
                t0 = time.perf_counter()
                info = make_input_file(cfg, data, segments, pulse)
                say(f"window {label}: input {data.relative_to(ROOT)} "
                    f"({data.stat().st_size} bytes, {info}) made in "
                    f"{time.perf_counter() - t0:.1f} s")
            stats, pipe, wall = run_cli(out_dir, text, data, {})
            peak = torch.cuda.max_memory_allocated()
            say(f"window {label} {setting} (turn {turn}): plan "
                f"{pipe.processor.plan_name}, {stats.segments} segments, "
                f"positive {pipe.positive_segments}, "
                f"{stats.msamples_per_sec:.1f} Msamples/s "
                f"({stats.elapsed_s:.3f} s, {wall:.3f} s with set-up), "
                f"max_memory_allocated {peak} bytes; card {card}; engine "
                + engine_numbers(stats))
            if stats.segments != segments or \
                    pipe.positive_segments != want:
                fail(f"window {label} {setting}: {stats.segments} segments,"
                     f" positive {pipe.positive_segments}; expected "
                     f"{segments} and {want}")
            t0 = time.perf_counter()
            got = _candidate_files(pipe)
            if first is None:
                first = got
            else:
                if sorted(got) != sorted(first):
                    fail(f"window {label} {setting}: candidate files "
                         f"{sorted(got)}, the first run's {sorted(first)}")
                for name, path in got.items():
                    if not _same_bytes(path, first[name]):
                        fail(f"window {label} {setting}: {name} differs "
                             "from the first run's")
                shutil.rmtree(out_dir)
            compare_s += time.perf_counter() - t0
            runs[setting].append({
                "msamples_per_s": stats.msamples_per_sec,
                "elapsed_s": stats.elapsed_s, "peak_bytes": peak,
                "stage_s": stats.extras["stage_s"]})
            del pipe
            free_card()
        if label != keep:
            data.unlink()
            shutil.rmtree(OUT_DIR / f"window_{label}_0")
        summary = {name: {
            "msamples_per_s": [r["msamples_per_s"] for r in rs],
            "elapsed_s": [r["elapsed_s"] for r in rs],
            "peak_bytes": max(r["peak_bytes"] for r in rs)}
            for name, rs in runs.items()}
        say(f"window {label}: candidate files identical in name and bytes "
            f"in all {len(WINDOW_TURNS)} runs ({sorted(first)}; compared "
            f"in {compare_s:.1f} s); summary "
            + json.dumps(summary) + f"; card {card}")
        out[label] = summary
        if label == keep:
            out[label] = dict(summary, data=data, first=first)
    return out


# ------------------------------------------------------------ micro-batch

# the batch phase's runs of fused_2^27 on the window phase's 8-segment
# file: (name, micro_batch_segments, inflight_segments, ingest_ring)
BATCH_SETTINGS = (("b2", 2, 2, "auto"), ("b2_ring_off", 2, 2, "off"),
                  ("b4", 4, 4, "auto"), ("b4_ring_off", 4, 4, "off"))


def _main_path(label: str) -> tuple:
    """The ``MAIN_PATHS`` entry of ``label``."""
    return next(p for p in MAIN_PATHS if p[0] == label)


def _same_candidates(label: str, got: dict, want: dict) -> None:
    """Fail unless two runs' candidate files agree in name and bytes."""
    if sorted(got) != sorted(want):
        fail(f"{label}: candidate files {sorted(got)}, expected "
             f"{sorted(want)}")
    for name, path in got.items():
        if not _same_bytes(path, want[name]):
            fail(f"{label}: {name} differs from the single dispatches'")


def run_batch_path(card: str, label: str, tag: str, data: Path,
                   segments: int, b: int, window: int, ring: str,
                   want: dict, positives: list) -> dict:
    """One micro-batched run of main path ``label`` on ``data``: its
    candidate files against ``want`` (a B = 1 run's, by name) byte for
    byte, the plan the reference's, the launches a segment the plan's
    table, the H2D bytes a segment the stride model (the first batch
    cold, whole segments; every later one warm, B strides), one dispatch
    a batch; prints Msamples/s, the peak and the engine's wall seconds by
    stage.  Returns the run's numbers and the pipeline."""
    import torch
    from srtb_tpu_torch import kernels as K
    _l, log2_n, extra, plan, per_segment, env = _main_path(label)
    out_dir = OUT_DIR / f"batch_{label}_{tag}"
    cfg, text = path_cfg(out_dir, extra + (
        f"micro_batch_segments = {b}\ninflight_segments = {window}\n"
        f"ingest_ring = {ring}\n"), log2_n, label)
    K.reset_launch_counts()
    stats, pipe, wall = run_cli(out_dir, text, data, env)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    proc = pipe.processor
    ex = stats.extras
    say(f"batch {label} {tag} (B = {b}, window {window}, ring {ring}): "
        f"plan {proc.plan_name}, {stats.segments} segments in "
        f"{ex['dispatches']} dispatches, positive {pipe.positive_segments},"
        f" {stats.msamples_per_sec:.1f} Msamples/s ({stats.elapsed_s:.3f} "
        f"s, {wall:.3f} s with set-up), max_memory_allocated {peak} bytes "
        f"({peak / 1e9:.2f} GB); card {card}; engine "
        + engine_numbers(stats))
    want_plan = plan if ring == "auto" else plan.removesuffix("+ring")
    if proc.plan_name != want_plan:
        fail(f"batch {label} {tag}: plan {proc.plan_name}, expected "
             f"{want_plan}")
    if stats.segments != segments or pipe.positive_segments != positives:
        fail(f"batch {label} {tag}: {stats.segments} segments, positive "
             f"{pipe.positive_segments}; expected {segments} and "
             f"{positives}")
    if ex["dispatches"] != segments // b:
        fail(f"batch {label} {tag}: {ex['dispatches']} dispatches for "
             f"{segments} segments at B = {b}")
    for name, count in counts.items():
        if count != per_segment.get(name, 0) * segments:
            fail(f"batch {label} {tag}: kernel {name} launched {count} "
                 f"times for {segments} segments, the table says "
                 f"{per_segment.get(name, 0)} a segment")
    seg = proc.stride_bytes + proc.reserved_bytes
    h2d = ([seg] * b + [proc.stride_bytes] * (segments - b)
           if ring == "auto" else [seg] * segments)
    if ex["h2d_bytes_per_segment"] != h2d:
        fail(f"batch {label} {tag}: H2D bytes a segment "
             f"{ex['h2d_bytes_per_segment']}, the stride model {h2d}")
    _same_candidates(f"batch {label} {tag}", _candidate_files(pipe), want)
    return {"msamples_per_s": stats.msamples_per_sec,
            "elapsed_s": stats.elapsed_s, "peak_bytes": peak,
            "stage_s": ex["stage_s"], "counts": counts, "pipe": pipe,
            "out_dir": out_dir}


def check_batch_syncs(pipe, b: int, label: str) -> None:
    """One batch of the run's first B segments dispatched again under
    ``torch.cuda.set_sync_debug_mode("error")``: no call of the uploads,
    the lanes or the result copies may synchronise with the card.  Then
    the lanes' decisions, which must be the run's."""
    import torch
    from srtb_tpu_torch.io.file_input import make_file_source
    from srtb_tpu_torch.pipeline.runtime import has_signal
    from srtb_tpu_torch.utils.bufferpool import BufferPool
    pool = BufferPool("batch dispatch check", pinned=True)
    src = make_file_source(pipe.cfg, buffer_pool=pool)
    segs = [next(src) for _ in range(b)]
    src.close()
    pipe._ring_invalidate()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        items = pipe._dispatch_batch(segs, [0] * b, 0)
    except RuntimeError as e:
        fail(f"{label}: a batch dispatch synchronised with the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    items[-1].done.synchronize()
    decisions = [has_signal(pipe.cfg, item.det,
                            frequency_bin_count=item.wf.shape[-2])
                 for item in items]
    pipe._ring_invalidate()
    del items
    for seg in segs:
        pool.release(seg.data)
    pool.free_all()
    want = [i in pipe.positive_segments for i in range(b)]
    if decisions != want:
        fail(f"{label}: decisions {decisions} of the checked batch, the "
             f"run's {want}")
    say(f"{label}: one batch of {b} dispatched under "
        f"set_sync_debug_mode('error'): no synchronising call; decisions "
        f"{decisions}")


@contextlib.contextmanager
def engine_labels():
    """``torch.profiler.record_function`` labels around the engine's host
    stages it does not label itself (set-up, read, the final drain,
    close; the engine records ``srtb:ingest``, ``srtb:dispatch``,
    ``srtb:fetch`` and ``srtb:sink``), for a profiled run only: the
    engine's methods are wrapped here and restored after."""
    import torch
    from srtb_tpu_torch.io import file_input as FI
    from srtb_tpu_torch.pipeline import runtime as R
    wrapped = ((R.Pipeline, "__init__", "srtb:setup"),
               (R.Pipeline, "close", "srtb:close"),
               (FI.DeterministicTimestampReader, "__next__", "srtb:read"),
               (R.Pipeline, "_drain_sinks", "srtb:drain"))
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _l in wrapped]

    def labelled(fn, label):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return inner

    for cls, name, label in wrapped:
        setattr(cls, name, labelled(cls.__dict__[name], label))
    try:
        yield
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def trace_summary(trace: Path, top: int = 6, names: dict | None = None
                  ) -> dict:
    """From a ``torch.profiler`` chrome trace (read by the port's
    ``tools/trace_summary.py``): the traced window (first to last event),
    the device's busy share (the union of its kernels, copies and sets
    over the window) and idle share, the sum of its events' durations,
    the longest idle gaps each with the host frames that held it (the
    ``srtb:`` labels and the innermost host operation open at the gap's
    middle, by thread), the device operations with the most time, and
    the host's labelled seconds by stage and thread (``names`` names
    threads by id)."""
    from srtb_tpu_torch.tools import trace_summary as TS
    names = names or {}
    events = TS.load_events(trace)
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in events
                 if e.get("cat") in TS.DEVICE_CATEGORIES)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e.get("tid"), e.get("cat")) for e in events
            if e.get("cat") in ("user_annotation", "cpu_op",
                                "cuda_runtime", "cuda_driver")]
    if not dev:
        return {"device_events": 0}
    t0 = min(dev[0][0], min(h[0] for h in host))
    t1 = max(max(d[1] for d in dev), max(h[1] for h in host))
    busy, gaps, cur_s, cur_e = 0.0, [], dev[0][0], dev[0][1]
    if cur_s > t0:
        gaps.append((t0, cur_s))
    for a, z, _n in dev[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, a))
            cur_s, cur_e = a, z
        else:
            cur_e = max(cur_e, z)
    busy += cur_e - cur_s
    if t1 > cur_e:
        gaps.append((cur_e, t1))

    def frames(mid):
        by_thread = {}
        for a, z, name, tid, cat in host:
            if a <= mid <= z:
                by_thread.setdefault(tid, []).append((z - a, name, cat))
        out = []
        for tid, opens in by_thread.items():
            labels = [n for _d, n, c in sorted(opens, reverse=True)
                      if c == "user_annotation"]
            inner = min(opens)[1]
            out.append(f"{names.get(tid, f'thread {tid}')}: "
                       f"{' > '.join(labels) or '-'} [{inner}]")
        return out or ["no host frame open"]

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    ops: dict = {}
    for a, z, name in dev:
        ops[name] = ops.get(name, 0.0) + (z - a)
    labelled: dict = {}
    for a, z, name, tid, cat in host:
        if cat == "user_annotation" and name.startswith("srtb:"):
            key = f"{name} ({names.get(tid, f'thread {tid}')})"
            labelled[key] = labelled.get(key, 0.0) + (z - a) / 1e6
    return {
        "window_s": (t1 - t0) / 1e6, "device_busy_s": busy / 1e6,
        "device_total_s": sum(z - a for a, z, _n in dev) / 1e6,
        "device_busy_share": busy / (t1 - t0),
        "device_idle_share": 1 - busy / (t1 - t0),
        "device_events": len(dev),
        "longest_idle_gaps": [
            {"ms": (z - a) / 1e3, "at_s": (a - t0) / 1e6,
             "host": frames((a + z) / 2)} for a, z in longest],
        "top_device_ops_ms": {
            name[:240]: t / 1e3 for name, t in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]},
        "host_labelled_s": labelled}


def profile_batch(card: str, label: str, data: Path, b: int,
                  keep_trace: bool = False) -> dict:
    """``torch.profiler`` (CPU and CUDA activity, every thread where this
    torch can: the sink thread's too) over a whole run of ``label`` on
    ``data`` at B = ``b`` (window max(2, b)), its chrome trace under
    ``build/chip_smoke/`` (deleted unless ``keep_trace``: then its path
    is the summary's ``trace``), and :func:`trace_summary`."""
    import threading
    import torch
    from torch.profiler import ProfilerActivity, profile
    kwargs, all_threads = {}, True
    try:
        from torch._C._profiler import _ExperimentalConfig
        kwargs["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        all_threads = False  # this torch traces the calling thread only
    _l, log2_n, extra, _plan, _per, env = _main_path(label)
    out_dir = OUT_DIR / f"profile_{label}_b{b}"
    cfg, text = path_cfg(out_dir, extra + (
        f"micro_batch_segments = {b}\ninflight_segments = {max(2, b)}\n"),
        log2_n, label)
    with engine_labels(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA],
                                  **kwargs) as prof:
        stats, pipe, wall = run_cli(out_dir, text, data, env)
        torch.cuda.synchronize()
    trace = out_dir / "trace.json"
    prof.export_chrome_trace(str(trace))
    summary = trace_summary(trace, names={
        threading.get_native_id(): "engine thread"})
    summary.update(all_threads=all_threads,
                   msamples_per_s=stats.msamples_per_sec,
                   elapsed_s=stats.elapsed_s, wall_s=wall,
                   stage_s=stats.extras["stage_s"],
                   trace_bytes=trace.stat().st_size)
    say(f"profile {label} B = {b}: " + json.dumps(summary)
        + f"; card {card}")
    if not summary["device_events"]:
        say(f"profile {label} B = {b}: torch.profiler recorded no device "
            "activity on this machine; the busy share is not measured")
    for files in pipe.sink.written:
        for p in files.npy_paths:
            os.unlink(p)
    if keep_trace:
        summary["trace"] = trace
    else:
        trace.unlink()
    return summary


def phase_batch(card: str, window: dict, runs: dict) -> dict:
    """Micro-batch on the card: fused_2^27 on the window phase's 8-segment
    file (the pulse in segment 5) at B = 2 (window 2) and B = 4 (window
    4), the ring auto and off, each run's candidate files byte for byte
    the window phase's first (B = 1, defaults) run's, with the plan, the
    launches, the H2D stride model and the dispatch count gated
    (:func:`run_batch_path`); one batch re-dispatched under the sync
    check; gznupsr_2^27 (two streams) at B = 2 against B = 1 on its main
    path file; then ``torch.profiler`` over the 8 segments at B = 1 and
    B = 2 (:func:`profile_batch`).  ``counts`` holds each gated run's
    launches, by path."""
    import shutil
    w = window["fused_2^27"]
    data, first = w["data"], w["first"]
    out = {"b1_msamples_per_s": w["default"]["msamples_per_s"],
           "b1_peak_bytes": w["default"]["peak_bytes"], "counts": {}}
    for tag, b, win, ring in BATCH_SETTINGS:
        run = run_batch_path(card, "fused_2^27", tag, data, 8, b, win,
                             ring, first, [5])
        if tag == "b2":
            check_batch_syncs(run["pipe"], b, "batch fused_2^27 b2")
        shutil.rmtree(run.pop("out_dir"))
        del run["pipe"]
        out["counts"][f"batch_fused_2^27_{tag}"] = run.pop("counts")
        out[tag] = run
        free_card()
    say("batch fused_2^27: Msamples/s at B = 1 (window phase, defaults) "
        f"{out['b1_msamples_per_s']}, B = 2 "
        f"{[out[t]['msamples_per_s'] for t in ('b2', 'b2_ring_off')]}, "
        f"B = 4 {[out[t]['msamples_per_s'] for t in ('b4', 'b4_ring_off')]}"
        f" (ring auto, off); peaks B = 1 {out['b1_peak_bytes']}, B = 2 "
        f"{out['b2']['peak_bytes']}, B = 4 {out['b4']['peak_bytes']} bytes;"
        f" card {card}")
    # two streams: B = 1 against B = 2 on the main path's 2-segment file
    gz = runs["gznupsr_2^27"]["data"]
    _l, log2_n, extra, _plan, _per, env = _main_path("gznupsr_2^27")
    out_dir = OUT_DIR / "batch_gznupsr_2^27_single"
    _cfg, text = path_cfg(out_dir, extra, log2_n, "gznupsr_2^27")
    _stats, pipe1, _wall = run_cli(out_dir, text, gz, env)
    gz_run = run_batch_path(card, "gznupsr_2^27", "b2", gz, 2, 2, 2,
                            "auto", _candidate_files(pipe1), [1])
    shutil.rmtree(gz_run.pop("out_dir"))
    shutil.rmtree(out_dir)
    del gz_run["pipe"], pipe1
    out["counts"]["batch_gznupsr_2^27_b2"] = gz_run.pop("counts")
    out["gznupsr_b2"] = gz_run
    free_card()
    for b in (1, 2):
        # B = 1's trace stays for the perf phase's trace_summary
        out[f"profile_b{b}"] = profile_batch(card, "fused_2^27", data, b,
                                             keep_trace=b == 1)
        free_card()
    return out


# ------------------------------------------------------------- perf tools

PERF_DIR = OUT_DIR / "perf"
PERF_REPS = 3
# srtb-torch-bench's legs: (label, its knobs, the main path whose plan
# and launches a segment it runs)
PERF_BENCH = (
    ("bench_2^27", {"SRTB_BENCH_LOG2N": str(LOG2_N_ROWS),
                    "SRTB_BENCH_FFT_STRATEGY": "pallas",
                    "SRTB_BENCH_USE_PALLAS": "1",
                    "SRTB_BENCH_USE_PALLAS_SK": "1"},
     "fused_2^27", "fused:pallas+ftail+skzap"),
    ("bench_2^30", {"SRTB_BENCH_LOG2N": str(LOG2_N),
                    "SRTB_BENCH_USE_PALLAS": "1",
                    "SRTB_BENCH_USE_PALLAS_SK": "1"},
     "staged_2^30", "staged:four_step"),
)
# kernel_bench's rows held to the kernels phase: case -> (the log2n at
# which its shape is the kernels phase's, that shape, the kernels
# phase's time of it from the records by name)
KB_TOLERANCE = 0.15
KB_SAME_SHAPE = {
    "k2": (LOG2_N, f"[{1 << (LOG2_N - 1)}]c64",
           lambda r: r["rfi_s1_dedisperse"]["ms"]),
    "b3": (LOG2_N, f"[{1 << (LOG2_N - 1)}]c64",
           lambda r: r["dedisperse"]["ms"]),
    "k3_k4": (LOG2_N, f"[2048,{1 << (LOG2_N - 1 - LOG2_CHANNELS)}]c64",
              lambda r: r["sk_stats"]["ms"] + r["sk_apply_timeseries"]["ms"]),
    "b6": (LOG2_N_ROWS,
           f"[2048,{1 << (LOG2_N_ROWS - 1 - LOG2_CHANNELS)}]c64",
           lambda r: next(t["ms"] for t in r["fft_rows"]["by_shape"]
                          if t["shape"] == [
                              1 << LOG2_CHANNELS,
                              1 << (LOG2_N_ROWS - 1 - LOG2_CHANNELS)])),
    "b8": (LOG2_N_ROWS,
           f"[2048,{1 << (LOG2_N_ROWS - 1 - LOG2_CHANNELS)}]c64",
           lambda r: r["fft_rows_skzap"]["ms"]),
}


def _json_lines(label: str, text: str) -> list:
    """The JSON lines a tool printed, each said under ``label``."""
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            say(f"{label}: {line}")
            out.append(json.loads(line))
    return out


def perf_bench(card: str, ledger: Path) -> dict:
    """``srtb-torch-bench`` at 2^27 on the pallas knobs and at 2^30 on the
    staged ones, ``PERF_REPS`` reps each, appended to ``ledger``: the plan
    and the launches a segment those of the main path of the same plan;
    returns each leg's line and launches."""
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.tools import bench as B
    out = {}
    for label, knobs, path, plan in PERF_BENCH:
        env = dict(knobs, SRTB_BENCH_REPS=str(PERF_REPS))
        K.reset_launch_counts()
        with path_env(env):
            rc, text = _printed(B.main, ["--ledger", str(ledger)])
        counts = K.launch_counts()
        (line,) = _json_lines(f"perf {label}", text)
        if rc or "error" in line or line["plan"] != plan:
            fail(f"perf {label}: rc {rc}, {line}")
        if line["card"] != card or line["platform"] != "cuda" \
                or not 0 < line["roofline_frac"] < 1:
            fail(f"perf {label}: card {line['card']!r}, platform "
                 f"{line['platform']}, roofline_frac "
                 f"{line.get('roofline_frac')}")
        _check_launches(f"perf {label}", counts, _main_path(path)[4],
                        PERF_REPS)
        say(f"perf {label}: {line['value']} Msamples/s, real-time factor "
            f"{line['vs_baseline']}, roofline_frac {line['roofline_frac']} "
            f"of {line['hbm_peak_gbps']} GB/s ({line['hbm_passes']} "
            f"spectrum passes, {line['model_hbm_gb']} GB a segment), "
            f"segment {line['segment_time_s']} s; card {card}")
        out[label] = {"line": line, "counts": counts}
        free_card()
    return out


def perf_kernel_bench(card: str, recs: list) -> dict:
    """``srtb-torch-kernel-bench`` at its default ``--log2n 28``, then its
    K2, K3 + K4 and B3 rows at 2^30 and B6 and B8 rows at 2^27, the shapes
    of the kernels phase, each within ``KB_TOLERANCE`` of that phase's
    time (its rows at 2^28 have other shapes: said, not held)."""
    from srtb_tpu_torch.tools import kernel_bench as KB
    by_name = {r["name"]: r for r in recs}
    rows = {}
    for argv in ([], ["--log2n", str(LOG2_N), "--only", "k2,b3,k3_k4"],
                 ["--log2n", str(LOG2_N_ROWS), "--only", "b6,b8"]):
        t0 = time.perf_counter()
        rc, text = _printed(KB.main, argv)
        lines = _json_lines(f"perf kernel_bench {' '.join(argv)}".rstrip(),
                            text)
        if rc or any("error" in x or "skipped" in x for x in lines):
            fail(f"perf kernel_bench {argv}: rc {rc}")
        say(f"perf kernel_bench {argv}: {len(lines)} cases in "
            f"{time.perf_counter() - t0:.1f} s; card {card}")
        log2n = int(argv[1]) if argv else 28
        for x in lines:
            rows[(x["case"], log2n)] = x
        free_card()
    for case, (log2n, shape, phase_ms) in KB_SAME_SHAPE.items():
        at28 = rows[(case, 28)]
        say(f"perf kernel_bench {case}: at --log2n 28 {at28['ms']:.4f} ms "
            f"on {at28['shape']}; the kernels phase's shape is {shape}, "
            "another shape: not compared")
        row = rows[(case, log2n)]
        want = phase_ms(by_name)
        if row["shape"] != shape:
            fail(f"perf kernel_bench {case}: shape {row['shape']}, the "
                 f"kernels phase's {shape}")
        dev = row["ms"] / want - 1
        say(f"perf kernel_bench {case} {shape}: {row['ms']:.4f} ms against "
            f"the kernels phase's {want:.4f} ms ({100 * dev:+.1f}%, limit "
            f"{100 * KB_TOLERANCE:.0f}%); card {card}")
        if abs(dev) > KB_TOLERANCE:
            fail(f"perf kernel_bench {case}: {row['ms']:.4f} ms, the "
                 f"kernels phase's {want:.4f} ms")
    return rows


def _sides_text(sides: dict) -> str:
    """Each side's compared samples (one median a short capture, ms) and
    their median, for a selftest's line."""
    return "; ".join(f"{name} {v['samples_ms']} (median {v['median_ms']})"
                     for name, v in sides.items())


def perf_gate_round(card: str, ledger: Path) -> dict:
    """``perf_gate --selftest`` on the card (the injected dispatch stall
    flagged, the clean sides passing; every side pooled from short
    captures in turns, each side's samples printed), then a
    ``--write-baseline`` / ``--baseline`` round trip under ``PERF_DIR``
    (pooled short captures too; its batches cannot alternate, so a
    shift between them beats the floor, ROADMAP C9: on a regression both
    sides are recaptured once, the baseline too, as the selftest's retry
    recaptures both of its clean sides).  The live threads before each
    batch are printed, for C9's cause."""
    import threading
    from srtb_tpu_torch.tools import perf_gate as PG
    t0 = time.perf_counter()
    rc, text = _printed(PG.main, ["--selftest"])
    (st,) = _json_lines("perf perf_gate --selftest", text)
    say("perf perf_gate --selftest samples (ms): "
        f"{_sides_text(st.get('sides', {}))}")
    if rc or st.get("selftest") != "ok" or st["platform"] != "cuda":
        fail(f"perf perf_gate --selftest: rc {rc}, {st}")
    t1 = time.perf_counter()
    say(f"perf perf_gate --selftest: stall {st['stall_s']} s a segment "
        f"flagged (effect {st['stalled']['effect']:.4f}, p "
        f"{st['stalled']['p']:.3e}); clean effect "
        f"{st['clean']['effect']:.4f}, noise floor "
        f"{st['clean']['noise_floor']:.4f}, p {st['clean']['p']:.3f}, "
        f"retried {st['clean']['retried']}; {st['captures']} captures of "
        f"{st['segments']} segments a side; clean median "
        f"{st['median_clean_s']:.6f} s a segment; {t1 - t0:.1f} s; "
        f"card {card}")
    base = PERF_DIR / "baseline.json"
    verdicts = []
    threads = []
    states = []
    for _ in range(2):
        threads.append(threading.active_count())
        states.append([card_state()])
        rc, text = _printed(PG.main, ["--write-baseline", str(base),
                                      "--ledger", str(ledger)])
        states[-1].append(card_state())
        (wb,) = _json_lines("perf perf_gate --write-baseline", text)
        if rc or not base.exists():
            fail(f"perf perf_gate --write-baseline: rc {rc}, {wb}")
        threads.append(threading.active_count())
        states[-1].append(card_state())
        rc, text = _printed(PG.main, ["--baseline", str(base),
                                      "--ledger", str(ledger)])
        states[-1].append(card_state())
        (v,) = _json_lines("perf perf_gate --baseline", text)
        verdicts.append(v)
        if rc != 1:
            break
    base_samples = json.loads(base.read_text())["samples_s"]
    if rc or v["cross_host"]:
        fail(f"perf perf_gate --baseline: rc {rc}, {verdicts}; baseline "
             f"samples (s) {base_samples}")
    rounds = [(round(x["effect"], 4), round(x["noise_floor"], 4))
              for x in verdicts]
    say(f"perf perf_gate round trip: {len(verdicts)} round(s), effect "
        f"{v['effect']:.4f}, noise floor {v['noise_floor']:.4f}, p "
        f"{v['p']:.3f}, medians {v['median_a_s']:.6f} / "
        f"{v['median_b_s']:.6f} s, same host; baseline samples (s) "
        f"{base_samples}; every round's effect / floor {rounds}; live "
        f"threads before each batch {threads} "
        f"({sorted({t.name.split('-')[0] for t in threading.enumerate()})}"
        f"); card state before and after each batch, a round "
        f"{json.dumps(states)}, shifted {[state_shift(x) for x in states]}"
        f"; {time.perf_counter() - t1:.1f} s; card {card}")
    return {"selftest": st, "baseline": verdicts, "card_states": states}


# C9's soak: the round trip's variants, taken in turns a round: as the
# script makes it ("script"), without the ledger writes between the
# batches ("no_ledger"), with the allocators' caches emptied and a
# collection between them ("empty_cache"), and right after a short
# stalled capture ("after_stall"); "drop_first" is "script" compared
# again without each batch's first capture
GATE_SOAK_VARIANTS = ("script", "no_ledger", "empty_cache", "after_stall")


def _round_trip(base: Path, ledger: Path | None, between=None) -> dict:
    """One ``--write-baseline`` / ``--baseline`` round trip (``between``
    called between the batches): its verdict, and each batch's capture
    medians when a ledger took them."""
    from srtb_tpu_torch.tools import perf_gate as PG
    from srtb_tpu_torch.utils import perf_ledger as PL
    extra = ["--ledger", str(ledger)] if ledger is not None else []
    states = [card_state()]
    rc, text = _printed(PG.main, ["--write-baseline", str(base)] + extra)
    states.append(card_state())
    if rc:
        fail(f"gate soak --write-baseline: rc {rc}, {text[-500:]}")
    if between is not None:
        between()
    states.append(card_state())
    rc, text = _printed(PG.main, ["--baseline", str(base)] + extra)
    states.append(card_state())
    (v,) = _json_lines("gate soak --baseline", text)
    out = {k: v[k] for k in ("effect", "noise_floor", "p", "regression",
                             "median_a_s", "median_b_s")}
    out["card_states"] = states
    out["state_shift"] = state_shift(states)
    out["batch_a_s"] = json.loads(base.read_text())["samples_s"]
    if ledger is not None:
        a, b = PL.load(str(ledger))[-2:]
        out["batch_a_s"], out["batch_b_s"] = a["samples_s"], b["samples_s"]
    return out


def _drop_first(r: dict) -> dict:
    from srtb_tpu_torch.utils import perf_stats as PS
    v = PS.compare(r["batch_a_s"][1:], r["batch_b_s"][1:])
    out = {k: v[k] for k in ("effect", "noise_floor", "p", "regression",
                             "median_a_s", "median_b_s")}
    out["state_shift"] = r["state_shift"]
    return out


def gate_round_child(argv: list) -> int:
    """One round trip in a fresh process (``chip_smoke.py
    --gate-round-child DIR``), its line after ``GATE_MARK``."""
    sys.path.insert(0, str(ROOT))
    d = Path(argv[0])
    d.mkdir(parents=True, exist_ok=True)
    r = _round_trip(d / "baseline.json", d / "ledger.jsonl")
    print(GATE_MARK + json.dumps(r), flush=True)
    return 0


GATE_MARK = "GATE_ROUND "


def gate_round_soak(argv: list) -> int:
    """C9's soak (``chip_smoke.py --gate-round-soak N``): the process
    brought to the state the perf phase finds it in (the kernels built,
    staged_2^30's main path run, ``perf_gate --selftest`` run), then N
    rounds, each the round trip's variants in turns
    (``GATE_SOAK_VARIANTS``), each line with its effect, floor, p, both
    batches' medians and capture medians; then N round trips in fresh
    processes.  The last line sums the regressions read by variant."""
    import gc
    import shutil
    import numpy as np
    import torch
    from srtb_tpu_torch.tools import perf_gate as PG
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    n = int(argv[0])
    card = phase_card()
    phase_build()
    made = {}
    label, log2_n, extra, plan, per_segment, env = _main_path("staged_2^30")
    phase_main_path(card, label, log2_n, extra, plan, per_segment, env, made)
    free_card()
    rc, text = _printed(PG.main, ["--selftest"])
    (st,) = _json_lines("gate soak --selftest", text)
    say(f"gate soak: selftest {st['selftest']}, clean "
        f"{st['clean']['effect']:.4f} against {st['clean']['noise_floor']:.4f},"
        f" stall {st['stalled']['effect']:.4f}; card {card}")
    root = OUT_DIR / "gate_soak"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)

    def emptied():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def stalled():
        med = float(np.median(PG.capture(segments=2, warmup=1)["samples_s"]))
        PG.capture(segments=PG.SHORT_SEGMENTS, warmup=4,
                   fault_plan=PG.stall_plan(PG.SHORT_SEGMENTS, 4,
                                            PG.stall_for(med)))
    found: dict = {v: [] for v in GATE_SOAK_VARIANTS + ("drop_first",)}
    for i in range(n):
        for v in GATE_SOAK_VARIANTS:
            d = root / f"{v}_{i}"
            d.mkdir()
            if v == "after_stall":
                stalled()
            r = _round_trip(d / "baseline.json",
                            None if v == "no_ledger" else d / "ledger.jsonl",
                            emptied if v == "empty_cache" else None)
            found[v].append(r)
            say(f"gate soak round {i} {v}: " + json.dumps(r))
            if v == "script":
                r2 = _drop_first(r)
                found["drop_first"].append(r2)
                say(f"gate soak round {i} drop_first: " + json.dumps(r2))
    fresh = []
    for i in range(n):
        d = root / f"fresh_{i}"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--gate-round-child", str(d)], capture_output=True, text=True,
            timeout=600)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(GATE_MARK)]
        if proc.returncode or not lines:
            fail(f"gate soak fresh {i}: rc {proc.returncode}, "
                 f"{proc.stderr[-1500:]}")
        r = json.loads(lines[-1][len(GATE_MARK):])
        fresh.append(r)
        say(f"gate soak fresh {i}: " + json.dumps(r))
    found["fresh"] = fresh

    def first_high(rs):
        # how often a batch's first capture is its slowest
        return sum(int(np.argmax(r[k]) == 0) for r in rs
                   for k in ("batch_a_s", "batch_b_s") if k in r)
    def crossed(rs, regression: bool, shift: bool) -> int:
        # C9's candidate: rounds by verdict against a shift of the card's
        # clocks or throttle reasons between their batches
        return sum(1 for r in rs if bool(r["regression"]) == regression
                   and bool(r["state_shift"]) == shift)
    summary = {v: {"regressions": sum(r["regression"] for r in rs),
                   "effects": [round(r["effect"], 4) for r in rs],
                   "floors": [round(r["noise_floor"], 4) for r in rs],
                   "first_capture_slowest": first_high(rs),
                   "regression_shifted": crossed(rs, True, True),
                   "regression_steady": crossed(rs, True, False),
                   "clean_shifted": crossed(rs, False, True),
                   "clean_steady": crossed(rs, False, False)}
               for v, rs in found.items()}
    shutil.rmtree(root)
    print(json.dumps({"gate_round_soak": summary, "rounds": n,
                      "card": card}), flush=True)
    return 0


def perf_steady(card: str, window: dict, ledger: Path) -> dict:
    """fused_2^27 on the window phase's 8-segment file with
    ``perf_ledger_path``: its candidate files byte for byte the window
    phase's first run's, one "steady" record in ``ledger`` holding the
    run's Msamples/s on the card, and ``perf_report``'s table of the
    ledger."""
    import shutil
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.tools import perf_report as PR
    from srtb_tpu_torch.utils import perf_ledger as PL
    label, log2_n, extra, _plan, per_segment, env = _main_path("fused_2^27")
    w = window["fused_2^27"]
    out_dir = PERF_DIR / "steady_fused_2^27"
    _cfg, text = path_cfg(out_dir, extra + f"perf_ledger_path = {ledger}\n",
                          log2_n, label)
    before = len(PL.load(str(ledger)))
    K.reset_launch_counts()
    stats, pipe, _wall = run_cli(out_dir, text, w["data"], env)
    counts = K.launch_counts()
    _check_launches("perf steady fused_2^27", counts, per_segment,
                    stats.segments)
    _same_candidates("perf steady fused_2^27", _candidate_files(pipe),
                     w["first"])
    recs = PL.load(str(ledger))[before:]
    if len(recs) != 1 or recs[0]["source"] != "steady" \
            or recs[0]["platform"] != "cuda" \
            or abs(recs[0]["value"] - stats.msamples_per_sec) > 1e-6 * \
            stats.msamples_per_sec:
        fail(f"perf steady fused_2^27: ledger records {recs}, the run's "
             f"{stats.msamples_per_sec} Msamples/s")
    say(f"perf steady fused_2^27: record {json.dumps(recs[0])}; card {card}")
    rc, md = _printed(PR.main, [str(ledger)])
    if rc or "| steady | cuda |" not in md:
        fail(f"perf perf_report: rc {rc}\n{md}")
    for line in md.splitlines():
        say(f"perf perf_report: {line}")
    del pipe
    shutil.rmtree(out_dir)
    return {"counts": counts, "record": recs[0]}


def perf_trace(card: str, profile: dict) -> None:
    """``srtb-torch-trace-summary`` of the batch phase's B = 1 profile
    trace: its device plane's total and busy time within 1% of that
    phase's own ``profile`` line; then the trace is deleted."""
    from srtb_tpu_torch.tools import trace_summary as TS
    trace = profile["trace"]
    rc, text = _printed(TS.main, [str(trace), "--top", "8"])
    planes = _json_lines("perf trace_summary", text)
    dev = [p for p in planes if p["plane"].startswith("/device:GPU")]
    if rc or len(dev) != 1:
        fail(f"perf trace_summary: rc {rc}, planes "
             f"{[p['plane'] for p in planes]}")
    (dev,) = dev
    for key, want in (("total_ms", profile["device_total_s"] * 1e3),
                      ("busy_ms", profile["device_busy_s"] * 1e3)):
        dev_rel = dev[key] / want - 1
        say(f"perf trace_summary: {key} {dev[key]} against the profile "
            f"line's {want:.3f} ({100 * dev_rel:+.3f}%, limit 1%); stages "
            f"{json.dumps(dev['stages_ms'])}; card {card}")
        if abs(dev_rel) > 0.01:
            fail(f"perf trace_summary: {key} {dev[key]}, the profile "
                 f"line's {want}")
    trace.unlink()


def phase_perf(card: str, recs: list, window: dict, batch: dict) -> dict:
    """The perf tools on the card (under ``build/chip_smoke/perf``):
    ``srtb-torch-bench`` (:func:`perf_bench`), ``srtb-torch-kernel-bench``
    (:func:`perf_kernel_bench`), ``srtb-torch-fft-bench`` from 2^20 to
    2^27, ``perf_gate`` (:func:`perf_gate_round`), a steady-state ledger
    record and ``perf_report`` (:func:`perf_steady`), and
    ``srtb-torch-trace-summary`` (:func:`perf_trace`).  ``counts`` holds
    the launches of the bench legs and the steady run, by path."""
    import shutil
    from srtb_tpu_torch.tools import fft_bench as FB
    t0 = time.perf_counter()
    if PERF_DIR.exists():
        shutil.rmtree(PERF_DIR)
    PERF_DIR.mkdir(parents=True)
    ledger = PERF_DIR / "ledger.jsonl"
    bench = perf_bench(card, ledger)
    perf_kernel_bench(card, recs)
    t1 = time.perf_counter()
    rc, text = _printed(FB.main, ["20", "27"])
    lines = _json_lines("perf fft_bench", text)
    if rc or len(lines) != 8 * len(FB.STRATEGIES) or \
            any("error" in x for x in lines):
        fail(f"perf fft_bench: rc {rc}, {len(lines)} lines")
    say(f"perf fft_bench: {len(lines)} lines in "
        f"{time.perf_counter() - t1:.1f} s; card {card}")
    free_card()
    perf_gate_round(card, ledger)
    steady = perf_steady(card, window, ledger)
    perf_trace(card, batch["profile_b1"])
    free_card()
    say(f"perf: phase {time.perf_counter() - t0:.1f} s; card {card}")
    shutil.rmtree(PERF_DIR)
    counts = {f"perf_{label}": b["counts"] for label, b in bench.items()}
    counts["perf_steady_fused_2^27"] = steady["counts"]
    return {"counts": counts}


# ------------------------------------------------------------- durability

DURABILITY_SEGMENTS = 4
DURABILITY_PULSES = (1, 2)
# (B, kill plan, writer_thread_count: None keeps the cfg's pool of 2,
# whose last commits of a segment land at its next submit or drain, so
# a stall kill rolls that segment back; 0 writes synchronously, so the
# kill leaves its group committed and the resume skips the replay)
DURABILITY_SOAKS = ((1, "ckpt_stall@1,rename@1", None),
                    (2, "ckpt_stall@2", 0))


def probe_durable_syscalls(d: Path) -> dict:
    """Whether the file system under ``d`` does what the manifest's
    protocol needs: ``fdatasync`` and ``fsync`` of a file, ``fsync`` of
    its directory, and an ``os.replace`` over an existing file; each
    "ok" or the error."""
    out = {}
    tmp, final = d / "probe.tmp", d / "probe"
    final.write_bytes(b"old")

    def attempt(name, fn):
        try:
            fn()
            out[name] = "ok"
        except OSError as e:
            out[name] = f"{type(e).__name__}: {e}"

    with open(tmp, "wb") as f:
        f.write(b"new")
        f.flush()
        attempt("fdatasync(file)", lambda: os.fdatasync(f.fileno()))
        attempt("fsync(file)", lambda: os.fsync(f.fileno()))
    attempt("os.replace", lambda: os.replace(tmp, final))
    out["replaced"] = final.read_bytes() == b"new"

    def dir_fsync():
        fd = os.open(d, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    attempt("fsync(directory)", dir_fsync)
    final.unlink()
    return out


def phase_durability(card: str) -> dict:
    """Durable exactly-once runs on the card: fused_2^27's cfg on a file
    of 4 segments with the pulse in segments 1 and 2, deterministic
    timestamps, the checkpoint and the manifest armed, through the port's
    crash soak (``srtb_tpu_torch/tools/crash_soak.py``, a child process a
    life of the run on the card): the kill plan ``ckpt_stall@1,rename@1``
    at B = 1 with the cfg's writer pool, then ``ckpt_stall@2`` at B = 2 (a
    kill inside a batch) with synchronous writes, whose resume must skip
    the killed segment's committed push, against the same golden run; each soak's gate (fsck clean, the
    output set the golden run's by SHA-256, every kill landed, no
    orphan).  Then fsck's selftest, the file system probe and an
    allocation on the card after the kills."""
    import dataclasses
    import shutil
    import torch
    from srtb_tpu_torch.tools import crash_soak as CS
    from srtb_tpu_torch.tools import fsck as FS
    _l, log2_n, extra, _plan, _per, _env = _main_path("fused_2^27")
    root = OUT_DIR / "durability"
    if root.exists():
        shutil.rmtree(root)
    cfg, _text = path_cfg(root / "cfg", extra, log2_n, "durability")
    data = root / "input.bin"
    t0 = time.perf_counter()
    info = make_input_file(cfg, data, DURABILITY_SEGMENTS, DURABILITY_PULSES)
    say(f"durability: input {data.relative_to(ROOT)} ({info}) made in "
        f"{time.perf_counter() - t0:.1f} s; syscalls "
        + json.dumps(probe_durable_syscalls(root)))
    base = dataclasses.asdict(cfg)
    out, golden = {}, None
    for b, plan, writers in DURABILITY_SOAKS:
        t0 = time.perf_counter()
        try:
            rep = CS.run_soak(kill_plan=plan, micro_batch=b, device=None,
                              writer_threads=writers,
                              tmpdir=str(root / f"b{b}"),
                              base_cfg=base, input_path=str(data),
                              golden=golden)
        except CS.SoakFailure as e:
            fail(f"durability B = {b} ({plan}): {e}")
        golden = rep.pop("golden")
        if golden["segments"] != DURABILITY_SEGMENTS or \
                golden["signals"] != len(DURABILITY_PULSES):
            fail(f"durability: golden run {golden['segments']} segments, "
                 f"{golden['signals']} positive")
        final = rep["children"][-1]
        if any(final["stats"]["recovered"].values()):
            fail(f"durability B = {b}: the last life recovered from faults "
                 f"nobody injected: {final['stats']['recovered']}")
        pool = (f"writer pool of {cfg.writer_thread_count}" if writers is None
                else "synchronous writes")
        if writers == 0 and rep["replayed_skips"] < 1:
            fail(f"durability B = {b} ({plan}, {pool}): the kill left the "
                 "segment's group committed, yet no resume skipped it")
        say(f"durability B = {b}, {pool}, kill plan {plan}: passed in "
            f"{time.perf_counter() - t0:.1f} s; kills landed "
            f"{rep['sigkills']}/{len(rep['plan'])}, replayed_skips "
            f"{rep['replayed_skips']}, rolled_back_intents "
            f"{rep['rolled_back_intents']}, recovered_segments "
            f"{rep['recovered_segments']}, fsck records "
            f"{rep['fsck_records']}, {rep['artifacts']} artifacts equal to "
            "the golden run's by SHA-256; lives (kind, killed, wall s): "
            + json.dumps([(c["kind"], c["killed"], c["wall_s"])
                          for c in rep["children"]])
            + "; checkpoint drain-and-fsync s a segment (last life) "
            + json.dumps(final["stats"]["checkpoint_s"])
            + f"; card {card}")
        out[f"b{b}"] = rep
    selftest = FS.selftest()
    if selftest:
        fail(f"durability: fsck selftest not sharp: {selftest}")
    x = torch.ones(1 << 20, device="cuda")
    usable = float(x.sum().item()) == float(1 << 20)
    say("durability: fsck selftest sharp (a forged CRC, a deleted "
        "artifact, bit rot and a checkpoint ahead of the manifest all "
        f"fail it); the card after {sum(r['sigkills'] for r in out.values())}"
        f" SIGKILLed children holding a CUDA context: usable {usable}")
    if not usable:
        fail("durability: the card is not usable after the kills")
    shutil.rmtree(root)
    return out


# ------------------------------------------------------------- resilience

# the real out-of-memory's path (its main path run keeps its waterfall
# dump for the check of the demoted run's)
OOM_PATH = "staged_pallas2_2^30"
# the ladder walk: fused_2^27 at B = 2 on the window phase's 8-segment file
# (the pulse in segment 5); an out-of-memory or a kernel build fault at
# the dispatch or the fetch of each of segments 0-5 walks the six rungs
# down to the monolithic floor
RESILIENCE_WALK = ("dispatch:oom@0,fetch:compile_fail@1,"
                   "dispatch:compile_fail@2,fetch:oom@3,dispatch:oom@4,"
                   "fetch:compile_fail@5")
RESILIENCE_SOAK_SEED = 7
# the retries: a transient fault at three sites and a corruption at the
# sink, each retried once (the default three attempts)
RESILIENCE_RETRIES = ("ingest:raise@1,h2d:raise@2,fetch:raise@3,"
                      "sink_write:corrupt@4")
# the watchdog: the chain of segment WEDGE_SEGMENT queued behind a
# WEDGE_S-second spin on the compute stream (the watchdog cannot cancel
# it; its requeue runs behind it), and an injected fetch stall, which
# sleeps after the readiness probe in both packages and trips nothing
WEDGE_SEGMENT = 3
WEDGE_S = 1.5
WATCHDOG_DEADLINE_S = 1.0
WATCHDOG_STALL = "fetch:stall=1.5@6"
# the sticky fault, where and at which index: the child process asserts on
# the card inside the chain of segment 1 ("chain"), or its sink thread does
# so at its first push and waits on the card, so that the sink meets the
# halt before the engine ("sink")
STICKY_AT = {"chain": 1, "sink": 0}
STICKY_MARK = "STICKY_RESULT "
# the longest the chain child waits for its injected assert to land
STICKY_LAND_S = 60
RESILIENCE_COUNTERS = ("plan_demotions", "plan_promotions", "device_reinits",
                       "retries_total", "data_loss_total",
                       "watchdog_requeues", "faults_injected",
                       "segments_dropped", "worker_restarts")


def check_no_recovery(label: str, stats) -> None:
    """Fail unless a run needed none of the resilience layers: no
    demotion, reinit, retry or watchdog requeue (the ladder is armed by
    default, and a quiet demotion past a kernel must not pass a path)."""
    ex = stats.extras
    used = {k: ex.get(k, 0) for k in ("plan_demotions", "device_reinits",
                                      "retries_total", "watchdog_requeues")}
    if any(used.values()):
        fail(f"{label}: the run recovered from faults nobody injected: "
             f"{used}")


def _counters(pipe) -> dict:
    """The resilience counters of the metrics registry (the run's own:
    :func:`_run_pipeline` resets it)."""
    from srtb_tpu_torch.utils.metrics import metrics
    return {k: metrics.get(k) for k in RESILIENCE_COUNTERS}


def rung_table(card: str, label: str, cfg, env: dict) -> list:
    """Each rung of ``cfg``'s demotion ladder (rung 0 the configured
    plan) built as a processor on the card: its plan, the peak memory of
    its first dispatch on one random segment (the module caches of device
    tables emptied first: a rung's first dispatch builds its own), then
    the chain's device ms and peak on the same segment, and the kernels
    it launches."""
    import torch
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.pipeline import registry
    from srtb_tpu_torch.resilience.demote import ladder_rungs
    out = []
    with path_env(env):
        rungs = [("full", cfg, None)] + [(r.step, r.cfg, r.staged)
                                         for r in ladder_rungs(cfg)]
        seg = cfg.segment_bytes(1)
        host = torch.randint(0, 256, (seg,), dtype=torch.uint8,
                             generator=torch.Generator().manual_seed(3))
        host = host.pin_memory()
        for level, (step, rcfg, staged) in enumerate(rungs):
            free_card()
            torch.cuda.reset_peak_memory_stats()
            proc = registry.build_processor(rcfg, staged=staged)
            raw = proc.stage_input(host.numpy())
            proc.run_device(raw)
            torch.cuda.synchronize()
            first = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            ms = cuda_ms(lambda: proc.run_device(raw), 1)
            counts = {k: v // 2 for k, v in K.launch_counts().items() if v}
            row = {"level": level, "step": step, "plan": proc.plan_name,
                   "staged": staged, "cfg": rcfg, "chain_ms": ms,
                   "first_peak_bytes": first,
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "launches": counts}
            say(f"resilience rung {label} {level} ({step}): plan "
                f"{proc.plan_name}, chain {ms:.3f} ms, peak "
                f"{row['peak_bytes']} bytes "
                f"({row['peak_bytes'] / 1e9:.2f} GB; the first dispatch "
                f"{first / 1e9:.2f} GB), launches a segment "
                f"{json.dumps(counts)}; card {card}")
            out.append(row)
            del proc, raw
        del host
    free_card()
    return out


def _recording(pipe) -> dict:
    """Wrap a pipeline's processor swap, its dispatch and the healer's
    demotion: each installed rung's plan and the launches made on the rung
    before it, the time of the first device fault, and the time of the
    first dispatch after it returned on the final rung."""
    from srtb_tpu_torch import kernels as K
    rec = {"plans": [pipe.processor.plan_name], "launches": [],
           "t_fault": None, "t_recovered": None}
    swap = pipe._swap_processor

    def recording_swap(newp):
        rec["launches"].append(K.launch_counts())
        K.reset_launch_counts()
        rec["plans"].append(newp.plan_name)
        swap(newp)
    pipe._swap_processor = recording_swap
    h = pipe.healer
    demote, reinit = h.demote, h.reinit

    def timed(fn):
        def wrapper(*args):
            if rec["t_fault"] is None:
                rec["t_fault"] = time.perf_counter()
            return fn(*args)
        return wrapper
    h.demote, h.reinit = timed(demote), timed(reinit)
    dispatch = pipe._dispatch_segment

    def timed_dispatch(*args, **kwargs):
        item = dispatch(*args, **kwargs)
        if rec["t_fault"] is not None and rec["t_recovered"] is None:
            rec["t_recovered"] = time.perf_counter()
        return item
    pipe._dispatch_segment = timed_dispatch
    return rec


def _run_pipeline(cfg, data: Path, env: dict, setup=None,
                  staged: bool | None = None):
    """``Pipeline(cfg)`` on ``data`` (the run's statistics, the pipeline
    and what ``setup(pipe)`` returned), the launch counts zeroed just
    before the run and the telemetry (:func:`fresh_telemetry`) before
    the pipeline is built; ``staged`` is the processor's argument (a
    rung's); the pipeline is closed."""
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.pipeline import registry
    from srtb_tpu_torch.pipeline.runtime import Pipeline
    cfg = cfg.replace(input_file_path=str(data))
    fresh_telemetry()
    with path_env(env):
        pipe = Pipeline(cfg, processor=None if staged is None else
                        registry.build_processor(cfg, staged=staged))
        extra = setup(pipe) if setup is not None else None
        K.reset_launch_counts()
        try:
            stats = pipe.run()
        finally:
            pipe.close()
    return stats, pipe, extra


# a stage-1 bin whose float64 power is within this fraction of the
# threshold may be zapped by one plan and kept by another (the edge of
# tests/test_torch_segment.py's float64 spectrum test)
S1_EDGE = 1e-5
# the segment tests' waterfall gate, a fraction of the largest value
WF_GATE = 2e-5


def _segment_bytes(cfg, data: Path, index: int):
    """Segment ``index`` of ``data`` under ``cfg``, its bytes on the
    card."""
    import torch
    from srtb_tpu_torch.io.file_input import make_file_source
    src = make_file_source(cfg.replace(input_file_path=str(data)))
    try:
        for i, seg in enumerate(src):
            if i == index:
                return torch.from_numpy(seg.data).to("cuda")
    finally:
        src.close()
    fail(f"{data} holds no segment {index}")


def _edge_slack(cfg, raw, rows: int, row_len: int):
    """Each waterfall row's slack [rows] for stage-1 decisions at the
    threshold: the float64 spectrum of the segment (the plain unpack,
    exact; the default rectangle window; R2C without the Nyquist bin), the
    bins whose power is within ``S1_EDGE`` of the threshold, and for each
    row the sum of those bins' normalized magnitudes, the most that
    zapping or keeping them moves a sample of the row (an unnormalized
    backward C2C)."""
    import torch
    from srtb_tpu_torch.kernels import unpack as KU
    from srtb_tpu_torch.ops import rfi
    x = KU.unpack_subbyte_window_plain(raw, cfg.baseband_input_bits)
    spec = torch.fft.rfft(x.to(torch.float64))[:-1]
    del x
    mag = spec.abs()
    del spec
    p = mag * mag
    ratio = p / (cfg.mitigate_rfi_average_method_threshold * p.mean())
    del p
    idx = torch.nonzero((ratio - 1).abs() <= S1_EDGE)[:, 0]
    del ratio
    idx = idx[idx < rows * row_len]
    norm = rfi.normalization_coefficient(mag.shape[0], rows)
    slack = torch.zeros(rows, dtype=torch.float64, device=mag.device)
    slack.index_add_(0, idx // row_len, mag[idx] * norm)
    return slack, int(idx.numel())


def check_demoted_dumps(label: str, cfg, data: Path, pulse: int, got: dict,
                        clean: dict) -> dict:
    """The pulse segment's waterfall dump (.npy) and boxcar-1 series
    (.1.tim) from a run that ended on a demoted rung, against the clean
    plan's, within the gates ``tests/test_torch_segment.py`` holds every
    plan to: each waterfall row within ``WF_GATE`` of the largest value,
    plus the row's slack for stage-1 bins at the threshold
    (:func:`_edge_slack`; a row the SK zap took in one run only must hold
    such a bin), and the series within ``time_series_error_gates`` of the
    waterfall error found.  The files' names (the decisions) must be
    equal.  Returns the errors."""
    import numpy as np
    import torch
    from srtb_tpu_torch.ops import detect as det
    npys = sorted(n for n in got if n.endswith(".npy"))
    tims = sorted(n for n in got if n.endswith(".1.tim"))
    if not npys or not tims or len(npys) != 1 \
            or npys != sorted(n for n in clean if n.endswith(".npy")) \
            or sorted(n for n in got if n.endswith(".tim")) \
            != sorted(n for n in clean if n.endswith(".tim")):
        fail(f"{label}: dumps {sorted(got)}, the clean plan's "
             f"{sorted(clean)}: one waterfall and a boxcar-1 series each")
    g = np.load(got[npys[0]], mmap_mode="r")
    c = np.load(clean[npys[0]], mmap_mode="r")
    if g.shape != c.shape or g.ndim != 2:
        fail(f"{label}: waterfall {g.shape} against {c.shape}")
    rows, row_len = c.shape
    slack, edge_bins = _edge_slack(cfg, _segment_bytes(cfg, data, pulse),
                                   rows, row_len)
    ts_got = np.fromfile(got[tims[0]], dtype="<f4")
    ts_clean = np.fromfile(clean[tims[0]], dtype="<f4")
    t = ts_clean.shape[0]
    err = torch.zeros(rows, dtype=torch.float64, device="cuda")
    sk_differs = torch.zeros(rows, dtype=torch.bool, device="cuda")
    top, power = 0.0, torch.zeros(t, dtype=torch.float64, device="cuda")
    step = max(1, (1 << 27) // row_len)
    for r in range(0, rows, step):
        a = torch.from_numpy(np.array(g[r:r + step])).cuda()
        b = torch.from_numpy(np.array(c[r:r + step])).cuda()
        err[r:r + step] = (a - b).abs().amax(-1).double()
        sk_differs[r:r + step] = (a == 0).all(-1) != (b == 0).all(-1)
        top = max(top, float(b.abs().amax()))
        power += (b[:, :t].abs().double() ** 2).sum(0)
        del a, b
    gate = WF_GATE * top + slack
    bad = (err > gate) | (sk_differs & (slack == 0))
    if bool(bad.any()):
        r = int(torch.nonzero(bad)[0, 0])
        fail(f"{label}: {int(bad.sum())} waterfall rows off the clean "
             f"plan's beyond the gate; row {r}: {float(err[r]):.4e} against "
             f"{float(gate[r]):.4e} ({WF_GATE} x {top:.4e} + slack "
             f"{float(slack[r]):.4e})")
    wf_err = float(err.max())
    ts_gate = sum(det.time_series_error_gates(rows, t, float(power.max()),
                                              wf_err))
    ts_err = float(np.abs(ts_got.astype(np.float64) - ts_clean).max())
    if ts_got.shape != ts_clean.shape or ts_err > ts_gate:
        fail(f"{label}: the boxcar-1 series off the clean plan's by "
             f"{ts_err:.4e} (gate {ts_gate:.4e})")
    out = {"edge_bins": edge_bins, "rows_with_slack": int((slack > 0).sum()),
           "sk_rows_differ": int(sk_differs.sum()),
           "wf_err_max": wf_err, "wf_err_strict_rows_max": float(
               err[slack == 0].max()) if bool((slack == 0).any()) else 0.0,
           "wf_gate_strict": WF_GATE * top, "ts_err": ts_err,
           "ts_gate": ts_gate}
    say(f"{label}: the pulse segment's waterfall and boxcar-1 series "
        f"against the clean plan's, within the segment tests' gates: "
        + json.dumps(out))
    del err, sk_differs, power, slack
    free_card()
    return out


def resilience_walk(card: str, window: dict) -> dict:
    """(a) The injected ladder walk on fused_2^27 at B = 2 over the window
    phase's 8 segments: ``RESILIENCE_WALK`` demotes once a fault, down to
    the monolithic floor; each rung's plan and launches, the decisions
    and the baseband bytes of the window phase's first run.  Then the
    chaos soak on the card and its selftest."""
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.tools import chaos_soak as CS
    w = window["fused_2^27"]
    _l, log2_n, extra, _plan, _per, env = _main_path("fused_2^27")
    out_dir = OUT_DIR / "resilience_walk"
    cfg, _text = path_cfg(out_dir, extra + "micro_batch_segments = 2\n"
                          f"fault_plan = {RESILIENCE_WALK}\n", log2_n,
                          "resilience_walk")
    rungs = rung_table(card, "fused_2^27", cfg.replace(fault_plan=""), env)
    t0 = time.perf_counter()
    stats, pipe, rec = _run_pipeline(cfg, w["data"], env, _recording)
    rec["launches"].append(K.launch_counts())
    wall = time.perf_counter() - t0
    counters = _counters(pipe)
    injected = len(RESILIENCE_WALK.split(","))
    say(f"resilience walk fused_2^27 (B = 2, 8 segments, plan "
        f"{RESILIENCE_WALK}): {wall:.2f} s; the rungs and the launches on "
        "each "
        + json.dumps([{"plan": p, "launches": {k: v for k, v in c.items()
                                               if v}}
                      for p, c in zip(rec["plans"], rec["launches"])])
        + f"; counters {json.dumps(counters)}; positive "
        f"{pipe.positive_segments}; card {card}")
    want_plans = [r["plan"] for r in rungs]
    if rec["plans"] != want_plans:
        fail(f"resilience walk: rungs {rec['plans']}, the ladder's "
             f"{want_plans}")
    if counters["plan_demotions"] != injected \
            or counters["faults_injected"] != injected:
        fail(f"resilience walk: {counters['plan_demotions']} demotions, "
             f"{counters['faults_injected']} faults fired, {injected} "
             "injected")
    if stats.segments != 8 or pipe.positive_segments != [5]:
        fail(f"resilience walk: {stats.segments} segments, positive "
             f"{pipe.positive_segments}; the clean run's: 8 and [5]")
    got = _candidate_files(pipe)
    bins = sorted(n for n in got if n.endswith(".bin"))
    if bins != sorted(n for n in w["first"] if n.endswith(".bin")) or \
            not all(_same_bytes(got[n], w["first"][n]) for n in bins):
        fail(f"resilience walk: baseband dumps {bins} differ from the "
             "clean run's")
    say(f"resilience walk: decisions the clean run's, baseband dumps "
        f"{bins} equal in bytes")
    dumps = check_demoted_dumps(
        f"resilience walk (the floor {rec['plans'][-1]} against "
        f"{rec['plans'][0]})", cfg, w["data"], 5, got, w["first"])
    import shutil
    shutil.rmtree(out_dir)
    free_card()
    t0 = time.perf_counter()
    try:
        rep = CS.run_soak(seed=RESILIENCE_SOAK_SEED, segments=6, faults=4,
                          log2n=LOG2_N_ROWS - 13,
                          tmpdir=str(OUT_DIR / "resilience_soak"))
    except CS.SoakFailure as e:
        fail(f"resilience chaos soak: {e}")
    say(f"resilience chaos soak (seed {RESILIENCE_SOAK_SEED}, 2^"
        f"{LOG2_N_ROWS - 13} samples): gate passed in "
        f"{time.perf_counter() - t0:.1f} s: " + json.dumps(rep))
    t0 = time.perf_counter()
    sharp = CS.selftest()
    if sharp:
        fail(f"resilience chaos soak selftest not sharp: {sharp}")
    say("resilience chaos soak selftest: an injected fatal fault and an "
        "out-of-memory with healing off fail the gate, one out-of-memory "
        f"with healing armed passes ({time.perf_counter() - t0:.1f} s)")
    shutil.rmtree(OUT_DIR / "resilience_soak", ignore_errors=True)
    return {"counts": rec["launches"], "rungs": rungs,
            "plans": rec["plans"], "dumps": dumps}


def resilience_real_oom(card: str, made: dict, clean: dict) -> dict:
    """(b) A real out-of-memory: staged_pallas2_2^30, serial (so that
    every segment runs on the rung that survives), under
    ``torch.cuda.set_per_process_memory_fraction``: the cap 1 GB under the
    peak of rung 0's first dispatch, above the first rung whose first
    dispatch peaks 3 GB under it (each rung measured here, its module
    caches of device tables built by that dispatch: B9's twiddle table
    alone is 8 GiB at 2^30, and the later chains' peaks leave it out), so
    that rung 0 raises a real ``torch.cuda.OutOfMemoryError`` on segment
    0 and the ladder walks to a rung that fits.  Gates: the run completes, demotes, stays under
    the cap and ends on that rung; its candidate bytes equal an uncapped
    run started on that rung's cfg, and its pulse segment's waterfall and
    series the main path's (``clean``, its candidate files, rung 0)
    within the segment tests' gates; the seconds from the fault to the
    first dispatch on the new rung."""
    import shutil
    import torch
    _l, log2_n, extra, _plan, _per, env = _main_path(OOM_PATH)
    out_dir = OUT_DIR / "resilience_oom"
    cfg, _text = path_cfg(out_dir, extra + "inflight_segments = 1\n",
                          log2_n, "resilience_oom")
    data = input_file(cfg, OOM_PATH, made)
    rungs = rung_table(card, OOM_PATH, cfg, env)
    peak0 = rungs[0]["first_peak_bytes"]
    fit = next((r for r in rungs[1:]
                if r["first_peak_bytes"] < peak0 - 3e9), None)
    if fit is None:
        fail("resilience oom: no rung of staged_pallas2_2^30 peaks 3 GB "
             f"below rung 0's {peak0} bytes")
    total = torch.cuda.get_device_properties(0).total_memory
    cap = peak0 - 1e9
    free_card()
    torch.cuda.set_per_process_memory_fraction(cap / total)
    torch.cuda.reset_peak_memory_stats()
    try:
        stats, pipe, rec = _run_pipeline(cfg, data, env, _recording)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    peak = torch.cuda.max_memory_allocated()
    counters = _counters(pipe)
    recovery_s = rec["t_recovered"] - rec["t_fault"] \
        if rec["t_recovered"] else None
    say(f"resilience oom staged_pallas2_2^30 (serial, cap {cap:.0f} bytes "
        f"= {cap / 1e9:.2f} GB, {cap / total:.4f} of the card): rungs "
        f"{rec['plans']}, counters {json.dumps(counters)}, peak {peak} "
        f"bytes ({peak / 1e9:.2f} GB), positive {pipe.positive_segments}, "
        f"{stats.msamples_per_sec:.1f} Msamples/s; from the first "
        f"out-of-memory to the first dispatch on the new rung "
        f"{recovery_s} s; card {card}")
    if counters["plan_demotions"] < 1 or peak > cap:
        fail(f"resilience oom: {counters['plan_demotions']} demotions, "
             f"peak {peak} of cap {cap:.0f}")
    if rec["plans"][-1] != fit["plan"]:
        fail(f"resilience oom: ended on {rec['plans'][-1]}, the first rung "
             f"below the cap is {fit['plan']}")
    if stats.segments != 2 or pipe.positive_segments != [1]:
        fail(f"resilience oom: {stats.segments} segments, positive "
             f"{pipe.positive_segments}")
    got = _candidate_files(pipe)
    free_card()
    direct_dir = OUT_DIR / "resilience_oom_direct"
    direct_dir.mkdir(parents=True, exist_ok=True)
    dcfg = fit["cfg"].replace(
        baseband_output_file_prefix=f"{direct_dir}/out_")
    dstats, dpipe, _ = _run_pipeline(dcfg, data, env, staged=fit["staged"])
    check_no_recovery("resilience oom direct run", dstats)
    if dpipe.processor.plan_name != fit["plan"]:
        fail(f"resilience oom: the direct run took {dpipe.processor.plan_name}")
    _same_candidates("resilience oom (against the uncapped run on "
                     f"{fit['plan']})", got, _candidate_files(dpipe))
    say(f"resilience oom: candidate files {sorted(got)} equal in bytes to "
        f"an uncapped run on {fit['plan']}")
    shutil.rmtree(direct_dir)
    del dpipe
    free_card()
    dumps = check_demoted_dumps(
        f"resilience oom ({fit['plan']} against the main path's "
        f"{rec['plans'][0]})", cfg, data, 1, got, clean)
    shutil.rmtree(out_dir)
    for name, path in clean.items():
        if name.endswith(".npy"):
            os.unlink(path)
    return {"counts": rec["launches"], "recovery_s": recovery_s,
            "cap_bytes": cap, "peak_bytes": peak, "rungs": rungs,
            "dumps": dumps}


def sticky_child(argv: list) -> int:
    """The sticky fault's child (``chip_smoke.py --sticky-child CFG
    INJECT [WHERE]``): the pipeline of the JSON config ``CFG`` with a
    device-side assert triggered inside the chain of segment ``INJECT``
    (WHERE ``chain``, the default: enqueued as a kernel's own assert is,
    then waited for until it has landed, so that every check the engine
    makes after it meets the dead context) or by the sink thread at push
    ``INJECT``
    (``sink``, which then waits on the card); ``INJECT`` < 0: none, a
    plain resume.  Prints the outcome after ``STICKY_MARK`` and exits 1
    when the run raised."""
    sys.path.insert(0, str(ROOT))
    import torch
    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.pipeline import segment as S
    from srtb_tpu_torch.pipeline.runtime import Pipeline
    from srtb_tpu_torch.resilience import errors as E
    cfg_path, inject = argv[0], int(argv[1])
    where = argv[2] if len(argv) > 2 else "chain"
    with open(cfg_path) as f:
        cfg = Config(**json.load(f))
    calls = [0]

    def device_assert(device) -> None:
        # an index past the end, checked on the card: a device-side
        # assert, which kills the CUDA context for the process
        x = torch.zeros(4, device=device)
        x[torch.tensor([10], device=device)]

    def assert_landed(device) -> None:
        # the chain's assert is left in flight, but the engine checks
        # nothing until it has landed: every later query and free then
        # meets a dead context, whatever the host's timing
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < STICKY_LAND_S:
            try:
                torch.cuda.current_stream(device).query()
            except RuntimeError:  # torch.AcceleratorError: it landed
                return
            time.sleep(0.001)
        raise SystemExit(f"the injected assert did not land within "
                         f"{STICKY_LAND_S} s")

    if where == "chain":
        run_device = S.SegmentProcessor._chain

        def asserting_run_device(self, raw):
            calls[0] += 1
            if calls[0] == inject + 1:
                device_assert(raw.device)
                assert_landed(raw.device)
            return run_device(self, raw)
        S.SegmentProcessor._chain = asserting_run_device
    else:
        push_sinks = Pipeline._push_sinks

        def asserting_push(self, item, positive, seg_key):
            calls[0] += 1
            if calls[0] == inject + 1:
                device_assert(self.processor.device)
                torch.cuda.synchronize(self.processor.device)
            return push_sinks(self, item, positive, seg_key)
        Pipeline._push_sinks = asserting_push
    out = {"error": "", "cause": "", "kind": None}
    pipe = Pipeline(cfg)
    reinit = pipe.healer.reinit

    def reporting_reinit(exc):
        # each reinit decision as it is made, should the process die later
        newp = reinit(exc)
        print(f"STICKY_REINIT {E.classify_device(exc)} "
              f"{'rebuilt' if newp is not None else 'budget spent'}",
              flush=True)
        return newp
    pipe.healer.reinit = reporting_reinit
    if pipe.incidents is not None:
        dump = pipe.incidents.dump

        def reporting_dump(*args, **kwargs):
            # the escalation's bundle, timed, as it is written (on a dead
            # context: it must touch nothing on the card)
            t0 = time.perf_counter()
            path = dump(*args, **kwargs)
            print(f"STICKY_INCIDENT {time.perf_counter() - t0:.6f} "
                  f"{os.path.basename(path or '')}", flush=True)
            return path
        pipe.incidents.dump = reporting_dump
    try:
        stats = pipe.run()
        out["segments"] = stats.segments
    except BaseException as e:  # noqa: BLE001 - reported
        cause = e.__cause__ or e
        # where the run's error was raised: its last frames
        where = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                 for f in traceback.extract_tb(e.__traceback__)[-4:]]
        out.update(error=type(e).__name__, cause=type(cause).__name__,
                   kind=E.classify_device(cause),
                   message=str(cause).splitlines()[0][:200], where=where)
    from srtb_tpu_torch.utils.metrics import metrics
    out["counters"] = {k: metrics.get(k) for k in RESILIENCE_COUNTERS}
    print(STICKY_MARK + json.dumps(out), flush=True)
    if out["error"]:
        # the run is lost, its outputs durable: on a dead context torch
        # aborts the process from the destructors of its pinned buffers,
        # so end it here, as a crash would
        os._exit(1)
    pipe.close()
    return 0


def _sticky_run(cfg_path: Path, inject: int, where: str = "chain"
                ) -> dict:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--sticky-child",
         str(cfg_path), str(inject), where], capture_output=True,
        text=True, timeout=600)
    # beside the run directory, whose output set the gate compares
    log = cfg_path.parent.parent / f"{cfg_path.parent.name}_{inject}.log"
    log.write_text(proc.stdout + proc.stderr)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(STICKY_MARK)]
    decisions = [ln.split(" ", 1)[1] for ln in proc.stdout.splitlines()
                 if ln.startswith("STICKY_REINIT ")]
    bundles = [ln.split(" ")[1:] for ln in proc.stdout.splitlines()
               if ln.startswith("STICKY_INCIDENT ")]
    if not lines and decisions and decisions[-1] == "halt budget spent" \
            and proc.returncode:
        # torch aborted the process after the escalation was decided (it
        # frees pinned results from a destructor, which raises on a dead
        # context): the decisions tell the run's end
        return {"error": "ReinitBudgetExceeded", "cause": "AcceleratorError",
                "kind": "halt", "decisions": decisions,
                "aborted_after_escalation": True, "rc": proc.returncode,
                "bundles": bundles,
                "counters": {"device_reinits": decisions.count(
                    "halt rebuilt")}}
    if not lines:
        heal = [ln[:160] for ln in (proc.stdout + proc.stderr).splitlines()
                if "[selfheal]" in ln or "[supervisor]" in ln
                or "STICKY_REINIT" in ln or "Error" in ln]
        fail(f"resilience sticky: the child printed no result (rc "
             f"{proc.returncode}); its engine's lines {heal[-12:]}; "
             f"stderr {proc.stderr[-1500:]}")
    return dict(json.loads(lines[-1][len(STICKY_MARK):]),
                rc=proc.returncode, decisions=decisions, bundles=bundles)


def _log_tail(cfg_path: Path, inject: int, n: int = 1500) -> str:
    """The end of a sticky child's log (``_sticky_run`` wrote it), for a
    failure's message."""
    log = cfg_path.parent.parent / f"{cfg_path.parent.name}_{inject}.log"
    return log.read_text()[-n:] if log.exists() else "(no log)"


def check_sticky_bundle(where: str, inc: Path, faulted: dict,
                        card: str) -> None:
    """The faulted child's escalation left one ``reinit_budget_exceeded``
    bundle, written after the real halt (its events hold the halt's
    ``fault.device``), with the metrics, events and config snapshots."""
    bundles = sorted(p.name for p in inc.iterdir()) if inc.exists() else []
    if bundles != ["incident_000_reinit_budget_exceeded"]:
        fail(f"resilience sticky ({where}): incident bundles {bundles}")
    b = inc / bundles[0]
    files = sorted(os.listdir(b))
    evs = [json.loads(line) for line in
           (b / "events.jsonl").read_text().splitlines()]
    halts = [e["info"] for e in evs if e["type"] == "fault.device"
             and e["info"].startswith("halt")]
    if not {"metrics.json", "events.jsonl", "config.json"} <= set(files) \
            or not halts:
        fail(f"resilience sticky ({where}): bundle files {files}, halt "
             f"events {halts}")
    say(f"resilience sticky ({where}): bundle {b.name} with {files}, "
        f"{len(evs)} events (halts {halts}); dumped in "
        f"{[x[0] for x in faulted.get('bundles', [])]} s after the halt; "
        f"card {card}")


def _sticky_dirs(root: Path, tags) -> dict:
    """fused_2^27's cfg on a file of 4 segments (the pulse in segments 1
    and 2) under a fresh ``root``, and a run directory a tag holding its
    ``cfg.json``: the checkpoint, the run manifest and (but for
    ``golden``) an incident directory beside it.  Returns the path's
    environment."""
    import dataclasses
    import shutil
    _l, log2_n, extra, _plan, _per, env = _main_path("fused_2^27")
    if root.exists():
        shutil.rmtree(root)
    cfg, _text = path_cfg(root / "cfg", extra, log2_n, root.name)
    data = root / "input.bin"
    make_input_file(cfg, data, DURABILITY_SEGMENTS, DURABILITY_PULSES)
    for tag in tags:
        d = root / tag
        d.mkdir()
        # the faulted runs' escalation bundles, beside the run directory
        # (whose output set the gate compares)
        incidents = str(root / f"{tag}_incidents") if tag != "golden" \
            else ""
        fields = dataclasses.asdict(cfg.replace(
            input_file_path=str(data),
            baseband_output_file_prefix=f"{d}/out_",
            checkpoint_path=str(d / "ck.json"),
            run_manifest_path=str(d / "manifest.jsonl"),
            incident_dir=incidents, incident_min_interval_s=0.0))
        (d / "cfg.json").write_text(json.dumps(fields))
    return env


def sticky_soak(argv: list) -> int:
    """``chip_smoke.py --sticky-soak N``: the sticky chain fault
    (:func:`sticky_child`, its assert left in flight) in N fresh
    children, each in a run directory of its own; one JSON line a child
    (its outcome, decisions and bundles) and a summary last: how many
    escalated ``ReinitBudgetExceeded`` with one bundle, how many the
    process aborted before it printed a result (ROADMAP C8), and how many
    ended otherwise.  Needs the card."""
    import shutil
    import torch
    if not torch.cuda.is_available():
        print("sticky soak: no CUDA device", file=sys.stderr)
        return 1
    n = int(argv[0])
    root = OUT_DIR / "sticky_soak"
    tags = [f"chain{i}" for i in range(n)]
    _sticky_dirs(root, tags)
    escalated = aborted = 0
    for tag in tags:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--sticky-child", str(root / tag / "cfg.json"),
             str(STICKY_AT["chain"]), "chain"], capture_output=True,
            text=True, timeout=600)
        lines = proc.stdout.splitlines()
        marks = [ln for ln in lines if ln.startswith(STICKY_MARK)]
        inc = root / f"{tag}_incidents"
        row = {"child": tag, "rc": proc.returncode,
               "s": round(time.perf_counter() - t0, 1),
               "result": (json.loads(marks[-1][len(STICKY_MARK):])
                          if marks else None),
               "decisions": [ln.split(" ", 1)[1] for ln in lines
                             if ln.startswith("STICKY_REINIT ")],
               "bundles": sorted(p.name for p in inc.iterdir())
               if inc.exists() else []}
        if not marks:
            row["stderr"] = proc.stderr[-2000:]
        aborted += not marks
        escalated += bool(marks and row["result"]["error"]
                          == "ReinitBudgetExceeded"
                          and len(row["bundles"]) == 1)
        print(json.dumps(row), flush=True)
    shutil.rmtree(root)
    print(json.dumps({"children": n, "escalated": escalated,
                      "aborted": aborted,
                      "other": n - escalated - aborted}))
    return 0


def resilience_sticky(card: str) -> dict:
    """(c) A real sticky fault: fused_2^27's cfg on a file of 4 segments
    (the pulse in segments 1 and 2) with the checkpoint and the run
    manifest, in a child process whose chain of segment 1 asserts on the
    card, and in one whose sink thread meets the assert first (at its
    first push); the port must classify the error ``halt``, and the run
    end with ``ReinitBudgetExceeded`` and a nonzero exit (a reinit cannot
    revive a dead context).  A fresh process then resumes each from its
    checkpoint, and each run directory's output set must equal an
    uninterrupted run's (in this process) by SHA-256 (the crash soak's
    snapshot)."""
    import shutil
    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.tools import crash_soak as CRS
    root = OUT_DIR / "resilience_sticky"
    env = _sticky_dirs(root, ("golden",) + tuple(STICKY_AT))
    data = root / "input.bin"
    out = {}
    gcfg = Config(**json.loads((root / "golden" / "cfg.json").read_text()))
    gstats, _gpipe, _ = _run_pipeline(gcfg, data, env)
    golden = {"error": "", "rc": 0, "segments": gstats.segments}
    if golden["error"] or golden["rc"]:
        fail(f"resilience sticky: the golden run failed: {golden}")
    want = CRS.snapshot_outputs(str(root / "golden"))
    for where, at in STICKY_AT.items():
        cfg_path = root / where / "cfg.json"
        t0 = time.perf_counter()
        faulted = _sticky_run(cfg_path, at, where)
        t1 = time.perf_counter()
        resumed = _sticky_run(cfg_path, -1)
        t2 = time.perf_counter()
        got = CRS.snapshot_outputs(str(root / where))
        say(f"resilience sticky fused_2^27 ({where}): golden "
            f"{json.dumps(golden)}; faulted {json.dumps(faulted)}; resumed "
            f"{json.dumps(resumed)}; the faulted life and the resume "
            f"{t1 - t0:.1f} s and {t2 - t1:.1f} s; output set "
            f"{sorted(got)}; card {card}")
        if faulted["error"] != "ReinitBudgetExceeded" or \
                faulted["kind"] != "halt" or not faulted["rc"]:
            fail(f"resilience sticky ({where}): the faulted run ended "
                 f"{faulted}; expected ReinitBudgetExceeded after a halt, "
                 "nonzero exit; its log ends " + _log_tail(cfg_path, at))
        check_sticky_bundle(where, root / f"{where}_incidents", faulted,
                            card)
        if resumed["error"] or resumed["rc"]:
            fail(f"resilience sticky ({where}): the resume failed: "
                 f"{resumed}; its log ends " + _log_tail(cfg_path, -1))
        if got != want:
            fail(f"resilience sticky ({where}): the resumed output set "
                 f"differs from the uninterrupted run's: {got} against "
                 f"{want}")
        restarts = faulted["counters"].get("worker_restarts")
        say(f"resilience sticky ({where}): classified {faulted['kind']} "
            f"({faulted['cause']}), escalated {faulted['error']} after "
            f"{faulted['counters']['device_reinits']} reinits and "
            f"{restarts} sink restarts; the resumed output set equals the "
            f"uninterrupted run's by SHA-256 ({len(got)} files)")
        out[where] = {"faulted_s": t1 - t0, "resume_s": t2 - t1,
                      "sink_restarts": restarts}
    shutil.rmtree(root)
    return out


def _wedging(pipe, segment: int) -> None:
    """Queue ``WEDGE_S`` seconds of spin (``torch.cuda._sleep``, its
    cycles a second measured first) on the compute stream before the chain
    of dispatch ``segment``, the first time only: that segment's ``done``
    event stays incomplete past the watchdog's deadline."""
    import torch
    probe = int(1e8)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    cycles = int(WEDGE_S * probe / (start.elapsed_time(end) / 1e3))
    proc = pipe.processor
    run = proc.run_device_ring
    calls = [0]

    def wedged(raw, warm=True):
        calls[0] += 1
        if calls[0] == segment + 1:
            torch.cuda._sleep(cycles)
        return run(raw, warm=warm)
    proc.run_device_ring = wedged


def resilience_front_retry_watchdog(card: str, window: dict,
                                    runs: dict) -> dict:
    """(d) One injected kernel build fault at the fetch of segment 0 on
    ffuse_2^30 takes the ``front_fuse`` rung (B11 and B12 before it, K1,
    B9, B10 and K2 after it); on fused_2^27's 8 segments, the transient
    faults of ``RESILIENCE_RETRIES`` under the default retries (the
    candidate bytes the clean run's, ``retries_total`` 4); then the
    watchdog: a segment's chain wedged behind a spin on the compute
    stream is requeued once, and an injected fetch stall requeues
    nothing; the bytes again the clean run's."""
    import shutil
    counts = {}
    _l, log2_n, extra, plan, _per, env = _main_path("ffuse_2^30")
    out_dir = OUT_DIR / "resilience_ffuse"
    cfg, _text = path_cfg(out_dir, extra + "fault_plan = "
                          "fetch:compile_fail@0\n", log2_n,
                          "resilience_ffuse")
    stats, pipe, rec = _run_pipeline(cfg, runs["ffuse_2^30"]["data"], env,
                                     _recording)
    from srtb_tpu_torch import kernels as K
    rec["launches"].append(K.launch_counts())
    say(f"resilience ffuse_2^30 (fetch:compile_fail@0): rungs and "
        "launches "
        + json.dumps([{"plan": p, "launches": {k: v for k, v in c.items()
                                               if v}}
                      for p, c in zip(rec["plans"], rec["launches"])])
        + f"; counters {json.dumps(_counters(pipe))}; positive "
        f"{pipe.positive_segments}; card {card}")
    first, second = rec["launches"]
    if rec["plans"] != [plan, plan.replace("+ffuse", "")] or \
            not (first["fft2_pass1_front"] and first["fft2_pass2_spectrum"]
                 and second["fft2_pass1"] and second["fft2_pass2"]
                 and not second["fft2_pass1_front"]) or \
            pipe.positive_segments != [1]:
        fail(f"resilience ffuse: rungs {rec['plans']}, launches "
             f"{rec['launches']}, positive {pipe.positive_segments}")
    counts["resilience_ffuse_2^30"] = {
        k: first[k] + second[k] for k in first}
    shutil.rmtree(out_dir)
    free_card()
    w = window["fused_2^27"]
    _l, log2_n, extra, _plan, _per, env = _main_path("fused_2^27")
    for tag, lines, setup in (
            ("retries", f"fault_plan = {RESILIENCE_RETRIES}\n", None),
            ("watchdog", f"segment_deadline_s = {WATCHDOG_DEADLINE_S}\n"
             "segment_watchdog_requeues = 2\n"
             f"fault_plan = {WATCHDOG_STALL}\n",
             lambda pipe: _wedging(pipe, WEDGE_SEGMENT))):
        out_dir = OUT_DIR / f"resilience_{tag}"
        cfg, _text = path_cfg(out_dir, extra + lines, log2_n,
                              f"resilience_{tag}")
        t0 = time.perf_counter()
        stats, pipe, _ = _run_pipeline(cfg, w["data"], env, setup)
        c = _counters(pipe)
        counts[f"resilience_{tag}"] = K.launch_counts()
        say(f"resilience {tag} fused_2^27: {time.perf_counter() - t0:.2f} "
            f"s, counters {json.dumps(c)}, positive "
            f"{pipe.positive_segments}; card {card}")
        want = ({"retries_total": 4, "data_loss_total": 1,
                 "watchdog_requeues": 0} if tag == "retries" else
                {"retries_total": 0, "watchdog_requeues": 1})
        if any(c[k] != v for k, v in want.items()) or \
                c["plan_demotions"] or pipe.positive_segments != [5]:
            fail(f"resilience {tag}: counters {c}, expected {want}; "
                 f"positive {pipe.positive_segments}")
        _same_candidates(f"resilience {tag}", _candidate_files(pipe),
                         w["first"])
        say(f"resilience {tag}: candidate files equal in bytes to the "
            "window phase's first run")
        shutil.rmtree(out_dir)
        free_card()
    return counts


# every resilience layer off (the defaults arm them all)
RESILIENCE_OFF = ("plan_ladder = off\ndevice_reinit_max = 0\n"
                  "degrade_enable = 0\nsupervisor_max_restarts = 0\n"
                  "retry_max_attempts = 1\n")


# armed against off: this many pairs, in turns off, armed, armed, off
# (the ratio is noise at any count, PERF.md §6: kept small so that every
# phase fits the script's time)
ARMED_PAIRS = 2


def resilience_armed_vs_off(card: str, window: dict) -> dict:
    """fused_2^27 over the window phase's 8 segments with every
    resilience layer off and armed (the defaults), ``ARMED_PAIRS`` pairs
    in turns off, armed, armed, off: Msamples/s of each, each pair's
    relative difference, the engine's host seconds a segment by stage on
    each side, the candidate files of each equal in bytes to the window
    phase's first run's."""
    import shutil
    import numpy as np
    w = window["fused_2^27"]
    _l, log2_n, extra, _plan, _per, env = _main_path("fused_2^27")
    rates = {"off": [], "armed": []}
    stages = {"off": {}, "armed": {}}
    # a first run that is not counted: on an H100 the first run after
    # the real OOM's phase ran at a fifth of the others' rate
    tags = ("warm-up",) + ("off", "armed", "armed", "off") * (
        ARMED_PAIRS // 2)
    for turn, tag in enumerate(tags):
        out_dir = OUT_DIR / f"resilience_{tag}_{turn}"
        cfg, text = path_cfg(out_dir, extra + (RESILIENCE_OFF if tag == "off"
                                               else ""), log2_n,
                             f"resilience_{tag}")
        stats, pipe, _wall = run_cli(out_dir, text, w["data"], env)
        if tag in rates:
            rates[tag].append(stats.msamples_per_sec)
            for k, v in stats.extras["stage_s"].items():
                stages[tag].setdefault(k, []).append(v / stats.segments)
        _same_candidates(f"resilience {tag} (turn {turn})",
                         _candidate_files(pipe), w["first"])
        shutil.rmtree(out_dir)
        del pipe
        free_card()
    off, armed = np.array(rates["off"]), np.array(rates["armed"])
    diff = (armed - off) / off
    summary = {"pairs": len(diff), "median_off": float(np.median(off)),
               "median_armed": float(np.median(armed)),
               "pair_diff_median": float(np.median(diff)),
               "pair_diff_min": float(diff.min()),
               "pair_diff_max": float(diff.max()),
               "armed_slower_pairs": int((diff < 0).sum()),
               "stage_ms_a_segment": {
                   tag: {k: float(np.median(v)) * 1e3
                         for k, v in by.items()}
                   for tag, by in stages.items()}}
    say(f"resilience fused_2^27, 8 segments, every layer off and armed in "
        f"turns: Msamples/s {json.dumps(rates)}; {json.dumps(summary)}; "
        f"candidate bytes equal; card {card}")
    return {**rates, **summary}


# ---------------------------------------------------------- observability

# every observability setting of the port, armed ("{d}": the run's output
# directory): the span journal, the flight recorder's dump, a profile
# capture of the first segment, the H100's HBM peak for the roofline
# gauges (PERF.md's bounds' 3.35 TB/s) and three SLO objectives
OBS_ARMED = ("telemetry_journal_path = {d}/spans.jsonl\n"
             "events_dump_path = {d}/events.jsonl\n"
             "profile_capture_segments = 1\n"
             "profile_capture_dir = {d}/profile\n"
             "hbm_peak_gbps = 3350\n"
             "slo_latency_ms = 1000\nslo_loss_budget = 0.01\n"
             "slo_staleness_s = 60\n")
# and off: no journal, dump, capture or objective, the recorder disarmed
OBS_OFF = "events_enable = 0\n"
# (kept small, as ARMED_PAIRS)
OBS_PAIRS = 2


@contextlib.contextmanager
def timed_capture(seconds: dict):
    """``ProfileCapture.start`` and ``stop`` timed into ``seconds``
    (lists by name) inside the block."""
    from srtb_tpu_torch.utils import tracing
    saved = tracing.ProfileCapture.start, tracing.ProfileCapture.stop

    def timed(name, fn):
        def inner(self, *args):
            was_active = self.active
            t0 = time.perf_counter()
            out = fn(self, *args)
            if name == "start" or (was_active and not self.active):
                seconds.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return inner
    tracing.ProfileCapture.start = timed("start", saved[0])
    tracing.ProfileCapture.stop = timed("stop", saved[1])
    try:
        yield
    finally:
        tracing.ProfileCapture.start, tracing.ProfileCapture.stop = saved


def _scrape(directory: Path, path: str) -> tuple:
    """One GET of the viewer on a free localhost port: status, body."""
    import urllib.error
    import urllib.request
    from srtb_tpu_torch.gui.server import WaterfallHTTPServer
    server = WaterfallHTTPServer(str(directory)).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    finally:
        server.stop()


def obs_staged(card: str, made: dict) -> dict:
    """staged_2^30 on its main path's two segments (the pulse in segment
    1) with every observability setting armed: each span's stages,
    device ms and roofline fields, the flight recorder's events by type,
    ``/metrics`` and ``/healthz`` scraped in-process, the profile's
    trace; then the dispatch check with the recorder armed and a profile
    capture running."""
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.utils.tracing import ProfileCapture
    label, log2_n, extra, plan, per_segment, env = _main_path("staged_2^30")
    out_dir = OUT_DIR / "obs_staged_2^30"
    cfg, text = path_cfg(out_dir, extra + OBS_ARMED.format(d=out_dir),
                         log2_n, "obs_staged_2^30")
    data = input_file(cfg, label, made)
    K.reset_launch_counts()
    capture_s: dict = {}
    with timed_capture(capture_s):
        stats, pipe, wall = run_cli(out_dir, text, data, env)
    counts = K.launch_counts()
    if stats.segments != 2 or pipe.positive_segments != [1]:
        fail(f"observability staged_2^30: {stats.segments} segments, "
             f"positive {pipe.positive_segments}")
    _check_launches("observability staged_2^30", counts, per_segment,
                    stats.segments)
    spans = [json.loads(line) for line in
             (out_dir / "spans.jsonl").read_text().splitlines()]
    if [s["segment"] for s in spans] != [0, 1] or \
            [s["dump"] for s in spans] != [False, True]:
        fail(f"observability staged_2^30: spans {spans}")
    for s in spans:
        for key in ("device_ms", "achieved_msamps", "roofline_frac"):
            if not s.get(key, 0) > 0:
                fail(f"observability staged_2^30: span {s['segment']} "
                     f"has no {key}")
        say(f"observability staged_2^30: span {s['segment']}: stages_ms "
            f"{json.dumps(s['stages_ms'])}, device_ms {s['device_ms']}, "
            f"achieved_msamps {s['achieved_msamps']}, roofline_frac "
            f"{s['roofline_frac']} (hbm_passes "
            f"{pipe.processor.hbm_passes}, peak {cfg.hbm_peak_gbps} GB/s), "
            f"plan {s['active_plan']}, trace {s['trace_id']}; card {card}")
    evs = [json.loads(line) for line in
           (out_dir / "events.jsonl").read_text().splitlines()]
    by_type: dict = {}
    for e in evs:
        by_type[e["type"]] = by_type.get(e["type"], 0) + 1
    for t in ("stage.ingest", "stage.dispatch", "stage.fetch", "stage.sink"):
        if by_type.get(t) != 2:
            fail(f"observability staged_2^30: {by_type.get(t)} {t} events")
    say(f"observability staged_2^30: {len(evs)} events by type "
        f"{json.dumps(by_type, sort_keys=True)}")
    status, prom = _scrape(out_dir, "/metrics")
    jstatus, snap = _scrape(out_dir, "/metrics.json")
    hstatus, health = _scrape(out_dir, "/healthz")
    snap = json.loads(snap)
    if status != 200 or jstatus != 200 or hstatus != 200 or \
            snap.get("segments") != 2 or snap.get("signals") != 1:
        fail(f"observability staged_2^30: /metrics {status}, /metrics.json "
             f"{jstatus} ({snap.get('segments')} segments), /healthz "
             f"{hstatus}")
    say(f"observability staged_2^30: /metrics {status}, "
        f"{len(prom.splitlines())} lines; /metrics.json segments "
        f"{snap['segments']}, signals {snap['signals']}, plan_compiles "
        f"{snap['plan_compiles']}, compile_seconds "
        f"{snap['compile_seconds']:.3f}, roofline_frac "
        f"{snap['roofline_frac']:.4f}; /healthz {hstatus} "
        f"{json.loads(health)['status']}")
    from srtb_tpu_torch.tools import trace_summary as TS
    trace = out_dir / "profile" / "trace.json"
    tevs = json.loads(trace.read_text())["traceEvents"]
    device = sum(1 for e in tevs if e.get("cat") in TS.DEVICE_CATEGORIES)
    stages = sorted({e["name"] for e in tevs
                     if e.get("cat") == "user_annotation"
                     and str(e.get("name", "")).startswith("srtb:")})
    side = json.loads((out_dir / "profile" / "capture.json").read_text())
    if not device or "srtb:dispatch" not in stages or side["segments"] != 1:
        fail(f"observability staged_2^30: trace {device} device events, "
             f"stages {stages}, sidecar {side}")
    say(f"observability staged_2^30: trace {trace.relative_to(ROOT)} "
        f"({trace.stat().st_size} bytes, {len(tevs)} events, {device} on "
        f"the device, stages {stages}); capture start "
        f"{capture_s['start'][0]:.3f} s, stop and export "
        f"{capture_s['stop'][0]:.3f} s; trace_ids "
        f"{side['first_trace_id']}..{side['last_trace_id']}; card {card}")
    sync_capture = ProfileCapture(str(out_dir / "profile_sync"), 1)
    sync_capture.start()
    try:
        check_dispatch_syncs(pipe, "observability staged_2^30 (recorder "
                                   "armed, profiler running)")
    finally:
        sync_capture.stop()
    for files in pipe.sink.written:
        for p in files.npy_paths:
            os.unlink(p)
    return {"spans": spans, "events": by_type, "capture_s": capture_s}


def obs_armed_vs_off(card: str, window: dict) -> dict:
    """fused_2^27 over the window phase's 8 segments with every
    observability setting off and armed, ``OBS_PAIRS`` pairs in turns
    off, armed, armed, off after a warm-up: Msamples/s of each, each
    pair's relative difference, the host ms a segment by stage, the
    profile capture's start and stop seconds, the candidate files of each
    equal in bytes to the window phase's first run's."""
    import shutil
    import numpy as np
    w = window["fused_2^27"]
    _l, log2_n, extra, _plan, _per, env = _main_path("fused_2^27")
    rates = {"off": [], "armed": []}
    stages = {"off": {}, "armed": {}}
    capture_s: dict = {}
    tags = ("warm-up",) + ("off", "armed", "armed", "off") * (OBS_PAIRS // 2)
    for turn, tag in enumerate(tags):
        out_dir = OUT_DIR / f"obs_{tag}_{turn}"
        settings = OBS_OFF if tag == "off" else OBS_ARMED.format(d=out_dir)
        cfg, text = path_cfg(out_dir, extra + settings, log2_n,
                             f"obs_{tag}")
        with timed_capture(capture_s if tag == "armed" else {}):
            stats, pipe, _wall = run_cli(out_dir, text, w["data"], env)
        if tag in rates:
            rates[tag].append(stats.msamples_per_sec)
            for k, v in stats.extras["stage_s"].items():
                stages[tag].setdefault(k, []).append(v / stats.segments)
        _same_candidates(f"observability {tag} (turn {turn})",
                         _candidate_files(pipe), w["first"])
        shutil.rmtree(out_dir)
        del pipe
        free_card()
    off, armed = np.array(rates["off"]), np.array(rates["armed"])
    diff = (armed - off) / off
    summary = {"pairs": len(diff), "median_off": float(np.median(off)),
               "median_armed": float(np.median(armed)),
               "pair_diff_median": float(np.median(diff)),
               "pair_diff_min": float(diff.min()),
               "pair_diff_max": float(diff.max()),
               "armed_slower_pairs": int((diff < 0).sum()),
               "capture_start_s": capture_s.get("start", []),
               "capture_stop_s": capture_s.get("stop", []),
               "stage_ms_a_segment": {
                   tag: {k: float(np.median(v)) * 1e3
                         for k, v in by.items()}
                   for tag, by in stages.items()}}
    say(f"observability fused_2^27, 8 segments, every setting off and "
        f"armed in turns: Msamples/s {json.dumps(rates)}; "
        f"{json.dumps(summary)}; candidate bytes equal; card {card}")
    return {**rates, **summary}


def phase_observability(card: str, window: dict, made: dict) -> dict:
    """The observability layer on the card (ROADMAP A9a): staged_2^30
    with every setting armed (:func:`obs_staged`), then fused_2^27 armed
    against off (:func:`obs_armed_vs_off`)."""
    t0 = time.perf_counter()
    staged = obs_staged(card, made)
    t1 = time.perf_counter()
    rates = obs_armed_vs_off(card, window)
    t2 = time.perf_counter()
    say(f"observability: seconds staged_2^30 {t1 - t0:.1f}, armed against "
        f"off {t2 - t1:.1f}; card {card}")
    return {"staged": staged, "rates": rates}


# ---- health (ROADMAP A9b): the pulse-injection canary and incident bundles

# canary_2^30: staged_2^30's cfg lines at 8 bits (the 8-bit unpack is
# torch's: no K1)
CANARY_EXTRA = PALLAS_ON + "baseband_input_bits = 8\n"
CANARY_PLAN = "staged:four_step+ring"
CANARY_LAUNCHES = {"rfi_s1_dedisperse": 1, "sk_stats": 1,
                   "sk_apply_timeseries": 1}
CANARY_SEGMENTS = 4
# the burst's per-sample amplitude in counts: at the cfg's DM the default
# 25 disperses over ~2e7 samples below half a count everywhere, and its
# delta is all zero (ROADMAP C5); 400 keeps a delta of about half a
# count rms
CANARY_AMP = 400.0
CANARY_ARMED = ("canary_every_segments = {every}\ncanary_amp = {amp}\n"
                "quality_stats = 1\nbaseband_write_all = {write_all}\n"
                "telemetry_journal_path = {d}/spans.jsonl\n"
                "events_dump_path = {d}/events.jsonl\n"
                "run_manifest_path = {d}/manifest.jsonl\n"
                "incident_dir = {d}/incidents\n"
                "incident_min_interval_s = 0\n")
# leg (c): 61 of the band's 64 MHz (1373 - 1437) zapped
CANARY_ZAP = "mitigate_rfi_freq_list = 1375-1436\n"
# the delta check: the card's build against the host's at 2^27; a count
# may differ only where the float64 value is this close to a half count
DELTA_LOG2_N = 27
HALF_COUNT_TIE = 1e-6


def make_noise_file(cfg, path: Path, segments: int, seed: int = 1644
                    ) -> int:
    """``segments`` segments of 8-bit ``simple`` bytes, normal(128, 8)
    clipped to [0, 255] and truncated (numpy's ``astype``), made on the
    card from a seeded generator: one continuous stream, one byte short of
    ``segments`` overlapping segments (the reader emits exactly that
    many).  Returns the stride in bytes."""
    import torch
    from srtb_tpu_torch.ops import dedisperse as dd
    n = cfg.baseband_input_count
    stride = n - dd.nsamps_reserved(cfg)
    size = n + (segments - 1) * stride - 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
    chunk = 1 << 28
    with open(path, "wb") as f:
        for a in range(0, size, chunk):
            x = torch.randn(min(chunk, size - a), generator=gen,
                            device="cuda")
            f.write(x.mul_(8.0).add_(128.0).clamp_(0, 255).to(
                torch.uint8).cpu().numpy().tobytes())
            del x
    return stride


def file_sha256(path: Path) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


@contextlib.contextmanager
def recorded_detections(out: dict):
    """Each drained segment's detection results, by drain index: the
    SHA-256 of the host copies of its fields (inside the block)."""
    import hashlib
    from srtb_tpu_torch.io.writers import to_host
    from srtb_tpu_torch.pipeline import runtime as R
    body = R.Pipeline._drain_body

    def recording(self, item, drained):
        h = hashlib.sha256()
        for name in ("signal_counts", "zero_count", "snr_peaks",
                     "time_series"):
            h.update(to_host(getattr(item.det, name)).tobytes())
        out[drained[0]] = h.hexdigest()
        return body(self, item, drained)
    R.Pipeline._drain_body = recording
    try:
        yield
    finally:
        R.Pipeline._drain_body = body


@contextlib.contextmanager
def timed_dumps(seconds: list):
    """Each incident bundle's dump, timed into ``seconds`` (inside the
    block)."""
    from srtb_tpu_torch.utils.incidents import IncidentRecorder
    dump = IncidentRecorder.dump

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = dump(self, *args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        return out
    IncidentRecorder.dump = timed
    try:
        yield
    finally:
        IncidentRecorder.dump = dump


def _printed(main, argv: list) -> tuple[int, str]:
    """A tool's ``main(argv)``: its exit code and what it printed."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def health_delta_check(card: str, root: Path) -> dict:
    """The canary's delta at 2^27 (the cfg's band and DM, its reserve,
    ``CANARY_AMP``) built on the card against the same build in float64 on
    the host: a position may differ by one count only, and only where the
    host's float64 value lies within ``HALF_COUNT_TIE`` of a half count
    (cuFFT's and the host FFT's rounding on opposite sides of it); prints
    the count of such ties and both builds' seconds."""
    import torch
    from srtb_tpu_torch.ops import dedisperse as dd
    from srtb_tpu_torch.quality.canary import CanaryController
    cfg, _text = path_cfg(
        root / "delta", CANARY_EXTRA + "canary_every_segments = 2\n"
        f"canary_amp = {CANARY_AMP}\n"
        f"baseband_input_count = 2 ** {DELTA_LOG2_N}\n", DELTA_LOG2_N,
        "canary delta")
    n, reserved = cfg.baseband_input_count, dd.nsamps_reserved(cfg)
    card_c = CanaryController(cfg, n, reserved, device="cuda")
    host_c = CanaryController(cfg, n, reserved, device="cpu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = card_c.ensure_delta()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = host_c.ensure_delta()
    t2 = time.perf_counter()
    got = got.cpu()
    diff = (got != want).nonzero().flatten()
    ties = 0
    if diff.numel():
        sig = host_c.dispersed_pulse()[diff]
        off_half = (sig.abs() - sig.abs().floor() - 0.5).abs()
        steps = (got[diff].to(torch.int32) - want[diff].to(torch.int32)).abs()
        if int(steps.max()) != 1 or float(off_half.max()) > HALF_COUNT_TIE:
            fail(f"health delta 2^{DELTA_LOG2_N}: {diff.numel()} positions "
                 f"differ, by up to {int(steps.max())} counts, up to "
                 f"{float(off_half.max()):.3e} from a half count")
        ties = diff.numel()
    nonzero = int((want != 0).sum())
    if not nonzero or got[:reserved].any() or got[n - reserved:].any():
        fail(f"health delta 2^{DELTA_LOG2_N}: {nonzero} nonzero counts, "
             "or counts inside the reserved spans")
    out = {"n": n, "reserved": reserved, "nonzero": nonzero,
           "max_count": int(want.abs().max()), "half_count_ties": ties,
           "card_s": t1 - t0, "host_s": t2 - t1, "t0": card_c.t0}
    say(f"health delta 2^{DELTA_LOG2_N} (amp {CANARY_AMP}, dm {cfg.dm}): "
        f"card build against the host's float64 build: {ties} positions "
        f"differ by one count at a half-count tie (within "
        f"{HALF_COUNT_TIE:g}), the rest equal; {json.dumps(out)}; card "
        f"{card}")
    return out


def health_delta_2_30(card: str, cfg) -> dict:
    """The 2^30 delta alone on the card: its build's seconds, the
    device's peak above what was allocated before it, and the device ms of
    one injection into a segment's bytes (``inject_``, CUDA events)."""
    import torch
    from srtb_tpu_torch.ops import dedisperse as dd
    from srtb_tpu_torch.quality.canary import CanaryController
    free_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    c = CanaryController(cfg, cfg.baseband_input_count,
                         dd.nsamps_reserved(cfg), device="cuda")
    t0 = time.perf_counter()
    d = c.ensure_delta()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out = {"build_s": build_s,
           "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "kept_gb": d.numel() * d.element_size() / 1e9,
           "nonzero": int((d != 0).sum()),
           "rms_counts": float(d.float().pow(2).mean().sqrt()),
           "max_count": int(d.abs().max()), "t0": c.t0}
    raw = torch.randint(0, 256, (cfg.baseband_input_count,),
                        dtype=torch.uint8, device="cuda")
    out["inject_ms"] = cuda_ms(lambda: c.inject_(raw), 10)
    del c, d, raw
    free_card()
    say(f"health delta 2^30 on the card: {json.dumps(out)}; card {card}")
    return out


def _health_leg(card: str, root: Path, tag: str, extra: str, data: Path,
                env: dict, dets: dict) -> tuple:
    """One canary_2^30 run (``srtb-torch-main``) of the cfg lines
    ``extra`` under ``root/tag``: its statistics, pipeline, launch counts
    and the seconds of its bundle dumps."""
    import torch
    from srtb_tpu_torch import kernels as K
    out_dir = root / tag
    cfg, text = path_cfg(out_dir, extra.format(d=out_dir), LOG2_N,
                         f"canary_2^30 ({tag})")
    dump_s: list = []
    K.reset_launch_counts()
    with recorded_detections(dets), timed_dumps(dump_s):
        stats, pipe, wall = run_cli(out_dir, text, data, env)
    counts = K.launch_counts()
    if pipe.processor.plan_name != CANARY_PLAN:
        fail(f"health canary_2^30 ({tag}): plan "
             f"{pipe.processor.plan_name}, want {CANARY_PLAN}")
    _check_launches(f"health canary_2^30 ({tag})", counts, CANARY_LAUNCHES,
                    stats.segments)
    say(f"health canary_2^30 ({tag}): {stats.segments} segments, "
        f"{stats.signals} signals, {stats.msamples_per_sec:.1f} Msamples/s,"
        f" wall {wall:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}")
    return cfg, stats, pipe, counts, dump_s


def phase_health(card: str) -> dict:
    """The health layer on the card (ROADMAP A9b), the path canary_2^30:
    staged_2^30's cfg lines at 8 bits, on a file of 4 noise segments made
    on the card.  The delta at 2^27 against the host's build and at 2^30
    alone (:func:`health_delta_check`, :func:`health_delta_2_30`); then
    (a) the canary every second segment with the quality epilogue, the
    write-all sink, the journal, the events dump, the run manifest and
    the incident directory: segments 1 and 3 injected, checked and
    passed, the first calibrating, nothing positive, the spans and the
    manifest flag both, ``/healthz`` reports detection ``ok``, the
    launches the table's; (b) the same with the canary off, run before
    (a): the write-all file equal to (a)'s by SHA-256, segments 0 and 2's
    detection results bit-identical to (a)'s; (c) two segments with 61 of 64 MHz zapped and
    the expectation pinned to (a)'s S/N: the check fails, detection
    degraded, one ``canary_sensitivity`` bundle whose ``extra.json`` holds
    the failed verdict and the quality timeline, ``trace_export
    --validate`` on it, and ``telemetry_report`` and ``quality_report`` in
    both formats on (a)'s journal.  Returns the launch counts."""
    import shutil
    from srtb_tpu_torch.tools import quality_report as QR
    from srtb_tpu_torch.tools import telemetry_report as TR
    from srtb_tpu_torch.tools import trace_export as TE
    from srtb_tpu_torch.utils.metrics import metrics
    t_start = time.perf_counter()
    root = OUT_DIR / "health"
    if root.exists():
        shutil.rmtree(root)
    _l, _log2_n, _extra, _plan, _per, env = _main_path("staged_2^30")
    delta27 = health_delta_check(card, root)
    armed = CANARY_EXTRA + CANARY_ARMED.format(every=2, amp=CANARY_AMP,
                                               write_all=1, d="{d}")
    cfg_a, _text = path_cfg(root / "a", armed.format(d=root / "a"),
                            LOG2_N, "canary_2^30")
    delta30 = health_delta_2_30(card, cfg_a)
    data = root / "input.bin"
    t0 = time.perf_counter()
    stride = make_noise_file(cfg_a, data, CANARY_SEGMENTS)
    say(f"health canary_2^30: input {data.relative_to(ROOT)} "
        f"({data.stat().st_size} bytes, 4 segments of 8-bit noise, stride "
        f"{stride}) made in {time.perf_counter() - t0:.1f} s")
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # (b) the canary off, first: the first run on this file takes any
    # first-run cost, so that it does not land on the canary's side
    dets_b: dict = {}
    off = CANARY_EXTRA + CANARY_ARMED.format(every=0, amp=CANARY_AMP,
                                             write_all=1, d="{d}")
    _cfg, stats_b, pipe_b, counts, _d = _health_leg(
        card, root, "b", off, data, env, dets_b)
    add(counts)
    wa = root / "b" / "out_stream0.bin"
    sha_b = file_sha256(wa)
    wa.unlink()
    if metrics.get("canary_injected"):
        fail(f"health canary_2^30 (b): {metrics.get('canary_injected')} "
             "canaries injected with the canary off")
    del pipe_b
    free_card()
    # (a) the canary armed
    dets_a: dict = {}
    _cfg, stats_a, pipe_a, counts, _d = _health_leg(
        card, root, "a", armed, data, env, dets_a)
    add(counts)
    m = {k: metrics.get(k) for k in (
        "canary_injected", "canary_checked", "canary_failed",
        "canary_last_snr", "canary_expected_snr",
        "canary_sensitivity_ratio", "detection_health_state",
        "incident_bundles")}
    spans = [json.loads(line) for line in
             (root / "a" / "spans.jsonl").read_text().splitlines()]
    canary = [s.get("canary") for s in spans]
    recs = [json.loads(line) for line in
            (root / "a" / "manifest.jsonl").read_text().splitlines()]
    marked = [r["abs"] for r in recs if r.get("t") == "canary"]
    hstatus, health = _scrape(root / "a", "/healthz")
    detection = json.loads(health).get("detection") or {}
    if stats_a.segments != CANARY_SEGMENTS or stats_a.signals != 0 or \
            m["canary_injected"] != 2 or m["canary_checked"] != 2 or \
            m["canary_failed"] != 0 or m["incident_bundles"] != 0:
        fail(f"health canary_2^30 (a): {stats_a.segments} segments, "
             f"{stats_a.signals} signals, {json.dumps(m)}")
    if [c is not None for c in canary] != [False, True, False, True] or \
            not canary[1].get("calibrated") or not canary[3].get("ok") or \
            marked != [1, 3]:
        fail(f"health canary_2^30 (a): span canaries {canary}, manifest "
             f"canary records at {marked}")
    if hstatus != 200 or detection.get("state") != "ok":
        fail(f"health canary_2^30 (a): /healthz {hstatus} {health}")
    snr = canary[1]["snr"]
    say(f"health canary_2^30 (a): recovered S/N {canary[1]['snr']} "
        f"(segment 1, calibrating) and {canary[3]['snr']} (segment 3, "
        f"ratio {canary[3]['ratio']}); spans' detections "
        f"{[s['detections'] for s in spans]}; manifest canary records at "
        f"{marked}; /healthz {hstatus} detection {json.dumps(detection)}; "
        f"card {card}")
    wa = root / "a" / "out_stream0.bin"
    sha_a = file_sha256(wa)
    wa.unlink()
    reports = {}
    for tool, main in (("telemetry_report", TR.main),
                       ("quality_report", QR.main)):
        for fmt in ("md", "json"):
            rc, text = _printed(main, [str(root / "a" / "spans.jsonl"),
                                       "--format", fmt])
            if rc or not text.strip():
                fail(f"health: {tool} --format {fmt} exited {rc}")
            reports[f"{tool} {fmt}"] = len(text)
            if tool == "quality_report" and fmt == "md" and \
                    "## Canary" not in text:
                fail(f"health: quality_report's Markdown has no Canary "
                     f"section: {text[:400]}")
            if fmt == "json":
                json.loads(text)
    say(f"health: telemetry_report and quality_report on (a)'s journal, "
        f"characters printed {json.dumps(reports)}")
    del pipe_a
    free_card()
    if sha_b != sha_a or any(dets_b[i] != dets_a[i] for i in (0, 2)):
        fail(f"health canary_2^30 (b): write-all SHA-256 {sha_b} against "
             f"(a)'s {sha_a}; detections {dets_b} against {dets_a}")
    say(f"health canary_2^30 (b): the write-all file equals (a)'s by "
        f"SHA-256 ({sha_a}); segments 0 and 2's detection results "
        f"bit-identical to (a)'s; Msamples/s canary on "
        f"{stats_a.msamples_per_sec:.1f}, off "
        f"{stats_b.msamples_per_sec:.1f}; card {card}")
    # the canary's cost: one pair in the turns off, on (the second pair
    # was cut for the a8b phase's room: the difference is no claim,
    # PERF.md section 6)
    rates = {"on": [stats_a.msamples_per_sec],
             "off": [stats_b.msamples_per_sec]}
    diffs = [(on - off) / off for on, off in zip(rates["on"], rates["off"])]
    say(f"health canary_2^30: Msamples/s canary on {rates['on']}, off "
        f"{rates['off']} (turns off, on); the on run's difference "
        f"{[round(x, 4) for x in diffs]}; card {card}")
    # (c) degraded: two segments, most of the band zapped
    os.truncate(data, cfg_a.baseband_input_count + stride - 1)
    degraded = CANARY_EXTRA + CANARY_ARMED.format(
        every=2, amp=CANARY_AMP, write_all=0, d="{d}") + CANARY_ZAP + \
        f"canary_expected_snr = {snr}\n"
    _cfg, stats_c, pipe_c, counts, dump_s = _health_leg(
        card, root, "c", degraded, data, env, {})
    add(counts)
    failed = metrics.get("canary_failed")
    state = metrics.get("detection_health_state")
    hstatus, health = _scrape(root / "c", "/healthz")
    detection = json.loads(health).get("detection") or {}
    inc = root / "c" / "incidents"
    bundles = sorted(p.name for p in inc.iterdir()) if inc.exists() else []
    if stats_c.segments != 2 or failed < 1 or state != 1 or \
            detection.get("state") != "degraded" or \
            bundles != ["incident_000_canary_sensitivity"]:
        fail(f"health canary_2^30 (c): {stats_c.segments} segments, "
             f"canary_failed {failed}, detection_health_state {state}, "
             f"/healthz {health}, bundles {bundles}")
    bundle = inc / bundles[0]
    extra = json.loads((bundle / "extra.json").read_text())
    if extra["canary"].get("ok") is not False or \
            not extra.get("quality_timeline"):
        fail(f"health canary_2^30 (c): extra.json {json.dumps(extra)[:600]}")
    rc, text = _printed(TE.main, [str(bundle), "--validate"])
    if rc:
        fail(f"health: trace_export --validate on {bundle.name} exited {rc}")
    say(f"health canary_2^30 (c): verdict {json.dumps(extra['canary'])}; "
        f"quality timeline {len(extra['quality_timeline'])} segment(s); "
        f"bundle files {sorted(os.listdir(bundle))}; dumped in "
        f"{[round(s, 4) for s in dump_s]} s; /healthz detection "
        f"{json.dumps(detection)}; trace_export: {text.strip()}; card {card}")
    del pipe_c
    shutil.rmtree(root)
    free_card()
    seconds = time.perf_counter() - t_start
    out = {"delta_2^27": delta27, "delta_2^30": delta30,
           "msamples_on": rates["on"], "msamples_off": rates["off"],
           "pair_diff": diffs, "snr": snr, "dump_s": dump_s,
           "seconds": seconds}
    say(f"health: {json.dumps(out)}; the phase took {seconds:.1f} s; "
        f"card {card}")
    return {"counts": total, **out}


def phase_resilience(card: str, window: dict, runs: dict, made: dict
                     ) -> dict:
    """The resilience layers on the card (ROADMAP A7): (a) the injected
    ladder walk and the chaos soak, (b) a real out-of-memory recovered by
    demotion, (c) a real sticky fault escalated and resumed in a new
    process, (d) the front-fuse rung, the retries and the watchdog, then
    every layer armed against every layer off.  Returns the launch counts
    by run and the numbers."""
    t0 = time.perf_counter()
    walk = resilience_walk(card, window)
    t1 = time.perf_counter()
    oom = resilience_real_oom(card, made, runs[OOM_PATH]["files"])
    t2 = time.perf_counter()
    resilience_sticky(card)
    t3 = time.perf_counter()
    counts = resilience_front_retry_watchdog(card, window, runs)
    t4 = time.perf_counter()
    rates = resilience_armed_vs_off(card, window)
    t5 = time.perf_counter()
    say(f"resilience: seconds (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) "
        f"{t3 - t2:.1f}, (d) {t4 - t3:.1f}, armed against off "
        f"{t5 - t4:.1f}; card {card}")
    for name, part in (("walk", walk), ("oom", oom)):
        total = {}
        for c in part["counts"]:
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        counts[f"resilience_{name}"] = total
    return {"counts": counts, "oom_recovery_s": oom["recovery_s"],
            "armed_vs_off": rates}


STAGED_FRONT = ("unpack K1", "rfft", "mean power", "rfi + chirp K2")


def phase_breakdown(run) -> dict:
    """Device time of one production segment stage by stage: each stage
    alone on the input the chain gives it (CUDA events, mean of a few
    runs), beside the whole chain on the same device-resident segment."""
    import torch
    from srtb_tpu_torch.kernels import rfi_chirp as KR
    from srtb_tpu_torch.kernels import unpack as KU
    from srtb_tpu_torch.ops import fft as F
    sp, raw, h2d = _segment_on_card(run)
    cfg = sp.cfg
    ms = dict(h2d)
    bits = cfg.baseband_input_bits
    ms["unpack K1"] = cuda_ms(
        lambda: KU.unpack_subbyte_window(raw, bits, sp.window), 5)
    x = KU.unpack_subbyte_window(raw, bits, sp.window)
    ms["rfft"] = cuda_ms(lambda: F.rfft_drop_nyquist(x), 3)
    spec = F.rfft_drop_nyquist(x)
    del x
    thr = cfg.mitigate_rfi_average_method_threshold
    ms["mean power"] = cuda_ms(lambda: KR.rfi_threshold(spec, thr), 5)
    k2 = (KR.rfi_threshold(spec, thr), sp.norm_coeff, sp.f_min, sp.df,
          sp.f_c, cfg.dm)
    ms["rfi + chirp K2"] = cuda_ms(
        lambda: KR.rfi_s1_dedisperse(spec, *k2, keep=sp.rfi_keep), 5)
    spec = KR.rfi_s1_dedisperse(spec, *k2, keep=sp.rfi_keep)
    _staged_tail_stages(ms, sp, spec)
    del spec
    whole = cuda_ms(lambda: sp.process(raw), 3)
    torch.cuda.empty_cache()
    return _breakdown_line("staged_2^30", ms, whole, cfg)


def _staged_tail_stages(ms: dict, sp, spec) -> None:
    """Time the staged plan's waterfall stages on the dedispersed spectrum
    [S, m] (or [m], one stream; rows of 2^18, outside the row kernels'
    window): the rows of every stream in one cuFFT call, then K3, the
    verdict and K4 once a stream, and detect over the streams, each stage
    alone on the input the chain gives it."""
    import torch
    from srtb_tpu_torch.kernels import sk as KS
    from srtb_tpu_torch.ops import detect as det
    from srtb_tpu_torch.ops import fft as F
    from srtb_tpu_torch.ops import rfi
    cfg = sp.cfg
    spec = spec if spec.dim() == 2 else spec[None]
    streams = range(spec.shape[0])
    ms["waterfall ifft"] = cuda_ms(
        lambda: F.waterfall_c2c(spec, sp.channel_count, sp.watfft_dewindow),
        3)
    wf = F.waterfall_c2c(spec, sp.channel_count, sp.watfft_dewindow)
    del spec
    ms["sk stats K3"] = cuda_ms(lambda: [KS.sk_stats(wf[s])
                                         for s in streams], 5)
    moments = [KS.sk_stats(wf[s])[:2] for s in streams]
    sk_thr = cfg.mitigate_rfi_spectral_kurtosis_threshold
    t_len = wf.shape[-1]

    def verdicts():
        return [rfi.sk_zap_decision(s2, s4, t_len, sk_thr)
                for s2, s4 in moments]
    ms["sk verdict"] = cuda_ms(verdicts, 5)
    zaps = verdicts()
    ms["sk apply + time series K4"] = cuda_ms(
        lambda: [KS.sk_apply_timeseries(wf[s], zaps[s]) for s in streams],
        5)
    ts = torch.stack([KS.sk_apply_timeseries(wf[s], zaps[s])[1]
                      for s in streams])
    del wf
    t = det.trimmed_length(t_len, sp.time_reserved_count)
    zc = torch.zeros(len(streams), dtype=torch.int32, device="cuda")
    ms["detect"] = cuda_ms(lambda: det.detect_from_time_series(
        ts[:, :t], zc, cfg.signal_detect_signal_noise_threshold,
        cfg.signal_detect_max_boxcar_length), 5)


def phase_breakdown_staged_rows(run) -> dict:
    """The staged_pallas2_2^30 chain on one device-resident segment, and
    the staged R2C front (K1, the packed C2C by the staged row
    implementation, the Hermitian post and the fused tail's epilogue)
    under SRTB_STAGED_ROWS_IMPL = xla, pallas and pallas2 on the same
    segment, each on a processor built under that switch.  The three R2C
    spectra (before the epilogue, whose stage-1 zap may flip a bin at the
    threshold) agree within 2e-5 of the largest value."""
    import torch
    from srtb_tpu_torch.pipeline.segment import SegmentProcessor
    sp, raw, h2d = _segment_on_card(run)
    fronts = {}
    ref = None
    worst = 0.0
    for impl in ("xla", "pallas", "pallas2"):
        with path_env({"SRTB_STAGED_ROWS_IMPL": impl}):
            p = SegmentProcessor(sp.cfg, device="cuda")
        fronts[impl] = cuda_ms(lambda: p._spectrum(raw), 3)
        spec = p._staged_spectrum(raw, None)
        if ref is None:
            ref = spec
        else:
            err, scale = _fft_err(spec, ref)
            if not err <= 2e-5 * scale:
                fail(f"staged R2C, rows {impl}: {err} > 2e-5 x {scale} "
                     "against rows xla")
            worst = max(worst, err / scale)
        del spec, p
        free_card()
    del ref
    free_card()
    say(f"staged R2C front by row implementation: spectra within "
        f"{worst:.2e} of the largest (gate 2e-5)")
    whole = cuda_ms(lambda: sp.process(raw), 3)
    torch.cuda.empty_cache()
    return _breakdown_line(
        "staged_pallas2_2^30", dict(h2d), whole, sp.cfg,
        {"front_ms_by_rows_impl (K1, C2C, Hermitian post, Parseval mean + "
         "K2)": fronts, "front_spectra_max_rel_err": worst})


def phase_breakdown_ffuse(run, label: str, extra: dict) -> dict:
    """Device time of one segment of a front-fused 2^30 path stage by
    stage (the processor's own functions, each alone on the input the
    chain gives it: B11 over every stream, B12 once a stream), the whole
    chain, and the numbers ``extra`` of other paths beside them."""
    import numpy as np
    import torch
    from srtb_tpu_torch.kernels import fft2 as K2
    from srtb_tpu_torch.kernels import fft2_front as FF
    sp, raw, h2d = _segment_on_card(run)
    cfg = sp.cfg
    m = sp.n_spectrum
    n2 = sp._ffuse_fac[1]
    ms = dict(h2d)

    def pass1():
        return FF.fft2_pass1_front(raw, m, sp._ffuse_variant,
                                   cfg.baseband_input_bits, sp._ffuse_window)
    ms["B11 pass1_front"] = cuda_ms(pass1, 5)
    b, aux = pass1()
    ms["front_mean_power"] = cuda_ms(
        lambda: FF.front_mean_power(aux, n2, m), 5)
    thr = np.float32(cfg.mitigate_rfi_average_method_threshold) \
        * FF.front_mean_power(aux, n2, m)

    def pass2():
        out = torch.empty_like(b)
        for s in range(b.shape[0]):
            FF.fft2_pass2_spectrum(b[s], thr[s:s + 1], sp.norm_coeff,
                                   keep=sp._ffuse_keep,
                                   chirp=sp._ffuse_chirp, out=out[s])
        return out
    ms["B12 pass2_spectrum"] = cuda_ms(pass2, 5)
    blocked = pass2()
    del b
    ms["unblock transpose"] = cuda_ms(lambda: K2.unblock(blocked), 5)
    spec = K2.unblock(blocked)
    del blocked
    front = sum(ms[k] for k in list(ms)[2:])
    _staged_tail_stages(ms, sp, spec)
    del spec
    whole = cuda_ms(lambda: sp.process(raw), 3)
    torch.cuda.empty_cache()
    return _breakdown_line(
        label, ms, whole, cfg,
        {"streams": sp.streams,
         "front_ms (B11 + mean + B12 + unblock)": front, **extra})


def phase_breakdown_dualpol(run, breakdowns: dict) -> dict:
    """Device time of one dualpol_2^30 segment stage by stage: the byte
    de-interleave as a stage of its own, K1 once a stream, the two
    streams' R2C in one cuFFT call, their mean powers, K2 once a stream,
    then the waterfall stages; the whole chain, and staged_2^30's (the
    same plan on one stream) beside it."""
    import torch
    from srtb_tpu_torch.kernels import rfi_chirp as KR
    from srtb_tpu_torch.kernels import unpack as KU
    from srtb_tpu_torch.ops import fft as F
    from srtb_tpu_torch.ops import unpack as U
    sp, raw, h2d = _segment_on_card(run)
    cfg = sp.cfg
    bits, variant = cfg.baseband_input_bits, sp.fmt.unpack_variant
    ms = dict(h2d)
    ms["de-interleave bytes"] = cuda_ms(
        lambda: U.deinterleave_bytes(raw, variant), 5)
    rows = U.deinterleave_bytes(raw, variant)
    ms["unpack K1"] = cuda_ms(
        lambda: [KU.unpack_subbyte_window(rows[s], bits, sp.window)
                 for s in range(sp.streams)], 5)
    del rows
    x = sp._unpack(raw)
    ms["rfft"] = cuda_ms(lambda: F.rfft_drop_nyquist(x), 3)
    spec = F.rfft_drop_nyquist(x)
    del x
    thr = cfg.mitigate_rfi_average_method_threshold
    ms["mean power"] = cuda_ms(lambda: KR.rfi_threshold(spec, thr), 5)
    t = KR.rfi_threshold(spec, thr)
    ms["rfi + chirp K2"] = cuda_ms(lambda: sp._k2(spec, t), 5)
    spec = sp._k2(spec, t)
    front = sum(ms[k] for k in list(ms)[2:])
    _staged_tail_stages(ms, sp, spec)
    del spec
    whole = cuda_ms(lambda: sp.process(raw), 3)
    torch.cuda.empty_cache()
    return _breakdown_line(
        "dualpol_2^30", ms, whole, cfg,
        {"streams": sp.streams,
         "front_ms (de-interleave + K1 + R2C + mean + K2)": front,
         "staged_2^30_chain_ms (one stream)":
             breakdowns["staged_2^30"]["chain_ms"]})


def phase_breakdown_dualpol_pallas2(run, breakdowns: dict) -> dict:
    """Device time of one dualpol_pallas2_2^30 segment: the staged front
    (K1 a stream, B9 and B10 over both streams, the Hermitian post and
    the fused tail's K2 epilogue a stream), then the waterfall stages;
    the whole chain, and staged_pallas2_2^30's (one stream) beside it."""
    import torch
    sp, raw, h2d = _segment_on_card(run)
    ms = dict(h2d)
    ms["front (K1, B9, B10, post, K2)"] = cuda_ms(
        lambda: sp._spectrum(raw), 3)
    spec = sp._spectrum(raw)
    _staged_tail_stages(ms, sp, spec)
    del spec
    whole = cuda_ms(lambda: sp.process(raw), 3)
    torch.cuda.empty_cache()
    return _breakdown_line(
        "dualpol_pallas2_2^30", ms, whole, sp.cfg,
        {"streams": sp.streams,
         "staged_pallas2_2^30_chain_ms (one stream)":
             breakdowns["staged_pallas2_2^30"]["chain_ms"]})


def _breakdown_line(label, ms, whole, cfg, extra=None) -> dict:
    stage_sum = sum(v for k, v in ms.items() if not k.startswith("h2d"))
    out = {"stage_ms": ms, "stages_sum_ms": stage_sum,
           "chain_ms": whole,
           "chain_msamples_per_s": cfg.baseband_input_count / whole / 1e3,
           **(extra or {})}
    say(f"breakdown {label}: " + json.dumps(out) + f"; card {card_line()}")
    return out


def _segment_on_card(run):
    """The run's processor and its first segment's bytes on the card, with
    the upload's times: the pageable copy the serial ``process`` makes,
    and the engine's, from pinned memory on the processor's copy stream
    (``stage_input``; timed on the compute stream, which waits for it)."""
    import numpy as np
    import torch
    from srtb_tpu_torch.utils.bufferpool import BufferPool
    sp = run["pipe"].processor
    n = sp.cfg.segment_bytes(sp.streams)
    host = torch.from_numpy(np.fromfile(run["data"], dtype=np.uint8,
                                        count=n))
    pool = BufferPool("upload", pinned=True)
    pinned = pool.acquire(n, zero=False)
    pinned[:] = host.numpy()
    h2d = {"h2d (pageable)": cuda_ms(lambda: host.to("cuda"), 3),
           "h2d (pinned, copy stream)": cuda_ms(
               lambda: sp.stage_input(pinned), 3)}
    pool.release(pinned)
    return sp, host.to("cuda"), h2d


def _fused_tail_stages(ms: dict, sp, a) -> None:
    """Time the fused plans' stages after the plane FFTs ``a [1, p, M]``
    (one stream), each the processor's own function on the input the
    chain gives it."""
    from srtb_tpu_torch.ops import fft as F
    ms["plane twiddle + butterfly + hermitian post"] = cuda_ms(
        lambda: F.finish_rfft_subbyte(a), 3)
    held = {}

    def hold(zf, spec):
        held.update(zf=zf, spec=spec)
        return spec
    F.finish_rfft_subbyte(a, epilogue=hold)
    epilogue = sp._tail_epilogue()
    ms["epilogue: Parseval mean + K2"] = cuda_ms(
        lambda: epilogue(held["zf"], held["spec"]), 5)
    spec = epilogue(held.pop("zf"), held.pop("spec"))
    ms["B8 waterfall tail + zero count + detect"] = cuda_ms(
        lambda: sp._waterfall_detect(spec), 5)


def _rows_front_stages(ms: dict, sp, raw):
    """Time the 2^27 row-FFT plans' front: B13 and the four-step FFT on
    B6 legs; returns the plane FFTs ``a [1, p, M]`` (one stream)."""
    from srtb_tpu_torch.kernels import unpack as KU
    from srtb_tpu_torch.ops import fft as F

    def unpack():
        return KU.unpack_subbyte_planes_window(
            raw, sp.cfg.baseband_input_bits, sp.window_planes)
    ms["B13 unpack planes"] = cuda_ms(unpack, 5)
    z = unpack()[None]

    def planes_fft():
        return F.fft_minor(z, False, "pallas", sp._len_cap)
    ms["four-step FFT: B6 legs, transposes, leg twiddle"] = cuda_ms(
        planes_fft, 5)
    return planes_fft()


def _unfused_tail_stages(ms: dict, sp, a) -> None:
    """Time the unfused plan's stages after the plane FFTs ``a [1, p, M]``
    (one stream): the R2C's finish, the mean power + K2, then the
    waterfall as ``_waterfall_detect`` runs it on that plan (B7, the torch
    verdict and zero count, K4, detect), each alone on the input the
    chain gives it."""
    import torch
    from srtb_tpu_torch.kernels import fft_rows as KF
    from srtb_tpu_torch.kernels import rfi_chirp as KR
    from srtb_tpu_torch.kernels import sk as KS
    from srtb_tpu_torch.ops import detect as det
    from srtb_tpu_torch.ops import fft as F
    from srtb_tpu_torch.ops import rfi
    cfg = sp.cfg
    ms["plane twiddle + butterfly + hermitian post"] = cuda_ms(
        lambda: F.finish_rfft_subbyte(a), 3)
    spec = F.finish_rfft_subbyte(a)
    thr = cfg.mitigate_rfi_average_method_threshold
    ms["mean power + K2"] = cuda_ms(
        lambda: sp._k2(spec, KR.rfi_threshold(spec, thr)), 5)
    spec = sp._k2(spec, KR.rfi_threshold(spec, thr))[0]
    rows = F.waterfall_rows(spec, sp.channel_count)
    del spec
    ms["B7 fft_rows_stats"] = cuda_ms(lambda: KF.fft_rows_stats(
        rows, inverse=True, dewindow=sp.watfft_dewindow), 5)
    wf, s2, s4 = KF.fft_rows_stats(rows, inverse=True,
                                   dewindow=sp.watfft_dewindow)
    del rows
    sk_thr = cfg.mitigate_rfi_spectral_kurtosis_threshold

    def verdict():
        zap = rfi.sk_zap_decision(s2, s4, sp.watfft_len, sk_thr)
        return zap, torch.sum((zap | (rfi.power(wf[:, 0]) == 0)).to(
            torch.int32), dtype=torch.int32)
    ms["sk verdict + zero count (torch)"] = cuda_ms(verdict, 5)
    zap, zero_count = verdict()
    ms["sk apply + time series K4"] = cuda_ms(
        lambda: KS.sk_apply_timeseries(wf, zap), 5)
    _, ts = KS.sk_apply_timeseries(wf, zap)
    del wf
    t = det.trimmed_length(ts.shape[-1], sp.time_reserved_count)
    ms["detect"] = cuda_ms(lambda: det.detect_from_time_series(
        ts[None, :t], zero_count[None],
        cfg.signal_detect_signal_noise_threshold,
        cfg.signal_detect_max_boxcar_length), 5)


def phase_breakdown_rows(fused, unfused) -> dict:
    """Device time of one 2^27 segment of the fused and of the unfused
    row-FFT plan stage by stage, each stage the processor's own function
    alone on the input the chain gives it (CUDA events, mean of a few
    runs), and each whole chain on the same device-resident segment;
    returns the fused plan's line."""
    import torch
    out = {}
    for label, run, tail in (("fused_2^27", fused, _fused_tail_stages),
                             ("unfused_2^27", unfused,
                              _unfused_tail_stages)):
        sp, raw, h2d = _segment_on_card(run)
        ms = dict(h2d)
        tail(ms, sp, _rows_front_stages(ms, sp, raw))
        out[label] = (ms, cuda_ms(lambda: sp.process(raw), 3), sp.cfg)
        del raw
        torch.cuda.empty_cache()
    f_ms, f_whole, cfg = out["fused_2^27"]
    u_ms, u_whole, _ = out["unfused_2^27"]
    _breakdown_line("unfused_2^27", u_ms, u_whole, cfg,
                    {"fused_2^27_chain_ms": f_whole})
    return _breakdown_line("fused_2^27", f_ms, f_whole, cfg,
                           {"unfused_chain_ms": u_whole})


def phase_breakdown_pallas2(run, fused_chain_ms: float) -> dict:
    """The same for the pallas2 plan: B13, then B9, B10 and the unblocking
    transpose in place of the four-step, then the same fused tail; the
    fused_2^27 chain beside it."""
    import torch
    from srtb_tpu_torch.kernels import fft2 as K2
    from srtb_tpu_torch.kernels import unpack as KU
    sp, raw, h2d = _segment_on_card(run)
    cfg = sp.cfg
    ms = dict(h2d)

    def unpack():
        return KU.unpack_subbyte_planes_window(raw, cfg.baseband_input_bits,
                                               sp.window_planes)
    ms["B13 unpack planes"] = cuda_ms(unpack, 5)
    z = unpack()
    blocks = z.reshape(*z.shape[:-1], *K2.factor(z.shape[-1]))
    del z
    ms["B9 pass 1"] = cuda_ms(lambda: K2.fft2_pass1(blocks), 5)
    b = K2.fft2_pass1(blocks)
    del blocks
    ms["B10 pass 2"] = cuda_ms(lambda: K2.fft2_pass2(b), 5)
    c = K2.fft2_pass2(b)
    del b
    ms["unblock transpose"] = cuda_ms(lambda: K2.unblock(c), 5)
    a = K2.unblock(c)[None]
    del c
    _fused_tail_stages(ms, sp, a)
    del a
    whole = cuda_ms(lambda: sp.process(raw), 3)
    torch.cuda.empty_cache()
    return _breakdown_line("pallas2_2^27", ms, whole, cfg,
                           {"fused_2^27_chain_ms": fused_chain_ms})


def phase_breakdown_gznupsr(run, fused_chain_ms: float) -> dict:
    """Device time of one gznupsr_2^27 segment stage by stage (the
    processor's own functions): the torch unpack of the word interleave
    into [2, n], the even/odd pack, the packed C2C of both streams on B6
    legs (two launches), the Hermitian post with the fused tail's
    epilogue (each stream's Parseval mean and K2), B8 once a stream with
    the zero count and detect; the whole chain, and fused_2^27's (one
    2-bit stream, the blocked R2C) beside it."""
    import torch
    from srtb_tpu_torch.ops import fft as F
    sp, raw, h2d = _segment_on_card(run)
    ms = dict(h2d)
    ms["unpack (torch)"] = cuda_ms(lambda: sp._unpack(raw), 5)
    x = sp._unpack(raw)
    ms["pack even/odd"] = cuda_ms(lambda: F.pack_even_odd(x), 5)
    z = F.pack_even_odd(x)
    del x

    def c2c():
        return F.four_step_fft(z, rows_impl="pallas", len_cap=sp._len_cap)
    ms["four-step FFT: B6 legs, transposes, leg twiddle"] = cuda_ms(c2c, 5)
    zf = c2c()
    del z
    epilogue = sp._tail_epilogue()
    ms["Hermitian post + epilogue (Parseval mean, K2)"] = cuda_ms(
        lambda: F.hermitian_rfft_post(zf, True, epilogue=epilogue), 5)
    spec = F.hermitian_rfft_post(zf, True, epilogue=epilogue)
    del zf
    ms["B8 waterfall tail + zero count + detect"] = cuda_ms(
        lambda: sp._waterfall_detect(spec), 5)
    del spec
    whole = cuda_ms(lambda: sp.process(raw), 3)
    torch.cuda.empty_cache()
    return _breakdown_line("gznupsr_2^27", ms, whole, sp.cfg,
                           {"streams": sp.streams,
                            "fused_2^27_chain_ms (one 2-bit stream)":
                                fused_chain_ms})


def phase_breakdown_shipped(run) -> dict:
    """Device time of one 2^30 segment of the example cfg as shipped, stage
    by stage (the processor's own functions), and the whole chain."""
    import torch
    from srtb_tpu_torch.kernels import dedisperse as KD
    from srtb_tpu_torch.ops import rfi
    sp, raw, h2d = _segment_on_card(run)
    cfg = sp.cfg
    ms = dict(h2d)
    ms["K1 unpack + R2C (cuFFT)"] = cuda_ms(lambda: sp._spectrum(raw), 3)
    spec = sp._spectrum(raw)
    thr = cfg.mitigate_rfi_average_method_threshold
    ms["stage 1: mean, zap, normalize (torch)"] = cuda_ms(
        lambda: rfi.mitigate_rfi_average_and_normalize(spec, thr,
                                                       sp.norm_coeff), 3)
    spec = rfi.mitigate_rfi_average_and_normalize(spec, thr, sp.norm_coeff)
    ms["manual mask (torch)"] = cuda_ms(
        lambda: rfi.mitigate_rfi_manual(spec, sp.rfi_zap), 3)
    spec = rfi.mitigate_rfi_manual(spec, sp.rfi_zap)
    chirp = (sp.f_min, sp.df, sp.f_c, cfg.dm)
    ms["B3 dedisperse"] = cuda_ms(lambda: KD.dedisperse(spec[0], *chirp), 5)
    spec = KD.dedisperse(spec[0], *chirp)[None]
    ms["waterfall C2C (cuFFT) + SK (torch) + detect"] = cuda_ms(
        lambda: sp._waterfall_detect(spec), 3)
    del spec
    whole = cuda_ms(lambda: sp.process(raw), 3)
    torch.cuda.empty_cache()
    return _breakdown_line("shipped_2^30", ms, whole, cfg)


# ---------------------------------------------------------------- live
# The live phase: srtb-torch-main's default input, UDP packets, from a
# loopback sender process at the J1644-4559 rate (2-bit at 128 Msamples/s
# a stream: 32 MB/s, 7812.5 fastmb_roach2 packets of 4096 payload bytes a
# second), through Pipeline(cfg, source=...) at the engine's defaults.
LIVE_RATE_BYTES_PER_S = 32e6
LIVE_PAYLOAD = 4096
LIVE_FORMAT = "baseband_format_type = fastmb_roach2\n"
# (label, log2 samples, cfg lines, segments a port, the pulse's segment
# on port 0, ports, kernel launches a segment and stream).  live_2^30's
# pulse is in its first segment: that positive's dump (a 4 GiB .npy)
# runs on the sink thread while the second segment is received, and
# holds its window slot, so the engine thread reads the third segment
# only once the dump is done; a lossy run is repeated without the pulse
LIVE_PATHS = (
    ("live_2^30", LOG2_N, PALLAS_ON, 3, 0, 1,
     {"unpack_subbyte_window": 1, "rfi_s1_dedisperse": 1, "sk_stats": 1,
      "sk_apply_timeseries": 1}),
    ("live2rx_2^27", LOG2_N_ROWS,
     PALLAS_27 + "udp_receiver_cpu_preferred = 2, 3\n", 4, 1, 2,
     {"unpack_subbyte_planes_window": 1, "fft_rows": 2,
      "rfi_s1_dedisperse": 1, "fft_rows_skzap": 1}),
)
# the first packet counter of each port's stream (distinct, so that the
# two ports' candidates never share a name)
LIVE_COUNTER0 = (0, 1 << 40)
# packets of zeros sent after each stream
LIVE_TRAILER = 64


def loopback_sender(argv: list) -> int:
    """``chip_smoke.py --loopback-sender RATE FILE PORT COUNTER0 [...]``:
    each file as counter-sequential fastmb_roach2 datagrams (LE64 counter
    from COUNTER0, 4096 payload bytes, the last payload zero-padded) to
    127.0.0.1:PORT, every stream at RATE bytes a second, then
    ``LIVE_TRAILER`` packets of zeros (a live stream goes on: a receiver
    whose last block lost its last packets closes it on them); prints
    the send window's wall-clock start and end and the most packets a
    stream fell behind its schedule (sent at once to catch up) as
    JSON."""
    import socket
    import struct
    rate = float(argv[0])
    streams = []
    for i in range(1, len(argv), 3):
        # read whole before the first packet: a page fault in the send
        # loop would make the sender fall behind and then burst
        with open(argv[i], "rb") as f:
            data = f.read()
        streams.append((data, int(argv[i + 1]), int(argv[i + 2]),
                        -(-len(data) // LIVE_PAYLOAD)))
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sent = [0] * len(streams)
    behind = 0  # the most packets a stream was behind its schedule
    t_start = time.time()
    t0 = time.perf_counter()
    while any(sent[i] < s[3] for i, s in enumerate(streams)):
        due = int((time.perf_counter() - t0) * rate / LIVE_PAYLOAD) + 1
        for i, (data, port, c0, count) in enumerate(streams):
            behind = max(behind, min(due, count) - sent[i])
            while sent[i] < min(due, count):
                k = sent[i]
                body = data[k * LIVE_PAYLOAD:(k + 1) * LIVE_PAYLOAD]
                body += bytes(LIVE_PAYLOAD - len(body))
                sock.sendto(struct.pack("<Q", c0 + k) + body,
                            ("127.0.0.1", port))
                sent[i] += 1
        time.sleep(0.0005)
    t_end = time.time()
    time.sleep(0.05)
    for data, port, c0, count in streams:
        for k in range(count, count + LIVE_TRAILER):
            sock.sendto(struct.pack("<Q", c0 + k) + bytes(LIVE_PAYLOAD),
                        ("127.0.0.1", port))
    print(json.dumps({"start": t_start, "end": t_end, "packets": sent,
                      "max_behind_packets": behind}), flush=True)
    return 0


def _free_udp_port() -> int:
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class LiveTap:
    """A sink appended to the live pipeline (it runs on the sink thread):
    it keeps a copy of each received segment's bytes with its (port,
    index, counter, decision) and nothing more, so that the sink side
    takes as long as it would without it (a slow sink holds a window
    slot, and the engine thread then reads the socket late).  After the
    run, :meth:`verify` holds each copy against the file reader's segment
    of the same port and index, payload slot by slot: a slot that
    differs must be all zeros (a lost packet); the differing slots of the
    freshly received strides are counted, and their sum must equal the
    source's packets_lost.  A segment with no differing slot, head
    included, is ``clean``: its decision and candidates can be held
    against file mode's."""

    def __init__(self, files: list, cfg, reserved: int):
        self.files = files
        self.seg = cfg.segment_bytes(1)
        self.stride = self.seg - reserved
        self.reserved_slots = reserved // LIVE_PAYLOAD
        self.next_index = [0] * len(files)
        self.copies = []
        self.records = []
        self.lossy = {}
        self.stride_mismatch = 0
        self.head_mismatch = 0
        self.clean = set()
        self.failures = []

    def push(self, work, has_signal):
        seg = work.segment
        port = seg.data_stream_id
        k = self.next_index[port]
        self.next_index[port] += 1
        self.copies.append(seg.data.copy())
        self.records.append([port, k, int(seg.udp_packet_counter),
                             bool(has_signal), 0])

    def verify(self) -> None:
        """The slot-by-slot comparison with the files (after the run)."""
        import numpy as np
        for record, got in zip(self.records, self.copies):
            port, k = record[0], record[1]
            want = np.zeros(self.seg, dtype=np.uint8)
            with open(self.files[port], "rb") as f:
                f.seek(k * self.stride)
                f.readinto(memoryview(want))
            got = got.reshape(-1, LIVE_PAYLOAD)
            differ = (got != want.reshape(-1, LIVE_PAYLOAD)).any(axis=1)
            if got[differ].any():
                self.failures.append(f"port {port} segment {k}: a slot "
                                     "differs from the file's and is not "
                                     "zero")
            head = self.reserved_slots if k else 0
            lost = int(differ[head:].sum())
            self.head_mismatch += int(differ[:head].sum())
            self.stride_mismatch += lost
            record[4] = lost
            if not differ.any():
                self.clean.add((port, k))
            if lost:
                # where in the segment: the lost slots' first and last
                # index and the count of gaps (runs of lost slots)
                at = np.flatnonzero(differ[head:]) + head
                self.lossy[(port, k)] = (int(at[0]), int(at[-1]),
                                         int(1 + (np.diff(at) > 1).sum()))
        self.copies = []


def _candidate_bytes_equal(live_files, file_files,
                           shed_dumps: bool = False) -> list:
    """Pairs of candidate files (.bin, each .npy, each .tim by its
    suffix after the counter or timestamp) whose bytes differ;
    ``shed_dumps``: the live run withheld the waterfall dumps (the
    degradation ladder's level 1), so file mode's are left out."""
    def by_suffix(files, npy=True):
        base = files.bin_path[:-len(".bin")]
        return {p[len(base):]: p for p in
                [files.bin_path, *(files.npy_paths if npy else ()),
                 *files.tim_paths]}
    live, ref = by_suffix(live_files), by_suffix(file_files, not shed_dumps)
    if sorted(live) != sorted(ref):
        return [f"files {sorted(live)} against {sorted(ref)}"]
    return [live[k] for k in live if not _same_bytes(live[k], ref[k])]


def check_packet_ring(card: str) -> None:
    """The AF_PACKET ring receiver once on loopback (it needs
    CAP_NET_RAW): four packets, one block, or the OSError's text."""
    import threading
    import numpy as np
    from srtb_tpu_torch.io import formats, udp
    fmt = formats.resolve("fastmb_roach2")
    port = _free_udp_port()
    try:
        rx = udp.PacketRingReceiver("", port, fmt, interface="lo")
    except OSError as e:
        say(f"live packet_ring: not run: {e}")
        return

    def send():
        import socket
        import struct
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        time.sleep(0.1)
        for c in (0, 2, 1, 3, 4):
            s.sendto(struct.pack("<Q", c) + bytes([c]) * LIVE_PAYLOAD,
                     ("127.0.0.1", port))
        s.close()
    t = threading.Thread(target=send, daemon=True)
    t.start()
    out = np.full(4 * LIVE_PAYLOAD, 0xA5, dtype=np.uint8)
    box = []
    r = threading.Thread(target=lambda: box.append(rx.receive_block(out)),
                         daemon=True)
    r.start()
    r.join(30)
    t.join(5)
    if r.is_alive():
        fail("packet_ring: no block within 30 s")
    rx.close()
    first, lost, total = box[0]
    if (first, lost, total) != (0, 0, 4) or [
            int(out[i * LIVE_PAYLOAD]) for i in range(4)] != [0, 1, 2, 3]:
        fail(f"packet_ring: block {box[0]}, slots "
             f"{[int(out[i * LIVE_PAYLOAD]) for i in range(4)]}")
    say(f"live packet_ring: one block of 4 reordered packets on lo "
        f"(first {first}, lost {lost}, total {total}), bytes as sent; "
        f"card {card}")


def phase_live_path(card: str, label: str, log2_n: int, extra: str,
                    segments: int, pulse: int, ports: int,
                    per_segment: dict) -> dict:
    """One live path: the sender streams each port's file (the
    overlap-save layout of ``make_input_file``, the pulse in stream 0's
    segment ``pulse`` on port 0 only) while ``Pipeline(cfg,
    source=UdpReceiverSource(cfg) | MultiUdpSource(cfg))`` searches
    ``segments`` segments a port at the engine's defaults; the launch
    counts are zeroed just before the run (after a warm-up dispatch on
    zeros, made before the first packet) and read just after it.  Then
    the gates: the native recvmmsg provider ran, every received slot
    equals the file's, lost slots are zero and their count is the
    source's packets_lost, the launches are the table's, the pulse's
    segment is positive; and on the segments that lost no packet (warm
    head included), each port's decisions and candidate bytes equal a
    file-mode run of its file."""
    import numpy as np
    import torch
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.io import udp
    from srtb_tpu_torch.pipeline.runtime import Pipeline
    port_numbers = [_free_udp_port() for _ in range(ports)]
    out_dir = OUT_DIR / label
    lines = (extra + LIVE_FORMAT + "udp_receiver_address = 127.0.0.1\n"
             + "udp_receiver_port = "
             + ", ".join(map(str, port_numbers)) + "\n")
    cfg, text = path_cfg(out_dir, lines, log2_n, label)
    files = []
    for p in range(ports):
        data = OUT_DIR / "inputs" / f"{label}_port{p}.bin"
        data.parent.mkdir(parents=True, exist_ok=True)
        info = make_input_file(cfg, data, segments,
                               pulse if p == 0 else None, seed=100 + 400 * p)
        files.append(data)
    say(f"{label}: inputs {[str(f.relative_to(ROOT)) for f in files]} "
        f"({info['segment_bytes']} bytes a segment, reserved "
        f"{info['reserved_bytes']})")
    src = udp.MultiUdpSource(cfg) if ports > 1 else \
        udp.UdpReceiverSource(cfg)
    sources = src.sources if ports > 1 else [src]
    provider = type(sources[0].receiver).__name__
    if provider != "NativeBlockReceiver":
        src.close()
        fail(f"{label}: the receiver is {provider}, not the native "
             "recvmmsg one")
    rcvbuf = sources[0].receiver.rcvbuf_bytes
    rmem_max = Path("/proc/sys/net/core/rmem_max").read_text().strip()
    fresh_telemetry()
    pipe = Pipeline(cfg, source=src)
    sender = None
    try:
        proc = pipe.processor
        # one dispatch on zeros before the first packet: the plan's
        # one-time set-up (FFT plans, cached tables) is not the stream's
        proc.process(np.zeros(cfg.segment_bytes(1), dtype=np.uint8))
        torch.cuda.synchronize()
        if sources[0].reserved_bytes != proc.reserved_bytes:
            fail(f"{label}: the source's overlap ({sources[0].reserved_bytes}"
                 f" bytes) is not the processor's ({proc.reserved_bytes})")
        tap = LiveTap(files, cfg, proc.reserved_bytes)
        pipe.sinks.append(tap)
        cold0, warm0 = proc.ring_cold_dispatches, proc.ring_warm_dispatches
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        args = [sys.executable, str(Path(__file__).resolve()),
                "--loopback-sender", str(LIVE_RATE_BYTES_PER_S)]
        for p in range(ports):
            args += [str(files[p]), str(port_numbers[p]),
                     str(LIVE_COUNTER0[p])]
        sender = subprocess.Popen(args, stdout=subprocess.PIPE, text=True)
        stats = _bounded_run(pipe, sources, segments * ports, label,
                             sum(f.stat().st_size for f in files)
                             / ports / LIVE_RATE_BYTES_PER_S + 120)
        t_done = time.time()
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        sent = json.loads(sender.communicate(timeout=120)[0])
        cold = proc.ring_cold_dispatches - cold0
        warm = proc.ring_warm_dispatches - warm0
    finally:
        if sender is not None and sender.poll() is None:
            sender.kill()
            sender.wait()
        pipe.close()
    tap.verify()
    lost = stats.extras["packets_lost"]
    total = stats.extras["packets_total"]
    window = sent["end"] - sent["start"]
    samples = stats.segments * cfg.baseband_input_count
    msps = samples / ports / window / 1e6
    say(f"live {label}: provider {provider}; {stats.segments} segments "
        f"({ports} port(s)); sent {sent['packets']} packets in "
        f"{window:.3f} s (at most {sent['max_behind_packets']} packets "
        f"behind schedule); packets_total {total}, packets_lost {lost}; "
        f"offered rate {msps:.2f} Msamples/s a stream (the sender's, "
        f"over its window: {msps / 128.0:.4f}x real time); lag: the last "
        f"segment done {t_done - sent['end']:.3f} s after the last "
        f"packet; pipeline "
        f"{stats.elapsed_s:.3f} s; SO_RCVBUF granted {rcvbuf} bytes, "
        f"net.core.rmem_max {rmem_max}; ring cold {cold}, warm {warm}; "
        f"max_memory_allocated {peak} bytes at window "
        f"{stats.extras['inflight_segments']}; launches {counts}; "
        f"positive {pipe.positive_segments}; card {card}")
    say(f"live {label}: engine " + engine_numbers(stats))
    say(f"live {label}: segments (port, index, counter, positive, lost) "
        + json.dumps(tap.records))
    ex = stats.extras
    levels = ex["degrade_levels"]
    steps = [(i, a, b) for i, (a, b) in enumerate(zip([0] + levels, levels))
             if a != b]
    say(f"live {label}: the degradation ladder (degrade_enable "
        f"{cfg.degrade_enable}): level by segment {levels}, transitions "
        f"(segment, from, to) {steps}, shed_waterfalls "
        f"{ex.get('shed_waterfalls', 0)}, shed_baseband "
        f"{ex.get('shed_baseband', 0)}, segments_dropped "
        f"{ex.get('segments_dropped', 0)}; card {card}")
    check_no_recovery(f"live {label}", stats)
    if stats.segments != segments * ports:
        fail(f"{label}: {stats.segments} segments")
    if tap.failures:
        fail(f"{label}: " + "; ".join(tap.failures))
    if tap.stride_mismatch != lost:
        fail(f"{label}: {tap.stride_mismatch} received slots differ from "
             f"the file's, the source lost {lost}")
    if lost:
        say(f"live {label}: LOST {lost} packets of {total} (zeroed slots; "
            f"{tap.head_mismatch} more in warm heads); SO_RCVBUF {rcvbuf}, "
            f"rmem_max {rmem_max}; (port, index, counter, positive, lost) "
            f"of the lossy segments {[r for r in tap.records if r[4]]}; "
            f"their lost slots' (first, last, gaps) of "
            f"{tap.seg // LIVE_PAYLOAD} "
            + json.dumps({str(k): v for k, v in tap.lossy.items()}))
    for name, count in counts.items():
        want = per_segment.get(name, 0) * stats.segments
        if count != want:
            fail(f"{label}: kernel {name} launched {count} times for "
                 f"{stats.segments} segments, the table says {want}")
    say(f"live {label}: every received slot equals the file's, lost "
        f"slots zero and counted; launches per segment as the table "
        + json.dumps({k: v / stats.segments for k, v in counts.items()}))
    result = {"counts": counts, "lost": lost, "msamples_per_s": msps,
              "peak_bytes": peak}
    if pulse is not None and [0, pulse] not in [r[:2] for r in tap.records
                                                if r[3]]:
        fail(f"{label}: the pulse's segment {pulse} on port 0 is not "
             f"positive live (positives {pipe.positive_segments})")
    _compare_with_file_mode(card, label, lines, log2_n, files, pipe, tap,
                            levels)
    for files_ in pipe.sink.written:
        for p in files_.npy_paths:
            os.unlink(p)
    for f in files:
        f.unlink()
    free_card()
    return result


def _bounded_run(pipe, sources, segments: int, label: str,
                 limit_s: float):
    """``pipe.run(max_segments=segments)`` on a thread of its own, the
    only one that launches kernels; past ``limit_s`` seconds the
    receivers are shut down (a blocked receive then raises) and the
    phase fails instead of waiting for packets that never come."""
    import threading
    box = {}

    def body():
        try:
            box["stats"] = pipe.run(max_segments=segments)
        except BaseException as e:  # noqa: BLE001 - reported below
            box["error"] = e
    runner = threading.Thread(target=body, name="live_engine", daemon=True)
    runner.start()
    runner.join(limit_s)
    if runner.is_alive():
        for src in sources:
            src.receiver.shutdown()
        runner.join(60)
        fail(f"{label}: the run did not end within {limit_s:.0f} s")
    if "error" in box:
        raise box["error"]
    return box["stats"]


def _compare_with_file_mode(card, label, lines, log2_n, files, pipe,
                            tap, levels: list) -> None:
    """Each port's file through ``srtb-torch-main`` in file mode, held
    against the live run on the segments that lost no packet
    (``tap.clean``): their positives must be the live run's for that
    port, and each positive's candidate bytes the live candidate's of the
    same segment (named by packet counter live, by timestamp in file
    mode), less what the live run's degradation ladder shed (``levels``,
    the level of each segment in the tap's order: at 1 its waterfall
    dumps, at 2 its candidate files; each shed listed).  A live candidate
    with no file-mode twin must be a piggyback (another port's negative
    written beside a positive) or a segment that lost packets."""
    stride_packets = tap.stride // LIVE_PAYLOAD
    clean = tap.clean
    level_of = {(r[0], r[1]): lv for r, lv in zip(tap.records, levels)}
    shed = []
    live_by_name = {os.path.basename(f.bin_path): f
                    for f in pipe.sink.written}
    matched = set()
    for p, data in enumerate(files):
        out_dir = OUT_DIR / f"{label}_file{p}"
        _cfg, ftext = path_cfg(out_dir, lines, log2_n, label)
        _stats, fpipe, _wall = run_cli(out_dir, ftext, data, {})
        live_pos = [k for port, k, _c, pos, _l in tap.records
                    if port == p and pos and (p, k) in clean]
        file_pos = [k for k in fpipe.positive_segments if (p, k) in clean]
        if file_pos != live_pos:
            fail(f"{label} port {p}: on the segments that lost nothing, "
                 f"file-mode positives {file_pos}, live {live_pos}")
        for k, ffiles in zip(fpipe.positive_segments, fpipe.sink.written):
            if (p, k) not in clean:
                continue
            name = f"out_{LIVE_COUNTER0[p] + k * stride_packets}.bin"
            level = level_of.get((p, k), 0)
            if level >= 2:
                shed.append((p, k, "candidates", name))
                continue
            if level == 1:
                shed.append((p, k, "waterfall dumps", name))
            if name not in live_by_name:
                fail(f"{label} port {p}: no live candidate {name}")
            bad = _candidate_bytes_equal(live_by_name[name], ffiles,
                                         shed_dumps=level == 1)
            if bad:
                fail(f"{label} port {p} segment {k}: live candidate files "
                     f"differ from file mode's: {bad}")
            matched.add(name)
        for ffiles in fpipe.sink.written:
            for q in ffiles.npy_paths:
                os.unlink(q)
        del fpipe
    extra = sorted(set(live_by_name) - matched)
    unmatched_ok = {f"out_{c}.bin" for p, k, c, pos, _l in tap.records
                    if not pos or (p, k) not in clean}
    if not set(extra) <= unmatched_ok:
        fail(f"{label}: live candidates {extra} are neither file mode's, "
             "nor piggybacked negatives, nor of a lossy segment")
    compared = sorted(clean)
    say(f"live {label}: on the {len(compared)} of {len(tap.records)} "
        f"segments that lost nothing {compared}, decisions and candidate "
        f"bytes equal file mode's ({sorted(matched)}), less what the "
        f"degradation ladder shed (port, segment, what, candidate) {shed}; "
        f"other live candidates {extra}; card {card}")


# ------------------------------------------------------------ search modes

# the periodicity path: the example cfg as shipped (no reserve) in the
# periodicity mode with the kernels on; its input's second segment holds
# PERIODIC_PULSES pulses PERIODIC_SPACING samples apart from
# PERIODIC_SPACING / 2 (the fundamental is bin 16 of T = 2^18 exactly),
# each PERIODIC_WIDTH samples of noise at PERIODIC_AMP times the noise's
# amplitude: a duty cycle of 1/64, weak enough that the cfg's SK threshold
# of 1.05 keeps every channel
PERIODIC_EXTRA = ("search_mode = periodicity\nuse_pallas = 1\n"
                  "use_pallas_sk = 1\n")
PERIODIC_PULSES = 16
PERIODIC_SPACING = 1 << 26
PERIODIC_WIDTH = 1 << 20
PERIODIC_AMP = 0.5
PERIODIC_FUNDAMENTAL = 16
# K1, K2, K3 and K4 once a segment
PERIODIC_LAUNCHES = {"unpack_subbyte_window": 1, "rfi_s1_dedisperse": 1,
                     "sk_stats": 1, "sk_apply_timeseries": 1}
# the DM search: examples/j1644_dmsearch.sh's eight trials around
# J1644-4559's -478.80
DM_TRIALS = (-380.0, -430.0, -465.0, -478.80, -495.0, -530.0, -580.0,
             -650.0)
DMSEARCH_EXTRA = ("use_pallas = 1\nuse_pallas_sk = 1\ndm_list = "
                  + ", ".join(f"{d:.2f}" for d in DM_TRIALS) + "\n")
# K1 once a segment, B3, K3 and K4 once a trial
DMSEARCH_LAUNCHES = {"unpack_subbyte_window": 1,
                     "dedisperse": len(DM_TRIALS),
                     "sk_stats": len(DM_TRIALS),
                     "sk_apply_timeseries": len(DM_TRIALS)}
# the correlator's inputs: two 8-bit files of 2^30 samples, the second
# the first delayed by CORR_LAG samples plus independent noise
CORR_LOG2_N = 30
CORR_LAG = 12345
CORR_RTOL = 1e-4


def make_periodic_input(cfg, path: Path) -> dict:
    """Two segments of the cfg's 2-bit samples made on the card (no
    reserve, so they do not overlap): noise, then the pulse train."""
    import torch
    from srtb_tpu_torch.io import synth
    n = cfg.baseband_input_count
    positions = [PERIODIC_SPACING // 2 + j * PERIODIC_SPACING
                 for j in range(PERIODIC_PULSES)]
    with open(path, "wb") as f:
        for i, pulses in enumerate(([], positions)):
            gen = torch.Generator(device="cuda").manual_seed(300 + i)
            f.write(synth.make_dispersed_baseband(
                n, cfg.baseband_freq_low, cfg.baseband_bandwidth, cfg.dm,
                pulses, nbits=cfg.baseband_input_bits,
                pulse_amp=PERIODIC_AMP, pulse_width=PERIODIC_WIDTH,
                device="cuda", generator=gen).cpu().numpy().tobytes())
            torch.cuda.empty_cache()
    return {"segments": 2, "pulse_segment": 1, "pulses": PERIODIC_PULSES,
            "spacing": PERIODIC_SPACING, "width": PERIODIC_WIDTH,
            "amp": PERIODIC_AMP}


def _check_launches(label: str, counts: dict, per_segment: dict,
                    segments: int) -> None:
    """Fail unless every kernel launched ``per_segment`` times a segment
    (0 when it is not listed) over the run's ``segments``."""
    for name, count in counts.items():
        want = per_segment.get(name, 0) * segments
        if count != want:
            fail(f"{label}: kernel {name} launched {count} times for "
                 f"{segments} segments, the plan's table says {want}")
    say(f"{label}: launches per segment as the plan's table "
        + json.dumps({k: v / segments for k, v in counts.items()}))


def phase_periodicity(card: str) -> dict:
    """periodicity_2^30: ``srtb-torch-main`` in the periodicity mode on the
    pulse-train file, then again at ``inflight_segments = 1``: the plan,
    the launches, the decisions (the boxcar's and the periodicity gate's
    apart), the candidates on the train's comb, the fold's peak, the
    ``.fold.npy`` and ``.cand.json`` written, both segments dispatched
    again under the sync check (:func:`check_dispatch_syncs`) and every
    candidate file of the two runs equal by SHA-256; the periodicity
    module's ms on the card, and two folds of one series equal bit for
    bit."""
    import torch
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.ops import periodicity as P
    from srtb_tpu_torch.pipeline.runtime import has_signal
    label = "periodicity_2^30"
    runs = {}
    data = OUT_DIR / "inputs" / f"{label}.bin"
    for setting, extra in (("default", ""),
                           ("serial", "inflight_segments = 1\n")):
        out_dir = OUT_DIR / f"{label}_{setting}"
        cfg, text = path_cfg(out_dir, PERIODIC_EXTRA + extra, LOG2_N, label)
        if not data.exists():
            data.parent.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            info = make_periodic_input(cfg, data)
            say(f"{label}: input {data.relative_to(ROOT)} "
                f"({data.stat().st_size} bytes, {info}) made in "
                f"{time.perf_counter() - t0:.1f} s")
        K.reset_launch_counts()
        stats, pipe, wall = run_cli(out_dir, text, data, {})
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        sp = pipe.processor
        say(f"{label} {setting}: plan {sp.plan_name}, {stats.segments} "
            f"segments, positive {pipe.positive_segments}, "
            f"{stats.msamples_per_sec:.1f} Msamples/s ({stats.elapsed_s:.2f}"
            f" s, {wall:.2f} s with set-up), max_memory_allocated {peak} "
            f"bytes ({peak / 1e9:.2f} GB); launches {counts}; card {card}")
        if sp.plan_name != "staged:four_step+period":
            fail(f"{label}: plan {sp.plan_name}")
        if stats.segments != 2 or pipe.positive_segments != [1]:
            fail(f"{label}: positive {pipe.positive_segments} of "
                 f"{stats.segments}; expected [1] of 2")
        _check_launches(f"{label} {setting}", counts, PERIODIC_LAUNCHES, 2)
        files = pipe.sink.written[0]
        names = sorted(os.path.basename(p) for p in files.fold_paths)
        if len(names) != 2 or not all(os.path.getsize(p) for p in
                                      files.fold_paths):
            fail(f"{label}: fold and candidate files {names}")
        runs[setting] = {"counts": counts, "digests": _digests(pipe),
                         "stats": stats, "pipe": pipe, "peak": peak}
        if setting == "default":
            cfg0 = cfg.replace(input_file_path=str(data))
            check_dispatch_syncs(pipe, label)
        for f in pipe.sink.written:  # the 4 GiB waterfall dumps: hashed
            for p in f.npy_paths:
                os.unlink(p)
    a, b = runs["default"]["digests"], runs["serial"]["digests"]
    if a != b:
        fail(f"{label}: candidate files of the two runs differ: {a} {b}")
    say(f"{label}: candidate files of the default and the serial run "
        f"equal by SHA-256 ({sorted(a)})")
    # the decisions by hand, on each segment: the boxcar's own and the
    # periodicity gate's, the candidates and the fold
    sp = runs["default"]["pipe"].processor
    segs, pool = _segments_pinned(cfg0)
    out = {}
    for i, seg in enumerate(segs):
        wf, res = sp.run_device(sp.stage_input(seg.data))
        del wf
        boxcar = bool((res.signal_counts.sum() > 0).item()) and bool(
            (res.zero_count < cfg0.signal_detect_channel_threshold
             * sp.channel_count).all().item())
        gate = res.positive_gate(cfg0).tolist()
        bins = res.candidate_bins[0].tolist()
        snr = res.candidate_snr[0].tolist()
        prof = res.folded_profiles[0, 0].float()
        ratio = float(prof.abs().max() / prof.abs().median())
        say(f"{label}: segment {i}: boxcar fired on its own {boxcar} "
            f"(signal_counts {res.signal_counts[0].tolist()}, zero_count "
            f"{int(res.zero_count[0])}), periodicity gate {gate} (margin "
            f"{cfg0.periodicity_snr_threshold} over ln(trials "
            f"{res.candidate_trials})), has_signal "
            f"{has_signal(cfg0, res, frequency_bin_count=sp.channel_count)}"
            f", candidates {bins} snr {snr} harmonics "
            f"{res.candidate_harmonics[0].tolist()}, fold peak / median "
            f"|profile| {ratio:.2f}")
        out[i] = (bins, ratio, res.time_series[0].clone())
        pool.release(seg.data)
    pool.free_all()
    bins, ratio, ts = out[1]
    if bins[0] not in (PERIODIC_FUNDAMENTAL, 2 * PERIODIC_FUNDAMENTAL) or \
            any(b % PERIODIC_FUNDAMENTAL for b in bins):
        fail(f"{label}: candidates {bins} off the train's comb")
    if not ratio > 3.0:
        fail(f"{label}: fold peak {ratio:.2f} x the median |profile|")
    # the module on the card: its time, and the fold's fixed order
    ms = cuda_ms(lambda: P.periodicity_search(ts, 8, 4, 64), 5)
    bins_t = torch.tensor([PERIODIC_FUNDAMENTAL, 3, 1000], device="cuda")
    f1, f2 = P.fold(ts, bins_t, 64), P.fold(ts, bins_t, 64)
    if not torch.equal(f1, f2):
        fail(f"{label}: two folds of one series differ")
    say(f"{label}: periodicity_search at T = {ts.shape[-1]} (harmonics 8, "
        f"4 candidates, 64 fold bins) {ms:.3f} ms; two folds of one "
        f"series equal bit for bit; card {card}")
    for r in runs.values():
        r.pop("pipe")
    return {"counts": runs["default"]["counts"], "module_ms": ms,
            "peak": runs["default"]["peak"],
            "msamples_per_s": [r["stats"].msamples_per_sec
                               for r in runs.values()]}


def _segments_pinned(cfg):
    """The file's segments in pinned buffers (and the pool that holds
    them)."""
    from srtb_tpu_torch.io.file_input import make_file_source
    from srtb_tpu_torch.utils.bufferpool import BufferPool
    pool = BufferPool("segments", pinned=True)
    src = make_file_source(cfg, buffer_pool=pool)
    segs = list(src)
    src.close()
    return segs, pool


def phase_dmsearch(card: str, made: dict) -> dict:
    """dmsearch_2^30: ``srtb-torch-main`` with the eight trials of
    ``examples/j1644_dmsearch.sh`` on the cfg's file with the pulse at
    -478.80 in segment 1: the launches, the record, the matched trial
    against a single-DM staged processor of the same cfg on the same
    segments, the trial loop dispatched under ``set_sync_debug_mode
    ("error")``, the peak memory at 1 and at 8 trials, the stages of one
    segment, and ``srtb-torch-plot-dm-curve`` on the record."""
    import contextlib
    import io
    import torch
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.parallel.segment_dist import DistSegmentProcessor
    from srtb_tpu_torch.pipeline.segment import SegmentProcessor
    from srtb_tpu_torch.tools import plot_dm_curve as PD
    label = "dmsearch_2^30"
    out_dir = OUT_DIR / label
    cfg, text = path_cfg(out_dir, DMSEARCH_EXTRA, LOG2_N, label)
    if tuple(cfg.dm_list) != DM_TRIALS or cfg.dm not in cfg.dm_list:
        fail(f"{label}: dm_list {cfg.dm_list}, dm {cfg.dm}")
    data = input_file(cfg, label, made)
    K.reset_launch_counts()
    stats, search, wall = run_cli(out_dir, text, data, {})
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with open(search.trials_path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    say(f"{label}: plan {search.processor.processor.plan_name} (the DM "
        f"tail's), {stats.segments} segments, {stats.signals} with signal, "
        f"{stats.msamples_per_sec:.1f} Msamples/s ({stats.elapsed_s:.2f} s,"
        f" {wall:.2f} s with set-up), max_memory_allocated {peak} bytes "
        f"({peak / 1e9:.2f} GB); launches {counts}; card {card}")
    for rec in records:
        say(f"{label}: record " + json.dumps(rec))
    _check_launches(label, counts, DMSEARCH_LAUNCHES, stats.segments)
    if stats.segments != 2 or len(records) != 2 or \
            records[1]["best_dm"] != cfg.dm:
        fail(f"{label}: segment 1's best dm "
             f"{records[-1]['best_dm'] if records else None}, expected "
             f"{cfg.dm}")
    # the matched trial against the single-DM staged processor
    i = cfg.dm_list.index(cfg.dm)
    single = SegmentProcessor(cfg.replace(dm_list=[]))
    segs, pool = _segments_pinned(cfg.replace(input_file_path=str(data)))
    for k, seg in enumerate(segs):
        _wf, det = single.run_device(single.stage_input(seg.data))
        del _wf
        want = (int(det.signal_counts.sum()), int(det.zero_count.max()))
        got = (records[k]["signal_counts"][i], records[k]["zero_counts"][i])
        if got != want:
            fail(f"{label}: segment {k}'s trial {cfg.dm}: counts and zero "
                 f"count {got}, the single-DM staged processor's {want}")
    say(f"{label}: the {cfg.dm} trial's counts and zero counts equal the "
        f"single-DM staged processor's ({single.plan_name}) on both "
        "segments")
    del single
    free_card()
    # the trial loop under the sync check, and the peaks at 1 and 8 trials
    peaks = {}
    for trials in ((cfg.dm,), DM_TRIALS):
        dist = DistSegmentProcessor(cfg, dm_list=list(trials))
        sp = dist.processor
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        staged = sp.stage_input(segs[1].data)
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = dist.run_device(staged)
        except RuntimeError as e:
            fail(f"{label}: the trial loop synchronised with the card: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        peaks[len(trials)] = torch.cuda.max_memory_allocated()
        if len(trials) == len(DM_TRIALS):
            peak_snr = res.snr_peaks.reshape(len(trials), -1).amax(-1)
            if peak_snr.tolist() != records[1]["peak_snr"]:
                fail(f"{label}: the re-dispatch's peaks {peak_snr.tolist()}"
                     f", the run's {records[1]['peak_snr']}")
        del res, staged, dist, sp
        free_card()
    say(f"{label}: {len(DM_TRIALS)} trials dispatched under "
        "set_sync_debug_mode('error'): no synchronising call; peak memory "
        f"of one segment at n_dm = 1 {peaks[1]} bytes "
        f"({peaks[1] / 1e9:.2f} GB), at n_dm = {len(DM_TRIALS)} "
        f"{peaks[len(DM_TRIALS)]} bytes "
        f"({peaks[len(DM_TRIALS)] / 1e9:.2f} GB); card {card}")
    if peaks[len(DM_TRIALS)] > 1.05 * peaks[1]:
        fail(f"{label}: peak memory grows with the trials: {peaks}")
    breakdown = phase_breakdown_dmsearch(cfg, segs[1].data)
    for seg in segs:
        pool.release(seg.data)
    pool.free_all()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = PD.main([search.trials_path])
    for line in buf.getvalue().splitlines():
        say(f"{label}: plot-dm-curve: {line}")
    # the curve printed (no matplotlib), or the plot's path
    text = buf.getvalue()
    if rc != 0 or not ("<- best" in text or text.rstrip().endswith(".png")):
        fail(f"{label}: srtb-torch-plot-dm-curve returned {rc}: {text}")
    return {"counts": counts, "peaks": peaks, "breakdown": breakdown,
            "peak": peak, "msamples_per_s": stats.msamples_per_sec,
            "records": records}


# the a8a phase: B6's distributed legs at 2^29 complex points (the packed
# spectrum of a 2^30-sample segment), held to torch.fft within the
# reference's gate for its B6 legs (tests/test_dist_fft.py:
# test_dist_fft_pallas_legs, 2e-5 of the largest value); per segment of
# the DM search on the mesh: K1 once, B6 for each of the two legs, B3,
# K3 and K4 once a trial
A8A_FFT_LOG2 = 29
A8A_FFT_GATE = 2e-5
A8A_LAUNCHES = {"unpack_subbyte_window": 1, "fft_rows": 2,
                "dedisperse": len(DM_TRIALS), "sk_stats": len(DM_TRIALS),
                "sk_apply_timeseries": len(DM_TRIALS)}
A8A_ENV = {"SRTB_DIST_ROWS_IMPL": "pallas"}
A8A_PEAK_RTOL = 2e-4
# the phase's share of the script's clock (seconds)
A8A_BUDGET_S = 25.0


def a8a_dist_fft(card: str) -> dict:
    """``dist_fft`` over the world-1 seq mesh at 2^29 complex points with
    the ``pallas`` legs against ``torch.fft.fft`` on the same input: B6's
    launches, the error beside its gate, both times."""
    import torch
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.parallel import dist_fft as DF
    from srtb_tpu_torch.parallel import mesh as MM
    n = 1 << A8A_FFT_LOG2
    g = torch.Generator(device="cuda").manual_seed(1644)
    x = torch.randn(n, dtype=torch.complex64, device="cuda", generator=g)
    mesh = MM.seq_mesh(1)
    K.reset_launch_counts()
    y = DF.dist_fft(x, mesh, rows_impl="pallas")
    torch.cuda.synchronize()
    b6 = K.launch_counts()["fft_rows"]
    inventory = dict(mesh.inventory)
    want = torch.fft.fft(x)
    err = float((y - want).abs().max() / want.abs().max())
    del y, want
    ms = cuda_ms(lambda: DF.dist_fft(x, mesh, rows_impl="pallas"), 3)
    lib = cuda_ms(lambda: torch.fft.fft(x), 3)
    say(f"a8a dist_fft [2^{A8A_FFT_LOG2}] pallas legs: B6 launches {b6}, "
        f"max |err| / max |X| {err:.3e} (gate {A8A_FFT_GATE:g}), "
        f"{ms:.3f} ms, torch.fft.fft {lib:.3f} ms, collectives "
        f"{inventory}; card {card}")
    if b6 != 2 or not err <= A8A_FFT_GATE:
        fail(f"a8a dist_fft: B6 launches {b6} (2 expected), error {err:.3e}"
             f" against the gate {A8A_FFT_GATE:g}")
    del x
    return {"ms": ms, "torch_ms": lib, "err": err}


def phase_a8a(card: str, made: dict, dmsearch: dict) -> dict:
    """The distributed layer on the card (ROADMAP A8a): a world-1 NCCL
    group through ``distributed.initialize``; ``dist_fft`` at full size
    with B6's legs (:func:`a8a_dist_fft`); ``DMSearchPipeline`` on
    dmsearch_2^30's file and trials over the group's (1, 1) mesh with the
    ``pallas`` legs (the sharded step), its records equal to
    dmsearch_2^30's (best dm, counts and zero counts exactly, peaks
    within ``A8A_PEAK_RTOL``), the collective inventory counted on the
    NCCL group, the peak memory, one segment's chain re-dispatched under
    ``set_sync_debug_mode("error")`` and timed; the group destroyed
    after.  ``counts`` holds the pipeline run's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.parallel import distributed as D
    from srtb_tpu_torch.pipeline.runtime import DMSearchPipeline
    t0 = time.perf_counter()
    label = "a8a_2^30"
    out_dir = OUT_DIR / label
    cfg, _text = path_cfg(out_dir, DMSEARCH_EXTRA, LOG2_N, label)
    data = input_file(cfg, "dmsearch_2^30", made)
    cfg = cfg.replace(input_file_path=str(data))
    rendezvous = out_dir / "rendezvous"
    rendezvous.unlink(missing_ok=True)
    D.initialize(f"file://{rendezvous}", 1, 0)
    try:
        say(f"a8a: world {dist.get_world_size()} group on "
            f"{dist.get_backend()} ({torch.cuda.get_device_name()}) in "
            f"{time.perf_counter() - t0:.2f} s")
        if dist.get_backend() != "nccl":
            fail(f"a8a: backend {dist.get_backend()}, not nccl")
        fft = a8a_dist_fft(card)
        free_card()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fresh_telemetry()
        K.reset_launch_counts()
        with path_env(A8A_ENV):
            search = DMSearchPipeline(cfg)
        t1 = time.perf_counter()
        with search:
            stats = search.run()
        wall = time.perf_counter() - t1
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        proc = search.processor
        inventory = {f"{name} {','.join(ax)}": c
                     for (name, ax), c in sorted(proc.mesh.inventory.items())}
        with open(search.trials_path) as f:
            records = [json.loads(line) for line in f if line.strip()]
        say(f"{label}: mesh {proc.mesh.shape}, sharded {proc.sharded}, "
            f"legs {proc.rows_impl}, {stats.segments} segments in "
            f"{wall:.2f} s, max_memory_allocated {peak} bytes "
            f"({peak / 1e9:.2f} GB); collectives on the NCCL group "
            f"{inventory}; launches {counts}; card {card}")
        for rec in records:
            say(f"{label}: record " + json.dumps(rec))
        if not proc.sharded or proc.rows_impl != "pallas":
            fail(f"{label}: the sharded step with the pallas legs did not "
                 f"run (sharded {proc.sharded}, legs {proc.rows_impl})")
        _check_launches(label, counts, A8A_LAUNCHES, stats.segments)
        want_inv = {"all_to_all seq": 3, "ppermute seq": 2, "psum dm": 3,
                    "psum seq": 3}
        if inventory != {k: v * stats.segments for k, v in want_inv.items()}:
            fail(f"{label}: collectives {inventory}, expected "
                 f"{want_inv} a segment")
        want = dmsearch["records"]
        if len(records) != len(want):
            fail(f"{label}: {len(records)} records, dmsearch_2^30 wrote "
                 f"{len(want)}")
        worst = 0.0
        for got, exp in zip(records, want):
            for key in ("best_dm", "signal_counts", "zero_counts"):
                if got[key] != exp[key]:
                    fail(f"{label}: segment {got['segment']}'s {key} "
                         f"{got[key]}, dmsearch_2^30's {exp[key]}")
            g, e = np.asarray(got["peak_snr"]), np.asarray(exp["peak_snr"])
            worst = max(worst, float(np.max(
                np.abs(g - e) / np.maximum(np.abs(e), 1e-30))))
        if not worst <= A8A_PEAK_RTOL:
            fail(f"{label}: peak S/N {worst:.3e} relative from "
                 f"dmsearch_2^30's (gate {A8A_PEAK_RTOL:g})")
        say(f"{label}: records equal dmsearch_2^30's (best dm, counts and "
            f"zero counts exactly; peak S/N within {worst:.3e} relative, "
            f"gate {A8A_PEAK_RTOL:g})")
        # one segment again: its trials dispatched under the sync check,
        # then its chain timed
        segs, pool = _segments_pinned(cfg)
        with path_env(A8A_ENV):
            raw = search.processor.shard(segs[1].data)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = proc.run_device(raw)
            except RuntimeError as e:
                fail(f"{label}: the sharded trial loop synchronised with "
                     f"the card: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            peaks = res.snr_peaks.reshape(len(DM_TRIALS), -1).amax(-1)
            if peaks.tolist() != records[1]["peak_snr"]:
                fail(f"{label}: the re-dispatch's peaks {peaks.tolist()}, "
                     f"the run's {records[1]['peak_snr']}")
            del res
            chain = cuda_ms(lambda: proc.run_device(raw), 2)
        for seg in segs:
            pool.release(seg.data)
        pool.free_all()
        del raw, proc, search
    finally:
        D.shutdown()
    if dist.is_initialized():
        fail("a8a: the process group outlived the phase")
    free_card()
    took = time.perf_counter() - t0
    say(f"{label}: the trial loop dispatched under set_sync_debug_mode"
        f"('error'): no synchronising call; chain {chain:.3f} ms a segment "
        f"({len(DM_TRIALS)} trials); group destroyed; phase {took:.1f} s "
        f"(budget {A8A_BUDGET_S:g} s); card {card}")
    if took > A8A_BUDGET_S:
        say(f"{label}: the phase took {took:.1f} s, over its "
            f"{A8A_BUDGET_S:g} s share")
    return {"counts": counts, "fft": fft, "chain_ms": chain, "peak": peak,
            "seconds": took}


def phase_breakdown_dmsearch(cfg, pinned) -> dict:
    """One segment of the DM search by stage, CUDA events: the front once
    (K1, the R2C, stage 1 and the mask), then one trial's B3, waterfall
    C2C, K3 + verdict + K4 and detect, beside the trial loop (every
    trial) and the whole segment."""
    import torch
    from srtb_tpu_torch.kernels import sk as KS
    from srtb_tpu_torch.ops import detect as det
    from srtb_tpu_torch.ops import fft as F
    from srtb_tpu_torch.ops import rfi
    from srtb_tpu_torch.parallel.segment_dist import DistSegmentProcessor
    dist = DistSegmentProcessor(cfg)
    sp = dist.processor
    raw = sp.stage_input(pinned)
    ms = {}
    ms["K1 unpack"] = cuda_ms(lambda: sp._unpack(raw), 5)
    x = sp._unpack(raw)
    ms["R2C"] = cuda_ms(lambda: F.rfft_drop_nyquist(x), 3)
    spec = F.rfft_drop_nyquist(x)
    del x
    thr = cfg.mitigate_rfi_average_method_threshold
    ms["stage 1 + mask"] = cuda_ms(lambda: rfi.mitigate_rfi_manual(
        rfi.mitigate_rfi_average_and_normalize(spec, thr, sp.norm_coeff),
        dist.rfi_zap), 3)
    del spec
    front = cuda_ms(lambda: dist.front(raw), 3)
    clean = dist.front(raw)
    buf = torch.empty_like(clean)
    ms["B3 (one trial)"] = cuda_ms(lambda: dist.chirp(clean, cfg.dm, buf), 5)
    ms["waterfall C2C (one trial)"] = cuda_ms(
        lambda: F.waterfall_c2c(buf, sp.channel_count, sp.watfft_dewindow), 3)
    wf = F.waterfall_c2c(buf, sp.channel_count, sp.watfft_dewindow)[0]
    sk_thr = cfg.mitigate_rfi_spectral_kurtosis_threshold
    out = torch.empty_like(wf)
    ms["K3 + verdict + K4 (one trial)"] = cuda_ms(
        lambda: KS.sk_zap_timeseries(wf, sk_thr, out=out), 5)
    _o, zc, ts = KS.sk_zap_timeseries(wf, sk_thr, out=out)
    del wf, out, _o
    t = det.trimmed_length(sp.watfft_len, sp.time_reserved_count)
    ms["detect (one trial)"] = cuda_ms(lambda: det.detect_from_time_series(
        ts[None, :t], zc[None], cfg.signal_detect_signal_noise_threshold,
        cfg.signal_detect_max_boxcar_length), 5)

    def loop():
        for dm in dist.dm_list:
            sp._waterfall_detect(dist.chirp(clean, dm, buf))
    trial_loop = cuda_ms(loop, 2)
    whole = cuda_ms(lambda: dist.run_device(raw), 2)
    del clean, buf
    torch.cuda.empty_cache()
    return _breakdown_line("dmsearch_2^30", ms, whole, cfg, {
        "front_ms (as one)": front,
        f"trial_loop_ms ({len(dist.dm_list)} trials)": trial_loop,
        "trial_ms (loop / trials)": trial_loop / len(dist.dm_list)})


# the a8b phase: the fleet at fused_2^27's cfg, four streams of one
# tenant, each on its own 4-segment file (seed A8B_SEED + 10 i), the pulse
# in beam0's segment 2 only
A8B_STREAMS = tuple(f"j1644.beam{i}" for i in range(4))
A8B_SEGMENTS = 4
A8B_PULSE = 2
A8B_SEED = 2300
A8B_LAUNCHES = {"unpack_subbyte_planes_window": 1, "fft_rows": 2,
                "rfi_s1_dedisperse": 1, "fft_rows_skzap": 1}
# the batch former's leg: one family of four at a window of 4, so that
# every lane offers its four segments before its first drain and the
# family fills four times (no idle flush of a partial family), and a
# partial batch waits for its family rather than the default 2 ms linger
A8B_BATCH_WINDOW = 4
A8B_BATCH = (f"fleet_batch_max = 4\nfleet_batch_linger_ms = 1000\n"
             f"inflight_segments = {A8B_BATCH_WINDOW}\n")
# the card's fleet soak: the soak's own cfg (8-bit, 64 channels, every
# segment positive and dumped), at the slice's width of 2^27 samples a
# segment; its depth, A8B_SOAK_SEGMENTS a stream, is what the phase's
# budget cuts (each stream-segment dumps about 0.7 GB, in the solo
# goldens and in the fleet)
A8B_SOAK_LOG2N = 27
A8B_SOAK_SEGMENTS = 2
A8B_SOAK_PLAN = "stream0:dispatch:oom@1"
# the reference's documented vmap tolerance (tools/fleet_soak.py)
A8B_VMAP = "rtol 1e-5, atol 1e-4 max(|golden|, 1)"
# fused_2^27 alone at window 2 (PERF.md section 5), holding two of its
# waterfalls (complex64 [2^11, 2^15]); each further waterfall in flight
# adds one
A8B_SOLO_PEAK_GB = 7.35
# the phase's share of the script's clock (seconds)
A8B_BUDGET_S = 40.0


def _a8b_cfg(tag: str, extra: str):
    """fused_2^27's cfg lines plus ``extra`` for one stream, its outputs
    in a directory of its own."""
    return path_cfg(OUT_DIR / "a8b" / tag, PALLAS_27 + extra,
                    LOG2_N_ROWS, tag)


def _a8b_files(out_dir: Path) -> dict:
    """name -> SHA-256 of every candidate file under ``out_dir``."""
    import hashlib
    out = {}
    for p in sorted(out_dir.glob("out_*")):
        h = hashlib.sha256()
        with open(p, "rb") as f:
            while chunk := f.read(1 << 26):
                h.update(chunk)
        out[p.name] = h.hexdigest()
    return out


def _a8b_fleet(card: str, label: str, extra: str, data: dict,
               journals: bool) -> dict:
    """One fleet run of the four streams: its launches (counted only
    here), seconds, peak, lanes' positives and statistics, the plan
    cache's compiles and hits and the pool's size; then one dispatch of
    each leg again under ``set_sync_debug_mode("error")`` (a beam's solo
    dispatch, and with the former a formed batch of two).  ``engine_s``
    is the lanes' span, from the first lane's start (its pipeline built)
    to the last lane's end, as a solo run's ``elapsed_s`` covers its
    engine only; ``wall`` adds the fleet's construction and admission,
    as ``run_cli``'s wall adds a solo run's."""
    import torch
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.pipeline.fleet import (StreamFleet, StreamSpec,
                                               _BatchSlot)
    specs = []
    for name in A8B_STREAMS:
        jp = (f"telemetry_journal_path = {OUT_DIR / 'a8b' / label}_"
              f"{name}.jsonl\n" if journals else "")
        cfg, _text = _a8b_cfg(f"{label}_{name}",
                              extra + "fleet_devices = 2\n" + jp
                              + f"input_file_path = {data[name]}\n")
        specs.append(StreamSpec(name=name, cfg=cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fresh_telemetry()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    fleet = StreamFleet(specs)
    res = fleet.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    from srtb_tpu_torch.utils.metrics import metrics
    lanes = [fleet.lanes[n] for n in A8B_STREAMS]
    engine_s = (max(ln._t_start + ln.pipe.stats.elapsed_s for ln in lanes)
                - min(ln._t_start for ln in lanes))
    out = {"counts": counts, "wall": wall, "engine_s": engine_s,
           "peak": peak,
           "compiles": fleet.plans.compiles, "hits": fleet.plans.hits,
           "pool": len(fleet.pool),
           "batched_dispatches": int(metrics.get("batched_dispatches")),
           "batched_segments": int(metrics.get("batched_segments")),
           "dropped": int(metrics.get("segments_dropped")),
           "results": res}
    out["positives"] = {n: list(fleet.lanes[n].pipe.positive_segments)
                        for n in A8B_STREAMS}
    out["plans"] = {n: fleet.lanes[n].pipe.processor.plan_name
                    for n in A8B_STREAMS}
    for name, r in res.items():
        if r.status != "done":
            fail(f"{label}: stream {name} {r.status}: {r.error!r}")
        check_no_recovery(f"{label} {name}", r.stats)
    out["sync_check"] = _a8b_sync_check(fleet, _BatchSlot)
    fleet.close()
    return out


def _a8b_sync_check(fleet, slot_cls) -> str:
    """Dispatch beam0's first segment again through its lane (and with
    the former, beam0's and beam1's first segments as one formed batch)
    under ``set_sync_debug_mode("error")``: a synchronising call in the
    lane's or the former's dispatch raises."""
    import torch
    from srtb_tpu_torch.io.file_input import make_file_source
    from srtb_tpu_torch.utils.bufferpool import BufferPool
    lanes = [fleet.lanes[n] for n in A8B_STREAMS[:2]]
    pool = BufferPool("a8b dispatch check", pinned=True)
    segs = []
    for lane in lanes:
        src = make_file_source(lane.pipe.cfg, buffer_pool=pool)
        segs.append((next(iter(src)), src.logical_offset))
        src.close()
    former = fleet._former
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if former is None:
            items = [lanes[0]._dispatch(segs[0][0], 0.0, segs[0][1], 0)]
            what = "a lane's solo dispatch"
        else:
            slots = [slot_cls(lane, seg, 0.0, off, 0)
                     for lane, (seg, off) in zip(lanes, segs)]
            former._dispatch_shared(lanes[0].pipe.processor, slots)
            errs = [s.error for s in slots if s.error is not None]
            if errs:
                raise errs[0]
            items = [s.item for s in slots]
            if any(getattr(s.seg, "batch_size", None) != 2 for s in slots):
                fail("a8b: the checked dispatch was not a formed batch of 2")
            what = "a formed batch of 2"
    except RuntimeError as e:
        fail(f"a8b: the fleet's dispatch synchronised with the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for item in items:
        item.done.synchronize()
    del items
    for seg, _off in segs:
        pool.release(seg.data)
    pool.free_all()
    return what


def phase_a8b(card: str) -> dict:
    """The stream fleet on the card (ROADMAP A8b): the four streams' solo
    goldens, ``fleet_2^27``, ``fleet_batch_2^27`` and the card's
    ``fleet_soak`` with its selftest (see the module docstring, phase
    15).  Returns the fleet legs' launch counts by path (``counts``) and
    what the a8c phase reuses (``kept``): the four input files, the solo
    goldens' SHA-256 maps and directories, and the solo runs' engine and
    wall seconds; the fleet legs' outputs are deleted."""
    import shutil
    import torch
    from srtb_tpu_torch.tools import fleet_soak as FS
    t0 = time.perf_counter()
    root = OUT_DIR / "a8b"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    data, solo, solo_s, positives = {}, {}, {}, {}
    solo_engine_s, solo_wall = {}, {}
    for i, name in enumerate(A8B_STREAMS):
        cfg, text = _a8b_cfg(f"solo_{name}", "")
        data[name] = root / f"{name}.bin"
        make_input_file(cfg, data[name], A8B_SEGMENTS,
                        A8B_PULSE if i == 0 else None, A8B_SEED + 10 * i)
        stats, pipe, wall = run_cli(root / f"solo_{name}", text,
                                    data[name], {})
        solo[name] = _a8b_files(root / f"solo_{name}")
        solo_s[name] = stats.msamples_per_sec
        solo_engine_s[name] = stats.elapsed_s
        solo_wall[name] = wall
        positives[name] = list(pipe.positive_segments)
        del pipe
    n_seg = len(A8B_STREAMS) * A8B_SEGMENTS
    samples = n_seg * (1 << LOG2_N_ROWS)
    wf_gb = 8 * (1 << LOG2_CHANNELS) * (1 << 15) / 1e9
    reckoned = {
        "fleet_2^27": A8B_SOLO_PEAK_GB
        + (2 * len(A8B_STREAMS) - 2) * wf_gb,
        "fleet_batch_2^27": A8B_SOLO_PEAK_GB
        + (A8B_BATCH_WINDOW * len(A8B_STREAMS) - 2) * wf_gb}
    # the four solo runs back to back: their engines' seconds (elapsed_s),
    # and their walls with each run's construction
    b2b = samples / sum(solo_engine_s.values()) / 1e6
    b2b_wall = samples / sum(solo_wall.values()) / 1e6
    say(f"a8b: solo goldens {positives} positive, Msamples/s "
        f"{[round(x, 1) for x in solo_s.values()]}, back to back "
        f"{b2b:.1f} over their engines' {sum(solo_engine_s.values()):.3f} s"
        f" ({b2b_wall:.1f} over their walls' {sum(solo_wall.values()):.3f} "
        f"s with construction); reckoned peaks (GB) "
        f"{ {k: round(v, 2) for k, v in reckoned.items()} }: fused_2^27 "
        f"alone {A8B_SOLO_PEAK_GB} GB holding 2 waterfalls, plus "
        f"{wf_gb:.3f} GB for each further one in flight (4 lanes at "
        f"window 2; at window {A8B_BATCH_WINDOW}); card {card}")
    want_pos = {n: [A8B_PULSE] if i == 0 else []
                for i, n in enumerate(A8B_STREAMS)}
    if positives != want_pos:
        fail(f"a8b: solo positives {positives}, expected {want_pos}")
    legs = {}
    for label, extra in (("fleet_2^27", ""), ("fleet_batch_2^27",
                                              A8B_BATCH)):
        run = legs[label] = _a8b_fleet(card, label, extra, data,
                                       journals=label != "fleet_2^27")
        rate = samples / run["engine_s"] / 1e6
        per = {n: round(r.stats.msamples_per_sec, 1)
               for n, r in run["results"].items()}
        say(f"a8b {label}: {n_seg} stream-segments, {rate:.1f} Msamples/s "
            f"aggregate over the lanes' {run['engine_s']:.3f} s (the solo "
            f"runs back to back {b2b:.1f}); with construction "
            f"{samples / run['wall'] / 1e6:.1f} over {run['wall']:.3f} s "
            f"(back to back {b2b_wall:.1f}); per stream {per}; plan cache "
            f"{run['compiles']} compile(s), {run['hits']} hit(s); pool of "
            f"{run['pool']} member(s) for fleet_devices = 2 on "
            f"{torch.cuda.device_count()} card(s); peak {run['peak']} bytes "
            f"({run['peak'] / 1e9:.2f} GB, reckoned {reckoned[label]:.2f});"
            f" "
            f"positives {run['positives']}; launches {run['counts']}; "
            f"batched dispatches {run['batched_dispatches']} of "
            f"{run['batched_segments']} segments; re-dispatched "
            f"{run['sync_check']} under set_sync_debug_mode('error'): no "
            f"synchronising call; card {card}")
        if run["compiles"] != 1 or run["hits"] != len(A8B_STREAMS) - 1:
            fail(f"a8b {label}: plan cache {run['compiles']} compiles, "
                 f"{run['hits']} hits")
        plan = _main_path("fused_2^27")[3]
        if set(run["plans"].values()) != {plan}:
            fail(f"a8b {label}: plans {run['plans']}, expected {plan}")
        if run["positives"] != want_pos or run["dropped"]:
            fail(f"a8b {label}: positives {run['positives']}, dropped "
                 f"{run['dropped']}")
        if run["pool"] != min(2, torch.cuda.device_count()):
            fail(f"a8b {label}: a pool of {run['pool']} members")
        _check_launches(f"a8b {label}", run["counts"], A8B_LAUNCHES, n_seg)
    # fleet_2^27: every stream's candidates its solo run's by SHA-256
    for name in A8B_STREAMS:
        got = _a8b_files(root / f"fleet_2^27_{name}")
        if got != solo[name]:
            fail(f"a8b fleet_2^27 {name}: candidates {sorted(got)} differ "
                 f"from the solo run's {sorted(solo[name])}")
    say(f"a8b fleet_2^27: every stream's candidates equal its solo run's "
        f"by SHA-256 ({sum(len(v) for v in solo.values())} files)")
    # fleet_batch_2^27: the vmap contract, batch_size on every record
    batch = legs["fleet_batch_2^27"]
    sizes, recs = [], 0
    for name in A8B_STREAMS:
        why = FS.artifacts_close(
            str(root / f"solo_{name}"), str(root / f"fleet_batch_2^27_{name}"),
            solo[name], _a8b_files(root / f"fleet_batch_2^27_{name}"))
        if why is not None:
            fail(f"a8b fleet_batch_2^27 {name}: {why} ({A8B_VMAP})")
        for line in open(root / f"fleet_batch_2^27_{name}.jsonl"):
            rec = json.loads(line)
            recs += 1
            if "batch_size" not in rec or rec.get("device") != "dev0":
                fail(f"a8b fleet_batch_2^27 {name}: a record without "
                     f"batch_size or device: {rec}")
            sizes.append(rec["batch_size"])
    dispatches = round(sum(1 / b for b in sizes))
    exact = sum(solo[n] == _a8b_files(root / f"fleet_batch_2^27_{n}")
                for n in A8B_STREAMS)
    say(f"a8b fleet_batch_2^27: {recs} records, mean batch size "
        f"{sum(sizes) / len(sizes):.2f}, {dispatches} device dispatches for "
        f"{recs} segments ({batch['batched_dispatches']} formed batches), "
        f"launches a dispatch {json.dumps({k: v / dispatches for k, v in batch['counts'].items()})}; "
        f"candidates within the vmap contract ({A8B_VMAP}), {exact} of "
        f"{len(A8B_STREAMS)} streams bitwise; Msamples/s "
        f"{samples / batch['engine_s'] / 1e6:.1f} against fleet_2^27's "
        f"{samples / legs['fleet_2^27']['engine_s'] / 1e6:.1f} (over the "
        f"lanes' spans); card {card}")
    if recs != n_seg or 2 * dispatches > recs:
        fail(f"a8b fleet_batch_2^27: {dispatches} device dispatches for "
             f"{recs} records (at most half of {n_seg})")
    free_card()
    # the card's fleet soak and its selftest
    t1 = time.perf_counter()
    soak = FS.run_soak(streams=3, segments=A8B_SOAK_SEGMENTS,
                       log2n=A8B_SOAK_LOG2N,
                       plan=A8B_SOAK_PLAN, device="cuda",
                       tmpdir=str(root / "soak"))
    t2 = time.perf_counter()
    fails = FS.selftest(log2n=12, device="cuda")
    t3 = time.perf_counter()
    say(f"a8b fleet_soak --streams 3 --segments {A8B_SOAK_SEGMENTS} "
        f"--log2n {A8B_SOAK_LOG2N} --plan {A8B_SOAK_PLAN} --device cuda: gates "
        f"(a), (b), (c) passed, drained {soak['drained']}, dropped "
        f"{soak['dropped']}, {soak['plan_compiles']} compile, "
        f"{soak['plan_cache_hits']} hits, {t2 - t1:.1f} s; selftest "
        f"{'sharp' if not fails else fails}, {t3 - t2:.1f} s; card {card}")
    if not soak["ok"] or fails:
        fail(f"a8b fleet_soak: {soak}, selftest {fails}")
    # the inputs and the solo goldens stay for the a8c phase, which
    # deletes them
    for p in root.iterdir():
        if p.is_dir() and not p.name.startswith("solo_"):
            shutil.rmtree(p)
    free_card()
    took = time.perf_counter() - t0
    say(f"a8b: phase {took:.1f} s (budget {A8B_BUDGET_S:g} s); card {card}")
    if took > A8B_BUDGET_S:
        fail(f"a8b: the phase took {took:.1f} s, over its "
             f"{A8B_BUDGET_S:g} s budget")
    return {"counts": {label: {"counts": run["counts"]}
                       for label, run in legs.items()},
            "kept": {"data": data, "solo": solo, "root": root,
                     "solo_engine_s": solo_engine_s,
                     "solo_wall": solo_wall}}



# the a8c phase: the archive replay over a8b's four beam files (their solo
# goldens were written with deterministic timestamps, so each artifact's
# name is the archive's but for the prefix), at the archive's defaults
A8C_LANES = 2
A8C_MICRO_BATCH = 4
A8C_INFLIGHT = 8
# the archive's selftest at its defaults (4 segments a file, 2^13), its
# command line's argv (``python -m srtb_tpu_torch.tools.archive_replay``)
# through its ``main`` in this process; its children run on the card
A8C_SELFTEST = ("--selftest", "--device", "cuda")
# the race soak on the card at a small depth; its migration phase on the
# CPU's virtual pool (the card's machine has one card)
A8C_RACE = dict(streams=2, segments=3, log2n=16, seed=1, batch=2)
A8C_RACE_DEADLINE_S = 120.0
# the phase's share of the script's clock (seconds)
A8C_BUDGET_S = 60.0


def _a8c_status(card: str) -> None:
    """``fleet_status()`` right after the archive: the card's one member
    ``ok``, the four streams' segments; the viewer's ``/fleet`` answering
    200 with the same payload; ``console --url`` rendering it."""
    import contextlib
    import io
    import urllib.request
    from srtb_tpu_torch.gui.server import WaterfallHTTPServer
    from srtb_tpu_torch.obs.status import fleet_status
    from srtb_tpu_torch.tools import console
    status = fleet_status()
    devices, streams = status["devices"], status["streams"]
    if status["pool"]["members"] != 1 or \
            [d["state"] for d in devices.values()] != ["ok"]:
        fail(f"a8c fleet_status: pool {status['pool']}, devices {devices}")
    if {n: s.get("segments") for n, s in streams.items()} != \
            {n: A8B_SEGMENTS for n in A8B_STREAMS}:
        fail(f"a8c fleet_status: streams {streams}")
    server = WaterfallHTTPServer(str(OUT_DIR / "a8c"), port=0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/fleet", timeout=10) as r:
            code, ctype = r.status, r.headers.get("Content-Type", "")
            served = json.loads(r.read().decode())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = console.main(["--url", base, "--once"])
    finally:
        server.stop()
    frame = buf.getvalue()
    for key in ("devices", "pool", "streams", "batch"):
        if served[key] != status[key]:
            fail(f"a8c /fleet: {key} {served[key]} against fleet_status()'s "
                 f"{status[key]}")
    if code != 200 or ctype != "application/json" or rc != 0 or \
            "POOL  members=1" not in frame or "STREAMS" not in frame:
        fail(f"a8c /fleet {code} {ctype}, console rc {rc}:\n{frame}")
    say(f"a8c fleet_status: /fleet {code} ({ctype}), keys "
        f"{sorted(status)}; devices "
        f"{ {d: (v['state'], v['lanes']) for d, v in devices.items()} }; "
        f"streams {len(streams)} "
        f"{ {n: s.get('segments') for n, s in sorted(streams.items())} } "
        f"segments; batch {status['batch']}; console --url rc {rc}, "
        f"{len(frame.splitlines())} lines; card {card}")


def phase_a8c(card: str, kept: dict) -> dict:
    """The modules on the fleet on the card (ROADMAP A8c): ``archive_2^27``
    (the archive replay over a8b's four beam files, equal to their solo
    runs), the archive's selftest in a process of its own, the fleet's
    status through ``/fleet`` and the console, and the race soak (see the
    module docstring, phase 16).  Deletes a8b's kept files; returns the
    archive's launch counts by path."""
    import shutil
    import torch
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.pipeline.archive import ArchiveReplay
    from srtb_tpu_torch.tools import archive_replay as AR
    from srtb_tpu_torch.tools import race_soak as RS
    t0 = time.perf_counter()
    root = OUT_DIR / "a8c"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    # archive_2^27: the base cfg is fused_2^27's (each lane's prefix,
    # checkpoint, manifest and batch depth are the archive's)
    cfg, _text = path_cfg(root / "cfg", PALLAS_27, LOG2_N_ROWS,
                          "archive_2^27")
    files = [str(kept["data"][n]) for n in A8B_STREAMS]
    # the solo goldens under the archive's names (each lane's prefix is
    # its stream's name where the solo run's was "out_")
    golden = {f"{name}_{fname[len('out_'):]}": sha
              for name in A8B_STREAMS
              for fname, sha in kept["solo"][name].items()}
    n_seg = len(A8B_STREAMS) * A8B_SEGMENTS
    samples = n_seg * (1 << LOG2_N_ROWS)
    wf_gb = 8 * (1 << LOG2_CHANNELS) * (1 << 15) / 1e9
    reckoned = A8B_SOLO_PEAK_GB + (A8C_LANES * A8C_INFLIGHT - 2) * wf_gb
    out_dir = root / "archive"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fresh_telemetry()
    K.reset_launch_counts()
    rep = ArchiveReplay(cfg, files, str(out_dir), lanes=A8C_LANES,
                        micro_batch=A8C_MICRO_BATCH,
                        inflight=A8C_INFLIGHT).run()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    d = rep.as_dict()
    if d["plan_compiles"] != 1 or d["failed"] or \
            not d["drained"] == d["segments"] == n_seg:
        fail(f"a8c archive_2^27: report {d}")
    _check_launches("a8c archive_2^27", counts, A8B_LAUNCHES, n_seg)
    got = AR._sha_map(str(out_dir))
    if got != golden:
        fail(f"a8c archive_2^27 against the solo runs: only in the archive "
             f"{sorted(set(got) - set(golden))}, only in the solo runs "
             f"{sorted(set(golden) - set(got))}, differing by SHA-256 "
             f"{sorted(k for k in set(got) & set(golden) if got[k] != golden[k])}")
    b2b = samples / sum(kept["solo_engine_s"].values()) / 1e6
    b2b_wall = samples / sum(kept["solo_wall"].values()) / 1e6
    say(f"a8c archive_2^27: {len(files)} files, lanes {A8C_LANES}, "
        f"micro-batch {A8C_MICRO_BATCH}, in flight {A8C_INFLIGHT}: "
        f"drained {d['drained']} of {d['segments']} segments, failed "
        f"{d['failed']}, {d['plan_compiles']} plan compile(s), batched "
        f"dispatches {d['batched_dispatches']}; "
        f"{samples / rep.elapsed_s / 1e6:.1f} Msamples/s over the replay's "
        f"elapsed_s {rep.elapsed_s:.3f} s (the fleet's construction in it), "
        f"the solo runs back to back {b2b_wall:.1f} over their walls with "
        f"construction ({b2b:.1f} over their engines' seconds); peak "
        f"{peak} bytes ({peak / 1e9:.2f} GB, reckoned {reckoned:.2f}: "
        f"fused_2^27 alone {A8B_SOLO_PEAK_GB} GB holding 2 waterfalls, plus "
        f"{wf_gb:.3f} GB for each further one of {A8C_LANES} lanes x "
        f"{A8C_INFLIGHT} in flight); launches {counts}; artifacts equal the "
        f"solo runs' by name and SHA-256 ({len(got)} files, "
        f"{sum(k.endswith('.bin') for k in got)} raw dumps); card {card}")
    _a8c_status(card)
    t1 = time.perf_counter()
    fails = RS.selftest()
    if fails:
        fail(f"a8c race_soak --selftest: {fails}")
    t2 = time.perf_counter()
    # the race soak's and the selftest's temporary files under the phase's
    # directory, deleted with it
    import contextlib
    import io
    import tempfile
    tmp = root / "tmp"
    tmp.mkdir()
    saved, tempfile.tempdir = tempfile.tempdir, str(tmp)
    try:
        try:
            race = RS.run_race_soak(**A8C_RACE,
                                    deadline_s=A8C_RACE_DEADLINE_S,
                                    device="cuda", migrate_device="cpu")
        except AssertionError as e:
            fail(f"a8c race_2^16: {e}")
        t3 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = AR.main(list(A8C_SELFTEST))
    finally:
        tempfile.tempdir = saved
    t4 = time.perf_counter()
    lines = buf.getvalue().splitlines()
    report = None
    if lines and lines[-1].startswith("{"):
        report = json.loads(lines[-1])
    if rc != 0 or report is None or not report.get("ok") or \
            not report.get("killed_mid_run") or \
            report.get("batch_bitwise") != report.get("artifacts"):
        fail(f"a8c archive_selftest: rc {rc}, report {report}:\n"
             + "\n".join(lines[-30:]))
    say(f"a8c archive_selftest (archive_replay {' '.join(A8C_SELFTEST)}): "
        f"rc {rc}, SIGTERM landed with bb0 at "
        f"{report['bb0_segments_at_kill']} segments, resumed: "
        f"{report['artifacts']} artifacts of {report['segments']} segments "
        f"equal the streamed goldens by SHA-256, fsck clean, no orphan "
        f"temp; the micro-batched leg {report['batch_bitwise']} of "
        f"{report['artifacts']} bitwise; device {report['device']}; "
        f"{t4 - t3:.1f} s; card {card}")
    if not race["ok"] or race["perturbs"] <= 0 or \
            not race["device"].startswith("cuda"):
        fail(f"a8c race_2^16: {race}")
    say(f"a8c race_2^16: race_soak --selftest sharp (the inverted order "
        f"raised, the consistent order did not), {t2 - t1:.1f} s; "
        f"run_race_soak {json.dumps(A8C_RACE)} deadline "
        f"{A8C_RACE_DEADLINE_S:g} s on {race['device']}: fleet_soak gates "
        f"(a), (b), (c) passed, drained {race['drained']}, dropped "
        f"{race['dropped']}, {race['batched_dispatches']} formed batches, "
        f"{race['perturbs']} perturbations at {race['perturb_sites']}, the "
        f"journal replayed exactly; migrate phase device: "
        f"{race['migrate_device']}, {race['migrations']} migrations, "
        f"{race['migrate_device_drains']} drains; {t3 - t2:.1f} s; card "
        f"{card}")
    if race["migrate_device"] != "cpu (virtual pool)":
        fail(f"a8c race_2^16: migrate phase on {race['migrate_device']}")
    shutil.rmtree(root)
    shutil.rmtree(kept["root"])
    free_card()
    took = time.perf_counter() - t0
    say(f"a8c: phase {took:.1f} s (budget {A8C_BUDGET_S:g} s); card {card}")
    if took > A8C_BUDGET_S:
        fail(f"a8c: the phase took {took:.1f} s, over its "
             f"{A8C_BUDGET_S:g} s budget")
    return {"archive_2^27": {"counts": counts}}

def phase_correlator(card: str) -> dict:
    """correlator_2^30: two 8-bit files of 2^30 samples made on the card,
    the second the first delayed by CORR_LAG samples plus independent
    noise; ``srtb-torch-correlator`` on them (its ms by CUDA events
    beside its wall seconds), the peak at the lag's half and ``corr.bin``
    within CORR_RTOL of its largest value of a complex128 ``torch.fft``
    computation on the card."""
    import numpy as np
    import torch
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.tools import correlator as C
    label = "correlator_2^30"
    out_dir = OUT_DIR / label
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 1 << CORR_LOG2_N
    gen = torch.Generator(device="cuda").manual_seed(500)
    s = torch.randn(n + CORR_LAG, device="cuda", generator=gen) * 30.0

    def q(v):
        return torch.clamp(torch.round(v + 128.0), 0, 255).to(torch.uint8)
    x1 = q(s[CORR_LAG:])
    x2 = q(s[:n] + 10.0 * torch.randn(n, device="cuda", generator=gen))
    del s
    paths = [out_dir / name for name in ("pol_1.bin", "pol_2.bin",
                                         "corr.bin")]
    for x, p in zip((x1, x2), paths):
        x.cpu().numpy().tofile(p)
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: C.correlate_device(x1, x2), 3)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if C.main([str(p) for p in paths]) != 0:
        fail(f"{label}: srtb-torch-correlator failed")
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    got = np.fromfile(paths[2], dtype="<f4")
    if got.size != n // 2 or paths[2].stat().st_size != 2 * n:
        fail(f"{label}: corr.bin holds {got.size} values")
    # complex128 on the card, the same function
    f1 = torch.fft.rfft(x1.to(torch.float64))[:n // 2]
    f2 = torch.fft.rfft(x2.to(torch.float64))[:n // 2]
    del x1, x2
    want = torch.abs(torch.fft.ifft(float(n) ** -1.5 * f1 * torch.conj(f2),
                                    norm="forward"))
    del f1, f2
    got_d = torch.from_numpy(got).to("cuda", torch.float64)
    err = float((got_d - want).abs().max())
    top = float(want.max())
    peak_at = int(torch.argmax(got_d))
    del got_d, want
    torch.cuda.empty_cache()
    expect = (n - CORR_LAG) // 2
    say(f"{label}: corr.bin {got.size} float32 values, peak at index "
        f"{peak_at} (the second file delayed by {CORR_LAG} samples: "
        f"expected (n - lag) / 2 = {expect}, the lag's half counted back "
        f"from the end), max |corr - complex128| {err:.3e} of max "
        f"{top:.6e} ({err / top:.3e}); correlate on the card {ms:.3f} ms, "
        f"the command {wall:.2f} s (reads, writes), max_memory_allocated "
        f"{peak} bytes ({peak / 1e9:.2f} GB); launches {counts}; card "
        f"{card}")
    if abs(peak_at - expect) > 1:
        fail(f"{label}: peak at {peak_at}, expected {expect} +- 1")
    if not err <= CORR_RTOL * top:
        fail(f"{label}: corr.bin off the complex128 result by {err:.3e} "
             f"of {top:.3e}")
    for p in paths:
        p.unlink()
    return {"counts": counts, "ms": ms, "wall_s": wall, "peak": peak}


def check_same_candidates(staged: dict, quality: dict) -> None:
    """The quality epilogue changes nothing the search decides or writes:
    quality_2^30's decisions and candidate bytes are staged_2^30's."""
    a, b = staged["stats"], quality["stats"]
    if (a.segments, a.signals) != (b.segments, b.signals) or \
            staged["digests"] != quality["digests"]:
        fail(f"quality_2^30: decisions ({b.segments}, {b.signals}) or "
             f"candidate files {quality['digests']} differ from "
             f"staged_2^30's ({a.segments}, {a.signals}) "
             f"{staged['digests']}")
    say(f"quality_2^30: decisions and candidate bytes equal staged_2^30's "
        f"({sorted(quality['digests'])})")


# ------------------------------------------------------------------ A9d

# the threaded engine's paths: (label, the main path whose cfg it runs,
# the window phase's file (True) or the main path's two-segment one)
THREADED_PATHS = (("threaded_2^30", "staged_2^30", False),
                  ("threaded_2^27", "fused_2^27", True))
# the live harness at the cfg's geometry: real time, 2 segments (a depth
# cut from 4 for the script's clock: each costs 8.4 s at 1x), the pulse in
# the first, the deadline armed
E2E_LABEL = "e2e_live_2^30"
E2E_SEGMENTS = 2
E2E_PLAN = "staged:four_step"
E2E_LAUNCHES = {"unpack_subbyte_window": 1, "dedisperse": 1}
# the compiled-kernel cache's children: the fused_2^27 main path's cfg
AOT_PATH = "fused_2^27"
AOT_MARK = "AOT_RESULT "
# the sanitized fused_2^27 runs: serial and the defaults (a window of 2)
SANITIZE_SETTINGS = {"serial": "inflight_segments = 1\nwriter_thread_count "
                               "= 0\ningest_ring = off\n", "window2": ""}
# udp_soak: the pace (2x the 0.256 Gbps requirement) and the packets
SOAK_PACE_GBPS = 0.512
SOAK_PACKETS = 20000


def _file_digests(files: dict) -> dict:
    """The SHA-256 of each file of ``files`` (name -> path), by name."""
    return {name: file_sha256(Path(path)) for name, path in files.items()}


def _steady_record(ledger: Path) -> dict:
    """The perf ledger's one "steady" record of a run."""
    recs = [json.loads(line) for line in ledger.read_text().splitlines()]
    if len(recs) != 1 or recs[0].get("source") != "steady":
        fail(f"{ledger}: expected one steady record, got {recs}")
    return recs[0]


def a9d_threaded(card: str, window: dict, runs: dict) -> dict:
    """(a) ``ThreadedPipeline`` on staged_2^30's cfg and two-segment file
    and on fused_2^27's cfg and the window phase's 8-segment file: the
    plan, the positives, the launches a segment, no recovery, the
    candidate bytes equal by SHA-256 to the async engine's run of the same
    file (staged_2^30's main path; the window phase's first fused_2^27
    run), and the Msamples/s, peak and steady perf-ledger record."""
    import shutil
    import torch
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.pipeline.runtime import ThreadedPipeline
    counts = {}
    for label, main, windowed in THREADED_PATHS:
        _l, log2_n, extra, plan, per_segment, env = _main_path(main)
        out_dir = OUT_DIR / label
        ledger = out_dir / "ledger.jsonl"
        cfg, _text = path_cfg(out_dir, extra
                              + f"perf_ledger_path = {ledger}\n", log2_n,
                              label)
        if ledger.exists():
            ledger.unlink()
        if windowed:
            w = window[main]
            data, want_files = w["data"], w["first"]
            segments, positives = 8, [5]
            want = _file_digests(want_files)
        else:
            data, want = runs[main]["data"], runs[main]["digests"]
            segments, positives = 2, [1]
        cfg = cfg.replace(input_file_path=str(data))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fresh_telemetry()
        with path_env(env):
            pipe = ThreadedPipeline(cfg)
            K.reset_launch_counts()
            try:
                stats = pipe.run()
            finally:
                pipe.close()
        counts[label] = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        rec = _steady_record(ledger)
        say(f"a9d {label}: ThreadedPipeline, plan "
            f"{pipe.processor.plan_name}, {stats.segments} segments, "
            f"positive {pipe.positive_segments}, "
            f"{stats.msamples_per_sec:.1f} Msamples/s ({stats.elapsed_s:.3f}"
            f" s), max_memory_allocated {peak} bytes ({peak / 1e9:.2f} GB);"
            f" steady record {json.dumps(rec)}; card {card}")
        say(f"a9d {label}: engine " + json.dumps(
            {k: stats.extras[k] for k in ("engine", "stage_s",
                                          "dispatches")}))
        if pipe.processor.plan_name != plan:
            fail(f"{label}: plan {pipe.processor.plan_name}, expected {plan}")
        if stats.segments != segments or \
                pipe.positive_segments != positives:
            fail(f"{label}: {stats.segments} segments, positive "
                 f"{pipe.positive_segments}; expected {segments} and "
                 f"{positives}")
        check_no_recovery(label, stats)
        _check_launches(f"a9d {label}", counts[label], per_segment,
                        stats.segments)
        got = _file_digests(_candidate_files(pipe))
        if got != want:
            fail(f"{label}: candidate files {sorted(got)} differ by name or "
                 f"SHA-256 from the async engine's {sorted(want)}")
        say(f"a9d {label}: candidate bytes equal by SHA-256 to the async "
            f"engine's ({len(got)} files: {sorted(got)})")
        del pipe
        shutil.rmtree(out_dir)
        free_card()
    return counts


def a9d_e2e_live(card: str, runs: dict) -> dict:
    """(b) ``python -m srtb_tpu_torch.tools.e2e_live`` at 2^30 / 2^11, real
    time, ``E2E_SEGMENTS`` segments, the pulse in the first, /metrics served, the
    deadline armed: the run completes, the plan and the launches a
    segment are expected ones, the pulse's segment is positive, every
    packet slot is accounted (received + lost); its loss beside
    live_2^30's (the async engine, one port, the live phase)."""
    import shutil
    from srtb_tpu_torch.io import formats
    from srtb_tpu_torch.tools import e2e_live as E
    out_dir = OUT_DIR / "e2e_live"
    out_dir.mkdir(parents=True, exist_ok=True)
    line = out_dir / "e2e.jsonl"
    t0 = time.perf_counter()
    rc = E.main(["--log2n", str(LOG2_N), "--log2chan", str(LOG2_CHANNELS),
                 "--rate_x", "1.0", "--max_segments", str(E2E_SEGMENTS),
                 "--pulse_segments", "1", "--deadline_s", "120",
                 "--port", "0", "--prefix", f"{out_dir}/out_",
                 "--out", str(line)])
    wall = time.perf_counter() - t0
    rec = json.loads(line.read_text().splitlines()[-1])
    shown = {k: rec[k] for k in (
        "segments", "seconds", "vs_realtime_window", "vs_realtime_lifetime",
        "msamples_per_s_window", "packets_total", "packets_lost",
        "loss_rate", "signals", "positive_segments", "plan", "launches",
        "deadline_s", "card")}
    shown["metrics_http"] = {k: rec["metrics_http"].get(k) for k in (
        "segments", "packets_total", "packets_lost", "elapsed_s",
        "msamples_per_sec")}
    live_lost = runs.get("live_2^30", {}).get("lost")
    say(f"a9d {E2E_LABEL}: rc {rc}, {wall:.1f} s with set-up; "
        + json.dumps(shown) + f"; card {card}")
    say(f"a9d {E2E_LABEL}: packets lost {rec['packets_lost']} of "
        f"{rec['packets_total']} (ThreadedPipeline, the receive on its own "
        f"thread, no waterfall dumps) against live_2^30's {live_lost} (the "
        "async engine, the receive on the engine thread, the positive's "
        "4 GiB dump) in this run (ROADMAP P7; no gate)")
    fmt = formats.resolve("fastmb_roach2")
    slots = E2E_SEGMENTS * (1 << LOG2_N) * 2 // 8 // fmt.payload_bytes
    if rc != 0 or rec["segments"] != E2E_SEGMENTS:
        fail(f"{E2E_LABEL}: rc {rc}, {rec['segments']} segments")
    if rec["plan"] != E2E_PLAN:
        fail(f"{E2E_LABEL}: plan {rec['plan']}, expected {E2E_PLAN}")
    want = {k: v * E2E_SEGMENTS for k, v in E2E_LAUNCHES.items()}
    if rec["launches"] != want:
        fail(f"{E2E_LABEL}: launches {rec['launches']}, expected {want}")
    if 0 not in rec["positive_segments"]:
        fail(f"{E2E_LABEL}: the pulse's segment 0 is not positive "
             f"({rec['positive_segments']})")
    http = rec["metrics_http"]
    if not (rec["packets_total"] == slots == http["packets_total"]
            and 0 <= rec["packets_lost"] == http["packets_lost"] <= slots):
        fail(f"{E2E_LABEL}: packets_total {rec['packets_total']} (served "
             f"{http['packets_total']}), lost {rec['packets_lost']}: not "
             f"the {slots} slots of {E2E_SEGMENTS} segments, received + "
             "lost")
    say(f"a9d {E2E_LABEL}: packets_total {slots} = received "
        f"{slots - rec['packets_lost']} + lost {rec['packets_lost']}")
    shutil.rmtree(out_dir)
    free_card()
    from srtb_tpu_torch import kernels as K
    counts = dict.fromkeys(K.launch_counts(), 0)
    counts.update(rec["launches"])
    return {"counts": counts, "lost": rec["packets_lost"],
            "vs_realtime_window": rec["vs_realtime_window"]}


def _sync_debug_probe() -> dict:
    """Which calls ``set_sync_debug_mode("error")`` refuses on this card:
    an event's synchronize, a non-blocking copy into pinned memory, a
    blocking ``.cpu()``, ``.item()`` and ``torch.cuda.synchronize``."""
    import torch
    x = torch.ones(1 << 20, device="cuda")
    pinned = torch.empty(1 << 20, pin_memory=True)
    ev = torch.cuda.Event()
    calls = {
        "event.synchronize": lambda: (ev.record(), ev.synchronize()),
        "copy_(non_blocking) to pinned": lambda: pinned.copy_(
            x, non_blocking=True),
        "tensor.cpu()": lambda: x.cpu(),
        "tensor.item()": lambda: x[0].item(),
        "torch.cuda.synchronize()": torch.cuda.synchronize}
    out = {}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            out[name] = "allowed"
        except RuntimeError as e:
            out[name] = f"refused ({str(e).splitlines()[0][:60]})"
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def a9d_sanitize(card: str, window: dict) -> None:
    """(c) ``sanitize = 1`` on fused_2^27 over the window phase's file,
    serial and at window 2: candidate bytes the unsanitized run's, no
    trip; a NaN seeded in the chain raises ``SanitizerError`` naming its
    boundary, a sink's ``.cpu()`` of the device waterfall raises it too;
    after each scope nothing is patched and the sync-debug mode is off.
    Then the chain's ms sanitized against off, and which calls the
    sync-debug mode refuses."""
    import shutil
    import numpy as np
    import torch
    from srtb_tpu_torch.analysis import sanitizer as S
    from srtb_tpu_torch.io.writers import to_host
    from srtb_tpu_torch.pipeline import segment as SEG
    _l, log2_n, extra, plan, per_segment, env = _main_path("fused_2^27")
    w = window["fused_2^27"]
    for tag, setting in SANITIZE_SETTINGS.items():
        out_dir = OUT_DIR / f"sanitize_{tag}"
        cfg, _text = path_cfg(out_dir, extra + "sanitize = 1\n" + setting,
                              log2_n, f"sanitize {tag}")
        stats, pipe, _ = _run_pipeline(cfg, w["data"], env)
        say(f"a9d sanitize {tag}: {stats.segments} segments, positive "
            f"{pipe.positive_segments}, {stats.msamples_per_sec:.1f} "
            f"Msamples/s ({stats.elapsed_s:.3f} s); no trip; card {card}")
        if stats.segments != 8 or pipe.positive_segments != [5]:
            fail(f"sanitize {tag}: {stats.segments} segments, positive "
                 f"{pipe.positive_segments}")
        check_no_recovery(f"sanitize {tag}", stats)
        _same_candidates(f"sanitize {tag}", _candidate_files(pipe),
                         w["first"])
        if S.patched() or torch.cuda.get_sync_debug_mode():
            fail(f"sanitize {tag}: the scope left torch patched or the "
                 "sync-debug mode armed")
        say(f"a9d sanitize {tag}: candidate bytes equal the unsanitized "
            "run's; after the scope nothing patched, sync-debug mode 0")
        shutil.rmtree(out_dir)
    # the seeded trips, at window 2
    out_dir = OUT_DIR / "sanitize_trips"
    cfg, _text = path_cfg(out_dir, extra + "sanitize = 1\n", log2_n,
                          "sanitize trips")
    spectrum = SEG.SegmentProcessor._spectrum

    def nan_spectrum(self, raw):
        spec = spectrum(self, raw)
        # fill_ of a Python number enqueues a kernel; an indexed
        # assignment would copy a host scalar, a sync the armed dispatch
        # refuses first
        spec[0].narrow(0, 12345, 1).fill_(float("nan"))
        return spec

    class CpuSink:
        """A sink that reads the device waterfall back itself."""

        def push(self, work, positive):
            work.waterfall.cpu()

    trips = {"a NaN seeded after the spectrum": (
                 "stage_a boundary", lambda: setattr(
                     SEG.SegmentProcessor, "_spectrum", nan_spectrum),
                 None),
             "a sink's .cpu() of the device waterfall": (
                 "implicit device->host transfer", None,
                 lambda pipe: pipe.sinks.append(CpuSink()))}
    for what, (want, patch, setup) in trips.items():
        if patch is not None:
            patch()
        try:
            _run_pipeline(cfg, w["data"], env, setup)
            fail(f"sanitize: {what} did not trip the sanitizer")
        except S.SanitizerError as e:
            if want not in str(e):
                fail(f"sanitize: {what} raised {e!r}, not naming {want!r}")
            say(f"a9d sanitize: {what} raised SanitizerError: "
                f"{str(e)[:160]}")
        finally:
            SEG.SegmentProcessor._spectrum = spectrum
        if S.patched() or torch.cuda.get_sync_debug_mode():
            fail(f"sanitize: after {what} torch is patched or the "
                 "sync-debug mode armed")
        free_card()
    shutil.rmtree(out_dir)
    # the chain alone, sanitized against off, on the file's first segment
    raw = np.fromfile(w["data"], dtype=np.uint8,
                      count=cfg.segment_bytes(1))
    ms = {}
    for tag, on in (("off", False), ("sanitized", True),
                    ("off", False), ("sanitized", True)):
        with path_env(env):
            proc = SEG.SegmentProcessor(cfg.replace(sanitize=on))
        dev = torch.from_numpy(raw).cuda()
        ms.setdefault(tag, []).append(cuda_ms(
            lambda: to_host(proc.run_device(dev)[1].signal_counts), 5))
        del proc, dev
        free_card()
    probe = _sync_debug_probe()
    say(f"a9d sanitize: fused_2^27 chain ms (one segment, 5 reps, turns) "
        f"off {ms['off']}, sanitized {ms['sanitized']}; "
        f"set_sync_debug_mode('error') refuses: {json.dumps(probe)}; "
        f"card {card}")


def aot_child(argv: list) -> int:
    """``chip_smoke.py --aot-child CFG T_LAUNCH``: ``srtb-torch-main`` on
    the cfg (its ``aot_plan_path`` set); prints the cache's counters, the
    seconds from ``T_LAUNCH`` (the parent's clock at the launch) to the
    first segment's result and the candidate files."""
    cfg_path, t_launch = argv[0], float(argv[1])
    sys.path.insert(0, str(ROOT))
    from srtb_tpu_torch.pipeline import runtime as R
    from srtb_tpu_torch.tools import main as M
    from srtb_tpu_torch.utils.metrics import metrics
    first = []
    record = R.Pipeline._record_segment

    def stamped(self, *args, **kwargs):
        if not first:
            first.append(time.time())
        return record(self, *args, **kwargs)
    R.Pipeline._record_segment = stamped
    t_imported = time.time()
    stats, pipe = M.run(["--config_file_name", cfg_path])
    print(AOT_MARK + json.dumps({
        "aot_active": pipe.processor.aot_active,
        "hits": metrics.get("aot_cache_hits"),
        "misses": metrics.get("aot_cache_misses"),
        "plan_compiles": metrics.get("plan_compiles"),
        "compile_seconds": metrics.get("compile_seconds"),
        "import_s": t_imported - t_launch,
        "first_result_s": first[0] - t_launch,
        "segments": stats.segments,
        "positive": pipe.positive_segments,
        "files": _candidate_files(pipe)}), flush=True)
    return 0


def _aot_run(tag: str, cfg_text: str, data: Path, no_nvcc: bool) -> dict:
    """One child of the compiled-kernel cache's check (``no_nvcc``: with
    ``nvcc`` off its PATH and CUDA_HOME, so any build fails loudly)."""
    out_dir = OUT_DIR / f"aot_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("out_*"):
        old.unlink()
    cfg_path = out_dir / "smoke.cfg"
    cfg_path.write_text(cfg_text.replace(
        str(OUT_DIR / "aot") + "/out_", f"{out_dir}/out_")
        + f"input_file_path = {data}\n")
    env = dict(os.environ)
    if no_nvcc:
        env["PATH"] = os.pathsep.join(
            p for p in env.get("PATH", "").split(os.pathsep)
            if not os.path.exists(os.path.join(p, "nvcc")))
        env["CUDA_HOME"] = str(out_dir / "no_cuda_toolkit")
    t_launch = time.time()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--aot-child",
         str(cfg_path), repr(t_launch)], capture_output=True, text=True,
        env=env, timeout=600)
    lines = [x for x in proc.stdout.splitlines() if x.startswith(AOT_MARK)]
    if proc.returncode or not lines:
        fail(f"aot {tag}: child rc {proc.returncode}\n{proc.stdout[-3000:]}"
             f"\n{proc.stderr[-3000:]}")
    rec = json.loads(lines[-1][len(AOT_MARK):])
    rec["wall_s"] = time.time() - t_launch
    rec["digests"] = _file_digests(rec.pop("files"))
    return rec


def a9d_aot(card: str, runs: dict) -> None:
    """(d) The compiled-kernel cache: two children on one fresh
    ``aot_plan_path`` (fused_2^27's cfg and two-segment file): the cold
    one builds into it (a miss, ``compile_seconds``), the warm one, with
    ``nvcc`` unavailable, loads it (a hit, no new compile); then the entry
    corrupted: a miss and a rebuild.  The seconds from each child's launch
    to its first segment's result, and candidate bytes equal across the
    three."""
    import shutil
    aot_dir = OUT_DIR / "aot" / "cache"
    shutil.rmtree(OUT_DIR / "aot", ignore_errors=True)
    _l, log2_n, extra, plan, per_segment, env = _main_path(AOT_PATH)
    _cfg, text = path_cfg(OUT_DIR / "aot", extra
                          + f"aot_plan_path = {aot_dir}\n", log2_n, "aot")
    data = runs[AOT_PATH]["data"]
    cold = _aot_run("cold", text, data, no_nvcc=False)
    entries = sorted(aot_dir.glob("kernels.*.so"))
    warm = _aot_run("warm", text, data, no_nvcc=True)
    if len(entries) != 1:
        fail(f"aot: the cache holds {entries}, expected one entry")
    # a corrupt entry: the first 4 KiB of it, then garbage
    blob = entries[0].read_bytes()
    entries[0].write_bytes(blob[:4096] + b"\0garbage" * 64)
    corrupt = _aot_run("corrupt", text, data, no_nvcc=False)
    for tag, rec in (("cold", cold), ("warm", warm), ("corrupt", corrupt)):
        shown = {k: v for k, v in rec.items() if k != "digests"}
        say(f"aot {tag}: {json.dumps(shown)}; card {card}")
    if not (cold["aot_active"] and cold["misses"] == 1 and cold["hits"] == 0
            and cold["compile_seconds"] > 0 and cold["plan_compiles"] == 1):
        fail(f"aot cold: expected one miss and one timed build: {cold}")
    if not (warm["aot_active"] and warm["hits"] == 1 and warm["misses"] == 0
            and warm["plan_compiles"] == 0):
        fail(f"aot warm: expected one hit and no build: {warm}")
    if not (corrupt["misses"] == 1 and corrupt["hits"] == 0
            and corrupt["plan_compiles"] == 1):
        fail(f"aot corrupt: expected a miss and a rebuild: {corrupt}")
    if not (cold["digests"] == warm["digests"] == corrupt["digests"]
            and cold["positive"] == warm["positive"] == corrupt["positive"]
            == [1]):
        fail("aot: candidate bytes or positives differ across the children")
    say(f"aot: first segment's result {cold['first_result_s']:.2f} s after "
        f"launch cold (build {cold['compile_seconds']:.2f} s), "
        f"{warm['first_result_s']:.2f} s warm (nvcc unavailable, no build), "
        f"{corrupt['first_result_s']:.2f} s after a corrupt entry (rebuilt "
        f"in {corrupt['compile_seconds']:.2f} s); candidate bytes equal "
        f"across the three ({sorted(cold['digests'])}); card {card}")
    shutil.rmtree(OUT_DIR / "aot")
    for tag in ("cold", "warm", "corrupt"):
        shutil.rmtree(OUT_DIR / f"aot_{tag}")


def a9d_udp_soak(card: str) -> None:
    """(e) ``udp_soak``: the default receiver paced at 2x the 0.256 Gbps
    requirement (zero loss, at least 1.5x the requirement), the AF_PACKET
    ring where CAP_NET_RAW allows, and the unpaced ceiling (above 2x)."""
    from srtb_tpu_torch.tools import udp_soak as U
    paced = U.run_soak(SOAK_PACKETS, "auto", port=0,
                       pace_gbps=SOAK_PACE_GBPS)
    say(f"a9d udp_soak paced: {json.dumps(paced)}; card {card}")
    if paced["lost"] or paced["gbps"] < 1.5 * U.REQUIRED_GBPS:
        fail(f"udp_soak paced at {SOAK_PACE_GBPS} Gbps: lost "
             f"{paced['lost']}, {paced['gbps']} Gbps")
    try:
        ring = U.run_soak(SOAK_PACKETS, "packet_ring", port=0,
                          pace_gbps=SOAK_PACE_GBPS)
        say(f"a9d udp_soak packet_ring: {json.dumps(ring)}; card {card}")
    except (OSError, RuntimeError) as e:
        say(f"a9d udp_soak packet_ring: not run ({e!r}; the AF_PACKET "
            "ring needs CAP_NET_RAW)")
    ceiling = U.run_soak(SOAK_PACKETS, "auto", port=0)
    say(f"a9d udp_soak unpaced: {json.dumps(ceiling)}; card {card}")
    if ceiling["gbps"] <= 2 * U.REQUIRED_GBPS:
        fail(f"udp_soak unpaced: {ceiling['gbps']} Gbps, not above 2x "
             "the requirement")


def a9d_oracle(card: str) -> None:
    """(f) ``production_oracle`` at 2^27 / 2^11: ``ok`` (every error
    under the reference's gate); the host's RAM beside it."""
    from srtb_tpu_torch.tools import production_oracle as PO
    mem = {k: v.strip() for k, v in (
        line.split(":", 1) for line in
        Path("/proc/meminfo").read_text().splitlines()[:3])}
    out = OUT_DIR / "production_oracle_torch.json"
    t0 = time.perf_counter()
    rc = PO.main(["--log2n", str(LOG2_N_ROWS), "--log2chan",
                  str(LOG2_CHANNELS), "--out", str(out)])
    rec = json.loads(out.read_text())
    say(f"a9d production_oracle: rc {rc} in {time.perf_counter() - t0:.1f}"
        f" s; host memory {mem}; " + json.dumps(rec))
    if rc != 0 or not rec["ok"]:
        fail(f"production_oracle at 2^{LOG2_N_ROWS}: not ok: {rec}")
    out.unlink()
    free_card()


def phase_a9d(card: str, window: dict, runs: dict) -> dict:
    """ROADMAP A9d on the card: (a) the threaded engine, (b) the live
    harness, (c) the runtime sanitizer, (d) the compiled-kernel cache,
    (e) the UDP soak, (f) the float64 oracle.  Returns the launch counts
    of the threaded and live paths."""
    t = [time.perf_counter()]
    laps = {}

    def lap(what):
        laps[what] = round(time.perf_counter() - t[0], 1)
        t[0] = time.perf_counter()
    counts = a9d_threaded(card, window, runs)
    lap("a")
    e2e = a9d_e2e_live(card, runs)
    counts[E2E_LABEL] = e2e["counts"]
    lap("b")
    a9d_sanitize(card, window)
    lap("c")
    a9d_aot(card, runs)
    lap("d")
    a9d_udp_soak(card)
    lap("e")
    a9d_oracle(card)
    lap("f")
    say(f"a9d: seconds by part {json.dumps(laps)}; card {card}")
    return {"counts": counts}


# ------------------------------------------------ a9e: static analysis
# and the rollup store (ROADMAP A9e)

def a9e_lint(card: str) -> dict:
    """``python -m srtb_tpu_torch.tools.lint srtb_tpu_torch/`` with this
    machine's Python on the checkout (``--format json``): exit 0, 0 new
    findings, no stale baseline entry; the counts printed."""
    cmd = [sys.executable, "-m", "srtb_tpu_torch.tools.lint",
           "srtb_tpu_torch/", "--format", "json"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    doc = json.loads(proc.stdout) if proc.returncode in (0, 1) else {}
    counts = {k: len(doc.get(k, ())) for k in
              ("new", "accepted", "stale_baseline_keys")}
    by_rule: dict = {}
    for f in doc.get("accepted", ()):
        by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
    say(f"a9e lint: {' '.join(cmd[1:])}: rc {proc.returncode}, findings "
        f"{json.dumps(counts)}, baselined by rule "
        f"{json.dumps(by_rule, sort_keys=True)}; python "
        f"{sys.version.split()[0]}")
    if proc.returncode or counts["new"] or counts["stale_baseline_keys"]:
        fail(f"a9e lint: rc {proc.returncode}, {counts}:\n"
             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return counts


def a9e_rollup(card: str, journal: Path, events_path: Path) -> None:
    """The ``Aggregator`` over the observability phase's span journal and
    event dump (staged_2^30, armed): its segment counts equal the
    journal's, its p50/p99 of the per-segment seconds (the stage sums)
    within ``QuantileDigest``'s documented error of the exact order
    statistic at that rank (one order statistic of slack, as the
    reference's test allows); a second aggregator on the same store
    resumes and ingests nothing; ``rollup.main`` on the same files."""
    import math
    import shutil
    from srtb_tpu_torch.obs import rollup as RU
    from srtb_tpu_torch.obs.digest import QuantileDigest
    from srtb_tpu_torch.obs.store import RollupStore
    from srtb_tpu_torch.tools import telemetry_report as TR
    recs = TR.load(str(journal))
    store_dir = OUT_DIR / "a9e_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    agg = RU.Aggregator(RollupStore(str(store_dir)), journals=[str(journal)],
                        events_dumps=[str(events_path)])
    got = agg.poll()
    rows = agg.flush()
    state = RollupStore(str(store_dir)).latest()
    minutes = [r for r in state.values() if r["type"] == "rollup_minute"]
    by_plan: dict = {}
    for r in minutes:
        by_plan[r["plan"]] = by_plan.get(r["plan"], 0) + r["segments"]
    want_plan: dict = {}
    for r in recs:
        plan = str(r.get("active_plan") or "")
        want_plan[plan] = want_plan.get(plan, 0) + 1
    dig = QuantileDigest.from_dict(state["d:stage:segment"]["digest"])
    exact = sorted(sum((r.get("stages_ms") or {}).values()) for r in recs)
    errs = {}
    for name, q in (("p50", 0.50), ("p99", 0.99)):
        est = dig.quantile(q)
        rank = max(1, math.ceil(q * len(exact)))
        near = exact[max(0, rank - 2):rank + 1]
        errs[name] = (est, exact[rank - 1],
                      min(abs(est - x) / x for x in near))
    again = RU.Aggregator(RollupStore(str(store_dir)),
                          journals=[str(journal)]).poll()
    rc, text = _printed(RU.main, [str(journal), "--store",
                                  str(OUT_DIR / "a9e_store_cli"),
                                  "--events", str(events_path),
                                  "--compact"])
    (cli,) = _json_lines("a9e rollup main", text)
    say(f"a9e rollup: {got['spans']} spans, {got['events']} fleet events, "
        f"{rows} rows flushed; segments by plan {json.dumps(by_plan)} "
        f"against the journal's {json.dumps(want_plan)}; per-segment ms "
        + ", ".join(f"{k} {v[0]:.4f} (exact {v[1]:.4f}, rel err "
                    f"{v[2]:.2e})" for k, v in errs.items())
        + f" within alpha {dig.alpha}; resumed poll {json.dumps(again)}; "
        f"main rc {rc}; card {card}")
    if got["spans"] != len(recs) or by_plan != want_plan or \
            dig.count != len(recs) or \
            any(v[2] > dig.alpha + 1e-9 for v in errs.values()) or \
            again["spans"] != 0 or rc or cli["spans"] != len(recs):
        fail(f"a9e rollup: {got}, {by_plan} against {want_plan}, {errs}, "
             f"resumed {again}, main rc {rc} {cli}")
    shutil.rmtree(store_dir)
    shutil.rmtree(OUT_DIR / "a9e_store_cli")


def a9e_trace_join(card: str, journal: Path, events_path: Path) -> None:
    """``trace_join`` of the same files.  A single card's journal carries
    no ``device`` (the reference's journal names one only for a fleet's
    lanes), so the join gives one track, the host's; rendered with every
    journal segment mapped to the card (``cuda:0``, what a fleet of one
    would stamp) it gives one device track, ``device:cuda:0``, holding
    every stage event (events of no segment stay on the host's track).
    Both pass ``trace_export.validate``."""
    import torch
    from srtb_tpu_torch.obs import trace_join as TJ
    from srtb_tpu_torch.tools import telemetry_report as TR
    from srtb_tpu_torch.tools.trace_export import load_events, validate
    doc = TJ.join([str(events_path)], [str(journal)])
    label = str(torch.device("cuda", 0))
    mapping = {(str(r.get("stream") or ""), int(r["segment"])): label
               for r in TR.load(str(journal))}
    events = sorted(load_events(str(events_path)), key=lambda e: e["t"])
    mapped = TJ.render(events, mapping)

    def tracks(d):
        return sorted(e["args"]["name"] for e in d["traceEvents"]
                      if e.get("ph") == "M" and e["name"] == "process_name")

    pids = {e["args"]["name"]: e["pid"] for e in mapped["traceEvents"]
            if e.get("ph") == "M" and e["name"] == "process_name"}
    stages = [e for e in mapped["traceEvents"] if e.get("cat") == "stage"]
    on_card = [e for e in stages if e["pid"] == pids.get(f"device:{label}")]
    devices = [t for t in tracks(mapped) if t != TJ.HOST_TRACK]
    problems = validate(doc) + validate(mapped)
    say(f"a9e trace_join: {len(doc['traceEvents'])} events, tracks "
        f"{tracks(doc)} (the journal names no device); mapped to the card: "
        f"tracks {tracks(mapped)}, devices "
        f"{mapped['otherData']['devices']}, {len(on_card)} of "
        f"{len(stages)} stage events on it, stream_devices "
        f"{json.dumps(mapped['otherData']['stream_devices'])}; problems "
        f"{problems}; card {card}")
    if problems or tracks(doc) != [TJ.HOST_TRACK] or \
            devices != [f"device:{label}"] or not stages or \
            len(on_card) != len(stages):
        fail(f"a9e trace_join: tracks {tracks(doc)} / {tracks(mapped)}, "
             f"{len(on_card)} of {len(stages)} stages, {problems}")


def a9e_regression(card: str) -> dict:
    """``obs.regression --selftest`` on the card: the stalled side
    escalates one bundle and latches, the clean side none; every side's
    samples printed."""
    from srtb_tpu_torch.obs import regression as RW
    t0 = time.perf_counter()
    rc, text = _printed(RW.main, ["--selftest"])
    (st,) = _json_lines("a9e regression --selftest", text)
    say("a9e regression --selftest samples (ms): "
        f"{_sides_text(st.get('sides', {}))}")
    if rc or st.get("selftest") != "ok":
        fail(f"a9e regression --selftest: rc {rc}, {st}")
    say(f"a9e regression --selftest: plan {st['plan']}, stall "
        f"{st['stall_s']} s flagged (effect {st['stalled']['effect']:.4f}, "
        f"p {st['stalled']['p']:.3e}, bundles {st['bundles_stalled_leg']}); "
        f"clean effect {st['clean']['effect']:.4f}, floor "
        f"{st['clean']['noise_floor']:.4f}, p {st['clean']['p']:.3f}, "
        f"retried {st['clean']['retried']}, bundles "
        f"{st['bundles_clean_leg']}; {st['captures']} legs of "
        f"{st['segments']} segments a side; "
        f"{time.perf_counter() - t0:.1f} s; card {card}")
    return st


def phase_a9e(card: str) -> None:
    """ROADMAP A9e on the card: (a) the linter on the checkout, (b) the
    rollup aggregator over the observability phase's staged_2^30 span
    journal and event dump, (c) ``trace_join`` of the same files, (d) the
    regression watch's selftest."""
    t = [time.perf_counter()]
    laps = {}

    def lap(what):
        laps[what] = round(time.perf_counter() - t[0], 1)
        t[0] = time.perf_counter()
    obs_dir = OUT_DIR / "obs_staged_2^30"
    journal, events_path = obs_dir / "spans.jsonl", obs_dir / "events.jsonl"
    a9e_lint(card)
    lap("a")
    a9e_rollup(card, journal, events_path)
    lap("b")
    a9e_trace_join(card, journal, events_path)
    lap("c")
    a9e_regression(card)
    lap("d")
    say(f"a9e: seconds by part {json.dumps(laps)}; "
        f"{sum(laps.values()):.1f} s; card {card}")


def main() -> int:
    import shutil
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()

    def lap(what: str) -> None:
        say(f"time: {what} done {time.perf_counter() - t0:.1f} s "
            "into the script")

    card = phase_card()
    phase_build()
    lap("build")
    copy_gbps = phase_bandwidth()
    recs = phase_kernels(copy_gbps)
    lap("kernels")
    runs, breakdowns, made = {}, {}, {}
    def ffuse(run):
        staged = breakdowns["staged_2^30"]["stage_ms"]
        return phase_breakdown_ffuse(run, "ffuse_2^30", {
            "staged_2^30_front_ms (K1 + R2C + mean + K2)":
                sum(staged[k] for k in STAGED_FRONT),
            "staged_pallas2_2^30_chain_ms":
                breakdowns["staged_pallas2_2^30"]["chain_ms"]})

    def dualpol8_ffuse(run):
        return phase_breakdown_ffuse(run, "dualpol8_ffuse_2^30", {
            "ffuse_2^30_chain_ms (one 2-bit stream)":
                breakdowns["ffuse_2^30"]["chain_ms"],
            "dualpol_2^30_chain_ms": breakdowns["dualpol_2^30"]["chain_ms"]})
    breakdown_30 = {
        "staged_2^30": phase_breakdown,
        "quality_2^30": lambda run: phase_quality(run, card),
        "shipped_2^30": phase_breakdown_shipped,
        "staged_pallas2_2^30": phase_breakdown_staged_rows,
        "ffuse_2^30": ffuse,
        "dualpol_2^30": lambda run: phase_breakdown_dualpol(run, breakdowns),
        "dualpol8_ffuse_2^30": dualpol8_ffuse,
        "dualpol_pallas2_2^30":
            lambda run: phase_breakdown_dualpol_pallas2(run, breakdowns)}
    for label, log2_n, extra, plan, per_segment, env in MAIN_PATHS:
        runs[label] = phase_main_path(card, label, log2_n, extra, plan,
                                      per_segment, env, made)
        if log2_n == LOG2_N:
            breakdowns[label] = breakdown_30[label](runs[label])
            del runs[label]["pipe"]
            say(f"card memory after {label}: {free_card()}")
    check_same_candidates(runs["staged_2^30"], runs["quality_2^30"])
    fused = phase_breakdown_rows(runs["fused_2^27"], runs["unfused_2^27"])
    phase_breakdown_pallas2(runs["pallas2_2^27"], fused["chain_ms"])
    phase_breakdown_gznupsr(runs["gznupsr_2^27"], fused["chain_ms"])
    for run in runs.values():
        run.pop("pipe", None)
    free_card()
    lap("main paths and breakdowns")
    runs["periodicity_2^30"] = phase_periodicity(card)
    free_card()
    runs["dmsearch_2^30"] = phase_dmsearch(card, made)
    free_card()
    runs["a8a_2^30"] = phase_a8a(card, made, runs["dmsearch_2^30"])
    lap("a8a")
    a8b = phase_a8b(card)
    runs.update(a8b["counts"])
    lap("a8b")
    runs.update(phase_a8c(card, a8b["kept"]))
    lap("a8c")
    runs["correlator_2^30"] = phase_correlator(card)
    free_card()
    lap("search modes")
    window = phase_window(card)
    lap("window")
    batch = phase_batch(card, window, runs)
    for label, counts in batch["counts"].items():
        runs[label] = {"counts": counts}
    lap("batch")
    perf = phase_perf(card, recs, window, batch)
    runs.update({label: {"counts": counts}
                 for label, counts in perf["counts"].items()})
    lap("perf")
    phase_observability(card, window, made)
    lap("observability")
    runs["canary_2^30"] = {"counts": phase_health(card)["counts"]}
    lap("health")
    res = phase_resilience(card, window, runs, made)
    runs.update({label: {"counts": counts}
                 for label, counts in res["counts"].items()})
    lap("resilience")
    phase_durability(card)
    lap("durability")
    check_packet_ring(card)
    for label, log2_n, extra, segments, pulse, ports, per_segment \
            in LIVE_PATHS:
        runs[label] = phase_live_path(card, label, log2_n, extra, segments,
                                      pulse, ports, per_segment)
    lap("live")
    a9d = phase_a9d(card, window, runs)
    runs.update({label: {"counts": counts}
                 for label, counts in a9d["counts"].items()})
    # the window phase's fused_2^27 input and first run: every user done
    window["fused_2^27"]["data"].unlink()
    shutil.rmtree(OUT_DIR / "window_fused_2^27_0")
    lap("a9d")
    phase_a9e(card)
    lap("a9e")
    for rec in recs:
        by_path = {label: run["counts"][rec["name"]]
                   for label, run in runs.items()}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
    lap("all phases")
    print(card, flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--loopback-sender"]:
        sys.exit(loopback_sender(sys.argv[2:]))
    if sys.argv[1:2] == ["--sticky-child"]:
        sys.exit(sticky_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--sticky-soak"]:
        sys.exit(sticky_soak(sys.argv[2:]))
    if sys.argv[1:2] == ["--gate-round-soak"]:
        sys.exit(gate_round_soak(sys.argv[2:]))
    if sys.argv[1:2] == ["--gate-round-child"]:
        sys.exit(gate_round_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--aot-child"]:
        sys.exit(aot_child(sys.argv[2:]))
    sys.exit(main())
