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
   in the first; if packets are lost, again without the pulse) and
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
   nonzero exit, then resumed by a fresh process from its checkpoint to
   the output set of an uninterrupted run (SHA-256); (d) a kernel build
   fault at ffuse_2^30's first fetch, which takes the front_fuse rung
   (B11 and B12 before it, K1, B9, B10 and K2 after it), transient faults
   at four sites retried (``retries_total`` 4, the clean run's bytes), a
   chain wedged behind a spin on the compute stream requeued once by the
   watchdog (an injected fetch stall requeues nothing); and fused_2^27
   with every layer off and armed, ten pairs in turns.  Every other run of the
   script must have needed no demotion, reinit, retry or requeue.

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
    K2.twiddle.cache_clear()
    F._hermitian_weights.cache_clear()
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


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_summary(trace: Path, top: int = 6, names: dict | None = None
                  ) -> dict:
    """From a ``torch.profiler`` chrome trace: the traced window (first to
    last event), the device's busy share (the union of its kernels,
    copies and sets over the window) and idle share, the longest idle
    gaps each with the host frames that held it (the ``srtb:`` labels and
    the innermost host operation open at the gap's middle, by thread),
    the device operations with the most time, and the host's labelled
    seconds by stage and thread (``names`` names threads by id)."""
    names = names or {}
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in events
                 if e.get("cat") in DEVICE_CATEGORIES)
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


def profile_batch(card: str, label: str, data: Path, b: int) -> dict:
    """``torch.profiler`` (CPU and CUDA activity, every thread where this
    torch can: the sink thread's too) over a whole run of ``label`` on
    ``data`` at B = ``b`` (window max(2, b)), its chrome trace under
    ``build/chip_smoke/``, and :func:`trace_summary`."""
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
        out[f"profile_b{b}"] = profile_batch(card, "fused_2^27", data, b)
        free_card()
    return out


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
    (WHERE ``chain``, the default) or by the sink thread at push
    ``INJECT``, which then waits on the card (``sink``); ``INJECT`` < 0:
    none, a plain resume.  Prints the outcome after ``STICKY_MARK`` and
    exits 1 when the run raised."""
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

    if where == "chain":
        run_device = S.SegmentProcessor._chain

        def asserting_run_device(self, raw):
            calls[0] += 1
            if calls[0] == inject + 1:
                device_assert(raw.device)
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
    try:
        stats = pipe.run()
        out["segments"] = stats.segments
    except BaseException as e:  # noqa: BLE001 - reported
        cause = e.__cause__ or e
        out.update(error=type(e).__name__, cause=type(cause).__name__,
                   kind=E.classify_device(cause),
                   message=str(cause).splitlines()[0][:200])
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
    if not lines and decisions and decisions[-1] == "halt budget spent" \
            and proc.returncode:
        # torch aborted the process after the escalation was decided (it
        # frees pinned results from a destructor, which raises on a dead
        # context): the decisions tell the run's end
        return {"error": "ReinitBudgetExceeded", "cause": "AcceleratorError",
                "kind": "halt", "decisions": decisions,
                "aborted_after_escalation": True, "rc": proc.returncode,
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
                rc=proc.returncode, decisions=decisions)


def _log_tail(cfg_path: Path, inject: int, n: int = 1500) -> str:
    """The end of a sticky child's log (``_sticky_run`` wrote it), for a
    failure's message."""
    log = cfg_path.parent.parent / f"{cfg_path.parent.name}_{inject}.log"
    return log.read_text()[-n:] if log.exists() else "(no log)"


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
    import dataclasses
    import shutil
    from srtb_tpu_torch.config import Config
    from srtb_tpu_torch.tools import crash_soak as CRS
    _l, log2_n, extra, _plan, _per, env = _main_path("fused_2^27")
    root = OUT_DIR / "resilience_sticky"
    if root.exists():
        shutil.rmtree(root)
    cfg, _text = path_cfg(root / "cfg", extra, log2_n, "resilience_sticky")
    data = root / "input.bin"
    make_input_file(cfg, data, DURABILITY_SEGMENTS, DURABILITY_PULSES)
    out = {}
    for tag in ("golden",) + tuple(STICKY_AT):
        d = root / tag
        d.mkdir()
        fields = dataclasses.asdict(cfg.replace(
            input_file_path=str(data),
            baseband_output_file_prefix=f"{d}/out_",
            checkpoint_path=str(d / "ck.json"),
            run_manifest_path=str(d / "manifest.jsonl")))
        (d / "cfg.json").write_text(json.dumps(fields))
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
ARMED_PAIRS = 10


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
OBS_PAIRS = 4


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
    trace = out_dir / "profile" / "trace.json"
    tevs = json.loads(trace.read_text())["traceEvents"]
    device = sum(1 for e in tevs if e.get("cat") in DEVICE_CATEGORIES)
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


def phase_resilience(card: str, window: dict, runs: dict, made: dict
                     ) -> dict:
    """The resilience layers on the card (ROADMAP A7): (a) the injected
    ladder walk and the chaos soak, (b) a real out-of-memory recovered by
    demotion, (c) a real sticky fault escalated and resumed in a new
    process, (d) the front-fuse rung, the retries and the watchdog, then
    every layer armed against every layer off.  Returns the launch counts
    by run and the numbers."""
    import shutil
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
    w = window["fused_2^27"]
    w["data"].unlink()
    shutil.rmtree(OUT_DIR / "window_fused_2^27_0")
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
            "peak": peak, "msamples_per_s": stats.msamples_per_sec}


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


def main() -> int:
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
    runs["correlator_2^30"] = phase_correlator(card)
    free_card()
    lap("search modes")
    window = phase_window(card)
    lap("window")
    batch = phase_batch(card, window, runs)
    for label, counts in batch["counts"].items():
        runs[label] = {"counts": counts}
    lap("batch")
    phase_observability(card, window, made)
    lap("observability")
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
        if runs[label]["lost"]:
            # where the loss comes from: the same stream without the
            # pulse, so without the positive's waterfall dump in the sink
            say(f"live {label}: packets lost; again without the pulse")
            phase_live_path(card, f"{label}_no_pulse", log2_n, extra,
                            segments, None, ports, per_segment)
    lap("live")
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
    sys.exit(main())
