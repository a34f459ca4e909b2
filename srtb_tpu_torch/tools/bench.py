"""Benchmark: sustained coherent-dedispersion throughput of the port on
one card, in the J1644-4559 configuration (2-bit samples, 128 MSa/s,
|DM| = 478.80, inverted 64 MHz band — ref: srtb_config_1644-4559.cfg);
the twin of the JAX package's ``bench.py``.

Prints ONE JSON line:
  {"metric": ..., "value": Msamples/s, "unit": ..., "vs_baseline": x, ...}
where ``vs_baseline`` is the real-time factor against the 128 MSa/s
baseband rate, with the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them
(``card``).  The segment's bytes live on the device and every rep runs
the processor's chain on them (``SegmentProcessor.run_device``); with
``--overlap on`` (default) the reps are enqueued back to back and synced
once, with ``off`` each rep ends in a sync.

Extra fields (the reference's roofline model):
  model_gflops      — FFT-dominated FLOP count of one segment / 1e9
  achieved_gflops_s — model_gflops / measured time
  model_hbm_gb      — the plan's HBM bytes a segment (the input read and
                      ``hbm_passes`` spectrum-sized sweeps) / 1e9
  achieved_gbps     — model_hbm_gb / measured time
  roofline_frac     — achieved_gbps / the card's HBM peak: 3350 GB/s for
                      the H100 80GB HBM3 (on the card only)

There is no CPU fallback: without a card, and without ``--device cpu``,
the tool prints one ``error`` line and exits non-zero; every failure
does.  Knobs (environment, as the reference's): ``SRTB_BENCH_LOG2N``
(27), ``_LOG2CHAN`` (11), ``_DM`` (-478.80), ``_FFT_STRATEGY`` (auto),
``_USE_PALLAS``, ``_USE_PALLAS_SK`` (0), ``_STAGED`` ("" auto, 0, 1),
``_FUSED_TAIL``, ``_FRONT_FUSE`` (auto), ``_RING`` (none), ``_REPS`` (5),
``_SEARCH_MODE`` (single_pulse), ``_TRACE_DIR`` (a torch.profiler trace
of one steady-state segment), and ``SRTB_PERF_LEDGER`` / ``--ledger``
(append the run to a perf ledger).  ``SRTB_BENCH_AOT_DIR`` is the AOT
leg: the compiled-kernel cache (``aot_plan_path``) at that directory, so
that run twice the second run's ``compile_s`` is the warm restart's (its
timer starts before the processor's construction, where the cache builds
or loads the kernel library; the line says ``aot_active`` and the
cache's hit and miss counts).  The fleet leg (``--fleet-batch``) waits
for ROADMAP A8; ``SRTB_BENCH_AUDIT`` (the JAX package's HLO plan
auditor) is not ported (A9e).

Usage: python -m srtb_tpu_torch.tools.bench [--overlap on|off]
           [--fused-tail auto|on|off] [--front-fuse auto|on|off]
           [--ring on|off|none] [--ledger L.jsonl] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# the H100 SXM's HBM3 (NVIDIA data sheet): the roof of the roofline
H100_HBM_PEAK_GBPS = 3350.0
REALTIME_SAMPLES_PER_S = 128e6
METRIC = "coherent_dedispersion_pipeline_throughput"
UNIT = "Msamples/s/card"


def emit(obj) -> None:
    print(json.dumps(obj))
    sys.stdout.flush()


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (None when it cannot say)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def roofline_model(n: int, channel_count: int, nbits: int,
                   hbm_passes: int = 7):
    """Static FLOP / HBM-byte model of one segment (the reference's):
    FFT work (5 m log2 m per length-m complex FFT, m = n/2 packed C2C)
    of the segment R2C and the per-channel backward C2C, elementwise
    stages at ~30 flops/bin; HBM bytes: the input read plus
    ``hbm_passes`` spectrum-sized sweeps, the plan's own floor
    (``SegmentProcessor.hbm_passes``)."""
    m = n // 2
    wlen = max(m // channel_count, 1)
    flops = 5.0 * m * math.log2(max(m, 2)) \
        + 5.0 * m * math.log2(max(wlen, 2)) \
        + 30.0 * m
    input_bytes = n * abs(nbits) / 8.0
    spectrum_bytes = 8.0 * m  # complex64
    bytes_moved = input_bytes + spectrum_bytes * hbm_passes
    return flops, bytes_moved


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--overlap", choices=("on", "off"), default="on")
    p.add_argument("--fused-tail", choices=("auto", "on", "off"),
                   default=os.environ.get("SRTB_BENCH_FUSED_TAIL", "auto"))
    p.add_argument("--front-fuse", choices=("auto", "on", "off"),
                   default=os.environ.get("SRTB_BENCH_FRONT_FUSE",
                                          "auto"))
    # the ingest ring legs: "on" uploads each warm rep's stride behind
    # the device-resident carry, "off" the whole segment a rep, "none"
    # (default) keeps the segment on the device (no upload a rep)
    p.add_argument("--ring", choices=("on", "off", "none"),
                   default=os.environ.get("SRTB_BENCH_RING", "none"))
    p.add_argument("--fleet-batch", choices=("none", "on", "off"),
                   default=os.environ.get("SRTB_BENCH_FLEET_BATCH",
                                          "none"))
    p.add_argument("--ledger",
                   default=os.environ.get("SRTB_PERF_LEDGER", ""))
    p.add_argument("--device", default=None,
                   help="default: the card; cpu runs the plain versions")
    return p.parse_args(argv)


def check_unported(args) -> None:
    """Raise for the knobs of later slices."""
    if args.fleet_batch != "none":
        raise NotImplementedError(
            "--fleet-batch is not ported yet (ROADMAP A8: the fleet)")
    if int(os.environ.get("SRTB_BENCH_AUDIT", "0") or 0):
        raise NotImplementedError(
            "SRTB_BENCH_AUDIT is the JAX package's HLO plan auditor, "
            "which is not ported (ROADMAP A9e)")


def bench_config(n: int, channels: int, fused_tail: str, front_fuse: str,
                 ring: str):
    from srtb_tpu_torch.config import Config
    return Config(
        baseband_input_count=n,
        baseband_input_bits=2,
        baseband_format_type="simple",
        baseband_freq_low=1405.0 + 32.0,
        baseband_bandwidth=-64.0,
        baseband_sample_rate=128e6,
        dm=float(os.environ.get("SRTB_BENCH_DM", "-478.80")),
        spectrum_channel_count=channels,
        mitigate_rfi_average_method_threshold=1.5,
        mitigate_rfi_spectral_kurtosis_threshold=1.05,
        signal_detect_signal_noise_threshold=8.0,
        signal_detect_max_boxcar_length=256,
        mitigate_rfi_freq_list="1418-1422",
        # the ring legs reserve the dedispersion tail (overlap-save);
        # the headline path keeps the reserve off, as the reference's
        baseband_reserve_sample=(ring != "none"),
        ingest_ring=("on" if ring == "on" else "off"),
        fft_strategy=os.environ.get("SRTB_BENCH_FFT_STRATEGY", "auto"),
        use_pallas=bool(int(os.environ.get("SRTB_BENCH_USE_PALLAS", "0"))),
        use_pallas_sk=bool(int(os.environ.get("SRTB_BENCH_USE_PALLAS_SK",
                                              "0"))),
        fused_tail=fused_tail,
        front_fuse=front_fuse,
        # the AOT leg: the compiled-kernel cache at this directory
        aot_plan_path=os.environ.get("SRTB_BENCH_AOT_DIR", ""),
        search_mode=os.environ.get("SRTB_BENCH_SEARCH_MODE",
                                   "single_pulse"),
    )


def run_bench(device, overlap: str = "on", fused_tail: str = "auto",
              ring: str = "none", ledger: str = "",
              front_fuse: str = "auto") -> dict:
    import torch
    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.pipeline import registry
    from srtb_tpu_torch.utils.metrics import metrics
    from srtb_tpu_torch.utils.perf_ledger import device_name

    on_card = device.type == "cuda"
    n = 1 << int(os.environ.get("SRTB_BENCH_LOG2N", "27"))
    channels = 1 << int(os.environ.get("SRTB_BENCH_LOG2CHAN", "11"))
    cfg = bench_config(n, channels, fused_tail, front_fuse, ring)
    staged_env = os.environ.get("SRTB_BENCH_STAGED", "")
    # the segment's bytes, made and uploaded before any timer
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=cfg.segment_bytes(1), dtype=np.uint8)
    raw_host = torch.from_numpy(raw)
    if on_card and ring != "none":
        raw_host = raw_host.pin_memory()  # the upload legs' source
    raw_dev = raw_host.to(device)

    def sync(res) -> None:
        # a host read of the (tiny) counts: an errored launch surfaces
        # here, not as a time of ~0
        res.signal_counts.cpu()

    cache0 = {k: metrics.get(k) for k in
              ("aot_cache_hits", "aot_cache_misses", "plan_compiles")}
    t0 = time.perf_counter()
    proc = registry.build_processor(
        cfg, device=device,
        staged=None if staged_env == "" else bool(int(staged_env)))
    # with the compiled-kernel cache engaged the build (or its load) ran
    # in the construction: compile_s starts before it then
    t_first = t0 if proc.aot_active else time.perf_counter()
    # warm-up: the first dispatch builds the kernels (nvcc at the
    # process's first launch) and the cuFFT plans; the ring legs warm
    # both of their steps
    host = raw_host.numpy()
    if ring == "on":
        dev = proc.stage_input(host)
        (wf, res), carry = proc.run_device_ring(dev, warm=False)
        sync(res)
        (wf, res), carry = proc.run_device_ring(
            proc.stage_input(host, carry), warm=True)
        sync(res)
        del carry
    else:
        wf, res = proc.run_device(raw_dev)
        sync(res)
    compile_s = time.perf_counter() - t_first
    compile_ms = (time.perf_counter() - t0) * 1e3
    cache = {k: int(metrics.get(k) - v) for k, v in cache0.items()}
    del wf, res

    trace_dir = os.environ.get("SRTB_BENCH_TRACE_DIR", "")
    if trace_dir:
        from srtb_tpu_torch.utils.tracing import device_trace
        with device_trace(trace_dir):
            wf, res = proc.run_device(raw_dev)
            sync(res)
            del wf, res

    reps = int(os.environ.get("SRTB_BENCH_REPS", "5"))
    h2d_host_s = 0.0
    h2d_bytes0 = proc.h2d_bytes
    K.reset_launch_counts()
    if on_card:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    last = carry = None
    rep_seconds = []  # per-rep wall: real segment times with overlap
    # off (each rep ends in a sync), dispatch-issue times with it on
    for _ in range(reps):
        t_rep = time.perf_counter()
        if ring == "none":
            wf, res = proc.run_device(raw_dev)
        else:
            th = time.perf_counter()
            dev = proc.stage_input(host, carry if ring == "on" else None)
            h2d_host_s += time.perf_counter() - th
            if ring == "on":
                (wf, res), carry = proc.run_device_ring(
                    dev, warm=carry is not None)
            else:
                wf, res = proc.run_device(dev)
        last = res
        del wf
        if overlap == "off":
            sync(last)
        rep_seconds.append(round(time.perf_counter() - t_rep, 5))
    sync(last)
    dt = (time.perf_counter() - t0) / reps
    launches = {k: v for k, v in K.launch_counts().items() if v}
    del last, carry

    samples_per_sec = n / dt
    realtime_factor = samples_per_sec / REALTIME_SAMPLES_PER_S
    flops, bytes_moved = roofline_model(n, channels,
                                        cfg.baseband_input_bits,
                                        hbm_passes=proc.hbm_passes)
    out = {
        "metric": METRIC,
        "value": round(samples_per_sec / 1e6, 2),
        "unit": UNIT,
        "vs_baseline": round(realtime_factor, 3),
        "platform": device.type,
        "device": device_name(device),
        "card": card_line() if on_card else None,
        "log2n": int(math.log2(n)),
        "segment_time_s": round(dt, 5),
        "compile_s": round(compile_s, 2),
        "compile_ms": round(compile_ms, 1),
        "aot_cache_hits": cache["aot_cache_hits"],
        "aot_cache_misses": cache["aot_cache_misses"],
        "plan_compiles": cache["plan_compiles"],
        "rep_seconds": rep_seconds,
        "model_gflops": round(flops / 1e9, 1),
        "achieved_gflops_s": round(flops / dt / 1e9, 1),
        "model_hbm_gb": round(bytes_moved / 1e9, 3),
        "achieved_gbps": round(bytes_moved / dt / 1e9, 1),
        "overlap": overlap,
        "plan": proc.plan_name,
        "hbm_passes": proc.hbm_passes,
        "fused_tail": "on" if proc.fused_tail else "off",
        "front_fuse": "on" if proc.front_fuse else "off",
        "ring": ring,
        "search_mode": proc.MODE,
        "reps": reps,
        "launches": launches,
    }
    if cfg.aot_plan_path:
        # whether the cache engaged (it is off on the CPU)
        out["aot_active"] = bool(proc.aot_active)
    if ring != "none":
        out["h2d_gb"] = round((proc.h2d_bytes - h2d_bytes0) / reps / 1e9, 4)
        out["h2d_hidden_ms"] = round(h2d_host_s / reps * 1e3, 2)
        out["reserved_frac"] = round(
            proc.reserved_bytes / proc._segment_bytes, 3)
    if on_card:
        # against the card's own HBM peak (Config.hbm_peak_gbps's
        # default is another device's)
        out["hbm_peak_gbps"] = H100_HBM_PEAK_GBPS
        out["roofline_frac"] = round(bytes_moved / dt / 1e9
                                     / H100_HBM_PEAK_GBPS, 4)
    out["pass"] = bool(on_card and realtime_factor >= 1.0)
    if ledger:
        try:
            from srtb_tpu_torch.utils import perf_ledger as PL
            extra = {k: out[k] for k in
                     ("overlap", "ring", "hbm_passes", "fused_tail",
                      "front_fuse", "compile_s", "compile_ms",
                      "roofline_frac", "achieved_gbps", "vs_baseline",
                      "search_mode", "device", "card") if k in out}
            PL.PerfLedger(ledger).append(PL.make_record(
                "bench", out["value"], out["unit"],
                plan=proc.plan_name,
                plan_signature=proc.plan_signature(),
                shape={"log2n": out["log2n"], "channels": channels,
                       "nbits": cfg.baseband_input_bits},
                platform=device.type, samples_s=rep_seconds,
                extra=extra, device=device))
        except Exception as e:  # noqa: BLE001 - the line must still land
            print(f"bench: WARNING: perf-ledger append failed: {e}",
                  file=sys.stderr)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        from srtb_tpu_torch.utils.device import resolve_device
        check_unported(args)
        device = resolve_device(args.device)
        emit(run_bench(device, overlap=args.overlap,
                       fused_tail=args.fused_tail, ring=args.ring,
                       ledger=args.ledger, front_fuse=args.front_fuse))
    except Exception as e:  # noqa: BLE001 - one error line, rc 1
        emit({"metric": METRIC, "value": 0.0, "unit": UNIT,
              "vs_baseline": 0.0, "pass": False,
              "error": f"{type(e).__name__}: {e}"[:500]})
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
