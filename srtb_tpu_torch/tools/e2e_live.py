"""Live UDP -> device -> candidates end-to-end harness (port of
``srtb_tpu/tools/e2e_live.py``).

The reference runs its whole graph off live packets in one process (ref:
src/main.cpp:261-271; README.md:320-322 documents the deployment).  The
ingest soak (``udp_soak``) and the file-fed compute (``srtb-torch-bench``)
each prove half of that; this harness proves the composition: a paced
loopback sender streams dispersed-pulse baseband packets at a multiple of
the real-time wire rate, a ``UdpReceiverSource`` (``MultiUdpSource`` with
``--receivers`` > 1) assembles segments, the ``ThreadedPipeline`` overlaps
the card's dispatch with the drain, candidates land on disk, and
``/metrics`` is served over HTTP throughout.

The pipeline runs with ``keep_waterfall=False``: only a sink that wants
the waterfall sees it (the lossy GUI tap of ``--gui``), so the candidate
writer dumps none during a rate measurement.  ``--keep_waterfall`` hands
it to every sink, so that each positive's waterfall is dumped as
``srtb-torch-main`` dumps it.  Before the senders are released one
dispatch warms the chain (on the card: the kernel library's build at its
first launch and cuFFT's plans).

Emits ONE JSON line (appended to ``--out`` too).  Throughput is given
under two labeled denominators:

  window   -- samples drained / wall time between "warm-up done, senders
              released" and the pipeline's end: the keep-up-with-the-
              wire claim, the number to compare with rate_x;
  lifetime -- samples / seconds since ``metrics.reset()`` at the
              harness's start, warm-up included: what an operator
              dividing bytes on disk by the observation's wall clock sees.

  {"harness": "e2e_live", "seconds": window wall, "rate_x": sender pace,
   "segments": N, "msamples_per_s_window": ..., "vs_realtime_window": ...,
   "lifetime_seconds": ..., "msamples_per_s_lifetime": ...,
   "vs_realtime_lifetime": ..., "packets_total": ..., "packets_lost": ...,
   "loss_rate": ..., "signals": ..., "deadline_hits": 0,
   "metrics_http": {...}, "plan": ..., "launches": {...},
   "device": ..., "card": ...}

Zero loss and vs_realtime_window >= rate_x mean the process kept up with
the offered load end to end; deadline_hits is 0 whenever the line is
printed at all (a tripped ``segment_deadline_s`` aborts the process).

``--pulse_segments K`` (0, the reference's: every segment) puts the pulse
in the first K segments' bytes only, noise after them.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import sys
import threading
import time

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import formats
from srtb_tpu_torch.utils.logging import log


def _sender(port: int, fmt, payloads: list, pulse_packets: int,
            pace_pps: float, started: threading.Event,
            stop: threading.Event):
    """Stream counter-sequential packets at ``pace_pps``: the first
    ``pulse_packets`` from ``payloads[0]``, then ``payloads[-1]``, each
    cyclically; then trail off slowly so that the receiver's block in
    progress completes (udp_soak's flush)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.connect(("127.0.0.1", port))
    payload = fmt.payload_bytes
    n_slices = len(payloads[0]) // payload
    header_size = fmt.packet_header_size

    def send(c):
        head = struct.pack("<Q", c) + b"\x00" * (header_size - 8) \
            if header_size >= 8 else b""
        src = payloads[0] if c < pulse_packets else payloads[-1]
        off = (c % n_slices) * payload
        try:
            sock.send(head + src[off:off + payload])
        except OSError:
            pass  # a kernel buffer overflow shows up as counter-gap loss

    started.wait()
    chunk = 32
    t0 = time.perf_counter()
    c = 0
    while not stop.is_set():
        send(c)
        c += 1
        if c % chunk == 0:
            lag = c / pace_pps - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
    for _ in range(4 * 64):  # flush a partly assembled block
        send(c)
        c += 1
        time.sleep(0.0005)
    sock.close()


def run(args) -> dict:
    import numpy as np

    from srtb_tpu_torch import kernels as K
    from srtb_tpu_torch.gui.server import WaterfallHTTPServer
    import torch

    from srtb_tpu_torch.io.synth import make_dispersed_baseband
    from srtb_tpu_torch.io.udp import MultiUdpSource, UdpReceiverSource
    from srtb_tpu_torch.io.writers import to_host
    from srtb_tpu_torch.pipeline.runtime import ThreadedPipeline
    from srtb_tpu_torch.utils.device import resolve_device
    from srtb_tpu_torch.utils.metrics import metrics
    from srtb_tpu_torch.utils.perf_ledger import device_name

    device = resolve_device(args.device)
    n = 1 << args.log2n
    if args.port == 0 and args.provider == "packet_ring":
        # the ring filters on a port given up front
        from srtb_tpu_torch.tools.udp_soak import free_port
        ports = [free_port() for _ in range(args.receivers)]
    elif args.port == 0:
        # each receiver binds a port the OS gives it, read back below
        ports = [0] * args.receivers
    else:
        ports = [args.port + i for i in range(args.receivers)]
    cfg = Config(
        baseband_input_count=n,
        baseband_input_bits=2,
        baseband_format_type="fastmb_roach2",
        baseband_freq_low=1405.0 + 32.0,
        baseband_bandwidth=-64.0,
        baseband_sample_rate=128e6,
        dm=-478.80,
        spectrum_channel_count=1 << args.log2chan,
        signal_detect_signal_noise_threshold=8.0,
        signal_detect_max_boxcar_length=64,
        mitigate_rfi_spectral_kurtosis_threshold=1.05,
        baseband_reserve_sample=False,
        baseband_output_file_prefix=args.prefix,
        udp_receiver_address=["127.0.0.1"] * len(ports),
        udp_receiver_port=ports,
        udp_packet_provider=args.provider,
        udp_receiver_rcvbuf_bytes=args.rcvbuf_bytes,
        segment_deadline_s=args.deadline_s,
        fft_strategy=args.fft_strategy,
    )
    fmt = formats.resolve(cfg.baseband_format_type)
    metrics.reset()

    # one segment of J1644-parameter baseband with dispersed pulses at 1/4
    # and 3/4, streamed cyclically: wherever a segment boundary lands in
    # the cycle, one pulse stays whole (made on the run's device: at 2^30
    # a float64 host synthesis takes minutes)
    seg_bytes = cfg.segment_bytes(1)

    def synth(pulses: list, seed: int) -> bytes:
        gen = torch.Generator(device=device).manual_seed(seed)
        return make_dispersed_baseband(
            n, cfg.baseband_freq_low, cfg.baseband_bandwidth, cfg.dm,
            pulses, nbits=2, pulse_amp=40.0, device=device,
            generator=gen).cpu().numpy().tobytes()
    pulse_segment = synth([n // 4, 3 * n // 4], 5)
    assert len(pulse_segment) == seg_bytes
    payloads = [pulse_segment]
    pulse_packets = 1 << 62
    if args.pulse_segments > 0:
        payloads.append(synth([], 6))
        pulse_packets = (args.pulse_segments
                         * (seg_bytes // fmt.payload_bytes))

    real_time_bps = cfg.baseband_sample_rate * 2 / 8  # 2-bit payload
    pace_pps = args.rate_x * real_time_bps / fmt.payload_bytes
    if args.max_segments > 0:
        # an explicit cap (overload runs: the derived count assumes the
        # pipeline keeps up, which an overload test disproves)
        expected_segments = args.max_segments
    else:
        expected_segments = max(1, int(
            args.seconds * args.rate_x * cfg.baseband_sample_rate / n)) \
            * len(ports)  # each receiver contributes its own stream

    src = MultiUdpSource(cfg) if len(ports) > 1 else UdpReceiverSource(cfg)
    ports = src.ports if len(ports) > 1 else [src.port]
    started = threading.Event()
    stop = threading.Event()
    senders = [threading.Thread(
        target=_sender, args=(port, fmt, payloads, pulse_packets, pace_pps,
                              started, stop),
        name=f"e2e-live-sender-{port}", daemon=True) for port in ports]
    for s in senders:
        s.start()

    # serve the directory the waterfall frames land in (the prefix's)
    frames_dir = os.path.dirname(args.prefix) or "."
    http_srv = WaterfallHTTPServer(frames_dir, port=args.http_port).start()
    # the lossy waterfall tap (the reference streams its waterfall from the
    # same live pipeline): it renders at most every --gui_min_interval_s,
    # so a slow render never holds the drain back; frames in between are
    # dropped
    waterfall_service = None
    gui_frames = [0]
    if args.gui:
        import glob

        from srtb_tpu_torch.gui.waterfall import WaterfallService
        # a prior run's frames would count as this run's
        for old in glob.glob(os.path.join(frames_dir, "waterfall_s*_*.png")):
            try:
                os.remove(old)
            except OSError:
                pass
        n_spec = n // 2
        nchan = min(cfg.spectrum_channel_count, n_spec)
        waterfall_service = WaterfallService(
            cfg, in_freq=nchan, in_time=n_spec // nchan, out_dir=frames_dir,
            device=device)
    pipe = ThreadedPipeline(cfg, source=src, device=device,
                            keep_waterfall=args.keep_waterfall)
    if waterfall_service is not None:
        last_render = [0.0]

        class _LossyTap:
            wants_waterfall = True

            def push(self, work, has_signal):
                now = time.perf_counter()
                if (work.waterfall is None
                        or now - last_render[0] < args.gui_min_interval_s):
                    return
                last_render[0] = now
                waterfall_service.push(work.waterfall,
                                       work.segment.data_stream_id)
                waterfall_service.render_pending()
                gui_frames[0] += 1
        pipe.sinks.append(_LossyTap())
    try:
        # warm up before offering load: the first dispatch builds the
        # kernels and cuFFT's plans, during which nothing drains and the
        # socket buffer would overflow
        warm = np.frombuffer(pulse_segment, dtype=np.uint8).copy()
        wf, det = pipe.processor.process(warm)
        to_host(det.signal_counts)
        del wf, det
        log.info("[e2e_live] pipeline warm; starting the offered load")
        K.reset_launch_counts()
        started.set()
        t0 = time.perf_counter()
        stats = pipe.run(max_segments=expected_segments)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in K.launch_counts().items() if v}
    finally:
        stop.set()
        for s in senders:
            s.join(timeout=5)
        src.close()
        pipe.close()

    # the live /metrics snapshot over real HTTP, part of what this proves
    import urllib.request
    with urllib.request.urlopen(
            f"http://127.0.0.1:{http_srv.port}/metrics.json",
            timeout=10) as r:
        metrics_http = json.loads(r.read().decode())
    gui_frames_served = None
    if args.gui:
        # the server must list the frames the tap rendered
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http_srv.port}/frames.json",
                timeout=10) as r:
            streams = json.loads(r.read().decode()).get("streams", {})
        gui_frames_served = sum(len(v) for v in streams.values())
    http_srv.stop()

    total = metrics_http.get("packets_total", 0.0)
    lost = metrics_http.get("packets_lost", 0.0)
    window_msps = stats.samples / wall / 1e6 if wall else 0.0
    lifetime_s = metrics_http.get("elapsed_s", 0.0)
    lifetime_msps = metrics_http.get("msamples_per_sec", 0.0)
    out = {
        "harness": "e2e_live",
        "seconds": round(wall, 1),
        "rate_x": args.rate_x,
        "log2n": args.log2n,
        "receivers": len(ports),
        "provider": args.provider,
        "segments": stats.segments,
        "msamples_per_s_window": round(window_msps, 1),
        "vs_realtime_window": round(window_msps * 1e6
                                    / cfg.baseband_sample_rate, 3),
        "lifetime_seconds": round(lifetime_s, 1),
        "msamples_per_s_lifetime": round(lifetime_msps, 1),
        "vs_realtime_lifetime": round(lifetime_msps * 1e6
                                      / cfg.baseband_sample_rate, 3),
        "packets_total": int(total),
        "packets_lost": int(lost),
        "loss_rate": round(lost / total, 6) if total else None,
        "signals": stats.signals,
        "positive_segments": pipe.positive_segments,
        "plan": pipe.processor.plan_name,
        # the kernels the run launched (the warm-up's not counted)
        "launches": launches,
        "deadline_s": args.deadline_s,
        "keep_waterfall": args.keep_waterfall,
        "deadline_hits": 0,  # a hit aborts before this line is reached
        "gui_frames": gui_frames[0] if waterfall_service else None,
        "gui_frames_served": gui_frames_served,
        "metrics_http": metrics_http,
        "platform": device.type,
        "device": device_name(device),
    }
    if device.type == "cuda":
        from srtb_tpu_torch.tools.bench import card_line
        out["card"] = card_line()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seconds", type=float, default=60.0,
                   help="offered-load duration (the sender keeps this pace)")
    p.add_argument("--rate_x", type=float, default=2.0,
                   help="sender pace as a multiple of the 128 MSa/s "
                        "real-time wire rate")
    p.add_argument("--log2n", type=int, default=24)
    p.add_argument("--log2chan", type=int, default=11)
    p.add_argument("--port", type=int, default=42150)
    p.add_argument("--receivers", type=int, default=1,
                   help="N receivers on ports port..port+N-1 "
                        "(MultiUdpSource, the reference's per-pol shape; "
                        "--port 0: ports the OS has free)")
    p.add_argument("--http_port", type=int, default=0)
    p.add_argument("--provider", default="recvmmsg",
                   choices=["recvmmsg", "packet_ring", "recvfrom",
                            "asyncio"])
    p.add_argument("--deadline_s", type=float, default=0.0)
    p.add_argument("--rcvbuf_bytes", type=int, default=1 << 28,
                   help="SO_RCVBUF request for the receiver sockets "
                        "(small values make overload surface as prompt "
                        "accounted loss)")
    p.add_argument("--max_segments", type=int, default=0,
                   help="stop after this many segments (0 = derive from "
                        "--seconds and --rate_x; required for overload "
                        "runs, where the offered load exceeds the compute "
                        "rate by design)")
    p.add_argument("--pulse_segments", type=int, default=0,
                   help="the pulse in the first K segments only (0: in "
                        "every segment, the reference's)")
    p.add_argument("--fft_strategy", default="auto")
    p.add_argument("--keep_waterfall", action="store_true",
                   help="dump each positive's waterfall, as "
                        "srtb-torch-main does (off: the reference's)")
    p.add_argument("--gui", action="store_true",
                   help="lossy waterfall tap + renderer during the run")
    p.add_argument("--gui_min_interval_s", type=float, default=0.5)
    p.add_argument("--prefix", default="e2e_live/out_")
    p.add_argument("--device", default=None,
                   help="default: the card; cpu runs the plain versions")
    p.add_argument("--out", default="",
                   help="append the JSON line to this file too")
    args = p.parse_args(argv)

    os.makedirs(os.path.dirname(args.prefix) or ".", exist_ok=True)
    result = run(args)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps({
                "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                **result}) + "\n")
    log.info(f"[e2e_live] {result['segments']} segments, "
             f"{result['vs_realtime_window']}x real-time (window), "
             f"{result['vs_realtime_lifetime']}x (lifetime), "
             f"loss {result['loss_rate']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
