"""Loopback UDP ingest soak (port of ``srtb_tpu/tools/udp_soak.py``):
the receiver's sustained packet rate, throughput and loss accounting
against the real-time requirement.

The J1644-4559 configuration needs 128 MSa/s x 2 bit = 32 MB/s = 0.256
Gbit/s of baseband off the wire (ref: srtb_config_1644-4559.cfg:22-29).
This tool sends counter-sequential fastmb_roach2 packets over loopback, as
fast as the sender can or paced at ``--pace-gbps``, and reports what the
receiver sustained.

Usage:
    python -m srtb_tpu_torch.tools.udp_soak [--packets N]
        [--impl auto|native|packet_ring|python|continuous]
        [--port P (0: a free one)] [--pace-gbps G]
        [--fault-plan "ingest:raise@3,..."]

``--fault-plan`` arms the fault injector on the receive loop (site
``ingest``, index = block number) and wraps each ``receive_block`` in the
default retry policy: the soak-level proof that ingest survives scheduled
transient faults, with the retries counted in the output (``retries``).

Prints one JSON line:
  {"pps": ..., "gbps": ..., "payload_bytes": ..., "received": ...,
   "lost": ..., "loss_rate": ..., "required_gbps": 0.256, "margin": ...}
"""

from __future__ import annotations

import argparse
import json
import socket
import struct
import threading
import time

import numpy as np

from srtb_tpu_torch.io import formats, udp

# 128 MSa/s * 2 bit / 8 = 32 MB/s of payload
REQUIRED_GBPS = 128e6 * 2 / 8 * 8 / 1e9


def free_port() -> int:
    """A UDP port the OS has free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sender(port: int, fmt, n_packets: int, started: threading.Event,
            pace_pps: float = 0.0):
    """Send (or pace) counter-sequential packets, then trail off with a
    slow flush so that blocks in progress at the receiver complete even
    when tail packets of the main burst were dropped."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.connect(("127.0.0.1", port))
    payload = b"\xab" * fmt.payload_bytes
    header_size = fmt.packet_header_size

    def send(c):
        if header_size >= 8:
            header = struct.pack("<Q", c) + b"\x00" * (header_size - 8)
        else:
            header = b""
        try:
            sock.send(header + payload)
        except OSError:
            pass  # a receiver-side overflow shows up as loss

    started.wait()
    chunk = 32
    t0 = time.perf_counter()
    for c in range(n_packets):
        send(c)
        if pace_pps and c % chunk == chunk - 1:
            target = (c + 1) / pace_pps
            lag = target - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
    # paced trailer packets push any partly assembled block over its
    # boundary (they arrive after the timed region ends)
    for c in range(n_packets, n_packets + 4 * 64):
        send(c)
        time.sleep(0.0005)
    sock.close()


def run_soak(n_packets: int = 20000, impl: str = "auto",
             packets_per_block: int = 64, port: int = 42100,
             pace_gbps: float = 0.0, fault_plan: str = "") -> dict:
    """``pace_gbps > 0`` throttles the sender to that payload rate (loss-
    free ingest at the real-time requirement); 0 sends at full speed to
    find the ceiling.  ``port`` 0 binds the one the OS gives."""
    from srtb_tpu_torch.resilience.faults import FaultInjector
    from srtb_tpu_torch.resilience.retry import RetryPolicy, retry_call
    from srtb_tpu_torch.utils.metrics import metrics
    fmt = formats.FASTMB_ROACH2  # 8-byte counter header + 4096-byte payload
    if impl == "auto":
        # a capability probe, not the library's presence: a host without
        # the recvmmsg call shape soaks through the Python receiver
        impl = "native" if udp.native_available() else "python"
    if impl == "native":
        rx = udp.NativeBlockReceiver("127.0.0.1", port, fmt)
    elif impl == "packet_ring":
        # the ring filters on a port given up front
        rx = udp.PacketRingReceiver("", port or free_port(), fmt,
                                    interface="lo")
    elif impl == "continuous":
        rx = udp.PythonContinuousReceiver("127.0.0.1", port, fmt,
                                          rcvbuf_bytes=1 << 28)
    else:
        rx = udp.PythonBlockReceiver("127.0.0.1", port, fmt,
                                     rcvbuf_bytes=1 << 28)
    port = rx.port  # the one the OS gave for port 0

    pace_pps = pace_gbps * 1e9 / 8 / fmt.payload_bytes if pace_gbps else 0.0
    started = threading.Event()
    sender = threading.Thread(target=_sender,
                              args=(port, fmt, n_packets, started,
                                    pace_pps), name="udp-soak-sender")
    sender.start()

    injector = FaultInjector.from_plan(fault_plan)
    policy = RetryPolicy(backoff_base_s=0.001)
    retries_before = metrics.get("retries_total")

    block = np.zeros(packets_per_block * fmt.payload_bytes, dtype=np.uint8)
    n_blocks = n_packets // packets_per_block
    started.set()
    t0 = time.perf_counter()
    received_payload_bytes = 0
    try:
        for i in range(n_blocks - 1):  # sender headroom for the tail
            if injector is None:
                rx.receive_block(block)
            else:
                def guarded(index=i):
                    injector.fire("ingest", index)
                    return rx.receive_block(block)
                retry_call(guarded, policy, "ingest")
            received_payload_bytes += block.nbytes
        dt = time.perf_counter() - t0
    finally:
        sender.join()
    total, lost = rx.total_packets, rx.lost_packets
    rx.close()

    gbps = received_payload_bytes * 8 / dt / 1e9
    pps = received_payload_bytes / fmt.payload_bytes / dt
    return {
        "impl": impl,
        "pace_gbps": pace_gbps,
        "fault_plan": fault_plan,
        "retries": int(metrics.get("retries_total") - retries_before),
        "pps": round(pps),
        "gbps": round(gbps, 3),
        "payload_bytes": fmt.payload_bytes,
        "received": int(total),
        "lost": int(lost),
        "loss_rate": round(lost / max(total + lost, 1), 5),
        "required_gbps": round(REQUIRED_GBPS, 3),
        "margin": round(gbps / REQUIRED_GBPS, 1),
        "seconds": round(dt, 3),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--packets", type=int, default=20000)
    p.add_argument("--impl", default="auto",
                   choices=["auto", "native", "packet_ring", "python",
                            "continuous"])
    p.add_argument("--port", type=int, default=42100,
                   help="the receiver's port (0: a free one)")
    p.add_argument("--pace-gbps", type=float, default=0.0)
    p.add_argument("--fault-plan", default="",
                   help="fault plan for the receive loop (site 'ingest', "
                        "index = block number)")
    args = p.parse_args(argv)
    print(json.dumps(run_soak(args.packets, args.impl, port=args.port,
                              pace_gbps=args.pace_gbps,
                              fault_plan=args.fault_plan)))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
