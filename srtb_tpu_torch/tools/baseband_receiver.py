"""UDP to disk baseband recorder, ``srtb-torch-baseband-receiver`` (port of
``srtb_tpu/tools/baseband_receiver.py``; ref: src/baseband_receiver.cpp:
59-87, a composite pipe of UDP receive, cast and write with no device
work).

Usage:
    srtb-torch-baseband-receiver --config_file_name srtb_config.cfg
        [--key value ...]

Receives segments on the configured ``udp_receiver_port`` (the first
one) and appends each to ``<baseband_output_file_prefix>recorded.bin``
through a one-thread writer pool (ordered appends, so disk latency never
blocks the receive loop), until interrupted.
"""

from __future__ import annotations

import sys

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io.native_writer import AsyncWriterPool
from srtb_tpu_torch.io.udp import UdpReceiverSource
from srtb_tpu_torch.utils.bufferpool import BufferPool
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.termination import install_termination_handler


def record(cfg: Config, max_segments: int | None = None) -> int:
    """Append received segments to the recording until interrupted (or
    ``max_segments``); returns the count written."""
    # no device work: plain host buffers
    src = UdpReceiverSource(cfg, buffer_pool=BufferPool("segments"))
    path = cfg.baseband_output_file_prefix + "recorded.bin"
    n = 0
    with AsyncWriterPool(n_threads=1) as pool:
        try:
            while max_segments is None or n < max_segments:
                seg = next(src)
                # the pool copies at submit: the buffer is free at once
                pool.submit(path, seg.data, append=True)
                src.pool.release(seg.data)
                n += 1
                # fail fast on disk errors rather than draining UDP for
                # hours while appends silently fail
                pool.raise_new_errors(f"append to {path}")
                log.debug(f"[baseband_receiver] segment {n}, counter "
                          f"{seg.udp_packet_counter}")
        except KeyboardInterrupt:
            pass
        finally:
            src.close()
            pool.drain()
            pool.raise_new_errors(f"append to {path}")
    log.info(f"[baseband_receiver] wrote {n} segments to {path}; "
             f"lost {src.packets_lost} packets")
    return n


def main(argv=None) -> int:
    install_termination_handler()
    record(Config.from_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
