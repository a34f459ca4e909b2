"""Baseband packet-format registry (port of ``srtb_tpu/io/formats.py``).

The reference's compile-time backend descriptors (ref:
io/backend_registry.hpp:36-181) as plain dataclass instances: per format
the header size, the packet size, the counter parser, the data-stream
count and the unpack variant that de-interleaves its streams
(``pipeline.segment.unpack_streams``).  The VDIF header bit fields follow
io/vdif_header.hpp:28-61.  The UDP receivers (``io/udp.py``) place each
packet's payload by its counter; file input reads a format's payload
bytes as they are.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, NamedTuple


class VdifHeader(NamedTuple):
    """VDIF data-frame header (8 little-endian 32-bit words)
    (ref: io/vdif_header.hpp:28-61)."""
    seconds_from_ref_epoch: int
    legacy_mode: int
    invalid_data: int
    data_frame_count_in_second: int
    reference_epoch: int
    unassigned: int
    data_frame_length: int
    log2_channels: int
    vdif_version: int
    station_id: int
    thread_id: int
    bits_per_sample_minus_1: int
    data_type: int
    extended_user_data_1: int
    extended_data_version: int
    extended_user_data_2: int
    extended_user_data_3: int
    extended_user_data_4: int


def parse_vdif_header(buf: bytes) -> VdifHeader:
    w = struct.unpack_from("<8I", buf)
    return VdifHeader(
        seconds_from_ref_epoch=w[0] & 0x3FFFFFFF,
        legacy_mode=(w[0] >> 30) & 1,
        invalid_data=(w[0] >> 31) & 1,
        data_frame_count_in_second=w[1] & 0xFFFFFF,
        reference_epoch=(w[1] >> 24) & 0x3F,
        unassigned=(w[1] >> 30) & 0x3,
        data_frame_length=w[2] & 0xFFFFFF,
        log2_channels=(w[2] >> 24) & 0x1F,
        vdif_version=(w[2] >> 29) & 0x7,
        station_id=w[3] & 0xFFFF,
        thread_id=(w[3] >> 16) & 0x3FF,
        bits_per_sample_minus_1=(w[3] >> 26) & 0x1F,
        data_type=(w[3] >> 31) & 1,
        extended_user_data_1=w[4] & 0xFFFFFF,
        extended_data_version=(w[4] >> 24) & 0xFF,
        extended_user_data_2=w[5],
        extended_user_data_3=w[6],
        extended_user_data_4=w[7],
    )


def _parse_counter_le64(packet: bytes) -> tuple[int, int]:
    """First 8 bytes little-endian as (counter, timestamp)
    (ref: backend_registry.hpp:63-73)."""
    counter = struct.unpack_from("<Q", packet)[0]
    return counter, counter


def _parse_counter_vdif(packet: bytes) -> tuple[int, int]:
    """VDIF words 6 and 7 form the u64 counter
    (ref: backend_registry.hpp:129-152)."""
    w6, w7 = struct.unpack_from("<2I", packet, 6 * 4)
    counter = w6 | (w7 << 32)
    return counter, counter


@dataclass(frozen=True)
class PacketFormat:
    name: str
    data_stream_count: int
    packet_header_size: int
    packet_payload_size: int  # the whole packet, header included, as the ref
    parse_packet: Callable[[bytes], tuple[int, int]] | None
    unpack_variant: str  # the de-interleave of pipeline.segment.unpack_streams

    @property
    def payload_bytes(self) -> int:
        return self.packet_payload_size - self.packet_header_size


# ref: backend_registry.hpp:36-39
SIMPLE = PacketFormat("simple", 1, 0, 0, None, "simple")
# ref: backend_registry.hpp:54-74
FASTMB_ROACH2 = PacketFormat("fastmb_roach2", 1, 8, 4104,
                             _parse_counter_le64, "simple")
# ref: backend_registry.hpp:86-92; "1122" pair interleave
NAOCPSR_SNAP1 = PacketFormat("naocpsr_snap1", 2, 8, 4104,
                             _parse_counter_le64, "naocpsr_snap1")
# ref: backend_registry.hpp:110-153; the current version has 2 streams,
# word-interleaved groups of 4 samples
GZNUPSR_A1 = PacketFormat("gznupsr_a1", 2, 64, 8256,
                          _parse_counter_vdif, "gznupsr_a1_v2_1")
# the original 4-stream gznupsr_a1 (ref: unpack.hpp:291-328,
# backend_registry.hpp:112 "was 4 in original version")
GZNUPSR_A1_V1 = PacketFormat("gznupsr_a1_v1", 4, 64, 8256,
                             _parse_counter_vdif, "gznupsr_a1")
# byte-interleaved 2-polarization file input, e.g. cpsr2 ("1212")
# (ref: unpack_pipe.hpp:146-260 unpack_interleaved_samples_2_pipe)
INTERLEAVED_SAMPLES_2 = PacketFormat("interleaved_samples_2", 2, 0, 0,
                                     None, "interleaved_samples_2")

_REGISTRY = {f.name: f for f in
             (SIMPLE, FASTMB_ROACH2, NAOCPSR_SNAP1, GZNUPSR_A1,
              GZNUPSR_A1_V1, INTERLEAVED_SAMPLES_2)}
# ref: backend_registry.hpp:176-181
_ALIASES = {"naocpsr_roach2": "fastmb_roach2"}


def resolve(name: str) -> PacketFormat:
    name = _ALIASES.get(name, name)
    if name not in _REGISTRY:
        raise ValueError(f"[backend_registry] unknown backend name {name!r}")
    return _REGISTRY[name]


def unpack_variant(name: str) -> str:
    """The unpack variant of the format ``name``."""
    return resolve(name).unpack_variant


def get_data_stream_count(name: str) -> int:
    return resolve(name).data_stream_count
