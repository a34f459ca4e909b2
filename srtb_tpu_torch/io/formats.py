"""Baseband packet-format registry (port of ``srtb_tpu/io/formats.py``,
the ``simple`` format only).

The other formats of the reference (fastmb_roach2, naocpsr_snap1,
gznupsr_a1, gznupsr_a1_v1, interleaved_samples_2) are not ported yet:
asking for one raises ``NotImplementedError`` naming the roadmap item.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PacketFormat:
    name: str
    data_stream_count: int


# ref: backend_registry.hpp:36-39
SIMPLE = PacketFormat("simple", 1)

_REGISTRY = {SIMPLE.name: SIMPLE}
_NOT_PORTED = ("fastmb_roach2", "naocpsr_roach2", "naocpsr_snap1",
               "gznupsr_a1", "gznupsr_a1_v1", "interleaved_samples_2")


def resolve(name: str) -> PacketFormat:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"baseband format {name!r} is not ported yet (ROADMAP A2: "
            "unpack variants and multi-stream formats)")
    if name not in _REGISTRY:
        raise ValueError(f"[backend_registry] unknown backend name {name!r}")
    return _REGISTRY[name]
