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

# the reference's unpack variant of every format, ported or not (the
# front-fuse resolution reads it before any processor is built)
_UNPACK_VARIANTS = {
    "simple": "simple", "fastmb_roach2": "simple",
    "naocpsr_roach2": "simple", "naocpsr_snap1": "naocpsr_snap1",
    "gznupsr_a1": "gznupsr_a1_v2_1", "gznupsr_a1_v1": "gznupsr_a1",
    "interleaved_samples_2": "interleaved_samples_2",
}


def unpack_variant(name: str) -> str:
    """The unpack variant of the format ``name`` (the reference's
    ``PacketFormat.unpack_variant``)."""
    if name not in _UNPACK_VARIANTS:
        raise ValueError(f"[backend_registry] unknown backend name {name!r}")
    return _UNPACK_VARIANTS[name]


def resolve(name: str) -> PacketFormat:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"baseband format {name!r} is not ported yet (ROADMAP A2: "
            "unpack variants and multi-stream formats)")
    if name not in _REGISTRY:
        raise ValueError(f"[backend_registry] unknown backend name {name!r}")
    return _REGISTRY[name]
