"""The port's packet-format registry and unpack variants against the JAX
package's, bit for bit: the registry (names, stream counts, header and
payload sizes, unpack variants, the alias, the unknown-name error), the
VDIF header and both counter parsers on hand-made packets, ``unpack`` at
every width of ``SUPPORTED_BITS`` with and without a window (a hand-made
set of float64 edge values too), every de-interleave variant at every
width it takes, and ``unpack_streams`` for every variant.  Inputs are
numpy bytes from a seed; the reference runs each function eagerly and
under ``jax.jit`` (as its pipeline runs it), and the port must match
both."""

import struct

import numpy as np
import pytest
import torch

from srtb_tpu_torch.io import formats
from srtb_tpu_torch.ops import unpack as U
from srtb_tpu_torch.pipeline.segment import unpack_streams
from test_torch_ref import run_reference

NAMES = ("simple", "fastmb_roach2", "naocpsr_roach2", "naocpsr_snap1",
         "gznupsr_a1", "gznupsr_a1_v1", "interleaved_samples_2", "vdif",
         "")

RNG = np.random.default_rng(2024)
# 4 KiB of random bytes: every width and variant divides it
BYTES = RNG.integers(0, 256, 4096, dtype=np.uint8)


def _edge_doubles() -> np.ndarray:
    """float64 values whose float32 decode has an edge: zeros of both
    signs, float64 subnormals, the float32 normal and subnormal range's
    ends, values beyond float32's range, +-inf, NaNs (quiet, signalling,
    payload only in the low word, negative), and mantissas whose low word
    rounds differently in two steps than in one (1 + 2^-24 + 2^-52 rounds
    up as one cast and to 1 in the reference's two steps)."""
    bits = [0x0000000000000001, 0x000FFFFFFFFFFFFF, 0x8000000000000001,
            0x7FF0000000000001, 0xFFF8000000000000, 0x7FF4000000000000,
            0x7FF0000080000000]
    vals = [0.0, -0.0, 5e-324, 2.2250738585072014e-308,
            1.1754943508222875e-38, 1.1754942106924411e-38, 1e-45, 1.4e-45,
            3.4028234663852886e38, 3.4028235677973366e38, 3.5e38, 1e39,
            -1e300, 1e300, np.inf, -np.inf, np.nan, 1.0, -2.5,
            1 + 2.0 ** -24 + 2.0 ** -52, 1 + 2.0 ** -24 - 2.0 ** -52,
            1 + 2.0 ** -23 + 2.0 ** -24, 1 - 2.0 ** -25 - 2.0 ** -53,
            np.pi, -np.e, 65504.0, 1.0 / 3.0]
    out = np.concatenate([np.array(vals, dtype=np.float64),
                          np.array(bits, dtype=np.uint64).view(np.float64)])
    # random magnitudes over float32's range and beyond, to 128 values
    k = 128 - out.size
    out = np.concatenate([out, RNG.standard_normal(k)
                          * 10.0 ** RNG.integers(-50, 50, k)])
    return out.view(np.uint8)


EDGES = _edge_doubles()
assert EDGES.size % 32 == 0

# (name, width) of every unpack case: "unpack" at every width with and
# without a window, the 64-bit edge set; the de-interleave variants at
# every width they take; unpack_streams for every variant
WIDTHS = U.SUPPORTED_BITS
UNPACK_CASES = (
    [("unpack", nbits, win, "random") for nbits in WIDTHS
     for win in (False, True)]
    + [("unpack", 64, win, "edges") for win in (False, True)]
    + [(name, nbits, win, "random") for name in (
        "unpack_interleaved_2pol", "unpack_naocpsr_snap1")
       for nbits in WIDTHS for win in (False, True)]
    + [(name, None, win, "random") for name in (
        "unpack_gznupsr_a1", "unpack_gznupsr_a1_v2_1")
       for win in (False, True)])
STREAM_CASES = (
    [("simple", nbits) for nbits in (1, 2, 4, 8, -8, 16, 64)]
    + [("interleaved_samples_2", nbits) for nbits in (1, 2, 4, 8, -8, 16,
                                                      32)]
    + [("naocpsr_snap1", nbits) for nbits in (2, -8, -16)]
    + [("gznupsr_a1", -8), ("gznupsr_a1_v2_1", -8)])

STREAMS = {"unpack": 1, "unpack_interleaved_2pol": 2,
           "unpack_naocpsr_snap1": 2, "unpack_gznupsr_a1": 4,
           "unpack_gznupsr_a1_v2_1": 2}


def _data(kind: str) -> np.ndarray:
    return EDGES if kind == "edges" else BYTES


def _samples(nbytes: int, nbits, streams: int) -> int:
    return nbytes * 8 // abs(nbits or 8) // streams


def _window(n: int) -> np.ndarray:
    return (0.5 + RNG.random(n)).astype(np.float32)


WINDOWS = {}


def _win_for(n: int) -> np.ndarray:
    if n not in WINDOWS:
        WINDOWS[n] = _window(n)
    return WINDOWS[n]


def _case_key(case) -> str:
    return "/".join(str(v) for v in case)


def _packets() -> list:
    """Hand-made 64-byte packets: VDIF words with every field at its
    extreme, counters in the first 8 bytes and in words 6 and 7, and
    random bytes."""
    w = [0x3FFFFFFF | 1 << 30 | 1 << 31, 0xFFFFFF | 0x3F << 24 | 3 << 30,
         0xFFFFFF | 0x1F << 24 | 7 << 29, 0xFFFF | 0x3FF << 16 | 0x1F << 26
         | 1 << 31, 0xFFFFFF | 0xFF << 24, 0xFFFFFFFF, 0xDEADBEEF,
         0x01234567]
    full = struct.pack("<8I", *w) + bytes(32)
    fields = struct.pack("<8I", 12345, 7 << 24 | 99, 3 << 29 | 11 << 24
                         | 1025, 2 << 26 | 5 << 16 | 77, 42, 1, 2, 3) \
        + bytes(32)
    counter = struct.pack("<Q", 0xFEDCBA9876543210) + bytes(56)
    rand = [RNG.integers(0, 256, 64, dtype=np.uint8).tobytes()
            for _ in range(4)]
    return [full, fields, counter, bytes(64), *rand]


PACKETS = _packets()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jobs = [{"key": "registry", "fn": "test_torch_ref:format_registry",
             "args": [list(NAMES)]},
            {"key": "packets", "fn": "test_torch_ref:parse_packets",
             "args": [PACKETS]}]
    for case in UNPACK_CASES:
        name, nbits, win, kind = case
        data = _data(kind)
        n = _samples(data.size, nbits, STREAMS[name])
        jobs.append({"key": _case_key(case),
                     "fn": "test_torch_ref:unpack_call",
                     "args": [name, data, nbits,
                              _win_for(n) if win else None]})
    for variant, nbits in STREAM_CASES:
        s = formats.get_data_stream_count(
            {"gznupsr_a1": "gznupsr_a1_v1",
             "gznupsr_a1_v2_1": "gznupsr_a1"}.get(variant, variant))
        n = _samples(BYTES.size, nbits, s)
        jobs.append({"key": f"streams/{variant}/{nbits}",
                     "fn": "test_torch_ref:unpack_call",
                     "args": ["unpack_streams", BYTES, nbits, _win_for(n)],
                     "kwargs": {"variant": variant}})
    return run_reference(jobs, tmp_path_factory.mktemp("ref_formats"))


def _subnormal(x: np.ndarray) -> np.ndarray:
    return (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)


def _same_bits(got: torch.Tensor, want: np.ndarray,
               unwindowed: torch.Tensor | None = None) -> None:
    """float32 results equal bit for bit (NaN payloads and zero signs
    included), with one gated difference: XLA on the CPU (as a TPU)
    flushes float32 subnormals to zero, in the operands and in the result
    of the window's multiply, so where the port's windowed sample or its
    unwindowed sample (``unwindowed``) is subnormal the reference holds a
    zero of the same sign (random 32-bit words are subnormal one time in
    256)."""
    got = got.numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    g, w = got.view(np.uint32), want.view(np.uint32)
    sub = _subnormal(got)
    if unwindowed is not None:
        sub |= _subnormal(unwindowed.numpy())
    flushed = sub & (w == (g & 0x80000000))
    np.testing.assert_array_equal(np.where(flushed, w, g), w)


@pytest.mark.parametrize("name", NAMES)
def test_registry_matches_reference(ref, name):
    """Each name resolves to the reference's format (the alias to its
    target), with the same streams, sizes, parser and unpack variant; an
    unknown name raises the reference's ValueError."""
    key = f"registry/{name}"
    if f"{key}/error" in ref:
        with pytest.raises(ValueError) as e:
            formats.resolve(name)
        assert str(e.value) == str(ref[f"{key}/error"])
        with pytest.raises(ValueError):
            formats.unpack_variant(name)
        return
    f = formats.resolve(name)
    for field in ("name", "unpack_variant"):
        assert getattr(f, field) == str(ref[f"{key}/{field}"])
    for field in ("data_stream_count", "packet_header_size",
                  "packet_payload_size", "payload_bytes"):
        assert getattr(f, field) == int(ref[f"{key}/{field}"]), field
    assert formats.get_data_stream_count(name) == int(ref[f"{key}/streams"])
    assert formats.unpack_variant(name) == f.unpack_variant
    parser = "" if f.parse_packet is None else f.parse_packet.__name__
    assert parser == str(ref[f"{key}/parser"])


@pytest.mark.parametrize("index", range(len(PACKETS)))
def test_packet_parsers_match_reference(ref, index):
    """``parse_vdif_header`` field by field, and the little-endian and
    VDIF counters, on hand-made and random packets."""
    packet = PACKETS[index]
    key = f"packets/{index}"
    header = formats.parse_vdif_header(packet)
    for field in formats.VdifHeader._fields:
        assert getattr(header, field) == int(ref[f"{key}/vdif/{field}"]), \
            field
    for name, parse in (("le64", formats._parse_counter_le64),
                        ("vdif_counter", formats._parse_counter_vdif)):
        assert list(parse(packet)) == [int(v) for v in ref[f"{key}/{name}"]]


def _port_unpack(name, data, nbits, window):
    fn = getattr(U, name)
    args = () if nbits is None else (nbits,)
    return fn(torch.from_numpy(data), *args, window=window)


@pytest.mark.parametrize("case", UNPACK_CASES, ids=_case_key)
def test_unpack_bit_identical(ref, case):
    """Every width and variant gives the reference's float32 samples bit
    for bit, eager and jitted (the 64-bit decode step for step in float32,
    so also on the edge set; the window one float32 multiply)."""
    name, nbits, win, kind = case
    data = _data(kind)
    n = _samples(data.size, nbits, STREAMS[name])
    w = torch.from_numpy(_win_for(n)) if win else None
    got = _port_unpack(name, data, nbits, w)
    plain = _port_unpack(name, data, nbits, None)
    if name == "unpack":
        got, plain = (got,), (plain,)
    assert len(got) == STREAMS[name]
    for mode in ("eager", "jit"):
        for s, g in enumerate(got):
            key = f"{_case_key(case)}/{mode}"
            want = ref[key] if name == "unpack" else ref[f"{key}/{s}"]
            _same_bits(g, want, plain[s])
    if kind == "edges":
        # the edge set tells the reference's decode from a plain cast
        cast = EDGES.view(np.float64).astype(np.float32)
        assert (cast.view(np.uint32) != plain[0].numpy().view(np.uint32)
                ).any()


@pytest.mark.parametrize("variant,nbits", STREAM_CASES)
def test_unpack_streams_bit_identical(ref, variant, nbits):
    """``unpack_streams`` stacks every variant's streams into [S, n] as
    the reference does, windowed, bit for bit."""
    want = ref[f"streams/{variant}/{nbits}/jit"]
    np.testing.assert_array_equal(
        want.view(np.uint32), ref[f"streams/{variant}/{nbits}/eager"]
        .view(np.uint32))
    n = want.shape[-1]
    got = unpack_streams(torch.from_numpy(BYTES), variant, nbits,
                         torch.from_numpy(_win_for(n)))
    _same_bits(got, want,
               unpack_streams(torch.from_numpy(BYTES), variant, nbits, None))


def test_deinterleave_groups_and_errors():
    """The byte de-interleave feeds K1 the same bytes the variants unpack;
    unknown variants and widths raise as in the reference."""
    data = torch.arange(16, dtype=torch.uint8)
    assert U.deinterleave_bytes(data, "interleaved_samples_2").tolist() == [
        list(range(0, 16, 2)), list(range(1, 16, 2))]
    assert U.deinterleave_bytes(data, "naocpsr_snap1").tolist() == [
        [0, 1, 4, 5, 8, 9, 12, 13], [2, 3, 6, 7, 10, 11, 14, 15]]
    for variant in ("simple", "gznupsr_a1"):
        with pytest.raises(ValueError):
            U.deinterleave_bytes(data, variant)
    with pytest.raises(ValueError, match="unknown unpack variant"):
        unpack_streams(data, "cpsr3", 8, None)
    for nbits in (3, 12, -32, -64):
        with pytest.raises(ValueError, match="unsupported"):
            U.unpack(data, nbits)
    assert [U.samples_per_byte(b) for b in (1, -8, 16, 64)] == [8, 1, 0.5,
                                                                 0.125]
