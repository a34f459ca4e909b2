"""The port's live UDP ingest against the JAX package's, over loopback.

The same packets, made from a numpy seed, go to the port's receivers in
this process and to the reference's in the runner's subprocess
(``tests/test_torch_ref.py``'s UDP harness, one sender thread on each
side), and everything must be bit-identical: block bytes, first counter,
lost and total, the receivers' totals, the sources' segment bytes,
packet counters and seqs.  Covered: block assembly with loss, reordering,
duplicated and stale counters for the Python, asyncio, native
(``recvmmsg``, skipped when its capability probe fails) and AF_PACKET
ring (skipped without ``CAP_NET_RAW``) receivers; gznupsr VDIF counters;
the continuous worker (straddling, inline zero-fill, late packets);
``UdpReceiverSource``'s overlap assembly with and without loss, the
misaligned-stride fallback (``seq = -1``) and the continuous mode; the
provider and mode refusals; ``MultiUdpSource`` on two ports; and one
end-to-end run at 2^16 samples, ``Pipeline(source=UdpReceiverSource)``
on the CPU against the reference's, paced so that the piggyback cannot
fire by chance.  Then the real-time candidate writer against the
reference's on a script, the engine's buffer ownership with a sink that
keeps segments, the CLI's input selection against ``srtb-main``'s, and
the baseband recorder.  Every receive is bounded (``UDP_TIMEOUT_S``)."""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import udp
from srtb_tpu_torch.io.writers import CandidateFiles, WriteSignalSink
from srtb_tpu_torch.ops import dedisperse as dd
from srtb_tpu_torch.pipeline.runtime import Pipeline, PipelineStats
from srtb_tpu_torch.pipeline.work import SegmentResultWork, SegmentWork
from srtb_tpu_torch.tools import baseband_receiver as BR
from srtb_tpu_torch.tools import main as M
from srtb_tpu_torch.utils.bufferpool import BufferPool
from test_torch_pipeline import (CHANNELS, DM, N, check_candidate_contents,
                                 reference_arrays)
from test_torch_ref import (UDP_TIMEOUT_S, bounded, free_udp_port,
                            paced_pipeline, receive_blocks, run_reference,
                            scripted_pushes, send_datagrams, source_segments,
                            start_thread, stream_datagrams)
from test_torch_segment import slice_config, stream_bytes

FASTMB = "fastmb_roach2"
P = 4096  # fastmb_roach2's payload
B = 1 << 33  # a counter base with bits in VDIF word 7

# block assembly: (format, counters in sending order, block sizes in
# bytes), each for the block receivers of RECEIVER_KINDS
BLOCK_CASES = {
    # block 0 loses counter 2 and gets 3 before 1; counter 4 overflows
    # it and opens block 1, which fills out of order
    "loss_reorder": (FASTMB, [0, 3, 1, 4, 5, 7, 6, 8], [4 * P, 4 * P]),
    # a duplicated counter must not close a block early; block 1 closes
    # on the overflowing 8 with 5 and 7 lost
    "duplicates": (FASTMB, [0, 1, 1, 2, 3, 4, 4, 6, 8], [4 * P, 4 * P]),
    # a stale counter of block 0 arriving during block 1 is dropped
    "stale": (FASTMB, [0, 1, 2, 3, 1, 4, 5, 6, 7, 2], [4 * P, 4 * P]),
    # VDIF words 6 and 7 (gznupsr): B + 1 lost, B + 4 overflows
    "gznupsr_vdif": ("gznupsr_a1", [B, B + 2, B + 3, B + 4], [4 * 8192]),
}
RECEIVER_KINDS = ("python", "asyncio", "native", "ring")
# the continuous worker: (counters, block sizes in bytes)
CONTINUOUS_CASES = {
    # the middle packet straddles the two blocks
    "straddle": ([0, 1, 2], [P + P // 2, P + P // 2]),
    # counters 2 and 3 lost: 2 P zeros inline, across a block boundary
    "zero_fill": ([0, 1, 4, 5], [P + P // 2, 2 * P, P + P // 2]),
    # late and duplicated packets are dropped
    "late": ([0, 1, 1, 0, 2, 3], [2 * P, 2 * P]),
}


def source_config(**over) -> Config:
    """The UDP source cases' cfg (the JAX package's ring tests' source
    geometry): 16384 8-bit samples, 4 payloads a segment; at 2048
    channels the reserved tail is one payload, the stride three."""
    kw = dict(baseband_input_count=16384, baseband_input_bits=8,
              baseband_format_type=FASTMB, baseband_freq_low=1405.0,
              baseband_bandwidth=64.0, baseband_sample_rate=128e6, dm=0.05,
              spectrum_channel_count=2048, baseband_reserve_sample=True,
              mitigate_rfi_average_method_threshold=100.0,
              mitigate_rfi_spectral_kurtosis_threshold=2.0)
    kw.update(over)
    return Config(**kw)


# source cases: (cfg overrides, counters a port, segments, use_native)
SOURCE_CASES = {
    "overlap_python": ({}, [list(range(10))], 3, False),
    "overlap_native": ({}, [list(range(10))], 3, True),
    "overlap_loss": ({}, [[0, 1, 2, 3, 4, 5, 7, 8, 9, 10]], 3, False),
    # 512 channels: a 1024-sample tail, stride not a payload multiple
    "misaligned": ({"spectrum_channel_count": 512},
                   [list(range(12))], 3, False),
    "continuous": ({"spectrum_channel_count": 512,
                    "udp_receiver_mode": "continuous"},
                   [[0, 1, 2, 3, 5, 6, 7, 8, 9, 10]], 3, None),
    "two_ports": ({"baseband_reserve_sample": False},
                  [list(range(8)), list(range(50, 58))], 2, False),
}
# provider and mode refusals: (cfg overrides, use_native)
REFUSALS = [
    ({"udp_packet_provider": "bogus"}, None),
    ({"udp_receiver_mode": "bogus"}, None),
    ({"udp_packet_provider": "asyncio",
      "udp_receiver_mode": "continuous"}, None),
    ({"udp_packet_provider": "asyncio"}, True),
    ({"udp_packet_provider": "packet_ring",
      "udp_receiver_mode": "continuous"}, None),
    ({"udp_packet_provider": "recvfrom"}, True),
    ({"udp_packet_provider": "packet_ring"}, False),
    ({"baseband_format_type": "simple"}, None),
    ({"baseband_input_count": 1000}, None),
]

# the end-to-end case: make_case's geometry in fastmb_roach2 packets (the
# 1232-byte reserved tail is no payload multiple: non-overlapping
# segments, seq = -1, the ring cold); 3 segments, the pulse in segment 1
E2E_SEGMENTS = 3
# seconds between a segment's return and the next stride's first packet:
# over 200 times the piggyback's 0.45-segment window (0.23 ms)
E2E_PACE_S = 0.05


def e2e_config(out_dir) -> Config:
    return slice_config(N, CHANNELS, DM).replace(
        baseband_format_type=FASTMB, input_file_path="",
        baseband_output_file_prefix=f"{out_dir}/out_")


def e2e_stream() -> np.ndarray:
    cfg = e2e_config("")
    nres = dd.nsamps_reserved(cfg)
    seg = cfg.segment_bytes(1)
    # segment 1 is bytes [seg, 2 seg): its searched span is its first
    # N - 2 nres samples, the pulse in the middle of it
    pulse_at = N + (N - 2 * nres) // 2
    return stream_bytes(cfg, E2E_SEGMENTS * N, pulse_at, 4.0, seed=11)


# the real-time writer's script: (timestamp ns, has_signal, stream); the
# piggyback window is 0.45 segment = 230400 ns at 2^16 samples
WRITER_SCRIPT = [
    (0, False, 0),                 # negative, nothing to piggyback on
    (1_000, True, 0),              # positive: written
    (2_000, False, 1),             # the other polarization: piggyback
    (10_000_000, False, 0),        # far: the old positive is cleaned
    (10_000_100, True, 1),         # positive
    (10_000_050, False, 0),        # within the window: piggyback
    (10_500_000, False, 1),        # outside the window, not yet cleaned
    (20_000_000, True, 0),         # positive after a cleanup
]


def _fields(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_udp")
    jobs = []
    for name, (fmt, counters, blocks) in BLOCK_CASES.items():
        for kind in RECEIVER_KINDS:
            jobs.append({"key": f"block/{name}/{kind}",
                         "fn": "test_torch_ref:ref_receive_blocks",
                         "args": [kind, fmt, counters, 5, blocks]})
    for name, (counters, blocks) in CONTINUOUS_CASES.items():
        jobs.append({"key": f"continuous/{name}",
                     "fn": "test_torch_ref:ref_receive_blocks",
                     "args": ["continuous", FASTMB, counters, 6, blocks]})
    for name, (over, counters, segments, native) in SOURCE_CASES.items():
        jobs.append({"key": f"source/{name}",
                     "fn": "test_torch_ref:ref_source_segments",
                     "args": [_fields(source_config(**over)), counters, 9,
                              segments],
                     "kwargs": {"use_native": native}})
    base = source_config(udp_receiver_address=["127.0.0.1"],
                         udp_receiver_port=[free_udp_port()])
    jobs.append({"key": "refusals", "fn": "test_torch_ref:ref_source_refusals",
                 "args": [_fields(base), REFUSALS]})
    e2e_dir = tmp / "e2e"
    e2e_dir.mkdir()
    jobs.append({"key": "e2e", "fn": "test_torch_ref:ref_paced_pipeline",
                 "args": [_fields(e2e_config(e2e_dir)), e2e_stream(),
                          E2E_SEGMENTS, E2E_PACE_S, str(e2e_dir)]})
    writer_dir = tmp / "writer"
    writer_dir.mkdir()
    jobs.append({"key": "writer",
                 "fn": "test_torch_ref:ref_write_signal_script",
                 "args": [_fields(e2e_config(writer_dir)), WRITER_SCRIPT, 64,
                          str(writer_dir)]})
    for name, argv in _main_cases(tmp / "main_ref").items():
        jobs.append({"key": f"main/{name}", "fn": "test_torch_ref:ref_main_source",
                     "args": [argv]})
    return run_reference(jobs, tmp)


def _same(ref: dict, key: str, got: dict) -> None:
    """Every array of reference job ``key`` equals the port's."""
    prefix = f"{key}/"
    want = {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}
    flat = {}

    def walk(name, value):
        if isinstance(value, dict):
            for k, v in value.items():
                walk(f"{name}/{k}" if name else k, v)
        elif isinstance(value, list) and value and \
                isinstance(value[0], np.ndarray):
            for i, v in enumerate(value):
                walk(f"{name}/{i}", v)
        else:
            flat[name] = np.asarray(value)
    walk("", got)
    assert sorted(flat) == sorted(want)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("kind", RECEIVER_KINDS)
@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_block_assembly_matches_reference(ref, name, kind):
    """Loss zero-filled and counted, reordering tolerated, duplicated
    and stale counters handled, in every block receiver, bit for bit as
    the reference's; the lost slots are zeroed in a dirty buffer."""
    if kind == "native" and not udp.native_available():
        pytest.skip("native recvmmsg receiver unavailable here "
                    "(udp.native_available(): the capability probe)")
    fmt, counters, blocks = BLOCK_CASES[name]
    got = receive_blocks(udp, kind, fmt, counters, 5, blocks)
    key = f"block/{name}/{kind}"
    if kind == "ring" and "skipped" in got:
        assert f"{key}/skipped" in ref  # the reference cannot either
        pytest.skip(f"AF_PACKET ring unavailable (CAP_NET_RAW): "
                    f"{got['skipped']}")
    assert "skipped" not in got
    _same(ref, key, got)
    # lost slots are zeros, never the buffer's previous bytes
    for block in got["blocks"]:
        assert not (block.reshape(-1, 16) == 0xA5).all(axis=1).any()


@pytest.mark.parametrize("name", sorted(CONTINUOUS_CASES))
def test_continuous_worker_matches_reference(ref, name):
    """The continuous worker: payloads straddle blocks, loss is
    zero-filled inline (also across a boundary), late and duplicated
    packets are dropped; the block counter is the first byte's."""
    counters, blocks = CONTINUOUS_CASES[name]
    got = receive_blocks(udp, "continuous", FASTMB, counters, 6, blocks)
    _same(ref, f"continuous/{name}", got)


@pytest.mark.parametrize("name", sorted(SOURCE_CASES))
def test_source_segments_match_reference(ref, name):
    """``UdpReceiverSource`` / ``MultiUdpSource``: segment bytes, packet
    counters (backed off by reserved // payload on warm segments), seqs
    (-1 for the misaligned stride), the overlap geometry and the
    receivers' loss totals, as the reference's."""
    over, counters, segments, native = SOURCE_CASES[name]
    if native and not udp.native_available():
        pytest.skip("native recvmmsg receiver unavailable here "
                    "(udp.native_available(): the capability probe)")
    got = source_segments(udp, source_config(**over), counters, 9,
                          segments, use_native=native)
    _same(ref, f"source/{name}", got)
    if name.startswith("overlap"):
        assert got["reserved_bytes"] == P and got["stride_bytes"] == 3 * P
        assert got["0"]["seq"].tolist() == [0, 1, 2]
    if name == "misaligned":
        assert got["0"]["seq"].tolist() == [-1, -1, -1]


def test_source_refusals_match_reference(ref):
    """Contradictory provider/mode settings and formats without packets
    raise ValueError before any socket opens, as in the reference."""
    base = source_config(udp_receiver_address=["127.0.0.1"],
                         udp_receiver_port=[free_udp_port()])
    for i, (over, use_native) in enumerate(REFUSALS):
        with pytest.raises(ValueError) as e:
            udp.UdpReceiverSource(base.replace(**over),
                                  use_native=use_native)
        want = str(ref[f"refusals/{i}"])
        assert want, f"case {i}: the reference builds the source"
        # the same refusal: the setting it names leads both texts
        assert str(e.value).split(" ")[0] == want.split(" ")[0], (
            str(e.value), want)


def test_source_pool_and_loss_counters():
    """The source receives into its pool's buffers (pinned only with a
    card) and counts packets_total / packets_lost; lost slots are zero
    in a reused, dirty buffer."""
    pool = BufferPool("segments")
    port = free_udp_port()
    cfg = source_config(baseband_reserve_sample=False,
                        udp_receiver_address=["127.0.0.1"],
                        udp_receiver_port=[port])
    src = udp.UdpReceiverSource(cfg, use_native=False, buffer_pool=pool)
    assert src.pool is pool and not pool.pinned
    dirty = pool.acquire(src.segment_bytes, zero=False)
    dirty[:] = 0xA5
    pool.release(dirty)
    datagrams = stream_datagrams(
        FASTMB, P, (np.arange(9 * P) % 251).astype(np.uint8), 0)
    # counter 3 lost; 8 closes the second segment
    sender = start_thread(send_datagrams, port,
                          datagrams[:3] + datagrams[4:9])
    try:
        seg = bounded(lambda: next(src), "segment")
        assert seg.data.ctypes.data == dirty.ctypes.data  # reused
        assert (seg.data[3 * P:] == 0).all()  # counter 3 lost
        assert src.packets_total == 4 and src.packets_lost == 1
        pool.release(seg.data)
        seg = bounded(lambda: next(src), "segment")
        assert src.packets_total == 8 and src.packets_lost == 1
        pool.release(seg.data)
    finally:
        sender.join(UDP_TIMEOUT_S)
        src.close()
    assert pool.stats()["in_use"] == 0


def test_multi_source_close_wakes_blocked_receivers():
    """Closing a ``MultiUdpSource`` whose receivers wait for packets that
    never come shuts their sockets down: the threads end at once."""
    cfg = source_config(baseband_reserve_sample=False,
                        udp_receiver_address=["127.0.0.1"],
                        udp_receiver_port=[free_udp_port(),
                                           free_udp_port()])
    src = udp.MultiUdpSource(cfg, use_native=udp.native_available())
    bounded(src.close, "close")
    assert not any(p.thread.is_alive() for p in src._pipes)


def test_multi_source_allocates_its_buffers_once(monkeypatch):
    """A ``MultiUdpSource`` allocates, once, the buffers a run holds at
    once in its shared pool: one receiving on each thread, the queue's,
    the engine's window and the sink's segment.  With the queue full, a
    segment held in each receiver and the window's and sink's segments
    held by the consumer, the pool has made no block since the source
    was built."""
    ports = [free_udp_port(), free_udp_port()]
    window = 2
    cfg = source_config(baseband_reserve_sample=False,
                        inflight_segments=window,
                        udp_receiver_address=["127.0.0.1"],
                        udp_receiver_port=ports)
    src = udp.MultiUdpSource(cfg, use_native=False)
    n, capacity = len(ports), 2 * len(ports)
    held_at_once = n + capacity + window + 1
    # the receiver threads may have taken theirs already
    stats = src.pool.stats()
    assert stats["cached_blocks"] + stats["in_use"] == held_at_once
    assert stats["cached_bytes"] == stats["cached_blocks"] * 4 * P
    made = []
    new_block = src.pool._new_block
    monkeypatch.setattr(src.pool, "_new_block",
                        lambda nbytes: made.append(nbytes)
                        or new_block(nbytes))
    # more segments a port than the run can hold
    segments = held_at_once
    senders = [start_thread(send_datagrams, port, stream_datagrams(
        FASTMB, P, np.full(segments * 4 * P, k, np.uint8), 0))
        for k, port in enumerate(ports)]
    taken = []
    try:
        for _ in range(window + 1):
            taken.append(bounded(lambda: next(src), "segment"))

        def full():
            while src.pool.stats()["in_use"] < held_at_once:
                time.sleep(0.01)
        bounded(full, "the pool in use")
        assert src._queue._q.qsize() == capacity
        assert made == []
    finally:
        for t in senders:
            t.join(UDP_TIMEOUT_S)
        for work in taken:
            src.pool.release(work.data)
        bounded(src.close, "close")


# a process blocked in a native receive on a port no packet comes to;
# SIGINT must end it (the default handler raises KeyboardInterrupt)
_BLOCKED_RECEIVE = """
import sys
import numpy as np
from srtb_tpu_torch.io import formats, udp
rx = udp.NativeBlockReceiver("127.0.0.1", int(sys.argv[1]),
                             formats.resolve("fastmb_roach2"))
print("receiving", flush=True)
rx.receive_block(np.empty(4 * 4096, np.uint8))
"""


def _interrupt_when_blocked(argv, marker: str, tmp_path):
    """Start ``argv``, wait (bounded) for ``marker`` on its stdout or
    stderr, give it two seconds to block in its receive, send SIGINT and
    return its exit code and output; it must exit within 20 s."""
    import signal
    import subprocess
    import sys
    out = tmp_path / "out.txt"
    with open(out, "w") as f:
        proc = subprocess.Popen([sys.executable, *argv], stdout=f,
                                stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.dirname(
                                    os.path.abspath(__file__))))
    try:
        deadline = time.monotonic() + 120
        while marker not in out.read_text():
            assert proc.poll() is None, out.read_text()
            assert time.monotonic() < deadline, out.read_text()
            time.sleep(0.1)
        time.sleep(2)
        assert proc.poll() is None, out.read_text()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(20)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, out.read_text()


def test_native_receive_yields_to_sigint(tmp_path):
    """A native receive with no packet coming returns to the interpreter
    while it waits, so SIGINT's handler runs in the waiting thread: the
    process ends with KeyboardInterrupt raised in ``_receive_into``."""
    if not udp.native_available():
        pytest.skip("native recvmmsg receiver unavailable here "
                    "(udp.native_available(): the capability probe)")
    rc, text = _interrupt_when_blocked(
        ["-c", _BLOCKED_RECEIVE, str(free_udp_port())], "receiving",
        tmp_path)
    assert rc != 0 and "KeyboardInterrupt" in text, text
    assert "_receive_into" in text, text


def test_cli_on_udp_exits_on_sigint(tmp_path):
    """``srtb-torch-main`` on one UDP port (its default input), waiting
    for packets that never come, ends on SIGINT: the termination handler
    logs the signal with the interrupted stack (in the native receive's
    loop where recvmmsg works) and the process dies of it."""
    import signal
    argv = _main_cases(tmp_path)["one_port"] + [
        "--baseband_input_count", "65536", "--spectrum_channel_count",
        "1024", "--dm", " 1", "--device", "cpu"]
    rc, text = _interrupt_when_blocked(
        ["-m", "srtb_tpu_torch.tools.main", *argv], "nsamps_reserved",
        tmp_path)
    assert rc == -signal.SIGINT, text
    assert "received signal 2" in text, text
    if udp.native_available():
        assert "_receive_into" in text, text


def test_end_to_end_matches_reference(ref, tmp_path):
    """``Pipeline(cfg, source=UdpReceiverSource(cfg))`` at 2^16 samples on
    the CPU against the reference's on the same packets: decisions by
    packet counter, artifact names and ``.bin`` bytes exactly; ``.npy``
    and ``.tim`` within the file-mode test's gates; no packet lost."""
    cfg = e2e_config(tmp_path)
    got = paced_pipeline(udp, Pipeline, cfg, e2e_stream(), E2E_SEGMENTS,
                         E2E_PACE_S, str(tmp_path), device="cpu")
    assert got["lost_packets"] == 0 == int(ref["e2e/lost_packets"])
    assert got["reserved_bytes"] == 0 == int(ref["e2e/reserved_bytes"])
    np.testing.assert_array_equal(got["decisions"], ref["e2e/decisions"])
    assert got["decisions"][:, 1].tolist() == [0, 1, 0]
    assert got["files"].tolist() == ref["e2e/files"].tolist()
    bins = [n for n in got["files"] if n.endswith(".bin")]
    assert len(bins) == 1
    for name in bins:
        np.testing.assert_array_equal(got[f"bin/{name}"],
                                      ref[f"e2e/bin/{name}"])
    base = os.path.join(tmp_path, bins[0][:-len(".bin")])
    files = CandidateFiles(
        base + ".bin",
        sorted(os.path.join(tmp_path, n) for n in got["files"]
               if n.endswith(".npy")),
        sorted(os.path.join(tmp_path, n) for n in got["files"]
               if n.endswith(".tim")))
    check_candidate_contents(files, reference_arrays(ref, "e2e", "npy"),
                             reference_arrays(ref, "e2e", "tim"),
                             dd.nsamps_reserved(cfg))


def test_pipeline_reports_packet_counters(tmp_path):
    """The pipeline reports its UDP source's packets_total and
    packets_lost in ``stats.extras``; a file source has none."""
    cfg = e2e_config(tmp_path)
    port = free_udp_port()
    cfg = cfg.replace(udp_receiver_address=["127.0.0.1"],
                      udp_receiver_port=[port])
    src = udp.UdpReceiverSource(cfg)
    stream = e2e_stream()
    datagrams = stream_datagrams(FASTMB, P, stream, 0)
    del datagrams[5]  # one lost packet in segment 1
    sender = start_thread(send_datagrams, port, datagrams)
    with Pipeline(cfg, source=src, device="cpu") as pipe:
        stats = bounded(lambda: pipe.run(max_segments=2), "pipeline")
    sender.join(UDP_TIMEOUT_S)
    assert stats.extras["packets_total"] == 8
    assert stats.extras["packets_lost"] == 1


def test_real_time_writer_matches_reference(ref, tmp_path):
    """The candidate writer with real-time input, scripted: the
    piggyback of the other polarization, the re-check of the negative
    just kept and the cleanup of outdated positives write the same files
    (names and bytes) and leave the same queues as the reference's."""
    sink = WriteSignalSink(e2e_config(tmp_path))
    got = scripted_pushes(sink, SegmentResultWork, SegmentWork,
                          WRITER_SCRIPT, 64, str(tmp_path))
    _same(ref, "writer", got)
    assert sorted(got["files"].tolist()) == [
        "out_101.bin", "out_102.bin", "out_104.bin", "out_105.bin",
        "out_107.bin"]


class _ScriptedSource:
    """Segments from pool buffers with scripted timestamps: each byte
    array copied into a buffer the pool hands out (dirty, not cleared)."""

    def __init__(self, segments, timestamps):
        self.pool = BufferPool("segments")
        self._items = list(zip(segments, timestamps))
        self.handed = []

    def __iter__(self):
        return self

    def __next__(self) -> SegmentWork:
        if not self._items:
            raise StopIteration
        data, ts = self._items.pop(0)
        buf = self.pool.acquire(data.size, zero=False)
        buf[:] = data
        self.handed.append(buf.ctypes.data)
        return SegmentWork(data=buf, timestamp=ts,
                           udp_packet_counter=200 + len(self.handed))

    def close(self):
        pass


class _Tap:
    """A sink after the candidate writer: at each push the writer keeps
    no negative, and the segment's buffer holds its own bytes."""

    def __init__(self, writer, originals):
        self.writer, self.originals = writer, originals
        self.pushes = 0

    def push(self, work, has_signal):
        assert not self.writer.recent_negative_works
        i = work.segment.udp_packet_counter - 201
        np.testing.assert_array_equal(work.segment.data, self.originals[i])
        self.pushes += 1


def test_piggyback_writes_its_own_bytes_from_reused_buffers(tmp_path):
    """With real-time input the candidate writer keeps no segment past
    its push, so the pipeline hands every buffer back to the source's
    pool after the pushes and the pool hands it out again: the
    piggybacked candidate's ``.bin`` holds its own segment's bytes, and
    every buffer is back in the pool at the end."""
    cfg = e2e_config(tmp_path).replace(writer_thread_count=0,
                                       inflight_segments=1)
    stream = e2e_stream()
    seg_bytes = cfg.segment_bytes(1)
    originals = [stream[i * seg_bytes:(i + 1) * seg_bytes].copy()
                 for i in range(E2E_SEGMENTS)]
    originals.append(originals[0][::-1].copy())  # a fourth, noise
    # segment 2 lies within the piggyback window of the positive 1
    stamps = [0, 10**9, 10**9 + 1000, 3 * 10**9]
    src = _ScriptedSource(originals, stamps)
    pipe = Pipeline(cfg, source=src, device="cpu")
    tap = _Tap(pipe.sink, originals)
    pipe.sinks.append(tap)
    stats = bounded(pipe.run, "pipeline")
    assert pipe.positive_segments == [1] and stats.segments == 4
    assert tap.pushes == 4
    # the serial leg: each segment received into the buffer just freed
    assert len(set(src.handed)) == 1
    written = {os.path.basename(f.bin_path): f.bin_path
               for f in pipe.sink.written}
    assert sorted(written) == ["out_202.bin", "out_203.bin"]
    for name, path in written.items():
        i = int(name[4:7]) - 201
        np.testing.assert_array_equal(np.fromfile(path, np.uint8),
                                      originals[i])
    pipe.close()
    assert src.pool.stats()["in_use"] == 0


def test_write_signal_sink_keeps_no_negative_past_a_push(tmp_path):
    """The real-time writer's negative queue is empty after every push
    of the scripted sequence (a kept negative is popped by the re-check
    of the same push), so no segment buffer outlives its push."""
    sink = WriteSignalSink(e2e_config(tmp_path))
    for i, (ts, positive, stream) in enumerate(WRITER_SCRIPT):
        data = np.full(64, i, dtype=np.uint8)
        sink.push(SegmentResultWork(segment=SegmentWork(
            data=data, timestamp=ts, udp_packet_counter=100 + i,
            data_stream_id=stream)), positive)
        assert not sink.recent_negative_works, i
    assert len(sink.written) == 5


def _main_cases(tmp) -> dict:
    """CLI argument lists: an existing file, a missing one, an empty
    path with one port and with two (each a free loopback port)."""
    tmp.mkdir(parents=True, exist_ok=True)
    data = tmp / "baseband.bin"
    data.write_bytes(bytes(16))
    base = ["--config_file_name", str(tmp / "none.cfg"), "--gui_enable", "0",
            "--baseband_format_type", FASTMB, "--udp_receiver_address",
            "127.0.0.1", "--baseband_output_file_prefix", f"{tmp}/out_"]
    return {
        "file": base + ["--input_file_path", str(data)],
        "missing": base + ["--input_file_path", str(tmp / "missing.bin")],
        "one_port": base + ["--udp_receiver_port", str(free_udp_port())],
        "two_ports": base + ["--udp_receiver_port",
                             f"{free_udp_port()},{free_udp_port()}"],
    }


@pytest.mark.parametrize("name", ["file", "missing", "one_port",
                                  "two_ports"])
def test_cli_selects_the_references_input(ref, tmp_path, monkeypatch, name):
    """``srtb-torch-main`` chooses the file reader, ``UdpReceiverSource``
    or ``MultiUdpSource`` as ``srtb-main`` does (the pipeline stubbed on
    both sides); a missing file exits 1 and builds nothing."""
    chosen = []

    class Stub:
        def __init__(self, cfg, source=None, device=None):
            chosen.append("file" if source is None
                          else type(source).__name__)
            self.source = source

        def run(self):
            return PipelineStats()

        def close(self):
            if self.source is not None:
                self.source.close()
    monkeypatch.setattr(M, "Pipeline", Stub)
    argv = _main_cases(tmp_path)[name]
    rc = M.main(argv + ["--device", "cpu"])
    assert rc == int(ref[f"main/{name}/rc"])
    assert (chosen[0] if chosen else "") == str(ref[f"main/{name}/source"])


def test_baseband_receiver_appends_in_order(tmp_path):
    """``srtb-torch-baseband-receiver``: N loopback segments appended in
    order through the one-thread writer pool equal the sent bytes."""
    port = free_udp_port()
    cfg = source_config(baseband_reserve_sample=False,
                        udp_receiver_address=["127.0.0.1"],
                        udp_receiver_port=[port],
                        baseband_output_file_prefix=f"{tmp_path}/rec_")
    segments = 5
    rng = np.random.default_rng(3)
    stream = rng.integers(0, 256, segments * cfg.segment_bytes(1),
                          dtype=np.uint8)
    sender = start_thread(send_datagrams, port,
                          stream_datagrams(FASTMB, P, stream, 77), 0.0005)
    n = bounded(lambda: BR.record(cfg, max_segments=segments), "recorder")
    sender.join(UDP_TIMEOUT_S)
    assert n == segments
    got = np.fromfile(tmp_path / "rec_recorded.bin", dtype=np.uint8)
    np.testing.assert_array_equal(got, stream)


def test_ordered_appends_need_one_thread(tmp_path):
    """The writer pool appends in submission order on one thread (native
    and Python) and refuses appends with more threads."""
    from srtb_tpu_torch.io.native_writer import AsyncWriterPool
    for native in (True, False):
        path = str(tmp_path / f"a_{native}.bin")
        with AsyncWriterPool(1, prefer_native=native) as pool:
            for i in range(20):
                pool.submit(path, bytes([i]) * (i + 1), append=True)
        assert open(path, "rb").read() == b"".join(
            bytes([i]) * (i + 1) for i in range(20))
        with AsyncWriterPool(2, prefer_native=native) as pool, \
                pytest.raises(ValueError, match="n_threads=1"):
            pool.submit(path, b"x", append=True)


def test_affinity_pins_the_calling_thread():
    from srtb_tpu_torch.utils.affinity import set_thread_affinity
    out = []

    def body():
        cpu = sorted(os.sched_getaffinity(0))[0]
        out.append((set_thread_affinity(cpu), os.sched_getaffinity(0), cpu))
    t = threading.Thread(target=body)
    t.start()
    t.join(UDP_TIMEOUT_S)
    ok, mask, cpu = out[0]
    assert ok and mask == {cpu}
