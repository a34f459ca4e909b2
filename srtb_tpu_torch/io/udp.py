"""UDP baseband ingest (port of ``srtb_tpu/io/udp.py``).

Python interface over the port's native C++ receivers
(``srtb_tpu_torch/native/udp_receiver.cpp``, batched ``recvmmsg``, and
``native/packet_ring.cpp``, an AF_PACKET TPACKET_V3 ring), built with
the host compiler at first use, and pure-Python socket receivers with the
same block-assembly semantics (counter placement, reorder tolerance
within a block, zero-fill of lost packets with loss accounting — ref:
io/udp/udp_receiver.hpp:180-272).

``UdpReceiverSource`` is the equivalent of udp_receiver_pipe
(ref: pipeline/udp_receiver_pipe.hpp): one receiver per (address, port)
pair, yielding full segments stamped with timestamp and first packet
counter.  Where the port differs from the reference:

- **buffers**: a segment is received straight into a buffer of the
  source's ``pool`` (``utils/bufferpool.py``; pinned when a card is
  present, so that the engine's upload reads it directly), acquired
  without clearing: the receivers zero the slots of lost packets
  themselves when a block closes.  Whoever consumes a segment releases
  its buffer there;
- **the native wait**: the recvmmsg receiver waits for a batch's first
  packet by poll() and then takes what is queued with ``MSG_DONTWAIT``,
  where the reference passes ``MSG_WAITFORONE`` (refused by a gVisor
  sandbox), and the capability probe tries that call shape.  Both native
  receivers return to Python at least every 100 ms while they wait
  (``_receive_into`` calls again and they resume the block), so that a
  receiver on the main thread lets the interpreter run a SIGINT or
  SIGTERM handler even when no packet comes;
- **loss counters**: ``packets_total`` and ``packets_lost`` are counted
  by the source (the pipeline reports them in ``stats.extras``) and, as
  the reference counts them, in the metrics registry with their 10 s
  windows (``packet_loss_rate_window``) and the lost packets' twin
  labeled by stream, with the reference's ``[udp_receiver] lost ...``
  warning; with the asyncio provider the source also sets the gauge
  ``udp_rx{id}_queue_packets`` to the receiver's queue depth after each
  block.
"""

from __future__ import annotations

import collections
import ctypes
import errno
import functools
import os
import socket
import threading
import time

import numpy as np

from srtb_tpu_torch.config import Config
from srtb_tpu_torch.io import formats
from srtb_tpu_torch.io.overlap import OverlapTailCarry
from srtb_tpu_torch.pipeline.work import SegmentWork
from srtb_tpu_torch.utils import termination
from srtb_tpu_torch.utils.bufferpool import BufferPool
from srtb_tpu_torch.utils.logging import log
from srtb_tpu_torch.utils.metrics import metrics

COUNTER_LE64 = 0
COUNTER_VDIF67 = 1

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)


@functools.cache
def native_library() -> ctypes.CDLL:
    """The recvmmsg receiver library, built on first use."""
    from srtb_tpu_torch.kernels import build
    lib = ctypes.CDLL(str(build.build_host_library("udp_receiver")))
    lib.srtb_udp_rx_create.restype = ctypes.c_void_p
    lib.srtb_udp_rx_create.argtypes = [
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_int64]
    lib.srtb_udp_rx_receive_block.restype = ctypes.c_int32
    lib.srtb_udp_rx_receive_block.argtypes = [
        ctypes.c_void_p, _U8P, ctypes.c_uint64, _U64P, _U64P, _U64P]
    for name in ("srtb_udp_rx_total_packets", "srtb_udp_rx_lost_packets"):
        getattr(lib, name).restype = ctypes.c_uint64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.srtb_udp_rx_fd.restype = ctypes.c_int32
    lib.srtb_udp_rx_fd.argtypes = [ctypes.c_void_p]
    lib.srtb_udp_rx_shutdown.restype = None
    lib.srtb_udp_rx_shutdown.argtypes = [ctypes.c_void_p]
    lib.srtb_udp_rx_destroy.restype = None
    lib.srtb_udp_rx_destroy.argtypes = [ctypes.c_void_p]
    return lib


@functools.cache
def ring_library() -> ctypes.CDLL:
    """The AF_PACKET ring library, built on first use."""
    from srtb_tpu_torch.kernels import build
    lib = ctypes.CDLL(str(build.build_host_library("packet_ring")))
    lib.srtb_pkt_ring_create.restype = ctypes.c_void_p
    lib.srtb_pkt_ring_create.argtypes = [
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_uint32, ctypes.c_uint32]
    lib.srtb_pkt_ring_receive_block.restype = ctypes.c_int32
    lib.srtb_pkt_ring_receive_block.argtypes = [
        ctypes.c_void_p, _U8P, ctypes.c_uint64, _U64P, _U64P, _U64P]
    for name in ("srtb_pkt_ring_total_packets",
                 "srtb_pkt_ring_lost_packets"):
        getattr(lib, name).restype = ctypes.c_uint64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.srtb_pkt_ring_destroy.restype = None
    lib.srtb_pkt_ring_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _built(loader) -> bool:
    """Whether a native library builds and loads here."""
    try:
        loader()
        return True
    except (OSError, RuntimeError) as e:
        log.warning(f"[udp] native library unavailable: {e}")
        return False


# capability probe result, resolved once per process (None = unprobed)
_RECVMMSG_OK: bool | None = None


def _probe_recvmmsg() -> bool:
    """Whether the recvmmsg(2) syscall actually works here.

    A built library says nothing about the *kernel*: sandboxed CI
    (gVisor/seccomp) accepts plain recvfrom but may fail recvmmsg with
    EINVAL/ENOSYS.  Probe a throwaway loopback socket with a real
    datagram queued, in the native receiver's exact call shape
    (``MSG_DONTWAIT`` after a poll).  The reference's receiver and probe
    use ``MSG_WAITFORONE``, which a gVisor sandbox refuses with EINVAL
    while it takes ``MSG_DONTWAIT``; the port's receiver waits by poll()
    instead, to the same effect."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        recvmmsg = libc.recvmmsg
    except (OSError, AttributeError):
        return False

    class _Iovec(ctypes.Structure):
        _fields_ = [("iov_base", ctypes.c_void_p),
                    ("iov_len", ctypes.c_size_t)]

    class _Msghdr(ctypes.Structure):
        _fields_ = [("msg_name", ctypes.c_void_p),
                    ("msg_namelen", ctypes.c_uint32),
                    ("msg_iov", ctypes.POINTER(_Iovec)),
                    ("msg_iovlen", ctypes.c_size_t),
                    ("msg_control", ctypes.c_void_p),
                    ("msg_controllen", ctypes.c_size_t),
                    ("msg_flags", ctypes.c_int)]

    class _Mmsghdr(ctypes.Structure):
        _fields_ = [("msg_hdr", _Msghdr), ("msg_len", ctypes.c_uint)]

    import select

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.bind(("127.0.0.1", 0))
        # deliver a real datagram first: some sandboxes answer EAGAIN on
        # an empty queue (looks supported) and fail EINVAL only once
        # recvmmsg has a message to deliver
        tx.sendto(b"probe", sock.getsockname())
        if not select.select([sock], [], [], 2.0)[0]:
            return False  # loopback delivery itself is broken here
        buf = ctypes.create_string_buffer(16)
        iov = _Iovec(ctypes.cast(buf, ctypes.c_void_p), len(buf))
        mm = _Mmsghdr()
        mm.msg_hdr.msg_iov = ctypes.pointer(iov)
        mm.msg_hdr.msg_iovlen = 1
        rc = recvmmsg(sock.fileno(), ctypes.byref(mm), 1,
                      socket.MSG_DONTWAIT, None)
        return rc >= 1
    except OSError:
        return False
    finally:
        tx.close()
        sock.close()


def native_available() -> bool:
    """True when the native recvmmsg block receiver is usable: the library
    builds AND the kernel/sandbox implements recvmmsg.  The single
    capability gate for auto-selection (``UdpReceiverSource``) and for
    test skips; an explicit ``use_native=True`` against a False probe
    raises a clear OSError instead of failing mid-receive."""
    global _RECVMMSG_OK
    if not _built(native_library):
        return False
    if _RECVMMSG_OK is None:
        _RECVMMSG_OK = _probe_recvmmsg()
        if not _RECVMMSG_OK:
            log.warning("[udp] recvmmsg unavailable in this environment "
                        "(sandbox?): native receiver disabled, Python "
                        "fallback selected")
    return _RECVMMSG_OK


def counter_kind_for(fmt: formats.PacketFormat) -> int:
    return COUNTER_VDIF67 if fmt.name.startswith("gznupsr") else COUNTER_LE64


def parse_packet_counter(fmt: formats.PacketFormat, pkt: bytes) -> int:
    """Packet counter from the header (LE64 at offset 0, or VDIF words
    6|7 for gznupsr formats — ref: io/udp/udp_receiver.hpp backends): the
    format's own parser."""
    return fmt.parse_packet(pkt)[0]


def _zero_unfilled(out: np.ndarray, slot_filled: bytearray,
                   payload: int) -> None:
    """Zero the payload slots no packet filled (the buffer is not cleared
    before a block, as in the native receivers)."""
    lost = np.frombuffer(slot_filled, dtype=np.uint8) == 0
    if lost.any():
        out.reshape(-1, payload)[lost] = 0


# a native receive_block's codes for "still waiting, call again"
_WAITING = (-errno.EINTR, -errno.EAGAIN)


def _receive_into(fn, handle, out: np.ndarray, what: str):
    """One block from a native receiver.  The receiver returns while it
    waits (a signal, or 100 ms with no packet) with the block left open;
    between the calls the interpreter runs the pending signal handlers
    (PEP 475), and the next call resumes the block."""
    first = ctypes.c_uint64()
    lost = ctypes.c_uint64()
    total = ctypes.c_uint64()
    ptr = out.ctypes.data_as(_U8P)
    rc = _WAITING[0]
    while rc in _WAITING:
        rc = fn(handle, ptr, out.nbytes, ctypes.byref(first),
                ctypes.byref(lost), ctypes.byref(total))
    if rc != 0:
        raise OSError(f"{what} failed rc={rc}")
    return first.value, lost.value, total.value


def _socket_rcvbuf(fd: int) -> int:
    """The SO_RCVBUF the kernel granted the socket ``fd``."""
    s = socket.socket(fileno=os.dup(fd))
    try:
        return s.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
    finally:
        s.close()


def _socket_port(fd: int) -> int:
    """The UDP port the socket ``fd`` is bound to."""
    s = socket.socket(fileno=os.dup(fd))
    try:
        return s.getsockname()[1]
    finally:
        s.close()


class NativeBlockReceiver:
    """Block receiver backed by the C++ recvmmsg implementation."""

    def __init__(self, addr: str, port: int, fmt: formats.PacketFormat,
                 rcvbuf_bytes: int = 1 << 28):
        self._lib = native_library()
        if not native_available():
            raise OSError(
                "recvmmsg syscall unavailable in this environment "
                "(sandboxed kernel?) — use the Python receiver "
                "(use_native=False / udp_packet_provider='recvfrom')")
        self._h = self._lib.srtb_udp_rx_create(
            addr.encode(), port, fmt.packet_payload_size,
            fmt.packet_header_size, counter_kind_for(fmt), rcvbuf_bytes)
        if not self._h:
            raise OSError(f"cannot bind UDP {addr}:{port}")
        self.fmt = fmt

    def receive_block(self, out: np.ndarray) -> tuple[int, int, int]:
        """Fill ``out`` (uint8, multiple of payload size) with one block.
        Returns (first_counter, lost, total)."""
        return _receive_into(self._lib.srtb_udp_rx_receive_block, self._h,
                             out, "receive_block")

    @property
    def total_packets(self) -> int:
        return self._lib.srtb_udp_rx_total_packets(self._h)

    @property
    def lost_packets(self) -> int:
        return self._lib.srtb_udp_rx_lost_packets(self._h)

    @property
    def rcvbuf_bytes(self) -> int:
        """The socket's receive buffer as the kernel granted it."""
        return _socket_rcvbuf(self._lib.srtb_udp_rx_fd(self._h))

    @property
    def port(self) -> int:
        """The port bound (the one the OS gave for port 0)."""
        return _socket_port(self._lib.srtb_udp_rx_fd(self._h))

    def shutdown(self) -> None:
        """Wake a thread blocked in ``receive_block`` (it raises)."""
        if self._h:
            self._lib.srtb_udp_rx_shutdown(self._h)

    def close(self):
        if self._h:
            self._lib.srtb_udp_rx_destroy(self._h)
            self._h = None


class PacketRingReceiver:
    """Block receiver over an AF_PACKET TPACKET_V3 RX ring
    (``native/packet_ring.cpp``): the kernel fills a mmap'd ring and
    wakes userspace once per block, so capture costs no per-packet
    syscalls.  Working equivalent of the reference's packet_mmap v3
    provider, which is marked broken upstream
    (ref: io/udp/packet_mmap_v3_provider.hpp:61-65).  Requires
    CAP_NET_RAW; captures on an *interface* (default loopback), filtering
    UDP datagrams by destination port and exact size."""

    def __init__(self, addr: str, port: int, fmt: formats.PacketFormat,
                 interface: str = "lo",
                 block_size: int = 1 << 20, block_count: int = 64):
        del addr  # L2 capture binds an interface, not an address
        self._lib = ring_library()
        self._h = self._lib.srtb_pkt_ring_create(
            interface.encode(), port, fmt.packet_payload_size,
            fmt.packet_header_size, counter_kind_for(fmt),
            block_size, block_count)
        if not self._h:
            raise OSError(
                f"cannot create AF_PACKET ring on {interface!r} "
                f"(needs CAP_NET_RAW)")
        self.fmt = fmt
        # the ring filters on the port given here: it takes no port 0
        self.port = port
        # Hold the UDP port open (never read): without a bound socket the
        # kernel answers every datagram with ICMP port-unreachable, and a
        # *connected* sender then fails alternate send()s with
        # ECONNREFUSED — an exact 50% "loss" that never hit the wire.  A
        # minimal rcvbuf keeps the dead socket cheap.
        self._port_holder = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._port_holder.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR,
                                     1)
        try:
            self._port_holder.setsockopt(socket.SOL_SOCKET,
                                         socket.SO_RCVBUF, 4096)
        except OSError:
            pass
        try:
            self._port_holder.bind(("", port))
        except OSError:
            self._port_holder.close()
            self._port_holder = None  # port already held elsewhere: fine

    def receive_block(self, out: np.ndarray) -> tuple[int, int, int]:
        return _receive_into(self._lib.srtb_pkt_ring_receive_block,
                             self._h, out, "ring receive_block")

    @property
    def total_packets(self) -> int:
        return self._lib.srtb_pkt_ring_total_packets(self._h)

    @property
    def lost_packets(self) -> int:
        return self._lib.srtb_pkt_ring_lost_packets(self._h)

    def close(self):
        if self._h:
            self._lib.srtb_pkt_ring_destroy(self._h)
            self._h = None
        if getattr(self, "_port_holder", None) is not None:
            self._port_holder.close()
            self._port_holder = None


class _SocketReceiver:
    """A bound UDP socket with the requested receive buffer, and its
    shutdown: a receiver blocked on it raises instead of spinning on the
    empty reads a shut-down socket returns."""

    def _bind(self, addr: str, port: int, rcvbuf_bytes: int) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if port:
            # a fixed port may be shared; port 0 asks the OS for one of
            # its own, and with SO_REUSEADDR its search may hand out a
            # port that another SO_REUSEADDR socket holds
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                  rcvbuf_bytes)
        except OSError:
            pass
        self._sock.bind((addr, port))
        # the port bound (the one the OS gave for port 0)
        self.port = self._sock.getsockname()[1]
        self._shut = False

    def _recv(self, size: int) -> bytes:
        pkt, _ = self._sock.recvfrom(size)
        if not pkt and self._shut:
            raise OSError("UDP receiver shut down")
        return pkt

    def shutdown(self) -> None:
        """Wake a thread blocked on the socket (it raises)."""
        self._shut = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # unconnected UDP: ENOTCONN, the readers wake all the same

    def close(self):
        self._sock.close()


class PythonBlockReceiver(_SocketReceiver):
    """Same semantics in pure Python (the reference's asio/recvfrom
    providers play this role: a slower but portable fallback)."""

    def __init__(self, addr: str, port: int, fmt: formats.PacketFormat,
                 rcvbuf_bytes: int = 1 << 26):
        self.fmt = fmt
        self._bind(addr, port, rcvbuf_bytes)
        self._pending: tuple[int, bytes] | None = None
        self._next_counter: int | None = None
        self.total_packets = 0
        self.lost_packets = 0

    def _next_packet(self) -> bytes:
        """Blocking fetch of one full-size packet (overridden by the
        asyncio provider; the base class reads the socket directly)."""
        while True:
            pkt = self._recv(self.fmt.packet_payload_size + 64)
            if len(pkt) >= self.fmt.packet_payload_size:
                return pkt

    def receive_block(self, out: np.ndarray) -> tuple[int, int, int]:
        fmt = self.fmt
        payload = fmt.payload_bytes
        assert out.nbytes % payload == 0
        packets_per_block = out.nbytes // payload
        begin = self._next_counter
        filled = 0
        seen = 0
        # per-slot fill map: a duplicated counter must not inflate the
        # fill count, or the block closes early with a silently-zeroed
        # slot and lost = 0
        slot_filled = bytearray(packets_per_block)
        while True:
            if self._pending is not None:
                c, pkt = self._pending
                self._pending = None
            else:
                pkt = self._next_packet()
                c = parse_packet_counter(fmt, pkt)
            if begin is None:
                begin = c
            if c < begin:
                continue
            slot = c - begin
            if slot >= packets_per_block:
                self._pending = (c, pkt)
                break
            start = slot * payload
            out[start:start + payload] = np.frombuffer(
                pkt, dtype=np.uint8,
                count=payload, offset=fmt.packet_header_size)
            if not slot_filled[slot]:
                slot_filled[slot] = 1
                filled += 1
            seen += 1
            if filled == packets_per_block:
                break
        _zero_unfilled(out, slot_filled, payload)
        self._next_counter = begin + packets_per_block
        lost = packets_per_block - filled
        self.total_packets += seen
        self.lost_packets += lost
        return begin, lost, packets_per_block


class AsyncioBlockReceiver(PythonBlockReceiver):
    """Event-loop packet provider: the analog of the reference's
    boost::asio provider (ref: io/udp/asio_udp_packet_provider.hpp:1-66,
    an io_context-driven receive_from on the same socket the other
    providers use).  Packets are received by an asyncio
    ``DatagramProtocol`` on a dedicated event-loop thread and handed to
    the block assembler (inherited from :class:`PythonBlockReceiver`)
    through a bounded deque; on overflow the oldest packet is dropped and
    surfaces as counter-gap loss, exactly like a kernel buffer drop.
    """

    def __init__(self, addr: str, port: int, fmt: formats.PacketFormat,
                 rcvbuf_bytes: int = 1 << 26, queue_packets: int = 8192):
        super().__init__(addr, port, fmt, rcvbuf_bytes)
        self._q: "collections.deque[bytes]" = collections.deque()
        self._q_max = queue_packets
        self._cv = threading.Condition()
        self._loop = None
        self._transport = None
        self._closed = False
        self._startup_error: BaseException | None = None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run_loop,
                                        name="srtb-asyncio-udp",
                                        daemon=True)
        termination.tag_thread(self._thread)
        self._thread.start()
        # bounded wait + error propagation: a loop-setup failure (e.g. fd
        # exhaustion while creating the selector) surfaces here instead
        # of hanging the constructor
        self._ready.wait(timeout=10)
        if self._startup_error is not None or not self._ready.is_set():
            err = self._startup_error
            self.close()  # release the bound socket, reap the thread
            if err is not None:
                raise RuntimeError(
                    "asyncio UDP provider failed to start") from err
            raise RuntimeError("asyncio UDP provider startup timed out")

    def _run_loop(self):
        import asyncio

        outer = self

        class _Proto(asyncio.DatagramProtocol):
            def datagram_received(self, data, _addr):
                with outer._cv:
                    if len(outer._q) >= outer._q_max:
                        outer._q.popleft()
                    outer._q.append(data)
                    outer._cv.notify()

        loop = None
        try:
            loop = asyncio.new_event_loop()
            self._loop = loop
            self._sock.setblocking(False)
            transport, _ = loop.run_until_complete(
                loop.create_datagram_endpoint(_Proto, sock=self._sock))
            self._transport = transport
        except BaseException as e:  # propagated by __init__
            self._startup_error = e
            # run_forever is never reached: release the selector fd here
            # and clear self._loop so close() does not call_soon_threadsafe
            # on a closed loop
            self._loop = None
            if loop is not None:
                loop.close()
            self._ready.set()
            return
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            transport.close()
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()

    def queue_depth(self) -> int:
        """Packets waiting between the event loop and the block assembler
        (the provider's ring occupancy; at the queue's bound the oldest
        packet is dropped as loss)."""
        with self._cv:
            return len(self._q)

    def _next_packet(self) -> bytes:
        need = self.fmt.packet_payload_size
        while True:
            with self._cv:
                while not self._q:
                    if self._closed:
                        # as the recvfrom provider, whose blocked syscall
                        # raises when the socket is shut down
                        raise OSError("asyncio UDP provider closed")
                    self._cv.wait()
                pkt = self._q.popleft()
            if len(pkt) >= need:
                return pkt

    def shutdown(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()  # unblock a consumer in _next_packet

    def close(self):
        self.shutdown()
        loop = self._loop  # snapshot: the worker's error path nulls and
        if loop is not None:  # closes it concurrently with this check
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:  # loop already closed by the worker
                pass
        if self._thread.is_alive():
            # join even when the loop never came up (startup timeout):
            # the thread may still hold self._sock
            self._thread.join(timeout=5)
        self._loop = None
        # the datagram transport owns (and closed) self._sock; the base
        # close covers startup failures where it never took ownership
        try:
            super().close()
        except OSError:  # pragma: no cover
            pass


class PythonContinuousReceiver(_SocketReceiver):
    """The reference's *continuous* receive worker
    (continuous_udp_receiver_worker, ref: io/udp/udp_receiver.hpp:42-168),
    as opposed to the block worker above: packets are consumed strictly
    sequentially, a packet's payload may straddle block boundaries (the
    unread tail carries over to the next call), and lost packets are
    zero-filled inline — ``lost * payload`` zeros injected exactly where
    the missing data would have been, also carrying across calls.  This
    keeps the delivered byte stream gap-free and continuous, at the cost
    of no reorder tolerance.

    Deviation from the reference, kept from the JAX package: a
    late/duplicate packet (counter <= last seen) is dropped instead of
    underflowing the unsigned lost-count arithmetic
    (udp_receiver.hpp:135 would zero-fill ~2^64 bytes).
    """

    def __init__(self, addr: str, port: int, fmt: formats.PacketFormat,
                 rcvbuf_bytes: int = 1 << 26):
        self.fmt = fmt
        self._bind(addr, port, rcvbuf_bytes)
        self._leftover = b""     # unread payload tail of the last packet
        self._zeros_pending = 0  # zero-fill bytes still owed to the stream
        self._last_counter: int | None = None
        self.total_packets = 0
        self.lost_packets = 0

    def receive_block(self, out: np.ndarray) -> tuple[int, int, int]:
        """Fill ``out`` (uint8, any size) with the next stretch of the
        continuous stream.  Returns (block_counter, lost,
        packets_received_this_call).

        ``block_counter`` is the counter of the packet the block's FIRST
        BYTE belongs to — when the block opens with carried-over payload
        it is the carried packet's counter, and when it opens inside a
        zero-filled gap it is the (lost) counter that gap stands for.
        (The reference returns the first counter *received during the
        call* instead, udp_receiver.hpp:77-86; that labels straddled
        segments off by the carryover length, so ``counter * payload``
        time reconstruction would drift: the JAX package's deliberate
        improvement, kept.)
        """
        fmt = self.fmt
        payload = fmt.payload_bytes
        cap = out.nbytes
        pos = 0
        if self._zeros_pending > 0 and self._last_counter is not None:
            # block opens inside the zero-filled gap that precedes
            # _last_counter's payload: gap packets count back from it
            gap_packets = -(-self._zeros_pending // payload)  # ceil
            first_counter = self._last_counter - gap_packets
        elif self._leftover:
            first_counter = self._last_counter
        else:
            first_counter = None  # set by the first packet received
        seen = 0
        lost_this = 0
        while pos < cap:
            if self._zeros_pending > 0:
                k = min(self._zeros_pending, cap - pos)
                out[pos:pos + k] = 0
                self._zeros_pending -= k
                pos += k
            elif self._leftover:
                k = min(len(self._leftover), cap - pos)
                out[pos:pos + k] = np.frombuffer(self._leftover, np.uint8,
                                                 count=k)
                self._leftover = self._leftover[k:]
                pos += k
            else:
                pkt = self._recv(fmt.packet_payload_size + 64)
                if len(pkt) < fmt.packet_payload_size:
                    continue
                c = parse_packet_counter(fmt, pkt)
                if self._last_counter is None:
                    lost = 0
                elif c > self._last_counter:
                    lost = c - self._last_counter - 1
                else:
                    continue  # late/duplicate: stream already moved past
                if first_counter is None:
                    first_counter = c
                seen += 1
                lost_this += lost
                self._zeros_pending += lost * payload
                self._last_counter = c
                self._leftover = pkt[
                    fmt.packet_header_size:fmt.packet_header_size + payload]
        self.total_packets += seen
        self.lost_packets += lost_this
        if first_counter is None:
            first_counter = self._last_counter or 0
        return first_counter, lost_this, seen


def _default_pool() -> BufferPool:
    """The segments' pool: pinned when a card is present, so that the
    engine's upload reads the received bytes directly."""
    import torch
    return BufferPool("segments", pinned=torch.cuda.is_available())


def _warm(pool: BufferPool, nbytes: int, count: int) -> None:
    """Allocate the ``count`` buffers a run holds at once now: a pinned
    allocation takes 0.5-5 s a GB, which between two receives would
    overflow the socket buffer."""
    bufs = [pool.acquire(nbytes, zero=False) for _ in range(count)]
    for buf in bufs:
        pool.release(buf)


class UdpReceiverSource:
    """Yields SegmentWork blocks from a UDP stream
    (ref: pipeline/udp_receiver_pipe.hpp:106-155), each received into a
    buffer of ``pool`` (the consumer releases it there).  Without a
    ``buffer_pool`` the source makes its pool and allocates in it the
    buffers a run holds at once (the engine's window, the sink's segment
    and the one receiving); a given pool is its maker's to fill."""

    def __init__(self, cfg: Config, receiver_id: int = 0,
                 use_native: bool | None = None,
                 buffer_pool: BufferPool | None = None):
        self.cfg = cfg
        self.fmt = formats.resolve(cfg.baseband_format_type)
        if self.fmt.packet_payload_size == 0:
            raise ValueError(
                f"format {self.fmt.name} has no packet structure")
        addr = cfg.udp_receiver_address[
            min(receiver_id, len(cfg.udp_receiver_address) - 1)]
        port = cfg.udp_receiver_port[
            min(receiver_id, len(cfg.udp_receiver_port) - 1)]
        mode = cfg.udp_receiver_mode
        if mode not in ("block", "continuous"):
            raise ValueError(f"unknown udp_receiver_mode {mode!r}")
        provider = cfg.udp_packet_provider
        if provider not in ("recvmmsg", "packet_ring", "recvfrom",
                            "asyncio"):
            raise ValueError(f"unknown udp_packet_provider {provider!r}")
        if provider == "asyncio":
            if mode == "continuous":
                raise ValueError(
                    "udp_packet_provider='asyncio' implements the block "
                    "worker only (like the reference's asio provider it "
                    "is an alternative packet transport, not a worker)")
            if use_native:
                raise ValueError(
                    "use_native=True contradicts udp_packet_provider="
                    "'asyncio' (the event-loop Python provider)")
        if mode == "continuous" and provider == "packet_ring":
            # refuse rather than silently downgrade: the operator asked
            # for the zero-loss ring but the continuous worker is the
            # pure-Python sequential receiver
            raise ValueError(
                "udp_packet_provider='packet_ring' requires "
                "udp_receiver_mode='block' (the continuous worker is the "
                "Python sequential receiver)")
        if use_native and provider == "recvfrom":
            raise ValueError(
                "use_native=True contradicts udp_packet_provider="
                "'recvfrom' (the Python fallback)")
        if provider == "packet_ring" and mode == "block" and (
                use_native is False or not _built(ring_library)):
            # refuse-don't-downgrade, as above: an explicit ring request
            # must not silently become the lossy recvfrom fallback
            raise ValueError(
                "udp_packet_provider='packet_ring' needs the native "
                "library (native/packet_ring.cpp, built by the host "
                "compiler) and use_native != False")
        if use_native is None:
            if provider == "packet_ring":
                # the AF_PACKET ring has its own syscalls (and its own
                # OSError on failure): recvmmsg is irrelevant to it
                use_native = True
            else:
                # auto-selection consults the capability probe, not just
                # the library: a sandbox without recvmmsg falls back to
                # the Python block receiver instead of erroring
                # mid-stream
                use_native = (mode == "block"
                              and provider not in ("recvfrom", "asyncio")
                              and native_available())
        rcvbuf = int(cfg.udp_receiver_rcvbuf_bytes)
        if mode == "continuous":
            # the continuous worker is sequential by construction; the
            # native recvmmsg path implements only the block worker (its
            # batching conflicts with strict in-order straddling)
            self.receiver = PythonContinuousReceiver(
                addr, port, self.fmt, rcvbuf_bytes=rcvbuf)
        elif use_native and provider == "packet_ring":
            self.receiver = PacketRingReceiver(
                addr, port, self.fmt,
                interface=cfg.udp_packet_ring_interface)
        elif use_native:
            self.receiver = NativeBlockReceiver(addr, port, self.fmt,
                                                rcvbuf_bytes=rcvbuf)
        elif provider == "asyncio":
            self.receiver = AsyncioBlockReceiver(addr, port, self.fmt,
                                                 rcvbuf_bytes=rcvbuf)
        else:
            self.receiver = PythonBlockReceiver(addr, port, self.fmt,
                                                rcvbuf_bytes=rcvbuf)
        self.pool = _default_pool() if buffer_pool is None \
            else buffer_pool
        self.data_stream_id = receiver_id
        self.packets_total = 0
        self.packets_lost = 0
        self.segment_bytes = cfg.segment_bytes(self.fmt.data_stream_count)
        payload = self.fmt.payload_bytes
        if mode == "block" and self.segment_bytes % payload:
            # the continuous worker straddles packet payloads across
            # segments, so it has no multiple-of-payload requirement
            raise ValueError(
                f"segment bytes {self.segment_bytes} not a multiple of "
                f"packet payload {payload}")
        # Overlap-save for the real-time source: with
        # baseband_reserve_sample active, consecutive segments overlap by
        # the reserved tail (exactly like the file reader's seek-back) so
        # that the edge each segment trims is processed by the next one.
        # The tail is retained in host memory and only the stride's new
        # bytes are received per segment.
        from srtb_tpu_torch.ops import dedisperse as dd
        nsamps = dd.nsamps_reserved(cfg)
        bits = abs(cfg.baseband_input_bits)
        reserved = int(nsamps * bits // 8 * self.fmt.data_stream_count)
        self.reserved_bytes = 0
        seq_valid = True
        if reserved > 0:
            # the reserved tail is DM/bandwidth math rounded to waterfall
            # tiles, so payload alignment holds only for cooperating
            # configs.  A misaligned config keeps non-overlapping block
            # framing with a warning, and its segments are left
            # UNSTAMPED (seq = -1) so the engine's adjacency guard keeps
            # the ingest ring cold rather than warm-assembling
            # non-overlapping blocks against a carry that is not their
            # head.
            problems = []
            if (nsamps * bits) % 8:
                problems.append(f"reserved samples {nsamps} not "
                                f"byte-aligned at {bits}-bit samples")
            if reserved >= self.segment_bytes:
                problems.append(f"reserved bytes {reserved} >= "
                                f"segment {self.segment_bytes}")
            if mode == "block" \
                    and (self.segment_bytes - reserved) % payload:
                problems.append(
                    f"stride {self.segment_bytes - reserved} not a "
                    f"multiple of the packet payload {payload} "
                    "(align spectrum_channel_count / segment size to "
                    "enable overlap)")
            if problems:
                log.warning(
                    "[udp_receiver] overlap-save disabled ("
                    + "; ".join(problems) + "): segments will NOT "
                    "overlap and the ingest ring stays cold for this "
                    "source")
                seq_valid = False
            else:
                self.reserved_bytes = reserved
        self.stride_bytes = self.segment_bytes - self.reserved_bytes
        self._carry = OverlapTailCarry(self.reserved_bytes,
                                       stamp_seq=seq_valid)
        self._own_pool = buffer_pool is None
        if self._own_pool:
            _warm(self.pool, self.segment_bytes,
                  max(1, cfg.inflight_segments) + 2)

    @property
    def port(self) -> int:
        """The port the receiver is bound to (the one the OS gave for a
        configured port 0)."""
        return self.receiver.port

    def reserve_buffers(self, held: int) -> None:
        """Allocate now the buffers of a consumer that holds up to
        ``held`` segments at once, the one receiving included (the
        threaded engine's graph): a pinned allocation between two
        receives would overflow the socket buffer.  A pool passed in is
        its maker's to fill."""
        if self._own_pool:
            _warm(self.pool, self.segment_bytes, held)

    def __iter__(self):
        return self

    def __next__(self) -> SegmentWork:
        buf = self.pool.acquire(self.segment_bytes, zero=False)
        try:
            # warm: head = retained tail of the previous segment; the
            # receiver fills only the stride's new bytes in place
            reserved = self._carry.head_into(buf)
            first_counter, lost, total = self.receiver.receive_block(
                buf[reserved:] if reserved else buf)
        except BaseException:
            self.pool.release(buf)
            raise
        if reserved:
            # the segment's first byte belongs to a packet reserved_bytes
            # earlier than the first freshly received one (exact in block
            # mode, where reserved is a payload multiple; floor-
            # approximate for a mid-packet continuous tail)
            first_counter -= reserved // self.fmt.payload_bytes
        if self.reserved_bytes > 0:
            self._carry.retain(buf)
        self.packets_total += total
        self.packets_lost += lost
        metrics.add("packets_total", total)
        metrics.add("packets_lost", lost)
        metrics.window("packets_total").add(total)
        metrics.window("packets_lost").add(lost)
        if lost:
            # whose packets: the stream's name, else the receiver's id
            origin = (str(self.cfg.stream_name or "")
                      or str(self.data_stream_id))
            metrics.add("packets_lost", lost, labels={"stream": origin})
        depth = getattr(self.receiver, "queue_depth", None)
        if depth is not None:
            metrics.set(f"udp_rx{self.data_stream_id}_queue_packets",
                        depth())
        if lost:
            log.warning(f"[udp_receiver] lost {lost}/{total} packets "
                        f"({lost / total:.2%})")
        return SegmentWork(
            data=buf,
            timestamp=time.time_ns(),
            udp_packet_counter=first_counter,
            data_stream_id=self.data_stream_id,
            seq=self._carry.next_seq(),
        )

    def close(self):
        self.receiver.close()


class MultiUdpSource:
    """N receivers (one per address/port pair, each on its own thread
    pinned to its ``udp_receiver_cpu_preferred`` CPU, like the
    reference's N udp_receiver_pipe instances, ref: main.cpp:261-271)
    multiplexed into one SegmentWork stream distinguished by
    ``data_stream_id``.  The receivers share one buffer pool
    (``pool``); without a ``buffer_pool`` the source makes it and
    allocates in it the buffers a run holds at once: one receiving on
    each thread, the queue's, the engine's window and the sink's
    segment."""

    def __init__(self, cfg: Config, use_native: bool | None = None,
                 buffer_pool: BufferPool | None = None):
        from srtb_tpu_torch.pipeline import framework as fw
        from srtb_tpu_torch.utils.affinity import set_thread_affinity
        self.cfg = cfg
        self.pool = _default_pool() if buffer_pool is None \
            else buffer_pool
        n = len(cfg.udp_receiver_port)
        self.sources = [UdpReceiverSource(cfg, receiver_id=i,
                                          use_native=use_native,
                                          buffer_pool=self.pool)
                        for i in range(n)]
        capacity = 2 * n
        self._own_pool = buffer_pool is None
        if self._own_pool:
            _warm(self.pool, self.sources[0].segment_bytes,
                  n + capacity + max(1, cfg.inflight_segments) + 1)
        self._stop = fw.StopToken()
        self._queue = fw.WorkQueue(capacity=capacity)
        self._pipes = []
        for i, src in enumerate(self.sources):
            def make(src, cpu):
                pinned = [False]

                def recv(stop_token, _):
                    if not pinned[0]:
                        # pin the receiver thread near the NIC
                        # (ref: udp_receiver_pipe.hpp:88-98)
                        set_thread_affinity(cpu)
                        pinned[0] = True
                    try:
                        return next(src)
                    except OSError:
                        if stop_token.stop_requested:
                            raise StopIteration  # woken by close()
                        raise
                recv.__name__ = f"udp_receiver_{src.data_stream_id}"
                return recv
            cpu = cfg.udp_receiver_cpu_preferred[
                min(i, len(cfg.udp_receiver_cpu_preferred) - 1)]
            self._pipes.append(fw.start_pipe(
                make(src, cpu), None, self._queue, self._stop,
                name=f"udp_receiver_{i}"))

    @property
    def ports(self) -> list[int]:
        """The receivers' bound ports, in receiver order."""
        return [src.port for src in self.sources]

    def reserve_buffers(self, held: int) -> None:
        """Allocate now the buffers of a consumer that holds up to
        ``held`` segments at once, one being read included: the
        receivers' own (one receiving on each thread, the queue's) and the
        consumer's (a pool passed in is its maker's to fill)."""
        if self._own_pool:
            n = len(self.sources)
            _warm(self.pool, self.sources[0].segment_bytes,
                  n + 2 * n + held - 1)

    @property
    def packets_total(self) -> int:
        return sum(s.packets_total for s in self.sources)

    @property
    def packets_lost(self) -> int:
        return sum(s.packets_lost for s in self.sources)

    def __iter__(self):
        return self

    def __next__(self) -> SegmentWork:
        item = self._queue.pop(self._stop)
        if item is None or not isinstance(item, SegmentWork):
            raise StopIteration
        return item

    def close(self):
        """Stop the receiver threads (their sockets shut down, so a
        thread blocked on one wakes), release the buffers of segments
        received but never taken, and close the receivers."""
        from srtb_tpu_torch.pipeline import framework as fw
        self._stop.request_stop()
        for src in self.sources:
            # the AF_PACKET ring has no wake-up: its threads are reported
            # wedged after on_exit's timeout and left open
            shutdown = getattr(src.receiver, "shutdown", None)
            if shutdown is not None:
                shutdown()
        wedged = fw.on_exit(self._stop, self._pipes)
        while (item := self._queue.try_pop()) is not None:
            if isinstance(item, SegmentWork):
                self.pool.release(item.data)
        if wedged:
            # a receiver still inside its receive call: leave it open
            # rather than free what the thread is using
            return
        for src in self.sources:
            src.close()
