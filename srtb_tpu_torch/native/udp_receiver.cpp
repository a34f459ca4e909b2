// Native UDP baseband receiver (the port's copy of the JAX package's
// receiver, srtb_tpu/native/udp_receiver.cpp, with the same C interface;
// srtb_tpu_torch/io/udp.py binds it).
//
// Batched recvmmsg() syscalls (128 packets a call, ref:
// io/udp/recvmmsg_packet_provider.hpp), counter parsing per packet
// format, placement of payloads by counter offset into a caller-provided
// block buffer (tolerating reordering within a block), zero-fill of lost
// packets with loss accounting (ref: io/udp/udp_receiver.hpp
// udp_receive_block_worker), optional CPU pinning of the receive thread.
//
// Differences from the JAX package's copy, none in what a block holds:
// - the block is not cleared before the packets arrive (every received
//   slot is written whole, and the slots still unfilled when the block
//   closes are zeroed then, which gives the same bytes without a 256 MiB
//   memset a 2^30 segment while the socket buffer fills);
// - the wait for the first packet of a batch is a poll() before a
//   non-blocking recvmmsg, not MSG_WAITFORONE (see refill);
// - receive_block returns to its caller while it waits, -EINTR when a
//   signal interrupts the wait and -EAGAIN after 100 ms with no
//   datagram, and the next call with the same buffer resumes the block:
//   a Python caller on the main thread runs its signal handlers between
//   the calls (PEP 475), where the JAX package's copy blocks in the
//   syscall for as long as no packet comes;
// - there is no srtb_set_thread_affinity: the Python side's
//   os.sched_setaffinity makes the same syscall.
//
// Exposed as a plain C interface for Python ctypes.  Built with the host
// compiler at first use (srtb_tpu_torch/kernels/build.py,
// build_host_library) into build/srtb_tpu_torch/.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <new>
#include <vector>

namespace {

constexpr size_t kBatch = 128;  // packets per recvmmsg (ref: recvmmsg_packet_provider.hpp)

// counter parsers (ref: io/backend_registry.hpp:63-73, 129-152)
enum CounterKind : int32_t {
  kCounterLe64 = 0,   // first 8 bytes little-endian (fastmb_roach2 / snap1)
  kCounterVdif67 = 1, // VDIF words 6 & 7 (gznupsr_a1)
};

inline uint64_t parse_counter(const uint8_t* pkt, int32_t kind) {
  uint64_t c = 0;
  if (kind == kCounterVdif67) {
    uint32_t w6, w7;
    std::memcpy(&w6, pkt + 6 * 4, 4);
    std::memcpy(&w7, pkt + 7 * 4, 4);
    c = (uint64_t)w6 | ((uint64_t)w7 << 32);
  } else {
    std::memcpy(&c, pkt, 8);
  }
  return c;
}

struct UdpRx {
  int fd = -1;
  size_t packet_size = 0;   // total datagram size incl. header
  size_t header_size = 0;
  int32_t counter_kind = kCounterLe64;
  uint64_t next_counter = 0;
  bool have_counter = false;

  // batch state: received but not yet consumed packets
  std::vector<uint8_t> buf;           // kBatch * packet_size
  std::vector<uint8_t> slot_filled;   // per-block fill map (reused)
  std::vector<mmsghdr> msgs;
  std::vector<iovec> iovs;
  size_t batch_pos = 0;
  size_t batch_len = 0;
  std::atomic<bool> stopping{false};  // set by srtb_udp_rx_shutdown

  // the block being assembled, kept across calls: a call that returns
  // -EINTR or -EAGAIN leaves it open, and the next call with the same
  // buffer resumes it (blk_out == nullptr: no block open)
  uint8_t* blk_out = nullptr;
  uint64_t blk_bytes = 0;
  uint64_t blk_begin = 0;
  bool blk_begin_set = false;
  uint64_t blk_filled = 0;
  uint64_t blk_seen = 0;

  // statistics
  uint64_t total_packets = 0;
  uint64_t lost_packets = 0;

  size_t payload_size() const { return packet_size - header_size; }
};

// Wait for at least one datagram, then take up to kBatch that are queued:
// the semantics of recvmmsg(MSG_WAITFORONE), spelled as poll() plus a
// non-blocking recvmmsg, because some sandboxed kernels (gVisor) refuse
// MSG_WAITFORONE with EINVAL but take MSG_DONTWAIT.  Returns 0 with a
// batch, -EINTR when a signal interrupted the wait, -EAGAIN when 100 ms
// passed with no datagram, and -1 on an error or after a shutdown
// (srtb_udp_rx_shutdown).
int refill(UdpRx* rx) {
  for (size_t i = 0; i < kBatch; i++) {
    rx->iovs[i].iov_base = rx->buf.data() + i * rx->packet_size;
    rx->iovs[i].iov_len = rx->packet_size;
    std::memset(&rx->msgs[i].msg_hdr, 0, sizeof(msghdr));
    rx->msgs[i].msg_hdr.msg_iov = &rx->iovs[i];
    rx->msgs[i].msg_hdr.msg_iovlen = 1;
  }
  if (rx->stopping.load()) return -1;
  pollfd pfd{rx->fd, POLLIN, 0};
  const int ready = poll(&pfd, 1, 100);
  if (ready < 0) return errno == EINTR ? -EINTR : -1;
  if (ready == 0) return -EAGAIN;
  const int n = recvmmsg(rx->fd, rx->msgs.data(), kBatch, MSG_DONTWAIT,
                         nullptr);
  // after a shutdown the socket returns empty reads at once: end the
  // block with an error instead of spinning on them
  if (rx->stopping.load()) return -1;
  if (n < 0) {
    if (errno == EINTR) return -EINTR;
    if (errno == EAGAIN || errno == EWOULDBLOCK) return -EAGAIN;
    return -1;
  }
  if (n == 0) return -1;
  rx->batch_pos = 0;
  rx->batch_len = (size_t)n;
  return 0;
}

// Zero the payload slots no packet filled (the lost ones) when a block
// closes: the caller's buffer is not cleared beforehand.
void zero_unfilled(uint8_t* out, const std::vector<uint8_t>& slot_filled,
                   size_t payload) {
  for (size_t slot = 0; slot < slot_filled.size(); slot++) {
    if (!slot_filled[slot]) std::memset(out + slot * payload, 0, payload);
  }
}

}  // namespace

extern "C" {

// Create a bound UDP socket with a large receive buffer.
// Returns nullptr on failure.
UdpRx* srtb_udp_rx_create(const char* addr, uint16_t port,
                          uint64_t packet_size, uint64_t header_size,
                          int32_t counter_kind, int64_t rcvbuf_bytes) {
  UdpRx* rx = new (std::nothrow) UdpRx;
  if (!rx) return nullptr;
  rx->packet_size = packet_size;
  rx->header_size = header_size;
  rx->counter_kind = counter_kind;
  rx->buf.resize(kBatch * packet_size);
  rx->msgs.resize(kBatch);
  rx->iovs.resize(kBatch);

  rx->fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (rx->fd < 0) { delete rx; return nullptr; }
  int reuse = 1;
  setsockopt(rx->fd, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
  if (rcvbuf_bytes > 0) {
    // like the reference's max SO_RCVBUF tuning (README.md deployment notes)
    int v = (int)rcvbuf_bytes;
    setsockopt(rx->fd, SOL_SOCKET, SO_RCVBUF, &v, sizeof(v));
  }
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons(port);
  sa.sin_addr.s_addr = addr && addr[0] ? inet_addr(addr) : INADDR_ANY;
  if (bind(rx->fd, (sockaddr*)&sa, sizeof(sa)) < 0) {
    close(rx->fd);
    delete rx;
    return nullptr;
  }
  return rx;
}

// Receive exactly one block of `out_bytes` payload bytes, assembled by
// packet counter.  Payload of packet with counter c goes to offset
// (c - begin_counter) * payload_size; the slots of lost packets are
// zeroed when the block closes (the buffer need not be cleared); packets
// beyond the block terminate assembly and are kept for the next call
// (ref: io/udp/udp_receiver.hpp 180-272 block worker).
// Returns 0 with the block complete (first_counter / lost / total
// filled), -EINTR or -EAGAIN with the block still open (call again with
// the same buffer to resume it; another buffer starts a new block), or
// another negative value on an error or after a shutdown.
int32_t srtb_udp_rx_receive_block(UdpRx* rx, uint8_t* out,
                                  uint64_t out_bytes,
                                  uint64_t* first_counter_out,
                                  uint64_t* lost_out, uint64_t* total_out) {
  const size_t payload = rx->payload_size();
  if (out_bytes % payload != 0) return -22;  // EINVAL
  const uint64_t packets_per_block = out_bytes / payload;

  if (rx->blk_out != out || rx->blk_bytes != out_bytes) {
    rx->blk_out = out;
    rx->blk_bytes = out_bytes;
    rx->blk_begin = rx->have_counter ? rx->next_counter : 0;
    rx->blk_begin_set = rx->have_counter;
    rx->blk_filled = 0;
    rx->blk_seen = 0;
    // per-slot fill map: a duplicated counter must not inflate the fill
    // count, or the block closes early with a silently-zeroed slot and
    // lost = 0 (mirrors the Python provider's fix).  Member buffer: no
    // per-block allocation in the line-rate drain loop
    rx->slot_filled.assign(packets_per_block, 0);
  }
  std::vector<uint8_t>& slot_filled = rx->slot_filled;

  while (true) {
    if (rx->batch_pos >= rx->batch_len) {
      const int rc = refill(rx);
      if (rc == -EINTR || rc == -EAGAIN) return rc;  // the block stays open
      if (rc != 0) {
        rx->blk_out = nullptr;
        return -1;
      }
    }
    for (; rx->batch_pos < rx->batch_len; rx->batch_pos++) {
      const size_t i = rx->batch_pos;
      if (rx->msgs[i].msg_len < rx->packet_size) continue;  // runt
      const uint8_t* pkt = rx->buf.data() + i * rx->packet_size;
      const uint64_t c = parse_counter(pkt, rx->counter_kind);
      if (!rx->blk_begin_set) {
        rx->blk_begin = c;
        rx->blk_begin_set = true;
      }
      const uint64_t begin_counter = rx->blk_begin;
      if (c < begin_counter) continue;  // stale packet from previous block
      const uint64_t slot = c - begin_counter;
      const bool overflow = slot >= packets_per_block;
      if (!overflow) {
        std::memcpy(out + slot * payload, pkt + rx->header_size, payload);
        if (!slot_filled[slot]) {
          slot_filled[slot] = 1;
          rx->blk_filled++;
        }
        rx->blk_seen++;
      }
      if (overflow || rx->blk_filled == packets_per_block) {
        // block complete; an overflowing packet stays at batch_pos for
        // the next call
        if (overflow) zero_unfilled(out, slot_filled, payload);
        else rx->batch_pos++;
        const uint64_t lost = packets_per_block - rx->blk_filled;
        rx->next_counter = begin_counter + packets_per_block;
        rx->have_counter = true;
        rx->total_packets += rx->blk_seen;
        rx->lost_packets += lost;
        rx->blk_out = nullptr;
        if (first_counter_out) *first_counter_out = begin_counter;
        if (lost_out) *lost_out = lost;
        if (total_out) *total_out = packets_per_block;
        return 0;
      }
    }
  }
}

uint64_t srtb_udp_rx_total_packets(UdpRx* rx) { return rx->total_packets; }

// The receiver's socket, for getsockopt (the SO_RCVBUF the kernel
// granted).
int32_t srtb_udp_rx_fd(UdpRx* rx) { return rx->fd; }

// Wake a thread waiting in receive_block (it returns -1), so that it can
// be joined before srtb_udp_rx_destroy; later calls fail at once.
void srtb_udp_rx_shutdown(UdpRx* rx) {
  rx->stopping.store(true);
  shutdown(rx->fd, SHUT_RDWR);
}

uint64_t srtb_udp_rx_lost_packets(UdpRx* rx) { return rx->lost_packets; }

void srtb_udp_rx_destroy(UdpRx* rx) {
  if (!rx) return;
  if (rx->fd >= 0) close(rx->fd);
  delete rx;
}

}  // extern "C"
