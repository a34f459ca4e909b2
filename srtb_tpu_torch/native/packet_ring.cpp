// AF_PACKET TPACKET_V3 RX-ring packet provider (the port's copy of the
// JAX package's srtb_tpu/native/packet_ring.cpp, with the same C
// interface; srtb_tpu_torch/io/udp.py binds it).
//
// The reference ships a packet_mmap v3 provider but marks it "not
// correctly implemented" and keeps it out of the dispatch table
// (ref: io/udp/packet_mmap_v3_provider.hpp:61-65, 3rdparty/
// packet_mmap_v3.c).  This is a working equivalent: the kernel DMA-fills
// a mmap'd ring of blocks and hands each block to userspace with one
// wakeup, so packet reception costs no per-packet (and almost no
// per-batch) syscalls — the next step up from recvmmsg
// (udp_receiver.cpp) for line-rate capture.
//
// Same block-assembly contract as the recvmmsg receiver: payload of the
// packet with counter c lands at offset (c - begin) * payload_size of
// the caller's buffer, reordering within a block is tolerated, lost
// packets stay zero-filled and are accounted.  Kernel-side filtering is
// L2: the socket sees every IPv4 packet on the interface, and frames
// are filtered here for UDP + destination port + exact datagram size.
// Requires CAP_NET_RAW (the reference's provider has the same
// requirement; deployments that cannot grant it use the recvmmsg path).
//
// As in the port's recvmmsg receiver (udp_receiver.cpp), the caller's
// block is not cleared beforehand: the slots still unfilled when a block
// closes are zeroed then; and receive_block returns -EINTR or -EAGAIN
// while it waits (a signal, or 100 ms with no ring block), leaving the
// block open for the next call with the same buffer, where the JAX
// package's copy polls with no timeout.
//
// Exposed as a plain C interface for Python ctypes.  Built with the host
// compiler at first use (srtb_tpu_torch/kernels/build.py,
// build_host_library) into build/srtb_tpu_torch/.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <vector>

#include <linux/filter.h>
#include <linux/if_packet.h>
#include <net/ethernet.h>
#include <net/if.h>
#include <netinet/in.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <unistd.h>

#include <new>

namespace {

// counter parsers — must match udp_receiver.cpp's CounterKind values
enum CounterKind : int32_t {
  kCounterLe64 = 0,
  kCounterVdif67 = 1,
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

struct PktRing {
  int fd = -1;
  uint8_t* map = nullptr;
  size_t map_len = 0;
  uint32_t block_size = 0;
  uint32_t block_count = 0;

  uint16_t port_be = 0;        // filter: UDP destination port (network order)
  size_t packet_size = 0;      // expected datagram size (header + payload)
  size_t header_size = 0;
  int32_t counter_kind = kCounterLe64;

  // iteration state (persists across receive_block calls so an
  // overflowing packet's ring block is resumed, not dropped)
  uint32_t cur_block = 0;
  uint32_t pkt_index = 0;      // next frame index within cur_block
  uint32_t num_pkts = 0;       // frames in cur_block (0 = block not open)
  uint8_t* frame = nullptr;    // next frame pointer
  std::vector<uint8_t> slot_filled;  // per-block fill map (reused)

  // the block being assembled, kept across calls (as in
  // udp_receiver.cpp): blk_out == nullptr when no block is open
  uint8_t* blk_out = nullptr;
  uint64_t blk_bytes = 0;
  uint64_t blk_begin = 0;
  bool blk_begin_set = false;
  uint64_t blk_filled = 0;
  uint64_t blk_seen = 0;

  uint64_t next_counter = 0;
  bool have_counter = false;

  // datagram that overflowed the previous block (it belongs to a later
  // one): consumed first by the next receive_block call.  Copied out of
  // the ring so its ring block can be released to the kernel.
  uint8_t* pending = nullptr;   // packet_size bytes when pending_set
  bool pending_set = false;

  uint64_t total_packets = 0;
  uint64_t lost_packets = 0;

  size_t payload_size() const { return packet_size - header_size; }

  tpacket_block_desc* block(uint32_t i) const {
    return (tpacket_block_desc*)(map + (size_t)i * block_size);
  }
};

// The block_status word is the kernel<->userspace handoff: it needs
// acquire on the TP_STATUS_USER read (frame loads must not be satisfied
// from pre-fill memory) and release on the TP_STATUS_KERNEL store (all
// payload loads must complete before the kernel may DMA-refill the
// block) — plain accesses reorder on weakly-ordered CPUs and silently
// corrupt payload under load.
inline uint32_t status_acquire(tpacket_block_desc* bd) {
  return __atomic_load_n(&bd->hdr.bh1.block_status, __ATOMIC_ACQUIRE);
}

inline void release_to_kernel(tpacket_block_desc* bd) {
  __atomic_store_n(&bd->hdr.bh1.block_status, TP_STATUS_KERNEL,
                   __ATOMIC_RELEASE);
}

// Advance to the next available frame, opening/releasing ring blocks and
// poll()ing as needed.  Sets *pkt to the UDP payload of a frame that
// passes the port/size filter and returns 0; returns -EINTR when a
// signal interrupted the wait, -EAGAIN after 100 ms with no ring block,
// -1 on a poll error.
int next_packet(PktRing* r, const uint8_t** pkt) {
  for (;;) {
    if (r->num_pkts == 0) {  // open the current block (or wait for it)
      tpacket_block_desc* bd = r->block(r->cur_block);
      if (!(status_acquire(bd) & TP_STATUS_USER)) {
        pollfd pfd{r->fd, POLLIN | POLLERR, 0};
        const int ready = poll(&pfd, 1, 100);
        if (ready < 0) return errno == EINTR ? -EINTR : -1;
        if (!(status_acquire(bd) & TP_STATUS_USER)) return -EAGAIN;
      }
      r->num_pkts = bd->hdr.bh1.num_pkts;
      r->pkt_index = 0;
      r->frame = (uint8_t*)bd + bd->hdr.bh1.offset_to_first_pkt;
      if (r->num_pkts == 0) {  // timed-out empty block: hand back, next
        release_to_kernel(bd);
        r->cur_block = (r->cur_block + 1) % r->block_count;
        continue;
      }
    }
    while (r->pkt_index < r->num_pkts) {
      tpacket3_hdr* tp = (tpacket3_hdr*)r->frame;
      const uint8_t* cur = r->frame;
      r->pkt_index++;
      r->frame = tp->tp_next_offset
                     ? r->frame + tp->tp_next_offset
                     : r->frame;  // last frame: index check ends the loop
      // loopback delivers each datagram twice (outgoing + incoming);
      // keep one copy
      auto* sll = (const sockaddr_ll*)(cur + sizeof(tpacket3_hdr));
      if (sll->sll_pkttype == PACKET_OUTGOING) continue;
      const uint8_t* ip = cur + tp->tp_net;
      if ((ip[0] >> 4) != 4) continue;                   // IPv4 only
      const size_t ihl = (size_t)(ip[0] & 0x0F) * 4;
      if (ip[9] != IPPROTO_UDP) continue;
      const uint16_t frag = (uint16_t)((ip[6] << 8) | ip[7]) & 0x3FFF;
      if (frag != 0) continue;                           // no fragments
      const uint8_t* udp = ip + ihl;
      uint16_t dport;
      std::memcpy(&dport, udp + 2, 2);
      if (dport != r->port_be) continue;
      uint16_t ulen_be;
      std::memcpy(&ulen_be, udp + 4, 2);
      const size_t dgram = (size_t)ntohs(ulen_be) - 8;
      if (dgram != r->packet_size) continue;             // runt/foreign
      *pkt = udp + 8;
      return 0;
    }
    // block fully consumed: release to the kernel, move on.  NOTE: a
    // packet returned from this block may still be read by the caller
    // (memcpy into the assembly buffer) strictly before the next call
    // re-enters here, and the overflow path copies its packet out
    // before release — both happen-before this store.
    release_to_kernel(r->block(r->cur_block));
    r->cur_block = (r->cur_block + 1) % r->block_count;
    r->num_pkts = 0;
  }
}

}  // namespace

extern "C" {

// Create the ring on `ifname` (e.g. "lo", "eth0"), filtering for UDP
// datagrams of exactly `packet_size` bytes to `port`.  block_size must
// be a multiple of the page size; block_count blocks are mapped.
// Returns nullptr on failure (typically missing CAP_NET_RAW).
PktRing* srtb_pkt_ring_create(const char* ifname, uint16_t port,
                              uint64_t packet_size, uint64_t header_size,
                              int32_t counter_kind, uint32_t block_size,
                              uint32_t block_count) {
  PktRing* r = new (std::nothrow) PktRing;
  if (!r) return nullptr;
  r->packet_size = packet_size;
  r->header_size = header_size;
  r->counter_kind = counter_kind;
  r->port_be = htons(port);
  r->block_size = block_size;
  r->block_count = block_count;
  r->pending = new (std::nothrow) uint8_t[packet_size];
  if (!r->pending) { delete r; return nullptr; }

  r->fd = socket(AF_PACKET, SOCK_RAW, htons(ETH_P_IP));
  if (r->fd < 0) { delete[] r->pending; delete r; return nullptr; }

  {
    // Kernel-level classic BPF: "ipv4 && udp && !frag && dst port P &&
    // udp length == packet_size + 8".  Without it every packet on the
    // interface is copied into the 64 MB ring and filtered in
    // userspace — foreign bursts would evict wanted baseband blocks.
    // Offsets assume an Ethernet-style link header (true for loopback
    // and standard NICs).
    const uint16_t dport = port;
    const uint16_t ulen = (uint16_t)(packet_size + 8);
    sock_filter code[] = {
        {BPF_LD | BPF_H | BPF_ABS, 0, 0, 12},            //  0: ethertype
        {BPF_JMP | BPF_JEQ | BPF_K, 0, 10, 0x0800},      //  1: ipv4?
        {BPF_LD | BPF_B | BPF_ABS, 0, 0, 23},            //  2: ip proto
        {BPF_JMP | BPF_JEQ | BPF_K, 0, 8, IPPROTO_UDP},  //  3: udp?
        {BPF_LD | BPF_H | BPF_ABS, 0, 0, 20},            //  4: frag field
        {BPF_JMP | BPF_JSET | BPF_K, 6, 0, 0x1FFF},      //  5: fragment?
        {BPF_LDX | BPF_B | BPF_MSH, 0, 0, 14},           //  6: x = ihl
        {BPF_LD | BPF_H | BPF_IND, 0, 0, 16},            //  7: dst port
        {BPF_JMP | BPF_JEQ | BPF_K, 0, 3, dport},        //  8
        {BPF_LD | BPF_H | BPF_IND, 0, 0, 18},            //  9: udp length
        {BPF_JMP | BPF_JEQ | BPF_K, 0, 1, ulen},         // 10
        {BPF_RET | BPF_K, 0, 0, 0xFFFFFFFF},             // 11: accept
        {BPF_RET | BPF_K, 0, 0, 0},                      // 12: drop
    };
    sock_fprog prog{sizeof(code) / sizeof(code[0]), code};
    if (setsockopt(r->fd, SOL_SOCKET, SO_ATTACH_FILTER, &prog,
                   sizeof(prog)) < 0)
      goto fail;
  }

  {
    int v = TPACKET_V3;
    if (setsockopt(r->fd, SOL_PACKET, PACKET_VERSION, &v, sizeof(v)) < 0)
      goto fail;
  }

  {
    tpacket_req3 req{};
    req.tp_block_size = block_size;
    req.tp_block_nr = block_count;
    // frame size is a v3 sizing hint; large enough for jumbo payloads
    req.tp_frame_size = 16384;
    req.tp_frame_nr = (uint32_t)(((uint64_t)block_size * block_count) /
                                 req.tp_frame_size);
    req.tp_retire_blk_tov = 60;  // ms: deliver partial blocks promptly
    if (setsockopt(r->fd, SOL_PACKET, PACKET_RX_RING, &req, sizeof(req)) < 0)
      goto fail;
  }

  r->map_len = (size_t)block_size * block_count;
  r->map = (uint8_t*)mmap(nullptr, r->map_len, PROT_READ | PROT_WRITE,
                          MAP_SHARED | MAP_LOCKED, r->fd, 0);
  if (r->map == MAP_FAILED) {
    // MAP_LOCKED can exceed RLIMIT_MEMLOCK; retry unlocked
    r->map = (uint8_t*)mmap(nullptr, r->map_len, PROT_READ | PROT_WRITE,
                            MAP_SHARED, r->fd, 0);
    if (r->map == MAP_FAILED) goto fail;
  }

  {
    sockaddr_ll sll{};
    sll.sll_family = AF_PACKET;
    sll.sll_protocol = htons(ETH_P_IP);
    sll.sll_ifindex = (int)if_nametoindex(ifname && ifname[0] ? ifname
                                                              : "lo");
    if (sll.sll_ifindex == 0 ||
        bind(r->fd, (sockaddr*)&sll, sizeof(sll)) < 0)
      goto fail;
  }
  return r;

fail:
  if (r->map && r->map != MAP_FAILED) munmap(r->map, r->map_len);
  if (r->fd >= 0) close(r->fd);
  delete[] r->pending;
  delete r;
  return nullptr;
}

// Same contract as srtb_udp_rx_receive_block (udp_receiver.cpp),
// -EINTR / -EAGAIN with the block still open included.
int32_t srtb_pkt_ring_receive_block(PktRing* r, uint8_t* out,
                                    uint64_t out_bytes,
                                    uint64_t* first_counter_out,
                                    uint64_t* lost_out,
                                    uint64_t* total_out) {
  const size_t payload = r->payload_size();
  if (out_bytes % payload != 0) return -22;  // EINVAL
  const uint64_t packets_per_block = out_bytes / payload;

  if (r->blk_out != out || r->blk_bytes != out_bytes) {
    r->blk_out = out;
    r->blk_bytes = out_bytes;
    r->blk_begin = r->have_counter ? r->next_counter : 0;
    r->blk_begin_set = r->have_counter;
    r->blk_filled = 0;
    r->blk_seen = 0;
    // per-slot fill map: a duplicated counter must not inflate the fill
    // count, or the block closes early with a silently-zeroed slot and
    // lost = 0 (mirrors the Python provider's fix).  Member buffer: no
    // per-block allocation in the line-rate drain loop
    r->slot_filled.assign(packets_per_block, 0);
  }
  std::vector<uint8_t>& slot_filled = r->slot_filled;

  for (;;) {
    const uint8_t* pkt;
    if (r->pending_set) {
      pkt = r->pending;
      r->pending_set = false;
    } else {
      const int rc = next_packet(r, &pkt);
      if (rc == -EINTR || rc == -EAGAIN) return rc;  // the block stays open
      if (rc != 0) {
        r->blk_out = nullptr;
        return -1;
      }
    }
    const uint64_t c = parse_counter(pkt, r->counter_kind);
    if (!r->blk_begin_set) {
      r->blk_begin = c;
      r->blk_begin_set = true;
    }
    const uint64_t begin_counter = r->blk_begin;
    if (c < begin_counter) continue;  // stale packet from a prior block
    const uint64_t slot = c - begin_counter;
    const bool overflow = slot >= packets_per_block;
    if (overflow) {
      // block complete; the overflowing packet belongs to a later block
      // — stash a copy for the next call (the ring frame itself may be
      // handed back to the kernel before then)
      if (pkt != r->pending) {
        std::memcpy(r->pending, pkt, r->packet_size);
      }
      r->pending_set = true;
      for (uint64_t s = 0; s < packets_per_block; s++) {
        if (!slot_filled[s]) std::memset(out + s * payload, 0, payload);
      }
    } else {
      std::memcpy(out + slot * payload, pkt + r->header_size, payload);
      if (!slot_filled[slot]) {
        slot_filled[slot] = 1;
        r->blk_filled++;
      }
      r->blk_seen++;
    }
    if (overflow || r->blk_filled == packets_per_block) {
      const uint64_t lost = packets_per_block - r->blk_filled;
      r->next_counter = begin_counter + packets_per_block;
      r->have_counter = true;
      r->total_packets += r->blk_seen;
      r->lost_packets += lost;
      r->blk_out = nullptr;
      if (first_counter_out) *first_counter_out = begin_counter;
      if (lost_out) *lost_out = lost;
      if (total_out) *total_out = packets_per_block;
      return 0;
    }
  }
}

uint64_t srtb_pkt_ring_total_packets(PktRing* r) { return r->total_packets; }
uint64_t srtb_pkt_ring_lost_packets(PktRing* r) { return r->lost_packets; }

void srtb_pkt_ring_destroy(PktRing* r) {
  if (!r) return;
  if (r->map && r->map != MAP_FAILED) munmap(r->map, r->map_len);
  if (r->fd >= 0) close(r->fd);
  delete[] r->pending;
  delete r;
}

}  // extern "C"
