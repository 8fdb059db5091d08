// Batched UDP transmit/receive — one sendmmsg(2)/recvmmsg(2) syscall
// for a whole dispatcher iteration's outbound datagrams or a whole
// inbound burst.
//
// The port's copy of the JAX package's native/netio.cpp, byte for byte
// in behaviour; built with g++ into ops/_build/ at first use
// (ops/_build.load_host("netio")).
//
// Role in the rebuild: concord-bft's PlainUDPCommunication
// (communication/src/PlainUDPCommunication.cpp:340) pays
// one sendto per message from its send thread; profiling the Python
// rebuild showed per-sendto syscall overhead dominating the consensus
// dispatcher (~10 datagrams per ordered op). Collapsing an iteration's
// sends into one kernel entry removes that per-message cost without
// changing wire behavior.
//
// Input: n records packed back-to-back, each
//   | u32 ipv4 (network byte order) | u16 port (LITTLE-endian) |
//   | u32 payload length (LITTLE-endian) | payload bytes       |
// The wire record byte order is DEFINED (little-endian for the scalar
// fields, assembled byte-by-byte below) rather than inherited from the
// host: the Python side packs with to_bytes(..., "little"), and a
// host-order memcpy here would silently byte-swap port/length on a
// big-endian host.
// Returns datagrams handed to the kernel (best-effort, like UDP), or -1
// on a malformed buffer.
#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <sys/socket.h>

extern "C" {

int net_sendmmsg(int fd, const uint8_t* buf, uint32_t buflen, int n) {
  if (n <= 0) return 0;
  constexpr int kMaxBatch = 64;
  mmsghdr hdrs[kMaxBatch];
  iovec iovs[kMaxBatch];
  sockaddr_in addrs[kMaxBatch];
  int sent_total = 0;
  const uint8_t* p = buf;
  const uint8_t* end = buf + buflen;
  while (n > 0) {
    const int batch = n > kMaxBatch ? kMaxBatch : n;
    for (int i = 0; i < batch; i++) {
      if (p + 10 > end) return -1;
      uint32_t ip;
      memcpy(&ip, p, 4);  // already network order: passed through as-is
      const uint16_t port = static_cast<uint16_t>(p[4] | (p[5] << 8));
      const uint32_t len = static_cast<uint32_t>(p[6]) |
                           (static_cast<uint32_t>(p[7]) << 8) |
                           (static_cast<uint32_t>(p[8]) << 16) |
                           (static_cast<uint32_t>(p[9]) << 24);
      p += 10;
      if (p + len > end) return -1;
      memset(&addrs[i], 0, sizeof(sockaddr_in));
      addrs[i].sin_family = AF_INET;
      addrs[i].sin_addr.s_addr = ip;
      addrs[i].sin_port = htons(port);
      iovs[i].iov_base = const_cast<uint8_t*>(p);
      iovs[i].iov_len = len;
      memset(&hdrs[i], 0, sizeof(mmsghdr));
      hdrs[i].msg_hdr.msg_name = &addrs[i];
      hdrs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
      hdrs[i].msg_hdr.msg_iov = &iovs[i];
      hdrs[i].msg_hdr.msg_iovlen = 1;
      p += len;
    }
    const int r = sendmmsg(fd, hdrs, batch, 0);
    if (r > 0) sent_total += r;  // partial/failed batch: UDP best-effort
    n -= batch;
  }
  return sent_total;
}

// Batched receive: drain every immediately-available datagram in ONE
// kernel entry (the admission plane's ingest side, mirroring the
// sendmmsg plane above; reference role: PlainUDPCommunication's
// per-recvfrom receive thread, one syscall per datagram).
//
// The caller selects()/polls for readability first, then calls this
// with MSG_DONTWAIT semantics: datagram i lands at buf + i*slot_len,
// its length in lens[i]. A datagram longer than slot_len is truncated
// by the kernel (callers size slots at max_message_size + header, so
// an over-long datagram is invalid traffic anyway; MSG_TRUNC in
// msg_flags is reflected as len = slot_len and dropped in Python by
// the sender-prefix/shape checks). Returns datagrams received, 0 when
// nothing was pending (EAGAIN), -1 on a real socket error.
int net_recvmmsg(int fd, uint8_t* buf, uint32_t slot_len, int max_n,
                 uint32_t* lens) {
  if (max_n <= 0 || slot_len == 0) return 0;
  constexpr int kMaxBatch = 64;
  if (max_n > kMaxBatch) max_n = kMaxBatch;
  mmsghdr hdrs[kMaxBatch];
  iovec iovs[kMaxBatch];
  for (int i = 0; i < max_n; i++) {
    iovs[i].iov_base = buf + static_cast<size_t>(i) * slot_len;
    iovs[i].iov_len = slot_len;
    memset(&hdrs[i], 0, sizeof(mmsghdr));
    hdrs[i].msg_hdr.msg_iov = &iovs[i];
    hdrs[i].msg_hdr.msg_iovlen = 1;
  }
  const int r = recvmmsg(fd, hdrs, max_n, MSG_DONTWAIT, nullptr);
  if (r < 0) {
    if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) return 0;
    return -1;
  }
  for (int i = 0; i < r; i++) lens[i] = hdrs[i].msg_len;
  return r;
}

}  // extern "C"
