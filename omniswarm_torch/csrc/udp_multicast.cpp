// UDP multicast datagram transport — the deployment-grade wire for the
// LoopNet channel layer (the reference uses LCM over
// udpm://224.0.0.251:7667?ttl=1, loop_net.cpp:4-17 — this is an
// independent minimal equivalent: join a multicast group, send/recv
// datagrams, non-blocking).
//
// C ABI for ctypes. Handles are opaque int fds.

#include <arpa/inet.h>
#include <cerrno>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// Returns fd >= 0 on success, -errno on failure.
int umc_open(const char* group, int port, int ttl, int loopback) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -errno;

  int reuse = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
#ifdef SO_REUSEPORT
  setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &reuse, sizeof(reuse));
#endif

  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    int e = errno;
    close(fd);
    return -e;
  }

  ip_mreq mreq{};
  mreq.imr_multiaddr.s_addr = inet_addr(group);
  mreq.imr_interface.s_addr = htonl(INADDR_ANY);
  if (setsockopt(fd, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq, sizeof(mreq)) < 0) {
    int e = errno;
    close(fd);
    return -e;
  }

  unsigned char ttl_v = static_cast<unsigned char>(ttl);
  setsockopt(fd, IPPROTO_IP, IP_MULTICAST_TTL, &ttl_v, sizeof(ttl_v));
  unsigned char loop_v = static_cast<unsigned char>(loopback);
  setsockopt(fd, IPPROTO_IP, IP_MULTICAST_LOOP, &loop_v, sizeof(loop_v));

  int flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  return fd;
}

// Returns bytes sent or -errno. A full send buffer (a keyframe is a burst
// of ~200 datagrams) is waited out for up to 1 s, as a blocking send would
// wait; only then does it return -EAGAIN.
int umc_send(int fd, const char* group, int port, const uint8_t* data,
             int len) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = inet_addr(group);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  for (;;) {
    ssize_t n = sendto(fd, data, static_cast<size_t>(len), 0,
                       reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    if (n >= 0) return static_cast<int>(n);
    int e = errno;
    if (e != EAGAIN && e != EWOULDBLOCK) return -e;
    pollfd p{fd, POLLOUT, 0};
    if (poll(&p, 1, 1000) <= 0) return -e;
  }
}

// Returns bytes received, 0 if none pending, or -errno.
int umc_recv(int fd, uint8_t* buf, int cap) {
  ssize_t n = recv(fd, buf, static_cast<size_t>(cap), 0);
  if (n < 0) {
    if (errno == EAGAIN || errno == EWOULDBLOCK) return 0;
    return -errno;
  }
  return static_cast<int>(n);
}

void umc_close(int fd) { close(fd); }

}  // extern "C"
