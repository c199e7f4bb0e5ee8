// Bulk's on_tick and next_time as device code, one host per team (a warp
// in K_WINDOW's TCP kernel, window.cu).
//
// bulk_tick follows shadow1_tpu_torch/apps/bulk.py `on_tick` (itself the
// JAX shadow1_tpu/apps/bulk.py:74-123) for one host: a due client opens
// its connection (tcp.connect_v); a running client writes the rest of its
// stream into the send buffer (write_v), closes once all of it is
// written (close_v), and is done once its FIN is acknowledged (or failed
// once its socket reports an error).  Then, on every host, active or
// not, every TCP socket consumes what it received (consume_all) and
// closes once its peer closed (CLOSEWAIT): the reference applies that
// sink policy to the whole table each micro-step, with no `active` mask.
// The socket calls are tcp.cuh's, on the client socket gathered once (in
// every lane; the leader stores it); the sink is per socket, so the
// team's lanes take the sockets.
#pragma once
#include "tcp.cuh"

namespace s1 {

constexpr int BULK_CLIENT_PORT = 40000;
constexpr int BULK_RUNNING = 1, BULK_DONE = 2, BULK_FAILED = 3;

// Mirrored field for field by the ctypes.Structure in
// shadow1_tpu_torch/core/megakernel.py.
struct BulkArgs {
  const uint8_t* is_client;
  const int32_t* dst;
  const int64_t* total;
  const int64_t* start_t;
  int32_t* phase;       // 0 idle, 1 running, 2 done, 3 failed
  int64_t* finish_t;
  int32_t server_port, client_slot;
};

// Bulk.next_time: an idle client's start time.
__device__ __forceinline__ int64_t bulk_next(const BulkArgs& b, int hh) {
  return (b.is_client[hh] && b.phase[hh] == 0) ? b.start_t[hh] : INV;
}

// on_tick for host hh at `tick` (its t_post).
template <class Team>
__device__ __forceinline__ void bulk_tick(const Team& tm, const BulkArgs& b,
                                          const TcpArgs& t, int hh,
                                          int64_t tick, bool act) {
  const int cs = b.client_slot;
  const int32_t phase0 = b.phase[hh];
  const bool client = act && b.is_client[hh];
  const bool starting = client && phase0 == 0 && b.start_t[hh] <= tick;
  if (starting || (client && phase0 == BULK_RUNNING)) {
    Sock v = sock_load(t, hh, cs);
    if (starting)
      sock_connect(v, t, hh, b.dst[hh], b.server_port, BULK_CLIENT_PORT,
                   tick);
    // The stream is bytes [1, 1 + total) after the SYN (u32 sequence
    // space); its FIN takes one more.
    const uint32_t target_end = 1u + (uint32_t)b.total[hh];
    sock_write(v, target_end, tick);
    if (v.snd_end == target_end) sock_close(v);
    tm.sync();               // every lane has loaded the socket
    if (tm.leader()) sock_store(t, hh, cs, v);
    const int32_t st = v.tcp_state;
    const bool closed = st == TCPS_FINWAIT2 || st == TCPS_TIMEWAIT ||
                        st == TCPS_CLOSED;
    const bool failed = v.error != 0;
    int32_t phase = BULK_RUNNING;
    if (failed) {
      phase = BULK_FAILED;
    } else if (closed && v.snd_una == target_end + 1u) {
      phase = BULK_DONE;
      if (tm.leader()) b.finish_t[hh] = tick;
    }
    if (tm.leader()) b.phase[hh] = phase;
    tm.sync();
  }
  // tcp.consume_all, then close-when-peer-closed, socket by socket.
  for (int s = tm.lane(); s < t.slots; s += Team::W) {
    const int64_t i = (int64_t)hh * t.slots + s;
    if (t.stype[i] != SOCK_TCP) continue;
    t.rcv_read[i] = t.rcv_nxt[i];
    if (t.tcp_state[i] == TCPS_CLOSEWAIT) t.app_closed[i] = 1;
  }
  tm.sync();
}

}  // namespace s1
