// Tgen's on_tick and next_time as device code, one host per team (a warp
// in K_WINDOW's TCP kernel, window.cu k_window_tgen).
//
// tgen_client and tgen_server follow shadow1_tpu_torch/apps/tgen.py
// `on_tick` (itself the JAX shadow1_tpu/apps/tgen.py:265-410) for one
// host.  The client pass: start and stop, then the node at the host's
// cursor -- START hops on; STREAM opens the client socket (tcp.connect_v
// on CLIENT_SLOT, the peer picked by conn_ctr), writes the request
// (write_v), half-closes once it is written (close_v) and ends the
// stream once the socket is torn down (done if the whole reply came,
// failed otherwise or on a socket error); END counts a visit and
// finishes at its bound; PAUSE draws its duration (keyed by host,
// conn_ctr and iters) and hops on once it has passed -- then the cursor
// advance and the instant re-tick (t_next = tick) of a host that moved
// onto a node.  The server pass, on every host whether active or not,
// writes each child socket's reply (bounded by the send buffer) once the
// peer's request is in, and closes it once the whole reply is written;
// it reads the peer's cur_send / cur_recv as every host's client pass of
// this tick left them, so the kernel runs it after a grid barrier that
// follows every client pass (window.cu).  Then the sink: every TCP socket
// consumes what it received (consume_all).  The client socket is
// gathered once (in every lane; the leader stores it); the server pass
// and the sink are per socket, so the team's lanes take the sockets.
#pragma once
#include "tcp.cuh"

namespace s1 {

constexpr int NT_START = 0, NT_STREAM = 1, NT_END = 2, NT_PAUSE = 3;
constexpr int64_t TGEN_EPH_BASE = 41000, TGEN_EPH_RANGE = 20000;

// Mirrored field for field by the ctypes.Structure in
// shadow1_tpu_torch/core/megakernel.py: the ten tables and fourteen
// registers of apps/tgen.py TgenState, the scratch that carries a host's
// step across the client/server barrier, the PURPOSE_HOST_APP key words
// and the table widths.
struct TgenArgs {
  const int32_t* ntype;       // [n] node tables
  const int32_t* nxt;
  const int64_t* sendsize;
  const int64_t* recvsize;
  const int64_t* count;
  const int64_t* pause_t;     // [n, pc]
  const int32_t* pause_n;
  const int32_t* peer_host;   // [n, mp]
  const int32_t* peer_port;   // [n, mp]
  const int32_t* peer_n;
  int32_t* cur;               // [h] registers
  const int64_t* start_t;
  const int64_t* stop_t;
  uint8_t* started;
  uint8_t* finished;
  int64_t* iters;
  int64_t* wait_until;
  int64_t* t_next;
  uint8_t* stream_active;
  int64_t* conn_ctr;
  int64_t* cur_send;
  int64_t* cur_recv;
  int64_t* streams_done;
  int64_t* streams_failed;
  int64_t* split;             // [h, 3] tick, t_post, act | delivered << 1
  uint32_t k0, k1;
  int32_t n_nodes, pc, mp, client_slot, h;
};

// Tgen.next_time: the start of a host not started yet, the pause deadline
// of a running one, the instant re-tick.
__device__ __forceinline__ int64_t tgen_next(const TgenArgs& g, int hh) {
  int64_t t = g.t_next[hh];
  if (g.cur[hh] >= 0) {
    if (!g.started[hh]) t = imin(t, g.start_t[hh]);
    else if (!g.finished[hh]) t = imin(t, g.wait_until[hh]);
  }
  return t;
}

// The client pass of on_tick for host hh at `tick` (its t_post).
template <class Team>
__device__ __forceinline__ void tgen_client(const Team& tm,
                                            const TgenArgs& g,
                                            const TcpArgs& t, int hh,
                                            int64_t tick, bool act) {
  const int cs = g.client_slot;
  const int32_t cur0 = g.cur[hh];
  int64_t t_next = act ? INV : g.t_next[hh];
  bool started = g.started[hh], finished = g.finished[hh];
  const bool start_now = act && !started && cur0 >= 0 &&
                         g.start_t[hh] <= tick;
  started = started || start_now;
  const int64_t stop = g.stop_t[hh];
  if (act && started && stop != INV && stop <= tick) finished = true;
  const bool run = act && started && !finished && cur0 >= 0;
  if (!run) {                // only the start / stop registers can change
    tm.sync();               // every lane has read the registers
    if (tm.leader()) {
      g.t_next[hh] = start_now ? tick : t_next;
      g.started[hh] = started;
      g.finished[hh] = finished;
    }
    tm.sync();
    return;
  }
  const int cur = cur0 > g.n_nodes - 1 ? g.n_nodes - 1 : cur0;
  const int32_t ntype = g.ntype[cur];
  bool advance = ntype == NT_START;

  // -- STREAM ----------------------------------------------------------------
  bool stream_active = g.stream_active[hh];
  int64_t conn_ctr = g.conn_ctr[hh];
  int64_t cur_send = g.cur_send[hh], cur_recv = g.cur_recv[hh];
  int64_t done_n = 0, failed_n = 0;
  if (ntype == NT_STREAM) {
    bool init = false;
    int32_t dsth = -1, dstp = 0;
    int32_t lport = 0;
    if (!stream_active) {
      const int32_t np = imax32(g.peer_n[cur], 1);
      int32_t pk = (int32_t)(conn_ctr % (int64_t)np);
      pk = pk < 0 ? 0 : (pk > g.mp - 1 ? g.mp - 1 : pk);
      dsth = g.peer_host[(int64_t)cur * g.mp + pk];
      dstp = g.peer_port[(int64_t)cur * g.mp + pk];
      init = dsth >= 0;
      lport = (int32_t)(TGEN_EPH_BASE + conn_ctr % TGEN_EPH_RANGE);
    }
    if (init) {
      stream_active = true;
      conn_ctr += 1;
      cur_send = g.sendsize[cur];
      cur_recv = g.recvsize[cur];
    }
    if (stream_active) {
      Sock v = sock_load(t, hh, cs);
      if (init) sock_connect(v, t, hh, dsth, dstp, lport, tick);
      // The request is bytes [1, 1 + sendsize) after the SYN (u32).
      const uint32_t target = 1u + (uint32_t)cur_send;
      sock_write(v, target, tick);
      if (v.snd_end == target) sock_close(v);
      tm.sync();             // every lane has loaded the socket
      if (tm.leader()) sock_store(t, hh, cs, v);
      const bool torn = v.tcp_state == TCPS_TIMEWAIT ||
                        v.tcp_state == TCPS_CLOSED;
      const bool ok = torn && v.bytes_recv >= cur_recv;
      const bool bad = !ok && (v.error != 0 ||
                               (torn && v.bytes_recv < cur_recv));
      done_n = ok;
      failed_n = bad;
      if (ok || bad) {
        stream_active = false;
        advance = true;
      }
    }
  }

  // -- END -------------------------------------------------------------------
  int64_t iters = g.iters[hh];
  if (ntype == NT_END) {
    ++iters;
    const int64_t cnt = g.count[cur];
    if (cnt > 0 && iters >= cnt) finished = true;
    else advance = true;
  }

  // -- PAUSE: the draw keyed (host, conn_ctr, iters) as u32 ------------------
  int64_t wait_until = g.wait_until[hh];
  if (ntype == NT_PAUSE) {
    if (wait_until == INV) {
      const float u = keyed_uniform3(g.k0, g.k1, (uint32_t)hh,
                                     (uint32_t)conn_ctr, (uint32_t)iters);
      const int32_t pn = imax32(g.pause_n[cur], 1);
      int32_t pick = imin32((int32_t)__fmul_rn(u, (float)pn), pn - 1);
      pick = pick < 0 ? 0 : (pick > g.pc - 1 ? g.pc - 1 : pick);
      wait_until = tick + g.pause_t[(int64_t)cur * g.pc + pick];
    } else if (wait_until <= tick) {
      wait_until = INV;
      advance = true;
    }
  }

  // -- cursor advance + instant re-tick --------------------------------------
  int32_t cur_new = cur0;
  if (advance) {
    const int32_t nxt = g.nxt[cur];
    cur_new = nxt;
    if (nxt < 0) finished = true;
    else t_next = tick;
  }
  if (start_now) t_next = tick;
  tm.sync();                 // every lane has read the registers
  if (tm.leader()) {
    g.cur[hh] = cur_new;
    g.t_next[hh] = t_next;
    g.started[hh] = started;
    g.finished[hh] = finished;
    g.iters[hh] = iters;
    g.wait_until[hh] = wait_until;
    g.stream_active[hh] = stream_active;
    g.conn_ctr[hh] = conn_ctr;
    g.cur_send[hh] = cur_send;
    g.cur_recv[hh] = cur_recv;
    g.streams_done[hh] += done_n;
    g.streams_failed[hh] += failed_n;
  }
  tm.sync();
}

// The server pass and the sink of on_tick for host hh: each child socket
// (ESTABLISHED or CLOSEWAIT, with a parent) whose peer's request is in
// writes its reply up to the send buffer's end and closes once the whole
// reply was written before this write; then every TCP socket consumes
// what it received.  The peers' stream registers are read from L2: other
// blocks wrote them before the grid barrier.
template <class Team>
__device__ __forceinline__ void tgen_server(const Team& tm,
                                            const TgenArgs& g,
                                            const TcpArgs& t, int hh) {
  for (int s = tm.lane(); s < t.slots; s += Team::W) {
    const int64_t i = (int64_t)hh * t.slots + s;
    if (t.stype[i] != SOCK_TCP) continue;
    const int32_t st = t.tcp_state[i];
    const int32_t ph = t.peer_host[i];
    if (t.parent[i] >= 0 && (st == TCPS_ESTABLISHED || st == TCPS_CLOSEWAIT)
        && ph >= 0 && !t.app_closed[i]) {
      const int p = ph > g.h - 1 ? g.h - 1 : ph;
      const int64_t want_send = __ldcg((const long long*)g.cur_send + p);
      const int64_t want_recv = __ldcg((const long long*)g.cur_recv + p);
      if (t.bytes_recv[i] >= want_send) {
        const uint32_t una = (uint32_t)t.snd_una[i];
        const uint32_t end = (uint32_t)t.snd_end[i];
        const uint32_t rtarget = 1u + (uint32_t)want_recv;
        const uint32_t cap_end = una + (uint32_t)t.snd_buf_cap[i];
        const uint32_t step_end =
            sdiff(rtarget, una) <= sdiff(cap_end, una) ? rtarget : cap_end;
        if (sdiff(step_end, end) > 0) t.snd_end[i] = step_end;
        if (end == rtarget) t.app_closed[i] = 1;
      }
    }
    t.rcv_read[i] = t.rcv_nxt[i];
  }
  tm.sync();
}

}  // namespace s1
