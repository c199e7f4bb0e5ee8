// K_DELIVER's per-host body as device functions, shared by the per-phase
// kernels of deliver.cu and by K_WINDOW (window.cu).
//
// What it computes (engine._rx_phase): router enqueue of the host's due
// inbox arrivals, then `rx_batch` delivery rounds, each taking the
// earliest candidate in (time, pkt_id) order through the NIC rx token
// bucket and CoDel, into the UDP socket ring or, in TCP worlds, through
// tcp.process_arrivals (tcp.cuh), whose reply goes into lane
// SLOT_RX_REPLY (round 0) or NUM_SLOTS + r - 1.  Every access is
// row-local by the megakernel's blocking contract (megakernel.py:30-37):
// a host touches only its own inbox slab, host row, socket rows and
// emission lanes.  The one cross-host value is each round's pair of
// scoreboard gates (tcp.cuh), which GridGate ORs over the grid.
//
// The pieces (rx_open, rx_round, rx_close) take a team (common.cuh): the
// UDP kernels run deliver_host on one thread per host where the world is
// larger than deliver_small takes, the TCP kernels run deliver_tcp_rounds,
// one warp per host (WarpHosts) or one block (K_WINDOW's resident tgen
// kernel), with each round split at its gate barrier and the host's state
// parked across it.  deliver_small (below)
// is the UDP body for worlds of up to 8-slot slabs and 8 sockets (the
// bench world): the same values as deliver_host on one thread, with the
// host's loads in two dependent steps and the rest on registers.
//
// Interface receive buffers (<host interfacebuffer>, params.iface_buf_pkts)
// are a compile-time choice, the template parameter `Buf` of every body
// here, so worlds without a buffer keep their code.  With a buffer, the
// router enqueue keeps at most `room` = max(bound - rx_queued, 0) of a
// bounded host's due arrivals, the earliest by (time, pkt_id), and frees
// the rest as tail drops (pkts_dropped_router, PDS_ROUTER_DROPPED); and
// no round takes an in-flight arrival as a candidate.  The JAX package
// ranks every due slot against every other in an [H, k, k] cube; here the
// enqueue is two passes: the first counts the host's due slots and, where
// they exceed the room, finds the (time, key) of the last one kept (each
// due slot ranked among the due slots only, by a walk of the slab); the
// second flips each due slot to RX_QUEUED or frees it.  deliver_small does
// it on register bitmasks.
#pragma once
#include <cooperative_groups.h>

#include "common.cuh"
#include "tcp.cuh"

namespace s1 {

// Launch arguments; mirrored field for field by the ctypes.Structure
// in shadow1_tpu_torch/core/megakernel.py.  The per-host inputs and
// outputs (tick_t .. t_post, window_end) are those of the per-phase
// kernel; K_WINDOW passes its own and leaves them null.
struct DeliverArgs {
  const int32_t* ib_blk;
  int32_t* ib_stage;
  int32_t* ib_status;
  int64_t* tokens_rx;
  int64_t* last_refill_rx;
  int32_t* rx_queued;
  int32_t* codel_count;
  uint8_t* codel_dropping;
  int64_t* codel_first_above;
  int64_t* codel_drop_next;
  int64_t* pkts_dropped_router;
  int64_t* pkts_recv;
  int64_t* bytes_recv;
  int64_t* t_resume;
  const int32_t* stype;
  const int32_t* local_port;
  const int32_t* peer_host;
  const int32_t* peer_port;
  int32_t* udp_head;
  int32_t* udp_count;
  int32_t* udp_src;
  int32_t* udp_sport;
  int32_t* udp_len;
  int32_t* udp_payload;
  int64_t* sock_bytes_recv;
  const int64_t* tick_t;
  const uint8_t* active;
  const int64_t* bw_dn;
  const int64_t* aux0;          // null when rx_batch == 1
  int32_t* delivered_n;
  int64_t* t_post;
  const float* rsqrt_tab;       // xlamath.rsqrt_table: 2048 estimates
  const int32_t* iface_buf_pkts;  // [h] interface buffer bounds (0: none)
  int64_t bootstrap_end;
  int64_t window_end;
  int32_t h, ki, ic, slots, rx_batch, pds_trail;
  int32_t has_iface_buf;        // some host has a bound: the Buf bodies
};

// XLA CPU's f32 rsqrt (core/xlamath.py rsqrt): Intel's rsqrtss estimate
// (table of 12-bit mantissas indexed by exponent parity and the top 10
// mantissa bits), then two Newton steps with fused multiply-adds.  The
// estimate is the CPU's own; the JAX results the port is held to come
// from an Intel host.
__device__ __forceinline__ float rsqrt_xla(float x, const float* tab) {
  const int32_t b = __float_as_int(x);
  const int32_t e = ((b >> 23) & 0xFF) - 127;
  const int idx = ((e & 1) << 10) | ((b >> 13) & 0x3FF);
  float y = __int_as_float((__float_as_int(tab[idx]) & 0x7FFFFF) |
                           ((126 - (e >> 1)) << 23));
  for (int i = 0; i < 2; ++i) {
    const float t = __fmaf_rn(y, __fmul_rn(x, y), -1.0f);
    y = __fmaf_rn(__fmul_rn(y, -0.5f), t, y);
  }
  return y;
}

// CoDel drop-next spacing: interval / sqrt(count) as the JAX package
// computes it after XLA's rewrite, int64(f32(interval) * rsqrt(count)).
__device__ __forceinline__ int64_t codel_spacing(int32_t cnt,
                                                 const float* tab) {
  const float c = (float)(cnt > 1 ? cnt : 1);
  return (int64_t)__fmul_rn(rsqrt_xla(c, tab), (float)CODEL_INTERVAL_NS);
}

struct Codel {
  int32_t count;
  bool dropping;
  int64_t first_above, drop_next;

  // nic.codel_dequeue for one host; returns drop.
  __device__ bool dequeue(bool mask, int64_t now, int64_t sojourn,
                          int32_t backlog_after, const float* tab) {
    bool below = (sojourn < CODEL_TARGET_NS) || (backlog_after <= 0);
    int64_t fa_new = below ? 0
                           : (first_above == 0 ? now + CODEL_INTERVAL_NS
                                               : first_above);
    bool ok = mask && !below && fa_new != 0 && now >= fa_new;
    bool drop_in = dropping && ok && now >= drop_next;
    int32_t count_in = count + (drop_in ? 1 : 0);
    int64_t next_in = drop_in ? drop_next + codel_spacing(count_in, tab)
                              : drop_next;
    bool recent = (now - drop_next) < 16 * CODEL_INTERVAL_NS;
    bool enter = mask && !dropping && ok;
    int32_t count_enter = (recent && count > 2) ? count - 2 : 1;
    bool drop = drop_in || enter;
    bool new_dropping = mask ? ((dropping && ok) || enter) : dropping;
    int32_t new_count = enter ? count_enter
                              : ((mask && dropping) ? count_in : count);
    int64_t new_next =
        enter ? now + codel_spacing(count_enter, tab)
              : ((mask && dropping) ? next_in : drop_next);
    if (mask) first_above = fa_new;
    dropping = new_dropping;
    count = new_count;
    drop_next = new_next;
    return drop;
  }
};

struct DeliverOut {
  int32_t delivered;
  int64_t t_post;
};

// Round r's gate bits OR-ed over the whole cooperative grid: per block,
// then one atomic OR per block into words[r] (zero before the round),
// then a grid barrier.  Every thread of the grid calls it once per round,
// from one call site.
struct GridGate {
  int32_t* words;
  __device__ int32_t operator()(int r, int32_t bits) const {
    const int32_t b =
        (__syncthreads_or(bits & GATE_SSACK) ? GATE_SSACK : 0) |
        (__syncthreads_or(bits & GATE_RX) ? GATE_RX : 0);
    if (threadIdx.x == 0 && b != 0) atomicOr(words + r, b);
    cooperative_groups::this_grid().sync();
    return __ldcg(words + r);
  }
};

// One host's receive state across the delivery rounds of a micro-step:
// registers in the one-thread kernels, a record of device scratch across
// the TCP kernels' gate barriers.
struct RxCarry {
  int64_t tick, bound, rate, tokens, last, t_resume;
  int64_t dropped_router, pkts_recv, bytes_recv, t_post;
  Codel cd;
  int32_t rxq, delivered;
  bool act, boot;
};

// The candidate a round took, for the TCP arrival.
struct RxPick {
  const int32_t* row;
  int64_t id, t_eff;
  bool tcp;              // a TCP segment was delivered
};

// The interface buffer's cut for host hh, whose due slots (in flight, time
// <= tick) number more than `room`: the (time, key) of the last due slot
// kept -- the largest among those with fewer than `room` due slots before
// them -- so that a due slot is kept iff its (time, key) is at most that.
// Each lane ranks its own due slots by a walk of the slab (stopping at
// `room`), then the team takes the largest kept pair (a min over the
// negated pairs: times and keys are non-negative).  `keep` is false when
// nothing is kept (room 0).  Reads only; the caller syncs after it.
template <class Team, class Rows>
__device__ __forceinline__ void iface_cut(const DeliverArgs& a,
                                          const Team& tm, int hh,
                                          int64_t tick, int32_t room,
                                          int64_t& cut_t, int64_t& cut_k,
                                          bool& keep, const Rows& rows) {
  const int ki = a.ki;
  const int64_t base = (int64_t)hh * ki;
  const int32_t* stage = a.ib_stage + base;
  int64_t nt = INV, nk = INV;
  int32_t none = 0;
  if (room > 0) {
    each_slot(tm, stage, ki, [&](int j, int32_t st) {
      if (st != STAGE_IN_FLIGHT) return;
      const int64_t tj = rows.time(a, base + j);
      if (tj > tick) return;
      const int64_t kj = rows.key(a, base + j);
      int32_t rank = 0;
      for (int i = 0; i < ki && rank < room; ++i) {
        if (stage[i] != STAGE_IN_FLIGHT) continue;
        const int64_t ti = rows.time(a, base + i);
        // (tj <= tick, so a slot before it is due too.)
        if (ti < tj || (ti == tj && rows.key(a, base + i) < kj)) ++rank;
      }
      if (rank < room && (-tj < nt || (-tj == nt && -kj < nk))) {
        nt = -tj;
        nk = -kj;
      }
    });
  }
  tm.min3(nt, nk, none);
  keep = nt != INV;
  cut_t = -nt;
  cut_k = -nk;
}

// Router enqueue of host hh's due inbox arrivals (the team's lanes take
// slots; the count is a sum) and the host's receive state, for a tick at
// `tick` (active or not); `aux0` is the rx_batch bound at batch start
// (read only when rx_batch > 1).  With `Buf`, a bounded host's due slots
// beyond its room are freed as tail drops (iface_cut).  `rows` gives the
// slots' (time, key).
template <bool Buf, class Team, class Rows = InboxRows>
__device__ __forceinline__ RxCarry rx_open(const DeliverArgs& a,
                                           const Team& tm, int hh,
                                           int64_t tick, bool act,
                                           int64_t aux0,
                                           int64_t window_end,
                                           const Rows& rows = Rows{}) {
  const int ki = a.ki;
  const int64_t base = (int64_t)hh * ki;
  const int32_t rxq0 = a.rx_queued[hh];
  int32_t n = 0, nd = 0;
  // With a buffer: cut the due set at (cut_t, cut_k) when it exceeds the
  // room (`over`).
  bool over = false, keep = true;
  int64_t cut_t = 0, cut_k = 0;
  if constexpr (Buf) {
    const int32_t cap = a.iface_buf_pkts[hh];
    if (act && cap > 0) {
      const int32_t room = imax32(cap - rxq0, 0);
      int32_t due = 0;
      each_slot(tm, a.ib_stage + base, ki, [&](int k, int32_t st) {
        if (st == STAGE_IN_FLIGHT && rows.time(a, base + k) <= tick) ++due;
      });
      over = tm.sum(due) > room;
      if (over) iface_cut(a, tm, hh, tick, room, cut_t, cut_k, keep, rows);
      tm.sync();             // every lane has read the stages
    }
  }
  if (act) {
    each_slot(tm, a.ib_stage + base, ki, [&](int k, int32_t st) {
      if (st != STAGE_IN_FLIGHT) return;
      const int64_t slot = base + k;
      const int64_t t = rows.time(a, slot);
      if (t > tick) return;
      if (Buf && over) {
        const int64_t key = rows.key(a, slot);
        if (!keep || t > cut_t || (t == cut_t && key > cut_k)) {
          a.ib_stage[slot] = STAGE_FREE;
          if (a.pds_trail) a.ib_status[slot] |= PDS_ROUTER_DROPPED;
          ++nd;
          return;
        }
      }
      a.ib_stage[slot] = STAGE_RX_QUEUED;
      if (a.pds_trail) a.ib_status[slot] |= PDS_ROUTER_ENQUEUED;
      ++n;
    });
  }
  RxCarry c;
  c.rxq = rxq0 + tm.sum(n);
  if constexpr (Buf) nd = tm.sum(nd);
  tm.sync();
  c.tick = tick;
  c.act = act;
  c.boot = tick < a.bootstrap_end;
  c.rate = a.bw_dn[hh];
  c.tokens = a.tokens_rx[hh];
  c.last = a.last_refill_rx[hh];
  refill(c.tokens, c.last, c.rate, tick, act);
  c.bound = tick;
  if (a.rx_batch > 1) {
    c.bound = imin(aux0, tick + ONE_MS);
    c.bound = imin(c.bound, window_end - 1);
  }
  c.cd = Codel{a.codel_count[hh], a.codel_dropping[hh] != 0,
               a.codel_first_above[hh], a.codel_drop_next[hh]};
  c.t_resume = a.t_resume[hh];
  c.dropped_router = a.pkts_dropped_router[hh] + nd;
  c.pkts_recv = a.pkts_recv[hh];
  c.bytes_recv = a.bytes_recv[hh];
  c.delivered = 0;
  c.t_post = tick;
  return c;
}

// Delivery round r of host hh: the earliest candidate by (time, pkt_id),
// lowest slot on a full tie (a lexicographic min over the team's lanes),
// through the NIC rx token bucket and CoDel, into the UDP socket ring
// (udp.lookup_socket: connected beats wildcard, lowest slot on ties -- a
// min over the lanes).  Returns the pick for tcp.process_arrivals.  With
// `Buf`, only the queued backlog is a candidate.  `rows` gives the slots'
// (time, key); the picked row itself is read from the inbox.
template <bool Buf, class Team, class Rows = InboxRows>
__device__ __forceinline__ RxPick rx_round(const DeliverArgs& a,
                                           const Team& tm, RxCarry& c,
                                           int hh, int r,
                                           const Rows& rows = Rows{}) {
  const int ki = a.ki, ic = a.ic, S = a.slots;
  const int64_t base = (int64_t)hh * ki;
  const int64_t limit = r == 0 ? c.tick : c.bound;
  int64_t tmin = INV, kmin = INV;
  int32_t col = ki;
  if (c.act) {
    // The stage column first: a row is read only for a live slot.
    each_slot(tm, a.ib_stage + base, ki, [&](int k, int32_t st) {
      if (st != STAGE_RX_QUEUED &&
          (Buf || r == 0 || st != STAGE_IN_FLIGHT))
        return;
      const int64_t t = rows.time(a, base + k);
      if (st == STAGE_IN_FLIGHT && t > limit) return;
      const int64_t key = rows.key(a, base + k);
      if (t < tmin || (t == tmin && key < kmin)) {
        tmin = t;
        kmin = key;
        col = k;
      }
    });
  }
  tm.min3(tmin, kmin, col);
  const bool have = c.act && col < ki && tmin <= limit;
  if (col > ki - 1) col = ki - 1;
  const int64_t slot = base + col;
  const bool was_queued = have && a.ib_stage[slot] == STAGE_RX_QUEUED;
  const int64_t t_eff = imax(c.tick, have ? tmin : 0);
  const int32_t* row = a.ib_blk + slot * ic;
  const int32_t p_src = row[ICOL_SRC];
  const int32_t p_proto = row[ICOL_PROTO];
  const int32_t p_len = row[ICOL_LEN];
  const int64_t p_time = have ? tmin : 0;

  if (r > 0) refill(c.tokens, c.last, c.rate, t_eff, have);
  const int64_t size = wire_size(p_proto, p_len);
  const bool loop = p_src == hh;
  const bool free_pass = loop || c.boot;
  const bool funded = have && (free_pass || c.tokens >= size);
  const int64_t sojourn = imax(t_eff - p_time, 0);
  const int32_t backlog_after = c.rxq - (was_queued ? 1 : 0);
  const bool drop = c.cd.dequeue(funded && !loop, t_eff, sojourn,
                                 backlog_after, a.rsqrt_tab);
  const bool deliver = funded && !drop;
  if (funded && !free_pass) c.tokens -= size;
  tm.sync();                 // every lane has read the slot's stage
  if (funded && tm.leader()) {
    a.ib_stage[slot] = STAGE_FREE;
    if (a.pds_trail) {
      a.ib_status[slot] |= drop ? (PDS_ROUTER_ENQUEUED | PDS_ROUTER_DROPPED)
                                : (PDS_ROUTER_ENQUEUED |
                                   PDS_RCV_SOCKET_PROCESSED);
    }
  }
  if (funded && was_queued) --c.rxq;
  if (drop) ++c.dropped_router;
  if (r == a.rx_batch - 1) {
    const int64_t t_res =
        (have && !funded) ? c.tick + time_until(size - c.tokens, c.rate)
                          : ((funded && c.rxq > 0) ? c.tick : INV);
    c.t_resume = imin(c.t_resume, t_res);
  }

  if (deliver && p_proto == PROTO_UDP) {
    const int32_t p_sport = row[ICOL_SPORT], p_dport = row[ICOL_DPORT];
    int32_t best = 2 * S;           // (2 - score) * S + slot; none: 2 * S
    for (int s = tm.lane(); s < S; s += Team::W) {
      const int64_t i = (int64_t)hh * S + s;
      if (a.stype[i] != SOCK_UDP || a.local_port[i] != p_dport) continue;
      const int32_t score =
          (a.peer_host[i] == p_src && a.peer_port[i] == p_sport) ? 2
          : (a.peer_host[i] == -1 ? 1 : 0);
      if (score > 0) best = imin32(best, (2 - score) * S + s);
    }
    best = tm.min32(best);
    if (best < 2 * S && tm.leader()) {
      // udp.push_ring: append unless the ring is full.
      const int64_t i = (int64_t)hh * S + (best < S ? best : best - S);
      const int32_t cnt = a.udp_count[i];
      if (cnt < UDP_RING) {
        const int32_t pos = (a.udp_head[i] + cnt) % UDP_RING;
        const int64_t j = i * UDP_RING + pos;
        a.udp_src[j] = p_src;
        a.udp_sport[j] = p_sport;
        a.udp_len[j] = p_len;
        a.udp_payload[j] = row[ICOL_PAYLOAD];
        a.udp_count[i] = cnt + 1;
        a.sock_bytes_recv[i] += p_len;
      }
    }
  }
  if (deliver) {
    ++c.pkts_recv;
    c.bytes_recv += p_len;
    ++c.delivered;
  }
  if (r == 0) {
    c.t_post = deliver ? t_eff : c.tick;
  } else if (deliver) {
    c.t_post = imax(c.t_post, t_eff);
  }
  tm.sync();
  return RxPick{row, have ? kmin : 0, t_eff, deliver && p_proto == PROTO_TCP};
}

// The host's receive state back to its rows.
template <class Team>
__device__ __forceinline__ DeliverOut rx_close(const DeliverArgs& a,
                                               const Team& tm,
                                               const RxCarry& c, int hh) {
  if (tm.leader()) {
    a.rx_queued[hh] = c.rxq;
    a.tokens_rx[hh] = c.tokens;
    a.last_refill_rx[hh] = c.last;
    a.codel_count[hh] = c.cd.count;
    a.codel_dropping[hh] = c.cd.dropping ? 1 : 0;
    a.codel_first_above[hh] = c.cd.first_above;
    a.codel_drop_next[hh] = c.cd.drop_next;
    a.t_resume[hh] = c.t_resume;
    a.pkts_dropped_router[hh] = c.dropped_router;
    a.pkts_recv[hh] = c.pkts_recv;
    a.bytes_recv[hh] = c.bytes_recv;
  }
  tm.sync();
  return DeliverOut{c.delivered, c.t_post};
}

// _rx_phase for host hh of a UDP world at tick `tick` (active or not), on
// one team, with no barrier: the enqueue, the rounds, the write-back,
// each marked on `clk`.
template <bool Buf, class Team>
__device__ __forceinline__ DeliverOut deliver_host(const DeliverArgs& a,
                                                   const Team& tm, int hh,
                                                   int64_t tick, bool act,
                                                   int64_t aux0,
                                                   int64_t window_end,
                                                   Clk& clk) {
  RxCarry c = rx_open<Buf>(a, tm, hh, tick, act, aux0, window_end);
  clk.mark(CLK_ENQUEUE);
  for (int r = 0; r < a.rx_batch; ++r) {
    rx_round<Buf>(a, tm, c, hh, r);
    clk.round(r, CLK_SELECT);
  }
  const DeliverOut o = rx_close(a, tm, c, hh);
  clk.mark(CLK_RXCLOSE);
  return o;
}

// ---------------------------------------------------------------------------
// deliver_small: deliver_host<Solo>'s body for the UDP kernels (k_deliver,
// phold's k_window) in worlds that fit: inbox slabs and socket tables of
// at most RX_SMALL slots, rx_batch at most RX_SMALL_BATCH, rows of an even
// number of 4-byte columns from an 8-byte aligned base (the bench world:
// 8-slot slabs, 4 sockets, rx_batch 2, 14 columns).  Written so that a
// host's loads are two dependent steps deep:
//   1. everything that depends only on the host, issued at once: the
//      caller's four words that give its tick, active flag, rx_batch bound
//      and resume time (`Setup`: the per-phase arrays, or K_WINDOW's tick
//      setup), the slab's stage words (two 16-byte loads), the receive
//      fields of its row and bw_dn, and its sockets' type, ports, peer and
//      ring head and count;
//   2. for the live slots (in flight or rx-queued) of an active host,
//      predicated: the columns every round compares (time, src, ctr) into
//      registers, and the three 8-byte pieces only a picked row needs
//      ((src, sport), (dport, proto), (len, payload)) into the thread's
//      rows of shared memory `rows` by cp.async, which spends no register.
// Then the router enqueue, each round's lexicographic min over (time, key,
// slot), the NIC refill and CoDel (rsqrt_tab is read only on CoDel's
// spacing path), the socket score and the ring append run on registers and
// slot bitmasks (in flight, rx-queued; a funded pick leaves both), the
// picked row's pieces read from shared memory at its slot; each socket's
// ring count is carried across the rounds (two deliveries of one step may
// fill one ring).  One write-back at the end, for active hosts only (an
// inactive host's words do not change): the stage words of the slots that
// changed, the PDS trail's status bits and the socket's byte count added
// by atomics whose result is not read (the thread is the words' only
// writer, so the sums are exact).  Register arrays are indexed by unrolled
// constants.  The same values as deliver_host<Solo> on the inputs
// Setup::resolve gives (returned in `in`; K_WINDOW's re-armed resume time
// is written back with the row).  With `Buf`, the host's bound is a word of
// step 1, and the tail drop ranks each due slot by the popcount of the due
// slots before it in (time, key).
// ---------------------------------------------------------------------------

constexpr int RX_SMALL = 8;
constexpr int RX_SMALL_BATCH = 8;

// Does the world fit deliver_small?  The same for every host of a launch
// (deliver_launch and k_window decide once from the arguments).
__host__ __device__ inline bool deliver_small_fits(const DeliverArgs& a) {
  return a.ki <= RX_SMALL && a.slots <= RX_SMALL &&
         a.rx_batch <= RX_SMALL_BATCH && (a.ic & 1) == 0 &&
         (reinterpret_cast<uintptr_t>(a.ib_blk) & 7u) == 0;
}

// A host's inputs to its delivery phase: its tick, the rx_batch bound at
// batch start (aux0), its resume time as the phase starts, and whether it
// is active.
struct RxIn {
  int64_t tick, aux0, t_resume;
  bool act;
};

// deliver_small's inputs in the per-phase kernel: K_DELIVER's arrays.
struct PhaseRxIn {
  const DeliverArgs& a;
  __device__ void load(int hh, int64_t* w) const {
    w[0] = a.tick_t[hh];
    w[1] = a.active[hh];
    w[2] = a.rx_batch > 1 ? a.aux0[hh] : INV;
    w[3] = a.t_resume[hh];
  }
  __device__ RxIn resolve(const int64_t* w) const {
    return RxIn{w[0], w[2], w[3], w[1] != 0};
  }
};

// The shared memory deliver_small takes in a block of B threads: three
// 8-byte pieces of RX_SMALL rows a thread, [piece][slot][thread].
template <int B>
struct RxRows {
  int2 w[3 * RX_SMALL * B];
};

template <bool Buf, int B, class Setup>
__device__ __forceinline__ DeliverOut deliver_small(
    const DeliverArgs& a, int hh, const Setup& setup, int64_t window_end,
    RxRows<B>& rows, RxIn& in, Clk& clk) {
  const int ki = a.ki, ic = a.ic, S = a.slots, rb = a.rx_batch;
  const int64_t base = (int64_t)hh * ki, sbase = (int64_t)hh * S;
  int2* const mine = rows.w + threadIdx.x;   // piece f of slot k at
                                             // mine[(f * RX_SMALL + k) * B]

  // ---- step 1: the host's own words -------------------------------------
  int64_t w_in[4];
  setup.load(hh, w_in);
  int32_t st[RX_SMALL];
  load8(a.ib_stage + base, ki, st, STAGE_FREE);
  int64_t tokens = a.tokens_rx[hh], last = a.last_refill_rx[hh];
  const int64_t rate = a.bw_dn[hh];
  int32_t rxq = a.rx_queued[hh];
  const int32_t cd_count = a.codel_count[hh];
  const int32_t cd_dropping = a.codel_dropping[hh];
  const int64_t cd_first = a.codel_first_above[hh];
  const int64_t cd_next = a.codel_drop_next[hh];
  int64_t dropped = a.pkts_dropped_router[hh];
  int64_t pkts = a.pkts_recv[hh], bytes = a.bytes_recv[hh];
  const int32_t cap = Buf ? a.iface_buf_pkts[hh] : 0;
  int32_t s_type[RX_SMALL], s_port[RX_SMALL], s_phost[RX_SMALL],
      s_pport[RX_SMALL], s_head[RX_SMALL], s_cnt[RX_SMALL];
#pragma unroll
  for (int s = 0; s < RX_SMALL; ++s) {
    s_type[s] = s_port[s] = s_phost[s] = s_pport[s] = s_head[s] =
        s_cnt[s] = 0;
    if (s < S) {
      s_type[s] = a.stype[sbase + s];
      s_port[s] = a.local_port[sbase + s];
      s_phost[s] = a.peer_host[sbase + s];
      s_pport[s] = a.peer_port[sbase + s];
      s_head[s] = a.udp_head[sbase + s];
      s_cnt[s] = a.udp_count[sbase + s];
    }
  }
#pragma unroll
  for (int k = 0; k < RX_SMALL; ++k) {
    keep(st[k]);
    keep(s_type[k]);
    keep(s_port[k]);
    keep(s_phost[k]);
    keep(s_pport[k]);
    keep(s_head[k]);
    keep(s_cnt[k]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) keep(w_in[j]);
  keep(tokens);
  keep(last);
  keep(rate);
  keep(rxq);
  keep(cd_count);
  keep(cd_dropping);
  keep(cd_first);
  keep(cd_next);
  keep(dropped);
  if constexpr (Buf) keep(cap);
  keep(pkts);
  keep(bytes);
  in = setup.resolve(w_in);
  const int64_t tick = in.tick;
  const bool act = in.act;
  int64_t t_resume = in.t_resume;
  clk.mark(CLK_SETUP);

  // Slot masks (bit k: slot k) and the UDP sockets' mask.
  uint32_t inf_m = 0, rxq_m = 0, udp_m = 0;
#pragma unroll
  for (int k = 0; k < RX_SMALL; ++k) {
    if (act && st[k] == STAGE_IN_FLIGHT) inf_m |= 1u << k;
    if (act && st[k] == STAGE_RX_QUEUED) rxq_m |= 1u << k;
    if (k < S && s_type[k] == SOCK_UDP) udp_m |= 1u << k;
  }

  // ---- step 2: the live slots' rows ---------------------------------------
  int64_t tm[RX_SMALL], key[RX_SMALL];
  int32_t src[RX_SMALL];
#pragma unroll
  for (int k = 0; k < RX_SMALL; ++k) {
    tm[k] = key[k] = INV;
    src[k] = 0;
    if ((inf_m | rxq_m) & (1u << k)) {
      const int32_t* row = a.ib_blk + (base + k) * ic;
      const int2 wt = *reinterpret_cast<const int2*>(row + ICOL_TIME_LO);
      const int2 wc = *reinterpret_cast<const int2*>(row + ICOL_CTR_LO);
      src[k] = row[ICOL_SRC];
      tm[k] = dec_i64(wt.x, wt.y);
      key[k] = ((int64_t)src[k] << 40) | dec_i64(wc.x, wc.y);
      copy8_async(mine + (0 * RX_SMALL + k) * B, row + ICOL_SRC);
      copy8_async(mine + (1 * RX_SMALL + k) * B, row + ICOL_DPORT);
      copy8_async(mine + (2 * RX_SMALL + k) * B, row + ICOL_LEN);
    }
  }
#pragma unroll
  for (int k = 0; k < RX_SMALL; ++k) {
    keep(tm[k]);
    keep(key[k]);
  }

  // ---- router enqueue and the receive state, on registers -----------------
  uint32_t enq_m = 0;                    // enqueued by this step
#pragma unroll
  for (int k = 0; k < RX_SMALL; ++k)
    if ((inf_m & (1u << k)) && tm[k] <= tick) enq_m |= 1u << k;
  uint32_t tail_m = 0;                   // tail-dropped by this step
  if constexpr (Buf) {
    if (cap > 0) {
      // A due slot's rank: the due slots before it in (time, key).
      const int32_t room = imax32(cap - rxq, 0);
#pragma unroll
      for (int k = 0; k < RX_SMALL; ++k) {
        uint32_t before = 0;
#pragma unroll
        for (int j = 0; j < RX_SMALL; ++j)
          if (tm[j] < tm[k] || (tm[j] == tm[k] && key[j] < key[k]))
            before |= 1u << j;
        if ((enq_m & (1u << k)) && __popc(before & enq_m) >= room)
          tail_m |= 1u << k;
      }
      enq_m &= ~tail_m;
      inf_m &= ~tail_m;
      dropped += __popc(tail_m);
    }
  }
  inf_m &= ~enq_m;
  rxq_m |= enq_m;
  rxq += __popc(enq_m);
  const bool boot = tick < a.bootstrap_end;
  const int64_t span = refill_span(rate);
  refill(tokens, last, rate, span, tick, act);
  int64_t bound = tick;
  if (rb > 1) {
    bound = imin(in.aux0, tick + ONE_MS);
    bound = imin(bound, window_end - 1);
  }
  uint32_t late_m = 0;                   // in flight and due by `bound`
#pragma unroll
  for (int k = 0; k < RX_SMALL; ++k)
    if (!Buf && tm[k] <= bound) late_m |= 1u << k;
  Codel cd{cd_count, cd_dropping != 0, cd_first, cd_next};
  int32_t delivered = 0;
  int64_t t_post = tick;
  uint32_t drop_m = 0, rcv_m = 0;        // funded picks, dropped / not
  uint32_t pushed_m = 0;                 // sockets whose ring count grew
  copy_wait();
  clk.mark(CLK_ENQUEUE);

  // ---- the delivery rounds, on registers ----------------------------------
  for (int r = 0; r < rb; ++r) {
    const int64_t limit = r == 0 ? tick : bound;
    const uint32_t cand_m = rxq_m | (r > 0 ? inf_m & late_m : 0u);
    int64_t tmin = INV, kmin = INV;
    int col = ki;
#pragma unroll
    for (int k = 0; k < RX_SMALL; ++k) {
      if ((cand_m & (1u << k)) &&
          (tm[k] < tmin || (tm[k] == tmin && key[k] < kmin))) {
        tmin = tm[k];
        kmin = key[k];
        col = k;
      }
    }
    const bool have = col < ki && tmin <= limit;
    int32_t p_src = 0, p_sport = 0, p_dport = 0, p_proto = 0, p_len = 0,
            p_pay = 0;
    if (have) {
      const int2 w0 = mine[(0 * RX_SMALL + col) * B];
      const int2 w1 = mine[(1 * RX_SMALL + col) * B];
      const int2 w4 = mine[(2 * RX_SMALL + col) * B];
      p_src = w0.x;
      p_sport = w0.y;
      p_dport = w1.x;
      p_proto = w1.y;
      p_len = w4.x;
      p_pay = w4.y;
    }
    const uint32_t bit = have ? 1u << col : 0u;
    const bool was_queued = (rxq_m & bit) != 0;
    const int64_t t_eff = imax(tick, have ? tmin : 0);
    const int64_t p_time = have ? tmin : 0;

    if (r > 0) refill(tokens, last, rate, span, t_eff, have);
    const int64_t size = wire_size(p_proto, p_len);
    const bool loop = p_src == hh;
    const bool free_pass = loop || boot;
    const bool funded = have && (free_pass || tokens >= size);
    const int64_t sojourn = imax(t_eff - p_time, 0);
    const int32_t backlog_after = rxq - (was_queued ? 1 : 0);
    const bool drop = cd.dequeue(funded && !loop, t_eff, sojourn,
                                 backlog_after, a.rsqrt_tab);
    const bool deliver = funded && !drop;
    if (funded && !free_pass) tokens -= size;
    if (funded) {
      inf_m &= ~bit;
      rxq_m &= ~bit;
      if (drop)
        drop_m |= bit;
      else
        rcv_m |= bit;
    }
    if (funded && was_queued) --rxq;
    if (drop) ++dropped;
    if (r == rb - 1) {
      int64_t t_res = (funded && rxq > 0) ? tick : INV;
      if (have && !funded) t_res = tick + time_until(size - tokens, rate);
      t_resume = imin(t_resume, t_res);
    }

    if (deliver && p_proto == PROTO_UDP) {
      // udp.lookup_socket: connected beats wildcard, lowest slot on ties.
      int32_t best = 2 * S;             // (2 - score) * S + slot
#pragma unroll
      for (int s = 0; s < RX_SMALL; ++s) {
        if (!(udp_m & (1u << s)) || s_port[s] != p_dport) continue;
        const int32_t score =
            (s_phost[s] == p_src && s_pport[s] == p_sport) ? 2
            : (s_phost[s] == -1 ? 1 : 0);
        if (score > 0) best = imin32(best, (2 - score) * S + s);
      }
      const int m = best < S ? best : best - S;
#pragma unroll
      for (int s = 0; s < RX_SMALL; ++s) {
        // udp.push_ring: append unless the ring is full.
        if (best == 2 * S || s != m || s_cnt[s] >= UDP_RING) continue;
        const int64_t i = sbase + s;
        const int64_t j = i * UDP_RING + (s_head[s] + s_cnt[s]) % UDP_RING;
        a.udp_src[j] = p_src;
        a.udp_sport[j] = p_sport;
        a.udp_len[j] = p_len;
        a.udp_payload[j] = p_pay;
        atomicAdd(reinterpret_cast<unsigned long long*>(a.sock_bytes_recv +
                                                        i),
                  (unsigned long long)(int64_t)p_len);
        ++s_cnt[s];
        pushed_m |= 1u << s;
      }
    }
    if (deliver) {
      ++pkts;
      bytes += p_len;
      ++delivered;
    }
    if (r == 0) {
      t_post = deliver ? t_eff : tick;
    } else if (deliver) {
      t_post = imax(t_post, t_eff);
    }
    clk.round(r, CLK_SELECT);
  }

  // ---- the write-back (an inactive host changes nothing) ------------------
  if (act) {
    const uint32_t done_m = drop_m | rcv_m;
#pragma unroll
    for (int k = 0; k < RX_SMALL; ++k) {
      const uint32_t bit = 1u << k;
      if (!((enq_m | done_m | tail_m) & bit)) continue;
      a.ib_stage[base + k] =
          ((done_m | tail_m) & bit) ? STAGE_FREE : STAGE_RX_QUEUED;
      if (a.pds_trail)
        atomicOr(a.ib_status + base + k,
                 (tail_m & bit) ? PDS_ROUTER_DROPPED
                 : PDS_ROUTER_ENQUEUED |
                     ((drop_m & bit) ? PDS_ROUTER_DROPPED : 0) |
                     ((rcv_m & bit) ? PDS_RCV_SOCKET_PROCESSED : 0));
    }
#pragma unroll
    for (int s = 0; s < RX_SMALL; ++s)
      if (pushed_m & (1u << s)) a.udp_count[sbase + s] = s_cnt[s];
    a.rx_queued[hh] = rxq;
    a.tokens_rx[hh] = tokens;
    a.last_refill_rx[hh] = last;
    a.codel_count[hh] = cd.count;
    a.codel_dropping[hh] = cd.dropping ? 1 : 0;
    a.codel_first_above[hh] = cd.first_above;
    a.codel_drop_next[hh] = cd.drop_next;
    a.t_resume[hh] = t_resume;
    a.pkts_dropped_router[hh] = dropped;
    a.pkts_recv[hh] = pkts;
    a.bytes_recv[hh] = bytes;
  }
  clk.mark(CLK_RXCLOSE);
  return DeliverOut{delivered, t_post};
}

// A host's carry across the TCP kernels' gate barriers.
struct HostCarry {
  RxCarry rx;
  Arrival ar;
};
constexpr int HOST_CARRY_BYTES = 512;    // megakernel.py CARRY_BYTES
static_assert(sizeof(HostCarry) <= HOST_CARRY_BYTES,
              "HostCarry outgrew its scratch record");

// The warp design's hosts (k_deliver_tcp, k_window_tcp, k_window_tgen):
// one warp per host, the hosts walked warp-stride over the whole grid (so
// any number of hosts), a host's carry across a gate parked in its record
// of device scratch (`carry`), its rows read from the inbox.  A host
// policy of deliver_tcp_rounds gives its team `tm` and row policy `rows`,
// `each(f)` -- f(hh) for every host of the calling team -- and `park` /
// `unpark` of a host's carry.
struct WarpHosts {
  using Team = Warp;
  Team tm{};
  InboxRows rows{};
  HostCarry* carry;
  int h;
  __device__ WarpHosts(void* carry_, int h_)
      : carry((HostCarry*)carry_), h(h_) {}
  template <class F>
  __device__ void each(const F& f) const {
    const int64_t nw = (int64_t)gridDim.x * blockDim.x / Warp::W;
    for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) /
                     Warp::W;
         i < h; i += nw)
      f((int)i);
  }
  __device__ void park(int hh, const RxCarry& c, const Arrival& ar) const {
    if (tm.leader()) {
      carry[hh].rx = c;
      carry[hh].ar = ar;
    }
  }
  __device__ void unpark(int hh, RxCarry& c, Arrival& ar) const {
    c = carry[hh].rx;
    ar = carry[hh].ar;
  }
};

// _rx_phase with tcp.process_arrivals for every host of a TCP world on
// the host policy `hosts` (WarpHosts, or window.cu's resident block).
// Each delivery round's scoreboard gates are global, so a round is split
// at its gate barrier into two passes over the hosts; the same team
// always takes the same host, so pass B of round r and pass A of round
// r + 1 are one pass:
//   pass r (r = 0 .. rb): finish of round r - 1 under its gates (r > 0;
//     before it: `setup`, the tick and the router enqueue, at r = 0);
//     then (r < rb) round r's select/NIC and tcp_arrival_begin, the
//     host's carry parked (hosts.park), its gate bits OR-ed into the
//     thread's; or (r == rb) the write-back and `tail`, the rest of the
//     host's micro-step;
//   between passes, the round's gate: block OR, one atomicOr, one grid
//   barrier, reached by every thread from this one call site.
// `setup(hh, tick, act, aux0)` gives a host's tick; `tail(hh, c, out,
// traced)` gets its carry and K_DELIVER's outputs.  `Buf` and `Cong` are
// the interface-buffer and congestion-control instantiations.  `clk`
// traces host `clk_host`.  Returns the socket-overflow error bits of
// passive opens.
template <bool Buf, int Cong, class Hosts, class Setup, class Tail>
__device__ __forceinline__ int32_t deliver_tcp_rounds(
    const DeliverArgs& a, const TcpArgs& t, Hosts& hosts,
    int32_t* gate_words, int64_t window_end, Clk& clk, int clk_host,
    const Setup& setup, const Tail& tail) {
  const auto& tm = hosts.tm;
  const int rb = a.rx_batch;
  int32_t err = 0, g = 0;
  for (int r = 0; r <= rb; ++r) {
    int32_t bits = 0;
    hosts.each([&](int hh) {
      const bool traced = hh == clk_host;
      if (traced) clk.start();
      RxCarry c;
      if (r == 0) {
        int64_t tick, aux0;
        bool act;
        setup(hh, tick, act, aux0);
        c = rx_open<Buf>(a, tm, hh, tick, act, aux0, window_end,
                         hosts.rows);
        if (traced) clk.mark(CLK_ENQUEUE);
      } else {
        Arrival ar;
        hosts.unpark(hh, c, ar);
        tcp_arrival_finish<Cong>(tm, t, ar, hh, g,
                                 r == 1 ? SLOT_RX_REPLY : NUM_SLOTS + r - 2);
        if (traced) clk.round(r - 1, CLK_FINISH);
      }
      if (r < rb) {
        const RxPick pk = rx_round<Buf>(a, tm, c, hh, r, hosts.rows);
        if (traced) clk.round(r, CLK_SELECT);
        Arrival ar;
        err |= tcp_arrival_begin(tm, t, ar, hh, pk.row, pk.id, pk.t_eff,
                                 pk.tcp);
        bits |= ar.gate_bits;
        hosts.park(hh, c, ar);
        if (traced) clk.round(r, CLK_BEGIN);
      } else {
        tail(hh, c, rx_close(a, tm, c, hh), traced);
      }
    });
    if (r < rb) {
      clk.start();
      g = GridGate{gate_words}(r, bits);
      clk.round(r, CLK_GATE);
    }
  }
  return err;
}

}  // namespace s1
