// K_DELIVER's per-host body as a device function, shared by the per-phase
// kernel of deliver.cu and by K_WINDOW (window.cu).
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
// scoreboard gates (tcp.cuh), which the caller's `gate` ORs over the
// grid; every thread of the grid, host or not, calls it once per round.
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
  int64_t bootstrap_end;
  int64_t window_end;
  int32_t h, ki, ic, slots, rx_batch, pds_trail;
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

// The gate of UDP worlds: never called (no TCP branch runs).
struct NoGate {
  __device__ int32_t operator()(int, int32_t bits) const { return bits; }
};

// Round r's gate bits OR-ed over the whole cooperative grid: per block,
// then one atomic OR per block into words[r] (zero before the round),
// then a grid barrier.  Every thread of the grid calls it once per round.
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

// _rx_phase for host hh at tick `tick` (active or not); `aux0` is the
// rx_batch bound at batch start (read only when rx_batch > 1).  `tcp` is
// null in UDP worlds.  A thread with no host (`valid` false) touches no
// memory but runs the same rounds, so that every thread of the block
// reaches the one `gate` call of each round at the same place (a
// barrier must not be reached from divergent call sites).  The
// socket-overflow error bits of the TCP branch are OR-ed into `err`.
template <class Gate>
__device__ __forceinline__ DeliverOut deliver_host(
    const DeliverArgs& a, const TcpArgs* tcp, const Gate& gate, int hh,
    bool valid, int64_t tick, bool act, int64_t aux0, int64_t window_end,
    int32_t& err) {
  const int ki = a.ki, ic = a.ic, S = a.slots;
  const int64_t base = (int64_t)hh * ki;
  int32_t rxq = 0;
  bool boot = false;
  int64_t rate = 0, tokens = 0, last = 0, bound = tick, t_resume = INV;
  int64_t dropped_router = 0, pkts_recv = 0, bytes_recv = 0;
  Codel cd{0, false, 0, 0};
  if (valid) {
    // Router enqueue: due wire arrivals join the router queue.
    rxq = a.rx_queued[hh];
    for (int k = 0; k < ki && act; ++k) {
      const int64_t slot = base + k;
      if (a.ib_stage[slot] != STAGE_IN_FLIGHT) continue;
      const int32_t* row = a.ib_blk + slot * ic;
      if (dec_i64(row[ICOL_TIME_LO], row[ICOL_TIME_HI]) <= tick) {
        a.ib_stage[slot] = STAGE_RX_QUEUED;
        if (a.pds_trail) a.ib_status[slot] |= PDS_ROUTER_ENQUEUED;
        ++rxq;
      }
    }
    boot = tick < a.bootstrap_end;
    rate = a.bw_dn[hh];
    tokens = a.tokens_rx[hh];
    last = a.last_refill_rx[hh];
    refill(tokens, last, rate, tick, act);
    if (a.rx_batch > 1) {
      bound = imin(aux0, tick + ONE_MS);
      bound = imin(bound, window_end - 1);
    }
    cd = Codel{a.codel_count[hh], a.codel_dropping[hh] != 0,
               a.codel_first_above[hh], a.codel_drop_next[hh]};
    t_resume = a.t_resume[hh];
    dropped_router = a.pkts_dropped_router[hh];
    pkts_recv = a.pkts_recv[hh];
    bytes_recv = a.bytes_recv[hh];
  }
  int32_t delivered = 0;
  int64_t t_post = tick;

  for (int r = 0; r < a.rx_batch; ++r) {
    bool have = false, deliver = false;
    int32_t p_proto = 0, p_len = 0;
    int64_t t_eff = tick, kmin = INV;
    const int32_t* row = a.ib_blk;
    if (valid) {
      const int64_t limit = r == 0 ? tick : bound;
      // Earliest candidate by (time, pkt_id), lowest slot on a full tie.
      int64_t tmin = INV;
      int col = ki;
      for (int k = 0; k < ki && act; ++k) {
        // The stage column first: a row is read only for a live slot.
        const int64_t slot = base + k;
        const int32_t st = a.ib_stage[slot];
        if (st != STAGE_RX_QUEUED && (r == 0 || st != STAGE_IN_FLIGHT))
          continue;
        const int32_t* rk = a.ib_blk + slot * ic;
        const int64_t t = dec_i64(rk[ICOL_TIME_LO], rk[ICOL_TIME_HI]);
        if (st == STAGE_IN_FLIGHT && t > limit) continue;
        const int64_t key = ((int64_t)rk[ICOL_SRC] << 40) |
                            dec_i64(rk[ICOL_CTR_LO], rk[ICOL_CTR_HI]);
        if (t < tmin || (t == tmin && key < kmin)) {
          tmin = t;
          kmin = key;
          col = k;
        }
      }
      have = act && col < ki && tmin <= limit;
      if (col > ki - 1) col = ki - 1;
      const int64_t slot = base + col;
      const bool was_queued = have && a.ib_stage[slot] == STAGE_RX_QUEUED;
      t_eff = imax(tick, have ? tmin : 0);
      row = a.ib_blk + slot * ic;
      const int32_t p_src = row[ICOL_SRC];
      p_proto = row[ICOL_PROTO];
      p_len = row[ICOL_LEN];
      const int64_t p_time = have ? tmin : 0;

      if (r > 0) refill(tokens, last, rate, t_eff, have);
      const int64_t size = wire_size(p_proto, p_len);
      const bool loop = p_src == hh;
      const bool free_pass = loop || boot;
      const bool funded = have && (free_pass || tokens >= size);
      const int64_t sojourn = imax(t_eff - p_time, 0);
      const int32_t backlog_after = rxq - (was_queued ? 1 : 0);
      const bool drop = cd.dequeue(funded && !loop, t_eff, sojourn,
                                   backlog_after, a.rsqrt_tab);
      deliver = funded && !drop;
      if (funded && !free_pass) tokens -= size;
      if (funded) {
        a.ib_stage[slot] = STAGE_FREE;
        if (a.pds_trail) {
          a.ib_status[slot] |= drop ? (PDS_ROUTER_ENQUEUED |
                                       PDS_ROUTER_DROPPED)
                                    : (PDS_ROUTER_ENQUEUED |
                                       PDS_RCV_SOCKET_PROCESSED);
        }
      }
      if (funded && was_queued) --rxq;
      if (drop) ++dropped_router;
      if (r == a.rx_batch - 1) {
        const int64_t t_res =
            (have && !funded) ? tick + time_until(size - tokens, rate)
                              : ((funded && rxq > 0) ? tick : INV);
        t_resume = imin(t_resume, t_res);
      }

      if (deliver && p_proto == PROTO_UDP) {
        // udp.lookup_socket: connected beats wildcard, lowest slot on
        // ties.
        const int32_t p_sport = row[ICOL_SPORT], p_dport = row[ICOL_DPORT];
        int best = 0, sl = 0;
        for (int s = 0; s < S; ++s) {
          const int64_t i = (int64_t)hh * S + s;
          const bool port_ok = a.stype[i] == SOCK_UDP &&
                               a.local_port[i] == p_dport;
          const int score =
              !port_ok ? 0
              : (a.peer_host[i] == p_src && a.peer_port[i] == p_sport) ? 2
              : (a.peer_host[i] == -1 ? 1 : 0);
          if (score > best) {
            best = score;
            sl = s;
          }
        }
        if (best > 0) {
          // udp.push_ring: append unless the ring is full.
          const int64_t i = (int64_t)hh * S + sl;
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
    }
    if (tcp != nullptr) {
      // tcp.process_arrivals, split at the round's grid-wide gates.
      Arrival ar;
      ar.gate_bits = 0;
      if (valid)
        err |= tcp_arrival_begin(*tcp, ar, hh, row, have ? kmin : 0, t_eff,
                                 deliver && p_proto == PROTO_TCP);
      const int32_t g = gate(r, ar.gate_bits);
      if (valid)
        tcp_arrival_finish(*tcp, ar, hh, g,
                           r == 0 ? SLOT_RX_REPLY : NUM_SLOTS + r - 1);
    }
    if (deliver) {
      ++pkts_recv;
      bytes_recv += p_len;
      ++delivered;
    }
    if (r == 0) {
      t_post = deliver ? t_eff : tick;
    } else if (deliver) {
      t_post = imax(t_post, t_eff);
    }
  }

  if (valid) {
    a.rx_queued[hh] = rxq;
    a.tokens_rx[hh] = tokens;
    a.last_refill_rx[hh] = last;
    a.codel_count[hh] = cd.count;
    a.codel_dropping[hh] = cd.dropping ? 1 : 0;
    a.codel_first_above[hh] = cd.first_above;
    a.codel_drop_next[hh] = cd.drop_next;
    a.t_resume[hh] = t_resume;
    a.pkts_dropped_router[hh] = dropped_router;
    a.pkts_recv[hh] = pkts_recv;
    a.bytes_recv[hh] = bytes_recv;
  }
  return DeliverOut{delivered, t_post};
}

}  // namespace s1
