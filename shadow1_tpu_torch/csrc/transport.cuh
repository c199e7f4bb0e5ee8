// K_TRANSPORT's per-host body and its reductions as device functions,
// shared by the per-phase kernels of transport.cu and by K_WINDOW
// (window.cu).
//
// What transport_host computes: in TCP worlds tcp.transmit first
// (tcp.cuh: up to TX_SLOTS segments of one socket into the emission
// lanes, back-pressured by the free outbox slots counted before staging),
// then engine._stage_emissions (pkt_id assignment, route_blk lookup,
// keyed loss draw, merge into free outbox slots either IN_FLIGHT or
// parked TX_QUEUED under the tx token bucket; full-width rows carry the
// TS send stamp), _tx_drain_body (one parked departure per host), the
// virtual-CPU accounting, and the post-step scan (scan_host: _scan_all
// on the host's slab plus the app wake time and, in TCP worlds, the
// earliest socket timer).  Every access is row-local; route_blk and
// host_vertex are replicated read-only tables.
// The r-th surviving emission takes the r-th free outbox slot in
// ascending order: slots are filled in that order, so the next free slot
// is always the first FREE one after the previous pick (next_free).
#pragma once
#include "common.cuh"
#include "tcp.cuh"

namespace s1 {

constexpr int kBlock = 256;     // threads per block of the per-host kernels

// Launch arguments; mirrored field for field by the ctypes.Structure
// in shadow1_tpu_torch/core/megakernel.py.  tick_t .. t_app and the
// partial/scalar outputs from th on are the per-phase kernel's; K_WINDOW
// passes its own per-host values and reduces the partials itself.
struct TransportArgs {
  const uint8_t* em_valid;
  const int32_t* em_blk;
  int32_t* pool_blk;
  int32_t* pool_stage;
  int64_t* pool_time;
  int32_t* pool_status;
  const int32_t* ib_blk;
  const int32_t* ib_stage;
  int64_t* send_ctr;
  int64_t* tokens_tx;
  int64_t* last_refill_tx;
  int64_t* t_resume;
  int32_t* tx_queued;
  int64_t* pkts_sent;
  int64_t* bytes_sent;
  int64_t* pkts_dropped_inet;
  int64_t* pkts_dropped_pool;
  int64_t* cpu_avail;
  const int32_t* host_vertex;
  const int32_t* route_blk;
  const int64_t* bw_up;
  const int64_t* cpu_ns_per_event;
  const int64_t* tick_t;
  const int64_t* t_post;
  const uint8_t* active;
  const int32_t* delivered_n;
  const int64_t* t_app;
  int64_t* th;
  int64_t* blk_ev;
  int64_t* blk_min;
  int32_t* blk_err;
  int64_t* n_events;
  int64_t* n_steps;
  int32_t* err;
  int64_t* gmin;
  int64_t bootstrap_end;
  int64_t cpu_threshold;
  int64_t cpu_precision;
  uint32_t drop_k0, drop_k1;
  int32_t h, e, pc, ko, ki, ic, n_vertices, n_hv, has_loss, pds_trail,
      n_blocks;
};

struct HostOut {
  int64_t th, events;
  int32_t err;
};

// engine._scan_all for host hh: its earliest IN_FLIGHT inbox arrival (a
// min over the team's lanes), the non-packet wake time `aux` (re-ticks
// and the app), and the virtual-CPU clamp.
template <class Team>
__device__ __forceinline__ int64_t scan_host(const TransportArgs& a,
                                             const Team& tm, int hh,
                                             int64_t aux, int64_t cpu_ns,
                                             int64_t cpu_avail) {
  int64_t t_in = INV;
  const int64_t ibase = (int64_t)hh * a.ki;
  each_slot(tm, a.ib_stage + ibase, a.ki, [&](int k, int32_t st) {
    if (st != STAGE_IN_FLIGHT) return;
    const int32_t* row = a.ib_blk + (ibase + k) * a.ic;
    t_in = imin(t_in, dec_i64(row[ICOL_TIME_LO], row[ICOL_TIME_HI]));
  });
  t_in = tm.min64(t_in);
  int64_t th = imin(t_in, aux);
  if (cpu_ns > 0 && th != INV && a.cpu_threshold >= 0) {
    const int64_t prec = a.cpu_precision > 1 ? a.cpu_precision : 1;
    int64_t ready = cpu_avail - a.cpu_threshold;
    const int64_t rem = floormod(ready, prec);
    ready = ready - rem + (rem >= prec / 2 ? prec : 0);
    th = imax(th, ready);
  }
  return th;
}

// Fixed-order tree reduction of one block's (event sum, th min, error
// OR) partials; thread 0 gets the block's totals.  Every thread of the
// block (B of them, a power of two) must call it.
template <int B = kBlock>
__device__ __forceinline__ HostOut block_reduce(HostOut o) {
  __shared__ int64_t s_ev[B];
  __shared__ int64_t s_min[B];
  __shared__ int32_t s_err[B];
  const int t = threadIdx.x;
  s_ev[t] = o.events;
  s_min[t] = o.th;
  s_err[t] = o.err;
  __syncthreads();
  for (int s = B / 2; s > 0; s >>= 1) {
    if (t < s) {
      s_ev[t] += s_ev[t + s];
      s_min[t] = imin(s_min[t], s_min[t + s]);
      s_err[t] |= s_err[t + s];
    }
    __syncthreads();
  }
  const HostOut out{s_min[0], s_ev[0], s_err[0]};
  __syncthreads();
  return out;
}

// Transmit (TCP) + staging + drain + CPU accounting + post-step scan for
// host hh on team `tm`: `tick` is its tick_t, `tp` its t_post,
// `delivered` K_DELIVER's count and `t_app` the app's wake time after the
// tick; `tcp` is null in UDP worlds.  The slab walks (free-slot count, the
// staging cursor, the drain's pick, the scan) run across the team's
// lanes; the emission lanes are staged in order on uniform values, and
// the leader writes.  Every lane gets the host's HostOut.
template <class Team>
__device__ __forceinline__ HostOut transport_host(const TransportArgs& a,
                                                  const Team& tm,
                                                  const TcpArgs* tcp,
                                                  int hh, int64_t tick,
                                                  int64_t tp, bool act,
                                                  int32_t delivered,
                                                  int64_t t_app, Clk& clk) {
  const int e = a.e, pc = a.pc, ko = a.ko;
  const int xb = pc - OEXT_COLS;                // extension base column
  const bool boot = tp < a.bootstrap_end;
  const int64_t rate = a.bw_up[hh];
  const int64_t pbase = (int64_t)hh * ko;
  const int32_t* const pstage = a.pool_stage + pbase;

  // ---- _stage_emissions ---------------------------------------------------
  const int64_t ctr = a.send_ctr[hh];
  int64_t tokens = a.tokens_tx[hh], last = a.last_refill_tx[hh];
  refill(tokens, last, rate, tp, act);
  const int64_t budget = tokens;
  const int32_t txq0 = a.tx_queued[hh];
  int n_free = 0;
  each_slot(tm, pstage, ko,
            [&](int, int32_t st) { n_free += st == STAGE_FREE; });
  n_free = tm.sum(n_free);
  int64_t t_resume = a.t_resume[hh];
  if (tcp != nullptr) tcp_transmit(tm, *tcp, hh, tp, act, n_free, t_resume);
  const int32_t vs = a.host_vertex[hh];
  int nvalid = 0, nlive = 0, cursor = 0;
  int64_t prefix = 0, spent = 0, t_park = INV;
  int64_t placed_n = 0, sent_bytes = 0, dropped_n = 0, pool_drop_n = 0;
  int32_t parked_n = 0;
  bool overflow = false;
  for (int j = 0; j < e; ++j) {
    if (!a.em_valid[(int64_t)hh * e + j]) continue;
    const int64_t ctr2 = ctr + nvalid++;
    const int32_t* er = a.em_blk + ((int64_t)hh * e + j) * pc;
    const int32_t dst = er[xb + OEXT_DST];
    const int32_t dcl = dst < 0 ? 0 : (dst > a.n_hv - 1 ? a.n_hv - 1 : dst);
    const int32_t vd = a.host_vertex[dcl];
    const int32_t* rr = a.route_blk +
                        ((int64_t)vs * a.n_vertices + vd) * RCOLS;
    int64_t lat = imax(dec_i64(rr[0], rr[1]), 1);
    float rel = __int_as_float(rr[2]);
    if (dst == hh) {                        // same-host path (never taken
      lat = 1;                              // by phold; kept for parity)
      rel = 1.0f;
    }
    if (a.has_loss) {
      const uint32_t bits = keyed_bits3(a.drop_k0, a.drop_k1, (uint32_t)hh,
                                        (uint32_t)ctr2,
                                        (uint32_t)(ctr2 >> 32));
      const float u = __fmul_rn((float)(bits >> 8), 5.9604644775390625e-8f);
      if (u >= rel) {
        ++dropped_n;
        continue;
      }
    }
    if (nlive++ >= n_free) {                // slab exhausted: counted drop
      ++pool_drop_n;
      overflow = true;
      continue;
    }
    cursor = next_free(tm, pstage, cursor, ko);
    const int64_t slot = pbase + cursor++;
    ++placed_n;
    const int64_t t_send = dec_i64(er[ICOL_TIME_LO], er[ICOL_TIME_HI]);
    const int64_t send_t = t_send > 0 ? t_send : tp;
    const int32_t len = er[ICOL_LEN];
    const int64_t size = wire_size(er[ICOL_PROTO], len);
    prefix += size;
    const bool admit = boot || (txq0 == 0 && prefix <= budget);
    if (admit && !boot) spent += size;
    if (!admit) {
      ++parked_n;
      t_park = imin(t_park, send_t);
    }
    sent_bytes += len;
    const int64_t time_v = admit ? send_t + lat : send_t;
    if (!tm.leader()) continue;             // the leader writes the row
    int32_t* pr = a.pool_blk + slot * pc;
    pr[ICOL_SRC] = hh;
    for (int c = ICOL_SPORT; c < ICOL_TIME_LO; ++c) pr[c] = er[c];
    pr[ICOL_TIME_LO] = enc_lo(time_v);
    pr[ICOL_TIME_HI] = enc_hi(time_v);
    pr[ICOL_CTR_LO] = enc_lo(ctr2);
    pr[ICOL_CTR_HI] = enc_hi(ctr2);
    if (xb >= ICOLS) {                      // full-width TCP row
      pr[ICOL_TS_LO] = enc_lo(send_t);
      pr[ICOL_TS_HI] = enc_hi(send_t);
      for (int c = ICOL_TSE_LO; c < ICOLS; ++c) pr[c] = er[c];
    }
    pr[xb + OEXT_DST] = dst;
    pr[xb + OEXT_LAT_LO] = enc_lo(lat);
    pr[xb + OEXT_LAT_HI] = enc_hi(lat);
    pr[xb + OEXT_PRIO] = er[xb + OEXT_PRIO];
    a.pool_stage[slot] = admit ? STAGE_IN_FLIGHT : STAGE_TX_QUEUED;
    a.pool_time[slot] = time_v;
    if (a.pds_trail) {
      a.pool_status[slot] =
          admit ? (PDS_SND_CREATED | PDS_SND_INTERFACE_SENT | PDS_INET_SENT)
                : PDS_SND_CREATED;
    }
  }
  tokens -= spent;
  int32_t txq = txq0 + parked_n;
  t_resume = imin(t_resume, t_park);
  if (tm.leader()) {
    a.send_ctr[hh] = ctr + nvalid;
    a.pkts_sent[hh] += placed_n;
    a.bytes_sent[hh] += sent_bytes;
    a.pkts_dropped_inet[hh] += dropped_n;
    a.pkts_dropped_pool[hh] += pool_drop_n;
    a.last_refill_tx[hh] = last;
  }
  tm.sync();
  clk.mark(CLK_TRANSMIT);

  // ---- _tx_drain_body (skip_refill: staging refilled at this instant) ----
  int64_t tmin = INV;
  int32_t jsel = ko;
  if (act) {
    each_slot(tm, pstage, ko, [&](int k, int32_t st) {
      if (st != STAGE_TX_QUEUED) return;
      const int64_t t = a.pool_time[pbase + k];
      if (t <= tp && t < tmin) {
        tmin = t;
        jsel = k;
      }
    });
  }
  tm.min2(tmin, jsel);
  if (jsel < ko) {
    const int64_t slot = pbase + jsel;
    const int32_t* row = a.pool_blk + slot * pc;
    const int64_t size = wire_size(row[ICOL_PROTO], row[ICOL_LEN]);
    const bool funded = boot || tokens >= size;
    if (funded) {
      if (!boot) tokens -= size;
      if (tm.leader()) {
        a.pool_stage[slot] = STAGE_IN_FLIGHT;
        a.pool_time[slot] =
            tp + dec_i64(row[xb + OEXT_LAT_LO], row[xb + OEXT_LAT_HI]);
        if (a.pds_trail) a.pool_status[slot] |= PDS_SND_INTERFACE_SENT |
                                                 PDS_INET_SENT;
      }
      --txq;
      if (txq > 0) t_resume = imin(t_resume, tp);
    } else {
      t_resume = imin(t_resume, tp + time_until(size - tokens, rate));
    }
  }
  if (tm.leader()) {
    a.tokens_tx[hh] = tokens;
    a.tx_queued[hh] = txq;
    a.t_resume[hh] = t_resume;
  }
  clk.mark(CLK_DRAIN);

  // ---- virtual-CPU accounting (at tick_t, as the JAX kernel does) --------
  const int64_t events = (int64_t)delivered + nvalid;
  const int64_t cpu_ns = a.cpu_ns_per_event[hh];
  int64_t cpu_avail = a.cpu_avail[hh];
  tm.sync();                 // every lane has read cpu_avail
  if (cpu_ns > 0 && act) {
    cpu_avail = imax(cpu_avail, tick) + cpu_ns * events;
    if (tm.leader()) a.cpu_avail[hh] = cpu_avail;
  }

  // ---- post-step scan: inbox arrivals, re-ticks, app, CPU clamp ----------
  int64_t aux = imin(t_resume, t_app);
  if (tcp != nullptr) aux = imin(aux, timer_min(tm, *tcp, hh));
  const int64_t th = scan_host(a, tm, hh, aux, cpu_ns, cpu_avail);
  tm.sync();
  clk.mark(CLK_SCAN);
  return HostOut{th, events, overflow ? 1 : 0};
}

}  // namespace s1
