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
// is always the first FREE one after the previous pick (next_free).  In
// worlds whose app may send to its own host (`may_loopback`: tgen), a
// surviving same-host emission takes the next free slot of the host's
// own inbox slab instead (engine._loopback_insert), by the same rule.
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
  int32_t* ib_blk;      // written by the loopback insert only
  int32_t* ib_stage;
  int32_t* ib_status;
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
  uint32_t* ticket;    // k_transport: blocks finished (0 between launches)
  int64_t bootstrap_end;
  int64_t cpu_threshold;
  int64_t cpu_precision;
  uint32_t drop_k0, drop_k1;
  uint32_t jit_k0, jit_k1;   // PURPOSE_JITTER's key words
  int32_t h, e, pc, ko, ki, ic, n_vertices, n_hv, has_loss, pds_trail,
      n_blocks, may_loopback, has_jitter;
};

struct HostOut {
  int64_t th, events;
  int32_t err;
};

// engine._scan_all for host hh: its earliest IN_FLIGHT inbox arrival (a
// min over the team's lanes; `rows` gives the arrival times), the
// non-packet wake time `aux` (re-ticks and the app), and the virtual-CPU
// clamp.
template <class Team, class Rows = InboxRows>
__device__ __forceinline__ int64_t scan_host(const TransportArgs& a,
                                             const Team& tm, int hh,
                                             int64_t aux, int64_t cpu_ns,
                                             int64_t cpu_avail,
                                             const Rows& rows = Rows{}) {
  int64_t t_in = INV;
  const int64_t ibase = (int64_t)hh * a.ki;
  each_slot(tm, a.ib_stage + ibase, a.ki, [&](int k, int32_t st) {
    if (st != STAGE_IN_FLIGHT) return;
    t_in = imin(t_in, rows.time(a, ibase + k));
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

// What staging hands back to transport_host: the host's counts (the same
// in every lane of the team).
struct StageOut {
  int32_t nvalid, parked_n;
  int64_t placed_n, sent_bytes, dropped_n, pool_drop_n, spent, t_park;
  bool overflow;
};

// The row of emission `er` placed in pool slot `slot`, as
// engine._patched_rows builds it: the source, the pkt_id counter, the
// arrival (admitted) or send (parked) time, the TS send stamp of
// full-width rows, the route's latency.
__device__ __forceinline__ void stage_row(const TransportArgs& a, int hh,
                                          const int32_t* er, int64_t slot,
                                          int64_t ctr2, int64_t time_v,
                                          int64_t send_t, int32_t dst,
                                          int64_t lat, bool admit) {
  const int pc = a.pc, xb = pc - OEXT_COLS;
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

// Whether host hh's emission with pkt_id counter ctr2 is lost: the keyed
// loss draw against the route's reliability (worlds with loss only).
__device__ __forceinline__ bool stage_lost(const TransportArgs& a, int hh,
                                           int64_t ctr2, float rel) {
  if (!a.has_loss) return false;
  const uint32_t bits = keyed_bits3(a.drop_k0, a.drop_k1, (uint32_t)hh,
                                    (uint32_t)ctr2, (uint32_t)(ctr2 >> 32));
  return __fmul_rn((float)(bits >> 8), 5.9604644775390625e-8f) >= rel;
}

// engine._route's jitter draw for host hh's emission with pkt_id counter
// ctr2 on a route of latency `lat` and jitter amplitude `jit`: u from
// PURPOSE_JITTER keyed by (hh, ctr2), delta = trunc((2u - 1) * f32(jit)),
// each f32 operation rounded once as XLA CPU rounds it (2u is exact, so
// a contraction of 2u - 1 cannot change it).  Callers clamp to 1 ns.
__device__ __forceinline__ int64_t jittered(const TransportArgs& a, int hh,
                                            int64_t ctr2, int64_t lat,
                                            int64_t jit) {
  if (jit <= 0) return lat;
  const float u = keyed_uniform3(a.jit_k0, a.jit_k1, (uint32_t)hh,
                                 (uint32_t)ctr2, (uint32_t)(ctr2 >> 32));
  const float x = __fsub_rn(__fmul_rn(2.0f, u), 1.0f);
  return lat + __float2ll_rz(__fmul_rn(x, __ll2float_rn(jit)));
}

// The latency of route row `rr` for host hh's emission ctr2: jittered
// in worlds with jitter, at least 1 ns.
__device__ __forceinline__ int64_t route_latency(const TransportArgs& a,
                                                 const int32_t* rr, int hh,
                                                 int64_t ctr2) {
  int64_t lat = dec_i64(rr[0], rr[1]);
  if (a.has_jitter) lat = jittered(a, hh, ctr2, lat, dec_i64(rr[3], rr[4]));
  return imax(lat, 1);
}

// Emission j of host hh: its destination, route latency and whether it
// survives the keyed loss draw (counter ctr2).
__device__ __forceinline__ bool stage_route(const TransportArgs& a, int hh,
                                            int32_t vs, const int32_t* er,
                                            int64_t ctr2, int32_t& dst,
                                            int64_t& lat) {
  dst = er[a.pc - OEXT_COLS + OEXT_DST];
  const int32_t dcl = dst < 0 ? 0 : (dst > a.n_hv - 1 ? a.n_hv - 1 : dst);
  const int32_t vd = a.host_vertex[dcl];
  const int32_t* rr = a.route_blk +
                      ((int64_t)vs * a.n_vertices + vd) * RCOLS;
  lat = route_latency(a, rr, hh, ctr2);
  float rel = __int_as_float(rr[2]);
  if (dst == hh) {                        // same-host path (never taken
    lat = 1;                              // by phold; kept for parity)
    rel = 1.0f;
  }
  return !stage_lost(a, hh, ctr2, rel);
}

// The loopback row of emission `er` in inbox slot `slot`, as
// engine._loopback_insert builds it: the emission's columns in inbox
// layout with the source, the arrival send + 1 ns, the pkt_id counter
// and, in full-width rows, the TS send stamp; IN_FLIGHT.  `rows` gets the
// row's (time, key).
template <class Rows>
__device__ __forceinline__ void stage_loopback_row(const TransportArgs& a,
                                                   int hh,
                                                   const int32_t* er,
                                                   int64_t slot, int64_t ctr2,
                                                   int64_t send_t,
                                                   const Rows& rows) {
  int32_t* ir = a.ib_blk + slot * a.ic;
  const int64_t arr = send_t + 1;
  ir[ICOL_SRC] = hh;
  for (int c = ICOL_SPORT; c < ICOL_TIME_LO; ++c) ir[c] = er[c];
  ir[ICOL_TIME_LO] = enc_lo(arr);
  ir[ICOL_TIME_HI] = enc_hi(arr);
  ir[ICOL_CTR_LO] = enc_lo(ctr2);
  ir[ICOL_CTR_HI] = enc_hi(ctr2);
  if (a.ic >= ICOLS) {                    // full-width TCP row
    ir[ICOL_TS_LO] = enc_lo(send_t);
    ir[ICOL_TS_HI] = enc_hi(send_t);
    for (int c = ICOL_TSE_LO; c < ICOLS; ++c) ir[c] = er[c];
  }
  a.ib_stage[slot] = STAGE_IN_FLIGHT;
  if (a.pds_trail)
    a.ib_status[slot] = PDS_SND_CREATED | PDS_SND_INTERFACE_SENT |
                        PDS_INET_SENT;
  rows.put(slot, arr, ((int64_t)hh << 40) |
                          dec_i64(enc_lo(ctr2), enc_hi(ctr2)));
}

// engine._stage_emissions for host hh, its emission lanes in order on
// uniform values (Solo and Warp teams): the r-th survivor takes the r-th
// free outbox slot (next_free from the previous pick), the token bucket
// admits while the byte prefix of the placed rows fits `budget`, and the
// leader writes each row.  With a.may_loopback a survivor addressed to hh
// takes the next of the host's `ib_free` free inbox slots instead
// (outside the outbox ranks and the byte prefix), or, with none left, is
// a counted pool drop.
template <class Team, class Rows>
__device__ __forceinline__ StageOut stage_serial(const TransportArgs& a,
                                                 const Team& tm, int hh,
                                                 int64_t ctr, int64_t budget,
                                                 int32_t txq0, bool boot,
                                                 int64_t tp, int n_free,
                                                 int ib_free, int32_t vs,
                                                 const Rows& rows) {
  const int e = a.e, pc = a.pc, ko = a.ko;
  const int64_t pbase = (int64_t)hh * ko, ibase = (int64_t)hh * a.ki;
  const int32_t* const pstage = a.pool_stage + pbase;
  StageOut o{0, 0, 0, 0, 0, 0, 0, INV, false};
  int nlive = 0, cursor = 0, nloop = 0, icursor = 0;
  int64_t prefix = 0;
  for (int j = 0; j < e; ++j) {
    if (!a.em_valid[(int64_t)hh * e + j]) continue;
    const int64_t ctr2 = ctr + o.nvalid++;
    const int32_t* er = a.em_blk + ((int64_t)hh * e + j) * pc;
    int32_t dst;
    int64_t lat;
    if (!stage_route(a, hh, vs, er, ctr2, dst, lat)) {
      ++o.dropped_n;
      continue;
    }
    const int64_t t_send = dec_i64(er[ICOL_TIME_LO], er[ICOL_TIME_HI]);
    const int64_t send_t = t_send > 0 ? t_send : tp;
    if (a.may_loopback && dst == hh) {      // into the own inbox slab
      if (nloop++ >= ib_free) {
        ++o.pool_drop_n;
        o.overflow = true;
        continue;
      }
      icursor = next_free(tm, a.ib_stage + ibase, icursor, a.ki);
      ++o.placed_n;
      o.sent_bytes += er[ICOL_LEN];
      if (tm.leader())
        stage_loopback_row(a, hh, er, ibase + icursor, ctr2, send_t, rows);
      ++icursor;
      continue;
    }
    if (nlive++ >= n_free) {                // slab exhausted: counted drop
      ++o.pool_drop_n;
      o.overflow = true;
      continue;
    }
    cursor = next_free(tm, pstage, cursor, ko);
    const int64_t slot = pbase + cursor++;
    ++o.placed_n;
    const int32_t len = er[ICOL_LEN];
    const int64_t size = wire_size(er[ICOL_PROTO], len);
    prefix += size;
    const bool admit = boot || (txq0 == 0 && prefix <= budget);
    if (admit && !boot) o.spent += size;
    if (!admit) {
      ++o.parked_n;
      o.t_park = imin(o.t_park, send_t);
    }
    o.sent_bytes += len;
    if (tm.leader())                        // the leader writes the row
      stage_row(a, hh, er, slot, ctr2, admit ? send_t + lat : send_t,
                send_t, dst, lat, admit);
  }
  return o;
}

// Transmit (TCP) + staging + drain + CPU accounting + post-step scan for
// host hh on team `tm`: `tick` is its tick_t, `tp` its t_post,
// `delivered` K_DELIVER's count and `t_app` the app's wake time after the
// tick; `tcp` is null in UDP worlds.  The slab walks (free-slot count, the
// staging cursor, the drain's pick, the scan) run across the team's
// lanes; the emission lanes are staged in order on uniform values, and
// the leader writes.  Every lane gets the host's HostOut.  `rows` gives
// (and takes, from the loopback insert) the inbox slots' (time, key).
template <class Team, class Rows = InboxRows>
__device__ __forceinline__ HostOut transport_host(const TransportArgs& a,
                                                  const Team& tm,
                                                  const TcpArgs* tcp,
                                                  int hh, int64_t tick,
                                                  int64_t tp, bool act,
                                                  int32_t delivered,
                                                  int64_t t_app, Clk& clk,
                                                  const Rows& rows = Rows{}) {
  const int pc = a.pc, ko = a.ko;
  const int xb = pc - OEXT_COLS;                // extension base column
  const bool boot = tp < a.bootstrap_end;
  const int64_t rate = a.bw_up[hh];
  const int64_t pbase = (int64_t)hh * ko;
  const int32_t* const pstage = a.pool_stage + pbase;

  // ---- _stage_emissions ---------------------------------------------------
  const int64_t ctr = a.send_ctr[hh];
  int64_t tokens = a.tokens_tx[hh], last = a.last_refill_tx[hh];
  refill(tokens, last, rate, tp, act);
  const int32_t txq0 = a.tx_queued[hh];
  int n_free = 0;
  each_slot(tm, pstage, ko,
            [&](int, int32_t st) { n_free += st == STAGE_FREE; });
  n_free = tm.sum(n_free);
  int ib_free = 0;
  if (a.may_loopback) {
    each_slot(tm, a.ib_stage + (int64_t)hh * a.ki, a.ki,
              [&](int, int32_t st) { ib_free += st == STAGE_FREE; });
    ib_free = tm.sum(ib_free);
  }
  int64_t t_resume = a.t_resume[hh];
  if (tcp != nullptr) tcp_transmit(tm, *tcp, hh, tp, act, n_free, t_resume);
  const int32_t vs = a.host_vertex[hh];
  const StageOut so = stage_serial(a, tm, hh, ctr, tokens, txq0, boot, tp,
                                   n_free, ib_free, vs, rows);
  const int nvalid = so.nvalid;
  const bool overflow = so.overflow;
  tokens -= so.spent;
  int32_t txq = txq0 + so.parked_n;
  t_resume = imin(t_resume, so.t_park);
  if (tm.leader()) {
    a.send_ctr[hh] = ctr + nvalid;
    a.pkts_sent[hh] += so.placed_n;
    a.bytes_sent[hh] += so.sent_bytes;
    a.pkts_dropped_inet[hh] += so.dropped_n;
    a.pkts_dropped_pool[hh] += so.pool_drop_n;
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
  const int64_t th = scan_host(a, tm, hh, aux, cpu_ns, cpu_avail, rows);
  tm.sync();
  clk.mark(CLK_SCAN);
  return HostOut{th, events, overflow ? 1 : 0};
}

// ---------------------------------------------------------------------------
// transport_small: transport_host's UDP body on one thread for slabs and
// emission lanes of at most SMALL (the bench world: 8-slot slabs, 6
// lanes), written so that a host's chain of dependent loads is three deep.
// Everything that depends only on the host -- its fields, its outbox
// slab's stage words and times, its inbox slab's stage words and arrival
// times, its emission rows' dst / time / length / protocol -- is loaded
// at once; then the destinations' vertices; then their route entries.
// Staging, the drain's pick, the CPU accounting and the post-step scan
// then run on registers (a slab slot staged this step carries its row's
// size and latency in registers; a row parked before is read when the
// drain picks it).  Register arrays are indexed by unrolled constants.
// The same values as transport_host<Solo> with tcp == nullptr.
// ---------------------------------------------------------------------------

constexpr int SMALL = 8;

__device__ __forceinline__ bool transport_small_fits(const TransportArgs& a) {
  return a.ko <= SMALL && a.ki <= SMALL && a.e <= SMALL &&
         a.pc - OEXT_COLS < ICOLS && !a.may_loopback;
}

__device__ __forceinline__ HostOut transport_small(const TransportArgs& a,
                                                   int hh, int64_t tick,
                                                   int64_t tp, bool act,
                                                   int32_t delivered,
                                                   int64_t t_app) {
  const int e = a.e, pc = a.pc, ko = a.ko, ki = a.ki;
  const int xb = pc - OEXT_COLS;
  const int64_t pbase = (int64_t)hh * ko, ibase = (int64_t)hh * ki;
  const bool boot = tp < a.bootstrap_end;

  // ---- the host's own words, in chains of at most four loads --------------
  // Stage words eight at a time; the arrival time of an in-flight inbox
  // slot and of a parked outbox slot, and the rows of valid emission
  // lanes, once their stage or valid flag is in; then the valid lanes'
  // destination vertices, then their routes.
  int32_t pst[SMALL], ist[SMALL];
  load8(a.pool_stage + pbase, ko, pst, -1);      // past the slab: never
  load8(a.ib_stage + ibase, ki, ist, STAGE_FREE);  // picked
  bool v[SMALL];
#pragma unroll
  for (int u = 0; u < SMALL; ++u)
    v[u] = u < e && a.em_valid[(int64_t)hh * e + u];
  const int64_t ctr = a.send_ctr[hh];
  int64_t tokens = a.tokens_tx[hh], last = a.last_refill_tx[hh];
  const int64_t rate = a.bw_up[hh];
  const int32_t txq0 = a.tx_queued[hh];
  int64_t t_resume = a.t_resume[hh];
  const int32_t vs = a.host_vertex[hh];
  const int64_t cpu_ns = a.cpu_ns_per_event[hh];
  int64_t cpu_avail = a.cpu_avail[hh];
  const int64_t sent0 = a.pkts_sent[hh], bytes0 = a.bytes_sent[hh];
  const int64_t inet0 = a.pkts_dropped_inet[hh];
  const int64_t pool0 = a.pkts_dropped_pool[hh];
#pragma unroll
  for (int k = 0; k < SMALL; ++k) {
    keep(pst[k]);
    keep(ist[k]);
    keep((int32_t)v[k]);
  }
  keep(ctr);
  keep(tokens);
  keep(last);
  keep(rate);
  keep(txq0);
  keep(t_resume);
  keep(vs);
  keep(cpu_ns);
  keep(cpu_avail);
  keep(sent0);
  keep(bytes0);
  keep(inet0);
  keep(pool0);
  int64_t ptm[SMALL], itm[SMALL];
#pragma unroll
  for (int k = 0; k < SMALL; ++k) {
    ptm[k] = pst[k] == STAGE_TX_QUEUED ? a.pool_time[pbase + k] : INV;
    itm[k] = INV;
    if (ist[k] == STAGE_IN_FLIGHT) {
      const int2 tw = *reinterpret_cast<const int2*>(
          a.ib_blk + (ibase + k) * a.ic + ICOL_TIME_LO);
      itm[k] = dec_i64(tw.x, tw.y);
    }
  }
  int32_t dst[SMALL], len[SMALL], proto[SMALL];
  int64_t t_send[SMALL];
#pragma unroll
  for (int u = 0; u < SMALL; ++u) {
    dst[u] = len[u] = proto[u] = 0;
    t_send[u] = 0;
    if (v[u]) {
      const int32_t* er = a.em_blk + ((int64_t)hh * e + u) * pc;
      const int2 tw = *reinterpret_cast<const int2*>(er + ICOL_TIME_LO);
      dst[u] = er[xb + OEXT_DST];
      t_send[u] = dec_i64(tw.x, tw.y);
      len[u] = er[ICOL_LEN];
      proto[u] = er[ICOL_PROTO];
    }
  }
#pragma unroll
  for (int k = 0; k < SMALL; ++k) {
    keep(ptm[k]);
    keep(itm[k]);
    keep(dst[k]);
    keep(t_send[k]);
    keep(len[k]);
    keep(proto[k]);
  }
  int32_t vd[SMALL];
#pragma unroll
  for (int u = 0; u < SMALL; ++u) {
    const int32_t d = dst[u] < 0 ? 0 : (dst[u] > a.n_hv - 1 ? a.n_hv - 1
                                                             : dst[u]);
    vd[u] = v[u] ? a.host_vertex[d] : 0;
  }
#pragma unroll
  for (int u = 0; u < SMALL; ++u) keep(vd[u]);
  int64_t lat[SMALL];
  float rel[SMALL];
  int nv = 0;                              // valid lanes before lane u
#pragma unroll
  for (int u = 0; u < SMALL; ++u) {
    lat[u] = 1;
    rel[u] = 1.0f;
    if (v[u] && dst[u] != hh) {            // the same-host path keeps 1, 1
      const int32_t* rr = a.route_blk +
                          ((int64_t)vs * a.n_vertices + vd[u]) * RCOLS;
      lat[u] = route_latency(a, rr, hh, ctr + nv);
      rel[u] = __int_as_float(rr[2]);
    }
    nv += v[u];
  }

  // ---- _stage_emissions, on registers -------------------------------------
  refill(tokens, last, rate, tp, act);
  const int64_t budget = tokens;
  int n_free = 0;
#pragma unroll
  for (int k = 0; k < SMALL; ++k) n_free += pst[k] == STAGE_FREE;
  int64_t psize[SMALL], plat[SMALL];     // rows staged this step
  bool pnew[SMALL];
#pragma unroll
  for (int k = 0; k < SMALL; ++k) {
    pnew[k] = false;
    psize[k] = 0;
    plat[k] = 0;
  }
  int nvalid = 0, nlive = 0;
  int64_t prefix = 0, spent = 0, t_park = INV;
  int64_t placed_n = 0, sent_bytes = 0, dropped_n = 0, pool_drop_n = 0;
  int32_t parked_n = 0;
  bool overflow = false;
#pragma unroll
  for (int u = 0; u < SMALL; ++u) {
    if (!v[u]) continue;
    const int64_t ctr2 = ctr + nvalid++;
    if (stage_lost(a, hh, ctr2, rel[u])) {
      ++dropped_n;
      continue;
    }
    if (nlive++ >= n_free) {                // slab exhausted: counted drop
      ++pool_drop_n;
      overflow = true;
      continue;
    }
    // The lowest free slot left (slots fill in ascending order).
    int slot_k = 0;
#pragma unroll
    for (int k = SMALL - 1; k >= 0; --k)
      if (pst[k] == STAGE_FREE) slot_k = k;
    ++placed_n;
    const int64_t send_t = t_send[u] > 0 ? t_send[u] : tp;
    const int64_t size = wire_size(proto[u], len[u]);
    prefix += size;
    const bool admit = boot || (txq0 == 0 && prefix <= budget);
    if (admit && !boot) spent += size;
    if (!admit) {
      ++parked_n;
      t_park = imin(t_park, send_t);
    }
    sent_bytes += len[u];
    const int64_t time_v = admit ? send_t + lat[u] : send_t;
#pragma unroll
    for (int k = 0; k < SMALL; ++k)
      if (k == slot_k) {
        pst[k] = admit ? STAGE_IN_FLIGHT : STAGE_TX_QUEUED;
        ptm[k] = time_v;
        pnew[k] = true;
        psize[k] = size;
        plat[k] = lat[u];
      }
    stage_row(a, hh, a.em_blk + ((int64_t)hh * e + u) * pc, pbase + slot_k,
              ctr2, time_v, send_t, dst[u], lat[u], admit);
  }
  tokens -= spent;
  int32_t txq = txq0 + parked_n;
  t_resume = imin(t_resume, t_park);
  a.send_ctr[hh] = ctr + nvalid;
  a.pkts_sent[hh] = sent0 + placed_n;
  a.bytes_sent[hh] = bytes0 + sent_bytes;
  a.pkts_dropped_inet[hh] = inet0 + dropped_n;
  a.pkts_dropped_pool[hh] = pool0 + pool_drop_n;
  a.last_refill_tx[hh] = last;

  // ---- _tx_drain_body (skip_refill) ---------------------------------------
  int64_t tmin = INV;
  int jsel = ko;
  if (act) {
#pragma unroll
    for (int k = 0; k < SMALL; ++k)
      if (pst[k] == STAGE_TX_QUEUED && ptm[k] <= tp && ptm[k] < tmin) {
        tmin = ptm[k];
        jsel = k;
      }
  }
  if (jsel < ko) {
    const int64_t slot = pbase + jsel;
    bool fresh = false;
    int64_t size = 0, dlat = 0;
#pragma unroll
    for (int k = 0; k < SMALL; ++k)
      if (k == jsel && pnew[k]) {
        fresh = true;
        size = psize[k];
        dlat = plat[k];
      }
    if (!fresh) {                           // parked before this step
      const int32_t* row = a.pool_blk + slot * pc;
      size = wire_size(row[ICOL_PROTO], row[ICOL_LEN]);
      dlat = dec_i64(row[xb + OEXT_LAT_LO], row[xb + OEXT_LAT_HI]);
    }
    const bool funded = boot || tokens >= size;
    if (funded) {
      if (!boot) tokens -= size;
      a.pool_stage[slot] = STAGE_IN_FLIGHT;
      a.pool_time[slot] = tp + dlat;
      if (a.pds_trail) a.pool_status[slot] |= PDS_SND_INTERFACE_SENT |
                                               PDS_INET_SENT;
      --txq;
      if (txq > 0) t_resume = imin(t_resume, tp);
    } else {
      t_resume = imin(t_resume, tp + time_until(size - tokens, rate));
    }
  }
  a.tokens_tx[hh] = tokens;
  a.tx_queued[hh] = txq;
  a.t_resume[hh] = t_resume;

  // ---- virtual-CPU accounting ---------------------------------------------
  const int64_t events = (int64_t)delivered + nvalid;
  if (cpu_ns > 0 && act) {
    cpu_avail = imax(cpu_avail, tick) + cpu_ns * events;
    a.cpu_avail[hh] = cpu_avail;
  }

  // ---- post-step scan (scan_host on the loaded inbox words) ---------------
  int64_t t_in = INV;
#pragma unroll
  for (int k = 0; k < SMALL; ++k)
    if (ist[k] == STAGE_IN_FLIGHT) t_in = imin(t_in, itm[k]);
  int64_t th = imin(t_in, imin(t_resume, t_app));
  if (cpu_ns > 0 && th != INV && a.cpu_threshold >= 0) {
    const int64_t prec = a.cpu_precision > 1 ? a.cpu_precision : 1;
    int64_t ready = cpu_avail - a.cpu_threshold;
    const int64_t rem = floormod(ready, prec);
    ready = ready - rem + (rem >= prec / 2 ? prec : 0);
    th = imax(th, ready);
  }
  return HostOut{th, events, overflow ? 1 : 0};
}

}  // namespace s1
