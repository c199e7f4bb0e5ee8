// K_WINDOW: one whole conservative window as one cooperative kernel.
//
// Replaces the TPU kernel K_WINDOW (shadow1_tpu/core/megakernel.py,
// window_fused, launched through _call_full, pallas_call at line 374),
// whose body is shadow1_tpu/core/engine.py _window_body_ref: the
// boundary exchange, the per-window scan, the window bounds
// ws = max(now, gmin) and we = min(ws + min_latency, t_target), the
// micro-step loop `while gmin < we` (K_DELIVER's body, in TCP worlds
// tcp.run_timers, the app tick, K_TRANSPORT's body), then the window
// close (now = we, n_windows + 1).  It also emits the earliest outbox
// arrival still awaiting the next exchange (engine._outbox_pending), so
// the host's window loop reads one small vector per window and nothing
// per micro-step.  Two kernels: k_window for UDP worlds with phold's tick
// (phold_tick.cuh), k_window_tcp for TCP worlds with bulk's tick
// (bulk_tick.cuh) and the TCP machine (tcp.cuh).  They share the window's
// opening (exchange and scan) and closing as device functions, so phold's
// kernel does not carry the TCP machine's registers.
//
// Design.  Within a window every phase is row-local over hosts (the
// megakernel's blocking contract): the only cross-host values are the
// exchange, gmin, the event count, the error bits and, in TCP worlds, the
// two scoreboard gates of each delivery round.  So one grid of resident
// blocks (cudaLaunchCooperativeKernel) runs the window, and grid-wide
// barriers (cooperative_groups this_grid().sync()) separate what must be
// ordered:
//   * the exchange's four passes (exchange.cuh, with the two-class
//     re-rank in TCP worlds), then each host's scan (transport.cuh
//     scan_host);
//   * each micro-step: every host runs its phases on its team (the
//     staging rows go through a scratch tensor, written and read by that
//     team only), then each block folds its (th min, event sum, error
//     OR) by a fixed tree and publishes it; after one grid sync every
//     block folds all partials in block order, so every block computes
//     the same gmin and the loop predicate is uniform.  Partials are
//     double-buffered by step parity, so one barrier per micro-step
//     suffices;
//   * the window close: the outbox-pending min over the pool, folded by
//     block 0, which writes the state scalars and the result vector.
// Integer min/sum/OR do not depend on order, so the results equal the
// reference's.  The loop carries a step cap from the wrapper, far above
// any real window: past it the kernel sets a status word and exits, so a
// wrong predicate fails the run instead of hanging the card.
//
// Both grids are sized from the occupancy query (the wrapper's
// window_occupancy), never refused for H: hosts are walked with
// grid-stride loops, so any number of hosts runs.
//
// UDP (k_window): one thread per host (the Solo team); a micro-step has
// no barrier inside it.
//
// TCP (k_window_tcp): one warp per host (the Warp team, common.cuh),
// hosts walked warp-stride.  A host's slab and socket walks -- the router
// enqueue, each round's candidate pick, the socket match, the timer pick,
// transmit's eligibility, the sink, the free-slot count, the staging
// cursor, the drain's pick and the scan -- stride the 32 lanes (coalesced
// loads) and end in warp reductions; the TCP machine runs on uniform
// values and the leader lane writes.  Each delivery round of
// process_arrivals takes the two scoreboard gates OR-ed over the whole
// grid (GridGate), so the rounds run as deliver_tcp_warps (deliver.cuh):
// one pass over the hosts per round, split at the gate barrier, with
// what crosses it (the host's receive state and its arrival, no socket)
// in a device scratch record per host; every thread reaches each barrier
// from one call site, outside the host loop.  The gate words are indexed
// by step parity and round, [2][rx_batch]: a step's words are read right
// after that round's barrier, all before the step's closing barrier, so
// the words of the other parity are zeroed at the start of the next step
// (after that barrier) and are not written again before the closing
// barrier that follows.  run_timers and bulk's tick need no barrier
// (per-host exact; tcp.cuh, bulk_tick.cuh).  The socket-overflow bit of a
// passive open and the pool-overflow bits are OR-ed into the step's block
// partials (only the leader lane counts a host's events).  Nothing a
// gathered socket holds lives across a barrier, so the kernel takes
// __launch_bounds__(256, 2) (ptxas: chip_smoke.py prints registers and
// spills).
//
// What bounds it on the H100: bytes.  Per window it must move what the
// exchange, each micro-step's phases and the tick touch -- the pool's
// stage column, the movers' rows, each active host's slabs, host row,
// sockets and app state, and the rows staged -- a few MB at the bench
// world (chip_smoke.py counts it per window from the run's data), a few
// microseconds of HBM time.  The serialising grid barriers (rx_batch + 1
// a micro-step in TCP worlds) and, in the bulk world, the server's serial
// TCP machine (up to rx_batch arrivals a step) set the time.
#include <cooperative_groups.h>

#include "bulk_tick.cuh"
#include "exchange.cuh"
#include "phold_tick.cuh"
#include "transport.cuh"

namespace cg = cooperative_groups;
using namespace s1;

// Mirrored field for field by the ctypes.Structure in
// shadow1_tpu_torch/core/megakernel.py.  In `d` and `t` the per-phase
// kernels' per-host inputs and outputs are unused (null); `t.em_valid` /
// `t.em_blk` point at the staging scratch below.  `p` is phold's (UDP),
// `tcp` and `b` bulk's (TCP); the other kernel leaves them zero.
struct WindowArgs {
  ExchangeArgs x;
  DeliverArgs d;
  TransportArgs t;
  PholdArgs p;
  TcpArgs tcp;
  BulkArgs b;
  int64_t* t_h;        // [h] out: per-host next event time
  int64_t* part_min;   // [2 * n_blocks] block partials, by step parity
  int64_t* part_ev;    // [2 * n_blocks]
  int32_t* part_err;   // [2 * n_blocks]
  int64_t* now;        // state scalars
  int64_t* n_windows;
  int64_t* win;        // [5] out: gmin, ws, we, outbox pending, status
  uint8_t* em_valid;   // [h * e] staging scratch
  int32_t* em_blk;     // [h * e * pc]
  int64_t* acks_thinned;
  long long* clk;      // [CLK_WORDS] phase cycles (S1_PHASE_CLOCKS builds)
  int64_t t_target;
  int64_t min_latency;
  int64_t max_steps;
  int32_t n_blocks;
  int32_t clk_host;    // the host whose phases are traced
};

namespace {

__device__ __forceinline__ void publish(const WindowArgs& a, int buf,
                                        const HostOut& b) {
  if (threadIdx.x == 0) {
    const int64_t i = (int64_t)buf * a.n_blocks + blockIdx.x;
    a.part_min[i] = b.th;
    a.part_ev[i] = b.events;
    a.part_err[i] = b.err;
  }
}

// Every block's partials of parity `buf`, folded in block order; all
// threads of the calling block get the result.
__device__ __forceinline__ HostOut fold(const WindowArgs& a, int buf) {
  __shared__ int64_t s_min, s_ev;
  __shared__ int32_t s_err;
  if (threadIdx.x == 0) {
    int64_t mn = INV, ev = 0;
    int32_t er = 0;
    const int64_t off = (int64_t)buf * a.n_blocks;
    for (int b = 0; b < a.n_blocks; ++b) {
      // L2 loads: the partials were written by other blocks.
      mn = imin(mn, __ldcg((const long long*)a.part_min + off + b));
      ev += __ldcg((const long long*)a.part_ev + off + b);
      er |= __ldcg(a.part_err + off + b);
    }
    s_min = mn;
    s_ev = ev;
    s_err = er;
  }
  __syncthreads();
  const HostOut r{s_min, s_ev, s_err};
  __syncthreads();
  return r;
}

// The app policies of the two kernels: the app's wake time after its
// tick, and the non-packet term of the next-event scan
// (engine._aux_times: re-ticks, in TCP worlds the socket timers, the app).
struct PholdTick {
  __device__ static int64_t next(const WindowArgs& a, int hh) {
    return a.p.pending[hh] > 0 ? a.p.next_send[hh] : INV;
  }
  template <class Team>
  __device__ static int64_t aux(const WindowArgs& a, const Team&, int hh) {
    return imin(a.t.t_resume[hh], next(a, hh));
  }
};

struct BulkTick {
  __device__ static int64_t next(const WindowArgs& a, int hh) {
    return bulk_next(a.b, hh);
  }
  template <class Team>
  __device__ static int64_t aux(const WindowArgs& a, const Team& tm,
                                int hh) {
    return imin(imin(a.t.t_resume[hh], timer_min(tm, a.tcp, hh)),
                next(a, hh));
  }
  template <class Team>
  __device__ static void tick(const WindowArgs& a, const Team& tm, int hh,
                              int64_t tp, bool act) {
    bulk_tick(tm, a.b, a.tcp, hh, tp, act);
  }
};

// The boundary exchange, its drop accounting (pure ACKs shed first in
// TCP worlds: engine._exchange_tail), the per-window scan and the window
// bounds.  Returns gmin; every block gets the same values.  The exchange
// is one thread per destination; with a Solo `Team` each destination's
// thread then scans its host, with Warp a grid sync parts the exchange
// from a scan on one warp per host.
template <class Tick, class Team>
__device__ __forceinline__ int64_t window_open(const WindowArgs& a,
                                               cg::grid_group& grid,
                                               int64_t& ws, int64_t& we) {
  const int h = a.x.h;
  const int64_t gtid = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kBlock;
  for (int64_t d = gtid; d < h; d += gstride) {
    a.x.cnt[d] = 0;
    a.x.fill[d] = 0;
  }
  if (a.x.gate != nullptr && gtid < 2) a.x.gate[gtid] = 0;
  grid.sync();
  for (int64_t i = gtid; i < a.x.p0; i += gstride) ex_count_row(a.x, i);
  grid.sync();
  if (blockIdx.x == 0) ex_scan_block(a.x);
  grid.sync();
  for (int64_t i = gtid; i < a.x.p0; i += gstride) ex_bucket_row(a.x, i);
  grid.sync();
  const Team tm{};
  constexpr bool solo = Team::W == 1;
  HostOut o{INV, 0, 0};
  for (int64_t dd = gtid; dd < h; dd += gstride) {
    const int d = (int)dd;
    int32_t total, total_prot, n_free;
    ex_place_dest(a.x, d, total, total_prot, n_free);
    const int32_t drops = imax32(total - n_free, 0);
    const int32_t data_drops = imin32(drops, imax32(total_prot - n_free, 0));
    if (data_drops > 0) {
      a.t.pkts_dropped_pool[d] += data_drops;
      o.err |= ERR_POOL_OVERFLOW;
    }
    if (drops > data_drops) a.acks_thinned[d] += drops - data_drops;
    if (solo) {
      const int64_t th = scan_host(a.t, tm, d, Tick::aux(a, tm, d),
                                   a.t.cpu_ns_per_event[d],
                                   a.t.cpu_avail[d]);
      a.t_h[d] = th;
      o.th = imin(o.th, th);
    }
  }
  if (!solo) {
    grid.sync();
    const int64_t nw = gstride / Team::W;
    for (int64_t dd = gtid / Team::W; dd < h; dd += nw) {
      const int d = (int)dd;
      const int64_t th = scan_host(a.t, tm, d, Tick::aux(a, tm, d),
                                   a.t.cpu_ns_per_event[d],
                                   a.t.cpu_avail[d]);
      if (tm.leader()) a.t_h[d] = th;
      o.th = imin(o.th, th);
    }
  }
  publish(a, 0, block_reduce(o));
  grid.sync();
  const HostOut g = fold(a, 0);
  ws = imax(*a.now, g.th);
  we = imin(ws + a.min_latency, a.t_target);
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.t.err |= g.err;
  return g.th;
}

// A micro-step's end: the block partials of parity `buf` published and
// folded after one grid sync; block 0 advances the state scalars.
// Returns the new gmin.
__device__ __forceinline__ int64_t step_close(const WindowArgs& a,
                                              cg::grid_group& grid, int buf,
                                              const HostOut& s) {
  publish(a, buf, block_reduce(s));
  grid.sync();
  const HostOut g = fold(a, buf);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.t.n_events += g.events;
    *a.t.n_steps += 1;
    *a.t.err |= g.err;
  }
  return g.th;
}

// The window close: outbox pending, state scalars, result vector.
__device__ __forceinline__ void window_close(const WindowArgs& a,
                                             cg::grid_group& grid, int buf,
                                             int64_t gmin, int64_t ws,
                                             int64_t we, int64_t status) {
  const int64_t gtid = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kBlock;
  buf ^= 1;
  HostOut q{INV, 0, 0};
  for (int64_t i = gtid; i < a.x.p0; i += gstride) {
    if (a.x.pool_stage[i] == STAGE_IN_FLIGHT)
      q.th = imin(q.th, a.x.pool_time[i]);
  }
  publish(a, buf, block_reduce(q));
  grid.sync();
  if (blockIdx.x == 0) {
    const HostOut p = fold(a, buf);
    if (threadIdx.x == 0) {
      *a.now = we;
      *a.n_windows += 1;
      a.win[0] = gmin;
      a.win[1] = ws;
      a.win[2] = we;
      a.win[3] = p.th;
      a.win[4] = status;
    }
  }
}

__global__ void __launch_bounds__(kBlock) k_window(WindowArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int h = a.x.h;
  const int e = a.t.e, pc = a.t.pc;
  const int64_t gtid = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kBlock;
  const Solo tm{};
  Clk no_clk = make_clk(nullptr, false);
  int64_t ws, we;
  int64_t gmin = window_open<PholdTick, Solo>(a, grid, ws, we);

  int buf = 0;
  int64_t steps = 0;
  int64_t status = 0;
  while (gmin < we) {                  // gmin is the same in every block
    if (steps == a.max_steps) {
      status = 1;
      break;
    }
    buf ^= 1;
    HostOut s{INV, 0, 0};
    for (int64_t i = gtid; i < h; i += gstride) {
      const int hh = (int)i;
      // Tick setup: re-arm the resume time of active hosts only.
      const int64_t th0 = a.t_h[hh];
      const bool act = th0 < we;
      const int64_t tick = act ? th0 : we;
      if (act) a.d.t_resume[hh] = INV;
      const int64_t aux0 = PholdTick::aux(a, tm, hh);
      const DeliverOut dl = deliver_host(a.d, tm, hh, tick, act, aux0, we);
      phold_tick(a.p, a.d, hh, dl.t_post, act, we,
                 a.em_valid + (int64_t)hh * e,
                 a.em_blk + (int64_t)hh * e * pc, e, pc);
      const HostOut t = transport_host(a.t, tm, nullptr, hh, tick, dl.t_post,
                                       act, dl.delivered,
                                       PholdTick::next(a, hh), no_clk);
      a.t_h[hh] = t.th;
      s.th = imin(s.th, t.th);
      s.events += t.events;
      s.err |= t.err;
    }
    gmin = step_close(a, grid, buf, s);
    ++steps;
  }
  window_close(a, grid, buf, gmin, ws, we, status);
}

// The TCP window: one warp per host, every thread through every barrier
// (see the design note above).  `clk` traces host a.clk_host's phases in
// the lane 0 of the warp that runs it (S1_PHASE_CLOCKS builds).
template <class Tick>
__device__ __forceinline__ void window_tcp(const WindowArgs& a) {
  cg::grid_group grid = cg::this_grid();
  const int h = a.x.h, e = a.t.e, rb = a.d.rx_batch;
  const int64_t gtid = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kBlock;
  const Warp tm{};
  const int64_t nw = gstride / Warp::W;
  int32_t* const gates = a.tcp.gates;            // [2][rb] by step parity
  Clk clk = make_clk(a.clk, a.clk_host >= 0 && a.clk_host < h &&
                                gtid / Warp::W == a.clk_host % nw &&
                                tm.leader());
  Clk no_clk = make_clk(nullptr, false);
  clk.start();
  for (int64_t i = gtid; i < 2 * rb; i += gstride) gates[i] = 0;
  int64_t ws, we;
  int64_t gmin = window_open<Tick, Warp>(a, grid, ws, we);
  clk.mark(CLK_OPEN);

  int buf = 0;
  int64_t steps = 0;
  int64_t status = 0;
  while (gmin < we) {                  // gmin is the same in every block
    if (steps == a.max_steps) {
      status = 1;
      break;
    }
    buf ^= 1;
    // The other parity's words were last read before the previous step's
    // closing barrier and are next written after this step's.
    if (gtid == 0)
      for (int r = 0; r < rb; ++r) gates[(buf ^ 1) * rb + r] = 0;
    HostOut s{INV, 0, 0};
    const int32_t sock_err = deliver_tcp_warps(
        a.d, a.tcp, gates + buf * rb, we, clk, a.clk_host,
        [&](int hh, int64_t& tick, bool& act, int64_t& aux0) {
          // Tick setup: re-arm the resume time of active hosts only; the
          // rx_batch bound is the aux term after the re-arm.
          const int64_t th0 = a.t_h[hh];
          act = th0 < we;
          tick = act ? th0 : we;
          if (act && tm.leader()) a.d.t_resume[hh] = INV;
          for (int j = tm.lane(); j < e; j += Warp::W)
            a.tcp.em_valid[(int64_t)hh * e + j] = 0;
          tm.sync();
          aux0 = Tick::aux(a, tm, hh);
        },
        [&](int hh, const RxCarry& c, const DeliverOut& dl, bool traced) {
          Clk& ck = traced ? clk : no_clk;
          tcp_run_timers(tm, a.tcp, hh, dl.t_post, c.act);
          ck.mark(CLK_TIMERS);
          Tick::tick(a, tm, hh, dl.t_post, c.act);
          ck.mark(CLK_TICK);
          const HostOut o = transport_host(a.t, tm, &a.tcp, hh, c.tick,
                                           dl.t_post, c.act, dl.delivered,
                                           Tick::next(a, hh), ck);
          if (tm.leader()) {
            a.t_h[hh] = o.th;
            s.events += o.events;
          }
          s.th = imin(s.th, o.th);
          s.err |= o.err;
        });
    s.err |= sock_err;
    clk.start();
    gmin = step_close(a, grid, buf, s);
    clk.mark(CLK_CLOSE);
    clk.count_step();
    ++steps;
  }
  clk.start();
  window_close(a, grid, buf, gmin, ws, we, status);
  clk.mark(CLK_WCLOSE);
}

__global__ void __launch_bounds__(kBlock, 2) k_window_tcp(WindowArgs a) {
  window_tcp<BulkTick>(a);
}

}  // namespace

// Blocks per SM of K_WINDOW's kernel (k_window_tcp when `tcp`, else
// k_window) and the card's SM count: the wrapper sizes the cooperative
// grid from them.  Returns a CUDA error code, or -1 when the device cannot
// launch cooperative kernels or the kernel does not fit on an SM.
extern "C" int window_occupancy(int tcp, int* per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = tcp ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  per_sm, k_window_tcp, kBlock, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  per_sm, k_window, kBlock, 0);
  if (e != cudaSuccess) return (int)e;
  return (!coop || *per_sm < 1) ? -1 : 0;
}

extern "C" int window_launch(const WindowArgs* args, void* stream) {
  void* params[] = {(void*)args};
  return (int)cudaLaunchCooperativeKernel((const void*)k_window,
                                          dim3(args->n_blocks), dim3(kBlock),
                                          params, 0, (cudaStream_t)stream);
}

extern "C" int window_tcp_launch(const WindowArgs* args, void* stream) {
  void* params[] = {(void*)args};
  return (int)cudaLaunchCooperativeKernel((const void*)k_window_tcp,
                                          dim3(args->n_blocks), dim3(kBlock),
                                          params, 0, (cudaStream_t)stream);
}

// The device f64 log1p (phold_tick.cuh log1p_xla) over a vector, for the
// card-vs-CPU check of chip_smoke.py.
namespace {
__global__ void k_log1p_probe(const double* x, double* y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = log1p_xla(x[i]);
}
}  // namespace

extern "C" int log1p_probe_launch(const double* x, double* y, int64_t n,
                                  void* stream) {
  const int tb = 256;
  k_log1p_probe<<<(unsigned)((n + tb - 1) / tb), tb, 0,
                  (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}
