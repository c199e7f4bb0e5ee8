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
// the host's window loop reads one small vector per launch and nothing
// per micro-step.  Four kernels: k_window for UDP worlds with phold's
// tick (phold_tick.cuh), and for TCP worlds with the TCP machine
// (tcp.cuh) k_window_tcp with bulk's tick (bulk_tick.cuh) and
// k_window_tgen with tgen's (tgen_tick.cuh), the same template
// (window_tcp) on two tick policies, and tgen's resident kernel
// k_window_tgen_res (one block per host with its hot state in shared
// memory, for the worlds whose shape fits; its note is below it).  They
// share the window's opening
// (exchange and scan) and closing as device functions, so phold's kernel
// does not carry the TCP machine's registers.  Each is a template on the
// world's interface buffers (k_window<Buf>; deliver.cuh) and, the TCP
// kernels, on its congestion control (k_window_tcp<Buf, Cong>; tcp.cuh),
// picked on the host once per launch from the arguments, so Reno worlds
// without buffers run the code they ran before either existed.  One
// library holds every instantiation; nvcc's --split-compile builds its
// kernels in parallel (core/_build.py).
//
// Design.  Within a window every phase is row-local over hosts (the
// megakernel's blocking contract): the only cross-host values are the
// exchange, gmin, the event count, the error bits and, in TCP worlds, the
// two scoreboard gates of each delivery round.  So one grid of resident
// blocks (cudaLaunchCooperativeKernel) runs the window, and grid-wide
// barriers (cooperative_groups this_grid().sync()) separate what must be
// ordered:
//   * the exchange's stages (exchange.cuh ex_run: the free lists and
//     the radix sort's counts, grid scans and scatters, with the
//     two-class re-rank in TCP worlds), then each host's scan
//     (transport.cuh scan_host);
//   * each micro-step: every host runs its phases on its team (the
//     staging rows go through a scratch tensor, written and read by that
//     team only), then each block folds its (th min, event sum, error
//     OR) by a fixed tree and publishes it; after one grid sync every
//     block folds all partials (one warp, strided, then a shuffle tree),
//     so every block computes the same gmin and the loop predicate is
//     uniform;
//   * the window close: the outbox-pending min over the pool, published
//     and folded the same way by every block; block 0 writes the state
//     scalars and the result vector.
// The partials are double-buffered: every publish -- the window's
// opening, each micro-step, the window's close (and the v1 exchange
// scan's chunk sums) -- flips one parity bit carried through the whole
// launch (the exchange's own stages publish into its own partials, with
// the same protocol: exchange.cuh ex_publish).  A block folds parity p right after
// the barrier that follows its publish; the next publish into p comes two
// publishes later, after the next barrier, which no block passes before
// every block has finished that fold.  So one barrier per publish
// suffices, across windows too.  Integer min/sum/OR do not depend on
// order, so the results equal the reference's.  The loop carries a step
// cap from the wrapper, far above any real window: past it the kernel
// sets status 1 and exits, so a wrong predicate fails the run instead of
// hanging the card.
//
// The window loop runs on the card, in every kernel.  After each window
// every block has the same gmin, outbox pending and `now` (carried in a
// register: the window's end, which block 0 also writes to the state), so
// the launch goes on to the next window while engine._run_windows'
// predicate holds -- now < t_target and min(gmin, outbox pending) <
// t_target, the JAX window_cond -- and fewer than `max_windows` windows
// have run (then status 2 if the predicate still holds).  One launch thus
// runs a whole run_until call: the same windows, micro-steps and
// n_windows as one launch per window.  The scratch each window reuses is
// rewritten by the window before it is read: the exchange's tables,
// free lists and sort buffers by its stages (ex_run zeroes what it
// counts into), every host's t_h by the scan and its staging lanes by
// its tick.  One thread per host (the Solo team) in blocks of
// kWinBlock = 128 threads: at the bench world (16,384 hosts) the grid is
// 128 blocks, one on each of 128 of the card's 132 SMs (256-thread blocks
// filled only 64).  A micro-step has no barrier inside it.  Its delivery
// phase is deliver.cuh deliver_small where the world fits (the bench
// world; the tick setup's loads are one step with its first), else
// deliver_host on the Solo team; the choice is the same in every thread.
//
// TCP (k_window_tcp, k_window_tgen): one warp per host (the Warp team,
// common.cuh), hosts walked warp-stride.  A host's slab and socket walks
// -- the router
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
// (per-host exact; tcp.cuh, bulk_tick.cuh).  Tgen's tick has one: its
// server pass reads the peers' stream registers, which their client pass
// of the same step writes, so the step runs the client stage in the
// last round's host loop, parks the host's tick, t_post, active flag and
// delivery count in a scratch record, and after one grid barrier runs
// the server stage, the sink and K_TRANSPORT's body in a second host
// loop (TgenTick::kSplit).  The socket-overflow bit of a
// passive open and the pool-overflow bits are OR-ed into the step's block
// partials (only the leader lane counts a host's events).  Nothing a
// gathered socket holds lives across a barrier, so the kernel takes
// __launch_bounds__(256, 2) (ptxas: chip_smoke.py prints registers and
// spills).
//
// Both grids are sized from the occupancy query (the wrapper's
// window_occupancy), never refused for H: hosts are walked with
// grid-stride loops, so any number of hosts runs.
//
// What bounds it on the H100: bytes.  Per window it must move what the
// exchange, each micro-step's phases and the tick touch -- the pool's
// stage column, the movers' rows, each active host's slabs, host row,
// sockets and app state, and the rows staged -- a few MB at the bench
// world (chip_smoke.py counts it per window from the run's data), a few
// microseconds of HBM time.  The chains of dependent loads in each
// host's walks and the serialising grid barriers (one a micro-step in
// UDP worlds, rx_batch + 1 in TCP worlds) and, in the bulk world, the
// server's serial TCP machine (up to rx_batch arrivals a step) set the
// time.
#include <cooperative_groups.h>

#include "bulk_tick.cuh"
#include "exchange.cuh"
#include "phold_tick.cuh"
#include "tgen_tick.cuh"
#include "transport.cuh"

using namespace s1;

// Mirrored field for field by the ctypes.Structure in
// shadow1_tpu_torch/core/megakernel.py.  In `d` and `t` the per-phase
// kernels' per-host inputs and outputs are unused (null); `t.em_valid` /
// `t.em_blk` point at the staging scratch below.  `p` is phold's (UDP),
// `tcp` the TCP kernels', `b` bulk's and `g` tgen's; the other kernels
// leave them zero.
struct WindowArgs {
  ExchangeArgs x;
  DeliverArgs d;
  TransportArgs t;
  PholdArgs p;
  TcpArgs tcp;
  BulkArgs b;
  TgenArgs g;
  int64_t* t_h;        // [h] out: per-host next event time
  int64_t* part_min;   // [2 * n_blocks] block partials, by parity
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
  int64_t max_steps;   // micro-steps of one window (status 1 past it)
  int64_t max_windows; // windows of one launch (k_window; status 2 at it)
  int32_t n_blocks;
  int32_t clk_host;    // the host whose phases are traced
};

// Status words of the result vector (megakernel.py check_window_status).
constexpr int64_t STATUS_STEP_CAP = 1;
constexpr int64_t STATUS_WINDOW_CAP = 2;

constexpr int kWinBlock = 128;   // threads per block of k_window

namespace {

// Flips the parity and publishes this block's partials into it: the
// block's fold of o, or, with `Held`, thread 0's o (the resident kernel,
// whose thread 0 holds its host's values).
template <int B, bool Held = false>
__device__ __forceinline__ void publish(const WindowArgs& a, int& buf,
                                        const HostOut& o) {
  const HostOut b = Held ? o : block_reduce<B>(o);
  buf ^= 1;
  if (threadIdx.x == 0) {
    const int64_t i = (int64_t)buf * a.n_blocks + blockIdx.x;
    a.part_min[i] = b.th;
    a.part_ev[i] = b.events;
    a.part_err[i] = b.err;
  }
}

// Every block's partials of parity `buf`, folded by the block's first
// warp (lane l takes blocks l, l + 32, ..., then a shuffle tree); all
// threads of the calling block get the result.
__device__ __forceinline__ HostOut fold(const WindowArgs& a, int buf) {
  __shared__ int64_t s_min, s_ev;
  __shared__ int32_t s_err;
  if (threadIdx.x < Warp::W) {
    const Warp w{};
    int64_t mn = INV, ev = 0;
    int32_t er = 0;
    const int64_t off = (int64_t)buf * a.n_blocks;
    for (int b = w.lane(); b < a.n_blocks; b += Warp::W) {
      // L2 loads: the partials were written by other blocks.
      mn = imin(mn, __ldcg((const long long*)a.part_min + off + b));
      ev += __ldcg((const long long*)a.part_ev + off + b);
      er |= __ldcg(a.part_err + off + b);
    }
    mn = w.min64(mn);
    ev = w.sum64(ev);
    er = w.or32(er);
    if (w.leader()) {
      s_min = mn;
      s_ev = ev;
      s_err = er;
    }
  }
  __syncthreads();
  const HostOut r{s_min, s_ev, s_err};
  __syncthreads();
  return r;
}

// Publish, one grid sync, fold: every block gets the grid's totals.
template <int B, bool Held = false>
__device__ __forceinline__ HostOut all_reduce(const WindowArgs& a,
                                              cg::grid_group& grid, int& buf,
                                              const HostOut& o) {
  publish<B, Held>(a, buf, o);
  grid.sync();
  return fold(a, buf);
}

// The previous exchange design's scan (ExchangeArgs.v1, exchange.cuh):
// start[d] = the movers of the destinations before d, start[h] = all of
// them, over the whole grid.  Each block takes a contiguous chunk of the
// counts, one count a thread a tile (coalesced loads), and publishes its
// chunk's sum with the parity protocol of the partials; after one grid
// barrier every block folds the sums of the blocks before it and adds
// them to a block-wide scan of its chunk.  In TCP worlds each
// destination's thread also ORs the two-class gate's second word (some
// destination has more movers than free slots; zeroed by window_open).
// The caller's next grid barrier publishes `start`.
template <int B>
__device__ __forceinline__ void ex_scan_grid_v1(const WindowArgs& a,
                                                cg::grid_group& grid,
                                                int& buf) {
  const ExchangeArgs& x = a.x;
  const int64_t chunk = (x.h + gridDim.x - 1) / gridDim.x;
  const int64_t lo = imin((int64_t)blockIdx.x * chunk, x.h);
  const int64_t hi = imin(lo + chunk, x.h);
  int64_t s = 0;
  for (int64_t d = lo + threadIdx.x; d < hi; d += B) s += x.total[d];
  publish<B>(a, buf, HostOut{INV, s, 0});
  grid.sync();
  __shared__ int64_t s_before, s_total;
  if (threadIdx.x < Warp::W) {
    const Warp w{};
    int64_t before = 0, total = 0;
    const int64_t off = (int64_t)buf * a.n_blocks;
    for (int b = w.lane(); b < a.n_blocks; b += Warp::W) {
      const int64_t v = __ldcg((const long long*)a.part_ev + off + b);
      total += v;
      before += b < (int)blockIdx.x ? v : 0;
    }
    before = w.sum64(before);
    total = w.sum64(total);
    if (w.leader()) {
      s_before = before;
      s_total = total;
    }
  }
  __syncthreads();
  int32_t acc = (int32_t)s_before;
  if (blockIdx.x == 0 && threadIdx.x == 0) x.start[x.h] = (int32_t)s_total;
  const bool gate = x.tcp && x.part[0] != 0;
  for (int64_t t0 = lo; t0 < hi; t0 += B) {
    const int64_t d = t0 + threadIdx.x;
    const int32_t c = d < hi ? x.total[d] : 0;
    int32_t tile;
    const int32_t ex = block_exclusive_scan<B>(c, tile);
    if (d < hi) {
      x.start[d] = acc + ex;
      if (gate) {
        int nf = 0;
        for (int k = 0; k < x.ki; ++k)
          nf += x.ib_stage[d * x.ki + k] == STAGE_FREE;
        if (c > nf) atomicOr(&x.part[1], 1);
      }
    }
    acc += tile;
  }
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

// deliver_small's inputs in k_window: the tick setup.  A host is active
// when its next event falls before the window's end; its resume time is
// re-armed then (deliver_small writes it back with the row), and the
// rx_batch bound is the aux term after the re-arm (PholdTick::aux).
struct PholdRxIn {
  const WindowArgs& a;
  int64_t we;
  __device__ void load(int hh, int64_t* w) const {
    w[0] = a.t_h[hh];
    w[1] = a.p.pending[hh];
    w[2] = a.p.next_send[hh];
    w[3] = a.d.t_resume[hh];
  }
  __device__ RxIn resolve(const int64_t* w) const {
    const bool act = w[0] < we;
    const int64_t tr = act ? INV : w[3];
    return RxIn{act ? w[0] : we, imin(tr, w[1] > 0 ? w[2] : INV), tr, act};
  }
};

// The TCP ticks.  BulkTick's is per-host exact, in one stage.
// TgenTick's server pass reads other hosts' registers as their client
// pass of the same micro-step left them, so it is split (kSplit): the
// client stage runs in the host's step, a grid barrier follows every
// host's, then the server stage, the sink and K_TRANSPORT's body run.
struct BulkTick {
  static constexpr bool kSplit = false;
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

struct TgenTick {
  static constexpr bool kSplit = true;
  __device__ static int64_t next(const WindowArgs& a, int hh) {
    return tgen_next(a.g, hh);
  }
  template <class Team>
  __device__ static int64_t aux(const WindowArgs& a, const Team& tm,
                                int hh) {
    return imin(imin(a.t.t_resume[hh], timer_min(tm, a.tcp, hh)),
                next(a, hh));
  }
  template <class Team>
  __device__ static void client(const WindowArgs& a, const Team& tm, int hh,
                                int64_t tp, bool act) {
    tgen_client(tm, a.g, a.tcp, hh, tp, act);
  }
  template <class Team>
  __device__ static void server(const WindowArgs& a, const Team& tm,
                                int hh) {
    tgen_server(tm, a.g, a.tcp, hh);
  }
};

// Destination d's drop accounting after the exchange, from its movers
// (`total`, `total_prot` of them not pure ACKs) and its free slots: in
// TCP worlds the pure ACKs are shed first (engine._exchange_tail).
// Returns the error bits.
__device__ __forceinline__ int32_t open_drops(const WindowArgs& a, int d,
                                              int32_t total,
                                              int32_t total_prot,
                                              int32_t n_free) {
  const int32_t drops = imax32(total - n_free, 0);
  const int32_t data_drops = imin32(drops, imax32(total_prot - n_free, 0));
  if (drops > data_drops) a.acks_thinned[d] += drops - data_drops;
  if (data_drops <= 0) return 0;
  a.t.pkts_dropped_pool[d] += data_drops;
  return ERR_POOL_OVERFLOW;
}

// The same from ex_run's counts.
__device__ __forceinline__ int32_t open_drops(const WindowArgs& a, int d) {
  return open_drops(a, d, __ldcg(a.x.total + d), __ldcg(a.x.total_prot + d),
                    __ldcg(a.x.n_free + d));
}

// The window open's end: the scans' partials reduced over the grid (with
// `Held`, thread 0's: publish), the window bounds ws = max(now, gmin) and
// `we` from `now`, the error bits; block 0 writes ws into the result
// vector here, so no register holds it through the window.  Returns gmin;
// every block gets the same values.
template <int B, bool Held = false>
__device__ __forceinline__ int64_t open_bounds(const WindowArgs& a,
                                               cg::grid_group& grid,
                                               int& buf, const HostOut& o,
                                               int64_t now, int64_t& we) {
  const HostOut g = all_reduce<B, Held>(a, grid, buf, o);
  const int64_t ws = imax(now, g.th);
  we = imin(ws + a.min_latency, a.t_target);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.t.err |= g.err;
    a.win[1] = ws;
  }
  return g.th;
}

// The boundary exchange, its drop accounting (open_drops), the
// per-window scan and the window's end `we` from `now` (open_bounds).
// Returns gmin; every block gets the same values.  The exchange is
// exchange.cuh ex_run over the whole grid (k_window_tcp's default) or,
// with x.v1, the previous design's passes (k_window's default, measured
// faster on phold); after a grid sync each destination's thread does its
// drop accounting and, with a Solo `Team`, scans its host; with Warp one
// warp per host scans.  B is the block size; `clk` marks the exchange's
// stages.
template <class Tick, class Team, int B>
__device__ __forceinline__ int64_t window_open(const WindowArgs& a,
                                               cg::grid_group& grid,
                                               int& buf, int64_t now,
                                               int64_t& we, Clk& clk) {
  const int h = a.x.h;
  const int64_t gtid = (int64_t)blockIdx.x * B + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * B;
  const Team tm{};
  constexpr bool solo = Team::W == 1;
  HostOut o{INV, 0, 0};
  if (a.x.v1) {
    for (int64_t d = gtid; d < h; d += gstride) {
      a.x.total[d] = 0;
      a.x.n_free[d] = 0;
    }
    if (gtid < 2) a.x.part[gtid] = 0;
    grid.sync();
    for (int64_t i = gtid; i < a.x.p0; i += gstride)
      ex_count_row_v1(a.x, i);
    grid.sync();
    clk.mark(CLK_EX_COUNT);
    ex_scan_grid_v1<B>(a, grid, buf);
    grid.sync();
    clk.mark(CLK_EX_SCAN);
    for (int64_t i = gtid; i < a.x.p0; i += gstride)
      ex_bucket_row_v1(a.x, i);
    grid.sync();
    clk.mark(CLK_EX_BUCKET);
  } else {
    ex_run<B>(a.x, grid, clk);
    grid.sync();
  }
  for (int64_t dd = gtid; dd < h; dd += gstride) {
    const int d = (int)dd;
    if (a.x.v1) {
      int32_t total, total_prot, n_free;
      ex_place_dest_v1(a.x, d, total, total_prot, n_free);
      o.err |= open_drops(a, d, total, total_prot, n_free);
    } else {
      o.err |= open_drops(a, d);
    }
    if (solo) {
      const int64_t th = scan_host(a.t, tm, d, Tick::aux(a, tm, d),
                                   a.t.cpu_ns_per_event[d],
                                   a.t.cpu_avail[d]);
      a.t_h[d] = th;
      o.th = imin(o.th, th);
    }
  }
  if (a.x.v1) clk.mark(CLK_EX_PLACE);
  if (!solo) {
    if (a.x.v1) grid.sync();    // the v1 rows were placed in the loop above
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
  return open_bounds<B>(a, grid, buf, o, now, we);
}

// A micro-step's end: the block partials reduced over the grid; block 0
// advances the state scalars.  Returns the new gmin.
template <int B, bool Held = false>
__device__ __forceinline__ int64_t step_close(const WindowArgs& a,
                                              cg::grid_group& grid, int& buf,
                                              const HostOut& s) {
  const HostOut g = all_reduce<B, Held>(a, grid, buf, s);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.t.n_events += g.events;
    *a.t.n_steps += 1;
    *a.t.err |= g.err;
  }
  return g.th;
}

// The window close: the outbox pending reduced over the grid (returned
// to every block), the state scalars and the result vector's words 0, 2
// and 3 (open_bounds wrote ws).  With `Held`, the block's min is the
// team's (every thread of the block in one team) and thread 0 publishes
// it.
template <int B, bool Held = false, class Team = Solo>
__device__ __forceinline__ int64_t window_close(const WindowArgs& a,
                                                cg::grid_group& grid,
                                                int& buf, int64_t gmin,
                                                int64_t we,
                                                const Team& tm = Team{}) {
  const int64_t gtid = (int64_t)blockIdx.x * B + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * B;
  HostOut q{INV, 0, 0};
  for (int64_t i = gtid; i < a.x.p0; i += gstride) {
    if (a.x.pool_stage[i] == STAGE_IN_FLIGHT)
      q.th = imin(q.th, a.x.pool_time[i]);
  }
  if constexpr (Held) q.th = tm.min64(q.th);
  const int64_t pend = all_reduce<B, Held>(a, grid, buf, q).th;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.now = we;
    *a.n_windows += 1;
    a.win[0] = gmin;
    a.win[2] = we;
    a.win[3] = pend;
  }
  return pend;
}

__device__ __forceinline__ void write_status(const WindowArgs& a,
                                             int64_t status) {
  if (blockIdx.x == 0 && threadIdx.x == 0) a.win[4] = status;
}

template <bool Buf>
__global__ void __launch_bounds__(kWinBlock) k_window(WindowArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int h = a.x.h;
  const int e = a.t.e, pc = a.t.pc;
  const int64_t gtid = (int64_t)blockIdx.x * kWinBlock + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kWinBlock;
  const Solo tm{};
  // The thread that runs host a.clk_host (and every host of its stride).
  Clk clk = make_clk(a.clk, a.clk_host >= 0 && a.clk_host < h &&
                                gtid == a.clk_host % gstride);
  clk.start();
  // Every block reads the state's `now` before its first barrier; block 0
  // rewrites it at each window's close, after several.
  int64_t now = *a.now;
  int buf = 0;
  int64_t windows = 0;
  int64_t status = 0;
  const bool small = deliver_small_fits(a.d);      // the same in every thread
  __shared__ RxRows<kWinBlock> rx_rows;            // deliver_small's rows
  for (;;) {
    int64_t we;
    int64_t gmin = window_open<PholdTick, Solo, kWinBlock>(a, grid, buf,
                                                          now, we, clk);
    clk.mark(CLK_OPEN);
    int64_t steps = 0;
    while (gmin < we) {                // gmin is the same in every block
      if (steps == a.max_steps) {
        status = STATUS_STEP_CAP;
        break;
      }
      HostOut s{INV, 0, 0};
      for (int64_t i = gtid; i < h; i += gstride) {
        const int hh = (int)i;
        int64_t tick;
        bool act;
        DeliverOut dl;
        if (small) {
          // The tick setup's loads are deliver_small's first step.
          RxIn in;
          dl = deliver_small<Buf>(a.d, hh, PholdRxIn{a, we}, we, rx_rows,
                                  in, clk);
          tick = in.tick;
          act = in.act;
        } else {
          // Tick setup: re-arm the resume time of active hosts only.
          const int64_t th0 = a.t_h[hh];
          act = th0 < we;
          tick = act ? th0 : we;
          if (act) a.d.t_resume[hh] = INV;
          const int64_t aux0 = PholdTick::aux(a, tm, hh);
          clk.mark(CLK_SETUP);
          dl = deliver_host<Buf>(a.d, tm, hh, tick, act, aux0, we, clk);
        }
        phold_tick(a.p, a.d, hh, dl.t_post, act, we,
                   a.em_valid + (int64_t)hh * e,
                   a.em_blk + (int64_t)hh * e * pc, e, pc);
        clk.mark(CLK_TICK);
        const HostOut t = transport_host(a.t, tm, nullptr, hh, tick,
                                         dl.t_post, act, dl.delivered,
                                         PholdTick::next(a, hh), clk);
        a.t_h[hh] = t.th;
        s.th = imin(s.th, t.th);
        s.events += t.events;
        s.err |= t.err;
      }
      gmin = step_close<kWinBlock>(a, grid, buf, s);
      clk.mark(CLK_CLOSE);
      clk.count_step();
      ++steps;
    }
    const int64_t pend = window_close<kWinBlock>(a, grid, buf, gmin, we);
    clk.mark(CLK_WCLOSE);
    now = we;
    ++windows;
    // The window loop's predicate (engine._run_windows, the JAX
    // window_cond), the same in every block.
    if (status != 0 || now >= a.t_target || imin(gmin, pend) >= a.t_target)
      break;
    if (windows == a.max_windows) {
      status = STATUS_WINDOW_CAP;
      break;
    }
  }
  write_status(a, status);
}

// The TCP window on a design `D` (WarpDesign, ResDesign below), every
// thread through every barrier (see the design note above): the window
// open (D::open), the micro-steps -- the tick setup, the delivery rounds
// (deliver_tcp_rounds on D's hosts), run_timers, the tick, K_TRANSPORT's
// body -- and the window close, while the window loop's predicate holds.
// The host-local device code runs on D.A, the arguments as the design
// points them; the grid's words (gates, t_h, the partials, the state
// scalars) are the kernel's `a`.  `clk` traces host a.clk_host's phases
// in the thread D::traced picks (S1_PHASE_CLOCKS builds).  `Buf` and
// `Cong` are the interface-buffer and congestion-control instantiations
// (deliver.cuh, tcp.cuh).
template <class Tick, bool Buf, int Cong, class D>
__device__ __forceinline__ void window_tcp(const WindowArgs& a, D& dz) {
  using Team = typename D::Team;
  constexpr int B = D::Threads;
  constexpr bool Held = D::kHeld;
  cg::grid_group grid = cg::this_grid();
  const WindowArgs& A = dz.A;
  const Team& tm = dz.tm;
  const int e = a.t.e, rb = a.d.rx_batch;
  const int64_t gtid = (int64_t)blockIdx.x * B + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * B;
  int32_t* const gates = a.tcp.gates;            // [2][rb] by step parity
  Clk clk = make_clk(a.clk, dz.traced());
  Clk no_clk = make_clk(nullptr, false);
  clk.start();
  for (int64_t i = gtid; i < 2 * rb; i += gstride) gates[i] = 0;
  // Every block reads the state's `now` before its first barrier; block 0
  // rewrites it at each window's close, after several.
  int64_t now = *a.now;
  int buf = 0;
  // 32-bit counts (far below 2^31): the warp kernels' registers are
  // capped at 128, and what lives through the TCP machine spills.
  int32_t windows = 0;
  int64_t status = 0;
  for (;;) {
    int64_t we;
    int64_t gmin = dz.template open<Tick>(grid, buf, now, we, clk);
    clk.mark(CLK_OPEN);

    int32_t steps = 0;
    while (gmin < we) {                  // gmin is the same in every block
      if (steps == a.max_steps) {
        status = STATUS_STEP_CAP;
        break;
      }
      // The step's gate words: parity `g`, the one the step's closing
      // publish takes.  The other parity's words were last read before the
      // previous step's closing barrier and are next written after this
      // step's.
      const int g = buf ^ 1;
      if (gtid == 0)
        for (int r = 0; r < rb; ++r) gates[(g ^ 1) * rb + r] = 0;
      HostOut s{INV, 0, 0};
      // K_TRANSPORT's body after the tick, and the host's partials.
      const auto step_tail = [&](int hh, int64_t tick, int64_t tp, bool act,
                                 int32_t delivered, Clk& ck) {
        const HostOut o = transport_host(A.t, tm, &A.tcp, hh, tick, tp, act,
                                         delivered, Tick::next(A, hh), ck,
                                         dz.rows);
        if (tm.leader()) {
          a.t_h[hh] = o.th;
          s.events += o.events;
        }
        s.th = imin(s.th, o.th);
        s.err |= o.err;
      };
      const int32_t sock_err = deliver_tcp_rounds<Buf, Cong>(
          A.d, A.tcp, dz, gates + g * rb, we, clk, a.clk_host,
          [&](int hh, int64_t& tick, bool& act, int64_t& aux0) {
            // Tick setup: re-arm the resume time of active hosts only; the
            // rx_batch bound is the aux term after the re-arm.
            const int64_t th0 = a.t_h[hh];
            act = th0 < we;
            tick = act ? th0 : we;
            if (act && tm.leader()) a.d.t_resume[hh] = INV;
            for (int j = tm.lane(); j < e; j += Team::W)
              A.tcp.em_valid[(int64_t)hh * e + j] = 0;
            tm.sync();
            aux0 = Tick::aux(A, tm, hh);
          },
          [&](int hh, const RxCarry& c, const DeliverOut& dl, bool traced) {
            Clk& ck = traced ? clk : no_clk;
            tcp_run_timers<Cong>(tm, A.tcp, hh, dl.t_post, c.act);
            ck.mark(CLK_TIMERS);
            if constexpr (Tick::kSplit) {
              // The client stage; the host's step goes on after the barrier.
              Tick::client(A, tm, hh, dl.t_post, c.act);
              dz.park_split(hh, c.tick, dl.t_post, c.act, dl.delivered);
            } else {
              Tick::tick(A, tm, hh, dl.t_post, c.act);
              ck.mark(CLK_TICK);
              step_tail(hh, c.tick, dl.t_post, c.act, dl.delivered, ck);
            }
          });
      if constexpr (Tick::kSplit) {
        // Every host's client stage before any server stage reads it.
        grid.sync();
        dz.each([&](int hh) {
          Clk& ck = hh == a.clk_host ? clk : no_clk;
          int64_t tick, tp;
          bool act;
          int32_t delivered;
          dz.unpark_split(hh, tick, tp, act, delivered);
          Tick::server(A, tm, hh);
          ck.mark(CLK_TICK);
          step_tail(hh, tick, tp, act, delivered, ck);
        });
      }
      s.err |= sock_err;
      clk.start();
      gmin = step_close<B, Held>(a, grid, buf, s);
      clk.mark(CLK_CLOSE);
      clk.count_step();
      ++steps;
    }
    dz.close();
    clk.start();
    const int64_t pend =
        window_close<B, Held>(a, grid, buf, gmin, we, tm);
    clk.mark(CLK_WCLOSE);
    now = we;
    ++windows;
    // The window loop's predicate, as k_window's.
    if (status != 0 || now >= a.t_target || imin(gmin, pend) >= a.t_target)
      break;
    if (windows == a.max_windows) {
      status = STATUS_WINDOW_CAP;
      break;
    }
  }
  write_status(a, status);
}

// The warp design (k_window_tcp, k_window_tgen): one warp per host,
// walked warp-stride over the grid, with a host's carry across the gates
// (WarpHosts) and tgen's across its client/server barrier (g.split)
// parked in device scratch; the arguments' tensors as they are (A is the
// kernel's `a`); the window open's exchange either design (window_open).
// The trace is the lane 0 of the warp that runs host a.clk_host.
struct WarpDesign : WarpHosts {
  static constexpr int Threads = kBlock;
  static constexpr bool kHeld = false;
  const WindowArgs& A;
  __device__ explicit WarpDesign(const WindowArgs& a)
      : WarpHosts(a.tcp.carry, a.x.h), A(a) {}
  __device__ bool traced() const {
    const int64_t nw = (int64_t)gridDim.x * Threads / Warp::W;
    const int64_t w = ((int64_t)blockIdx.x * Threads + threadIdx.x) / Warp::W;
    return A.clk_host >= 0 && A.clk_host < h && w == A.clk_host % nw &&
           tm.leader();
  }
  template <class Tick>
  __device__ int64_t open(cg::grid_group& grid, int& buf, int64_t now,
                          int64_t& we, Clk& clk) const {
    return window_open<Tick, Warp, Threads>(A, grid, buf, now, we, clk);
  }
  __device__ void close() const {}
  __device__ void park_split(int hh, int64_t tick, int64_t tp, bool act,
                             int32_t delivered) const {
    if (tm.leader()) {
      int64_t* sp = A.g.split + (int64_t)hh * 3;
      sp[0] = tick;
      sp[1] = tp;
      sp[2] = (int64_t)act | ((int64_t)delivered << 1);
    }
  }
  __device__ void unpark_split(int hh, int64_t& tick, int64_t& tp, bool& act,
                               int32_t& delivered) const {
    const int64_t* sp = A.g.split + (int64_t)hh * 3;
    tick = sp[0];
    tp = sp[1];
    act = (sp[2] & 1) != 0;
    delivered = (int32_t)(sp[2] >> 1);
  }
};

template <bool Buf, int Cong>
__global__ void __launch_bounds__(kBlock, 2) k_window_tcp(WindowArgs a) {
  WarpDesign dz(a);
  window_tcp<BulkTick, Buf, Cong>(a, dz);
}

template <bool Buf, int Cong>
__global__ void __launch_bounds__(kBlock, 2) k_window_tgen(WindowArgs a) {
  WarpDesign dz(a);
  window_tcp<TgenTick, Buf, Cong>(a, dz);
}

// ---------------------------------------------------------------------------
// The resident tgen kernel (k_window_tgen_res): window_tcp<TgenTick> on
// one block of kResBlock threads per host (block hh runs host hh; the
// grid is h blocks, all resident), with the host's hot state in shared
// memory for the whole launch -- its record (dynamic shared memory,
// res_record_bytes):
//   * its socket table, every field of Sock for its S slots, SoA in the
//     table's own dtypes (S1_SOCK_FIELDS, TcpArgs order), loaded once at
//     the launch's start and stored back at its end: within a launch no
//     other host reads a host's sockets (tgen_server reads its peers' app
//     registers, and the exchange only the pool and the inbox slabs);
//   * its inbox slab's stage words and each live slot's (time, key), the
//     columns every walk compares (CachedRows), loaded after each window's
//     exchange and the stage words stored back at the window's close, for
//     the next exchange; the loopback insert writes its row to the inbox
//     and its (time, key) to the copy;
//   * its emission lanes.
// The shared functions run unchanged on it: the block's copy of the
// arguments (`A`, shared) points the socket table's fields, the slab's
// stage words and the emission lanes at the record, offset by the host's
// first row so that the usual flat indexes land in it (generic addresses,
// which resolve to shared memory).  The team is the whole block (Cta):
// every walk -- the enqueue, each round's pick, the socket match, the
// timer pick, transmit's eligibility, the free-slot counts, the staging
// cursor, the drain pick, the scans -- strides kResBlock threads and ends
// in a block reduction; the serial TCP machine runs on uniform values in
// every thread, its reads from shared memory, and the leader writes.  A
// host's receive state and its arrival stay in registers across the gate
// barriers, and its tick, t_post and counts across the client/server
// barrier (ResDesign), so neither scratch record of the warp design is
// used.  The grid barriers are the warp design's: the exchange's, the
// open's fold, the rx_batch gates, the client/server split, the step
// close and the window close; thread 0 holds the host's partials, so it
// publishes them with no block fold (`Held`).  The block takes
// __launch_bounds__(kResBlock, 1): one block per SM, every register the
// serial path wants.  The wrapper picks this kernel by the world's shape
// (megakernel.window_tgen_resident): h blocks resident and the record
// within the shared memory a block may opt into.
// ---------------------------------------------------------------------------

// Threads a block of k_window_tgen_res; -DS1_RES_BLOCK builds another
// width.  Timed on the same inputs (window_ab.py widths, PERF.md): 32
// matches 128 on the tgen world's 32-slot slabs but takes 1.7x its time
// on examples/tgen-100host's 3,200-slot ones; 256 is 4 % faster there and
// 15 % slower on the tgen world.
#ifndef S1_RES_BLOCK
#define S1_RES_BLOCK 128
#endif
constexpr int kResBlock = S1_RES_BLOCK;

// The socket table's fields (TcpArgs and megakernel.py _TCP_SOCK_FIELDS
// order): dtype, name, words per slot.
#define S1_SOCK_FIELDS(X)                                                   \
  X(int32_t, stype, 1) X(int32_t, tcp_state, 1) X(int32_t, local_port, 1)   \
  X(int32_t, peer_host, 1) X(int32_t, peer_port, 1) X(int32_t, parent, 1)   \
  X(uint8_t, accepted, 1) X(int64_t, child_order, 1) X(int32_t, backlog, 1) \
  X(int64_t, snd_una, 1) X(int64_t, snd_nxt, 1) X(int64_t, snd_end, 1)      \
  X(int32_t, snd_wnd, 1) X(int32_t, snd_buf_cap, 1) X(int32_t, cwnd, 1)     \
  X(int32_t, ssthresh, 1) X(int32_t, dup_acks, 1) X(int64_t, recover, 1)    \
  X(uint8_t, in_recovery, 1) X(int64_t, retrans_nxt, 1)                     \
  X(int64_t, retrans_end, 1) X(uint8_t, app_closed, 1)                      \
  X(int64_t, rcv_nxt, 1) X(int64_t, rcv_read, 1) X(int32_t, rcv_buf_cap, 1) \
  X(int64_t, sack_lo, SACK_RANGES) X(int64_t, sack_hi, SACK_RANGES)         \
  X(int64_t, fin_seq, 1) X(int64_t, ts_recent, 1) X(int64_t, srtt, 1)       \
  X(int64_t, rttvar, 1) X(int64_t, rto, 1) X(int64_t, t_rto, 1)             \
  X(int64_t, t_delack, 1) X(int64_t, t_tw, 1) X(int64_t, t_persist, 1)      \
  X(int32_t, delack_pending, 1) X(int64_t, at_bytes, 1)                     \
  X(int64_t, at_last, 1) X(int64_t, cub_epoch, 1) X(int32_t, cub_wmax, 1)   \
  X(int64_t, ssack_lo, SSACK_RANGES) X(int64_t, ssack_hi, SSACK_RANGES)     \
  X(int32_t, retx_segs, 1) X(int32_t, error, 1) X(int64_t, bytes_sent, 1)   \
  X(int64_t, bytes_recv, 1)

// An array of the record: `n` bytes rounded up to 16.
__host__ __device__ inline int64_t res_span(int64_t n) {
  return (n + 15) & ~(int64_t)15;
}

// The socket table's part of a host's record.
__host__ __device__ inline int64_t res_sock_bytes(int slots) {
  int64_t b = 0;
#define S1_X(T, name, R) b += res_span((int64_t)slots * (R) * sizeof(T));
  S1_SOCK_FIELDS(S1_X)
#undef S1_X
  return b;
}

// Bytes of a host's record: the sockets, then the slab's stage words,
// arrival times and keys, then the emission lanes' valid flags and rows
// (megakernel.py resident_record_bytes, which the launch checks).
__host__ __device__ inline int64_t res_record_bytes(int slots, int ki, int e,
                                                    int pc) {
  return res_sock_bytes(slots) + res_span(4LL * ki) + 2 * res_span(8LL * ki) +
         res_span(e) + res_span(4LL * e * pc);
}

// n elements from src to dst, strided over the block's threads.
template <class T>
__device__ __forceinline__ void res_copy(T* dst, const T* src, int64_t n) {
  for (int64_t i = threadIdx.x; i < n; i += kResBlock) dst[i] = src[i];
}

// The resident design: host hh on the whole block, its rows' (time, key)
// from the record, its carries in registers (a design of window_tcp and
// a host policy of deliver_tcp_rounds).  `a` is the kernel's arguments,
// `A` the block's copy pointed at the record.  The window open runs
// ex_run, then the host's drop accounting on thread 0, copies the slab's
// stage words and live (time, key) into the record and scans the host
// there; the window close stores the stage words back.  The trace is
// thread 0 of block a.clk_host.
struct ResDesign {
  using Team = Cta<kResBlock>;
  static constexpr int Threads = kResBlock;
  static constexpr bool kHeld = true;
  Team tm{};
  CachedRows rows;
  const WindowArgs& a;
  const WindowArgs& A;
  int hh;
  RxCarry c;                           // across the gates
  Arrival ar;
  int64_t s_tick, s_tp;                // across the client/server barrier
  bool s_act;
  int32_t s_delivered;
  __device__ ResDesign(const WindowArgs& a_, const WindowArgs& A_,
                       CachedRows rows_)
      : rows(rows_), a(a_), A(A_), hh((int)blockIdx.x) {}
  __device__ bool traced() const {
    return hh == a.clk_host && threadIdx.x == 0;
  }
  template <class F>
  __device__ void each(const F& f) const {
    f(hh);
  }
  __device__ void park(int, const RxCarry& c_, const Arrival& ar_) {
    c = c_;
    ar = ar_;
  }
  __device__ void unpark(int, RxCarry& c_, Arrival& ar_) const {
    c_ = c;
    ar_ = ar;
  }
  __device__ void park_split(int, int64_t tick, int64_t tp, bool act,
                             int32_t delivered) {
    s_tick = tick;
    s_tp = tp;
    s_act = act;
    s_delivered = delivered;
  }
  __device__ void unpark_split(int, int64_t& tick, int64_t& tp, bool& act,
                               int32_t& delivered) const {
    tick = s_tick;
    tp = s_tp;
    act = s_act;
    delivered = s_delivered;
  }
  template <class Tick>
  __device__ int64_t open(cg::grid_group& grid, int& buf, int64_t now,
                          int64_t& we, Clk& clk) {
    ex_run<Threads>(a.x, grid, clk);
    grid.sync();
    HostOut o{INV, 0, 0};
    if (threadIdx.x == 0) o.err = open_drops(a, hh);
    const int ki = a.d.ki;
    const int64_t ibase = (int64_t)hh * ki;
    for (int k = threadIdx.x; k < ki; k += Threads) {
      const int32_t st = a.d.ib_stage[ibase + k];
      A.d.ib_stage[ibase + k] = st;
      if (st != STAGE_FREE) {
        const int32_t* row = a.d.ib_blk + (ibase + k) * a.d.ic;
        rows.put(ibase + k, row_time(row), row_key(row));
      }
    }
    __syncthreads();
    o.th = scan_host(A.t, tm, hh, Tick::aux(A, tm, hh),
                     a.t.cpu_ns_per_event[hh], a.t.cpu_avail[hh], rows);
    if (tm.leader()) a.t_h[hh] = o.th;
    return open_bounds<Threads, true>(a, grid, buf, o, now, we);
  }
  __device__ void close() const {
    const int ki = a.d.ki;
    const int64_t ibase = (int64_t)hh * ki;
    for (int k = threadIdx.x; k < ki; k += Threads)
      a.d.ib_stage[ibase + k] = A.d.ib_stage[ibase + k];
  }
};

template <bool Buf, int Cong>
__global__ void __launch_bounds__(kResBlock, 1)
    k_window_tgen_res(WindowArgs a) {
  extern __shared__ __align__(16) unsigned char rec[];
  __shared__ WindowArgs A;             // `a` with the record's pointers
  const int hh = blockIdx.x;
  const int S = a.tcp.slots, ki = a.d.ki, e = a.t.e, pc = a.t.pc;
  const int64_t sbase = (int64_t)hh * S, ibase = (int64_t)hh * ki;
  unsigned char* const slab = rec + res_sock_bytes(S);
  if (threadIdx.x == 0) {
    A = a;
    unsigned char* p = rec;
#define S1_X(T, name, R)                      \
  A.tcp.name = (T*)p - sbase * (R);           \
  p += res_span((int64_t)S * (R) * sizeof(T));
    S1_SOCK_FIELDS(S1_X)
#undef S1_X
    int32_t* const stage = (int32_t*)slab - ibase;
    A.d.ib_stage = stage;
    A.t.ib_stage = stage;
    unsigned char* const lanes = slab + res_span(4LL * ki) +
                                 2 * res_span(8LL * ki);
    uint8_t* const ev = lanes - (int64_t)hh * e;
    int32_t* const eb = (int32_t*)(lanes + res_span(e)) -
                        (int64_t)hh * e * pc;
    A.tcp.em_valid = ev;
    A.t.em_valid = ev;
    A.tcp.em_blk = eb;
    A.t.em_blk = eb;
  }
  __syncthreads();
  // The host's sockets into the record.
#define S1_X(T, name, R) \
  res_copy(A.tcp.name + sbase * (R), a.tcp.name + sbase * (R), (int64_t)S * (R));
  S1_SOCK_FIELDS(S1_X)
#undef S1_X
  __syncthreads();
  const CachedRows rows{(int64_t*)(slab + res_span(4LL * ki)) - ibase,
                        (int64_t*)(slab + res_span(4LL * ki) +
                                   res_span(8LL * ki)) - ibase};
  ResDesign dz(a, A, rows);
  window_tcp<TgenTick, Buf, Cong>(a, dz);
  // The host's sockets back to the table.
#define S1_X(T, name, R) \
  res_copy(a.tcp.name + sbase * (R), A.tcp.name + sbase * (R), (int64_t)S * (R));
  S1_SOCK_FIELDS(S1_X)
#undef S1_X
}

template <bool Buf, int Cong>
const void* window_tcp_fn(int kernel) {
  return kernel == 2 ? (const void*)k_window_tgen<Buf, Cong>
                     : (const void*)k_window_tcp<Buf, Cong>;
}

}  // namespace

// K_WINDOW's kernel by the wrapper's index -- k_window (phold), then the
// TCP kernels k_window_tcp (bulk) and k_window_tgen (tgen) -- in the
// instantiation of the world's interface buffers and, the TCP kernels,
// congestion control.  The phase-clock build (S1_PHASE_CLOCKS, for
// chip_smoke.py's phase traces) carries the TCP kernels for Reno without
// buffers only; null for an instantiation the library does not hold.
static const void* window_kernel_fn(int kernel, bool buf, int cong) {
  if (kernel == 0)
    return buf ? (const void*)k_window<true> : (const void*)k_window<false>;
#ifdef S1_PHASE_CLOCKS
  return buf || cong != CONG_RENO ? nullptr
                                  : window_tcp_fn<false, CONG_RENO>(kernel);
#else
  if (cong == CONG_CUBIC)
    return buf ? window_tcp_fn<true, CONG_CUBIC>(kernel)
               : window_tcp_fn<false, CONG_CUBIC>(kernel);
  return buf ? window_tcp_fn<true, CONG_RENO>(kernel)
             : window_tcp_fn<false, CONG_RENO>(kernel);
#endif
}

// Blocks per SM of K_WINDOW's kernel `kernel` in instantiation (buf,
// cong) (window_kernel_fn) and the card's SM count: the wrapper sizes the
// cooperative grid from them.  Returns a CUDA error code, or -1 when the
// device cannot launch cooperative kernels or the kernel does not fit on
// an SM.
extern "C" int window_occupancy(int kernel, int buf, int cong, int* per_sm,
                                int* sms) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  const void* fn = window_kernel_fn(kernel, buf != 0, cong);
  if (fn == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, fn, kernel ? kBlock : kWinBlock, 0);
  if (e != cudaSuccess) return (int)e;
  return (!coop || *per_sm < 1) ? -1 : 0;
}

extern "C" int window_launch(const WindowArgs* args, void* stream) {
  void* params[] = {(void*)args};
  const void* fn = window_kernel_fn(0, args->d.has_iface_buf != 0, 0);
  if (fn == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  return (int)cudaLaunchCooperativeKernel(fn, dim3(args->n_blocks),
                                          dim3(kWinBlock), params, 0,
                                          (cudaStream_t)stream);
}

// The TCP kernels: `kernel` 1 (k_window_tcp) or 2 (k_window_tgen).
extern "C" int window_tcp_launch(const WindowArgs* args, int kernel,
                                 void* stream) {
  void* params[] = {(void*)args};
  const void* fn =
      window_kernel_fn(kernel, args->d.has_iface_buf != 0, args->tcp.cong);
  if (fn == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  return (int)cudaLaunchCooperativeKernel(fn, dim3(args->n_blocks),
                                          dim3(kBlock),
                                          params, 0, (cudaStream_t)stream);
}

// The resident tgen kernel in instantiation (buf, cong); the phase-clock
// build carries Reno without buffers only (null otherwise).
static const void* window_res_fn(bool buf, int cong) {
#ifdef S1_PHASE_CLOCKS
  return buf || cong != CONG_RENO
             ? nullptr
             : (const void*)k_window_tgen_res<false, CONG_RENO>;
#else
  if (cong == CONG_CUBIC)
    return buf ? (const void*)k_window_tgen_res<true, CONG_CUBIC>
               : (const void*)k_window_tgen_res<false, CONG_CUBIC>;
  return buf ? (const void*)k_window_tgen_res<true, CONG_RENO>
             : (const void*)k_window_tgen_res<false, CONG_RENO>;
#endif
}

// The resident tgen kernel's fit for a record of `bytes`: its static
// shared bytes, the shared memory a block may opt into, and, when the two
// fit together, the blocks per SM with that much dynamic shared memory
// (after raising the kernel's dynamic limit to it; 0 when they do not
// fit), and the card's SM count.  Returns a CUDA error code, or -1 when
// the device cannot launch cooperative kernels.
extern "C" int window_res_occupancy(int buf, int cong, int64_t bytes,
                                    int* per_sm, int* sms, int* static_bytes,
                                    int* optin) {
  int dev = 0, coop = 0;
  *per_sm = 0;
  const void* fn = window_res_fn(buf != 0, cong);
  if (fn == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  cudaFuncAttributes at;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&at, fn);
  if (e != cudaSuccess) return (int)e;
  *static_bytes = (int)at.sharedSizeBytes;
  if (!coop) return -1;
  if (bytes + (int64_t)at.sharedSizeBytes > (int64_t)*optin) return 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kResBlock,
                                                      (size_t)bytes);
  return (int)e;
}

// The resident tgen kernel on one block per host (args->n_blocks = h) with
// a record of `bytes` as its dynamic shared memory: refused unless
// `bytes` is res_record_bytes of the arguments' shapes.  The kernel's
// dynamic shared-memory limit is a property of the function, which every
// world of an instantiation shares (window_res_occupancy sets it to the
// record it was asked about), so each launch sets it to its own record.
extern "C" int window_res_launch(const WindowArgs* args, int64_t bytes,
                                 void* stream) {
  void* params[] = {(void*)args};
  const void* fn = window_res_fn(args->d.has_iface_buf != 0, args->tcp.cong);
  if (fn == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  if (bytes != res_record_bytes(args->tcp.slots, args->d.ki, args->t.e,
                                args->t.pc))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaLaunchCooperativeKernel(fn, dim3(args->n_blocks),
                                          dim3(kResBlock), params,
                                          (size_t)bytes,
                                          (cudaStream_t)stream);
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

// The device f32 cbrt of CUBIC's window target (xla_cbrt.cuh cbrt_xla) over
// a vector, for chip_smoke.py's check against xlamath.cbrt.
namespace {
__global__ void k_cbrt_probe(const float* x, float* y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = cbrt_xla(x[i]);
}
}  // namespace

extern "C" int cbrt_probe_launch(const float* x, float* y, int64_t n,
                                 void* stream) {
  const int tb = 256;
  k_cbrt_probe<<<(unsigned)((n + tb - 1) / tb), tb, 0,
                 (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

// CUBIC's window target and hooks (tcp.cuh cubic_target, cong_new_ack,
// cong_enter_recovery, cong_timeout) over vectors of socket registers, for
// chip_smoke.py's check against transport/cong.py.  `kind` 0 writes the
// target; 1-3 run the new-ACK, fast-recovery or RTO hook where `mask` is
// set (the new ACK with `acked` there, 0 elsewhere) and write the five
// registers back in place.
namespace {
__global__ void k_cong_probe(int kind, int32_t* cwnd, int32_t* ssthresh,
                             int64_t* cub_epoch, int32_t* cub_wmax,
                             int64_t* srtt, const int64_t* tick,
                             const int32_t* acked, const int32_t* flight,
                             const bool* mask, int32_t* target, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Sock v{};
  v.cwnd = cwnd[i];
  v.ssthresh = ssthresh[i];
  v.cub_epoch = cub_epoch[i];
  v.cub_wmax = cub_wmax[i];
  v.srtt = srtt[i];
  const bool m = mask[i];
  if (kind == 0) {
    target[i] = cubic_target(v, tick[i]);
    return;
  }
  if (kind == 1)
    cong_new_ack<CONG_CUBIC>(v, m, m ? acked[i] : 0, tick[i]);
  else if (m && kind == 2)
    cong_enter_recovery<CONG_CUBIC>(v, flight[i]);
  else if (m)
    cong_timeout<CONG_CUBIC>(v, flight[i]);
  cwnd[i] = v.cwnd;
  ssthresh[i] = v.ssthresh;
  cub_epoch[i] = v.cub_epoch;
  cub_wmax[i] = v.cub_wmax;
  srtt[i] = v.srtt;
}
}  // namespace

extern "C" int cong_probe_launch(int kind, int32_t* cwnd, int32_t* ssthresh,
                                 int64_t* cub_epoch, int32_t* cub_wmax,
                                 int64_t* srtt, const int64_t* tick,
                                 const int32_t* acked, const int32_t* flight,
                                 const bool* mask, int32_t* target,
                                 int64_t n, void* stream) {
  const int tb = 256;
  k_cong_probe<<<(unsigned)((n + tb - 1) / tb), tb, 0,
                 (cudaStream_t)stream>>>(kind, cwnd, ssthresh, cub_epoch,
                                         cub_wmax, srtt, tick, acked, flight,
                                         mask, target, n);
  return (int)cudaGetLastError();
}
