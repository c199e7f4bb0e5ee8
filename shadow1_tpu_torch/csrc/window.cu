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
//     re-rank in TCP worlds), the per-destination pass followed by that
//     host's scan (transport.cuh scan_host);
//   * each micro-step: every host runs its phases in one thread (the
//     staging rows go through a scratch tensor, written and read by that
//     thread only), then each block folds its (th min, event sum, error
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
// UDP (k_window): the grid is sized from the occupancy query, never from
// H, and walks hosts with grid-stride loops; a micro-step has no barrier
// inside it.
//
// TCP (k_window_tcp): each delivery round of process_arrivals takes the
// two scoreboard gates OR-ed over the whole grid (GridGate, deliver.cuh),
// a barrier inside the micro-step, and a host's gathered arrival lives in
// registers across it.  So every host has its own resident thread -- one
// thread per host, H <= blocks per SM x 132 SMs x 256 threads; the
// wrapper raises beyond that, naming the limit -- and every thread of the
// grid, host or not, calls deliver_host and its gate once per round from
// the same call site (a thread with no host runs the rounds masked off):
// an aligned barrier reached from divergent call sites hangs the grid.
// The gate words are indexed by step parity and round, [2][rx_batch]:
// a step's words are read right after that round's barrier, all before
// the step's closing barrier, so the words of the other parity are
// zeroed at the start of the next step (after that barrier) and are not
// written again before the closing barrier that follows.  run_timers and
// bulk's tick need no barrier (per-host exact; tcp.cuh, bulk_tick.cuh).
// The socket-overflow bit of a passive open and the pool-overflow bits
// are OR-ed into the step's block partials.  The TCP machine takes ~250
// registers a thread and ~1 KB of stack (ptxas, printed by
// chip_smoke.py), so one block of 256 fits each SM.
//
// What bounds it on the H100: bytes.  Per window it must move what the
// exchange, each micro-step's phases and the tick touch -- the pool's
// stage column, the movers' rows, each active host's slabs, host row,
// sockets and app state, and the rows staged -- a few MB at the bench
// world (chip_smoke.py counts it per window from the run's data), a few
// microseconds of HBM time.  One thread per host and the serialising grid
// barriers dominate; in the bulk world the server's one thread walks its
// 3,200-slot slab and 204 sockets each round and sets the time.
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
  int64_t t_target;
  int64_t min_latency;
  int64_t max_steps;
  int32_t n_blocks;
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
  __device__ static int64_t aux(const WindowArgs& a, int hh) {
    return imin(a.t.t_resume[hh], next(a, hh));
  }
};

struct BulkTick {
  __device__ static int64_t next(const WindowArgs& a, int hh) {
    return bulk_next(a.b, hh);
  }
  __device__ static int64_t aux(const WindowArgs& a, int hh) {
    return imin(imin(a.t.t_resume[hh], timer_min(a.tcp, hh)), next(a, hh));
  }
  __device__ static void tick(const WindowArgs& a, int hh, int64_t tp,
                              bool act) {
    bulk_tick(a.b, a.tcp, hh, tp, act);
  }
};

// The boundary exchange, its drop accounting (pure ACKs shed first in
// TCP worlds: engine._exchange_tail), the per-window scan and the window
// bounds.  Returns gmin; every block gets the same values.
template <class Tick>
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
    const int64_t th = scan_host(a.t, d, Tick::aux(a, d),
                                 a.t.cpu_ns_per_event[d], a.t.cpu_avail[d]);
    a.t_h[d] = th;
    o.th = imin(o.th, th);
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
  int64_t ws, we;
  int64_t gmin = window_open<PholdTick>(a, grid, ws, we);

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
      const int64_t aux0 = PholdTick::aux(a, hh);
      int32_t no_tcp_err = 0;
      const DeliverOut dl = deliver_host(a.d, nullptr, NoGate{}, hh, true,
                                         tick, act, aux0, we, no_tcp_err);
      phold_tick(a.p, a.d, hh, dl.t_post, act, we,
                 a.em_valid + (int64_t)hh * e,
                 a.em_blk + (int64_t)hh * e * pc, e, pc);
      const HostOut t = transport_host(a.t, nullptr, hh, tick, dl.t_post,
                                       act, dl.delivered,
                                       PholdTick::next(a, hh));
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

// The TCP window: one thread per host, every thread through every
// barrier (see the design note above).
template <class Tick>
__device__ __forceinline__ void window_tcp(const WindowArgs& a) {
  cg::grid_group grid = cg::this_grid();
  const int h = a.x.h, e = a.t.e, rb = a.d.rx_batch;
  const int64_t gtid = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kBlock;
  int32_t* const gates = a.tcp.gates;            // [2][rb] by step parity
  for (int64_t i = gtid; i < 2 * rb; i += gstride) gates[i] = 0;
  int64_t ws, we;
  int64_t gmin = window_open<Tick>(a, grid, ws, we);

  const bool valid = gtid < h;
  const int hh = valid ? (int)gtid : 0;
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
    int64_t tick = we, aux0 = INV;
    bool act = false;
    if (valid) {
      // Tick setup: re-arm the resume time of active hosts only; the
      // rx_batch bound is the aux term after the re-arm.
      const int64_t th0 = a.t_h[hh];
      act = th0 < we;
      if (act) {
        tick = th0;
        a.d.t_resume[hh] = INV;
      }
      aux0 = Tick::aux(a, hh);
      for (int j = 0; j < e; ++j) a.tcp.em_valid[(int64_t)hh * e + j] = 0;
    }
    int32_t sock_err = 0;
    const DeliverOut dl = deliver_host(a.d, &a.tcp, GridGate{gates + buf * rb},
                                       hh, valid, tick, act, aux0, we,
                                       sock_err);
    if (valid) {
      tcp_run_timers(a.tcp, hh, dl.t_post, act);
      Tick::tick(a, hh, dl.t_post, act);
      s = transport_host(a.t, &a.tcp, hh, tick, dl.t_post, act, dl.delivered,
                         Tick::next(a, hh));
      a.t_h[hh] = s.th;
      s.err |= sock_err;
    }
    gmin = step_close(a, grid, buf, s);
    ++steps;
  }
  window_close(a, grid, buf, gmin, ws, we, status);
}

__global__ void __launch_bounds__(kBlock, 1) k_window_tcp(WindowArgs a) {
  window_tcp<BulkTick>(a);
}

}  // namespace

namespace {

// Per-SM residency of `kernel` and the SM count (CUDA error code, or -1
// when the device cannot launch cooperative kernels).
int resident(const void* kernel, int* per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kBlock,
                                                      0);
  if (e != cudaSuccess) return (int)e;
  return (!coop || *per_sm < 1) ? -1 : 0;
}

}  // namespace

// Blocks of k_window's cooperative grid for h hosts: one thread per
// host, at most what the card holds resident at once (grid-stride loops
// cover the rest).  Returns a CUDA error code, or -1 when the device
// cannot launch cooperative kernels.
extern "C" int window_grid(int h, int* grid) {
  int per_sm = 0, sms = 0;
  const int rc = resident((const void*)k_window, &per_sm, &sms);
  if (rc != 0) return rc;
  const int need = (h + kBlock - 1) / kBlock;
  *grid = need < per_sm * sms ? need : per_sm * sms;
  return 0;
}

// Blocks of k_window_tcp's grid for h hosts: exactly one thread per host,
// all resident.  `max_hosts` gets the most hosts the card can hold
// (blocks per SM x SMs x kBlock).  Returns a CUDA error code, -1 when the
// device cannot launch cooperative kernels, or -2 when h > max_hosts.
extern "C" int window_tcp_grid(int h, int* grid, int* max_hosts) {
  int per_sm = 0, sms = 0;
  const int rc = resident((const void*)k_window_tcp, &per_sm, &sms);
  if (rc != 0) return rc;
  *max_hosts = per_sm * sms * kBlock;
  *grid = (h + kBlock - 1) / kBlock;
  return *grid > per_sm * sms ? -2 : 0;
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
