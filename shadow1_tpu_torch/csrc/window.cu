// K_WINDOW: one whole conservative window as one cooperative kernel.
//
// Replaces the TPU kernel K_WINDOW (shadow1_tpu/core/megakernel.py,
// window_fused, launched through _call_full, pallas_call at line 374),
// whose body is shadow1_tpu/core/engine.py _window_body_ref: the
// boundary exchange, the per-window scan, the window bounds
// ws = max(now, gmin) and we = min(ws + min_latency, t_target), the
// micro-step loop `while gmin < we` (K_DELIVER's body, the app tick,
// K_TRANSPORT's body), then the window close (now = we, n_windows + 1).
// It also emits the earliest outbox arrival still awaiting the next
// exchange (engine._outbox_pending), so the host's window loop reads one
// small vector per window and nothing per micro-step.  UDP worlds, phold
// tick only (phold_tick.cuh).
//
// Design.  Within a window every phase is row-local over hosts (the
// megakernel's blocking contract): the only cross-host values are the
// exchange, gmin, the event count and the error bits.  So one grid of
// resident blocks (cudaLaunchCooperativeKernel; the wrapper sizes it from
// the occupancy query, never from H) walks hosts and pool rows with
// grid-stride loops, and grid-wide barriers (cooperative_groups
// this_grid().sync()) separate what must be ordered:
//   * the exchange's four passes (exchange.cuh), the per-destination
//     pass followed by that host's scan (transport.cuh scan_host);
//   * each micro-step: every host runs deliver_host -> phold_tick ->
//     transport_host in one thread (the staging rows go through a
//     scratch tensor, written and read by that thread only), then each
//     block folds its (th min, event sum, error OR) by a fixed tree and
//     publishes it; after one grid sync every block folds all partials in
//     block order, so every block computes the same gmin and the loop
//     predicate is uniform.  Partials are double-buffered by step parity,
//     so one barrier per micro-step suffices;
//   * the window close: the outbox-pending min over the pool, folded by
//     block 0, which writes the state scalars and the result vector.
// Integer min/sum/OR do not depend on order, so the results equal the
// reference's.  The loop carries a step cap from the wrapper, far above
// any real window: past it the kernel sets a status word and exits, so a
// wrong predicate fails the run instead of hanging the card.
//
// What bounds it on the H100: bytes.  Per window it must move what the
// exchange, each micro-step's three phases and the tick touch -- the
// pool's stage column, the movers' rows, each active host's slabs, host
// row, socket ring and app state, and the rows staged -- a few MB at the
// bench world (chip_smoke.py counts it per window from the run's data),
// a few microseconds of HBM time.  One thread per host and the
// serialising grid barriers dominate.
#include <cooperative_groups.h>

#include "exchange.cuh"
#include "phold_tick.cuh"
#include "transport.cuh"

namespace cg = cooperative_groups;
using namespace s1;

// Mirrored field for field by the ctypes.Structure in
// shadow1_tpu_torch/core/megakernel.py.  In `d` and `t` the per-phase
// kernels' per-host inputs and outputs are unused (null); `t.em_valid` /
// `t.em_blk` point at the staging scratch below.
struct WindowArgs {
  ExchangeArgs x;
  DeliverArgs d;
  TransportArgs t;
  PholdArgs p;
  int64_t* t_h;        // [h] out: per-host next event time
  int64_t* part_min;   // [2 * n_blocks] block partials, by step parity
  int64_t* part_ev;    // [2 * n_blocks]
  int32_t* part_err;   // [2 * n_blocks]
  int64_t* now;        // state scalars
  int64_t* n_windows;
  int64_t* win;        // [5] out: gmin, ws, we, outbox pending, status
  uint8_t* em_valid;   // [h * e] staging scratch
  int32_t* em_blk;     // [h * e * pc]
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

__device__ __forceinline__ int64_t app_next(const PholdArgs& p, int hh) {
  return p.pending[hh] > 0 ? p.next_send[hh] : INV;
}

__global__ void __launch_bounds__(kBlock) k_window(WindowArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int h = a.x.h;
  const int e = a.t.e, pc = a.t.pc;
  const int64_t gtid = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kBlock;

  // ---- boundary exchange ------------------------------------------------
  for (int64_t d = gtid; d < h; d += gstride) {
    a.x.cnt[d] = 0;
    a.x.fill[d] = 0;
  }
  grid.sync();
  for (int64_t i = gtid; i < a.x.p0; i += gstride) ex_count_row(a.x, i);
  grid.sync();
  if (blockIdx.x == 0) ex_scan_block(a.x);
  grid.sync();
  for (int64_t i = gtid; i < a.x.p0; i += gstride) ex_bucket_row(a.x, i);
  grid.sync();
  // Placement, the exchange's drop accounting, then the host's scan.
  HostOut o{INV, 0, 0};
  for (int64_t dd = gtid; dd < h; dd += gstride) {
    const int d = (int)dd;
    int32_t total, total_prot, n_free;
    ex_place_dest(a.x, d, total, total_prot, n_free);
    if (total > n_free) {
      a.t.pkts_dropped_pool[d] += total - n_free;
      o.err |= ERR_POOL_OVERFLOW;
    }
    const int64_t aux = imin(a.t.t_resume[d], app_next(a.p, d));
    const int64_t th = scan_host(a.t, d, aux, a.t.cpu_ns_per_event[d],
                                 a.t.cpu_avail[d]);
    a.t_h[d] = th;
    o.th = imin(o.th, th);
  }
  publish(a, 0, block_reduce(o));
  grid.sync();
  HostOut g = fold(a, 0);
  int64_t gmin = g.th;
  const int64_t ws = imax(*a.now, gmin);
  const int64_t we = imin(ws + a.min_latency, a.t_target);
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.t.err |= g.err;

  // ---- micro-steps ------------------------------------------------------
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
      const int64_t aux0 = imin(a.d.t_resume[hh], app_next(a.p, hh));
      int32_t no_tcp_err = 0;
      const DeliverOut dl = deliver_host(a.d, nullptr, NoGate{}, hh, true,
                                         tick, act, aux0, we, no_tcp_err);
      phold_tick(a.p, a.d, hh, dl.t_post, act, we,
                 a.em_valid + (int64_t)hh * e,
                 a.em_blk + (int64_t)hh * e * pc, e, pc);
      const HostOut t = transport_host(a.t, nullptr, hh, tick, dl.t_post,
                                       act, dl.delivered, app_next(a.p, hh));
      a.t_h[hh] = t.th;
      s.th = imin(s.th, t.th);
      s.events += t.events;
      s.err |= t.err;
    }
    publish(a, buf, block_reduce(s));
    grid.sync();
    g = fold(a, buf);
    gmin = g.th;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *a.t.n_events += g.events;
      *a.t.n_steps += 1;
      *a.t.err |= g.err;
    }
    ++steps;
  }

  // ---- window close: outbox pending, state scalars, result vector -------
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

}  // namespace

// Blocks of the cooperative grid for h hosts: one thread per host, at
// most what the card holds resident at once.  Returns a CUDA error code,
// or -1 when the device cannot launch cooperative kernels.
extern "C" int window_grid(int h, int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_window,
                                                      kBlock, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return -1;
  const int need = (h + kBlock - 1) / kBlock;
  *grid = need < per_sm * sms ? need : per_sm * sms;
  return 0;
}

extern "C" int window_launch(const WindowArgs* args, void* stream) {
  void* params[] = {(void*)args};
  return (int)cudaLaunchCooperativeKernel((const void*)k_window,
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
