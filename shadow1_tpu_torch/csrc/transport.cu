// K_TRANSPORT: one micro-step's send phase and post-step scan, every host.
//
// Replaces the TPU kernel K_TRANSPORT (shadow1_tpu/core/megakernel.py,
// microstep_fused.k_transport launched through _call_blocked, pallas_call
// at line 220).  Its body is shadow1_tpu/transport/tcp.py transmit (TCP
// worlds: one socket per host, up to TX_SLOTS segments into the emission
// lanes; tcp.cuh), then shadow1_tpu/core/engine.py
// _stage_emissions (pkt_id assignment, route_blk lookup, keyed loss draw,
// merge into free outbox slots either IN_FLIGHT or parked TX_QUEUED under
// the tx token bucket), _tx_drain_body (one parked departure per host),
// the virtual-CPU accounting, and the post-step scan (_scan_all on the
// host's slab plus the app wake time carried in and, in TCP worlds, the
// host's earliest socket timer) giving th[h].
//
// Design.  UDP worlds (k_transport): one thread per host running
// transport_host with the Solo team (transport.cuh, which K_WINDOW
// shares).  TCP worlds (k_transport_tcp): one warp per host running the
// same function on the Warp team, as K_WINDOW's TCP kernel does: the
// host's walks -- transmit's two eligibility passes over its sockets, the
// free-slot count, the staging cursor, the drain's pick, the timer scan
// and the post-step scan -- stride the 32 lanes (coalesced loads) and end
// in warp reductions; the TCP machine runs on uniform values and the
// leader lane writes.  Transmit has no grid-wide gate (unlike
// process_arrivals), so a plain launch of ceil(h / 8) blocks of 256
// threads covers any host count, one warp per host (the wrapper computes
// the block count, core/megakernel.py _transport_blocks).  Cross-host
// outputs -- the event sum (the leader lane counts its host), the error
// OR and the min of th -- are reduced per block by a fixed shared-memory
// tree; then one block folds the per-block partials (each thread a
// strided subset in block order, then the same tree) into gmin and the
// state's n_events / n_steps / err scalars.  Integer sums, mins and ORs
// do not depend on order, and no atomic takes part.
//
// What bounds it on the H100: bytes.  Per launch it must read every
// host's emission valid flags, outbox slab stages and inbox slab (the
// post-step scan), the valid emission rows and the route_blk entries they
// gather, and write the placed rows (72 B each) and the changed host
// fields -- about 1.8 MB at the bench world's mid-window step
// (chip_smoke.py transport_bytes counts it), ~0.5 us of HBM time.  The
// emission rows are read with a per-host stride, so the reads are
// uncoalesced; a later PR can stage them through shared memory.  In TCP
// worlds each active host also walks its sockets' eligibility columns
// twice and every host its sockets' four timers: at the bulk world (204
// sockets, 3,200-slot slabs) a warp takes those walks in a few dozen
// coalesced steps, where one thread took hundreds of dependent loads.
#include "transport.cuh"

using namespace s1;

namespace {

__device__ __forceinline__ void store_partials(const TransportArgs& a,
                                               const HostOut& o) {
  const HostOut b = block_reduce(o);
  if (threadIdx.x == 0) {
    a.blk_ev[blockIdx.x] = b.events;
    a.blk_min[blockIdx.x] = b.th;
    a.blk_err[blockIdx.x] = b.err;
  }
}

__global__ void __launch_bounds__(kBlock) k_transport(TransportArgs a) {
  const int hh = blockIdx.x * kBlock + threadIdx.x;
  HostOut o{INV, 0, 0};
  if (hh < a.h) {
    Clk clk = make_clk(nullptr, false);
    o = transport_host(a, Solo{}, nullptr, hh, a.tick_t[hh], a.t_post[hh],
                       a.active[hh] != 0, a.delivered_n[hh], a.t_app[hh],
                       clk);
    a.th[hh] = o.th;
  }
  store_partials(a, o);
}

__global__ void __launch_bounds__(kBlock, 2)
    k_transport_tcp(TransportArgs a, TcpArgs t) {
  const Warp tm{};
  const int64_t nw = (int64_t)gridDim.x * kBlock / Warp::W;
  Clk clk = make_clk(nullptr, false);
  HostOut o{INV, 0, 0};
  for (int64_t i = ((int64_t)blockIdx.x * kBlock + threadIdx.x) / Warp::W;
       i < a.h; i += nw) {
    const int hh = (int)i;
    const HostOut r = transport_host(a, tm, &t, hh, a.tick_t[hh],
                                     a.t_post[hh], a.active[hh] != 0,
                                     a.delivered_n[hh], a.t_app[hh], clk);
    if (tm.leader()) {
      a.th[hh] = r.th;
      o.events += r.events;
    }
    o.th = imin(o.th, r.th);
    o.err |= r.err;
  }
  store_partials(a, o);
}

// Folds the per-block partials into the run's scalars: thread i takes
// partials i, i + kBlock, ... in order, then the block's fixed tree.
__global__ void __launch_bounds__(kBlock) k_reduce(TransportArgs a) {
  HostOut o{INV, 0, 0};
  for (int b = threadIdx.x; b < a.n_blocks; b += kBlock) {
    o.events += a.blk_ev[b];
    o.th = imin(o.th, a.blk_min[b]);
    o.err |= a.blk_err[b];
  }
  const HostOut r = block_reduce(o);
  if (threadIdx.x == 0) {
    *a.n_events += r.events;
    *a.n_steps += 1;
    *a.err |= r.err;
    *a.gmin = r.th;
  }
}

}  // namespace

// `tcp` is null in UDP worlds.  The grid is args->n_blocks blocks: one
// thread per host (UDP), one warp per host (TCP).
extern "C" int transport_launch(const TransportArgs* args,
                                const TcpArgs* tcp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tcp == nullptr)
    k_transport<<<args->n_blocks, kBlock, 0, st>>>(*args);
  else
    k_transport_tcp<<<args->n_blocks, kBlock, 0, st>>>(*args, *tcp);
  k_reduce<<<1, kBlock, 0, st>>>(*args);
  return (int)cudaGetLastError();
}
