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
// Design: one thread per host running transport_host with the Solo team
// (transport.cuh, which K_WINDOW shares; its TCP kernel runs it on a
// warp per host).  Cross-host outputs -- the event sum, the
// error OR and the min of th -- are reduced per block by a fixed
// shared-memory tree, then a one-thread pass folds the per-block
// partials in block order into gmin and the state's n_events / n_steps /
// err scalars.
//
// What bounds it on the H100: bytes.  Per launch it must read every
// host's emission valid flags, outbox slab stages and inbox slab (the
// post-step scan), the valid emission rows and the route_blk entries they
// gather, and write the placed rows (72 B each) and the changed host
// fields -- about 1.8 MB at the bench world's mid-window step
// (chip_smoke.py transport_bytes counts it), ~0.5 us of HBM time.  The
// emission rows are read with a per-host stride, so the reads are
// uncoalesced; a later PR can stage them through shared memory.  In TCP
// worlds each active host's thread also scans its sockets' eligibility
// columns twice and every host its sockets' four timers; at the bulk
// world (204 sockets, 3,200-slot slabs) those per-thread scans set the
// kernel's time.
#include "transport.cuh"

using namespace s1;

namespace {

__global__ void k_transport(TransportArgs a, TcpArgs t, int tcp_on) {
  const int hh = blockIdx.x * kBlock + threadIdx.x;
  HostOut o{INV, 0, 0};
  if (hh < a.h) {
    Clk clk = make_clk(nullptr, false);
    o = transport_host(a, Solo{}, tcp_on ? &t : nullptr, hh, a.tick_t[hh],
                       a.t_post[hh], a.active[hh] != 0, a.delivered_n[hh],
                       a.t_app[hh], clk);
    a.th[hh] = o.th;
  }
  const HostOut b = block_reduce(o);
  if (threadIdx.x == 0) {
    a.blk_ev[blockIdx.x] = b.events;
    a.blk_min[blockIdx.x] = b.th;
    a.blk_err[blockIdx.x] = b.err;
  }
}

// Folds the per-block partials in block order into the run's scalars.
__global__ void k_reduce(TransportArgs a) {
  if (threadIdx.x != 0) return;
  int64_t ev = 0, mn = INV;
  int32_t er = 0;
  for (int b = 0; b < a.n_blocks; ++b) {
    ev += a.blk_ev[b];
    mn = imin(mn, a.blk_min[b]);
    er |= a.blk_err[b];
  }
  *a.n_events += ev;
  *a.n_steps += 1;
  *a.err |= er;
  *a.gmin = mn;
}

}  // namespace

// `tcp` is null in UDP worlds.
extern "C" int transport_launch(const TransportArgs* args,
                                const TcpArgs* tcp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  TcpArgs t{};
  if (tcp != nullptr) t = *tcp;
  k_transport<<<args->n_blocks, kBlock, 0, st>>>(*args, t, tcp != nullptr);
  k_reduce<<<1, 32, 0, st>>>(*args);
  return (int)cudaGetLastError();
}
