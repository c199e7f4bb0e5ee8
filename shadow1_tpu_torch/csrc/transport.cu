// K_TRANSPORT: one micro-step's send phase and post-step scan, every host.
//
// Replaces the TPU kernel K_TRANSPORT (shadow1_tpu/core/megakernel.py,
// microstep_fused.k_transport launched through _call_blocked, pallas_call
// at line 220).  Its body is shadow1_tpu/transport/tcp.py transmit (TCP
// worlds: one socket per host, up to TX_SLOTS segments into the emission
// lanes; tcp.cuh), then shadow1_tpu/core/engine.py
// _stage_emissions (pkt_id assignment, route_blk lookup, keyed loss draw,
// merge into free outbox slots either IN_FLIGHT or parked TX_QUEUED under
// the tx token bucket; with an app that may send to its own host, tgen's,
// the _loopback_insert of same-host segments into the sender's own inbox
// slab, arriving 1 ns later), _tx_drain_body (one parked departure per
// host),
// the virtual-CPU accounting, and the post-step scan (_scan_all on the
// host's slab plus the app wake time carried in and, in TCP worlds, the
// host's earliest socket timer) giving th[h].
//
// Design.  UDP worlds (k_transport): one thread per host in blocks of
// kTrBlock = 128 threads, so the bench world's 16,384 hosts fill 128 of
// the card's 132 SMs (256-thread blocks left half of them idle).  A host's
// work is a chain of dependent loads, and what sets the time is that
// chain's depth: for slabs and emission lanes of at most 8 (the bench
// world) the thread runs transport.cuh transport_small, whose chains of
// dependent loads are at most four deep with every independent load of a
// step in flight at once, and does the rest on registers; larger worlds
// run transport_host on the Solo team.  A team of 4-16 lanes per host,
// tried on the card (PERF.md), ran every host's serial part on every lane
// and was slower.  The block partials are folded in the same launch:
// after a block has published its partials it takes a ticket (an atomic
// count of finished blocks, after a fence), and the block that takes the
// last ticket folds every block's partials in block order by a fixed
// tree into gmin and the state's n_events / n_steps / err, then resets
// the ticket to 0 for the next launch.  Which block folds depends on timing; what it computes does
// not.  TCP worlds (k_transport_tcp): one warp per host running the
// same function on the Warp team, as K_WINDOW's TCP kernel does: the
// host's walks -- transmit's two eligibility passes over its sockets, the
// free-slot count, the staging cursor, the drain's pick, the timer scan
// and the post-step scan -- stride the 32 lanes (coalesced loads) and end
// in warp reductions; the TCP machine runs on uniform values and the
// leader lane writes.  Transmit has no grid-wide gate (unlike
// process_arrivals), so a plain launch of ceil(h / 8) blocks of 256
// threads covers any host count, one warp per host (the wrapper computes
// the block count, core/megakernel.py _transport_blocks), and a second
// launch (k_reduce) folds the block partials.  Cross-host outputs -- the
// event sum (the leader lane counts its host), the error OR and the min
// of th -- are reduced per block by a fixed shared-memory tree, then over
// the blocks as above (by k_reduce in TCP worlds).  Integer sums, mins
// and ORs do not depend on order, and no atomic decides a result.
//
// What bounds it on the H100: bytes.  Per launch it must read every
// host's emission valid flags, outbox slab stages and inbox slab (the
// post-step scan), the valid emission rows and the route_blk entries they
// gather, and write the placed rows (72 B each) and the changed host
// fields -- about 1.8 MB at the bench world's mid-window step
// (chip_smoke.py transport_bytes counts it), ~0.5 us of HBM time.  What
// sets the time is each host's chain of dependent loads (stage words,
// emission rows, route entries, the inbox's times); the UDP kernel
// batches the independent loads of that chain and keeps 16,384 hosts' in
// flight at once over every SM, where 256-thread blocks left half the SMs
// idle and a second launch folded the partials.  In TCP
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

constexpr int kTrBlock = 128;   // threads per block of k_transport

// Folds the per-block partials into the run's scalars: thread i takes
// partials i, i + B, ... in block order (L2 loads: other blocks wrote
// them), then the block's fixed tree.
template <int B>
__device__ __forceinline__ void fold_blocks(const TransportArgs& a) {
  HostOut o{INV, 0, 0};
  for (int b = threadIdx.x; b < a.n_blocks; b += B) {
    o.events += __ldcg((const long long*)a.blk_ev + b);
    o.th = imin(o.th, (int64_t)__ldcg((const long long*)a.blk_min + b));
    o.err |= __ldcg(a.blk_err + b);
  }
  const HostOut r = block_reduce<B>(o);
  if (threadIdx.x == 0) {
    *a.n_events += r.events;
    *a.n_steps += 1;
    *a.err |= r.err;
    *a.gmin = r.th;
  }
}

__global__ void __launch_bounds__(kTrBlock) k_transport(TransportArgs a) {
  const int hh = blockIdx.x * kTrBlock + threadIdx.x;
  HostOut o{INV, 0, 0};
  if (hh < a.h) {
    if (transport_small_fits(a)) {          // the same in every thread
      o = transport_small(a, hh, a.tick_t[hh], a.t_post[hh],
                          a.active[hh] != 0, a.delivered_n[hh], a.t_app[hh]);
    } else {
      Clk clk = make_clk(nullptr, false);
      o = transport_host(a, Solo{}, nullptr, hh, a.tick_t[hh], a.t_post[hh],
                         a.active[hh] != 0, a.delivered_n[hh], a.t_app[hh],
                         clk);
    }
    a.th[hh] = o.th;
  }
  const HostOut b = block_reduce<kTrBlock>(o);
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    a.blk_ev[blockIdx.x] = b.events;
    a.blk_min[blockIdx.x] = b.th;
    a.blk_err[blockIdx.x] = b.err;
    __threadfence();                  // the partials before the ticket
    s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  fold_blocks<kTrBlock>(a);
  if (threadIdx.x == 0) *a.ticket = 0;
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

__global__ void __launch_bounds__(kBlock) k_reduce(TransportArgs a) {
  fold_blocks<kBlock>(a);
}

}  // namespace

// `tcp` is null in UDP worlds.  The grid is args->n_blocks blocks: one
// thread per host (UDP, kTrBlock a block), one warp per host (TCP).
extern "C" int transport_launch(const TransportArgs* args,
                                const TcpArgs* tcp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = args->n_blocks;
  if (tcp == nullptr) {
    k_transport<<<nb, kTrBlock, 0, st>>>(*args);
  } else {
    k_transport_tcp<<<nb, kBlock, 0, st>>>(*args, *tcp);
    k_reduce<<<1, kBlock, 0, st>>>(*args);
  }
  return (int)cudaGetLastError();
}
