// K_DELIVER: one micro-step's arrival phase for every host.
//
// Replaces the TPU kernel K_DELIVER (shadow1_tpu/core/megakernel.py,
// microstep_fused.k_deliver launched through _call_blocked, pallas_call at
// line 220), whose body is shadow1_tpu/core/engine.py _rx_phase (UDP
// branch): router enqueue of due inbox arrivals, then `rx_batch` delivery
// rounds, each taking the host's earliest candidate in (time, pkt_id)
// order through the NIC rx token bucket and CoDel, into the UDP socket
// ring.
//
// Design: one thread per host (the body is deliver_host, deliver.cuh,
// which K_WINDOW shares).  Every phase is row-local by the
// megakernel's blocking contract (megakernel.py:30-37): a host touches
// only its own inbox slab, host row and socket rows, so threads never
// share a written word and need no synchronisation.  The inbox slab is
// re-scanned from global memory each round (ki = 8 rows at the bench
// world; L1 keeps them).  UDP delivery stages no emission, so no partial
// reduction leaves the kernel (the netem kill count and TCP error bits of
// the JAX kernel do not exist in this slice).
//
// What bounds it on the H100: bytes.  Per launch it must read each
// active host's slab stages, the times of its live slots and its rx
// state, the rows it consumes and the receivers' socket rows, and write
// back the fields it changes, the ring entries and two [H] outputs --
// about 1 MB at the bench world's mid-window step (chip_smoke.py
// deliver_bytes counts it), a fraction of a microsecond of HBM time.
// The strided per-host slab reads are uncoalesced (448 B apart); at this
// size the launch itself dominates.
#include "deliver.cuh"

using namespace s1;

namespace {

__global__ void k_deliver(DeliverArgs a) {
  const int hh = blockIdx.x * blockDim.x + threadIdx.x;
  if (hh >= a.h) return;
  const DeliverOut o = deliver_host(a, hh, a.tick_t[hh], a.active[hh] != 0,
                                    a.rx_batch > 1 ? a.aux0[hh] : INV,
                                    a.window_end);
  a.delivered_n[hh] = o.delivered;
  a.t_post[hh] = o.t_post;
}

}  // namespace

extern "C" int deliver_launch(const DeliverArgs* args, void* stream) {
  const int tb = 256;
  k_deliver<<<(args->h + tb - 1) / tb, tb, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
