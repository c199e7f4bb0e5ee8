// K_DELIVER: one micro-step's arrival phase for every host.
//
// Replaces the TPU kernel K_DELIVER (shadow1_tpu/core/megakernel.py,
// microstep_fused.k_deliver launched through _call_blocked, pallas_call at
// line 220), whose body is shadow1_tpu/core/engine.py _rx_phase: router
// enqueue of due inbox arrivals, then `rx_batch` delivery rounds, each
// taking the host's earliest candidate in (time, pkt_id) order through
// the NIC rx token bucket and CoDel, into the UDP socket ring or through
// tcp.process_arrivals (tcp.cuh) with its reply segment.
//
// Design: one thread per host (the body is deliver_host, deliver.cuh,
// which K_WINDOW shares).  Every phase is row-local by the
// megakernel's blocking contract (megakernel.py:30-37): a host touches
// only its own inbox slab, host row and socket rows, so threads never
// share a written word and need no synchronisation.  The inbox slab is
// re-scanned from global memory each round (ki = 8 rows at the bench
// world; L1 keeps them).
//
// TCP worlds launch k_deliver_tcp cooperatively (all blocks resident):
// the two scoreboard inserts of process_arrivals take a global gate per
// round (tcp.cuh), so each round every block ORs its hosts' gate bits
// into a word of `gates` and the grid synchronises once before the rest
// of the round; OR does not depend on order.  The socket-overflow error
// bit of a passive open that finds no free slot is OR-ed per block into
// state.err.  A gathered socket is ~45 scalars plus 24 range words per
// thread: the TCP kernel takes ~250 registers and a ~1 KB stack frame in
// local memory (ptxas, printed by chip_smoke.py).  Every barrier of the
// cooperative grid is reached from one call site by every thread (a
// thread with no host runs the rounds with its work masked off): an
// aligned barrier reached from divergent call sites hangs the grid.
//
// What bounds it on the H100: bytes.  Per launch it must read each
// active host's slab stages, the times of its live slots and its rx
// state, the rows it consumes and the receivers' socket rows, and write
// back the fields it changes, the ring entries and two [H] outputs --
// about 1 MB at the bench world's mid-window step (chip_smoke.py
// deliver_bytes counts it), a fraction of a microsecond of HBM time.
// The strided per-host slab reads are uncoalesced (448 B apart); at this
// size the launch itself dominates.  In the bulk TCP world the server's
// thread walks a 3,200-slot slab once per round and matches each
// segment against 204 sockets; that one thread sets the kernel's time.
#include "deliver.cuh"

using namespace s1;

namespace {

constexpr int kDeliverBlock = 256;

__global__ void k_deliver(DeliverArgs a) {
  const int hh = blockIdx.x * blockDim.x + threadIdx.x;
  if (hh >= a.h) return;
  int32_t err = 0;
  const DeliverOut o = deliver_host(a, nullptr, NoGate{}, hh, true,
                                    a.tick_t[hh], a.active[hh] != 0,
                                    a.rx_batch > 1 ? a.aux0[hh] : INV,
                                    a.window_end, err);
  a.delivered_n[hh] = o.delivered;
  a.t_post[hh] = o.t_post;
}

__global__ void __launch_bounds__(kDeliverBlock)
    k_deliver_tcp(DeliverArgs a, TcpArgs t) {
  const int hh = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = hh < a.h;
  int32_t err = 0;
  const DeliverOut o = deliver_host(
      a, &t, GridGate{t.gates}, hh, valid, valid ? a.tick_t[hh] : 0,
      valid && a.active[hh] != 0,
      (valid && a.rx_batch > 1) ? a.aux0[hh] : INV, a.window_end, err);
  if (valid) {
    a.delivered_n[hh] = o.delivered;
    a.t_post[hh] = o.t_post;
  }
  if (__syncthreads_or(err & ERR_SOCKET_OVERFLOW) && threadIdx.x == 0)
    atomicOr(t.err, ERR_SOCKET_OVERFLOW);
}

}  // namespace

// `tcp` is null in UDP worlds.  Returns a CUDA error code, or -1 when the
// cooperative TCP grid cannot be resident on the card at once.
extern "C" int deliver_launch(const DeliverArgs* args, const TcpArgs* tcp,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tb = kDeliverBlock;
  const int nb = (args->h + tb - 1) / tb;
  if (tcp == nullptr) {
    k_deliver<<<nb, tb, 0, st>>>(*args);
    return (int)cudaGetLastError();
  }
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_deliver_tcp,
                                                      tb, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm * sms < nb) return -1;
  e = cudaMemsetAsync(tcp->gates, 0, sizeof(int32_t) * args->rx_batch, st);
  if (e != cudaSuccess) return (int)e;
  DeliverArgs a = *args;
  TcpArgs t = *tcp;
  void* params[] = {&a, &t};
  e = cudaLaunchCooperativeKernel((const void*)k_deliver_tcp, dim3(nb),
                                  dim3(tb), params, 0, st);
  return (int)e;
}
