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
// UDP worlds: one thread per host in 128-thread blocks (kUdpBlock), so
// the bench world's 16,384 hosts are 128 blocks, one on each of 128 of
// the card's 132 SMs (256-thread blocks left half of them idle).  Every
// phase is row-local by the megakernel's blocking contract
// (megakernel.py:30-37): a host touches only its own inbox slab, host row
// and socket rows, so threads never share a written word and need no
// synchronisation.  A host's work is a chain of dependent loads, and what
// sets the time is that chain's depth.  Worlds that fit
// (deliver_small_fits: slabs and socket tables of at most 8 slots,
// rx_batch at most 8, even row widths; the bench world does) take
// k_deliver_small, deliver.cuh deliver_small, which phold's K_WINDOW
// shares: the host's own words in one step, its live slots' rows in a
// second, then the enqueue, the rounds, CoDel and the ring appends on
// registers and one write-back.  Other UDP worlds take k_deliver,
// deliver_host on the Solo team, which re-reads the slab's stage words
// and live rows each round and walks the sockets after each pick.  The
// launcher decides once per launch, from the arguments, as it decides
// the instantiation: each kernel is a template on the world's interface
// buffers (DeliverArgs.has_iface_buf: the router enqueue's tail drop,
// deliver.cuh) and k_deliver_tcp also on the congestion control
// (TcpArgs.cong: Reno or CUBIC, tcp.cuh).
//
// TCP worlds (k_deliver_tcp): one warp per host, walked warp-stride over
// a cooperative grid sized from the occupancy query, so any number of
// hosts (deliver_tcp_rounds on WarpHosts, deliver.cuh, which K_WINDOW's
// TCP kernels share).  The two scoreboard inserts of process_arrivals
// take a global gate per round (tcp.cuh): each round ends in a block OR,
// one atomic OR
// per block into a word of `gates` and one grid sync, reached by every
// thread from one call site; what a host carries across it is a record
// of device scratch, not registers.  A host's slab and socket walks run
// across the warp's lanes (coalesced loads, warp reductions).  The
// socket-overflow error bit of a passive open that finds no free slot is
// OR-ed per block into state.err.
//
// What bounds it on the H100: bytes.  Per launch it must read each
// active host's slab stages, the times of its live slots and its rx
// state, the rows it consumes and the receivers' socket rows, and write
// back the fields it changes, the ring entries and two [H] outputs --
// about 1 MB at the bench world's mid-window step (chip_smoke.py
// deliver_bytes counts it), a fraction of a microsecond of HBM time.
// What sets the UDP kernels' time is each host's chain of dependent loads
// (~1-2 us a step inside these kernels, PERF.md): two steps in
// deliver_small, against about a dozen in deliver_host.  In the bulk TCP
// world the server's 3,200-slot slab and 204 sockets set the time: a warp
// walks them in ~100 coalesced steps a pass, then the TCP machine runs
// serially on the matched socket.
#include "deliver.cuh"

using namespace s1;

namespace {

constexpr int kDeliverBlock = 256;    // k_deliver_tcp
constexpr int kUdpBlock = 128;        // k_deliver_small, k_deliver

// UDP worlds that fit (deliver_small_fits): the host's loads in two
// dependent steps, the rest on registers.  `Buf`: the world has interface
// buffers (DeliverArgs.has_iface_buf).
template <bool Buf>
__global__ void __launch_bounds__(kUdpBlock) k_deliver_small(DeliverArgs a) {
  __shared__ RxRows<kUdpBlock> rows;
  const int hh = blockIdx.x * kUdpBlock + threadIdx.x;
  if (hh >= a.h) return;
  Clk clk = make_clk(nullptr, false);
  RxIn in;
  const DeliverOut o = deliver_small<Buf>(a, hh, PhaseRxIn{a}, a.window_end,
                                          rows, in, clk);
  a.delivered_n[hh] = o.delivered;
  a.t_post[hh] = o.t_post;
}

// Other UDP worlds (larger slabs or socket tables): deliver_host on one
// thread.
template <bool Buf>
__global__ void __launch_bounds__(kUdpBlock) k_deliver(DeliverArgs a) {
  const int hh = blockIdx.x * kUdpBlock + threadIdx.x;
  if (hh >= a.h) return;
  Clk clk = make_clk(nullptr, false);
  const DeliverOut o = deliver_host<Buf>(a, Solo{}, hh, a.tick_t[hh],
                                    a.active[hh] != 0,
                                    a.rx_batch > 1 ? a.aux0[hh] : INV,
                                    a.window_end, clk);
  a.delivered_n[hh] = o.delivered;
  a.t_post[hh] = o.t_post;
}

// TCP worlds; `Cong`: the congestion control (TcpArgs.cong).
template <bool Buf, int Cong>
__global__ void __launch_bounds__(kDeliverBlock, 2)
    k_deliver_tcp(DeliverArgs a, TcpArgs t) {
  Clk clk = make_clk(nullptr, false);
  WarpHosts hosts(t.carry, a.h);
  const int32_t err = deliver_tcp_rounds<Buf, Cong>(
      a, t, hosts, t.gates, a.window_end, clk, -1,
      [&](int hh, int64_t& tick, bool& act, int64_t& aux0) {
        tick = a.tick_t[hh];
        act = a.active[hh] != 0;
        aux0 = a.rx_batch > 1 ? a.aux0[hh] : INV;
      },
      [&](int hh, const RxCarry&, const DeliverOut& o, bool) {
        if (Warp{}.leader()) {
          a.delivered_n[hh] = o.delivered;
          a.t_post[hh] = o.t_post;
        }
      });
  if (__syncthreads_or(err & ERR_SOCKET_OVERFLOW) && threadIdx.x == 0)
    atomicOr(t.err, ERR_SOCKET_OVERFLOW);
}

// k_deliver_tcp's instantiation for a launch's arguments.
const void* deliver_tcp_fn(const DeliverArgs& a, const TcpArgs& t) {
  const bool cubic = t.cong == CONG_CUBIC;
  if (a.has_iface_buf)
    return cubic ? (const void*)k_deliver_tcp<true, CONG_CUBIC>
                 : (const void*)k_deliver_tcp<true, CONG_RENO>;
  return cubic ? (const void*)k_deliver_tcp<false, CONG_CUBIC>
               : (const void*)k_deliver_tcp<false, CONG_RENO>;
}

}  // namespace

// `tcp` is null in UDP worlds, which take k_deliver_small where the world
// fits (deliver_small_fits) and k_deliver otherwise.  The instantiation
// (interface buffers; in TCP worlds the congestion control) is picked from
// the arguments, once per launch.  Returns a CUDA error code.  The TCP
// grid is as many blocks as the card keeps resident (the occupancy query),
// at most one warp per host.
extern "C" int deliver_launch(const DeliverArgs* args, const TcpArgs* tcp,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tcp == nullptr) {
    const int nb = (args->h + kUdpBlock - 1) / kUdpBlock;
    const bool buf = args->has_iface_buf != 0;
    if (deliver_small_fits(*args)) {
      if (buf)
        k_deliver_small<true><<<nb, kUdpBlock, 0, st>>>(*args);
      else
        k_deliver_small<false><<<nb, kUdpBlock, 0, st>>>(*args);
    } else {
      if (buf)
        k_deliver<true><<<nb, kUdpBlock, 0, st>>>(*args);
      else
        k_deliver<false><<<nb, kUdpBlock, 0, st>>>(*args);
    }
    return (int)cudaGetLastError();
  }
  const void* fn = deliver_tcp_fn(*args, *tcp);
  const int tb = kDeliverBlock;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, tb, 0);
  if (e != cudaSuccess) return (int)e;
  const int warps = tb / 32;
  const int need = (args->h + warps - 1) / warps;
  const int nb = need < per_sm * sms ? need : per_sm * sms;
  e = cudaMemsetAsync(tcp->gates, 0, sizeof(int32_t) * args->rx_batch, st);
  if (e != cudaSuccess) return (int)e;
  DeliverArgs a = *args;
  TcpArgs t = *tcp;
  void* params[] = {&a, &t};
  e = cudaLaunchCooperativeKernel(fn, dim3(nb), dim3(tb), params, 0, st);
  return (int)e;
}

// 1 if a UDP world with these arguments takes deliver_small (k_deliver_small,
// and k_window's micro-step), else 0.
extern "C" int deliver_fits_small(const DeliverArgs* args) {
  return deliver_small_fits(*args) ? 1 : 0;
}
