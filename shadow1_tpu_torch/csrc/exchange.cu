// Window-boundary exchange: IN_FLIGHT outbox rows -> destination inbox slabs.
//
// Replaces the TPU kernel `exchange_call` (shadow1_tpu/core/megakernel.py,
// exchange_call, pallas_call at line 280), whose body is
// shadow1_tpu/core/engine.py _exchange_core, with the ACK-before-data
// two-class re-rank of TCP worlds.  What it computes and how
// (a stable radix sort of the movers by destination over the grid, free
// lists by a grid scan, rows copied by groups of lanes) is described in
// exchange.cuh, whose ex_run K_WINDOW (window.cu) shares.  Here ex_run is
// one cooperative launch on the caller's stream (its stages parted by grid
// syncs; nothing to zero beforehand), deterministic by construction -- no
// atomic order decides a rank or a slot.
//
// What bounds it on the H100: bytes.  Per window it reads the pool's and
// the inbox's stage words, and for each mover its dst (and, in TCP worlds,
// three header words), one packed row and its time, and writes one inbox
// row, stage and status, the free lists and the movers' keys: at the bench
// world (p0 = p1 = 131,072, ~6 x 6,349 movers a window) a few MB, a few
// microseconds of HBM time; at the bulk world's boundary (p0 = p1 =
// 320,000) ~2.8 MB.  The stages' grid barriers (three with one sort
// pass, seven with two), their chains of dependent loads and the launch
// set the time.  The grid is one block per 1,024 pool rows or inbox
// slots, at most one per SM (core/megakernel.py _exchange_grid).
#include "exchange.cuh"

using namespace s1;

namespace {

constexpr int kExBlock = 256;   // threads per block of k_exchange

__global__ void __launch_bounds__(kExBlock) k_exchange(ExchangeArgs x) {
  cg::grid_group grid = cg::this_grid();
  Clk clk = make_clk(nullptr, false);
  ex_run<kExBlock>(x, grid, clk);
}

}  // namespace

// Blocks per SM of k_exchange and the card's SM count (the wrapper sizes
// the cooperative grid from them).  Returns a CUDA error code, or -1 when
// the device cannot launch cooperative kernels.
extern "C" int exchange_occupancy(int* per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k_exchange,
                                                      kExBlock, 0);
  if (e != cudaSuccess) return (int)e;
  return (!coop || *per_sm < 1) ? -1 : 0;
}

// One cooperative launch of `n_blocks` blocks; the scratch in `x` is
// sized by the wrapper (core/megakernel.py _ex_scratch).
extern "C" int exchange_launch(const ExchangeArgs* x, int n_blocks,
                               void* stream) {
  void* params[] = {(void*)x};
  return (int)cudaLaunchCooperativeKernel((const void*)k_exchange,
                                          dim3(n_blocks), dim3(kExBlock),
                                          params, 0, (cudaStream_t)stream);
}
