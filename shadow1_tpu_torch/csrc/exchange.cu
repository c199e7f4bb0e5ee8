// Window-boundary exchange: IN_FLIGHT outbox rows -> destination inbox slabs.
//
// Replaces the TPU kernel `exchange_call` (shadow1_tpu/core/megakernel.py,
// exchange_call, pallas_call at line 280), whose body is
// shadow1_tpu/core/engine.py _exchange_core, with the ACK-before-data
// two-class re-rank of TCP worlds.  What it computes and the four passes
// are described in exchange.cuh, whose
// device functions K_WINDOW (window.cu) shares; here each pass is its own
// kernel on the caller's stream, deterministic by construction -- no
// atomic order decides a rank or a slot.
//
// What bounds it on the H100: bytes.  Per window it reads the pool stage
// and dst column (P0 * 8 B), and for each mover one packed row (56 B of
// the 72 B row) plus its time, and writes one inbox row, stage and
// status; the per-destination pass reads each slab's stage (H * ki * 4 B).
// At the bench world (P0 = 131,072, ~6 * 6,349 movers per window) that is
// under 5 MB -- a few microseconds of HBM time; the four launches and the
// per-destination thread's serial walk dominate, which is what K_WINDOW
// removes.  In a TCP fan-in world one destination (the server) takes
// thousands of movers a window, so its thread's insertion sort and slab
// walk (ki = 3,200 at the bulk bench world) set the time.
#include "exchange.cuh"

using namespace s1;

namespace {

__global__ void k_count(ExchangeArgs x) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < x.p0) ex_count_row(x, i);
}

__global__ void k_scan(ExchangeArgs x) { ex_scan_block(x); }

__global__ void k_bucket(ExchangeArgs x) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < x.p0) ex_bucket_row(x, i);
}

__global__ void k_place(ExchangeArgs x, int32_t* __restrict__ total,
                        int32_t* __restrict__ total_prot,
                        int32_t* __restrict__ n_free) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d < x.h) ex_place_dest(x, d, total[d], total_prot[d], n_free[d]);
}

}  // namespace

// scratch: int32[3h + 3] = cnt[h] | fill[h] | start[h + 1] | gate[2];
// lst: int32[p0].  The two-class gate exists in full-width (TCP) worlds.
extern "C" int exchange_launch(const int32_t* pool_blk, int pc, int64_t p0,
                               const int64_t* pool_time, int32_t* pool_stage,
                               const int32_t* pool_status, int32_t* ib_blk,
                               int ic, int32_t* ib_stage, int32_t* ib_status,
                               int64_t p1, int h, int pds_trail,
                               int32_t* scratch, int32_t* lst,
                               int32_t* total, int32_t* total_prot,
                               int32_t* n_free, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  ExchangeArgs x{pool_blk, pool_stage, pool_time, pool_status, ib_blk,
                 ib_stage, ib_status, scratch, scratch + h,
                 scratch + 2 * (int64_t)h, lst,
                 ic >= ICOLS ? scratch + 3 * (int64_t)h + 1 : nullptr, p0, pc,
                 ic, (int32_t)(p1 / h), h, pds_trail};
  cudaError_t e = cudaMemsetAsync(scratch, 0,
                                  sizeof(int32_t) * (3 * (size_t)h + 3), st);
  if (e != cudaSuccess) return (int)e;
  const int tb = 256;
  const unsigned gp = (unsigned)((p0 + tb - 1) / tb);
  k_count<<<gp, tb, 0, st>>>(x);
  k_scan<<<1, 1024, 0, st>>>(x);
  k_bucket<<<gp, tb, 0, st>>>(x);
  k_place<<<(h + tb - 1) / tb, tb, 0, st>>>(x, total, total_prot, n_free);
  return (int)cudaGetLastError();
}
