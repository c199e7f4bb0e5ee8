// Window-boundary exchange: IN_FLIGHT outbox rows -> destination inbox slabs.
//
// Replaces the TPU kernel `exchange_call` (shadow1_tpu/core/megakernel.py,
// exchange_call, pallas_call at line 280), whose body is
// shadow1_tpu/core/engine.py _exchange_core (UDP branch).
//
// What it computes: every IN_FLIGHT outbox row moves to its destination's
// inbox slab.  The r-th mover of destination d, in flat (src-major) pool
// order, takes the r-th FREE slot of slab d in ascending slot order, if
// there is one; movers beyond the slab's free slots are dropped (the
// caller counts them from `total - n_free`).  Rows are copied verbatim
// except the two TIME columns, spliced from the authoritative pool.time.
// All movers leave the outbox (stage FREE).
//
// Design (four passes on the caller's stream, deterministic by
// construction -- no atomic order decides a rank or a slot):
//   1. k_count  (one thread per pool row): histogram of movers per
//      destination (atomicAdd counts; the count does not depend on order);
//   2. k_scan   (one block): exclusive scan of the histogram -> bucket
//      starts;
//   3. k_bucket (one thread per pool row): each mover lands at some
//      position of its destination's bucket (atomic, order undefined) and
//      its outbox stage clears;
//   4. k_place  (one thread per destination): sorts its bucket by flat
//      pool index (insertion sort: a bucket holds a handful of movers),
//      which fixes the rank order whatever the atomics did, then walks its
//      slab in ascending slot order handing out free slots.
// The drop sentinel of the JAX scatter (`.at[islot].set(mode="drop")`
// with islot = p1) becomes the plain `r < n_free` walk bound.
//
// What bounds it on the H100: bytes.  Per window it reads the pool stage
// and dst column (P0 * 8 B), and for each mover one packed row (56 B of
// the 72 B row) plus its time, and writes one inbox row, stage and
// status; the per-destination pass reads each slab's stage (H * ki * 4 B).
// At the bench world (P0 = 131,072, ~6 * 6,349 movers per window) that is
// under 5 MB -- a few microseconds of HBM time; the four launches and the
// per-destination thread's serial walk dominate, which is what a later
// fused (K_WINDOW) design removes.
#include "common.cuh"

using namespace s1;

namespace {

__device__ __forceinline__ int clip_dst(const int32_t* row, int pc, int h) {
  int d = row[pc - OEXT_COLS + OEXT_DST];
  return d < 0 ? 0 : (d > h - 1 ? h - 1 : d);
}

__global__ void k_count(const int32_t* __restrict__ pool_blk, int pc,
                        int64_t p0, const int32_t* __restrict__ pool_stage,
                        int h, int32_t* __restrict__ cnt) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p0 || pool_stage[i] != STAGE_IN_FLIGHT) return;
  atomicAdd(&cnt[clip_dst(pool_blk + i * pc, pc, h)], 1);
}

// Exclusive scan of cnt[0..h) into start[0..h], one block of 1024 threads.
__global__ void k_scan(const int32_t* __restrict__ cnt,
                       int32_t* __restrict__ start, int h) {
  __shared__ int32_t part[1024];
  int t = threadIdx.x;
  int per = (h + blockDim.x - 1) / blockDim.x;
  int lo = t * per;
  int hi = min(lo + per, h);
  int32_t s = 0;
  for (int d = lo; d < hi; ++d) s += cnt[d];
  part[t] = s;
  __syncthreads();
  if (t == 0) {
    int32_t acc = 0;
    for (int i = 0; i < (int)blockDim.x; ++i) {
      int32_t v = part[i];
      part[i] = acc;
      acc += v;
    }
    start[h] = acc;
  }
  __syncthreads();
  int32_t acc = part[t];
  for (int d = lo; d < hi; ++d) {
    start[d] = acc;
    acc += cnt[d];
  }
}

__global__ void k_bucket(const int32_t* __restrict__ pool_blk, int pc,
                         int64_t p0, int32_t* __restrict__ pool_stage, int h,
                         const int32_t* __restrict__ start,
                         int32_t* __restrict__ fill,
                         int32_t* __restrict__ lst) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p0 || pool_stage[i] != STAGE_IN_FLIGHT) return;
  int d = clip_dst(pool_blk + i * pc, pc, h);
  int pos = atomicAdd(&fill[d], 1);
  lst[start[d] + pos] = (int32_t)i;
  pool_stage[i] = STAGE_FREE;
}

__global__ void k_place(const int32_t* __restrict__ pool_blk, int pc,
                        const int64_t* __restrict__ pool_time,
                        const int32_t* __restrict__ pool_status,
                        int32_t* __restrict__ ib_blk, int ic,
                        int32_t* __restrict__ ib_stage,
                        int32_t* __restrict__ ib_status, int ki, int h,
                        int pds_trail, const int32_t* __restrict__ cnt,
                        const int32_t* __restrict__ start,
                        int32_t* __restrict__ lst,
                        int32_t* __restrict__ total,
                        int32_t* __restrict__ n_free) {
  int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= h) return;
  const int n = cnt[d];
  int32_t* L = lst + start[d];
  for (int i = 1; i < n; ++i) {          // ascending flat pool index
    int32_t key = L[i];
    int j = i - 1;
    while (j >= 0 && L[j] > key) {
      L[j + 1] = L[j];
      --j;
    }
    L[j + 1] = key;
  }
  const int64_t base = (int64_t)d * ki;
  int nf = 0;
  for (int k = 0; k < ki; ++k) nf += ib_stage[base + k] == STAGE_FREE;
  int r = 0;
  for (int k = 0; k < ki && r < n; ++k) {
    const int64_t slot = base + k;
    if (ib_stage[slot] != STAGE_FREE) continue;
    const int64_t row = L[r++];
    const int32_t* src = pool_blk + row * pc;
    int32_t* dst = ib_blk + slot * ic;
    for (int c = 0; c < ic; ++c) dst[c] = src[c];
    const int64_t t = pool_time[row];
    dst[ICOL_TIME_LO] = enc_lo(t);
    dst[ICOL_TIME_HI] = enc_hi(t);
    ib_stage[slot] = STAGE_IN_FLIGHT;
    if (pds_trail) ib_status[slot] = pool_status[row];
  }
  total[d] = n;
  n_free[d] = nf;
}

}  // namespace

// scratch: int32[3h + 1] = cnt[h] | fill[h] | start[h + 1]; lst: int32[p0].
extern "C" int exchange_launch(const int32_t* pool_blk, int pc, int64_t p0,
                               const int64_t* pool_time, int32_t* pool_stage,
                               const int32_t* pool_status, int32_t* ib_blk,
                               int ic, int32_t* ib_stage, int32_t* ib_status,
                               int64_t p1, int h, int pds_trail,
                               int32_t* scratch, int32_t* lst,
                               int32_t* total, int32_t* n_free,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* cnt = scratch;
  int32_t* fill = scratch + h;
  int32_t* start = scratch + 2 * (int64_t)h;
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * 2 * (size_t)h,
                                  st);
  if (e != cudaSuccess) return (int)e;
  const int tb = 256;
  const unsigned gp = (unsigned)((p0 + tb - 1) / tb);
  const int ki = (int)(p1 / h);
  k_count<<<gp, tb, 0, st>>>(pool_blk, pc, p0, pool_stage, h, cnt);
  k_scan<<<1, 1024, 0, st>>>(cnt, start, h);
  k_bucket<<<gp, tb, 0, st>>>(pool_blk, pc, p0, pool_stage, h, start, fill,
                              lst);
  k_place<<<(h + tb - 1) / tb, tb, 0, st>>>(
      pool_blk, pc, pool_time, pool_status, ib_blk, ic, ib_stage, ib_status,
      ki, h, pds_trail, cnt, start, lst, total, n_free);
  return (int)cudaGetLastError();
}
