// The window-boundary exchange's phases as device functions, shared by
// the per-phase kernels of exchange.cu and by K_WINDOW (window.cu).
//
// What they compute (engine._exchange_core): every IN_FLIGHT outbox row
// moves to its destination's inbox slab.  The r-th mover of destination
// d, in flat (src-major) pool order, takes the r-th FREE slot of slab d
// in ascending slot order, if there is one; movers beyond the slab's free
// slots are dropped (counted from `total - n_free`).  Rows are copied
// verbatim except the two TIME columns, spliced from the authoritative
// pool.time.  All movers leave the outbox (stage FREE).
//
// TCP worlds (full-width rows; `gate` set) shed pure ACKs first: when
// some destination has more movers than free slots and some mover is a
// pure ACK, every destination ranks its protected movers (data and
// control) first, then its pure ACKs, each class in flat order, and
// reports the protected count as total_prot.  The gate is global because
// the re-rank also moves the movers of destinations that fit.
//
// The passes, each separated from the next by a barrier over the whole
// grid (a kernel boundary in exchange.cu, a grid sync in window.cu):
//   1. ex_count_row  (per pool row): histogram of movers per destination
//      (atomic counts; a count does not depend on order), and in TCP
//      worlds whether any mover is a pure ACK;
//   2. ex_scan_block (one block): exclusive scan of the histogram ->
//      bucket starts; in TCP worlds, the two-class gate (K_WINDOW spreads
//      this pass over its whole grid instead: window.cu ex_scan_grid);
//   3. ex_bucket_row (per pool row): each mover lands at some position of
//      its destination's bucket (atomic, order undefined) and its outbox
//      stage clears;
//   4. ex_place_dest (per destination): sorts its bucket by flat pool
//      index (insertion sort), which fixes the rank order whatever the
//      atomics did, then walks its slab in ascending slot order handing
//      out free slots in rank order (under the gate: protected movers,
//      then pure ACKs).
// The drop sentinel of the JAX scatter (`.at[islot].set(mode="drop")`
// with islot = p1) becomes the plain `r < n_free` walk bound.
#pragma once
#include "common.cuh"
#include "tcp.cuh"

namespace s1 {

// Mirrored field for field by the ctypes.Structure in
// shadow1_tpu_torch/core/megakernel.py (K_WINDOW's arguments).
struct ExchangeArgs {
  const int32_t* pool_blk;
  int32_t* pool_stage;
  const int64_t* pool_time;
  const int32_t* pool_status;
  int32_t* ib_blk;
  int32_t* ib_stage;
  int32_t* ib_status;
  int32_t* cnt;      // [h] movers per destination
  int32_t* fill;     // [h] bucket fill cursors
  int32_t* start;    // [h + 1] bucket starts
  int32_t* lst;      // [p0] pool indices, bucketed by destination
  int32_t* gate;     // [2] any pure-ACK mover, two-class gate; null in
                     // narrow (UDP) worlds
  int64_t p0;
  int32_t pc, ic, ki, h, pds_trail;
};

__device__ __forceinline__ int ex_clip_dst(const ExchangeArgs& x,
                                           int64_t i) {
  const int d = x.pool_blk[i * x.pc + x.pc - OEXT_COLS + OEXT_DST];
  return d < 0 ? 0 : (d > x.h - 1 ? x.h - 1 : d);
}

// tcp.pure_ack of pool row i.
__device__ __forceinline__ bool ex_pure_ack(const ExchangeArgs& x,
                                            int64_t i) {
  const int32_t* r = x.pool_blk + i * x.pc;
  return r[ICOL_PROTO] == PROTO_TCP && r[ICOL_LEN] == 0 &&
         r[ICOL_FLAGS] == TCP_FLAG_ACK;
}

__device__ __forceinline__ void ex_count_row(const ExchangeArgs& x,
                                             int64_t i) {
  if (x.pool_stage[i] != STAGE_IN_FLIGHT) return;
  atomicAdd(&x.cnt[ex_clip_dst(x, i)], 1);
  if (x.gate != nullptr && ex_pure_ack(x, i)) atomicOr(&x.gate[0], 1);
}

// Exclusive scan of cnt[0..h) into start[0..h]; the calling block's
// threads (at most 1024) all take part.
__device__ __forceinline__ void ex_scan_block(const ExchangeArgs& x) {
  __shared__ int32_t part[1024];
  const int t = threadIdx.x;
  const int per = (x.h + blockDim.x - 1) / blockDim.x;
  const int lo = t * per;
  const int hi = min(lo + per, x.h);
  int32_t s = 0;
  for (int d = lo; d < hi; ++d) s += x.cnt[d];
  part[t] = s;
  __syncthreads();
  if (t == 0) {
    int32_t acc = 0;
    for (int i = 0; i < (int)blockDim.x; ++i) {
      const int32_t v = part[i];
      part[i] = acc;
      acc += v;
    }
    x.start[x.h] = acc;
  }
  __syncthreads();
  int32_t acc = part[t];
  bool over = false;
  for (int d = lo; d < hi; ++d) {
    x.start[d] = acc;
    acc += x.cnt[d];
    if (x.gate != nullptr && x.gate[0] != 0) {
      int nf = 0;
      for (int k = 0; k < x.ki; ++k)
        nf += x.ib_stage[(int64_t)d * x.ki + k] == STAGE_FREE;
      over = over || x.cnt[d] > nf;
    }
  }
  over = __syncthreads_or(over) != 0;
  if (x.gate != nullptr && t == 0) x.gate[1] = over ? 1 : 0;
  __syncthreads();
}

__device__ __forceinline__ void ex_bucket_row(const ExchangeArgs& x,
                                              int64_t i) {
  if (x.pool_stage[i] != STAGE_IN_FLIGHT) return;
  const int d = ex_clip_dst(x, i);
  const int pos = atomicAdd(&x.fill[d], 1);
  x.lst[x.start[d] + pos] = (int32_t)i;
  x.pool_stage[i] = STAGE_FREE;
}

// Places destination d's movers; returns (total movers, protected
// movers, free slots before placement) through `total` / `total_prot` /
// `n_free`.
__device__ __forceinline__ void ex_place_dest(const ExchangeArgs& x, int d,
                                              int32_t& total,
                                              int32_t& total_prot,
                                              int32_t& n_free) {
  const int n = x.cnt[d];
  int32_t* L = x.lst + x.start[d];
  for (int i = 1; i < n; ++i) {          // ascending flat pool index
    const int32_t key = L[i];
    int j = i - 1;
    while (j >= 0 && L[j] > key) {
      L[j + 1] = L[j];
      --j;
    }
    L[j + 1] = key;
  }
  const int64_t base = (int64_t)d * x.ki;
  int nf = 0;
  for (int k = 0; k < x.ki; ++k) nf += x.ib_stage[base + k] == STAGE_FREE;
  const bool two = x.gate != nullptr && x.gate[1] != 0;
  int n_prot = n;
  if (two)
    for (int i = 0; i < n; ++i) n_prot -= ex_pure_ack(x, L[i]) ? 1 : 0;
  int r = 0, k = 0;
  for (int pass = 0; pass < (two ? 2 : 1); ++pass) {
    for (int i = 0; i < n && r < nf; ++i) {
      const int64_t row = L[i];
      if (two && ex_pure_ack(x, row) != (pass == 1)) continue;
      while (x.ib_stage[base + k] != STAGE_FREE) ++k;
      const int64_t slot = base + k++;
      ++r;
      const int32_t* src = x.pool_blk + row * x.pc;
      int32_t* dst = x.ib_blk + slot * x.ic;
      for (int c = 0; c < x.ic; ++c) dst[c] = src[c];
      const int64_t t = x.pool_time[row];
      dst[ICOL_TIME_LO] = enc_lo(t);
      dst[ICOL_TIME_HI] = enc_hi(t);
      x.ib_stage[slot] = STAGE_IN_FLIGHT;
      if (x.pds_trail) x.ib_status[slot] = x.pool_status[row];
    }
  }
  total = n;
  total_prot = n_prot;
  n_free = nf;
}

}  // namespace s1
