// The window-boundary exchange as device functions, shared by the
// per-phase kernel of exchange.cu and by K_WINDOW's window open
// (window.cu).
//
// What it computes (engine._exchange_core): every IN_FLIGHT outbox row
// moves to its destination's inbox slab.  The r-th mover of destination
// d, in flat (src-major) pool order, takes the r-th FREE slot of slab d
// in ascending slot order, if there is one; movers beyond the slab's free
// slots are dropped (counted from `total - n_free`).  Rows are copied
// verbatim except the two TIME columns, spliced from the authoritative
// pool.time.  All movers leave the outbox (stage FREE).
//
// TCP worlds (full-width rows; `tcp` set) shed pure ACKs first: when
// some destination has more movers than free slots and some mover is a
// pure ACK, every destination ranks its protected movers (data and
// control) first, then its pure ACKs, each class in flat order, and
// reports the protected count as total_prot.  The gate is global because
// the re-rank also moves the movers of destinations that fit.
//
// Design (ex_run): a stable counting sort of the movers by destination,
// written as flat, coalesced passes over the grid, separated by grid-wide
// barriers; no thread walks a bucket or a slab alone, and no atomic
// decides a position.
//   * Free lists: a grid-wide exclusive scan of the inbox's FREE flags
//     compacts every free slot, in flat order, into `flist`; slab d's
//     free slots in ascending order are flist[fbase[d] .. fbase[d + 1]).
//   * Movers: each block takes a contiguous chunk of the pool and lists
//     its movers, in flat order, as (key, pool index) pairs at the
//     chunk's own offset of `keys` / `vals` (U rows a thread a step,
//     positions from per-warp ballots); their outbox stage clears there.
//   * Ranks: a least-significant-digit radix sort keyed by destination,
//     in passes of at most EX_RBITS bits.  A pass counts each digit per
//     block (a digit-major table [bins][blocks]), scans the table over
//     the grid, and scatters: a block walks its input (its chunk's movers,
//     then its chunk of the previous pass's output) in tiles of one
//     element a thread, ranks each element among the tile's earlier
//     elements of its digit (warp match / popc, then the earlier warps'
//     counts) and adds the running offset of its digit.  Elements keep
//     their flat order within a digit in every pass, so the sort is
//     stable.  Counts are sums (shared or global atomics add the same
//     total in any order); every position comes from scans of those
//     counts and from thread order.
//   * One pass (h << tcp <= EX_R bins, e.g. the bulk world): the key is
//     (d << 1) | pure_ack in TCP worlds, d in UDP worlds, and the pass
//     places directly: the scanned table gives each destination's movers
//     per class and block, so the gate (some destination overflows and
//     some mover is a pure ACK) is known before the scatter, and the
//     scatter ranks by (d, class) when it is on, by d alone when it is
//     off (the two classes' block offsets added).
//   * Several passes (phold, the pairs world): the key is d; the last
//     pass's output is the movers sorted by destination in flat order, a
//     grid scan of the per-destination counts gives the bucket starts,
//     and a mover's rank is its position minus its bucket's start.  When
//     the gate is on, a grid scan of the protected flags over the sorted
//     movers gives each mover its rank within its class.
//   * Place: the mover of rank r < n_free[d] takes slot
//     flist[fbase[d] + r] of slab d; a warp copies its placed rows with
//     groups of lanes across each row's columns (two or three 32-byte
//     sectors a row).
// Work: O(p0 + p1 + movers * ic + bins * blocks) words and a fixed number
// of grid barriers (one pass: three; two passes: seven, nine with the
// gate on; the caller adds one after), scratch O(p0 + p1 + h + bins *
// blocks).  Each stage is a few dependent loads deep, so on the card the
// barriers and those load steps, not the bytes, set the time.
//
// The exchange's previous design (ex_*_v1 below: atomic buckets, then one
// thread per destination sorting its bucket and walking its slab) stays
// as phold's K_WINDOW's window open: with ~2 movers a destination it
// measured faster there than ex_run's extra barriers (ExchangeArgs.v1;
// core/megakernel.py set_window_exchange_v1 picks either for a run).
#pragma once
#include <cooperative_groups.h>

#include "common.cuh"
#include "tcp.cuh"

namespace s1 {

namespace cg = cooperative_groups;

constexpr int EX_RBITS = 8;            // most bits of one sort pass
constexpr int EX_R = 1 << EX_RBITS;    // most bins of one sort pass

// Mirrored field for field by the ctypes.Structure in
// shadow1_tpu_torch/core/megakernel.py (the exchange's and K_WINDOW's
// arguments); the wrapper sizes the scratch (megakernel._ex_scratch).
struct ExchangeArgs {
  const int32_t* pool_blk;
  int32_t* pool_stage;
  const int64_t* pool_time;
  const int32_t* pool_status;
  int32_t* ib_blk;
  int32_t* ib_stage;
  int32_t* ib_status;
  int32_t* total;       // [h] out: movers per destination
  int32_t* total_prot;  // [h] out: protected movers (total when no gate)
  int32_t* n_free;      // [h] out: free slots before placement
  int32_t* fbase;       // [h + 1] free slots of the slabs before d
  int32_t* flist;       // [p1] free slots (offset in their slab), flat
  int32_t* keys;        // [p0], [2 * p0] with several passes: sort keys
  int32_t* vals;        // the same: pool indices
  int32_t* table;       // [passes * bins * blocks + h + 1] digit counts
                        // per block, then movers per destination
  int32_t* start;       // [h + 1] bucket starts (several passes)
  int32_t* prot;        // [p0 + 1] protected-flag prefix (several
                        // passes, TCP)
  int32_t* part;        // [2 * blocks * 4] block partials, by parity
  int64_t p0;
  int32_t pc, ic, ki, h, pds_trail;
  int32_t tcp;          // full-width TCP rows: the pure-ACK class exists
  int32_t passes;       // sort passes (megakernel._ex_plan)
  int32_t dbits;        // bits of one pass's digit
  int32_t v1;           // K_WINDOW only: the previous design's passes
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

// A mover's key: (d << 1) | pure_ack in TCP worlds, d in UDP worlds.
__device__ __forceinline__ int32_t ex_key(const ExchangeArgs& x,
                                          int64_t i) {
  const int32_t d = ex_clip_dst(x, i);
  return x.tcp ? (d << 1) | (ex_pure_ack(x, i) ? 1 : 0) : d;
}

// The digit of `key` in sort pass `p`: one pass sorts by the whole key,
// several passes by the destination alone.
__device__ __forceinline__ int ex_digit(const ExchangeArgs& x, int32_t key,
                                        int p) {
  const int32_t sk = x.passes == 1 ? key : key >> x.tcp;
  return (sk >> (p * x.dbits)) & ((1 << x.dbits) - 1);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31u)) - 1u;
}

// Exclusive scan of one value a thread over the block (B threads, a
// multiple of 32): warp shuffles, then the warps' sums through shared
// memory.  Every thread gets its prefix, and the block's total in
// `total`.
template <int B>
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v,
                                                        int32_t& total) {
  constexpr int NW = B / 32;
  __shared__ int32_t wsum[NW];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int32_t inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[w] = inc;
  __syncthreads();
  int32_t before = 0;
  total = 0;
  for (int i = 0; i < NW; ++i) {
    const int32_t ws = wsum[i];
    before += i < w ? ws : 0;
    total += ws;
  }
  __syncthreads();                 // wsum is rewritten by the next call
  return before + inc - v;
}

// A block partial: three sums and an OR.
struct Ex4 {
  int32_t a, b, c, o;
};

template <int B>
__device__ __forceinline__ Ex4 ex_block_reduce(Ex4 v) {
  constexpr int NW = B / 32;
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ Ex4 s[NW];
  v.a = __reduce_add_sync(FULL, v.a);
  v.b = __reduce_add_sync(FULL, v.b);
  v.c = __reduce_add_sync(FULL, v.c);
  v.o = (int32_t)__reduce_or_sync(FULL, (unsigned)v.o);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  Ex4 r{0, 0, 0, 0};
  for (int i = 0; i < NW; ++i) {
    r.a += s[i].a;
    r.b += s[i].b;
    r.c += s[i].c;
    r.o |= s[i].o;
  }
  __syncthreads();
  return r;
}

// Flips the exchange's parity and publishes this block's partial into it.
// A block folds parity p right after the barrier that follows its
// publish, and the next publish into p comes two publishes later, after
// the next barrier, so one barrier per publish suffices.
template <int B>
__device__ __forceinline__ void ex_publish(const ExchangeArgs& x, int& buf,
                                           Ex4 v) {
  const Ex4 r = ex_block_reduce<B>(v);
  buf ^= 1;
  if (threadIdx.x == 0) {
    int32_t* p = x.part + ((int64_t)buf * gridDim.x + blockIdx.x) * 4;
    p[0] = r.a;
    p[1] = r.b;
    p[2] = r.c;
    p[3] = r.o;
  }
}

// The partials of parity `buf`, folded by the block's first warp: the sums
// over the blocks before this one (`before`) and over every block
// (`all`, whose `o` is the OR of all).  Every thread gets both.
__device__ __forceinline__ void ex_fold(const ExchangeArgs& x, int buf,
                                        Ex4& before, Ex4& all) {
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ Ex4 s_before, s_all;
  if (threadIdx.x < 32) {
    Ex4 bf{0, 0, 0, 0}, al{0, 0, 0, 0};
    const int4* part = reinterpret_cast<const int4*>(x.part) +
                       (int64_t)buf * gridDim.x;
#pragma unroll 4
    for (int k = threadIdx.x; k < (int)gridDim.x; k += 32) {
      // One 16-byte L2 load a block: other blocks wrote the partials.
      const int4 v = __ldcg(part + k);
      al.a += v.x;
      al.b += v.y;
      al.c += v.z;
      al.o |= v.w;
      if (k < (int)blockIdx.x) {
        bf.a += v.x;
        bf.b += v.y;
        bf.c += v.z;
      }
    }
    bf.a = __reduce_add_sync(FULL, bf.a);
    bf.b = __reduce_add_sync(FULL, bf.b);
    bf.c = __reduce_add_sync(FULL, bf.c);
    al.a = __reduce_add_sync(FULL, al.a);
    al.b = __reduce_add_sync(FULL, al.b);
    al.c = __reduce_add_sync(FULL, al.c);
    al.o = (int32_t)__reduce_or_sync(FULL, (unsigned)al.o);
    if (threadIdx.x == 0) {
      s_before = bf;
      s_all = al;
    }
  }
  __syncthreads();
  before = s_before;
  all = s_all;
  __syncthreads();
}

// Shared memory of the sort passes: per-digit running offsets (or
// counts) and the per-warp digit counts of one tile.
template <int B>
struct ExSmem {
  int32_t run[EX_R];
  int32_t wc[B / 32][EX_R];
  int64_t src[B / 32][32];   // a warp's placed rows (ex_put_rows)
  int64_t dst[B / 32][32];
  int32_t step[8][B / 32];   // per-warp counts of a step (ex_step_positions)
};

// One tile of the block's chunk, one element a thread in flat order:
// `dig` is the thread's digit (< EX_R) or -1 when it holds no element.
// Returns s.run[dig] plus the number of earlier elements of the tile with
// the same digit, then adds the tile's counts to s.run.  s.wc must be zero
// on entry and is again on exit.  Every thread of the block calls it.
template <int B>
__device__ __forceinline__ int32_t ex_tile_rank(ExSmem<B>& s, int dig) {
  const unsigned peers = __match_any_sync(0xffffffffu, dig);
  const int w = threadIdx.x >> 5;
  const int before = __popc(peers & lanemask_lt());
  const bool lead = before == 0;
  if (dig >= 0 && lead) s.wc[w][dig] = __popc(peers);
  __syncthreads();
  int32_t pos = 0;
  if (dig >= 0) {
    pos = s.run[dig] + before;
    for (int v = 0; v < w; ++v) pos += s.wc[v][dig];
  }
  __syncthreads();
  if (dig >= 0 && lead) {
    atomicAdd(&s.run[dig], __popc(peers));
    s.wc[w][dig] = 0;
  }
  __syncthreads();
  return pos;
}

template <int B>
__device__ __forceinline__ void ex_zero_wc(ExSmem<B>& s) {
  for (int k = threadIdx.x; k < (B / 32) * EX_R; k += B)
    s.wc[k / EX_R][k % EX_R] = 0;
}

// Copies pool row `src` (`put`) into inbox slot `slot`, the TIME columns
// spliced from pool.time.  The warp's placed rows are listed in shared
// memory in lane order; then its lanes take the rows in turn, a row's
// columns on neighbouring lanes, all loads of a round (U rows a lane
// group) in flight before its stores.  Every lane of the warp calls it.
template <int B>
__device__ __forceinline__ void ex_put_rows(const ExchangeArgs& x,
                                            ExSmem<B>& sm, bool put,
                                            int64_t src, int64_t slot) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int U = 4;                      // rows a lane group a round
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(FULL, put);
  if (put) {
    const int r = __popc(m & lanemask_lt());
    sm.src[w][r] = src;
    sm.dst[w][r] = slot;
    x.ib_stage[slot] = STAGE_IN_FLIGHT;
    if (x.pds_trail) x.ib_status[slot] = x.pool_status[src];
  }
  __syncwarp();
  // Lane groups of GW = 16 or 32 lanes (a power of two >= ic) take one row
  // each a round: lane l copies column l % GW of row l / GW.
  const int gw = x.ic <= 16 ? 16 : 32, rows = 32 / gw;
  const int c = lane & (gw - 1), sub = lane / gw;
  const int n = __popc(m);
  for (int j0 = 0; j0 < n; j0 += rows * U) {
    int32_t v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * rows + sub;
      if (j < n && c < x.ic) {
        const int64_t s = sm.src[w][j];
        if (c == ICOL_TIME_LO)
          v[u] = enc_lo(x.pool_time[s]);
        else if (c == ICOL_TIME_HI)
          v[u] = enc_hi(x.pool_time[s]);
        else
          v[u] = x.pool_blk[s * x.pc + c];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * rows + sub;
      if (j < n && c < x.ic) x.ib_blk[sm.dst[w][j] * x.ic + c] = v[u];
    }
  }
  __syncwarp();                             // sm is rewritten next call
}

// Rows of a digit table a block owns in its grid scan: whole rows, and
// whole (d, class) row pairs when the key carries the class bit.
__device__ __forceinline__ int ex_rows_per_block(int bins, bool pairs) {
  int r = (bins + (int)gridDim.x - 1) / (int)gridDim.x;
  if (pairs) r = (r + 1) & ~1;
  return r;
}

// Grid scan of a digit table, phase 2: the block's rows [r0, r1) in
// place, from `acc` (the entries before them), one tile of B entries at a
// time.  Row k's sum goes to rsum[k - r0] when rsum is not null.
template <int B>
__device__ __forceinline__ void ex_scan_rows(int32_t* T, int r0, int r1,
                                             int32_t acc, int32_t* rsum) {
  const int G = gridDim.x;
  for (int r = r0; r < r1; ++r) {
    int32_t rs = 0;
    for (int e0 = 0; e0 < G; e0 += B) {
      const int e = e0 + threadIdx.x;
      const int64_t at = (int64_t)r * G + e;
      const int32_t v = e < G ? __ldcg(T + at) : 0;
      int32_t tile;
      const int32_t ex = block_exclusive_scan<B>(v, tile);
      if (e < G) T[at] = acc + ex;
      acc += tile;
      rs += tile;
    }
    if (rsum != nullptr && threadIdx.x == 0) rsum[r - r0] = rs;
  }
}

// The sum of a table's rows [r0, r1) (grid scan, phase 1).
template <int B>
__device__ __forceinline__ int32_t ex_rows_sum(const int32_t* T, int r0,
                                               int r1) {
  const int64_t G = gridDim.x;
  int32_t s = 0;
  for (int64_t e = r0 * G + threadIdx.x; e < r1 * G; e += B)
    s += __ldcg(T + e);
  return s;
}

// Positions, in flat order, of the flagged elements of one step of a
// block's chunk: element u of thread t is k0 + u * B + t (U of them a
// thread, so each load and store of the step is coalesced).  Returns in
// pos[u] the number of flagged elements before it in the step, and the
// step's total.  Every thread of the block calls it.
template <int B, int U>
__device__ __forceinline__ int32_t ex_step_positions(ExSmem<B>& sm,
                                                     const bool* flag,
                                                     int32_t* pos) {
  constexpr int NW = B / 32;
  const int w = threadIdx.x >> 5;
  const unsigned lt = lanemask_lt();
  unsigned bal[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    bal[u] = __ballot_sync(0xffffffffu, flag[u]);
    if ((threadIdx.x & 31) == 0) sm.step[u][w] = __popc(bal[u]);
  }
  __syncthreads();
  int32_t acc = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int32_t before = 0, tot = 0;
    for (int v = 0; v < NW; ++v) {
      const int32_t c = sm.step[u][v];
      before += v < w ? c : 0;
      tot += c;
    }
    pos[u] = acc + before + __popc(bal[u] & lt);
    acc += tot;
  }
  __syncthreads();                          // sm.step is rewritten next step
  return acc;
}

// The whole exchange on the calling grid (every thread of every block):
// updates the inbox and the pool's stage, and writes total, total_prot
// and n_free.  Ends without a trailing barrier: the caller syncs before
// it reads what other blocks wrote.  `clk` marks the count, scan, sort
// and place stages.
template <int B>
__device__ __forceinline__ void ex_run(const ExchangeArgs& x,
                                       cg::grid_group& grid, Clk& clk) {
  __shared__ ExSmem<B> s;
  const int G = gridDim.x, b = blockIdx.x, t = threadIdx.x;
  const int64_t gtid = (int64_t)b * B + t, gstride = (int64_t)G * B;
  const int64_t p0 = x.p0, p1 = (int64_t)x.h * x.ki;
  const int P = x.passes, R = 1 << x.dbits, c = x.tcp;
  const bool one = P == 1;
  const int64_t TS = (int64_t)R * G;     // entries of one pass's table
  int32_t* const cnt = x.table + P * TS;  // [h] movers per destination
  const int64_t cp = (p0 + G - 1) / G;
  const int64_t plo = imin((int64_t)b * cp, p0), phi = imin(plo + cp, p0);
  const int64_t cq = (p1 + G - 1) / G;
  const int64_t ilo = imin((int64_t)b * cq, p1), ihi = imin(ilo + cq, p1);
  constexpr int U = 8;                      // elements a thread a step
  int buf = 0;
  Ex4 bef, all;

  // ---- 1. the pool chunk's movers compacted, digit counts; free slots --
  // U rows a thread a step; the step's movers, in flat order, go to keys /
  // vals [plo, plo + nmov) as (key, pool index).  Their outbox stage
  // clears here: no later stage reads it.
  for (int r = t; r < R; r += B) s.run[r] = 0;
  if (!one)                     // the later passes' tables and cnt
    for (int64_t k = gtid; k < (P - 1) * TS + x.h; k += gstride)
      x.table[TS + k] = 0;
  __syncthreads();
  int32_t ack = 0, nmov = 0;
  for (int64_t k0 = plo; k0 < phi; k0 += U * B) {
    int32_t key[U], pos[U];
    bool mv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t k = k0 + u * B + t;
      mv[u] = k < phi && x.pool_stage[k] == STAGE_IN_FLIGHT;
      key[u] = mv[u] ? ex_key(x, k) : 0;
    }
    const int32_t n = ex_step_positions<B, U>(s, mv, pos);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!mv[u]) continue;
      const int64_t k = k0 + u * B + t, q = plo + nmov + pos[u];
      x.keys[q] = key[u];
      x.vals[q] = (int32_t)k;
      x.pool_stage[k] = STAGE_FREE;
      ack |= key[u] & c;
      atomicAdd(&s.run[ex_digit(x, key[u], 0)], 1);
    }
    nmov += n;
  }
  __syncthreads();
  for (int r = t; r < R; r += B) x.table[(int64_t)r * G + b] = s.run[r];
  int32_t nf = 0;
  for (int64_t k = ilo + t; k < ihi; k += B)
    nf += x.ib_stage[k] == STAGE_FREE;
  ex_publish<B>(x, buf, Ex4{nf, 0, 0, ack});
  grid.sync();
  clk.mark(CLK_EX_COUNT);

  // ---- 2. free lists (grid scan of the FREE flags); table scan, 1 ------
  ex_fold(x, buf, bef, all);
  const bool any_ack = all.o != 0;
  {
    int64_t run = bef.a;
    for (int64_t k0 = ilo; k0 < ihi; k0 += U * B) {
      int32_t pos[U];
      bool f[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t k = k0 + u * B + t;
        f[u] = k < ihi && x.ib_stage[k] == STAGE_FREE;
      }
      const int32_t n = ex_step_positions<B, U>(s, f, pos);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t k = k0 + u * B + t;
        if (k >= ihi) continue;
        const uint32_t d = (uint32_t)k / (uint32_t)x.ki;
        const int32_t off = (int32_t)((uint32_t)k - d * (uint32_t)x.ki);
        const int64_t q = run + pos[u];
        if (off == 0) x.fbase[d] = (int32_t)q;
        if (f[u]) x.flist[q] = off;
      }
      run += n;
    }
    if (b == 0 && t == 0) x.fbase[x.h] = all.a;
  }
  const int rpb = ex_rows_per_block(R, one && c);
  const int r0 = imin(b * rpb, R), r1 = imin(r0 + rpb, R);
  ex_publish<B>(x, buf, Ex4{ex_rows_sum<B>(x.table, r0, r1), 0, 0, 0});
  grid.sync();

  // ---- 3. table scan, 2 ------------------------------------------------
  ex_fold(x, buf, bef, all);
  const int32_t m = all.a;                  // movers
  __syncthreads();                          // s.run is reused as row sums
  ex_scan_rows<B>(x.table, r0, r1, bef.a, s.run);
  if (one) {
    // Each destination's movers, per class, are its rows' sums: the
    // tallies and this block's share of the overflow test.
    __syncthreads();
    int32_t over = 0;
    for (int r = r0 + (t << c); r < r1; r += B << c) {
      const int d = r >> c;
      if (d >= x.h) continue;
      const int32_t prot = s.run[r - r0];
      const int32_t tot = prot + (c ? s.run[r - r0 + 1] : 0);
      const int32_t n = __ldcg(x.fbase + d + 1) - __ldcg(x.fbase + d);
      x.total[d] = tot;
      x.total_prot[d] = prot;
      x.n_free[d] = n;
      over |= tot > n;
    }
    ex_publish<B>(x, buf, Ex4{0, 0, 0, over});
  }
  grid.sync();
  clk.mark(CLK_EX_SCAN);

  if (one) {
    // ---- 4. the one pass places -----------------------------------------
    ex_fold(x, buf, bef, all);
    const bool gate = c && any_ack && all.o != 0;
    // Rank digits: the key under the gate (protected, then pure ACKs),
    // else the destination; s.run = the rank, within its destination, of
    // this block's first mover of each digit.
    const bool by_key = gate || !c;
    const int rd = by_key ? R : R >> 1;
    for (int r = t; r < rd; r += B) {
      int32_t v;
      if (by_key) {
        const int64_t row = (int64_t)r * G;
        v = __ldcg(x.table + row + b) -
            __ldcg(x.table + (int64_t)((r >> c) << c) * G);
      } else {
        const int64_t e0 = (int64_t)(2 * r) * G, e1 = e0 + G;
        v = __ldcg(x.table + e0 + b) - __ldcg(x.table + e0) +
            __ldcg(x.table + e1 + b) - __ldcg(x.table + e1);
      }
      s.run[r] = v;
    }
    ex_zero_wc<B>(s);
    __syncthreads();
    for (int64_t q0 = plo; q0 < plo + nmov; q0 += B) {
      const int64_t q = q0 + t;
      int dig = -1, d = 0;
      int64_t i = 0;
      if (q < plo + nmov) {
        const int32_t key = x.keys[q];
        i = x.vals[q];
        d = key >> c;
        dig = by_key ? key : d;
      }
      const int32_t r = ex_tile_rank<B>(s, dig);
      int64_t slot = -1;
      if (dig >= 0 && r < __ldcg(x.n_free + d))
        slot = (int64_t)d * x.ki + __ldcg(x.flist + __ldcg(x.fbase + d) + r);
      ex_put_rows<B>(x, s, slot >= 0, i, slot);
    }
    if (!gate)
      for (int64_t d = gtid; d < x.h; d += gstride)
        x.total_prot[d] = __ldcg(x.total + d);
    clk.mark(CLK_EX_PLACE);
    return;
  }

  // ---- 4. the sort passes ----------------------------------------------
  const int64_t chm = imax((m + G - 1) / G, 1);   // sorted-array chunk
  const int64_t mlo = imin((int64_t)b * chm, (int64_t)m);
  const int64_t mhi = imin(mlo + chm, (int64_t)m);
  const int64_t ch = (x.h + G - 1) / G;           // cnt chunk
  const int64_t hlo = imin((int64_t)b * ch, (int64_t)x.h);
  const int64_t hhi = imin(hlo + ch, (int64_t)x.h);
  int32_t over = 0;
  for (int p = 0; p < P; ++p) {
    const int32_t* T = x.table + p * TS;
    const int32_t* const kin = x.keys + (p & 1) * p0;
    const int32_t* const vin = x.vals + (p & 1) * p0;
    int32_t* const kout = x.keys + ((p + 1) & 1) * p0;
    int32_t* const vout = x.vals + ((p + 1) & 1) * p0;
    int32_t* const Tn = x.table + (p + 1) * TS;
    const bool last = p == P - 1;
    for (int r = t; r < R; r += B)
      s.run[r] = __ldcg(T + (int64_t)r * G + b);
    ex_zero_wc<B>(s);
    __syncthreads();
    // Pass 0 reads the block's compacted movers, later passes the
    // previous pass's output.
    const int64_t lo = p == 0 ? plo : mlo, hi = p == 0 ? plo + nmov : mhi;
    for (int64_t i0 = lo; i0 < hi; i0 += B) {
      const int64_t i = i0 + t;
      int dig = -1;
      int32_t key = 0, v = 0;
      if (i < hi) {
        key = __ldcg(kin + i);
        v = __ldcg(vin + i);
        dig = ex_digit(x, key, p);
        if (p == 0) atomicAdd(&cnt[key >> c], 1);
      }
      const int32_t pos = ex_tile_rank<B>(s, dig);
      if (dig >= 0) {
        kout[pos] = key;
        vout[pos] = v;
        if (!last)    // the next pass's count, by the block that takes pos
          atomicAdd(&Tn[(int64_t)ex_digit(x, key, p + 1) * G + pos / chm],
                    1);
      }
    }
    if (last) {
      // Tallies and this block's share of the overflow test (the bucket
      // starts and counts were scanned before this pass).
      for (int64_t d = gtid; d < x.h; d += gstride) {
        const int32_t tot = __ldcg(cnt + d);
        const int32_t n = __ldcg(x.fbase + d + 1) - __ldcg(x.fbase + d);
        x.total[d] = tot;
        x.n_free[d] = n;
        over |= tot > n;
      }
      ex_publish<B>(x, buf, Ex4{0, 0, 0, over});
      grid.sync();
      break;
    }
    grid.sync();
    // Grid scan of the next pass's table (and, before the last pass, of
    // cnt into the bucket starts), phase 1 ...
    const bool starts = p + 1 == P - 1;
    int32_t sc = 0;
    if (starts)
      for (int64_t d = hlo + t; d < hhi; d += B) sc += __ldcg(cnt + d);
    ex_publish<B>(x, buf, Ex4{ex_rows_sum<B>(Tn, r0, r1), sc, 0, 0});
    grid.sync();
    // ... and phase 2.
    ex_fold(x, buf, bef, all);
    ex_scan_rows<B>(Tn, r0, r1, bef.a, nullptr);
    if (starts) {
      int32_t acc = bef.b;
      for (int64_t d0 = hlo; d0 < hhi; d0 += B) {
        const int64_t d = d0 + t;
        int32_t tile;
        const int32_t ex = block_exclusive_scan<B>(
            d < hhi ? __ldcg(cnt + d) : 0, tile);
        if (d < hhi) x.start[d] = acc + ex;
        acc += tile;
      }
      if (b == 0 && t == 0) x.start[x.h] = m;
    }
    grid.sync();
  }
  clk.mark(CLK_EX_BUCKET);
  ex_fold(x, buf, bef, all);
  const bool gate = c && any_ack && all.o != 0;
  const int32_t* const ks = x.keys + (P & 1) * p0;
  const int32_t* const vs = x.vals + (P & 1) * p0;
  if (gate) {
    // Grid scan of the protected flags over the sorted movers.
    int32_t sp = 0;
    for (int64_t q = mlo + t; q < mhi; q += B) sp += (__ldcg(ks + q) & 1) == 0;
    ex_publish<B>(x, buf, Ex4{sp, 0, 0, 0});
    grid.sync();
    ex_fold(x, buf, bef, all);
    int32_t acc = bef.a;
    for (int64_t q0 = mlo; q0 < mhi; q0 += B) {
      const int64_t q = q0 + t;
      int32_t tile;
      const int32_t ex = block_exclusive_scan<B>(
          q < mhi ? (__ldcg(ks + q) & 1) == 0 : 0, tile);
      if (q < mhi) x.prot[q] = acc + ex;
      acc += tile;
    }
    if (b == 0 && t == 0) x.prot[m] = all.a;
    grid.sync();
  }

  // ---- 5. place: rank = position - bucket start ------------------------
  for (int64_t q0 = mlo; q0 < mhi; q0 += B) {
    const int64_t q = q0 + t;
    int64_t src = 0, slot = -1;
    if (q < mhi) {
      const int32_t key = __ldcg(ks + q);
      const int d = key >> c;
      const int32_t st = __ldcg(x.start + d);
      int32_t r = (int32_t)q - st;
      if (gate) {
        const int32_t pst = __ldcg(x.prot + st);
        const int32_t pq = __ldcg(x.prot + q) - pst;
        const int32_t tp = __ldcg(x.prot + __ldcg(x.start + d + 1)) - pst;
        r = (key & 1) ? tp + (r - pq) : pq;
      }
      src = __ldcg(vs + q);
      if (r < __ldcg(x.n_free + d))
        slot = (int64_t)d * x.ki + __ldcg(x.flist + __ldcg(x.fbase + d) + r);
    }
    ex_put_rows<B>(x, s, slot >= 0, src, slot);
  }
  for (int64_t d = gtid; d < x.h; d += gstride) {
    int32_t tp = __ldcg(x.total + d);
    if (gate)
      tp = __ldcg(x.prot + __ldcg(x.start + d + 1)) -
           __ldcg(x.prot + __ldcg(x.start + d));
    x.total_prot[d] = tp;
  }
  clk.mark(CLK_EX_PLACE);
}

// ---------------------------------------------------------------------------
// The previous design, kept for K_WINDOW's comparison runs (x.v1): atomic
// per-destination counts, a grid scan into bucket starts, an atomic bucket
// fill in undefined order, then one thread per destination that sorts its
// bucket by flat pool index (insertion sort) and walks its slab handing
// out free slots in rank order.  Scratch: cnt = total, fill cursors =
// n_free, bucket starts = start, bucket lists = keys, the two gate words
// = part[0..1].
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ex_count_row_v1(const ExchangeArgs& x,
                                                int64_t i) {
  if (x.pool_stage[i] != STAGE_IN_FLIGHT) return;
  atomicAdd(&x.total[ex_clip_dst(x, i)], 1);
  if (x.tcp && ex_pure_ack(x, i)) atomicOr(&x.part[0], 1);
}

__device__ __forceinline__ void ex_bucket_row_v1(const ExchangeArgs& x,
                                                 int64_t i) {
  if (x.pool_stage[i] != STAGE_IN_FLIGHT) return;
  const int d = ex_clip_dst(x, i);
  const int pos = atomicAdd(&x.n_free[d], 1);
  x.keys[x.start[d] + pos] = (int32_t)i;
  x.pool_stage[i] = STAGE_FREE;
}

// Places destination d's movers; returns (total movers, protected
// movers, free slots before placement).
__device__ __forceinline__ void ex_place_dest_v1(const ExchangeArgs& x,
                                                 int d, int32_t& total,
                                                 int32_t& total_prot,
                                                 int32_t& n_free) {
  const int n = x.total[d];
  int32_t* L = x.keys + x.start[d];
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
  const bool two = x.tcp && x.part[1] != 0;
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
