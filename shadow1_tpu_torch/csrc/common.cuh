// Shared constants and helpers of the port's CUDA kernels (sm_90a).
// Every constant mirrors shadow1_tpu/core/state.py, nic.py or rng.py.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace s1 {

constexpr int64_t INV = INT64_MAX;          // SIMTIME_INVALID
constexpr int STAGE_FREE = 0;
constexpr int STAGE_TX_QUEUED = 1;
constexpr int STAGE_IN_FLIGHT = 2;
constexpr int STAGE_RX_QUEUED = 3;
constexpr int PROTO_TCP = 6;
constexpr int PROTO_UDP = 17;
constexpr int SOCK_UDP = 1;
constexpr int UDP_RING = 8;
constexpr int TCP_HEADER_SIZE = 40;
constexpr int UDP_HEADER_SIZE = 28;

constexpr int ERR_POOL_OVERFLOW = 1 << 0;

constexpr int PDS_SND_CREATED = 1 << 0;
constexpr int PDS_SND_INTERFACE_SENT = 1 << 2;
constexpr int PDS_INET_SENT = 1 << 3;
constexpr int PDS_ROUTER_ENQUEUED = 1 << 5;
constexpr int PDS_ROUTER_DROPPED = 1 << 6;
constexpr int PDS_RCV_SOCKET_PROCESSED = 1 << 8;

// Packed-row columns (narrow UDP layout: NCOLS_UDP = 14, then the four
// outbox extension columns addressed from the end of the row).
constexpr int ICOL_SRC = 0, ICOL_SPORT = 1, ICOL_DPORT = 2, ICOL_PROTO = 3;
constexpr int ICOL_LEN = 8, ICOL_PAYLOAD = 9;
constexpr int ICOL_TIME_LO = 10, ICOL_TIME_HI = 11;
constexpr int ICOL_CTR_LO = 12, ICOL_CTR_HI = 13;
constexpr int OEXT_DST = 0, OEXT_LAT_LO = 1, OEXT_LAT_HI = 2, OEXT_PRIO = 3;
constexpr int OEXT_COLS = 4;
constexpr int RCOLS = 5;   // route_blk: LAT_LO, LAT_HI, REL, JIT_LO, JIT_HI

// nic.py
constexpr int64_t SCALE = 1000000000LL;
constexpr int64_t REFILL_INTERVAL_NS = 1000000LL;
constexpr int64_t MTU = 1500;
constexpr int64_t CODEL_TARGET_NS = 10000000LL;
constexpr int64_t CODEL_INTERVAL_NS = 100000000LL;
constexpr int64_t ONE_MS = 1000000LL;

// Per-phase cycle counters of K_WINDOW's kernels, compiled in only under
// -DS1_PHASE_CLOCKS (core/_build.py builds that variant as a library of
// its own, "window_clk"; the normal build carries none of it).  One
// thread -- the thread (k_window) or lane 0 of the warp (k_window_tcp)
// that runs the traced host -- adds the clock64() cycles since its
// previous mark to acc[phase].  Phases: the window's opening -- the
// exchange's zeroing and count pass, its scan, its bucket pass,
// its placement (with k_window's host scan), then the rest of the opening
// (the host scan of k_window_tcp, the fold) -- the tick setup (k_window),
// the router enqueue, per
// delivery round r (at most 4 traced) its select/NIC, begin, gate and
// finish, the receive state's write-back (k_window), then run_timers,
// the app tick, transmit and staging, the TX drain, the post-step scan,
// the step's closing barrier and fold, and the window's close;
// CLK_STEPS counts the traced micro-steps.
enum ClkPhase {
  CLK_OPEN = 0, CLK_ENQUEUE = 1, CLK_ROUND = 2,   // + 4 * r + part
  CLK_SELECT = 0, CLK_BEGIN = 1, CLK_GATE = 2, CLK_FINISH = 3,
  CLK_TIMERS = 18, CLK_TICK = 19, CLK_TRANSMIT = 20, CLK_DRAIN = 21,
  CLK_SCAN = 22, CLK_CLOSE = 23, CLK_WCLOSE = 24, CLK_SETUP = 25,
  CLK_RXCLOSE = 26, CLK_EX_COUNT = 27, CLK_EX_SCAN = 28, CLK_EX_BUCKET = 29,
  CLK_EX_PLACE = 30, CLK_STEPS = 31, CLK_WORDS = 32
};

struct Clk {
#ifdef S1_PHASE_CLOCKS
  long long* acc;
  long long t;
  bool on;
  __device__ void start() {
    if (on) t = clock64();
  }
  __device__ void mark(int phase) {
    if (!on) return;
    const long long n = clock64();
    acc[phase] += n - t;
    t = n;
  }
  __device__ void count_step() {
    if (on) acc[CLK_STEPS] += 1;
  }
#else
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void count_step() {}
#endif
  __device__ void round(int r, int part) {
    mark(CLK_ROUND + 4 * (r < 3 ? r : 3) + part);
  }
};

// A Clk that traces when `on` (and the build has the counters).
__device__ __forceinline__ Clk make_clk(long long* acc, bool on) {
  Clk c;
#ifdef S1_PHASE_CLOCKS
  c.acc = acc;
  c.t = 0;
  c.on = on && acc != nullptr;
#endif
  return c;
}

__device__ __forceinline__ int64_t dec_i64(int32_t lo, int32_t hi) {
  return ((int64_t)hi << 31) | (int64_t)lo;
}
__device__ __forceinline__ int32_t enc_lo(int64_t x) {
  return (int32_t)(x & 0x7FFFFFFFLL);
}
__device__ __forceinline__ int32_t enc_hi(int64_t x) {
  return (int32_t)(x >> 31);
}
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}
// Python/JAX floor division and modulo.
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int64_t floormod(int64_t a, int64_t b) {
  int64_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ int64_t wire_size(int32_t proto, int32_t len) {
  int32_t w = len + (proto == PROTO_TCP ? TCP_HEADER_SIZE : UDP_HEADER_SIZE);
  return (int64_t)w * SCALE;
}

// nic.refill's longest counted interval: a function of the rate alone (an
// int64 division), so a caller that refills more than once takes it once.
__device__ __forceinline__ int64_t refill_span(int64_t rate) {
  const int64_t r1 = rate > 1 ? rate : 1;
  return REFILL_INTERVAL_NS + floordiv(MTU * SCALE, r1) + 1;
}

// nic.refill: lazy continuous token refill (updates where mask), given
// refill_span(rate).
__device__ __forceinline__ void refill(int64_t& tokens, int64_t& last,
                                       int64_t rate, int64_t span,
                                       int64_t now, bool mask) {
  int64_t dt = now - last;
  dt = dt < 0 ? 0 : (dt > span ? span : dt);
  int64_t cap = rate * REFILL_INTERVAL_NS + MTU * SCALE;
  int64_t acc = imin(cap, tokens + dt * rate);
  if (mask) {
    tokens = acc;
    last = now;
  }
}
__device__ __forceinline__ void refill(int64_t& tokens, int64_t& last,
                                       int64_t rate, int64_t now,
                                       bool mask) {
  refill(tokens, last, rate, refill_span(rate), now, mask);
}

// nic.time_until: ns until `deficit` more tokens accrue (ceil).
__device__ __forceinline__ int64_t time_until(int64_t deficit,
                                              int64_t rate) {
  int64_t r = rate > 1 ? rate : 1;
  return floordiv(deficit + r - 1, r);
}

// ---------------------------------------------------------------------------
// Team-width policy of the per-host device code.  A host's scans (its inbox
// and outbox slabs, its socket table) run on a team: Solo is one thread
// (the per-phase kernels, phold's K_WINDOW), Warp is the 32 lanes of a
// warp (K_WINDOW's TCP kernels and K_DELIVER's TCP kernel, one warp per
// host), Cta the threads of a block (the resident tgen kernel, one block
// per host).  A scan strides the lanes over the slab -- coalesced loads -- and
// ends in a reduction that every lane gets; min, sum and OR of integers do
// not depend on order, and a lexicographic min that ends in the slot
// index picks the lowest slot on a full tie, as the serial walk does.  The
// serial parts run on uniform values in every lane; a write that is not
// the lane's own slot is made by the leader, with a `sync` before it (the
// lanes have read what it overwrites) and after it (before the team's
// next read).
// ---------------------------------------------------------------------------

struct Solo {
  static constexpr int W = 1;
  __device__ int lane() const { return 0; }
  __device__ bool leader() const { return true; }
  __device__ void sync() const {}
  __device__ int32_t min32(int32_t x) const { return x; }
  __device__ int32_t sum(int32_t x) const { return x; }
  __device__ bool any(bool p) const { return p; }
  __device__ uint32_t ballot(bool p) const { return p ? 1u : 0u; }
  __device__ int64_t min64(int64_t x) const { return x; }
  // Lexicographic mins: (a, b) and (a, b, c), in place.
  __device__ void min2(int64_t&, int32_t&) const {}
  __device__ void min3(int64_t&, int64_t&, int32_t&) const {}
};

struct Warp {
  static constexpr int W = 32;
  static constexpr unsigned FULL = 0xffffffffu;
  __device__ int lane() const { return (int)(threadIdx.x & 31u); }
  __device__ bool leader() const { return lane() == 0; }
  __device__ void sync() const { __syncwarp(); }
  __device__ int32_t min32(int32_t x) const {
    return __reduce_min_sync(FULL, x);
  }
  __device__ int32_t sum(int32_t x) const {
    return __reduce_add_sync(FULL, x);
  }
  __device__ bool any(bool p) const { return __any_sync(FULL, p) != 0; }
  __device__ uint32_t ballot(bool p) const { return __ballot_sync(FULL, p); }
  __device__ int64_t min64(int64_t x) const {
    for (int o = 16; o > 0; o >>= 1) {
      const int64_t y = __shfl_xor_sync(FULL, (long long)x, o);
      x = y < x ? y : x;
    }
    return x;
  }
  __device__ int64_t sum64(int64_t x) const {
    for (int o = 16; o > 0; o >>= 1)
      x += __shfl_xor_sync(FULL, (long long)x, o);
    return x;
  }
  __device__ int32_t or32(int32_t x) const {
    return (int32_t)__reduce_or_sync(FULL, (unsigned)x);
  }
  __device__ void min2(int64_t& a, int32_t& b) const {
    for (int o = 16; o > 0; o >>= 1) {
      const int64_t a2 = __shfl_xor_sync(FULL, (long long)a, o);
      const int32_t b2 = __shfl_xor_sync(FULL, b, o);
      if (a2 < a || (a2 == a && b2 < b)) {
        a = a2;
        b = b2;
      }
    }
  }
  __device__ void min3(int64_t& a, int64_t& b, int32_t& c) const {
    for (int o = 16; o > 0; o >>= 1) {
      const int64_t a2 = __shfl_xor_sync(FULL, (long long)a, o);
      const int64_t b2 = __shfl_xor_sync(FULL, (long long)b, o);
      const int32_t c2 = __shfl_xor_sync(FULL, c, o);
      if (a2 < a || (a2 == a && (b2 < b || (b2 == b && c2 < c)))) {
        a = a2;
        b = b2;
        c = c2;
      }
    }
  }
};

// A row's arrival time and its order key ((src << 40) | ctr, pkt_id).
__device__ __forceinline__ int64_t row_time(const int32_t* row) {
  return dec_i64(row[ICOL_TIME_LO], row[ICOL_TIME_HI]);
}
__device__ __forceinline__ int64_t row_key(const int32_t* row) {
  return ((int64_t)row[ICOL_SRC] << 40) |
         dec_i64(row[ICOL_CTR_LO], row[ICOL_CTR_HI]);
}

// Where the walks read an inbox slot's (time, key) -- `slot` is the flat
// index hh * ki + k, `a` the kernel's DeliverArgs or TransportArgs: from
// the row itself (InboxRows, every kernel but one), or from the copies that
// the resident tgen kernel keeps in shared memory (window.cu; `t` and `k`
// are offset so that its host's flat slot indexes them), which `put`
// keeps up to date when a row is written.
struct InboxRows {
  template <class A>
  __device__ int64_t time(const A& a, int64_t slot) const {
    return row_time(a.ib_blk + slot * a.ic);
  }
  template <class A>
  __device__ int64_t key(const A& a, int64_t slot) const {
    return row_key(a.ib_blk + slot * a.ic);
  }
  __device__ void put(int64_t, int64_t, int64_t) const {}
};

struct CachedRows {
  int64_t* t;
  int64_t* k;
  template <class A>
  __device__ int64_t time(const A&, int64_t slot) const { return t[slot]; }
  template <class A>
  __device__ int64_t key(const A&, int64_t slot) const { return k[slot]; }
  __device__ void put(int64_t slot, int64_t time, int64_t key) const {
    t[slot] = time;
    k[slot] = key;
  }
};

// Cta<B> is the B threads of a block (the resident tgen kernel, window.cu:
// one block per host).  Walks stride all B threads; a reduction is the
// warp's shuffles, then the warps' partials through shared memory, which
// every thread folds in warp order.  The partials are double-buffered by
// a parity that each thread keeps in its team object, so a reduction takes
// one barrier: the next reduction writes the other buffer, and the one
// after it writes this one only after the next one's barrier, which no
// thread passes before every thread has read this one.  So one team object
// serves a whole launch, and every thread makes the same sequence of
// reductions (as the Warp team's full-mask collectives require too).
// `sync` is the block barrier; a ballot only for a one-warp block
// (next_free below takes a min for wider ones).
template <int B>
struct Cta {
  static constexpr int W = B;
  static constexpr int NW = B / 32;
  static_assert(B % 32 == 0 && NW <= 32, "Cta takes whole warps");
  mutable int par = 0;
  __device__ int lane() const { return (int)threadIdx.x; }
  __device__ bool leader() const { return threadIdx.x == 0; }
  __device__ void sync() const { __syncthreads(); }
  __device__ bool any(bool p) const { return __syncthreads_or(p) != 0; }
  __device__ uint32_t ballot(bool p) const {
    static_assert(B == 32, "a ballot covers one warp");
    return __ballot_sync(0xffffffffu, p);
  }

  // The warps' partials, [parity][word][warp].
  __device__ static int64_t (&parts())[2][3][NW] {
    __shared__ int64_t s[2][3][NW];
    return s;
  }
  // The block's fold of x by op (commutative and associative).
  template <class Op>
  __device__ int64_t fold(int64_t x, const Op& op) const {
    for (int o = 16; o > 0; o >>= 1)
      x = op(x, (int64_t)__shfl_xor_sync(0xffffffffu, (long long)x, o));
    int64_t* const s = parts()[par][0];
    if ((threadIdx.x & 31u) == 0) s[threadIdx.x >> 5] = x;
    __syncthreads();
    int64_t r = s[0];
    for (int w = 1; w < NW; ++w) r = op(r, s[w]);
    par ^= 1;
    return r;
  }
  __device__ int64_t min64(int64_t x) const {
    return fold(x, [](int64_t a, int64_t b) { return a < b ? a : b; });
  }
  __device__ int64_t sum64(int64_t x) const {
    return fold(x, [](int64_t a, int64_t b) { return a + b; });
  }
  __device__ int32_t min32(int32_t x) const { return (int32_t)min64(x); }
  __device__ int32_t sum(int32_t x) const { return (int32_t)sum64(x); }
  __device__ int32_t or32(int32_t x) const {
    return (int32_t)fold(x, [](int64_t a, int64_t b) { return a | b; });
  }
  // Lexicographic mins: (a, b) and (a, b, c), in place.
  __device__ void min3(int64_t& a, int64_t& b, int32_t& c) const {
    for (int o = 16; o > 0; o >>= 1) {
      const int64_t a2 = __shfl_xor_sync(0xffffffffu, (long long)a, o);
      const int64_t b2 = __shfl_xor_sync(0xffffffffu, (long long)b, o);
      const int32_t c2 = __shfl_xor_sync(0xffffffffu, c, o);
      if (a2 < a || (a2 == a && (b2 < b || (b2 == b && c2 < c)))) {
        a = a2;
        b = b2;
        c = c2;
      }
    }
    auto& s = parts()[par];
    if ((threadIdx.x & 31u) == 0) {
      const int w = threadIdx.x >> 5;
      s[0][w] = a;
      s[1][w] = b;
      s[2][w] = c;
    }
    __syncthreads();
    a = s[0][0];
    b = s[1][0];
    c = (int32_t)s[2][0];
    for (int w = 1; w < NW; ++w) {
      const int64_t a2 = s[0][w], b2 = s[1][w];
      const int32_t c2 = (int32_t)s[2][w];
      if (a2 < a || (a2 == a && (b2 < b || (b2 == b && c2 < c)))) {
        a = a2;
        b = b2;
        c = c2;
      }
    }
    par ^= 1;
  }
  __device__ void min2(int64_t& a, int32_t& b) const {
    int64_t z = 0;
    min3(a, z, b);
  }
};

// Calls f(k, stage[k]) for every slot k < n of a slab, in ascending k on
// each lane.  The Warp team strides its lanes over the slab (coalesced
// loads).  The Solo team reads the stage words eight at a time -- two
// 16-byte loads where the eight are whole and aligned -- before the eight
// calls, so one load latency serves them and the rows the calls read for
// live slots are all in flight at once; a call may write its own slot's
// stage (each word is read before its call).
template <class Team, class F>
__device__ __forceinline__ void each_slot(const Team& tm,
                                          const int32_t* stage, int n,
                                          const F& f) {
  if constexpr (Team::W == 1) {
    for (int k0 = 0; k0 < n; k0 += 8) {
      int32_t s[8];
      if (k0 + 8 <= n &&
          (reinterpret_cast<uintptr_t>(stage + k0) & 15u) == 0) {
        const int4 lo = *reinterpret_cast<const int4*>(stage + k0);
        const int4 hi = *reinterpret_cast<const int4*>(stage + k0 + 4);
        s[0] = lo.x; s[1] = lo.y; s[2] = lo.z; s[3] = lo.w;
        s[4] = hi.x; s[5] = hi.y; s[6] = hi.z; s[7] = hi.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[j] = k0 + j < n ? stage[k0 + j] : STAGE_FREE;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (k0 + j < n) f(k0 + j, s[j]);
    }
  } else {
    for (int k = tm.lane(); k < n; k += Team::W) f(k, stage[k]);
  }
}

// Pins a loaded value before this point: an empty asm that takes it as an
// input keeps the compiler from sinking its load past here, so the loads
// of one step of a chain (transport_small, deliver_small) are in flight
// together.
__device__ __forceinline__ void keep(int64_t x) { asm volatile("" ::"l"(x)); }
__device__ __forceinline__ void keep(int32_t x) { asm volatile("" ::"r"(x)); }

// Words [0, n) of p (n <= 8) into v[0..8), `fill` past n: two 16-byte
// loads where all eight are there and aligned.
__device__ __forceinline__ void load8(const int32_t* p, int n, int32_t* v,
                                      int32_t fill) {
  if (n == 8 && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    const int4 lo = *reinterpret_cast<const int4*>(p);
    const int4 hi = *reinterpret_cast<const int4*>(p + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = k < n ? p[k] : fill;
  }
}

// 8 bytes from global memory to the calling thread's shared memory
// without passing through registers (cp.async); copy_wait() waits for every
// copy the thread has issued and makes them visible to it.
__device__ __forceinline__ void copy8_async(int2* dst, const int32_t* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The lowest index >= `from` (and < n) whose `stage` is STAGE_FREE, or n:
// the team reads W stages at a time and takes the lowest set bit of the
// ballot (a min over the lanes in a Cta team).
template <class Team>
__device__ __forceinline__ int next_free(const Team& tm, const int32_t* stage,
                                         int from, int n) {
  for (int c0 = from; c0 < n; c0 += Team::W) {
    const int k = c0 + tm.lane();
    const bool f = k < n && stage[k] == STAGE_FREE;
    if constexpr (Team::W > 32) {
      const int m = tm.min32(f ? k : n);
      if (m < n) return m;
    } else {
      const uint32_t m = tm.ballot(f);
      if (m != 0u) return c0 + __ffs((int)m) - 1;
    }
  }
  return n;
}

// rng._mix32 and keyed_bits over three ids.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t keyed_bits3(uint32_t k0, uint32_t k1,
                                                uint32_t a, uint32_t b,
                                                uint32_t c) {
  const uint32_t g = 0x9E3779B9u;
  uint32_t h = mix32(k0 ^ 0x85EBCA6Bu);
  h = mix32(h ^ (a + g));
  h = mix32(h ^ (b + g * 3u));
  h = mix32(h ^ (c + g * 5u));
  return mix32(h ^ k1);
}

// rng.keyed_uniform: (bits >> 8) * 2^-24, exact in f32.
__device__ __forceinline__ float keyed_uniform3(uint32_t k0, uint32_t k1,
                                                uint32_t a, uint32_t b,
                                                uint32_t c) {
  return __fmul_rn((float)(keyed_bits3(k0, k1, a, b, c) >> 8),
                   5.9604644775390625e-8f);
}

}  // namespace s1
