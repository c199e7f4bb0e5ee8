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

// nic.refill: lazy continuous token refill (updates where mask).
__device__ __forceinline__ void refill(int64_t& tokens, int64_t& last,
                                       int64_t rate, int64_t now,
                                       bool mask) {
  int64_t r1 = rate > 1 ? rate : 1;
  int64_t fill_time = REFILL_INTERVAL_NS + floordiv(MTU * SCALE, r1) + 1;
  int64_t dt = now - last;
  dt = dt < 0 ? 0 : (dt > fill_time ? fill_time : dt);
  int64_t cap = rate * REFILL_INTERVAL_NS + MTU * SCALE;
  int64_t acc = imin(cap, tokens + dt * rate);
  if (mask) {
    tokens = acc;
    last = now;
  }
}

// nic.time_until: ns until `deficit` more tokens accrue (ceil).
__device__ __forceinline__ int64_t time_until(int64_t deficit,
                                              int64_t rate) {
  int64_t r = rate > 1 ? rate : 1;
  return floordiv(deficit + r - 1, r);
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

}  // namespace s1
