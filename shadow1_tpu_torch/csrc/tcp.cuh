// The TCP machine's per-host device functions, shared by the TCP branches
// of K_DELIVER (deliver.cuh: arrival processing), K_TRANSPORT
// (transport.cuh: transmit and the timer term of the post-step scan) and
// K_WINDOW (window.cu: all of these, plus run_timers and the socket API
// that the apps' device ticks call, e.g. bulk_tick.cuh).
//
// What they compute: shadow1_tpu/transport/tcp.py, rule for rule and in
// the same order -- process_arrivals (socket match, passive open, RST,
// handshake, ACK clocking with the congestion-control hooks of cong.py
// (Reno or CUBIC, a template parameter: see below), the
// sender SACK scoreboard, RTT/RTO, reassembly, FIN, delayed ACKs, the
// reply segment), run_timers (one due timer per host: SYN / SYN-ACK /
// RTO back-off, delayed ACK, TIME_WAIT, persist), the socket API
// (connect_v, write_v, close_v; consume_all is bulk's sink, bulk_tick.cuh)
// and transmit (one socket per host, up to TX_SLOTS segments, outbox
// back-pressure, the re-tick).  The plain torch version is
// shadow1_tpu_torch/transport/tcp.py.
//
// Layout: one team per host (common.cuh: Solo, one thread, in the
// per-phase K_TRANSPORT; Warp, 32 lanes, in the TCP kernels of K_DELIVER
// and K_WINDOW).  The table walks -- the socket match, the timer pick,
// transmit's eligibility, the sink's consume and close -- stride the
// team's lanes over the host's sockets and end in a min, sum or any.  A
// host's one socket is then gathered into registers (struct Sock: ~45
// scalars and 24 range words) in every lane, updated on uniform values,
// and stored back by the leader under the same mask as the JAX scatter.
// The socket table keeps the JAX package's dtypes, with uint32 leaves held
// in int64 words; here they are uint32_t, so sequence sums wrap as u32 and
// sdiff is the int32 reinterpretation of the difference.
//
// The scoreboard inserts of process_arrivals re-pack the ranges of every
// connected host when ANY host inserts (the JAX package's global
// `lax.cond` gate, which is not the identity per host), so arrival
// processing is split in two: tcp_arrival_begin computes each host's
// contribution to the two gates and stores the connected socket back,
// the caller ORs the bits over the whole grid, and tcp_arrival_finish
// reloads the socket and runs with the global gates.  What crosses the
// gate is the Arrival record below (no socket in it), kept in device
// scratch by the caller.
//
// Congestion control (cong.py) is a template parameter of the two
// functions that call its hooks, tcp_arrival_finish (new ACK, fast
// recovery) and tcp_run_timers (RTO): CONG_RENO instantiations compile to
// the inline NewReno arithmetic alone, and only CONG_CUBIC ones carry
// CUBIC's f32 window target and its cube root (xla_cbrt.cuh), so Reno's
// kernels keep their registers.  The launchers pick the instantiation on
// the host, once per launch, from TcpArgs.cong.
#pragma once
#include "common.cuh"
#include "xla_cbrt.cuh"

namespace s1 {

constexpr int TCP_FLAG_FIN = 1, TCP_FLAG_SYN = 2, TCP_FLAG_RST = 4,
              TCP_FLAG_PSH = 8, TCP_FLAG_ACK = 16;
constexpr int TCPS_CLOSED = 0, TCPS_LISTEN = 1, TCPS_SYNSENT = 2,
              TCPS_SYNRECEIVED = 3, TCPS_ESTABLISHED = 4, TCPS_FINWAIT1 = 5,
              TCPS_FINWAIT2 = 6, TCPS_CLOSING = 7, TCPS_TIMEWAIT = 8,
              TCPS_CLOSEWAIT = 9, TCPS_LASTACK = 10;
constexpr int SOCK_FREE = 0, SOCK_TCP = 2;
constexpr int TCP_MSS = 1460;
constexpr int64_t RTO_INIT = 1000000000LL;
constexpr int64_t RTO_MIN = 200000000LL;
constexpr int64_t RTO_MAX = 120000000000LL;
constexpr int64_t DELACK_DELAY = 40000000LL;
constexpr int64_t TIMEWAIT_DELAY = 60000000000LL;
constexpr int64_t SND_BUF_MAX = 4194304;
constexpr int64_t RCV_BUF_MAX = 6291456;
constexpr int32_t INIT_CWND = 10 * TCP_MSS;
constexpr int32_t SSTHRESH_INIT = 1 << 30;
constexpr int SACK_BLOCKS = 3, SACK_RANGES = 8, SSACK_RANGES = 4;
constexpr int ERR_SOCKET_OVERFLOW = 1 << 1;
constexpr int QDISC_RR = 1;
// cong.ALGORITHMS, by index (TcpArgs.cong).
constexpr int CONG_RENO = 0, CONG_CUBIC = 1;

// Emission lanes (core/emit.py) and the full-width row's TCP columns.
constexpr int SLOT_RX_REPLY = 0, SLOT_TIMER = 1, SLOT_TX_BASE = 3,
              TX_SLOTS = 4, NUM_SLOTS = 7;
constexpr int ICOL_FLAGS = 4, ICOL_SEQ = 5, ICOL_ACK = 6, ICOL_WND = 7;
constexpr int ICOL_TS_LO = 14, ICOL_TS_HI = 15, ICOL_TSE_LO = 16,
              ICOL_TSE_HI = 17, ICOL_SACK0_LO = 18;
constexpr int ICOLS = 24;

// Gate bits of one delivery round (OR-ed over the grid).
constexpr int GATE_SSACK = 1, GATE_RX = 2;

__device__ __forceinline__ int32_t sdiff(uint32_t a, uint32_t b) {
  return (int32_t)(a - b);
}
__device__ __forceinline__ bool seq_lt(uint32_t a, uint32_t b) {
  return sdiff(a, b) < 0;
}
__device__ __forceinline__ bool seq_leq(uint32_t a, uint32_t b) {
  return sdiff(a, b) <= 0;
}
__device__ __forceinline__ uint32_t seq_min(uint32_t a, uint32_t b) {
  return seq_lt(a, b) ? a : b;
}
__device__ __forceinline__ uint32_t seq_max(uint32_t a, uint32_t b) {
  return seq_lt(a, b) ? b : a;
}
__device__ __forceinline__ int32_t imin32(int32_t a, int32_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int32_t imax32(int32_t a, int32_t b) {
  return a > b ? a : b;
}
__device__ __forceinline__ bool sendable_state(int32_t s) {
  return s == TCPS_ESTABLISHED || s == TCPS_CLOSEWAIT ||
         s == TCPS_FINWAIT1 || s == TCPS_CLOSING || s == TCPS_LASTACK;
}

// The socket table ([h, slots] per field; ranges [h, slots, R]) and the
// per-host params the TCP branches read.  Mirrored field for field by
// the ctypes.Structure in shadow1_tpu_torch/core/megakernel.py.  `gates`
// is K_DELIVER's [rx_batch] words, or K_WINDOW's [2][rx_batch] (by
// micro-step parity).
struct TcpArgs {
  int32_t* stype;
  int32_t* tcp_state;
  int32_t* local_port;
  int32_t* peer_host;
  int32_t* peer_port;
  int32_t* parent;
  uint8_t* accepted;
  int64_t* child_order;
  int32_t* backlog;
  int64_t* snd_una;
  int64_t* snd_nxt;
  int64_t* snd_end;
  int32_t* snd_wnd;
  int32_t* snd_buf_cap;
  int32_t* cwnd;
  int32_t* ssthresh;
  int32_t* dup_acks;
  int64_t* recover;
  uint8_t* in_recovery;
  int64_t* retrans_nxt;
  int64_t* retrans_end;
  uint8_t* app_closed;
  int64_t* rcv_nxt;
  int64_t* rcv_read;
  int32_t* rcv_buf_cap;
  int64_t* sack_lo;
  int64_t* sack_hi;
  int64_t* fin_seq;
  int64_t* ts_recent;
  int64_t* srtt;
  int64_t* rttvar;
  int64_t* rto;
  int64_t* t_rto;
  int64_t* t_delack;
  int64_t* t_tw;
  int64_t* t_persist;
  int32_t* delack_pending;
  int64_t* at_bytes;
  int64_t* at_last;
  int64_t* cub_epoch;
  int32_t* cub_wmax;
  int64_t* ssack_lo;
  int64_t* ssack_hi;
  int32_t* retx_segs;
  int32_t* error;
  int64_t* bytes_sent;
  int64_t* bytes_recv;
  const int32_t* def_snd_buf;
  const int32_t* def_rcv_buf;
  const uint8_t* autotune_snd;
  const uint8_t* autotune_rcv;
  int32_t* rr_next;
  uint8_t* em_valid;     // [h, e] emission lanes
  int32_t* em_blk;       // [h, e, pc]
  int32_t* gates;        // grid-wide gate words (see above)
  int32_t* err;          // state.err (K_DELIVER ORs socket overflow in)
  void* carry;           // [h] deliver.cuh HostCarry records (TCP kernels)
  int64_t min_latency;
  int32_t slots, e, pc, qdisc;
  int32_t cong;            // CONG_RENO or CONG_CUBIC
};

// One socket's fields in registers (transport/tcp.py _Sock.FIELDS and
// RANGE_FIELDS).
struct Sock {
  int32_t stype, tcp_state, local_port, peer_host, peer_port, parent;
  bool accepted;
  int64_t child_order;
  int32_t backlog;
  uint32_t snd_una, snd_nxt, snd_end;
  int32_t snd_wnd, snd_buf_cap, cwnd, ssthresh, dup_acks;
  uint32_t recover;
  bool in_recovery;
  uint32_t retrans_nxt, retrans_end;
  bool app_closed;
  uint32_t rcv_nxt, rcv_read;
  int32_t rcv_buf_cap;
  uint32_t fin_seq;
  int64_t ts_recent, srtt, rttvar, rto, t_rto, t_delack, t_tw, t_persist;
  int32_t delack_pending;
  int64_t at_bytes, at_last, cub_epoch;
  int32_t cub_wmax, retx_segs, error;
  int64_t bytes_sent, bytes_recv;
  uint32_t sack_lo[SACK_RANGES], sack_hi[SACK_RANGES];
  uint32_t ssack_lo[SSACK_RANGES], ssack_hi[SSACK_RANGES];
};

__device__ __forceinline__ Sock sock_load(const TcpArgs& t, int hh, int s) {
  const int64_t i = (int64_t)hh * t.slots + s;
  Sock v;
  v.stype = t.stype[i];
  v.tcp_state = t.tcp_state[i];
  v.local_port = t.local_port[i];
  v.peer_host = t.peer_host[i];
  v.peer_port = t.peer_port[i];
  v.parent = t.parent[i];
  v.accepted = t.accepted[i] != 0;
  v.child_order = t.child_order[i];
  v.backlog = t.backlog[i];
  v.snd_una = (uint32_t)t.snd_una[i];
  v.snd_nxt = (uint32_t)t.snd_nxt[i];
  v.snd_end = (uint32_t)t.snd_end[i];
  v.snd_wnd = t.snd_wnd[i];
  v.snd_buf_cap = t.snd_buf_cap[i];
  v.cwnd = t.cwnd[i];
  v.ssthresh = t.ssthresh[i];
  v.dup_acks = t.dup_acks[i];
  v.recover = (uint32_t)t.recover[i];
  v.in_recovery = t.in_recovery[i] != 0;
  v.retrans_nxt = (uint32_t)t.retrans_nxt[i];
  v.retrans_end = (uint32_t)t.retrans_end[i];
  v.app_closed = t.app_closed[i] != 0;
  v.rcv_nxt = (uint32_t)t.rcv_nxt[i];
  v.rcv_read = (uint32_t)t.rcv_read[i];
  v.rcv_buf_cap = t.rcv_buf_cap[i];
  v.fin_seq = (uint32_t)t.fin_seq[i];
  v.ts_recent = t.ts_recent[i];
  v.srtt = t.srtt[i];
  v.rttvar = t.rttvar[i];
  v.rto = t.rto[i];
  v.t_rto = t.t_rto[i];
  v.t_delack = t.t_delack[i];
  v.t_tw = t.t_tw[i];
  v.t_persist = t.t_persist[i];
  v.delack_pending = t.delack_pending[i];
  v.at_bytes = t.at_bytes[i];
  v.at_last = t.at_last[i];
  v.cub_epoch = t.cub_epoch[i];
  v.cub_wmax = t.cub_wmax[i];
  v.retx_segs = t.retx_segs[i];
  v.error = t.error[i];
  v.bytes_sent = t.bytes_sent[i];
  v.bytes_recv = t.bytes_recv[i];
  for (int r = 0; r < SACK_RANGES; ++r) {
    v.sack_lo[r] = (uint32_t)t.sack_lo[i * SACK_RANGES + r];
    v.sack_hi[r] = (uint32_t)t.sack_hi[i * SACK_RANGES + r];
  }
  for (int r = 0; r < SSACK_RANGES; ++r) {
    v.ssack_lo[r] = (uint32_t)t.ssack_lo[i * SSACK_RANGES + r];
    v.ssack_hi[r] = (uint32_t)t.ssack_hi[i * SSACK_RANGES + r];
  }
  return v;
}

// Writes every TCP field back.  A field the machine did not assign holds
// its gathered value, so this equals the JAX scatter of the dirty fields.
__device__ __forceinline__ void sock_store(const TcpArgs& t, int hh, int s,
                                           const Sock& v) {
  const int64_t i = (int64_t)hh * t.slots + s;
  t.stype[i] = v.stype;
  t.tcp_state[i] = v.tcp_state;
  t.local_port[i] = v.local_port;
  t.peer_host[i] = v.peer_host;
  t.peer_port[i] = v.peer_port;
  t.parent[i] = v.parent;
  t.accepted[i] = v.accepted ? 1 : 0;
  t.child_order[i] = v.child_order;
  t.backlog[i] = v.backlog;
  t.snd_una[i] = v.snd_una;
  t.snd_nxt[i] = v.snd_nxt;
  t.snd_end[i] = v.snd_end;
  t.snd_wnd[i] = v.snd_wnd;
  t.snd_buf_cap[i] = v.snd_buf_cap;
  t.cwnd[i] = v.cwnd;
  t.ssthresh[i] = v.ssthresh;
  t.dup_acks[i] = v.dup_acks;
  t.recover[i] = v.recover;
  t.in_recovery[i] = v.in_recovery ? 1 : 0;
  t.retrans_nxt[i] = v.retrans_nxt;
  t.retrans_end[i] = v.retrans_end;
  t.app_closed[i] = v.app_closed ? 1 : 0;
  t.rcv_nxt[i] = v.rcv_nxt;
  t.rcv_read[i] = v.rcv_read;
  t.rcv_buf_cap[i] = v.rcv_buf_cap;
  t.fin_seq[i] = v.fin_seq;
  t.ts_recent[i] = v.ts_recent;
  t.srtt[i] = v.srtt;
  t.rttvar[i] = v.rttvar;
  t.rto[i] = v.rto;
  t.t_rto[i] = v.t_rto;
  t.t_delack[i] = v.t_delack;
  t.t_tw[i] = v.t_tw;
  t.t_persist[i] = v.t_persist;
  t.delack_pending[i] = v.delack_pending;
  t.at_bytes[i] = v.at_bytes;
  t.at_last[i] = v.at_last;
  t.cub_epoch[i] = v.cub_epoch;
  t.cub_wmax[i] = v.cub_wmax;
  t.retx_segs[i] = v.retx_segs;
  t.error[i] = v.error;
  t.bytes_sent[i] = v.bytes_sent;
  t.bytes_recv[i] = v.bytes_recv;
  for (int r = 0; r < SACK_RANGES; ++r) {
    t.sack_lo[i * SACK_RANGES + r] = v.sack_lo[r];
    t.sack_hi[i * SACK_RANGES + r] = v.sack_hi[r];
  }
  for (int r = 0; r < SSACK_RANGES; ++r) {
    t.ssack_lo[i * SSACK_RANGES + r] = v.ssack_lo[r];
    t.ssack_hi[i * SSACK_RANGES + r] = v.ssack_hi[r];
  }
}

// tcp._apply_defaults: a fresh socket of host hh (tcp_new).
__device__ __forceinline__ Sock sock_defaults(const TcpArgs& t, int hh) {
  Sock v;
  v.stype = SOCK_FREE;
  v.tcp_state = TCPS_CLOSED;
  v.local_port = 0;
  v.peer_host = -1;
  v.peer_port = 0;
  v.parent = -1;
  v.accepted = false;
  v.child_order = 0;
  v.backlog = 0;
  v.snd_una = 0;
  v.snd_nxt = 0;
  v.snd_end = 1;
  v.snd_wnd = TCP_MSS;
  v.snd_buf_cap = t.def_snd_buf[hh];
  v.cwnd = INIT_CWND;
  v.ssthresh = SSTHRESH_INIT;
  v.dup_acks = 0;
  v.recover = 0;
  v.in_recovery = false;
  v.retrans_nxt = 1;
  v.retrans_end = 1;
  v.app_closed = false;
  v.rcv_nxt = 0;
  v.rcv_read = 0;
  v.rcv_buf_cap = t.def_rcv_buf[hh];
  v.fin_seq = 0;
  v.ts_recent = 0;
  v.srtt = 0;
  v.rttvar = 0;
  v.rto = RTO_INIT;
  v.t_rto = INV;
  v.t_delack = INV;
  v.t_tw = INV;
  v.t_persist = INV;
  v.delack_pending = 0;
  v.at_bytes = 0;
  v.at_last = 0;
  v.cub_epoch = 0;
  v.cub_wmax = 0;
  v.retx_segs = 0;
  v.error = 0;
  v.bytes_sent = 0;
  v.bytes_recv = 0;
  for (int r = 0; r < SACK_RANGES; ++r) v.sack_lo[r] = v.sack_hi[r] = 0;
  for (int r = 0; r < SSACK_RANGES; ++r) v.ssack_lo[r] = v.ssack_hi[r] = 0;
  return v;
}

// ---------------------------------------------------------------------------
// Socket API on a gathered socket (tcp.connect_v, write_v, close_v), for
// the apps' device ticks
// ---------------------------------------------------------------------------

// tcp.connect_v: every TCP field of the slot back to its default (the
// ranges too), then an active open whose SYN leaves when the RTO timer
// armed at `now` fires.
__device__ __forceinline__ void sock_connect(Sock& v, const TcpArgs& t,
                                             int hh, int32_t dst_host,
                                             int32_t dst_port,
                                             int32_t local_port,
                                             int64_t now) {
  v = sock_defaults(t, hh);
  v.stype = SOCK_TCP;
  v.tcp_state = TCPS_SYNSENT;
  v.local_port = local_port;
  v.peer_host = dst_host;
  v.peer_port = dst_port;
  v.t_rto = now;
}

// tcp.write_v: snd_end advances toward `target_end` (exclusive), bounded
// by snd_una + snd_buf_cap; a write into a zero window with no timer
// armed arms the persist timer.
__device__ __forceinline__ void sock_write(Sock& v, uint32_t target_end,
                                           int64_t now) {
  const uint32_t cap_end = v.snd_una + (uint32_t)v.snd_buf_cap;
  const uint32_t new_end = seq_lt(target_end, cap_end) ? target_end
                                                        : cap_end;
  if (!seq_lt(v.snd_end, new_end)) return;
  v.snd_end = new_end;
  if (v.snd_wnd == 0 && v.t_persist == INV && v.t_rto == INV &&
      sendable_state(v.tcp_state))
    v.t_persist = now + v.rto;
}

// tcp.close_v: FIN at the end of the stream.
__device__ __forceinline__ void sock_close(Sock& v) {
  if (v.stype == SOCK_TCP) v.app_closed = true;
}


// tcp.recv_window.
__device__ __forceinline__ int32_t recv_window(uint32_t rcv_nxt,
                                               uint32_t rcv_read,
                                               int32_t cap) {
  const int32_t w = imax32(cap - sdiff(rcv_nxt, rcv_read), 0);
  const int32_t thresh = imin32(TCP_MSS, imax32(cap / 2, 1));
  return w < thresh ? 0 : w;
}

// emit.put of one full-width TCP row into lane `lane` of host hh
// (unset columns 0, payload -1, priority 0.0f); the team's leader calls it.
__device__ __forceinline__ void em_put_tcp(const TcpArgs& t, int hh, int lane,
                                           int32_t dst, int32_t sport,
                                           int32_t dport, int32_t flags,
                                           uint32_t seq, uint32_t ack,
                                           int32_t wnd, int32_t len,
                                           int64_t ts_echo, int64_t t_send,
                                           const uint32_t* slo,
                                           const uint32_t* shi) {
  int32_t* row = t.em_blk + ((int64_t)hh * t.e + lane) * t.pc;
  for (int c = 0; c < t.pc; ++c) row[c] = 0;
  row[ICOL_SPORT] = sport;
  row[ICOL_DPORT] = dport;
  row[ICOL_PROTO] = PROTO_TCP;
  row[ICOL_FLAGS] = flags;
  row[ICOL_SEQ] = (int32_t)seq;
  row[ICOL_ACK] = (int32_t)ack;
  row[ICOL_WND] = wnd;
  row[ICOL_LEN] = len;
  row[ICOL_PAYLOAD] = -1;
  row[ICOL_TIME_LO] = enc_lo(t_send);
  row[ICOL_TIME_HI] = enc_hi(t_send);
  row[ICOL_TSE_LO] = enc_lo(ts_echo);
  row[ICOL_TSE_HI] = enc_hi(ts_echo);
  if (slo != nullptr) {
    for (int i = 0; i < SACK_BLOCKS; ++i) {
      row[ICOL_SACK0_LO + 2 * i] = (int32_t)slo[i];
      row[ICOL_SACK0_LO + 2 * i + 1] = (int32_t)shi[i];
    }
  }
  row[t.pc - OEXT_COLS + OEXT_DST] = dst;
  t.em_valid[(int64_t)hh * t.e + lane] = 1;
}

// ---------------------------------------------------------------------------
// Byte-range scoreboards (tcp._ranges_insert_many / _ranges_drain)
// ---------------------------------------------------------------------------

// Inserts K ranges [s[k], e[k]) where m[k]: one stable sort by distance
// from `base` (empties last, ties in input order: insertion sort with a
// strict comparison), then one merge pass; past R ranges the farthest
// are dropped.
template <int R, int K>
__device__ __forceinline__ void ranges_insert(uint32_t (&lo)[R],
                                              uint32_t (&hi)[R],
                                              const bool (&m)[K],
                                              const uint32_t (&s)[K],
                                              const uint32_t (&e)[K],
                                              uint32_t base) {
  constexpr int N = R + K;
  uint32_t l1[N], h1[N];
  int64_t key[N];
  for (int i = 0; i < R; ++i) {
    l1[i] = lo[i];
    h1[i] = hi[i];
  }
  for (int k = 0; k < K; ++k) {
    l1[R + k] = m[k] ? s[k] : 0u;
    h1[R + k] = m[k] ? e[k] : 0u;
  }
  for (int i = 0; i < N; ++i)
    key[i] = l1[i] != h1[i] ? (int64_t)sdiff(l1[i], base) : (1LL << 40);
  for (int i = 1; i < N; ++i) {
    const int64_t kk = key[i];
    const uint32_t ll = l1[i], hh = h1[i];
    int j = i - 1;
    while (j >= 0 && key[j] > kk) {
      key[j + 1] = key[j];
      l1[j + 1] = l1[j];
      h1[j + 1] = h1[j];
      --j;
    }
    key[j + 1] = kk;
    l1[j + 1] = ll;
    h1[j + 1] = hh;
  }
  uint32_t out_lo[R], out_hi[R];
  for (int i = 0; i < R; ++i) out_lo[i] = out_hi[i] = 0;
  int ptr = 0;
  uint32_t cur_lo = 0, cur_hi = 0;
  bool cur_valid = false;
  for (int i = 0; i < N; ++i) {
    const uint32_t li = l1[i], hii = h1[i];
    const bool vi = li != hii;
    const bool merge = vi && cur_valid && seq_leq(li, cur_hi);
    const bool start = vi && !merge;
    if (start && cur_valid) {
      if (ptr < R) {
        out_lo[ptr] = cur_lo;
        out_hi[ptr] = cur_hi;
      }
      ++ptr;
    }
    if (merge && seq_lt(cur_hi, hii)) cur_hi = hii;
    if (start) {
      cur_lo = li;
      cur_hi = hii;
    }
    cur_valid = cur_valid || vi;
  }
  if (cur_valid && ptr < R) {
    out_lo[ptr] = cur_lo;
    out_hi[ptr] = cur_hi;
  }
  for (int i = 0; i < R; ++i) {
    lo[i] = out_lo[i];
    hi[i] = out_hi[i];
  }
}

// Advances nxt through the ranges it reaches, popping them; returns the
// bytes drained.
template <int R>
__device__ __forceinline__ int32_t ranges_drain(uint32_t (&lo)[R],
                                                uint32_t (&hi)[R],
                                                uint32_t& nxt, bool mask) {
  int32_t drained = 0;
  for (int it = 0; it < R; ++it) {
    const bool take = mask && lo[0] != hi[0] && seq_leq(lo[0], nxt);
    if (!take) continue;
    const uint32_t new_nxt = seq_lt(nxt, hi[0]) ? hi[0] : nxt;
    drained += sdiff(new_nxt, nxt);
    nxt = new_nxt;
    for (int i = 0; i + 1 < R; ++i) {
      lo[i] = lo[i + 1];
      hi[i] = hi[i + 1];
    }
    lo[R - 1] = hi[R - 1] = 0;
  }
  return drained;
}

// tcp._rtt_update (rtt > 0 under the mask, so `/` is floor division).
__device__ __forceinline__ void rtt_update(Sock& v, bool mask, int64_t rtt) {
  if (!mask || rtt <= 0) return;
  const bool first = v.srtt == 0;
  const int64_t srtt_n = first ? rtt : v.srtt - v.srtt / 8 + rtt / 8;
  const int64_t dev = srtt_n > rtt ? srtt_n - rtt : rtt - srtt_n;
  const int64_t rttvar_n = first ? rtt / 2 : v.rttvar - v.rttvar / 4 + dev / 4;
  int64_t rto_n = srtt_n + imax(4 * rttvar_n, ONE_MS);
  rto_n = rto_n < RTO_MIN ? RTO_MIN : (rto_n > RTO_MAX ? RTO_MAX : rto_n);
  v.srtt = srtt_n;
  v.rttvar = rttvar_n;
  v.rto = rto_n;
}

// ---------------------------------------------------------------------------
// Congestion control: cong.py's hooks on one gathered socket
// ---------------------------------------------------------------------------

// CUBIC's f32 constants as XLA CPU folds them (cong.py): 1 / 1e9, 1 / MSS,
// (1 - beta) / (C * MSS), C, beta, (1 + beta) / 2, SND_BUF_MAX / MSS.
constexpr float CUBIC_NS = 1e-09f;
constexpr float CUBIC_INV_MSS = 0.000684931525f;
constexpr float CUBIC_K_ARG = 0.000513698673f;
constexpr float CUBIC_C = 0.4f;
constexpr float CUBIC_BETA = 0.7f;
constexpr float CUBIC_FAST_CONV = 0.85f;
constexpr float CUBIC_WMAX_SEG = 2872.81104f;

// cong._cubic_target: W_cubic(t + RTT) in bytes, the f32 sequence XLA CPU
// runs (two fused multiply-adds), truncated to i32.
__device__ __forceinline__ int32_t cubic_target(const Sock& v, int64_t tick) {
  const float wmax = __int2float_rn(v.cub_wmax);
  const float k = cbrt_xla(fmaxf(__fmul_rn(wmax, CUBIC_K_ARG), 0.0f));
  const float t_s = __ll2float_rn(imax(tick - v.cub_epoch, 0));
  const float rtt_s = __fmul_rn(__ll2float_rn(imax(v.srtt, 1)), CUBIC_NS);
  const float d = __fsub_rn(__fmaf_rn(t_s, CUBIC_NS, rtt_s), k);
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(d, CUBIC_C), d), d);
  float w = __fmaf_rn(wmax, CUBIC_INV_MSS, cube);
  w = fminf(fmaxf(w, 2.0f), CUBIC_WMAX_SEG);
  return __float2int_rz(__fmul_rn(w, (float)TCP_MSS));
}

// i32(f32(cwnd) * f), truncating (the JAX astype).
__device__ __forceinline__ int32_t cwnd_scaled(int32_t cwnd, float f) {
  return __float2int_rz(__fmul_rn(__int2float_rn(cwnd), f));
}

// The new-ACK hook (cong.new_ack) on a socket whose ACK is new outside
// recovery (`normal`): slow start below ssthresh, then Reno's linear or
// CUBIC's cubic growth.
template <int Cong>
__device__ __forceinline__ void cong_new_ack(Sock& v, bool normal,
                                             int32_t acked_bytes,
                                             int64_t tick) {
  if (!normal) return;
  if (v.cwnd < v.ssthresh) {
    v.cwnd = imin32(v.cwnd + acked_bytes, v.ssthresh);
    return;
  }
  const int32_t reno_step =
      imax32((TCP_MSS * TCP_MSS) / imax32(v.cwnd, 1), 1);
  if constexpr (Cong == CONG_CUBIC) {
    if (v.cub_epoch == 0) {          // a fresh epoch
      v.cub_epoch = tick;
      v.cub_wmax = imax32(v.cub_wmax, v.cwnd);
    }
    const int32_t target = cubic_target(v, tick);
    // The JAX `//` floors and `/` truncates: they differ only on a
    // negative quotient, which the clip at 0 maps to 0 either way.  The
    // i64 quotient goes to i32 with wrap-around, as XLA's convert.
    int32_t step = (int32_t)((int64_t)(target - v.cwnd) * acked_bytes /
                             imax32(v.cwnd, TCP_MSS));
    step = imin32(imax32(step, 0), imax32(acked_bytes, TCP_MSS));
    v.cwnd = v.cwnd + imax32(step, reno_step);
  } else {
    v.cwnd = v.cwnd + reno_step;
  }
}

// The fast-recovery hook (cong.enter_recovery) at the third duplicate ACK.
template <int Cong>
__device__ __forceinline__ void cong_enter_recovery(Sock& v,
                                                    int32_t flight) {
  if constexpr (Cong == CONG_CUBIC) {
    // Fast convergence: a Wmax below the previous one shrinks further.
    const int32_t wmax = v.cwnd < v.cub_wmax
                             ? cwnd_scaled(v.cwnd, CUBIC_FAST_CONV)
                             : v.cwnd;
    const int32_t reduced =
        imax32(cwnd_scaled(v.cwnd, CUBIC_BETA), 2 * TCP_MSS);
    v.cub_wmax = wmax;
    v.ssthresh = reduced;
    v.cwnd = reduced + 3 * TCP_MSS;
    v.cub_epoch = 0;
  } else {
    const int32_t half = imax32(flight / 2, 2 * TCP_MSS);
    v.ssthresh = half;
    v.cwnd = half + 3 * TCP_MSS;
  }
}

// The RTO hook (cong.timeout) of an established retransmission timeout.
template <int Cong>
__device__ __forceinline__ void cong_timeout(Sock& v, int32_t flight) {
  if constexpr (Cong == CONG_CUBIC) {
    v.ssthresh = imax32(cwnd_scaled(v.cwnd, CUBIC_BETA), 2 * TCP_MSS);
    v.cub_wmax = imax32(v.cub_wmax, v.cwnd);
    v.cub_epoch = 0;
  } else {
    v.ssthresh = imax32(flight / 2, 2 * TCP_MSS);
  }
  v.cwnd = TCP_MSS;
}

// ---------------------------------------------------------------------------
// Arrival processing (tcp.process_arrivals), split at the global gates
// ---------------------------------------------------------------------------

// The delivered segment's fields (engine.RxPkt).
struct Pkt {
  int32_t src, sport, dport, flags, wnd, len;
  uint32_t seq, ack;
  int64_t ts, tse, id;
  uint32_t sack_lo[SACK_BLOCKS], sack_hi[SACK_BLOCKS];
};

__device__ __forceinline__ Pkt pkt_decode(const int32_t* row, int64_t id) {
  Pkt p;
  p.src = row[ICOL_SRC];
  p.sport = row[ICOL_SPORT];
  p.dport = row[ICOL_DPORT];
  p.flags = row[ICOL_FLAGS];
  p.seq = (uint32_t)row[ICOL_SEQ];
  p.ack = (uint32_t)row[ICOL_ACK];
  p.wnd = row[ICOL_WND];
  p.len = row[ICOL_LEN];
  p.ts = dec_i64(row[ICOL_TS_LO], row[ICOL_TS_HI]);
  p.tse = dec_i64(row[ICOL_TSE_LO], row[ICOL_TSE_HI]);
  p.id = id;
  for (int i = 0; i < SACK_BLOCKS; ++i) {
    p.sack_lo[i] = (uint32_t)row[ICOL_SACK0_LO + 2 * i];
    p.sack_hi[i] = (uint32_t)row[ICOL_SACK0_LO + 2 * i + 1];
  }
  return p;
}

// One host's arrival across the gate barrier (kept in device scratch by
// the TCP kernels): the segment, the masks taken before the gates, and no
// socket -- tcp_arrival_begin stores the connected socket (and a spawned
// child) back to the table, and tcp_arrival_finish reloads it.
struct Arrival {
  Pkt p;
  int64_t tick;
  bool mask, has_conn, has_lsn, spawn, dup_syn, m, m_live, rep;
  bool f_syn, f_ack, f_fin, f_rst, est_like, ackp, can_rcv, fits, ooo_ok;
  bool sack_m[SACK_BLOCKS];
  int32_t rep_flags, conn_slot, child_slot, off, new_bytes;
  uint32_t end_seq;
  int32_t gate_bits;      // this host's contribution: GATE_SSACK | GATE_RX
};

// Up to the gates: socket match, passive open, RST, handshake; the
// masks the two scoreboard gates are taken over.  `mask` is the host's
// TCP delivery of this round.  Returns the socket-overflow error bit.
template <class Team>
__device__ __forceinline__ int32_t tcp_arrival_begin(const Team& tm,
                                                     const TcpArgs& t,
                                                     Arrival& a, int hh,
                                                     const int32_t* row,
                                                     int64_t id, int64_t tick,
                                                     bool mask) {
  const int S = t.slots;
  a.mask = mask;
  a.has_conn = a.has_lsn = a.spawn = a.m = a.m_live = a.rep = false;
  a.dup_syn = a.est_like = a.ackp = a.can_rcv = a.fits = a.ooo_ok = false;
  a.f_syn = a.f_ack = a.f_fin = a.f_rst = false;
  for (int i = 0; i < SACK_BLOCKS; ++i) a.sack_m[i] = false;
  a.rep_flags = 0;
  a.conn_slot = a.child_slot = S - 1;
  a.off = a.new_bytes = 0;
  a.end_seq = 0;
  a.tick = tick;
  a.gate_bits = 0;
  if (!mask) return 0;
  a.p = pkt_decode(row, id);
  const Pkt& p = a.p;
  a.f_syn = (p.flags & TCP_FLAG_SYN) != 0;
  a.f_ack = (p.flags & TCP_FLAG_ACK) != 0;
  a.f_fin = (p.flags & TCP_FLAG_FIN) != 0;
  a.f_rst = (p.flags & TCP_FLAG_RST) != 0;

  // Socket match: lowest connected slot, lowest listener, lowest free
  // (three min-reductions over the team's lanes).
  int32_t conn = S, lsn = S, fre = S;
  for (int s = tm.lane(); s < S; s += Team::W) {
    const int64_t i = (int64_t)hh * S + s;
    const int32_t st = t.stype[i];
    if (st == SOCK_FREE && fre == S) fre = s;
    if (st != SOCK_TCP || t.local_port[i] != p.dport) continue;
    const int32_t ts_ = t.tcp_state[i];
    if (ts_ == TCPS_LISTEN) {
      if (lsn == S) lsn = s;
    } else if (ts_ != TCPS_CLOSED && conn == S && t.peer_host[i] == p.src &&
               t.peer_port[i] == p.sport) {
      conn = s;
    }
  }
  conn = tm.min32(conn);
  lsn = tm.min32(lsn);
  fre = tm.min32(fre);
  a.has_conn = conn < S;
  a.conn_slot = conn < S ? conn : S - 1;
  a.has_lsn = lsn < S;
  const bool want_child = !a.has_conn && a.has_lsn && a.f_syn && !a.f_ack &&
                          !a.f_rst;
  const bool have_free = fre < S;
  a.spawn = want_child && have_free;
  a.child_slot = fre < S ? fre : S - 1;
  const int32_t err = (want_child && !have_free) ? ERR_SOCKET_OVERFLOW : 0;

  if (a.spawn) {
    Sock c = sock_defaults(t, hh);
    c.stype = SOCK_TCP;
    c.tcp_state = TCPS_SYNRECEIVED;
    c.local_port = p.dport;
    c.peer_host = p.src;
    c.peer_port = p.sport;
    c.parent = lsn;
    c.child_order = p.id;
    c.rcv_nxt = p.seq + 1u;
    c.rcv_read = p.seq + 1u;
    c.snd_una = 0;
    c.snd_nxt = 1;
    c.snd_wnd = p.wnd;
    c.ts_recent = p.ts;
    c.t_rto = tick + RTO_INIT;
    if (tm.leader()) sock_store(t, hh, a.child_slot, c);
  }

  a.m = a.has_conn;
  if (!a.m) {
    tm.sync();
    return err;
  }

  Sock v = sock_load(t, hh, a.conn_slot);
  if (a.f_rst) {
    v.tcp_state = TCPS_CLOSED;
    v.stype = SOCK_FREE;
    v.error = 104;
    v.t_rto = v.t_delack = v.t_tw = v.t_persist = INV;
  }
  a.m_live = !a.f_rst;
  const bool ml = a.m_live;

  const bool synack = ml && a.f_syn && a.f_ack &&
                      v.tcp_state == TCPS_SYNSENT && p.ack == v.snd_nxt;
  if (synack) {
    const uint32_t nxt0 = v.snd_nxt;
    v.tcp_state = TCPS_ESTABLISHED;
    v.rcv_nxt = p.seq + 1u;
    v.rcv_read = p.seq + 1u;
    v.snd_una = p.ack;
    v.retrans_nxt = nxt0;
    v.retrans_end = nxt0;
    v.snd_wnd = imax32(p.wnd, TCP_MSS);
    v.ts_recent = p.ts;
    v.t_rto = INV;
  }
  rtt_update(v, synack && p.tse > 0, tick - p.tse);
  if (synack) {
    a.rep = true;
    a.rep_flags = TCP_FLAG_ACK;
  }

  a.dup_syn = ml && a.f_syn && !a.f_ack && v.tcp_state == TCPS_SYNRECEIVED;
  if (a.dup_syn) {
    a.rep = true;
    a.rep_flags = TCP_FLAG_SYN | TCP_FLAG_ACK;
  }

  const bool hs_done = ml && a.f_ack && !a.f_syn &&
                       v.tcp_state == TCPS_SYNRECEIVED && p.ack == v.snd_nxt;
  if (hs_done) {
    const uint32_t nxt0 = v.snd_nxt;
    v.tcp_state = TCPS_ESTABLISHED;
    v.snd_una = p.ack;
    v.retrans_nxt = nxt0;
    v.retrans_end = nxt0;
    v.snd_wnd = imax32(p.wnd, TCP_MSS);
    v.t_rto = INV;
  }
  rtt_update(v, hs_done && p.tse > 0, tick - p.tse);

  const int32_t s0 = v.tcp_state;
  a.est_like = s0 == TCPS_ESTABLISHED || s0 == TCPS_FINWAIT1 ||
               s0 == TCPS_FINWAIT2 || s0 == TCPS_CLOSING ||
               s0 == TCPS_CLOSEWAIT || s0 == TCPS_LASTACK;
  a.ackp = ml && a.f_ack && !a.f_syn && a.est_like;
  for (int i = 0; i < SACK_BLOCKS; ++i) {
    a.sack_m[i] = a.ackp && p.sack_lo[i] != p.sack_hi[i];
    if (a.sack_m[i]) a.gate_bits |= GATE_SSACK;
  }
  // Reception masks: nothing between here and their use in the JAX code
  // changes rcv_nxt, rcv_read or rcv_buf_cap.
  a.can_rcv = ml && a.est_like && !a.f_syn && p.len > 0;
  a.off = sdiff(p.seq, v.rcv_nxt);
  a.end_seq = p.seq + (uint32_t)p.len;
  a.new_bytes = sdiff(a.end_seq, v.rcv_nxt);
  a.fits = sdiff(a.end_seq, v.rcv_read) <= v.rcv_buf_cap;
  a.ooo_ok = a.can_rcv && a.off > 0 && a.fits;
  if (a.ooo_ok) a.gate_bits |= GATE_RX;
  // No other host touches this socket before tcp_arrival_finish reloads it.
  tm.sync();
  if (tm.leader()) sock_store(t, hh, a.conn_slot, v);
  tm.sync();
  return err;
}

// The rest of process_arrivals under the grid-wide gates, then the
// socket store and the reply segment into lane `reply_slot`; `Cong` is
// the congestion control.
template <int Cong, class Team>
__device__ __forceinline__ void tcp_arrival_finish(const Team& tm,
                                                   const TcpArgs& t,
                                                   Arrival& a, int hh,
                                                   int32_t gates,
                                                   int reply_slot) {
  const Pkt& p = a.p;
  const int64_t tick = a.tick;
  bool in_adv = false, old_data = false, fin_now = false, probe = false;
  bool tw_refin = false, ack_now = false;
  const bool reply0 = (a.m && a.rep) || a.spawn;
  const bool orphan = a.mask && !a.has_conn && !a.spawn && !a.dup_syn &&
                      !a.f_rst && !(a.has_lsn && a.f_syn);
  if (!a.m && !reply0 && !orphan) return;
  Sock v = sock_load(t, hh, a.spawn ? a.child_slot : a.conn_slot);
  if (a.m) {
    const bool ml = a.m_live;
    const bool ackp = a.ackp;
    const bool new_ack = ackp && seq_lt(v.snd_una, p.ack) &&
                         seq_leq(p.ack, v.snd_nxt);
    const int32_t acked_bytes = new_ack ? sdiff(p.ack, v.snd_una) : 0;
    const bool wnd_upd = ackp && seq_leq(p.ack, v.snd_nxt);
    if (wnd_upd) v.snd_wnd = p.wnd;
    const bool data_pend = sdiff(v.snd_end, v.snd_nxt) > 0 || v.app_closed;
    if (wnd_upd && p.wnd == 0 && data_pend && v.t_persist == INV)
      v.t_persist = tick + v.rto;
    if (wnd_upd && p.wnd > 0) v.t_persist = INV;

    const int32_t snd_tgt = (int32_t)imin(2 * (int64_t)v.cwnd, SND_BUF_MAX);
    if (new_ack && v.snd_buf_cap < snd_tgt && t.autotune_snd[hh])
      v.snd_buf_cap = imax32(snd_tgt, v.snd_buf_cap);

    // Sender SACK scoreboard (global gate), dead ranges, highest sack.
    if (gates & GATE_SSACK)
      ranges_insert<SSACK_RANGES, SACK_BLOCKS>(v.ssack_lo, v.ssack_hi,
                                               a.sack_m, p.sack_lo,
                                               p.sack_hi, v.snd_una);
    int32_t hs_off = 0;
    for (int i = 0; i < SSACK_RANGES; ++i) {
      const bool valid = v.ssack_lo[i] != v.ssack_hi[i];
      if (ackp && valid && seq_leq(v.ssack_hi[i], p.ack))
        v.ssack_lo[i] = v.ssack_hi[i] = 0;
    }
    for (int i = 0; i < SSACK_RANGES; ++i) {
      if (v.ssack_lo[i] != v.ssack_hi[i])
        hs_off = imax32(hs_off, sdiff(v.ssack_hi[i], p.ack));
    }

    rtt_update(v, new_ack && p.tse > 0, tick - p.tse);

    // NewReno's recovery, with the congestion-control hooks (cong.py).
    const int32_t flight = sdiff(v.snd_nxt, v.snd_una);
    const bool exit_rec = new_ack && v.in_recovery &&
                          seq_leq(v.recover, p.ack);
    const bool partial = new_ack && v.in_recovery && !exit_rec;
    const bool normal = new_ack && !v.in_recovery;
    cong_new_ack<Cong>(v, normal, acked_bytes, tick);
    if (exit_rec) {
      v.cwnd = v.ssthresh;
      v.in_recovery = false;
      v.dup_acks = 0;
    }
    if (partial) {
      v.retrans_nxt = p.ack;
      v.retrans_end = seq_max(p.ack + (uint32_t)TCP_MSS,
                              p.ack + (uint32_t)imax32(hs_off, 0));
      v.cwnd = imax32(v.cwnd - acked_bytes + TCP_MSS, TCP_MSS);
    }
    if (normal) v.dup_acks = 0;
    if (new_ack) {
      v.snd_una = p.ack;
      if (seq_lt(v.retrans_nxt, p.ack)) v.retrans_nxt = p.ack;
      v.t_rto = seq_lt(p.ack, v.snd_nxt) ? tick + v.rto : INV;
    }

    const bool dup = ackp && p.ack == v.snd_una && p.len == 0 && !a.f_fin &&
                     sdiff(v.snd_nxt, v.snd_una) > 0 && !new_ack;
    if (dup) v.dup_acks += 1;
    const bool fr = dup && v.dup_acks == 3 && !v.in_recovery;
    if (fr) {
      cong_enter_recovery<Cong>(v, flight);
      v.in_recovery = true;
      v.recover = v.snd_nxt;
      v.retrans_nxt = v.snd_una;
      v.retrans_end = v.snd_una + (uint32_t)imax32(hs_off, TCP_MSS);
    }
    if (dup && v.in_recovery && v.dup_acks > 3) v.cwnd += TCP_MSS;

    const bool fin_sent = v.app_closed && v.snd_nxt == v.snd_end + 1u;
    const bool fin_acked = new_ack && fin_sent && p.ack == v.snd_nxt;
    if (fin_acked && v.tcp_state == TCPS_FINWAIT1) {
      v.tcp_state = TCPS_FINWAIT2;
    } else if (fin_acked && v.tcp_state == TCPS_CLOSING) {
      v.tcp_state = TCPS_TIMEWAIT;
      v.t_tw = tick + TIMEWAIT_DELAY;
    } else if (fin_acked && v.tcp_state == TCPS_LASTACK) {
      v.tcp_state = TCPS_CLOSED;
      v.stype = SOCK_FREE;
      v.t_rto = v.t_delack = v.t_tw = v.t_persist = INV;
    }

    // Data reception (masks from tcp_arrival_begin).
    const bool can_rcv = a.can_rcv, fits = a.fits;
    in_adv = can_rcv && a.off <= 0 && a.new_bytes > 0 && fits;
    old_data = can_rcv && a.new_bytes <= 0;
    if (gates & GATE_RX) {
      const bool mk[1] = {a.ooo_ok};
      const uint32_t sk[1] = {p.seq}, ek[1] = {a.end_seq};
      ranges_insert<SACK_RANGES, 1>(v.sack_lo, v.sack_hi, mk, sk, ek,
                                    v.rcv_nxt);
    }
    int32_t adv = 0, drained = 0;
    if (in_adv) {
      v.ts_recent = p.ts;
      adv = a.new_bytes;
      v.rcv_nxt = v.rcv_nxt + (uint32_t)adv;
      drained = ranges_drain<SACK_RANGES>(v.sack_lo, v.sack_hi, v.rcv_nxt,
                                          true);
      v.bytes_recv += (int64_t)adv + drained;
      v.at_bytes += (int64_t)adv + drained;
      if (v.at_last == 0) v.at_last = tick;
      const int64_t rtt_w = imax(v.srtt, ONE_MS);
      if (v.at_last > 0 && tick - v.at_last > rtt_w && t.autotune_rcv[hh]) {
        const int32_t space = (int32_t)imin(2 * v.at_bytes, RCV_BUF_MAX);
        v.rcv_buf_cap = imax32(v.rcv_buf_cap, space);
        v.at_bytes = 0;
        v.at_last = tick;
      }
    }

    // FIN reception.
    if (ml && a.f_fin && a.est_like) v.fin_seq = p.seq + (uint32_t)p.len;
    fin_now = ml && a.est_like && v.fin_seq != 0 && v.rcv_nxt == v.fin_seq;
    if (fin_now) v.rcv_nxt = v.rcv_nxt + 1u;
    const int32_t st_ = v.tcp_state;
    const bool our_fin_acked = v.app_closed && v.snd_una == v.snd_end + 1u;
    if (fin_now && st_ == TCPS_ESTABLISHED) v.tcp_state = TCPS_CLOSEWAIT;
    if (fin_now && st_ == TCPS_FINWAIT1 && !our_fin_acked)
      v.tcp_state = TCPS_CLOSING;
    if (fin_now && (st_ == TCPS_FINWAIT2 ||
                    (st_ == TCPS_FINWAIT1 && our_fin_acked))) {
      v.tcp_state = TCPS_TIMEWAIT;
      v.t_tw = tick + TIMEWAIT_DELAY;
    }

    // ACK generation.
    tw_refin = ml && a.f_fin && v.tcp_state == TCPS_TIMEWAIT;
    probe = ml && a.est_like && (p.flags & TCP_FLAG_PSH) != 0 && p.len == 0;
    const int32_t pend = v.delack_pending + (in_adv ? 1 : 0);
    ack_now = a.ooo_ok || old_data || (can_rcv && !fits) || fin_now ||
              probe || tw_refin || (in_adv && pend >= 2) ||
              (in_adv && drained > 0);
    if (in_adv && !ack_now) {
      v.delack_pending = pend;
      if (v.t_delack == INV) v.t_delack = tick + DELACK_DELAY;
    }
    if (ack_now) {
      v.delack_pending = 0;
      v.t_delack = INV;
    }
    if (ack_now && a.rep_flags == 0) a.rep_flags = TCP_FLAG_ACK;
    a.rep = a.rep || ack_now;
  }
  tm.sync();                 // every lane has loaded the socket
  if (a.m && tm.leader()) sock_store(t, hh, a.conn_slot, v);

  // Replies: the spawned child's SYN-ACK (its fields were stored by
  // tcp_arrival_begin and are loaded in `v`), the connected socket's
  // reply, or a RST for a segment no socket takes -- which reads the
  // window of the table's socket at the clamped connection slot, as the
  // JAX view does.
  const bool reply = (a.m && a.rep) || a.spawn;
  if ((reply || orphan) && tm.leader()) {
    const uint32_t zero3[SACK_BLOCKS] = {0, 0, 0};
    const bool sk = reply && a.m;
    const int32_t r_flags = a.spawn ? (TCP_FLAG_SYN | TCP_FLAG_ACK)
                                    : a.rep_flags;
    const uint32_t r_seq = (a.spawn || a.dup_syn) ? 0u : v.snd_nxt;
    em_put_tcp(t, hh, reply_slot, p.src, p.dport, p.sport,
               orphan ? (TCP_FLAG_RST | TCP_FLAG_ACK) : r_flags,
               orphan ? p.ack : r_seq,
               orphan ? p.seq + (uint32_t)p.len + 1u : v.rcv_nxt,
               recv_window(v.rcv_nxt, v.rcv_read, v.rcv_buf_cap), 0,
               reply ? v.ts_recent : 0, tick, sk ? v.sack_lo : zero3,
               sk ? v.sack_hi : zero3);
  }
  tm.sync();
}

// ---------------------------------------------------------------------------
// Transmission (tcp.transmit) and the timer term of the scan
// ---------------------------------------------------------------------------

struct Elig {
  bool retx, can_new, fin_ready;
};

__device__ __forceinline__ Elig eligibility(int32_t st, uint32_t una,
                                            uint32_t nxt, uint32_t end,
                                            int32_t wnd, int32_t cwnd,
                                            uint32_t rnxt, uint32_t rend,
                                            bool app_closed) {
  const bool sendable = sendable_state(st);
  const int32_t inflight = sdiff(nxt, una);
  const int32_t allowed = imin32(cwnd, imax32(wnd, 0));
  const bool retx = sendable && seq_lt(rnxt, seq_min(rend, nxt)) &&
                    sdiff(rnxt, una) < allowed;
  const int32_t room = allowed - inflight;
  const int32_t data_left = sdiff(end, nxt);
  const bool can_new = sendable &&
                       ((data_left >= TCP_MSS && room >= TCP_MSS) ||
                        (data_left > 0 && data_left < TCP_MSS &&
                         room >= data_left));
  const bool fin_ready = sendable && app_closed && nxt == end &&
                         (st == TCPS_ESTABLISHED || st == TCPS_CLOSEWAIT);
  return Elig{retx, can_new, fin_ready};
}

__device__ __forceinline__ bool table_eligible(const TcpArgs& t, int64_t i) {
  const Elig e = eligibility(
      t.tcp_state[i], (uint32_t)t.snd_una[i], (uint32_t)t.snd_nxt[i],
      (uint32_t)t.snd_end[i], t.snd_wnd[i], t.cwnd[i],
      (uint32_t)t.retrans_nxt[i], (uint32_t)t.retrans_end[i],
      t.app_closed[i] != 0);
  return e.retx || e.can_new || e.fin_ready;
}

// transmit for host hh at `tick` (its t_post), before staging: up to
// TX_SLOTS segments into lanes SLOT_TX_BASE.. of the emission block.
// `free_out` is the host's free outbox slots, counted before staging.
// Lowers t_resume to the re-tick instant and advances rr_next (RR).  The
// eligibility walks are the team's: pick_fifo and pick_eff are mins,
// any_elig and `more` an any.
template <class Team>
__device__ __forceinline__ void tcp_transmit(const Team& tm,
                                             const TcpArgs& t, int hh,
                                             int64_t tick, bool act,
                                             int free_out,
                                             int64_t& t_resume) {
  const int S = t.slots;
  const bool room_ok = free_out >= t.e;
  const bool tx_active = act && room_ok;
  const int32_t rr = t.rr_next[hh];
  const bool use_rr = t.qdisc == QDISC_RR;
  bool any_elig = false;
  int32_t pick_fifo = S, pick_eff = S;
  for (int s = tm.lane(); s < S; s += Team::W) {
    if (!table_eligible(t, (int64_t)hh * S + s)) continue;
    any_elig = true;
    if (!tx_active) continue;
    if (pick_fifo == S) pick_fifo = s;
    pick_eff = imin32(pick_eff, (int32_t)floormod(s - rr, S));
  }
  any_elig = tm.any(any_elig);
  pick_fifo = tm.min32(pick_fifo);
  pick_eff = tm.min32(pick_eff);
  const bool deferred = act && !room_ok && any_elig;
  const bool have = pick_fifo < S;
  bool more = false;
  if (have) {
    int pick = pick_fifo;
    if (use_rr)
      pick = (int)floormod(imin32(pick_eff, S - 1) + rr, S);
    Sock v = sock_load(t, hh, pick);
    for (int k = 0; k < TX_SLOTS; ++k) {
      const Elig e = eligibility(v.tcp_state, v.snd_una, v.snd_nxt, v.snd_end,
                                 v.snd_wnd, v.cwnd, v.retrans_nxt,
                                 v.retrans_end, v.app_closed);
      uint32_t seq_sk = v.retrans_nxt;
      for (int r = 0; r < SSACK_RANGES; ++r) {
        const uint32_t lo = v.ssack_lo[r], hi = v.ssack_hi[r];
        if (e.retx && lo != hi && seq_leq(lo, seq_sk) && seq_lt(seq_sk, hi))
          seq_sk = hi;
      }
      if (e.retx && seq_sk != v.retrans_nxt) v.retrans_nxt = seq_sk;
      const bool do_retx =
          e.retx && seq_lt(seq_sk, seq_min(v.retrans_end, v.snd_nxt));
      const bool do_new = !do_retx && e.can_new;
      const bool do_fin_only = !do_retx && !do_new && e.fin_ready;
      const uint32_t seq = do_retx ? v.retrans_nxt : v.snd_nxt;
      const int32_t data_left = do_retx ? sdiff(v.snd_end, v.retrans_nxt)
                                        : sdiff(v.snd_end, v.snd_nxt);
      int32_t seg_len = imax32(imin32(TCP_MSS, data_left), 0);
      const bool retx_fin = do_retx && data_left == 0 && v.app_closed;
      if (retx_fin || do_fin_only) seg_len = 0;
      const bool send_fin = retx_fin || do_fin_only ||
                            (do_new && v.app_closed &&
                             seq + (uint32_t)seg_len == v.snd_end);
      const uint32_t consumed = (uint32_t)seg_len + (send_fin ? 1u : 0u);
      const bool doing = do_retx || do_new || do_fin_only;
      if (!doing) continue;
      if (tm.leader())
        em_put_tcp(t, hh, SLOT_TX_BASE + k, v.peer_host, v.local_port,
                   v.peer_port, TCP_FLAG_ACK | (send_fin ? TCP_FLAG_FIN : 0),
                   seq, v.rcv_nxt,
                   recv_window(v.rcv_nxt, v.rcv_read, v.rcv_buf_cap),
                   seg_len, v.ts_recent, 0, nullptr, nullptr);
      if (do_retx) {
        v.retrans_nxt = v.retrans_nxt + consumed;
        v.retx_segs += 1;
      }
      if (do_new || do_fin_only) {
        v.snd_nxt = seq + consumed;
        v.bytes_sent += seg_len;
        if (send_fin && v.tcp_state == TCPS_ESTABLISHED) {
          v.tcp_state = TCPS_FINWAIT1;
        } else if (send_fin && v.tcp_state == TCPS_CLOSEWAIT) {
          v.tcp_state = TCPS_LASTACK;
        }
      }
      v.delack_pending = 0;
      v.t_delack = INV;
      if (v.t_rto == INV) v.t_rto = tick + v.rto;
    }
    tm.sync();               // every lane has loaded the socket
    if (tm.leader()) {
      sock_store(t, hh, pick, v);
      if (use_rr) t.rr_next[hh] = (pick + 1) % S;
    }
    tm.sync();
    if (tx_active) {
      for (int s = tm.lane(); s < S && !more; s += Team::W)
        more = table_eligible(t, (int64_t)hh * S + s);
      more = tm.any(more);
    }
  }
  const int64_t t_res = more ? tick
                             : (deferred ? tick + t.min_latency : INV);
  t_resume = imin(t_resume, t_res);
}

// The earliest armed socket timer of host hh (engine._aux_times' term).
template <class Team>
__device__ __forceinline__ int64_t timer_min(const Team& tm,
                                             const TcpArgs& t, int hh) {
  int64_t m = INV;
  for (int s = tm.lane(); s < t.slots; s += Team::W) {
    const int64_t i = (int64_t)hh * t.slots + s;
    m = imin(m, imin(imin(t.t_rto[i], t.t_persist[i]),
                     imin(t.t_delack[i], t.t_tw[i])));
  }
  return tm.min64(m);
}

// ---------------------------------------------------------------------------
// Timers (tcp.run_timers), between the arrivals and the app tick
// ---------------------------------------------------------------------------

constexpr int K_RTO = 0, K_DELACK = 1, K_TW = 2, K_PERSIST = 3;

// run_timers for host hh at `tick` (its t_post): fires at most one due
// timer -- the earliest, ties to the lowest flat index slot * 4 + kind
// over (RTO, delayed ACK, TIME_WAIT, persist) -- and emits into lane
// SLOT_TIMER.  The JAX package runs the body under lax.cond(any(due))
// over all hosts; that gate is exact per host, because with nothing due
// on a host every write of the body to it (the socket scatter and the
// emission) is masked off.  So each thread decides for its own host and
// the timers need no grid barrier.  The pick is the team's min over
// (time, slot * 4 + kind).  An established RTO calls the timeout hook of
// `Cong`.
template <int Cong, class Team>
__device__ __forceinline__ void tcp_run_timers(const Team& tm,
                                               const TcpArgs& t, int hh,
                                               int64_t tick, bool act) {
  if (!act) return;
  const int S = t.slots;
  int64_t tmin = INV;
  int32_t pick = 4 * S;
  for (int s = tm.lane(); s < S; s += Team::W) {
    const int64_t i = (int64_t)hh * S + s;
    const int64_t c[4] = {t.t_rto[i], t.t_delack[i], t.t_tw[i],
                          t.t_persist[i]};
    for (int k = 0; k < 4; ++k) {
      if (c[k] <= tick && c[k] < tmin) {
        tmin = c[k];
        pick = s * 4 + k;
      }
    }
  }
  tm.min2(tmin, pick);
  if (pick >= 4 * S) return;
  const int slot = pick / 4, kind = pick % 4;
  Sock v = sock_load(t, hh, slot);

  // RTO: the first SYN, SYN / SYN-ACK back-off (or give up), or an
  // established retransmission timeout.
  const bool rto_f = kind == K_RTO;
  const bool syn_first = rto_f && v.tcp_state == TCPS_SYNSENT &&
                         v.snd_nxt == 0;
  if (syn_first) {
    v.snd_nxt = 1;
    v.t_rto = tick + v.rto;
  }
  const bool syn_re = rto_f && v.tcp_state == TCPS_SYNSENT && !syn_first;
  const bool synack_re = rto_f && v.tcp_state == TCPS_SYNRECEIVED;
  const bool timed_out = (syn_re || synack_re) && v.rto >= RTO_MAX;
  if (timed_out) {
    v.tcp_state = TCPS_CLOSED;
    v.stype = SOCK_FREE;
    v.error = 110;
    v.t_rto = v.t_delack = v.t_tw = v.t_persist = INV;
  } else if (syn_re || synack_re) {
    v.rto = imin(v.rto * 2, RTO_MAX);
    v.t_rto = tick + v.rto;
  }
  const int32_t flight = sdiff(v.snd_nxt, v.snd_una);
  const bool est_rto = rto_f && sendable_state(v.tcp_state) && flight > 0;
  if (est_rto) {
    cong_timeout<Cong>(v, flight);
    v.retrans_nxt = v.snd_una;
    v.retrans_end = v.snd_nxt;
    v.in_recovery = false;
    v.dup_acks = 0;
    v.rto = imin(v.rto * 2, RTO_MAX);
    for (int r = 0; r < SSACK_RANGES; ++r) v.ssack_lo[r] = v.ssack_hi[r] = 0;
    v.t_rto = tick + v.rto;
  }
  if (rto_f && !syn_first && !syn_re && !synack_re && !est_rto)
    v.t_rto = INV;

  // Delayed ACK.
  const bool send_ack = kind == K_DELACK && v.delack_pending > 0;
  if (kind == K_DELACK) {
    v.t_delack = INV;
    v.delack_pending = 0;
  }

  // TIME_WAIT expiry.
  if (kind == K_TW && v.tcp_state == TCPS_TIMEWAIT) {
    v.tcp_state = TCPS_CLOSED;
    v.stype = SOCK_FREE;
    v.t_rto = v.t_delack = v.t_tw = v.t_persist = INV;
  } else if (kind == K_TW) {
    v.t_tw = INV;
  }

  // Zero-window persist probe.
  const bool data_pend = sdiff(v.snd_end, v.snd_nxt) > 0 || v.app_closed;
  const bool send_probe = kind == K_PERSIST && sendable_state(v.tcp_state) &&
                          v.snd_wnd == 0 && data_pend;
  if (send_probe) {
    v.t_persist = tick + v.rto;
  } else if (kind == K_PERSIST) {
    v.t_persist = INV;
  }
  const bool syn_emit = syn_first || syn_re;
  tm.sync();                 // every lane has loaded the socket
  if (tm.leader()) {
    sock_store(t, hh, slot, v);
    if (syn_emit || synack_re || send_ack || send_probe) {
      const int32_t flags =
          synack_re ? (TCP_FLAG_SYN | TCP_FLAG_ACK)
          : syn_emit ? TCP_FLAG_SYN
          : send_probe ? (TCP_FLAG_ACK | TCP_FLAG_PSH) : TCP_FLAG_ACK;
      const uint32_t zero3[SACK_BLOCKS] = {0, 0, 0};
      em_put_tcp(t, hh, SLOT_TIMER, v.peer_host, v.local_port, v.peer_port,
                 flags, (syn_emit || synack_re) ? 0u : v.snd_nxt,
                 (syn_emit && !synack_re) ? 0u : v.rcv_nxt,
                 recv_window(v.rcv_nxt, v.rcv_read, v.rcv_buf_cap), 0,
                 send_ack ? v.ts_recent : 0, 0, send_ack ? v.sack_lo : zero3,
                 send_ack ? v.sack_hi : zero3);
    }
  }
  tm.sync();
}

}  // namespace s1
