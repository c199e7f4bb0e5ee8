"""TCP as vectorized structure-of-arrays transitions, in plain torch
(counterpart of shadow1_tpu/transport/tcp.py).

Every per-socket scalar is a cell of an [H, S] tensor of the socket
table, and every protocol rule is a masked update over hosts; the engine
hands each host at most one inbound segment per delivery round.  The
machine is the JAX package's, rule for rule and in the same order, so
every leaf compares bitwise: NewReno loss recovery, the byte-range
reassembly and SACK scoreboards, RFC 6298 RTO with timestamp-echo RTT
samples, delayed ACKs, zero-window persist, buffer autotuning.

uint32 sequence numbers live in int64 tensors holding [0, 2^32) (package
docstring): every sum is re-masked (`_u32`) and `_sdiff` sign-extends the
32-bit difference, so wrap-around behaves as the JAX u32 arithmetic.

The gates of the JAX package's kernel diet (`lax.cond` on a global
`any`) are kept where skipping is not the identity on every host: the
two scoreboard inserts re-pack (merge, re-sort, compact) the ranges of
every connected host when any host inserts.  The other gates are exact
per host; they are kept as `any()` branches because on the card they
spare the per-phase path hundreds of launches.

This module is the plain version of the TCP branches of K_DELIVER
(`process_arrivals`) and K_TRANSPORT (`transmit`), and of what K_WINDOW's
TCP kernel runs besides: `run_timers` and the socket API the apps' ticks
call.  On the per-phase path `run_timers` runs between the kernels, where
the JAX package also keeps it.  Their CUDA counterparts are csrc/tcp.cuh.
"""

from __future__ import annotations

import torch

from ..core import emit, simtime
from ..core import state as st
from ..core.params import QDISC_RR
from ..core.state import (ERR_SOCKET_OVERFLOW, I32, I64, SACK_BLOCKS,
                          SOCK_FREE, SOCK_TCP, SSACK_RANGES, TCP_FLAG_ACK,
                          TCP_FLAG_FIN, TCP_FLAG_PSH, TCP_FLAG_RST,
                          TCP_FLAG_SYN, TCP_MSS, TCPS_CLOSED,
                          TCPS_CLOSEWAIT, TCPS_CLOSING, TCPS_ESTABLISHED,
                          TCPS_FINWAIT1, TCPS_FINWAIT2, TCPS_LASTACK,
                          TCPS_LISTEN, TCPS_SYNRECEIVED, TCPS_SYNSENT,
                          TCPS_TIMEWAIT)
from . import cong

INV = simtime.SIMTIME_INVALID
M32 = 0xFFFFFFFF

RTO_INIT = simtime.SIMTIME_ONE_SECOND
RTO_MIN = simtime.SIMTIME_ONE_SECOND // 5
RTO_MAX = 120 * simtime.SIMTIME_ONE_SECOND
DELACK_DELAY = simtime.SIMTIME_ONE_SECOND // 25
TIMEWAIT_DELAY = 60 * simtime.SIMTIME_ONE_SECOND
SND_BUF_MAX = 4194304
RCV_BUF_MAX = 6291456
INIT_CWND = 10 * TCP_MSS
SSTHRESH_INIT = 1 << 30

_SENDABLE = (TCPS_ESTABLISHED, TCPS_CLOSEWAIT, TCPS_FINWAIT1, TCPS_CLOSING,
             TCPS_LASTACK)


# ---------------------------------------------------------------------------
# u32 sequence arithmetic (wraparound-safe)
# ---------------------------------------------------------------------------


def _u32(x):
    """Reduce an int64 value mod 2^32 (the JAX package's u32 wrap)."""
    return x & M32


def pure_ack(proto, flags, length):
    """Pure ACK: the ACK flag alone, no payload (the segments the exchange
    may shed under destination-slab pressure)."""
    return (proto == st.PROTO_TCP) & (length == 0) & (flags == TCP_FLAG_ACK)


def _sdiff(a, b):
    """Signed distance a - b in sequence space, as int32."""
    d = (a - b) & M32
    return torch.where(d >= (1 << 31), d - (1 << 32), d).to(I32)


def _seq_lt(a, b):
    return _sdiff(a, b) < 0


def _seq_leq(a, b):
    return _sdiff(a, b) <= 0


def _seq_min(a, b):
    return torch.where(_seq_lt(a, b), a, b)


def _seq_max(a, b):
    return torch.where(_seq_lt(a, b), b, a)


def _in_state(tcp_state, states):
    m = tcp_state == states[0]
    for s in states[1:]:
        m = m | (tcp_state == s)
    return m


# ---------------------------------------------------------------------------
# gather / scatter: one socket per host
# ---------------------------------------------------------------------------


class _Sock:
    """Per-host view of one socket slot: fields are gathered on first
    read, and `scatter` writes back, under a mask, the fields that were
    assigned (the JAX package's lazy, dirty-tracking view)."""

    FIELDS = [
        "stype", "tcp_state", "local_port", "peer_host", "peer_port",
        "parent", "accepted", "child_order", "backlog",
        "snd_una", "snd_nxt", "snd_end", "snd_wnd", "snd_buf_cap",
        "cwnd", "ssthresh", "dup_acks", "recover", "in_recovery",
        "retrans_nxt", "retrans_end", "app_closed",
        "rcv_nxt", "rcv_read", "rcv_buf_cap", "fin_seq",
        "ts_recent", "srtt", "rttvar", "rto",
        "t_rto", "t_delack", "t_tw", "t_persist", "delack_pending",
        "at_bytes", "at_last", "cub_epoch", "cub_wmax", "retx_segs",
        "error", "bytes_sent", "bytes_recv",
    ]

    RANGE_FIELDS = ["sack_lo", "sack_hi", "ssack_lo", "ssack_hi"]

    def __init__(self, socks: st.SocketTable, slot):
        d = object.__setattr__
        d(self, "_socks", socks)
        slot = torch.as_tensor(slot, dtype=I64, device=socks.stype.device)
        slot = torch.broadcast_to(torch.clamp(slot, 0, socks.slots - 1),
                                  (socks.num_hosts,))
        d(self, "_slot", slot)
        d(self, "_onehot", slot[:, None] == torch.arange(
            socks.slots, dtype=I64, device=slot.device)[None, :])
        d(self, "_orig", {})
        d(self, "_dirty", set())

    def __getattr__(self, name):
        if name in self.FIELDS:
            v = getattr(self._socks, name).gather(
                1, self._slot[:, None]).squeeze(1)
        elif name in self.RANGE_FIELDS:
            tab = getattr(self._socks, name)
            idx = self._slot[:, None, None].expand(-1, 1, tab.shape[2])
            v = tab.gather(1, idx).squeeze(1)
        else:
            raise AttributeError(name)
        self._orig[name] = v
        object.__setattr__(self, name, v)
        return v

    def __setattr__(self, name, value):
        if name in self.FIELDS or name in self.RANGE_FIELDS:
            if name not in self._orig:
                getattr(self, name)
            self._dirty.add(name)
        object.__setattr__(self, name, value)

    def scatter(self, socks: st.SocketTable, mask) -> st.SocketTable:
        if socks is not self._socks:
            raise ValueError("scatter target must be the source table")
        oh = self._onehot
        upd = {}
        for f in sorted(self._dirty):
            cur = getattr(socks, f)
            if f in self.RANGE_FIELDS:
                w = oh[:, :, None] & mask[:, None, None]
                upd[f] = torch.where(w, getattr(self, f)[:, None, :], cur)
            else:
                w = oh & mask[:, None]
                upd[f] = torch.where(w, getattr(self, f)[:, None], cur)
        return socks.replace(**upd) if upd else socks

    def setwhere(self, mask, **kv):
        """Where mask, set each field to its value cast to the field's
        dtype (u32 fields reduced mod 2^32, as the JAX astype does)."""
        for f, v in kv.items():
            cur = getattr(self, f)
            v = torch.as_tensor(v, device=cur.device).to(cur.dtype)
            if f in st.SocketTable.U32_FIELDS:
                v = v & M32
            setattr(self, f, torch.where(mask, v, cur))


_DEFAULTS = dict(
    stype=SOCK_FREE, tcp_state=TCPS_CLOSED, local_port=0, peer_host=-1,
    peer_port=0, parent=-1, accepted=False, child_order=0, backlog=0,
    snd_una=0, snd_nxt=0, snd_end=1, snd_wnd=TCP_MSS,
    cwnd=INIT_CWND, ssthresh=SSTHRESH_INIT,
    dup_acks=0, recover=0, in_recovery=False, retrans_nxt=1, retrans_end=1,
    app_closed=False,
    rcv_nxt=0, rcv_read=0, fin_seq=0,
    ts_recent=0, srtt=0, rttvar=0, rto=RTO_INIT,
    t_rto=INV, t_delack=INV, t_tw=INV, t_persist=INV, delack_pending=0,
    at_bytes=0, at_last=0, cub_epoch=0, cub_wmax=0, retx_segs=0,
    error=0, bytes_sent=0, bytes_recv=0,
)


def _apply_defaults(sv: _Sock, mask):
    """Reset every TCP field of the viewed slot to its default where mask
    (tcp_new); the UDP ring fields stay."""
    sv.setwhere(mask, snd_buf_cap=sv._socks.def_snd_buf,
                rcv_buf_cap=sv._socks.def_rcv_buf, **_DEFAULTS)
    for f in _Sock.RANGE_FIELDS:
        cur = getattr(sv, f)
        setattr(sv, f, torch.where(mask[:, None], torch.zeros_like(cur),
                                   cur))


# ---------------------------------------------------------------------------
# Socket API (vectorized over hosts)
# ---------------------------------------------------------------------------


def listen_v(socks: st.SocketTable, mask, slot, port,
             backlog: int = 64) -> st.SocketTable:
    """Where mask, socket `slot` becomes a TCP listener on `port`."""
    sv = _Sock(socks, slot)
    _apply_defaults(sv, mask)
    sv.setwhere(mask, stype=SOCK_TCP, tcp_state=TCPS_LISTEN, local_port=port,
                backlog=backlog)
    return sv.scatter(socks, mask)


def connect_v(socks: st.SocketTable, mask, slot, dst_host, dst_port,
              local_port, now) -> st.SocketTable:
    """Where mask, open an active connection from socket `slot`; the SYN
    goes out when the RTO timer armed at `now` fires."""
    sv = _Sock(socks, slot)
    _apply_defaults(sv, mask)
    sv.setwhere(mask, stype=SOCK_TCP, tcp_state=TCPS_SYNSENT,
                local_port=local_port, peer_host=dst_host,
                peer_port=dst_port, snd_una=0, snd_nxt=0, rcv_nxt=0,
                t_rto=now)
    return sv.scatter(socks, mask)


def write_v(socks: st.SocketTable, mask, slot, target_end,
            now=None) -> st.SocketTable:
    """App write: advance snd_end toward `target_end` (u32, exclusive),
    bounded by the send buffer; a write into a zero window arms the
    persist timer."""
    sv = _Sock(socks, slot)
    cap_end = _u32(sv.snd_una + sv.snd_buf_cap.to(I64))
    tgt = _u32(torch.as_tensor(target_end, dtype=I64))
    new_end = torch.where(_seq_lt(tgt, cap_end), tgt, cap_end)
    grow = mask & _seq_lt(sv.snd_end, new_end)
    sv.setwhere(grow, snd_end=new_end)
    if now is not None:
        blocked = grow & (sv.snd_wnd == 0) & (sv.t_persist == INV) & \
            (sv.t_rto == INV) & _in_state(sv.tcp_state, _SENDABLE)
        sv.setwhere(blocked, t_persist=now + sv.rto)
    return sv.scatter(socks, grow)


def close_v(socks: st.SocketTable, mask, slot) -> st.SocketTable:
    """App close: FIN at the end of the stream."""
    sv = _Sock(socks, slot)
    do = mask & (sv.stype == SOCK_TCP) & ~sv.app_closed
    sv.setwhere(do, app_closed=True)
    return sv.scatter(socks, do)


def consume_all(socks: st.SocketTable) -> st.SocketTable:
    """Mark every received byte as read (an infinite consumer)."""
    is_tcp = socks.stype == SOCK_TCP
    return socks.replace(
        rcv_read=torch.where(is_tcp, socks.rcv_nxt, socks.rcv_read))


def recv_window(sv: _Sock):
    """Advertised window with receiver-side silly-window avoidance."""
    used = _sdiff(sv.rcv_nxt, sv.rcv_read)
    w = torch.clamp(sv.rcv_buf_cap - used, min=0)
    thresh = torch.clamp(torch.clamp(sv.rcv_buf_cap // 2, min=1),
                         max=TCP_MSS)
    return torch.where(w < thresh, torch.zeros_like(w), w)


# ---------------------------------------------------------------------------
# Byte-range scoreboards ([H, R] u32 lo/hi pairs, lo == hi empty)
# ---------------------------------------------------------------------------


def _ranges_insert(lo, hi, mask, s, e, base):
    return _ranges_insert_many(lo, hi, [mask], [s], [e], base)


def _ranges_insert_many(lo, hi, masks, ss, es, base):
    """Insert up to k ranges [ss[i], es[i]) per host (masked) in one sort
    and merge pass: entries are sorted by distance from `base` (stable:
    ties keep their order, empties go last), overlapping or adjacent
    ranges merge, and past R ranges the farthest are dropped."""
    h, r = lo.shape
    big = 1 << 40
    new_lo = [_u32(torch.where(m, s_, 0))[:, None] for m, s_ in zip(masks, ss)]
    new_hi = [_u32(torch.where(m, e_, 0))[:, None] for m, e_ in zip(masks, es)]
    lo1 = torch.cat([lo] + new_lo, dim=1)
    hi1 = torch.cat([hi] + new_hi, dim=1)
    valid = lo1 != hi1
    key = torch.where(valid, _sdiff(lo1, base[:, None]).to(I64), big)
    order = torch.argsort(key, dim=1, stable=True)
    lo1 = lo1.gather(1, order)
    hi1 = hi1.gather(1, order)
    valid = lo1 != hi1

    out_lo = torch.zeros_like(lo)
    out_hi = torch.zeros_like(hi)
    ptr = torch.zeros((h,), dtype=I32, device=lo.device)
    cur_lo = torch.zeros((h,), dtype=lo.dtype, device=lo.device)
    cur_hi = torch.zeros((h,), dtype=lo.dtype, device=lo.device)
    cur_valid = torch.zeros((h,), dtype=torch.bool, device=lo.device)
    slots = torch.arange(r, dtype=I32, device=lo.device)[None, :]

    def _emit(out_lo, out_hi, ptr, do):
        onehot = (slots == ptr[:, None]) & (do & (ptr < r))[:, None]
        return (torch.where(onehot, cur_lo[:, None], out_lo),
                torch.where(onehot, cur_hi[:, None], out_hi),
                ptr + do.to(I32))

    for i in range(r + len(masks)):
        li, hii, vi = lo1[:, i], hi1[:, i], valid[:, i]
        merge = vi & cur_valid & _seq_leq(li, cur_hi)
        start = vi & ~merge
        out_lo, out_hi, ptr = _emit(out_lo, out_hi, ptr, start & cur_valid)
        cur_hi = torch.where(merge & _seq_lt(cur_hi, hii), hii, cur_hi)
        cur_lo = torch.where(start, li, cur_lo)
        cur_hi = torch.where(start, hii, cur_hi)
        cur_valid = cur_valid | vi
    out_lo, out_hi, ptr = _emit(out_lo, out_hi, ptr, cur_valid)
    return out_lo, out_hi


def _ranges_drain(lo, hi, nxt, mask):
    """Advance `nxt` through the ranges it reaches (lo <= nxt), popping
    them; returns (lo, hi, nxt, drained bytes as int32)."""
    drained = torch.zeros(nxt.shape, dtype=I32, device=nxt.device)
    r = lo.shape[1]
    zcol = torch.zeros_like(lo[:, :1])
    for _ in range(r):
        v = lo[:, 0] != hi[:, 0]
        take = mask & v & _seq_leq(lo[:, 0], nxt)
        new_nxt = torch.where(take & _seq_lt(nxt, hi[:, 0]), hi[:, 0], nxt)
        drained = drained + torch.where(take, _sdiff(new_nxt, nxt), 0)
        nxt = new_nxt
        lo_s = torch.cat([lo[:, 1:], zcol], dim=1)
        hi_s = torch.cat([hi[:, 1:], zcol], dim=1)
        lo = torch.where(take[:, None], lo_s, lo)
        hi = torch.where(take[:, None], hi_s, hi)
    return lo, hi, nxt, drained


# ---------------------------------------------------------------------------
# RTT / RTO (RFC 6298)
# ---------------------------------------------------------------------------


def _rtt_update(sv: _Sock, mask, rtt):
    first = sv.srtt == 0
    srtt_n = torch.where(first, rtt, sv.srtt - sv.srtt // 8 + rtt // 8)
    dev = torch.abs(srtt_n - rtt)
    rttvar_n = torch.where(first, rtt // 2,
                           sv.rttvar - sv.rttvar // 4 + dev // 4)
    rto_n = torch.clamp(srtt_n + torch.clamp(
        4 * rttvar_n, min=simtime.SIMTIME_ONE_MILLISECOND), RTO_MIN, RTO_MAX)
    sv.setwhere(mask & (rtt > 0), srtt=srtt_n, rttvar=rttvar_n, rto=rto_n)


# ---------------------------------------------------------------------------
# Arrival processing: the TCP branch of K_DELIVER
# ---------------------------------------------------------------------------


def process_arrivals(state, params, em, tick_t, pkt, mask,
                     reply_slot=emit.SLOT_RX_REPLY):
    """Handle at most one inbound segment per host (`mask` marks the
    hosts with a TCP arrival; `pkt` holds its fields, engine.RxPkt).
    Returns (state, em): the reply segment goes into lane `reply_slot`."""
    socks = state.socks
    h = socks.num_hosts
    dev = socks.stype.device

    p_src, p_sport, p_dport = pkt.src, pkt.sport, pkt.dport
    p_flags, p_seq, p_ack = pkt.flags, pkt.seq, pkt.ack
    p_wnd, p_len = pkt.wnd, pkt.length
    p_ts, p_tse = pkt.ts, pkt.ts_echo
    p_id = pkt.pkt_id

    f_syn = (p_flags & TCP_FLAG_SYN) != 0
    f_ack = (p_flags & TCP_FLAG_ACK) != 0
    f_fin = (p_flags & TCP_FLAG_FIN) != 0
    f_rst = (p_flags & TCP_FLAG_RST) != 0

    # --- socket match ------------------------------------------------------
    is_tcp = socks.stype == SOCK_TCP
    port_ok = socks.local_port == p_dport[:, None]
    peer_ok = (socks.peer_host == p_src[:, None]) & \
        (socks.peer_port == p_sport[:, None])
    not_listen = (socks.tcp_state != TCPS_LISTEN) & \
        (socks.tcp_state != TCPS_CLOSED)
    conn_m = is_tcp & port_ok & peer_ok & not_listen
    lsn_m = is_tcp & port_ok & (socks.tcp_state == TCPS_LISTEN)

    s_num = socks.slots
    slot_ids = torch.arange(s_num, dtype=I32, device=dev)[None, :]
    conn_slot = torch.where(conn_m, slot_ids, s_num).amin(dim=1)
    has_conn = mask & (conn_slot < s_num)
    conn_slot = torch.clamp(conn_slot, 0, s_num - 1)
    lsn_slot = torch.where(lsn_m, slot_ids, s_num).amin(dim=1)
    has_lsn = mask & (lsn_slot < s_num)

    # --- passive open: SYN -> new child socket -----------------------------
    want_child = mask & ~has_conn & has_lsn & f_syn & ~f_ack & ~f_rst
    free_m = socks.stype == SOCK_FREE
    child_slot = torch.where(free_m, slot_ids, s_num).amin(dim=1)
    have_free = child_slot < s_num
    spawn = want_child & have_free
    child_slot = torch.clamp(child_slot, 0, s_num - 1)
    slot_overflow = (want_child & ~have_free).any()

    if bool(spawn.any()):           # exact per host: writes under spawn
        cv = _Sock(socks, child_slot)
        _apply_defaults(cv, spawn)
        cv.setwhere(spawn, stype=SOCK_TCP, tcp_state=TCPS_SYNRECEIVED,
                    local_port=p_dport, peer_host=p_src, peer_port=p_sport,
                    parent=lsn_slot, child_order=p_id,
                    rcv_nxt=_u32(p_seq + 1), rcv_read=_u32(p_seq + 1),
                    snd_una=0, snd_nxt=1, snd_wnd=p_wnd, ts_recent=p_ts,
                    t_rto=tick_t + RTO_INIT)
        socks = cv.scatter(socks, spawn)

    # --- connected-socket processing ---------------------------------------
    sv = _Sock(socks, conn_slot)
    m = has_conn
    rep = torch.zeros((h,), dtype=torch.bool, device=dev)
    rep_flags = torch.zeros((h,), dtype=I32, device=dev)

    rst_hit = m & f_rst
    sv.setwhere(rst_hit, tcp_state=TCPS_CLOSED, stype=SOCK_FREE, error=104,
                t_rto=INV, t_delack=INV, t_tw=INV, t_persist=INV)
    m_live = m & ~f_rst

    synack = m_live & f_syn & f_ack & (sv.tcp_state == TCPS_SYNSENT) & \
        (p_ack == sv.snd_nxt)
    sv.setwhere(synack, tcp_state=TCPS_ESTABLISHED,
                rcv_nxt=_u32(p_seq + 1), rcv_read=_u32(p_seq + 1),
                snd_una=p_ack, retrans_nxt=sv.snd_nxt,
                retrans_end=sv.snd_nxt,
                snd_wnd=torch.clamp(p_wnd, min=TCP_MSS),
                ts_recent=p_ts, t_rto=INV)
    _rtt_update(sv, synack & (p_tse > 0), tick_t - p_tse)
    rep = rep | synack
    rep_flags = torch.where(synack, TCP_FLAG_ACK, rep_flags)

    dup_syn = m_live & f_syn & ~f_ack & (sv.tcp_state == TCPS_SYNRECEIVED)
    rep = rep | dup_syn
    rep_flags = torch.where(dup_syn, TCP_FLAG_SYN | TCP_FLAG_ACK, rep_flags)

    hs_done = m_live & f_ack & ~f_syn & \
        (sv.tcp_state == TCPS_SYNRECEIVED) & (p_ack == sv.snd_nxt)
    sv.setwhere(hs_done, tcp_state=TCPS_ESTABLISHED,
                snd_una=p_ack, retrans_nxt=sv.snd_nxt,
                retrans_end=sv.snd_nxt,
                snd_wnd=torch.clamp(p_wnd, min=TCP_MSS), t_rto=INV)
    _rtt_update(sv, hs_done & (p_tse > 0), tick_t - p_tse)

    # ---- ACK processing -----------------------------------------------------
    est_like = _in_state(sv.tcp_state, (TCPS_ESTABLISHED, TCPS_FINWAIT1,
                                        TCPS_FINWAIT2, TCPS_CLOSING,
                                        TCPS_CLOSEWAIT, TCPS_LASTACK))
    ackp = m_live & f_ack & ~f_syn & est_like

    new_ack = ackp & _seq_lt(sv.snd_una, p_ack) & _seq_leq(p_ack, sv.snd_nxt)
    acked_bytes = torch.where(new_ack, _sdiff(p_ack, sv.snd_una), 0)

    sv.setwhere(ackp & _seq_leq(p_ack, sv.snd_nxt), snd_wnd=p_wnd)

    wnd_upd = ackp & _seq_leq(p_ack, sv.snd_nxt)
    data_pend = (_sdiff(sv.snd_end, sv.snd_nxt) > 0) | sv.app_closed
    arm_p = wnd_upd & (p_wnd == 0) & data_pend & (sv.t_persist == INV)
    sv.setwhere(arm_p, t_persist=tick_t + sv.rto)
    sv.setwhere(wnd_upd & (p_wnd > 0), t_persist=INV)

    snd_tgt = torch.clamp(2 * sv.cwnd.to(I64), max=SND_BUF_MAX).to(I32)
    grow_snd = new_ack & (sv.snd_buf_cap < snd_tgt) & params.autotune_snd
    sv.setwhere(grow_snd, snd_buf_cap=torch.maximum(snd_tgt, sv.snd_buf_cap))

    # Sender-side SACK scoreboard.  The insert re-packs every connected
    # host's ranges, so it runs exactly when some host inserts (the JAX
    # package's global gate).
    sack_masks = [ackp & (pkt.sack_lo[:, i] != pkt.sack_hi[:, i])
                  for i in range(SACK_BLOCKS)]
    if bool(torch.stack(sack_masks, dim=1).any()):
        sv.ssack_lo, sv.ssack_hi = _ranges_insert_many(
            sv.ssack_lo, sv.ssack_hi, sack_masks,
            [pkt.sack_lo[:, i] for i in range(SACK_BLOCKS)],
            [pkt.sack_hi[:, i] for i in range(SACK_BLOCKS)], sv.snd_una)
    dead = _seq_leq(sv.ssack_hi, p_ack[:, None]) & \
        (sv.ssack_lo != sv.ssack_hi) & ackp[:, None]
    sv.ssack_lo = torch.where(dead, 0, sv.ssack_lo)
    sv.ssack_hi = torch.where(dead, 0, sv.ssack_hi)
    hs_off = torch.zeros((h,), dtype=I32, device=dev)
    for i in range(SSACK_RANGES):
        ne = sv.ssack_lo[:, i] != sv.ssack_hi[:, i]
        hs_off = torch.maximum(
            hs_off, torch.where(ne, _sdiff(sv.ssack_hi[:, i], p_ack), 0))

    _rtt_update(sv, new_ack & (p_tse > 0), tick_t - p_tse)

    # NewReno.
    flight = _sdiff(sv.snd_nxt, sv.snd_una)
    exit_rec = new_ack & sv.in_recovery & _seq_leq(sv.recover, p_ack)
    partial = new_ack & sv.in_recovery & ~exit_rec
    normal = new_ack & ~sv.in_recovery

    cong.new_ack(params.cong, sv, normal, acked_bytes, tick_t)
    sv.setwhere(exit_rec, cwnd=sv.ssthresh, in_recovery=False, dup_acks=0)
    sv.setwhere(partial,
                retrans_nxt=p_ack,
                retrans_end=_seq_max(
                    _u32(p_ack + TCP_MSS),
                    _u32(p_ack + torch.clamp(hs_off, min=0).to(I64))),
                cwnd=torch.clamp(sv.cwnd - acked_bytes + TCP_MSS,
                                 min=TCP_MSS))
    sv.setwhere(normal, dup_acks=0)
    sv.setwhere(new_ack, snd_una=p_ack,
                retrans_nxt=torch.where(_seq_lt(sv.retrans_nxt, p_ack),
                                        p_ack, sv.retrans_nxt))
    still_out = _seq_lt(p_ack, sv.snd_nxt)
    sv.setwhere(new_ack, t_rto=torch.where(still_out, tick_t + sv.rto, INV))

    dup = ackp & (p_ack == sv.snd_una) & (p_len == 0) & ~f_fin & \
        (_sdiff(sv.snd_nxt, sv.snd_una) > 0) & ~new_ack
    sv.setwhere(dup, dup_acks=sv.dup_acks + 1)
    fr = dup & (sv.dup_acks == 3) & ~sv.in_recovery
    cong.enter_recovery(params.cong, sv, fr, flight, tick_t)
    sv.setwhere(fr, in_recovery=True, recover=sv.snd_nxt,
                retrans_nxt=sv.snd_una,
                retrans_end=_u32(sv.snd_una + torch.clamp(
                    hs_off, min=TCP_MSS).to(I64)))
    inflate = dup & sv.in_recovery & (sv.dup_acks > 3)
    sv.setwhere(inflate, cwnd=sv.cwnd + TCP_MSS)

    fin_sent = sv.app_closed & (sv.snd_nxt == _u32(sv.snd_end + 1))
    fin_acked = new_ack & fin_sent & (p_ack == sv.snd_nxt)
    sv.setwhere(fin_acked & (sv.tcp_state == TCPS_FINWAIT1),
                tcp_state=TCPS_FINWAIT2)
    sv.setwhere(fin_acked & (sv.tcp_state == TCPS_CLOSING),
                tcp_state=TCPS_TIMEWAIT, t_tw=tick_t + TIMEWAIT_DELAY)
    sv.setwhere(fin_acked & (sv.tcp_state == TCPS_LASTACK),
                tcp_state=TCPS_CLOSED, stype=SOCK_FREE,
                t_rto=INV, t_delack=INV, t_tw=INV, t_persist=INV)

    # ---- data reception -----------------------------------------------------
    can_rcv = m_live & est_like & ~f_syn & (p_len > 0)
    off = _sdiff(p_seq, sv.rcv_nxt)
    end_seq = _u32(p_seq + p_len.to(I64))
    new_bytes = _sdiff(end_seq, sv.rcv_nxt)
    fits = _sdiff(end_seq, sv.rcv_read) <= sv.rcv_buf_cap
    in_adv = can_rcv & (off <= 0) & (new_bytes > 0) & fits
    old_data = can_rcv & (new_bytes <= 0)
    ooo_ok = can_rcv & (off > 0) & fits

    # Reassembly insert: global gate, as the SACK insert above.
    if bool(ooo_ok.any()):
        sv.sack_lo, sv.sack_hi = _ranges_insert(
            sv.sack_lo, sv.sack_hi, ooo_ok, p_seq, end_seq, sv.rcv_nxt)
    sv.setwhere(in_adv, ts_recent=p_ts)
    adv = torch.where(in_adv, new_bytes, 0)
    sv.setwhere(in_adv, rcv_nxt=_u32(sv.rcv_nxt + adv.to(I64)))

    # Drain: exact per host (take is masked by in_adv).
    if bool(((sv.sack_lo != sv.sack_hi) & in_adv[:, None]).any()):
        sv.sack_lo, sv.sack_hi, new_nxt, drained = _ranges_drain(
            sv.sack_lo, sv.sack_hi, sv.rcv_nxt, in_adv)
    else:
        new_nxt = sv.rcv_nxt
        drained = torch.zeros((h,), dtype=I32, device=dev)
    sv.setwhere(in_adv, rcv_nxt=new_nxt,
                bytes_recv=sv.bytes_recv + adv + drained)

    sv.setwhere(in_adv, at_bytes=sv.at_bytes + adv + drained,
                at_last=torch.where(sv.at_last == 0, tick_t, sv.at_last))
    rtt_w = torch.clamp(sv.srtt, min=simtime.SIMTIME_ONE_MILLISECOND)
    adjust = in_adv & (sv.at_last > 0) & (tick_t - sv.at_last > rtt_w) & \
        params.autotune_rcv
    space = torch.clamp(2 * sv.at_bytes, max=RCV_BUF_MAX).to(I32)
    sv.setwhere(adjust, rcv_buf_cap=torch.maximum(sv.rcv_buf_cap, space),
                at_bytes=0, at_last=tick_t)

    # ---- FIN reception ------------------------------------------------------
    fin_pos = _u32(p_seq + p_len.to(I64))
    sv.setwhere(m_live & f_fin & est_like, fin_seq=fin_pos)
    fin_now = m_live & est_like & (sv.fin_seq != 0) & \
        (sv.rcv_nxt == sv.fin_seq)
    sv.setwhere(fin_now, rcv_nxt=_u32(sv.rcv_nxt + 1))
    st_ = sv.tcp_state
    sv.setwhere(fin_now & (st_ == TCPS_ESTABLISHED), tcp_state=TCPS_CLOSEWAIT)
    our_fin_acked = sv.app_closed & (sv.snd_una == _u32(sv.snd_end + 1))
    sv.setwhere(fin_now & (st_ == TCPS_FINWAIT1) & ~our_fin_acked,
                tcp_state=TCPS_CLOSING)
    sv.setwhere(fin_now & ((st_ == TCPS_FINWAIT2) |
                           ((st_ == TCPS_FINWAIT1) & our_fin_acked)),
                tcp_state=TCPS_TIMEWAIT, t_tw=tick_t + TIMEWAIT_DELAY)

    # ---- ACK generation -----------------------------------------------------
    tw_refin = m_live & f_fin & (sv.tcp_state == TCPS_TIMEWAIT)
    probe = m_live & est_like & ((p_flags & TCP_FLAG_PSH) != 0) & (p_len == 0)
    pend = sv.delack_pending + in_adv.to(I32)
    ack_now = ooo_ok | old_data | (can_rcv & ~fits) | fin_now | probe | \
        tw_refin | (in_adv & (pend >= 2)) | (in_adv & (drained > 0))
    delay_ack = in_adv & ~ack_now
    sv.setwhere(delay_ack, delack_pending=pend,
                t_delack=torch.where(sv.t_delack == INV,
                                     tick_t + DELACK_DELAY, sv.t_delack))
    sv.setwhere(ack_now, delack_pending=0, t_delack=INV)
    rep_flags = torch.where(ack_now & (rep_flags == 0), TCP_FLAG_ACK,
                            rep_flags)
    rep = rep | ack_now

    socks = sv.scatter(socks, m)

    # --- replies -------------------------------------------------------------
    sv2 = _Sock(socks, torch.where(spawn, child_slot, conn_slot))
    reply = (m & rep) | spawn
    r_flags = torch.where(spawn, TCP_FLAG_SYN | TCP_FLAG_ACK, rep_flags)
    r_seq = torch.where(spawn | dup_syn, 0, sv2.snd_nxt)
    orphan = mask & ~has_conn & ~spawn & ~dup_syn & ~f_rst & \
        ~(has_lsn & f_syn)
    rst_flags = TCP_FLAG_RST | TCP_FLAG_ACK
    reply_any = reply | orphan
    em = emit.put(
        em, reply_any, reply_slot,
        dst=p_src, sport=p_dport, dport=p_sport, proto=st.PROTO_TCP,
        t_send=tick_t,
        flags=torch.where(orphan, rst_flags, r_flags),
        seq=torch.where(orphan, p_ack, r_seq),
        ack=torch.where(orphan, _u32(p_seq + p_len.to(I64) + 1),
                        sv2.rcv_nxt),
        wnd=recv_window(sv2),
        ts_echo=torch.where(reply, sv2.ts_recent, 0),
        sack_lo=torch.where(reply[:, None], sv2.sack_lo[:, :SACK_BLOCKS], 0),
        sack_hi=torch.where(reply[:, None], sv2.sack_hi[:, :SACK_BLOCKS], 0))
    err = state.err | (slot_overflow.to(I32) * ERR_SOCKET_OVERFLOW)
    return state.replace(socks=socks, err=err), em


# ---------------------------------------------------------------------------
# Timers: between K_DELIVER and the app tick (tcp.cuh tcp_run_timers)
# ---------------------------------------------------------------------------

_K_RTO, _K_DELACK, _K_TW, _K_PERSIST = 0, 1, 2, 3
_NKINDS = 4


def timer_min(socks: st.SocketTable):
    """[H] earliest armed socket timer per host."""
    return torch.minimum(
        torch.minimum(socks.t_rto.amin(dim=1), socks.t_persist.amin(dim=1)),
        torch.minimum(socks.t_delack.amin(dim=1), socks.t_tw.amin(dim=1)))


def run_timers(state, params, em, tick_t, active):
    """Fire at most one due timer per host (RTO, delayed ACK, TIME_WAIT,
    persist).  The fire body runs only when some timer is due: with none
    due every write of it is masked off (the JAX package's exact gate)."""
    socks = state.socks
    h, s = socks.num_hosts, socks.slots
    cand = torch.stack([socks.t_rto, socks.t_delack, socks.t_tw,
                        socks.t_persist], dim=-1).reshape(h, s * _NKINDS)
    due = (cand <= tick_t[:, None]) & active[:, None]
    if not bool(due.any()):
        return state, em
    return _timers_fire(state, params, em, tick_t, cand, due)


def _timers_fire(state, params, em, tick_t, cand2, due):
    socks = state.socks
    h, s = socks.num_hosts, socks.slots
    dev = cand2.device
    tmin = torch.where(due, cand2, INV).amin(dim=1)
    at_min = due & (cand2 == tmin[:, None])
    flat = torch.arange(s * _NKINDS, dtype=I32, device=dev)[None, :]
    pick = torch.where(at_min, flat, s * _NKINDS).amin(dim=1)
    have = pick < s * _NKINDS
    pick = torch.clamp(pick, 0, s * _NKINDS - 1)
    slot = pick // _NKINDS
    kind = pick % _NKINDS

    sv = _Sock(socks, slot)
    m = have

    rto_f = m & (kind == _K_RTO)
    syn_first = rto_f & (sv.tcp_state == TCPS_SYNSENT) & (sv.snd_nxt == 0)
    sv.setwhere(syn_first, snd_nxt=1, t_rto=tick_t + sv.rto)
    syn_re = rto_f & (sv.tcp_state == TCPS_SYNSENT) & ~syn_first
    synack_re = rto_f & (sv.tcp_state == TCPS_SYNRECEIVED)
    backoff = syn_re | synack_re
    timed_out = backoff & (sv.rto >= RTO_MAX)
    sv.setwhere(timed_out, tcp_state=TCPS_CLOSED, stype=SOCK_FREE,
                error=110, t_rto=INV, t_delack=INV, t_tw=INV, t_persist=INV)
    backoff = backoff & ~timed_out
    sv.setwhere(backoff, rto=torch.clamp(sv.rto * 2, max=RTO_MAX))
    sv.setwhere(backoff, t_rto=tick_t + sv.rto)

    est_like = _in_state(sv.tcp_state, _SENDABLE)
    has_out = _sdiff(sv.snd_nxt, sv.snd_una) > 0
    est_rto = rto_f & est_like & has_out
    flight = _sdiff(sv.snd_nxt, sv.snd_una)
    cong.timeout(params.cong, sv, est_rto, flight, tick_t)
    sv.setwhere(est_rto, retrans_nxt=sv.snd_una, retrans_end=sv.snd_nxt,
                in_recovery=False, dup_acks=0,
                rto=torch.clamp(sv.rto * 2, max=RTO_MAX))
    sv.ssack_lo = torch.where(est_rto[:, None], 0, sv.ssack_lo)
    sv.ssack_hi = torch.where(est_rto[:, None], 0, sv.ssack_hi)
    sv.setwhere(est_rto, t_rto=tick_t + sv.rto)
    sv.setwhere(rto_f & ~syn_first & ~syn_re & ~synack_re & ~est_rto &
                ~timed_out, t_rto=INV)

    da_f = m & (kind == _K_DELACK)
    send_ack = da_f & (sv.delack_pending > 0)
    sv.setwhere(da_f, t_delack=INV, delack_pending=0)

    tw_f = m & (kind == _K_TW) & (sv.tcp_state == TCPS_TIMEWAIT)
    sv.setwhere(tw_f, tcp_state=TCPS_CLOSED, stype=SOCK_FREE,
                t_rto=INV, t_delack=INV, t_tw=INV, t_persist=INV)
    sv.setwhere(m & (kind == _K_TW) & ~tw_f, t_tw=INV)

    ps_f = m & (kind == _K_PERSIST)
    est_like_p = _in_state(sv.tcp_state, _SENDABLE)
    data_pend = (_sdiff(sv.snd_end, sv.snd_nxt) > 0) | sv.app_closed
    send_probe = ps_f & est_like_p & (sv.snd_wnd == 0) & data_pend
    sv.setwhere(send_probe, t_persist=tick_t + sv.rto)
    sv.setwhere(ps_f & ~send_probe, t_persist=INV)

    socks = sv.scatter(socks, m)

    sv2 = _Sock(socks, slot)
    syn_emit = syn_first | syn_re
    emit_any = syn_emit | synack_re | send_ack | send_probe
    flags = torch.where(
        syn_emit & ~synack_re, TCP_FLAG_SYN,
        torch.where(synack_re, TCP_FLAG_SYN | TCP_FLAG_ACK,
                    torch.where(send_probe, TCP_FLAG_ACK | TCP_FLAG_PSH,
                                TCP_FLAG_ACK)))
    em = emit.put(
        em, emit_any, emit.SLOT_TIMER,
        dst=sv2.peer_host, sport=sv2.local_port, dport=sv2.peer_port,
        proto=st.PROTO_TCP, flags=flags,
        seq=torch.where(syn_emit | synack_re, 0, sv2.snd_nxt),
        ack=torch.where(syn_emit & ~synack_re, 0, sv2.rcv_nxt),
        wnd=recv_window(sv2),
        ts_echo=torch.where(send_ack, sv2.ts_recent, 0),
        sack_lo=torch.where(send_ack[:, None],
                            sv2.sack_lo[:, :SACK_BLOCKS], 0),
        sack_hi=torch.where(send_ack[:, None],
                            sv2.sack_hi[:, :SACK_BLOCKS], 0))
    return state.replace(socks=socks), em


# ---------------------------------------------------------------------------
# Transmission: the TCP branch of K_TRANSPORT
# ---------------------------------------------------------------------------


def _eligibility(tcp_state, snd_una, snd_nxt, snd_end, snd_wnd, cwnd,
                 retrans_nxt, retrans_end, app_closed):
    """(retransmit pending, new data sendable, FIN ready), elementwise."""
    sendable = _in_state(tcp_state, _SENDABLE)
    inflight = _sdiff(snd_nxt, snd_una)
    allowed = torch.minimum(cwnd, torch.clamp(snd_wnd, min=0))

    retx_bound = _seq_min(retrans_end, snd_nxt)
    retx = sendable & _seq_lt(retrans_nxt, retx_bound) & \
        (_sdiff(retrans_nxt, snd_una) < allowed)

    room = allowed - inflight
    data_left = _sdiff(snd_end, snd_nxt)
    can_new = sendable & (
        ((data_left >= TCP_MSS) & (room >= TCP_MSS)) |
        ((data_left > 0) & (data_left < TCP_MSS) & (room >= data_left)))

    fin_ready = sendable & app_closed & (snd_nxt == snd_end) & \
        _in_state(tcp_state, (TCPS_ESTABLISHED, TCPS_CLOSEWAIT))
    return retx, can_new, fin_ready


def _tx_eligibility(socks: st.SocketTable):
    return _eligibility(socks.tcp_state, socks.snd_una, socks.snd_nxt,
                        socks.snd_end, socks.snd_wnd, socks.cwnd,
                        socks.retrans_nxt, socks.retrans_end,
                        socks.app_closed)


def transmit(state, params, em, tick_t, active):
    """Up to TX_SLOTS segments from one socket per host (the first
    eligible by slot id, or round-robin), deferred while the host's
    outbox slab lacks room for a full lane set; hosts with more to send
    re-tick at the same instant."""
    socks = state.socks
    h = socks.num_hosts
    s_num = socks.slots
    dev = socks.stype.device
    slot_ids = torch.arange(s_num, dtype=I32, device=dev)[None, :]

    ko = state.pool.capacity // h
    free_out = (state.pool.stage == st.STAGE_FREE).reshape(h, ko).sum(dim=1)
    room_ok = free_out >= em.valid.shape[1]
    tx_active = active & room_ok

    retx, can_new, fin_ready = _tx_eligibility(socks)
    elig = retx | can_new | fin_ready
    want = elig & tx_active[:, None]
    deferred = active & ~room_ok & elig.any(dim=1)
    rr = state.hosts.rr_next
    use_rr = params.qdisc == QDISC_RR

    more = torch.zeros((h,), dtype=torch.bool, device=dev)
    rr_next = rr
    if bool(want.any()):            # exact per host: writes under have
        pick_fifo = torch.where(want, slot_ids, s_num).amin(dim=1)
        have = pick_fifo < s_num
        if use_rr:
            eff = torch.remainder(slot_ids - rr[:, None], s_num)
            pick_eff = torch.where(want, eff, s_num).amin(dim=1)
            pick = torch.remainder(torch.clamp(pick_eff, 0, s_num - 1) + rr,
                                   s_num)
        else:
            pick = pick_fifo
        pick = torch.clamp(pick, 0, s_num - 1)
        sv = _Sock(socks, pick)

        for k in range(emit.TX_SLOTS):
            retx_k, can_new_k, fin_ready_k = _eligibility(
                sv.tcp_state, sv.snd_una, sv.snd_nxt, sv.snd_end, sv.snd_wnd,
                sv.cwnd, sv.retrans_nxt, sv.retrans_end, sv.app_closed)
            # Hop the retransmission cursor over the sacked ranges.
            seq_sk = sv.retrans_nxt
            for r_ in range(SSACK_RANGES):
                lo_r, hi_r = sv.ssack_lo[:, r_], sv.ssack_hi[:, r_]
                inr = retx_k & (lo_r != hi_r) & _seq_leq(lo_r, seq_sk) & \
                    _seq_lt(seq_sk, hi_r)
                seq_sk = torch.where(inr, hi_r, seq_sk)
            moved = have & retx_k & (seq_sk != sv.retrans_nxt)
            sv.setwhere(moved, retrans_nxt=seq_sk)
            retx_bound_k = _seq_min(sv.retrans_end, sv.snd_nxt)
            retx_k = retx_k & _seq_lt(seq_sk, retx_bound_k)
            do_retx = have & retx_k
            do_new = have & ~do_retx & can_new_k
            do_fin_only = have & ~do_retx & ~do_new & fin_ready_k

            seq = torch.where(do_retx, sv.retrans_nxt, sv.snd_nxt)
            data_left = torch.where(do_retx,
                                    _sdiff(sv.snd_end, sv.retrans_nxt),
                                    _sdiff(sv.snd_end, sv.snd_nxt))
            seg_len = torch.clamp(torch.clamp(data_left, max=TCP_MSS), 0,
                                  TCP_MSS)
            retx_fin = do_retx & (data_left == 0) & sv.app_closed
            seg_len = torch.where(retx_fin | do_fin_only, 0, seg_len)
            send_fin = retx_fin | do_fin_only | \
                (do_new & sv.app_closed &
                 (_u32(seq + seg_len.to(I64)) == sv.snd_end))
            consumed = seg_len.to(I64) + send_fin.to(I64)

            doing = do_retx | do_new | do_fin_only
            flags = torch.where(doing, TCP_FLAG_ACK, 0) | \
                torch.where(send_fin & doing, TCP_FLAG_FIN, 0)

            em = emit.put(
                em, doing, emit.SLOT_TX_BASE + k,
                dst=sv.peer_host, sport=sv.local_port, dport=sv.peer_port,
                proto=st.PROTO_TCP, flags=flags, seq=seq, ack=sv.rcv_nxt,
                wnd=recv_window(sv), length=seg_len, ts_echo=sv.ts_recent)

            sv.setwhere(do_retx, retrans_nxt=_u32(sv.retrans_nxt + consumed),
                        retx_segs=sv.retx_segs + 1)
            adv_new = do_new | do_fin_only
            sv.setwhere(adv_new, snd_nxt=_u32(seq + consumed))
            sv.setwhere(adv_new, bytes_sent=sv.bytes_sent + seg_len)
            first_fin = (do_new | do_fin_only) & send_fin
            sv.setwhere(first_fin & (sv.tcp_state == TCPS_ESTABLISHED),
                        tcp_state=TCPS_FINWAIT1)
            sv.setwhere(first_fin & (sv.tcp_state == TCPS_CLOSEWAIT),
                        tcp_state=TCPS_LASTACK)
            sv.setwhere(doing, delack_pending=0, t_delack=INV)
            sv.setwhere(doing & (sv.t_rto == INV), t_rto=tick_t + sv.rto)

        socks = sv.scatter(socks, have)

        retx_a, can_new_a, fin_ready_a = _tx_eligibility(socks)
        more = (retx_a | can_new_a | fin_ready_a).any(dim=1) & tx_active
        if use_rr:
            rr_next = torch.where(have, (pick + 1) % s_num, rr).to(I32)

    hosts = state.hosts
    t_res = torch.where(
        more, tick_t,
        torch.where(deferred, tick_t + params.min_latency_ns, INV))
    hosts = hosts.replace(t_resume=torch.minimum(hosts.t_resume, t_res),
                          rr_next=rr_next)
    return state.replace(socks=socks, hosts=hosts), em
