"""The windowed discrete-event engine in plain torch (counterpart of
shadow1_tpu/core/engine.py).

Conservative windows with min-latency lookahead; within a window every
host advances its earliest pending event per micro-step.  The data
layout is the JAX package's: per-SOURCE outbox slabs (`state.pool`),
per-DESTINATION inbox slabs (`state.inbox`), and one window-boundary
exchange moving IN_FLIGHT outbox rows into their destination slabs.

The functions here are the plain versions of the per-phase kernels
(core/megakernel.py): `_exchange_core` (exchange), `_rx_phase`
(K_DELIVER, with tcp.process_arrivals in TCP worlds), and
tcp.transmit + `_stage_emissions` + `_tx_drain_body` + the CPU
accounting + the post-step scan (K_TRANSPORT).  They are functional
(return new tensors) and run on any device; on the card the main path
goes through the kernels instead, and the tests pin these bodies leaf
for leaf against the JAX package.

The loops (`run_until`, `run_chunked`) run on the host.  With
`params.persistent` (the default) each window is one K_WINDOW call
(megakernel.window_call, body `_window_body_ref`) and the host reads one
small vector per window; without it, one scalar per micro-step (the
`gmin < window_end` predicate JAX evaluates inside its device while
loop) and a few per window.

Scope: phold (UDP), bulk and tgen (TCP, Reno or CUBIC) worlds,
loopback emissions, per-packet jitter and interface receive buffers
included.  Other apps, bucket padding and every instrumentation and
netem block are later slices, refused by `check_supported` with a
message naming what is missing.
"""

from __future__ import annotations

import torch

from . import emit, nic, rng, simtime
from .state import (ERR_POOL_OVERFLOW, I32, I64, ICOLS, ICOL_ACK,
                    ICOL_DPORT, ICOL_FLAGS, ICOL_LEN, ICOL_PAYLOAD,
                    ICOL_PROTO, ICOL_SACK0_HI, ICOL_SACK0_LO, ICOL_SEQ,
                    ICOL_SPORT, ICOL_SRC, ICOL_TIME_HI, ICOL_TIME_LO,
                    ICOL_TSE_HI, ICOL_TSE_LO, ICOL_TS_HI, ICOL_TS_LO,
                    ICOL_WND, OEXT_DST, OEXT_LAT_HI,
                    OEXT_LAT_LO, OEXT_PRIO, PDS_INET_SENT,
                    PDS_RCV_SOCKET_PROCESSED, PDS_ROUTER_DROPPED,
                    PDS_ROUTER_ENQUEUED, PDS_SND_CREATED,
                    PDS_SND_INTERFACE_SENT, PROTO_TCP, PROTO_UDP,
                    STAGE_FREE, STAGE_IN_FLIGHT, STAGE_RX_QUEUED,
                    STAGE_TX_QUEUED, TCP_HEADER_SIZE, UDP_HEADER_SIZE,
                    SimState, dec_i64, enc_hi, enc_lo, ext_base, host_ids)
from ..transport import cong
from ..transport import tcp as tcp_mod
from ..transport import udp as udp_mod

INV = simtime.SIMTIME_INVALID


def _uses_tcp(app) -> bool:
    return getattr(app, "uses_tcp", True)


def _may_loopback(app) -> bool:
    return getattr(app, "may_loopback", True)


PORTED_APPS = ("Phold", "Bulk", "Tgen")


def check_iface_cube(h: int, ki: int) -> None:
    """The JAX package ranks an interface buffer's tail drop with an
    [H, k, k] comparison cube and refuses worlds where it passes 2^28
    elements; the port refuses the same worlds with the same message."""
    if h * ki * ki > (1 << 28):
        raise ValueError(
            f"<host interfacebuffer> needs an [H={h}, k={ki}, k={ki}] "
            f"ranking cube (> 2^28 elements) in the compiled step; "
            f"shrink the inbox slab (--pool-slab) or drop the "
            f"interfacebuffer bound for worlds this large")


def check_supported(state: SimState, params, app) -> None:
    """Refuse, by name, what the port does not carry yet."""
    name = type(app).__name__
    if not any(c.__name__ in PORTED_APPS for c in type(app).__mro__):
        raise NotImplementedError(
            f"the app {name} is not ported yet (ported: "
            f"{', '.join(PORTED_APPS)}; Echo is ROADMAP queue 1)")
    wide = state.inbox.blk.shape[1] >= ICOLS
    if _uses_tcp(app):
        cong.validate(params.cong)
        if not wide:
            raise ValueError(
                "this world's inbox was built narrow (uses_tcp=False) but "
                "the app uses TCP; TCP segments need the TS/SACK columns")
    elif wide:
        raise NotImplementedError(
            "a full-width inbox for a UDP app is not ported; build the "
            "world with uses_tcp=False")
    if params.has_iface_buf:
        h = state.hosts.num_hosts
        check_iface_cube(h, state.inbox.capacity // h)
    if params.hosts_real is not None:
        raise NotImplementedError(
            "bucket-padded worlds (hosts_real) are not ported yet")
    if params.megakernel and params.persistent and \
            getattr(app, "device_tick", None) is None:
        raise NotImplementedError(
            f"params.persistent runs each window as K_WINDOW, with the app "
            f"tick on the card, and {type(app).__name__} has no device tick "
            f"(Phold, Bulk and Tgen have one); build with persistent=False")


# ---------------------------------------------------------------------------
# Next-event scan
# ---------------------------------------------------------------------------


def _aux_times(state: SimState, params, app):
    """Per-host earliest non-packet event: re-ticks, TCP timers, the app."""
    t_h = state.hosts.t_resume
    if _uses_tcp(app):
        t_h = torch.minimum(t_h, tcp_mod.timer_min(state.socks))
    if app is not None:
        t_h = torch.minimum(t_h, app.next_time(state))
    return t_h


def _cpu_clamp(state: SimState, params, t_h):
    """Virtual CPU gate; `%` is floor modulo like JAX's."""
    prec = max(params.cpu_precision_ns, 1)
    ready = state.hosts.cpu_avail - params.cpu_threshold_ns
    rem = torch.remainder(ready, prec)
    ready = ready - rem + torch.where(rem >= prec // 2, prec, 0)
    clamp = (params.cpu_ns_per_event > 0) & (t_h != INV) & \
        (params.cpu_threshold_ns >= 0)
    return torch.where(clamp, torch.maximum(t_h, ready), t_h)


def _inbox_next(ib, h):
    """[H] earliest IN_FLIGHT arrival per destination slab (INV if none)."""
    ki = ib.capacity // h
    t2 = ib.times().reshape(h, ki)
    drive = (ib.stage == STAGE_IN_FLIGHT).reshape(h, ki)
    return torch.where(drive, t2, torch.full_like(t2, INV)).amin(dim=1)


def _scan_all(state: SimState, params, app):
    """Per-host next event time [H] and its global min (0-d tensor)."""
    h = state.hosts.num_hosts
    t_h = torch.minimum(_inbox_next(state.inbox, h),
                        _aux_times(state, params, app))
    t_h = _cpu_clamp(state, params, t_h)
    return t_h, t_h.amin()


def _outbox_pending(state: SimState):
    """Earliest arrival still awaiting the boundary exchange (0-d)."""
    pool = state.pool
    return torch.where(pool.stage == STAGE_IN_FLIGHT, pool.time,
                       torch.full_like(pool.time, INV)).amin()


# ---------------------------------------------------------------------------
# Window-boundary exchange: outbox IN_FLIGHT -> inbox slabs
# ---------------------------------------------------------------------------


def _superblock(n: int, h: int) -> int:
    """Items per rank superblock (the JAX package's sizing rule)."""
    m = int((4 * max(h, 1)) ** 0.5)
    m = max(64, min(512, (m // 64) * 64 if m >= 64 else 64))
    return min(m, max(64, n))


def _rank_by_dst(mask, dstp, h, m):
    """Per-item rank among masked same-destination items in flat order:
    superblock count table (duplicate-index accumulate), exclusive cumsum
    over blocks, pairwise ranks inside each block.  Returns
    ([npad] rank i32, [H] totals i32)."""
    npad = dstp.shape[0]
    dev = dstp.device
    blkid = torch.arange(npad, dtype=I64, device=dev) // m
    b = npad // m
    cnt = torch.zeros((b, h), dtype=I32, device=dev)
    cnt.index_put_((blkid, dstp.to(I64)), mask.to(I32), accumulate=True)
    csum = torch.cumsum(cnt, dim=0, dtype=I32)
    off = csum - cnt
    total = csum[-1]
    d3 = dstp.reshape(b, m)
    l3 = mask.reshape(b, m)
    eq = (d3[:, :, None] == d3[:, None, :]) & l3[:, None, :]
    lower = torch.tril(torch.ones((m, m), dtype=torch.bool, device=dev),
                       -1)[None]
    rank_in = (eq & lower).sum(dim=2, dtype=I32).reshape(-1)
    return off.reshape(-1)[blkid * h + dstp] + rank_in, total


def _exchange_core(pool, ib, h, params):
    """Rank movers by destination, splice them into the destination
    slabs' free slots (ascending slot order), clear the outbox stage.
    Returns (pool, inbox, total, total_prot, n_free); the last three are
    [H] int32 per-destination tallies.

    TCP worlds (full-width inbox) shed pure ACKs first on overflow: when
    some destination cannot take all its movers and some mover is a pure
    ACK, every destination ranks its protected movers (data and control)
    first, in flat order, then its pure ACKs; `total_prot` counts the
    protected ones.  The gate is global, as in the JAX package, because
    the re-rank also moves movers of destinations that do not overflow."""
    p0 = pool.capacity
    p1 = ib.capacity
    ki = p1 // h
    ic = ib.blk.shape[1]
    dev = pool.stage.device

    moving = pool.stage == STAGE_IN_FLIGHT
    dst = torch.clamp(pool.dst, 0, h - 1)
    m = _superblock(p0, h)
    npad = -(-p0 // m) * m
    pad = npad - p0
    dstp = torch.nn.functional.pad(dst, (0, pad))
    mvp = torch.nn.functional.pad(moving, (0, pad))
    rank, total = _rank_by_dst(mvp, dstp, h, m)

    free2 = (ib.stage == STAGE_FREE).reshape(h, ki)
    ids = torch.arange(ki, dtype=I32, device=dev)[None, :]
    n_free = free2.sum(dim=1, dtype=I32)

    total_prot = total
    if ic >= ICOLS:
        blk = pool.blk
        ackp = torch.nn.functional.pad(tcp_mod.pure_ack(
            blk[:, ICOL_PROTO], blk[:, ICOL_FLAGS], blk[:, ICOL_LEN]),
            (0, pad)) & mvp
        if bool((total > n_free).any() & ackp.any()):
            rank_prot, total_prot = _rank_by_dst(mvp & ~ackp, dstp, h, m)
            rank = torch.where(ackp, total_prot[dstp.to(I64)]
                               + (rank - rank_prot), rank_prot)

    order2 = torch.argsort(torch.where(free2, ids, ids + ki), dim=1,
                           stable=True).to(I32)
    within = order2.reshape(-1)[(dstp * ki + torch.clamp(rank, 0, ki - 1))
                                .to(I64)]
    ok = mvp & (rank < n_free[dstp.to(I64)])
    islot = (dstp * ki + within).to(I64)

    vals = torch.cat([pool.blk[:, :ICOL_TIME_LO],
                      enc_lo(pool.time)[:, None], enc_hi(pool.time)[:, None],
                      pool.blk[:, ICOL_TIME_HI + 1:ic]], dim=1)
    vals = torch.nn.functional.pad(vals, (0, 0, 0, pad))
    sel = islot[ok]
    blk = ib.blk.clone()
    blk[sel] = vals[ok]
    stage = ib.stage.clone()
    stage[sel] = STAGE_IN_FLIGHT
    status = ib.status
    if params.pds_trail:
        status = status.clone()
        status[sel] = torch.nn.functional.pad(pool.status, (0, pad))[ok]
    ib = ib.replace(blk=blk, stage=stage, status=status)
    pool = pool.replace(stage=torch.where(moving, STAGE_FREE, pool.stage))
    return pool, ib, total, total_prot, n_free


def _exchange_tail(state: SimState, total, total_prot, n_free) -> SimState:
    """Accounting tail of the exchange: overflowed pure ACKs are shed
    (acks_thinned), every other overflowed mover is a counted drop that
    raises ERR_POOL_OVERFLOW."""
    hosts = state.hosts
    drops_all = torch.clamp(total - n_free, min=0).to(I64)
    data_drops = torch.minimum(
        drops_all, torch.clamp(total_prot - n_free, min=0).to(I64))
    acks_shed = drops_all - data_drops
    hosts = hosts.replace(
        pkts_dropped_pool=hosts.pkts_dropped_pool + data_drops,
        acks_thinned=hosts.acks_thinned + acks_shed)
    err = state.err | ((data_drops > 0).any().to(I32) * ERR_POOL_OVERFLOW)
    return state.replace(hosts=hosts, err=err)


def _exchange(state: SimState, params, fused: bool = False) -> SimState:
    """The boundary exchange.  It runs every window: with no mover it is
    the identity, exactly as the JAX package's skipped branch."""
    if fused:
        from . import megakernel as mk
        pool, ib, total, tprot, n_free = mk.exchange_call(
            state.pool, state.inbox, state.hosts.num_hosts, params)
    else:
        pool, ib, total, tprot, n_free = _exchange_core(
            state.pool, state.inbox, state.hosts.num_hosts, params)
    state = state.replace(pool=pool, inbox=ib)
    return _exchange_tail(state, total, tprot, n_free)


# ---------------------------------------------------------------------------
# Phase A: inbox enqueue -> NIC receive (tokens + CoDel) -> delivery
# ---------------------------------------------------------------------------


def _wire_bytes(proto, length):
    return length + torch.where(proto == PROTO_TCP, TCP_HEADER_SIZE,
                                UDP_HEADER_SIZE).to(length.dtype)


class RxPkt:
    """Field registers of the packet each host takes in one delivery
    round, decoded from its inbox row ([H] tensors; seq/ack/SACK are
    uint32 held in int64)."""

    __slots__ = ("src", "sport", "dport", "proto", "flags", "seq", "ack",
                 "wnd", "length", "payload_id", "time", "ts", "ts_echo",
                 "pkt_id", "sack_lo", "sack_hi")

    def __init__(self, row, keys_row, time_row):
        def u32(c):
            return c.to(I64) & 0xFFFFFFFF

        self.src = row[:, ICOL_SRC]
        self.sport = row[:, ICOL_SPORT]
        self.dport = row[:, ICOL_DPORT]
        self.proto = row[:, ICOL_PROTO]
        self.flags = row[:, ICOL_FLAGS]
        self.seq = u32(row[:, ICOL_SEQ])
        self.ack = u32(row[:, ICOL_ACK])
        self.wnd = row[:, ICOL_WND]
        self.length = row[:, ICOL_LEN]
        self.payload_id = row[:, ICOL_PAYLOAD]
        self.time = time_row
        self.ts = dec_i64(row[:, ICOL_TS_LO], row[:, ICOL_TS_HI])
        self.ts_echo = dec_i64(row[:, ICOL_TSE_LO], row[:, ICOL_TSE_HI])
        self.sack_lo = u32(row[:, ICOL_SACK0_LO:ICOL_SACK0_LO + 6:2])
        self.sack_hi = u32(row[:, ICOL_SACK0_HI:ICOL_SACK0_HI + 6:2])
        self.pkt_id = keys_row


def _rx_phase(state: SimState, params, em, tick_t, active, app, window_end,
              bw_dn, aux_bound=None):
    """Arrivals: router enqueue, NIC rx token/CoDel drain of one packet
    per host per round, UDP delivery, and in TCP worlds
    tcp.process_arrivals, whose reply of round r goes into lane
    SLOT_RX_REPLY (r = 0) or NUM_SLOTS + r - 1.  Returns (state, em,
    delivered_n [H] i32, t_post [H] i64); UDP worlds pass `em` through."""
    ib, hosts = state.inbox, state.hosts
    h = hosts.num_hosts
    p1 = ib.capacity
    ki = p1 // h
    dev = tick_t.device
    inv = torch.full((h,), INV, dtype=I64, device=dev)

    t2 = ib.times().reshape(h, ki)
    st2 = ib.stage.reshape(h, ki)
    due = (st2 == STAGE_IN_FLIGHT) & (t2 <= tick_t[:, None]) & \
        active[:, None]
    k2 = ib.order_keys().reshape(h, ki)

    # Interface receive buffer (<host interfacebuffer>): a host with a
    # bound keeps at most `room` of its due arrivals, the earliest by
    # (time, key), and tail-drops the rest.  A due slot's rank is the
    # number of due slots before it, as the JAX package counts it over
    # its [H, k, k] cube; the cube is built here only for the hosts whose
    # dues exceed their room (the others drop nothing).
    if params.has_iface_buf:
        cap = params.iface_buf_pkts
        room = torch.clamp(cap - hosts.rx_queued, min=0)
        over = ((cap > 0) & (due.sum(dim=1) > room)).nonzero().flatten()
        tail_drop = torch.zeros_like(due)
        if over.numel():
            d_o, t_o, k_o = due[over], t2[over], k2[over]
            before = d_o[:, None, :] & (
                (t_o[:, None, :] < t_o[:, :, None]) |
                ((t_o[:, None, :] == t_o[:, :, None]) &
                 (k_o[:, None, :] < k_o[:, :, None])))
            rank = before.sum(dim=2)
            tail_drop[over] = d_o & (rank >= room[over, None])
        due = due & ~tail_drop
    else:
        tail_drop = None

    st2 = torch.where(due, STAGE_RX_QUEUED, st2).to(I32)
    status = ib.status
    if params.pds_trail:
        status = torch.where(due.reshape(-1), status | PDS_ROUTER_ENQUEUED,
                             status)
    if tail_drop is not None:
        st2 = torch.where(tail_drop, STAGE_FREE, st2).to(I32)
        if params.pds_trail:
            status = torch.where(tail_drop.reshape(-1),
                                 status | PDS_ROUTER_DROPPED, status)
        hosts = hosts.replace(
            pkts_dropped_router=hosts.pkts_dropped_router
            + tail_drop.sum(dim=1))
    hosts = hosts.replace(
        rx_queued=hosts.rx_queued + due.sum(dim=1, dtype=I32))

    d_rounds = max(1, int(getattr(app, "rx_batch", 1)))
    ids = torch.arange(ki, dtype=I32, device=dev)[None, :]
    rows = torch.arange(h, dtype=I64, device=dev)
    rows_g = host_ids(state, I32)
    boot = tick_t < params.bootstrap_end
    tokens, last = nic.refill(hosts.tokens_rx, hosts.last_refill_rx,
                              bw_dn, tick_t, active)
    hosts = hosts.replace(last_refill_rx=last)
    if d_rounds > 1:
        span = simtime.SIMTIME_ONE_MILLISECOND
        aux0 = _aux_times(state, params, app) if aux_bound is None \
            else aux_bound
        bound = torch.minimum(aux0, tick_t + span)
        bound = torch.clamp(bound, max=window_end - 1)
    else:
        bound = tick_t

    delivered_n = torch.zeros((h,), dtype=I32, device=dev)
    t_post = tick_t
    state = state.replace(hosts=hosts)
    for r in range(d_rounds):
        limit = tick_t if r == 0 else bound
        hosts = state.hosts
        # Candidates: the queued backlog, plus (rounds > 0, in worlds
        # without interface buffers) in-flight arrivals within the bound.
        cand = st2 == STAGE_RX_QUEUED
        if r > 0 and not params.has_iface_buf:
            cand = cand | ((st2 == STAGE_IN_FLIGHT) & (t2 <= limit[:, None]))
        cand = cand & active[:, None]
        tq = torch.where(cand, t2, torch.full_like(t2, INV))
        tmin = tq.amin(dim=1)
        at_t = cand & (tq == tmin[:, None])
        kq = torch.where(at_t, k2, torch.full_like(k2, INV))
        kmin = kq.amin(dim=1)
        at = at_t & (kq == kmin[:, None])
        col = torch.where(at, ids, torch.full_like(ids, ki)).amin(dim=1)
        have = active & (col < ki) & (tmin <= limit)
        col = torch.clamp(col, 0, ki - 1)
        flat = rows * ki + col
        was_queued = have & (st2.reshape(-1)[flat] == STAGE_RX_QUEUED)
        t_eff = torch.maximum(tick_t, torch.where(have, tmin, 0))

        row = ib.blk[flat]
        p_src = row[:, ICOL_SRC]
        p_proto = row[:, ICOL_PROTO]
        p_len = row[:, ICOL_LEN]
        p_time = torch.where(have, tmin, 0)

        if r > 0:
            tokens, last = nic.refill(tokens, hosts.last_refill_rx, bw_dn,
                                      t_eff, have)
            hosts = hosts.replace(last_refill_rx=last)
        size = _wire_bytes(p_proto, p_len).to(I64) * nic.SCALE
        loop = p_src == rows_g
        free_pass = loop | boot
        funded = have & (free_pass | (tokens >= size))

        sojourn = torch.clamp(t_eff - p_time, min=0)
        rx_q_now = hosts.rx_queued
        backlog_after = rx_q_now - was_queued.to(I32)
        hosts, drop = nic.codel_dequeue(hosts, funded & ~loop, t_eff,
                                        sojourn, backlog_after)
        deliver = funded & ~drop
        tokens = tokens - torch.where(funded & ~free_pass, size, 0)
        hosts = hosts.replace(tokens_rx=tokens)

        oh = ids == col[:, None]
        st2 = torch.where(oh & funded[:, None], STAGE_FREE, st2).to(I32)
        if params.pds_trail:
            fm = (oh & (funded & drop)[:, None]).reshape(-1)
            status = torch.where(fm, status | PDS_ROUTER_ENQUEUED
                                 | PDS_ROUTER_DROPPED, status)
            dm = (oh & deliver[:, None]).reshape(-1)
            status = torch.where(dm, status | PDS_ROUTER_ENQUEUED
                                 | PDS_RCV_SOCKET_PROCESSED, status)
        hosts = hosts.replace(
            rx_queued=rx_q_now - (funded & was_queued).to(I32),
            pkts_dropped_router=hosts.pkts_dropped_router + drop.to(I64))

        if r == d_rounds - 1:
            t_tok = tick_t + nic.time_until(size - tokens, bw_dn)
            t_res = torch.where(have & ~funded, t_tok,
                                torch.where(funded & (hosts.rx_queued > 0),
                                            tick_t, inv))
            hosts = hosts.replace(
                t_resume=torch.minimum(hosts.t_resume, t_res))

        state = state.replace(
            inbox=ib.replace(stage=st2.reshape(-1), status=status),
            hosts=hosts)
        ib = state.inbox

        udp_mask = deliver & (p_proto == PROTO_UDP)
        socks, _acc = udp_mod.deliver(state.socks, udp_mask, p_src,
                                      row[:, ICOL_SPORT], row[:, ICOL_DPORT],
                                      p_len, row[:, ICOL_PAYLOAD])
        hosts = state.hosts
        hosts = hosts.replace(
            pkts_recv=hosts.pkts_recv + deliver.to(I64),
            bytes_recv=hosts.bytes_recv
            + torch.where(deliver, p_len, 0).to(I64))
        state = state.replace(socks=socks, hosts=hosts)
        if _uses_tcp(app):
            tcp_mask = deliver & (p_proto == PROTO_TCP)
            # Exact skip: every write of process_arrivals is masked by a
            # subset of tcp_mask.  It touches no host counter, so it may
            # follow the counter update below the UDP delivery.
            if bool(tcp_mask.any()):
                pkt = RxPkt(row, torch.where(have, kmin, 0), p_time)
                reply_slot = emit.SLOT_RX_REPLY if r == 0 \
                    else emit.NUM_SLOTS + r - 1
                state, em = tcp_mod.process_arrivals(
                    state, params, em, t_eff, pkt, tcp_mask,
                    reply_slot=reply_slot)
        delivered_n = delivered_n + deliver.to(I32)
        if r == 0:
            t_post = torch.where(deliver, t_eff, tick_t)
        else:
            t_post = torch.where(deliver, torch.maximum(t_post, t_eff),
                                 t_post)
    return state, em, delivered_n, t_post


# ---------------------------------------------------------------------------
# Emission staging (packets leave their source this tick)
# ---------------------------------------------------------------------------


def _route(params, vs, vd, src, ctr):
    """Routing lookup + per-packet jitter draw: (latency >= 1 ns,
    reliability).  Jitter perturbs the latency uniformly within +/- the
    pair's amplitude, keyed by (src, per-src counter), as the JAX _route
    draws it: u in [0,1) from PURPOSE_JITTER, delta = trunc((2u - 1) *
    f32(jit)).  A world without jitter skips the draw; draws are keyed,
    so skipping one consumes nothing."""
    if not params.has_jitter:
        lat, rel = params.route_narrow(vs, vd)
        return torch.clamp(lat, min=simtime.SIMTIME_ONE_NANOSECOND), rel
    lat, jit, rel = params.route(vs, vd)
    u = rng.keyed_uniform(params.purpose_words[rng.PURPOSE_JITTER], src,
                          ctr, ctr >> 32)
    delta = ((2.0 * u - 1.0) * jit.to(torch.float32)).to(I64)
    lat = torch.clamp(lat + torch.where(jit > 0, delta, 0),
                      min=simtime.SIMTIME_ONE_NANOSECOND)
    return lat, rel


def _free_slot_pick(free2, rank2):
    """[H, E] slot columns: the r-th allocation takes the r-th free slot
    in ascending order; 0 where rank2 is negative or past the free slots
    (callers mask by rank2 < n_free)."""
    h, k = free2.shape
    order = torch.argsort((~free2).to(torch.int8), dim=1, stable=True)
    pick = order.gather(1, torch.clamp(rank2, 0, k - 1).to(I64)).to(I32)
    ok = (rank2 >= 0) & (rank2 < free2.sum(dim=1, keepdim=True))
    return torch.where(ok, pick, 0)


def _patched_rows(em, src2, ctr2, time_v, send_t, lat, stage_v, status_v):
    """[H, E, C+2] staging rows: the emission row with SRC/TIME/CTR/LAT
    (and, in full-width TCP rows, the TS send stamp) patched, plus
    stage/status scratch."""
    eb = em.blk
    base = ext_base(eb.shape[2])

    def c(x):
        return x[:, :, None].to(I32)

    pieces = [c(src2), eb[:, :, 1:ICOL_TIME_LO],
              c(enc_lo(time_v)), c(enc_hi(time_v)),
              c(enc_lo(ctr2)), c(enc_hi(ctr2))]
    if base >= ICOLS:
        pieces += [c(enc_lo(send_t)), c(enc_hi(send_t)),
                   eb[:, :, ICOL_TSE_LO:base + 1]]
    else:
        pieces += [eb[:, :, base + OEXT_DST:base + OEXT_DST + 1]]
    pieces += [c(enc_lo(lat)), c(enc_hi(lat)),
               eb[:, :, base + OEXT_PRIO:base + OEXT_PRIO + 1],
               c(stage_v), c(status_v)]
    return torch.cat(pieces, dim=2)


def _stage_emissions(state: SimState, params, em, tick_t, active, app,
                     bw_up):
    """Assign pkt_ids, route, draw reliability drops, and merge staged
    emissions into free slots of the emitting host's own outbox slab --
    IN_FLIGHT when the tx bucket covers them, else parked TX_QUEUED.  An
    app that may loop back (`_may_loopback`) has its same-host emissions
    go into its own inbox slab instead (_loopback_insert), outside the
    outbox ranks and the token bucket.  Returns (state, placed), placed
    counting both."""
    pool, hosts = state.pool, state.hosts
    h, e = em.valid.shape
    p0 = pool.capacity
    ko = p0 // h
    dev = tick_t.device

    valid = em.valid
    rank = torch.cumsum(valid, dim=1) - 1
    counts = valid.sum(dim=1).to(I64)
    ctr = hosts.send_ctr
    src2 = torch.broadcast_to(host_ids(state, I32)[:, None], (h, e))
    ctr2 = ctr[:, None] + rank

    vs = torch.broadcast_to(params.host_vertex[:, None], (h, e))
    vd = params.host_vertex[torch.clamp(em.dst, 0,
                                        params.host_vertex.shape[0] - 1)
                            .to(I64)]
    lat, rel = _route(params, vs.to(I64), vd.to(I64), src2.to(I64), ctr2)
    loop = em.dst == src2
    lat = torch.where(loop, simtime.SIMTIME_ONE_NANOSECOND, lat)
    rel = torch.where(loop, torch.ones_like(rel), rel)

    if params.has_loss:
        u = rng.keyed_uniform(params.purpose_words[rng.PURPOSE_PACKET_DROP],
                              src2.to(I64), ctr2, ctr2 >> 32)
        dropped = valid & (u >= rel)
    else:
        dropped = torch.zeros_like(valid)
    live = valid & ~dropped
    lb = live & loop if _may_loopback(app) else torch.zeros_like(live)
    nl = live & ~lb

    free = (pool.stage == STAGE_FREE).reshape(h, ko)
    n_free = free.sum(dim=1)
    nl_rank = torch.where(nl, torch.cumsum(nl, dim=1) - 1, -1)
    within = _free_slot_pick(free, nl_rank)
    placed = nl & (nl_rank >= 0) & (nl_rank < n_free[:, None])

    t_send = em.t_send
    send_t = torch.where(t_send > 0, t_send,
                         torch.broadcast_to(tick_t[:, None], (h, e)))
    arr_t = send_t + lat

    tokens, last = nic.refill(hosts.tokens_tx, hosts.last_refill_tx,
                              bw_up, tick_t, active)
    sizes = _wire_bytes(em.proto, em.length).to(I64) * nic.SCALE
    prefix = torch.cumsum(torch.where(placed, sizes, 0), dim=1)
    boot2 = (tick_t < params.bootstrap_end)[:, None]
    ok_budget = (hosts.tx_queued == 0)[:, None] & (prefix <= tokens[:, None])
    admit = placed & (boot2 | ok_budget)
    spent = torch.where(admit & ~boot2, sizes, 0).sum(dim=1)
    tokens = tokens - spent
    parked = placed & ~admit
    t_park = torch.where(parked, send_t,
                         torch.full_like(send_t, INV)).amin(dim=1)
    hosts = hosts.replace(
        tokens_tx=tokens, last_refill_tx=last,
        t_resume=torch.minimum(hosts.t_resume, t_park),
        tx_queued=hosts.tx_queued + parked.sum(dim=1).to(I32))

    stage_v = torch.where(admit, STAGE_IN_FLIGHT, STAGE_TX_QUEUED)
    time_v = torch.where(admit, arr_t, send_t)
    status_v = torch.where(
        admit, PDS_SND_CREATED | PDS_SND_INTERFACE_SENT | PDS_INET_SENT,
        PDS_SND_CREATED)

    # Each placed emission takes its own slot: write the rows there (the
    # JAX package's one-hot merge of the [H, E] rows into [H, ko]).
    pc = pool.blk.shape[1]
    val3 = _patched_rows(em, src2, ctr2, time_v, send_t, lat, stage_v,
                         status_v)
    hh, ee = placed.nonzero(as_tuple=True)
    flat = hh * ko + within[hh, ee].to(I64)
    rows = val3[hh, ee]
    blk, stage, time = pool.blk.clone(), pool.stage.clone(), pool.time.clone()
    blk[flat] = rows[:, :pc]
    stage[flat] = rows[:, pc]
    time[flat] = dec_i64(rows[:, ICOL_TIME_LO], rows[:, ICOL_TIME_HI])
    status = pool.status
    if params.pds_trail:
        status = status.clone()
        status[flat] = rows[:, pc + 1]
    pool = pool.replace(blk=blk, stage=stage, status=status, time=time)
    state = state.replace(pool=pool)

    # Loopback: straight into the sender's own inbox slab.
    lb_placed = torch.zeros_like(lb)
    if _may_loopback(app):
        state, lb_placed = _loopback_insert(state, params, em, lb, src2,
                                            ctr2, send_t)

    all_placed = placed | lb_placed
    overflow = (live & ~all_placed).any()
    sent_bytes = torch.where(all_placed, em.length, 0).sum(dim=1).to(I64)
    hosts = hosts.replace(
        send_ctr=ctr + counts,
        pkts_sent=hosts.pkts_sent + all_placed.sum(dim=1),
        bytes_sent=hosts.bytes_sent + sent_bytes,
        pkts_dropped_inet=hosts.pkts_dropped_inet + dropped.sum(dim=1),
        pkts_dropped_pool=hosts.pkts_dropped_pool
        + (live & ~all_placed).sum(dim=1))
    err = state.err | (overflow.to(I32) * ERR_POOL_OVERFLOW)
    return state.replace(hosts=hosts, err=err), all_placed


def _loopback_insert(state: SimState, params, em, lb, src2, ctr2, send_t):
    """Insert loopback emissions `lb` [H, E] into the sender's own inbox
    slab: the r-th one takes the r-th free slot in ascending order, as an
    IN_FLIGHT row in inbox layout (the emission's columns with SRC, TIME,
    CTR and, in full-width rows, the TS send stamp patched) arriving at
    send + 1 ns (the reference's network_interface.c:548-555).  Returns
    (state, placed [H, E])."""
    ib = state.inbox
    h, e = lb.shape
    ki = ib.capacity // h

    free2 = (ib.stage == STAGE_FREE).reshape(h, ki)
    n_free = free2.sum(dim=1)
    lb_rank = torch.where(lb, torch.cumsum(lb, dim=1) - 1, -1)
    within = _free_slot_pick(free2, lb_rank)
    ok = lb & (lb_rank >= 0) & (lb_rank < n_free[:, None])
    arr = send_t + simtime.SIMTIME_ONE_NANOSECOND

    def c(x):
        return x[:, :, None].to(I32)

    ic = ib.blk.shape[1]          # ICOLS, or NCOLS_UDP for TCP-free worlds
    pieces = [c(src2), em.blk[:, :, 1:ICOL_TIME_LO],
              c(enc_lo(arr)), c(enc_hi(arr)),
              c(enc_lo(ctr2)), c(enc_hi(ctr2))]
    if ic >= ICOLS:
        pieces += [c(enc_lo(send_t)), c(enc_hi(send_t)),
                   em.blk[:, :, ICOL_TSE_LO:ICOLS]]
    vals = torch.cat(pieces, dim=2)

    hh, ee = ok.nonzero(as_tuple=True)
    flat = hh * ki + within[hh, ee].to(I64)
    blk, stage = ib.blk.clone(), ib.stage.clone()
    blk[flat] = vals[hh, ee]
    stage[flat] = STAGE_IN_FLIGHT
    status = ib.status
    if params.pds_trail:
        status = status.clone()
        status[flat] = PDS_SND_CREATED | PDS_SND_INTERFACE_SENT | \
            PDS_INET_SENT
    return state.replace(inbox=ib.replace(blk=blk, stage=stage,
                                          status=status)), ok


def _select_tx_slab(pool, tick_t, active, h):
    """Per source host the earliest due TX_QUEUED packet: ([H] pool index
    or -1, [P] chosen mask)."""
    k = pool.capacity // h
    stage2 = pool.stage.reshape(h, k)
    time2 = pool.time.reshape(h, k)
    due = (stage2 == STAGE_TX_QUEUED) & (time2 <= tick_t[:, None]) & \
        active[:, None]
    td = torch.where(due, time2, torch.full_like(time2, INV))
    tmin = td.amin(dim=1)
    ids = torch.arange(k, dtype=I32, device=tick_t.device)[None, :]
    at = due & (td == tmin[:, None])
    j = torch.where(at, ids, torch.full_like(ids, k)).amin(dim=1)
    have = j < k
    j = torch.clamp(j, 0, k - 1)
    slot_of_host = torch.where(
        have, torch.arange(h, dtype=I32, device=tick_t.device) * k + j, -1)
    chosen = ((ids == j[:, None]) & have[:, None]).reshape(-1)
    return slot_of_host, chosen


def _tx_drain_body(state: SimState, params, tick_t, active, bw_up,
                   skip_refill=False):
    """Drain one parked packet per host through the tx bucket.  The JAX
    package's kernel-diet gate around it (skip when nothing is parked
    anywhere) is exact -- with no due packet the body changes nothing but
    the refill -- so the body always runs here."""
    pool, hosts = state.pool, state.hosts
    h = hosts.num_hosts
    slot_of_host, chosen = _select_tx_slab(pool, tick_t, active, h)
    have = slot_of_host >= 0
    slot = torch.clamp(slot_of_host, 0, pool.capacity - 1).to(I64)
    if skip_refill:
        tokens, last = hosts.tokens_tx, hosts.last_refill_tx
    else:
        tokens, last = nic.refill(hosts.tokens_tx, hosts.last_refill_tx,
                                  bw_up, tick_t, active)
    row = pool.blk[slot]
    size = _wire_bytes(row[:, ICOL_PROTO], row[:, ICOL_LEN]).to(I64) \
        * nic.SCALE
    boot = tick_t < params.bootstrap_end
    funded = have & (boot | (tokens >= size))
    tokens = tokens - torch.where(funded & ~boot, size, 0)

    eb = ext_base(pool.blk.shape[1])
    arr = tick_t + dec_i64(row[:, eb + OEXT_LAT_LO], row[:, eb + OEXT_LAT_HI])
    ko = pool.capacity // h
    funded_b = torch.broadcast_to(funded[:, None], (h, ko)).reshape(-1)
    arr_b = torch.broadcast_to(arr[:, None], (h, ko)).reshape(-1)
    dep = chosen & funded_b
    pool = pool.replace(
        stage=torch.where(dep, STAGE_IN_FLIGHT, pool.stage).to(I32),
        time=torch.where(dep, arr_b, pool.time),
        status=torch.where(dep, pool.status | PDS_SND_INTERFACE_SENT
                           | PDS_INET_SENT, pool.status)
        if params.pds_trail else pool.status)
    hosts = hosts.replace(tokens_tx=tokens, last_refill_tx=last,
                          tx_queued=hosts.tx_queued - funded.to(I32))
    t_tok = tick_t + nic.time_until(size - tokens, bw_up)
    t_res = torch.where(have & ~funded, t_tok,
                        torch.where(funded & (hosts.tx_queued > 0), tick_t,
                                    torch.full_like(tick_t, INV)))
    hosts = hosts.replace(t_resume=torch.minimum(hosts.t_resume, t_res))
    return state.replace(pool=pool, hosts=hosts)


def _cpu_account(state: SimState, params, tick_t, active, delivered_n,
                 em_valid):
    """Virtual-CPU accounting; returns (state, events [H] i64)."""
    cpu_on = params.cpu_ns_per_event > 0
    events = delivered_n.to(I64) + em_valid.sum(dim=1).to(I64)
    cost = params.cpu_ns_per_event * events
    avail = torch.maximum(state.hosts.cpu_avail, tick_t)
    new_avail = torch.where(cpu_on & active, avail + cost,
                            state.hosts.cpu_avail)
    return state.replace(hosts=state.hosts.replace(cpu_avail=new_avail)), \
        events


# ---------------------------------------------------------------------------
# Micro-step and loops
# ---------------------------------------------------------------------------


def _window_ctx(state: SimState, params):
    """Window-invariant micro-step inputs (bw_up, bw_dn); without netem
    they are the configured rates."""
    return params.bw_up_Bps, params.bw_down_Bps


def _n_lanes(app) -> int:
    """Emission lanes per host: TCP apps take the fixed TCP lanes plus one
    reply lane per extra delivery round; UDP apps their send lanes."""
    if _uses_tcp(app):
        return emit.NUM_SLOTS + max(0, int(getattr(app, "rx_batch", 1)) - 1)
    return emit.SLOT_APP + max(1, int(getattr(app, "app_tx_lanes", 1)))


def _tick_setup(state: SimState, t_h, window_end):
    """active / tick_t, and the resume flags of active hosts cleared."""
    active = t_h < window_end
    tick_t = torch.where(active, t_h, torch.full_like(t_h, window_end))
    hosts = state.hosts.replace(t_resume=torch.where(
        active, torch.full_like(t_h, INV), state.hosts.t_resume))
    return state.replace(hosts=hosts), active, tick_t


def _app_tick(state, params, app, em, t_post, active, window_end):
    if getattr(app, "wants_window_end", False):
        return app.on_tick(state, params, em, t_post, active,
                           window_end=window_end)
    return app.on_tick(state, params, em, t_post, active)


def _microstep_core(state: SimState, params, app, t_h, window_end: int,
                    ctx=None):
    """Advance every host's earliest pending event (< window_end); the
    reference phase graph (megakernel=False)."""
    bw_up, bw_dn = _window_ctx(state, params) if ctx is None else ctx
    h = state.hosts.num_hosts
    state, active, tick_t = _tick_setup(state, t_h, window_end)
    em = emit.empty(h, _n_lanes(app), state.pool.blk.shape[1], state.device)
    state, em, delivered_n, t_post = _rx_phase(
        state, params, em, tick_t, active, app, window_end, bw_dn)
    if _uses_tcp(app):
        state, em = tcp_mod.run_timers(state, params, em, t_post, active)
    state, em = _app_tick(state, params, app, em, t_post, active,
                          window_end)
    if _uses_tcp(app):
        state, em = tcp_mod.transmit(state, params, em, t_post, active)
    state, _placed = _stage_emissions(state, params, em, t_post, active,
                                      app, bw_up)
    state = _tx_drain_body(state, params, t_post, active, bw_up)
    state, events = _cpu_account(state, params, tick_t, active, delivered_n,
                                 em.valid)
    return state.replace(n_steps=state.n_steps + 1,
                         n_events=state.n_events + events.sum())


def microstep(state: SimState, params, app, t_h, window_end: int):
    """One micro-step (public wrapper): the fused kernels when
    params.megakernel applies, else the reference phase graph."""
    from . import megakernel as mk
    if mk.enabled(state, params, app):
        st, _t_h, _gmin = mk.microstep_fused(state, params, app, t_h,
                                             window_end)
        return st
    return _microstep_core(state, params, app, t_h, window_end)


def _window_body_ref(state: SimState, params, app, t_target):
    """One whole conservative window, reference functions only: the
    boundary exchange, the per-window scan, the window bounds, the
    micro-step loop and the window close -- the body of K_WINDOW
    (megakernel.window_fused).  Returns (state, t_h, gmin, ws, we), the
    last three as 0-d tensors."""
    st = _exchange(state, params, fused=False)
    t_h, gmin = _scan_all(st, params, app)
    ws = torch.maximum(st.now, gmin)
    we = torch.clamp(ws + params.min_latency_ns, max=int(t_target))
    ctx = _window_ctx(st, params)
    we_i = int(we)
    while int(gmin) < we_i:
        st = _microstep_core(st, params, app, t_h, we_i, ctx=ctx)
        t_h, gmin = _scan_all(st, params, app)
    st = st.replace(now=we.clone(), n_windows=st.n_windows + 1)
    return st, t_h, gmin, ws, we


def clone_state(state: SimState) -> SimState:
    """Deep copy of every tensor (the kernels update state in place; a
    run never mutates its caller's state)."""
    import dataclasses

    def cp(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(
                x, **{f.name: cp(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
        return x

    return cp(state)


def run_until(state: SimState, params, app, t_target: int) -> SimState:
    """Run windows until simulated time reaches t_target.  The caller's
    state is not modified."""
    return run_until_impl(clone_state(state), params, app, t_target)


def run_until_impl(state: SimState, params, app, t_target: int) -> SimState:
    """The window loop.  Per window: exchange, scan, window bounds, then
    micro-steps while the global next event lies before the window end --
    through K_WINDOW with params.persistent (_run_windows), else the JAX
    package's per-phase window body on the host."""
    from . import megakernel as mk
    check_supported(state, params, app)
    t_target = int(t_target)
    if mk.persistent_enabled(state, params, app):
        return _run_windows(state, params, app, t_target)
    fused = mk.enabled(state, params, app)
    ctx = _window_ctx(state, params)
    _t_h, gmin = _scan_all(state, params, app)
    now = int(state.now)
    while now < t_target and \
            min(int(gmin), int(_outbox_pending(state))) < t_target:
        state = _exchange(state, params, fused=fused)
        t_h, gmin = _scan_all(state, params, app)
        ws = max(now, int(gmin))
        we = min(ws + params.min_latency_ns, t_target)
        while int(gmin) < we:
            if fused:
                state, t_h, gmin = mk.microstep_fused(state, params, app,
                                                      t_h, we, ctx=ctx)
            else:
                state = _microstep_core(state, params, app, t_h, we, ctx=ctx)
                t_h, gmin = _scan_all(state, params, app)
        now = we
        state = state.replace(now=torch.full_like(state.now, we),
                              n_windows=state.n_windows + 1)
    return state.replace(now=torch.full_like(state.now, t_target))


def _run_windows(state: SimState, params, app, t_target: int) -> SimState:
    """The persistent window loop: window_call while the predicate holds,
    and one host read of the (gmin, ws, we, outbox pending, status) vector
    of each call's last window.  K_WINDOW's kernels run the windows of
    the whole call themselves (one launch).
    Each window ends at least min(now + min_latency, t_target), so the
    cap handed down -- that many windows reach t_target -- binds only
    when the kernel's predicate is wrong, and then raises."""
    from . import megakernel as mk
    _t_h, gmin = _scan_all(state, params, app)
    now, g = torch.stack([state.now, torch.minimum(
        gmin, _outbox_pending(state))]).tolist()
    lat = max(1, int(params.min_latency_ns))
    while now < t_target and g < t_target:
        cap = -(-(t_target - now) // lat)
        state, _t_h, win = mk.window_call(state, params, app, t_target, cap)
        gmin, _ws, now, gout, status = win.tolist()
        mk.check_window_status(status, cap)
        g = min(gmin, gout)
    return state.replace(now=torch.full_like(state.now, t_target))


CHUNK_NS = 2 * simtime.SIMTIME_ONE_SECOND


def run_chunked(state: SimState, params, app, t_target: int,
                chunk_ns: int = CHUNK_NS) -> SimState:
    """Bounded run_until calls up to t_target (chunk boundaries insert
    window boundaries exactly as the JAX run_chunked does)."""
    state = clone_state(state)
    t = int(state.now)
    t_target = int(t_target)
    while t < t_target:
        t = min(t + chunk_ns, t_target)
        state = run_until_impl(state, params, app, t)
    return state
