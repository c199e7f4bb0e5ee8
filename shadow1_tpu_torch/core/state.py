"""Simulator state as dense structure-of-arrays dataclasses of tensors
(counterpart of shadow1_tpu/core/state.py).

Same tables, same layouts, same dtypes as the JAX package, so every leaf
compares against it directly:

* `PacketPool` -- the OUTBOX, per-source slabs; a packed [P, C] int32
  block (C = pool_cols(uses_tcp)) plus the hot lifecycle arrays
  `stage`/`time`/`status`.
* `Inbox` -- per-destination slabs; packed [P1, ICOLS or NCOLS_UDP].
* `SocketTable` [H, S] and `HostTable` [H].

uint32 leaves of the JAX state are held as int64 in [0, 2^32) (see the
package docstring); each class lists them in `U32_FIELDS` so
`convert.to_numpy` can hand them back as uint32.

Blocks of the JAX `SimState` this slice does not carry (cap, log,
log_level, tr, fr, scope, nm, sentinel, lineage, dg, hoff) have no field
here; `convert.from_jax` refuses a state that holds any of them.
"""

from __future__ import annotations

import dataclasses

import torch

from . import simtime

# ---------------------------------------------------------------------------
# Enums / constants (copied from the JAX package; plain ints)
# ---------------------------------------------------------------------------

STAGE_FREE = 0
STAGE_TX_QUEUED = 1
STAGE_IN_FLIGHT = 2
STAGE_RX_QUEUED = 3

PROTO_NONE = 0
PROTO_TCP = 6
PROTO_UDP = 17

SOCK_FREE = 0
SOCK_UDP = 1
SOCK_TCP = 2

PDS_SND_CREATED = 1 << 0
PDS_SND_TCP_ENQUEUE_THROTTLED = 1 << 1
PDS_SND_INTERFACE_SENT = 1 << 2
PDS_INET_SENT = 1 << 3
PDS_INET_DROPPED = 1 << 4
PDS_ROUTER_ENQUEUED = 1 << 5
PDS_ROUTER_DROPPED = 1 << 6
PDS_RCV_INTERFACE_RECEIVED = 1 << 7
PDS_RCV_SOCKET_PROCESSED = 1 << 8
PDS_DESTROYED = 1 << 9

ERR_POOL_OVERFLOW = 1 << 0
ERR_SOCKET_OVERFLOW = 1 << 1
ERR_UDPQ_OVERFLOW = 1 << 2

TCP_FLAG_FIN = 1
TCP_FLAG_SYN = 2
TCP_FLAG_RST = 4
TCP_FLAG_PSH = 8   # the zero-window probe marker (forces an ACK)
TCP_FLAG_ACK = 16

TCPS_CLOSED = 0
TCPS_LISTEN = 1
TCPS_SYNSENT = 2
TCPS_SYNRECEIVED = 3
TCPS_ESTABLISHED = 4
TCPS_FINWAIT1 = 5
TCPS_FINWAIT2 = 6
TCPS_CLOSING = 7
TCPS_TIMEWAIT = 8
TCPS_CLOSEWAIT = 9
TCPS_LASTACK = 10

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
BOOL = torch.bool

MTU = 1500
TCP_HEADER_SIZE = 40
UDP_HEADER_SIZE = 28
TCP_MSS = MTU - TCP_HEADER_SIZE

# Packed inbox columns (all int32; int64 fields split 31-bit lo / hi).
(ICOL_SRC, ICOL_SPORT, ICOL_DPORT, ICOL_PROTO, ICOL_FLAGS, ICOL_SEQ,
 ICOL_ACK, ICOL_WND, ICOL_LEN, ICOL_PAYLOAD,
 ICOL_TIME_LO, ICOL_TIME_HI, ICOL_CTR_LO, ICOL_CTR_HI,
 ICOL_TS_LO, ICOL_TS_HI, ICOL_TSE_LO, ICOL_TSE_HI,
 ICOL_SACK0_LO, ICOL_SACK0_HI, ICOL_SACK1_LO, ICOL_SACK1_HI,
 ICOL_SACK2_LO, ICOL_SACK2_HI) = range(24)
ICOLS = 24
NCOLS_UDP = ICOL_CTR_HI + 1

OCOL_DST = ICOLS + 0
OCOL_LAT_LO = ICOLS + 1
OCOL_LAT_HI = ICOLS + 2
OCOL_PRIO = ICOLS + 3
OCOLS = ICOLS + 4

(OEXT_DST, OEXT_LAT_LO, OEXT_LAT_HI, OEXT_PRIO) = range(4)
OEXT_COLS = 4

SACK_BLOCKS = 3
SACK_RANGES = 8
SSACK_RANGES = 4
UDP_RING = 8


def ext_base(cols: int) -> int:
    """First extension column of a width-`cols` packed outbox block."""
    return cols - OEXT_COLS


def pool_cols(uses_tcp: bool) -> int:
    """Packed outbox/emission block width: inbox width + extension."""
    return (ICOLS if uses_tcp else NCOLS_UDP) + OEXT_COLS


_LO_MASK = (1 << 31) - 1


def enc_lo(x):
    """Low 31 bits of a non-negative int64 as int32."""
    return (x & _LO_MASK).to(I32)


def enc_hi(x):
    """High bits (>> 31) of a non-negative int64 as int32."""
    return (x >> 31).to(I32)


def dec_i64(lo, hi):
    return (hi.to(I64) << 31) | lo.to(I64)


# ---------------------------------------------------------------------------
# Dataclass plumbing
# ---------------------------------------------------------------------------


class Tree:
    """Dataclass-of-tensors base: `replace` like flax's struct.dataclass;
    `U32_FIELDS` names the leaves that are uint32 in the JAX package."""

    U32_FIELDS: frozenset = frozenset()

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _z(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _f(shape, dtype, value, device):
    return torch.full(shape, value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PacketPool(Tree):
    """All packets in the world (the OUTBOX half), per-source slabs."""

    blk: torch.Tensor      # [P, C] i32 packed
    stage: torch.Tensor    # [P] i32 STAGE_*
    time: torch.Tensor     # [P] i64 (authoritative; blk TIME cols go stale)
    status: torch.Tensor   # [P] i32 PDS_* trail

    @property
    def capacity(self) -> int:
        return self.stage.shape[0]

    @property
    def dst(self):
        return self.blk[:, ext_base(self.blk.shape[1]) + OEXT_DST]


def make_packet_pool(capacity: int, cols: int, device) -> PacketPool:
    return PacketPool(
        blk=_z((capacity, cols), I32, device),
        stage=_z((capacity,), I32, device),
        time=_f((capacity,), I64, simtime.SIMTIME_INVALID, device),
        status=_z((capacity,), I32, device),
    )


@dataclasses.dataclass
class Inbox(Tree):
    """Packets at (or heading to) their destination: slot d * slab + k
    belongs to destination host d."""

    blk: torch.Tensor      # [P1, C] i32 packed
    stage: torch.Tensor    # [P1] i32
    status: torch.Tensor   # [P1] i32

    @property
    def capacity(self) -> int:
        return self.stage.shape[0]

    def times(self):
        return dec_i64(self.blk[:, ICOL_TIME_LO], self.blk[:, ICOL_TIME_HI])

    def order_keys(self):
        """(src << 40) | ctr: the deterministic total-order tiebreak."""
        src = self.blk[:, ICOL_SRC].to(I64)
        ctr = dec_i64(self.blk[:, ICOL_CTR_LO], self.blk[:, ICOL_CTR_HI])
        return (src << 40) | ctr


def make_inbox(num_hosts: int, slab: int, cols: int, device) -> Inbox:
    p1 = num_hosts * slab
    return Inbox(blk=_z((p1, cols), I32, device),
                 stage=_z((p1,), I32, device),
                 status=_z((p1,), I32, device))


_SOCK_U32 = frozenset({
    "snd_una", "snd_nxt", "snd_end", "recover", "retrans_nxt",
    "retrans_end", "rcv_nxt", "rcv_read", "sack_lo", "sack_hi", "fin_seq",
    "ssack_lo", "ssack_hi"})


@dataclasses.dataclass
class SocketTable(Tree):
    """[H, S] socket slots: the UDP ring and the TCP machine's fields
    (transport/tcp.py)."""

    U32_FIELDS = _SOCK_U32

    stype: torch.Tensor
    tcp_state: torch.Tensor
    local_port: torch.Tensor
    peer_host: torch.Tensor
    peer_port: torch.Tensor
    parent: torch.Tensor
    accepted: torch.Tensor
    child_order: torch.Tensor
    backlog: torch.Tensor
    snd_una: torch.Tensor
    snd_nxt: torch.Tensor
    snd_end: torch.Tensor
    snd_wnd: torch.Tensor
    snd_buf_cap: torch.Tensor
    cwnd: torch.Tensor
    ssthresh: torch.Tensor
    dup_acks: torch.Tensor
    recover: torch.Tensor
    in_recovery: torch.Tensor
    retrans_nxt: torch.Tensor
    retrans_end: torch.Tensor
    app_closed: torch.Tensor
    rcv_nxt: torch.Tensor
    rcv_read: torch.Tensor
    rcv_buf_cap: torch.Tensor
    sack_lo: torch.Tensor
    sack_hi: torch.Tensor
    fin_seq: torch.Tensor
    ts_recent: torch.Tensor
    srtt: torch.Tensor
    rttvar: torch.Tensor
    rto: torch.Tensor
    t_rto: torch.Tensor
    t_delack: torch.Tensor
    t_tw: torch.Tensor
    t_persist: torch.Tensor
    delack_pending: torch.Tensor
    at_bytes: torch.Tensor
    at_last: torch.Tensor
    cub_epoch: torch.Tensor
    cub_wmax: torch.Tensor
    ssack_lo: torch.Tensor
    ssack_hi: torch.Tensor
    retx_segs: torch.Tensor
    udp_head: torch.Tensor
    udp_count: torch.Tensor
    udp_src: torch.Tensor
    udp_sport: torch.Tensor
    udp_len: torch.Tensor
    udp_payload: torch.Tensor
    error: torch.Tensor
    bytes_sent: torch.Tensor
    bytes_recv: torch.Tensor
    def_snd_buf: torch.Tensor
    def_rcv_buf: torch.Tensor

    @property
    def num_hosts(self) -> int:
        return self.stype.shape[0]

    @property
    def slots(self) -> int:
        return self.stype.shape[1]


def make_socket_table(num_hosts: int, slots: int, device) -> SocketTable:
    hs = (num_hosts, slots)
    inv = simtime.SIMTIME_INVALID
    z, f = _z, _f
    d = device
    return SocketTable(
        stype=z(hs, I32, d), tcp_state=z(hs, I32, d),
        local_port=z(hs, I32, d), peer_host=f(hs, I32, -1, d),
        peer_port=z(hs, I32, d), parent=f(hs, I32, -1, d),
        accepted=z(hs, BOOL, d), child_order=z(hs, I64, d),
        backlog=z(hs, I32, d),
        snd_una=z(hs, I64, d), snd_nxt=z(hs, I64, d), snd_end=z(hs, I64, d),
        snd_wnd=z(hs, I32, d), snd_buf_cap=z(hs, I32, d),
        cwnd=z(hs, I32, d), ssthresh=z(hs, I32, d), dup_acks=z(hs, I32, d),
        recover=z(hs, I64, d), in_recovery=z(hs, BOOL, d),
        retrans_nxt=z(hs, I64, d), retrans_end=z(hs, I64, d),
        app_closed=z(hs, BOOL, d),
        rcv_nxt=z(hs, I64, d), rcv_read=z(hs, I64, d),
        rcv_buf_cap=z(hs, I32, d),
        sack_lo=z(hs + (SACK_RANGES,), I64, d),
        sack_hi=z(hs + (SACK_RANGES,), I64, d),
        fin_seq=z(hs, I64, d),
        ts_recent=z(hs, I64, d), srtt=z(hs, I64, d), rttvar=z(hs, I64, d),
        rto=z(hs, I64, d),
        t_rto=f(hs, I64, inv, d), t_delack=f(hs, I64, inv, d),
        t_tw=f(hs, I64, inv, d), t_persist=f(hs, I64, inv, d),
        delack_pending=z(hs, I32, d),
        at_bytes=z(hs, I64, d), at_last=z(hs, I64, d),
        cub_epoch=z(hs, I64, d), cub_wmax=z(hs, I32, d),
        ssack_lo=z(hs + (SSACK_RANGES,), I64, d),
        ssack_hi=z(hs + (SSACK_RANGES,), I64, d),
        retx_segs=z(hs, I32, d),
        udp_head=z(hs, I32, d), udp_count=z(hs, I32, d),
        udp_src=f(hs + (UDP_RING,), I32, -1, d),
        udp_sport=z(hs + (UDP_RING,), I32, d),
        udp_len=z(hs + (UDP_RING,), I32, d),
        udp_payload=f(hs + (UDP_RING,), I32, -1, d),
        error=z(hs, I32, d), bytes_sent=z(hs, I64, d),
        bytes_recv=z(hs, I64, d),
        def_snd_buf=f((num_hosts,), I32, 131072, d),
        def_rcv_buf=f((num_hosts,), I32, 174760, d),
    )


@dataclasses.dataclass
class HostTable(Tree):
    """[H] per-host NIC buckets, CoDel state, counters."""

    U32_FIELDS = frozenset({"rng_ctr"})

    rng_ctr: torch.Tensor
    send_ctr: torch.Tensor
    cpu_avail: torch.Tensor
    rr_next: torch.Tensor
    t_resume: torch.Tensor
    tokens_tx: torch.Tensor
    tokens_rx: torch.Tensor
    last_refill_tx: torch.Tensor
    last_refill_rx: torch.Tensor
    tx_queued: torch.Tensor
    rx_queued: torch.Tensor
    codel_count: torch.Tensor
    codel_dropping: torch.Tensor
    codel_first_above: torch.Tensor
    codel_drop_next: torch.Tensor
    bytes_sent: torch.Tensor
    bytes_recv: torch.Tensor
    pkts_sent: torch.Tensor
    pkts_recv: torch.Tensor
    pkts_dropped_inet: torch.Tensor
    pkts_dropped_router: torch.Tensor
    pkts_dropped_pool: torch.Tensor
    acks_thinned: torch.Tensor

    @property
    def num_hosts(self) -> int:
        return self.rng_ctr.shape[0]


def make_host_table(num_hosts: int, device) -> HostTable:
    h = (num_hosts,)
    z, d = _z, device
    return HostTable(
        rng_ctr=z(h, I64, d), send_ctr=z(h, I64, d), cpu_avail=z(h, I64, d),
        rr_next=z(h, I32, d),
        t_resume=_f(h, I64, simtime.SIMTIME_INVALID, d),
        tokens_tx=z(h, I64, d), tokens_rx=z(h, I64, d),
        last_refill_tx=z(h, I64, d), last_refill_rx=z(h, I64, d),
        tx_queued=z(h, I32, d), rx_queued=z(h, I32, d),
        codel_count=z(h, I32, d), codel_dropping=z(h, BOOL, d),
        codel_first_above=z(h, I64, d), codel_drop_next=z(h, I64, d),
        bytes_sent=z(h, I64, d), bytes_recv=z(h, I64, d),
        pkts_sent=z(h, I64, d), pkts_recv=z(h, I64, d),
        pkts_dropped_inet=z(h, I64, d), pkts_dropped_router=z(h, I64, d),
        pkts_dropped_pool=z(h, I64, d), acks_thinned=z(h, I64, d),
    )


# Blocks of the JAX SimState that this slice does not carry.
UNCARRIED_BLOCKS = ("cap", "log", "log_level", "tr", "fr", "scope", "nm",
                    "sentinel", "lineage", "dg", "hoff")


@dataclasses.dataclass
class SimState(Tree):
    """Everything that evolves during a run.  Scalars (`now`, `err`,
    `n_*`) are 0-d tensors on the state's device, so a run needs no host
    round trip to update them."""

    now: torch.Tensor          # i64 scalar
    pool: PacketPool
    inbox: Inbox
    socks: SocketTable
    hosts: HostTable
    app: object = None
    err: torch.Tensor = None   # i32 scalar
    n_steps: torch.Tensor = None
    n_windows: torch.Tensor = None
    n_events: torch.Tensor = None

    @property
    def device(self) -> torch.device:
        return self.pool.stage.device


def host_ids(state, dtype=I32) -> torch.Tensor:
    """GLOBAL host ids of this state's rows (arange off-mesh; the mesh is
    not part of this slice)."""
    return torch.arange(state.hosts.num_hosts, dtype=dtype,
                        device=state.device)


def make_sim_state(num_hosts: int, sock_slots: int = 16,
                   pool_capacity: int = 1 << 15, app=None,
                   inbox_capacity: int | None = None,
                   uses_tcp: bool = True, device=None) -> SimState:
    """Per-host slabs of at least 8 slots; capacities round up to a
    multiple of num_hosts (same rule as the JAX package)."""
    from .. import resolve_device
    dev = resolve_device(device)
    slab = max(8, -(-pool_capacity // num_hosts))
    if inbox_capacity is None:
        inbox_capacity = pool_capacity
    islab = max(8, -(-inbox_capacity // num_hosts))
    return SimState(
        now=torch.zeros((), dtype=I64, device=dev),
        pool=make_packet_pool(num_hosts * slab, pool_cols(uses_tcp), dev),
        inbox=make_inbox(num_hosts, islab,
                         ICOLS if uses_tcp else NCOLS_UDP, dev),
        socks=make_socket_table(num_hosts, sock_slots, dev),
        hosts=make_host_table(num_hosts, dev),
        app=app,
        err=torch.zeros((), dtype=I32, device=dev),
        n_steps=torch.zeros((), dtype=I64, device=dev),
        n_windows=torch.zeros((), dtype=I64, device=dev),
        n_events=torch.zeros((), dtype=I64, device=dev),
    )
