"""The port's hand-written kernels, their launch wrappers, and their
plain torch versions (counterpart of shadow1_tpu/core/megakernel.py).

Each TPU kernel of the JAX package has a CUDA kernel here, written for
sm_90a in `csrc/` and built by core/_build.py:

* exchange  (csrc/exchange.cu)  <- megakernel.exchange_call,
  shadow1_tpu/core/megakernel.py:231-289, body engine._exchange_core
  (with the ACK-before-data two-class re-rank of TCP worlds);
* deliver   (csrc/deliver.cu)   <- microstep_fused's K_DELIVER,
  megakernel.py:502-545, body engine._rx_phase (with
  tcp.process_arrivals in TCP worlds, csrc/tcp.cuh);
* transport (csrc/transport.cu) <- microstep_fused's K_TRANSPORT,
  megakernel.py:562-658, body tcp.transmit (TCP worlds) +
  _stage_emissions + _tx_drain_body + CPU accounting + the post-step
  scan;
* window    (csrc/window.cu)    <- window_fused's K_WINDOW,
  megakernel.py:391-424, body engine._window_body_ref: the exchange, the
  scan, the window bounds and the whole micro-step loop with the app's
  tick as device code, as one cooperative launch that loops the windows
  of a whole run_until call on the card -- k_window for UDP worlds with
  phold's tick (csrc/phold_tick.cuh), and for TCP worlds with
  tcp.run_timers (csrc/tcp.cuh) k_window_tcp with bulk's tick
  (csrc/bulk_tick.cuh) and, with tgen's (csrc/tgen_tick.cuh), the
  resident kernel k_window_tgen_res (one block per host, its sockets and
  slab keys in shared memory) where the world's shape fits, else
  k_window_tgen.  The three phases are one copy of device code
  (csrc/*.cuh) that the per-phase kernels share.

The TCP kernels of K_DELIVER, K_TRANSPORT and K_WINDOW run one warp per
host -- K_DELIVER's and K_WINDOW's hosts walked warp-stride over a
cooperative grid sized from the occupancy query, K_TRANSPORT's as a plain
launch of one warp per host -- so no host count is refused (the resident
tgen kernel, one block per host, takes the worlds whose hosts all fit one
resident block each, and k_window_tgen the rest); the UDP
kernels run one thread per host (csrc/common.cuh, the Solo and Warp
teams), with the host's loads in a few dependent steps where its slabs
fit (deliver_small, transport_small).  The exchange is one cooperative launch of a
stable radix sort of the movers by destination (csrc/exchange.cuh
ex_run), which K_WINDOW's window open shares.

Interface receive buffers (params.has_iface_buf) and, in TCP worlds, the
congestion control (params.cong: Reno or CUBIC) are template parameters
of the K_DELIVER and K_WINDOW kernels: the launchers pick the
instantiation from the arguments (`DeliverArgs.has_iface_buf`,
`TcpArgs.cong`), once per launch.

Dispatch rule, the same for every wrapper: a CUDA tensor launches the
kernel (or raises); a CPU tensor runs the plain version, which is built
from the reference functions of core/engine.py.  There is no third path
and no fallback.  The kernels update the state's tensors in place
(run_until clones its input once); the plain versions return new
tensors.  Each wrapper counts its launches in `LAUNCHES`.

With `params.persistent` (the default, as in the JAX package) the
windows run through K_WINDOW, for every app with a device tick (Phold,
Bulk and Tgen: `app.device_tick`): one launch per run_until call.
Without it, the app tick (and
in TCP worlds tcp.run_timers before it) runs between K_DELIVER and
K_TRANSPORT as plain torch on the state's device, as it runs between the
Pallas kernels in the JAX per-phase graph.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import emit, engine, rng, xlamath
from ..transport import cong, tcp
from .state import I32, I64, ICOLS, SACK_RANGES, SSACK_RANGES

INV = engine.INV

# Launches of each kernel since the last reset (plain versions do not
# count).  chip_smoke.py zeroes these around the run of each path.
LAUNCHES = {"exchange": 0, "deliver": 0, "transport": 0, "window": 0}
# K_WINDOW's launches on tgen worlds by design (window_tgen_resident):
# the resident kernel and the warp design, each also one of
# LAUNCHES["window"].
TGEN_LAUNCHES = {"resident": 0, "warp": 0}

_BLOCK = 256     # threads per block of the per-host kernels
_TR_BLOCK = 128  # threads per block of k_transport (csrc/transport.cu)
_WIN_BLOCK = 128  # threads per block of k_window (csrc/window.cu kWinBlock)

# K_WINDOW's micro-step cap per window: far above any real window (the
# bench world's take ~6); past it the kernel stops and the wrapper raises.
MAX_STEPS = 1 << 20

# K_WINDOW's status words (the result vector's last word; csrc/window.cu).
STATUS_STEP_CAP = 1     # a window reached MAX_STEPS micro-steps
STATUS_WINDOW_CAP = 2   # the launch ran max_windows windows with the
                        # window loop's predicate still true

# Cooperative grid sizes from the occupancy queries, per (device, library,
# kernel).
_OCCUPANCY: dict = {}


def _phase(name: str):
    """A profiler range named `name` while a torch profiler records, else
    nothing: an idle `record_function` still calls into the profiler on
    every entry, once per phase of every micro-step."""
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", True):
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def reset_launches() -> None:
    for counts in (LAUNCHES, TGEN_LAUNCHES):
        for k in counts:
            counts[k] = 0


def enabled(state, params, app) -> bool:
    """Does this world take the kernel path?  (No instrumentation block
    exists in the port yet, so only the static flag decides.)"""
    return bool(getattr(params, "megakernel", False))


def persistent_enabled(state, params, app) -> bool:
    """Does this world run whole windows through K_WINDOW?  The kernel
    path plus the params.persistent static (the port has no mesh)."""
    return enabled(state, params, app) and \
        bool(getattr(params, "persistent", False))


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _addr(t) -> int:
    """A tensor's address for a pointer argument or struct field (0 for
    None)."""
    return t.data_ptr() if t is not None else 0


def _check(t, dtype, shape, name):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: kernel takes a CUDA tensor")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _transport_blocks(h: int, tcp: bool) -> int:
    """Blocks (and block partials) of K_TRANSPORT for h hosts: one
    thread per host in _TR_BLOCK-thread blocks (k_transport), or one warp
    per host (k_transport_tcp, _BLOCK // 32 hosts a block)."""
    return -(-h // (_BLOCK // 32 if tcp else _TR_BLOCK))


# k_transport's ticket word per device: zero between launches (the last
# block resets it).
_TICKETS: dict = {}


def _ticket(device) -> torch.Tensor:
    key = str(device)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((1,), dtype=I32, device=device)
    return _TICKETS[key]


# ---------------------------------------------------------------------------
# exchange
# ---------------------------------------------------------------------------


def exchange_plain(pool, ib, h, params):
    """Plain version: engine._exchange_core."""
    return engine._exchange_core(pool, ib, h, params)


# The exchange's sort (csrc/exchange.cuh): at most EX_RBITS bits a pass.
EX_RBITS = 8


def _ex_plan(h: int, tcp: bool) -> tuple[int, int]:
    """(passes, digit bits) of the exchange's radix sort for h
    destinations: one pass over the whole key ((d << 1) | pure_ack in TCP
    worlds, d in UDP worlds) when it fits in 2^EX_RBITS bins, else two or
    more passes over d alone, each of at most EX_RBITS bits."""
    keys = h << int(tcp)
    if keys <= 1 << EX_RBITS:
        return 1, max(1, (keys - 1).bit_length())
    bits = (h - 1).bit_length()
    passes = max(2, -(-bits // EX_RBITS))
    return passes, -(-bits // passes)


class _ExchangeArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "pool_blk", "pool_stage", "pool_time", "pool_status", "ib_blk",
        "ib_stage", "ib_status", "total", "total_prot", "n_free", "fbase",
        "flist", "keys", "vals", "table", "start", "prot", "part")] + [
        ("p0", ctypes.c_int64)] + [(n, ctypes.c_int32) for n in (
            "pc", "ic", "ki", "h", "pds_trail", "tcp", "passes", "dbits",
            "v1")]


def _ex_struct(pool, ib, h, params, grid: int, v1: bool = False):
    """The exchange's arguments (csrc/exchange.cuh ExchangeArgs) for a
    grid of `grid` blocks, state tensors checked and its scratch
    allocated.  `v1` asks K_WINDOW for the previous design's passes.
    Returns (struct, the tensors it points at: keep them referenced until
    the launch is enqueued, and (total, total_prot, n_free))."""
    p0, pc = pool.blk.shape
    p1, ic = ib.blk.shape
    if p0 % h or p1 % h:
        raise ValueError("pool and inbox capacities must be multiples of h")
    _check(pool.blk, I32, (p0, pc), "pool.blk")
    _check(pool.time, I64, (p0,), "pool.time")
    _check(pool.stage, I32, (p0,), "pool.stage")
    _check(pool.status, I32, (p0,), "pool.status")
    _check(ib.blk, I32, (p1, ic), "inbox.blk")
    _check(ib.stage, I32, (p1,), "inbox.stage")
    _check(ib.status, I32, (p1,), "inbox.status")
    if max(p0, p1) >= 1 << 31:
        raise ValueError("the exchange takes pools and inboxes below 2^31 "
                         "rows")
    tcp_on = ic >= ICOLS
    passes, dbits = _ex_plan(h, tcp_on)
    dev = pool.blk.device

    def buf(n):
        return torch.empty((n,), dtype=I32, device=dev)
    two = 2 if passes > 1 else 1   # the sort's buffers (v1: bucket lists)
    t = dict(total=buf(h), total_prot=buf(h), n_free=buf(h),
             fbase=buf(h + 1), flist=buf(p1), keys=buf(two * p0),
             vals=buf(two * p0),
             table=buf(passes * (1 << dbits) * grid + h + 1),
             start=buf(h + 1) if passes > 1 or v1 else None,
             prot=buf(p0 + 1) if passes > 1 and tcp_on else None,
             part=buf(2 * grid * 4))
    x = _ExchangeArgs(
        pool_blk=_addr(pool.blk), pool_stage=_addr(pool.stage),
        pool_time=_addr(pool.time), pool_status=_addr(pool.status),
        ib_blk=_addr(ib.blk), ib_stage=_addr(ib.stage),
        ib_status=_addr(ib.status), **{k: _addr(v) for k, v in t.items()},
        p0=p0, pc=pc, ic=ic, ki=p1 // h, h=h,
        pds_trail=int(bool(params.pds_trail)), tcp=int(tcp_on),
        passes=passes, dbits=dbits, v1=int(bool(v1)))
    return x, t, (t["total"], t["total_prot"], t["n_free"])


def _exchange_grid(lib, p0: int, p1: int) -> int:
    """Blocks of the exchange's cooperative grid: one per 1,024 pool rows
    or inbox slots, at most one per SM (the stages' barriers cost more
    with more blocks than the work gains), and no more than the card
    keeps resident.  Raises if the card cannot launch it cooperatively."""
    key = (torch.cuda.current_device(), id(lib), "exchange")
    if key not in _OCCUPANCY:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.exchange_occupancy(ctypes.byref(per_sm), ctypes.byref(sms))
        if rc == -1:
            raise RuntimeError("exchange: the device cannot launch "
                               "cooperative kernels")
        _raise_on(rc, "exchange (occupancy query)")
        _OCCUPANCY[key] = (per_sm.value, sms.value)
    per_sm, sms = _OCCUPANCY[key]
    return max(1, min(-(-max(p0, p1) // 1024), sms, per_sm * sms))


def exchange_kernel(pool, ib, h, params):
    """Launch csrc/exchange.cu: one cooperative launch.  Updates
    pool.stage and the inbox in place; returns (pool, ib, total,
    total_prot, n_free)."""
    from . import _build
    lib = _build.load("exchange")
    grid = _exchange_grid(lib, pool.blk.shape[0], ib.blk.shape[0])
    x, keep, (total, total_prot, n_free) = _ex_struct(pool, ib, h, params,
                                                      grid)
    rc = lib.exchange_launch(ctypes.byref(x), grid, _stream())
    del keep
    _raise_on(rc, "exchange")
    LAUNCHES["exchange"] += 1
    return pool, ib, total, total_prot, n_free


def exchange_call(pool, ib, h, params):
    """The exchange: kernel on a CUDA tensor, plain version on the CPU."""
    if _on_cuda(pool.stage):
        return exchange_kernel(pool, ib, h, params)
    return exchange_plain(pool, ib, h, params)


# ---------------------------------------------------------------------------
# The TCP branches' arguments (csrc/tcp.cuh TcpArgs)
# ---------------------------------------------------------------------------

# Socket-table fields in TcpArgs order, with their dtypes (uint32 leaves
# are int64 words) and trailing range width (None for [H, S]).
_TCP_SOCK_FIELDS = (
    ("stype", I32, None), ("tcp_state", I32, None), ("local_port", I32, None),
    ("peer_host", I32, None), ("peer_port", I32, None), ("parent", I32, None),
    ("accepted", torch.bool, None), ("child_order", I64, None),
    ("backlog", I32, None), ("snd_una", I64, None), ("snd_nxt", I64, None),
    ("snd_end", I64, None), ("snd_wnd", I32, None),
    ("snd_buf_cap", I32, None), ("cwnd", I32, None), ("ssthresh", I32, None),
    ("dup_acks", I32, None), ("recover", I64, None),
    ("in_recovery", torch.bool, None), ("retrans_nxt", I64, None),
    ("retrans_end", I64, None), ("app_closed", torch.bool, None),
    ("rcv_nxt", I64, None), ("rcv_read", I64, None),
    ("rcv_buf_cap", I32, None), ("sack_lo", I64, SACK_RANGES),
    ("sack_hi", I64, SACK_RANGES), ("fin_seq", I64, None),
    ("ts_recent", I64, None), ("srtt", I64, None), ("rttvar", I64, None),
    ("rto", I64, None), ("t_rto", I64, None), ("t_delack", I64, None),
    ("t_tw", I64, None), ("t_persist", I64, None),
    ("delack_pending", I32, None), ("at_bytes", I64, None),
    ("at_last", I64, None), ("cub_epoch", I64, None), ("cub_wmax", I32, None),
    ("ssack_lo", I64, SSACK_RANGES), ("ssack_hi", I64, SSACK_RANGES),
    ("retx_segs", I32, None), ("error", I32, None), ("bytes_sent", I64, None),
    ("bytes_recv", I64, None))


class _TcpArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n, _d, _r in _TCP_SOCK_FIELDS] + [
        (n, ctypes.c_void_p) for n in (
            "def_snd_buf", "def_rcv_buf", "autotune_snd", "autotune_rcv",
            "rr_next", "em_valid", "em_blk", "gates", "err", "carry")] + [
        ("min_latency", ctypes.c_int64), ("slots", ctypes.c_int32),
        ("e", ctypes.c_int32), ("pc", ctypes.c_int32),
        ("qdisc", ctypes.c_int32), ("cong", ctypes.c_int32)]


def cong_index(params) -> int:
    """TcpArgs.cong: the index of params.cong in cong.ALGORITHMS
    (csrc/tcp.cuh CONG_RENO, CONG_CUBIC), which picks the TCP kernels'
    instantiation."""
    return cong.ALGORITHMS.index(cong.validate(params.cong))


def _tcp_struct(state, params, em, gates=None, carry=None) -> _TcpArgs:
    """The TCP branches' arguments, socket table and emission block
    checked.  `gates` (int32 words) and `carry` (`_carry_scratch`) are the
    warp-per-host kernels' grid-wide gate words and per-host records
    across them; K_TRANSPORT leaves both None."""
    socks, hosts = state.socks, state.hosts
    h, s = socks.num_hosts, socks.slots
    pc = state.pool.blk.shape[1]
    e = em.valid.shape[1]
    if pc != ICOLS + 4:
        raise ValueError("the TCP kernels take the full-width (28-column) "
                         "pool")
    ptrs = {}
    for name, dt, r in _TCP_SOCK_FIELDS:
        t = getattr(socks, name)
        _check(t, dt, (h, s) if r is None else (h, s, r), f"socks.{name}")
        ptrs[name] = _addr(t)
    for name in ("def_snd_buf", "def_rcv_buf"):
        _check(getattr(socks, name), I32, (h,), f"socks.{name}")
    for name in ("autotune_snd", "autotune_rcv"):
        _check(getattr(params, name), torch.bool, (h,), f"params.{name}")
    _check(hosts.rr_next, I32, (h,), "hosts.rr_next")
    _check(em.valid, torch.bool, (h, e), "em.valid")
    _check(em.blk, I32, (h, e, pc), "em.blk")
    _check(state.err, I32, (), "err")
    return _TcpArgs(
        **ptrs, def_snd_buf=_addr(socks.def_snd_buf),
        def_rcv_buf=_addr(socks.def_rcv_buf),
        autotune_snd=_addr(params.autotune_snd),
        autotune_rcv=_addr(params.autotune_rcv),
        rr_next=_addr(hosts.rr_next), em_valid=_addr(em.valid),
        em_blk=_addr(em.blk), gates=_addr(gates), err=_addr(state.err),
        carry=_addr(carry),
        min_latency=params.min_latency_ns, slots=s, e=e, pc=pc,
        qdisc=int(params.qdisc), cong=cong_index(params))


# Bytes of one host's record across the TCP kernels' gate barriers
# (csrc/deliver.cuh HostCarry, HOST_CARRY_BYTES).
CARRY_BYTES = 512


def _carry_scratch(h: int, device) -> torch.Tensor:
    return torch.empty((h, CARRY_BYTES // 8), dtype=I64, device=device)


# ---------------------------------------------------------------------------
# K_DELIVER
# ---------------------------------------------------------------------------


def deliver_plain(state, params, app, em, tick_t, active, window_end,
                  bw_dn, aux0):
    """Plain version: engine._rx_phase.  Returns
    (state, em, delivered_n, t_post)."""
    return engine._rx_phase(state, params, em, tick_t, active, app,
                            window_end, bw_dn, aux_bound=aux0)


class _DeliverArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "ib_blk", "ib_stage", "ib_status",
        "tokens_rx", "last_refill_rx", "rx_queued", "codel_count",
        "codel_dropping", "codel_first_above", "codel_drop_next",
        "pkts_dropped_router", "pkts_recv", "bytes_recv", "t_resume",
        "stype", "local_port", "peer_host", "peer_port", "udp_head",
        "udp_count", "udp_src", "udp_sport", "udp_len", "udp_payload",
        "sock_bytes_recv", "tick_t", "active", "bw_dn", "aux0",
        "delivered_n", "t_post", "rsqrt_tab", "iface_buf_pkts")] + [
        ("bootstrap_end", ctypes.c_int64), ("window_end", ctypes.c_int64),
        ("h", ctypes.c_int32), ("ki", ctypes.c_int32),
        ("ic", ctypes.c_int32), ("slots", ctypes.c_int32),
        ("rx_batch", ctypes.c_int32), ("pds_trail", ctypes.c_int32),
        ("has_iface_buf", ctypes.c_int32)]


def _deliver_struct(state, params, app, bw_dn, window_end=0, tick_t=None,
                    active=None, aux0=None, delivered_n=None,
                    t_post=None) -> _DeliverArgs:
    """K_DELIVER's arguments, state tensors checked.  The per-host inputs
    and outputs are the per-phase kernel's; K_WINDOW leaves them None."""
    ib, hosts, socks = state.inbox, state.hosts, state.socks
    h = hosts.num_hosts
    p1, ic = ib.blk.shape
    s = socks.slots
    _check(ib.blk, I32, (p1, ic), "inbox.blk")
    _check(ib.stage, I32, (p1,), "inbox.stage")
    _check(ib.status, I32, (p1,), "inbox.status")
    for name in ("tokens_rx", "last_refill_rx", "codel_first_above",
                 "codel_drop_next", "pkts_dropped_router", "pkts_recv",
                 "bytes_recv", "t_resume"):
        _check(getattr(hosts, name), I64, (h,), f"hosts.{name}")
    for name in ("rx_queued", "codel_count"):
        _check(getattr(hosts, name), I32, (h,), f"hosts.{name}")
    _check(hosts.codel_dropping, torch.bool, (h,), "hosts.codel_dropping")
    for name in ("stype", "local_port", "peer_host", "peer_port",
                 "udp_head", "udp_count"):
        _check(getattr(socks, name), I32, (h, s), f"socks.{name}")
    for name in ("udp_src", "udp_sport", "udp_len", "udp_payload"):
        _check(getattr(socks, name), I32, (h, s, 8), f"socks.{name}")
    _check(socks.bytes_recv, I64, (h, s), "socks.bytes_recv")
    _check(bw_dn, I64, (h,), "bw_dn")
    buf = bool(params.has_iface_buf)
    if buf:
        _check(params.iface_buf_pkts, I32, (h,), "params.iface_buf_pkts")
        engine.check_iface_cube(h, p1 // h)
    return _DeliverArgs(
        ib_blk=_addr(ib.blk), ib_stage=_addr(ib.stage),
        ib_status=_addr(ib.status),
        tokens_rx=_addr(hosts.tokens_rx),
        last_refill_rx=_addr(hosts.last_refill_rx),
        rx_queued=_addr(hosts.rx_queued),
        codel_count=_addr(hosts.codel_count),
        codel_dropping=_addr(hosts.codel_dropping),
        codel_first_above=_addr(hosts.codel_first_above),
        codel_drop_next=_addr(hosts.codel_drop_next),
        pkts_dropped_router=_addr(hosts.pkts_dropped_router),
        pkts_recv=_addr(hosts.pkts_recv),
        bytes_recv=_addr(hosts.bytes_recv),
        t_resume=_addr(hosts.t_resume),
        stype=_addr(socks.stype), local_port=_addr(socks.local_port),
        peer_host=_addr(socks.peer_host), peer_port=_addr(socks.peer_port),
        udp_head=_addr(socks.udp_head), udp_count=_addr(socks.udp_count),
        udp_src=_addr(socks.udp_src), udp_sport=_addr(socks.udp_sport),
        udp_len=_addr(socks.udp_len), udp_payload=_addr(socks.udp_payload),
        sock_bytes_recv=_addr(socks.bytes_recv),
        tick_t=_addr(tick_t), active=_addr(active), bw_dn=_addr(bw_dn),
        aux0=_addr(aux0), delivered_n=_addr(delivered_n),
        t_post=_addr(t_post),
        rsqrt_tab=_addr(xlamath.rsqrt_table(bw_dn.device)),
        iface_buf_pkts=_addr(params.iface_buf_pkts) if buf else 0,
        bootstrap_end=params.bootstrap_end, window_end=int(window_end),
        h=h, ki=p1 // h, ic=ic, slots=s,
        rx_batch=max(1, int(getattr(app, "rx_batch", 1))),
        pds_trail=int(bool(params.pds_trail)), has_iface_buf=int(buf))


def deliver_kernel(state, params, app, em, tick_t, active, window_end,
                   bw_dn, aux0):
    """Launch csrc/deliver.cu: _rx_phase with one thread per host --
    deliver_small where the world fits, else deliver_host (deliver_path
    says which) -- or, in TCP worlds, one cooperative grid of one warp per
    host, process_arrivals included, replies into `em`.  Updates the inbox, hosts, socket
    tensors, err and `em` in place; returns (state, em, delivered_n,
    t_post)."""
    from . import _build
    h = state.hosts.num_hosts
    rx_batch = max(1, int(getattr(app, "rx_batch", 1)))
    if rx_batch > 1 and aux0 is None:
        raise ValueError("rx_batch > 1 needs the batch-start bound aux0")
    _check(tick_t, I64, (h,), "tick_t")
    _check(active, torch.bool, (h,), "active")
    if aux0 is not None:
        _check(aux0, I64, (h,), "aux0")
    dev = tick_t.device
    delivered_n = torch.empty((h,), dtype=I32, device=dev)
    t_post = torch.empty((h,), dtype=I64, device=dev)
    a = _deliver_struct(state, params, app, bw_dn, window_end, tick_t,
                        active, aux0, delivered_n, t_post)
    tcp = None
    if engine._uses_tcp(app):
        gates = torch.empty((rx_batch,), dtype=I32, device=dev)
        carry = _carry_scratch(h, dev)
        tcp = _tcp_struct(state, params, em, gates, carry)
    lib = _build.load("deliver")
    _raise_on(lib.deliver_launch(ctypes.byref(a),
                                 None if tcp is None else ctypes.byref(tcp),
                                 _stream()), "deliver")
    LAUNCHES["deliver"] += 1
    return state, em, delivered_n, t_post


def deliver_path(state, params, app) -> str:
    """The body K_DELIVER (and phold's K_WINDOW micro-step) runs on this
    world, as csrc/deliver.cu decides it: "tcp" (deliver_tcp_warps),
    "small" (deliver_small, the world fits) or "general" (deliver_host).
    Builds the library if needed (card only)."""
    from . import _build
    if engine._uses_tcp(app):
        return "tcp"
    a = _deliver_struct(state, params, app,
                        engine._window_ctx(state, params)[1])
    fits = _build.load("deliver").deliver_fits_small(ctypes.byref(a))
    return "small" if fits else "general"


def deliver_call(state, params, app, em, tick_t, active, window_end, bw_dn,
                 aux0):
    if _on_cuda(tick_t):
        return deliver_kernel(state, params, app, em, tick_t, active,
                              window_end, bw_dn, aux0)
    return deliver_plain(state, params, app, em, tick_t, active, window_end,
                         bw_dn, aux0)


# ---------------------------------------------------------------------------
# K_TRANSPORT
# ---------------------------------------------------------------------------


def transport_plain(state, params, app, em, tick_t, t_post, active, bw_up,
                    delivered_n, t_app):
    """Plain version: tcp.transmit (TCP worlds), staging, parked-TX drain
    (the staging refill makes the drain's own refill a no-op), CPU
    accounting, post-step scan and the step counters.  Returns
    (state, th, gmin)."""
    uses_tcp = engine._uses_tcp(app)
    if uses_tcp:
        state, em = tcp.transmit(state, params, em, t_post, active)
    state, _placed = engine._stage_emissions(state, params, em, t_post,
                                             active, app, bw_up)
    state = engine._tx_drain_body(state, params, t_post, active, bw_up,
                                  skip_refill=True)
    state, events = engine._cpu_account(state, params, tick_t, active,
                                        delivered_n, em.valid)
    h = state.hosts.num_hosts
    aux = torch.minimum(state.hosts.t_resume, t_app)
    if uses_tcp:
        aux = torch.minimum(aux, tcp.timer_min(state.socks))
    th = engine._cpu_clamp(state, params, torch.minimum(
        engine._inbox_next(state.inbox, h), aux))
    state = state.replace(n_steps=state.n_steps + 1,
                          n_events=state.n_events + events.sum())
    return state, th, th.amin()


class _TransportArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "em_valid", "em_blk", "pool_blk", "pool_stage", "pool_time",
        "pool_status", "ib_blk", "ib_stage", "ib_status", "send_ctr",
        "tokens_tx",
        "last_refill_tx", "t_resume", "tx_queued", "pkts_sent",
        "bytes_sent", "pkts_dropped_inet", "pkts_dropped_pool", "cpu_avail",
        "host_vertex", "route_blk", "bw_up", "cpu_ns_per_event", "tick_t",
        "t_post", "active", "delivered_n", "t_app", "th", "blk_ev",
        "blk_min", "blk_err", "n_events", "n_steps", "err", "gmin",
        "ticket")] + [
        ("bootstrap_end", ctypes.c_int64),
        ("cpu_threshold", ctypes.c_int64),
        ("cpu_precision", ctypes.c_int64),
        ("drop_k0", ctypes.c_uint32), ("drop_k1", ctypes.c_uint32),
        ("jit_k0", ctypes.c_uint32), ("jit_k1", ctypes.c_uint32),
        ("h", ctypes.c_int32), ("e", ctypes.c_int32),
        ("pc", ctypes.c_int32), ("ko", ctypes.c_int32),
        ("ki", ctypes.c_int32), ("ic", ctypes.c_int32),
        ("n_vertices", ctypes.c_int32), ("n_hv", ctypes.c_int32),
        ("has_loss", ctypes.c_int32), ("pds_trail", ctypes.c_int32),
        ("n_blocks", ctypes.c_int32), ("may_loopback", ctypes.c_int32),
        ("has_jitter", ctypes.c_int32)]


def _transport_struct(state, params, app, em_valid, em_blk, e, bw_up,
                      tick_t=None, t_post=None, active=None,
                      delivered_n=None, t_app=None, th=None, blk_ev=None,
                      blk_min=None, blk_err=None, gmin=None, ticket=None,
                      n_blocks=0) -> _TransportArgs:
    """K_TRANSPORT's arguments, state tensors checked.  The per-host
    inputs and the partial/scalar outputs from `th` on are the per-phase
    kernel's; K_WINDOW leaves them None.  The staging's loopback insert is
    on when the app may send to its own host (engine._may_loopback)."""
    pool, hosts, ib = state.pool, state.hosts, state.inbox
    h = hosts.num_hosts
    p0, pc = pool.blk.shape
    p1, ic = ib.blk.shape
    _check(em_valid, torch.bool, tuple(em_valid.shape), "em.valid")
    _check(em_blk, I32, tuple(em_blk.shape), "em.blk")
    if em_valid.numel() != h * e or em_blk.numel() != h * e * pc:
        raise ValueError("emission staging is not [H, E] x pool width")
    _check(pool.blk, I32, (p0, pc), "pool.blk")
    _check(pool.stage, I32, (p0,), "pool.stage")
    _check(pool.time, I64, (p0,), "pool.time")
    _check(pool.status, I32, (p0,), "pool.status")
    _check(ib.blk, I32, (p1, ic), "inbox.blk")
    _check(ib.stage, I32, (p1,), "inbox.stage")
    _check(ib.status, I32, (p1,), "inbox.status")
    for name in ("send_ctr", "tokens_tx", "last_refill_tx", "t_resume",
                 "pkts_sent", "bytes_sent", "pkts_dropped_inet",
                 "pkts_dropped_pool", "cpu_avail"):
        _check(getattr(hosts, name), I64, (h,), f"hosts.{name}")
    _check(hosts.tx_queued, I32, (h,), "hosts.tx_queued")
    nhv = params.host_vertex.shape[0]
    _check(params.host_vertex, I32, (nhv,), "params.host_vertex")
    _check(params.route_blk, I32, tuple(params.route_blk.shape),
           "params.route_blk")
    _check(bw_up, I64, (h,), "bw_up")
    _check(params.cpu_ns_per_event, I64, (h,), "params.cpu_ns_per_event")
    for name, t, dt in (("n_events", state.n_events, I64),
                        ("n_steps", state.n_steps, I64),
                        ("err", state.err, I32)):
        _check(t, dt, (), name)
    k0, k1 = params.purpose_words[rng.PURPOSE_PACKET_DROP]
    j0, j1 = params.purpose_words[rng.PURPOSE_JITTER]
    return _TransportArgs(
        em_valid=_addr(em_valid), em_blk=_addr(em_blk),
        pool_blk=_addr(pool.blk), pool_stage=_addr(pool.stage),
        pool_time=_addr(pool.time), pool_status=_addr(pool.status),
        ib_blk=_addr(ib.blk), ib_stage=_addr(ib.stage),
        ib_status=_addr(ib.status), send_ctr=_addr(hosts.send_ctr),
        tokens_tx=_addr(hosts.tokens_tx),
        last_refill_tx=_addr(hosts.last_refill_tx),
        t_resume=_addr(hosts.t_resume), tx_queued=_addr(hosts.tx_queued),
        pkts_sent=_addr(hosts.pkts_sent), bytes_sent=_addr(hosts.bytes_sent),
        pkts_dropped_inet=_addr(hosts.pkts_dropped_inet),
        pkts_dropped_pool=_addr(hosts.pkts_dropped_pool),
        cpu_avail=_addr(hosts.cpu_avail),
        host_vertex=_addr(params.host_vertex),
        route_blk=_addr(params.route_blk), bw_up=_addr(bw_up),
        cpu_ns_per_event=_addr(params.cpu_ns_per_event),
        tick_t=_addr(tick_t), t_post=_addr(t_post), active=_addr(active),
        delivered_n=_addr(delivered_n), t_app=_addr(t_app), th=_addr(th),
        blk_ev=_addr(blk_ev), blk_min=_addr(blk_min), blk_err=_addr(blk_err),
        n_events=_addr(state.n_events), n_steps=_addr(state.n_steps),
        err=_addr(state.err), gmin=_addr(gmin), ticket=_addr(ticket),
        bootstrap_end=params.bootstrap_end,
        cpu_threshold=params.cpu_threshold_ns,
        cpu_precision=params.cpu_precision_ns, drop_k0=k0, drop_k1=k1,
        jit_k0=j0, jit_k1=j1,
        h=h, e=e, pc=pc, ko=p0 // h, ki=p1 // h, ic=ic,
        n_vertices=params.n_vertices, n_hv=nhv,
        has_loss=int(bool(params.has_loss)),
        pds_trail=int(bool(params.pds_trail)), n_blocks=n_blocks,
        may_loopback=int(engine._may_loopback(app)),
        has_jitter=int(bool(params.has_jitter)))


def transport_kernel(state, params, app, em, tick_t, t_post, active, bw_up,
                     delivered_n, t_app):
    """Launch csrc/transport.cu: transmit (TCP worlds) + staging + drain
    + CPU accounting + scan with one thread per host (k_transport, one
    launch that also folds the block partials) or, in TCP worlds, one
    warp per host (k_transport_tcp, then k_reduce): the fixed-order
    reduction of the per-block partials into gmin / n_events / n_steps /
    err.  Updates the pool, hosts, socket tensors, state scalars and the
    TX lanes of `em` in place."""
    from . import _build
    h = state.hosts.num_hosts
    pc = state.pool.blk.shape[1]
    e = em.valid.shape[1]
    _check(em.valid, torch.bool, (h, e), "em.valid")
    _check(em.blk, I32, (h, e, pc), "em.blk")
    for name, t in (("tick_t", tick_t), ("t_post", t_post),
                    ("t_app", t_app)):
        _check(t, I64, (h,), name)
    _check(active, torch.bool, (h,), "active")
    _check(delivered_n, I32, (h,), "delivered_n")
    dev = tick_t.device
    uses_tcp = engine._uses_tcp(app)
    nb = _transport_blocks(h, uses_tcp)
    th = torch.empty((h,), dtype=I64, device=dev)
    blk_ev = torch.empty((nb,), dtype=I64, device=dev)
    blk_min = torch.empty((nb,), dtype=I64, device=dev)
    blk_err = torch.empty((nb,), dtype=I32, device=dev)
    gmin = torch.empty((), dtype=I64, device=dev)
    a = _transport_struct(state, params, app, em.valid, em.blk, e, bw_up,
                          tick_t, t_post, active, delivered_n, t_app, th,
                          blk_ev, blk_min, blk_err, gmin, _ticket(dev), nb)
    tcp = _tcp_struct(state, params, em) if uses_tcp else None
    lib = _build.load("transport")
    _raise_on(lib.transport_launch(
        ctypes.byref(a), None if tcp is None else ctypes.byref(tcp),
        _stream()), "transport")
    LAUNCHES["transport"] += 1
    return state, th, gmin


def transport_call(state, params, app, em, tick_t, t_post, active, bw_up,
                   delivered_n, t_app):
    if _on_cuda(tick_t):
        return transport_kernel(state, params, app, em, tick_t, t_post,
                                active, bw_up, delivered_n, t_app)
    return transport_plain(state, params, app, em, tick_t, t_post, active,
                           bw_up, delivered_n, t_app)


# ---------------------------------------------------------------------------
# Fused micro-step: K_DELIVER -> app tick -> K_TRANSPORT
# ---------------------------------------------------------------------------


def microstep_fused(state, params, app, t_h, window_end: int, ctx=None):
    """One micro-step through the kernels.  Returns (state, t_h_next,
    gmin_next): the post-step scan rides out of K_TRANSPORT.  Each phase
    is a profiler range ("microstep.<phase>", see `_phase`)."""
    bw_up, bw_dn = engine._window_ctx(state, params) if ctx is None else ctx
    h = state.hosts.num_hosts
    with _phase("microstep.setup"):
        state, active, tick_t = engine._tick_setup(state, t_h, window_end)
        d_rounds = max(1, int(getattr(app, "rx_batch", 1)))
        # rx_batch bound at batch start (post re-arm, pre any rx mutation);
        # the kernel does not carry app state, so it rides in per host.
        aux0 = (engine._aux_times(state, params, app) if d_rounds > 1
                else None)
        em = emit.empty(h, engine._n_lanes(app), state.pool.blk.shape[1],
                        state.device)
    with _phase("microstep.deliver"):
        state, em, delivered_n, t_post = deliver_call(
            state, params, app, em, tick_t, active, window_end, bw_dn, aux0)
    if engine._uses_tcp(app):
        with _phase("microstep.timers"):
            state, em = tcp.run_timers(state, params, em, t_post, active)
    with _phase("microstep.app_tick"):
        state, em = engine._app_tick(state, params, app, em, t_post, active,
                                     window_end)
        t_app = app.next_time(state)
    with _phase("microstep.transport"):
        return transport_call(state, params, app, em, tick_t, t_post, active,
                              bw_up, delivered_n, t_app)


# ---------------------------------------------------------------------------
# K_WINDOW: a whole window in one cooperative launch
# ---------------------------------------------------------------------------


def window_plain(state, params, app, t_target, max_windows: int = 1):
    """Plain version: windows of engine._window_body_ref, each followed
    by the outbox-pending min -- the first one always, then more while the
    window loop's predicate holds (now < t_target and min(gmin, outbox
    pending) < t_target) and fewer than `max_windows` have run.  Returns
    (state, t_h, win) with win = i64[5], the last window's (gmin, ws, we,
    outbox pending) and the status: STATUS_WINDOW_CAP when it stopped at
    `max_windows` with the predicate true, else 0."""
    if max_windows < 1:
        raise ValueError(f"max_windows must be at least 1, not {max_windows}")
    t_target = int(t_target)
    for _ in range(max_windows):
        state, t_h, gmin, ws, we = engine._window_body_ref(state, params,
                                                           app, t_target)
        pend = engine._outbox_pending(state)
        more = int(we) < t_target and min(int(gmin), int(pend)) < t_target
        if not more:
            break
    status = STATUS_WINDOW_CAP if more else 0
    win = torch.stack([gmin, ws, we, pend, torch.full_like(gmin, status)])
    return state, t_h, win


class _PholdArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "next_send", "pending", "sent", "recv", "rng_ctr")] + [
        ("mean_delay_ns", ctypes.c_int64), ("k0", ctypes.c_uint32),
        ("k1", ctypes.c_uint32), ("sock_slot", ctypes.c_int32),
        ("rx_batch", ctypes.c_int32), ("lanes", ctypes.c_int32),
        ("n_hosts", ctypes.c_int32)]


class _BulkArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "is_client", "dst", "total", "start_t", "phase", "finish_t")] + [
        ("server_port", ctypes.c_int32), ("client_slot", ctypes.c_int32)]


# apps/tgen.py TgenState's tables and registers in TgenArgs order, with
# their dtypes (csrc/tgen_tick.cuh).
_TGEN_FIELDS = (
    ("ntype", I32), ("nxt", I32), ("sendsize", I64), ("recvsize", I64),
    ("count", I64), ("pause_t", I64), ("pause_n", I32), ("peer_host", I32),
    ("peer_port", I32), ("peer_n", I32), ("cur", I32), ("start_t", I64),
    ("stop_t", I64), ("started", torch.bool), ("finished", torch.bool),
    ("iters", I64), ("wait_until", I64), ("t_next", I64),
    ("stream_active", torch.bool), ("conn_ctr", I64), ("cur_send", I64),
    ("cur_recv", I64), ("streams_done", I64), ("streams_failed", I64))


class _TgenArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n, _d in _TGEN_FIELDS] + [
        ("split", ctypes.c_void_p), ("k0", ctypes.c_uint32),
        ("k1", ctypes.c_uint32)] + [(n, ctypes.c_int32) for n in (
            "n_nodes", "pc", "mp", "client_slot", "h")]


class _WindowArgs(ctypes.Structure):
    _fields_ = [("x", _ExchangeArgs), ("d", _DeliverArgs),
                ("t", _TransportArgs), ("p", _PholdArgs),
                ("tcp", _TcpArgs), ("b", _BulkArgs), ("g", _TgenArgs)] + [
        (n, ctypes.c_void_p) for n in (
            "t_h", "part_min", "part_ev", "part_err", "now", "n_windows",
            "win", "em_valid", "em_blk", "acks_thinned", "clk")] + [
        ("t_target", ctypes.c_int64), ("min_latency", ctypes.c_int64),
        ("max_steps", ctypes.c_int64), ("max_windows", ctypes.c_int64),
        ("n_blocks", ctypes.c_int32), ("clk_host", ctypes.c_int32)]


# K_WINDOW's phase trace: while `buf` is set, windows launch the clocked
# build (core/_build.py VARIANTS "window_clk") and add host `host`'s
# cycles per phase into it (csrc/common.cuh Clk).
_PHASE_CLOCKS = {"buf": None, "host": 0}
CLK_WORDS = 32

# K_WINDOW's exchange at the window open: the previous design's passes
# (csrc/exchange.cuh ex_*_v1: atomic buckets, a thread per destination
# sorting its bucket) or ex_run (the radix sort over the grid).  Each
# kernel takes the one measured faster on its main path (PERF.md):
# k_window (phold: ~2 movers a destination, where the per-destination
# sort is short and the radix sort's extra barriers cost more) the
# previous passes, k_window_tcp (the bulk server's fan-in) ex_run.
# chip_smoke.py forces either with set_window_exchange_v1.
_WINDOW_EXCHANGE_V1 = {False: True, True: False}   # by kernel is TCP
_WINDOW_EXCHANGE = {"v1": None}


def set_window_exchange_v1(on: bool | None) -> None:
    """Open K_WINDOW's windows with the previous exchange passes (True),
    with ex_run (False), or with each kernel's default (None)."""
    _WINDOW_EXCHANGE["v1"] = None if on is None else bool(on)


def set_phase_clocks(buf=None, host: int = 0) -> None:
    """Trace host `host`'s phases of K_WINDOW (either kernel) into
    `buf` (int64 [CLK_WORDS] on the card, accumulated across launches);
    None stops tracing."""
    if buf is not None:
        _check(buf, I64, (CLK_WORDS,), "phase clock buffer")
    _PHASE_CLOCKS.update(buf=buf, host=int(host))



def _window_grid(lib, h: int, kernel: int, buf: bool = False,
                 cong_i: int = 0) -> int:
    """Blocks of K_WINDOW's cooperative grid for h hosts and the kernel
    of index `kernel` (_DEVICE_TICKS) in its instantiation for interface
    buffers `buf` and congestion control `cong_i` (cong_index): what the
    card keeps resident (blocks per SM from the occupancy query, times
    SMs; cached per device, library, kernel and instantiation), and no
    more blocks than the hosts fill
    -- one thread per host for k_window (_WIN_BLOCK hosts a block), one
    warp per host for the TCP kernels (_BLOCK // 32).  The kernels walk
    hosts grid-stride, so any h runs.  Raises if the card cannot launch
    the kernel cooperatively."""
    kernel, buf, cong_i = int(kernel), int(bool(buf)), int(cong_i)
    key = (torch.cuda.current_device(), id(lib), kernel, buf, cong_i)
    if key not in _OCCUPANCY:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.window_occupancy(kernel, buf, cong_i, ctypes.byref(per_sm),
                                  ctypes.byref(sms))
        if rc == -1:
            raise RuntimeError("K_WINDOW: the device cannot launch "
                               "cooperative kernels (or the kernel does "
                               "not fit on one SM)")
        _raise_on(rc, "window (occupancy query)")
        _OCCUPANCY[key] = per_sm.value * sms.value
    per_block = _BLOCK // 32 if kernel else _WIN_BLOCK
    return min(-(-h // per_block), _OCCUPANCY[key])


# ---------------------------------------------------------------------------
# The resident tgen kernel (csrc/window.cu k_window_tgen_res): one block
# per host, its sockets, slab keys and emission lanes in shared memory
# ---------------------------------------------------------------------------

# The shared memory one block may opt into on the H100 (227 KB); the
# occupancy query checks the card's own figure
# (cudaDevAttrMaxSharedMemoryPerBlockOptin) with the kernel's static
# shared memory added.
RES_SMEM_OPTIN = 227 * 1024


def _res_span(n: int) -> int:
    return -(-n // 16) * 16


def resident_record_bytes(slots: int, ki: int, e: int, pc: int) -> int:
    """Bytes of one host's record in the resident tgen kernel's shared
    memory (csrc/window.cu res_record_bytes, the same sum): every field of
    the socket table for `slots` sockets in its own dtype (ranges
    included), then the inbox slab's stage words, arrival times and order
    keys for `ki` slots (4, 8 and 8 bytes a slot), then the `e` emission
    lanes' valid flags and rows of `pc` int32 columns; each array rounded
    up to 16 bytes."""
    b = sum(_res_span(slots * (r or 1) * dt.itemsize)
            for _name, dt, r in _TCP_SOCK_FIELDS)
    return b + _res_span(4 * ki) + 2 * _res_span(8 * ki) + _res_span(e) + \
        _res_span(4 * e * pc)


def tgen_record_bytes(state, app) -> int:
    """resident_record_bytes of a world's shapes."""
    h = state.hosts.num_hosts
    return resident_record_bytes(state.socks.slots,
                                 state.inbox.stage.shape[0] // h,
                                 engine._n_lanes(app),
                                 state.pool.blk.shape[1])


# K_WINDOW's design for tgen worlds: None picks by shape
# (window_tgen_resident), True / False force the resident kernel / the
# warp design (chip_smoke.py runs both on the same inputs).
_WINDOW_TGEN_RESIDENT = {"on": None}


def set_window_tgen_resident(on: bool | None) -> None:
    """Run tgen worlds' windows on the resident kernel (True), on the warp
    design, k_window_tgen (False), or by the world's shape (None)."""
    _WINDOW_TGEN_RESIDENT["on"] = None if on is None else bool(on)


_RES_OCCUPANCY: dict = {}


def _res_blocks(lib, record: int, buf: bool, cong_i: int) -> int:
    """Blocks of the resident kernel the card keeps resident with a host
    record of `record` bytes as their dynamic shared memory: blocks per SM
    from the occupancy query (0 when the record and the kernel's static
    shared memory exceed what a block may opt into) times SMs; cached per
    device, library, instantiation and record size.  Raises if the card
    cannot launch the kernel cooperatively."""
    key = (torch.cuda.current_device(), id(lib), int(bool(buf)), int(cong_i),
           int(record))
    if key not in _RES_OCCUPANCY:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        static, optin = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.window_res_occupancy(
            int(bool(buf)), int(cong_i), int(record), ctypes.byref(per_sm),
            ctypes.byref(sms), ctypes.byref(static), ctypes.byref(optin))
        if rc == -1:
            raise RuntimeError("K_WINDOW: the device cannot launch "
                               "cooperative kernels")
        _raise_on(rc, "window (resident occupancy query)")
        _RES_OCCUPANCY[key] = per_sm.value * sms.value
    return _RES_OCCUPANCY[key]


def window_tgen_resident(lib, h: int, record: int, buf: bool = False,
                         cong_i: int = 0) -> bool:
    """Does a tgen world of h hosts whose host record takes `record`
    bytes (resident_record_bytes) run on the resident kernel?  By its
    shape: the record within RES_SMEM_OPTIN, and h blocks resident with
    it (_res_blocks); else the warp design (k_window_tgen), which takes
    any world.  set_window_tgen_resident forces either; forced onto a
    world it does not take, the resident kernel raises.  The choice never
    follows a failed build or launch."""
    on = _WINDOW_TGEN_RESIDENT["on"]
    if on is False:
        return False
    why = None
    if record > RES_SMEM_OPTIN:
        why = (f"a host's record takes {record} bytes of shared memory, "
               f"over the {RES_SMEM_OPTIN} a block may opt into")
    else:
        blocks = _res_blocks(lib, record, buf, cong_i)
        if h > blocks:
            why = (f"{h} hosts, {blocks} blocks resident with a "
                   f"{record}-byte record")
    if why is None:
        return True
    if on:
        raise ValueError(f"the resident tgen kernel does not take this "
                         f"world: {why}")
    return False


def _phold_struct(state, params, app) -> _PholdArgs:
    a_st, hosts = state.app, state.hosts
    h = hosts.num_hosts
    _check(hosts.rng_ctr, I64, (h,), "hosts.rng_ctr")
    for name, dt in (("next_send", I64), ("pending", I32), ("sent", I64),
                     ("recv", I64)):
        _check(getattr(a_st, name), dt, (h,), f"app.{name}")
    k0, k1 = params.purpose_words[rng.PURPOSE_HOST_APP]
    return _PholdArgs(
        next_send=_addr(a_st.next_send), pending=_addr(a_st.pending),
        sent=_addr(a_st.sent), recv=_addr(a_st.recv),
        rng_ctr=_addr(hosts.rng_ctr), mean_delay_ns=app.mean_delay_ns,
        k0=k0, k1=k1, sock_slot=app.sock_slot,
        rx_batch=max(1, int(app.rx_batch)),
        lanes=max(1, int(app.app_tx_lanes)),
        n_hosts=params.global_hosts())


def _bulk_struct(state, app) -> _BulkArgs:
    a_st = state.app
    h = state.hosts.num_hosts
    for name, dt in (("is_client", torch.bool), ("dst", I32),
                     ("total", I64), ("start_t", I64), ("phase", I32),
                     ("finish_t", I64)):
        _check(getattr(a_st, name), dt, (h,), f"app.{name}")
    return _BulkArgs(
        is_client=_addr(a_st.is_client), dst=_addr(a_st.dst),
        total=_addr(a_st.total), start_t=_addr(a_st.start_t),
        phase=_addr(a_st.phase), finish_t=_addr(a_st.finish_t),
        server_port=app.server_port, client_slot=app.client_slot)


def _tgen_struct(state, params, app):
    """Tgen's tick arguments (csrc/tgen_tick.cuh TgenArgs), app state
    checked, and the scratch across its client/server barrier: returns
    (struct, scratch)."""
    a_st = state.app
    h = state.hosts.num_hosts
    n = a_st.ntype.shape[0]
    pcw = a_st.pause_t.shape[1]
    mp = a_st.peer_host.shape[1]
    ptrs = {}
    for name, dt in _TGEN_FIELDS:
        t = getattr(a_st, name)
        shape = (n, pcw) if name == "pause_t" else (n, mp) \
            if name in ("peer_host", "peer_port") else \
            (n,) if name in a_st.TABLES else (h,)
        _check(t, dt, shape, f"app.{name}")
        ptrs[name] = _addr(t)
    split = torch.empty((h, 3), dtype=I64, device=a_st.cur.device)
    k0, k1 = params.purpose_words[rng.PURPOSE_HOST_APP]
    return _TgenArgs(**ptrs, split=_addr(split), k0=k0, k1=k1, n_nodes=n,
                     pc=pcw, mp=mp, client_slot=app.client_slot,
                     h=h), split


# The device ticks K_WINDOW carries, by the apps' `device_tick` name:
# the index of its kernel (csrc/window.cu window_kernel_fn: k_window,
# then the TCP kernels, with a full-width inbox, k_window_tcp and
# k_window_tgen).
_DEVICE_TICKS = {"phold": 0, "bulk": 1, "tgen": 2}


def window_kernel(state, params, app, t_target, max_windows: int = 1):
    """Launch csrc/window.cu: whole windows (exchange, scan, bounds, the
    micro-step loop with the app's tick on the card; in TCP worlds
    run_timers and the TCP machine too) as one cooperative kernel --
    k_window for phold, k_window_tcp for bulk, and for tgen the resident
    kernel (k_window_tgen_res, one block per host, where the world's shape
    fits: window_tgen_resident) or k_window_tgen -- each of which runs
    windows as window_plain does: the first always, then while the window
    loop's predicate holds, at most `max_windows`.  Updates the state's
    tensors in place; returns (state, t_h, win) with win = i64[5] (the
    last window's gmin, ws, we, outbox pending, and the status) on the
    card."""
    from . import _build
    if max_windows < 1:
        raise ValueError(f"max_windows must be at least 1, not {max_windows}")
    tick = getattr(app, "device_tick", None)
    if tick not in _DEVICE_TICKS:
        raise NotImplementedError(
            f"K_WINDOW runs the app tick on the card; "
            f"{type(app).__name__} has no device tick (Phold, Bulk and "
            f"Tgen have one)")
    kernel = _DEVICE_TICKS[tick]
    tcp_on = kernel > 0
    pool, ib, hosts = state.pool, state.inbox, state.hosts
    h = hosts.num_hosts
    p0, pc = pool.blk.shape
    p1, ic = ib.blk.shape
    if (ic >= ICOLS) != tcp_on:
        raise ValueError(f"K_WINDOW runs {type(app).__name__} with a "
                         f"{'full-width' if tcp_on else 'narrow'} inbox; "
                         f"this one has {ic} columns")
    if p0 % h or p1 % h:
        raise ValueError("pool and inbox capacities must be multiples of h")
    _check(ib.status, I32, (p1,), "inbox.status")
    _check(hosts.acks_thinned, I64, (h,), "hosts.acks_thinned")
    for name in ("now", "n_windows"):
        _check(getattr(state, name), I64, (), name)
    clk = _PHASE_CLOCKS["buf"]
    buf = bool(params.has_iface_buf)
    cong_i = cong_index(params) if tcp_on else 0
    if clk is not None and tcp_on and (buf or cong_i):
        raise NotImplementedError(
            "K_WINDOW's phase clocks trace the Reno TCP kernels without "
            "interface buffers only")
    lib = _build.load("window" if clk is None else "window_clk")
    dev = pool.blk.device
    e = engine._n_lanes(app)
    record = resident_record_bytes(state.socks.slots, p1 // h, e, pc) \
        if tick == "tgen" else 0
    resident = tick == "tgen" and window_tgen_resident(lib, h, record, buf,
                                                        cong_i)
    grid = h if resident else _window_grid(lib, h, kernel, buf, cong_i)
    bw_up, bw_dn = engine._window_ctx(state, params)
    v1 = _WINDOW_EXCHANGE["v1"]
    # The resident kernel opens its windows with ex_run.
    x, ex_keep, _ = _ex_struct(pool, ib, h, params, grid,
                               v1=False if resident else
                               _WINDOW_EXCHANGE_V1[tcp_on] if v1 is None
                               else v1)
    t_h = torch.empty((h,), dtype=I64, device=dev)
    part_min = torch.empty((2 * grid,), dtype=I64, device=dev)
    part_ev = torch.empty((2 * grid,), dtype=I64, device=dev)
    part_err = torch.empty((2 * grid,), dtype=I32, device=dev)
    win = torch.empty((5,), dtype=I64, device=dev)
    em = emit.Emissions(
        valid=torch.empty((h, e), dtype=torch.bool, device=dev),
        blk=torch.empty((h, e, pc), dtype=I32, device=dev))
    if tcp_on:
        rx_batch = max(1, int(getattr(app, "rx_batch", 1)))
        gates = torch.empty((2 * rx_batch,), dtype=I32, device=dev)
        carry = None if resident else _carry_scratch(h, dev)
        app_args = dict(tcp=_tcp_struct(state, params, em, gates, carry))
        if tick == "tgen":
            app_args["g"], split = _tgen_struct(state, params, app)
        else:
            app_args["b"] = _bulk_struct(state, app)
    else:
        app_args = dict(p=_phold_struct(state, params, app))
    args = _WindowArgs(
        x=x, d=_deliver_struct(state, params, app, bw_dn),
        t=_transport_struct(state, params, app, em.valid, em.blk, e, bw_up),
        **app_args, t_h=_addr(t_h), part_min=_addr(part_min),
        part_ev=_addr(part_ev), part_err=_addr(part_err),
        now=_addr(state.now), n_windows=_addr(state.n_windows),
        win=_addr(win), em_valid=_addr(em.valid), em_blk=_addr(em.blk),
        acks_thinned=_addr(hosts.acks_thinned), clk=_addr(clk),
        t_target=int(t_target), min_latency=params.min_latency_ns,
        max_steps=MAX_STEPS, max_windows=int(max_windows), n_blocks=grid,
        clk_host=_PHASE_CLOCKS["host"])
    if resident:
        rc = lib.window_res_launch(ctypes.byref(args), record, _stream())
    elif tcp_on:
        rc = lib.window_tcp_launch(ctypes.byref(args), kernel, _stream())
    else:
        rc = lib.window_launch(ctypes.byref(args), _stream())
    del ex_keep
    _raise_on(rc, "window")
    LAUNCHES["window"] += 1
    if tick == "tgen":
        TGEN_LAUNCHES["resident" if resident else "warp"] += 1
    return state, t_h, win


def window_call(state, params, app, t_target, max_windows: int = 1):
    """Windows toward t_target (at most `max_windows`; see
    window_kernel): K_WINDOW on a CUDA tensor, the plain version on the
    CPU.  Returns (state, t_h, win); the caller reads `win` once and
    checks its status."""
    if _on_cuda(state.pool.stage):
        return window_kernel(state, params, app, t_target, max_windows)
    return window_plain(state, params, app, t_target, max_windows)


def check_window_status(status: int, max_windows: int | None = None) -> None:
    """Raises on a status word K_WINDOW sets when it stops at a cap:
    STATUS_STEP_CAP, or STATUS_WINDOW_CAP (`max_windows` is the cap the
    launch was given)."""
    status = int(status)
    if status == STATUS_STEP_CAP:
        raise RuntimeError(
            f"K_WINDOW stopped at its cap of {MAX_STEPS} micro-steps in one "
            f"window (status {status}): the micro-step loop's predicate "
            f"never turned false")
    if status == STATUS_WINDOW_CAP:
        raise RuntimeError(
            f"K_WINDOW stopped at its cap of {max_windows} windows in one "
            f"launch (status {status}): the window loop's predicate did not "
            f"turn false by then")
    if status != 0:
        raise RuntimeError(f"K_WINDOW returned an unknown status {status}")


def window_fused(state, params, app, t_target):
    """One whole window (the JAX window_fused): returns (state, t_h,
    gmin, ws, we), the scalars as 0-d tensors.  A stop at its one-window
    cap is the window asked for."""
    state, t_h, win = window_call(state, params, app, t_target, 1)
    status = int(win[4])
    if status != STATUS_WINDOW_CAP:
        check_window_status(status, 1)
    return state, t_h, win[0], win[1], win[2]


def cbrt_probe(x):
    """The device f32 cbrt of CUBIC's window target (csrc/xla_cbrt.cuh
    cbrt_xla) on a CUDA f32 vector."""
    from . import _build
    _check(x, torch.float32, (x.numel(),), "x")
    y = torch.empty_like(x)
    lib = _build.load("window")
    _raise_on(lib.cbrt_probe_launch(_addr(x), _addr(y), x.numel(),
                                    _stream()), "cbrt probe")
    return y


# cong_probe's kinds (csrc/window.cu k_cong_probe).
CONG_PROBE_KINDS = ("target", "new_ack", "enter_recovery", "timeout")


def cong_probe(kind: str, regs: dict):
    """CUBIC's device window target or hook `kind` (CONG_PROBE_KINDS;
    csrc/tcp.cuh) on CUDA vectors of socket registers `regs` (cwnd,
    ssthresh, cub_epoch, cub_wmax, srtt; tick, acked, flight, mask): the
    target (i32), or the five registers after the hook, where mask is set,
    as a new dict."""
    from . import _build
    n = regs["cwnd"].numel()
    out = {f: regs[f].clone() for f in
           ("cwnd", "ssthresh", "cub_epoch", "cub_wmax", "srtt")}
    for f, dt in (("cwnd", I32), ("ssthresh", I32), ("cub_epoch", I64),
                  ("cub_wmax", I32), ("srtt", I64), ("tick", I64),
                  ("acked", I32), ("flight", I32), ("mask", torch.bool)):
        _check(regs[f], dt, (n,), f)
    target = torch.empty_like(regs["cwnd"])
    lib = _build.load("window")
    _raise_on(lib.cong_probe_launch(
        CONG_PROBE_KINDS.index(kind), *(_addr(out[f]) for f in out),
        *(_addr(regs[f]) for f in ("tick", "acked", "flight", "mask")),
        _addr(target), n, _stream()), "cong probe")
    return target if kind == "target" else out


def log1p_probe(x):
    """The device f64 log1p of K_WINDOW's phold tick (csrc/phold_tick.cuh
    log1p_xla) on a CUDA f64 vector."""
    from . import _build
    _check(x, torch.float64, (x.numel(),), "x")
    y = torch.empty_like(x)
    lib = _build.load("window")
    _raise_on(lib.log1p_probe_launch(_addr(x), _addr(y), x.numel(),
                                     _stream()), "log1p probe")
    return y
