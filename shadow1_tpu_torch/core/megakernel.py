"""The slice's three hand-written kernels, their launch wrappers, and
their plain torch versions (counterpart of shadow1_tpu/core/megakernel.py).

Each TPU kernel of the JAX package's per-phase path has a CUDA kernel
here, written for sm_90a in `csrc/` and built by core/_build.py:

* exchange  (csrc/exchange.cu)  <- megakernel.exchange_call,
  shadow1_tpu/core/megakernel.py:231-289, body engine._exchange_core;
* deliver   (csrc/deliver.cu)   <- microstep_fused's K_DELIVER,
  megakernel.py:502-545, body engine._rx_phase;
* transport (csrc/transport.cu) <- microstep_fused's K_TRANSPORT,
  megakernel.py:562-658, body _stage_emissions + _tx_drain_body + CPU
  accounting + the post-step scan.

Dispatch rule, the same for all three wrappers: a CUDA tensor launches
the kernel (or raises); a CPU tensor runs the plain version, which is
built from the reference functions of core/engine.py.  There is no third
path and no fallback.  The kernels update the state's tensors in place
(run_until clones its input once); the plain versions return new
tensors.  Each wrapper counts its launches in `LAUNCHES`.

phold's tick runs between K_DELIVER and K_TRANSPORT as plain torch on the
state's device, as it runs between the Pallas kernels in the JAX graph.
K_WINDOW (megakernel.window_fused, the persistent whole-window region)
is the next slice of the port.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import emit, engine, rng, xlamath
from .state import I32, I64, ICOLS

INV = engine.INV

# Launches of each kernel since the last reset (plain versions do not
# count).  chip_smoke.py zeroes these around the main-path run.
LAUNCHES = {"exchange": 0, "deliver": 0, "transport": 0}

_BLOCK = 256     # threads per block of the per-host kernels


def _phase(name: str):
    """A profiler range named `name` while a torch profiler records, else
    nothing: an idle `record_function` still calls into the profiler on
    every entry, once per phase of every micro-step."""
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", True):
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def enabled(state, params, app) -> bool:
    """Does this world take the kernel path?  (No instrumentation block
    exists in the port yet, so only the static flag decides.)"""
    return bool(getattr(params, "megakernel", False))


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None \
        else ctypes.c_void_p(0)


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


def _n_blocks(h: int) -> int:
    return -(-h // _BLOCK)


# ---------------------------------------------------------------------------
# exchange
# ---------------------------------------------------------------------------


def exchange_plain(pool, ib, h, params):
    """Plain version: engine._exchange_core."""
    return engine._exchange_core(pool, ib, h, params)


def exchange_kernel(pool, ib, h, params):
    """Launch csrc/exchange.cu.  Updates pool.stage and the inbox in
    place; returns (pool, ib, total, total_prot, n_free)."""
    from . import _build
    p0, pc = pool.blk.shape
    p1, ic = ib.blk.shape
    if ic >= ICOLS:
        raise NotImplementedError("the exchange kernel takes the narrow "
                                  "(UDP) inbox only")
    if p0 % h or p1 % h:
        raise ValueError("pool and inbox capacities must be multiples of h")
    _check(pool.blk, I32, (p0, pc), "pool.blk")
    _check(pool.time, I64, (p0,), "pool.time")
    _check(pool.stage, I32, (p0,), "pool.stage")
    _check(pool.status, I32, (p0,), "pool.status")
    _check(ib.blk, I32, (p1, ic), "inbox.blk")
    _check(ib.stage, I32, (p1,), "inbox.stage")
    _check(ib.status, I32, (p1,), "inbox.status")
    dev = pool.blk.device
    cnt = torch.empty((3 * h + 1,), dtype=I32, device=dev)
    lst = torch.empty((p0,), dtype=I32, device=dev)
    total = torch.empty((h,), dtype=I32, device=dev)
    n_free = torch.empty((h,), dtype=I32, device=dev)
    lib = _build.load("exchange")
    rc = lib.exchange_launch(
        _ptr(pool.blk), pc, ctypes.c_int64(p0), _ptr(pool.time),
        _ptr(pool.stage), _ptr(pool.status), _ptr(ib.blk), ic,
        _ptr(ib.stage), _ptr(ib.status), ctypes.c_int64(p1), h,
        int(bool(params.pds_trail)), _ptr(cnt), _ptr(lst), _ptr(total),
        _ptr(n_free), _stream())
    _raise_on(rc, "exchange")
    LAUNCHES["exchange"] += 1
    return pool, ib, total, total, n_free


def exchange_call(pool, ib, h, params):
    """The exchange: kernel on a CUDA tensor, plain version on the CPU."""
    if _on_cuda(pool.stage):
        return exchange_kernel(pool, ib, h, params)
    return exchange_plain(pool, ib, h, params)


# ---------------------------------------------------------------------------
# K_DELIVER
# ---------------------------------------------------------------------------


def deliver_plain(state, params, app, tick_t, active, window_end, bw_dn,
                  aux0):
    """Plain version: engine._rx_phase.  Returns
    (state, delivered_n, t_post)."""
    return engine._rx_phase(state, params, tick_t, active, app, window_end,
                            bw_dn, aux_bound=aux0)


class _DeliverArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "ib_blk", "ib_stage", "ib_status",
        "tokens_rx", "last_refill_rx", "rx_queued", "codel_count",
        "codel_dropping", "codel_first_above", "codel_drop_next",
        "pkts_dropped_router", "pkts_recv", "bytes_recv", "t_resume",
        "stype", "local_port", "peer_host", "peer_port", "udp_head",
        "udp_count", "udp_src", "udp_sport", "udp_len", "udp_payload",
        "sock_bytes_recv", "tick_t", "active", "bw_dn", "aux0",
        "delivered_n", "t_post", "rsqrt_tab")] + [
        ("bootstrap_end", ctypes.c_int64), ("window_end", ctypes.c_int64),
        ("h", ctypes.c_int32), ("ki", ctypes.c_int32),
        ("ic", ctypes.c_int32), ("slots", ctypes.c_int32),
        ("rx_batch", ctypes.c_int32), ("pds_trail", ctypes.c_int32)]


def deliver_kernel(state, params, app, tick_t, active, window_end, bw_dn,
                   aux0):
    """Launch csrc/deliver.cu: _rx_phase with one thread per host.
    Updates the inbox, hosts and socket tensors in place."""
    from . import _build
    ib, hosts, socks = state.inbox, state.hosts, state.socks
    h = hosts.num_hosts
    p1, ic = ib.blk.shape
    ki = p1 // h
    s = socks.slots
    rx_batch = max(1, int(getattr(app, "rx_batch", 1)))
    if rx_batch > 1 and aux0 is None:
        raise ValueError("rx_batch > 1 needs the batch-start bound aux0")
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
    _check(tick_t, I64, (h,), "tick_t")
    _check(active, torch.bool, (h,), "active")
    _check(bw_dn, I64, (h,), "bw_dn")
    if aux0 is not None:
        _check(aux0, I64, (h,), "aux0")
    dev = tick_t.device
    rsqrt_tab = xlamath.rsqrt_table(dev)
    delivered_n = torch.empty((h,), dtype=I32, device=dev)
    t_post = torch.empty((h,), dtype=I64, device=dev)
    a = _DeliverArgs(
        ib_blk=ib.blk.data_ptr(), ib_stage=ib.stage.data_ptr(),
        ib_status=ib.status.data_ptr(),
        tokens_rx=hosts.tokens_rx.data_ptr(),
        last_refill_rx=hosts.last_refill_rx.data_ptr(),
        rx_queued=hosts.rx_queued.data_ptr(),
        codel_count=hosts.codel_count.data_ptr(),
        codel_dropping=hosts.codel_dropping.data_ptr(),
        codel_first_above=hosts.codel_first_above.data_ptr(),
        codel_drop_next=hosts.codel_drop_next.data_ptr(),
        pkts_dropped_router=hosts.pkts_dropped_router.data_ptr(),
        pkts_recv=hosts.pkts_recv.data_ptr(),
        bytes_recv=hosts.bytes_recv.data_ptr(),
        t_resume=hosts.t_resume.data_ptr(),
        stype=socks.stype.data_ptr(), local_port=socks.local_port.data_ptr(),
        peer_host=socks.peer_host.data_ptr(),
        peer_port=socks.peer_port.data_ptr(),
        udp_head=socks.udp_head.data_ptr(),
        udp_count=socks.udp_count.data_ptr(),
        udp_src=socks.udp_src.data_ptr(), udp_sport=socks.udp_sport.data_ptr(),
        udp_len=socks.udp_len.data_ptr(),
        udp_payload=socks.udp_payload.data_ptr(),
        sock_bytes_recv=socks.bytes_recv.data_ptr(),
        tick_t=tick_t.data_ptr(), active=active.data_ptr(),
        bw_dn=bw_dn.data_ptr(),
        aux0=aux0.data_ptr() if aux0 is not None else 0,
        delivered_n=delivered_n.data_ptr(), t_post=t_post.data_ptr(),
        rsqrt_tab=rsqrt_tab.data_ptr(),
        bootstrap_end=params.bootstrap_end, window_end=int(window_end),
        h=h, ki=ki, ic=ic, slots=s, rx_batch=rx_batch,
        pds_trail=int(bool(params.pds_trail)))
    lib = _build.load("deliver")
    _raise_on(lib.deliver_launch(ctypes.byref(a), _stream()), "deliver")
    LAUNCHES["deliver"] += 1
    return state, delivered_n, t_post


def deliver_call(state, params, app, tick_t, active, window_end, bw_dn,
                 aux0):
    if _on_cuda(tick_t):
        return deliver_kernel(state, params, app, tick_t, active,
                              window_end, bw_dn, aux0)
    return deliver_plain(state, params, app, tick_t, active, window_end,
                         bw_dn, aux0)


# ---------------------------------------------------------------------------
# K_TRANSPORT
# ---------------------------------------------------------------------------


def transport_plain(state, params, em, tick_t, t_post, active, bw_up,
                    delivered_n, t_app):
    """Plain version: staging, parked-TX drain (the staging refill makes
    the drain's own refill a no-op), CPU accounting, post-step scan and
    the step counters.  Returns (state, th, gmin)."""
    state, _placed = engine._stage_emissions(state, params, em, t_post,
                                             active, bw_up)
    state = engine._tx_drain_body(state, params, t_post, active, bw_up,
                                  skip_refill=True)
    state, events = engine._cpu_account(state, params, tick_t, active,
                                        delivered_n, em.valid)
    h = state.hosts.num_hosts
    aux = torch.minimum(state.hosts.t_resume, t_app)
    th = engine._cpu_clamp(state, params, torch.minimum(
        engine._inbox_next(state.inbox, h), aux))
    state = state.replace(n_steps=state.n_steps + 1,
                          n_events=state.n_events + events.sum())
    return state, th, th.amin()


class _TransportArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "em_valid", "em_blk", "pool_blk", "pool_stage", "pool_time",
        "pool_status", "ib_blk", "ib_stage", "send_ctr", "tokens_tx",
        "last_refill_tx", "t_resume", "tx_queued", "pkts_sent",
        "bytes_sent", "pkts_dropped_inet", "pkts_dropped_pool", "cpu_avail",
        "host_vertex", "route_blk", "bw_up", "cpu_ns_per_event", "tick_t",
        "t_post", "active", "delivered_n", "t_app", "th", "blk_ev",
        "blk_min", "blk_err", "n_events", "n_steps", "err", "gmin")] + [
        ("bootstrap_end", ctypes.c_int64),
        ("cpu_threshold", ctypes.c_int64),
        ("cpu_precision", ctypes.c_int64),
        ("drop_k0", ctypes.c_uint32), ("drop_k1", ctypes.c_uint32),
        ("h", ctypes.c_int32), ("e", ctypes.c_int32),
        ("pc", ctypes.c_int32), ("ko", ctypes.c_int32),
        ("ki", ctypes.c_int32), ("ic", ctypes.c_int32),
        ("n_vertices", ctypes.c_int32), ("n_hv", ctypes.c_int32),
        ("has_loss", ctypes.c_int32), ("pds_trail", ctypes.c_int32),
        ("n_blocks", ctypes.c_int32)]


def transport_kernel(state, params, em, tick_t, t_post, active, bw_up,
                     delivered_n, t_app):
    """Launch csrc/transport.cu: staging + drain + CPU accounting + scan
    with one thread per host, then the fixed-order reduction of the
    per-block partials into gmin / n_events / n_steps / err.  Updates
    the pool, hosts and state scalars in place."""
    from . import _build
    pool, hosts, ib = state.pool, state.hosts, state.inbox
    h = hosts.num_hosts
    p0, pc = pool.blk.shape
    p1, ic = ib.blk.shape
    e = em.valid.shape[1]
    _check(em.valid, torch.bool, (h, e), "em.valid")
    _check(em.blk, I32, (h, e, pc), "em.blk")
    _check(pool.blk, I32, (p0, pc), "pool.blk")
    _check(pool.stage, I32, (p0,), "pool.stage")
    _check(pool.time, I64, (p0,), "pool.time")
    _check(pool.status, I32, (p0,), "pool.status")
    _check(ib.blk, I32, (p1, ic), "inbox.blk")
    _check(ib.stage, I32, (p1,), "inbox.stage")
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
    for name, t in (("tick_t", tick_t), ("t_post", t_post),
                    ("t_app", t_app)):
        _check(t, I64, (h,), name)
    _check(active, torch.bool, (h,), "active")
    _check(delivered_n, I32, (h,), "delivered_n")
    for name, t, dt in (("n_events", state.n_events, I64),
                        ("n_steps", state.n_steps, I64),
                        ("err", state.err, I32)):
        _check(t, dt, (), name)
    dev = tick_t.device
    nb = _n_blocks(h)
    th = torch.empty((h,), dtype=I64, device=dev)
    blk_ev = torch.empty((nb,), dtype=I64, device=dev)
    blk_min = torch.empty((nb,), dtype=I64, device=dev)
    blk_err = torch.empty((nb,), dtype=I32, device=dev)
    gmin = torch.empty((), dtype=I64, device=dev)
    k0, k1 = params.purpose_words[rng.PURPOSE_PACKET_DROP]
    a = _TransportArgs(
        em_valid=em.valid.data_ptr(), em_blk=em.blk.data_ptr(),
        pool_blk=pool.blk.data_ptr(), pool_stage=pool.stage.data_ptr(),
        pool_time=pool.time.data_ptr(), pool_status=pool.status.data_ptr(),
        ib_blk=ib.blk.data_ptr(), ib_stage=ib.stage.data_ptr(),
        send_ctr=hosts.send_ctr.data_ptr(),
        tokens_tx=hosts.tokens_tx.data_ptr(),
        last_refill_tx=hosts.last_refill_tx.data_ptr(),
        t_resume=hosts.t_resume.data_ptr(),
        tx_queued=hosts.tx_queued.data_ptr(),
        pkts_sent=hosts.pkts_sent.data_ptr(),
        bytes_sent=hosts.bytes_sent.data_ptr(),
        pkts_dropped_inet=hosts.pkts_dropped_inet.data_ptr(),
        pkts_dropped_pool=hosts.pkts_dropped_pool.data_ptr(),
        cpu_avail=hosts.cpu_avail.data_ptr(),
        host_vertex=params.host_vertex.data_ptr(),
        route_blk=params.route_blk.data_ptr(), bw_up=bw_up.data_ptr(),
        cpu_ns_per_event=params.cpu_ns_per_event.data_ptr(),
        tick_t=tick_t.data_ptr(), t_post=t_post.data_ptr(),
        active=active.data_ptr(), delivered_n=delivered_n.data_ptr(),
        t_app=t_app.data_ptr(), th=th.data_ptr(), blk_ev=blk_ev.data_ptr(),
        blk_min=blk_min.data_ptr(), blk_err=blk_err.data_ptr(),
        n_events=state.n_events.data_ptr(), n_steps=state.n_steps.data_ptr(),
        err=state.err.data_ptr(), gmin=gmin.data_ptr(),
        bootstrap_end=params.bootstrap_end,
        cpu_threshold=params.cpu_threshold_ns,
        cpu_precision=params.cpu_precision_ns, drop_k0=k0, drop_k1=k1,
        h=h, e=e, pc=pc, ko=p0 // h, ki=p1 // h, ic=ic,
        n_vertices=params.n_vertices, n_hv=nhv,
        has_loss=int(bool(params.has_loss)),
        pds_trail=int(bool(params.pds_trail)), n_blocks=nb)
    lib = _build.load("transport")
    _raise_on(lib.transport_launch(ctypes.byref(a), _stream()), "transport")
    LAUNCHES["transport"] += 1
    return state, th, gmin


def transport_call(state, params, em, tick_t, t_post, active, bw_up,
                   delivered_n, t_app):
    if _on_cuda(tick_t):
        return transport_kernel(state, params, em, tick_t, t_post, active,
                                bw_up, delivered_n, t_app)
    return transport_plain(state, params, em, tick_t, t_post, active, bw_up,
                           delivered_n, t_app)


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
    with _phase("microstep.deliver"):
        state, delivered_n, t_post = deliver_call(
            state, params, app, tick_t, active, window_end, bw_dn, aux0)
    with _phase("microstep.app_tick"):
        em = emit.empty(h, engine._n_lanes(app), state.pool.blk.shape[1],
                        state.device)
        state, em = engine._app_tick(state, params, app, em, t_post, active,
                                     window_end)
        t_app = app.next_time(state)
    with _phase("microstep.transport"):
        return transport_call(state, params, em, tick_t, t_post, active,
                              bw_up, delivered_n, t_app)
