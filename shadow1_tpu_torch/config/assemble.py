"""Simulation assembly: shadow.config.xml + GraphML -> runnable sim
(counterpart of shadow1_tpu/config/assemble.py).

Shadow's master/slave setup for the port: expand <host quantity=N>,
register DNS names and IPs, attach every host to a topology vertex
through the hint ladder, pull per-vertex bandwidths into NetParams,
precompute the APSP routing matrices, and lower <process> elements onto
the modeled tgen.  Every table is built on the CPU and moved to the
device once; the result equals the JAX package's `build` leaf for leaf.

Refused by name, each with the ROADMAP item that will carry it:
real-process plugins (queue 1 item 10, the substrate), a <netem>
section (item 5), bucket padding (item 4), and the per-host
instrumentation attributes logpcap and loglevel (item 8).  Both
congestion controls (Reno, CUBIC) and <host interfacebuffer> are
carried.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import resolve_device
from ..apps import tgen as tgen_app
from ..core import simtime
from ..core.params import QDISC_FIFO, QDISC_RR, NetParams, make_net_params
from ..core.state import MTU, make_sim_state
from ..routing import apsp, graphml
from ..routing.dns import DNS
from ..transport import cong as _cong
from ..transport import tcp

SEC = simtime.SIMTIME_ONE_SECOND

# Shadow's bandwidth attributes are KiB/s.
_KIB = 1024
# Fallback when neither the host element nor its vertex specifies one.
_DEFAULT_BW_KIBPS = 102400  # 100 MiB/s
# Virtual CPU model base: a host configured with cpufrequency F KHz pays
# 1us * (3e6 / F) per event.
_BASE_CPU_KHZ = 3_000_000
_BASE_EVENT_NS = 1_000
# Topologies up to this many vertices run the Floyd-Warshall on the CPU,
# larger ones on the run's device (the JAX package's split).
_APSP_ON_CPU_MAX_V = 1024
# Host log levels that switch on the JAX package's event log.
_LOGGING_LEVELS = ("error", "critical", "warning", "message", "info",
                   "debug", "trace")


@dataclasses.dataclass
class Assembled:
    """Everything the CLI needs to run and report."""

    state: object            # SimState
    params: NetParams
    app: object
    hostnames: list          # [H]
    dns: DNS
    topology: graphml.Topology
    config: object           # ShadowConfig
    stop_time: int           # ns
    heartbeat_freq_s: object = None  # [H] i64, 0 = default


def _expand_hosts(cfg):
    """<host quantity=N> -> N hosts named id, or id1..idN when N > 1."""
    names, specs = [], []
    for hs in cfg.hosts:
        q = max(1, hs.quantity)
        for i in range(q):
            names.append(hs.id if q == 1 else f"{hs.id}{i + 1}")
            specs.append(hs)
    return names, specs


def _plugin_path(cfg, plugin_id: str) -> str | None:
    spec = cfg.plugins.get(plugin_id)
    if not (spec and spec.path):
        return None
    path = os.path.expanduser(spec.path)
    if not os.path.isabs(path):
        path = os.path.join(cfg.base_dir, path)
    return path


def _plugin_kind(cfg, plugin_id: str) -> str:
    """"tgen" (modeled) or "real" (an executable program), by the JAX
    package's rule: a shared object or a plugin that is not an existing
    executable maps to its modeled equivalent when it names tgen."""
    path = _plugin_path(cfg, plugin_id)
    spec = cfg.plugins.get(plugin_id)
    hay = f"{plugin_id} {spec.path if spec else ''}".lower()
    is_shared_obj = bool(path) and (
        path.endswith(".so") or ".so." in os.path.basename(path))
    if is_shared_obj or not (
            path and os.path.isfile(path) and os.access(path, os.X_OK)):
        if "tgen" in hay:
            return "tgen"
        if is_shared_obj:
            raise ValueError(
                f"plugin {plugin_id!r} is a shared object ({path}); "
                f"fork/exec cannot run it and no modeled equivalent is "
                f"known -- point the plugin at an executable program")
        raise ValueError(
            f"plugin {plugin_id!r} is neither an existing executable "
            f"(real-process plugin) nor a known modeled equivalent (tgen)")
    return "real"


def _refuse_unported(cfg, specs, bucket: bool) -> None:
    if bucket:
        raise NotImplementedError(
            "bucket padding is not ported yet (ROADMAP queue 1 item 4)")
    if cfg.netem is not None:
        raise NotImplementedError(
            "a <netem> section is not ported yet (ROADMAP queue 1 item 5)")
    for s in specs:
        if s.logpcap:
            raise NotImplementedError(
                f"<host id={s.id!r} logpcap> (packet capture) is not "
                f"ported yet (ROADMAP queue 1 item 8)")
        if (s.loglevel or "").lower() in _LOGGING_LEVELS:
            raise NotImplementedError(
                f"<host id={s.id!r} loglevel> (the event log) is not "
                f"ported yet (ROADMAP queue 1 item 8)")
        for p in s.processes:
            if _plugin_kind(cfg, p.plugin) == "real":
                raise NotImplementedError(
                    f"plugin {p.plugin!r} of host {s.id!r} is a real "
                    f"program; real processes (the substrate) are not "
                    f"ported yet (ROADMAP queue 1 item 10)")


def build(cfg, seed: int = 1, sock_slots: int | None = None,
          pool_slab: int = 128, qdisc: str = "fifo",
          cpu_threshold_us: int = -1, cpu_precision_us: int = 200,
          cong: str = "reno", bucket: bool = False,
          persistent: bool = True, device=None) -> Assembled:
    """Assemble a parsed ShadowConfig into (state, params, app) on
    `device` (None = the CUDA card); the same arguments as the JAX
    `build`, plus the port's `persistent` / `device`."""
    dev = resolve_device(device)
    names, specs = _expand_hosts(cfg)
    h = len(names)
    if h == 0:
        raise ValueError("config defines no hosts")
    _refuse_unported(cfg, specs, bucket)

    # --- topology + attachment -------------------------------------------
    topo = graphml.load(cfg.topology_source())
    dns = DNS()
    for i, name in enumerate(names):
        dns.register(i, name, requested_ip=specs[i].iphint)
    host_vertex = graphml.attach_all(topo, [s.hints() for s in specs], seed)

    # --- bandwidths (host override, else vertex, else default) -----------
    bw_up = np.empty(h, np.int64)
    bw_dn = np.empty(h, np.int64)
    cpu_ns = np.zeros(h, np.int64)
    snd_buf = np.zeros(h, np.int64)      # 0 = default + autotune
    rcv_buf = np.zeros(h, np.int64)
    iface_pkts = np.zeros(h, np.int32)   # 0 = unbounded
    hb_freq = np.zeros(h, np.int64)      # 0 = tracker default
    for i, s in enumerate(specs):
        v = host_vertex[i]
        up = s.bandwidthup_KiBps or int(topo.bw_up_KiBps[v]) or \
            _DEFAULT_BW_KIBPS
        dn = s.bandwidthdown_KiBps or int(topo.bw_down_KiBps[v]) or \
            _DEFAULT_BW_KIBPS
        bw_up[i], bw_dn[i] = up * _KIB, dn * _KIB
        if s.cpufrequency:
            cpu_ns[i] = max(1, (_BASE_EVENT_NS * _BASE_CPU_KHZ)
                            // max(1, s.cpufrequency))
        if s.socketsendbuffer:
            snd_buf[i] = s.socketsendbuffer
        if s.socketrecvbuffer:
            rcv_buf[i] = s.socketrecvbuffer
        if s.interfacebuffer:
            # Bytes in the config; the router backlog counts packets, so
            # round up in MTUs.
            iface_pkts[i] = max(1, -(-s.interfacebuffer // MTU))
        if s.heartbeatfrequency_s:
            hb_freq[i] = s.heartbeatfrequency_s

    # --- routing matrices -------------------------------------------------
    lat_ns, rel, jit_ns = apsp.build_matrices(
        topo.lat_ms, topo.edge_rel, self_lat_ms=topo.self_lat_ms,
        self_rel=topo.self_rel, edge_jitter_ms=topo.jitter_ms,
        self_jitter_ms=topo.self_jitter_ms,
        device=None if topo.num_vertices <= _APSP_ON_CPU_MAX_V else dev)
    params = make_net_params(
        latency_ns=lat_ns, reliability=rel, host_vertex=host_vertex,
        bw_up_Bps=bw_up, bw_down_Bps=bw_dn, seed=seed,
        stop_time=cfg.stoptime_s * SEC,
        bootstrap_end=cfg.bootstrap_end_s * SEC,
        jitter_ns=jit_ns, cpu_ns_per_event=cpu_ns,
        cpu_threshold_ns=(cpu_threshold_us * 1000
                          if cpu_threshold_us >= 0 else -1),
        cpu_precision_ns=max(1, cpu_precision_us) * 1000,
        qdisc={"fifo": QDISC_FIFO, "rr": QDISC_RR}[qdisc],
        autotune_snd=snd_buf == 0, autotune_rcv=rcv_buf == 0,
        iface_buf_pkts=iface_pkts, cong=_cong.validate(cong),
        persistent=persistent, device=dev)

    # --- connectivity: every pair of vertices hosts attach to must be
    # routable (the diagonal is exempt: loopback never reads the matrix).
    used = np.unique(np.asarray(host_vertex))
    routable = apsp.is_routable(lat_ns.cpu()).numpy()[used][:, used]
    np.fill_diagonal(routable, True)
    if not routable.all():
        pairs = sorted({(min(i, j), max(i, j))
                        for i, j in np.argwhere(~routable)})
        vi, vj = used[pairs[0][0]], used[pairs[0][1]]
        raise ValueError(
            f"topology is not connected: no route between attached "
            f"vertices {topo.names[vi]!r} and {topo.names[vj]!r} "
            f"({len(pairs)} unroutable attached-vertex pairs); every "
            f"pair of vertices that hosts attach to must be connected")

    # --- processes -> the modeled tgen ------------------------------------
    graph_of_args: dict = {}
    graphs: list = []
    host_graph = np.full(h, -1, np.int64)
    start_t = np.zeros(h, np.int64)
    stop_t = np.full(h, simtime.SIMTIME_INVALID, np.int64)
    for i, s in enumerate(specs):
        for p in s.processes:
            if host_graph[i] >= 0:
                raise ValueError(f"host {names[i]!r}: multiple MODELED "
                                 f"processes per host not yet supported "
                                 f"(real-process plugins compose freely)")
            arg = (p.arguments.strip().split()[0]
                   if p.arguments.strip() else "")
            path = arg if os.path.isabs(arg) \
                else os.path.join(cfg.base_dir, arg)
            if path not in graph_of_args:
                graph_of_args[path] = len(graphs)
                graphs.append(tgen_app.parse_tgen(path))
            host_graph[i] = graph_of_args[path]
            start_t[i] = p.starttime_s * SEC
            if p.stoptime_s:
                stop_t[i] = p.stoptime_s * SEC

    # --- sizing: a server's fan-in bounds its socket slots, and its slab
    # holds one stream's worth of segments per client.
    def resolve_peer(spec: str):
        name, _, port = spec.rpartition(":")
        return dns.resolve_name(name).host_index, int(port)

    fan_in = np.zeros(h, np.int64)
    for i in range(h):
        g = host_graph[i]
        if g < 0:
            continue
        for node_peers in graphs[int(g)].peers:
            for ps in node_peers:
                fan_in[resolve_peer(ps)[0]] += 1
    if sock_slots is None:
        sock_slots = int(max(4, min(512, 2 * fan_in.max() + 4)))
    slab = int(max(pool_slab, min(4096, 32 * (1 + fan_in.max()))))

    state = make_sim_state(h, sock_slots=sock_slots, pool_capacity=h * slab,
                           uses_tcp=True, device="cpu")
    socks = state.socks
    # Per-host socket-buffer defaults (<host socketsendbuffer /
    # socketrecvbuffer>); every socket the host creates starts from these.
    if (snd_buf > 0).any():
        socks = socks.replace(def_snd_buf=torch.where(
            torch.from_numpy(snd_buf > 0),
            torch.from_numpy(snd_buf).to(torch.int32), socks.def_snd_buf))
    if (rcv_buf > 0).any():
        socks = socks.replace(def_rcv_buf=torch.where(
            torch.from_numpy(rcv_buf > 0),
            torch.from_numpy(rcv_buf).to(torch.int32), socks.def_rcv_buf))
    for gi, g in enumerate(graphs):
        if g.serverport > 0:
            socks = tcp.listen_v(socks, torch.from_numpy(host_graph == gi), 0,
                                 g.serverport,
                                 backlog=int(fan_in.max()) + 1)
    state = state.replace(socks=socks, app=tgen_app.build_state(
        h, graphs, host_graph, start_t, stop_t, resolve_peer=resolve_peer,
        device="cpu"))
    state = _to_device(state, dev)

    return Assembled(state=state, params=params, app=tgen_app.Tgen(),
                     hostnames=names, dns=dns, topology=topo, config=cfg,
                     stop_time=cfg.stoptime_s * SEC,
                     heartbeat_freq_s=hb_freq)


def _to_device(obj, dev):
    """The state tree with every tensor moved to `dev` (one copy each)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return obj.replace(**{f.name: _to_device(getattr(obj, f.name), dev)
                              for f in dataclasses.fields(obj)})
    return obj


def load(path: str, **kw) -> Assembled:
    from . import shadowxml
    return build(shadowxml.parse(path), **kw)
