"""High-level simulation assembly (counterpart of shadow1_tpu/sim.py):
build params + state + app, then run."""

from __future__ import annotations

import torch

from . import resolve_device
from .apps import bulk as bulk_app
from .apps import phold as phold_app
from .apps import tgen as tgen_app
from .core import engine, simtime
from .core.params import make_net_params
from .core.state import make_sim_state
from .routing.synthetic import uniform_full_mesh
from .transport import tcp, udp


def build_phold(num_hosts: int,
                latency_ns: int = 10 * simtime.SIMTIME_ONE_MILLISECOND,
                reliability: float = 1.0,
                msgs_per_host: int = 1,
                mean_delay_ns: int = 10 * simtime.SIMTIME_ONE_MILLISECOND,
                stop_time: int = simtime.SIMTIME_ONE_SECOND,
                seed: int = 1,
                sock_slots: int = 4,
                pool_capacity: int = 1 << 14,
                bw_up_Bps: int = 1 << 30,
                bw_down_Bps: int = 1 << 30,
                bootstrap_end: int = 0,
                rx_batch: int = 1,
                megakernel: bool = True,
                persistent: bool = True,
                device=None):
    """A phold world on a uniform full mesh (at most 256 vertices, hosts
    striped across them); same arguments and result as the JAX
    build_phold, on `device` (None = the CUDA card)."""
    if num_hosts < 2:
        raise ValueError("phold needs at least 2 hosts (every message is "
                         "forwarded to a different host)")
    dev = resolve_device(device)
    v = min(num_hosts, 256)
    lat, rel = uniform_full_mesh(v, latency_ns, reliability)
    params = make_net_params(
        latency_ns=lat, reliability=rel,
        host_vertex=torch.arange(num_hosts) % v,
        bw_up_Bps=torch.full((num_hosts,), bw_up_Bps),
        bw_down_Bps=torch.full((num_hosts,), bw_down_Bps),
        seed=seed, stop_time=stop_time, bootstrap_end=bootstrap_end,
        megakernel=megakernel, persistent=persistent, device=dev)
    state = make_sim_state(num_hosts, sock_slots=sock_slots,
                           pool_capacity=pool_capacity, uses_tcp=False,
                           device=dev)
    state = state.replace(
        socks=udp.open_bind_all(state.socks, slot=0,
                                port=phold_app.PHOLD_PORT),
        # rng_ctr starts at 1: counter 0 keys the initial send times.
        hosts=state.hosts.replace(rng_ctr=state.hosts.rng_ctr + 1),
        app=phold_app.init_state(num_hosts, params, msgs_per_host,
                                 mean_delay_ns))
    app = phold_app.Phold(mean_delay_ns=mean_delay_ns, sock_slot=0,
                          rx_batch=rx_batch)
    return state, params, app


def build_bulk(num_hosts: int,
               server: int = 0,
               bytes_per_client: int = 1 << 20,
               latency_ns: int = 10 * simtime.SIMTIME_ONE_MILLISECOND,
               reliability: float = 1.0,
               start_time: int = simtime.SIMTIME_ONE_MILLISECOND,
               stop_time: int = 60 * simtime.SIMTIME_ONE_SECOND,
               seed: int = 1,
               sock_slots: int = 16,
               pool_capacity: int = 1 << 14,
               bw_up_Bps: int = 1 << 30,
               bw_down_Bps: int = 1 << 30,
               bootstrap_end: int = 0,
               megakernel: bool = True,
               persistent: bool = True,
               device=None):
    """Bulk TCP transfers: every host but `server` sends
    `bytes_per_client` to the server over a uniform full mesh of
    `num_hosts` vertices; same arguments and result as the JAX
    build_bulk, on `device` (None = the CUDA card).  With the defaults
    each window is one K_WINDOW launch (the TCP kernel, with bulk's tick
    on the card); persistent=False runs the per-phase kernels."""
    dev = resolve_device(device)
    lat, rel = uniform_full_mesh(num_hosts, latency_ns, reliability)
    params = make_net_params(
        latency_ns=lat, reliability=rel,
        host_vertex=torch.arange(num_hosts),
        bw_up_Bps=torch.full((num_hosts,), bw_up_Bps),
        bw_down_Bps=torch.full((num_hosts,), bw_down_Bps),
        seed=seed, stop_time=stop_time, bootstrap_end=bootstrap_end,
        megakernel=megakernel, persistent=persistent, device=dev)
    state = make_sim_state(num_hosts, sock_slots=sock_slots,
                           pool_capacity=pool_capacity, uses_tcp=True,
                           device=dev)
    is_server = torch.arange(num_hosts, device=dev) == server
    state = state.replace(
        socks=bulk_app.setup_servers(state.socks, is_server),
        app=bulk_app.init_state(
            num_hosts, is_client=~is_server, dst=server,
            total_bytes=torch.where(is_server, 0, bytes_per_client),
            start_t=start_time, device=dev))
    return state, params, bulk_app.Bulk()


_TGEN_SERVER_XML = """
<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="serverport" attr.type="string" for="node" id="k0"/>
  <graph edgedefault="directed">
    <node id="start"><data key="k0">{port}</data></node>
  </graph>
</graphml>"""

_TGEN_CLIENT_XML = """
<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="peers" attr.type="string" for="node" id="k0"/>
  <key attr.name="sendsize" attr.type="string" for="node" id="k1"/>
  <key attr.name="recvsize" attr.type="string" for="node" id="k2"/>
  <key attr.name="count" attr.type="string" for="node" id="k3"/>
  <key attr.name="time" attr.type="string" for="node" id="k4"/>
  <graph edgedefault="directed">
    <node id="start"><data key="k0">server:{port}</data></node>
    <node id="stream"><data key="k1">{sendsize}</data>
      <data key="k2">{recvsize}</data></node>
    <node id="end"><data key="k3">{streams}</data></node>
    <node id="pause"><data key="k4">1,2</data></node>
    <edge source="start" target="stream"/>
    <edge source="stream" target="end"/>
    <edge source="end" target="pause"/>
    <edge source="pause" target="start"/>
  </graph>
</graphml>"""

TGEN_PORT = 8888


def build_tgen(num_hosts: int,
               server: int = 0,
               sendsize: int = 50 * 1024,
               recvsize: int = 200 * 1024,
               streams: int = 3,
               latency_ns: int = 20 * simtime.SIMTIME_ONE_MILLISECOND,
               reliability: float = 1.0,
               stop_time: int = 120 * simtime.SIMTIME_ONE_SECOND,
               seed: int = 1,
               sock_slots: int = 16,
               pool_slab: int = 32,
               bw_Bps: int = 1 << 27,
               megakernel: bool = True,
               persistent: bool = True,
               device=None):
    """A tgen world: one file server plus (num_hosts - 1) clients running
    the modeled action-graph interpreter (apps/tgen.py) with the graph
    shape of Shadow's examples/tgen-100host -- each client streams
    `sendsize` up and `recvsize` down `streams` times with 1-2 s pauses.
    Same arguments and result as the JAX build_tgen, on `device` (None =
    the CUDA card).  With the defaults each window is one K_WINDOW launch
    (the TCP kernel, with tgen's tick on the card); persistent=False runs
    the per-phase kernels."""
    if num_hosts < 2:
        raise ValueError("tgen needs at least 2 hosts (one server plus "
                         "clients)")
    dev = resolve_device(device)
    v = min(num_hosts, 256)
    srv = tgen_app.parse_tgen(_TGEN_SERVER_XML.format(port=TGEN_PORT))
    cli = tgen_app.parse_tgen(_TGEN_CLIENT_XML.format(
        port=TGEN_PORT, sendsize=int(sendsize), recvsize=int(recvsize),
        streams=int(streams)))
    host_graph = [1] * num_hosts
    host_graph[server] = 0
    start_t = [5 * simtime.SIMTIME_ONE_SECOND] * num_hosts
    start_t[server] = simtime.SIMTIME_ONE_SECOND
    lat, rel = uniform_full_mesh(v, latency_ns, reliability)
    params = make_net_params(
        latency_ns=lat, reliability=rel,
        host_vertex=torch.arange(num_hosts) % v,
        bw_up_Bps=torch.full((num_hosts,), bw_Bps),
        bw_down_Bps=torch.full((num_hosts,), bw_Bps),
        seed=seed, stop_time=stop_time, megakernel=megakernel,
        persistent=persistent, device=dev)
    state = make_sim_state(num_hosts, sock_slots=sock_slots,
                           pool_capacity=num_hosts * pool_slab,
                           uses_tcp=True, device=dev)
    mask = torch.arange(num_hosts, device=dev) == server
    state = state.replace(
        socks=tcp.listen_v(state.socks, mask, 0, TGEN_PORT,
                           backlog=num_hosts),
        app=tgen_app.build_state(
            num_hosts, [srv, cli], host_graph, start_t,
            resolve_peer=lambda s: (server, int(s.rsplit(":", 1)[1])),
            device=dev))
    return state, params, tgen_app.Tgen()


def run(state, params, app, until: int | None = None):
    """Run to `until` (default params.stop_time) in run_chunked chunks."""
    t = params.stop_time if until is None else int(until)
    return engine.run_chunked(state, params, app, t)
