"""High-level simulation assembly (counterpart of shadow1_tpu/sim.py):
build params + state + app, then run."""

from __future__ import annotations

import torch

from . import resolve_device
from .apps import bulk as bulk_app
from .apps import phold as phold_app
from .core import engine, simtime
from .core.params import make_net_params
from .core.state import make_sim_state
from .routing.synthetic import uniform_full_mesh
from .transport import udp


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


def run(state, params, app, until: int | None = None):
    """Run to `until` (default params.stop_time) in run_chunked chunks."""
    t = params.stop_time if until is None else int(until)
    return engine.run_chunked(state, params, app, t)
