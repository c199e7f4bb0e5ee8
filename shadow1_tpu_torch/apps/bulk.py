"""Bulk TCP transfers (counterpart of shadow1_tpu/apps/bulk.py): clients
open a connection to a server, stream `total` bytes, close, and record
when their FIN is acknowledged; every host consumes what it receives.

On the persistent path (params.persistent, the default) K_WINDOW runs
the tick on the card: its device copy is csrc/bulk_tick.cuh
(`device_tick = "bulk"`), which this module's `on_tick` and `next_time`
are the plain versions of.  On the per-phase path `on_tick` runs as plain
torch between K_DELIVER and K_TRANSPORT, as in the JAX package's
per-phase graph."""

from __future__ import annotations

import dataclasses

import torch

from ..core import simtime
from ..core.state import (I32, I64, SOCK_TCP, TCPS_CLOSED, TCPS_CLOSEWAIT,
                          TCPS_FINWAIT2, TCPS_TIMEWAIT, Tree)
from ..transport import tcp

SERVER_PORT = 80
CLIENT_PORT = 40000
LISTEN_SLOT = 0
CLIENT_SLOT = 1

INV = simtime.SIMTIME_INVALID
M32 = 0xFFFFFFFF


@dataclasses.dataclass
class BulkState(Tree):
    is_client: torch.Tensor  # [H] bool
    dst: torch.Tensor        # [H] i32
    total: torch.Tensor      # [H] i64
    start_t: torch.Tensor    # [H] i64
    phase: torch.Tensor      # [H] i32 0 idle, 1 running, 2 done, 3 failed
    finish_t: torch.Tensor   # [H] i64 completion time, INV until done


class Bulk:
    """Static app config (same class attributes as the JAX Bulk).  Bulk
    never sends to its own host (clients address the server, replies go
    back to their source), so unlike the JAX class it declares no
    loopback: the staging path's loopback insert is the identity there."""

    uses_tcp = True
    may_loopback = False
    rx_batch = 4
    device_tick = "bulk"

    def __init__(self, server_port: int = SERVER_PORT,
                 client_slot: int = CLIENT_SLOT):
        self.server_port = int(server_port)
        self.client_slot = int(client_slot)

    def next_time(self, state):
        a = state.app
        return torch.where(a.is_client & (a.phase == 0), a.start_t,
                           torch.full_like(a.start_t, INV))

    def on_tick(self, state, params, em, tick_t, active):
        """Start due clients, stream and close running ones, record
        completions; every host consumes and closes when its peer did.
        Each socket call is skipped when no host takes it: under an empty
        mask it writes nothing."""
        a = state.app
        socks = state.socks
        h = a.phase.shape[0]
        cs = self.client_slot
        slot = torch.full((h,), cs, dtype=I32, device=a.phase.device)

        starting = active & a.is_client & (a.phase == 0) & \
            (a.start_t <= tick_t)
        if bool(starting.any()):
            socks = tcp.connect_v(socks, starting, slot, a.dst,
                                  self.server_port, CLIENT_PORT, tick_t)
            a = a.replace(phase=torch.where(starting, 1, a.phase))

        running = active & a.is_client & (a.phase == 1)
        target_end = (1 + (a.total & M32)) & M32
        if bool(running.any()):
            socks = tcp.write_v(socks, running, slot, target_end, now=tick_t)
            all_written = socks.snd_end[:, cs] == target_end
            socks = tcp.close_v(socks, running & all_written, slot)
            cstate = socks.tcp_state[:, cs]
            closed = (cstate == TCPS_FINWAIT2) | \
                (cstate == TCPS_TIMEWAIT) | (cstate == TCPS_CLOSED)
            all_acked = socks.snd_una[:, cs] == ((target_end + 1) & M32)
            failed = running & (socks.error[:, cs] != 0)
            done = running & closed & all_acked & ~failed
            a = a.replace(
                phase=torch.where(done, 2, torch.where(failed, 3, a.phase)),
                finish_t=torch.where(done, tick_t, a.finish_t))

        socks = tcp.consume_all(socks)
        socks = socks.replace(app_closed=socks.app_closed | (
            (socks.stype == SOCK_TCP) & (socks.tcp_state == TCPS_CLOSEWAIT)))
        return state.replace(app=a, socks=socks), em


def init_state(num_hosts: int, is_client, dst, total_bytes, start_t,
               device=None) -> BulkState:
    def t(x, dtype):
        return torch.broadcast_to(torch.as_tensor(x, device=device),
                                  (num_hosts,)).to(dtype).clone()

    return BulkState(
        is_client=t(is_client, torch.bool), dst=t(dst, I32),
        total=t(total_bytes, I64), start_t=t(start_t, I64),
        phase=torch.zeros((num_hosts,), dtype=I32, device=device),
        finish_t=torch.full((num_hosts,), INV, dtype=I64, device=device))


def setup_servers(socks, is_server, port: int = SERVER_PORT,
                  slot: int = LISTEN_SLOT):
    """Install TCP listeners on the server hosts (set-up time)."""
    return tcp.listen_v(socks, is_server, slot, port)
