"""PHOLD on-device application model (counterpart of
shadow1_tpu/apps/phold.py).

Every received UDP message becomes a pending message forwarded to a
random other host after an exponential delay; draws are keyed by (host,
per-host draw counter).  The f64 delay draw goes through
core.xlamath.log1p, which reproduces the JAX package's f64 log1p bit for
bit (torch.log1p does not).  On the per-phase path `on_tick` runs as
plain torch between the K_DELIVER and K_TRANSPORT launches, as it runs
between the Pallas kernels in the JAX main graph; K_WINDOW runs its
device copy, csrc/phold_tick.cuh (`device_tick = "phold"`)."""

from __future__ import annotations

import dataclasses

import torch

from ..core import emit, rng, simtime, xlamath
from ..core.state import I32, I64, Tree, host_ids
from ..transport import udp

PHOLD_PORT = 9000
MSG_BYTES = 64
INV = simtime.SIMTIME_INVALID
M32 = 0xFFFFFFFF


@dataclasses.dataclass
class PholdState(Tree):
    next_send: torch.Tensor  # [H] i64, SIMTIME_INVALID if none
    pending: torch.Tensor    # [H] i32
    sent: torch.Tensor       # [H] i64
    recv: torch.Tensor       # [H] i64


def _delay_from_u(u, mean_delay_ns: int):
    """max(int64(-log1p(-u) * mean), 1) with the f64 log1p of XLA CPU."""
    d = -xlamath.log1p(-u.to(torch.float64)) * float(mean_delay_ns)
    return torch.clamp(d.to(I64), min=1)


class Phold:
    """Static app config (same class attributes as the JAX Phold)."""

    uses_tcp = False
    may_loopback = False
    app_tx_lanes = 4
    wants_window_end = True
    # The tick K_WINDOW runs on the card (csrc/phold_tick.cuh).
    device_tick = "phold"

    def __init__(self, mean_delay_ns: int, sock_slot: int = 0,
                 rx_batch: int = 1):
        self.mean_delay_ns = int(mean_delay_ns)
        self.sock_slot = int(sock_slot)
        self.rx_batch = int(rx_batch)

    def next_time(self, state):
        a = state.app
        return torch.where(a.pending > 0, a.next_send,
                           torch.full_like(a.next_send, INV))

    def _delay(self, params, rows, ctr):
        words = params.purpose_words[rng.PURPOSE_HOST_APP]
        u = rng.keyed_uniform(words, rows, ctr, 1)
        return _delay_from_u(u, self.mean_delay_ns)

    def _delays(self, params, rows, ctr0, n: int):
        """[H, n] delays keyed by draw counters ctr0 .. ctr0 + n - 1.  A
        tick draws its delays at counters in that span, so one batched
        f64 log1p serves all of them (the draws are functionally keyed;
        batching changes no value)."""
        span = torch.arange(n, dtype=I64, device=rows.device)[None, :]
        return self._delay(params, rows[:, None],
                           (ctr0[:, None] + span) & M32)

    def _pick_dst(self, params, rows, ctr, num_hosts: int):
        words = params.purpose_words[rng.PURPOSE_HOST_APP]
        u = rng.keyed_uniform(words, rows, ctr, 2)
        # f32 multiply, then truncate (the JAX (u * (n - 1)).astype(I32)).
        scaled = (u * float(num_hosts - 1)).to(I32)
        off = 1 + torch.clamp(scaled, max=num_hosts - 2)
        return torch.remainder(rows.to(I32) + off, num_hosts)

    def on_tick(self, state, params, em, tick_t, active, window_end=None):
        a = state.app
        socks = state.socks
        h = a.pending.shape[0]
        dev = a.pending.device
        rows = host_ids(state, I64)
        hg = params.global_hosts()
        slot = torch.full((h,), self.sock_slot, dtype=I32, device=dev)
        inv = torch.full((h,), INV, dtype=I64, device=dev)

        n_pop = max(2, self.rx_batch)
        lanes = max(1, self.app_tx_lanes) if window_end is not None else 1
        # Every delay of this tick is keyed by a counter in
        # [ctr0, ctr0 + n_pop + 2 * lanes): pops draw at ctr0 + (pops so
        # far), send lanes at (counter before the lane) + 1.
        ctr0 = state.hosts.rng_ctr
        delays = self._delays(params, rows, ctr0, n_pop + 2 * lanes)

        def delay_at(ctr):
            return delays.gather(1, ((ctr - ctr0) & M32)[:, None])[:, 0]

        # Consume delivered messages: each becomes a pending message.
        for _ in range(n_pop):
            socks, got, _s, _p, _l, _i = udp.pop_ring(socks, active, slot)
            ctr = state.hosts.rng_ctr
            cand = tick_t + delay_at(ctr)
            gi = got.to(I32)
            a = a.replace(
                pending=a.pending + gi,
                next_send=torch.where(got, torch.minimum(a.next_send, cand),
                                      a.next_send),
                recv=a.recv + gi.to(I64))
            state = state.replace(hosts=state.hosts.replace(
                rng_ctr=(state.hosts.rng_ctr + gi.to(I64)) & M32))

        if window_end is not None:
            ib = state.inbox
            ki = ib.capacity // h
            t2 = ib.times().reshape(h, ki)
            live = (ib.stage != 0).reshape(h, ki)
            arr_next = torch.where(live, torch.maximum(t2, tick_t[:, None]),
                                   torch.full_like(t2, INV)).amin(dim=1)
            bound = torch.clamp(arr_next, max=window_end)
        else:
            bound = None

        for k in range(lanes):
            ctr = state.hosts.rng_ctr
            if k == 0:
                due = active & (a.pending > 0) & (a.next_send <= tick_t)
                t_send = 0
            else:
                due = active & (a.pending > 0) & (a.next_send < bound)
                t_send = a.next_send
            dst = self._pick_dst(params, rows, ctr, hg)
            em = emit.put(em, due, emit.SLOT_APP + k, dst=dst,
                          sport=PHOLD_PORT, dport=PHOLD_PORT, proto=17,
                          length=MSG_BYTES, t_send=t_send)
            delay2 = delay_at((ctr + 1) & M32)
            base_t = tick_t if k == 0 else a.next_send
            di = due.to(I32)
            pending2 = a.pending - di
            a = a.replace(
                pending=pending2,
                sent=a.sent + di.to(I64),
                next_send=torch.where(
                    due, torch.where(pending2 > 0, base_t + delay2, inv),
                    a.next_send))
            state = state.replace(hosts=state.hosts.replace(
                rng_ctr=(state.hosts.rng_ctr + 2 * di.to(I64)) & M32))
        return state.replace(app=a, socks=socks), em


def init_state(num_hosts: int, params, msgs_per_host: int = 1,
               mean_delay_ns: int = 10 * simtime.SIMTIME_ONE_MILLISECOND,
               device=None):
    """Initial population: `msgs_per_host` messages per host with
    exponentially distributed first send times (draw counter 0)."""
    dev = params.host_vertex.device if device is None else device
    words = params.purpose_words[rng.PURPOSE_HOST_APP]
    rows = torch.arange(num_hosts, dtype=I64, device=dev)
    u = rng.keyed_uniform(words, rows, 0, 1)
    return PholdState(
        next_send=_delay_from_u(u, mean_delay_ns),
        pending=torch.full((num_hosts,), msgs_per_host, dtype=I32,
                           device=dev),
        sent=torch.zeros((num_hosts,), dtype=I64, device=dev),
        recv=torch.zeros((num_hosts,), dtype=I64, device=dev))
