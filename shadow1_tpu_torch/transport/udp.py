"""UDP: connectionless datagram sockets over the socket table
(counterpart of shadow1_tpu/transport/udp.py).  Lookup is a vectorized
match over the S slot axis -- connected (peer-matching) beats wildcard,
lowest slot breaks ties -- and received datagrams land in a per-socket
ring of UDP_RING entries."""

from __future__ import annotations

import torch

from ..core import state as st
from ..core.state import I32, I64, UDP_RING


def open_bind_all(socks: st.SocketTable, slot: int,
                  port: int) -> st.SocketTable:
    """Bind a wildcard UDP socket in `slot` on every host at once."""
    stype, local_port = socks.stype.clone(), socks.local_port.clone()
    peer_host, peer_port = socks.peer_host.clone(), socks.peer_port.clone()
    stype[:, slot] = st.SOCK_UDP
    local_port[:, slot] = port
    peer_host[:, slot] = -1
    peer_port[:, slot] = 0
    return socks.replace(stype=stype, local_port=local_port,
                         peer_host=peer_host, peer_port=peer_port)


def lookup_socket(socks: st.SocketTable, mask, src, sport, dport):
    """[H] i32 bound slot for an inbound datagram, -1 if none."""
    is_udp = socks.stype == st.SOCK_UDP
    port_ok = socks.local_port == dport[:, None]
    wildcard = socks.peer_host == -1
    specific = (socks.peer_host == src[:, None]) & \
        (socks.peer_port == sport[:, None])
    score = torch.where(is_udp & port_ok & specific, 2,
                        torch.where(is_udp & port_ok & wildcard, 1, 0))
    best = score.amax(dim=1)
    slot_ids = torch.arange(socks.slots, dtype=I32,
                            device=score.device)[None, :]
    cand = torch.where(score == best[:, None], slot_ids,
                       torch.full_like(slot_ids, socks.slots))
    slot = cand.amin(dim=1).to(I32)
    ok = mask & (best > 0)
    return torch.where(ok, slot, torch.full_like(slot, -1))


def _onehot(socks, slot):
    safe = torch.clamp(slot, 0, socks.slots - 1)
    return safe[:, None] == torch.arange(socks.slots, dtype=I32,
                                         device=slot.device)


def _gather(tab, oh):
    """[H] from [H, S] (or [H, S, R] under an [H, S, R] one-hot)."""
    axes = tuple(range(1, tab.ndim)) if oh.ndim == tab.ndim else (1,)
    return torch.where(oh, tab, torch.zeros_like(tab)).sum(
        dim=axes, dtype=tab.dtype)


def push_ring(socks: st.SocketTable, host_mask, slot, src, sport, length,
              payload_id):
    """Append a datagram to each masked host's socket ring; returns
    (socks, dropped_mask)."""
    oh = _onehot(socks, slot)
    count = _gather(socks.udp_count, oh)
    full = count >= UDP_RING
    do = host_mask & (slot >= 0) & ~full
    head = _gather(socks.udp_head, oh)
    pos = torch.remainder(head + count, UDP_RING)
    oh_sr = oh[:, :, None] & (pos[:, None, None] == torch.arange(
        UDP_RING, dtype=I32, device=slot.device)[None, None, :])
    w = oh_sr & do[:, None, None]

    def scatter(arr, val):
        v = torch.broadcast_to(val.to(I32), (socks.num_hosts,))
        return torch.where(w, v[:, None, None], arr)

    ohd = oh & do[:, None]
    return socks.replace(
        udp_src=scatter(socks.udp_src, src),
        udp_sport=scatter(socks.udp_sport, sport),
        udp_len=scatter(socks.udp_len, length),
        udp_payload=scatter(socks.udp_payload, payload_id),
        udp_count=torch.where(ohd, socks.udp_count + 1, socks.udp_count),
        bytes_recv=torch.where(ohd, socks.bytes_recv
                               + length.to(I64)[:, None], socks.bytes_recv),
    ), host_mask & (slot >= 0) & full


def pop_ring(socks: st.SocketTable, host_mask, slot):
    """Pop the oldest datagram of each masked host's socket ring; returns
    (socks, got_mask, src, sport, length, payload_id)."""
    oh = _onehot(socks, slot)
    count = _gather(socks.udp_count, oh)
    got = host_mask & (slot >= 0) & (count > 0)
    head = _gather(socks.udp_head, oh)
    oh_sr = oh[:, :, None] & (head[:, None, None] == torch.arange(
        UDP_RING, dtype=I32, device=slot.device)[None, None, :])
    src = _gather(socks.udp_src, oh_sr)
    sport = _gather(socks.udp_sport, oh_sr)
    length = _gather(socks.udp_len, oh_sr)
    payload = _gather(socks.udp_payload, oh_sr)
    adv = oh & got[:, None]
    socks = socks.replace(
        udp_head=torch.where(adv, torch.remainder(socks.udp_head + 1,
                                                  UDP_RING), socks.udp_head),
        udp_count=torch.where(adv, socks.udp_count - 1, socks.udp_count),
    )
    return socks, got, src, sport, length, payload


def deliver(socks: st.SocketTable, host_mask, src, sport, dport, length,
            payload_id):
    """Deliver one inbound datagram per masked host; returns
    (socks, accepted_mask)."""
    slot = lookup_socket(socks, host_mask, src, sport, dport)
    socks, dropped_full = push_ring(socks, host_mask, slot, src, sport,
                                    length, payload_id)
    return socks, host_mask & (slot >= 0) & ~dropped_full
