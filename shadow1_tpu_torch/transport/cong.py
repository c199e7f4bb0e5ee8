"""Congestion control hooks (counterpart of shadow1_tpu/transport/cong.py).

Reno (NewReno, RFC 6582: slow start, AIMD avoidance, halving on fast
retransmit, one segment on RTO) is ported.  CUBIC is not: its window
target is f32 arithmetic around a cube root that must round as XLA CPU's
does, on the card as well (ROADMAP queue 1); `validate` refuses it by
name, and `engine.check_supported` calls it.

Every hook mutates the gathered socket view `sv` (transport.tcp._Sock)
under its mask, like the JAX hooks.
"""

from __future__ import annotations

import torch

from ..core.state import TCP_MSS

ALGORITHMS = ("reno",)


def validate(name: str) -> str:
    if name == "cubic":
        raise NotImplementedError(
            "congestion control 'cubic' is not ported yet (its f32 cube-"
            "root target needs XLA CPU's rounding on the card); use 'reno'")
    if name not in ALGORITHMS:
        raise ValueError(f"unknown congestion control {name!r} "
                         f"(available: {ALGORITHMS})")
    return name


def _reno_new_ack(sv, normal, acked_bytes, tick_t):
    ss = normal & (sv.cwnd < sv.ssthresh)
    sv.setwhere(ss, cwnd=torch.minimum(sv.cwnd + acked_bytes, sv.ssthresh))
    ca = normal & ~ss
    sv.setwhere(ca, cwnd=sv.cwnd + torch.clamp(
        (TCP_MSS * TCP_MSS) // torch.clamp(sv.cwnd, min=1), min=1))


def _reno_enter_recovery(sv, fr, flight, tick_t):
    half = torch.clamp(flight // 2, min=2 * TCP_MSS)
    sv.setwhere(fr, ssthresh=half, cwnd=half + 3 * TCP_MSS)


def _reno_timeout(sv, est_rto, flight, tick_t):
    sv.setwhere(est_rto, ssthresh=torch.clamp(flight // 2, min=2 * TCP_MSS),
                cwnd=TCP_MSS)


_HOOKS = {"reno": (_reno_new_ack, _reno_enter_recovery, _reno_timeout)}


def new_ack(alg: str, sv, normal, acked_bytes, tick_t):
    _HOOKS[validate(alg)][0](sv, normal, acked_bytes, tick_t)


def enter_recovery(alg: str, sv, fr, flight, tick_t):
    _HOOKS[validate(alg)][1](sv, fr, flight, tick_t)


def timeout(alg: str, sv, est_rto, flight, tick_t):
    _HOOKS[validate(alg)][2](sv, est_rto, flight, tick_t)
