"""Congestion control hooks (counterpart of shadow1_tpu/transport/cong.py).

Reno (NewReno, RFC 6582: slow start, AIMD avoidance, halving on fast
retransmit, one segment on RTO) and CUBIC (RFC 8312-style window growth
with fast convergence) as in the JAX package.  Every hook mutates the
gathered socket view `sv` (transport.tcp._Sock) under its mask, like the
JAX hooks; CUBIC's per-socket state is the socket table's cub_epoch /
cub_wmax, which Reno never touches.

CUBIC's window target is f32 arithmetic around a cube root, and it must
round as XLA CPU rounds the JAX `_cubic_target` after its optimisations:
every division by a constant becomes a product with an f32 constant (the
K argument `wmax / MSS * (1 - beta) / C` one product), and two
multiply-adds are contracted into fused ones.  `_cubic_target` is that
sequence, with `xlamath.fma_f32` for the fused steps and `xlamath.cbrt`
for XLA CPU's cube root; csrc/tcp.cuh `cubic_target` is the same
sequence on the card.
"""

from __future__ import annotations

import torch

from ..core import xlamath
from ..core.state import I32, I64, TCP_MSS

ALGORITHMS = ("reno", "cubic")

# CUBIC's f32 constants as XLA CPU folds them (RFC 8312: C = 0.4,
# beta = 0.7): 1 / 1e9, 1 / MSS, (1 - beta) / (C * MSS), C, beta,
# (1 + beta) / 2 and the SND_BUF_MAX cap in segments.
_NS_TO_S = 1e-09
_INV_MSS = 0.000684931525
_K_ARG = 0.000513698673
_C = 0.4
_BETA = 0.7
_FAST_CONV = 0.85
_WMAX_SEG = 2872.81104


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def validate(name: str) -> str:
    if name not in ALGORITHMS:
        raise ValueError(f"unknown congestion control {name!r} "
                         f"(available: {ALGORITHMS})")
    return name


# ---------------------------------------------------------------------------
# Reno (NewReno)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# CUBIC
# ---------------------------------------------------------------------------


def _cubic_target(sv, tick_t):
    """W_cubic(t + RTT) in bytes, i32: C (t - K)^3 + Wmax in f32 segments,
    clamped to [2, SND_BUF_MAX / MSS] before the truncating cast."""
    f32 = torch.float32
    dev = sv.cwnd.device
    ns = _f32(_NS_TO_S).to(dev)
    wmax = sv.cub_wmax.to(f32)
    k = xlamath.cbrt(torch.clamp(wmax * _f32(_K_ARG).to(dev), min=0.0))
    t_s = torch.clamp(tick_t - sv.cub_epoch, min=0).to(f32)
    rtt_s = torch.clamp(sv.srtt, min=1).to(f32) * ns
    d = xlamath.fma_f32(t_s, ns, rtt_s) - k
    cube = ((d * _f32(_C).to(dev)) * d) * d
    w = xlamath.fma_f32(wmax, _f32(_INV_MSS).to(dev), cube)
    w = torch.clamp(w, 2.0, float(_f32(_WMAX_SEG)))
    return (w * _f32(float(TCP_MSS)).to(dev)).to(I32)


def _cubic_new_ack(sv, normal, acked_bytes, tick_t):
    # Slow start below ssthresh, cubic growth above.
    ss = normal & (sv.cwnd < sv.ssthresh)
    sv.setwhere(ss, cwnd=torch.minimum(sv.cwnd + acked_bytes, sv.ssthresh))
    ca = normal & ~ss
    # A fresh epoch starts on entering congestion avoidance with none.
    fresh = ca & (sv.cub_epoch == 0)
    sv.setwhere(fresh, cub_epoch=tick_t,
                cub_wmax=torch.maximum(sv.cub_wmax, sv.cwnd))
    target = _cubic_target(sv, tick_t)
    # The per-ACK step toward the target, in i64, cast to i32 with
    # wrap-around as XLA's convert does.  The JAX `//` floors where C's
    # `/` truncates; they differ only on a negative quotient, and the
    # clip at 0 maps both to 0.
    step = ((target - sv.cwnd).to(I64) * acked_bytes
            // torch.clamp(sv.cwnd, min=TCP_MSS)).to(I32)
    step = torch.minimum(torch.clamp(step, min=0),
                         torch.clamp(acked_bytes, min=TCP_MSS))
    # TCP-friendly floor: at least Reno's linear growth.
    reno_step = torch.clamp(
        (TCP_MSS * TCP_MSS) // torch.clamp(sv.cwnd, min=1), min=1)
    sv.setwhere(ca, cwnd=sv.cwnd + torch.maximum(step, reno_step))


def _scaled(cwnd, factor: float):
    """i32(f32(cwnd) * f32(factor)), truncating."""
    return (cwnd.to(torch.float32) * _f32(factor).to(cwnd.device)).to(I32)


def _cubic_enter_recovery(sv, fr, flight, tick_t):
    # Fast convergence: a Wmax below the previous one shrinks further.
    new_wmax = torch.where(sv.cwnd < sv.cub_wmax,
                           _scaled(sv.cwnd, _FAST_CONV), sv.cwnd)
    reduced = torch.clamp(_scaled(sv.cwnd, _BETA), min=2 * TCP_MSS)
    sv.setwhere(fr, cub_wmax=new_wmax, ssthresh=reduced,
                cwnd=reduced + 3 * TCP_MSS, cub_epoch=0)


def _cubic_timeout(sv, est_rto, flight, tick_t):
    sv.setwhere(est_rto,
                ssthresh=torch.clamp(_scaled(sv.cwnd, _BETA),
                                     min=2 * TCP_MSS),
                cwnd=TCP_MSS, cub_epoch=0,
                cub_wmax=torch.maximum(sv.cub_wmax, sv.cwnd))


_HOOKS = {
    "reno": (_reno_new_ack, _reno_enter_recovery, _reno_timeout),
    "cubic": (_cubic_new_ack, _cubic_enter_recovery, _cubic_timeout),
}


def new_ack(alg: str, sv, normal, acked_bytes, tick_t):
    _HOOKS[validate(alg)][0](sv, normal, acked_bytes, tick_t)


def enter_recovery(alg: str, sv, fr, flight, tick_t):
    _HOOKS[validate(alg)][1](sv, fr, flight, tick_t)


def timeout(alg: str, sv, est_rto, flight, tick_t):
    _HOOKS[validate(alg)][2](sv, est_rto, flight, tick_t)
