"""NIC token buckets and the CoDel control law (counterpart of
shadow1_tpu/core/nic.py).  Integer token accounting in byte-nanosecond
units.  CoDel's one float op, interval / sqrt(count) in f32, is what the
JAX package computes after XLA rewrites it: interval * rsqrt(count) with
XLA CPU's f32 rsqrt (core/xlamath.py), not a correctly rounded divide."""

from __future__ import annotations

import torch

from . import simtime, xlamath
from .state import I32, I64, MTU

SCALE = 1_000_000_000
REFILL_INTERVAL_NS = simtime.SIMTIME_ONE_MILLISECOND
CODEL_TARGET_NS = 10 * simtime.SIMTIME_ONE_MILLISECOND
CODEL_INTERVAL_NS = 100 * simtime.SIMTIME_ONE_MILLISECOND


def bucket_capacity(rate_Bps):
    return rate_Bps * REFILL_INTERVAL_NS + MTU * SCALE


def refill(tokens, last, rate_Bps, now, mask):
    """Lazy continuous refill; returns (tokens, last) updated where mask."""
    fill_time = REFILL_INTERVAL_NS + torch.div(
        MTU * SCALE, torch.clamp(rate_Bps, min=1),
        rounding_mode="floor") + 1
    dt = torch.minimum(torch.clamp(now - last, min=0), fill_time)
    accrued = torch.minimum(bucket_capacity(rate_Bps), tokens + dt * rate_Bps)
    return torch.where(mask, accrued, tokens), torch.where(mask, now, last)


def time_until(deficit_scaled, rate_Bps):
    """ns until `deficit_scaled` more tokens accrue (ceil; floor division
    like JAX's `//`)."""
    r = torch.clamp(rate_Bps, min=1)
    return torch.div(deficit_scaled + r - 1, r, rounding_mode="floor")


def codel_spacing(cnt):
    """Drop-next spacing: int64(f32(interval) * rsqrt_xla(f32(count)))."""
    r = xlamath.rsqrt(torch.clamp(cnt, min=1).to(torch.float32))
    return (r * float(CODEL_INTERVAL_NS)).to(I64)


def codel_dequeue(hosts, mask, now, sojourn, backlog_after):
    """One CoDel dequeue decision per masked host; returns (hosts, drop)."""
    count = hosts.codel_count
    dropping = hosts.codel_dropping
    fa = hosts.codel_first_above
    drop_next = hosts.codel_drop_next
    zero = torch.zeros_like(fa)

    below = (sojourn < CODEL_TARGET_NS) | (backlog_after <= 0)
    fa_new = torch.where(below, zero,
                         torch.where(fa == 0, now + CODEL_INTERVAL_NS, fa))
    ok = mask & ~below & (fa_new != 0) & (now >= fa_new)

    drop_in = dropping & ok & (now >= drop_next)
    count_in = count + drop_in.to(I32)
    next_in = torch.where(drop_in, drop_next + codel_spacing(count_in),
                          drop_next)

    recent = (now - drop_next) < (16 * CODEL_INTERVAL_NS)
    enter = mask & ~dropping & ok
    count_enter = torch.where(recent & (count > 2), count - 2,
                              torch.ones_like(count))
    next_enter = now + codel_spacing(count_enter)

    drop = drop_in | enter
    new_dropping = torch.where(mask, (dropping & ok) | enter, dropping)
    new_count = torch.where(enter, count_enter,
                            torch.where(mask & dropping, count_in, count))
    new_next = torch.where(enter, next_enter,
                           torch.where(mask & dropping, next_in, drop_next))
    hosts = hosts.replace(
        codel_first_above=torch.where(mask, fa_new, fa),
        codel_dropping=new_dropping,
        codel_count=new_count.to(I32),
        codel_drop_next=new_next.to(I64),
    )
    return hosts, drop
