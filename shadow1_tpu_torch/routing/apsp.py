"""All-pairs shortest paths: the routing precompute (counterpart of
shadow1_tpu/routing/apsp.py).

Floyd-Warshall over [V,V] f32 latencies (ms), carrying the path's
reliability (multiplied) and jitter (summed) wherever the latency
strictly improves; then the self-paths (an explicit self-loop, else out
to the nearest neighbour and back) and the rounding to i64 nanoseconds.
The JAX package computes this outside any Pallas kernel, and so does the
port: plain torch ops on the tensors' device, in the same order and f32
arithmetic, so every matrix equals the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

from ..core.simtime import SIMTIME_ONE_MILLISECOND

F32 = torch.float32
I64 = torch.int64

# Unreachable sentinel in ms; far above any real path but small enough that
# INF + INF stays finite in f32.
INF_MS = 1e12


def floyd_warshall(lat_ms: torch.Tensor, rel: torch.Tensor,
                   jit_ms: torch.Tensor):
    """Relax [V,V] f32 latency (ms), reliability and jitter through every
    vertex k in turn (JAX floyd_warshall's fori_loop body)."""
    lat, rel, jit = lat_ms.clone(), rel.clone(), jit_ms.clone()
    for k in range(lat.shape[0]):
        through = lat[:, k, None] + lat[None, k, :]
        better = through < lat
        rel = torch.where(better, rel[:, k, None] * rel[None, k, :], rel)
        jit = torch.where(better, jit[:, k, None] + jit[None, k, :], jit)
        lat = torch.where(better, through, lat)
    return lat, rel, jit


def build_matrices(edge_lat_ms, edge_rel, self_lat_ms=None, self_rel=None,
                   edge_jitter_ms=None, self_jitter_ms=None, device=None):
    """From directed-adjacency inputs (numpy or tensors, f32) to the final
    routing matrices, computed on `device` (None: the CPU):
    (latency_ns i64 [V,V], reliability f32 [V,V], jitter_ns i64 [V,V]).
    Same arguments and meaning as the JAX build_matrices."""
    dev = torch.device("cpu") if device is None else torch.device(device)

    def t(x):
        return None if x is None else torch.as_tensor(x, dtype=F32).to(dev)

    lat_in, rel_in = t(edge_lat_ms), t(edge_rel)
    v = lat_in.shape[0]
    jit_in = torch.zeros_like(lat_in) if edge_jitter_ms is None \
        else t(edge_jitter_ms)
    lat, rel, jit = floyd_warshall(lat_in, rel_in, jit_in)

    eye = torch.eye(v, dtype=torch.bool, device=dev)
    off_lat = torch.where(eye, torch.tensor(INF_MS, dtype=F32, device=dev),
                          lat)
    nearest = torch.argmin(off_lat, dim=1)    # first minimum, as jnp's
    rng_v = torch.arange(v, device=dev)
    d_lat = 2.0 * off_lat[rng_v, nearest]
    r = rel[rng_v, nearest]
    d_rel = r * r                             # jnp's `** 2` (integer_pow)
    d_jit = 2.0 * jit[rng_v, nearest]
    if self_lat_ms is not None:
        s_lat = t(self_lat_ms)
        have = ~torch.isnan(s_lat)
        d_lat = torch.where(have, s_lat, d_lat)
        d_rel = torch.where(have, torch.ones_like(d_rel) if self_rel is None
                            else t(self_rel), d_rel)
        if self_jitter_ms is not None:
            d_jit = torch.where(have, t(self_jitter_ms), d_jit)
    eyef = eye.to(F32)
    lat = torch.where(eye, d_lat[:, None] * eyef, lat)
    rel = torch.where(eye, d_rel[:, None] * eyef + (~eye).to(F32), rel)
    jit = torch.where(eye, d_jit[:, None] * eyef, jit)

    # f32 products (a Python int against an f32 array stays f32 in JAX),
    # rounded half to even.
    lat_ns = torch.round(lat * SIMTIME_ONE_MILLISECOND).to(I64)
    jit_ns = torch.round(jit * SIMTIME_ONE_MILLISECOND).to(I64)
    # Jitter can never make a path non-causal: clamp to latency - 1ns.
    jit_ns = torch.minimum(jit_ns, torch.clamp(lat_ns - 1, min=0))
    return lat_ns, rel.to(F32), jit_ns


def is_routable(lat_ns: torch.Tensor) -> torch.Tensor:
    """[V,V] bool connectivity (topology_isRoutable)."""
    return lat_ns < int(INF_MS) * SIMTIME_ONE_MILLISECOND // 2
