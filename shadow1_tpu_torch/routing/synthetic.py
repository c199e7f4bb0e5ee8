"""Synthetic topologies (counterpart of shadow1_tpu/routing/synthetic.py)."""

from __future__ import annotations

import torch

from ..core.simtime import TIME_DTYPE


def uniform_full_mesh(n_vertices: int, latency_ns: int,
                      reliability: float = 1.0):
    """Complete graph, self-paths included, every pair at `latency_ns`.
    Returns (latency_ns [V,V] i64, reliability [V,V] f32), on the CPU."""
    lat = torch.full((n_vertices, n_vertices), latency_ns, dtype=TIME_DTYPE)
    rel = torch.full((n_vertices, n_vertices), reliability,
                     dtype=torch.float32)
    return lat, rel
