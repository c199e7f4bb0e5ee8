"""GraphML topology ingestion -> dense routing arrays (a copy of
shadow1_tpu/routing/graphml.py; the port imports nothing of the JAX
package).

Reads the same GraphML the reference feeds igraph
(Shadow's src/main/routing/topology.c:371-560): node attributes
{ip, citycode, countrycode, geocode, asn, type, bandwidthup, bandwidthdown,
packetloss}, edge attributes {latency (ms), jitter (ms), packetloss},
undirected by default, optional self-loop edges giving explicit
same-vertex path costs.  Existing topology files (including the bundled
`topology.graphml.xml.xz` style) load unchanged; `.xz` is handled
transparently.

Output is numpy adjacency matrices ready for `apsp.build_matrices` plus
per-vertex metadata used by the host-attachment hint ladder, the analog of
topology_attach's ip/city/country/geo/type preference matching
(topology.c:107-138,2371-2430).
"""

from __future__ import annotations

import dataclasses
import lzma
import os
import xml.etree.ElementTree as ET

import numpy as np

from .apsp import INF_MS

_NS = "{http://graphml.graphdrawing.org/xmlns}"


@dataclasses.dataclass
class Topology:
    names: list            # vertex id strings
    index: dict            # name -> vertex index
    ip: list               # dotted-quad strings ("0.0.0.0" = unassigned)
    citycode: list
    countrycode: list
    geocode: list
    typ: list
    asn: np.ndarray        # [V] i64
    bw_up_KiBps: np.ndarray    # [V] i64
    bw_down_KiBps: np.ndarray  # [V] i64
    vertex_loss: np.ndarray    # [V] f64
    lat_ms: np.ndarray     # [V,V] f32 adjacency, INF_MS where no edge, 0 diag
    edge_rel: np.ndarray   # [V,V] f32 per-edge reliability (vertex loss folded
                           # into the receiving end of each edge)
    jitter_ms: np.ndarray  # [V,V] f32 adjacency jitter
    self_lat_ms: np.ndarray  # [V] f32 explicit self-loop latency, nan = none
    self_rel: np.ndarray     # [V] f32
    self_jitter_ms: np.ndarray  # [V] f32

    @property
    def num_vertices(self) -> int:
        return len(self.names)


def _read_text(source: str) -> str:
    """Accept a file path (optionally .xz) or a literal GraphML string."""
    if source.lstrip().startswith("<"):
        return source
    if source.endswith(".xz"):
        with lzma.open(source, "rt") as f:
            return f.read()
    with open(source) as f:
        return f.read()


def load(source: str) -> Topology:
    root = ET.fromstring(_read_text(source))

    # key id -> (domain, attr name)
    keys = {}
    for k in root.iter(_NS + "key"):
        keys[k.get("id")] = (k.get("for"), k.get("attr.name"))

    graph = root.find(_NS + "graph")
    if graph is None:
        raise ValueError("GraphML has no <graph> element")

    def data_of(el):
        out = {}
        for d in el.findall(_NS + "data"):
            dom, name = keys.get(d.get("key"), (None, d.get("key")))
            out[name] = d.text or ""
        return out

    names, meta = [], []
    for node in graph.findall(_NS + "node"):
        names.append(node.get("id"))
        meta.append(data_of(node))
    index = {n: i for i, n in enumerate(names)}
    v = len(names)

    def col(name, default):
        return [m.get(name, default) for m in meta]

    asn = np.array([int(float(x or 0)) for x in col("asn", "0")], np.int64)
    bw_up = np.array([int(float(x or 0)) for x in col("bandwidthup", "0")],
                     np.int64)
    bw_dn = np.array([int(float(x or 0)) for x in col("bandwidthdown", "0")],
                     np.int64)
    vloss = np.array([float(x or 0) for x in col("packetloss", "0")],
                     np.float64)

    lat = np.full((v, v), INF_MS, np.float32)
    np.fill_diagonal(lat, 0.0)
    jit = np.zeros((v, v), np.float32)
    erel = np.ones((v, v), np.float32)
    self_lat = np.full((v,), np.nan, np.float32)
    self_rel = np.ones((v,), np.float32)
    self_jit = np.zeros((v,), np.float32)

    directed = graph.get("edgedefault", "undirected") == "directed"

    for edge in graph.findall(_NS + "edge"):
        s, t = index[edge.get("source")], index[edge.get("target")]
        d = data_of(edge)
        elat = float(d.get("latency", 0) or 0)
        eloss = float(d.get("packetloss", 0) or 0)
        ejit = float(d.get("jitter", 0) or 0)
        if s == t:
            self_lat[s] = elat
            self_rel[s] = (1.0 - eloss) * (1.0 - vloss[s])
            self_jit[s] = ejit
            continue
        # Vertex packet loss is folded into every edge *into* that vertex so
        # reliability composes associatively during the APSP relaxation.
        # Multi-edges keep the lowest-latency edge's full attribute set
        # (GraphML permits parallel edges; min-latency wins like Dijkstra
        # would pick it).
        if elat < lat[s, t]:
            lat[s, t] = elat
            erel[s, t] = (1.0 - eloss) * (1.0 - vloss[t])
            jit[s, t] = ejit
        if not directed and elat < lat[t, s]:
            lat[t, s] = elat
            erel[t, s] = (1.0 - eloss) * (1.0 - vloss[s])
            jit[t, s] = ejit

    return Topology(
        names=names, index=index,
        ip=col("ip", "0.0.0.0"),
        citycode=col("citycode", ""),
        countrycode=col("countrycode", ""),
        geocode=col("geocode", ""),
        typ=col("type", ""),
        asn=asn, bw_up_KiBps=bw_up, bw_down_KiBps=bw_dn, vertex_loss=vloss,
        lat_ms=lat, edge_rel=erel, jitter_ms=jit,
        self_lat_ms=self_lat, self_rel=self_rel, self_jitter_ms=self_jit,
    )


# ---------------------------------------------------------------------------
# Host attachment (the hint ladder)
# ---------------------------------------------------------------------------


def attach(topo: Topology, hints: dict, rng: np.random.Generator) -> int:
    """Pick the topology vertex for one host.

    Preference ladder like the reference's attach-hint matching
    (topology.c:2371-2430): exact iphint -> narrow candidates by
    citycode/countrycode/geocode/type hints in that order (a hint that
    matches nothing is skipped) -> uniform choice among survivors with the
    supplied (seeded, per-host) generator.
    """
    v = topo.num_vertices
    ip = hints.get("iphint")
    if ip:
        for i, vip in enumerate(topo.ip):
            if vip == ip:
                return i
    cand = list(range(v))
    for key, attr in (("citycodehint", topo.citycode),
                      ("countrycodehint", topo.countrycode),
                      ("geocodehint", topo.geocode),
                      ("typehint", topo.typ)):
        want = hints.get(key)
        if want:
            narrowed = [i for i in cand if attr[i] == want]
            if narrowed:
                cand = narrowed
    return int(cand[rng.integers(0, len(cand))])


def attach_all(topo: Topology, hint_list, seed: int) -> np.ndarray:
    """Deterministically attach every host; each host uses its own
    seeded stream so the assignment is independent of host order."""
    out = np.empty(len(hint_list), np.int32)
    for i, hints in enumerate(hint_list):
        out[i] = attach(topo, hints or {},
                        np.random.default_rng((seed, 0xA77AC4, i)))
    return out
