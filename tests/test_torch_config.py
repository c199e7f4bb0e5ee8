"""The port's config front end (shadow1_tpu_torch/config, routing/dns,
routing/graphml, routing/apsp) against the JAX package (CPU).

* `shadowxml.parse` gives the same dataclasses, field for field, on both
  example configs and on the attribute configs of tests/test_config.py;
* the DNS registry assigns the same IPs (reserved ranges skipped, usable
  and unusable iphints);
* `graphml.load` reads the same topology from literal XML, a file and an
  `.xz` file, and `attach_all` puts every host on the same vertex;
* `apsp.build_matrices` and `is_routable` are bitwise equal on the
  3-vertex example topology and on a seeded random graph of 48 vertices
  (vertex and edge loss, jitter, explicit self-loops, multi-edges and an
  unreachable component);
* `assemble.build` equals the JAX build leaf for leaf (state and params)
  on both examples, an attribute config, an interfacebuffer config and
  CUBIC, and refuses by name what the port does not carry.
"""

import dataclasses
import lzma
import os

import jax.numpy as jnp
import numpy as np
import pytest

import test_config
from shadow1_tpu.config import assemble as jasm
from shadow1_tpu.config import shadowxml as jxml
from shadow1_tpu.routing import apsp as japsp
from shadow1_tpu.routing import dns as jdns
from shadow1_tpu.routing import graphml as jgml
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.config import assemble as tasm
from shadow1_tpu_torch.config import shadowxml as txml
from shadow1_tpu_torch.routing import apsp as tapsp
from shadow1_tpu_torch.routing import dns as tdns
from shadow1_tpu_torch.routing import graphml as tgml

from _torch_parity import assert_same, jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [os.path.join(REPO, "examples", d, "shadow.config.xml")
            for d in ("tgen-2host", "tgen-100host")]
# Host attributes of the attribute configs (test_config.TestConfigAttributes
# ._mini puts them on its server host).
ATTRS = ["", 'socketrecvbuffer="8192" socketsendbuffer="4096"',
         'heartbeatfrequency="5"', 'cpufrequency="2500000"',
         'iphint="11.0.0.7" typehint="client"', 'bogusattr="1"',
         'interfacebuffer="3000" logpcap="true" loglevel="debug"']


def _attr_config(tmp_path, attrs):
    """(path-free XML, base dir) of an attribute config, graphs written."""
    t = test_config.TestConfigAttributes()
    t._files(tmp_path)
    return t._mini(attrs), str(tmp_path)


def _same_dataclass(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# Parser, DNS, topology, attachment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attrs", ATTRS)
def test_parse_equals_jax(attrs, tmp_path):
    xml, _ = _attr_config(tmp_path, attrs)
    _same_dataclass(txml.parse(xml), jxml.parse(xml))
    if attrs == "":
        for path in EXAMPLES:
            _same_dataclass(txml.parse(path), jxml.parse(path))


def test_dns_equals_jax():
    rng = np.random.default_rng(5)
    hints = [None, "0.0.0.0", "11.0.0.1", "10.0.0.5", "192.168.1.1",
             "1.0.0.2", "1.0.0.9", "127.0.0.1", "8.8.8.8", "11.0.0.1"]
    registries = [tdns.DNS(), jdns.DNS()]
    for i in range(300):
        hint = hints[int(rng.integers(0, len(hints)))]
        got = [d.register(i, f"h{i}", requested_ip=hint) for d in registries]
        assert got[0].ip == got[1].ip and got[0].ip_str == got[1].ip_str
    for name in ("h0", "h17", "h299", "11.0.0.1", got[0].ip_str):
        assert registries[0].resolve_name(name).host_index == \
            registries[1].resolve_name(name).host_index
    with pytest.raises(ValueError):
        registries[0].register(300, "h3")
    assert all(tdns.is_restricted(ip) == jdns.is_restricted(ip)
               for ip in rng.integers(0, 1 << 32, 2000).tolist())


def _same_topology(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a.view(f"u{a.itemsize}"),
                                  b.view(f"u{b.itemsize}")), f.name
        else:
            assert a == b, f.name


def _random_graphml(seed: int = 7, v: int = 48, island: int = 8) -> str:
    """A GraphML text: vertices 0..v-island-1 connected, the last `island`
    vertices a component of their own; random latencies (ms, three
    decimals), jitter, edge and vertex loss, self-loops and multi-edges,
    and the attachment attributes of the hint ladder."""
    rng = np.random.default_rng(seed)
    keys = [("ip", "node"), ("citycode", "node"), ("type", "node"),
            ("packetloss", "node"), ("bandwidthup", "node"),
            ("latency", "edge"), ("jitter", "edge"), ("packetloss", "edge")]
    out = ['<graphml xmlns="http://graphml.graphdrawing.org/xmlns">']
    for n, (name, dom) in enumerate(keys):
        out.append(f'<key id="k{n}" for="{dom}" attr.name="{name}"/>')
    out.append('<graph edgedefault="undirected">')
    for i in range(v):
        loss = rng.choice([0.0, 0.0, 0.001, 0.02])
        out.append(f'<node id="n{i}"><data key="k0">11.0.{i}.1</data>'
                   f'<data key="k1">c{i % 5}</data>'
                   f'<data key="k2">{"core" if i % 7 == 0 else "edge"}'
                   f'</data><data key="k3">{loss}</data>'
                   f'<data key="k4">{int(rng.integers(100, 9999))}</data>'
                   f'</node>')

    def edge(a, b):
        lat = round(float(rng.uniform(0.5, 120.0)), 3)
        jit = round(float(rng.choice([0.0, rng.uniform(0.0, 30.0)])), 3)
        loss = float(rng.choice([0.0, 0.0, 0.005, 0.05]))
        out.append(f'<edge source="n{a}" target="n{b}">'
                   f'<data key="k5">{lat}</data><data key="k6">{jit}</data>'
                   f'<data key="k7">{loss}</data></edge>')

    core = v - island
    for i in range(1, core):                    # a spanning tree
        edge(int(rng.integers(0, i)), i)
    for _ in range(2 * core):                   # chords and multi-edges
        edge(*rng.integers(0, core, 2).tolist())
    for i in range(core + 1, v):
        edge(int(rng.integers(core, i)), i)
    for i in rng.choice(v, 6, replace=False).tolist():   # self-loops
        edge(i, i)
    out.append("</graph></graphml>")
    return "\n".join(out)


def test_graphml_load_equals_jax(tmp_path):
    srcs = [jxml.parse(p).topology_source() for p in EXAMPLES]
    srcs.append(_random_graphml())
    plain = tmp_path / "topo.graphml.xml"
    plain.write_text(srcs[-1])
    with lzma.open(tmp_path / "topo.graphml.xml.xz", "wt") as f:
        f.write(srcs[1])
    srcs += [str(plain), str(tmp_path / "topo.graphml.xml.xz")]
    for src in srcs:
        _same_topology(tgml.load(src), jgml.load(src))


def test_attach_equals_jax():
    topo_t, topo_j = (m.load(_random_graphml()) for m in (tgml, jgml))
    ladder = [{}, {"iphint": "11.0.3.1"}, {"iphint": "9.9.9.9"},
              {"citycodehint": "c2"}, {"citycodehint": "none"},
              {"typehint": "core"}, {"citycodehint": "c1",
                                     "typehint": "core"},
              {"countrycodehint": "x", "typehint": "edge"}]
    hints = ladder * 8
    for seed in (1, 2, 99):
        a = tgml.attach_all(topo_t, hints, seed)
        b = jgml.attach_all(topo_j, hints, seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for path in EXAMPLES:
        cfg = jxml.parse(path)
        specs = jasm._expand_hosts(cfg)[1]
        src = cfg.topology_source()
        for seed in (1, 5):
            a = tgml.attach_all(tgml.load(src), [s.hints() for s in specs],
                                seed)
            b = jgml.attach_all(jgml.load(src), [s.hints() for s in specs],
                                seed)
            assert np.array_equal(a, b)


@pytest.mark.parametrize("which", ["tgen-100host", "random"])
def test_apsp_bitwise_equals_jax(which):
    src = jxml.parse(EXAMPLES[1]).topology_source() \
        if which == "tgen-100host" else _random_graphml()
    topo = jgml.load(src)
    args = (topo.lat_ms, topo.edge_rel)
    kw = dict(self_lat_ms=topo.self_lat_ms, self_rel=topo.self_rel,
              edge_jitter_ms=topo.jitter_ms,
              self_jitter_ms=topo.self_jitter_ms)
    want = japsp.build_matrices(*(jnp.asarray(a) for a in args),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tapsp.build_matrices(*args, **kw)
    for g, w, name in zip(got, want, ("latency", "reliability", "jitter")):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        assert np.array_equal(g.view(f"u{g.itemsize}"),
                              w.view(f"u{w.itemsize}")), name
    r_t = tapsp.is_routable(got[0]).numpy()
    assert np.array_equal(r_t, np.asarray(japsp.is_routable(want[0])))
    if which == "random":
        assert not r_t.all() and r_t[:40, :40].all()
        assert (got[2] > 0).any() and (got[1] < 1).any()
    # Without the optional inputs (the doubled nearest-edge self-paths).
    got = tapsp.build_matrices(*args)
    want = japsp.build_matrices(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------


def _same_assembled(t, j, label):
    assert_same(convert.to_numpy(t.state), jax_tree(j.state), f"{label} state")
    assert_same(convert.to_numpy(t.params), jax_tree(j.params),
                f"{label} params")
    for f in ("cong", "has_iface_buf", "pds_trail", "has_loss", "has_jitter",
              "kernel_diet", "megakernel", "persistent"):
        assert getattr(t.params, f) == getattr(j.params, f), f
    assert t.hostnames == j.hostnames and t.stop_time == j.stop_time
    assert np.array_equal(t.heartbeat_freq_s, j.heartbeat_freq_s)
    assert type(t.app).__name__ == type(j.app).__name__ == "Tgen"


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(os.path.dirname(p))
                              for p in EXAMPLES])
def test_assemble_equals_jax(path):
    _same_assembled(tasm.load(path, device="cpu"), jasm.load(path),
                    os.path.basename(os.path.dirname(path)))


def test_assemble_attributes_equal_jax(tmp_path):
    xml, base = _attr_config(
        tmp_path, 'socketrecvbuffer="8192" socketsendbuffer="4096" '
        'cpufrequency="2500000" heartbeatfrequency="3"')
    cfgs = [m.parse(xml) for m in (txml, jxml)]
    for c in cfgs:
        c.base_dir = base
    kw = dict(seed=3, qdisc="rr", cpu_threshold_us=50, cpu_precision_us=7,
              pool_slab=16, sock_slots=6)
    _same_assembled(tasm.build(cfgs[0], device="cpu", **kw),
                    jasm.build(cfgs[1], **kw), "attributes")


_NETEM = '<netem><event time="1" kind="link_down" a="server" b="client"/>' \
    '</netem>\n</shadow>'


@pytest.mark.parametrize("case,match", [
    ("logpcap", "packet capture.*item 8"),
    ("loglevel", "event log.*item 8"),
    ("netem", "<netem>.*item 5"),
    ("bucket", "bucket padding.*item 4"),
    ("real", "real processes.*item 10"),
])
def test_assemble_refusals(case, match, tmp_path):
    attrs = {"logpcap": 'logpcap="true"',
             "loglevel": 'loglevel="debug"'}.get(case, "")
    xml, base = _attr_config(tmp_path, attrs)
    if case == "netem":
        xml = xml.replace("</shadow>", _NETEM)
    if case == "real":
        prog = tmp_path / "prog"
        prog.write_text("#!/bin/sh\n")
        prog.chmod(0o755)
        xml = xml.replace('path="tgen"', f'path="{prog}"')
    cfg = txml.parse(xml)
    cfg.base_dir = base
    kw = {"bucket": True} if case == "bucket" else {}
    with pytest.raises(NotImplementedError, match=match):
        tasm.build(cfg, device="cpu", **kw)


@pytest.mark.parametrize("case", ["interfacebuffer", "cubic"])
def test_assemble_carries_equal_jax(case, tmp_path):
    """What the port used to refuse and now carries: an interfacebuffer
    (bytes, rounded up to whole MTUs of packets) and CUBIC assemble to
    the JAX build, leaf for leaf, statics included."""
    attrs = 'interfacebuffer="3001"' if case == "interfacebuffer" else ""
    xml, base = _attr_config(tmp_path, attrs)
    cfgs = [m.parse(xml) for m in (txml, jxml)]
    for c in cfgs:
        c.base_dir = base
    kw = {"cong": "cubic"} if case == "cubic" else {}
    t = tasm.build(cfgs[0], device="cpu", **kw)
    _same_assembled(t, jasm.build(cfgs[1], **kw), case)
    if case == "cubic":
        assert t.params.cong == "cubic" and not t.params.has_iface_buf
    else:
        assert t.params.has_iface_buf and t.params.cong == "reno"
        assert sorted(t.params.iface_buf_pkts.tolist()) == [0, 3]
